// qz_entropy.cc — native host runtime: zstd entropy coding + frame assembly.
//
// The fast-path implementation of the format/ golden model (bit-compatible
// by construction, differentially tested from Python). This plays the role
// libzstd's entropy stage plays for the reference plugin (the reference
// emits sequences and lets libzstd do FSE/Huffman; our TPU pipeline emits
// sequences and this runtime finishes the frame), plus a complete software
// fallback compressor (hash-chain matcher) mirroring the reference's
// libzstd soft-fallback posture (README.md:197-198).
//
// Written from the RFC 8878 format spec; no code from the reference (which
// contains no entropy coder) or libzstd.
//
// C ABI at the bottom; driven from Python via ctypes (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cassert>
#include <thread>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace qz {

// ---------------------------------------------------------------- bitstream

// Backward-read bitstream (FSE/Huffman payloads): LSB-first accumulation,
// closed with a single '1' sentinel then zero-padded to a byte.
//
// The writer is bounds-check-free on the hot path: callers pre-size the
// buffer to a worst-case bound via reserve_bytes() (the measured cost of
// the old push_back flushes was the per-byte capacity check + size
// bump, ~2x the actual bit work in encode_sequences_section).
struct BackwardBitWriter {
  uint64_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> out;
  size_t pos = 0;  // write cursor into the pre-sized buffer

  // Worst-case capacity for everything added before close(); +16 covers
  // the close() drain and store slack.
  void reserve_bytes(size_t n) {
    if (out.size() < pos + n + 16) out.resize(pos + n + 16);
  }
  // Whole-word flushes: a single add() carries <= 32 bits, and the
  // post-flush residue is <= 31, so the 64-bit accumulator never
  // overflows (31 + 32 = 63). Explicit LE byte composition keeps the
  // store endian-neutral (advisor r3); GCC folds the four shifts into
  // one 32-bit store on little-endian hosts.
  inline void add(uint64_t value, int nb) {
    // Reserve contract (advisor r4): every call site sizes the buffer
    // via reserve_bytes() before adding; enforce it in debug/fuzz
    // builds so a future wider field fails an assert, not the heap.
    assert(pos + 8 <= out.size());
    acc |= value << nbits;
    nbits += nb;
    if (nbits >= 32) {
      uint32_t word = static_cast<uint32_t>(acc);
      uint8_t* p = out.data() + pos;
      p[0] = static_cast<uint8_t>(word);
      p[1] = static_cast<uint8_t>(word >> 8);
      p[2] = static_cast<uint8_t>(word >> 16);
      p[3] = static_cast<uint8_t>(word >> 24);
      pos += 4;
      acc >>= 32;
      nbits -= 32;
    }
  }
  inline void add_masked(uint64_t value, int nb) {
    add(value & ((1ull << nb) - 1), nb);
  }
  std::vector<uint8_t> close() {
    add(1, 1);
    assert(pos + 8 <= out.size());
    while (nbits > 0) {  // drain the <= 32-bit residue
      out[pos++] = static_cast<uint8_t>(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
    nbits = 0;
    out.resize(pos);
    return std::move(out);
  }
};

// Forward LSB-first bitstream (FSE table descriptions).
struct ForwardBitWriter {
  uint64_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> out;
  inline void add(uint64_t value, int nb) {
    acc |= value << nbits;
    nbits += nb;
    while (nbits >= 8) {
      out.push_back(static_cast<uint8_t>(acc & 0xFF));
      acc >>= 8;
      nbits -= 8;
    }
  }
  std::vector<uint8_t> close() {
    if (nbits) {
      out.push_back(static_cast<uint8_t>(acc & 0xFF));
      acc = 0;
      nbits = 0;
    }
    return std::move(out);
  }
};

static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }
// Greedy chain levels (no lazy until L5) get the same conditional
// one-step lazy on short finds (see the fast matcher's mini-lazy).
#ifndef QZ_CHAIN_LAZY_BAR
#define QZ_CHAIN_LAZY_BAR 32
#endif


// ---------------------------------------------------------------- xxhash64

static const uint64_t P1 = 11400714785074694791ull;
static const uint64_t P2 = 14029467366897019727ull;
static const uint64_t P3 = 1609587929392839161ull;
static const uint64_t P4 = 9650029242287828579ull;
static const uint64_t P5 = 2870177450012600261ull;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}
static inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  return (acc ^ xxh_round(0, val)) * P1 + P4;
}
static inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
static inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Longest common prefix of a and b, capped at lim. The word loops end
// with a ctz on the XOR of the mismatching word (the old byte tail paid
// up to 7 extra compares per mismatch — and EVERY probe ends in exactly
// one mismatch, so this is the per-probe fixed cost); AVX2 compares 32
// bytes per step on long matches. This is the shared primitive of every
// matcher/extension/walk probe in this file.
static inline size_t lcp(const uint8_t* a, const uint8_t* b, size_t lim) {
  size_t l = 0;
#if defined(__AVX2__)
  while (l + 32 <= lim) {
    __m256i va = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(a + l));
    __m256i vb = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(b + l));
    uint32_t eq = static_cast<uint32_t>(
        _mm256_movemask_epi8(_mm256_cmpeq_epi8(va, vb)));
    if (eq != 0xFFFFFFFFu) return l + __builtin_ctz(~eq);
    l += 32;
  }
#endif
  while (l + 8 <= lim) {
    uint64_t x = rd64(a + l) ^ rd64(b + l);
    if (x) return l + (__builtin_ctzll(x) >> 3);
    l += 8;
  }
  while (l < lim && a[l] == b[l]) ++l;
  return l;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t a1 = seed + P1 + P2, a2 = seed + P2, a3 = seed, a4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      a1 = xxh_round(a1, rd64(p));
      a2 = xxh_round(a2, rd64(p + 8));
      a3 = xxh_round(a3, rd64(p + 16));
      a4 = xxh_round(a4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(a1, 1) + rotl64(a2, 7) + rotl64(a3, 12) + rotl64(a4, 18);
    h = xxh_merge(h, a1);
    h = xxh_merge(h, a2);
    h = xxh_merge(h, a3);
    h = xxh_merge(h, a4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= xxh_round(0, rd64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(rd32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- FSE

struct FseEncodeTable {
  int accuracy_log = 0;
  std::vector<uint16_t> state_table;      // (size,), values in [size, 2size)
  std::vector<int64_t> delta_nb_bits;     // per symbol
  std::vector<int32_t> delta_find_state;  // per symbol
};

// Canonical symbol spread (RFC 8878 §4.1.1). Returns false on bad counts.
static bool spread_symbols(const std::vector<int>& norm, int al,
                           std::vector<int>* table) {
  int size = 1 << al;
  int mask = size - 1;
  table->assign(size, -1);
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s)
    if (norm[s] == -1) (*table)[high--] = static_cast<int>(s);
  int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int c = 0; c < norm[s]; ++c) {
      (*table)[pos] = static_cast<int>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  return pos == 0;
}

bool build_encode_table(const std::vector<int>& norm, int al,
                        FseEncodeTable* t) {
  int size = 1 << al;
  std::vector<int> spread;
  if (!spread_symbols(norm, al, &spread)) return false;
  size_t nsym = norm.size();
  t->accuracy_log = al;
  t->state_table.assign(size, 0);
  std::vector<int> cumul(nsym + 1, 0);
  for (size_t s = 0; s < nsym; ++s)
    cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : norm[s]);
  if (cumul[nsym] != size) return false;
  std::vector<int> fill(cumul.begin(), cumul.begin() + nsym);
  for (int u = 0; u < size; ++u) {
    int s = spread[u];
    t->state_table[fill[s]++] = static_cast<uint16_t>(size + u);
  }
  t->delta_nb_bits.assign(nsym, 0);
  t->delta_find_state.assign(nsym, 0);
  int total = 0;
  for (size_t s = 0; s < nsym; ++s) {
    int c = norm[s];
    if (c == 0) {
      t->delta_nb_bits[s] = ((int64_t)(al + 1) << 16) - (1 << al);
      t->delta_find_state[s] = 0;
    } else if (c == -1 || c == 1) {
      t->delta_nb_bits[s] = ((int64_t)al << 16) - (1 << al);
      t->delta_find_state[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = al - highbit(c - 1);
      int64_t min_state_plus = (int64_t)c << max_bits_out;
      t->delta_nb_bits[s] = ((int64_t)max_bits_out << 16) - min_state_plus;
      t->delta_find_state[s] = total - c;
      total += c;
    }
  }
  return true;
}

struct FseEncoder {
  const FseEncodeTable* t = nullptr;
  int state = 0;
  bool rle = false;  // accuracy-log-0 degenerate machine: no bits

  void init(const FseEncodeTable* table, int first_symbol) {
    t = table;
    int64_t tt_nb = t->delta_nb_bits[first_symbol];
    int nb_out = static_cast<int>((tt_nb + (1 << 15)) >> 16);
    int64_t value = ((int64_t)nb_out << 16) - tt_nb;
    int idx = static_cast<int>((value >> nb_out) +
                               t->delta_find_state[first_symbol]);
    state = t->state_table[idx];
  }
  inline void encode(int symbol, BackwardBitWriter* w) {
    if (rle) return;
    int nb = static_cast<int>((state + t->delta_nb_bits[symbol]) >> 16);
    w->add_masked(state, nb);
    state = t->state_table[(state >> nb) + t->delta_find_state[symbol]];
  }
  inline void flush(BackwardBitWriter* w) {
    if (rle) return;
    w->add_masked(state, t->accuracy_log);
  }
};

// NCount serialization (forward bitstream). Returns false on bad counts.
bool write_ncount(const std::vector<int>& norm, int al,
                  std::vector<uint8_t>* out) {
  if (al < 5 || al > 12) return false;
  int size = 1 << al;
  ForwardBitWriter w;
  w.add(al - 5, 4);
  int remaining = size + 1;
  int threshold = size;
  int nb_bits = al + 1;
  size_t symbol = 0;
  bool previous_is_0 = false;
  size_t nsym = norm.size();
  while (remaining > 1 && symbol < nsym) {
    if (previous_is_0) {
      size_t start = symbol;
      while (symbol < nsym && norm[symbol] == 0) ++symbol;
      if (symbol == nsym) return false;
      size_t run = symbol;
      while (run >= start + 24) {
        start += 24;
        w.add(0xFFFF, 16);
      }
      while (run >= start + 3) {
        start += 3;
        w.add(3, 2);
      }
      w.add(run - start, 2);
    }
    int count = norm[symbol++];
    int vmax = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += vmax;
    if (count < vmax)
      w.add(count, nb_bits - 1);
    else
      w.add(count, nb_bits);
    previous_is_0 = (count == 1);
    if (remaining < 1) return false;
    while (remaining < threshold) {
      --nb_bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return false;
  *out = w.close();
  return true;
}

// Histogram normalization: largest-remainder with low-prob cutoff, repaired
// against the largest buckets (mirrors format/fse.py normalize_counts).
bool normalize_counts(const std::vector<int64_t>& hist_in, int al,
                      int64_t total, std::vector<int>* out) {
  int size = 1 << al;
  int last = -1;
  for (size_t s = 0; s < hist_in.size(); ++s)
    if (hist_in[s] > 0) last = static_cast<int>(s);
  if (last < 0 || total <= 0) return false;
  std::vector<int64_t> hist(hist_in.begin(), hist_in.begin() + last + 1);
  int npresent = 0;
  for (auto h : hist)
    if (h > 0) ++npresent;
  if (npresent < 2 || npresent > size) return false;

  size_t n = hist.size();
  std::vector<double> scaled(n);
  std::vector<int64_t> norm(n, 0);
  for (size_t s = 0; s < n; ++s) {
    scaled[s] = static_cast<double>(hist[s]) * size / total;
    norm[s] = static_cast<int64_t>(scaled[s]);  // floor (scaled >= 0)
    if (hist[s] > 0 && scaled[s] < 1.0)
      norm[s] = -1;
    else if (hist[s] > 0 && norm[s] == 0)
      norm[s] = 1;
  }
  auto cur_sum = [&]() {
    int64_t t = 0;
    for (auto v : norm) t += (v == -1 ? 1 : v);
    return t;
  };
  int64_t delta = size - cur_sum();
  if (delta != 0) {
    // Stable insertion sorts (n <= 256, usually <= 53): byte-identical
    // ordering to the old stable_sort without its per-call temporary
    // buffer allocation — this pass runs 3-5x per block (plan_table x3,
    // literals weights) and the allocations were a measured ~6% of the
    // software profile.
    std::vector<size_t> order(n);
    for (size_t i = 0; i < n; ++i) order[i] = i;
    auto rem = [&](size_t s) {
      return scaled[s] - static_cast<double>(std::max<int64_t>(norm[s], 0));
    };
    for (size_t a = 1; a < n; ++a) {
      size_t key = order[a];
      double rk = rem(key);
      size_t b = a;
      while (b > 0 && rk > rem(order[b - 1])) {
        order[b] = order[b - 1];
        --b;
      }
      order[b] = key;
    }
    size_t i = 0;
    while (delta > 0) {
      size_t s = order[i % n];
      if (norm[s] >= 1) {
        ++norm[s];
        --delta;
      }
      ++i;
      if (i > 10 * n) {
        size_t mx = 0;
        for (size_t s2 = 1; s2 < n; ++s2)
          if (norm[s2] > norm[mx]) mx = s2;
        norm[mx] += delta;
        delta = 0;
      }
    }
    std::vector<size_t> big(n);
    for (size_t j = 0; j < n; ++j) big[j] = j;
    for (size_t a = 1; a < n; ++a) {
      size_t key = big[a];
      int64_t nk = norm[key];
      size_t b = a;
      while (b > 0 && nk > norm[big[b - 1]]) {
        big[b] = big[b - 1];
        --b;
      }
      big[b] = key;
    }
    i = 0;
    while (delta < 0) {
      size_t s = big[i % n];
      if (norm[s] > 1) {
        int64_t take = std::min<int64_t>(norm[s] - 1, -delta);
        norm[s] -= take;
        delta += take;
      }
      ++i;
      if (i > 10 * n) return false;
    }
  }
  int64_t mxv = 0;
  for (auto v : norm) mxv = std::max(mxv, v);
  if (mxv >= size) return false;
  out->assign(norm.begin(), norm.end());
  return true;
}

// ---------------------------------------------------------------- Huffman

static const int MAX_CODE_BITS = 11;

struct HuffmanTable {
  int nb_bits[256] = {0};
  uint16_t codes[256] = {0};
  int max_bits = 0;
  int last_symbol = 0;
};

// OPTIMAL length-limited canonical Huffman via package-merge (mirrors
// format/huffman.py _package_merge_lengths EXACTLY, including the
// deterministic tie-breaks — leaves sorted by (freq, symbol), stable
// merge putting leaves before equal-frequency packages — so host
// outputs stay byte-identical across the Python and native paths).
// The previous plain-Huffman + clamp + greedy-repair builder measured
// ~3.5 KB/2 MB worse than optimal on the mixed corpus.
bool build_huffman(const int64_t* hist, HuffmanTable* t) {
  std::vector<int> present;
  for (int s = 0; s < 256; ++s)
    if (hist[s] > 0) present.push_back(s);
  if (present.size() < 2) return false;

  struct Item {
    // 16-byte items: the per-round std::merge copies dominate this
    // builder's cost, so freq is u32 (leaf counts sum to the literal
    // count and every package freq is bounded by that sum; callers
    // with > 2^31 total are refused below) and sym is i16.
    uint32_t freq;
    int16_t sym;  // >= 0: leaf; -1: package
    int a, b;     // package children (pool_id * 65536 + index)
  };
  // All working storage is thread-local scratch: this builder runs once
  // per block from every MT worker, and its two dozen per-call vector
  // allocations were a measured ~10-20% of the software entropy profile.
  // Pool slices live in a flat arena (pool_id * POOL_STRIDE + idx; pool
  // sizes are bounded by leaves + packages <= 256 + 255 < POOL_STRIDE).
  constexpr int POOL_STRIDE = 512;
  static thread_local std::vector<Item> leaves, prev, nxt, top, arena;
  static thread_local std::vector<std::pair<int, int>> stack;
  int64_t total_count = 0;
  for (int s : present) total_count += hist[s];
  if (total_count > 0x7FFFFFFF) return false;  // u32 freq bound
  leaves.clear();
  // Leaves sorted by (freq, symbol) — symbol order is already ascending
  // from the present[] scan, so a stable sort by freq suffices.
  for (int s : present)
    leaves.push_back({static_cast<uint32_t>(hist[s]),
                      static_cast<int16_t>(s), -1, -1});
  std::stable_sort(leaves.begin(), leaves.end(),
                   [](const Item& x, const Item& y) {
                     return x.freq < y.freq;
                   });
  const int n = static_cast<int>(leaves.size());
  arena.resize(static_cast<size_t>(MAX_CODE_BITS) * POOL_STRIDE);
  prev.clear();
  // Each round's pool is merge(leaves, prev): both inputs are already
  // sorted (prev's package freqs are sums of consecutive pairs of a
  // sorted list, hence non-decreasing), and std::merge takes from the
  // first range on ties — exactly the leaves-before-equal-frequency-
  // packages contract the Python mirror requires. Replaces a measured
  // per-round stable_sort.
  auto freq_lt = [](const Item& x, const Item& y) {
    return x.freq < y.freq;
  };
  for (int round = 0; round < MAX_CODE_BITS - 1; ++round) {
    const int pool_id = round + 1;
    Item* cur = arena.data() + static_cast<size_t>(pool_id) * POOL_STRIDE;
    std::merge(leaves.begin(), leaves.end(), prev.begin(), prev.end(),
               cur, freq_lt);
    const int csz = n + static_cast<int>(prev.size());
    nxt.clear();
    for (int i = 0; i + 1 < csz; i += 2) {
      // Children referenced as pool_id * 65536 + index.
      nxt.push_back({cur[i].freq + cur[i + 1].freq, -1,
                     pool_id * 65536 + i, pool_id * 65536 + i + 1});
    }
    prev.swap(nxt);
  }
  top.resize(leaves.size() + prev.size());
  std::merge(leaves.begin(), leaves.end(), prev.begin(), prev.end(),
             top.begin(), freq_lt);
  int64_t lengths[256] = {0};
  stack.clear();
  for (int i = 0; i < 2 * n - 2; ++i) stack.push_back({-1, i});
  while (!stack.empty()) {
    auto [pool, idx] = stack.back();
    stack.pop_back();
    const Item& it = pool < 0 ? top[idx]
                              : arena[static_cast<size_t>(pool) *
                                          POOL_STRIDE + idx];
    if (it.sym >= 0) {
      ++lengths[it.sym];
    } else {
      stack.push_back({it.a / 65536, it.a % 65536});
      stack.push_back({it.b / 65536, it.b % 65536});
    }
  }
  const int64_t unit = 1ll << MAX_CODE_BITS;
  int64_t kraft = 0;
  for (int s : present) kraft += unit >> lengths[s];
  if (kraft != unit) return false;  // PM codes are complete by theorem

  int max_bits = 0;
  for (int s : present)
    max_bits = std::max<int>(max_bits, static_cast<int>(lengths[s]));
  int nb_per_rank[MAX_CODE_BITS + 2] = {0};
  for (int s : present) ++nb_per_rank[lengths[s]];
  int val_per_rank[MAX_CODE_BITS + 2] = {0};
  int mn = 0;
  for (int nb = max_bits; nb > 0; --nb) {
    val_per_rank[nb] = mn;
    mn += nb_per_rank[nb];
    mn >>= 1;
  }
  for (int s = 0; s < 256; ++s) {
    t->nb_bits[s] = static_cast<int>(lengths[s]);
    t->codes[s] = 0;
  }
  for (int s = 0; s < 256; ++s) {
    int l = static_cast<int>(lengths[s]);
    if (l > 0) t->codes[s] = static_cast<uint16_t>(val_per_rank[l]++);
  }
  t->max_bits = max_bits;
  t->last_symbol = present.back();
  return true;
}

// Huffman weights -> serialized tree description (header + weights).
// Mirrors format/huffman.py serialize_tree incl. the FSE-vs-direct choice.
static bool fse_compress_weights(const std::vector<int>& ws,
                                 std::vector<uint8_t>* out) {
  if (ws.size() < 2) return false;
  std::vector<int64_t> hist(13, 0);
  int maxw = 0;
  for (int w : ws) {
    ++hist[w];
    maxw = std::max(maxw, w);
  }
  int distinct = 0;
  for (auto h : hist)
    if (h > 0) ++distinct;
  if (distinct < 2) return false;
  int nbits = 1;
  while ((1u << nbits) < ws.size()) ++nbits;
  // Format floor: FSE accuracy logs are >= 5 (the 4-bit AL field counts
  // from 5), even for tiny weight alphabets.
  int max_al = std::min(6, std::max(5, nbits));
  std::vector<int> norm;
  if (!normalize_counts(hist, max_al, static_cast<int64_t>(ws.size()),
                        &norm))
    return false;
  std::vector<uint8_t> desc;
  if (!write_ncount(norm, max_al, &desc)) return false;
  FseEncodeTable t;
  if (!build_encode_table(norm, max_al, &t)) return false;
  BackwardBitWriter w;
  w.reserve_bytes(ws.size() + 32);  // <= 6 bits per weight + flushes
  std::ptrdiff_t n = static_cast<std::ptrdiff_t>(ws.size());
  FseEncoder c1, c2;
  // C1 carries even indices, C2 odd; inits consume the top index of each
  // parity; strictly alternating descending encodes; flush C2 then C1.
  if (n % 2 == 1) {
    c1.init(&t, ws[n - 1]);
    c2.init(&t, ws[n - 2]);
  } else {
    c2.init(&t, ws[n - 1]);
    c1.init(&t, ws[n - 2]);
  }
  for (std::ptrdiff_t ii = n - 3; ii >= 0; --ii) {
    (ii % 2 == 1 ? c2 : c1).encode(ws[ii], &w);
  }
  c2.flush(&w);
  c1.flush(&w);
  std::vector<uint8_t> stream = w.close();
  out->clear();
  out->insert(out->end(), desc.begin(), desc.end());
  out->insert(out->end(), stream.begin(), stream.end());
  if (out->size() >= 128 || out->size() >= ws.size()) return false;
  return true;
}

bool serialize_tree(const HuffmanTable& t, std::vector<uint8_t>* out) {
  std::vector<int> ws;
  for (int s = 0; s < t.last_symbol; ++s) {
    int nb = t.nb_bits[s];
    ws.push_back(nb == 0 ? 0 : t.max_bits + 1 - nb);
  }
  std::vector<uint8_t> fse_ws;
  bool has_fse = fse_compress_weights(ws, &fse_ws);
  std::vector<uint8_t> direct;
  bool has_direct = false;
  if (ws.size() <= 128) {
    direct.push_back(static_cast<uint8_t>(127 + ws.size()));
    for (size_t i = 0; i < ws.size(); i += 2) {
      int hi = ws[i] << 4;
      int lo = (i + 1 < ws.size()) ? ws[i + 1] : 0;
      direct.push_back(static_cast<uint8_t>(hi | lo));
    }
    has_direct = true;
  }
  if (has_fse && (!has_direct || fse_ws.size() + 1 < direct.size())) {
    out->clear();
    out->push_back(static_cast<uint8_t>(fse_ws.size()));
    out->insert(out->end(), fse_ws.begin(), fse_ws.end());
    return true;
  }
  if (!has_direct) return false;
  *out = std::move(direct);
  return true;
}

static inline void store64_le(uint8_t* p, uint64_t v) {
  // Explicit LE byte composition (endian-neutral — advisor r3 posture);
  // GCC folds this into a single 8-byte store on little-endian hosts.
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
  p[4] = static_cast<uint8_t>(v >> 32);
  p[5] = static_cast<uint8_t>(v >> 40);
  p[6] = static_cast<uint8_t>(v >> 48);
  p[7] = static_cast<uint8_t>(v >> 56);
}

static std::vector<uint8_t> huf_stream(const uint8_t* data, size_t n,
                                       const HuffmanTable& t) {
  // Combined (code | nbits<<12) entries; 4 symbols per byte-granular
  // 64-bit flush — one 8-byte store and pointer bump per group (the
  // bytes beyond the consumed count are rewritten by the next flush),
  // replacing per-byte push_back flushes. 4 symbols add <= 44 bits and
  // the post-flush residue is <= 7 bits, so the accumulator holds
  // <= 51 bits — no overflow.
  uint32_t entry[256];
  for (int s = 0; s < 256; ++s)
    entry[s] = t.codes[s] | (static_cast<uint32_t>(t.nb_bits[s]) << 12);
  std::vector<uint8_t> out(n * 11 / 8 + 24);  // worst case + store slack
  uint8_t* op = out.data();
  uint64_t acc = 0;
  int nbits = 0;
  size_t i = n;
  auto push = [&](size_t idx) {
    uint32_t e = entry[data[idx]];
    acc |= static_cast<uint64_t>(e & 0xFFF) << nbits;
    nbits += e >> 12;
  };
  while (i >= 4) {
    push(--i);
    push(--i);
    push(--i);
    push(--i);
    store64_le(op, acc);
    op += nbits >> 3;
    acc >>= nbits & ~7;
    nbits &= 7;
  }
  while (i > 0) push(--i);
  acc |= 1ull << nbits;  // close sentinel
  ++nbits;
  store64_le(op, acc);
  op += (nbits + 7) >> 3;
  out.resize(op - out.data());
  return out;
}

// Four-stream Huffman encode, interleaved: the 4-stream literal mode
// (n > 1023) encodes four independent segments, and running their four
// accumulator chains in ONE loop gives the out-of-order core 4-way ILP
// where sequential huf_stream calls serialized on each chain's
// acc/nbits dependency (measured ~2.5x on this stage). Per stream the
// emitted bytes are IDENTICAL to huf_stream (same push/flush cadence).
// seg = ceil(n/4); stream k covers [k*seg, min((k+1)*seg, n)).
static void huf_stream4(const uint8_t* data, size_t n,
                        const HuffmanTable& t,
                        std::vector<uint8_t> out[4], size_t seg) {
  uint32_t entry[256];
  for (int s = 0; s < 256; ++s)
    entry[s] = t.codes[s] | (static_cast<uint32_t>(t.nb_bits[s]) << 12);
  struct St {
    const uint8_t* d;
    size_t i;
    uint8_t* op;
    uint64_t acc = 0;
    int nbits = 0;
  } st[4];
  for (int k = 0; k < 4; ++k) {
    size_t len = k < 3 ? seg : n - 3 * seg;
    out[k].resize(len * 11 / 8 + 24);
    st[k] = {data + k * seg, len, out[k].data(), 0, 0};
  }
  auto push = [&](St& s) {
    uint32_t e = entry[s.d[--s.i]];
    s.acc |= static_cast<uint64_t>(e & 0xFFF) << s.nbits;
    s.nbits += e >> 12;
  };
  auto flush = [&](St& s) {
    store64_le(s.op, s.acc);
    s.op += s.nbits >> 3;
    s.acc >>= s.nbits & ~7;
    s.nbits &= 7;
  };
  while (st[0].i >= 4 && st[1].i >= 4 && st[2].i >= 4 && st[3].i >= 4) {
    for (int k = 0; k < 4; ++k) {
      St& s = st[k];
      push(s);
      push(s);
      push(s);
      push(s);
      flush(s);
    }
  }
  for (int k = 0; k < 4; ++k) {
    St& s = st[k];
    while (s.i >= 4) {
      push(s);
      push(s);
      push(s);
      push(s);
      flush(s);
    }
    while (s.i > 0) push(s);
    s.acc |= 1ull << s.nbits;  // close sentinel
    ++s.nbits;
    store64_le(s.op, s.acc);
    s.op += (s.nbits + 7) >> 3;
    out[k].resize(s.op - out[k].data());
  }
}

// ------------------------------------------------------- literals section

static void lit_header_rawrle(int lit_type, size_t n,
                              std::vector<uint8_t>* out) {
  if (n < 32) {
    out->push_back(static_cast<uint8_t>(lit_type | (n << 3)));
  } else if (n < 4096) {
    uint32_t v = lit_type | (1u << 2) | (static_cast<uint32_t>(n) << 4);
    out->push_back(v & 0xFF);
    out->push_back((v >> 8) & 0xFF);
  } else {
    uint32_t v = lit_type | (3u << 2) | (static_cast<uint32_t>(n) << 4);
    out->push_back(v & 0xFF);
    out->push_back((v >> 8) & 0xFF);
    out->push_back((v >> 16) & 0xFF);
  }
}

// Best of Raw / RLE / Huffman-compressed literals section.
bool encode_literals_section(const uint8_t* lit, size_t n, bool try_huffman,
                             std::vector<uint8_t>* out) {
  out->clear();
  bool all_same = n > 0;
  for (size_t i = 1; i < n && all_same; ++i) all_same = lit[i] == lit[0];
  if (n > 0 && all_same) {
    lit_header_rawrle(1 /*RLE*/, n, out);
    out->push_back(lit[0]);
    return true;
  }
  // Raw baseline.
  std::vector<uint8_t> raw;
  lit_header_rawrle(0 /*Raw*/, n, &raw);
  raw.insert(raw.end(), lit, lit + n);

  if (try_huffman && n >= 16) {
    // 4-way split histogram: independent sub-tables break the
    // store-forward dependency on repeated bytes (classic histogram
    // trick; n <= 128K keeps u32 counters safe).
    uint32_t h4[4][256] = {{0}};
    size_t hi = 0;
    for (; hi + 4 <= n; hi += 4) {
      ++h4[0][lit[hi]];
      ++h4[1][lit[hi + 1]];
      ++h4[2][lit[hi + 2]];
      ++h4[3][lit[hi + 3]];
    }
    for (; hi < n; ++hi) ++h4[0][lit[hi]];
    int64_t hist[256];
    for (int s = 0; s < 256; ++s)
      hist[s] = static_cast<int64_t>(h4[0][s]) + h4[1][s] + h4[2][s] +
                h4[3][s];
    HuffmanTable t;
    if (build_huffman(hist, &t)) {
      std::vector<uint8_t> tree;
      if (serialize_tree(t, &tree)) {
        bool four = n > 1023;
        std::vector<uint8_t> payload;
        if (!four) {
          payload = huf_stream(lit, n, t);
        } else {
          size_t seg = (n + 3) / 4;
          static thread_local std::vector<uint8_t> ss[4];
          huf_stream4(lit, n, t, ss, seg);
          if (ss[0].size() <= 0xFFFF && ss[1].size() <= 0xFFFF &&
              ss[2].size() <= 0xFFFF) {
            payload.reserve(6 + ss[0].size() + ss[1].size() +
                            ss[2].size() + ss[3].size());
            for (int k = 0; k < 3; ++k) {
              payload.push_back(ss[k].size() & 0xFF);
              payload.push_back((ss[k].size() >> 8) & 0xFF);
            }
            for (int k = 0; k < 4; ++k)
              payload.insert(payload.end(), ss[k].begin(), ss[k].end());
          }
        }
        size_t comp = tree.size() + payload.size();
        if (!payload.empty() || (!four && comp > 0)) {
          std::vector<uint8_t> sec;
          bool ok = true;
          if (!four) {
            if (n < 1024 && comp < 1024) {
              uint32_t v = 2u | (0u << 2) |
                           (static_cast<uint32_t>(n) << 4) |
                           (static_cast<uint32_t>(comp) << 14);
              sec = {static_cast<uint8_t>(v & 0xFF),
                     static_cast<uint8_t>((v >> 8) & 0xFF),
                     static_cast<uint8_t>((v >> 16) & 0xFF)};
            } else {
              ok = false;
            }
          } else if (n < (1u << 14) && comp < (1u << 14)) {
            uint32_t v = 2u | (2u << 2) | (static_cast<uint32_t>(n) << 4) |
                         (static_cast<uint32_t>(comp) << 18);
            sec = {static_cast<uint8_t>(v & 0xFF),
                   static_cast<uint8_t>((v >> 8) & 0xFF),
                   static_cast<uint8_t>((v >> 16) & 0xFF),
                   static_cast<uint8_t>((v >> 24) & 0xFF)};
          } else if (n < (1u << 18) && comp < (1u << 18)) {
            uint64_t v = 2u | (3u << 2) | (static_cast<uint64_t>(n) << 4) |
                         (static_cast<uint64_t>(comp) << 22);
            for (int i = 0; i < 5; ++i)
              sec.push_back(static_cast<uint8_t>((v >> (8 * i)) & 0xFF));
          } else {
            ok = false;
          }
          if (ok) {
            sec.insert(sec.end(), tree.begin(), tree.end());
            sec.insert(sec.end(), payload.begin(), payload.end());
            if (sec.size() < raw.size()) {
              *out = std::move(sec);
              return true;
            }
          }
        }
      }
    }
  }
  *out = std::move(raw);
  return true;
}

// ------------------------------------------------------ sequences section

// Code tables (RFC 8878 §3.1.1.3.2.1.1) — mirror format/tables.py.
static const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,   6,   7,   8,   9,    10,   11,
    12, 13, 14, 15, 16, 18,  20,  22,  24,  28,   32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const int LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,  15,  16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,  29,  30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59,  67,  83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const int ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const int LL_DEFAULT_DIST[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                        2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                        2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1,
                                        -1};
static const int ML_DEFAULT_DIST[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int OF_DEFAULT_DIST[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                        1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                        1, 1, 1, 1, -1, -1, -1, -1, -1};

// Code lookup: dense tables for the small values (where the bases are
// irregular), highbit for the large ones (where each code spans exactly
// one power-of-two range — LL_BASE[25+k] = 64<<k, ML_BASE[43+k] =
// 3 + (128<<k)). The old per-sequence binary searches were a measured
// hot spot of encode_sequences_section.
static inline int ll_code_search(uint32_t ll) {
  if (ll < 16) return static_cast<int>(ll);
  int lo = 16, hi = 35;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (LL_BASE[mid] <= ll)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}
static inline int ml_code_search(uint32_t ml) {
  if (ml <= 34) return static_cast<int>(ml - 3);
  int lo = 32, hi = 52;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (ML_BASE[mid] <= ml)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}
struct SeqCodeTables {
  uint8_t ll[64];   // ll < 64
  uint8_t ml[128];  // (ml - 3) < 128
  SeqCodeTables() {
    for (uint32_t v = 0; v < 64; ++v)
      ll[v] = static_cast<uint8_t>(ll_code_search(v));
    for (uint32_t v = 0; v < 128; ++v)
      ml[v] = static_cast<uint8_t>(ml_code_search(v + 3));
  }
};
static inline int ll_code(uint32_t ll) {
  static const SeqCodeTables t;
  return ll < 64 ? t.ll[ll] : highbit(ll) + 19;
}
static inline int ml_code(uint32_t ml) {
  static const SeqCodeTables t;
  uint32_t v = ml - 3;
  return v < 128 ? t.ml[v] : highbit(v) + 36;
}

struct TablePlan {
  int mode = 0;  // 0 predefined, 1 RLE, 2 FSE
  std::vector<uint8_t> desc;
  FseEncodeTable table;
  int rle_symbol = -1;
  double bit_cost = 0;
};

// Cached predefined encode tables (magic-static: thread-safe init, the
// MT block compressor hits this from every worker).
static const FseEncodeTable& predef_table(int kind) {
  struct Tables {
    FseEncodeTable ll, of, ml;
    Tables() {
      build_encode_table(
          std::vector<int>(LL_DEFAULT_DIST, LL_DEFAULT_DIST + 36), 6, &ll);
      build_encode_table(
          std::vector<int>(OF_DEFAULT_DIST, OF_DEFAULT_DIST + 29), 5, &of);
      build_encode_table(
          std::vector<int>(ML_DEFAULT_DIST, ML_DEFAULT_DIST + 53), 6, &ml);
    }
  };
  static const Tables t;
  return kind == 0 ? t.ll : (kind == 1 ? t.of : t.ml);
}

// Mode selection per code stream (mirrors format/sequences.py _plan_table).
// Takes the precomputed histogram (the caller builds all three stream
// histograms in one fused pass over the sequences — the old per-stream
// code rescan was a measured share of the section's cost). hist must
// cover [0, max_code]; n_codes is the sequence count.
static bool plan_table(const int64_t* hist, int max_code, size_t n_codes,
                       int kind, int max_accuracy, bool allow_custom,
                       TablePlan* plan) {
  const int* dist = kind == 0 ? LL_DEFAULT_DIST
                              : (kind == 1 ? OF_DEFAULT_DIST : ML_DEFAULT_DIST);
  int dist_n = kind == 0 ? 36 : (kind == 1 ? 29 : 53);
  int def_al = kind == 1 ? 5 : 6;

  int npresent = 0, only = max_code;
  for (int s = 0; s <= max_code; ++s)
    if (hist[s] > 0) {
      ++npresent;
      if (npresent == 1) only = s;
    }
  if (npresent == 1) {
    plan->mode = 1;
    plan->rle_symbol = only;
    plan->desc = {static_cast<uint8_t>(only)};
    return true;
  }
  bool predef_ok = max_code < dist_n;
  double predef_cost = 1e30;
  if (predef_ok) {
    predef_cost = 0;
    for (int s = 0; s <= max_code; ++s) {
      if (hist[s] == 0) continue;
      int p = dist[s] == -1 ? 1 : dist[s];
      predef_cost += hist[s] * (def_al - std::log2(double(p)));
    }
  }
  if (allow_custom && n_codes >= 2) {
    int nbits = 1;
    while ((size_t(1) << nbits) < n_codes) ++nbits;
    int accuracy = std::min(max_accuracy, std::max(5, nbits));
    static thread_local std::vector<int64_t> htrim;
    htrim.assign(hist, hist + max_code + 1);
    std::vector<int> norm;
    if (normalize_counts(htrim, accuracy,
                         static_cast<int64_t>(n_codes), &norm)) {
      std::vector<uint8_t> desc;
      if (write_ncount(norm, accuracy, &desc)) {
        double cost = 8.0 * desc.size();
        for (int s = 0; s <= max_code; ++s) {
          if (hist[s] == 0) continue;
          int p = static_cast<size_t>(s) < norm.size()
                      ? (norm[s] == -1 ? 1 : norm[s])
                      : 0;
          if (p <= 0) {
            cost = 1e30;
            break;
          }
          cost += hist[s] * (accuracy - std::log2(double(p)));
        }
        if (cost < predef_cost) {
          std::vector<int> nrm(norm);
          if (build_encode_table(nrm, accuracy, &plan->table)) {
            plan->mode = 2;
            plan->desc = std::move(desc);
            return true;
          }
        }
      }
    }
  }
  if (!predef_ok) return false;
  plan->mode = 0;
  plan->table = predef_table(kind);
  return true;
}

// Full Sequences_Section (mirrors format/sequences.py encode_sequences).
bool encode_sequences_section(const uint32_t* lit_lens,
                              const uint32_t* offsets,
                              const uint32_t* match_lens, size_t nseq,
                              bool allow_custom, bool first_block,
                              std::vector<uint8_t>* out) {
  out->clear();
  out->reserve(nseq * 3 + 64);
  size_t n = nseq;
  if (n < 128) {
    out->push_back(static_cast<uint8_t>(n));
  } else if (n < 0x7F00) {
    out->push_back(static_cast<uint8_t>((n >> 8) + 128));
    out->push_back(static_cast<uint8_t>(n & 0xFF));
  } else {
    out->push_back(0xFF);
    uint32_t v = static_cast<uint32_t>(n - 0x7F00);
    out->push_back(v & 0xFF);
    out->push_back((v >> 8) & 0xFF);
  }
  if (n == 0) return true;

  // offset_value stream with repcode compression (RFC 8878
  // §3.1.1.3.2.1.1; mirrors format/sequences.py offset_values): values
  // 1-3 name recent-offset slots. Incoming cross-block rep state is
  // unknown (blocks encode in parallel), so a slot is only used once
  // locally determined by explicit pushes.
  static thread_local std::vector<uint32_t> ofvs;  // per-block scratch
  ofvs.resize(n);
  {
    uint32_t reps[3] = {1, 4, 8};
    // Frame-first blocks get the spec initial history (RFC 8878
    // 3.1.1.5): all three slots usable immediately (ADVICE r2).
    int known = first_block ? 3 : 0;
    for (size_t i = 0; i < n; ++i) {
      uint32_t off = offsets[i];
      uint32_t ll = lit_lens[i];
      uint32_t v = 0;
      if (ll != 0) {
        if (known >= 1 && off == reps[0]) {
          v = 1;
        } else if (known >= 2 && off == reps[1]) {
          v = 2;
          uint32_t t[3] = {reps[1], reps[0], reps[2]};
          std::memcpy(reps, t, sizeof t);
        } else if (known >= 3 && off == reps[2]) {
          v = 3;
          uint32_t t[3] = {reps[2], reps[0], reps[1]};
          std::memcpy(reps, t, sizeof t);
        }
      } else {
        if (known >= 2 && off == reps[1]) {
          v = 1;
          uint32_t t[3] = {reps[1], reps[0], reps[2]};
          std::memcpy(reps, t, sizeof t);
        } else if (known >= 3 && off == reps[2]) {
          v = 2;
          uint32_t t[3] = {reps[2], reps[0], reps[1]};
          std::memcpy(reps, t, sizeof t);
        } else if (known >= 1 && off + 1 == reps[0] && off > 0) {
          v = 3;
          uint32_t t[3] = {off, reps[0], reps[1]};
          std::memcpy(reps, t, sizeof t);
          known = known < 3 ? known + 1 : 3;  // pushes a new value
        }
      }
      if (v == 0) {
        v = off + 3;
        uint32_t t[3] = {off, reps[0], reps[1]};
        std::memcpy(reps, t, sizeof t);
        known = known < 3 ? known + 1 : 3;
      }
      ofvs[i] = v;
    }
  }
  static thread_local std::vector<int> llc, ofc, mlc;  // scratch
  llc.resize(n);
  ofc.resize(n);
  mlc.resize(n);
  // Fused code derivation + histograms: one pass feeds all three
  // plan_table calls. Valid codes are LL 0-35, OF 0-31, ML 0-52
  // (out-of-alphabet inputs are rejected below before any indexing);
  // 72-wide counters keep the arrays one cache-line-rounded size.
  int64_t hll[72] = {0}, hof[72] = {0}, hml[72] = {0};
  int max_ll = 0, max_of = 0, max_ml = 0;
  for (size_t i = 0; i < n; ++i) {
    // Alphabet guard: the RFC code ranges are LL 0-35, ML 0-52. A
    // match_len < 3 (underflowing ml_code) or a length past the block
    // cap can only arrive through the raw ABI with invalid sequences;
    // refusing here (caller emits a raw block) is cheaper than letting
    // LL_BASE/ML_BASE index out of bounds in the encode loop below.
    if (match_lens[i] < 3) return false;
    int lc = ll_code(lit_lens[i]);
    int mc = ml_code(match_lens[i]);
    int oc = highbit(ofvs[i]);
    if (lc > 35 || mc > 52) return false;
    llc[i] = lc;
    mlc[i] = mc;
    ofc[i] = oc;
    ++hll[lc];
    ++hml[mc];
    ++hof[oc];
    max_ll = std::max(max_ll, lc);
    max_ml = std::max(max_ml, mc);
    max_of = std::max(max_of, oc);
  }
  TablePlan llp, ofp, mlp;
  if (!plan_table(hll, max_ll, n, 0, 9, allow_custom, &llp)) return false;
  if (!plan_table(hof, max_of, n, 1, 8, allow_custom, &ofp)) return false;
  if (!plan_table(hml, max_ml, n, 2, 9, allow_custom, &mlp)) return false;

  out->push_back(static_cast<uint8_t>((llp.mode << 6) | (ofp.mode << 4) |
                                      (mlp.mode << 2)));
  for (const TablePlan* p : {&llp, &ofp, &mlp})
    if (p->mode != 0)
      out->insert(out->end(), p->desc.begin(), p->desc.end());

  BackwardBitWriter w;
  // Worst case per sequence: 26 state bits + 63 extra bits < 12 bytes.
  w.reserve_bytes(n * 12 + 16);
  auto mk_state = [](const TablePlan& p, int first_sym, FseEncoder* e) {
    if (p.mode == 1) {
      e->rle = true;
    } else {
      e->init(&p.table, first_sym);
    }
  };
  FseEncoder mls, ofs, lls;
  mk_state(mlp, mlc[n - 1], &mls);
  mk_state(ofp, ofc[n - 1], &ofs);
  mk_state(llp, llc[n - 1], &lls);
  auto add_extra = [&](size_t i) {
    // Same bit order as three separate adds (LL extra lowest); the LL
    // and ML fields are already width-masked by construction and sum to
    // <= 32 bits, so they merge into one flush-checked add.
    int llb = LL_BITS[llc[i]];
    w.add(static_cast<uint64_t>(lit_lens[i] - LL_BASE[llc[i]]) |
              (static_cast<uint64_t>(match_lens[i] - ML_BASE[mlc[i]])
               << llb),
          llb + ML_BITS[mlc[i]]);
    w.add(ofvs[i] - (1u << ofc[i]), ofc[i]);
  };
  add_extra(n - 1);
  // Fused state step: the three FSE states' writes (<= 8 + 9 + 9 bits)
  // merge into one add per sequence — 3 adds/seq total instead of 6,
  // each under the writer's 32-bit flush ceiling.
  for (size_t ii = n - 1; ii-- > 0;) {
    uint64_t bits = 0;
    int tb = 0;
    if (!ofs.rle) {
      int nb = static_cast<int>(
          (ofs.state + ofs.t->delta_nb_bits[ofc[ii]]) >> 16);
      bits = static_cast<uint64_t>(ofs.state) & ((1ull << nb) - 1);
      tb = nb;
      ofs.state = ofs.t->state_table[(ofs.state >> nb) +
                                     ofs.t->delta_find_state[ofc[ii]]];
    }
    if (!mls.rle) {
      int nb = static_cast<int>(
          (mls.state + mls.t->delta_nb_bits[mlc[ii]]) >> 16);
      bits |= (static_cast<uint64_t>(mls.state) & ((1ull << nb) - 1))
              << tb;
      tb += nb;
      mls.state = mls.t->state_table[(mls.state >> nb) +
                                     mls.t->delta_find_state[mlc[ii]]];
    }
    if (!lls.rle) {
      int nb = static_cast<int>(
          (lls.state + lls.t->delta_nb_bits[llc[ii]]) >> 16);
      bits |= (static_cast<uint64_t>(lls.state) & ((1ull << nb) - 1))
              << tb;
      tb += nb;
      lls.state = lls.t->state_table[(lls.state >> nb) +
                                     lls.t->delta_find_state[llc[ii]]];
    }
    w.add(bits, tb);
    add_extra(ii);
  }
  mls.flush(&w);
  ofs.flush(&w);
  lls.flush(&w);
  std::vector<uint8_t> stream = w.close();
  out->insert(out->end(), stream.begin(), stream.end());
  return true;
}

// ------------------------------------------------------------- block body

// Compressed_Block content (literals + sequences). Returns false if the
// body cannot be built or would not fit dst_cap.
bool encode_block_body(const uint8_t* block, size_t block_len,
                       const uint32_t* lit_lens, const uint32_t* offsets,
                       const uint32_t* match_lens, size_t nseq,
                       uint32_t last_literals, bool allow_custom,
                       bool try_huffman, bool first_block,
                       std::vector<uint8_t>* out) {
  // Gather literal bytes into per-thread scratch (sized once; the
  // per-call reserve + growth reallocs measured on the MT profile).
  static thread_local std::vector<uint8_t> lits;
  size_t pos = 0;
  uint64_t span = last_literals;
  uint64_t nlit = last_literals;
  for (size_t i = 0; i < nseq; ++i) {
    span += lit_lens[i] + match_lens[i];
    nlit += lit_lens[i];
  }
  if (span != block_len) return false;
  if (lits.size() < nlit) lits.resize(nlit);
  uint8_t* lp = lits.data();
  for (size_t i = 0; i < nseq; ++i) {
    std::memcpy(lp, block + pos, lit_lens[i]);
    lp += lit_lens[i];
    pos += lit_lens[i] + match_lens[i];
  }
  std::memcpy(lp, block + pos, last_literals);
  lp += last_literals;

  std::vector<uint8_t> lit_sec, seq_sec;
  if (!encode_literals_section(lits.data(), static_cast<size_t>(nlit),
                               try_huffman, &lit_sec))
    return false;
  if (!encode_sequences_section(lit_lens, offsets, match_lens, nseq,
                                allow_custom, first_block, &seq_sec))
    return false;
  out->clear();
  out->reserve(lit_sec.size() + seq_sec.size());
  out->insert(out->end(), lit_sec.begin(), lit_sec.end());
  out->insert(out->end(), seq_sec.begin(), seq_sec.end());
  return true;
}

// ----------------------------------------------------- software match find

// Fast greedy/lazy hash-chain matcher — the native software fallback
// (role of libzstd's internal match finder for the reference). Mirrors
// golden/matcher.py semantics.
struct Sequence {
  uint32_t lit_len, offset, match_len;
};

static const uint32_t HASH_MUL = 2654435761u;

// Hash-chain match finder over base[0 .. ctx_len + n): the first ctx_len
// bytes are *window context* — raw bytes of earlier stream blocks that
// matches may reference (offsets up to ctx_len + block position) but that
// the emitted sequences never cover. This is what stock zstd's streaming
// window gives its matcher; the caller sizes ctx_len so every offset stays
// within the frame's declared window. ctx_len == 0 is the reference's
// stateless per-block mode (src/qatseqprod.c:941).
// Adaptive sequence pruning: drop matches whose estimated bit cost
// exceeds the literals they replace, using the block's measured byte
// entropy as the literal cost. This is how a fixed minimum-match length
// becomes content-adaptive: text (cheap 4-byte matches pay off) keeps
// them, high-entropy structured data (where short matches fragment the
// code streams for little gain) sheds them.
static void prune_sequences(const uint8_t* block, size_t n,
                            std::vector<Sequence>* seqs,
                            uint32_t* last_literals) {
  if (seqs->empty()) return;
  uint32_t hist[256] = {0};
  for (size_t i = 0; i < n; i += 2) ++hist[block[i]];  // sampled histogram
  double total = 0, bits = 0;
  for (int i = 0; i < 256; ++i) total += hist[i];
  for (int i = 0; i < 256; ++i)
    if (hist[i]) bits -= hist[i] * std::log2(hist[i] / total);
  double lit_bits = total > 0 ? bits / total : 8.0;
  if (lit_bits < 2.0) lit_bits = 2.0;
  // Marginal cost of one sequence: LL+ML+OF code symbols through FSE
  // (~9 bits combined) plus the offset's extra bits; rep continuations
  // (offset == previous) cost ~1 bit of offset code instead.
  const double SEQ_BASE = 9.0;
  size_t out = 0;
  uint64_t pend = 0;
  uint32_t prev_off = 0;
  for (size_t i = 0; i < seqs->size(); ++i) {
    Sequence s = (*seqs)[i];
    double of_bits = s.offset == prev_off
                         ? 1.0
                         : static_cast<double>(highbit(s.offset + 3));
    double cost = SEQ_BASE + of_bits;
    if (s.match_len * lit_bits < cost) {
      pend += s.lit_len + s.match_len;  // drop: bytes become literals
      continue;
    }
    s.lit_len += static_cast<uint32_t>(pend);
    pend = 0;
    prev_off = s.offset;
    (*seqs)[out++] = s;
  }
  *last_literals += static_cast<uint32_t>(pend);
  seqs->resize(out);
}

// Optional hints: device-discovered (position, offset) candidates that
// compete inside the parse. hint_pos is BLOCK-relative ascending match
// starts; hint_off the device's source distance at that position. This
// is the deep-level integration point (VERDICT r4 #3): instead of two
// full parses per block (device parse finished on host, then a host
// chain re-parse, keep the smaller body — the r4 best-of-two crutch),
// the chain parse runs ONCE with the accelerator's long-window finds as
// extra scored candidates, so the result dominates the host-only parse
// by construction and the device's contribution (multi-hundred-KB LDM
// offsets the 4-byte-gram chains cannot see) survives.
void find_sequences(const uint8_t* base, size_t ctx_len, size_t n,
                    int chain_depth, bool lazy, int mml,
                    std::vector<Sequence>* seqs, uint32_t* last_literals,
                    const uint32_t* hint_pos = nullptr,
                    const uint32_t* hint_len = nullptr,
                    const uint32_t* hint_off = nullptr,
                    size_t nhints = 0) {
  bool adaptive = mml <= 0;
  if (adaptive) mml = 4;
  if (mml < 3) mml = 3;
  seqs->clear();
  if (n < 5) {
    *last_literals = static_cast<uint32_t>(n);
    return;
  }
  const size_t total = ctx_len + n;
  const int hash_log = ctx_len ? 17 : 15;
  std::vector<int32_t> head(size_t(1) << hash_log, -1);
  std::vector<int32_t> prev(total, -1);
  auto hash_at = [&](size_t p) {
    uint32_t w;
    std::memcpy(&w, base + p, 4);
    return (w * HASH_MUL) >> (32 - hash_log);
  };
  auto insert = [&](size_t p) {
    uint32_t h = hash_at(p);
    prev[p] = head[h];
    head[h] = static_cast<int32_t>(p);
  };
  // Offset-priced candidate scoring (r5, mirroring the fast matcher's
  // r4 redesign and the finishing walk's match_gap): a candidate pays
  // ~1 byte per 8 offset bits plus a flat explicit-offset penalty, a
  // rep continuation pays nothing. Longest-wins picked far candidates
  // one byte longer than near ones and scattered the offset
  // distribution — measured as the selector's binary/mixed forfeit
  // (deep_select_diag: the walk's priced competition beat this parse
  // by 1-5% per structured block despite identical chains).
  // Cost floor per candidate: a sequence costs ~10 bits +
  // log2(offset) extra bits while literals cost ~5-6 bits/byte
  // post-Huffman, so short matches are net losses except very near.
  // mml is the level's general minimum (stock zstd's fast levels use
  // 6-7 for the same reason); rep continuations bypass the floor
  // entirely via rep_probe.
  auto best_match = [&](size_t p, uint32_t* off, int* score) -> size_t {
    size_t limit = total - p;
    *score = INT32_MIN;
    if (limit < 3) return 0;
    size_t best = 0;
    uint32_t boff = 0;
    int best_score = INT32_MIN;
    int32_t cand = head[hash_at(p)];
    int depth = chain_depth;
    while (cand >= 0 && depth > 0) {
      size_t l = lcp(base + cand, base + p, limit);
      // Quick reject: highbit(o) >= 0, so a candidate scores at most
      // l*8 - 8 — shorter candidates can't beat the incumbent and
      // skip the floor/pricing work (keeps the priced loop at the
      // longest-wins loop's cost for the common case).
      if (static_cast<int>(l) * 8 - 8 > best_score) {
        uint32_t o = static_cast<uint32_t>(p - cand);
        bool ok = l >= static_cast<size_t>(mml) ||
                  (l >= 4 && o <= 1024) || (l == 3 && o <= 64);
        if (l < 6 && o > 65536) ok = false;
        if (ok) {
          int sc = static_cast<int>(l) * 8 - highbit(o) - 8;
          if (sc > best_score) {
            best_score = sc;
            best = l;
            boff = o;
          }
        }
      }
      cand = prev[cand];
      --depth;
    }
    if (!best) return 0;
    *off = boff;
    *score = best_score;
    return best;
  };

  // Seed the chains with the context (stride 2: context anchors only need
  // to be findable, extension recovers exact lengths — half the seeding
  // cost of the block itself).
  if (ctx_len >= 4)
    for (size_t p = 0; p + 4 <= ctx_len; p += 2) insert(p);
  size_t lit_start = ctx_len;
  insert(ctx_len);
  size_t inserted_up_to = ctx_len + 1;
  size_t pos = ctx_len + 1;
  size_t safe_end = total - 4;  // last position with a full 4-byte window
  uint32_t rep = 0;  // previous sequence's offset (the decoder's rep1)
  // Rep probe: continuing the previous offset costs ~1 bit of offset
  // code vs ~log2(off) for an explicit one, so even a 3-byte rep match
  // beats literals and a rep match within 2 bytes of the chain's best
  // wins (stock zstd's matchers embed the same preference).
  auto rep_probe = [&](size_t p, size_t* lr) -> bool {
    if (rep == 0 || p < static_cast<size_t>(rep)) return false;
    size_t l = lcp(base + p - rep, base + p, total - p);
    *lr = l;
    return l >= 3;
  };
  size_t hcur = 0;  // hint cursor (hint_pos ascending, block-relative)
  while (pos < total) {
    if (pos > safe_end) {
      ++pos;
      continue;
    }
    uint32_t off = 0;
    int score = INT32_MIN;
    size_t len = best_match(pos, &off, &score);
    // Hint probe: the device claim COVERING this position, if any. A
    // verified claim [s, s+ml) at offset o sources every interior
    // position too (block[p..) matches block[p-o..) for p in the span),
    // so the device candidate competes wherever the parse cursor
    // actually lands — anchoring hints at claim STARTS only was measured
    // contributing nothing (the chain parse's cursor rarely lands on a
    // start). Verified by real bytes (lcp), same cost floor as the
    // chain's, longest-wins against the chain's best. Slot-quantized
    // LDM offsets (exact to +-the minimizer sample stride) get the same
    // +-63 slide the extension pass uses when the direct read is short.
    if (nhints) {
      while (hcur < nhints &&
             ctx_len + static_cast<size_t>(hint_pos[hcur]) +
                     hint_len[hcur] <=
                 pos)
        ++hcur;
      if (hcur < nhints &&
          ctx_len + static_cast<size_t>(hint_pos[hcur]) <= pos) {
        uint32_t ho = hint_off[hcur];
        size_t lh = 0;
        if (ho != 0 && static_cast<size_t>(ho) <= pos)
          lh = lcp(base + pos, base + pos - ho, total - pos);
        if (lh < 16 && ho > 32768) {
          for (uint32_t d = 1; d <= 63; ++d) {
            uint32_t cand2[2] = {ho - d, ho + d};
            for (uint32_t oc : cand2) {
              if (oc == 0 || static_cast<size_t>(oc) > pos) continue;
              const uint8_t* a = base + pos;
              if (pos + 8 <= total && rd64(a) != rd64(a - oc)) continue;
              size_t ls = lcp(a, a - oc, total - pos);
              if (ls >= 16 && ls > lh) {
                ho = oc;
                lh = ls;
                d = 64;
                break;
              }
            }
          }
        }
        bool hok = (lh >= static_cast<size_t>(mml) ||
                    (lh >= 4 && ho <= 1024) || (lh == 3 && ho <= 64)) &&
                   !(lh < 6 && ho > 65536);
        if (hok) {  // hok implies lh >= 3, hence ho != 0 (highbit safe)
          int hsc = static_cast<int>(lh) * 8 - highbit(ho) - 8;
          if (hsc > score) {
            len = lh;
            off = ho;
            score = hsc;
          }
        }
      }
    }
    // Rep continuation: pays no offset bits and keeps the rep chain
    // alive, so it competes at its full length against the priced
    // candidate score (the old length-based `lr + 2 >= len` rule was
    // this pricing for 64 KiB offsets; scoring generalizes it).
    size_t lr = 0;
    if (rep_probe(pos, &lr) && static_cast<int>(lr) * 8 >= score) {
      len = lr;
      off = rep;
      score = static_cast<int>(lr) * 8;
    }
    if (len == 0) {
      if (pos >= inserted_up_to) {
        insert(pos);
        inserted_up_to = pos + 1;
      }
      ++pos;
      continue;
    }
    if ((lazy || len < QZ_CHAIN_LAZY_BAR) && pos + 1 <= safe_end &&
        off != rep) {
      if (pos >= inserted_up_to) {
        insert(pos);
        inserted_up_to = pos + 1;
      }
      uint32_t noff = 0;
      int nscore = INT32_MIN;
      size_t nlen = best_match(pos + 1, &noff, &nscore);
      if (nlen && nscore > score + 8) {
        if (pos + 1 >= inserted_up_to) {
          insert(pos + 1);
          inserted_up_to = pos + 2;
        }
        ++pos;
        len = nlen;
        off = noff;
      }
    }
    // Backward extension into the pending literal run (zstd's standard
    // post-find gain; hash chains only anchor match *starts*).
    while (pos > lit_start && pos >= static_cast<size_t>(off) + 1 &&
           base[pos - 1] == base[pos - 1 - off]) {
      --pos;
      ++len;
    }
    seqs->push_back({static_cast<uint32_t>(pos - lit_start), off,
                     static_cast<uint32_t>(len)});
    rep = off;
    size_t end = pos + len;
    size_t step = len <= 64 ? 1 : std::max<size_t>(1, len / 32);
    size_t p = std::max(inserted_up_to, pos);
    size_t ins_end = std::min(end, safe_end + 1);
    while (p < ins_end) {
      insert(p);
      p += step;
    }
    inserted_up_to = std::min(end, total);
    pos = end;
    lit_start = end;
  }
  *last_literals = static_cast<uint32_t>(total - lit_start);
  if (adaptive) prune_sequences(base + ctx_len, n, seqs, last_literals);
}

// Streaming matcher: persistent hash table across a contiguous block
// range. find_sequences() re-seeds its table with the full window
// context for EVERY block (stride-2 over up to 384 KiB = 1.5x the
// block's own positions, again and again) — measured as the dominant
// cost of the software path. Here the table persists while the range
// advances, so context anchors are simply the positions inserted while
// compressing earlier blocks: zero re-seeding, denser anchors, same
// window reach. Chain storage is a fixed power-of-two ring over
// absolute positions; stale ring entries are rejected by the
// monotonic-decrease guard (a stale value is either smaller — walks
// still terminate — or out-of-window and the walk breaks), and every
// candidate is byte-compared before use, so staleness can cost a probe
// but never correctness.
struct StreamMatcher {
  const uint8_t* base;  // range base (frame-start-relative safety holds
                        // because cand >= 0 means offset <= pos)
  size_t range_len;
  size_t window;        // max offset (1 << window_log)
#ifndef QZ_SM_HASH_LOG
#define QZ_SM_HASH_LOG 17
#endif
  static constexpr int kHashLog = QZ_SM_HASH_LOG;
  size_t ring_mask;  // sized from the window (advisor r3: a fixed 2^20
                     // ring aliased under 2-4 MiB windows, silently
                     // truncating chains the window nominally grants)
  std::vector<int32_t> head;
  std::vector<int32_t> ring;

  static size_t ring_entries(size_t win) {
    // >= 2x the window so live chain links never alias, clamped to
    // [2^17, 2^23] (a 4 MiB window gets the full 2^23 = 32 MB ring).
    size_t e = size_t(1) << 17;
    while (e < 2 * win && e < (size_t(1) << 23)) e <<= 1;
    return e;
  }

  StreamMatcher(const uint8_t* b, size_t len, size_t win)
      : base(b), range_len(len), window(win),
        ring_mask(ring_entries(win) - 1),
        head(size_t(1) << kHashLog, -1),
        ring(ring_entries(win), -1) {}

  uint32_t hash_at(size_t p) const {
    uint32_t w;
    std::memcpy(&w, base + p, 4);
    return (w * HASH_MUL) >> (32 - kHashLog);
  }
  void insert(size_t p) {
    uint32_t h = hash_at(p);
    ring[p & ring_mask] = head[h];
    head[h] = static_cast<int32_t>(p);
  }

  // One block: same parse as find_sequences (greedy + optional lazy1,
  // rep probe, backward extension, cost floor), context implicit.
  void compress_block(size_t blk_off, size_t blk_len, int chain_depth,
                      bool lazy, int mml, std::vector<Sequence>* seqs,
                      uint32_t* last_literals) {
    bool adaptive = mml <= 0;
    if (adaptive) mml = 4;
    if (mml < 3) mml = 3;
    seqs->clear();
    if (blk_len < 5) {
      *last_literals = static_cast<uint32_t>(blk_len);
      // Keep the table warm even over runt blocks.
      for (size_t p = blk_off; p + 4 <= blk_off + blk_len; ++p) insert(p);
      return;
    }
    const size_t total = blk_off + blk_len;
    const size_t rmask = ring_mask;
    // Offset-priced candidate scoring — same pricing as the block-local
    // find_sequences above (r5): candidates pay highbit(offset)/8 bytes
    // plus a flat penalty, reps pay nothing, floor applied per
    // candidate so a far long candidate can no longer shadow a near
    // one that passes the floor.
    auto best_match = [&](size_t p, uint32_t* off, int* score) -> size_t {
      size_t limit = total - p;
      *score = INT32_MIN;
      if (limit < 3) return 0;
      size_t best = 0;
      uint32_t boff = 0;
      int best_score = INT32_MIN;
      int32_t cand = head[hash_at(p)];
      int depth = chain_depth;
      while (cand >= 0 && depth > 0) {
        size_t cp = static_cast<size_t>(cand);
        if (cp >= p || p - cp > window) break;  // stale or out-of-window
        size_t l = lcp(base + cp, base + p, limit);
        // Quick reject (see find_sequences): shorter-than-incumbent
        // candidates can't win under pricing; skip their floor work.
        if (static_cast<int>(l) * 8 - 8 > best_score) {
          uint32_t o = static_cast<uint32_t>(p - cp);
          bool ok = l >= static_cast<size_t>(mml) ||
                    (l >= 4 && o <= 1024) || (l == 3 && o <= 64);
          if (l < 6 && o > 65536) ok = false;
          if (ok) {
            int sc = static_cast<int>(l) * 8 - highbit(o) - 8;
            if (sc > best_score) {
              best_score = sc;
              best = l;
              boff = o;
            }
          }
        }
        int32_t nxt = ring[cp & rmask];
        if (nxt >= cand) break;  // stale ring entry: stop, never cycle
        cand = nxt;
        --depth;
      }
      if (!best) return 0;
      *off = boff;
      *score = best_score;
      return best;
    };

    size_t lit_start = blk_off;
    insert(blk_off);
    size_t inserted_up_to = blk_off + 1;
    size_t pos = blk_off + 1;
    size_t safe_end = total - 4;
    uint32_t rep = 0;
    auto rep_probe = [&](size_t p, size_t* lr) -> bool {
      if (rep == 0 || p < static_cast<size_t>(rep)) return false;
      size_t l = lcp(base + p - rep, base + p, total - p);
      *lr = l;
      return l >= 3;
    };
    while (pos < total) {
      if (pos > safe_end) {
        ++pos;
        continue;
      }
      uint32_t off = 0;
      int score = INT32_MIN;
      size_t len = best_match(pos, &off, &score);
      size_t lr = 0;
      if (rep_probe(pos, &lr) && static_cast<int>(lr) * 8 >= score) {
        len = lr;
        off = rep;
        score = static_cast<int>(lr) * 8;
      }
      if (len == 0) {
        if (pos >= inserted_up_to) {
          insert(pos);
          inserted_up_to = pos + 1;
        }
        ++pos;
        continue;
      }
      if ((lazy || len < QZ_CHAIN_LAZY_BAR) && pos + 1 <= safe_end &&
          off != rep) {
        if (pos >= inserted_up_to) {
          insert(pos);
          inserted_up_to = pos + 1;
        }
        uint32_t noff = 0;
        int nscore = INT32_MIN;
        size_t nlen = best_match(pos + 1, &noff, &nscore);
        if (nlen && nscore > score + 8) {
          if (pos + 1 >= inserted_up_to) {
            insert(pos + 1);
            inserted_up_to = pos + 2;
          }
          ++pos;
          len = nlen;
          off = noff;
        }
      }
      while (pos > lit_start && pos >= static_cast<size_t>(off) + 1 &&
             base[pos - 1] == base[pos - 1 - off]) {
        --pos;
        ++len;
      }
      seqs->push_back({static_cast<uint32_t>(pos - lit_start), off,
                       static_cast<uint32_t>(len)});
      rep = off;
      size_t end = pos + len;
      size_t step = len <= 64 ? 1 : std::max<size_t>(1, len / 32);
      size_t p = std::max(inserted_up_to, pos);
      size_t ins_end = std::min(end, safe_end + 1);
      while (p < ins_end) {
        insert(p);
        p += step;
      }
      inserted_up_to = std::min(end, total);
      pos = end;
      lit_start = end;
    }
    *last_literals = static_cast<uint32_t>(total - lit_start);
    if (adaptive)
      prune_sequences(base + blk_off, blk_len, seqs, last_literals);
  }

#ifndef QZ_FAST_INS_STRIDE
#define QZ_FAST_INS_STRIDE 2
#endif
#ifndef QZ_FAST_ACCEL
#define QZ_FAST_ACCEL 8
#endif
#ifndef QZ_FAST_REP_TAKE
#define QZ_FAST_REP_TAKE 64
#endif
#ifndef QZ_FAST_REP_MIN
#define QZ_FAST_REP_MIN 4
#endif
#ifndef QZ_FAST_REP_BONUS
#define QZ_FAST_REP_BONUS 8
#endif
#ifndef QZ_FAST_LAZY
#define QZ_FAST_LAZY 64
#endif
  // ---- Single-probe fast matcher (the fast-level strategy) ----
  //
  // Stock zstd maps its fastest levels to exactly this shape (one hash
  // table entry per probe, no chains, acceleration stepping over
  // incompressible stretches); the chain matcher above was measured at
  // ~72% of the software path's time at L1, almost all of it chain-walk
  // loads and per-position inserts. Here each scan position costs one
  // table load + one store; positions skipped by acceleration cost
  // nothing at all. The table persists across blocks exactly like the
  // chain table (streaming context), candidates are byte-verified, and
  // the window/ordering guards reject stale entries, so staleness can
  // cost a probe but never correctness.
#ifndef QZ_FAST_HASH_LOG
#define QZ_FAST_HASH_LOG 17
#endif
  static constexpr int kFastHashLog = QZ_FAST_HASH_LOG;
  // 2-way entries interleaved in one u64 (low 32 = most recent, high 32
  // = previous): both candidates arrive in ONE cache-line touch and the
  // shift-in update is one store — the split-array layout paid two
  // misses per probe on the 1 MB of tables (measured ~12% of the
  // matcher).
  std::vector<uint64_t> fpair;
  std::vector<int32_t> lhead;   // 8-byte-gram table (L2 long probe)

  uint32_t fhash_at(size_t p) const {
    // 6-byte gram (matches the fast levels' mml=6 general minimum):
    // low 48 bits of the little-endian word, golden-ratio mixed.
    uint64_t w;
    std::memcpy(&w, base + p, 8);
    return static_cast<uint32_t>(((w << 16) * 0x9E3779B185EBCA87ull) >>
                                 (64 - kFastHashLog));
  }
  void ensure_fast_tables() {
    if (fpair.empty())
      fpair.assign(size_t(1) << kFastHashLog, ~uint64_t(0));  // -1, -1
  }
  void insert_fast(size_t p) {
    uint32_t h = fhash_at(p);
    fpair[h] = (fpair[h] << 32) | static_cast<uint32_t>(p);
    if (!lhead.empty()) lhead[lhash_at(p)] = static_cast<int32_t>(p);
  }
  uint32_t lhash_at(size_t p) const {  // full 8-byte gram
    uint64_t w;
    std::memcpy(&w, base + p, 8);
    return static_cast<uint32_t>((w * 0x9E3779B185EBCA87ull) >>
                                 (64 - kFastHashLog));
  }

  // use_long (the L2 point): adds a second single-probe table keyed on
  // the full 8-byte gram, probed alongside the 6-gram table — the
  // double-table strategy stock zstd uses one level above its fastest
  // (long hits are near-certain real matches >= 8, so they displace
  // shorter 6-gram candidates and upgrade the parse without chains).
  void compress_block_fast(size_t blk_off, size_t blk_len, int mml,
                           bool use_long, std::vector<Sequence>* seqs,
                           uint32_t* last_literals) {
    bool adaptive = mml <= 0;
    if (adaptive) mml = 4;
    if (mml < 4) mml = 4;
    seqs->clear();
    ensure_fast_tables();
    if (use_long && lhead.empty())
      lhead.assign(size_t(1) << kFastHashLog, -1);
    const size_t total = blk_off + blk_len;
    if (blk_len < 16) {
      *last_literals = static_cast<uint32_t>(blk_len);
      return;
    }
    const size_t safe_end = total - 8;  // fhash_at / rd64 window
    auto match_len_at = [&](size_t p, uint32_t o) -> size_t {
      return lcp(base + p, base + p - o, total - p);
    };
    size_t lit_start = blk_off;
    size_t pos = blk_off;
    uint32_t rep = 0;
    while (pos <= safe_end) {
      size_t len = 0;
      uint32_t off = 0;
      size_t scan = pos;
      // --- probe with acceleration: step grows with the literal run ---
      // Software-pipelined: the NEXT scan position's hash is computed
      // and its table line prefetched while the current position's
      // candidates verify — the fpair load (1 MB table, routinely a
      // cache miss) was the dominant stall of this loop. The step
      // depends only on (scan, lit_start), so the next position is
      // known before the current one resolves.
      uint32_t h = scan <= safe_end ? fhash_at(scan) : 0;
      while (scan <= safe_end) {
        size_t nscan = scan + 1 + ((scan - lit_start) >> QZ_FAST_ACCEL);
        uint32_t hn = 0;
        if (nscan <= safe_end) {
          hn = fhash_at(nscan);
          __builtin_prefetch(&fpair[hn]);
          // Second-order prefetch: one iteration of lookahead only
          // partially covers the fpair miss latency on a cold line;
          // the step function is deterministic, so the line after next
          // is known too (~4 cycles of extra hash math vs ~100 saved).
          size_t n2 = nscan + 1 + ((nscan - lit_start) >> QZ_FAST_ACCEL);
          if (n2 <= safe_end) __builtin_prefetch(&fpair[fhash_at(n2)]);
        }
        // 2-way stays: a 1-way table measured +1.5% ratio on mixed and
        // +4% on text for ~+8% speed — the wrong trade for this path.
        uint64_t pr = fpair[h];
        int32_t cand0 = static_cast<int32_t>(pr);
        int32_t cand1 = static_cast<int32_t>(pr >> 32);
        int32_t candL = -1;
        fpair[h] = (pr << 32) | static_cast<uint32_t>(scan);
        if (use_long) {
          uint32_t lh = lhash_at(scan);
          candL = lhead[lh];
          lhead[lh] = static_cast<int32_t>(scan);
        }
        size_t lr = 0;
        if (rep && scan >= static_cast<size_t>(rep) &&
            rd32(base + scan) == rd32(base + scan - rep))
          lr = match_len_at(scan, rep);
        // Score competition, offset-aware (r4 redesign; measured on the
        // multi-corpus probe): a rep continuation scores its full length
        // (of_val=1 costs zero offset bits and keeps the rep chain
        // alive); a table candidate pays its offset bits (~1 byte per 8)
        // plus a flat explicit-offset penalty. Longest-wins scattered
        // the offset distribution (+16% vs stock on structured records);
        // unconditional rep-first truncated matches (+19%); the priced
        // compromise beats both on every probe corpus.
        int best_score = lr >= QZ_FAST_REP_MIN
                             ? static_cast<int>(lr) * 8
                             : INT32_MIN;
        if (best_score > INT32_MIN) {
          len = lr;
          off = rep;
        }
        // Rep early-out (same 64-byte bar as the finishing walk's): a
        // long rep continuation pays zero offset bits, so a candidate
        // upset past 64 bytes is a rounding error and the candidate
        // verifies it saves are the probe loop's dominant cost.
        // Measured: +2-3% speed, binary corpus +0.15% size.
        if (lr >= QZ_FAST_REP_TAKE) break;
        for (int32_t cand : {candL, cand0, cand1}) {
          if (cand < 0) continue;
          size_t cp = static_cast<size_t>(cand);
          if (cp < scan && scan - cp <= window &&
              rd32(base + cp) == rd32(base + scan)) {
            size_t l = match_len_at(scan,
                                    static_cast<uint32_t>(scan - cp));
            uint32_t o = static_cast<uint32_t>(scan - cp);
            // Same cost floor as the chain matcher: short matches pay
            // only when near.
            bool ok = l >= static_cast<size_t>(mml) ||
                      (l >= 4 && o <= 1024);
            if (l < 6 && o > 65536) ok = false;
            int score = static_cast<int>(l) * 8 - highbit(o) -
                        QZ_FAST_REP_BONUS;
            if (ok && score > best_score) {
              best_score = score;
              len = l;
              off = o;
            }
          }
        }
        if (len) break;
        scan = nscan;
        h = hn;
      }
      if (!len) break;  // no more matches in the block
      // Mini-lazy (r5, default on): a non-rep find below the bar
      // checks the next position's candidates once; a match there
      // that is 2+ bytes longer pays for the extra literal and
      // de-fragments the parse. This was the text residual's root
      // cause (6-8-byte matches where stock finds 9-16): measured at
      // 8 MB, text L1 1.0203x -> 0.926x stock, mixed -2.8%, binary
      // -1.1%, redundant unchanged, speed flat (fewer sequences to
      // entropy-encode pays for the probe: one table load + <= 2
      // verifies, only on short finds). QZ_FAST_LAZY=0 disables.
      if (QZ_FAST_LAZY && len < QZ_FAST_LAZY && off != rep &&
          scan + 1 <= safe_end) {
        uint32_t h1 = fhash_at(scan + 1);
        uint64_t pr1 = fpair[h1];
        int32_t c10 = static_cast<int32_t>(pr1);
        int32_t c11 = static_cast<int32_t>(pr1 >> 32);
        fpair[h1] = (pr1 << 32) | static_cast<uint32_t>(scan + 1);
        // The long (8-gram) table joins the probe on use_long levels —
        // it is exactly where the longer match the lazy step hunts
        // tends to live when the 6-gram bucket was evicted.
        int32_t c1L = -1;
        if (use_long) {
          uint32_t lh1 = lhash_at(scan + 1);
          c1L = lhead[lh1];
          lhead[lh1] = static_cast<int32_t>(scan + 1);
        }
        size_t l1 = 0;
        uint32_t o1 = 0;
        for (int32_t cand : {c1L, c10, c11}) {
          if (cand < 0) continue;
          size_t cp = static_cast<size_t>(cand);
          if (cp < scan + 1 && scan + 1 - cp <= window &&
              rd32(base + cp) == rd32(base + scan + 1)) {
            size_t l = match_len_at(scan + 1,
                                    static_cast<uint32_t>(scan + 1 - cp));
            if (l > l1) {
              l1 = l;
              o1 = static_cast<uint32_t>(scan + 1 - cp);
            }
          }
        }
        if (l1 >= len + 2 && l1 >= 6) {
          ++scan;
          len = l1;
          off = o1;
        }
      }
      // Backward extension into the pending literal run.
      while (scan > lit_start && scan >= static_cast<size_t>(off) + 1 &&
             base[scan - 1] == base[scan - 1 - off]) {
        --scan;
        ++len;
      }
      seqs->push_back({static_cast<uint32_t>(scan - lit_start), off,
                       static_cast<uint32_t>(len)});
      rep = off;
      size_t end = scan + len;
      // In-match inserts, stride QZ_FAST_INS_STRIDE (diag knob).
      // Full-density inserts for short matches were tried (r5): text
      // -1.15% / mixed -0.7% at 8 MB, but the denser interiors evict
      // the 2-way buckets' long-range anchors and the high-redundancy
      // corpus regressed 2.4x at 1 MB (155 KB -> 370 KB) — the
      // per-corpus gate caught it. Sampled stride stays.
      {
        size_t q = scan + 2;
        size_t qe = std::min(end >= 2 ? end - 2 : 0, safe_end);
        size_t qstep = QZ_FAST_INS_STRIDE;
        while (q <= qe && q <= safe_end) {
          insert_fast(q);
          q += qstep;
        }
        if (end >= 2 && end - 2 <= safe_end && end - 2 > scan + 2)
          insert_fast(end - 2);
      }
      pos = end;
      lit_start = end;
    }
    *last_literals = static_cast<uint32_t>(total - lit_start);
    if (adaptive)
      prune_sequences(base + blk_off, blk_len, seqs, last_literals);
  }
};

}  // namespace qz

// =============================================================== C ABI

extern "C" {

uint64_t qz_xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  return qz::xxh64(p, n, seed);
}

// Incremental XXH64 (streaming frames accumulate their content checksum
// block by block, mirroring stateless per-block processing with only a
// cursor carried — the checkpoint/resume posture of the stream layer).
struct QzXxhState {
  uint64_t acc[4];
  uint8_t buf[32];
  size_t buf_len;
  uint64_t total;
  uint64_t seed;
};

void qz_xxh64_init(QzXxhState* s, uint64_t seed) {
  s->acc[0] = seed + qz::P1 + qz::P2;
  s->acc[1] = seed + qz::P2;
  s->acc[2] = seed;
  s->acc[3] = seed - qz::P1;
  s->buf_len = 0;
  s->total = 0;
  s->seed = seed;
}

void qz_xxh64_update(QzXxhState* s, const uint8_t* p, size_t n) {
  s->total += n;
  if (s->buf_len) {
    size_t need = 32 - s->buf_len;
    size_t take = n < need ? n : need;
    std::memcpy(s->buf + s->buf_len, p, take);
    s->buf_len += take;
    p += take;
    n -= take;
    if (s->buf_len == 32) {
      for (int i = 0; i < 4; ++i)
        s->acc[i] = qz::xxh_round(s->acc[i], qz::rd64(s->buf + 8 * i));
      s->buf_len = 0;
    }
  }
  while (n >= 32) {
    for (int i = 0; i < 4; ++i)
      s->acc[i] = qz::xxh_round(s->acc[i], qz::rd64(p + 8 * i));
    p += 32;
    n -= 32;
  }
  if (n) {
    std::memcpy(s->buf, p, n);
    s->buf_len = n;
  }
}

uint64_t qz_xxh64_digest(const QzXxhState* s) {
  uint64_t h;
  if (s->total >= 32) {
    h = qz::rotl64(s->acc[0], 1) + qz::rotl64(s->acc[1], 7) +
        qz::rotl64(s->acc[2], 12) + qz::rotl64(s->acc[3], 18);
    for (int i = 0; i < 4; ++i) h = qz::xxh_merge(h, s->acc[i]);
  } else {
    h = s->seed + qz::P5;
  }
  h += s->total;
  const uint8_t* p = s->buf;
  const uint8_t* end = s->buf + s->buf_len;
  while (p + 8 <= end) {
    h ^= qz::xxh_round(0, qz::rd64(p));
    h = qz::rotl64(h, 27) * qz::P1 + qz::P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(qz::rd32(p)) * qz::P1;
    h = qz::rotl64(h, 23) * qz::P2 + qz::P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * qz::P5;
    h = qz::rotl64(h, 11) * qz::P1;
    ++p;
  }
  h ^= h >> 33;
  h *= qz::P2;
  h ^= h >> 29;
  h *= qz::P3;
  h ^= h >> 32;
  return h;
}

size_t qz_xxh64_state_size(void) { return sizeof(QzXxhState); }

// Block body from externally produced sequences (e.g. the TPU pipeline).
// Returns body size, or 0 if not encodable/beneficial (caller emits raw).
size_t qz_block_body(const uint8_t* block, size_t block_len,
                     const uint32_t* lit_lens, const uint32_t* offsets,
                     const uint32_t* match_lens, size_t nseq,
                     uint32_t last_literals, int allow_custom,
                     int try_huffman, int first_block, uint8_t* dst,
                     size_t dst_cap) {
  std::vector<uint8_t> body;
  if (!qz::encode_block_body(block, block_len, lit_lens, offsets, match_lens,
                             nseq, last_literals, allow_custom != 0,
                             try_huffman != 0, first_block != 0, &body))
    return 0;
  if (body.size() > dst_cap) return 0;
  std::memcpy(dst, body.data(), body.size());
  return body.size();
}

// Extend device-produced matches with real byte comparisons.
//
// The TPU pipeline caps sort-derived match lengths at 16 bytes (carried
// content words); this pass re-extends each match to its true length and
// re-parses the tail: consumed sequences are trimmed or dropped (front-
// trimming a match is always valid — the source only moves forward).
// Equivalent in spirit to the reference's division of labor where cheap
// post-processing on the host finishes what the accelerator started
// (QZSTD_decLz4s's token fix-ups, src/qatseqprod.c:1013-1091).
//
// Arrays are modified in place; returns the new sequence count.
// `base` holds ctx_len bytes of window context followed by the n-byte
// block: extension compares may read into the context (offsets can reach
// ctx_len + position back), but sequences still cover only the block.
// Gap fill: re-match long literal runs against the cross-block window
// context. The device match pipeline is block-local (its windows cannot
// reach earlier blocks), so multi-block redundancy shows up as literal
// runs in its output; this pass probes ONLY those gap bytes against a
// hash table seeded with the context and the already-matched regions —
// far cheaper than a full software re-match, and it runs after
// qz_extend_sequences so inputs are verified sequences. Arrays are
// rewritten in place (capacity `cap`); returns the new count or
// SIZE_MAX on overflow.
size_t qz_fill_gaps(const uint8_t* base, size_t ctx_len, size_t n,
                    uint32_t* lit_lens, uint32_t* offsets,
                    uint32_t* match_lens, size_t nseq,
                    uint32_t* last_literals, size_t cap, int chain_depth,
                    int mml, int min_gap, int relaxed) {
  if (n < 8) return nseq;
  const size_t total = ctx_len + n;
  // min_gap >= 2^20 (bigger than any block) = competition-only mode:
  // gap probing off, but the walk still runs so every claim faces the
  // chain competition.
  const bool comp_only = min_gap >= (1 << 20);
  if (min_gap < 4) min_gap = 4;
  if (mml < 4) mml = 4;
  // Early exit: no qualifying gap means nothing to probe, and the
  // table seed below (up to a full window of context at stride 2, per
  // block) is the expensive part — skip all of it. Device-parsed blocks
  // are usually densely covered, so this is the common case.
  if (!comp_only) {
    bool any_gap = *last_literals >= static_cast<uint32_t>(min_gap);
    for (size_t i = 0; !any_gap && i < nseq; ++i)
      any_gap = lit_lens[i] >= static_cast<uint32_t>(min_gap);
    if (!any_gap) return nseq;
  }
  const int hash_log = 17;
  // Thread-local scratch: the table alloc + fill (0.5 MB head + up to
  // 2.5 MB prev per call) measured as a real share of this pass's cost.
  // head must reset between calls (memset); prev needs no reset — stale
  // entries are only reachable through head chains, which are fresh.
  static thread_local std::vector<int32_t> head, prev;
  head.assign(size_t(1) << hash_log, -1);
  if (prev.size() < total) prev.resize(total);
  // 6-byte-gram hash (stock L1's mls): 4-gram chains on text are so
  // overloaded that a depth-4 walk never surfaces the 6-8 byte matches
  // the gaps actually hold (measured: stock emits 10k 6-8B matches per
  // text block, the 4-gram fill found 2/3 of them). Callers need 8
  // readable bytes per hashed position.
  auto hash_at = [&](size_t p) {
    uint64_t w;
    std::memcpy(&w, base + p, 8);
    return static_cast<uint32_t>(((w << 16) * 0x9E3779B185EBCA87ull) >>
                                 (64 - hash_log));
  };
  auto insert = [&](size_t p) {
    uint32_t h = hash_at(p);
    prev[p] = head[h];
    head[h] = static_cast<int32_t>(p);
  };
  // Seed the context at an adaptive stride: a block with few gap bytes
  // cannot repay a dense seed of up to a full window (the seed, not the
  // probing, dominates this pass's cost). Block-local positions insert
  // as the walk passes them (matched spans at stride 2, probed gap
  // bytes at stride 1), so candidates always precede the probe.
  size_t gap_bytes = *last_literals;
  for (size_t i = 0; i < nseq; ++i)
    if (lit_lens[i] >= static_cast<uint32_t>(min_gap))
      gap_bytes += lit_lens[i];
  size_t ctx_stride =
      comp_only ? 2
                : (gap_bytes >= 8192 ? 2 : (gap_bytes >= 1024 ? 4 : 8));
  // Seed with a prefetch horizon: the chained head/prev stores hit a
  // random line of the 0.5 MB head table per position, and this loop
  // (up to a full window of context per block) measured ~40% of the
  // whole pass. Recomputing the hash for the prefetch costs ~4 cycles
  // against a ~100-cycle miss.
  {
    const size_t ahead = 8 * ctx_stride;
    for (size_t p = 0; p + 8 <= ctx_len; p += ctx_stride) {
      if (p + ahead + 8 <= ctx_len)
        __builtin_prefetch(&head[hash_at(p + ahead)]);
      insert(p);
    }
  }
  // Rep state threaded through the WHOLE walk (emitted gap matches and
  // the original sequences both advance it, mirroring the decoder's
  // view): a gap match at the current rep offset costs ZERO offset bits
  // (of_val=1) and leaves the stream's offset distribution untouched, so
  // it is priced far below a fresh explicit offset (VERDICT r4:
  // repcode-aware gap-fill).
  uint32_t rep = 0;
  // Probe [p, limit_abs): rep continuation + chain candidates, scored.
  auto match_gap = [&](size_t p, size_t limit_abs, uint32_t* off) -> size_t {
    size_t limit = std::min(limit_abs, total) - p;
    if (limit < 3) return 0;
    size_t lrep = 0;
    if (rep && p >= static_cast<size_t>(rep))
      lrep = qz::lcp(base + p, base + p - rep, limit);
    // Rep early-out: a 64+ byte rep continuation pays zero offset bits;
    // a chain candidate would need >= lrep + highbit(off)/8 extra bytes
    // to outscore it, and the chain walk it saves is the dominant
    // per-probe cost (measured 47% of the consumption pass in
    // match_gap). The bar sits at 64 because structured records DO
    // field longer same-period candidates against mid-length rep
    // continuations (a 16-byte bar measured a 1.2% binary-corpus ratio
    // loss); past 64 bytes an upset is a rounding error.
    if (lrep >= 64) {
      *off = rep;
      return lrep;
    }
    size_t best = 0;
    uint32_t boff = 0;
    if (limit >= 4 && p + 8 <= total) {  // hash_at reads 8 bytes
      int32_t cand = head[hash_at(p)];
      int depth = chain_depth < 4 ? 4 : chain_depth;
      while (cand >= 0 && depth > 0) {
        if (static_cast<size_t>(cand) < p) {  // skip later-seeded entries
          size_t l = qz::lcp(base + cand, base + p, limit);
          if (l > best) {
            best = l;
            boff = static_cast<uint32_t>(p - cand);
          }
          --depth;
        }
        cand = prev[cand];
      }
    }
    // Stricter economics than the primary matcher: a gap match also
    // perturbs the established LL/ML/OF code distributions and the rep
    // chain, so it must clearly pay — near matches at the level's mml,
    // mid-range from 8 bytes, far (cross-block) from 12. The syncmer
    // speed point (pair-sampled device anchors) leaves SHORT local
    // matches in its gaps by construction, so it passes relaxed=1 and
    // gets the extension walk's cost model instead (the gaps there are
    // genuinely unmatched bytes, not strategically skipped ones).
    bool worth;
    if (relaxed) {
      worth = (best >= 8) || (best >= 6 && boff <= 32768) ||
              (best >= 5 && boff <= 4096) || (best >= 4 && boff <= 256);
    } else {
      worth = (best >= 12) || (best >= 8 && boff <= 65536) ||
              (best >= static_cast<size_t>(mml) && boff <= 1024);
    }
    if (!worth) best = 0;
    // Scored competition: the rep continuation pays no offset bits and
    // bypasses the economics filter entirely (it cannot perturb what it
    // repeats); an explicit candidate pays ~1 byte per 8 offset bits.
    int sc_rep = lrep >= 3 ? static_cast<int>(lrep) * 8 : INT32_MIN;
    int sc_cand = best ? static_cast<int>(best) * 8 - qz::highbit(boff)
                       : INT32_MIN;
    if (sc_rep >= sc_cand) {
      if (lrep < 3) return 0;
      *off = rep;
      return lrep;
    }
    *off = boff;
    return best;
  };

  // Unified forward walk over the block. Claims (the extension pass's
  // verified sequences) and gap probes compete on one timeline: a gap
  // match may extend PAST the gap into following claims — the old
  // per-gap scan hard-capped every gap match at the gap end, measured
  // as the fragmentation signature on text (10k 3-5 byte matches vs
  // stock's 410; matches systematically one bucket shorter). Coverage
  // never decreases: an overrunning gap match either consumes a claim
  // whole, front-trims it to >= 4 bytes (front-trim of a verified
  // match stays verified), or is capped so the claim survives.
  std::vector<qz::Sequence> out;
  out.reserve(nseq + 64);
  uint64_t lead = 0;        // literal bytes immediately preceding p
  size_t p = ctx_len;       // walk cursor
  size_t i = 0;             // next claim
  size_t Li = ctx_len;      // claim i's literal-run start (absolute)
  auto insert_span = [&](size_t s, size_t e) {
    for (size_t q = s; q + 8 <= std::min(e, total); q += 2) insert(q);
  };
  // Cap a match starting at p2 so a downstream claim [Mj, Ej) either
  // gets consumed whole or survives with >= 4 bytes (front-trim of a
  // verified match stays verified); Ej - 4 >= Mj always, so the cap
  // never lands before the claim start.
  auto cap_overrun = [](size_t p2, size_t len, size_t Mj,
                        size_t Ej) -> size_t {
    if (p2 + len > Mj && p2 + len < Ej && Ej - (p2 + len) < 4)
      return Ej - 4 - p2;
    return len;
  };
  while (p < total || i < nseq) {
    const size_t Mi = i < nseq ? Li + lit_lens[i] : total;  // claim start
    const size_t Ei = i < nseq ? Mi + match_lens[i] : total;
    if (i < nseq && p >= Mi) {
      // Cursor reached (or overran into/past) claim i's match span.
      // Untouched claims (p == Mi) emit at the format's 3-byte floor;
      // only front-trimmed remnants require >= 4 (a trimmed verified
      // match stays verified, but a 3-byte remnant of one prices worse
      // than letting the rep probe reclaim it — and cap_overrun's
      // Ej-4 >= p2 bound assumes remnants of < 4 never emit).
      if (p < Ei && (Ei - p >= 4 || (p == Mi && Ei - p >= 3))) {
        size_t ml = Ei - p;
        uint32_t off = offsets[i];
        // Claim competition: the chain may know a longer or nearer
        // source than the device's sampled anchors could see (syncmer
        // pair-sampling keeps only half the candidate positions, so
        // the nearest sampled occurrence is often not the nearest
        // occurrence — measured as systematically shorter matches on
        // text). Same pricing as the extension walk: ~1 byte per 8
        // offset bits, reps free. Gated: claims already at the walk's
        // rep offset skip the probe (a competitor pays offset bits the
        // rep doesn't, so it must be strictly LONGER to win — rare
        // against an established continuation); claims at any other
        // offset always compete, because converting a churning offset
        // to a rep of equal length is exactly the structured-records
        // fix the competition exists for (r4: binary L1 1.06 -> 0.96).
        if (off != rep || ml < 32) {
          uint32_t off2 = 0;
          size_t l2 = match_gap(p, total, &off2);
          if (l2 >= 4) {
            size_t Mn = total, En = total;
            if (i + 1 < nseq) {
              Mn = Ei + lit_lens[i + 1];
              En = Mn + match_lens[i + 1];
            }
            l2 = cap_overrun(p, l2, Mn, En);
            int sc_new = static_cast<int>(l2) * 8 -
                         (off2 == rep ? 0 : qz::highbit(off2 | 1));
            int sc_old = static_cast<int>(ml) * 8 -
                         (off == rep ? 0 : qz::highbit(off | 1));
            if (l2 >= 4 && sc_new > sc_old) {
              ml = l2;
              off = off2;
            }
          }
        }
        out.push_back({static_cast<uint32_t>(lead), off,
                       static_cast<uint32_t>(ml)});
        rep = off;
        lead = 0;
        insert_span(p, p + ml);
        p += ml;
      }
      // else: runt after trimming — its bytes stay at p and fall into
      // the following gap for re-probing (rep continuations often
      // reclaim them at zero offset cost).
      ++i;
      Li = Ei;
      continue;
    }
    if (p >= total) break;
    // Gap region [p, Mi). Probe only when it meets the caller's
    // minimum (probing cost gate); otherwise skip to the claim.
    if (Mi - p < static_cast<size_t>(min_gap)) {
      lead += Mi - p;
      p = Mi;
      continue;
    }
    const size_t ge = Mi;
    size_t fails = 0;  // probe acceleration over unmatched stretches
    while (p < ge && p + 4 <= total) {
      if (p + 16 <= total)  // hide the next probe's head-table miss
        __builtin_prefetch(&head[hash_at(p + 1)]);
      uint32_t off = 0;
      size_t len = match_gap(p, total, &off);
      if (len == 0) {
        if (p + 8 <= total) insert(p);
        // Accelerate like the fast matcher: after 32 consecutive
        // misses the stretch is reading as incompressible, so step
        // 2, then 3, ... (capped at the gap end). Skipped positions
        // cost nothing; the backward extension of the next hit
        // recovers short overshoots.
        size_t step = std::min(1 + (fails++ >> 5), ge - p);
        p += step;
        lead += step;
        continue;
      }
      fails = 0;
      if (i < nseq) {
        // A gap match may overrun into claim i, but must consume it
        // whole or leave >= 4 bytes of it alive.
        len = cap_overrun(p, len, Mi, Ei);
        if (len < 3) {
          if (p + 8 <= total) insert(p);
          ++p;
          ++lead;
          continue;
        }
      }
      // One-step lazy on short non-rep gap takes (r5, same rule as
      // the fast matcher's mini-lazy and the greedy chain levels): a
      // 1-byte-later probe that scores past the one-literal cost
      // de-fragments the gap parse. Gap bytes are a minority of the
      // block, so the extra probe costs little. Fast (relaxed) levels
      // only: their width-quantized claims leave fragmented gaps that
      // the shift repairs (device text L1/L2 -0.25%), while deep
      // levels' denser claims measured a ~0.4% LOSS on mixed L9-L12
      // from the same shift (the stricter gap economics there already
      // suppress the short takes worth shifting).
      if (relaxed && len < QZ_CHAIN_LAZY_BAR && off != rep &&
          p + 5 <= total) {
        uint32_t offn = 0;
        size_t ln = match_gap(p + 1, total, &offn);
        if (i < nseq) ln = cap_overrun(p + 1, ln, Mi, Ei);
        if (ln >= 4) {
          int sc_n = static_cast<int>(ln) * 8 -
                     (offn == rep ? 0 : qz::highbit(offn | 1));
          int sc_c = static_cast<int>(len) * 8 -
                     static_cast<int>(qz::highbit(off | 1));
          if (sc_n > sc_c + 8) {
            if (p + 8 <= total) insert(p);
            ++p;
            ++lead;
            len = ln;
            off = offn;
          }
        }
      }
      // Backward extension into the pending literal run.
      size_t bk = 0;
      while (bk < lead && p - bk - 1 >= static_cast<size_t>(off) &&
             base[p - bk - 1] == base[p - bk - 1 - off])
        ++bk;
      out.push_back({static_cast<uint32_t>(lead - bk), off,
                     static_cast<uint32_t>(len + bk)});
      rep = off;
      lead = 0;
      size_t end = p + len;
      insert_span(p - bk, end);
      p = end;
      if (p >= Mi) break;  // claim branch consumes/trims from here
    }
    if (p < ge && i < nseq) {
      // Tail of the gap too short to probe further.
      lead += ge - p;
      p = ge;
    } else if (i >= nseq && p < total) {
      lead += total - p;
      p = total;
    }
  }
  if (out.size() > cap) return static_cast<size_t>(-1);
  for (size_t k = 0; k < out.size(); ++k) {
    lit_lens[k] = out[k].lit_len;
    offsets[k] = out[k].offset;
    match_lens[k] = out[k].match_len;
  }
  *last_literals = static_cast<uint32_t>(lead);
  return out.size();
}

size_t qz_extend_sequences(const uint8_t* base, size_t ctx_len, size_t n,
                           uint32_t* lit_lens, uint32_t* offsets,
                           uint32_t* match_lens, size_t nseq,
                           uint32_t* last_literals, size_t max_off) {
  if (max_off == 0) max_off = ~size_t(0);
  const uint8_t* block = base + ctx_len;
  size_t out = 0;
  size_t cursor = 0;        // bytes already emitted (post-extension)
  size_t orig_pos = 0;      // original span walker
  uint64_t pending_lit = 0; // literals freed by dropped/trimmed sequences
  // Recent-offset history for the repcode probe (3 deep like zstd's
  // rep set): a junk short match at an edit site must not evict the
  // long-distance offset the next claim needs to resume with.
  uint32_t rep[3] = {0, 0, 0};
  auto lcp_at = [&](size_t p, uint32_t o) -> size_t {
    return qz::lcp(block + p, block + p - o, n - p);
  };
  for (size_t i = 0; i < nseq; ++i) {
    size_t lit_start = orig_pos;
    size_t match_start = lit_start + lit_lens[i];
    size_t match_end = match_start + match_lens[i];
    orig_pos = match_end;
    if (cursor >= match_end) continue;  // fully consumed by an extension
    uint32_t off = offsets[i];
    size_t new_lit;
    size_t new_start;
    if (cursor <= match_start) {
      new_lit = match_start - cursor;
      new_start = match_start;
    } else {
      new_lit = 0;
      new_start = cursor;  // front-trimmed match
    }
    size_t new_ml = match_end - new_start;
    // Runt tiles (front-trimmed to 1-2 bytes) are dropped untested:
    // probing them was measured net-negative under dense claims (tiny
    // runt matches split coverage into extra sequences).
    if (new_ml < 3) {
      pending_lit += new_lit + new_ml;
      cursor = match_end;
      continue;
    }
    // Verify + re-extend: recompute the true LCP at (new_start,
    // new_start - off). The device's claims may be probabilistic (the
    // hash matcher's widths are hash-equal, not byte-verified — the
    // compressAndVerify posture, src/qatseqprod.c:1245): a false claim
    // shrinks below MIN_MATCH here and degrades to literals; a capped
    // claim extends to its true length. Either way every emitted
    // sequence is byte-exact. A structurally invalid offset (0 or
    // beyond the window context, e.g. an LDM claim at a batch seam)
    // contributes no match but may still be rescued by the rep probe.
    size_t l = 0;
    if (off != 0 && off <= ctx_len + new_start) l = lcp_at(new_start, off);
    // Repcode probe: also try the recently emitted offsets (stock
    // zstd's matchers check reps at every position — this is where the
    // device path recovers that, e.g. resuming a long-distance match
    // right after a small edit broke it). Scored, not tie-broken: a rep
    // costs no offset bits, so it may be up to highbit(off)/8 bytes
    // SHORTER than the claim and still win (r4 parse economics).
    {
      int sc = l >= 3 ? static_cast<int>(l) * 8 - qz::highbit(off | 1)
                      : INT32_MIN;
      for (int r = 0; r < 3; ++r) {
        uint32_t ro = rep[r];
        if (ro && ro != off && ro <= ctx_len + new_start) {
          size_t lr = lcp_at(new_start, ro);
          int sr = lr >= 3 ? static_cast<int>(lr) * 8 : INT32_MIN;
          if (sr >= sc && lr >= 3) {
            off = ro;
            l = lr;
            sc = sr;
          }
        }
      }
    }
    // Slide probe for long-distance claims: LDM offsets are minimizer
    // slot-quantized (exact to +-1 slot = +-the sample stride), so when
    // the quantized offset does not verify, scan the +-63 byte
    // neighborhood outward for the true distance. Gated on a weak
    // direct/rep result and an offset beyond the 32K local window so
    // the probe never runs on the (exact) local claims — LDM claims in
    // the (32K, 64K] band are just as jittered as farther ones (review
    // finding: the old > 65536 gate let those degrade to literals).
    if (l < 16 && offsets[i] > 32768) {
      uint32_t o0 = offsets[i];
      for (uint32_t d = 1; d <= 63; ++d) {
        uint32_t cand[2] = {o0 - d, o0 + d};
        for (uint32_t oc : cand) {
          if (oc == 0 || oc > ctx_len + new_start || oc > max_off)
            continue;
          const uint8_t* a = block + new_start;
          if (new_start + 8 <= n && qz::rd64(a) != qz::rd64(a - oc))
            continue;
          size_t ls = lcp_at(new_start, oc);
          if (ls >= 16 && ls > l) {
            off = oc;
            l = ls;
            d = 64;  // break outer
            break;
          }
        }
      }
    }
    if (l < 3) {  // false claim: the whole span becomes literals
      pending_lit += new_lit + new_ml;
      cursor = match_end;
      continue;
    }
    // Backward extension reach: grow the match into the preceding
    // literal run (contiguous bytes [new_start - new_lit - pending_lit,
    // new_start)), the standard zstd gain the forward-only device parse
    // leaves behind. Counted before the economics test so a short
    // forward match that extends backward into a long one still passes.
    uint64_t total_lit = new_lit + pending_lit;
    size_t bk = 0;
    while (bk < total_lit && new_start - bk > 0 &&
           new_start - bk - 1 + ctx_len >= off &&
           block[new_start - bk - 1] == *(block + new_start - bk - 1 - off))
      ++bk;
    // Offset-aware economics (same model as the matchers' cost floor:
    // a sequence costs ~10 + log2(offset) bits, literals ~5-6 bits/byte
    // post-Huffman). The device cost filter applies this to CLAIMS, but
    // verify-shrink and front-trimming re-create short matches here —
    // measured 2700+ ml<=5 emissions per 2 MB vs stock's ~550, many at
    // uneconomic offsets. Rep offsets bypass (their code is ~1-5 bits).
    const size_t le = l + bk;
    const bool rep_hit =
        off == rep[0] || off == rep[1] || off == rep[2];
    const bool worth =
        rep_hit || le >= 5 || (le >= 4 && off <= 4096) ||
        (le >= 3 && off <= 256);
    if (!worth) {
      pending_lit += new_lit + new_ml;
      cursor = match_end;
      continue;
    }
    new_ml = l + bk;
    new_start -= bk;
    total_lit -= bk;
    lit_lens[out] = static_cast<uint32_t>(total_lit);
    offsets[out] = off;
    match_lens[out] = static_cast<uint32_t>(new_ml);
    pending_lit = 0;
    if (off != rep[0]) {
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    }
    ++out;
    cursor = new_start + new_ml;
  }
  // Tail bytes: [cursor, n) plus literals freed by trailing dropped
  // sequences (those bytes sit before cursor but after the last emitted
  // sequence, contiguous with the tail).
  *last_literals = static_cast<uint32_t>(n - cursor + pending_lit);
  return out;
}

// Block body assembly around a device-produced Sequences_Section: this
// host side only gathers/encodes the literals section and concatenates
// the accelerator's section bytes (the hybrid entropy split: literals on
// host, sequence FSE on TPU). Returns body size or 0.
size_t qz_block_body_external_seqsec(
    const uint8_t* block, size_t block_len, const uint32_t* lit_lens,
    const uint32_t* match_lens, size_t nseq, uint32_t last_literals,
    const uint8_t* seq_section, size_t seq_section_len, int try_huffman,
    uint8_t* dst, size_t dst_cap) {
  std::vector<uint8_t> lits;
  size_t pos = 0;
  uint64_t span = last_literals;
  for (size_t i = 0; i < nseq; ++i) span += lit_lens[i] + match_lens[i];
  if (span != block_len) return 0;
  lits.reserve(block_len / 2);
  for (size_t i = 0; i < nseq; ++i) {
    lits.insert(lits.end(), block + pos, block + pos + lit_lens[i]);
    pos += lit_lens[i] + match_lens[i];
  }
  lits.insert(lits.end(), block + pos, block + pos + last_literals);
  std::vector<uint8_t> lit_sec;
  if (!qz::encode_literals_section(lits.data(), lits.size(),
                                   try_huffman != 0, &lit_sec))
    return 0;
  size_t total = lit_sec.size() + seq_section_len;
  if (total > dst_cap) return 0;
  std::memcpy(dst, lit_sec.data(), lit_sec.size());
  std::memcpy(dst + lit_sec.size(), seq_section, seq_section_len);
  return total;
}

// LZ4s token-stream ingest — the native analog of the reference's CPU
// hot loop (QZSTD_decLz4s, src/qatseqprod.c:1013-1091; format contract
// pinned by format/lz4s.py, the golden model this is differentially
// tested against). Decodes a hardware-produced LZ4s stream into claim
// triples ready for qz_extend_sequences: 4-bit nibbles with 255-saturated
// extensions, LE16 offsets, +2 match bias (3-byte minimum), zero-match
// literal-run accumulation, final literals-only entry (counted).
// Returns the sequence count, SIZE_MAX on malformed input or capacity
// overflow (the producer-error posture). last entry (off=0, ml=0)
// carries the tail literals in lit_lens[count-1].
size_t qz_dec_lz4s(const uint8_t* stream, size_t n, uint32_t* lit_lens,
                   uint32_t* offsets, uint32_t* match_lens, size_t cap) {
  size_t ip = 0;
  size_t out = 0;
  uint64_t hist = 0;
  bool ended_in_literals = false;
  while (ip < n) {
    uint32_t token = stream[ip++];
    uint64_t lit = token >> 4;
    if (lit == 15) {
      while (true) {
        if (ip >= n) return static_cast<size_t>(-1);  // truncated run
        uint32_t b = stream[ip++];
        lit += b;
        if (b != 255) break;
      }
    }
    ip += lit;  // the literal bytes ride the stream
    if (ip > n) return static_cast<size_t>(-1);
    if (ip == n) {  // final literals-only sequence (:1037-1045)
      if (out >= cap) return static_cast<size_t>(-1);
      lit_lens[out] = static_cast<uint32_t>(lit + hist);
      offsets[out] = 0;
      match_lens[out] = 0;
      ++out;
      ended_in_literals = true;
      break;
    }
    if (ip + 2 > n) return static_cast<size_t>(-1);  // truncated offset
    uint32_t off = stream[ip] | (stream[ip + 1] << 8);
    ip += 2;
    uint64_t ml = token & 15;
    if (ml == 15) {
      while (true) {
        if (ip >= n) return static_cast<size_t>(-1);
        uint32_t b = stream[ip++];
        ml += b;
        if (b != 255) break;
      }
    }
    if (ml != 0) {
      ml += 2;  // LZ4MINMATCH bias -> 3-byte minimum (:1060-1062)
      if (off == 0) return static_cast<size_t>(-1);
      if (out >= cap) return static_cast<size_t>(-1);  // :1073-1076
      lit_lens[out] = static_cast<uint32_t>(lit + hist);
      offsets[out] = off;
      match_lens[out] = static_cast<uint32_t>(ml);
      hist = 0;
      ++out;
    } else {
      hist += lit;  // literal-run continuation (:1077-1084)
    }
  }
  if (!ended_in_literals) {  // stream ended right after a match (:1090)
    if (out >= cap) return static_cast<size_t>(-1);
    lit_lens[out] = static_cast<uint32_t>(hist);
    offsets[out] = 0;
    match_lens[out] = 0;
    ++out;
  }
  return out;
}

// Software matcher (native fallback). `base` holds ctx_len bytes of
// window context followed by the n-byte block (ctx_len = 0 for stateless
// blocks). Writes up to cap sequences; returns the count, sets
// *last_literals. Returns SIZE_MAX on overflow.
size_t qz_find_sequences(const uint8_t* base, size_t ctx_len, size_t n,
                         int chain_depth, int lazy, int mml,
                         uint32_t* lit_lens, uint32_t* offsets,
                         uint32_t* match_lens, size_t cap,
                         uint32_t* last_literals) {
  std::vector<qz::Sequence> seqs;
  qz::find_sequences(base, ctx_len, n, chain_depth, lazy != 0, mml, &seqs,
                     last_literals);
  if (seqs.size() > cap) return static_cast<size_t>(-1);
  for (size_t i = 0; i < seqs.size(); ++i) {
    lit_lens[i] = seqs[i].lit_len;
    offsets[i] = seqs[i].offset;
    match_lens[i] = seqs[i].match_len;
  }
  return seqs.size();
}

// Hinted variant: hint_pos (block-relative, ascending) + hint_off are
// device-discovered candidates competing inside the ONE parse — the
// deep-level replacement for the r4 best-of-two double parse. The
// accelerator keeps its role from the reference's division of labor
// (it finds the matches the host cannot see cheaply,
// src/qatseqprod.c:1106-1336); the host does selection and entropy.
size_t qz_find_sequences_hinted(const uint8_t* base, size_t ctx_len,
                                size_t n, int chain_depth, int lazy,
                                int mml, const uint32_t* hint_pos,
                                const uint32_t* hint_len,
                                const uint32_t* hint_off, size_t nhints,
                                uint32_t* lit_lens, uint32_t* offsets,
                                uint32_t* match_lens, size_t cap,
                                uint32_t* last_literals) {
  std::vector<qz::Sequence> seqs;
  qz::find_sequences(base, ctx_len, n, chain_depth, lazy != 0, mml, &seqs,
                     last_literals, hint_pos, hint_len, hint_off, nhints);
  if (seqs.size() > cap) return static_cast<size_t>(-1);
  for (size_t i = 0; i < seqs.size(); ++i) {
    lit_lens[i] = seqs[i].lit_len;
    offsets[i] = seqs[i].offset;
    match_lens[i] = seqs[i].match_len;
  }
  return seqs.size();
}

// Whole-buffer software compression with an internal thread pool: match +
// extend + entropy for every block in one call (the reference's
// thread-per-CCtx benchmark concurrency, test/benchmark.c:514-520, moved
// inside the runtime so Python pays one FFI crossing per buffer).
// dst is an arena of nblocks * block_size bytes; body_sizes[i] == 0 means
// "emit raw" for that block.
void qz_compress_blocks_mt(const uint8_t* src, size_t n, size_t block_size,
                           int chain_depth, int lazy, int mml,
                           int allow_custom, int try_huffman,
                           int window_log, int nthreads, int frame_start,
                           uint8_t* dst, uint32_t* body_sizes) {
  size_t nblocks = n == 0 ? 0 : (n + block_size - 1) / block_size;
  size_t window = window_log > 0 ? (size_t(1) << window_log) : block_size;
  // Contiguous block ranges per thread with a STREAMING matcher: the
  // hash table persists as the range advances, so window context is the
  // positions inserted while compressing earlier blocks — no per-block
  // context re-seeding (the old per-block full-window reseed was 1.5x
  // the block's own work, measured as the dominant software-path cost;
  // 31 -> ~130 MB/s on 4 cores). Only each range's first blocks lose
  // context, mirroring block 0 of any buffer. Blocks stay independent
  // in the FORMAT (offsets reach raw input bytes only), so per-range
  // streaming changes which matches are found, never their validity.
  // Range partitioning is derived from INPUT SIZE, not thread count
  // (advisor r3: nthreads-derived ranges made compressed bytes vary with
  // machine core count). Fixed 32-block (4 MiB) streaming ranges keep
  // output reproducible on any host; nthreads only sets concurrency.
  constexpr size_t kBlocksPerRange = 32;
  size_t nranges = nblocks == 0 ? 0 : (nblocks + kBlocksPerRange - 1)
                                          / kBlocksPerRange;
  int nt = (nthreads <= 1 || nranges <= 1)
               ? 1
               : static_cast<int>(std::min<size_t>(nthreads, nranges));
  auto worker = [&](size_t b0, size_t b1) {
    if (b0 >= b1) return;
    size_t range_off = b0 * block_size;
    size_t range_len = std::min(n, b1 * block_size) - range_off;
    // One window of pre-range context, seeded ONCE per range (the old
    // design paid this per BLOCK): range boundaries keep full reach.
    size_t ctx0 = std::min(range_off, window);
    qz::StreamMatcher sm(src + range_off - ctx0, ctx0 + range_len,
                         window);
    // Fast levels (shallow greedy chains, L1-L2) take the single-probe
    // matcher; its table seeds lazily, so context positions go straight
    // into it. Measured on the gate corpus at L2 settings: fast 565542
    // vs chain-4 559941 vs stock L2 572637 — both beat stock, fast is
    // ~3x the speed for ~1% of size, the right trade for a FAST level.
    bool fast = chain_depth <= 4 && !lazy;
    if (fast && ctx0 >= 8) {
      sm.ensure_fast_tables();
      for (size_t p = 0; p + 8 <= ctx0; p += 2) sm.insert_fast(p);
    }
    if (!fast)
      for (size_t p = 0; p + 4 <= ctx0; p += 2) sm.insert(p);
    std::vector<qz::Sequence> seqs;
    for (size_t i = b0; i < b1; ++i) {
      size_t off = i * block_size;
      size_t len = std::min(block_size, n - off);
      body_sizes[i] = 0;
      if (len < 64) continue;
      uint32_t last_lit = 0;
      if (fast)
        sm.compress_block_fast(ctx0 + off - range_off, len, mml,
                               chain_depth >= 3, &seqs, &last_lit);
      else
        sm.compress_block(ctx0 + off - range_off, len, chain_depth,
                          lazy != 0, mml, &seqs, &last_lit);
      size_t nseq = seqs.size();
      size_t cap = nseq + len / 8 + 64;
      std::vector<uint32_t> ll(cap), of(cap), ml(cap);
      for (size_t s = 0; s < nseq; ++s) {
        ll[s] = seqs[s].lit_len;
        of[s] = seqs[s].offset;
        ml[s] = seqs[s].match_len;
      }
      // Finishing walk over the software parse (the same pass the
      // device path's host side runs: gap re-probing + claim
      // competition). Policy:
      //   lazy deep levels — skip (their chain parse already beats
      //     stock everywhere; the walk's relaxed pricing was measured
      //     NET-NEGATIVE under a deep parse);
      //   L2-L4 (double-table fast / shallow chains) — always (every
      //     probe corpus improves; these are the balanced levels);
      //   L1 (speed point) — only when the parse shows OFFSET CHURN:
      //     few distinct offsets but a low rep-hit rate, the signature
      //     of structured records where greedy longest-wins rotates
      //     between stride multiples and wrecks the offset coding
      //     (measured: binary corpus 1.06x stock -> 0.96x; text/mixed
      //     parses don't trigger, keeping the L1 throughput point).
      bool do_fill = false;
      if (!lazy && len >= 4096) {
        if (chain_depth >= 3) {
          do_fill = true;
        } else if (nseq >= 128) {
          uint32_t r3[3] = {0, 0, 0};
          size_t rep_hits = 0;
          uint32_t slots[1024] = {0};
          size_t distinct = 0;
          bool many = false;
          for (size_t s = 0; s < nseq; ++s) {
            uint32_t o = of[s];
            if (o == r3[0] || o == r3[1] || o == r3[2]) ++rep_hits;
            if (o != r3[0]) {
              r3[2] = r3[1];
              r3[1] = r3[0];
              r3[0] = o;
            }
            if (!many && o) {
              uint32_t h = (o * 2654435761u) >> 22;
              for (int k = 0; k < 1024; ++k) {
                uint32_t& sl = slots[(h + k) & 1023];
                if (sl == o) break;
                if (sl == 0) {
                  sl = o;
                  // Measured separation on the probe corpora: structured
                  // records ~84 distinct offsets per block, text/mixed
                  // ~1000 — the boundary sits comfortably at 256.
                  if (++distinct > 256) many = true;
                  break;
                }
              }
            }
          }
          do_fill = !many && rep_hits < nseq * 9 / 10;
        }
      }
      if (do_fill) {
        size_t max_ctx = window > block_size ? window - block_size : 0;
        max_ctx = std::min(max_ctx, size_t(32768));
        size_t cf = std::min(off, max_ctx);
        size_t ns = qz_fill_gaps(src + off - cf, cf, len, ll.data(),
                                 of.data(), ml.data(), nseq, &last_lit,
                                 cap, 8, mml, 4, 1);
        if (ns != static_cast<size_t>(-1)) nseq = ns;
      }
      std::vector<uint8_t> body;
      if (!qz::encode_block_body(src + off, len, ll.data(), of.data(),
                                 ml.data(), nseq, last_lit,
                                 allow_custom != 0, try_huffman != 0,
                                 frame_start != 0 && i == 0, &body))
        continue;
      if (body.size() >= len || body.size() > block_size) continue;
      std::memcpy(dst + i * block_size, body.data(), body.size());
      body_sizes[i] = static_cast<uint32_t>(body.size());
    }
  };
  if (nt == 1) {
    worker(0, nblocks);
    return;
  }
  // Each worker drains ranges round-robin; range boundaries (and thus the
  // compressed bytes) are identical regardless of nt.
  auto run_ranges = [&](int t) {
    for (size_t r = static_cast<size_t>(t); r < nranges;
         r += static_cast<size_t>(nt))
      worker(r * kBlocksPerRange,
             std::min(nblocks, (r + 1) * kBlocksPerRange));
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(run_ranges, t);
  for (auto& t : pool) t.join();
}

}  // extern "C"

