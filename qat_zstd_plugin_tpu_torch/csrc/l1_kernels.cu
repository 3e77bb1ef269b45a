// Hopper kernels of the level-1 device path (the syncmer slot pipeline).
//
// Four hand-written CUDA kernels replace the four Pallas kernels that
// qat_zstd_plugin_tpu.ops.glue_kernels.find_matches_positions(sync=True)
// runs on the TPU. Each has a plain PyTorch twin in
// qat_zstd_plugin_tpu_torch/ops/glue_kernels.py that computes the same
// words; the wrappers there check shapes and dtypes, allocate the outputs
// and launch these entry points through ctypes.
//
// Interface: every entry point takes device pointers, sizes and the CUDA
// stream (PyTorch's current stream), launches on that stream, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported at once. All sort keys and slot words are u32 bit patterns; the
// PyTorch side holds them in int32 tensors.
//
// All four are integer passes with a few operations per byte moved, so
// device-memory bandwidth bounds them on an H100 (3.35 TB/s). Each is
// designed for the card: 32-bit index arithmetic, whole lines a warp
// load, and the sign flips of the signed row sorts around them folded
// into each. On the level-1 path K1 writes its keys flipped and only the
// LDM samples, K3 reads those contiguously, and K4 takes the last sorts'
// flipped words and computes the LDM estimates itself, so no torch pass
// runs between the kernels and the row sorts.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: pair-syncmer anchor keys + the LDM samples (or the full plane).
// Replaces glue_kernels.hash_keys_winmin_sync (Pallas).
//
// Pair p of a row (positions i = 2p and i + 1) holds (hash_width(sel) >>
// pbits << pbits | sel & pmask) ^ flip, sel the member whose lane parity
// is the parity of the argmin of (h8 & ~1 | position & 1) over [i, i + 4):
// ties go to the even lane, positions at or past n count as 0xFFFFFFFF
// (the reference's fill). The second output is, with kPlane, the
// reference's (B, n) plane minz[i] = the minimum of h8 over [i, i +
// stride); else only the words the LDM chain reads, minz[:, ::stride]:
// sample j is the minimum of h8 over [j stride, (j + 1) stride). h8 is the
// 8-gram hash with bytes past the row read as 0.
//
// Bound: device memory. A row reads n bytes and writes 2n bytes of keys
// and 4n / stride of samples; the full plane would add 4n, of which the
// chain reads one word in `stride`. The design is B6's (common.cuh): a
// warp per tile of kK1Rows rows of 128 positions, lane l at positions
// 4l..4l+3 of each row, one 128-byte line a warp load, the grams from
// shuffled words by __byte_perm, 32-bit in-row indices, no shared memory.
// A lane holds pairs 2l and 2l+1 of a row. The second pair's window needs
// h8 at 4l+4 and 4l+5: the next lane's first two, for lane 31 the next
// row's lane 0 (after the tile's last row, the halo row's), by shuffle.
// Both keys go out in one 8-byte store. A sample at stride S <= 128 lies
// in one row: the minimum over S/4 lanes by xor shuffles, log2(S/4) steps
// (3 at level 1's stride of 32), stored by the first of them. Above 128
// the kernel writes the stride-128 samples into scratch and
// sync_samples_kernel takes the minimum of each S/128 of them; the full
// plane takes block_scans/window_min, and above 128
// winmin_stretch_kernel, as B6 does. A row whose length is no multiple of
// 4 (n % 4 == 2) loads byte by byte and stores word by word (kVec false).
// ---------------------------------------------------------------------------

constexpr int kK1Rows = 8;   // rows of 128 positions a warp tile
constexpr int kK1Warps = 4;  // warps a CTA
constexpr int kK1WarpSpan = kK1Rows * kRowSpan;
constexpr int kK1Span = kK1Warps * kK1WarpSpan;  // positions a CTA

// Word q of a row: its bytes 4q..4q+3, little-endian, 0 past n.
template <bool kVec>
__device__ __forceinline__ uint32_t row_word(const uint8_t* __restrict__ x,
                                             int q, int n) {
    if (kVec)
        return q < (n >> 2)
            ? __ldg(reinterpret_cast<const uint32_t*>(x) + q) : 0u;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (4 * q + k < n) v |= uint32_t(__ldg(x + 4 * q + k)) << (8 * k);
    return v;
}

// Stores the lane's four words of a row at i..i+3 (those below n).
template <bool kVec>
__device__ __forceinline__ void store4(uint32_t* row, int i, int n, uint4 v) {
    if (kVec) {
        if (i < n) *reinterpret_cast<uint4*>(row + i) = v;
        return;
    }
    const uint32_t a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (i + k < n) row[i + k] = a[k];
}

struct SyncRow {
    uint4 h8;  // the 8-gram hashes at i..i+3, kEmpty at or past n
    uint4 hw;  // the width's hashes at i..i+3, low pbits cleared
};

// One row of a warp tile, starting at position `start`: lane `lane` at
// positions i..i+3 with its word `own` of the row and `next` of the row
// after (common.cuh tile_row). The compare with n is made only in a row
// that reaches it (warp-uniform): K1's time follows its instructions more
// than its bytes (its samples add 4% to the bytes and 22% to the time on
// the card, designs/l1_sync.py).
__device__ __forceinline__ SyncRow sync_row(uint32_t own, uint32_t next,
                                            int lane, int start, int n,
                                            int width, uint32_t hmask) {
    const uint32_t b = __shfl_sync(kFull, lane >= 1 ? own : next,
                                   (lane + 1) & 31);
    const uint32_t c = __shfl_sync(kFull, lane >= 2 ? own : next,
                                   (lane + 2) & 31);
    uint32_t h[4], hw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t lo = be_at(own, b, k), hi = be_at(b, c, k);
        h[k] = hash_words(lo, hi, 8);
        hw[k] = hash_words(lo, hi, width) & hmask;
    }
    if (start + kRowSpan > n) {
        const int i = start + 4 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (i + k >= n) h[k] = kEmpty;
    }
    return {make_uint4(h[0], h[1], h[2], h[3]),
            make_uint4(hw[0], hw[1], hw[2], hw[3])};
}

// The keys of the pairs at i and i + 2 from the lane's row and h8 at
// i + 4 and i + 5. The parity of the argmin of (h8 & ~1 | position & 1)
// over [i, i + 4) is odd where the odd members' minimum with its low bit
// set lies below the even members' with it cleared.
__device__ __forceinline__ uint2 pair_keys(const SyncRow& r, uint32_t h4,
                                           uint32_t h5, int i,
                                           uint32_t pmask, uint32_t flip) {
    const uint32_t p0 = (min(r.h8.y, r.h8.w) | 1u) < (min(r.h8.x, r.h8.z) &
                                                      ~1u);
    const uint32_t p1 = (min(r.h8.w, h5) | 1u) < (min(r.h8.z, h4) & ~1u);
    const uint32_t k0 = (p0 ? r.hw.y : r.hw.x) | ((uint32_t(i) + p0) & pmask);
    const uint32_t k1 = (p1 ? r.hw.w : r.hw.z) |
                        ((uint32_t(i) + 2u + p1) & pmask);
    return make_uint2(k0 ^ flip, k1 ^ flip);
}

// The samples of the lane's four positions at stride S = 2^slog <= 128
// (L = S/4 lanes a sample at S >= 4).
template <bool kVec>
__device__ __forceinline__ void row_samples(uint4 h, int lane, int i, int n,
                                            int slog, uint32_t* row) {
    if (slog >= 2) {
        const int L = 1 << (slog - 2);
        uint32_t m = min(min(h.x, h.y), min(h.z, h.w));
#pragma unroll
        for (int d = 1; d < 32; d *= 2)
            if (d < L) m = min(m, __shfl_xor_sync(kFull, m, d));
        if ((lane & (L - 1)) == 0 && i < n) row[i >> slog] = m;
    } else if (slog == 1) {
        const uint2 m = make_uint2(min(h.x, h.y), min(h.z, h.w));
        if (kVec) {
            if (i < n) *reinterpret_cast<uint2*>(row + (i >> 1)) = m;
        } else {
            if (i < n) row[i >> 1] = m.x;
            if (i + 2 < n) row[(i >> 1) + 1] = m.y;
        }
    } else {
        store4<kVec>(row, i, n, h);
    }
}

template <bool kPlane, bool kVec>  // kVec: n % 4 == 0
__global__ void __launch_bounds__(kK1Warps * 32)
hash_keys_winmin_sync_kernel(const uint8_t* __restrict__ blocks,
                             uint32_t* __restrict__ keys,
                             uint32_t* __restrict__ out, int n, int width,
                             int pbits, uint32_t pmask, int stride,
                             uint32_t flip) {
    constexpr int kLoads = kK1Rows + 2;  // the tile, the halo, one more
    const int lane = threadIdx.x & 31;
    const int t0 =
        (int(blockIdx.x) * kK1Warps + int(threadIdx.x >> 5)) * kK1WarpSpan;
    if (t0 >= n) return;  // the whole warp
    const int row = blockIdx.y;
    const uint8_t* x = blocks + size_t(row) * n;
    uint32_t w[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r)
        w[r] = row_word<kVec>(x, (t0 >> 2) + 32 * r + lane, n);
    uint32_t* krow = keys + size_t(row) * (n >> 1);
    const int slog = stride > 0 ? __ffs(stride) - 1 : 0;
    uint32_t* orow = out + size_t(row) *
        (kPlane ? n : (n + stride - 1) >> slog);  // read when stride > 0
    const int L = stride >= 4 ? stride >> 2 : 1;
    const int i0 = t0 + 4 * lane;
    const uint32_t hmask = ~0u << pbits;
    SyncRow cur = sync_row(w[0], w[1], lane, t0, n, width, hmask);
    uint4 pre = cur.h8, suf = cur.h8;
    if (kPlane && stride >= 4) block_scans(cur.h8, lane, L, pre, suf);
#pragma unroll
    for (int r = 0; r < kK1Rows; ++r) {
        // Row r + 1; at r + 1 == kK1Rows the halo row.
        const SyncRow nxt = sync_row(w[r + 1], w[r + 2], lane,
                                     t0 + (r + 1) * kRowSpan, n, width,
                                     hmask);
        const uint32_t h4 = __shfl_sync(kFull, lane >= 1 ? cur.h8.x
                                                         : nxt.h8.x,
                                        (lane + 1) & 31);
        const uint32_t h5 = __shfl_sync(kFull, lane >= 1 ? cur.h8.y
                                                         : nxt.h8.y,
                                        (lane + 1) & 31);
        const int i = i0 + r * kRowSpan;
        const uint2 k = pair_keys(cur, h4, h5, i, pmask, flip);
        if (kVec) {
            if (i < n) *reinterpret_cast<uint2*>(krow + (i >> 1)) = k;
        } else {
            if (i < n) krow[i >> 1] = k.x;
            if (i + 2 < n) krow[(i >> 1) + 1] = k.y;
        }
        if (kPlane) {
            uint4 pn = nxt.h8, sn = nxt.h8;
            if (stride >= 4) block_scans(nxt.h8, lane, L, pn, sn);
            store4<kVec>(orow, i, n, window_min(cur.h8, pre, suf, nxt.h8,
                                                pn, lane, stride));
            pre = pn;
            suf = sn;
        } else if (stride > 0) {
            row_samples<kVec>(cur.h8, lane, i, n, slog, orow);
        }
        cur = nxt;
    }
}

// samples[j] = the minimum of a row's stride-128 samples m128[j reps ..
// (j + 1) reps), those at or past n128 left out: K1's samples above
// stride 128. One thread a sample.
__global__ void __launch_bounds__(kThreads)
sync_samples_kernel(const uint32_t* __restrict__ m128,
                    uint32_t* __restrict__ samples, int n128, int reps,
                    int ns) {
    const int j = int(blockIdx.x) * kThreads + int(threadIdx.x);
    if (j >= ns) return;
    const uint32_t* src = m128 + size_t(blockIdx.y) * n128;
    uint32_t m = kEmpty;
    for (int q = j * reps; q < min((j + 1) * reps, n128); ++q)
        m = min(m, __ldg(src + q));
    samples[size_t(blockIdx.y) * ns + j] = m;
}

// ---------------------------------------------------------------------------
// K2: nearest equal-hash neighbor -> un-sort keys.
// Replaces glue_kernels.neighbor_unsort_keys (Pallas).
//
// Each row of the (rows, w) keys (hash << pbits | pos) is sorted. The
// nearest of the `neighbors` earlier entries of the row with an equal hash
// and a smaller position claims off = pos - prev (the first k entries of a
// row see the reference's fill, hash 0xFFFFFFFF, which no key's hash
// equals); the output (key << (32 - pbits) | off) drops the hash bits, so
// a second row sort restores position order. `flip` (0 or 0x80000000) is
// XORed into every word read and every word written: the row sorts on
// either side are signed, and this folds their sign flips into the pass.
//
// Bound: 8 bytes moved a word. Grid: (chunks of a row, rows), all index
// arithmetic 32-bit. Where w % 4 == 0 (kVec) a thread takes 4 consecutive
// words with one 16-byte load and the 4 before them with another (the
// previous thread's, an L1 hit), claims from that 8-word window and
// writes the 4 outputs with one 16-byte store; a neighbor more than 4 back
// (neighbors > 4, which no level takes) is read from the row, through L1.
// Otherwise (the scalar path) a thread takes one word and reads its
// neighbors from the row. Each claim is written as one condition.
// Measured against each other on the card (designs/k2_k3.py), this runs
// as fast as a 16-byte copy of the same bytes; the same window with each
// claim behind a branch (k <= neighbors, k <= j) around a helper's test
// runs 9% slower, and tiles of 1024, 2048 or 4096 words staged in shared
// memory (the window read from there after a barrier) 3-21% slower.
// ---------------------------------------------------------------------------

constexpr int kK2Threads = 256;

__device__ __forceinline__ uint4 xor4(uint4 v, uint32_t flip) {
    return make_uint4(v.x ^ flip, v.y ^ flip, v.z ^ flip, v.w ^ flip);
}

template <bool kVec>  // kVec: w % 4 == 0, so every row is 16-byte aligned
__global__ void __launch_bounds__(kK2Threads)
neighbor_unsort_keys_kernel(const uint32_t* __restrict__ sk,
                            uint32_t* __restrict__ out, int w, int pbits,
                            int neighbors, uint32_t pmask, uint32_t flip) {
    const uint32_t* x = sk + size_t(blockIdx.y) * w;
    uint32_t* y = out + size_t(blockIdx.y) * w;
    const int shift = 32 - pbits;
    const int i = int(blockIdx.x * kK2Threads + threadIdx.x);
    if (kVec) {
        const int t = 4 * i;  // first of the thread's 4 words
        if (t >= w) return;
        const uint4 a = t >= 4
            ? xor4(__ldg(reinterpret_cast<const uint4*>(x + t - 4)), flip)
            : make_uint4(0, 0, 0, 0);  // never read: k <= j below
        const uint4 b = xor4(__ldg(reinterpret_cast<const uint4*>(x + t)),
                             flip);
        const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = t + e;  // a row's first k see the fill
            const uint32_t sv = win[4 + e];
            const uint32_t sh = sv >> pbits, sp = sv & pmask;
            uint32_t off = 0;
#pragma unroll
            for (int k = 1; k <= 4; ++k) {
                const uint32_t q = win[4 + e - k], pp = q & pmask;
                if (k <= neighbors && k <= j && off == 0 &&
                    (q >> pbits) == sh && pp < sp)
                    off = sp - pp;
            }
            for (int k = 5; k <= neighbors && k <= j && off == 0; ++k) {
                const uint32_t q = __ldg(x + j - k) ^ flip, pp = q & pmask;
                if ((q >> pbits) == sh && pp < sp) off = sp - pp;
            }
            o[e] = ((sv << shift) | off) ^ flip;
        }
        *reinterpret_cast<uint4*>(y + t) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
        if (i >= w) return;
        const uint32_t sv = __ldg(x + i) ^ flip;
        const uint32_t sh = sv >> pbits, sp = sv & pmask;
        uint32_t off = 0;
        for (int k = 1; k <= neighbors && k <= i && off == 0; ++k) {
            const uint32_t q = __ldg(x + i - k) ^ flip, pp = q & pmask;
            if ((q >> pbits) == sh && pp < sp) off = sp - pp;
        }
        y[i] = ((sv << shift) | off) ^ flip;
    }
}

// ---------------------------------------------------------------------------
// K3: long-distance-match sort keys.
// Replaces glue_kernels.ldm_keys (Pallas).
//
// Span row r of the (nspans, 2 * half) output is [the previous span's
// samples | this span's samples]: sample q of block b (minz[b, q *
// stride]: on the level-1 path K1's sample plane at stride 1, else a full
// plane at ldm_stride), remixed by x 2654435761, packs (h << pbits |
// column). One
// thread a sample: it reads the sample once and writes it to both places
// it belongs, column half + (b % sb) * spb + q of span row b / sb and
// column (b % sb) * spb + q of span row b / sb + 1, as that row's context.
// The last span's blocks, which have no next row, write span row 0's
// context instead: the 0xFFFFFFFF fill, remixed like any sample. So every
// output word is written exactly once. `flip` is XORed into every output
// word (the LDM chain's signed row sort follows). Grid: (sample chunks,
// b % sb, b / sb), no division.
//
// Bound: 4 bytes in and 8 out a sample. On K1's sample plane (stride 1)
// a warp's 32 samples are one 128-byte line; on a full plane the reads are
// strided, one 32-byte sector a sample (B * spb * 32 bytes in), a warp's
// samples in 32 consecutive lines. Stores are coalesced. Taking 4 or 8
// consecutive samples a thread, with 16-byte stores, spread a warp's
// strided reads over 4 or 8 times as many lines and was slower on the
// card.
// ---------------------------------------------------------------------------

constexpr int kK3Threads = 256;

__device__ __forceinline__ uint32_t ldm_key(uint32_t m, int pbits,
                                            int column, uint32_t flip) {
    return ((((m * kC1) >> pbits) << pbits) | uint32_t(column)) ^ flip;
}

__global__ void __launch_bounds__(kK3Threads)
ldm_keys_kernel(const uint32_t* __restrict__ minz, uint32_t* __restrict__ out,
                int n, int stride, int spb, int span_blocks, int nspans,
                int r0, int pbits, uint32_t flip) {
    const int q = int(blockIdx.x * kK3Threads + threadIdx.x);  // sample
    if (q >= spb) return;
    const int r = r0 + int(blockIdx.z);  // span row
    const int half = span_blocks * spb;
    const int c = int(blockIdx.y) * spb + q;  // context column
    const bool last = r + 1 == nspans;
    const uint32_t m = __ldg(minz + size_t(r * span_blocks + int(blockIdx.y))
                             * n + size_t(q) * stride);
    out[size_t(r) * (2 * half) + half + c] = ldm_key(m, pbits, half + c,
                                                     flip);
    out[size_t(last ? 0 : r + 1) * (2 * half) + c] =
        ldm_key(last ? kEmpty : m, pbits, c, flip);
}

// ---------------------------------------------------------------------------
// K4: pair claims -> slot words, with the LDM estimates.
// Replaces glue_kernels.compact_slots_sync (Pallas), its _ldm_est included.
//
// Slot s of a block holds the smaller (k << 30 | off) of pair words 2s
// and 2s + 1 of the block's position-ordered pair entries (pos << offbits
// | off, `flip` XORed into each word read) whose claim has an offset and
// passes the tail guard segbase + pos + width <= length, else the empty
// sentinel. With the LDM rows (spb > 0: each span's position-ordered LDM
// keys, `flip` XORed in too), every sls = ns / spb-th slot is the slot of
// sample q of its block and computes the reference's _ldm_est for it
// (ldm_estimate, common.cuh); the slot takes the LDM offset offs * stride
// when the estimate beats the local claim's width.
//
// Bound: device memory, 8 bytes of pair words read and 4 written a slot
// and the span's half of each LDM row (0.0157 ms at B=128 x 128 KiB, LDM
// span 4, at 3.35 TB/s). B8's design (dense_kernels.cu): grid (chunks,
// blocks) in groups of kMaxGridY, 32-bit in-row indices, kSyncSlots
// consecutive slots a thread, their pair words loaded 16 bytes at a time
// through the streaming cache hint (the pair rows are dead after K4), one
// store (16 bytes at 4 slots). sls is stride / 4, a power of two >= 8
// (ldm_stride is 32 * 2^k), so only a thread's first slot can be a
// sample, found by a mask and indexed by a shift; its six LDM words are
// loaded beside the pair words, through L1 (neighbouring samples share
// them). Measured on the card (designs/l1_sync.py), 4 slots a thread run
// as fast as the bytes allow with LDM and without; at 2, where a quarter
// of a warp's lanes compute an estimate, 29% slower with LDM, at 1 twice
// as slow. A block of an odd slot count (N = 4100: 1025) takes the
// guarded path (kVec false).
// ---------------------------------------------------------------------------

constexpr int kSyncSlots = 4;       // slots a thread
constexpr bool kSyncStream = true;  // __ldcs on the pair words
constexpr int kSyncThreads = 256;
constexpr int kSyncChunk = kSyncThreads * kSyncSlots;

template <class T>
__device__ __forceinline__ T load_pairs(const T* p) {
    if constexpr (kSyncStream) return __ldcs(p);
    return __ldg(p);
}

// The slot word v after the estimate of sample q and K4's take rule: the
// LDM offset where the estimate beats the local claim's width.
__device__ __forceinline__ uint32_t take_ldm(uint32_t v,
                                             const uint32_t (&offs)[kLdmReach],
                                             const LdmArgs& a, int q,
                                             int blen, int width) {
    int ldo;
    const int est = ldm_estimate(offs, a, q, blen, ldo);
    return est > (v != kEmpty ? width : 0) ? uint32_t(ldo) : v;
}

// The slot word of pair words e0 and e1 (flip removed).
__device__ __forceinline__ uint32_t slot_word(uint32_t e0, uint32_t e1,
                                              int segbase, int offbits,
                                              int width, int blen) {
    const uint32_t offmask = (1u << offbits) - 1u;
    uint32_t best = kEmpty;
    const uint32_t e[2] = {e0, e1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const uint32_t posf = e[j] >> offbits, off = e[j] & offmask;
        if (off > 0 && segbase + int(posf) + width <= blen)
            best = min(best, ((posf & 3u) << 30) | off);
    }
    return best;
}

template <bool kVec>  // kVec: kSyncSlots divides ns
__global__ void __launch_bounds__(kSyncThreads)
compact_slots_sync_kernel(const uint32_t* __restrict__ su,
                          const int32_t* __restrict__ lengths, LdmArgs ldm,
                          uint32_t* __restrict__ out, int ns, int pbits,
                          int width, int sls_log2, uint32_t flip,
                          int r0) {
    const int b = r0 + int(blockIdx.y);
    const int s0 = (int(blockIdx.x) * kSyncThreads + int(threadIdx.x)) *
                   kSyncSlots;
    if (s0 >= ns) return;
    const uint32_t* src = su + size_t(b) * (2 * ns) + 2 * s0;
    uint32_t pw[2 * kSyncSlots];
#pragma unroll
    for (int k = 0; k < kSyncSlots; k += 2) {
        if (kVec && k + 1 < kSyncSlots) {
            const uint4 v = load_pairs(reinterpret_cast<const uint4*>(src) +
                                       k / 2);
            pw[2 * k] = v.x;
            pw[2 * k + 1] = v.y;
            pw[2 * k + 2] = v.z;
            pw[2 * k + 3] = v.w;
        } else {
#pragma unroll
            for (int j = k; j < k + 2 && j < kSyncSlots; ++j) {
                const uint2 v = kVec || s0 + j < ns
                    ? load_pairs(reinterpret_cast<const uint2*>(src) + j)
                    : make_uint2(flip, flip);  // no claim
                pw[2 * j] = v.x;
                pw[2 * j + 1] = v.y;
            }
        }
    }
    const int blen = __ldg(lengths + b);
    // A sample slot is a thread's first; its LDM words load beside the
    // pair words.
    const bool sample =
        ldm.spb > 0 && (s0 & ((1 << sls_log2) - 1)) == 0;
    uint32_t offs[kLdmReach];
    const int q = s0 >> sls_log2;
    if (sample) ldm_offsets(ldm, b, q, flip, offs);
    const int offbits = 32 - pbits;
    uint32_t best[kSyncSlots];
#pragma unroll
    for (int k = 0; k < kSyncSlots; ++k)
        best[k] = slot_word(pw[2 * k] ^ flip, pw[2 * k + 1] ^ flip,
                            ((s0 + k) >> (pbits - 2)) << pbits, offbits,
                            width, blen);
    if (sample)
        best[0] = take_ldm(best[0], offs, ldm, q, blen, width);
    uint32_t* dst = out + size_t(b) * ns + s0;
    if constexpr (kVec && kSyncSlots == 1) {
        dst[0] = best[0];
    } else if constexpr (kVec && kSyncSlots == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(best[0], best[1]);
    } else if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < kSyncSlots; k += 4)
            *reinterpret_cast<uint4*>(dst + k) =
                make_uint4(best[k], best[k + 1], best[k + 2], best[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < kSyncSlots; ++k)
            if (s0 + k < ns) dst[k] = best[k];
    }
}

}  // namespace

extern "C" {

const char* qz_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 on the stream: keys, and at stride > 0 the (rows, ceil(n / stride))
// samples or, with samples == 0, the (rows, n) plane into `out`;
// `scratch` holds the stride-128 samples (rows * ceil(n / 128) words) or
// plane (rows * n) above stride 128. cudaErrorInvalidValue, and no
// launch, for a shape the grid cannot hold, an odd n, a stride that is
// not 0 or a power of two up to 4096, or no scratch where it is needed.
int qz_hash_keys_winmin_sync(const void* blocks, void* keys, void* out,
                             void* scratch, int rows, int n, int width,
                             int pbits, int pmask, int stride, unsigned flip,
                             int samples, void* stream) {
    const bool wide = stride > kRowSpan;
    if (rows < 1 || rows > 65535 || n < 2 || n % 2 != 0 || stride < 0 ||
        stride > kMaxStride || (stride & (stride - 1)) != 0 ||
        (stride > 0 && out == nullptr) || (wide && scratch == nullptr))
        return int(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool plane = !samples && stride > 0, vec = n % 4 == 0;
    auto kernel = plane ? (vec ? hash_keys_winmin_sync_kernel<true, true>
                               : hash_keys_winmin_sync_kernel<true, false>)
                        : (vec ? hash_keys_winmin_sync_kernel<false, true>
                               : hash_keys_winmin_sync_kernel<false, false>);
    const dim3 grid((n + kK1Span - 1) / kK1Span, rows);
    kernel<<<grid, kK1Warps * 32, 0, s>>>(
        static_cast<const uint8_t*>(blocks), static_cast<uint32_t*>(keys),
        static_cast<uint32_t*>(wide ? scratch : out), n, width, pbits,
        uint32_t(pmask), wide ? kRowSpan : stride, flip);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !wide) return int(err);
    const auto m128 = static_cast<const uint32_t*>(scratch);
    const auto dst = static_cast<uint32_t*>(out);
    if (plane) {
        const dim3 stretch((n + 4 * kThreads - 1) / (4 * kThreads), rows);
        if (vec)
            winmin_stretch_kernel<true><<<stretch, kThreads, 0, s>>>(
                m128, dst, n, stride / kRowSpan);
        else
            winmin_stretch_kernel<false><<<stretch, kThreads, 0, s>>>(
                m128, dst, n, stride / kRowSpan);
    } else {
        const int ns = (n + stride - 1) / stride;
        sync_samples_kernel<<<dim3((ns + kThreads - 1) / kThreads, rows),
                              kThreads, 0, s>>>(
            m128, dst, (n + kRowSpan - 1) / kRowSpan, stride / kRowSpan, ns);
    }
    return int(cudaGetLastError());
}

int qz_neighbor_unsort_keys(const void* sk, void* out, int rows, int w,
                            int pbits, int neighbors, int pmask,
                            unsigned flip, void* stream) {
    if (rows <= 0 || w <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = w % 4 == 0;
    const int per = vec ? 4 * kK2Threads : kK2Threads;  // words a CTA
    const unsigned chunks = unsigned((w + per - 1) / per);
    for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
        const dim3 grid(chunks, unsigned(min(rows - r0, kMaxGridY)));
        const uint32_t* src =
            static_cast<const uint32_t*>(sk) + size_t(r0) * w;
        uint32_t* dst = static_cast<uint32_t*>(out) + size_t(r0) * w;
        if (vec)
            neighbor_unsort_keys_kernel<true><<<grid, kK2Threads, 0, st>>>(
                src, dst, w, pbits, neighbors, uint32_t(pmask), flip);
        else
            neighbor_unsort_keys_kernel<false><<<grid, kK2Threads, 0, st>>>(
                src, dst, w, pbits, neighbors, uint32_t(pmask), flip);
    }
    return int(cudaGetLastError());
}

int qz_ldm_keys(const void* minz, void* out, int nspans, int n, int stride,
                int span_blocks, int pbits, unsigned flip, void* stream) {
    const int spb = n / stride;  // samples a block
    if (nspans <= 0 || spb <= 0) return 0;
    const unsigned chunks = unsigned((spb + kK3Threads - 1) / kK3Threads);
    for (int r0 = 0; r0 < nspans; r0 += kMaxGridY)
        ldm_keys_kernel<<<dim3(chunks, unsigned(span_blocks),
                               unsigned(min(nspans - r0, kMaxGridY))),
                          kK3Threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(minz), static_cast<uint32_t*>(out),
            n, stride, spb, span_blocks, nspans, r0, pbits, flip);
    return int(cudaGetLastError());
}

// K4 on the stream over rows blocks of ns slots; ldm_rows (null: no LDM)
// holds spans of sb blocks of spb samples each at `stride` positions, its
// keys carrying ldm_pbits position bits. cudaErrorInvalidValue, and no
// launch, for bits the kernel cannot take or a sample every sls = ns /
// spb slots where sls is no power of two >= kSyncSlots.
int qz_compact_slots_sync(const void* su, const void* lengths,
                          const void* ldm_rows, void* out, int rows, int ns,
                          int pbits, int width, int sb, int spb,
                          int ldm_pbits, int stride, int max_off,
                          unsigned flip, void* stream) {
    if (rows <= 0 || ns <= 0) return int(cudaSuccess);
    const int sls = spb > 0 ? ns / spb : 0;
    if (pbits < 2 || pbits > 31 ||
        (spb > 0 && (ldm_rows == nullptr || sb < 1 || ns % spb != 0 ||
                     sls < kSyncSlots || (sls & (sls - 1)) != 0 ||
                     ldm_pbits < 1 || ldm_pbits > 31 || stride < 1)))
        return int(cudaErrorInvalidValue);
    const LdmArgs ldm = {static_cast<const uint32_t*>(ldm_rows), sb,
                         spb > 0 ? spb : 0, stride, max_off,
                         spb > 0 ? (1u << (32 - ldm_pbits)) - 1u : 0u};
    const unsigned chunks = unsigned((ns + kSyncChunk - 1) / kSyncChunk);
    const auto s = static_cast<cudaStream_t>(stream);
    auto kernel = ns % kSyncSlots ? compact_slots_sync_kernel<false>
                                  : compact_slots_sync_kernel<true>;
    for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
        const dim3 grid(chunks, unsigned(min(rows - r0, kMaxGridY)));
        kernel<<<grid, kSyncThreads, 0, s>>>(
            static_cast<const uint32_t*>(su),
            static_cast<const int32_t*>(lengths), ldm,
            static_cast<uint32_t*>(out), ns, pbits, width,
            sls > 0 ? __builtin_ctz(unsigned(sls)) : 0, flip, r0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return int(err);
    }
    return int(cudaSuccess);
}

}  // extern "C"
