// Helpers shared by the port's CUDA sources: the hash constants and gram
// hash of qat_zstd_plugin_tpu.ops.glue_kernels._hash_tile, the launch
// shape of the one-thread-per-element kernels, the templated body of the
// full-resolution key and minimizer-plane kernels (B5, B6, B9; K1 takes
// its row scans), the LDM estimate of one sample (K4), and the tiled
// offset-1 run scan that B7 and B13 fuse with their first pass.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 2654435761u;
constexpr uint32_t kC2 = 2246822519u;
constexpr uint32_t kC3 = 3266489917u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t be_word(const uint8_t* b) {
    return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
           (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

// hbits-bit hash of the width-byte gram at b (glue_kernels._hash_tile).
__device__ __forceinline__ uint32_t gram_hash(const uint8_t* b, int width,
                                              int hbits) {
    const uint32_t w0 = be_word(b);
    uint32_t h;
    if (width == 4) {
        h = w0 * kC1;
    } else if (width == 5) {
        h = (w0 * kC1) ^ ((uint32_t(b[4]) * kC2) << 11);
    } else if (width == 6) {
        h = (w0 * kC1) ^ (((uint32_t(b[4]) << 8) | uint32_t(b[5])) * kC2);
    } else {  // 8
        h = (w0 * kC1) ^ (be_word(b + 4) * kC2 * kC3);
    }
    return h >> (32 - hbits);
}

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // a launch's rows go in groups of this

inline unsigned blocks_for(long long total) {
    return unsigned((total + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// Full-resolution sort keys and the windowed-minimum plane of the 8-gram
// hash: B5 hash_keys (kKeys), B6 hash_keys_winmin (kKeys and kMinz) in
// dense_kernels.cu, B9 ldm_winmin (kMinz only) in content_kernels.cu.
//
// keys[i] = (hash_w(i) >> pbits << pbits | i & pmask) ^ flip in the
// (rows * nseg, w) layout, which is the (rows, n) row-major one; minz[i]
// = the unsigned minimum of h8 over [i, i + stride), h8 the 8-gram hash
// with bytes past the row read as 0 and 0xFFFFFFFF at or past n.
//
// Bound: device memory, n bytes read and 4n written per output plane
// (B6 9n, B9 and B5 5n bytes a row). The design makes a position's work
// the same at every stride and touches no shared memory:
//  - one warp per tile of kHashRows rows of kRowSpan = 128 positions of
//    a block row, lane l holding positions 4l..4l+3 of each row; no
//    warp waits on another, so there is no __syncthreads;
//  - loads: lane l loads word l of each row of the tile, of the row
//    after it (the halo, for the minima) and, with kMinz, of the row
//    after that (the halo's last grams), all at once: each warp load is
//    one whole 128-byte line (16-byte loads would need the words moved
//    between lanes to their rows), 0 past the row's end;
//  - grams: the lane's next two words come from lanes l+1 and l+2 by
//    shuffle (lanes 30 and 31 take lanes 0 and 1's words of the next
//    row: each source lane sends the row its reader needs), the
//    big-endian words at 4l+k and 4l+k+4 are __byte_perm of them, and
//    h8 and the width's hash are computed from those in registers;
//  - the windowed minimum, van Herk/Gil-Werman: the row is cut into
//    blocks of S = stride positions (L = S/4 lanes) and minz[i] =
//    min(suffix[i], prefix[i + S - 1]), suffix the minimum from i to its
//    block's end and prefix from its block's start to i. The lane's own
//    four first, then segmented shuffle scans over the block's L lanes
//    (log2 L steps each, __shfl_*_sync's width); prefix[i + S - 1] lies L
//    lanes on (for lane l + L >= 32 in the next row's lane l + L - 32),
//    one shuffle a position. Rows go in order and each keeps its
//    prefixes for the row before it; the tile's last row takes the halo
//    row's. S = 1 and 2 take h8 and min(h8[i], h8[i+1]) directly. S >
//    128 (up to 4096; no level takes it): the kernel writes the S = 128
//    plane into scratch and winmin_stretch_kernel takes, for each i, the
//    minimum of that plane at i, i + 128, ..., i + S - 128;
//  - stores: one 16-byte store per output a lane and row: a warp writes
//    512 contiguous bytes.
// ---------------------------------------------------------------------------

constexpr int kHashWarps = 4;   // warps a CTA
constexpr int kHashRows = 8;    // rows a warp tile
constexpr int kRowSpan = 128;   // positions a row: 32 lanes x 4
constexpr int kWarpSpan = kHashRows * kRowSpan;
constexpr int kHashSpan = kHashWarps * kWarpSpan;  // positions a CTA
constexpr int kMaxStride = 4096;

constexpr unsigned kFull = 0xFFFFFFFFu;

// The big-endian word of bytes k..k+3 of the little-endian pair (lo, hi).
__device__ __forceinline__ uint32_t be_at(uint32_t lo, uint32_t hi, int k) {
    return __byte_perm(lo, hi, 0x0123u + 0x1111u * unsigned(k));
}

// gram_hash's arithmetic (before the shift) from the big-endian words a
// and b at the gram's first and fifth byte.
__device__ __forceinline__ uint32_t hash_words(uint32_t a, uint32_t b,
                                               int width) {
    const uint32_t h = a * kC1;
    if (width == 4) return h;
    if (width == 5) return h ^ (((b >> 24) * kC2) << 11);
    if (width == 6) return h ^ ((b >> 16) * kC2);
    return h ^ (b * kC2 * kC3);
}

__device__ __forceinline__ uint4 min4(uint4 a, uint32_t b) {
    return make_uint4(min(a.x, b), min(a.y, b), min(a.z, b), min(a.w, b));
}

struct HashArgs {
    uint32_t* keys;  // the row's keys (kKeys)
    int n, width, pbits;
    uint32_t pmask, flip;
};

// One row of a warp tile: lane `lane` at positions i..i+3 (i % 4 == 0)
// with its word `own` of the row and `next` of the row after. Writes the
// keys when `write_keys` is set; returns h8 (kEmpty at or past n).
template <bool kKeys, bool kMinz>
__device__ __forceinline__ uint4 tile_row(const HashArgs& a, uint32_t own,
                                          uint32_t next, int lane, int i,
                                          bool write_keys) {
    const uint32_t b = __shfl_sync(kFull, lane >= 1 ? own : next,
                                   (lane + 1) & 31);
    const uint32_t c = __shfl_sync(kFull, lane >= 2 ? own : next,
                                   (lane + 2) & 31);
    uint32_t lo[4], hi[4];  // big-endian words at i + k and i + k + 4
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        lo[k] = be_at(own, b, k);
        hi[k] = be_at(b, c, k);
    }
    if (kKeys && write_keys && i < a.n) {  // n % 4 == 0: all four are in
        uint32_t k4[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            k4[k] = ((hash_words(lo[k], hi[k], a.width) >> a.pbits
                      << a.pbits) | (uint32_t(i + k) & a.pmask)) ^ a.flip;
        *reinterpret_cast<uint4*>(a.keys + i) =
            make_uint4(k4[0], k4[1], k4[2], k4[3]);
    }
    if (!kMinz || i >= a.n) return make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
    return make_uint4(hash_words(lo[0], hi[0], 8), hash_words(lo[1], hi[1], 8),
                      hash_words(lo[2], hi[2], 8), hash_words(lo[3], hi[3], 8));
}

// Prefix and suffix minima of h within blocks of L lanes (4L positions):
// the lane's own four, then segmented shuffle scans over the block.
__device__ __forceinline__ void block_scans(uint4 h, int lane, int L,
                                            uint4& pre, uint4& suf) {
    pre.x = h.x;
    pre.y = min(pre.x, h.y);
    pre.z = min(pre.y, h.z);
    pre.w = min(pre.z, h.w);
    suf.w = h.w;
    suf.z = min(h.z, suf.w);
    suf.y = min(h.y, suf.z);
    suf.x = min(h.x, suf.y);
    uint32_t ip = pre.w, is = suf.x;  // inclusive over the block's lanes
    for (int d = 1; d < L; d *= 2) {
        ip = min(ip, __shfl_up_sync(kFull, ip, d, L));
        is = min(is, __shfl_down_sync(kFull, is, d, L));
    }
    uint32_t ep = __shfl_up_sync(kFull, ip, 1, L);  // the lanes before
    uint32_t es = __shfl_down_sync(kFull, is, 1, L);  // the lanes after
    if ((lane & (L - 1)) == 0) ep = kEmpty;
    if ((lane & (L - 1)) == L - 1) es = kEmpty;
    pre = min4(pre, ep);
    suf = min4(suf, es);
}

// minz at the lane's four positions of a row from its h8, prefixes and
// suffixes and the next row's h8 and prefixes.
__device__ __forceinline__ uint4 window_min(uint4 h, uint4 pre, uint4 suf,
                                            uint4 hn, uint4 pn, int lane,
                                            int stride) {
    if (stride >= 4) {
        // prefix[i + S - 1]: at k > 0 lane + L's prefix k - 1, at k = 0
        // lane + L - 1's prefix 3; the source lane sends this row's
        // prefix when its reader is in this row, else the next row's.
        const int L = stride >> 2;
        const int up = (lane + L) & 31;
        const uint32_t q0 = __shfl_sync(kFull, lane >= L ? pre.x : pn.x, up);
        const uint32_t q1 = __shfl_sync(kFull, lane >= L ? pre.y : pn.y, up);
        const uint32_t q2 = __shfl_sync(kFull, lane >= L ? pre.z : pn.z, up);
        const uint32_t q3 = __shfl_sync(kFull, lane >= L - 1 ? pre.w : pn.w,
                                        (lane + L - 1) & 31);
        return make_uint4(min(suf.x, q3), min(suf.y, q0), min(suf.z, q1),
                          min(suf.w, q2));
    }
    if (stride == 2) {
        const uint32_t h4 = __shfl_sync(kFull, lane >= 1 ? h.x : hn.x,
                                        (lane + 1) & 31);
        return make_uint4(min(h.x, h.y), min(h.y, h.z), min(h.z, h.w),
                          min(h.w, h4));
    }
    return h;
}

template <bool kKeys, bool kMinz>
__global__ void __launch_bounds__(kHashWarps * 32)
hash_keys_kernel(const uint8_t* __restrict__ blocks,
                 uint32_t* __restrict__ keys, uint32_t* __restrict__ minz,
                 int n, int width, int pbits, uint32_t pmask, int stride,
                 uint32_t flip) {
    constexpr int kLoads = kHashRows + (kMinz ? 2 : 1);  // rows of words
    const int lane = threadIdx.x & 31;
    const int t0 =
        (int(blockIdx.x) * kHashWarps + int(threadIdx.x >> 5)) * kWarpSpan;
    if (t0 >= n) return;  // the whole warp
    const size_t base = size_t(blockIdx.y) * n;
    const uint32_t* x = reinterpret_cast<const uint32_t*>(blocks + base);
    uint32_t w[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
        const int q = (t0 >> 2) + 32 * r + lane;
        w[r] = q < (n >> 2) ? __ldg(x + q) : 0u;
    }
    const HashArgs a = {kKeys ? keys + base : nullptr, n, width, pbits,
                        pmask, flip};
    const int i0 = t0 + 4 * lane;
    if (!kMinz) {
#pragma unroll
        for (int r = 0; r < kHashRows; ++r)
            tile_row<kKeys, false>(a, w[r], w[r + 1], lane,
                                   i0 + r * kRowSpan, true);
        return;
    }
    uint32_t* m_row = minz + base;
    const int L = stride >= 4 ? stride >> 2 : 1;
    uint4 h = tile_row<kKeys, true>(a, w[0], w[1], lane, i0, true);
    uint4 pre = h, suf = h;
    if (stride >= 4) block_scans(h, lane, L, pre, suf);
#pragma unroll
    for (int r = 0; r < kHashRows; ++r) {
        // Row r + 1; at r + 1 == kHashRows the halo, which writes no keys.
        const uint4 hn = tile_row<kKeys, true>(
            a, w[r + 1], w[r + 2], lane, i0 + (r + 1) * kRowSpan,
            r + 1 < kHashRows);
        uint4 pn = hn, sn = hn;
        if (stride >= 4) block_scans(hn, lane, L, pn, sn);
        const int i = i0 + r * kRowSpan;
        const uint4 m = window_min(h, pre, suf, hn, pn, lane, stride);
        if (i < n) *reinterpret_cast<uint4*>(m_row + i) = m;
        h = hn;
        pre = pn;
        suf = sn;
    }
}

// minz[i] = the minimum of the stride-128 plane m128 at i, i + 128, ...,
// i + 128 (reps - 1) (kEmpty at or past n): the windowed minimum over
// [i, i + 128 reps). One thread per 4 positions, 16-byte accesses where
// n % 4 == 0 (kVec), else 4-byte ones (K1's rows of n % 4 == 2).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
winmin_stretch_kernel(const uint32_t* __restrict__ m128,
                      uint32_t* __restrict__ minz, int n, int reps) {
    const int i = 4 * (int(blockIdx.x) * kThreads + int(threadIdx.x));
    if (i >= n) return;
    const size_t at = size_t(blockIdx.y) * n + i;
    if (!kVec) {
        for (int k = 0; k < 4 && i + k < n; ++k) {
            uint32_t m = m128[at + k];
            for (int r = 1; r < reps && i + k + r * kRowSpan < n; ++r)
                m = min(m, m128[at + k + r * kRowSpan]);
            minz[at + k] = m;
        }
        return;
    }
    uint4 m = *reinterpret_cast<const uint4*>(m128 + at);
    for (int r = 1; r < reps && i + r * kRowSpan < n; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(m128 + at +
                                                         r * kRowSpan);
        m = make_uint4(min(m.x, v.x), min(m.y, v.y), min(m.z, v.z),
                       min(m.w, v.w));
    }
    *reinterpret_cast<uint4*>(minz + at) = m;
}

// Launches B5, B6 or B9 on the stream: cudaErrorInvalidValue, and no
// launch, for a shape the grid cannot hold, a stride that is not a power
// of two up to 4096, or a stride above 128 without scratch (rows * n
// words, the stride-128 plane).
template <bool kKeys, bool kMinz>
int launch_hash_keys(const void* blocks, void* keys, void* minz,
                     void* scratch, int rows, int n, int width, int pbits,
                     int pmask, int stride, unsigned flip, void* stream) {
    const bool wide = kMinz && stride > kRowSpan;
    if (rows < 1 || rows > 65535 || n < 4 || n % 4 != 0 ||
        (kMinz && (stride < 1 || stride > kMaxStride ||
                   (stride & (stride - 1)) != 0)) ||
        (wide && scratch == nullptr))
        return int(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    auto* plane = static_cast<uint32_t*>(wide ? scratch : minz);
    const dim3 grid((n + kHashSpan - 1) / kHashSpan, rows);
    hash_keys_kernel<kKeys, kMinz><<<grid, kHashWarps * 32, 0, s>>>(
        static_cast<const uint8_t*>(blocks), static_cast<uint32_t*>(keys),
        plane, n, width, pbits, uint32_t(pmask), wide ? kRowSpan : stride,
        flip);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !wide) return int(err);
    const dim3 stretch((n / 4 + kThreads - 1) / kThreads, rows);
    winmin_stretch_kernel<true><<<stretch, kThreads, 0, s>>>(
        plane, static_cast<uint32_t*>(minz), n, stride / kRowSpan);
    return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// _ldm_est of one sample (glue_kernels._ldm_est, XLA glue in the
// reference), for a kernel that reads the position-ordered LDM keys
// itself: K4 compact_slots_sync (l1_kernels.cu). Sample q of block b
// reads offs at columns c..c+5 of span row b / sb, c = half + (b % sb) spb
// + q, 0 past the row's end (the chain runs on into block b + 1's
// samples); the chain of offsets that agree (|nxt - offs| <= 1, nxt > 0)
// has its reach capped at 6; the estimate reach * stride is valid for
// reach >= 2, offs >= 2 and offs * stride <= max_off (the int32 product,
// as the reference's), and only where q * stride + 40 <= length.
// ---------------------------------------------------------------------------

constexpr int kLdmReach = 6;  // a sample and the 5 after it

struct LdmArgs {
    const uint32_t* rows;  // (nspans, 2 half) LDM keys; null: no LDM
    int sb, spb, stride, max_off;
    uint32_t offmask;  // the keys' offset bits
};

// The offsets of sample q of block b and of the five after it (`flip`
// XORed into each word read).
__device__ __forceinline__ void ldm_offsets(const LdmArgs& a, int b, int q,
                                            uint32_t flip,
                                            uint32_t (&offs)[kLdmReach]) {
    const int half = a.sb * a.spb;
    const int span = b / a.sb;
    const int p = (b - span * a.sb) * a.spb + q;  // column - half
    const uint32_t* row = a.rows + size_t(span) * (2 * half) + half;
#pragma unroll
    for (int k = 0; k < kLdmReach; ++k)
        offs[k] = p + k < half ? (__ldg(row + p + k) ^ flip) & a.offmask
                               : 0u;
}

// The estimate (0: no claim) of sample q from its offsets; ldo gets the
// LDM byte offset offs * stride.
__device__ __forceinline__ int ldm_estimate(const uint32_t (&offs)[kLdmReach],
                                            const LdmArgs& a, int q,
                                            int blen, int& ldo) {
    const int o = int(offs[0]);
    bool agree = o > 0;
    int reach = agree;
#pragma unroll
    for (int k = 1; k < kLdmReach; ++k) {
        const int nx = int(offs[k]);
        agree = agree && abs(nx - o) <= 1 && nx > 0;
        reach += agree;
    }
    ldo = int(uint32_t(o) * uint32_t(a.stride));
    const bool valid = reach >= 2 && o >= 2 && ldo <= a.max_off &&
                       q * a.stride + 40 <= blen;
    return valid ? reach * a.stride : 0;
}

// ---------------------------------------------------------------------------
// The offset-1 run scan of B7 finalize_candidates and B13 finalize_verified,
// fused with their first pass (dense_kernels.cu, verified_kernels.cu).
//
// The reference takes, for each i, the first byte change in [i, i + 2^14)
// by 14 doubling steps of a suffix minimum (the row's last byte counts as
// a change); the length it gives, min(r - i + 1, len - i, 16383), is
// capped at 16383, so the exact next change gives the same length. It
// then takes the run where the byte repeats (i > 0, x[i] == x[i-1]),
// len1 >= 4 and len1 > mlen.
//
// Bound: device memory (3.35 TB/s). The scan itself needs only the n
// bytes of a row; the first pass's key reads (4n bytes a key array) and
// the two 4n-byte planes written dominate. The design makes the work a
// position does independent of the data, keeps every SM busy, keeps many
// loads in flight and writes each plane once, neighbouring threads on
// neighbouring positions:
//  1. tile_first_change_kernel, one warp per tile of kRunTile positions
//     of a row (kFirstWarps tiles a CTA): the tile's first change, or
//     kBig, into a scratch word. A lane loads four 16-byte chunks of the
//     tile (one byte at a time where n % 16 != 0), takes the next byte
//     from its neighbour lane, and compares four bytes at once (n bytes
//     read, n / kRunTile words written).
//  2. finalize_tile_kernel<Pass>, one CTA per (tile, row), kRunThreads
//     threads, thread t holding positions t0 + k * kRunThreads + t for
//     k < kRunPer: (a) it issues every load it needs at once: the next
//     tiles' first changes, the length, the tile's bytes with 16 on each
//     side, and the tile's words of each key array plus a halo of
//     Pass::kHalo (the chain's reach), 16 bytes a load into shared
//     memory; (b) one warp ballot per k turns the change bits into
//     kRunWords 32-bit words in shared memory;
//     (c) one warp takes, for each word, the first change at or after its
//     start by a reverse min-scan over the words (two a lane, then
//     shuffles), seeded with the minimum of the next kRunLook tiles'
//     first changes: a position with no change left in its tile needs
//     the exact next change only while it is closer than the cap, and
//     kRunLook tiles always reach that far; (d) each thread runs the
//     first pass (Pass) at its positions from shared memory, finds the
//     next change from its word (or the next word's scan), applies the
//     run rule and writes mlen and moff once.
// With kRunTile = 2048 a B=64 x 128 KiB batch is 4096 CTAs of 256
// threads.
// ---------------------------------------------------------------------------

constexpr int kRunCap = 16383;  // longest run / length finalize writes
constexpr int kBig = 1 << 30;   // "no change" in the run scan

constexpr int kRunTile = 2048;  // positions a CTA (glue_kernels.RUN_TILE)
constexpr int kRunThreads = 256;
constexpr int kRunPer = kRunTile / kRunThreads;  // positions a thread
constexpr int kRunWords = kRunTile / 32;         // change words a tile
constexpr int kFirstWarps = kRunThreads / 32;    // pre-pass tiles a CTA
// Tiles after its own that a tile's last position must see: the change
// it needs lies within kRunCap - 2 bytes of it.
constexpr int kRunLook = (kRunCap + 1) / kRunTile;
static_assert(kRunWords == 64, "the word scan gives each lane two words");
static_assert(kRunTile % 512 == 0 && kRunTile % kRunThreads == 0 &&
              kRunThreads % 32 == 0, "tile geometry");
static_assert(kRunLook * kRunTile >= kRunCap - 1, "look-ahead too short");

// First change among the 16 bytes of v (byte k at c + k), the byte after
// them nb: offset 0-15, or kBig.
__device__ __forceinline__ int chunk_first_change(uint4 v, uint32_t nb) {
    const uint32_t w[5] = {v.x, v.y, v.z, v.w, nb};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t d = w[q] ^ __funnelshift_r(w[q], w[q + 1], 8);
        if (d) return 4 * q + ((__ffs(d) - 1) >> 3);
    }
    return kBig;
}

template <bool kVec>  // kVec: n % 16 == 0, so every chunk is aligned
__global__ void __launch_bounds__(kRunThreads)
tile_first_change_kernel(const uint8_t* __restrict__ blocks,
                         int* __restrict__ first, int n, int tiles) {
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * kFirstWarps + int(threadIdx.x >> 5);
    if (tile >= tiles) return;  // the whole warp
    const int row = blockIdx.y;
    const int t0 = tile * kRunTile;
    const uint8_t* x = blocks + size_t(row) * n;
    int f = n - 1 < t0 + kRunTile ? n - 1 : kBig;  // the row's last byte
    if (kVec) {
        constexpr int kChunks = kRunTile / 512;  // 16-byte chunks a lane
        uint4 v[kChunks];
        uint32_t b0[kChunks + 1];  // chunks' first bytes, the tile's next
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
            const int c = t0 + 16 * (lane + 32 * q);
            v[q] = c < n ? __ldg(reinterpret_cast<const uint4*>(x + c))
                         : make_uint4(0, 0, 0, 0);
            b0[q] = v[q].x & 0xFFu;
        }
        b0[kChunks] = t0 + kRunTile < n ? x[t0 + kRunTile] : 0u;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
            // The byte after chunk (lane, q): chunk (lane + 1, q)'s first,
            // for lane 31 chunk (0, q + 1)'s, or the next tile's.
            const uint32_t up = __shfl_down_sync(kFull, b0[q], 1);
            const uint32_t wrap = q + 1 < kChunks
                ? __shfl_sync(kFull, b0[q + 1], 0) : b0[kChunks];
            const int c = t0 + 16 * (lane + 32 * q);
            // At c + 15 == n - 1 the byte after is not the row's, but
            // that position is a change anyway.
            if (c < n)
                f = min(f, c + chunk_first_change(v[q], lane < 31 ? up
                                                                  : wrap));
        }
    } else {
        for (int k = 0; k < kRunTile / 32; ++k) {
            const int j = t0 + 32 * k + lane;
            if (j < n - 1 && x[j] != x[j + 1]) f = min(f, j);
        }
    }
    f = __reduce_min_sync(kFull, f);
    if (lane == 0) first[size_t(row) * tiles + tile] = f;
}

// Copies words [t0, t0 + kSpan) of a key row into shared memory (0 past
// the row's n words), 16 bytes a load where the row is 16-byte aligned.
template <int kSpan>
__device__ __forceinline__ void stage_words(const uint32_t* __restrict__ src,
                                            uint32_t* dst, int t0, int n,
                                            bool vec) {
    static_assert(kSpan % 4 == 0, "whole 16-byte groups");
    constexpr int kIters = (kSpan / 4 + kRunThreads - 1) / kRunThreads;
    if (vec) {
#pragma unroll
        for (int it = 0; it < kIters; ++it) {
            const int q = it * kRunThreads + int(threadIdx.x);
            const int j = t0 + 4 * q;
            if (q >= kSpan / 4) break;
            if (j + 4 <= n) {
                reinterpret_cast<uint4*>(dst)[q] =
                    __ldg(reinterpret_cast<const uint4*>(src + j));
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dst[4 * q + e] = j + e < n ? __ldg(src + j + e) : 0u;
            }
        }
    } else {
        for (int q = threadIdx.x; q < kSpan; q += kRunThreads)
            dst[q] = t0 + q < n ? __ldg(src + t0 + q) : 0u;
    }
}

constexpr int kByteHalo = 16;  // staged bytes before and after a tile
constexpr int kByteSpan = kRunTile + 2 * kByteHalo;

// Copies bytes [t0 - 16, t0 + kRunTile + 16) of a row into shared memory
// (0 outside the row), 16 bytes a load where n % 16 == 0.
__device__ __forceinline__ void stage_bytes(const uint8_t* __restrict__ x,
                                            uint8_t* dst, int t0, int n) {
    const int b0 = t0 - kByteHalo;
    if (n % 16 == 0) {
        static_assert(kByteSpan / 16 <= kRunThreads, "one chunk a thread");
        const int q = threadIdx.x;
        const int c = b0 + 16 * q;
        if (q < kByteSpan / 16)
            reinterpret_cast<uint4*>(dst)[q] = c >= 0 && c < n
                ? __ldg(reinterpret_cast<const uint4*>(x + c))
                : make_uint4(0, 0, 0, 0);
    } else {
        for (int q = threadIdx.x; q < kByteSpan; q += kRunThreads) {
            const int j = b0 + q;
            dst[q] = j >= 0 && j < n ? x[j] : 0;
        }
    }
}

// A first pass: Pass::kArrays key arrays, each staged with a halo of
// Pass::kHalo words; pass.arrays() of them in use, pass.keys(a) the a-th
// key array's (rows, n) words; pass(tile, r, i, blen, ml, mo) gives the
// filtered, capped (mlen, moff) at position i = t0 + r of a row from the
// staged words, tile[a * (kRunTile + kHalo) + r'] for position t0 + r'.
// Pass::kUnroll positions of a thread are unrolled together in (d).
template <class Pass>
__global__ void __launch_bounds__(kRunThreads)
finalize_tile_kernel(Pass pass, const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ lengths,
                     const int* __restrict__ first,
                     int32_t* __restrict__ mlen, int32_t* __restrict__ moff,
                     int n, int tiles) {
    constexpr int kSpan = kRunTile + Pass::kHalo;
    __shared__ __align__(16) uint32_t keys[Pass::kArrays * kSpan];
    __shared__ __align__(16) uint8_t xs[kByteSpan];  // x[t0 - 16 + q]
    __shared__ uint32_t bits[kRunWords];
    __shared__ int nextw[kRunWords + 1];  // first change at or after word q
    const int row = blockIdx.y;
    const int tile = blockIdx.x;
    const int t0 = tile * kRunTile;
    const int lane = threadIdx.x & 31;
    const uint8_t* sx = xs + kByteHalo;  // sx[r]: position t0 + r

    // (a) Every load of the CTA at once: the following tiles' first
    // changes (warp 0), the length, the tile's bytes and its key words
    // with their halo.
    int after = kBig;
    if (threadIdx.x < 32) {
        for (int q = 1 + lane; q <= kRunLook && tile + q < tiles; q += 32)
            after = min(after, first[size_t(row) * tiles + tile + q]);
    }
    const int blen = lengths[row];
    stage_bytes(blocks + size_t(row) * n, xs, t0, n);
#pragma unroll
    for (int a = 0; a < Pass::kArrays; ++a) {
        if (a < pass.arrays())
            stage_words<kSpan>(pass.keys(a) + size_t(row) * n,
                               keys + a * kSpan, t0, n, (n & 3) == 0);
    }
    __syncthreads();

    // (b) Change bits: bit r & 31 of word r >> 5 is position t0 + r; a
    // change at j: x[j] != x[j+1], and the row's last byte (and, harmlessly,
    // every position past it).
#pragma unroll
    for (int k = 0; k < kRunPer; ++k) {
        const int r = k * kRunThreads + int(threadIdx.x);
        const uint32_t word = __ballot_sync(
            kFull, t0 + r >= n - 1 || sx[r] != sx[r + 1]);
        if (lane == 0) bits[r >> 5] = word;
    }
    __syncthreads();

    // (c) One warp: the reverse min-scan over the words, lane l holding
    // words 2l and 2l + 1, seeded with the first change after the tile.
    if (threadIdx.x < 32) {
        after = __reduce_min_sync(kFull, after);
        const uint32_t w0 = bits[2 * lane], w1 = bits[2 * lane + 1];
        const int p0 = w0 ? t0 + 64 * lane + __ffs(w0) - 1 : kBig;
        const int p1 = w1 ? t0 + 64 * lane + 32 + __ffs(w1) - 1 : kBig;
        int s = min(p0, p1);  // inclusive suffix minimum over the lanes
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int v = __shfl_down_sync(kFull, s, d);
            if (lane + d < 32) s = min(s, v);
        }
        int later = __shfl_down_sync(kFull, s, 1);  // lanes after this one
        later = lane == 31 ? after : min(later, after);
        const int n1 = w1 ? p1 : later;
        nextw[2 * lane + 1] = n1;
        nextw[2 * lane] = w0 ? p0 : n1;
        if (lane == 0) nextw[kRunWords] = after;
    }
    __syncthreads();

    // (d) First pass, next change, run rule, one write of each plane.
    int32_t* ml_row = mlen + size_t(row) * n;
    int32_t* mo_row = moff + size_t(row) * n;
#pragma unroll (Pass::kUnroll)
    for (int k = 0; k < kRunPer; ++k) {
        const int r = k * kRunThreads + int(threadIdx.x);
        const int j = t0 + r;
        if (j >= n) break;
        int ml, mo;
        pass(keys, r, j, blen, ml, mo);
        const uint32_t m = bits[r >> 5] >> (r & 31);
        const int next = m ? j + __ffs(m) - 1 : nextw[(r >> 5) + 1];
        const bool repeat = j > 0 && sx[r] == sx[r - 1];
        const int len1 = min(min(next - j + 1, blen - j), kRunCap);
        if (repeat && len1 >= 4 && len1 > ml) {
            ml = len1;
            mo = 1;
        }
        ml_row[j] = ml;
        mo_row[j] = mo;
    }
}

// Launches both kernels on the stream; cudaErrorInvalidValue, and no
// launch, for a shape the grid cannot hold or scratch of fewer words than
// one a tile of every row.
template <class Pass>
int finalize_tiles(const Pass& pass, const void* blocks, const void* lengths,
                   void* scratch, size_t scratch_words, void* mlen,
                   void* moff, int rows, int n, void* stream) {
    const int tiles = (n + kRunTile - 1) / kRunTile;
    if (rows < 1 || rows > 65535 || n < 1 || n >= kBig ||
        scratch_words < size_t(rows) * size_t(tiles))
        return int(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto x = static_cast<const uint8_t*>(blocks);
    const auto first = static_cast<int*>(scratch);
    const dim3 pre((tiles + kFirstWarps - 1) / kFirstWarps, rows);
    if (n % 16 == 0)
        tile_first_change_kernel<true><<<pre, kRunThreads, 0, s>>>(
            x, first, n, tiles);
    else
        tile_first_change_kernel<false><<<pre, kRunThreads, 0, s>>>(
            x, first, n, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    finalize_tile_kernel<Pass><<<dim3(tiles, rows), kRunThreads, 0, s>>>(
        pass, x, static_cast<const int32_t*>(lengths), first,
        static_cast<int32_t*>(mlen), static_cast<int32_t*>(moff), n, tiles);
    return int(cudaGetLastError());
}

}  // namespace
