// Helpers shared by the port's CUDA sources: the hash constants and gram
// hash of qat_zstd_plugin_tpu.ops.glue_kernels._hash_tile, the launch
// shape of the one-thread-per-element kernels, the templated body of the
// full-resolution key and minimizer-plane kernels (B5, B6, B9), and the
// tiled offset-1 run scan that B7 and B13 fuse with their first pass.

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

inline unsigned blocks_for(long long total) {
    return unsigned((total + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// Full-resolution sort keys and the windowed-minimum plane of the 8-gram
// hash: B5 hash_keys (kKeys), B6 hash_keys_winmin (kKeys and kMinz) in
// dense_kernels.cu, B9 ldm_winmin (kMinz only) in content_kernels.cu.
//
// One thread per 4 consecutive positions; a CTA covers kHashSpan
// positions of one row. It stages the tile's bytes plus a halo in shared
// memory (zero past the row's end, as the reference's shifted reads), and
// each thread writes (hash_w(i) << pbits | i & pmask) for its four
// positions with one 16-byte store: the (rows * nseg, w) key layout is the
// (rows, n) row-major one. With kMinz the CTA first hashes every 8-gram of
// the tile plus a stride-wide halo once into shared memory (0xFFFFFFFF at
// or past n, the reference's fill) and each thread writes minz[i..i+3],
// the minimum over [i+k, i+k+stride): the inner [i+3, i+stride) is shared
// by the four. Bound: reads n bytes, writes 4n (keys) and 4n (minz) per
// row.
// ---------------------------------------------------------------------------

constexpr int kHashThreads = 256;
constexpr int kHashSpan = 4 * kHashThreads;

template <bool kKeys, bool kMinz>
__global__ void __launch_bounds__(kHashThreads)
hash_keys_kernel(const uint8_t* __restrict__ blocks,
                 uint32_t* __restrict__ keys, uint32_t* __restrict__ minz,
                 int n, int width, int pbits, uint32_t pmask, int stride) {
    extern __shared__ uint32_t smem[];
    const int nh = kMinz ? kHashSpan + stride : 0;  // h8 entries
    uint32_t* h8 = smem;
    uint8_t* bytes = reinterpret_cast<uint8_t*>(smem + nh);
    const int nb = (kMinz ? nh : kHashSpan) + 7;
    const int row = blockIdx.y;
    const int base = blockIdx.x * kHashSpan;
    const uint8_t* x = blocks + size_t(row) * n;

    for (int j = threadIdx.x; j < nb; j += kHashThreads) {
        const int p = base + j;
        bytes[j] = p < n ? x[p] : 0;
    }
    __syncthreads();
    if (kMinz) {
        for (int j = threadIdx.x; j < nh; j += kHashThreads)
            h8[j] = base + j < n ? gram_hash(bytes + j, 8, 32) : kEmpty;
        __syncthreads();
    }

    const int t = 4 * threadIdx.x;
    const int i = base + t;
    if (i >= n) return;  // n % 4 == 0: positions i..i+3 are all in the row
    const size_t at = (size_t(row) * n + i) >> 2;
    if (kKeys) {
        const int hbits = 32 - pbits;
        uint4 k;
        k.x = (gram_hash(bytes + t, width, hbits) << pbits) |
              (uint32_t(i) & pmask);
        k.y = (gram_hash(bytes + t + 1, width, hbits) << pbits) |
              (uint32_t(i + 1) & pmask);
        k.z = (gram_hash(bytes + t + 2, width, hbits) << pbits) |
              (uint32_t(i + 2) & pmask);
        k.w = (gram_hash(bytes + t + 3, width, hbits) << pbits) |
              (uint32_t(i + 3) & pmask);
        reinterpret_cast<uint4*>(keys)[at] = k;
    }

    if (kMinz) {
        uint4 m;
        if (stride >= 4) {
            uint32_t inner = kEmpty;  // min over [t+3, t+stride)
            for (int q = 3; q < stride; ++q) inner = min(inner, h8[t + q]);
            const uint32_t a0 = h8[t], a1 = h8[t + 1], a2 = h8[t + 2];
            const uint32_t b0 = h8[t + stride], b1 = h8[t + stride + 1],
                           b2 = h8[t + stride + 2];
            m.x = min(inner, min(a0, min(a1, a2)));
            m.y = min(inner, min(a1, min(a2, b0)));
            m.z = min(inner, min(a2, min(b0, b1)));
            m.w = min(inner, min(b0, min(b1, b2)));
        } else {
            uint32_t v[4] = {kEmpty, kEmpty, kEmpty, kEmpty};
            for (int p = 0; p < 4; ++p)
                for (int q = 0; q < stride; ++q)
                    v[p] = min(v[p], h8[t + p + q]);
            m = make_uint4(v[0], v[1], v[2], v[3]);
        }
        reinterpret_cast<uint4*>(minz)[at] = m;
    }
}

template <bool kKeys, bool kMinz>
int launch_hash_keys(const void* blocks, void* keys, void* minz, int rows,
                     int n, int width, int pbits, int pmask, int stride,
                     void* stream) {
    const int nh = kMinz ? kHashSpan + stride : 0;
    const int nb = (kMinz ? nh : kHashSpan) + 7;
    const size_t smem = size_t(nh) * 4 + ((size_t(nb) + 3) & ~size_t(3));
    const dim3 grid((n + kHashSpan - 1) / kHashSpan, rows);
    hash_keys_kernel<kKeys, kMinz><<<grid, kHashThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<uint32_t*>(keys),
        static_cast<uint32_t*>(minz), n, width, pbits, uint32_t(pmask),
        stride);
    return int(cudaGetLastError());
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

constexpr unsigned kFull = 0xFFFFFFFFu;

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
