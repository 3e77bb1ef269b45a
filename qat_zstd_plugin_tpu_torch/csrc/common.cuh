// Helpers shared by the port's CUDA sources: the hash constants and gram
// hash of qat_zstd_plugin_tpu.ops.glue_kernels._hash_tile, the launch
// shape of the one-thread-per-element kernels, the templated body of the
// full-resolution key and minimizer-plane kernels (B5, B6, B9), and the
// offset-1 run scan of B7 and B13.

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
// The offset-1 run scan of B7 finalize_candidates and B13 finalize_verified
// (their second pass), one CTA per row. The reference takes, for each i,
// the first byte change in [i, i + 2^14) by 14 doubling steps of a suffix
// minimum; the length it gives is capped at 16383, so the exact next
// change gives the same length. A per-thread forward walk would read up to
// 16384 bytes per position (2^31 reads for a 128 KiB all-same block), so
// each thread takes a chunk of the row: it finds the first change in its
// chunk, a shared-memory suffix minimum over the chunks gives each thread
// the first change after its chunk, and a backward walk over the chunk
// then knows the next change at every position. n reads per row plus the
// mlen/moff read-modify-write where the byte repeats.
// ---------------------------------------------------------------------------

constexpr int kRunCap = 16383;  // longest run / length finalize writes
constexpr int kBig = 1 << 30;   // "no change" in the run scan

constexpr int kRunThreads = 1024;

__global__ void __launch_bounds__(kRunThreads)
finalize_runs_kernel(const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ lengths,
                     int32_t* __restrict__ mlen, int32_t* __restrict__ moff,
                     int n) {
    __shared__ int after[kRunThreads];
    const int row = blockIdx.x;
    const uint8_t* x = blocks + size_t(row) * n;
    int32_t* ml = mlen + size_t(row) * n;
    int32_t* mo = moff + size_t(row) * n;
    const int blen = lengths[row];
    const int chunk = (n + kRunThreads - 1) / kRunThreads;
    const int lo = min(n, int(threadIdx.x) * chunk);
    const int hi = min(n, lo + chunk);
    // A change at j: x[j] != x[j+1]; the row's last byte is always one.
    auto change = [&](int j) { return j == n - 1 || x[j] != x[j + 1]; };

    int first = kBig;
    for (int j = lo; j < hi; ++j) {
        if (change(j)) {
            first = j;
            break;
        }
    }
    after[threadIdx.x] = first;
    __syncthreads();
    for (int s = 1; s < kRunThreads; s *= 2) {  // suffix minimum
        const int v = threadIdx.x + s < kRunThreads ? after[threadIdx.x + s]
                                                    : kBig;
        __syncthreads();
        after[threadIdx.x] = min(after[threadIdx.x], v);
        __syncthreads();
    }
    int next = threadIdx.x + 1 < kRunThreads ? after[threadIdx.x + 1] : kBig;
    for (int j = hi - 1; j >= lo; --j) {
        if (change(j)) next = j;  // first change at or after j
        const int len1 = min(min(next - j + 1, blen - j), kRunCap);
        if (j > 0 && x[j] == x[j - 1] && len1 >= 4 && len1 > ml[j]) {
            ml[j] = len1;
            mo[j] = 1;
        }
    }
}

}  // namespace
