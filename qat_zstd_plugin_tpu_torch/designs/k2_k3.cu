// Rejected designs of K2 (neighbor_unsort_keys) and K3 (ldm_keys), and the
// bare copy and gather of the same bytes, built only by designs/k2_k3.py to
// time them beside the kernels in csrc/l1_kernels.cu. Nothing of the codec
// calls them.
//
// K2 (neighbors <= 4 here): csrc's kernel reads a thread's 4 words and
// the 4 before them straight from the row (two 16-byte loads, the second
// an L1 hit of the previous thread's), claims 4 outputs from that 8-word
// window and writes them with one 16-byte store. Here: a CTA stages a
// tile of T words (1024, 2048, 4096) and the 4 words before it (the halo)
// in shared memory with 16-byte loads, and after a barrier each thread
// claims from an 8-word window of shared memory; and csrc's window with
// each claim behind a branch.
//
// K3, S samples a thread (S = 4, 8): a thread reads S consecutive samples
// of a block and writes each of its two runs of S output words with
// 16-byte stores. csrc's K3 takes one sample a thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 2654435761u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 xor4(uint4 v, uint32_t flip) {
    return make_uint4(v.x ^ flip, v.y ^ flip, v.z ^ flip, v.w ^ flip);
}

template <int T>  // tile words, a multiple of 4 * kThreads
__global__ void __launch_bounds__(kThreads)
k2_staged(const uint32_t* __restrict__ sk, uint32_t* __restrict__ out, int w,
          int pbits, int neighbors, uint32_t pmask, uint32_t flip) {
    constexpr int Q = T / (4 * kThreads);  // 16-byte loads a thread
    __shared__ __align__(16) uint32_t s[4 + T];  // halo, then the tile
    const int base = int(blockIdx.x) * T;
    const int n = min(T, w - base);
    const uint32_t* x = sk + size_t(blockIdx.y) * w;
    uint32_t* y = out + size_t(blockIdx.y) * w;
    if (threadIdx.x == 0 && base > 0)
        *reinterpret_cast<uint4*>(s) = xor4(
            __ldg(reinterpret_cast<const uint4*>(x + base - 4)), flip);
    uint4 v[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
        const int t = 4 * (int(threadIdx.x) + kThreads * u);
        if (t < n) v[u] = __ldg(reinterpret_cast<const uint4*>(x + base + t));
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
        const int t = 4 * (int(threadIdx.x) + kThreads * u);
        if (t < n) *reinterpret_cast<uint4*>(s + 4 + t) = xor4(v[u], flip);
    }
    __syncthreads();
    const int shift = 32 - pbits;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
        const int t = 4 * (int(threadIdx.x) + kThreads * u);
        if (t >= n) continue;
        const uint4 a = *reinterpret_cast<const uint4*>(s + t);
        const uint4 b = *reinterpret_cast<const uint4*>(s + 4 + t);
        const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = base + t + e;  // the row's first k see the fill
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
            o[e] = ((sv << shift) | off) ^ flip;
        }
        *reinterpret_cast<uint4*>(y + base + t) =
            make_uint4(o[0], o[1], o[2], o[3]);
    }
}

__device__ __forceinline__ void claim(uint32_t& off, uint32_t sh,
                                      uint32_t sp, uint32_t q, int pbits,
                                      uint32_t pmask) {
    const uint32_t pp = q & pmask;
    if (off == 0 && (q >> pbits) == sh && pp < sp) off = sp - pp;
}

// csrc's window with each claim behind a branch on (k <= neighbors,
// k <= j) and a helper's own test.
__global__ void __launch_bounds__(kThreads)
k2_window_branch(const uint32_t* __restrict__ sk, uint32_t* __restrict__ out,
                 int w, int pbits, int neighbors, uint32_t pmask,
                 uint32_t flip) {
    const int t = 4 * int(blockIdx.x * kThreads + threadIdx.x);
    if (t >= w) return;
    const uint32_t* x = sk + size_t(blockIdx.y) * w;
    uint32_t* y = out + size_t(blockIdx.y) * w;
    const uint4 a = t >= 4
        ? xor4(__ldg(reinterpret_cast<const uint4*>(x + t - 4)), flip)
        : make_uint4(0, 0, 0, 0);  // never read: k <= j below
    const uint4 b = xor4(__ldg(reinterpret_cast<const uint4*>(x + t)), flip);
    const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int shift = 32 - pbits;
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int j = t + e;
        const uint32_t sv = win[4 + e];
        const uint32_t sh = sv >> pbits, sp = sv & pmask;
        uint32_t off = 0;
#pragma unroll
        for (int k = 1; k <= 4; ++k)
            if (k <= neighbors && k <= j)
                claim(off, sh, sp, win[4 + e - k], pbits, pmask);
        for (int k = 5; k <= neighbors && k <= j && off == 0; ++k)
            claim(off, sh, sp, __ldg(x + j - k) ^ flip, pbits, pmask);
        o[e] = ((sv << shift) | off) ^ flip;
    }
    *reinterpret_cast<uint4*>(y + t) = make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void copy16(const uint4* __restrict__ a, uint4* __restrict__ b,
                       long long n) {
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i < n) b[i] = __ldg(a + i);
}

__device__ __forceinline__ uint32_t ldm_key(uint32_t m, int pbits,
                                            int column, uint32_t flip) {
    return ((((m * kC1) >> pbits) << pbits) | uint32_t(column)) ^ flip;
}

template <int S>  // samples a thread, a multiple of 4
__global__ void __launch_bounds__(kThreads)
k3_samples(const uint32_t* __restrict__ minz, uint32_t* __restrict__ out,
           int n, int stride, int spb, int span_blocks, int nspans,
           int pbits, uint32_t flip) {
    const int q = S * int(blockIdx.x * kThreads + threadIdx.x);
    if (q >= spb) return;
    const int r = int(blockIdx.z);
    const int half = span_blocks * spb;
    const int c = int(blockIdx.y) * spb + q;
    const bool last = r + 1 == nspans;
    const uint32_t* src = minz + size_t(r * span_blocks + int(blockIdx.y)) * n
                          + size_t(q) * stride;
    uint4* dst = reinterpret_cast<uint4*>(out + size_t(r) * (2 * half)
                                          + half + c);
    uint4* ctx = reinterpret_cast<uint4*>(
        out + size_t(last ? 0 : r + 1) * (2 * half) + c);
    uint32_t v[S];
#pragma unroll
    for (int e = 0; e < S; ++e) v[e] = __ldg(src + e * stride);
#pragma unroll
    for (int g = 0; g < S / 4; ++g) {
        uint32_t d[4], x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e;
            d[e] = ldm_key(v[i], pbits, half + c + i, flip);
            x[e] = ldm_key(last ? kEmpty : v[i], pbits, c + i, flip);
        }
        dst[g] = make_uint4(d[0], d[1], d[2], d[3]);
        ctx[g] = make_uint4(x[0], x[1], x[2], x[3]);
    }
}

// Each sample copied out once: K3's reads with half its writes.
__global__ void gather(const uint32_t* __restrict__ minz,
                       uint32_t* __restrict__ out, long long samples,
                       int stride) {
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i < samples) out[i] = __ldg(minz + i * stride);
}

}  // namespace

extern "C" {

// design 0, 1, 2: staged tiles of 1024, 2048, 4096 words; 3: the window
// with its claims behind branches; 4: copy16.
int qzd_k2(int design, const void* sk, void* out, int rows, int w,
           int pbits, int neighbors, int pmask, unsigned flip,
           void* stream) {
    if (w % 4 || neighbors > 4 || rows > 65535) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(sk);
    uint32_t* b = static_cast<uint32_t*>(out);
    const uint32_t pm = uint32_t(pmask);
    if (design == 0)
        k2_staged<1024><<<dim3((w + 1023) / 1024, rows), kThreads, 0, st>>>(
            a, b, w, pbits, neighbors, pm, flip);
    else if (design == 1)
        k2_staged<2048><<<dim3((w + 2047) / 2048, rows), kThreads, 0, st>>>(
            a, b, w, pbits, neighbors, pm, flip);
    else if (design == 2)
        k2_staged<4096><<<dim3((w + 4095) / 4096, rows), kThreads, 0, st>>>(
            a, b, w, pbits, neighbors, pm, flip);
    else if (design == 3)
        k2_window_branch<<<dim3((w + 4 * kThreads - 1) / (4 * kThreads),
                                rows), kThreads, 0, st>>>(
            a, b, w, pbits, neighbors, pm, flip);
    else if (design == 4) {
        const long long n = (long long)rows * w / 4;
        copy16<<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
            reinterpret_cast<const uint4*>(a), reinterpret_cast<uint4*>(b), n);
    } else {
        return cudaErrorInvalidValue;
    }
    return int(cudaGetLastError());
}

// design 0, 1: 4 and 8 samples a thread; 2: gather.
int qzd_k3(int design, const void* minz, void* out, int nspans, int n,
           int stride, int span_blocks, int pbits, unsigned flip,
           void* stream) {
    const int spb = n / stride;
    if (spb % 8 || nspans > 65535) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(minz);
    uint32_t* b = static_cast<uint32_t*>(out);
    const dim3 g4((spb + 4 * kThreads - 1) / (4 * kThreads), span_blocks,
                  nspans);
    const dim3 g8((spb + 8 * kThreads - 1) / (8 * kThreads), span_blocks,
                  nspans);
    if (design == 0)
        k3_samples<4><<<g4, kThreads, 0, st>>>(a, b, n, stride, spb,
                                               span_blocks, nspans, pbits,
                                               flip);
    else if (design == 1)
        k3_samples<8><<<g8, kThreads, 0, st>>>(a, b, n, stride, spb,
                                               span_blocks, nspans, pbits,
                                               flip);
    else if (design == 2) {
        const long long s = (long long)nspans * span_blocks * spb;
        gather<<<unsigned((s + kThreads - 1) / kThreads), kThreads, 0, st>>>(
            a, b, s, stride);
    } else {
        return cudaErrorInvalidValue;
    }
    return int(cudaGetLastError());
}

}  // extern "C"
