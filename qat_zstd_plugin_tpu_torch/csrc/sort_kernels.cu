// Hopper kernels of B19 bitonic_sort: a bitonic network over (key, pos)
// rows, carrying any number of int32 payloads.
//
// Replaces qat_zstd_plugin_tpu.ops.sort_kernel.bitonic_sort (Pallas), which
// holds one row in VMEM for the whole network. Its plain PyTorch twin,
// ops/sort_kernel.bitonic_sort_twin, runs the same network; the wrapper
// there checks shapes and dtypes, allocates the outputs and launches the
// entry point below through ctypes.
//
// The order is the reference's: key as unsigned, then pos as signed int32,
// ascending. Stage (k, j) pairs i with i ^ j; the lower element of a pair
// keeps the smaller (key, pos) where (i & k) == 0 and the larger otherwise,
// and a pair swaps only when it is strictly out of order. The network is not
// stable, so when a row holds equal (key, pos) pairs the payloads' order is
// the network's own, which a stable sort would not give. This kernel runs
// the same network on (key, pos, idx), idx the original column, and then
// gathers every payload by idx: the same permutation as the reference's for
// any number of payloads.
//
// A row of N = 2^m elements does not fit an SM for N > 16384 (12 bytes an
// element, 227 KB of shared memory), so the network runs in tiles of
// T = min(N, 8192) elements (96 KiB):
//   * local pass, one CTA per (row, tile): every stage with k <= T, in
//     shared memory;
//   * for each k > T: one global pass per j >= T, one thread per pair, in
//     device memory; then one merge pass per (row, tile) for the stages
//     j < T in shared memory.
// The direction bit (i & k) is taken from the global column i in both, so
// the tiles and the global passes run one network. Work: B * N / 2 *
// log2(N) * (log2(N) + 1) / 2 compare-exchanges, and the passes of k > T
// move the row's 12 bytes an element through device memory again.

#include "common.cuh"

namespace {

constexpr int kSortTile = 8192;    // elements of one shared-memory tile
constexpr int kSortThreads = 1024;
constexpr int kMaxPayloads = 8;    // payloads gathered by one launch

// (key as unsigned, pos as signed) as one unsigned 64-bit word.
__device__ __forceinline__ uint64_t order_word(uint32_t key, int32_t pos) {
    return (uint64_t(key) << 32) | (uint32_t(pos) ^ 0x80000000u);
}

// Stages (k, j), j from j_hi down to 1, on one tile held in shared memory;
// `base` is the tile's first column in its row.
__device__ __forceinline__ void tile_stages(uint64_t* word, int32_t* idx,
                                            int tile, int base, int k,
                                            int j_hi) {
    for (int j = j_hi; j >= 1; j >>= 1) {
        for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
            const int lo = (p / j) * 2 * j + (p % j);
            const int hi = lo + j;
            const bool descending = ((base + lo) & k) != 0;
            const uint64_t a = word[lo], b = word[hi];
            if (descending ? a < b : a > b) {
                word[lo] = b;
                word[hi] = a;
                const int32_t t = idx[lo];
                idx[lo] = idx[hi];
                idx[hi] = t;
            }
        }
        __syncthreads();
    }
}

// Local pass (first = true: read the inputs, every stage k <= tile) or the
// merge of stage k (first = false: read the outputs, stages j < tile).
__global__ void sort_tile_kernel(const uint32_t* __restrict__ key_in,
                                 const int32_t* __restrict__ pos_in,
                                 uint32_t* __restrict__ key_out,
                                 int32_t* __restrict__ pos_out,
                                 int32_t* __restrict__ idx_out, int n,
                                 int tile, int k_merge) {
    extern __shared__ uint64_t sort_smem[];
    uint64_t* word = sort_smem;
    int32_t* idx = reinterpret_cast<int32_t*>(sort_smem + tile);
    const int tiles = n / tile;
    const int base = (blockIdx.x % tiles) * tile;
    const size_t off = size_t(blockIdx.x / tiles) * n + base;
    const bool first = k_merge == 0;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        if (first) {
            word[e] = order_word(key_in[off + e], pos_in[off + e]);
            idx[e] = base + e;
        } else {
            word[e] = order_word(key_out[off + e], pos_out[off + e]);
            idx[e] = idx_out[off + e];
        }
    }
    __syncthreads();
    if (first) {
        for (int k = 2; k <= tile; k <<= 1) tile_stages(word, idx, tile, base,
                                                         k, k >> 1);
    } else {
        tile_stages(word, idx, tile, base, k_merge, tile >> 1);
    }
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        key_out[off + e] = uint32_t(word[e] >> 32);
        pos_out[off + e] = int32_t(uint32_t(word[e]) ^ 0x80000000u);
        idx_out[off + e] = idx[e];
    }
}

// Stage (k, j) with j >= the tile, in device memory: one thread per pair.
__global__ void sort_global_kernel(uint32_t* __restrict__ key,
                                   int32_t* __restrict__ pos,
                                   int32_t* __restrict__ idx, long long pairs,
                                   int n, int k, int j) {
    const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (p >= pairs) return;
    const int half = n / 2;
    const int q = int(p % half);
    const int lo = (q / j) * 2 * j + (q % j);
    const size_t row = size_t(p / half) * n;
    const size_t a_at = row + lo, b_at = a_at + j;
    const uint32_t ka = key[a_at], kb = key[b_at];
    const int32_t pa = pos[a_at], pb = pos[b_at];
    const uint64_t a = order_word(ka, pa), b = order_word(kb, pb);
    const bool descending = (lo & k) != 0;
    if (descending ? a < b : a > b) {
        key[a_at] = kb;
        key[b_at] = ka;
        pos[a_at] = pb;
        pos[b_at] = pa;
        const int32_t t = idx[a_at];
        idx[a_at] = idx[b_at];
        idx[b_at] = t;
    }
}

struct Payloads {
    const int32_t* src[kMaxPayloads];
    int32_t* dst[kMaxPayloads];
};

// dst[r][i] = src[r][idx[r][i]] for every payload of the launch.
__global__ void gather_payloads_kernel(const int32_t* __restrict__ idx,
                                       Payloads pl, int npay, long long total,
                                       int n) {
    const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (e >= total) return;
    const size_t from = size_t(e / n) * n + idx[e];
    for (int q = 0; q < npay; ++q) pl.dst[q][e] = pl.src[q][from];
}

}  // namespace

extern "C" {

int qz_bitonic_sort(const void* key, const void* pos, void* key_out,
                    void* pos_out, void* idx, const void* srcs,
                    const void* dsts, int npay, int rows, int n,
                    void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto ko = static_cast<uint32_t*>(key_out);
    const auto po = static_cast<int32_t*>(pos_out);
    const auto ix = static_cast<int32_t*>(idx);
    const int tile = n < kSortTile ? n : kSortTile;
    const size_t smem_bytes =
        size_t(tile) * (sizeof(uint64_t) + sizeof(int32_t));
    cudaError_t err = cudaFuncSetAttribute(
        sort_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes));
    if (err != cudaSuccess) return int(err);
    const unsigned ctas = unsigned((long long)rows * (n / tile));
    sort_tile_kernel<<<ctas, kSortThreads, smem_bytes, s>>>(
        static_cast<const uint32_t*>(key), static_cast<const int32_t*>(pos),
        ko, po, ix, n, tile, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    const long long pairs = (long long)rows * (n / 2);
    for (int k = 2 * tile; k <= n; k <<= 1) {
        for (int j = k >> 1; j >= tile; j >>= 1) {
            sort_global_kernel<<<blocks_for(pairs), kThreads, 0, s>>>(
                ko, po, ix, pairs, n, k, j);
            if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
        }
        sort_tile_kernel<<<ctas, kSortThreads, smem_bytes, s>>>(
            nullptr, nullptr, ko, po, ix, n, tile, k);
        if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
    const auto src = static_cast<const void* const*>(srcs);
    const auto dst = static_cast<void* const*>(dsts);
    const long long total = (long long)rows * n;
    for (int q0 = 0; q0 < npay; q0 += kMaxPayloads) {
        Payloads pl = {};
        const int m = npay - q0 < kMaxPayloads ? npay - q0 : kMaxPayloads;
        for (int q = 0; q < m; ++q) {
            pl.src[q] = static_cast<const int32_t*>(src[q0 + q]);
            pl.dst[q] = static_cast<int32_t*>(dst[q0 + q]);
        }
        gather_payloads_kernel<<<blocks_for(total), kThreads, 0, s>>>(
            ix, pl, m, total, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
    return int(cudaSuccess);
}

}  // extern "C"
