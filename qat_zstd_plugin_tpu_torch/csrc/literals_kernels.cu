// Hopper kernels of the device Huffman literals (full device entropy, every
// level).
//
// B15 literal_keys replaces the Pallas kernel
// qat_zstd_plugin_tpu.ops.literals_kernel.literal_keys and B16 byte_hist
// the Pallas kernel literals_kernel.byte_hist. Their plain PyTorch twins
// are literal_keys_twin and byte_hist_twin in
// qat_zstd_plugin_tpu_torch/ops/literals_kernel.py; the wrappers beside
// them check shapes and dtypes, allocate the outputs and scratch, and
// launch these entry points through ctypes.
//
// Interface: as in l1_kernels.cu, every entry point takes device
// pointers, sizes and the CUDA stream (PyTorch's current stream), launches
// on that stream, allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B15 literal_keys: (B, n) u32 keys, (pos << 8 | byte) at literal
// positions and 0xFFFFFFFF elsewhere.
//
// A position i < length is a literal unless a chosen match at or before it
// ends after it: covered(i) = max over j <= i of (chosen[j] ? j + mlen[j]
// : 0) > i, an inclusive per-row prefix maximum. The reference takes the
// maximum by 14 doubling steps of whole-row shifts, which sees only the
// last 16384 positions; that bounds every match of the hash path (runs
// capped at 16383) but not the content path's offset-1 runs (up to
// 65535), whose positions from start + 16384 on it marks as literals.
// Here the maximum runs over the whole row, as the twin's torch.cummax.
//
// Layout: tiles of kLitTile = 2048 positions, 8 consecutive positions a
// thread (one 8-byte load of the chosen flags and the bytes, two 16-byte
// loads of the lengths, two 16-byte stores of the keys). Pass 1 writes
// each tile's maximum end to a (B, ntiles) scratch plane; pass 2 takes, in
// each tile, the maximum of the tiles before it as the carry, scans its 8
// positions in registers, the 256 threads' maxima by warp shuffles and one
// shared-memory step, and writes the keys. Bound: per position 1 byte of
// blocks, 1 of chosen and 4 of mlen read and 4 written; pass 1 reads
// chosen and mlen a second time (the 5 bytes the bound does not count).
// ---------------------------------------------------------------------------

constexpr int kLitThreads = 256;
constexpr int kLitPer = 8;                          // positions per thread
constexpr int kLitTile = kLitThreads * kLitPer;     // 2048
constexpr int kWarps = kLitThreads / 32;

// The ends (chosen ? p + mlen : 0) of positions p..p+7 of a row; p % 8 == 0
// and p < n, with n % 8 == 0, so all eight are in the row.
__device__ __forceinline__ void load_ends(const uint8_t* chosen,
                                          const int32_t* mlen, int p,
                                          int (&ends)[kLitPer]) {
    const uint2 c = *reinterpret_cast<const uint2*>(chosen + p);
    const int4 m0 = *reinterpret_cast<const int4*>(mlen + p);
    const int4 m1 = *reinterpret_cast<const int4*>(mlen + p + 4);
    const int m[kLitPer] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int k = 0; k < kLitPer; ++k) {
        const uint32_t word = k < 4 ? c.x : c.y;
        const bool ch = (word >> (8 * (k & 3))) & 0xFFu;
        ends[k] = ch ? p + k + m[k] : 0;
    }
}

// Maximum of v over the CTA; every thread gets it. `red` holds kWarps ints.
__device__ __forceinline__ int block_max(int v, int* red) {
    for (int s = 16; s > 0; s >>= 1)
        v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, s));
    __syncthreads();  // red may still be read from an earlier call
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int out = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) out = max(out, red[w]);
    return out;
}

__global__ void __launch_bounds__(kLitThreads)
literal_tile_max_kernel(const uint8_t* __restrict__ chosen,
                        const int32_t* __restrict__ mlen,
                        int32_t* __restrict__ tile_max, int n, int ntiles) {
    __shared__ int red[kWarps];
    const int row = blockIdx.y;
    const int p = blockIdx.x * kLitTile + kLitPer * threadIdx.x;
    int best = 0;
    if (p < n) {
        int ends[kLitPer];
        load_ends(chosen + size_t(row) * n, mlen + size_t(row) * n, p, ends);
#pragma unroll
        for (int k = 0; k < kLitPer; ++k) best = max(best, ends[k]);
    }
    best = block_max(best, red);
    if (threadIdx.x == 0) tile_max[size_t(row) * ntiles + blockIdx.x] = best;
}

__global__ void __launch_bounds__(kLitThreads)
literal_keys_kernel(const uint8_t* __restrict__ blocks,
                    const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ chosen,
                    const int32_t* __restrict__ mlen,
                    const int32_t* __restrict__ tile_max,
                    uint32_t* __restrict__ keys, int n, int ntiles) {
    __shared__ int red[kWarps];
    __shared__ int warp_max[kWarps];
    const int row = blockIdx.y;
    const int tile = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // The carry: the largest end of any chosen match in the earlier tiles.
    int carry = 0;
    for (int t = threadIdx.x; t < tile; t += kLitThreads)
        carry = max(carry, tile_max[size_t(row) * ntiles + t]);
    carry = block_max(carry, red);

    const int p = tile * kLitTile + kLitPer * threadIdx.x;
    const bool in_row = p < n;
    int run[kLitPer];
    if (in_row) {
        load_ends(chosen + size_t(row) * n, mlen + size_t(row) * n, p, run);
#pragma unroll
        for (int k = 1; k < kLitPer; ++k) run[k] = max(run[k], run[k - 1]);
    } else {
#pragma unroll
        for (int k = 0; k < kLitPer; ++k) run[k] = 0;
    }

    // Exclusive prefix maximum of the threads' last entries.
    int incl = run[kLitPer - 1];
    for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, s);
        if (lane >= s) incl = max(incl, v);
    }
    if (lane == 31) warp_max[warp] = incl;
    int excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    if (lane == 0) excl = 0;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = max(excl, warp_max[w]);
    if (!in_row) return;
    const int before = max(carry, excl);

    const int blen = lengths[row];
    const uint2 x = *reinterpret_cast<const uint2*>(blocks + size_t(row) * n
                                                    + p);
    uint32_t out[kLitPer];
#pragma unroll
    for (int k = 0; k < kLitPer; ++k) {
        const int i = p + k;
        const bool covered = max(before, run[k]) > i;
        const uint32_t byte = ((k < 4 ? x.x : x.y) >> (8 * (k & 3))) & 0xFFu;
        out[k] = !covered && i < blen ? (uint32_t(i) << 8) | byte : kEmpty;
    }
    uint4* dst = reinterpret_cast<uint4*>(keys + size_t(row) * n + p);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// ---------------------------------------------------------------------------
// B16 byte_hist: (B, n) u32 literal keys -> (B, 256) int32 histogram of
// key & 0xFF over the keys that are not 0xFFFFFFFF.
//
// The TPU kernel builds a (rows, 512, 256) one-hot per chunk and sums it;
// here each CTA takes kHistChunk keys of one row (16-byte loads), counts
// them into a 256-bin histogram per warp in shared memory with integer
// atomics (a per-warp copy cuts the collisions of skewed text, where a few
// bytes take most literals), then adds the summed bins into the row's
// histogram in device memory with one atomic per non-empty bin. The
// entry point zeroes the histogram on the stream first. Integer adds
// commute, so the result does not depend on the order. Bound: 4 bytes
// read per key.
// ---------------------------------------------------------------------------

constexpr int kHistThreads = 256;
constexpr int kHistChunk = 16384;  // keys per CTA

__global__ void __launch_bounds__(kHistThreads)
byte_hist_kernel(const uint32_t* __restrict__ keys, int32_t* __restrict__ hist,
                 int n) {
    __shared__ int bins[kHistThreads / 32][256];
    const int row = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    for (int j = threadIdx.x; j < (kHistThreads / 32) * 256;
         j += kHistThreads)
        (&bins[0][0])[j] = 0;
    __syncthreads();
    const uint32_t* x = keys + size_t(row) * n;
    const int lo = blockIdx.x * kHistChunk;
    const int hi = min(n, lo + kHistChunk);
    for (int i = lo + 4 * threadIdx.x; i < hi; i += 4 * kHistThreads) {
        const uint4 k = *reinterpret_cast<const uint4*>(x + i);
        const uint32_t v[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (v[q] != kEmpty) atomicAdd(&bins[warp][v[q] & 0xFFu], 1);
    }
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kHistThreads / 32; ++w) sum += bins[w][threadIdx.x];
    if (sum) atomicAdd(&hist[size_t(row) * 256 + threadIdx.x], sum);
}

}  // namespace

extern "C" {

int qz_literal_keys(const void* blocks, const void* lengths,
                    const void* chosen, const void* mlen, void* tile_max,
                    void* keys, int rows, int n, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    const int ntiles = (n + kLitTile - 1) / kLitTile;
    const dim3 grid(ntiles, rows);
    literal_tile_max_kernel<<<grid, kLitThreads, 0, s>>>(
        static_cast<const uint8_t*>(chosen),
        static_cast<const int32_t*>(mlen), static_cast<int32_t*>(tile_max), n,
        ntiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    literal_keys_kernel<<<grid, kLitThreads, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths),
        static_cast<const uint8_t*>(chosen),
        static_cast<const int32_t*>(mlen),
        static_cast<const int32_t*>(tile_max), static_cast<uint32_t*>(keys),
        n, ntiles);
    return int(cudaGetLastError());
}

int qz_byte_hist(const void* keys, void* hist, int rows, int n,
                 void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(hist, 0, size_t(rows) * 256 * 4, s);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((n + kHistChunk - 1) / kHistChunk, rows);
    byte_hist_kernel<<<grid, kHistThreads, 0, s>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(hist), n);
    return int(cudaGetLastError());
}

}  // extern "C"
