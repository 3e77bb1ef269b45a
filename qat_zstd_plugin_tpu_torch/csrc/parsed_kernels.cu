// Hopper kernels of the parsed hash path: B17 compact_slots and B18
// compact_operands.
//
// Two hand-written CUDA kernels replace the two Pallas kernels that turn a
// device parse into its outputs in qat_zstd_plugin_tpu.ops.glue_kernels:
// compact_slots (the slot words of find_matches_positions(dense=False)) and
// compact_operands (the sort operands of compact_fast_glue). Each has a
// plain PyTorch twin in qat_zstd_plugin_tpu_torch/ops/glue_kernels.py that
// computes the same words; the wrappers there check shapes and dtypes,
// allocate the outputs and launch these entry points through ctypes.
//
// Interface: as in l1_kernels.cu, every entry point takes device pointers,
// sizes and the CUDA stream (PyTorch's current stream), launches on that
// stream, allocates nothing, and returns cudaGetLastError(). `chosen` is
// either bool (one byte a position, B10's output) or int32 (`ch_bytes` 1 or
// 4); a position is chosen where it is not 0.
//
// Both are elementwise passes with a handful of integer operations per
// position, so device-memory bandwidth bounds them on an H100 (3.35 TB/s):
// each thread takes four consecutive positions with one 4- or 16-byte load
// per input and 16-byte stores, neighbouring threads on neighbouring
// addresses.

#include "common.cuh"

namespace {

template <typename T>
struct Lanes;  // the four `chosen` lanes of one aligned slot, in one load

template <>
struct Lanes<uint8_t> {
    __device__ __forceinline__ static void load(const void* p, long long s,
                                                bool ch[4]) {
        const uchar4 v = static_cast<const uchar4*>(p)[s];
        ch[0] = v.x != 0;
        ch[1] = v.y != 0;
        ch[2] = v.z != 0;
        ch[3] = v.w != 0;
    }
};

template <>
struct Lanes<int32_t> {
    __device__ __forceinline__ static void load(const void* p, long long s,
                                                bool ch[4]) {
        const int4 v = static_cast<const int4*>(p)[s];
        ch[0] = v.x != 0;
        ch[1] = v.y != 0;
        ch[2] = v.z != 0;
        ch[3] = v.w != 0;
    }
};

// ---------------------------------------------------------------------------
// B17 compact_slots: parse-chosen claims -> slot words.
// Replaces glue_kernels.compact_slots (Pallas), which takes four strided
// copies of each input and a sign-flipped int32 minimum over them (Mosaic
// has no unsigned reduction). Here one thread per 4-byte slot s reads
// chosen[4s..4s+3] and moff[4s..4s+3] in one load each and keeps the
// unsigned minimum of (k << 30 | moff[4s+k]) over the chosen lanes, else the
// empty sentinel 0xFFFFFFFF. The minimum picks the smallest chosen k: the
// parse spaces its claims >= 4 apart, so a parsed slot holds one claim, but
// a dense mask (mlen >= MIN_MATCH) can hold four, and the reference's
// minimum then keeps the first. The flat slot index is the row-major index
// of the (rows * nseg, w / 4) output, as the segments tile the block.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void compact_slots_kernel(const void* __restrict__ chosen,
                                     const int32_t* __restrict__ moff,
                                     uint32_t* __restrict__ out,
                                     long long total) {
    const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (s >= total) return;
    bool ch[4];
    Lanes<T>::load(chosen, s, ch);
    const int4 of = reinterpret_cast<const int4*>(moff)[s];
    const uint32_t ofs[4] = {uint32_t(of.x), uint32_t(of.y), uint32_t(of.z),
                             uint32_t(of.w)};
    uint32_t best = kEmpty;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (ch[k]) best = min(best, (uint32_t(k) << 30) | ofs[k]);
    }
    out[s] = best;
}

// ---------------------------------------------------------------------------
// B18 compact_operands: the two sort operands of the segmented compaction.
// Replaces glue_kernels.compact_operands (Pallas). Position i of a row has
// local position gp = i & (w - 1) and poskey = gp if chosen, else w + gp;
// the operands are (poskey << 16 | mlen[i]) and (poskey << 16 | moff[i]) as
// u32, the payload ORed in unmasked as the reference does. The (rows, n)
// row-major order is the (rows * nseg, w) one, so thread t writes
// positions 4t..4t+3 of both with two 16-byte stores.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void compact_operands_kernel(const void* __restrict__ chosen,
                                        const int32_t* __restrict__ mlen,
                                        const int32_t* __restrict__ moff,
                                        uint32_t* __restrict__ op_a,
                                        uint32_t* __restrict__ op_b,
                                        long long total, int n, uint32_t w) {
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (t >= total) return;
    bool ch[4];
    Lanes<T>::load(chosen, t, ch);
    const int4 ml = reinterpret_cast<const int4*>(mlen)[t];
    const int4 of = reinterpret_cast<const int4*>(moff)[t];
    const uint32_t mls[4] = {uint32_t(ml.x), uint32_t(ml.y), uint32_t(ml.z),
                             uint32_t(ml.w)};
    const uint32_t ofs[4] = {uint32_t(of.x), uint32_t(of.y), uint32_t(of.z),
                             uint32_t(of.w)};
    const uint32_t i0 = uint32_t((4 * t) % n);
    uint32_t a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t gp = (i0 + k) & (w - 1);
        const uint32_t poskey = (ch[k] ? gp : gp + w) << 16;
        a[k] = poskey | mls[k];
        b[k] = poskey | ofs[k];
    }
    reinterpret_cast<uint4*>(op_a)[t] = make_uint4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<uint4*>(op_b)[t] = make_uint4(b[0], b[1], b[2], b[3]);
}

}  // namespace

extern "C" {

int qz_compact_slots(const void* chosen, const void* moff, void* out,
                     int rows, int n, int ch_bytes, void* stream) {
    const long long total = (long long)rows * (n / 4);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto of = static_cast<const int32_t*>(moff);
    const auto o = static_cast<uint32_t*>(out);
    if (ch_bytes == 1)
        compact_slots_kernel<uint8_t><<<blocks_for(total), kThreads, 0, s>>>(
            chosen, of, o, total);
    else
        compact_slots_kernel<int32_t><<<blocks_for(total), kThreads, 0, s>>>(
            chosen, of, o, total);
    return int(cudaGetLastError());
}

int qz_compact_operands(const void* chosen, const void* mlen, const void* moff,
                        void* op_a, void* op_b, int rows, int n, int w,
                        int ch_bytes, void* stream) {
    const long long total = (long long)rows * (n / 4);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto ml = static_cast<const int32_t*>(mlen);
    const auto of = static_cast<const int32_t*>(moff);
    const auto a = static_cast<uint32_t*>(op_a);
    const auto b = static_cast<uint32_t*>(op_b);
    const unsigned grid = blocks_for(total);
    if (ch_bytes == 1)
        compact_operands_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
            chosen, ml, of, a, b, total, n, uint32_t(w));
    else
        compact_operands_kernel<int32_t><<<grid, kThreads, 0, s>>>(
            chosen, ml, of, a, b, total, n, uint32_t(w));
    return int(cudaGetLastError());
}

}  // extern "C"
