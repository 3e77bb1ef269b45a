// Hopper kernels of the byte-verified hash matcher (levels 1-4 with hybrid
// device entropy).
//
// Three hand-written CUDA kernels replace the three Pallas kernels that
// qat_zstd_plugin_tpu.ops.glue_kernels.candidates_hash_verified runs on the
// TPU around its two row sorts. Each has a plain PyTorch twin in
// qat_zstd_plugin_tpu_torch/ops/glue_kernels.py that computes the same
// words; the wrappers there check shapes and dtypes, allocate the outputs
// and launch these entry points through ctypes.
//
// Interface: as in l1_kernels.cu, every entry point takes device
// pointers, sizes and the CUDA stream (PyTorch's current stream), launches
// on that stream, allocates nothing, and returns cudaGetLastError().
//
// All three are integer passes with a few operations per byte moved, so
// device-memory bandwidth bounds them on an H100 (3.35 TB/s).
// finalize_verified is two launches: a pre-pass over the bytes and one
// tiled pass that fuses the chain with the offset-1 run scan (common.cuh).

#include "common.cuh"

namespace {

constexpr int kVerifiedSteps = 3;  // glue_kernels.VERIFIED_CHAIN_STEPS
constexpr int kNearOff = 32768;    // glue_kernels.VERIFIED_NEAR_OFF
constexpr int kFarMin = 4;         // glue_kernels.VERIFIED_FAR_MIN

// ---------------------------------------------------------------------------
// B11 gram_pos_planes: big-endian 4-byte grams and segment positions.
// Replaces glue_kernels.gram_pos_planes (Pallas).
//
// One thread per 4 consecutive positions i..i+3 of a row (n % 4 == 0, so
// they share the row): two aligned 4-byte loads give bytes i..i+7 (the
// second is 0 at the row's last quad: the reference's shifted reads fill
// 0 past the row's end, and a gram reads along the whole row, so the last
// three grams of a segment read the next segment's bytes), __byte_perm
// assembles the four big-endian grams, and one 16-byte store each writes
// the grams and the positions (i + k) & (w - 1). The (rows * nseg, w)
// outputs are the (rows, n) row-major layout. Bound: n bytes read, 8n
// written per row.
// ---------------------------------------------------------------------------

__global__ void gram_pos_planes_kernel(const uint8_t* __restrict__ blocks,
                                       uint32_t* __restrict__ grams,
                                       uint32_t* __restrict__ pos,
                                       long long quads, int n,
                                       uint32_t pmask) {
    const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (q >= quads) return;
    const long long e = 4 * q;  // element (row, i) at row * n + i
    const int i = int(e % n);
    const uint32_t a = *reinterpret_cast<const uint32_t*>(blocks + e);
    const uint32_t b = i + 4 < n
        ? *reinterpret_cast<const uint32_t*>(blocks + e + 4) : 0u;
    uint4 g;
    g.x = __byte_perm(a, b, 0x0123);  // bytes i, i+1, i+2, i+3
    g.y = __byte_perm(a, b, 0x1234);
    g.z = __byte_perm(a, b, 0x2345);
    g.w = __byte_perm(a, b, 0x3456);
    reinterpret_cast<uint4*>(grams)[q] = g;
    reinterpret_cast<uint4*>(pos)[q] = make_uint4(
        uint32_t(i) & pmask, uint32_t(i + 1) & pmask, uint32_t(i + 2) & pmask,
        uint32_t(i + 3) & pmask);
}

// ---------------------------------------------------------------------------
// B12 neighbor_verify_keys: verified offsets -> un-sort keys.
// Replaces glue_kernels.neighbor_verify_keys (Pallas).
//
// One thread per element of the (gram, pos)-sorted rows: for k = 1 ..
// neighbors, nearest first, the first earlier entry of the row with an
// equal gram (equal grams sit together, in position order) claims
// off = pos - prev; the output (pos << (32 - pbits) | off) drops the gram,
// so a row sort restores position order. Unlike the reference, a
// neighbour that does not exist (j < k) claims nothing: the reference
// reads it as gram 0xFFFFFFFF at position 0 and so claims a false match to
// position 0 when a segment holds exactly one gram below 0xFFFFFFFF.
// Elementwise with `neighbors` L1-hit neighbour reads: 16 bytes moved per
// element.
// ---------------------------------------------------------------------------

__global__ void neighbor_verify_keys_kernel(const uint32_t* __restrict__ sg,
                                            const uint32_t* __restrict__ sp,
                                            uint32_t* __restrict__ out,
                                            long long total, int w,
                                            int pbits, int neighbors) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = int(idx % w);
    const uint32_t g = sg[idx];
    const uint32_t p = sp[idx];
    uint32_t off = 0;
    for (int k = 1; k <= neighbors && k <= j; ++k) {
        const uint32_t pp = sp[idx - k];
        if (off == 0 && sg[idx - k] == g && pp < p) off = p - pp;
    }
    out[idx] = (p << (32 - pbits)) | off;
}

// ---------------------------------------------------------------------------
// B13 finalize_verified: verified claims -> exact (mlen, moff).
// Replaces glue_kernels.finalize_verified (Pallas).
//
// Bound: device memory, 4n bytes of keys and n of bytes read, 8n written
// per row (13n: 0.033 ms for B=64 x 128 KiB at 3.35 TB/s).
//
// The first pass, VerifiedPass at position i: it reads the claim offsets
// at i, i+4, ..., i+28 of the position-ordered keys (the block row is
// contiguous across its segments and the chain runs across them, as the
// reference's whole-row shifts do), zeroes a claim whose gram passes the
// block's length (i + 4 > len, before the chain), counts the leading
// claims equal to the one at i (what the reference's three doubling steps
// of the same-offset chain give: a length in 4-byte units, at most 32
// bytes), then the worth filter and the 16383 cap. It runs inside finalize_tile_kernel (common.cuh, shared with B7),
// which stages the keys of a tile of 2048 positions plus a halo of 28
// words in shared memory with 16-byte loads, adds the offset-1 run scan
// and writes each plane once, one CTA per (tile, row).
// ---------------------------------------------------------------------------

struct VerifiedPass {
    static constexpr int kArrays = 1;
    static constexpr int kHalo = 4 * ((1 << kVerifiedSteps) - 1);
    static constexpr int kUnroll = kRunPer;  // all of a thread's positions
    const uint32_t* su;
    int n;
    uint32_t omask;

    __device__ __forceinline__ int arrays() const { return 1; }
    __device__ __forceinline__ const uint32_t* keys(int) const { return su; }
    __device__ __forceinline__ void operator()(const uint32_t* tile, int r,
                                               int i, int blen, int& ml_out,
                                               int& mo_out) const {
        constexpr int kPos = 1 << kVerifiedSteps;
        const int off = i + 4 <= blen ? int(tile[r] & omask) : 0;
        // The reference's three doubling steps of reach(j) += reach(j +
        // 4s), where the claim at j continues the chain, give at i the
        // number of leading claims at i, i+4, ..., i+28 equal to the
        // claim at i (> 0).
        bool same = off > 0;
        int reach = same;
#pragma unroll
        for (int m = 1; m < kPos; ++m) {
            const int j = i + 4 * m;
            same &= (j < n) & (j + 4 <= blen) &
                    (int(tile[r + 4 * m] & omask) == off);
            reach += same;
        }
        const int ml = reach * 4;
        const bool worth = ml >= kFarMin || (ml >= 4 && off <= kNearOff);
        ml_out = worth ? min(ml, kRunCap) : 0;
        mo_out = worth ? off : 0;
    }
};

}  // namespace

extern "C" {

int qz_gram_pos_planes(const void* blocks, void* grams, void* pos, int rows,
                       int n, int pmask, void* stream) {
    const long long quads = (long long)rows * n / 4;
    gram_pos_planes_kernel<<<blocks_for(quads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<uint32_t*>(grams),
        static_cast<uint32_t*>(pos), quads, n, uint32_t(pmask));
    return int(cudaGetLastError());
}

int qz_neighbor_verify_keys(const void* sg, const void* sp, void* out,
                            int rows, int w, int pbits, int neighbors,
                            void* stream) {
    const long long total = (long long)rows * w;
    neighbor_verify_keys_kernel<<<blocks_for(total), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sg), static_cast<const uint32_t*>(sp),
        static_cast<uint32_t*>(out), total, w, pbits, neighbors);
    return int(cudaGetLastError());
}

int qz_finalize_verified(const void* su, const void* blocks,
                         const void* lengths, void* mlen, void* moff,
                         void* scratch, int rows, int n, int pbits,
                         size_t scratch_words, void* stream) {
    const VerifiedPass pass = {static_cast<const uint32_t*>(su), n,
                               (1u << pbits) - 1u};
    return finalize_tiles(pass, blocks, lengths, scratch, scratch_words,
                          mlen, moff, rows, n, stream);
}

}  // extern "C"
