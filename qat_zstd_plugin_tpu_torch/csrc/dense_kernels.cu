// Hopper kernels of the level 2-4 device path (full-resolution dense hash
// claims).
//
// Four hand-written CUDA kernels replace the four Pallas kernels that
// qat_zstd_plugin_tpu.ops.glue_kernels.find_matches_positions(dense=True,
// sync=False) runs on the TPU beyond the level-1 ones. Each has a plain
// PyTorch twin in qat_zstd_plugin_tpu_torch/ops/glue_kernels.py that
// computes the same words; the wrappers there check shapes and dtypes,
// allocate the outputs and launch these entry points through ctypes.
//
// Interface: as in l1_kernels.cu, every entry point takes device
// pointers, sizes and the CUDA stream (PyTorch's current stream), launches
// on that stream, allocates nothing, and returns cudaGetLastError().
//
// All four are integer passes with a few operations per byte moved, so
// device-memory bandwidth bounds them on an H100 (3.35 TB/s).
// finalize_candidates is two launches: a pre-pass over the bytes and one
// tiled pass (common.cuh). The others are written simple and right first.

#include "common.cuh"

namespace {

constexpr int kMinMatch = 4;    // match_pipeline.MIN_MATCH
constexpr int kChainSteps = 2;  // glue_kernels.CHAIN_STEPS

// ---------------------------------------------------------------------------
// B5 hash_keys and B6 hash_keys_winmin: full-resolution sort keys (+ the
// windowed-minimum plane of the 8-gram hash).
// Replaces glue_kernels.hash_keys and glue_kernels.hash_keys_winmin
// (Pallas). The templated body, shared with B9 ldm_winmin, is
// hash_keys_kernel in common.cuh: kKeys for B5, kKeys and kMinz for B6.
// `flip` is XORed into every key written, so the signed row sort that
// follows on the main path needs no XOR pass of its own; minz is never
// flipped.
//
// Bound: device memory, n bytes read and 4n written per plane: B6 9n
// bytes a row (0.0225 ms at B=64 x 128 KiB at 3.35 TB/s), B5 5n
// (0.0125 ms). B6's design (common.cuh) is a warp per tile of 8 rows of
// 128 positions: whole-word loads, the grams from shuffled words and
// __byte_perm in registers, the windowed minimum by the van Herk/Gil-
// Werman split over segmented shuffle scans (the same work a position
// at every stride up to 128, no shared memory), one 16-byte store per
// plane a lane and row.
// ---------------------------------------------------------------------------
// B7 finalize_candidates: per-width chain doubling, cross-width merge, cost
// filter, offset-1 run scan.
// Replaces glue_kernels._finalize_chunk (Pallas), which the reference
// calls two widths at a time (a VMEM limit); here every width is one pass,
// which gives the same words because the filter and the run scan come
// after the last width either way.
//
// Bound: device memory, 4n bytes of keys a width, n bytes of blocks read
// and 8n bytes of mlen/moff written per row (25n at four widths: 0.063 ms
// for B=64 x 128 KiB at 3.35 TB/s).
//
// The first pass, CandidatesPass at position i: for each width it reads
// the claim offsets at i, i+w, ..., i+3w of the position-ordered keys (the
// block row is contiguous across its segments, and the chain runs across
// them, as the reference's whole-row shifts do), zeroes a claim whose gram
// passes the block's length, counts the leading claims equal to the one
// at i (what the reference's two doubling steps of the same-offset chain
// give), and merges the estimate (longer, then nearer); then the cost
// filter and the 16383 cap. It runs inside finalize_tile_kernel
// (common.cuh), which stages each width's keys for a tile of 2048
// positions plus a halo of 3 * 64 words (the chain's reach at the widest
// width the entry point takes) in shared memory with 16-byte loads, adds
// the offset-1 run scan and writes each plane once, one CTA per (tile,
// row). Neighbouring threads read neighbouring words: no bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kMaxWidth = 64;  // glue_kernels.finalize_candidates' widths

struct CandidatesPass {
    static constexpr int kArrays = 4;  // one key array a width
    static constexpr int kHalo = ((1 << kChainSteps) - 1) * kMaxWidth;
    static constexpr int kUnroll = 2;  // 16 key reads a position already
    const uint32_t* su[4];
    int width[4];
    int nw;
    int n;
    uint32_t omask;

    __device__ __forceinline__ int arrays() const { return nw; }
    __device__ __forceinline__ const uint32_t* keys(int a) const {
        return su[a];
    }
    __device__ __forceinline__ void operator()(const uint32_t* tile, int r,
                                               int i, int blen, int& ml_out,
                                               int& mo_out) const {
        constexpr int kPos = 1 << kChainSteps;
        constexpr int kSpan = kRunTile + kHalo;
        int ml = 0, mo = 0;
#pragma unroll
        for (int wi = 0; wi < kArrays; ++wi) {
            if (wi >= nw) break;
            const int w = width[wi];
            const uint32_t* t = tile + wi * kSpan + r;
            const int off = i + w <= blen ? int(t[0] & omask) : 0;
            // The reference's kChainSteps doubling steps of reach(j) +=
            // reach(j + s*width), where the claim at j continues the
            // chain, give at i the number of leading claims at i, i+w,
            // i+2w, ... equal to the claim at i (> 0), at most kPos.
            bool same = off > 0;
            int reach = same;
#pragma unroll
            for (int m = 1; m < kPos; ++m) {
                const int j = i + m * w;
                same &= (j < n) & (j + w <= blen) &
                        (int(t[m * w] & omask) == off);
                reach += same;
            }
            const int est = reach * w;
            const bool better =
                est > ml || (est == ml && off > 0 && (off < mo || mo == 0));
            if (off > 0 && better) {
                ml = est;
                mo = off;
            }
        }
        const bool worth = ml >= 7 || (ml >= 6 && mo <= 32768) ||
                           (ml >= 5 && mo <= 4096) || (ml >= 4 && mo <= 256);
        ml_out = worth ? min(ml, kRunCap) : 0;
        mo_out = worth ? mo : 0;
    }
};

// ---------------------------------------------------------------------------
// B8 compact_slots_dense: dense claims -> slot words, LDM take rule.
// Replaces glue_kernels.compact_slots_dense (Pallas).
//
// One thread per 4-byte slot s of a block: one 16-byte load each of mlen
// and moff at 4s..4s+3 (the reference makes four strided copies first),
// the smallest (k << 30 | moff) over the lanes with mlen >= MIN_MATCH, or
// the empty sentinel. On every (ns / spb)-th slot, when LDM estimates are
// given, the LDM offset takes the slot under merge_ldm's rule against the
// true lane-0 length: est > mlen[4s] and (mlen[4s] < local_cap or
// est >= 128). 32 bytes read and 4 written per slot.
// ---------------------------------------------------------------------------

__global__ void compact_slots_dense_kernel(const int32_t* __restrict__ mlen,
                                           const int32_t* __restrict__ moff,
                                           const int32_t* __restrict__ est,
                                           const int32_t* __restrict__ ldo,
                                           uint32_t* __restrict__ out,
                                           long long total, int ns, int spb,
                                           int local_cap) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int4 ml = reinterpret_cast<const int4*>(mlen)[idx];
    const int4 of = reinterpret_cast<const int4*>(moff)[idx];
    const int mls[4] = {ml.x, ml.y, ml.z, ml.w};
    const int ofs[4] = {of.x, of.y, of.z, of.w};
    uint32_t best = kEmpty;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (mls[k] >= kMinMatch)
            best = min(best, (uint32_t(k) << 30) | uint32_t(ofs[k]));
    }
    if (spb > 0) {
        const int sls = ns / spb;  // slots per LDM sample
        const int s = int(idx % ns);
        if (s % sls == 0) {
            const size_t t = size_t(idx / ns) * spb + s / sls;
            const int e = est[t];
            if (e > ml.x && (ml.x < local_cap || e >= 128))
                best = uint32_t(ldo[t]);
        }
    }
    out[idx] = best;
}

}  // namespace

extern "C" {

int qz_hash_keys(const void* blocks, void* keys, int rows, int n, int width,
                 int pbits, int pmask, unsigned flip, void* stream) {
    return launch_hash_keys<true, false>(blocks, keys, nullptr, nullptr,
                                         rows, n, width, pbits, pmask, 0,
                                         flip, stream);
}

int qz_hash_keys_winmin(const void* blocks, void* keys, void* minz,
                        void* scratch, int rows, int n, int width, int pbits,
                        int pmask, int stride, unsigned flip, void* stream) {
    return launch_hash_keys<true, true>(blocks, keys, minz, scratch, rows, n,
                                        width, pbits, pmask, stride, flip,
                                        stream);
}

int qz_finalize_candidates(const void* su0, const void* su1, const void* su2,
                           const void* su3, const void* blocks,
                           const void* lengths, void* mlen, void* moff,
                           void* scratch, int rows, int n, int nw, int w0,
                           int w1, int w2, int w3, int pbits,
                           size_t scratch_words, void* stream) {
    const CandidatesPass pass = {
        {static_cast<const uint32_t*>(su0), static_cast<const uint32_t*>(su1),
         static_cast<const uint32_t*>(su2), static_cast<const uint32_t*>(su3)},
        {w0, w1, w2, w3}, nw, n, (1u << pbits) - 1u};
    if (nw < 1 || nw > CandidatesPass::kArrays)
        return int(cudaErrorInvalidValue);
    for (int wi = 0; wi < nw; ++wi) {  // the halo holds the chain's reach
        if (pass.width[wi] < 1 || pass.width[wi] > kMaxWidth)
            return int(cudaErrorInvalidValue);
    }
    return finalize_tiles(pass, blocks, lengths, scratch, scratch_words,
                          mlen, moff, rows, n, stream);
}

int qz_compact_slots_dense(const void* mlen, const void* moff,
                           const void* est, const void* ldo, void* out,
                           int rows, int ns, int spb, int local_cap,
                           void* stream) {
    const long long total = (long long)rows * ns;
    compact_slots_dense_kernel<<<blocks_for(total), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(mlen), static_cast<const int32_t*>(moff),
        static_cast<const int32_t*>(est), static_cast<const int32_t*>(ldo),
        static_cast<uint32_t*>(out), total, ns, spb, local_cap);
    return int(cudaGetLastError());
}

}  // extern "C"
