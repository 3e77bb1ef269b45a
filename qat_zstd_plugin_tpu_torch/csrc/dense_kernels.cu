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
// tiled pass (common.cuh); B8 takes four slots a thread.

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
// Slot s of a row holds the smallest (k << 30 | moff[4s+k]) over the
// lanes k with mlen[4s+k] >= MIN_MATCH, or the empty sentinel. When LDM
// estimates are given (spb > 0), each sample slot (every sls = ns/spb-th)
// takes the LDM offset under merge_ldm's rule against the true lane-0
// length: est > mlen[4s] and (mlen[4s] < local_cap or est >= 128).
//
// Bound: device memory, 8 bytes read and 1 written a position (0.0225 ms
// at B=64 x 128 KiB at 3.35 TB/s). Grid (chunks, rows), rows in groups of
// kMaxGridY, 32-bit in-row indices: no 64-bit division or modulo. A
// thread takes kSlotsPer consecutive slots (16 positions at 4): it issues
// all of its 16-byte loads of mlen and moff (128 bytes) before it uses
// any, through the streaming cache hint (both planes are dead after B8),
// and writes its words with one store (16 bytes at 4 slots). The level
// paths' ldm_stride is 32 * 2^k, so sls = stride / 4 is a power of two
// of at least 8: the entry point passes its log2 when sls is a power of
// two no smaller than kSlotsPer, and then only a thread's first slot can
// be a sample, found by a mask and indexed by a shift, its lane-0 length
// already in registers. Any other sls (no level's) takes a 32-bit % and /
// a slot. A row count ns that kSlotsPer does not divide (ns = 1025 at N
// = 4100) takes the guarded path (kVec false): the same loads where in
// the row, one 4-byte store a slot.
// ---------------------------------------------------------------------------

constexpr int kSlotsPer = 2;          // slots a thread
constexpr bool kSlotsStream = true;   // __ldcs on mlen and moff
constexpr int kSlotThreads = 256;
constexpr int kSlotChunk = kSlotThreads * kSlotsPer;

__device__ __forceinline__ int4 load_claims(const int4* p) {
    if constexpr (kSlotsStream) return __ldcs(p);
    return __ldg(p);
}

// v: the slot word; m0: its lane-0 length; e, lo: the sample's estimate
// and LDM offset.
__device__ __forceinline__ uint32_t take_ldm(uint32_t v, int m0, int e,
                                             int lo, int local_cap) {
    return e > m0 && (m0 < local_cap || e >= 128) ? uint32_t(lo) : v;
}

template <bool kVec>  // kVec: kSlotsPer divides ns
__global__ void __launch_bounds__(kSlotThreads)
compact_slots_dense_kernel(const int4* __restrict__ mlen,
                           const int4* __restrict__ moff,
                           const int32_t* __restrict__ est,
                           const int32_t* __restrict__ ldo,
                           uint32_t* __restrict__ out, int ns, int spb,
                           int sls, int sls_log2, int local_cap, int r0) {
    const int row = r0 + int(blockIdx.y);
    const int s0 = (int(blockIdx.x) * kSlotThreads + int(threadIdx.x)) *
                   kSlotsPer;
    if (s0 >= ns) return;
    const size_t base = size_t(row) * ns;  // a slot is one int4 of a plane
    int4 ml[kSlotsPer], mo[kSlotsPer];
#pragma unroll
    for (int k = 0; k < kSlotsPer; ++k) {
        if (kVec || s0 + k < ns) {
            ml[k] = load_claims(mlen + base + s0 + k);
            mo[k] = load_claims(moff + base + s0 + k);
        } else {
            ml[k] = mo[k] = make_int4(0, 0, 0, 0);
        }
    }
    // The sample of the shift path, loaded beside the claims.
    const bool sample = spb > 0 && sls_log2 >= 0 && (s0 & (sls - 1)) == 0;
    int e = 0, lo = 0;
    if (sample) {
        const size_t t = size_t(row) * spb + (s0 >> sls_log2);
        e = __ldg(est + t);
        lo = __ldg(ldo + t);
    }
    uint32_t best[kSlotsPer];
#pragma unroll
    for (int k = 0; k < kSlotsPer; ++k) {
        const int m[4] = {ml[k].x, ml[k].y, ml[k].z, ml[k].w};
        const int o[4] = {mo[k].x, mo[k].y, mo[k].z, mo[k].w};
        uint32_t b = kEmpty;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (m[j] >= kMinMatch)
                b = min(b, (uint32_t(j) << 30) | uint32_t(o[j]));
        }
        best[k] = b;
    }
    if (sample) best[0] = take_ldm(best[0], ml[0].x, e, lo, local_cap);
    if (spb > 0 && sls_log2 < 0) {
#pragma unroll
        for (int k = 0; k < kSlotsPer; ++k) {
            const int s = s0 + k;
            if ((kVec || s < ns) && s % sls == 0) {
                const size_t t = size_t(row) * spb + s / sls;
                best[k] = take_ldm(best[k], ml[k].x, __ldg(est + t),
                                   __ldg(ldo + t), local_cap);
            }
        }
    }
    uint32_t* dst = out + base + s0;
    if constexpr (kVec && kSlotsPer == 1) {
        dst[0] = best[0];
    } else if constexpr (kVec && kSlotsPer == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(best[0], best[1]);
    } else if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < kSlotsPer; k += 4)
            *reinterpret_cast<uint4*>(dst + k) =
                make_uint4(best[k], best[k + 1], best[k + 2], best[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < kSlotsPer; ++k)
            if (s0 + k < ns) dst[k] = best[k];
    }
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
    if (rows <= 0 || ns <= 0) return int(cudaSuccess);
    const int sls = spb > 0 ? ns / spb : 0;
    int sls_log2 = -1;  // the shift path: a power of two >= kSlotsPer
    if (sls >= kSlotsPer && (sls & (sls - 1)) == 0)
        sls_log2 = __builtin_ctz(unsigned(sls));
    const unsigned chunks = unsigned((ns + kSlotChunk - 1) / kSlotChunk);
    auto s = static_cast<cudaStream_t>(stream);
    for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
        const dim3 grid(chunks, unsigned(min(rows - r0, kMaxGridY)));
        auto kernel = ns % kSlotsPer ? compact_slots_dense_kernel<false>
                                     : compact_slots_dense_kernel<true>;
        kernel<<<grid, kSlotThreads, 0, s>>>(
            static_cast<const int4*>(mlen), static_cast<const int4*>(moff),
            static_cast<const int32_t*>(est),
            static_cast<const int32_t*>(ldo), static_cast<uint32_t*>(out),
            ns, spb, sls, sls_log2, local_cap, r0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return int(err);
    }
    return int(cudaSuccess);
}

}  // extern "C"
