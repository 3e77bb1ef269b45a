// Hopper kernels of the level-1 device path (the syncmer slot pipeline).
//
// Four hand-written CUDA kernels replace the four Pallas kernels that
// qat_zstd_plugin_tpu.ops.glue_kernels.find_matches_positions(sync=True)
// runs on the TPU. Each has a plain PyTorch twin in
// qat_zstd_plugin_tpu_torch/ops/glue_kernels.py that computes the same
// words; the wrappers there check shapes and dtypes, allocate the outputs
// and launch these entry points through ctypes.
//
// Interface: every entry point takes device pointers, sizes and the CUDA
// stream (PyTorch's current stream), launches on that stream, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported at once. All sort keys and slot words are u32 bit patterns; the
// PyTorch side holds them in int32 tensors.
//
// All four are integer passes with a few operations per byte moved, so
// device-memory bandwidth bounds them on an H100 (3.35 TB/s). They are
// written simple and right first: one thread per output element, loads
// and stores coalesced along the row.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: pair-syncmer anchor keys + windowed-minimum plane.
// Replaces glue_kernels.hash_keys_winmin_sync (Pallas).
//
// One thread per byte pair (positions i, i+1 with i even). A CTA covers
// kK1Span positions of one row: it stages the bytes of the tile plus a
// halo in shared memory, hashes every 8-byte gram of the tile plus the
// window halo once into shared memory (entries past the row's end hold the
// 0xFFFFFFFF fill of the reference's shifted reads), then each thread
//   * takes the parity of the argmin of (h8 & ~1 | lane parity) over the
//     4-wide window [i, i+4) and writes the key of the chosen pair member,
//     (hash_w(sel) << pbits | sel & pmask), for the even lane only: the
//     Pallas kernel writes full width and drops odd lanes afterwards
//     because Mosaic cannot decimate lanes;
//   * writes minz[i], minz[i+1]: the minimum h8 over [i, i+stride).
// Bound: reads N bytes and writes 2N (keys) + 4N (minz) bytes per row;
// the 8-gram hash is computed once per position in shared memory instead
// of once per window member.
// ---------------------------------------------------------------------------

constexpr int kK1Threads = 256;
constexpr int kK1Span = 2 * kK1Threads;

__global__ void __launch_bounds__(kK1Threads)
hash_keys_winmin_sync_kernel(const uint8_t* __restrict__ blocks,
                             uint32_t* __restrict__ keys,
                             uint32_t* __restrict__ minz, int n, int width,
                             int pbits, uint32_t pmask, int stride,
                             int halo) {
    extern __shared__ uint32_t smem[];
    const int nh = kK1Span + halo;  // h8 entries: tile + window halo
    uint32_t* h8 = smem;
    uint8_t* bytes = reinterpret_cast<uint8_t*>(smem + nh);  // nh + 7
    const int row = blockIdx.y;
    const int base = blockIdx.x * kK1Span;
    const uint8_t* x = blocks + size_t(row) * n;

    for (int j = threadIdx.x; j < nh + 7; j += kK1Threads) {
        const int p = base + j;
        bytes[j] = p < n ? x[p] : 0;  // zero past the row, as the reference
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nh; j += kK1Threads) {
        h8[j] = base + j < n ? gram_hash(bytes + j, 8, 32) : kEmpty;
    }
    __syncthreads();

    const int t = 2 * threadIdx.x;
    const int i = base + t;
    if (i >= n) return;

    // Argmin parity over [i, i+4): the low bit carries the lane parity,
    // so ties go to the even lane, as in the reference's sign-flipped min.
    uint32_t v = kEmpty;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t u = i + k < n
            ? (h8[t + k] & 0xFFFFFFFEu) | uint32_t((i + k) & 1) : kEmpty;
        v = min(v, u);
    }
    const int pick = int(v & 1u);
    const uint32_t selh = gram_hash(bytes + t + pick, width, 32 - pbits);
    const uint32_t selp = uint32_t(i + pick) & pmask;
    keys[(size_t(row) * n + i) >> 1] = (selh << pbits) | selp;

    if (stride > 0) {
        uint32_t inner = kEmpty;  // min over [i+1, i+stride)
        for (int k = 1; k < stride; ++k) inner = min(inner, h8[t + k]);
        *reinterpret_cast<uint2*>(minz + size_t(row) * n + i) =
            make_uint2(min(h8[t], inner), min(inner, h8[t + stride]));
    }
}

// ---------------------------------------------------------------------------
// K2: nearest equal-hash neighbor -> un-sort keys.
// Replaces glue_kernels.neighbor_unsort_keys (Pallas).
//
// One thread per element of the sorted (rows, w) keys (hash << pbits |
// pos). The nearest earlier entry of the row with an equal hash claims
// offset pos - prev; the output (key << (32 - pbits) | off) drops the hash
// bits, so a second row sort restores position order. Pure elementwise
// pass with one neighbor read (an L1 hit): 8 bytes moved per element.
// ---------------------------------------------------------------------------

__global__ void neighbor_unsort_keys_kernel(const uint32_t* __restrict__ sk,
                                            uint32_t* __restrict__ out,
                                            long long total, int w,
                                            int pbits, int neighbors,
                                            uint32_t pmask) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = int(idx % w);
    const uint32_t s = sk[idx];
    const uint32_t sh = s >> pbits;
    const uint32_t sp = s & pmask;
    uint32_t off = 0;
    for (int k = 1; k <= neighbors; ++k) {
        uint32_t ph = kEmpty, pp = 0;  // the reference's row-head fills
        if (j >= k) {
            const uint32_t q = sk[idx - k];
            ph = q >> pbits;
            pp = q & pmask;
        }
        if (off == 0 && sh == ph && pp < sp) off = sp - pp;
    }
    out[idx] = (s << (32 - pbits)) | off;
}

// ---------------------------------------------------------------------------
// K3: long-distance-match sort keys.
// Replaces glue_kernels.ldm_keys (Pallas).
//
// One thread per output element of the (nspans, 2 * half) rows: column c
// of span row r samples minz every `stride` bytes, from this span's blocks
// (c >= half) or from the previous span's (c < half; the first span's
// context is 0xFFFFFFFF), remixes by x 2654435761 and packs
// (h << pbits | c). Reads are strided (one 32-byte sector per sample), so
// the pass is bound by sectors read: N / stride per block row.
// ---------------------------------------------------------------------------

__global__ void ldm_keys_kernel(const uint32_t* __restrict__ minz,
                                uint32_t* __restrict__ out, long long total,
                                int n, int stride, int span_blocks,
                                int pbits) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int spb = n / stride;
    const int half = span_blocks * spb;
    const int sps = 2 * half;
    const int r = int(idx / sps);
    const int c = int(idx % sps);
    const int q = c < half ? c : c - half;
    const int blk = r * span_blocks + q / spb - (c < half ? span_blocks : 0);
    const uint32_t m = blk >= 0
        ? minz[size_t(blk) * n + size_t(q % spb) * stride] : kEmpty;
    out[idx] = (((m * kC1) >> pbits) << pbits) | uint32_t(c);
}

// ---------------------------------------------------------------------------
// K4: pair claims -> slot words.
// Replaces glue_kernels.compact_slots_sync (Pallas).
//
// One thread per 4-byte slot i of a block: it reads the position-ordered
// pair entries 2i and 2i+1 (pos << offbits | off) with one 8-byte load,
// keeps each claim that has an offset and passes the tail guard
// pos + width <= len, and writes the smaller (k << 30 | off) or the empty
// sentinel. When LDM estimates are given (spb > 0), the slot on every
// (Ns / spb)-th position takes the LDM offset if the estimate beats the
// local claim's width. 8 bytes read and 4 written per slot.
// ---------------------------------------------------------------------------

__global__ void compact_slots_sync_kernel(const uint32_t* __restrict__ su,
                                          const int32_t* __restrict__ lengths,
                                          const int32_t* __restrict__ est,
                                          const int32_t* __restrict__ ldo,
                                          uint32_t* __restrict__ out,
                                          long long total, int ns, int pbits,
                                          int width, int spb) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int b = int(idx / ns);
    const int i = int(idx % ns);
    const int offbits = 32 - pbits;
    const uint32_t offmask = (1u << offbits) - 1u;
    const int segbase = (i >> (pbits - 2)) << pbits;
    const int blen = lengths[b];
    const uint2 pair = reinterpret_cast<const uint2*>(su)[idx];
    uint32_t best = kEmpty;
    const uint32_t entries[2] = {pair.x, pair.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const uint32_t s = entries[e];
        const uint32_t posf = s >> offbits;
        const uint32_t off = s & offmask;
        if (off > 0 && segbase + int(posf) + width <= blen)
            best = min(best, ((posf & 3u) << 30) | off);
    }
    if (spb > 0) {
        const int sls = ns / spb;  // slots per LDM sample
        if (i % sls == 0) {
            const size_t t = size_t(b) * spb + i / sls;
            const int ml0 = best != kEmpty ? width : 0;
            if (est[t] > ml0) best = uint32_t(ldo[t]);
        }
    }
    out[idx] = best;
}

}  // namespace

extern "C" {

const char* qz_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qz_hash_keys_winmin_sync(const void* blocks, void* keys, void* minz,
                             int rows, int n, int width, int pbits,
                             int pmask, int stride, void* stream) {
    const int halo = stride > 4 ? stride : 4;
    const int nh = kK1Span + halo;
    const size_t smem = size_t(nh) * 4 + ((size_t(nh) + 7 + 3) & ~size_t(3));
    const dim3 grid((n + kK1Span - 1) / kK1Span, rows);
    hash_keys_winmin_sync_kernel<<<grid, kK1Threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<uint32_t*>(keys),
        static_cast<uint32_t*>(minz), n, width, pbits, uint32_t(pmask),
        stride, halo);
    return int(cudaGetLastError());
}

int qz_neighbor_unsort_keys(const void* sk, void* out, int rows, int w,
                            int pbits, int neighbors, int pmask,
                            void* stream) {
    const long long total = (long long)rows * w;
    neighbor_unsort_keys_kernel<<<blocks_for(total), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sk), static_cast<uint32_t*>(out), total,
        w, pbits, neighbors, uint32_t(pmask));
    return int(cudaGetLastError());
}

int qz_ldm_keys(const void* minz, void* out, int nspans, int n, int stride,
                int span_blocks, int pbits, void* stream) {
    const long long total = (long long)nspans * 2 * span_blocks * (n / stride);
    ldm_keys_kernel<<<blocks_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(minz), static_cast<uint32_t*>(out),
        total, n, stride, span_blocks, pbits);
    return int(cudaGetLastError());
}

int qz_compact_slots_sync(const void* su, const void* lengths,
                          const void* est, const void* ldo, void* out,
                          int rows, int ns, int pbits, int width, int spb,
                          void* stream) {
    const long long total = (long long)rows * ns;
    compact_slots_sync_kernel<<<blocks_for(total), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(su),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(est), static_cast<const int32_t*>(ldo),
        static_cast<uint32_t*>(out), total, ns, pbits, width, spb);
    return int(cudaGetLastError());
}

}  // extern "C"
