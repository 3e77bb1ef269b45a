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
// device-memory bandwidth bounds them on an H100 (3.35 TB/s). K1 and K4
// are written simple and right first: one thread per output element (K1
// a byte pair), loads and stores coalesced along the row. K2 and K3 are
// redesigned for the card: 32-bit index arithmetic, 16-byte accesses in
// K2, one read of each LDM sample in K3, and the sign flips of the signed
// row sorts around them folded into both.

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
// Each row of the (rows, w) keys (hash << pbits | pos) is sorted. The
// nearest of the `neighbors` earlier entries of the row with an equal hash
// and a smaller position claims off = pos - prev (the first k entries of a
// row see the reference's fill, hash 0xFFFFFFFF, which no key's hash
// equals); the output (key << (32 - pbits) | off) drops the hash bits, so
// a second row sort restores position order. `flip` (0 or 0x80000000) is
// XORed into every word read and every word written: the row sorts on
// either side are signed, and this folds their sign flips into the pass.
//
// Bound: 8 bytes moved a word. Grid: (chunks of a row, rows), all index
// arithmetic 32-bit. Where w % 4 == 0 (kVec) a thread takes 4 consecutive
// words with one 16-byte load and the 4 before them with another (the
// previous thread's, an L1 hit), claims from that 8-word window and
// writes the 4 outputs with one 16-byte store; a neighbor more than 4 back
// (neighbors > 4, which no level takes) is read from the row, through L1.
// Otherwise (the scalar path) a thread takes one word and reads its
// neighbors from the row. Each claim is written as one condition.
// Measured against each other on the card (designs/k2_k3.py), this runs
// as fast as a 16-byte copy of the same bytes; the same window with each
// claim behind a branch (k <= neighbors, k <= j) around a helper's test
// runs 9% slower, and tiles of 1024, 2048 or 4096 words staged in shared
// memory (the window read from there after a barrier) 3-21% slower.
// ---------------------------------------------------------------------------

constexpr int kK2Threads = 256;

__device__ __forceinline__ uint4 xor4(uint4 v, uint32_t flip) {
    return make_uint4(v.x ^ flip, v.y ^ flip, v.z ^ flip, v.w ^ flip);
}

template <bool kVec>  // kVec: w % 4 == 0, so every row is 16-byte aligned
__global__ void __launch_bounds__(kK2Threads)
neighbor_unsort_keys_kernel(const uint32_t* __restrict__ sk,
                            uint32_t* __restrict__ out, int w, int pbits,
                            int neighbors, uint32_t pmask, uint32_t flip) {
    const uint32_t* x = sk + size_t(blockIdx.y) * w;
    uint32_t* y = out + size_t(blockIdx.y) * w;
    const int shift = 32 - pbits;
    const int i = int(blockIdx.x * kK2Threads + threadIdx.x);
    if (kVec) {
        const int t = 4 * i;  // first of the thread's 4 words
        if (t >= w) return;
        const uint4 a = t >= 4
            ? xor4(__ldg(reinterpret_cast<const uint4*>(x + t - 4)), flip)
            : make_uint4(0, 0, 0, 0);  // never read: k <= j below
        const uint4 b = xor4(__ldg(reinterpret_cast<const uint4*>(x + t)),
                             flip);
        const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = t + e;  // a row's first k see the fill
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
            for (int k = 5; k <= neighbors && k <= j && off == 0; ++k) {
                const uint32_t q = __ldg(x + j - k) ^ flip, pp = q & pmask;
                if ((q >> pbits) == sh && pp < sp) off = sp - pp;
            }
            o[e] = ((sv << shift) | off) ^ flip;
        }
        *reinterpret_cast<uint4*>(y + t) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
        if (i >= w) return;
        const uint32_t sv = __ldg(x + i) ^ flip;
        const uint32_t sh = sv >> pbits, sp = sv & pmask;
        uint32_t off = 0;
        for (int k = 1; k <= neighbors && k <= i && off == 0; ++k) {
            const uint32_t q = __ldg(x + i - k) ^ flip, pp = q & pmask;
            if ((q >> pbits) == sh && pp < sp) off = sp - pp;
        }
        y[i] = ((sv << shift) | off) ^ flip;
    }
}

// ---------------------------------------------------------------------------
// K3: long-distance-match sort keys.
// Replaces glue_kernels.ldm_keys (Pallas).
//
// Span row r of the (nspans, 2 * half) output is [the previous span's
// samples | this span's samples]: sample q of block b (minz[b, q *
// stride]), remixed by x 2654435761, packs (h << pbits | column). One
// thread a sample: it reads the sample once and writes it to both places
// it belongs, column half + (b % sb) * spb + q of span row b / sb and
// column (b % sb) * spb + q of span row b / sb + 1, as that row's context.
// The last span's blocks, which have no next row, write span row 0's
// context instead: the 0xFFFFFFFF fill, remixed like any sample. So every
// output word is written exactly once. `flip` is XORed into every output
// word (the LDM chain's signed row sort follows). Grid: (sample chunks,
// b % sb, b / sb), no division.
//
// Bound: the reads are strided, one 32-byte sector a sample, so the pass
// moves B * spb * 32 bytes in and 8 out a sample (the byte bound counts
// 4 in). A warp's 32 samples lie in 32 consecutive 128-byte lines and its
// stores are coalesced; taking 4 or 8 consecutive samples a thread, with
// 16-byte stores, spread a warp's reads over 4 or 8 times as many lines
// and was slower on the card.
// ---------------------------------------------------------------------------

constexpr int kK3Threads = 256;

__device__ __forceinline__ uint32_t ldm_key(uint32_t m, int pbits,
                                            int column, uint32_t flip) {
    return ((((m * kC1) >> pbits) << pbits) | uint32_t(column)) ^ flip;
}

__global__ void __launch_bounds__(kK3Threads)
ldm_keys_kernel(const uint32_t* __restrict__ minz, uint32_t* __restrict__ out,
                int n, int stride, int spb, int span_blocks, int nspans,
                int r0, int pbits, uint32_t flip) {
    const int q = int(blockIdx.x * kK3Threads + threadIdx.x);  // sample
    if (q >= spb) return;
    const int r = r0 + int(blockIdx.z);  // span row
    const int half = span_blocks * spb;
    const int c = int(blockIdx.y) * spb + q;  // context column
    const bool last = r + 1 == nspans;
    const uint32_t m = __ldg(minz + size_t(r * span_blocks + int(blockIdx.y))
                             * n + size_t(q) * stride);
    out[size_t(r) * (2 * half) + half + c] = ldm_key(m, pbits, half + c,
                                                     flip);
    out[size_t(last ? 0 : r + 1) * (2 * half) + c] =
        ldm_key(last ? kEmpty : m, pbits, c, flip);
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
                            unsigned flip, void* stream) {
    if (rows <= 0 || w <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = w % 4 == 0;
    const int per = vec ? 4 * kK2Threads : kK2Threads;  // words a CTA
    const unsigned chunks = unsigned((w + per - 1) / per);
    for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
        const dim3 grid(chunks, unsigned(min(rows - r0, kMaxGridY)));
        const uint32_t* src =
            static_cast<const uint32_t*>(sk) + size_t(r0) * w;
        uint32_t* dst = static_cast<uint32_t*>(out) + size_t(r0) * w;
        if (vec)
            neighbor_unsort_keys_kernel<true><<<grid, kK2Threads, 0, st>>>(
                src, dst, w, pbits, neighbors, uint32_t(pmask), flip);
        else
            neighbor_unsort_keys_kernel<false><<<grid, kK2Threads, 0, st>>>(
                src, dst, w, pbits, neighbors, uint32_t(pmask), flip);
    }
    return int(cudaGetLastError());
}

int qz_ldm_keys(const void* minz, void* out, int nspans, int n, int stride,
                int span_blocks, int pbits, unsigned flip, void* stream) {
    const int spb = n / stride;  // samples a block
    if (nspans <= 0 || spb <= 0) return 0;
    const unsigned chunks = unsigned((spb + kK3Threads - 1) / kK3Threads);
    for (int r0 = 0; r0 < nspans; r0 += kMaxGridY)
        ldm_keys_kernel<<<dim3(chunks, unsigned(span_blocks),
                               unsigned(min(nspans - r0, kMaxGridY))),
                          kK3Threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(minz), static_cast<uint32_t*>(out),
            n, stride, spb, span_blocks, nspans, r0, pbits, flip);
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
