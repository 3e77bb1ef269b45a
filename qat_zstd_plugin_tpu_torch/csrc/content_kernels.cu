// Hopper kernels of the level 5-12 device path (the exact-LCP content
// matcher).
//
// Two hand-written CUDA kernels replace the two Pallas kernels that
// qat_zstd_plugin_tpu.ops.match_pipeline.find_matches_packed runs on the
// TPU beside the already-ported neighbor_unsort_keys and ldm_keys. Each
// has a plain PyTorch twin (ops/glue_kernels.py ldm_winmin_twin,
// ops/parse_kernel.py parse_greedy_twin) that computes the same words;
// the wrappers beside them check shapes and dtypes, allocate the outputs
// and launch these entry points through ctypes.
//
// Interface: as in l1_kernels.cu, every entry point takes device
// pointers, sizes and the CUDA stream (PyTorch's current stream), launches
// on that stream, allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kMinMatch = 4;  // match_pipeline.MIN_MATCH

// ---------------------------------------------------------------------------
// B9 ldm_winmin: the windowed minimum of the 8-gram hash over [i, i+stride).
// Replaces glue_kernels.ldm_winmin (Pallas), which computes the same words
// as the minimizer half of hash_keys_winmin. It is that kernel's templated
// body (common.cuh) with the keys switched off: a warp per tile of 8 rows
// of 128 positions, whole-word loads, h8 from shuffled words and
// __byte_perm in registers, the van Herk/Gil-Werman windowed minimum over
// segmented shuffle scans (no shared memory; the same work a position at
// strides 4 to 128; strides 256 to 4096 take a second launch over the
// stride-128 plane in scratch), one 16-byte store a lane and row.
// Bound: memory, n bytes read and 4n written per row (40 MiB at
// B=64 x 128 KiB, 12.5 us at 3.35 TB/s).
// ---------------------------------------------------------------------------
// B10 parse_greedy: the greedy parse with the optional one-step lazy.
// Replaces parse_kernel.parse_greedy_pallas / _make_kernel (Pallas), which
// lays the batch on the TPU's lanes and sweeps every position with one
// cursor per lane. Where the cursor goes from a position t depends on t
// alone: past the match when t is taken (mlen[t] >= 4 and, with lazy, not
// mlen[t+1] > mlen[t], mlen[n] reading as 0), else to t + 1. So a row's
// parse is the chain 0 -> next(0) -> ..., and a position off the chain is
// never taken. Here each position's step is signed: -(the match length,
// cut at the row's end) when taken, else 1.
//
// Segmented mode (trunc, the reference's parse_greedy_pallas(psegs > 1)):
// each block row of N positions is psegs independent rows of n = N/psegs,
// which lie one after the other in memory, so the caller passes B*psegs
// rows of n. Each length is first cut to the row's end, min(mlen[t], n -
// t), and the take test uses the cut one (the look-ahead reads the raw
// mlen[t+1], 0 at the row's end).
//
// What bounds it. The bytes: each visited position's length and each
// output byte, 4 * visited + n (0.0053 ms at B=64 x 128 KiB of L5
// candidates at 3.35 TB/s). This design reads every length, so its
// floor is 5n bytes (0.0125 ms there), and it has a serial part: a row's
// chunks are links of one chain, each a round trip through L2. A CTA a
// row with the chain marked by pointer doubling (log2(C) passes over a
// chunk of C) took 0.52-0.58 ms: 64 rows on 64 of 132 SMs. This design
// takes about 0.035 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (designs/parse.py, PERF.md): six CTAs an SM (shared memory), each
// spending about half of its cycles on its maps, so the maps' work per SM
// bounds it; the chain, 0.6-0.7 us a link, adds about a tenth at psegs 1.
//
// The design: linear work, a CTA a chunk of kParseChunk positions, and
// every SM busy. A lane owns a piece of kParsePiece positions, a warp a
// segment of 32 pieces.
//   (a) Maps. The CTA stages its chunk's lengths and the one after it in
//       shared memory (coalesced, 16-byte loads where the row is aligned),
//       and each lane reads its piece back into registers as signed steps
//       (lazy and trunc are template parameters). For a span of
//       positions, where the chain from every entry leaves the span
//       follows from one backward recurrence: exit[j] = j + step[j] if
//       that leaves the span, else exit[j + step[j]]. Each lane runs it
//       over its piece (`pe`); each warp then over its segment, piece by
//       piece from the last, from the pieces' exits (`we`), which a lane
//       reads kParseAhead pieces ahead. Both are O(1) a position: one
//       dependent shared load a step, chunk offsets in 32 bits (an exit may
//       lie far past the chunk).
//   (b) Chaining, by decoupled look-back. A CTA takes its chunk from a
//       ticket counter, chunk-major (ticket = chunk * rows + row), so the
//       CTA of the chunk before it in the row has started and every wait
//       ends, and every row's front advances at once. Thread 0 waits for
//       that CTA's exit (the row's cursor at this chunk's start, one
//       status word of 31 bits and a ready bit), hops over at most
//       kParseWarps segments by `we` to this chunk's exit and publishes it
//       at once. An exit past the chunk passes through it unchanged (a
//       match over whole chunks). Relaxed loads and stores suffice: the
//       status word carries the only value passed.
//   (c) Walk. Each warp hops over its pieces by `pe` from its segment's
//       entry (at most 32 hops, every lane the same address), and each lane
//       walks its piece forward from its entry over the steps in its
//       registers and writes its 32 chosen bytes in two 16-byte stores.
// Shared memory is indexed j + j/32 so that lanes on their pieces hit
// distinct banks. The entry point zeroes the counter and the status words
// (kParseStatusStride words apart, one 32-byte sector each) on the stream
// before the launch; the wrapper allocates them.
// ---------------------------------------------------------------------------

constexpr int kParseThreads = 128;     // threads of a CTA
constexpr int kParsePiece = 32;        // positions of a lane's piece
constexpr int kParseStatusStride = 8;  // words between two status words
constexpr int kParseAhead = 8;         // pieces' exits read ahead (level 1)
constexpr int kParseChunk = kParseThreads * kParsePiece;  // a CTA's
constexpr int kParseWarps = kParseThreads / 32;
constexpr int kParseSegment = 32 * kParsePiece;           // a warp's
constexpr int kParseColumn = (kParsePiece + 31) / 32;  // a lane's of a piece
constexpr int kParseWords = kParseChunk + kParseChunk / 32 + 1;  // padded
constexpr size_t kParseSmem = size_t(kParseWords) * 2 * 4;
constexpr uint32_t kExitReady = 0x80000000u;
static_assert(kParseThreads % 32 == 0 && kParsePiece % 16 == 0,
              "whole warps; a piece is whole 16-byte stores");
static_assert(32 % kParseAhead == 0, "whole groups of pieces");

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

__device__ __forceinline__ int step_of(int s) { return s < 0 ? -s : s; }

// Position t's signed step: -(its length, cut at the row's end) when t is
// taken, else 1; raw its length, next the length at t + 1 (0 at the row's
// end).
template <bool kLazy, bool kTrunc>
__device__ __forceinline__ int parse_step(int raw, int next, int t, int n) {
    const int ml = kTrunc ? min(raw, n - t) : raw;
    const bool take = ml >= kMinMatch && !(kLazy && next > ml);
    return take ? -min(ml, n - t) : 1;
}

__device__ __forceinline__ uint32_t peek_exit(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void post_exit(uint32_t* p, uint32_t v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

template <bool kLazy, bool kTrunc>
__global__ void __launch_bounds__(kParseThreads)
parse_greedy_kernel(const int32_t* __restrict__ mlen,
                    uint8_t* __restrict__ chosen,
                    uint32_t* __restrict__ scratch, int rows, int n) {
    extern __shared__ int32_t parse_smem[];
    int32_t* pe = parse_smem;                // the lengths, then piece exits
    int32_t* we = parse_smem + kParseWords;  // segment exits
    __shared__ int ticket;
    __shared__ int seg_entry[kParseWarps];  // kParseChunk: no entry
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) ticket = int(atomicAdd(scratch, 1u));
    if (tid < kParseWarps) seg_entry[tid] = kParseChunk;
    __syncthreads();
    const int k = ticket / rows, r = ticket - k * rows;  // chunk-major
    const int base = k * kParseChunk;
    const int end = min(kParseChunk, n - base);  // the chunk's positions
    const int32_t* m = mlen + size_t(r) * n + base;
    uint8_t* c = chosen + size_t(r) * n + base;
    uint32_t* status = scratch + kParseStatusStride;  // [chunk][row]

    // (a) The lengths, coalesced, and the one after the chunk (0 past the
    // row's end); thread t takes positions 4 * (t + g * kParseThreads).
    if (end == kParseChunk && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
#pragma unroll
        for (int g = 0; g < kParsePiece / 4; ++g) {
            const int p = 4 * (tid + g * kParseThreads);
            const int4 x = __ldg(reinterpret_cast<const int4*>(m + p));
            pe[padded(p)] = x.x;
            pe[padded(p + 1)] = x.y;
            pe[padded(p + 2)] = x.z;
            pe[padded(p + 3)] = x.w;
        }
    } else {
        for (int p = tid; p < kParseChunk; p += kParseThreads)
            pe[padded(p)] = p < end ? __ldg(m + p) : 0;
    }
    if (tid == 0)
        pe[padded(kParseChunk)] = base + kParseChunk < n ? __ldg(m + kParseChunk) : 0;
    __syncthreads();
    // A lane's steps, in registers. Past the row's end a position's step
    // is 1; no chain reaches it.
    const int ps = tid * kParsePiece;
    int st[kParsePiece];
    {
        int next = pe[padded(ps + kParsePiece)];
#pragma unroll
        for (int i = kParsePiece - 1; i >= 0; --i) {
            const int raw = pe[padded(ps + i)];
            st[i] = ps + i < end
                        ? parse_step<kLazy, kTrunc>(raw, next, base + ps + i, n)
                        : 1;
            next = raw;
        }
    }
    __syncthreads();  // every lane has read its lengths before pe changes

    // (a) The piece's exits, backward; j and y lie in the lane's piece, so
    // padded(j) = j + j / 32 is j + its piece's index.
    const int pend = min(ps + kParsePiece, end);
    const int ppad = ps / 32;
#pragma unroll
    for (int i = kParsePiece - 1; i >= 0; --i) {
        const int j = ps + i;
        const int y = j + step_of(st[i]);
        pe[j + i / 32 + ppad] = y >= pend ? y : pe[padded(y)];
    }
    __syncwarp();
    // The segment's exits, piece by piece from the last; a piece's exits
    // lie in a later piece of the segment or past it. The pieces' exits
    // of the lane's column are read kParseAhead pieces ahead of the chain
    // of `we` loads.
    const int ss = warp * kParseSegment;
    const int send = min(ss + kParseSegment, end);
#pragma unroll
    for (int q0 = 32 - kParseAhead; q0 >= 0; q0 -= kParseAhead) {
        int y[kParseAhead][kParseColumn];
#pragma unroll
        for (int a = 0; a < kParseAhead; ++a)
#pragma unroll
            for (int u = 0; u < kParseColumn; ++u) {
                const int i = lane + 32 * u;
                y[a][u] = i < kParsePiece
                              ? pe[padded(ss + (q0 + a) * kParsePiece + i)]
                              : 0;
            }
#pragma unroll
        for (int a = kParseAhead - 1; a >= 0; --a) {
#pragma unroll
            for (int u = 0; u < kParseColumn; ++u) {
                const int i = lane + 32 * u, j = ss + (q0 + a) * kParsePiece + i;
                if (i < kParsePiece)
                    we[padded(j)] = y[a][u] >= send ? y[a][u]
                                                    : we[padded(y[a][u])];
            }
            __syncwarp();
        }
    }
    __syncthreads();

    // (b) The entry from the chunk before, the hops over the segments,
    // the exit published for the chunk after.
    if (tid == 0) {
        int entry = 0;
        if (k > 0) {
            const uint32_t* prev =
                status + (size_t(k - 1) * rows + r) * kParseStatusStride;
            uint32_t v;
            while (!((v = peek_exit(prev)) & kExitReady)) {
            }
            entry = int(v & ~kExitReady);
        }
        int x = entry - base, exit_at = entry;  // past the chunk: through
        while (x < end) {
            seg_entry[x / kParseSegment] = x;
            const int y = we[padded(x)];
            if (y >= end) {
                exit_at = base + y;
                break;
            }
            x = y;
        }
        if (base + kParseChunk < n)  // a chunk follows
            post_exit(status + (size_t(k) * rows + r) * kParseStatusStride,
                      kExitReady | uint32_t(exit_at));
    }
    __syncthreads();

    // (c) The pieces' entries: the warp hops from its segment's entry.
    int x = seg_entry[warp];
    int mine = kParseChunk;  // no entry: the walk meets no position
    while (x < send) {
        if (x / kParsePiece == tid) mine = x;
        x = pe[padded(x)];
    }
    // The walk, 4 chosen bytes a word.
    uint32_t word[kParsePiece / 4];
#pragma unroll
    for (int w = 0; w < kParsePiece / 4; ++w) {
        uint32_t bits = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int i = 4 * w + b;
            if (ps + i == mine) {
                bits |= uint32_t(st[i] < 0) << (8 * b);
                mine += step_of(st[i]);
            }
        }
        word[w] = bits;
    }
    if (pend == ps + kParsePiece &&
        (reinterpret_cast<uintptr_t>(c + ps) & 15) == 0) {
#pragma unroll
        for (int w = 0; w < kParsePiece / 16; ++w)
            reinterpret_cast<uint4*>(c + ps)[w] =
                make_uint4(word[4 * w], word[4 * w + 1], word[4 * w + 2],
                           word[4 * w + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < kParsePiece; ++i)
            if (ps + i < end) c[ps + i] = uint8_t(word[i / 4] >> (8 * (i & 3)));
    }
}

}  // namespace

extern "C" {

int qz_ldm_winmin(const void* blocks, void* minz, void* scratch, int rows,
                  int n, int stride, void* stream) {
    return launch_hash_keys<false, true>(blocks, nullptr, minz, scratch, rows,
                                         n, 8, 0, 0, stride, 0u, stream);
}

int qz_parse_greedy(const void* mlen, void* chosen, void* scratch,
                    int scratch_words, int rows, int n, int lazy, int trunc,
                    void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (n >= (1 << 30)) return int(cudaErrorInvalidValue);
    const long long chunks = (long long)rows * ((n - 1) / kParseChunk + 1);
    const long long words = (chunks + 1) * kParseStatusStride;
    if (words > scratch_words) return int(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto kernel = lazy ? (trunc ? parse_greedy_kernel<true, true>
                                      : parse_greedy_kernel<true, false>)
                             : (trunc ? parse_greedy_kernel<false, true>
                                      : parse_greedy_kernel<false, false>);
    if constexpr (kParseSmem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            int(kParseSmem));
        if (e != cudaSuccess) return int(e);
    }
    const cudaError_t e = cudaMemsetAsync(scratch, 0, size_t(words) * 4, s);
    if (e != cudaSuccess) return int(e);
    kernel<<<unsigned(chunks), kParseThreads, kParseSmem, s>>>(
        static_cast<const int32_t*>(mlen), static_cast<uint8_t*>(chosen),
        static_cast<uint32_t*>(scratch), rows, n);
    return int(cudaGetLastError());
}

}  // extern "C"
