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
// cursor per lane. Where the cursor goes from a position it lands on
// depends on that position alone: past the match (t + mlen[t]) when t is
// taken (mlen[t] >= 4 and, with lazy, not mlen[t+1] > mlen[t], where
// mlen[n] reads as 0), else to t + 1. The positions a row visits are the
// chain cursor -> next(cursor) -> ..., and a position off the chain is
// never active in the reference's sweep, so never taken.
//
// A walk of that chain by one thread is a dependent read per visited
// position, up to n per row: that first design took 3.5 ms at B=64 x 128
// KiB on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), as slow as
// the plain-torch twin. Here the chain is marked in parallel instead. One
// CTA takes one block row, chunk by chunk (kParseChunk positions, the
// cursor carried between chunks in shared memory). For a chunk its
// threads write each position's step and its jump (the next position in
// the chunk, or the chunk's end) to shared memory and mark the entry
// position; then round r marks jump(p) for every marked p and squares the
// jumps (jump <- jump(jump)), so after round r the first 2^(r+1)
// positions of the chain are marked (marks a thread sees early are chain
// positions too). After log2(kParseChunk) rounds the whole chain in the
// chunk is marked; a marked position with a step > 1 is chosen, and the
// marked one whose step leaves the chunk gives the next chunk's cursor.
// Work: log2(C) passes over a chunk of C words in shared memory instead
// of up to C dependent reads. Bound: memory, 4n bytes read and n written
// per row (40 MiB at B=64 x 128 KiB, 12.5 us at 3.35 TB/s); with 64 rows
// on 64 of 132 SMs and 2 log2(C) barriers per chunk it stays well above
// that.
//
// Segmented mode (trunc, the reference's parse_greedy_pallas(psegs > 1)):
// each block row of N positions is psegs independent rows of n = N/psegs,
// which lie one after the other in memory, so the caller passes B*psegs
// rows of n and one CTA still takes one (block, segment) row. Each
// position's length is first cut to the row's end, min(mlen[t], n - t),
// and the take test (>= 4, and with lazy not mlen[t+1] > the cut length,
// the next length read raw and 0 at the row's end) uses the cut one.
// ---------------------------------------------------------------------------

constexpr int kParseThreads = 256;
constexpr int kParseChunk = 4096;  // positions per chunk
constexpr int kParseRounds = 12;   // log2(kParseChunk)

__global__ void __launch_bounds__(kParseThreads)
parse_greedy_kernel(const int32_t* __restrict__ mlen,
                    uint8_t* __restrict__ chosen, int n, int lazy,
                    int trunc) {
    __shared__ int32_t step[kParseChunk];
    __shared__ int16_t jump_a[kParseChunk], jump_b[kParseChunk];
    __shared__ uint8_t mark[kParseChunk];
    __shared__ int cursor;  // the row's cursor at the current chunk's start
    const int32_t* m = mlen + size_t(blockIdx.x) * n;
    uint8_t* c = chosen + size_t(blockIdx.x) * n;
    if (threadIdx.x == 0) cursor = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kParseChunk) {
        const int len = min(kParseChunk, n - base);
        const int entry = cursor - base;  // >= 0
        if (entry >= len) {  // the chain jumps over this chunk
            for (int j = threadIdx.x; j < len; j += kParseThreads)
                c[base + j] = 0;
            continue;  // every thread read cursor before it changes
        }
        for (int j = threadIdx.x; j < len; j += kParseThreads) {
            const int t = base + j;
            const int ml = trunc ? min(m[t], n - t) : m[t];
            const int next = t + 1 < n ? m[t + 1] : 0;
            const bool take = ml >= kMinMatch && !(lazy && next > ml);
            const int d = take ? ml : 1;  // a take moves >= kMinMatch
            step[j] = d;
            jump_a[j] = int16_t(min(j + d, len));
            mark[j] = j == entry;
        }
        __syncthreads();
        int16_t* jump = jump_a;
        int16_t* spare = jump_b;
        for (int r = 0; r < kParseRounds; ++r) {
            for (int j = threadIdx.x; j < len; j += kParseThreads) {
                const int to = jump[j];
                if (mark[j] && to < len) mark[to] = 1;
            }
            __syncthreads();
            if (r + 1 == kParseRounds) break;
            for (int j = threadIdx.x; j < len; j += kParseThreads) {
                const int to = jump[j];
                spare[j] = to < len ? jump[to] : int16_t(len);
            }
            __syncthreads();
            int16_t* t = jump;
            jump = spare;
            spare = t;
        }
        int exit_at = -1;
        for (int j = threadIdx.x; j < len; j += kParseThreads) {
            const bool on = mark[j];
            c[base + j] = on && step[j] > 1;
            if (on && j + step[j] >= len) exit_at = base + j + step[j];
        }
        __syncthreads();  // every thread read cursor (entry) above
        if (exit_at >= 0) cursor = exit_at;  // one thread: the chain's last
        __syncthreads();
    }
}

}  // namespace

extern "C" {

int qz_ldm_winmin(const void* blocks, void* minz, void* scratch, int rows,
                  int n, int stride, void* stream) {
    return launch_hash_keys<false, true>(blocks, nullptr, minz, scratch, rows,
                                         n, 8, 0, 0, stride, 0u, stream);
}

int qz_parse_greedy(const void* mlen, void* chosen, int rows, int n, int lazy,
                    int trunc, void* stream) {
    parse_greedy_kernel<<<rows, kParseThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(mlen), static_cast<uint8_t*>(chosen), n,
        lazy, trunc);
    return int(cudaGetLastError());
}

}  // extern "C"
