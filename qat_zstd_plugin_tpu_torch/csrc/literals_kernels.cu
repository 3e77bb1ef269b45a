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

#include <climits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B15 literal_keys: (B, n) u32 keys, (pos << 8 | byte) at literal
// positions and 0xFFFFFFFF elsewhere.
//
// A position i < length is a literal unless a chosen match at or before it
// ends after it: covered(i) = max over j <= i of end(j) > i, an inclusive
// per-row prefix maximum of end(j) = chosen[j] ? j + mlen[j] : 0. The
// reference takes the maximum by 14 doubling steps of whole-row shifts,
// which sees only the last 16384 positions; that bounds every match of
// the hash path (runs capped at 16383) but not the content path's
// offset-1 runs (up to 65535), whose positions from start + 16384 on it
// marks as literals. Here the maximum runs over the whole row, as the
// twin's torch.cummax. Each end is clamped to [0, n]: min(j + min(max(
// mlen, 0), n), n), which covers the same positions of the row (an end
// at or past n covers all of them after j, one at or before j none), fits
// 30 bits (the entry point refuses n >= 2^29) and cannot overflow an int
// on any mlen.
//
// Bound: device memory, per position 1 byte of blocks, 1 of chosen and 4
// of mlen read and 4 of keys written (0.0250 ms at B=64 x 128 KiB at 3.35
// TB/s). One launch: a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016) over tiles of kLitTile positions, the operator max,
// which is idempotent, so a tile may take any number of its
// predecessors' aggregates, and may fold into its own anything no larger
// than its carry. Each status word is (flag << 30 | value), flag 0
// empty, 2 aggregate, 3 inclusive prefix; each bound word is 0 or (1 <<
// 30 | a lower bound on the next tile's carry). The entry point zeroes
// both planes and the tile counter on the stream before the launch.
//
// The look-back is a chain of memory round trips (publish, read back,
// publish). A CTA that waited for it before it stored a tile of 2048
// positions spent most of its life waiting (slower than the two-pass
// parent on the card), so here no store waits for it:
//  - a CTA takes its tile index, row-major over (row, tile), from a
//    global counter in the order CTAs start, so every tile before it in
//    its row belongs to a CTA that is running or done. Each publishes its
//    aggregate without waiting for anything, so every look-back ends:
//    forward progress needs no co-residency;
//  - the tile is kLitSteps steps of kLitStep positions, kLitPer
//    consecutive ones a thread, in groups of 8 (8 bytes of chosen and of
//    blocks, two 16-byte loads of mlen), each step's loads issued before
//    the step before it is scanned;
//  - a step: the running maximum of the clamped ends in registers, the
//    threads' maxima by warp shuffles and one shared-memory step, and the
//    keys (16-byte stores) from the maximum over the tile's earlier steps
//    and a lower bound b on the carry: the previous tile's bound word,
//    read a step earlier. After each step a tile posts max(its running
//    maximum, b) as its bound, so a match that covers many tiles reaches
//    the next ones while they store, not after;
//  - then warp 0 publishes the tile's aggregate (with b), looks back 32
//    predecessors a step, waiting until none of them is empty, to the
//    nearest one holding an inclusive prefix, and publishes the
//    tile's inclusive prefix. The carry c from the earlier tiles covers
//    exactly the positions of the tile below c: each thread rewrites as
//    0xFFFFFFFF those it stored as literals (at or past the step's b), 16
//    bytes a store where it can (the thread wrote them: program order
//    orders the two stores).
// ---------------------------------------------------------------------------

constexpr int kLitThreads = 256;
constexpr int kLitPer = 8;      // positions a thread a step
constexpr int kLitSteps = 16;   // steps a tile
constexpr int kLitGroups = kLitPer / 8;  // groups of 8 positions
constexpr int kLitStep = kLitThreads * kLitPer;
constexpr int kLitTile = kLitStep * kLitSteps;
constexpr int kWarps = kLitThreads / 32;
// A tile's bound word leads a line of its own (kLitBoundStride words):
// the tiles of a row post and read them every step, and on the card words
// that shared lines made the kernel 2.3 times slower.
constexpr int kLitBoundStride = 32;
constexpr uint32_t kValueMask = (1u << 30) - 1;
constexpr uint32_t kPartial = 1u << 30;
constexpr uint32_t kAggregate = 2u << 30;
constexpr uint32_t kPrefix = 3u << 30;

// The status words. Each carries its value in the word that carries its
// flag, so a reader that sees the flag sees the value; kLitOrdered picks
// acquire loads and release stores (ld.acquire.gpu / st.release.gpu)
// over relaxed ones for the status words. The bound words are hints,
// posted and peeked with relaxed ones (no fence a step).
constexpr bool kLitOrdered = true;

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
    uint32_t v;
    if constexpr (kLitOrdered) {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v) : "l"(p) : "memory");
    } else {
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                     : "=r"(v) : "l"(p) : "memory");
    }
    return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
    if constexpr (kLitOrdered) {
        asm volatile("st.release.gpu.global.u32 [%0], %1;"
                     :: "l"(p), "r"(v) : "memory");
    } else {
        asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
                     :: "l"(p), "r"(v) : "memory");
    }
}

__device__ __forceinline__ uint32_t peek_bound(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ void post_bound(uint32_t* p, uint32_t v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v));
}

// The inclusive prefix maximum of the tiles before `tile` in its row
// (`st` the row's status words), by the calling warp; every lane gets it.
__device__ __forceinline__ int look_back(const uint32_t* st, int tile) {
    const int lane = threadIdx.x & 31;
    int carry = 0;
    for (int top = tile - 1;; top -= 32) {
        const int t = top - lane;
        uint32_t s;
        do {  // before the row's first tile: the prefix 0
            s = t >= 0 ? load_status(st + t) : kPrefix;
        } while (__any_sync(0xFFFFFFFFu, s < kAggregate));
        const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, s >= kPrefix);
        // Lanes up to the nearest prefix count; without one, all 32.
        const int last = prefixes ? __ffs(prefixes) - 1 : 31;
        int v = lane <= last ? int(s & kValueMask) : 0;
        for (int d = 16; d > 0; d >>= 1)
            v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
        carry = max(carry, v);
        if (prefixes) return carry;
    }
}

// One thread's positions p..p + kLitPer - 1 of a step, as loaded; `at`
// is the row's offset plus p.
struct LitStep {
    uint2 ch[kLitGroups], by[kLitGroups];  // chosen flags, bytes
    int4 ml[2 * kLitGroups];               // match lengths
};

__device__ __forceinline__ void load_step(LitStep& d, const uint8_t* blocks,
                                          const uint8_t* chosen,
                                          const int32_t* mlen, size_t at,
                                          int p, int n) {
#pragma unroll
    for (int g = 0; g < kLitGroups; ++g) {
        if (p + 8 * g < n) {
            d.ch[g] = __ldg(reinterpret_cast<const uint2*>(chosen + at) + g);
            d.by[g] = __ldg(reinterpret_cast<const uint2*>(blocks + at) + g);
            const int4* m = reinterpret_cast<const int4*>(mlen + at);
            d.ml[2 * g] = __ldg(m + 2 * g);
            d.ml[2 * g + 1] = __ldg(m + 2 * g + 1);
        } else {
            d.ch[g] = d.by[g] = make_uint2(0, 0);
            d.ml[2 * g] = d.ml[2 * g + 1] = make_int4(0, 0, 0, 0);
        }
    }
}

__global__ void __launch_bounds__(kLitThreads)
literal_keys_kernel(const uint8_t* __restrict__ blocks,
                    const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ chosen,
                    const int32_t* __restrict__ mlen,
                    uint32_t* __restrict__ status,
                    uint32_t* __restrict__ bounds,
                    uint32_t* __restrict__ counter,
                    uint32_t* __restrict__ keys, int n, int ntiles) {
    __shared__ int warp_max[2][kWarps];  // by step parity
    __shared__ int step_lb[kLitSteps];   // each step's bound on the carry
    __shared__ int shared_int;           // the tile index, then the carry
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) shared_int = int(atomicAdd(counter, 1u));
    __syncthreads();
    const int vid = shared_int;
    const int row = vid / ntiles;
    const int tile = vid - row * ntiles;
    const int base = tile * kLitTile;  // the tile's first position
    const size_t row_at = size_t(row) * n;
    uint32_t* st = status + size_t(row) * ntiles;
    const int blen = __ldg(lengths + row);
    const int p0 = base + kLitPer * int(threadIdx.x);
    LitStep cur;
    load_step(cur, blocks, chosen, mlen, row_at + p0, p0, n);
    // Thread 0 reads the previous tile's bound a step before it uses the
    // value, and posts this tile's.
    uint32_t* own = bounds + size_t(vid) * kLitBoundStride;  // this tile's
    const uint32_t* left = tile > 0 ? own - kLitBoundStride : own;
    uint32_t prev = tile > 0 && threadIdx.x == 0 ? peek_bound(left) : 0u;
    int lb = 0;  // thread 0's lower bound on the carry
    int step_bound = 0;  // the bound of the last step, in every thread

    int tile_max = 0;  // the largest end of the tile's earlier steps
    for (int j = 0; j < kLitSteps; ++j) {
        const int p = p0 + j * kLitStep;
        const bool more = j + 1 < kLitSteps && base + (j + 1) * kLitStep < n;
        LitStep nxt;  // the next step's loads, in flight during this one
        if (more)
            load_step(nxt, blocks, chosen, mlen, row_at + p + kLitStep,
                      p + kLitStep, n);

        // The running maximum of the clamped ends in registers.
        int run[kLitPer];
#pragma unroll
        for (int k = 0; k < kLitPer; ++k) {
            const uint2 c = cur.ch[k / 8];
            const int4 m4 = cur.ml[k / 4];
            const int m = (k & 3) == 0 ? m4.x : (k & 3) == 1 ? m4.y
                        : (k & 3) == 2 ? m4.z : m4.w;
            const uint32_t word = (k & 4) ? c.y : c.x;
            const bool chosen_k = (word >> (8 * (k & 3))) & 0xFFu;
            const int end = chosen_k ? min(p + k + min(max(m, 0), n), n) : 0;
            run[k] = k ? max(run[k - 1], end) : end;
        }
        // Exclusive prefix maximum of the threads' last entries.
        int incl = run[kLitPer - 1];
        for (int s = 1; s < 32; s <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, s);
            if (lane >= s) incl = max(incl, v);
        }
        if (lane == 31) warp_max[j & 1][warp] = incl;
        if (threadIdx.x == 0) {
            if (prev >= kPartial) lb = max(lb, int(prev & kValueMask));
            step_lb[j] = lb;
            if (more && tile > 0) prev = peek_bound(left);
        }
        int excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
        if (lane == 0) excl = 0;
        __syncthreads();
        int step_max = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int v = warp_max[j & 1][w];
            if (w < warp) excl = max(excl, v);
            step_max = max(step_max, v);
        }
        step_bound = step_lb[j];
        const int before = max(max(tile_max, excl), step_bound);
        tile_max = max(tile_max, step_max);
        if (threadIdx.x == 0 && more)  // a bound for the next tile
            post_bound(own, kPartial | max(tile_max, step_bound));

#pragma unroll
        for (int g = 0; g < kLitGroups; ++g) {
            if (p + 8 * g >= n) break;
            uint32_t out[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int k = 8 * g + q;
                const int i = p + k;
                const bool lit = max(before, run[k]) <= i && i < blen;
                const uint32_t word = q < 4 ? cur.by[g].x : cur.by[g].y;
                const uint32_t byte = (word >> (8 * (q & 3))) & 0xFFu;
                out[q] = lit ? (uint32_t(i) << 8) | byte : kEmpty;
            }
            uint4* dst = reinterpret_cast<uint4*>(keys + row_at + p + 8 * g);
            dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
            dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
        }
        if (!more) break;
        cur = nxt;
    }

    // The carry from the earlier tiles of the row.
    if (warp == 0) {
        int carry = 0;
        if (tile > 0) {
            if (lane == 0)
                store_status(st + tile,
                             kAggregate | max(tile_max, step_bound));
            carry = look_back(st, tile);
        }
        if (lane == 0) {
            store_status(st + tile, kPrefix | max(carry, tile_max));
            shared_int = carry;
        }
    }
    __syncthreads();
    // Rewrite this thread's literals below the carry: in step j those at
    // or past step_lb[j], which were stored as literals.
    const int carry = min(shared_int, min(base + kLitTile, n));
    const uint4 empty = make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
    for (int j = 0; base + j * kLitStep < carry; ++j) {
        const int p = p0 + j * kLitStep;
        const int lo = step_lb[j];
#pragma unroll
        for (int g = 0; g < kLitGroups; ++g) {
            const int q = p + 8 * g;
            if (q >= lo && q + 8 <= carry) {
                uint4* dst = reinterpret_cast<uint4*>(keys + row_at + q);
                dst[0] = empty;
                dst[1] = empty;
            } else {
                for (int k = max(q, lo); k < min(q + 8, carry); ++k)
                    keys[row_at + k] = kEmpty;
            }
        }
    }
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
                    const void* chosen, const void* mlen, void* scratch,
                    void* keys, int rows, int n, void* stream) {
    if (n >= (1 << 29) || n % 8) return int(cudaErrorInvalidValue);
    if (rows <= 0 || n <= 0) return int(cudaSuccess);
    auto s = static_cast<cudaStream_t>(stream);
    const int ntiles = (n + kLitTile - 1) / kLitTile;
    const long long tiles = (long long)rows * ntiles;
    if (tiles > INT_MAX) return int(cudaErrorInvalidValue);
    // The status words, the bound words, the counter.
    const size_t words = size_t(tiles) * (1 + kLitBoundStride);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, (words + 1) * 4, s);
    if (err != cudaSuccess) return int(err);
    auto* status = static_cast<uint32_t*>(scratch);
    literal_keys_kernel<<<unsigned(tiles), kLitThreads, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths),
        static_cast<const uint8_t*>(chosen),
        static_cast<const int32_t*>(mlen), status, status + tiles,
        status + words,
        static_cast<uint32_t*>(keys), n, ntiles);
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
