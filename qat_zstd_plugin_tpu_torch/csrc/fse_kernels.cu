// Hopper kernel of the device FSE sequence sections (hybrid device
// entropy, every level).
//
// B14, the FSE encoder state machine, replaces the Pallas kernel
// qat_zstd_plugin_tpu.ops.fse_kernel._make_state_kernel /
// _run_state_kernel. Its plain PyTorch twin is run_state_kernel_twin in
// qat_zstd_plugin_tpu_torch/ops/fse_kernel.py; the wrapper beside it
// checks shapes and dtypes, allocates the outputs and launches this entry
// point through ctypes.
//
// Interface: as in l1_kernels.cu, the entry point takes device pointers,
// sizes and the CUDA stream (PyTorch's current stream), launches on that
// stream, allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B14 the FSE state machine of the LL, OF and ML streams.
//
// FSE is a serial chain per block: step j's state is the table entry
// that step j-1's state and symbol pick. The TPU kernel puts the batch on
// its lanes and walks the steps with one-hot table lookups; here one
// thread walks one block's steps, a warp takes 32 blocks, and the
// reference's (S+1, B) layout (steps on rows, blocks on columns) makes a
// warp's reads of the codes and its writes of the items one coalesced
// 128-byte row per step. The block's nine tables (dnb and dfs per symbol,
// the state table, for LL, OF and ML: 480 words, 1920 bytes) sit in
// shared memory as [row][lane], so each thread's lookups hit its own bank.
// The codes go through shared memory too, kChunk steps at a time: each
// thread first copies its own column of the chunk (independent loads, many
// in flight), so the chain then waits on shared memory, not on a
// device-memory load per step. Steps past the block's flush read no codes.
//
// Per step, for 1 <= j < nseq: OF, then ML, then LL, nb = (s + dnb[code])
// >> 16 bits of the state s go out and s <- st[(s >> nb) + dfs[code]]; the
// three bit fields form one item, lowest first. Step nseq writes the flush
// item (ml & 63 | (of & 31) << 6 | (ll & 63) << 11, 17 bits); every other
// step an empty one. A lookup outside its table reads 0, as the
// reference's one-hot lookup does.
//
// Bound: the serial chain. The bytes (three code planes read, two item
// planes written: 20 bytes a step and block) take microseconds at 3.35
// TB/s; the chain of the block with the most sequences, a few dependent
// shared-memory reads a step, sets the time. Splitting that chain is a
// later change.
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;                   // blocks per CTA
constexpr int kRowsLL = 64, kRowsOF = 32, kRowsML = 64;  // symbol rows
constexpr int kSizeLL = 64, kSizeOF = 32, kSizeML = 64;  // state tables
// Shared-memory table offsets, in rows of kLanes words.
constexpr int kDnbLL = 0, kDfsLL = kDnbLL + kRowsLL, kStLL = kDfsLL + kRowsLL;
constexpr int kDnbOF = kStLL + kSizeLL, kDfsOF = kDnbOF + kRowsOF;
constexpr int kStOF = kDfsOF + kRowsOF;
constexpr int kDnbML = kStOF + kSizeOF, kDfsML = kDnbML + kRowsML;
constexpr int kStML = kDfsML + kRowsML;
constexpr int kTableRows = kStML + kSizeML;  // 480
constexpr int kChunk = 64;                   // steps of codes staged at once
constexpr size_t kFseSmem = size_t(kTableRows + 3 * kChunk) * kLanes * 4;

struct FseArgs {
    const int32_t* codes[3];   // LL, OF, ML: (S1, B)
    const int32_t* tables[9];  // per stream dnb, dfs, st: (rows, B)
    const int32_t* init[3];    // (B,)
    const int32_t* nseq;       // (B,)
    int32_t* lo;               // (S1, B)
    int32_t* nb;               // (S1, B)
};

struct Stream {
    int dnb, dfs, st, rows, size;  // table offsets and extents
};

// One stream's active step: returns the bits to emit, sets their count
// and advances the state.
__device__ __forceinline__ int fse_step(const int32_t* tab, int lane,
                                        const Stream& t, int code,
                                        int& state, int& nbits) {
    const bool known = code >= 0 && code < t.rows;
    const int dnb = known ? tab[(t.dnb + code) * kLanes + lane] : 0;
    const int dfs = known ? tab[(t.dfs + code) * kLanes + lane] : 0;
    const int nb = (state + dnb) >> 16;
    const int bits = state & ((1 << nb) - 1);
    const int at = (state >> nb) + dfs;
    state = at >= 0 && at < t.size ? tab[(t.st + at) * kLanes + lane] : 0;
    nbits = nb;
    return bits;
}

__global__ void __launch_bounds__(kLanes)
fse_state_kernel(FseArgs a, int s1, int nblocks) {
    extern __shared__ int32_t tab[];  // [kTableRows][kLanes], then the codes
    int32_t* staged = tab + kTableRows * kLanes;  // [3][kChunk][kLanes]
    const int lane = threadIdx.x;
    const int b0 = blockIdx.x * kLanes;
    const int b = b0 + lane;
    const int offs[9] = {kDnbLL, kDfsLL, kStLL, kDnbOF, kDfsOF, kStOF,
                         kDnbML, kDfsML, kStML};
    const int rows[9] = {kRowsLL, kRowsLL, kSizeLL, kRowsOF, kRowsOF,
                         kSizeOF, kRowsML, kRowsML, kSizeML};
    for (int t = 0; t < 9; ++t) {
        for (int r = 0; r < rows[t]; ++r) {
            tab[(offs[t] + r) * kLanes + lane] =
                b < nblocks ? a.tables[t][size_t(r) * nblocks + b] : 0;
        }
    }
    __syncthreads();
    if (b >= nblocks) return;
    const Stream sll = {kDnbLL, kDfsLL, kStLL, kRowsLL, kSizeLL};
    const Stream sof = {kDnbOF, kDfsOF, kStOF, kRowsOF, kSizeOF};
    const Stream sml = {kDnbML, kDfsML, kStML, kRowsML, kSizeML};
    int st_ll = a.init[0][b], st_of = a.init[1][b], st_ml = a.init[2][b];
    const int n = a.nseq[b];
    // Column `lane` of stream k's staged codes, step i of the chunk.
    auto code = [&](int k, int i) {
        return staged[(k * kChunk + i) * kLanes + lane];
    };
    for (int j0 = 0; j0 < s1; j0 += kChunk) {
        const int steps = min(kChunk, s1 - j0);
        const int need = min(steps, n - j0);  // active steps' codes only
        for (int i = 0; i < need; ++i) {
            const size_t at = size_t(j0 + i) * nblocks + b;
            for (int k = 0; k < 3; ++k)
                staged[(k * kChunk + i) * kLanes + lane] = a.codes[k][at];
        }
        for (int i = 0; i < steps; ++i) {
            const int j = j0 + i;
            int lo = 0, nb = 0;
            if (j >= 1 && j < n) {
                int n_of, n_ml, n_ll;
                const int b_of = fse_step(tab, lane, sof, code(1, i), st_of,
                                          n_of);
                const int b_ml = fse_step(tab, lane, sml, code(2, i), st_ml,
                                          n_ml);
                const int b_ll = fse_step(tab, lane, sll, code(0, i), st_ll,
                                          n_ll);
                lo = b_of | (b_ml << n_of) | (b_ll << (n_of + n_ml));
                nb = n_of + n_ml + n_ll;
            } else if (j == n) {
                lo = (st_ml & 63) | ((st_of & 31) << 6) | ((st_ll & 63) << 11);
                nb = 17;
            }
            const size_t at = size_t(j) * nblocks + b;
            a.lo[at] = lo;
            a.nb[at] = nb;
        }
    }
}

}  // namespace

extern "C" {

int qz_fse_state(const void* c_ll, const void* c_of, const void* c_ml,
                 const void* dnb_ll, const void* dfs_ll, const void* st_ll,
                 const void* dnb_of, const void* dfs_of, const void* st_of,
                 const void* dnb_ml, const void* dfs_ml, const void* st_ml,
                 const void* init_ll, const void* init_of,
                 const void* init_ml, const void* nseq, void* lo, void* nb,
                 int s1, int nblocks, void* stream) {
    auto p = [](const void* x) { return static_cast<const int32_t*>(x); };
    const FseArgs a = {
        {p(c_ll), p(c_of), p(c_ml)},
        {p(dnb_ll), p(dfs_ll), p(st_ll), p(dnb_of), p(dfs_of), p(st_of),
         p(dnb_ml), p(dfs_ml), p(st_ml)},
        {p(init_ll), p(init_of), p(init_ml)},
        p(nseq), static_cast<int32_t*>(lo), static_cast<int32_t*>(nb)};
    cudaError_t err = cudaFuncSetAttribute(
        fse_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(kFseSmem));
    if (err != cudaSuccess) return int(err);
    const unsigned grid = unsigned((nblocks + kLanes - 1) / kLanes);
    fse_state_kernel<<<grid, kLanes, kFseSmem,
                       static_cast<cudaStream_t>(stream)>>>(a, s1, nblocks);
    return int(cudaGetLastError());
}

}  // extern "C"
