// Hopper kernels of the device FSE sequence sections (hybrid device
// entropy, every level).
//
// B14, the FSE encoder state machine, replaces the Pallas kernel
// qat_zstd_plugin_tpu.ops.fse_kernel._make_state_kernel /
// _run_state_kernel. Its plain PyTorch twin is run_state_kernel_twin in
// qat_zstd_plugin_tpu_torch/ops/fse_kernel.py; the wrapper beside it
// checks shapes and dtypes, allocates the outputs and the scratch and
// calls this entry point through ctypes.
//
// Interface: as in l1_kernels.cu, the entry point takes device pointers,
// sizes and the CUDA stream (PyTorch's current stream), launches on that
// stream, allocates nothing, and returns cudaGetLastError(). It refuses
// (cudaErrorInvalidValue) a piece longer than kMaxPiece and scratch
// smaller than its kMapStride-byte maps need.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B14 the FSE state machine of the LL, OF and ML streams.
//
// Per step, for 1 <= j < nseq: OF, then ML, then LL, nb = (s + dnb[code])
// >> 16 bits of the state s go out and s <- st[(s >> nb) + dfs[code]]; the
// three bit fields form one item, lowest first. Step nseq writes the flush
// item (ml & 63 | (of & 31) << 6 | (ll & 63) << 11, 17 bits); every other
// step an empty one. A lookup outside its table reads 0, as the
// reference's one-hot lookup does.
//
// What bounds it on the H100. The bytes (three code planes read, two item
// planes written: 20 bytes a step and block) take microseconds at 3.35
// TB/s, but each block is a serial chain of up to S+1 dependent steps. The
// first port walked each chain with one thread (64 threads on 2 SMs at
// B=64): 3.7 ms, about 440 cycles a step.
//
// The design splits every chain exactly. A stream's state after an active
// step is an entry of its state table or 0 (a lookup outside the table),
// and before the first active step it is the initial state: so a stream
// enters any stretch of steps in one of size + 2 ways, entry e < size
// meaning st[e], e == size meaning 0, e == size + 1 the initial state (66
// for LL and ML, 34 for OF). The steps are cut into pieces of L (the
// wrapper's PIECE):
//   (a) fse_maps_kernel: for every (block, stream, piece, entry) a
//       thread walks the piece's active steps and records the exit entry
//       (maps, one byte each). A CTA takes 4 blocks and 4 pieces: it
//       stages the blocks' tables in shared memory, turns the pieces'
//       codes into (dnb, dfs) pairs once, and each thread walks its 4
//       pieces in lockstep (4 independent chains). The threads of one
//       (block, stream) read the same pair (a broadcast); only the
//       state-table read differs between them. A step has no branch: a
//       lookup outside a table clamps to the zero row after it, and a
//       block's wholly active pieces (all but its first and last) check
//       no step range. Work: 166 table steps per
//       active step of a block (the design's operation floor), over
//       (P/4 x B/4) CTAs, which fill the card at B=64.
//   (b) fse_chain_kernel: for every (block, stream), from the initial
//       state's entry, follow the maps piece to piece (P = ceil((S+1)/L)
//       lookups in shared memory instead of S+1 dependent steps) and record
//       each piece's entry.
//   (c) fse_emit_kernel: for every (block, piece) one thread walks the L
//       steps from the three known entry states and writes lo and nb as
//       the one-thread walk did, reading 8 steps' codes ahead; a CTA takes
//       8 blocks x 16 pieces, so a warp's reads and writes of one step are
//       4 runs of 8 neighbouring columns. Steps past the block's flush
//       read no codes.
// Pieces with no active step are skipped in (a) and pass their entry on
// unchanged in (b).
// ---------------------------------------------------------------------------

constexpr int kRowsLL = 64, kRowsOF = 32, kRowsML = 64;  // symbol rows
constexpr int kSizeLL = 64, kSizeOF = 32, kSizeML = 64;  // state tables
// Table offsets, in rows: dnb, dfs, st per stream, LL, OF, ML. A zero row
// follows each state table: the state of a lookup outside it.
constexpr int kDnbLL = 0, kDfsLL = kDnbLL + kRowsLL, kStLL = kDfsLL + kRowsLL;
constexpr int kDnbOF = kStLL + kSizeLL + 1, kDfsOF = kDnbOF + kRowsOF;
constexpr int kStOF = kDfsOF + kRowsOF;
constexpr int kDnbML = kStOF + kSizeOF + 1, kDfsML = kDnbML + kRowsML;
constexpr int kStML = kDfsML + kRowsML;
constexpr int kTableRows = kStML + kSizeML + 1;  // 483
constexpr int kMapStride = 68;    // bytes of a map: 66 entries, padded
constexpr int kMaxPiece = 64;     // steps of a piece
constexpr int kMapBlocks = 4;     // blocks of a maps CTA
constexpr int kMapPieces = 4;     // pieces of a maps CTA, walked in turn
constexpr int kMapWalkers = 192;  // threads of one block: 66 + 34 + 66 used
constexpr int kChainPieces = 64;  // maps a chain CTA stages at once
constexpr int kChainThreads = 256;
constexpr int kEmitBlocks = 8;    // blocks of an emit CTA
constexpr int kEmitPieces = 16;   // pieces of an emit CTA

struct FseArgs {
    const int32_t* codes[3];   // LL, OF, ML: (S1, B)
    const int32_t* tables[9];  // per stream dnb, dfs, st: (rows, B)
    const int32_t* init[3];    // (B,)
    const int32_t* nseq;       // (B,)
    int32_t* lo;               // (S1, B)
    int32_t* nb;               // (S1, B)
    uint8_t* maps;             // (B, 3, P, kMapStride)
    uint8_t* entries;          // (B, 3, P)
};

struct Stream {
    int dnb, dfs, st, rows, size;  // table offsets and extents
};

__device__ __forceinline__ Stream stream_of(int k) {
    if (k == 0) return {kDnbLL, kDfsLL, kStLL, kRowsLL, kSizeLL};
    if (k == 1) return {kDnbOF, kDfsOF, kStOF, kRowsOF, kSizeOF};
    return {kDnbML, kDfsML, kStML, kRowsML, kSizeML};
}

// Copies the nine tables of blocks b0 .. b0 + W - 1 to tab[row][W]
// (zero past the batch and in the rows after the state tables), row in
// the order of the offsets above.
template <int W>
__device__ __forceinline__ void load_tables(const FseArgs& a, int32_t* tab,
                                            int b0, int nblocks) {
    const int first[9] = {kDnbLL, kDfsLL, kStLL, kDnbOF, kDfsOF, kStOF,
                          kDnbML, kDfsML, kStML};
    const int rows[9] = {kRowsLL, kRowsLL, kSizeLL, kRowsOF, kRowsOF,
                         kSizeOF, kRowsML, kRowsML, kSizeML};
#pragma unroll 4
    for (int i = threadIdx.x; i < kTableRows * W; i += blockDim.x) {
        const int row = i / W, b = b0 + i % W;
        int t = 8;
        while (row < first[t]) --t;
        const int r = row - first[t];
        tab[i] = b < nblocks && r < rows[t]
                     ? a.tables[t][size_t(r) * nblocks + b]
                     : 0;
    }
}

// The active steps of piece p: [max(p*L, 1), min(p*L + L, nseq, S1)).
__device__ __forceinline__ void active_range(int p, int piece, int n, int s1,
                                             int& lo, int& hi) {
    lo = max(p * piece, 1);
    hi = min(min(p * piece + piece, n), s1);
}

// One stream's active step with the code's dnb and dfs, on the tables of
// column `col` of W: returns the bits to emit, sets their count, advances
// the state and sets `entry` to the state's entry (size for a lookup
// outside the table).
template <int W>
__device__ __forceinline__ int advance(const int32_t* tab, int col,
                                       const Stream& t, int dnb, int dfs,
                                       int& state, int& nbits, int& entry) {
    const int nb = (state + dnb) >> 16;
    const int bits = state & ((1 << nb) - 1);
    // Outside the table (below 0 or past it) is entry size, the zero row.
    const unsigned at =
        min(unsigned((state >> nb) + dfs), unsigned(t.size));
    state = tab[(t.st + int(at)) * W + col];
    entry = int(at);
    nbits = nb;
    return bits;
}

// The code's (dnb, dfs); (0, 0) outside the table.
template <int W>
__device__ __forceinline__ int2 symbol(const int32_t* tab, int col,
                                       const Stream& t, int code) {
    return code >= 0 && code < t.rows
               ? make_int2(tab[(t.dnb + code) * W + col],
                           tab[(t.dfs + code) * W + col])
               : make_int2(0, 0);
}

// The state an entry stands for.
template <int W>
__device__ __forceinline__ int entry_state(const int32_t* tab, int col,
                                           const Stream& t, int e, int init) {
    return e < t.size ? tab[(t.st + e) * W + col] : e == t.size ? 0 : init;
}

// A maps thread's kMapPieces pieces, walked in lockstep (independent
// chains); kChecked skips the steps outside each piece's active range,
// which only a block's first and last pieces have.
template <bool kChecked, int W>
__device__ __forceinline__ void walk_pieces(const int2 (*sym)[W],
                                            const int32_t* tab, int col,
                                            const Stream& t, int piece,
                                            int p0, const int* lo,
                                            const int* hi, int* state,
                                            int* entry) {
    for (int i = 0; i < piece; ++i) {
#pragma unroll
        for (int g = 0; g < kMapPieces; ++g) {
            const int j = (p0 + g) * piece + i;
            if (kChecked && (j < lo[g] || j >= hi[g])) continue;
            const int2 v = sym[g * piece + i][col];
            int nbits;
            advance<W>(tab, col, t, v.x, v.y, state[g], nbits, entry[g]);
        }
    }
}

// (a) grid (ceil(P / kMapPieces), ceil(B / kMapBlocks)), kMapBlocks *
// kMapWalkers threads. The CTA first turns the active steps' codes into
// (dnb, dfs) pairs in shared memory, so a walker's step reads one
// broadcast pair and one state-table word.
__global__ void __launch_bounds__(kMapBlocks * kMapWalkers)
fse_maps_kernel(FseArgs a, int s1, int nblocks, int piece, int npieces) {
    constexpr int W = kMapBlocks;
    __shared__ int32_t tab[kTableRows * W];
    __shared__ int2 sym[3][kMapPieces * kMaxPiece][W];
    const int p0 = blockIdx.x * kMapPieces, b0 = blockIdx.y * W;
    const int j0 = p0 * piece;
    const int steps = min(kMapPieces * piece, s1 - j0);
    load_tables<W>(a, tab, b0, nblocks);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * steps * W; i += blockDim.x) {
        const int k = i / (steps * W), rest = i % (steps * W);
        const int c = rest % W, j = j0 + rest / W, b = b0 + c;
        int2 v = make_int2(0, 0);
        if (b < nblocks && j >= 1 && j < a.nseq[b])
            v = symbol<W>(tab, c, stream_of(k),
                          a.codes[k][size_t(j) * nblocks + b]);
        sym[k][rest / W][c] = v;
    }
    __syncthreads();
    const int col = threadIdx.x / kMapWalkers;
    const int r = threadIdx.x % kMapWalkers;
    const int b = b0 + col;
    const int k = r < kSizeLL + 2 ? 0 : r < kSizeLL + kSizeOF + 4 ? 1 : 2;
    const int e = k == 0 ? r : k == 1 ? r - (kSizeLL + 2)
                                      : r - (kSizeLL + kSizeOF + 4);
    if (b >= nblocks || (k == 2 && e >= kSizeML + 2)) return;
    const int n = a.nseq[b], init = a.init[k][b];
    const Stream t = stream_of(k);
    // The CTA's pieces in lockstep: kMapPieces independent chains a thread.
    // Where every piece is wholly active (the same for a block's walkers,
    // whole warps), the walk checks no step.
    int lo[kMapPieces], hi[kMapPieces], state[kMapPieces], entry[kMapPieces];
    bool whole = true;
#pragma unroll
    for (int g = 0; g < kMapPieces; ++g) {
        active_range(p0 + g, piece, n, s1, lo[g], hi[g]);
        if (p0 + g >= npieces) hi[g] = lo[g];
        whole &= lo[g] == (p0 + g) * piece && hi[g] == lo[g] + piece;
        state[g] = entry_state<W>(tab, col, t, e, init);
        entry[g] = e;
    }
    if (whole)
        walk_pieces<false, W>(sym[k], tab, col, t, piece, p0, lo, hi, state,
                              entry);
    else
        walk_pieces<true, W>(sym[k], tab, col, t, piece, p0, lo, hi, state,
                             entry);
#pragma unroll
    for (int g = 0; g < kMapPieces; ++g) {
        if (lo[g] < hi[g])  // else no active step: (b) passes the entry on
            a.maps[((size_t(b) * 3 + k) * npieces + p0 + g) * kMapStride +
                   e] = uint8_t(entry[g]);
    }
}

// (b) one CTA per block; lane 0 of warp k chains stream k through maps
// staged kChainPieces at a time with 4-byte loads (the maps of pieces
// without an active step were never written and are never read).
__global__ void __launch_bounds__(kChainThreads)
fse_chain_kernel(FseArgs a, int s1, int nblocks, int piece, int npieces) {
    constexpr int kWords = kMapStride / 4;
    __shared__ uint32_t staged[3][kChainPieces * kWords];
    const int b = blockIdx.x;
    const int n = a.nseq[b];
    const int k = threadIdx.x / 32;
    int e = (k == 1 ? kSizeOF : kSizeLL) + 1;  // the initial state's entry
    const auto maps = reinterpret_cast<const uint32_t*>(a.maps);
    for (int p0 = 0; p0 < npieces; p0 += kChainPieces) {
        const int m = min(kChainPieces, npieces - p0);
        __syncthreads();
        for (int i = threadIdx.x; i < 3 * m * kWords; i += blockDim.x) {
            const int kk = i / (m * kWords), rest = i % (m * kWords);
            staged[kk][rest] =
                maps[((size_t(b) * 3 + kk) * npieces + p0) * kWords + rest];
        }
        __syncthreads();
        if (k < 3 && threadIdx.x % 32 == 0) {
            const auto bytes = reinterpret_cast<const uint8_t*>(staged[k]);
            for (int i = 0; i < m; ++i) {
                a.entries[(size_t(b) * 3 + k) * npieces + p0 + i] =
                    uint8_t(e);
                int lo, hi;
                active_range(p0 + i, piece, n, s1, lo, hi);
                if (lo < hi) e = bytes[i * kMapStride + e];
            }
        }
    }
}

// (c) grid (ceil(P / kEmitPieces), ceil(B / kEmitBlocks)). A thread reads
// the codes of kAhead steps at once, then walks them.
__global__ void __launch_bounds__(kEmitBlocks * kEmitPieces)
fse_emit_kernel(FseArgs a, int s1, int nblocks, int piece, int npieces) {
    constexpr int W = kEmitBlocks;
    constexpr int kAhead = 8;
    __shared__ int32_t tab[kTableRows * W];
    const int b0 = blockIdx.y * W;
    load_tables<W>(a, tab, b0, nblocks);
    __syncthreads();
    const int col = threadIdx.x % W;
    const int b = b0 + col;
    const int p = blockIdx.x * kEmitPieces + threadIdx.x / W;
    if (b >= nblocks || p >= npieces) return;
    const int n = a.nseq[b];
    const Stream sll = stream_of(0), sof = stream_of(1), sml = stream_of(2);
    const uint8_t* ent = a.entries + size_t(b) * 3 * npieces + p;
    int st_ll = entry_state<W>(tab, col, sll, ent[0], a.init[0][b]);
    int st_of = entry_state<W>(tab, col, sof, ent[npieces], a.init[1][b]);
    int st_ml = entry_state<W>(tab, col, sml, ent[2 * npieces], a.init[2][b]);
    const int j_end = min(p * piece + piece, s1);
    for (int j0 = p * piece; j0 < j_end; j0 += kAhead) {
        int c[3][kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
            const int j = j0 + i;
            const bool act = j < j_end && j >= 1 && j < n;
            for (int k = 0; k < 3; ++k)
                c[k][i] = act ? a.codes[k][size_t(j) * nblocks + b] : 0;
        }
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
            const int j = j0 + i;
            if (j >= j_end) break;
            int lo = 0, nb = 0;
            if (j >= 1 && j < n) {
                int n_of, n_ml, n_ll, unused;
                const int2 y_of = symbol<W>(tab, col, sof, c[1][i]);
                const int2 y_ml = symbol<W>(tab, col, sml, c[2][i]);
                const int2 y_ll = symbol<W>(tab, col, sll, c[0][i]);
                const int b_of = advance<W>(tab, col, sof, y_of.x, y_of.y,
                                            st_of, n_of, unused);
                const int b_ml = advance<W>(tab, col, sml, y_ml.x, y_ml.y,
                                            st_ml, n_ml, unused);
                const int b_ll = advance<W>(tab, col, sll, y_ll.x, y_ll.y,
                                            st_ll, n_ll, unused);
                lo = b_of | (b_ml << n_of) | (b_ll << (n_of + n_ml));
                nb = n_of + n_ml + n_ll;
            } else if (j == n) {
                lo = (st_ml & 63) | ((st_of & 31) << 6) |
                     ((st_ll & 63) << 11);
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
                 void* maps, void* entries, int s1, int nblocks, int piece,
                 int npieces, size_t maps_bytes, size_t entries_bytes,
                 void* stream) {
    // The wrapper sizes the scratch and picks the piece; both are held to
    // this file's kMapStride and kMaxPiece here.
    const size_t maps_needed = size_t(nblocks) * 3 * npieces;
    if (piece < 1 || piece > kMaxPiece ||
        (long long)npieces * piece < s1 || (npieces - 1) * piece >= s1 ||
        maps_bytes < maps_needed * kMapStride || entries_bytes < maps_needed)
        return int(cudaErrorInvalidValue);
    auto p = [](const void* x) { return static_cast<const int32_t*>(x); };
    const FseArgs a = {
        {p(c_ll), p(c_of), p(c_ml)},
        {p(dnb_ll), p(dfs_ll), p(st_ll), p(dnb_of), p(dfs_of), p(st_of),
         p(dnb_ml), p(dfs_ml), p(st_ml)},
        {p(init_ll), p(init_of), p(init_ml)},
        p(nseq), static_cast<int32_t*>(lo), static_cast<int32_t*>(nb),
        static_cast<uint8_t*>(maps), static_cast<uint8_t*>(entries)};
    const auto s = static_cast<cudaStream_t>(stream);
    fse_maps_kernel<<<dim3((npieces + kMapPieces - 1) / kMapPieces,
                           (nblocks + kMapBlocks - 1) / kMapBlocks),
                      kMapBlocks * kMapWalkers, 0, s>>>(a, s1, nblocks, piece,
                                                        npieces);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    fse_chain_kernel<<<nblocks, kChainThreads, 0, s>>>(a, s1, nblocks, piece, npieces);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    fse_emit_kernel<<<dim3((npieces + kEmitPieces - 1) / kEmitPieces,
                           (nblocks + kEmitBlocks - 1) / kEmitBlocks),
                      kEmitBlocks * kEmitPieces, 0, s>>>(a, s1, nblocks, piece,
                                                         npieces);
    return int(cudaGetLastError());
}

}  // extern "C"
