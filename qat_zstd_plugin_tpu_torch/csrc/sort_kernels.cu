// Hopper kernels of B19 bitonic_sort: a bitonic network over (key, pos)
// rows, carrying any number of int32 payloads.
//
// Replaces qat_zstd_plugin_tpu.ops.sort_kernel.bitonic_sort (Pallas), which
// holds one row in VMEM for the whole network. Its plain PyTorch twin,
// ops/sort_kernel.bitonic_sort_twin, runs the same network; the wrapper
// there checks shapes and dtypes, plans the launches (sort_plan), allocates
// the outputs and calls the entry point below through ctypes.
//
// The order is the reference's: key as unsigned, then pos as signed int32,
// ascending. Stage (k, j) pairs i with i ^ j; the lower element of a pair
// keeps the smaller (key, pos) where (i & k) == 0 and the larger otherwise,
// and a pair swaps only when it is strictly out of order. The network is not
// stable, so when a row holds equal (key, pos) pairs the payloads' order is
// the network's own. The kernels run the same network on (key, pos, idx),
// idx the original column, and the last launch gathers every payload by
// idx straight from shared memory: the reference's permutation for any
// number of payloads. A single payload instead rides through the network
// in idx's place, as the reference carries it, and needs no gather.
//
// What bounds it on the H100. The network does B * N/2 * log2 N * (log2 N
// + 1)/2 compare-exchanges (0.038 ms of int32 work at 64 x 131072), and
// the function must move each element's 12 bytes in and out once (0.060
// ms). The first port ran every stage through shared memory with a
// __syncthreads each, and a row of 131072 (1.5 MiB) did not fit one SM, so
// it made 15 device-memory passes of the whole row: 2.74 ms, 1.7 times
// torch.sort.
//
// The design:
//   * A row of up to 131072 stays on chip in one thread block cluster: 8
//     CTAs of 16384 elements (12 bytes each, 204 KiB with one pad word per
//     16, which keeps the strided register-group loads free of bank
//     conflicts). A stage whose partner i ^ j lies in another CTA (j >=
//     16384) reads the partner through distributed shared memory, and each
//     CTA keeps its own side of every pair; cluster barriers separate the
//     reads from the writes. Shorter rows take one CTA (N <= 16384) or a
//     cluster of 2 or 4.
//   * Every other stage runs in registers: a thread loads 16 elements
//     whose columns differ only in 4 neighbouring bits and runs up to 4
//     consecutive stages of one k on them (the stages whose partner bits
//     are among the 4), so a shared-memory round trip serves 4 stages
//     (all 10 stages of k <= 16 share one). A CTA has 512 threads, each
//     taking two such groups in turn: at 1024 threads the 48 registers of
//     a group spilled.
//   * Index arithmetic is 32-bit shifts and masks (every size is a power
//     of two), and a group's pair directions are one bit mask. Where all
//     of a warp's pairs run one way (every k >= 512, and most smaller
//     ones), the direction is a template argument, so a compare-exchange
//     is one 64-bit compare and its selects.
//   * Rows longer than a cluster (N >= 262144) sort each 131072-element
//     span in its cluster, and then for each k > 131072 run the stages j
//     >= 131072 in device-memory passes, a thread holding the 2^r (r <= 4)
//     elements that r consecutive stages pair among themselves, then one
//     cluster pass for the stages j < 131072 of that k.
// The launches and their stages are planned in Python (sort_plan), where
// the CPU tests check that they cover the network once and in order and
// that each stage pairs only elements that one thread, CTA or cluster
// holds. A plan is a list of launches, each [kind, nsteps, steps...]:
// kind 0 is a cluster launch, 1 a device-memory pass, 2 a launch of
// single CTAs (the stages k <= 16384, which need no cluster, so that the
// scheduler may place every CTA on any SM); a step word is
// op | log2 k << 2 | log2 j << 8 | r << 14, op 0 a cross-CTA stage (k, j),
// op 1 the r stages j, j/2, ... of k on a register group.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtaLog = 14;      // 16384 elements a CTA at most
constexpr int kSpanLog = 17;     // 8 CTAs a cluster: 131072 elements
constexpr int kGroupBits = 4;    // a register group: 16 elements a thread
constexpr int kPer = 1 << kGroupBits;
constexpr int kSortThreads = 512;  // threads of a CTA at most
constexpr int kMaxSteps = 64;    // steps of one cluster launch
constexpr int kMaxPayloads = 8;  // payloads gathered by one launch
constexpr int kOpCross = 0, kOpRegs = 1;
constexpr int kKindCluster = 0, kKindGlobal = 1, kKindCta = 2;

// (key as unsigned, pos as signed) as one unsigned 64-bit word.
__device__ __forceinline__ uint64_t order_word(uint32_t key, int32_t pos) {
    return (uint64_t(key) << 32) | (uint32_t(pos) ^ 0x80000000u);
}

// The lowest of the kGroupBits column bits of a register group whose top
// stage is 2^jb.
__host__ __device__ __forceinline__ int group_base(int jb) {
    return jb > kGroupBits - 1 ? jb - (kGroupBits - 1) : 0;
}

// Shared-memory slot of column l: one pad word per 2^kPadLog.
constexpr int kPadLog = 4;
__host__ __device__ __forceinline__ int padded(int l) {
    return l + (l >> kPadLog);
}

struct SortArgs {
    const uint32_t* key_in;  // the inputs in the first launch, else null
    const int32_t* pos_in;
    uint32_t* key;           // the outputs, and the rows between launches
    int32_t* pos;
    int32_t* idx;            // idx (or the carried payload) between launches
    const int32_t* carry_in;   // first launch: the one payload, carried
    int32_t* carry_out;        // last launch: where the carried payload goes
    const int32_t* src[kMaxPayloads];
    int32_t* dst[kMaxPayloads];
    int npay;                // payloads gathered by this launch (the last)
    int write_idx;           // store idx (a later launch or gather reads it)
    int log_n, log_cta;
    int nsteps;
    int steps[kMaxSteps];
};

// Which of a group's E columns col0 | e << pb run a descending pair at
// stage k (bit e of the mask): the columns' bit k, a pattern of e where
// k's bit lies among the group's bits, else the same for all.
template <int E>
__device__ __forceinline__ unsigned desc_mask(int col0, int pb, int k) {
    const int q = __ffs(k) - 1 - pb;
    if (q >= 0 && (1 << q) < E)
        return q == 0 ? 0xAAAAAAAAu : q == 1 ? 0xCCCCCCCCu
             : q == 2 ? 0xF0F0F0F0u : q == 3 ? 0xFF00FF00u : 0xFFFF0000u;
    return (col0 & k) ? ~0u : 0u;
}

// Stage Q of a register group: elements e and e | 1 << Q for each e with
// bit Q clear, descending where bit e of dmask is set.
template <int E, int Q>
__device__ __forceinline__ void reg_stage(uint64_t (&w)[E], int32_t (&x)[E],
                                          unsigned dmask) {
    if constexpr ((1 << Q) < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if (e & (1 << Q)) continue;
            const int f = e | (1 << Q);
            const bool desc = (dmask >> e) & 1u;
            const uint64_t a = w[e], b = w[f];
            const int32_t xa = x[e], xb = x[f];
            const bool swap = desc ? b > a : a > b;
            w[e] = swap ? b : a;
            w[f] = swap ? a : b;
            x[e] = swap ? xb : xa;
            x[f] = swap ? xa : xb;
        }
    }
}

// Stage Q of a register group whose pairs all run one way: elements e
// and e | 1 << Q for each e with bit Q clear, the larger word going to
// e | 1 << Q (ascending) or to e (kDesc). The direction is fixed at
// compile time, so a compare-exchange is one 64-bit compare and its
// selects.
template <int E, int Q, bool kDesc>
__device__ __forceinline__ void reg_stage_dir(uint64_t (&w)[E],
                                              int32_t (&x)[E]) {
    if constexpr ((1 << Q) < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            if (e & (1 << Q)) continue;
            const int lo = kDesc ? e | (1 << Q) : e;
            const int hi = kDesc ? e : e | (1 << Q);
            const uint64_t a = w[lo], b = w[hi];
            const int32_t xa = x[lo], xb = x[hi];
            const bool swap = a > b;
            w[lo] = swap ? b : a;
            w[hi] = swap ? a : b;
            x[lo] = swap ? xb : xa;
            x[hi] = swap ? xa : xb;
        }
    }
}

template <int E, bool kDesc>
__device__ __forceinline__ void reg_stages_dir(uint64_t (&w)[E],
                                               int32_t (&x)[E], int q_hi,
                                               int r) {
    for (int q = q_hi; q > q_hi - r; --q) {
        switch (q) {
            case 4: reg_stage_dir<E, 4, kDesc>(w, x); break;
            case 3: reg_stage_dir<E, 3, kDesc>(w, x); break;
            case 2: reg_stage_dir<E, 2, kDesc>(w, x); break;
            case 1: reg_stage_dir<E, 1, kDesc>(w, x); break;
            default: reg_stage_dir<E, 0, kDesc>(w, x); break;
        }
    }
}

// The r stages of k with partner bits q_hi, q_hi - 1, ... of the group of
// columns col0 | e << pb. Where k's bit lies above the group's bits (k >
// 8 on a first group, every later one) all of a thread's pairs run one
// way; where a warp's threads also agree (k >= 512 always), the warp
// takes that direction's code.
template <int E>
__device__ __forceinline__ void reg_stages(uint64_t (&w)[E], int32_t (&x)[E],
                                           int col0, int pb, int k, int q_hi,
                                           int r) {
    const unsigned dmask = desc_mask<E>(col0, pb, k);
    const unsigned lanes = __activemask();
    if (__all_sync(lanes, dmask == 0u))
        return reg_stages_dir<E, false>(w, x, q_hi, r);
    if (__all_sync(lanes, dmask == ~0u))
        return reg_stages_dir<E, true>(w, x, q_hi, r);
    for (int q = q_hi; q > q_hi - r; --q) {
        switch (q) {
            case 4: reg_stage<E, 4>(w, x, dmask); break;
            case 3: reg_stage<E, 3>(w, x, dmask); break;
            case 2: reg_stage<E, 2>(w, x, dmask); break;
            case 1: reg_stage<E, 1>(w, x, dmask); break;
            default: reg_stage<E, 0>(w, x, dmask); break;
        }
    }
}

// Register steps s .. s_end - 1 of a cluster launch, all on the groups of
// columns base | e << pb. Column base | e << pb sits in slot padded(base) +
// padded(e << pb) (base has bits pb .. pb + 3 clear), which is padded(base)
// + e * (17 << (pb - 4)) when pb >= 4 (kWide): one multiply-add a slot.
template <bool kWide>
__device__ __forceinline__ void group_pass(const SortArgs& a, uint64_t* word,
                                           int32_t* idx, int cta_base,
                                           int cta, int pb, int s,
                                           int s_end) {
    const int stride = kWide ? ((1 << kPadLog) + 1) << (pb - kPadLog) : 0;
    for (int t = threadIdx.x; t < cta >> kGroupBits; t += blockDim.x) {
        const int base = ((t >> pb) << (pb + kGroupBits)) |
                         (t & ((1 << pb) - 1));
        const int p0 = padded(base);
        uint64_t w[kPer];
        int32_t x[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const int p = p0 + (kWide ? e * stride : padded(e << pb));
            w[e] = word[p];
            x[e] = idx[p];
        }
        for (int u = s; u < s_end; ++u) {
            const int st = a.steps[u];
            reg_stages<kPer>(w, x, cta_base | base, pb, 1 << ((st >> 2) & 63),
                             ((st >> 8) & 63) - pb, (st >> 14) & 7);
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const int p = p0 + (kWide ? e * stride : padded(e << pb));
            word[p] = w[e];
            idx[p] = x[e];
        }
    }
}

// One cluster launch: a CTA holds 2^log_cta columns of one row, a cluster
// the CTAs of one span; blockDim.x * kPer divides 2^log_cta.
__global__ void __launch_bounds__(kSortThreads, 1)
sort_cluster_kernel(const __grid_constant__ SortArgs a) {
    extern __shared__ uint64_t qz_sort_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cta = 1 << a.log_cta;
    uint64_t* word = qz_sort_smem;
    int32_t* idx = reinterpret_cast<int32_t*>(qz_sort_smem + padded(cta));
    const int shift = a.log_n - a.log_cta;
    const int cta_base = int(blockIdx.x & ((1u << shift) - 1)) << a.log_cta;
    const size_t row_off = size_t(blockIdx.x >> shift) << a.log_n;
    const size_t off = row_off + cta_base;
    const int nt = blockDim.x;
#pragma unroll 8
    for (int l = threadIdx.x; l < cta; l += nt) {
        const int p = padded(l);
        if (a.key_in) {
            word[p] = order_word(a.key_in[off + l], a.pos_in[off + l]);
            idx[p] = a.carry_in ? a.carry_in[off + l] : cta_base + l;
        } else {
            word[p] = order_word(a.key[off + l], a.pos[off + l]);
            idx[p] = a.idx[off + l];
        }
    }
    const unsigned rank = cluster.block_rank();
    for (int s = 0; s < a.nsteps; ++s) {
        const int step = a.steps[s];
        const int k = 1 << ((step >> 2) & 63);
        const int jb = (step >> 8) & 63;
        if ((step & 3) == kOpCross) {
            // Partner CTA rank ^ (j / cta), same slot. Both sides of a pair
            // compute the same swap; each keeps the partner's element when
            // it swaps. The direction bit k lies above the CTA, so it is
            // the CTA's. A slot is read by its partner only, so batches of
            // kPer slots a thread each read, sync, then write.
            const unsigned bit = 1u << (jb - a.log_cta);
            // The pair's smaller word goes to the lower CTA in an ascending
            // run: this CTA's word comes first in the compare when it is
            // the lower one of an ascending pair or the upper of a
            // descending one.
            const bool mine_first =
                ((rank & bit) == 0) == ((cta_base & k) == 0);
            const uint64_t* rw = cluster.map_shared_rank(word, rank ^ bit);
            const int32_t* ri = cluster.map_shared_rank(idx, rank ^ bit);
            for (int l0 = 0; l0 < cta; l0 += nt * kPer) {
                cluster.sync();
                uint64_t nw[kPer];
                int32_t ni[kPer];
#pragma unroll
                for (int e = 0; e < kPer; ++e) {
                    const int p = padded(l0 + threadIdx.x + e * nt);
                    const uint64_t mine = word[p], theirs = rw[p];
                    const bool swap = mine_first ? mine > theirs
                                                 : theirs > mine;
                    nw[e] = swap ? theirs : mine;
                    ni[e] = swap ? ri[p] : idx[p];
                }
                cluster.sync();
#pragma unroll
                for (int e = 0; e < kPer; ++e) {
                    const int p = padded(l0 + threadIdx.x + e * nt);
                    word[p] = nw[e];
                    idx[p] = ni[e];
                }
            }
        } else {
            // The group's column bits start at pb; the thread's base
            // column has them clear. The following register steps with the
            // same pb (k <= 2^kGroupBits) run on the same registers.
            const int pb = group_base(jb);
            int s_end = s + 1;
            while (s_end < a.nsteps && (a.steps[s_end] & 3) != kOpCross &&
                   group_base((a.steps[s_end] >> 8) & 63) == pb)
                ++s_end;
            __syncthreads();
            if (pb >= kPadLog)
                group_pass<true>(a, word, idx, cta_base, cta, pb, s, s_end);
            else
                group_pass<false>(a, word, idx, cta_base, cta, pb, s, s_end);
            s = s_end - 1;
        }
    }
    // A thread holds cta / nt = 16 or 32 columns: 8 at a time, every
    // payload's 8 reads are issued before its 8 writes.
    __syncthreads();
    for (int l0 = threadIdx.x; l0 < cta; l0 += 8 * nt) {
        int32_t from[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int l = l0 + i * nt, p = padded(l);
            const uint64_t w = word[p];
            from[i] = idx[p];
            a.key[off + l] = uint32_t(w >> 32);
            a.pos[off + l] = int32_t(uint32_t(w) ^ 0x80000000u);
            if (a.write_idx) a.idx[off + l] = from[i];
            if (a.carry_out) a.carry_out[off + l] = from[i];
        }
        for (int q = 0; q < a.npay; ++q) {
            int32_t v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = a.src[q][row_off + from[i]];
#pragma unroll
            for (int i = 0; i < 8; ++i) a.dst[q][off + l0 + i * nt] = v[i];
        }
    }
    cluster.sync();  // no CTA leaves while its cluster may still read it
}

// The R stages k, 2^(jb_lo + R - 1) ... 2^jb_lo, in device memory: a thread
// holds the 2^R columns that differ only in bits jb_lo .. jb_lo + R - 1.
template <int R>
__global__ void sort_global_kernel(uint32_t* __restrict__ key,
                                   int32_t* __restrict__ pos,
                                   int32_t* __restrict__ idx, int log_n, int k,
                                   int jb_lo, long long threads) {
    constexpr int E = 1 << R;
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (t >= threads) return;
    const int per_row = log_n - R;
    const size_t row_off = size_t(t >> per_row) << log_n;
    const unsigned q = unsigned(t) & ((1u << per_row) - 1);
    const unsigned base = ((q >> jb_lo) << (jb_lo + R)) |
                          (q & ((1u << jb_lo) - 1));
    uint64_t w[E];
    int32_t x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const size_t at = row_off + (base | (unsigned(e) << jb_lo));
        w[e] = order_word(key[at], pos[at]);
        x[e] = idx[at];
    }
    reg_stages<E>(w, x, int(base), jb_lo, k, R - 1, R);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const size_t at = row_off + (base | (unsigned(e) << jb_lo));
        key[at] = uint32_t(w[e] >> 32);
        pos[at] = int32_t(uint32_t(w[e]) ^ 0x80000000u);
        idx[at] = x[e];
    }
}

struct Payloads {
    const int32_t* src[kMaxPayloads];
    int32_t* dst[kMaxPayloads];
};

// dst[r][i] = src[r][idx[r][i]]: the payloads past the last launch's eight.
__global__ void gather_payloads_kernel(const int32_t* __restrict__ idx,
                                       Payloads pl, int npay, long long total,
                                       int log_n) {
    const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (e >= total) return;
    const size_t from = (size_t(e >> log_n) << log_n) + idx[e];
    for (int q = 0; q < npay; ++q) pl.dst[q][e] = pl.src[q][from];
}

int log2_of(int n) { return 31 - __builtin_clz(unsigned(n)); }

// Whether a plan runs every stage of the network once and in order, each
// on columns that one thread, CTA or cluster of this file's geometry holds
// (kCtaLog, kSpanLog, kGroupBits): a plan made for another geometry is
// refused, not run on the wrong columns. A device-memory pass may run any
// stages, but neither first (it reads the outputs) nor last (the last
// launch gathers the payloads).
bool plan_ok(const int* words, int plan_len, int log_n) {
    const int log_cta = log_n < kCtaLog ? log_n : kCtaLog;
    const int log_span = log_n < kSpanLog ? log_n : kSpanLog;
    int kb = 1, jb = 0;  // the next stage: k = 2^kb, j = 2^jb
    int kind = kKindGlobal;
    for (int at = 0; at < plan_len;) {
        if (at + 2 > plan_len) return false;
        kind = words[at];
        const int nsteps = words[at + 1];
        if (nsteps < 1 || nsteps > plan_len - at - 2) return false;
        if (kind == kKindGlobal ? at == 0 || nsteps != 1
                                : (kind != kKindCluster && kind != kKindCta) ||
                                      nsteps > kMaxSteps)
            return false;
        for (int i = 0; i < nsteps; ++i) {
            const int st = words[at + 2 + i];
            const int op = st & 3, r = (st >> 14) & 7;
            if (kb > log_n || ((st >> 2) & 63) != kb || ((st >> 8) & 63) != jb)
                return false;
            if (op == kOpCross) {
                if (kind != kKindCluster || r != 1 || jb < log_cta ||
                    jb >= log_span)
                    return false;
            } else if (op != kOpRegs || r < 1 || r > kGroupBits ||
                       jb - r + 1 < (kind == kKindGlobal ? 0 : group_base(jb)) ||
                       (kind != kKindGlobal && jb >= log_cta)) {
                return false;
            }
            jb -= r;
            if (jb < 0) jb = kb++;
        }
        at += 2 + nsteps;
    }
    return kb == log_n + 1 && kind != kKindGlobal;
}

// A cluster launch's shape for rows of n: CTA and cluster sizes (a
// cluster of one CTA when `single`).
cudaLaunchConfig_t cluster_config(int rows, int n, bool single,
                                  cudaLaunchAttribute* attr, cudaStream_t s) {
    const int log_n = log2_of(n);
    const int log_cta = log_n < kCtaLog ? log_n : kCtaLog;
    const int log_span = log_n < kSpanLog ? log_n : kSpanLog;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unsigned(rows) << (log_n - log_cta));
    const unsigned groups = (1u << log_cta) >> kGroupBits;
    cfg.blockDim = dim3(groups < kSortThreads ? groups : kSortThreads);
    cfg.dynamicSmemBytes =
        size_t(padded(1 << log_cta)) * (sizeof(uint64_t) + sizeof(int32_t));
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = single ? 1u : 1u << (log_span - log_cta);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" {

// Clusters of the cluster launch that the card holds at once for rows of
// n (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int qz_bitonic_active_clusters(int n) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(1, n, false, attr, nullptr);
    cudaError_t err = cudaFuncSetAttribute(
        sort_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(cfg.dynamicSmemBytes));
    int clusters = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&clusters, sort_cluster_kernel,
                                             &cfg);
    return err == cudaSuccess ? clusters : -int(err);
}

int qz_bitonic_sort(const void* key, const void* pos, void* key_out,
                    void* pos_out, void* idx, const void* srcs,
                    const void* dsts, int npay, int rows, int n,
                    const void* plan, int plan_len, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto words = static_cast<const int*>(plan);
    const auto src = static_cast<const int32_t* const*>(srcs);
    const auto dst = static_cast<int32_t* const*>(dsts);
    const int log_n = log2_of(n);
    if (n < 1024 || (n & (n - 1)) || !plan_ok(words, plan_len, log_n))
        return int(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1], attr_cta[1];
    const cudaLaunchConfig_t cfg = cluster_config(rows, n, false, attr, s);
    const cudaLaunchConfig_t cfg_cta =
        cluster_config(rows, n, true, attr_cta, s);
    cudaError_t err = cudaFuncSetAttribute(
        sort_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return int(err);
    const bool carry = npay == 1;  // the payload rides in idx's place
    bool first = true;
    for (int at = 0; at < plan_len;) {
        const int kind = words[at], nsteps = words[at + 1];
        const int* steps = words + at + 2;
        at += 2 + nsteps;
        const bool last = at >= plan_len;
        if (kind == kKindCluster || kind == kKindCta) {
            SortArgs a = {};
            a.key_in = first ? static_cast<const uint32_t*>(key) : nullptr;
            a.pos_in = first ? static_cast<const int32_t*>(pos) : nullptr;
            a.key = static_cast<uint32_t*>(key_out);
            a.pos = static_cast<int32_t*>(pos_out);
            a.idx = static_cast<int32_t*>(idx);
            a.carry_in = first && carry ? src[0] : nullptr;
            a.carry_out = last && carry ? dst[0] : nullptr;
            a.npay = last && !carry
                         ? (npay < kMaxPayloads ? npay : kMaxPayloads)
                         : 0;
            for (int q = 0; q < a.npay; ++q) {
                a.src[q] = src[q];
                a.dst[q] = dst[q];
            }
            a.write_idx = !last || npay > kMaxPayloads;
            a.log_n = log_n;
            a.log_cta = log_n < kCtaLog ? log_n : kCtaLog;
            a.nsteps = nsteps;
            for (int i = 0; i < nsteps; ++i) a.steps[i] = steps[i];
            err = cudaLaunchKernelEx(kind == kKindCta ? &cfg_cta : &cfg,
                                     sort_cluster_kernel, a);
        } else {
            const int k = 1 << ((steps[0] >> 2) & 63);
            const int r = (steps[0] >> 14) & 7;
            const int jb_lo = ((steps[0] >> 8) & 63) - r + 1;
            const long long threads = (long long)rows << (log_n - r);
            auto ko = static_cast<uint32_t*>(key_out);
            auto po = static_cast<int32_t*>(pos_out);
            auto ix = static_cast<int32_t*>(idx);
            const unsigned grid = blocks_for(threads);
            switch (r) {
                case 1: sort_global_kernel<1><<<grid, kThreads, 0, s>>>(
                            ko, po, ix, log_n, k, jb_lo, threads); break;
                case 2: sort_global_kernel<2><<<grid, kThreads, 0, s>>>(
                            ko, po, ix, log_n, k, jb_lo, threads); break;
                case 3: sort_global_kernel<3><<<grid, kThreads, 0, s>>>(
                            ko, po, ix, log_n, k, jb_lo, threads); break;
                default: sort_global_kernel<4><<<grid, kThreads, 0, s>>>(
                            ko, po, ix, log_n, k, jb_lo, threads); break;
            }
            err = cudaGetLastError();
        }
        if (err != cudaSuccess) return int(err);
        first = false;
    }
    const long long total = (long long)rows * n;
    for (int q0 = kMaxPayloads; q0 < npay; q0 += kMaxPayloads) {
        Payloads pl = {};
        const int m = npay - q0 < kMaxPayloads ? npay - q0 : kMaxPayloads;
        for (int q = 0; q < m; ++q) {
            pl.src[q] = src[q0 + q];
            pl.dst[q] = dst[q0 + q];
        }
        gather_payloads_kernel<<<blocks_for(total), kThreads, 0, s>>>(
            static_cast<const int32_t*>(idx), pl, m, total, log_n);
        if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    }
    return int(cudaSuccess);
}

}  // extern "C"
