// The thread-block cluster the solves run on (greedy_scan.cu, wavefront.cu,
// evaluate_single.cu): its launch shape, the node ownership of its blocks,
// the team that block_eval and the team-wide helpers of solve_common.cuh
// evaluate a pod with, and the launch itself.
//
// A cluster of G blocks runs on neighbouring SMs; block b owns the 32-node
// chunks q with q % G == b, so a warp reads 32 neighbouring nodes and the
// padded tail of the node axis, where no node is feasible, is spread over
// every block.  A reduction ends in one block barrier: each warp's lane 0
// leaves the warp's partial in shared memory, thread t < G merges the
// block's warps and stores the block's partial into slot [rank] of block t
// (cluster.map_shared_rank), one cluster barrier (barrier.cluster
// arrive.release / wait.acquire), and every block merges the G slots
// itself.  Every merge is order-free (flags OR, integer counts, fmaxf /
// fminf, ranks_above's total order), so a cluster gives one block's bits.
// Exchange slots alternate between two buffers by a parity the caller
// advances: a block writes a slot's next use only after every block has
// passed a barrier that follows every read of its last use.

#pragma once

#include <cooperative_groups.h>

#include <mutex>

#include "solve_common.cuh"

namespace solve {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;      // H100: the largest non-portable cluster
constexpr int kClusterThreads = 1024;
constexpr int kSmallThreads = 512;   // up to kMaxCluster * 512 nodes

// The launch shape for N nodes, about one node a thread: 512 threads a
// block up to 16 x 512 = 8,192 nodes (the register budget of a 512-thread
// block holds the evaluation without spills), 1,024 threads above; N /
// threads blocks, at least 2 and at most 16.
struct Shape {
    int threads, blocks;
};

__host__ __device__ inline Shape launch_shape(int n)
{
    const int t = n <= kMaxCluster * kSmallThreads ? kSmallThreads : kClusterThreads;
    const int g = (n + t - 1) / t;
    return {t, g < 2 ? 2 : (g > kMaxCluster ? kMaxCluster : g)};
}

// The block of a g-block cluster that owns node nd: 32-node chunks, dealt
// round robin.
__host__ __device__ inline int block_of(int nd, int g)
{
    return (nd >> 5) % g;
}

// The exchange slots of one block (shared memory; every block of the
// cluster writes its partial into slot [its rank] of every block's copy).
struct Slots {
    Step step[2][kMaxCluster];
    float best[2][kMaxCluster];       // pass 2's picks
    int idx[2][kMaxCluster];
    float guess_best[2][kMaxCluster]; // pass 1's picks against the guess
    int guess_idx[2][kMaxCluster];
    float mins[2][kMaxCluster][kMaxMC];
};

__device__ __forceinline__ bool same_bits(float a, float b)
{
    return __float_as_uint(a) == __float_as_uint(b);
}

// A cluster evaluating one pod: this block's nodes, the team-wide
// thread numbering and barrier, and the reductions merged across the
// blocks through distributed shared memory (solve_common.cuh, "Teams").
struct ClusterTeam {
    static constexpr bool kSpeculate = true;   // block_eval: one exchange on a hit
    unsigned rank_, size_;   // block rank, blocks in the cluster
    mutable Step guess;      // the maxima pass 1 scores against: the last step's
    int par;                 // exchange parity: which slot buffer
    Slots* slots;            // this block's slots

    __device__ void init(Slots* s)
    {
        cg::cluster_group cluster = cg::this_cluster();
        rank_ = cluster.block_rank();
        size_ = cluster.num_blocks();
        slots = s;
        guess = step_zero();
        par = 0;
    }

    __device__ int rank() const { return (int)(rank_ * blockDim.x + threadIdx.x); }
    __device__ int size() const { return (int)(size_ * blockDim.x); }
    // block b owns the 32-node chunks q with q % G == b; a warp visits
    // 32 neighbouring nodes
    __device__ int first() const
    {
        return (int)((rank_ + size_ * (threadIdx.x >> 5)) * 32 + (threadIdx.x & 31));
    }
    __device__ int stride() const { return (int)(size_ * blockDim.x); }
    __device__ int end(int n) const { return n; }
    __device__ bool owns(int nd) const { return block_of(nd, (int)size_) == (int)rank_; }
    __device__ void sync() const { cg::this_cluster().sync(); }

    template <class T>
    __device__ void store(T* slot, const T& v) const
    {
        *cg::this_cluster().map_shared_rank(slot, threadIdx.x) = v;
    }

    // the Step alone, merged in one exchange
    __device__ Step reduce_step(Step st, Scratch& sc) const
    {
        const int warp = threadIdx.x >> 5;
        st = warp_reduce_step(st);
        if ((threadIdx.x & 31) == 0) sc.warp_step[warp] = st;
        __syncthreads();
        if (threadIdx.x < size_) {
            Step bs = step_zero();
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) bs = step_merge(bs, sc.warp_step[w]);
            store(&slots->step[par][rank_], bs);
        }
        sync();
        Step all = step_zero();
        for (unsigned b = 0; b < size_; ++b) all = step_merge(all, slots->step[par][b]);
        return all;
    }

    // pass 1's Step and its pick against the guess, merged in one exchange
    __device__ Step reduce_step_best(Step st, float& best, int& idx, Scratch& sc) const
    {
        const int warp = threadIdx.x >> 5;
        st = warp_reduce_step(st);
        warp_reduce_best(best, idx);
        if ((threadIdx.x & 31) == 0) {
            sc.warp_step[warp] = st;
            sc.warp_best[warp] = best;
            sc.warp_idx[warp] = idx;
        }
        __syncthreads();
        if (threadIdx.x < size_) {
            Step bs = step_zero();
            float bb = -INFINITY;
            int bi = 0x7fffffff;
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
                bs = step_merge(bs, sc.warp_step[w]);
                better(bb, bi, sc.warp_best[w], sc.warp_idx[w]);
            }
            store(&slots->step[par][rank_], bs);
            store(&slots->guess_best[par][rank_], bb);
            store(&slots->guess_idx[par][rank_], bi);
        }
        sync();
        Step all = step_zero();
        best = -INFINITY;
        idx = 0x7fffffff;
        for (unsigned b = 0; b < size_; ++b) {
            all = step_merge(all, slots->step[par][b]);
            better(best, idx, slots->guess_best[par][b], slots->guess_idx[par][b]);
        }
        return all;
    }

    // whether the maxima the scores read (the spread raw max / min only
    // with soft rows) equal the guess bit for bit; the merged maxima become
    // the next guess
    __device__ bool guessed(const Step& all, bool soft) const
    {
        const bool hit = same_bits(all.max_aff, guess.max_aff)
            && same_bits(all.max_taint, guess.max_taint)
            && (!soft || (same_bits(all.sp_mx, guess.sp_mx)
                          && same_bits(all.sp_mn, guess.sp_mn)));
        guess = all;
        return hit;
    }

    __device__ void reduce_best(float& best, int& idx, Scratch& sc) const
    {
        warp_reduce_best(best, idx);
        if ((threadIdx.x & 31) == 0) {
            sc.warp_best[threadIdx.x >> 5] = best;
            sc.warp_idx[threadIdx.x >> 5] = idx;
        }
        __syncthreads();
        if (threadIdx.x < size_) {
            float bb = -INFINITY;
            int bi = 0x7fffffff;
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
                better(bb, bi, sc.warp_best[w], sc.warp_idx[w]);
            }
            store(&slots->best[par][rank_], bb);
            store(&slots->idx[par][rank_], bi);
        }
        sync();
        best = -INFINITY;
        idx = 0x7fffffff;
        for (unsigned b = 0; b < size_; ++b) {
            better(best, idx, slots->best[par][b], slots->idx[par][b]);
        }
    }

    // ps.minm holds this block's minimum of each hard row (thread 0 wrote
    // it); afterwards thread 0 holds the cluster's.
    __device__ void reduce_mins(PodSpread& ps, int mc) const
    {
        __syncthreads();
        if (threadIdx.x < size_) {
            for (int j = 0; j < mc; ++j) store(&slots->mins[par][rank_][j], ps.minm[j]);
        }
        sync();
        if (threadIdx.x == 0) {
            for (int j = 0; j < mc; ++j) {
                float m = kBig;
                for (unsigned b = 0; b < size_; ++b) m = fminf(m, slots->mins[par][b][j]);
                ps.minm[j] = m;
            }
        }
    }
};

// Pod i placed on node `choice` (solve_common.cuh block_spread_update, over
// this block's nodes): the rows' values at the choice are read once, one
// thread a row, before the block walks the rows that gain a count.
// s_vat: [blockDim] shared.
__device__ inline void cluster_spread_update(const Spread& sp, int n, int i, int choice,
                                             const ClusterTeam& team, int* s_vat)
{
    for (int cb = 0; cb < sp.c_dim; cb += blockDim.x) {
        const int c = cb + threadIdx.x;
        int v_at = -1;
        if (c < sp.c_dim && sp.pod_matches[(size_t)i * sp.c_dim + c]) {
            const size_t o = (size_t)c * n + choice;
            if (sp.eligible[o]) v_at = sp.v[o];
        }
        s_vat[threadIdx.x] = v_at;
        __syncthreads();
        const int rows = min((int)blockDim.x, sp.c_dim - cb);
        for (int cc = 0; cc < rows; ++cc) {
            const int v = s_vat[cc];
            if (v < 0) continue;
            const size_t oc = (size_t)(cb + cc) * n;
            for (int nd = team.first(); nd < team.end(n); nd += team.stride()) {
                if (sp.v[oc + nd] == v) sp.counts[oc + nd] = add(sp.counts[oc + nd], 1.0f);
            }
        }
        __syncthreads();
    }
}

// Ready `kernel` for clusters of shape.blocks blocks of shape.threads
// threads with `smem` bytes of dynamic shared memory, and give the clusters
// of that shape the card holds at once (cudaOccupancyMaxActiveClusters).
// Before the first launch of each (kernel, shape, smem) the kernel's
// attributes are set (non-portable cluster sizes above 8; its dynamic
// shared memory limit raised to the largest `smem` asked for, so the
// static and dynamic bytes may pass 48 KB) and the card is asked how many
// such clusters fit; a shape the card refuses (none fits) is an error,
// returned as the launch's.  Nothing retries.  Later calls for a known
// shape make no attribute call (a launch may be captured in a CUDA graph).
template <class... Params>
inline cudaError_t prepare_cluster(void (*kernel)(Params...), Shape shape, int smem,
                                   int* capacity)
{
    // the (kernel, shape, smem) checked so far (one per block size and
    // dynamic shared memory size in use; past 256, each launch checks
    // again); a kernel's dynamic shared memory limit is the largest smem
    // among its entries
    struct Checked { const void* fn; int blocks, threads, smem, capacity; };
    static Checked checked[256];
    static int n_checked = 0;
    static std::mutex mu;
    std::lock_guard<std::mutex> lock(mu);
    const void* fn = (const void*)kernel;
    int limit = 0;
    for (int k = 0; k < n_checked; ++k) {
        const Checked& c = checked[k];
        if (c.fn != fn) continue;
        if (c.blocks == shape.blocks && c.threads == shape.threads && c.smem == smem) {
            *capacity = c.capacity;
            return cudaSuccess;
        }
        limit = max(limit, c.smem);
    }
    cudaError_t err = cudaSuccess;
    if (shape.blocks > 8) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    if (smem > limit) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(shape.blocks, 1, 1);
    cfg.blockDim = dim3(shape.threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = shape.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (n_checked < 256) checked[n_checked++] = {fn, shape.blocks, shape.threads, smem, clusters};
    *capacity = clusters;
    return cudaSuccess;
}

// Launch `kernel` as `count` clusters of shape.blocks blocks of
// shape.threads threads (cluster k is blocks k * shape.blocks onwards) with
// `smem` bytes of dynamic shared memory on `stream`, readied by
// prepare_cluster.
template <class... Params, class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), Shape shape, int count, int smem,
                                   cudaStream_t stream, Args... args)
{
    int capacity = 0;
    cudaError_t err = prepare_cluster(kernel, shape, smem, &capacity);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(count * shape.blocks, 1, 1);
    cfg.blockDim = dim3(shape.threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = shape.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Launch `kernel` as one cluster (launch_clusters with count 1).
template <class... Params, class... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), Shape shape, int smem,
                                  cudaStream_t stream, Args... args)
{
    return launch_clusters(kernel, shape, 1, smem, stream, args...);
}

}  // namespace solve
