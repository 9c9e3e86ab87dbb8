// Kernel `auction_spread`: one round's PodTopologySpread repair and count
// commit in the auction solve.
//
// Replaces: kubernetes_tpu/ops/auction.py:482-652 — `spread_repair` (its
// SPREAD_REPAIR_ITERS = 3 admit passes over the round's capacity-accepted
// pods, with `_slot_sorts` and `_spread_ranks`), and `commit_spread` of the
// kept pods into the node-space counts (auction.py:716-720, 731-732).
//
// What it computes.  A pass takes the accepted pods not yet kept, the
// critical-path minimum of every row (min count over eligible nodes, 0
// without one or under minDomains), and for each such pod and each of its
// hard rows whose bid node has a value: its rank, the number of earlier
// pods of the pass in solve order that match the row and bid a node of the
// same value; the pod is admitted unless some row has rank >= maxSkew + min
// - count + (1 - selfMatch).  The admits are committed into a working copy
// of the counts, so the next pass sees the raised minimum.  Then the kept
// pods are committed into the counts, and `accept` becomes the kept set for
// the commit stage of auction_accept.
//
// Bound on this card: the ranks compare each candidate with the candidates
// before it (P^2/2 tests a row a pass); the min and the commits move the
// [C, N] counts (and a [C, Z] value table) a few times.  At the main path's
// shapes (2,048 pods, one row, 8,192 nodes) both are microseconds of the
// card's rates; this design pays one SM and its barriers.
//
// Design: one block of 1,024 threads, launched once a round between
// auction_accept's two stages and returning at once when the device's
// continue flag (state[1]) is down.  The minima run one warp a row; the
// ranks one thread a solve position, counting over the positions before
// it (the reference's stable value sort and segmented exclusive count give
// the same number); the commits add integer counts in value space with
// integer atomics and then read them back per node, as the reference's
// one-hot matmuls do.  Counts are integer-valued floats below 2^24, so
// every add is exact and the order of the atomics does not matter.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;
constexpr int kRepairIters = 3;  // ops/auction.py SPREAD_REPAIR_ITERS

// counts[c, n] += adds[c, v[c, n]] for every node with a value, after the
// marked pods' adds were gathered in value space (adds zeroed first).
__device__ void commit_marked(const Spread& sp, int n, int p, int z, const int32_t* bid,
                              const uint8_t* marked, int32_t* adds, float* counts)
{
    const int tid = threadIdx.x;
    for (int o = tid; o < sp.c_dim * z; o += blockDim.x) adds[o] = 0;
    __syncthreads();
    for (int i = tid; i < p; i += blockDim.x) {
        if (!marked[i]) continue;
        const int node = min(max(bid[i], 0), n - 1);
        for (int c = 0; c < sp.c_dim; ++c) {
            const size_t o = (size_t)c * n + node;
            const int val = sp.v[o];
            if (sp.pod_matches[(size_t)i * sp.c_dim + c] && sp.eligible[o] && val >= 0) {
                atomicAdd(&adds[(size_t)c * z + min(val, z - 1)], 1);
            }
        }
    }
    __syncthreads();
    for (size_t o = tid; o < (size_t)sp.c_dim * n; o += blockDim.x) {
        const int val = sp.v[o];
        if (val < 0) continue;
        const int c = (int)(o / n);
        const int a = adds[(size_t)c * z + min(val, z - 1)];
        if (a) counts[o] = add(counts[o], (float)a);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) spread_repair_kernel(
    int n, int p, int z, Spread sp,
    const int32_t* __restrict__ order, const int32_t* __restrict__ bid,
    const int32_t* __restrict__ state, uint8_t* accept,
    float* counts_it, int32_t* adds, float* minc,           // [C, N], [C, Z], [C]
    uint8_t* kept, uint8_t* cand, uint8_t* admit)           // [P] each
{
    if (!state[1]) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int c_dim = sp.c_dim;
    for (int i = tid; i < p; i += blockDim.x) kept[i] = 0;
    for (size_t o = tid; o < (size_t)c_dim * n; o += blockDim.x) counts_it[o] = sp.counts[o];
    __syncthreads();

    for (int it = 0; it < kRepairIters; ++it) {
        for (int i = tid; i < p; i += blockDim.x) cand[i] = accept[i] && !kept[i];
        // every row's critical-path minimum against the working counts
        for (int c = warp; c < c_dim; c += nwarps) {
            float m = kBig;
            const size_t o = (size_t)c * n;
            for (int nd = lane; nd < n; nd += 32) {
                if (sp.eligible[o + nd]) m = fminf(m, counts_it[o + nd]);
            }
            for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
            if (lane == 0) {
                if (m >= kBig) m = 0.0f;
                const float md = sp.min_domains[c];
                if (md > 0.0f && sp.sizes[c] < md) m = 0.0f;
                minc[c] = m;
            }
        }
        __syncthreads();
        // admit: every hard row of the pod keeps its rank under the bound
        for (int k = tid; k < p; k += blockDim.x) {
            const int i = order[k];
            bool ok = cand[i] != 0;
            if (ok) {
                const int node = min(max(bid[i], 0), n - 1);
                for (int j = 0; j < sp.mc && ok; ++j) {
                    const int cidx = sp.pod_idx[(size_t)i * sp.mc + j];
                    const int c = min(max(cidx, 0), c_dim - 1);
                    const int vp = sp.v[(size_t)c * n + node];
                    if (cidx < 0 || !sp.hard[c] || vp < 0) continue;
                    const float cnt = counts_it[(size_t)c * n + node];
                    const float self_m = sp.pod_matches[(size_t)i * c_dim + c] ? 1.0f : 0.0f;
                    const float allowed = add(sub(add(sp.max_skew[c], minc[c]), cnt),
                                              sub(1.0f, self_m));
                    int rank = 0;
                    for (int k2 = 0; k2 < k; ++k2) {
                        const int q = order[k2];
                        if (!cand[q] || !sp.pod_matches[(size_t)q * c_dim + c]) continue;
                        const int nq = min(max(bid[q], 0), n - 1);
                        rank += sp.v[(size_t)c * n + nq] == vp ? 1 : 0;
                    }
                    if ((float)rank >= allowed) ok = false;
                }
            }
            admit[i] = ok ? 1 : 0;
        }
        __syncthreads();
        commit_marked(sp, n, p, z, bid, admit, adds, counts_it);
        for (int i = tid; i < p; i += blockDim.x) kept[i] |= admit[i];
        __syncthreads();
    }
    // the kept pods' counts, and the accepted set the commit stage reads
    commit_marked(sp, n, p, z, bid, kept, adds, sp.counts);
    for (int i = tid; i < p; i += blockDim.x) accept[i] = kept[i];
}

}  // namespace

extern "C" int auction_spread_launch(
    int n, int p, int z, int sp_c, int sp_mc, const void* sp_pod_idx,
    const void* sp_pod_matches, const void* sp_max_skew, const void* sp_min_domains,
    const void* sp_hard, const void* sp_eligible, const void* sp_v, const void* sp_sizes,
    void* sp_counts, const void* order, const void* bid, const void* state, void* accept,
    void* counts_it, void* adds, void* minc, void* kept, void* cand, void* admit,
    void* stream)
{
    if (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1 || z < 1) return (int)cudaErrorInvalidValue;
    if (p == 0 || n == 0) return 0;
    const Spread sp = make_spread(1, 0, sp_c, sp_mc, sp_pod_idx, sp_pod_matches, sp_max_skew,
                                  sp_min_domains, sp_hard, sp_eligible, sp_v, sp_sizes,
                                  sp_counts);
    spread_repair_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        n, p, z, sp, (const int32_t*)order, (const int32_t*)bid, (const int32_t*)state,
        (uint8_t*)accept, (float*)counts_it, (int32_t*)adds, (float*)minc,
        (uint8_t*)kept, (uint8_t*)cand, (uint8_t*)admit);
    return (int)cudaGetLastError();
}

extern "C" const char* auction_spread_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
