// Kernel `auction_interpod`: one round's InterPodAffinity repair and
// term-bit commit in the auction solve.
//
// Replaces: kubernetes_tpu/ops/auction.py:587-614 `interpod_repair` (run
// after `spread_repair`, :717-720) and :654-678 `commit_terms` of the kept
// pods into the present / blocked / global_any bits (:733-736).
//
// What it computes.  A pod of the round's accepted set is involved in
// group (v, t) when it matches term t or carries t as an anti-affinity
// term, and its bid node has value v in t's topology slot.  In every group
// that holds an involved carrier of the term, every involved pod after the
// group's first in solve order is released (the sequential scan would
// have refused them: the first one's placement blocks the rest).  Then the
// kept pods commit: the terms they match turn present, and their anti
// terms blocked, on every node that shares the bid node's value in the
// term's slot; the terms they match turn globally present.  `accept`
// becomes the kept set for the commit stage of auction_accept.
//
// The reference runs the repair once per used topology slot over the terms
// of that slot; every term has one slot, so one table over all (value,
// term) groups, each term at its own slot's value, gives the same groups.
//
// Bound on this card: the work is one pass over the P x T (pod, term)
// pairs for the minima, one for the releases, one for the commit, and one
// over the N x T (node, term) pairs for the bits, plus clearing the
// Z x T group tables (Z the slot's value capacity; hostname keys make it
// the node count).  At the main path's shapes these are microseconds of
// the card's memory rate; this design pays one SM and its barriers.
//
// Design: one block of 1,024 threads, launched once a round after
// auction_spread (or stage 1 of auction_accept) and before stage 2, and
// returning at once when the device's continue flag (state[1]) is down.
// The group minima of solve positions are integer atomicMin in device
// memory and the carrier / commit flags plain byte stores of 1, so the
// result does not depend on the order the threads run in; global_any is
// an atomicOr of whole words.  Node rows are written by one thread each.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;
constexpr int kBigI = 1 << 30;  // ops/auction.py _BIG_I

struct Groups {
    int n, t_dim, tk, z;
    const int32_t* topo_ids;   // [N, TK]
    const int32_t* slot_of_t;  // [T]
    const int32_t* bid;        // [P]
};

// The (value, term) group of pod i's involvement in term t, or -1 when its
// bid node has no value in the term's slot.
__device__ __forceinline__ int group_of(const Groups& g, int i, int t)
{
    const int node = min(max(g.bid[i], 0), g.n - 1);
    const int s = min(max(g.slot_of_t[t], 0), g.tk - 1);
    const int v = g.topo_ids[(size_t)node * g.tk + s];
    if (v < 0) return -1;
    return min(v, g.z - 1) * g.t_dim + t;
}

__global__ void __launch_bounds__(kThreads, 1) interpod_repair_kernel(
    int p, int w, Groups g,
    const uint8_t* __restrict__ mi_dense,    // [P, T] valid terms the pod matches
    const uint8_t* __restrict__ anti_dense,  // [P, T] valid terms it carries as anti
    const int32_t* __restrict__ solve_pos,   // [P]
    const int32_t* __restrict__ state, uint8_t* accept,
    uint32_t* present, uint32_t* blocked, uint32_t* global_any,  // [N, W], [N, W], [W]
    int32_t* minpos, uint8_t* carrier, uint8_t* z_mi, uint8_t* z_an,  // [Z * T] each
    uint8_t* release)                                                 // [P]
{
    if (!state[1]) return;
    const int tid = threadIdx.x;
    const int t_dim = g.t_dim;
    const size_t groups = (size_t)g.z * t_dim;
    const size_t pairs = (size_t)p * t_dim;
    for (size_t o = tid; o < groups; o += blockDim.x) {
        minpos[o] = kBigI;
        carrier[o] = 0;
        z_mi[o] = 0;
        z_an[o] = 0;
    }
    for (int i = tid; i < p; i += blockDim.x) release[i] = 0;
    __syncthreads();

    // each group's first involved position in solve order, and its carriers
    for (size_t e = tid; e < pairs; e += blockDim.x) {
        const int i = (int)(e / t_dim), t = (int)(e % t_dim);
        if (!accept[i] || !(mi_dense[e] | anti_dense[e])) continue;
        const int gi = group_of(g, i, t);
        if (gi < 0) continue;
        atomicMin(&minpos[gi], solve_pos[i]);
        if (anti_dense[e]) carrier[gi] = 1;
    }
    __syncthreads();
    // release every involved pod after the first of a group with a carrier
    for (size_t e = tid; e < pairs; e += blockDim.x) {
        const int i = (int)(e / t_dim), t = (int)(e % t_dim);
        if (!accept[i] || !(mi_dense[e] | anti_dense[e])) continue;
        const int gi = group_of(g, i, t);
        if (gi >= 0 && carrier[gi] && solve_pos[i] > minpos[gi]) release[i] = 1;
    }
    __syncthreads();
    for (int i = tid; i < p; i += blockDim.x) {
        if (release[i]) accept[i] = 0;
    }
    __syncthreads();

    // the kept pods' terms in value space, and the global bits
    for (size_t e = tid; e < pairs; e += blockDim.x) {
        const int i = (int)(e / t_dim), t = (int)(e % t_dim);
        if (!accept[i] || !(mi_dense[e] | anti_dense[e])) continue;
        const int gi = group_of(g, i, t);
        if (gi < 0) continue;
        if (mi_dense[e]) {
            z_mi[gi] = 1;
            atomicOr(&global_any[t >> 5], 1u << (t & 31));
        }
        if (anti_dense[e]) z_an[gi] = 1;
    }
    __syncthreads();
    // node space: bit t of a node turns on when its group in t's slot did
    for (int nd = tid; nd < g.n; nd += blockDim.x) {
        for (int wi = 0; wi < w; ++wi) {
            uint32_t pw = 0u, bw = 0u;
            for (int b = 0; b < 32; ++b) {
                const int t = wi * 32 + b;
                if (t >= t_dim) break;
                const int s = min(max(g.slot_of_t[t], 0), g.tk - 1);
                const int v = g.topo_ids[(size_t)nd * g.tk + s];
                if (v < 0) continue;
                const size_t gi = (size_t)min(v, g.z - 1) * t_dim + t;
                if (z_mi[gi]) pw |= 1u << b;
                if (z_an[gi]) bw |= 1u << b;
            }
            present[(size_t)nd * w + wi] |= pw;
            blocked[(size_t)nd * w + wi] |= bw;
        }
    }
}

}  // namespace

extern "C" int auction_interpod_launch(
    int n, int p, int t_dim, int tk, int z, int w,
    const void* topo_ids, const void* slot_of_t, const void* bid,
    const void* mi_dense, const void* anti_dense, const void* solve_pos,
    const void* state, void* accept, void* present, void* blocked, void* global_any,
    void* minpos, void* carrier, void* z_mi, void* z_an, void* release, void* stream)
{
    if (t_dim < 1 || tk < 1 || z < 1 || w != (t_dim + 31) / 32) return (int)cudaErrorInvalidValue;
    if (p == 0 || n == 0) return 0;
    Groups g;
    g.n = n;
    g.t_dim = t_dim;
    g.tk = tk;
    g.z = z;
    g.topo_ids = (const int32_t*)topo_ids;
    g.slot_of_t = (const int32_t*)slot_of_t;
    g.bid = (const int32_t*)bid;
    interpod_repair_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        p, w, g, (const uint8_t*)mi_dense, (const uint8_t*)anti_dense,
        (const int32_t*)solve_pos, (const int32_t*)state, (uint8_t*)accept,
        (uint32_t*)present, (uint32_t*)blocked, (uint32_t*)global_any,
        (int32_t*)minpos, (uint8_t*)carrier, (uint8_t*)z_mi, (uint8_t*)z_an,
        (uint8_t*)release);
    return (int)cudaGetLastError();
}

extern "C" const char* auction_interpod_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
