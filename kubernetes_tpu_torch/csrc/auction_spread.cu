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
// Bound on this card: the bytes are the [C, N] counts (and a [C, Z] value
// table) moved a few times, microseconds of the card's memory rate.  The
// ranks are the sequential part: a rank counts earlier positions in solve
// order, so a row's ranks are a running count per value along P.  The
// first design had the thread at position k walk every earlier position
// (P^2 / 2 dependent loads a row a pass; at 2,048 pods ~1.9 ms a round on
// one SM of an H100).
//
// Design: one block of 1,024 threads, launched once a round between
// auction_accept's two stages and returning at once when the device's
// continue flag (state[1]) is down.  Per admit pass:
//   rows     only the hard rows are read within a round (a soft row ranks
//            no pod), so the block lists them (up to 1,024 at a time) and
//            keeps the working counts of those rows alone;
//   minima   every hard row's critical-path minimum over the whole block:
//            with L listed rows and W = 32 warps, W / L warps a row (one
//            warp a row when L >= W), each strided over N, merged by fminf;
//   ranks    a warp walks a hard row's P positions in solve order, 32 at
//            a time (8 chunks' loads issued, branch-free, before the 8 are
//            walked).  Each lane's key is its pod's bid-node value in the
//            row when the pod is a candidate that matches the row or is
//            ranked in it (else none); __match_any_sync gives the lanes of
//            its value, and the rank is that value's running counter plus
//            the matching peers in lower lanes (__popc(peers & from &
//            lanemask_lt)).  The lowest lane of each value then adds the
//            value's matching peers to the counter.  A pod ranked in the
//            row is refused (admit = 0) when its rank reaches the bound.
//            The counters are the row's [Z] table: in shared memory when
//            Z <= kShZ (a zone key), else the row's slice of the global
//            [C, Z] scratch `adds` (a hostname key), zeroed first.  With
//            shared tables and L < W hard rows, each row gets W / L warps,
//            each walking one contiguous segment of the solve order: a
//            first sweep counts each segment's matching candidates per
//            value (shared atomics), an exclusive prefix over the row's
//            warps gives each segment its starting counters, and the walk
//            starts from them.  Otherwise a warp walks a whole row;
//   commit   integer counts added in value space with integer atomics, then
//            read back per node, as the reference's one-hot matmuls do —
//            over (pod, row) pairs, and read back only in the rows some pod
//            added to (the working commits: hard rows only; the last commit
//            into the carried counts: every row).
// That is P / 32 sequential chunks a row (P / (32 W / L) with segments)
// instead of P^2 / 2 loads.
// Exactness: ranks are integers, and counts are integer-valued floats
// below 2^24, so every add is exact and neither the order of the atomics
// nor the split of the minima over warps changes a bit.  A hard row's
// values lie in [0, Z) (Z is the spread slots' value capacity); the table
// index is clamped into it as the commit's is.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRepairIters = 3;  // ops/auction.py SPREAD_REPAIR_ITERS
constexpr int kShZ = 256;        // counters a warp keeps in shared memory
constexpr int kBatch = 8;        // chunks of 32 positions loaded before the walk
constexpr int kRowChunk = kThreads;  // rows listed at once

// The block's shared scratch.
struct Shared {
    int tab[kWarps * kShZ];      // each warp's counter table (Z <= kShZ)
    float part[kWarps];          // partial minima
    int rows[kRowChunk];         // the current chunk's hard rows
    int rows2[kRowChunk];        // the rows a commit added to
    int n_rows;
    uint8_t touched[kRowChunk];
};

// List map(q) for every q < count with keep(q) into out (in no particular
// order: every row is handled alone).  Block-wide; ends on a barrier.
// Returns the count listed.
template <class Keep, class Map>
__device__ int list_rows(int count, Keep keep, Map map, int* out, Shared& sh)
{
    if (threadIdx.x == 0) sh.n_rows = 0;
    __syncthreads();
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
        if (keep(q)) out[atomicAdd(&sh.n_rows, 1)] = map(q);
    }
    __syncthreads();
    return sh.n_rows;
}

// The hard rows of [cb, cb + kRowChunk) into sh.rows.
__device__ int list_hard(const Spread& sp, int cb, Shared& sh)
{
    return list_rows(min(kRowChunk, sp.c_dim - cb), [&](int q) { return sp.hard[cb + q] != 0; },
                     [&](int q) { return cb + q; }, sh.rows, sh);
}

// counts[c, n] += the marked pods' placements in row c at the nodes that
// share their bid node's value: with hard_only in the hard rows (the
// working counts), else in every row.  The adds are gathered in value
// space first (integer atomics into `adds`) over (pod, row) pairs, then
// read back per node in the rows some pod added to.
__device__ void commit_marked(const Spread& sp, int n, int p, int z, const int32_t* bid,
                              const uint8_t* marked, bool hard_only, int32_t* adds,
                              float* counts, Shared& sh)
{
    const int tid = threadIdx.x;
    const int c_dim = sp.c_dim;
    for (int cb = 0; cb < c_dim; cb += kRowChunk) {
        const int rows = hard_only ? list_hard(sp, cb, sh) : min(kRowChunk, c_dim - cb);
        auto row = [&](int q) { return hard_only ? sh.rows[q] : cb + q; };
        for (int q = tid; q < rows; q += blockDim.x) sh.touched[q] = 0;
        for (int t = tid; t < rows * z; t += blockDim.x) adds[(size_t)row(t / z) * z + t % z] = 0;
        __syncthreads();
#pragma unroll 4
        for (int t = tid; t < p * rows; t += blockDim.x) {
            const int i = t / rows, q = t % rows, c = row(q);
            if (!(marked[i] & sp.pod_matches[(size_t)i * c_dim + c])) continue;
            const size_t o = (size_t)c * n + min(max(bid[i], 0), n - 1);
            const int val = sp.v[o];
            if (sp.eligible[o] && val >= 0) {
                atomicAdd(&adds[(size_t)c * z + min(val, z - 1)], 1);
                sh.touched[q] = 1;
            }
        }
        __syncthreads();
        const int nt = list_rows(rows, [&](int q) { return sh.touched[q] != 0; }, row,
                                 sh.rows2, sh);
        for (int t = tid; t < nt * n; t += blockDim.x) {
            const int c = sh.rows2[t / n];
            const size_t o = (size_t)c * n + t % n;
            const int val = sp.v[o];
            if (val < 0) continue;
            const int a = adds[(size_t)c * z + min(val, z - 1)];
            if (a) counts[o] = add(counts[o], (float)a);
        }
        __syncthreads();
    }
}

// The critical-path minimum of each listed row against the working counts,
// block-wide: kWarps / L warps a row for L listed rows (one warp a row when
// L >= kWarps), each strided over N, merged by fminf.
__device__ void row_minima(const Spread& sp, int n, int n_rows, const float* counts_it,
                           float* minc, Shared& sh)
{
    if (n_rows == 0) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wpr = n_rows >= kWarps ? 1 : kWarps / n_rows;   // warps a row
    const int at_once = kWarps / wpr;                         // rows in flight
    for (int base = 0; base < n_rows; base += at_once) {
        const int r = base + warp / wpr, part = warp % wpr;
        float m = kBig;
        if (warp < at_once * wpr && r < n_rows) {
            const size_t o = (size_t)sh.rows[r] * n;
            for (int nd = part * 32 + lane; nd < n; nd += wpr * 32) {
                if (sp.eligible[o + nd]) m = fminf(m, counts_it[o + nd]);
            }
        }
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
        if (lane == 0) sh.part[warp] = m;
        __syncthreads();
        if (tid < at_once && base + tid < n_rows) {
            float mm = kBig;
            for (int q = 0; q < wpr; ++q) mm = fminf(mm, sh.part[tid * wpr + q]);
            const int c = sh.rows[base + tid];
            minc[c] = spread_min_final(sp, c, mm);
        }
        __syncthreads();
    }
}

// One solve position in row c: the candidate's value key (-1: not a
// candidate matching or ranked in the row), whether it counts (matches the
// row) and is ranked (the row is its own hard row), and its bound.  Every
// load is issued whatever the position holds, so a batch's loads overlap.
struct Entry {
    int key, pod;
    bool from, ranked;
    float allowed;
};

__device__ __forceinline__ Entry load_entry(const Spread& sp, int n, int p, int z, int c,
                                            float skew_min, int k, const int32_t* order,
                                            const int32_t* bid, const uint8_t* cand,
                                            const float* counts_it)
{
    const bool in = k < p;
    const int i = order[in ? k : 0];
    const size_t o = (size_t)c * n + min(max(bid[i], 0), n - 1);
    const bool m = sp.pod_matches[(size_t)i * sp.c_dim + c] != 0;
    bool own = false;
    for (int j = 0; j < sp.mc; ++j) {
        const int cidx = sp.pod_idx[(size_t)i * sp.mc + j];
        own |= cidx >= 0 && min(cidx, sp.c_dim - 1) == c;
    }
    const int val = sp.v[o];
    const float cnt = counts_it[o];
    const bool act = in && cand[i] && val >= 0 && (m || own);
    Entry e;
    e.key = act ? min(val, z - 1) : -1;
    e.pod = i;
    e.from = act && m;
    e.ranked = act && own;
    e.allowed = add(sub(skew_min, cnt), sub(1.0f, m ? 1.0f : 0.0f));
    return e;
}

// The admit test of one pass over the listed (hard) rows: admit[i] starts
// as cand[i]; the walk clears it for every pod ranked in a row whose rank
// reaches maxSkew + min - count + (1 - selfMatch).  With the counters in
// shared memory and fewer rows than warps, each row's W / L warps split the
// solve order into segments: each warp first counts its segment's matching
// candidates per value (shared atomics), an exclusive prefix over the
// row's warps turns those into each segment's starting counters, then each
// warp walks its segment.  Otherwise one warp walks a row from zero.
__device__ void rank_rows(const Spread& sp, int n, int p, int z, int n_rows,
                          const int32_t* order, const int32_t* bid, const uint8_t* cand,
                          const float* counts_it, const float* minc, int32_t* adds,
                          uint8_t* admit, Shared& sh)
{
    if (n_rows == 0) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;   // lanemask_lt
    const bool in_shared = z <= kShZ;
    const int wpr = in_shared && n_rows < kWarps ? kWarps / n_rows : 1;   // warps a row
    const int at_once = kWarps / wpr;
    const int seg = (p + wpr * 32 - 1) / (wpr * 32) * 32;   // a warp's positions
    for (int base = 0; base < n_rows; base += at_once) {
        const int r = base + warp / wpr, part = warp % wpr;
        const bool active = warp < at_once * wpr && r < n_rows;
        const int c = active ? sh.rows[r] : 0;
        int* tab = in_shared ? sh.tab + warp * kShZ : adds + (size_t)c * z;
        const int k_lo = min(p, part * seg), k_hi = min(p, k_lo + seg);
        const size_t oc = (size_t)c * n;
        const float skew_min = active ? add(sp.max_skew[c], minc[c]) : 0.0f;
        if (active) {
            for (int t = lane; t < z; t += 32) tab[t] = 0;
            __syncwarp();
        }
        if (wpr > 1) {
            if (active) {
                for (int k = k_lo + lane; k < k_hi; k += 32) {
                    const Entry e = load_entry(sp, n, p, z, c, skew_min, k, order, bid, cand,
                                               counts_it);
                    if (e.from) atomicAdd(&tab[e.key], 1);
                }
            }
            __syncthreads();
            // exclusive prefix over each row's warps, value by value
            for (int t = threadIdx.x; t < at_once * z; t += blockDim.x) {
                const int rr = t / z, v = t % z;
                if (base + rr >= n_rows) continue;
                int run = 0;
                for (int q = 0; q < wpr; ++q) {
                    int* cell = sh.tab + (rr * wpr + q) * kShZ + v;
                    const int x = *cell;
                    *cell = run;
                    run += x;
                }
            }
            __syncthreads();
        }
        if (active) {
            for (int k0 = k_lo; k0 < k_hi; k0 += 32 * kBatch) {
                Entry e[kBatch];
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const int k = k0 + b * 32 + lane;
                    e[b] = load_entry(sp, n, p, z, c, skew_min, k < k_hi ? k : p, order, bid,
                                      cand, counts_it);
                }
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const unsigned peers = __match_any_sync(0xffffffffu, e[b].key);
                    const unsigned group = peers & __ballot_sync(0xffffffffu, e[b].from);
                    const int before = e[b].key >= 0 ? tab[e[b].key] : 0;
                    if (e[b].ranked && (float)(before + __popc(group & below)) >= e[b].allowed) {
                        admit[e[b].pod] = 0;
                    }
                    __syncwarp();
                    if (e[b].key >= 0 && group != 0u && lane == __ffs(peers) - 1) {
                        tab[e[b].key] = before + __popc(group);
                    }
                    __syncwarp();
                }
            }
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads, 1) spread_repair_kernel(
    int n, int p, int z, Spread sp,
    const int32_t* __restrict__ order, const int32_t* __restrict__ bid,
    const int32_t* __restrict__ state, uint8_t* accept,
    float* counts_it, int32_t* adds, float* minc,           // [C, N], [C, Z], [C]
    uint8_t* kept, uint8_t* cand, uint8_t* admit)           // [P] each
{
    __shared__ Shared sh;
    if (!state[1]) return;
    const int tid = threadIdx.x;
    const int c_dim = sp.c_dim;
    for (int i = tid; i < p; i += blockDim.x) kept[i] = 0;
    // the working counts: only the hard rows are ever read
    for (int cb = 0; cb < c_dim; cb += kRowChunk) {
        const int nh = list_hard(sp, cb, sh);
        for (int t = tid; t < nh * n; t += blockDim.x) {
            const size_t o = (size_t)sh.rows[t / n] * n + t % n;
            counts_it[o] = sp.counts[o];
        }
        __syncthreads();
    }

    for (int it = 0; it < kRepairIters; ++it) {
        for (int i = tid; i < p; i += blockDim.x) {
            const uint8_t cd = accept[i] && !kept[i];
            cand[i] = cd;
            admit[i] = cd;
        }
        for (int cb = 0; cb < c_dim; cb += kRowChunk) {
            const int nh = list_hard(sp, cb, sh);         // ends on a barrier
            row_minima(sp, n, nh, counts_it, minc, sh);
            rank_rows(sp, n, p, z, nh, order, bid, cand, counts_it, minc, adds, admit, sh);
            __syncthreads();
        }
        commit_marked(sp, n, p, z, bid, admit, true, adds, counts_it, sh);
        for (int i = tid; i < p; i += blockDim.x) kept[i] |= admit[i];
        __syncthreads();
    }
    // the kept pods' counts, and the accepted set the commit stage reads
    commit_marked(sp, n, p, z, bid, kept, false, adds, sp.counts, sh);
    for (int i = tid; i < p; i += blockDim.x) accept[i] = kept[i];
}

}  // namespace

// The largest value space whose rank counters stay in shared memory.
extern "C" int auction_spread_limits()
{
    return kShZ;
}

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
