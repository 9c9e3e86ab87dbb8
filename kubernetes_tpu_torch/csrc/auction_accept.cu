// Kernel `auction_accept`: one round's per-node acceptance and commit.
//
// Replaces: kubernetes_tpu/ops/auction.py:680-745, the `body` of the
// auction's while_loop around its spread repair (kernel auction_spread)
// and without its anti-affinity branch, and its `cond`: pods pre-permuted
// into solve order and stably sorted by
// bid (:694-695); a pod's demand on its node as a difference of global
// prefix sums, within = prefix - prefix[first] + sreq[first] (:697-699),
// held against the node's remaining capacity (:700-705); the commit
// scatter of requested and nonzero_requested (:727-730); the assigned and
// bid_scores update (:737-738); the progress flag and the loop condition
// (:725, :742-745).
//
// Bound on this card: the sort compares each pod with every other
// (P^2 integer tests); the rest moves the pods' requests and the bid
// nodes' rows once.  At the main path's shapes both are microseconds of
// the card's rates.
//
// Design: two kernels per round, both returning at once when the device's
// continue flag (state[1]) is down, so all max_rounds rounds are enqueued
// with no host sync.  `stage` 3 runs the round whole; with the spread
// family the round is split around the repair: stage 1 (sort, acceptance,
// progress into state[2]), then kernel auction_spread (which narrows the
// accepted set in `accept`), then stage 2 (the commit and the state):
//   sort_pass    one thread per solve position, 256 a block: its sorted
//                position is the count of pods with a smaller bid plus the
//                count with the same bid earlier in solve order (a tiled
//                pass over the bids in solve order) — the stable sort of
//                the reference, by counting; it also records the position
//                of its bid group's first member (searchsorted left), and
//                its position in a second order, by (bid, pod index), for
//                the commit;
//   commit_pass  one 1,024-thread block: the inclusive prefix of the
//                requests in sorted order, acceptance per sorted position,
//                the commit — each node group's first member adds its
//                accepted members' requests in pod index order, the order
//                of the reference's scatter-add — the assigned /
//                bid_scores update, then state: rounds + 1, progress, and
//                the flag = rounds < max_rounds && progress && some valid
//                pod unplaced.
// A third entry point, auction_accept_release, is the gang post-pass's
// subtraction (auction.py:771-848): every node takes its released pods'
// requests off in pod index order, the order of the reference's masked
// scatter-add, one thread a node.
// The prefix adds in the order XLA's CPU backend adds the reference's
// jnp.cumsum (a cumulative reduce-window rewritten as sequential scans of
// blocks of 16 rows, the block totals scanned the same way, recursively,
// then each block's exclusive total added back).  Every sum is a float32
// round-to-nearest add, so the kernel, its plain version (ops/auction.py
// `prefix_sum`) and the reference run on the CPU agree for any request
// values, also where the prefix passes float32's exact range.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kSortThreads = 256;
constexpr int kThreads = 1024;
constexpr int kScanBlock = 16;   // XLA's block for a rewritten cumulative sum
constexpr int kMaxLevels = 9;    // 16^8 rows

__global__ void __launch_bounds__(kSortThreads) sort_pass_kernel(
    int p, const int32_t* __restrict__ order, const int32_t* __restrict__ bid,
    const int32_t* __restrict__ state, int32_t* perm, int32_t* firstpos,
    int32_t* perm_idx)
{
    if (!state[1]) return;
    __shared__ int s_bid[kSortThreads];
    __shared__ int s_pod[kSortThreads];
    const int q = (int)(blockIdx.x * kSortThreads + threadIdx.x);
    int i = -1, b = 0;
    if (q < p) {
        i = order[q];
        b = bid[i];
    }
    int less = 0, same_before = 0, same_lower = 0;
    for (int base = 0; base < p; base += kSortThreads) {
        const int k = base + threadIdx.x;
        const int pod = k < p ? order[k] : 0;
        s_pod[threadIdx.x] = pod;
        s_bid[threadIdx.x] = k < p ? bid[pod] : 0;
        __syncthreads();
        const int lim = min(kSortThreads, p - base);
        for (int t = 0; t < lim; ++t) {
            const int kb = s_bid[t];
            less += kb < b ? 1 : 0;
            same_before += (kb == b && base + t < q) ? 1 : 0;
            same_lower += (kb == b && s_pod[t] < i) ? 1 : 0;
        }
        __syncthreads();
    }
    if (q >= p) return;
    const int pos = less + same_before;
    perm[pos] = i;
    firstpos[pos] = less;
    perm_idx[less + same_lower] = i;
}

// Sequential inclusive scans of the blocks of kScanBlock rows of a [len, r]
// array, in place; with `totals`, each block's total goes to its row there.
__device__ void scan_blocks(float* a, int len, int r, float* totals, int tid)
{
    const int nb = (len + kScanBlock - 1) / kScanBlock;
    for (int b = tid; b < nb; b += kThreads) {
        const int lo = b * kScanBlock, hi = min(len, lo + kScanBlock);
        for (int rr = 0; rr < r; ++rr) {
            float run = 0.0f;
            for (int q = lo; q < hi; ++q) {
                run = add(run, a[(size_t)q * r + rr]);
                a[(size_t)q * r + rr] = run;
            }
            if (totals) totals[(size_t)b * r + rr] = run;
        }
    }
}

// The acceptance half of a round, block-wide: the prefix of the requests
// in sorted order, then accept[i] per pod; returns the round's progress
// (some pod accepted).
__device__ int accept_block(
    int n, int r, int p, const float* __restrict__ alloc, const float* requested,
    const float* __restrict__ pod_req, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ firstpos, const int32_t* __restrict__ bid,
    float* prefix, float* scan, uint8_t* accept)
{
    const int tid = threadIdx.x;
    // inclusive prefix of the requests in sorted order, in XLA's order:
    // level 0 is the gathered requests, level k + 1 the block totals of
    // level k (in `scan`), up to a level of one block; scanned upwards,
    // then each block's exclusive total added downwards
    for (int q = tid; q < p; q += kThreads) {
        for (int rr = 0; rr < r; ++rr) {
            prefix[(size_t)q * r + rr] = pod_req[(size_t)perm[q] * r + rr];
        }
    }
    float* level[kMaxLevels];
    int len[kMaxLevels];
    level[0] = prefix;
    len[0] = p;
    int top = 0;
    float* next = scan;
    while (len[top] > kScanBlock) {
        len[top + 1] = (len[top] + kScanBlock - 1) / kScanBlock;
        level[top + 1] = next;
        next += (size_t)len[top + 1] * r;
        ++top;
    }
    __syncthreads();
    for (int k = 0; k <= top; ++k) {
        scan_blocks(level[k], len[k], r, k < top ? level[k + 1] : nullptr, tid);
        __syncthreads();
    }
    for (int k = top - 1; k >= 0; --k) {
        for (int q = tid; q < len[k]; q += kThreads) {
            const int b = q / kScanBlock;
            if (b == 0) continue;
            for (int rr = 0; rr < r; ++rr) {
                level[k][(size_t)q * r + rr] = add(level[k][(size_t)q * r + rr],
                                                   level[k + 1][(size_t)(b - 1) * r + rr]);
            }
        }
        __syncthreads();
    }

    // acceptance per sorted position
    int any_ok = 0;
    for (int q = tid; q < p; q += kThreads) {
        const int i = perm[q];
        const int b = bid[i];
        bool ok = b < n;
        if (ok) {
            const int f = firstpos[q];
            const int fi = perm[f];
            for (int rr = 0; rr < r; ++rr) {
                const float req = pod_req[(size_t)i * r + rr];
                const float within = add(sub(prefix[(size_t)q * r + rr], prefix[(size_t)f * r + rr]),
                                         pod_req[(size_t)fi * r + rr]);
                const float remaining = sub(alloc[(size_t)b * r + rr], requested[(size_t)b * r + rr]);
                if (!(req <= 0.0f || within <= remaining)) ok = false;
            }
        }
        accept[i] = ok ? 1 : 0;
        any_ok |= ok ? 1 : 0;
    }
    return __syncthreads_or(any_ok);
}

__global__ void __launch_bounds__(kThreads, 1) commit_pass_kernel(
    int n, int r, int p, int max_rounds, int stage,
    const float* __restrict__ alloc, float* requested, float* nonzero,
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const uint8_t* __restrict__ pod_valid,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ firstpos,
    const int32_t* __restrict__ perm_idx,
    const int32_t* __restrict__ bid, const float* __restrict__ val,
    int32_t* assigned, float* bid_scores, int32_t* state,
    float* prefix, float* scan, uint8_t* accept)  // [P, R], [levels, R], [P] scratch
{
    if (!state[1]) return;
    const int tid = threadIdx.x;
    int progress;
    if (stage & 1) {
        progress = accept_block(n, r, p, alloc, requested, pod_req, perm, firstpos, bid,
                                prefix, scan, accept);
        if (!(stage & 2)) {
            if (tid == 0) state[2] = progress;
            return;
        }
    } else {
        progress = state[2];  // stage 2: the acceptance's progress, before the repair
    }

    // commit: each node group's first member adds the accepted requests
    // in pod index order (the group spans the same positions in perm_idx)
    for (int q = tid; q < p; q += kThreads) {
        if (firstpos[q] != q) continue;
        const int b = bid[perm[q]];
        if (b >= n) continue;
        for (int q2 = q; q2 < p && bid[perm_idx[q2]] == b; ++q2) {
            const int i2 = perm_idx[q2];
            if (!accept[i2]) continue;
            for (int rr = 0; rr < r; ++rr) {
                requested[(size_t)b * r + rr] = add(requested[(size_t)b * r + rr], pod_req[(size_t)i2 * r + rr]);
                nonzero[(size_t)b * r + rr] = add(nonzero[(size_t)b * r + rr], pod_nz[(size_t)i2 * r + rr]);
            }
        }
    }
    for (int i = tid; i < p; i += kThreads) {
        if (accept[i]) {
            assigned[i] = bid[i];
            bid_scores[i] = val[i];
        }
    }
    __syncthreads();
    int unplaced = 0;
    for (int i = tid; i < p; i += kThreads) unplaced |= (assigned[i] < 0 && pod_valid[i]) ? 1 : 0;
    unplaced = __syncthreads_or(unplaced);
    if (tid == 0) {
        const int rounds = state[0] + 1;
        state[0] = rounds;
        state[1] = (rounds < max_rounds && progress && unplaced) ? 1 : 0;
        state[2] = progress ? 1 : 0;
    }
}

// The gang post-pass's release: node b subtracts the requests of every
// dropped pod assigned to it, in pod index order (one thread a node).
__global__ void release_kernel(
    int n, int r, int p, const int32_t* __restrict__ assigned,
    const uint8_t* __restrict__ dropped, const float* __restrict__ pod_req,
    const float* __restrict__ pod_nz, float* requested, float* nonzero)
{
    const int b = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    if (b >= n) return;
    for (int i = 0; i < p; ++i) {
        if (!dropped[i] || assigned[i] != b) continue;
        for (int rr = 0; rr < r; ++rr) {
            requested[(size_t)b * r + rr] = sub(requested[(size_t)b * r + rr], pod_req[(size_t)i * r + rr]);
            nonzero[(size_t)b * r + rr] = sub(nonzero[(size_t)b * r + rr], pod_nz[(size_t)i * r + rr]);
        }
    }
}

}  // namespace

extern "C" int auction_accept_release(
    int n, int r, int p, const void* assigned, const void* dropped, const void* pod_req,
    const void* pod_nz, void* requested, void* nonzero, void* stream)
{
    if (p == 0 || n == 0) return 0;
    release_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        n, r, p, (const int32_t*)assigned, (const uint8_t*)dropped, (const float*)pod_req,
        (const float*)pod_nz, (float*)requested, (float*)nonzero);
    return (int)cudaGetLastError();
}

extern "C" int auction_accept_launch(
    int n, int r, int p, int max_rounds, int stage,
    const void* alloc, void* requested, void* nonzero, const void* pod_req,
    const void* pod_nz, const void* pod_valid, const void* order, const void* bid,
    const void* val, void* assigned, void* bid_scores, void* state, void* perm,
    void* firstpos, void* perm_idx, void* prefix, void* scan, void* accept,
    void* stream)
{
    if (r > kMaxR || stage < 1 || stage > 3) return (int)cudaErrorInvalidValue;
    if (p == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (stage & 1) {
        sort_pass_kernel<<<(p + kSortThreads - 1) / kSortThreads, kSortThreads, 0, s>>>(
            p, (const int32_t*)order, (const int32_t*)bid, (const int32_t*)state,
            (int32_t*)perm, (int32_t*)firstpos, (int32_t*)perm_idx);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    commit_pass_kernel<<<1, kThreads, 0, s>>>(
        n, r, p, max_rounds, stage, (const float*)alloc, (float*)requested, (float*)nonzero,
        (const float*)pod_req, (const float*)pod_nz, (const uint8_t*)pod_valid,
        (const int32_t*)perm, (const int32_t*)firstpos, (const int32_t*)perm_idx,
        (const int32_t*)bid, (const float*)val, (int32_t*)assigned, (float*)bid_scores,
        (int32_t*)state, (float*)prefix, (float*)scan, (uint8_t*)accept);
    return (int)cudaGetLastError();
}

extern "C" const char* auction_accept_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
