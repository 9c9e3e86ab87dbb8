// Kernel `preempt_dry_run`: preemption's cumulative victim subtraction.
//
// Replaces: kubernetes_tpu/ops/preemption.py:129 `batched_dry_run` (entry
// preempt_dry_run_launch) and :70 `dry_run_victims` (entry
// preempt_dry_run_victims_launch).  Both run the same two stages.
//
//   Stage 1, one thread per (level l, node n, resource r): gather the
//   node's victims in the level's eviction order (perm; the identity for
//   dry_run_victims), multiply each by its 0/1 mask (the level's
//   evictable prefix, k < elig_len; or victim_valid, which need not be a
//   prefix) as the reference does — padding slots may hold junk —, and
//   prefix-sum over k into cum[l, n, :, r].  The r == 0 thread also
//   prefix-sums the PDB-violation flags of the prefix (int32) and stores
//   the largest admissible k (elig_len, or the count of valid slots).
//
//   Stage 2, one thread per (pod p, node n): walk k = 0..K of the pod's
//   level; free_k = free + cum[k - 1] (k = 0: free + 0.0, the reference's
//   concatenated zero row); the first k with req <= 0 || req <= free_k on
//   every resource and k <= the admissible bound is min_k (0 and
//   infeasible when none fits, as jnp.argmax returns); viol_k is the
//   violation prefix at min_k.
//
// Numerics: the prefix sum adds in the reference compiler's CPU order for
// jnp.cumsum (ops/auction.py prefix_sum, auction_common.cuh scan_blocks):
// sequentially inside blocks of 16 (zero-padded), the block totals
// prefix-summed the same way, then each block's exclusive total added.
// Requests that are not whole MiB leave float32's exact range once a
// node's victims pass 4,096 MiB, and then the order decides which k fits.
// Every add and multiply is __fadd_rn / __fmul_rn (built --fmad=false);
// free is the host's allocatable - requested, used as given (never
// rearranged into req - cum <= free).
//
// Bound on this card: bytes.  The inputs (free, the victims' requests,
// the orders and flags, the pods' requests) are read once and the three
// [P, N] outputs written once; the work is a few float operations per
// (l, n, k, r) and per (p, n, k, r).  Stage 1 writes its sums to global
// scratch ([L, N, K, R] floats) that stage 2 reads back — in L2 at the
// shapes the scheduler sends (one pass: P <= 16 pods, K <= 128 slots).
// Design: one thread a row and no shared memory; the block-order prefix
// keeps its block totals in a small local array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanBlock = 16;               // ops/auction.py SCAN_BLOCK
constexpr int kMaxK = kScanBlock * kScanBlock * kScanBlock;  // two recursion levels

// In-place inclusive prefix sum of x[i * stride], i < n <= kMaxK, in
// ops/auction.py prefix_sum's order.
__device__ void prefix_sum_ordered(float* x, int n, int stride)
{
    float t1[kScanBlock * kScanBlock];       // block totals, then their prefix
    const int nb0 = (n + kScanBlock - 1) / kScanBlock;
    for (int b = 0; b < nb0; ++b) {
        float run = 0.0f;
        for (int j = 0; j < kScanBlock; ++j) {
            const int i = b * kScanBlock + j;
            run = __fadd_rn(run, i < n ? x[(size_t)i * stride] : 0.0f);
            if (i < n) x[(size_t)i * stride] = run;
        }
        t1[b] = run;
    }
    if (nb0 == 1) return;
    // the block totals' prefix, the same way: blocks of 16 ...
    const int nb1 = (nb0 + kScanBlock - 1) / kScanBlock;
    float t2[kScanBlock];
    for (int c = 0; c < nb1; ++c) {
        float run = 0.0f;
        for (int j = 0; j < kScanBlock; ++j) {
            const int i = c * kScanBlock + j;
            run = __fadd_rn(run, i < nb0 ? t1[i] : 0.0f);
            if (i < nb0) t1[i] = run;
        }
        t2[c] = run;
    }
    // ... whose totals (at most 16: one block) are summed sequentially
    if (nb1 > 1) {
        float run = 0.0f;
        for (int c = 0; c < nb1; ++c) {
            run = __fadd_rn(run, t2[c]);
            t2[c] = run;
        }
        for (int i = kScanBlock; i < nb0; ++i) t1[i] = __fadd_rn(t1[i], t2[i / kScanBlock - 1]);
    }
    for (int i = kScanBlock; i < n; ++i) {
        const size_t o = (size_t)i * stride;
        x[o] = __fadd_rn(x[o], t1[i / kScanBlock - 1]);
    }
}

// Stage 1: masked victims in eviction order, prefix-summed per (l, n, r).
// perm / elig_len / viol are null in dry_run_victims mode (valid given).
__global__ void stage1_kernel(
    int l_dim, int n, int k, int r,
    const float* __restrict__ victim_req,   // [N, K, R]
    const int32_t* __restrict__ perm,       // [L, N, K] or null
    const int32_t* __restrict__ elig_len,   // [L, N] or null
    const uint8_t* __restrict__ valid,      // [N, K] or null
    const uint8_t* __restrict__ viol,       // [L, N, K] or null
    float* __restrict__ cum,                // [L, N, K, R]
    int32_t* __restrict__ cum_viol,         // [L, N, K]
    int32_t* __restrict__ bound)            // [L, N]
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)l_dim * n * r) return;
    const int rr = (int)(t % r);
    const long long ln = t / r;
    const int node = (int)(ln % n);
    int lim = 0;
    if (valid != nullptr) {
        for (int j = 0; j < k; ++j) lim += valid[(size_t)node * k + j] ? 1 : 0;
    } else {
        lim = elig_len[ln];
    }
    float* c = cum + (size_t)ln * k * r + rr;
    for (int j = 0; j < k; ++j) {
        int src = j;
        bool in = false;
        if (valid != nullptr) {
            in = valid[(size_t)node * k + j] != 0;
        } else {
            src = min(max(perm[(size_t)ln * k + j], 0), k - 1);
            in = j < lim;
        }
        const float v = victim_req[((size_t)node * k + src) * r + rr];
        c[(size_t)j * r] = __fmul_rn(v, in ? 1.0f : 0.0f);
    }
    prefix_sum_ordered(c, k, r);
    if (rr == 0) {
        bound[ln] = lim;
        int run = 0;
        for (int j = 0; j < k; ++j) {
            if (viol != nullptr && j < lim && viol[(size_t)ln * k + j]) ++run;
            cum_viol[(size_t)ln * k + j] = run;
        }
    }
}

// Stage 2: the first fitting k per (pod, node).
__global__ void stage2_kernel(
    int l_dim, int n, int k, int r, int p,
    const float* __restrict__ free,         // [N, R]
    const float* __restrict__ pods_req,     // [P, R]
    const int32_t* __restrict__ pod_level,  // [P] or null (level 0)
    const float* __restrict__ cum,          // [L, N, K, R]
    const int32_t* __restrict__ cum_viol,   // [L, N, K]
    const int32_t* __restrict__ bound,      // [L, N]
    uint8_t* __restrict__ feasible,         // [P, N]
    int32_t* __restrict__ min_k,            // [P, N]
    int32_t* __restrict__ viol_k)           // [P, N] or null
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)p * n) return;
    const int node = (int)(t % n);
    const int pod = (int)(t / n);
    const int lvl = pod_level != nullptr ? min(max(pod_level[pod], 0), l_dim - 1) : 0;
    const size_t ln = (size_t)lvl * n + node;
    const float* c = cum + ln * k * r;
    const float* fr = free + (size_t)node * r;
    const float* req = pods_req + (size_t)pod * r;
    const int kmax = min(k, bound[ln]);
    int found = -1;
    for (int j = 0; j <= kmax && found < 0; ++j) {
        bool ok = true;
        for (int rr = 0; rr < r; ++rr) {
            const float q = req[rr];
            const float f = __fadd_rn(fr[rr], j == 0 ? 0.0f : c[(size_t)(j - 1) * r + rr]);
            if (!(q <= 0.0f || q <= f)) ok = false;
        }
        if (ok) found = j;
    }
    feasible[t] = found >= 0 ? 1 : 0;
    min_k[t] = found > 0 ? found : 0;
    if (viol_k != nullptr) viol_k[t] = found > 0 ? cum_viol[ln * k + found - 1] : 0;
}

int launch(int l_dim, int n, int k, int r, int p,
           const void* free, const void* victim_req, const void* perm,
           const void* elig_len, const void* valid, const void* viol,
           const void* pods_req, const void* pod_level,
           void* cum, void* cum_viol, void* bound,
           void* feasible, void* min_k, void* viol_k, void* stream)
{
    if (k < 1 || k > kMaxK || r < 1 || l_dim < 1) return (int)cudaErrorInvalidValue;
    if (n == 0 || p == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const long long rows = (long long)l_dim * n * r;
    stage1_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        l_dim, n, k, r, (const float*)victim_req, (const int32_t*)perm,
        (const int32_t*)elig_len, (const uint8_t*)valid, (const uint8_t*)viol,
        (float*)cum, (int32_t*)cum_viol, (int32_t*)bound);
    const long long pairs = (long long)p * n;
    stage2_kernel<<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        l_dim, n, k, r, p, (const float*)free, (const float*)pods_req,
        (const int32_t*)pod_level, (const float*)cum, (const int32_t*)cum_viol,
        (const int32_t*)bound, (uint8_t*)feasible, (int32_t*)min_k, (int32_t*)viol_k);
    return (int)cudaGetLastError();
}

}  // namespace

// batched_dry_run: every preemptor of a pass against every candidate node.
extern "C" int preempt_dry_run_launch(
    int l_dim, int n, int k, int r, int p,
    const void* free, const void* victim_req, const void* perm, const void* elig_len,
    const void* viol, const void* pods_req, const void* pod_level,
    void* cum, void* cum_viol, void* bound,
    void* feasible, void* min_k, void* viol_k, void* stream)
{
    return launch(l_dim, n, k, r, p, free, victim_req, perm, elig_len, nullptr, viol,
                  pods_req, pod_level, cum, cum_viol, bound, feasible, min_k, viol_k, stream);
}

// dry_run_victims: one pod (P = L = 1, perm the identity) over C candidates,
// victims masked by victim_valid.
extern "C" int preempt_dry_run_victims_launch(
    int c, int k, int r,
    const void* free, const void* victim_req, const void* valid, const void* pod_req,
    void* cum, void* cum_viol, void* bound, void* feasible, void* min_k, void* stream)
{
    // one pod, read as row 0 of [1, R]; its min_k row is [1, C]
    return launch(1, c, k, r, 1, free, victim_req, nullptr, nullptr, valid, nullptr,
                  pod_req, nullptr, cum, cum_viol, bound, feasible, min_k, nullptr, stream);
}

extern "C" int preempt_dry_run_max_k() { return kMaxK; }

extern "C" const char* preempt_dry_run_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
