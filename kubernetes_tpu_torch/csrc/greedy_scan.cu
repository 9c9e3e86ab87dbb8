// Kernel `greedy_scan`: the whole sequential-greedy batch solve, one launch.
//
// Replaces: kubernetes_tpu/ops/assign.py:591 `greedy_assign` — the lax.scan
// over pods in solve order of `_eval_pod` (assign.py:374: class statics,
// `fits_resources`, in-batch ports), the scores (`least_allocated`,
// `most_allocated`, `requested_to_capacity_ratio`, `balanced_allocation`,
// `normalize`, `combine_scores`, scores.py), `_pick` (first-max-index,
// assign.py:358) and the assume carry update, followed by the
// `_gang_release` epilogue (assign.py:558).
//
// Bound on this card: latency of the sequential chain.  Pod k+1 must see
// pod k's placement, so the P steps run one after another; each step is
// two passes over the N nodes (about 60 bytes a node from L2: the class
// row, allocatable, requested and nonzero-requested) plus four block-wide
// reductions.  The bytes the function must move (its inputs once, its
// outputs once) take tens of microseconds at the card's memory rate; the
// chain of P dependent steps, each bounded by one SM's L2 bandwidth and
// barrier latency, is what this design pays.
//
// Design: one persistent block of 1024 threads on one SM of 132 loops over
// the pods.  Per step:
//   pass 1  strided over N: static row, resource fit, in-batch ports; block
//           reduction of the stage anys (s_any, a_res, a_ports), the
//           feasible count and the two normalisation maxima over feasible
//           nodes (0-floored, scores.py:191);
//   pass 2  strided over N: fit, balanced, normalised affinity, reversed
//           taint and the weighted total; block reduction of (score, lowest
//           index), which is jnp.argmax's first-index tie-break;
//   then thread 0 writes the pod's outputs and threads 0..R / 0..PW add the
//           winner's requests and ports to its rows in place, before the
//           closing barrier makes them visible to the next step.
// Host ports are checked against one carried port table that starts as the
// bound pods' claims: a node whose bound claims conflict is already outside
// the class's static row, so the test equals the reference's in-batch-only
// carry and the table is the post-solve port_bits as it stands.
// The carry tensors are copies made by the caller; nothing else is written.
//
// Numerics: every score is a floor of IEEE float32 operations in the
// reference's order (__fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, and the
// file is built with --fmad=false), so the results equal the reference bit
// for bit.  The one multiply-add the reference's compiler fuses (inside
// jnp.interp) is fused here too (__fmaf_rn).  One block uses one SM;
// spreading a step over a cluster or a cooperative grid is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 32;        // resource axis
constexpr int kMaxPW = 256;      // port words (8192 ports)
constexpr int kMaxFit = 8;       // fit / balanced resources
constexpr int kMaxShape = 16;    // RequestedToCapacityRatio points
constexpr float kMaxNodeScore = 100.0f;

// fit strategies (0 is LeastAllocated, the default branch of fit_score)
constexpr int kMostAllocated = 1;
constexpr int kRequestedToCapacityRatio = 2;

constexpr int kReasonNone = -1;
constexpr int kReasonStatic = 0;
constexpr int kReasonResources = 1;
constexpr int kReasonPorts = 2;
constexpr int kReasonGang = 5;

// integer parameter block (iparams), filled by the wrapper
enum {
    kIpStrategy = 0, kIpNumFit, kIpNumBal, kIpNumShape,
    kIpFitIdx, kIpBalIdx = kIpFitIdx + kMaxFit, kIpCount = kIpBalIdx + kMaxFit,
};
// float parameter block (fparams)
enum {
    kFpFitWeight = 0, kFpBalWeight, kFpAffWeight, kFpTaintWeight, kFpInterpEps,
    kFpFitW, kFpShapeX = kFpFitW + kMaxFit, kFpShapeY = kFpShapeX + kMaxShape,
    kFpCount = kFpShapeY + kMaxShape,
};

struct Config {
    int strategy, n_fit, n_bal, n_shape;
    int fit_idx[kMaxFit], bal_idx[kMaxFit];
    float fit_weight, bal_weight, aff_weight, taint_weight, interp_eps;
    float fit_w[kMaxFit], xs[kMaxShape], ys[kMaxShape];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// jnp.interp with constant extrapolation (jax _interp, operation order kept)
__device__ float interp(float x, const Config& cfg)
{
    const int len = cfg.n_shape;
    int i = 0;  // searchsorted(xs, x, side='right'): count of xs <= x
    while (i < len && cfg.xs[i] <= x) ++i;
    i = min(max(i, 1), len - 1);
    const float df = sub(cfg.ys[i], cfg.ys[i - 1]);
    const float dx = sub(cfg.xs[i], cfg.xs[i - 1]);
    const float delta = sub(x, cfg.xs[i - 1]);
    const bool dx0 = fabsf(dx) <= cfg.interp_eps;
    // one rounding: the reference's XLA build fuses this multiply-add
    float f = dx0 ? cfg.ys[i - 1] : __fmaf_rn(dv(delta, dx0 ? 1.0f : dx), df, cfg.ys[i - 1]);
    if (x < cfg.xs[0]) f = cfg.ys[0];
    if (x > cfg.xs[len - 1]) f = cfg.ys[len - 1];
    return f;
}

// Least/Most/RequestedToCapacityRatio over NonZeroRequested (scores.py:72-134)
__device__ float fit_score(const float* cap, const float* nzq, const float* pod_nz,
                           const Config& cfg)
{
    float total = 0.0f, wsum = 0.0f;
    for (int j = 0; j < cfg.n_fit; ++j) {
        const int idx = cfg.fit_idx[j];
        const float weight = cfg.fit_w[j];
        const float c = cap[idx];
        const float q = add(nzq[idx], pod_nz[idx]);
        const bool ok = c > 0.0f;
        const float okf = ok ? 1.0f : 0.0f;
        if (cfg.strategy == kRequestedToCapacityRatio) {
            const float util = fminf(fmaxf(dv(mul(q, 100.0f), fmaxf(c, 1.0f)), 0.0f), 100.0f);
            const float s = mul(interp(util, cfg), kMaxNodeScore / 10.0f);
            total = add(total, mul(weight, (ok && q <= c) ? floorf(s) : 0.0f));
        } else {
            float s = 0.0f;
            if (ok && q <= c) {
                const float num = cfg.strategy == kMostAllocated ? q : sub(c, q);
                s = floorf(dv(mul(num, kMaxNodeScore), fmaxf(c, 1.0f)));
            }
            total = add(total, mul(mul(weight, s), okf));
        }
        wsum = add(wsum, mul(weight, okf));
    }
    return wsum > 0.0f ? floorf(dv(total, fmaxf(wsum, 1.0f))) : 0.0f;
}

// BalancedAllocation over actual Requested (scores.py:136-160)
__device__ float balanced_score(const float* cap, const float* rq, const float* pod_req,
                                const Config& cfg)
{
    float frac[kMaxFit];
    bool valid[kMaxFit];
    int count = 0;
    for (int j = 0; j < cfg.n_bal; ++j) {
        const int idx = cfg.bal_idx[j];
        const float c = cap[idx];
        valid[j] = c > 0.0f;
        const float f = fminf(dv(add(rq[idx], pod_req[idx]), fmaxf(c, 1.0f)), 1.0f);
        frac[j] = valid[j] ? f : 0.0f;
        count += valid[j] ? 1 : 0;
    }
    const float cnt = (float)max(count, 1);
    float fsum = 0.0f;
    for (int j = 0; j < cfg.n_bal; ++j) fsum = add(fsum, frac[j]);
    const float mean = dv(fsum, cnt);
    float vsum = 0.0f;
    for (int j = 0; j < cfg.n_bal; ++j) {
        const float d = sub(frac[j], mean);
        vsum = add(vsum, valid[j] ? mul(d, d) : 0.0f);
    }
    const float stdev = __fsqrt_rn(dv(vsum, cnt));
    return floorf(mul(sub(1.0f, stdev), kMaxNodeScore));
}

// DefaultNormalizeScore (scores.py:181-198)
__device__ __forceinline__ float normalized(float raw, float m, bool reverse)
{
    const float scaled = floorf(dv(mul(kMaxNodeScore, raw), fmaxf(m, 1e-30f)));
    float out = m > 0.0f ? scaled : 0.0f;
    if (reverse) out = m > 0.0f ? sub(kMaxNodeScore, out) : kMaxNodeScore;
    return out;
}

struct Step {
    int flags;      // bit 0 s_any, bit 1 a_res, bit 2 a_ports
    int count;      // feasible nodes
    float max_aff;  // normalisation maxima over feasible nodes, 0-floored
    float max_taint;
};

__device__ __forceinline__ Step warp_reduce_step(Step s)
{
    for (int off = 16; off > 0; off >>= 1) {
        s.flags |= __shfl_down_sync(0xffffffffu, s.flags, off);
        s.count += __shfl_down_sync(0xffffffffu, s.count, off);
        s.max_aff = fmaxf(s.max_aff, __shfl_down_sync(0xffffffffu, s.max_aff, off));
        s.max_taint = fmaxf(s.max_taint, __shfl_down_sync(0xffffffffu, s.max_taint, off));
    }
    return s;
}

// (score, index): the larger score wins, the lower index breaks ties
__device__ __forceinline__ void better(float& best, int& idx, float s, int i)
{
    if (s > best || (s == best && i < idx)) { best = s; idx = i; }
}

__device__ __forceinline__ void warp_reduce_best(float& best, int& idx)
{
    for (int off = 16; off > 0; off >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, best, off);
        const int i = __shfl_down_sync(0xffffffffu, idx, off);
        better(best, idx, s, i);
    }
}

__global__ void __launch_bounds__(kThreads, 1) greedy_scan_kernel(
    int n, int r, int p, int c_dim, int pw, int use_ports, int n_groups,
    const float* __restrict__ alloc,      // [N, R]
    float* requested,                     // [N, R] carry, updated in place
    float* nonzero,                       // [N, R] carry, updated in place
    uint32_t* ports,                      // [N, PW] carry (bound | in-batch)
    const uint8_t* __restrict__ sfeas,    // [C, N]
    const float* __restrict__ aff,        // [C, N]
    const float* __restrict__ taint,      // [C, N]
    const int32_t* __restrict__ order,    // [P] solve order
    const int32_t* __restrict__ class_id, // [P]
    const uint8_t* __restrict__ pod_valid,  // [P]
    const int32_t* __restrict__ group_id,   // [P]
    const float* __restrict__ pod_req,      // [P, R]
    const float* __restrict__ pod_nz,       // [P, R]
    const uint32_t* __restrict__ pod_ports, // [P, PW]
    const int32_t* __restrict__ iparams,
    const float* __restrict__ fparams,
    int32_t* assignment, float* scores, int32_t* feas_counts, int32_t* reasons,
    int32_t* incomplete)                    // [max(G, 1)] zeroed scratch
{
    __shared__ Config cfg;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    __shared__ uint32_t s_ports[kMaxPW];
    __shared__ Step s_warp[kWarps];
    __shared__ Step s_step;
    __shared__ float s_best[kWarps];
    __shared__ int s_best_idx[kWarps];
    __shared__ float s_win;
    __shared__ int s_win_idx;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    if (tid == 0) {
        cfg.strategy = iparams[kIpStrategy];
        cfg.n_fit = iparams[kIpNumFit];
        cfg.n_bal = iparams[kIpNumBal];
        cfg.n_shape = iparams[kIpNumShape];
        for (int j = 0; j < kMaxFit; ++j) {
            cfg.fit_idx[j] = iparams[kIpFitIdx + j];
            cfg.bal_idx[j] = iparams[kIpBalIdx + j];
            cfg.fit_w[j] = fparams[kFpFitW + j];
        }
        for (int j = 0; j < kMaxShape; ++j) {
            cfg.xs[j] = fparams[kFpShapeX + j];
            cfg.ys[j] = fparams[kFpShapeY + j];
        }
        cfg.fit_weight = fparams[kFpFitWeight];
        cfg.bal_weight = fparams[kFpBalWeight];
        cfg.aff_weight = fparams[kFpAffWeight];
        cfg.taint_weight = fparams[kFpTaintWeight];
        cfg.interp_eps = fparams[kFpInterpEps];
    }

    for (int k = 0; k < p; ++k) {
        const int i = order[k];
        const int c = min(max(class_id[i], 0), c_dim - 1);
        for (int t = tid; t < r; t += kThreads) {
            s_req[t] = pod_req[(size_t)i * r + t];
            s_nz[t] = pod_nz[(size_t)i * r + t];
        }
        if (use_ports) {
            for (int t = tid; t < pw; t += kThreads) s_ports[t] = pod_ports[(size_t)i * pw + t];
        }
        __syncthreads();

        const uint8_t* srow = sfeas + (size_t)c * n;
        const float* arow = aff + (size_t)c * n;
        const float* trow = taint + (size_t)c * n;

        // pass 1: filters, stage anys, count, normalisation maxima
        Step st = {0, 0, 0.0f, 0.0f};
        for (int nd = tid; nd < n; nd += kThreads) {
            if (!srow[nd]) continue;
            st.flags |= 1;
            bool fit = true;
            for (int rr = 0; rr < r; ++rr) {
                const float q = s_req[rr];
                if (q > 0.0f && !(add(requested[(size_t)nd * r + rr], q) <= alloc[(size_t)nd * r + rr])) {
                    fit = false;
                }
            }
            if (!fit) continue;
            st.flags |= 2;
            if (use_ports) {
                const uint32_t* np = ports + (size_t)nd * pw;
                bool clash = false;
                for (int w = 0; w < pw; ++w) clash |= (np[w] & s_ports[w]) != 0u;
                if (clash) continue;
            }
            st.flags |= 4;
            st.count += 1;
            st.max_aff = fmaxf(st.max_aff, arow[nd]);
            st.max_taint = fmaxf(st.max_taint, trow[nd]);
        }
        st = warp_reduce_step(st);
        if (lane == 0) s_warp[warp] = st;
        __syncthreads();
        if (warp == 0) {
            st = s_warp[lane];
            st = warp_reduce_step(st);
            if (lane == 0) s_step = st;
        }
        __syncthreads();
        const Step all = s_step;
        const bool found = (all.flags & 4) != 0;

        // pass 2: scores of feasible nodes, first-index argmax
        float best = -INFINITY;
        int best_idx = 0x7fffffff;
        if (found) {
            for (int nd = tid; nd < n; nd += kThreads) {
                if (!srow[nd]) continue;
                const float* cap = alloc + (size_t)nd * r;
                const float* rq = requested + (size_t)nd * r;
                bool fit = true;
                for (int rr = 0; rr < r; ++rr) {
                    const float q = s_req[rr];
                    if (q > 0.0f && !(add(rq[rr], q) <= cap[rr])) fit = false;
                }
                if (!fit) continue;
                if (use_ports) {
                    const uint32_t* np = ports + (size_t)nd * pw;
                    bool clash = false;
                    for (int w = 0; w < pw; ++w) clash |= (np[w] & s_ports[w]) != 0u;
                    if (clash) continue;
                }
                const float fit_s = fit_score(cap, nonzero + (size_t)nd * r, s_nz, cfg);
                const float bal_s = balanced_score(cap, rq, s_req, cfg);
                const float aff_s = normalized(arow[nd], all.max_aff, false);
                const float taint_s = normalized(trow[nd], all.max_taint, true);
                const float total = add(
                    add(add(mul(cfg.fit_weight, fit_s), mul(cfg.bal_weight, bal_s)),
                        mul(cfg.aff_weight, aff_s)),
                    mul(cfg.taint_weight, taint_s));
                if (total > best) { best = total; best_idx = nd; }
            }
        }
        warp_reduce_best(best, best_idx);
        if (lane == 0) { s_best[warp] = best; s_best_idx[warp] = best_idx; }
        __syncthreads();
        if (warp == 0) {
            best = s_best[lane];
            best_idx = s_best_idx[lane];
            warp_reduce_best(best, best_idx);
            if (lane == 0) { s_win = best; s_win_idx = best_idx; }
        }
        __syncthreads();

        const int choice = s_win_idx;
        if (tid == 0) {
            assignment[i] = found ? choice : -1;
            scores[i] = found ? s_win : -INFINITY;
            feas_counts[i] = all.count;
            reasons[i] = found ? kReasonNone
                : !(all.flags & 1) ? kReasonStatic
                : !(all.flags & 2) ? kReasonResources
                : kReasonPorts;
        }
        if (found) {
            for (int t = tid; t < r; t += kThreads) {
                requested[(size_t)choice * r + t] = add(requested[(size_t)choice * r + t], s_req[t]);
                nonzero[(size_t)choice * r + t] = add(nonzero[(size_t)choice * r + t], s_nz[t]);
            }
            if (use_ports) {
                for (int t = tid; t < pw; t += kThreads) ports[(size_t)choice * pw + t] |= s_ports[t];
            }
        }
        __syncthreads();
    }

    // gang all-or-nothing: release every placement of an incomplete group
    if (n_groups > 0) {
        for (int i = tid; i < p; i += kThreads) {
            const int g = group_id[i];
            if (g >= 0 && pod_valid[i] && assignment[i] < 0) incomplete[min(g, n_groups - 1)] = 1;
        }
        __syncthreads();
        for (int i = tid; i < p; i += kThreads) {
            const int g = group_id[i];
            const int a = assignment[i];
            if (g < 0 || a < 0 || !incomplete[min(g, n_groups - 1)]) continue;
            for (int rr = 0; rr < r; ++rr) {
                atomicAdd(&requested[(size_t)a * r + rr], -pod_req[(size_t)i * r + rr]);
                atomicAdd(&nonzero[(size_t)a * r + rr], -pod_nz[(size_t)i * r + rr]);
            }
            assignment[i] = -1;
            scores[i] = -INFINITY;
            reasons[i] = kReasonGang;
        }
    }
}

}  // namespace

extern "C" int greedy_scan_limits(int which)
{
    switch (which) {
        case 0: return kMaxR;
        case 1: return kMaxPW;
        case 2: return kMaxFit;
        case 3: return kMaxShape;
        case 4: return kIpCount;
        case 5: return kFpCount;
        default: return -1;
    }
}

extern "C" int greedy_scan_launch(
    int n, int r, int p, int c_dim, int pw, int use_ports, int n_groups,
    const void* alloc, void* requested, void* nonzero, void* ports,
    const void* sfeas, const void* aff, const void* taint,
    const void* order, const void* class_id, const void* pod_valid,
    const void* group_id, const void* pod_req, const void* pod_nz,
    const void* pod_ports, const void* iparams, const void* fparams,
    void* assignment, void* scores, void* feas_counts, void* reasons,
    void* incomplete, void* stream)
{
    if (p == 0) return 0;
    greedy_scan_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        n, r, p, c_dim, pw, use_ports, n_groups,
        (const float*)alloc, (float*)requested, (float*)nonzero,
        (uint32_t*)ports, (const uint8_t*)sfeas, (const float*)aff,
        (const float*)taint, (const int32_t*)order, (const int32_t*)class_id,
        (const uint8_t*)pod_valid, (const int32_t*)group_id,
        (const float*)pod_req, (const float*)pod_nz,
        (const uint32_t*)pod_ports, (const int32_t*)iparams,
        (const float*)fparams, (int32_t*)assignment, (float*)scores,
        (int32_t*)feas_counts, (int32_t*)reasons, (int32_t*)incomplete);
    return (int)cudaGetLastError();
}

extern "C" const char* greedy_scan_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
