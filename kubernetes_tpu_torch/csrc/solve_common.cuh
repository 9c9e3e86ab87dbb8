// Device code shared by the three solves (greedy_scan.cu, wavefront.cu,
// auction_bids.cu): the score parameter block, the per-node filter and
// score functions and the block-wide evaluation of one pod, so every solve
// evaluates a pod with one body.
//
// Numerics: every score is a floor of IEEE float32 operations in the
// reference package's order (__fadd_rn / __fmul_rn / __fdiv_rn /
// __fsqrt_rn; every file that includes this one is built with
// --fmad=false), so the results equal the reference bit for bit.  The one
// multiply-add the reference's compiler fuses (inside jnp.interp) is fused
// here too (__fmaf_rn).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace solve {

constexpr int kMaxR = 32;        // resource axis
constexpr int kMaxPW = 256;      // port words (8192 ports)
constexpr int kMaxFit = 8;       // fit / balanced resources
constexpr int kMaxShape = 16;    // RequestedToCapacityRatio points
constexpr int kMaxWarps = 32;    // blocks of at most 1024 threads
constexpr float kMaxNodeScore = 100.0f;

// fit strategies (0 is LeastAllocated, the default branch of fit_score)
constexpr int kMostAllocated = 1;
constexpr int kRequestedToCapacityRatio = 2;

constexpr int kReasonNone = -1;
constexpr int kReasonStatic = 0;
constexpr int kReasonResources = 1;
constexpr int kReasonPorts = 2;
constexpr int kReasonGang = 5;

// integer parameter block (iparams), filled by bindings.score_params
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

// One thread fills the block's shared Config; the caller synchronises.
__device__ inline void load_config(Config& cfg, const int32_t* iparams, const float* fparams)
{
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

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// jnp.interp with constant extrapolation (jax _interp, operation order kept)
__device__ inline float interp(float x, const Config& cfg)
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
__device__ inline float fit_score(const float* cap, const float* nzq, const float* pod_nz,
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
__device__ inline float balanced_score(const float* cap, const float* rq, const float* pod_req,
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

// combine_scores' weighted sum for one node, given the normalisation maxima
__device__ __forceinline__ float node_total(float fit_s, float bal_s, float aff_raw,
                                            float taint_raw, float max_aff, float max_taint,
                                            const Config& cfg)
{
    const float aff_s = normalized(aff_raw, max_aff, false);
    const float taint_s = normalized(taint_raw, max_taint, true);
    return add(add(add(mul(cfg.fit_weight, fit_s), mul(cfg.bal_weight, bal_s)),
                   mul(cfg.aff_weight, aff_s)),
               mul(cfg.taint_weight, taint_s));
}

// NodeResourcesFit: requested + req <= allocatable on every requested resource
__device__ __forceinline__ bool node_fits(const float* rq, const float* cap, const float* req, int r)
{
    bool fit = true;
    for (int rr = 0; rr < r; ++rr) {
        const float q = req[rr];
        if (q > 0.0f && !(add(rq[rr], q) <= cap[rr])) fit = false;
    }
    return fit;
}

__device__ __forceinline__ bool ports_clash(const uint32_t* node_ports, const uint32_t* pod_ports, int pw)
{
    bool clash = false;
    for (int w = 0; w < pw; ++w) clash |= (node_ports[w] & pod_ports[w]) != 0u;
    return clash;
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

// Shared scratch of the block reductions below (one per block).
struct Scratch {
    Step warp_step[kMaxWarps];
    Step step;
    float warp_best[kMaxWarps];
    int warp_idx[kMaxWarps];
    float best;
    int idx;
};

// Block-wide Step reduction; every thread returns the block's total.
__device__ inline Step block_reduce_step(Step st, Scratch& sc)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    st = warp_reduce_step(st);
    if (lane == 0) sc.warp_step[warp] = st;
    __syncthreads();
    if (warp == 0) {
        Step z = {0, 0, 0.0f, 0.0f};
        st = lane < nwarps ? sc.warp_step[lane] : z;
        st = warp_reduce_step(st);
        if (lane == 0) sc.step = st;
    }
    __syncthreads();
    return sc.step;
}

// Block-wide (score desc, index asc) reduction; every thread returns the
// winner in (best, idx).
__device__ inline void block_reduce_best(float& best, int& idx, Scratch& sc)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    warp_reduce_best(best, idx);
    if (lane == 0) { sc.warp_best[warp] = best; sc.warp_idx[warp] = idx; }
    __syncthreads();
    if (warp == 0) {
        best = lane < nwarps ? sc.warp_best[lane] : -INFINITY;
        idx = lane < nwarps ? sc.warp_idx[lane] : 0x7fffffff;
        warp_reduce_best(best, idx);
        if (lane == 0) { sc.best = best; sc.idx = idx; }
    }
    __syncthreads();
    best = sc.best;
    idx = sc.idx;
    __syncthreads();
}

// What one pod's evaluation against the carry gives every thread.
struct Eval {
    Step all;     // stage flags, feasible count, normalisation maxima
    bool found;   // some node passes every filter
    int choice;   // first-index argmax of the masked scores
    float best;   // its score (-inf when !found)
    int reason;   // REASON_* of the first stage that emptied the set
};

// The scan's step for one pod, block-wide (ops/assign.py `_eval_pod` +
// `_pick`): pass 1 over N for the filters, the stage anys, the feasible
// count and the normalisation maxima; pass 2 for the scores of feasible
// nodes and the first-index argmax.  With `masked` non-null, pass 2 also
// writes every node's masked score (-inf where infeasible).  pod_req,
// pod_nz and pod_ports may point to shared memory.
__device__ inline Eval block_eval(
    int n, int r, int pw, bool use_ports,
    const float* alloc, const float* requested, const float* nonzero, const uint32_t* ports,
    const uint8_t* srow, const float* arow, const float* trow,
    const float* pod_req, const float* pod_nz, const uint32_t* pod_ports,
    const Config& cfg, Scratch& sc, float* masked)
{
    Step st = {0, 0, 0.0f, 0.0f};
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
        if (!srow[nd]) continue;
        st.flags |= 1;
        if (!node_fits(requested + (size_t)nd * r, alloc + (size_t)nd * r, pod_req, r)) continue;
        st.flags |= 2;
        if (use_ports && ports_clash(ports + (size_t)nd * pw, pod_ports, pw)) continue;
        st.flags |= 4;
        st.count += 1;
        st.max_aff = fmaxf(st.max_aff, arow[nd]);
        st.max_taint = fmaxf(st.max_taint, trow[nd]);
    }
    Eval ev;
    ev.all = block_reduce_step(st, sc);
    ev.found = (ev.all.flags & 4) != 0;

    float best = -INFINITY;
    int best_idx = 0x7fffffff;
    if (ev.found || masked != nullptr) {
        for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
            float total = -INFINITY;
            const float* cap = alloc + (size_t)nd * r;
            const float* rq = requested + (size_t)nd * r;
            if (srow[nd] && node_fits(rq, cap, pod_req, r)
                && !(use_ports && ports_clash(ports + (size_t)nd * pw, pod_ports, pw))) {
                const float fit_s = fit_score(cap, nonzero + (size_t)nd * r, pod_nz, cfg);
                const float bal_s = balanced_score(cap, rq, pod_req, cfg);
                total = node_total(fit_s, bal_s, arow[nd], trow[nd],
                                   ev.all.max_aff, ev.all.max_taint, cfg);
                if (total > best) { best = total; best_idx = nd; }
            }
            if (masked != nullptr) masked[nd] = total;
        }
    }
    block_reduce_best(best, best_idx, sc);
    ev.choice = best_idx;
    ev.best = ev.found ? best : -INFINITY;
    ev.reason = ev.found ? kReasonNone
        : !(ev.all.flags & 1) ? kReasonStatic
        : !(ev.all.flags & 2) ? kReasonResources
        : kReasonPorts;
    return ev;
}

// Gang all-or-nothing post-pass (assign.py `_gang_release`), block-wide:
// release every placement of a group with an unplaced member.
// `incomplete` is zeroed scratch of max(n_groups, 1) ints.
__device__ inline void block_gang_release(
    int p, int r, int n_groups, const uint8_t* pod_valid, const int32_t* group_id,
    const float* pod_req, const float* pod_nz, float* requested, float* nonzero,
    int32_t* assignment, float* scores, int32_t* reasons, int32_t* incomplete)
{
    for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int g = group_id[i];
        if (g >= 0 && pod_valid[i] && assignment[i] < 0) incomplete[min(g, n_groups - 1)] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p; i += blockDim.x) {
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

}  // namespace solve
