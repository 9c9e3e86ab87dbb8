// Device code shared by the three solves (greedy_scan.cu, wavefront.cu,
// auction_loop.cu) and evaluate_single.cu: the score parameter block, the per-node filter and
// score functions, the PodTopologySpread family (ops/topology.py), the
// required InterPodAffinity family (ops/interpod.py: the three bitset
// checks and the carry update) and the block-wide evaluation of one pod,
// so every solve evaluates a pod with one body.  The hoisted extra score
// row of a class (preferred inter-pod affinity and ImageLocality, kernel
// class_extras) is added after the spread term; the TPU slice carve-out
// stage (slices_common.cuh) filters last under "require" and adds its
// bonus after everything else, outside the normalised sum.
//
// Teams.  A pod is evaluated by a team of threads: one block over every
// node (BlockTeam, the default: the auction's bids), or a thread-block
// cluster whose blocks each own a share of the nodes (cluster_common.cuh
// ClusterTeam: the scan, the wavefront, evaluate_single).  The node loops run
// over this block's share (team.first(), stride(), end()), and the
// reductions go through the team: a block reduces in shared memory; a
// cluster then merges the blocks' partials through distributed shared
// memory.  Every merge is order-free — flags OR, counts in integers,
// fmaxf / fminf, and the pick by ranks_above's total order — so a team of
// any size gives the bits a block gives.
//
// Numerics: every score is a floor of IEEE float32 operations in the
// reference package's order (__fadd_rn / __fmul_rn / __fdiv_rn /
// __fsqrt_rn; every file that includes this one is built with
// --fmad=false), so the results equal the reference bit for bit.  The
// multiply-adds the reference's compiler fuses (inside jnp.interp, the
// spread score's cnt * weight + (maxSkew - 1), and inside its float32 log)
// are fused here too (__fmaf_rn); `log32` is that compiler's log, not
// CUDA's logf, and the spread score rounds half to even (rintf), as
// jnp.round does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slices_common.cuh"

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
constexpr int kReasonSpread = 3;
constexpr int kReasonInterpod = 4;
constexpr int kReasonGang = 5;

constexpr int kMaxMC = 8;        // spread constraints per pod
constexpr int kMaxTW = 32;       // inter-pod term words (1,024 terms)
constexpr float kBig = 1e9f;     // ops/topology.py _BIG

// integer parameter block (iparams), filled by bindings.score_params
enum {
    kIpStrategy = 0, kIpNumFit, kIpNumBal, kIpNumShape,
    kIpFitIdx, kIpBalIdx = kIpFitIdx + kMaxFit, kIpCount = kIpBalIdx + kMaxFit,
};
// float parameter block (fparams)
enum {
    kFpFitWeight = 0, kFpBalWeight, kFpAffWeight, kFpTaintWeight, kFpInterpEps,
    kFpFitW, kFpShapeX = kFpFitW + kMaxFit, kFpShapeY = kFpShapeX + kMaxShape,
    kFpSpreadWeight = kFpShapeY + kMaxShape, kFpCount,
};

struct Config {
    int strategy, n_fit, n_bal, n_shape;
    int fit_idx[kMaxFit], bal_idx[kMaxFit];
    float fit_weight, bal_weight, aff_weight, taint_weight, interp_eps, spread_weight;
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
    cfg.spread_weight = fparams[kFpSpreadWeight];
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

// ---- PodTopologySpread (ops/topology.py) ---------------------------------

// The reference compiler's float32 log (XLA on the CPU: a Cephes-style
// polynomial with fused multiply-adds at these places, denormals read as
// zero), bit for bit; ops/topology.py `log32` is its plain version.
__device__ inline float log32(float x)
{
    if (fabsf(x) < 1.17549435e-38f) return -INFINITY;  // zeros and denormals
    if (!(x > 0.0f)) return NAN;                        // negatives and NaN
    if (isinf(x)) return INFINITY;
    const int bits = __float_as_int(x);
    float e = add(__int2float_rn((bits >> 23) - 127), 1.0f);
    const float xm = __int_as_float((bits & (int)0x807fffff) | 0x3f000000);  // [0.5, 1)
    const bool small = xm < 0.707106781186547524f;
    const float xr = add(sub(xm, 1.0f), small ? xm : 0.0f);
    e = sub(e, small ? 1.0f : 0.0f);
    const float x2 = mul(xr, xr);
    const float x3 = mul(x2, xr);
    float y = __fmaf_rn(__fmaf_rn(xr, 7.0376836292e-2f, -1.1514610310e-1f), xr, 1.1676998740e-1f);
    const float y1 = __fmaf_rn(__fmaf_rn(xr, -1.2420140846e-1f, 1.4249322787e-1f), xr,
                               -1.6668057665e-1f);
    const float y2 = __fmaf_rn(__fmaf_rn(xr, 2.0000714765e-1f, -2.4999993993e-1f), xr,
                               3.3333331174e-1f);
    y = __fmaf_rn(y, x3, y1);
    y = __fmaf_rn(y, x3, y2);
    y = __fmaf_rn(y, x3, mul(-2.12194440e-4f, e));
    return __fmaf_rn(0.693359375f, e, add(sub(xr, mul(0.5f, x2)), y));
}

// The spread family's tables for a solve (`counts` is the carry, null when
// the family is off).  Built by make_spread from the launch arguments.
struct Spread {
    int on, soft_on, c_dim, mc;
    const int32_t* pod_idx;      // [P, MC] constraint rows per pod, -1 pad
    const uint8_t* pod_matches;  // [P, C]
    const float* max_skew;       // [C]
    const float* min_domains;    // [C] 0 = unset
    const uint8_t* hard;         // [C]
    const uint8_t* eligible;     // [C, N]
    const int32_t* v;            // [C, N] node's value, -1 absent
    const float* sizes;          // [C] distinct eligible values
    float* counts;               // [C, N] match count of the node's value
};

inline Spread make_spread(int on, int soft_on, int c_dim, int mc, const void* pod_idx,
                          const void* pod_matches, const void* max_skew,
                          const void* min_domains, const void* hard, const void* eligible,
                          const void* v, const void* sizes, void* counts)
{
    Spread sp;
    sp.on = on;
    sp.soft_on = soft_on;
    sp.c_dim = c_dim;
    sp.mc = mc;
    sp.pod_idx = (const int32_t*)pod_idx;
    sp.pod_matches = (const uint8_t*)pod_matches;
    sp.max_skew = (const float*)max_skew;
    sp.min_domains = (const float*)min_domains;
    sp.hard = (const uint8_t*)hard;
    sp.eligible = (const uint8_t*)eligible;
    sp.v = (const int32_t*)v;
    sp.sizes = (const float*)sizes;
    sp.counts = (float*)counts;
    return sp;
}

// One pod's constraint rows, in shared memory (block_spread_pod).
struct PodSpread {
    int any_hard, any_soft;
    int c[kMaxMC];
    int enforced[kMaxMC];   // a hard row: the filter reads it
    int soft[kMaxMC];       // a soft row: the score reads it
    float self_m[kMaxMC];   // the pod matches the row's selector
    float minm[kMaxMC];     // the row's critical-path minimum
    float skew[kMaxMC];     // maxSkew
    float weight[kMaxMC];   // log32(sizes + 2)
    float damp[kMaxMC];     // maxSkew - 1
};

struct Step {
    int flags;      // bit 0 s_any, bit 1 a_res, bit 2 a_ports, bit 3 a_spread,
                    // bit 4 passes every filter, bit 5 a_interpod
    int count;      // feasible nodes
    float max_aff;  // normalisation maxima over feasible nodes, 0-floored
    float max_taint;
    float sp_mx;    // spread score: max / min raw over scored nodes
    float sp_mn;
};

__device__ __forceinline__ Step step_zero()
{
    Step s = {0, 0, 0.0f, 0.0f, -kBig, kBig};
    return s;
}

// The Step of two node sets: order-free (OR, integer sum, fmaxf / fminf).
__device__ __forceinline__ Step step_merge(Step a, const Step& b)
{
    a.flags |= b.flags;
    a.count += b.count;
    a.max_aff = fmaxf(a.max_aff, b.max_aff);
    a.max_taint = fmaxf(a.max_taint, b.max_taint);
    a.sp_mx = fmaxf(a.sp_mx, b.sp_mx);
    a.sp_mn = fminf(a.sp_mn, b.sp_mn);
    return a;
}

__device__ __forceinline__ Step warp_reduce_step(Step s)
{
    for (int off = 16; off > 0; off >>= 1) {
        s.flags |= __shfl_down_sync(0xffffffffu, s.flags, off);
        s.count += __shfl_down_sync(0xffffffffu, s.count, off);
        s.max_aff = fmaxf(s.max_aff, __shfl_down_sync(0xffffffffu, s.max_aff, off));
        s.max_taint = fmaxf(s.max_taint, __shfl_down_sync(0xffffffffu, s.max_taint, off));
        s.sp_mx = fmaxf(s.sp_mx, __shfl_down_sync(0xffffffffu, s.sp_mx, off));
        s.sp_mn = fminf(s.sp_mn, __shfl_down_sync(0xffffffffu, s.sp_mn, off));
    }
    return s;
}

// (score, index) order of jnp.argmax, torch.argmax and lax.top_k: a NaN
// ranks above every number (+inf included), a larger score above a smaller
// one, and equal ranks (two NaNs too) break to the lower index.  A NaN score
// comes only from a corrupt input (an injected fault: +inf affinity rows or
// +inf allocatable make floor(100 * inf / inf)); it must win the pick as it
// wins the reference's, so the decode's health check sees it.
__device__ __forceinline__ bool ranks_above(float s, int i, float best, int idx)
{
    const bool sn = isnan(s), bn = isnan(best);
    if (sn != bn) return sn;
    return sn ? i < idx : (s > best || (s == best && i < idx));
}

__device__ __forceinline__ void better(float& best, int& idx, float s, int i)
{
    if (ranks_above(s, i, best, idx)) { best = s; idx = i; }
}

// jnp.max / torch.max of two: NaN if either is NaN (fmaxf drops a NaN)
__device__ __forceinline__ float nan_max(float a, float b)
{
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
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
        st = lane < nwarps ? sc.warp_step[lane] : step_zero();
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

// Block-wide float min; every thread returns the block's min.
__device__ inline float block_reduce_min(float m, Scratch& sc)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) sc.warp_best[warp] = m;
    __syncthreads();
    if (warp == 0) {
        m = lane < nwarps ? sc.warp_best[lane] : INFINITY;
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
        if (lane == 0) sc.best = m;
    }
    __syncthreads();
    m = sc.best;
    __syncthreads();
    return m;
}

// The min count of row c over the eligible nodes this block visits (a
// thread: first, first + stride, ... below end), kBig without one.
// Block-wide.
__device__ inline float block_spread_min(const Spread& sp, int n, int first, int stride, int end,
                                         int c, Scratch& sc)
{
    float m = kBig;
    const size_t o = (size_t)c * n;
    for (int nd = first; nd < end; nd += stride) {
        if (sp.eligible[o + nd]) m = fminf(m, sp.counts[o + nd]);
    }
    return block_reduce_min(m, sc);
}

// The critical-path minimum of row c (topology.py spread_min_match) from
// the min count over every eligible node: 0 without an eligible node or
// when fewer eligible domains exist than minDomains asks for.
__device__ __forceinline__ float spread_min_final(const Spread& sp, int c, float m)
{
    if (m >= kBig) m = 0.0f;
    const float md = sp.min_domains[c];
    if (md > 0.0f && sp.sizes[c] < md) m = 0.0f;
    return m;
}

// One block over every node: every node, a thread each blockDim apart, and
// the block-wide reductions.  reduce_mins merges each hard row's minimum
// across the team (ps.minm holds this block's; a block is the whole team).
struct BlockTeam : slices::BlockThreads {
    static constexpr bool kSpeculate = false;   // block_eval: two passes
    __device__ Step reduce_step(Step st, Scratch& sc) const { return block_reduce_step(st, sc); }
    __device__ void reduce_best(float& best, int& idx, Scratch& sc) const
    {
        block_reduce_best(best, idx, sc);
    }
    __device__ void reduce_mins(PodSpread&, int) const {}
};

// Pod i's rows into `ps`, minima 0 (one thread).
__device__ inline void pod_spread_rows(const Spread& sp, int i, PodSpread& ps)
{
    ps.any_hard = ps.any_soft = 0;
    for (int j = 0; j < sp.mc; ++j) {
        const int cidx = sp.pod_idx[(size_t)i * sp.mc + j];
        const int c = min(max(cidx, 0), sp.c_dim - 1);
        const bool hard = sp.hard[c] != 0;
        ps.c[j] = c;
        ps.enforced[j] = cidx >= 0 && hard;
        ps.soft[j] = cidx >= 0 && !hard;
        ps.any_hard |= ps.enforced[j];
        ps.any_soft |= ps.soft[j];
        ps.self_m[j] = sp.pod_matches[(size_t)i * sp.c_dim + c] ? 1.0f : 0.0f;
        ps.skew[j] = sp.max_skew[c];
        ps.damp[j] = sub(sp.max_skew[c], 1.0f);
        ps.weight[j] = log32(add(sp.sizes[c], 2.0f));
        ps.minm[j] = 0.0f;
    }
}

// Fill `ps` (shared) with pod i's rows and each hard row's minimum against
// the current counts.  Every thread of the team calls it.
template <class Team = BlockTeam>
__device__ inline void block_spread_pod(const Spread& sp, int n, int i, PodSpread& ps, Scratch& sc,
                                        const Team& team = Team())
{
    if (threadIdx.x == 0) pod_spread_rows(sp, i, ps);
    __syncthreads();
    for (int j = 0; j < sp.mc; ++j) {
        if (!ps.enforced[j]) continue;  // uniform: read from shared memory
        const float m = block_spread_min(sp, n, team.first(), team.stride(), team.end(n),
                                         ps.c[j], sc);
        if (threadIdx.x == 0) ps.minm[j] = m;
    }
    if (ps.any_hard) team.reduce_mins(ps, sp.mc);
    if (threadIdx.x == 0) {
        for (int j = 0; j < sp.mc; ++j) {
            if (ps.enforced[j]) ps.minm[j] = spread_min_final(sp, ps.c[j], ps.minm[j]);
        }
    }
    __syncthreads();
}

// spread_filter at node nd: count + selfMatch - min <= maxSkew on every
// hard row, and the node has the row's topology key.
__device__ __forceinline__ bool spread_ok(const Spread& sp, const PodSpread& ps, int n, int nd)
{
    for (int j = 0; j < sp.mc; ++j) {
        if (!ps.enforced[j]) continue;
        const size_t o = (size_t)ps.c[j] * n + nd;
        const float skew = sub(add(sp.counts[o], ps.self_m[j]), ps.minm[j]);
        if (!(skew <= ps.skew[j]) || sp.v[o] < 0) return false;
    }
    return true;
}

// spread_score's raw row at node nd: round(sum over soft rows of
// fma(count, weight, maxSkew - 1)), rows added in order; `ignored` when the
// node lacks a soft row's key.
__device__ __forceinline__ float spread_raw(const Spread& sp, const PodSpread& ps, int n, int nd,
                                            bool& ignored)
{
    float total = 0.0f;
    ignored = false;
    for (int j = 0; j < sp.mc; ++j) {
        if (!ps.soft[j]) continue;
        const size_t o = (size_t)ps.c[j] * n + nd;
        ignored |= sp.v[o] < 0;
        total = add(total, __fmaf_rn(sp.counts[o], ps.weight[j], ps.damp[j]));
    }
    return rintf(total);
}

// Account pod i placed on node `choice` (spread_update): every row the pod
// matches, at an eligible node with a value, gains one on every node that
// shares the value.  Block-wide; the caller synchronises after it.
__device__ inline void block_spread_update(const Spread& sp, int n, int i, int choice)
{
    for (int c = 0; c < sp.c_dim; ++c) {
        const size_t oc = (size_t)c * n;
        const int v_at = sp.v[oc + choice];
        if (!sp.pod_matches[(size_t)i * sp.c_dim + c] || !sp.eligible[oc + choice] || v_at < 0) {
            continue;
        }
        for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
            if (sp.v[oc + nd] == v_at) sp.counts[oc + nd] = add(sp.counts[oc + nd], 1.0f);
        }
    }
}

// ---- InterPodAffinity, required terms (ops/interpod.py) -------------------

// The inter-pod family's tables for a solve (the three bitsets are the
// carry, null when the family is off).  Words are the int32 views of the
// reference's u32 bitsets, read here as uint32_t.  Built by make_terms.
struct Terms {
    int on, w, u, p;             // family on; words a row; used slots; pod axis
    const uint32_t* key_bits;    // [N, W] the node has term t's topology key
    const int32_t* slot_v;       // [U, N] node values of each used slot
    const uint32_t* mi_slot;     // [U, P, W] terms the pod matches, by slot
    const uint32_t* anti_slot;   // [U, P, W] the pod's anti terms, by slot
    const uint32_t* aff_bits;    // [P, W] the pod's affinity terms
    const uint32_t* anti_bits;   // [P, W] the pod's anti terms
    const uint8_t* self_match;   // [P] the pod matches all its affinity terms
    uint32_t* present;           // [N, W] carry
    uint32_t* blocked;           // [N, W] carry
    uint32_t* global_any;        // [W] carry
    int cw;                      // words of the wave-safety rows (wavefront)
    const uint32_t* writes;      // [P, CW] terms a placement writes
    const uint32_t* reads;       // [P, CW] terms an evaluation reads
};

inline Terms make_terms(int on, int w, int u, int p, const void* key_bits,
                        const void* slot_v, const void* mi_slot, const void* anti_slot,
                        const void* aff_bits, const void* anti_bits, const void* self_match,
                        void* present, void* blocked, void* global_any, int cw,
                        const void* writes, const void* reads)
{
    Terms tm;
    tm.on = on;
    tm.w = w;
    tm.u = u;
    tm.p = p;
    tm.key_bits = (const uint32_t*)key_bits;
    tm.slot_v = (const int32_t*)slot_v;
    tm.mi_slot = (const uint32_t*)mi_slot;
    tm.anti_slot = (const uint32_t*)anti_slot;
    tm.aff_bits = (const uint32_t*)aff_bits;
    tm.anti_bits = (const uint32_t*)anti_bits;
    tm.self_match = (const uint8_t*)self_match;
    tm.present = (uint32_t*)present;
    tm.blocked = (uint32_t*)blocked;
    tm.global_any = (uint32_t*)global_any;
    tm.cw = cw;
    tm.writes = (const uint32_t*)writes;
    tm.reads = (const uint32_t*)reads;
    return tm;
}

// One pod's term words, in shared memory (block_interpod_pod).
struct PodTerms {
    int any_aff;             // the pod has an affinity term
    int fallback;            // first-pod escape: no affinity term matched
                             // anywhere, and the pod matches them all
    uint32_t mi[kMaxTW];     // terms the pod matches (every used slot)
    uint32_t anti[kMaxTW];   // its anti terms
    uint32_t aff[kMaxTW];    // its affinity terms
};

// Pod i's words against the current global bits into `pt` (one thread).
__device__ inline void pod_terms_words(const Terms& tm, int i, PodTerms& pt)
{
    int any_aff = 0, none_anywhere = 1;
    for (int w = 0; w < tm.w; ++w) {
        uint32_t mi = 0u;
        for (int j = 0; j < tm.u; ++j) mi |= tm.mi_slot[((size_t)j * tm.p + i) * tm.w + w];
        const uint32_t aff = tm.aff_bits[(size_t)i * tm.w + w];
        pt.mi[w] = mi;
        pt.anti[w] = tm.anti_bits[(size_t)i * tm.w + w];
        pt.aff[w] = aff;
        any_aff |= aff != 0u;
        if (aff & tm.global_any[w]) none_anywhere = 0;
    }
    pt.any_aff = any_aff;
    pt.fallback = none_anywhere && tm.self_match[i];
}

// Fill `pt` (shared) with pod i's words against the current global bits.
// Every thread of the block calls it.
__device__ inline void block_interpod_pod(const Terms& tm, int i, PodTerms& pt)
{
    if (threadIdx.x == 0) pod_terms_words(tm, i, pt);
    __syncthreads();
}

// interpod_filter at node nd: no existing pod's anti term matches the pod,
// none of the pod's anti terms matches an existing pod, and every affinity
// term is present with the node's keys (or the first-pod escape holds).
__device__ __forceinline__ bool interpod_ok(const Terms& tm, const PodTerms& pt, int nd)
{
    const uint32_t* pr = tm.present + (size_t)nd * tm.w;
    const uint32_t* bl = tm.blocked + (size_t)nd * tm.w;
    const uint32_t* kb = tm.key_bits + (size_t)nd * tm.w;
    bool all_here = true, keys_ok = true;
    for (int w = 0; w < tm.w; ++w) {
        if ((bl[w] & pt.mi[w]) || (pr[w] & pt.anti[w])) return false;
        all_here &= (pt.aff[w] & ~pr[w]) == 0u;
        keys_ok &= (pt.aff[w] & ~kb[w]) == 0u;
    }
    return !pt.any_aff || (keys_ok && (all_here || pt.fallback));
}

// Account pod i placed on node `choice` (interpod_update): per used slot,
// the terms it matches turn present on every node sharing the node's value
// in that slot (and global), its anti terms blocked.  Block-wide over this
// block's share of the team's nodes; each thread writes its own node rows,
// thread 0 the global word; the caller synchronises after it.
template <class Team = BlockTeam>
__device__ inline void block_interpod_update(const Terms& tm, int n, int i, int choice,
                                             const Team& team = Team())
{
    for (int j = 0; j < tm.u; ++j) {
        const int32_t* sv = tm.slot_v + (size_t)j * n;
        const int ta = sv[choice];
        if (ta < 0) continue;
        const uint32_t* mi = tm.mi_slot + ((size_t)j * tm.p + i) * tm.w;
        const uint32_t* an = tm.anti_slot + ((size_t)j * tm.p + i) * tm.w;
        bool any = false;
        for (int w = 0; w < tm.w; ++w) any |= (mi[w] | an[w]) != 0u;
        if (!any) continue;  // uniform across the block
        for (int nd = team.first(); nd < team.end(n); nd += team.stride()) {
            if (sv[nd] != ta) continue;
            for (int w = 0; w < tm.w; ++w) {
                tm.present[(size_t)nd * tm.w + w] |= mi[w];
                tm.blocked[(size_t)nd * tm.w + w] |= an[w];
            }
        }
        if (threadIdx.x == 0) {
            for (int w = 0; w < tm.w; ++w) tm.global_any[w] |= mi[w];
        }
    }
}

// A feasible node's total against the maxima `m` (combine_scores' weighted
// sum with the normalisations, the spread score when the family scores,
// the class's extra row `erow` when not null, and with `carve` the
// carve-out bonus).  sp_soft: the pod has soft rows the score reads.  With
// parts non-null, parts[0] and parts[1] take the node's fit and balanced
// scores.
__device__ __forceinline__ float node_score(
    int n, int r, int nd, const float* alloc, const float* requested, const float* nonzero,
    const float* pod_req, const float* pod_nz, const float* arow, const float* trow,
    const Spread& sp, const PodSpread& ps, bool sp_soft, const float* erow, bool carve,
    float bonus, const Step& m, const Config& cfg, float* parts = nullptr)
{
    const float* cap = alloc + (size_t)nd * r;
    const float fit_s = fit_score(cap, nonzero + (size_t)nd * r, pod_nz, cfg);
    const float bal_s = balanced_score(cap, requested + (size_t)nd * r, pod_req, cfg);
    if (parts != nullptr) {
        parts[0] = fit_s;
        parts[1] = bal_s;
    }
    float total = node_total(fit_s, bal_s, arow[nd], trow[nd], m.max_aff, m.max_taint, cfg);
    if (sp.on && sp.soft_on) {
        // spread_score: 0 for a pod without soft rows and at nodes that
        // lack a soft row's key
        float s = 0.0f;
        if (sp_soft) {
            bool ignored;
            const float raw = spread_raw(sp, ps, n, nd, ignored);
            if (!ignored) {
                s = m.sp_mx <= 0.0f ? kMaxNodeScore
                    : floorf(dv(mul(kMaxNodeScore, sub(add(m.sp_mx, m.sp_mn), raw)),
                                fmaxf(m.sp_mx, 1e-30f)));
            }
        }
        total = add(total, mul(cfg.spread_weight, s));
    }
    if (erow != nullptr) total = add(total, erow[nd]);
    // every pod of a slice batch, shaped or not (x + 0 is +0)
    if (carve) total = add(total, bonus);
    return total;
}

// What one pod's evaluation against the carry gives every thread.
struct Eval {
    Step all;     // stage flags, feasible count, normalisation maxima
    bool found;   // some node passes every filter
    int choice;   // first-index argmax of the masked scores, in [0, n) when found
    float best;   // its score (-inf when !found; NaN when a feasible score is)
    int reason;   // REASON_* of the first stage that emptied the set
};

// The scan's step for one pod, block-wide (ops/assign.py `_eval_pod` +
// `_pick`): pass 1 over N for the filters in the reference's stage order
// (static, resources, ports, spread, inter-pod), the stage anys, the
// feasible count, the normalisation maxima and the spread score's raw max
// / min over scored nodes; pass 2 for the scores of feasible nodes and the
// first-index argmax.  With `masked` non-null, pass 2 also writes every
// node's masked score (-inf where infeasible).  pod_req, pod_nz and
// pod_ports may point to shared memory; `ps` is the pod's block_spread_pod
// (read only when sp.on), `pt` its block_interpod_pod (read only when
// tm.on); `erow` is the class's extra score row, or null; `sl` / `pc` the
// slice carve-out family and the pod's view of it (null off the family;
// for an anchor, block_build_grid has run on `requested`).  The passes run
// over this block's share of the team's nodes and reduce through the team,
// so every thread of the team returns the same Eval.
//
// A team with kSpeculate (the cluster) scores in pass 1 against its guess
// of the maxima (the previous step's) and merges the step and the pick in
// one exchange; when the merged maxima the scores read equal the guess bit
// for bit, every score is the one pass 2 would compute and pass 2 is
// skipped, else pass 2 runs as for a block.
template <class Team = BlockTeam>
__device__ inline Eval block_eval(
    int n, int r, int pw, bool use_ports,
    const float* alloc, const float* requested, const float* nonzero, const uint32_t* ports,
    const uint8_t* srow, const float* arow, const float* trow,
    const float* pod_req, const float* pod_nz, const uint32_t* pod_ports,
    const Spread& sp, const PodSpread& ps, const Terms& tm, const PodTerms& pt,
    const float* erow, const Config& cfg, Scratch& sc, float* masked,
    const slices::Slices* sl = nullptr, const slices::PodCarve* pc = nullptr,
    const Team& team = Team())
{
    const int first = team.first(), stride = team.stride(), end = team.end(n);
    const bool sp_hard = sp.on && ps.any_hard;
    const bool sp_soft = sp.on && sp.soft_on && ps.any_soft;
    const bool carve = sl != nullptr && sl->on;             // the bonus is added
    const bool carve_shaped = carve && pc->shaped;          // unshaped: 0 and ok
    const bool carve_filter = carve_shaped && sl->require;

    auto score_at = [&](int nd, const Step& m, float bonus) {
        return node_score(n, r, nd, alloc, requested, nonzero, pod_req, pod_nz, arow, trow,
                          sp, ps, sp_soft, erow, carve, bonus, m, cfg);
    };

    Step st = step_zero();
    float best = -INFINITY;
    int best_idx = 0x7fffffff;
    for (int nd = first; nd < end; nd += stride) {
        if (!srow[nd]) continue;
        st.flags |= 1;
        if (!node_fits(requested + (size_t)nd * r, alloc + (size_t)nd * r, pod_req, r)) continue;
        st.flags |= 2;
        if (use_ports && ports_clash(ports + (size_t)nd * pw, pod_ports, pw)) continue;
        st.flags |= 4;
        if (sp_hard && !spread_ok(sp, ps, n, nd)) continue;
        st.flags |= 8;
        if (tm.on && !interpod_ok(tm, pt, nd)) continue;
        st.flags |= 32;
        float bonus = 0.0f;
        if (carve_filter || (Team::kSpeculate && carve_shaped)) {
            const bool ok = slices::carve_node(*sl, *pc, requested, nd, bonus);
            if (carve_filter && !ok) continue;
        }
        st.flags |= 16;
        st.count += 1;
        st.max_aff = fmaxf(st.max_aff, arow[nd]);
        st.max_taint = fmaxf(st.max_taint, trow[nd]);
        if (sp_soft) {
            bool ignored;
            const float raw = spread_raw(sp, ps, n, nd, ignored);
            if (!ignored) {
                st.sp_mx = fmaxf(st.sp_mx, raw);
                st.sp_mn = fminf(st.sp_mn, raw);
            }
        }
        if constexpr (Team::kSpeculate) better(best, best_idx, score_at(nd, team.guess, bonus), nd);
    }
    Eval ev;
    bool picked = false;
    if constexpr (Team::kSpeculate) {
        ev.all = team.reduce_step_best(st, best, best_idx, sc);
        picked = team.guessed(ev.all, sp_soft) || !(ev.all.flags & 16);
    } else {
        ev.all = team.reduce_step(st, sc);
    }
    ev.found = (ev.all.flags & 16) != 0;

    if (!picked) {
        best = -INFINITY;
        best_idx = 0x7fffffff;
        if (ev.found || masked != nullptr) {
            for (int nd = first; nd < end; nd += stride) {
                float total = -INFINITY;
                const float* cap = alloc + (size_t)nd * r;
                const float* rq = requested + (size_t)nd * r;
                float bonus = 0.0f;
                bool carve_ok = true;
                if (carve_shaped) carve_ok = slices::carve_node(*sl, *pc, requested, nd, bonus);
                if (srow[nd] && node_fits(rq, cap, pod_req, r)
                    && !(use_ports && ports_clash(ports + (size_t)nd * pw, pod_ports, pw))
                    && !(sp_hard && !spread_ok(sp, ps, n, nd))
                    && !(tm.on && !interpod_ok(tm, pt, nd))
                    && !(carve_filter && !carve_ok)) {
                    total = score_at(nd, ev.all, bonus);
                    better(best, best_idx, total, nd);
                }
                if (masked != nullptr) masked[nd] = total;
            }
        }
        team.reduce_best(best, best_idx, sc);
    }
    ev.choice = best_idx;
    ev.best = ev.found ? best : -INFINITY;
    ev.reason = ev.found ? kReasonNone
        : !(ev.all.flags & 1) ? kReasonStatic
        : !(ev.all.flags & 2) ? kReasonResources
        : !(ev.all.flags & 4) ? kReasonPorts
        : !(ev.all.flags & 8) ? kReasonSpread
        : !(ev.all.flags & 32) ? kReasonInterpod
        : carve_filter ? slices::kReasonSlice
        : kReasonInterpod;
    return ev;
}

// Gang all-or-nothing post-pass (assign.py `_gang_release`), team-wide:
// release every placement of a group with an unplaced member.  Each node
// takes its released pods' requests off in pod index order (one thread a
// node, in the block that owns it), the order of the reference's
// scatter-add, which decides the rounding once a node's sum is past
// float32's exact range.  `incomplete` is zeroed scratch of
// max(n_groups, 1) ints.
template <class Team = BlockTeam>
__device__ inline void block_gang_release(
    int n, int p, int r, int n_groups, const uint8_t* pod_valid, const int32_t* group_id,
    const float* pod_req, const float* pod_nz, float* requested, float* nonzero,
    int32_t* assignment, float* scores, int32_t* reasons, int32_t* incomplete,
    const Team& team = Team())
{
    for (int i = team.rank(); i < p; i += team.size()) {
        const int g = group_id[i];
        if (g >= 0 && pod_valid[i] && assignment[i] < 0) incomplete[min(g, n_groups - 1)] = 1;
    }
    team.sync();
    for (int b = team.first(); b < team.end(n); b += team.stride()) {
        for (int i = 0; i < p; ++i) {
            const int g = group_id[i];
            if (g < 0 || assignment[i] != b || !incomplete[min(g, n_groups - 1)]) continue;
            for (int rr = 0; rr < r; ++rr) {
                requested[(size_t)b * r + rr] = sub(requested[(size_t)b * r + rr], pod_req[(size_t)i * r + rr]);
                nonzero[(size_t)b * r + rr] = sub(nonzero[(size_t)b * r + rr], pod_nz[(size_t)i * r + rr]);
            }
        }
    }
    team.sync();
    for (int i = team.rank(); i < p; i += team.size()) {
        const int g = group_id[i];
        if (g < 0 || assignment[i] < 0 || !incomplete[min(g, n_groups - 1)]) continue;
        assignment[i] = -1;
        scores[i] = -INFINITY;
        reasons[i] = kReasonGang;
    }
}

}  // namespace solve
