// Kernel `evaluate_single`: one pod's full Filter + Score over every node,
// with no placement (what the extender's filter and prioritize verbs need:
// the node set, not one pick).
//
// Replaces: kubernetes_tpu/ops/assign.py:1665 `evaluate_single` — the
// static row (class_statics, launched before), `fits_resources`, the hard
// spread filter (`spread_filter`, topology.py:121), the required inter-pod
// filter (`interpod_filter`, interpod.py:156), the slice carve-out anchor
// stage (`carveout_eval`, slices.py:191, no gang carry: a lone pod is an
// anchor), then `score_from_raw` with the soft spread score and the extra
// score row (class_extras, launched between the two stages) and the
// carve-out bonus.
//
// Two stages, two launches on one stream, because the extra row
// (preferred inter-pod affinity, ImageLocality) is normalised over the
// pod's post-filter feasible set (assign.py:1726-1736), which stage 1
// computes and kernel class_extras reads before stage 2:
//   stage 1 (filter)  feas[N], the post-spread set feas_sp[N] (the soft
//                     spread score's normalisation set: the reference takes
//                     spread_score before the inter-pod and slice filters),
//                     and the carve-out bonus[N];
//   stage 2 (score)   the normalisation maxima over feas (affinity, taint)
//                     and feas_sp (spread), then where(feas, score, -inf).
//
// Bound on this card: bytes.  Each stage reads the node tables once (~60 B
// a node: allocatable, requested, nonzero, the static and raw rows, the
// spread and term rows the pod reads) and writes a few bytes a node; at
// 8,192 nodes that is ~0.5 MB, well under a microsecond at the card's
// rate.  Each stage is one block of 1,024 threads on one SM (8 nodes a
// thread at 8,192 nodes), so launch latency and one SM's L2 rate bound it.
//
// Numerics: the same bodies as the solves (solve_common.cuh: node_fits,
// spread_ok / spread_raw, interpod_ok, fit_score, balanced_score,
// node_total; slices_common.cuh: carve_node), built with --fmad=false, so
// every score equals the reference bit for bit.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads, 1) single_filter_kernel(
    int n, int r,
    const float* __restrict__ alloc, const float* __restrict__ requested,
    const uint8_t* __restrict__ srow,     // [N] static row of pod 0
    const float* __restrict__ pod_req,    // [R] pod 0's requests
    Spread sp, Terms tm, slices::Slices sl,
    uint8_t* feas, uint8_t* feas_sp, float* bonus)   // [N] each
{
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;
    __shared__ slices::PodCarve pc;
    __shared__ float s_req[kMaxR];
    for (int t = threadIdx.x; t < r; t += blockDim.x) s_req[t] = pod_req[t];
    if (sl.on && threadIdx.x == 0) slices::load_pod_carve(sl, 0, -1, 0, nullptr, nullptr, pc);
    __syncthreads();
    if (sp.on) block_spread_pod(sp, n, 0, ps, sc);
    if (tm.on) block_interpod_pod(tm, 0, pt);
    const bool shaped = sl.on && pc.shaped;
    if (shaped) slices::block_build_grid(sl, n, requested);
    const bool sp_hard = sp.on && ps.any_hard;
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
        bool f = srow[nd] && node_fits(requested + (size_t)nd * r, alloc + (size_t)nd * r, s_req, r);
        if (sp_hard && f) f = spread_ok(sp, ps, n, nd);
        feas_sp[nd] = f;
        if (tm.on && f) f = interpod_ok(tm, pt, nd);
        float b = 0.0f;
        if (shaped) {
            const bool ok = slices::carve_node(sl, pc, requested, nd, b);
            if (sl.require) f = f && ok;
        }
        feas[nd] = f;
        bonus[nd] = b;
    }
}

__global__ void __launch_bounds__(kThreads, 1) single_score_kernel(
    int n, int r,
    const float* __restrict__ alloc, const float* __restrict__ requested,
    const float* __restrict__ nonzero,
    const float* __restrict__ arow, const float* __restrict__ trow,   // [N] raw rows of pod 0
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    Spread sp, int carve_on,
    const uint8_t* __restrict__ feas, const uint8_t* __restrict__ feas_sp,
    const float* __restrict__ bonus, const float* __restrict__ extra,   // extra: [N] or null
    float* masked)                                                       // [N]
{
    __shared__ Config cfg;
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    if (threadIdx.x == 0) load_config(cfg, iparams, fparams);
    for (int t = threadIdx.x; t < r; t += blockDim.x) {
        s_req[t] = pod_req[t];
        s_nz[t] = pod_nz[t];
    }
    __syncthreads();
    if (sp.on) block_spread_pod(sp, n, 0, ps, sc);
    const bool sp_soft = sp.on && sp.soft_on && ps.any_soft;
    Step st = step_zero();
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
        if (feas[nd]) {
            st.max_aff = fmaxf(st.max_aff, arow[nd]);
            st.max_taint = fmaxf(st.max_taint, trow[nd]);
        }
        if (sp_soft && feas_sp[nd]) {
            bool ignored;
            const float raw = spread_raw(sp, ps, n, nd, ignored);
            if (!ignored) {
                st.sp_mx = fmaxf(st.sp_mx, raw);
                st.sp_mn = fminf(st.sp_mn, raw);
            }
        }
    }
    st = block_reduce_step(st, sc);
    const float mx = st.sp_mx, mn = st.sp_mn;
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
        float total = -INFINITY;
        if (feas[nd]) {
            const float* cap = alloc + (size_t)nd * r;
            const float* rq = requested + (size_t)nd * r;
            const float fit_s = fit_score(cap, nonzero + (size_t)nd * r, s_nz, cfg);
            const float bal_s = balanced_score(cap, rq, s_req, cfg);
            total = node_total(fit_s, bal_s, arow[nd], trow[nd], st.max_aff, st.max_taint, cfg);
            if (sp.on && sp.soft_on) {
                float s = 0.0f;
                if (sp_soft) {
                    bool ignored;
                    const float raw = spread_raw(sp, ps, n, nd, ignored);
                    if (!ignored) {
                        s = mx <= 0.0f ? kMaxNodeScore
                            : floorf(dv(mul(kMaxNodeScore, sub(add(mx, mn), raw)),
                                        fmaxf(mx, 1e-30f)));
                    }
                }
                total = add(total, mul(cfg.spread_weight, s));
            }
            if (extra != nullptr) total = add(total, extra[nd]);
            if (carve_on) total = add(total, bonus[nd]);
        }
        masked[nd] = total;
    }
}

}  // namespace

extern "C" int evaluate_single_limits(int which)
{
    switch (which) {
        case 0: return kMaxR;
        case 1: return kMaxMC;
        case 2: return kMaxTW;
        case 3: return slices::kMaxDim;
        default: return -1;
    }
}

extern "C" int evaluate_single_launch(
    int stage, int n, int r, int p,
    const void* alloc, const void* requested, const void* nonzero,
    const void* srow, const void* arow, const void* trow,
    const void* pod_req, const void* pod_nz, const void* iparams, const void* fparams,
    int sp_on, int sp_soft, int sp_c, int sp_mc, const void* sp_pod_idx,
    const void* sp_pod_matches, const void* sp_max_skew, const void* sp_min_domains,
    const void* sp_hard, const void* sp_eligible, const void* sp_v, const void* sp_sizes,
    void* sp_counts,
    int tm_on, int tm_w, int tm_u, int tm_p, int tm_cw, const void* tm_key_bits,
    const void* tm_slot_v, const void* tm_mi_slot, const void* tm_anti_slot,
    const void* tm_aff_bits, const void* tm_anti_bits, const void* tm_self_match,
    void* tm_present, void* tm_blocked, void* tm_global_any, const void* tm_writes,
    const void* tm_reads, const void* extra,
    int sl_on, int sl_require, int sl_z, int sl_d, int sl_pods_col, const void* sl_node_valid,
    const void* sl_slice_id, const void* sl_coords, const void* sl_dims, const void* sl_pod_shape,
    void* sl_pres, void* sl_occ, void* sl_integral, void* sl_free_count,
    void* feas, void* feas_sp, void* bonus, void* masked, void* stream)
{
    if (r > kMaxR || n < 1) return (int)cudaErrorInvalidValue;
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1)) return (int)cudaErrorInvalidValue;
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || tm_p != p)) {
        return (int)cudaErrorInvalidValue;
    }
    if (sl_on && (sl_z < 1 || sl_d < 1 || sl_d > slices::kMaxDim || sl_pods_col >= r)) {
        return (int)cudaErrorInvalidValue;
    }
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, sp_counts);
    cudaStream_t st = (cudaStream_t)stream;
    if (stage == 0) {
        const Terms tm = make_terms(tm_on, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v, tm_mi_slot,
                                    tm_anti_slot, tm_aff_bits, tm_anti_bits, tm_self_match,
                                    tm_present, tm_blocked, tm_global_any, tm_cw, tm_writes,
                                    tm_reads);
        const slices::Slices sl = slices::make_slices(
            sl_on, sl_require, sl_z, sl_d, r, sl_pods_col, sl_node_valid, sl_slice_id,
            sl_coords, sl_dims, sl_pod_shape, sl_pres, sl_occ, sl_integral, sl_free_count);
        single_filter_kernel<<<1, kThreads, 0, st>>>(
            n, r, (const float*)alloc, (const float*)requested, (const uint8_t*)srow,
            (const float*)pod_req, sp, tm, sl, (uint8_t*)feas, (uint8_t*)feas_sp,
            (float*)bonus);
    } else {
        single_score_kernel<<<1, kThreads, 0, st>>>(
            n, r, (const float*)alloc, (const float*)requested, (const float*)nonzero,
            (const float*)arow, (const float*)trow, (const float*)pod_req,
            (const float*)pod_nz, (const int32_t*)iparams, (const float*)fparams, sp, sl_on,
            (const uint8_t*)feas, (const uint8_t*)feas_sp, (const float*)bonus,
            (const float*)extra, (float*)masked);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* evaluate_single_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
