// Kernel `evaluate_single`: one pod's full Filter + Score over every node,
// with no placement (what the extender's filter and prioritize verbs need:
// the node set, not one pick).
//
// Replaces: kubernetes_tpu/ops/assign.py:1665 `evaluate_single` — the
// static row (class_statics, launched before), `fits_resources`, the hard
// spread filter (`spread_filter`, topology.py:121), the required inter-pod
// filter (`interpod_filter`, interpod.py:156), the slice carve-out anchor
// stage (`carveout_eval`, slices.py:191, no gang carry: a lone pod is an
// anchor), then `score_from_raw` with the soft spread score, the extra
// score row (class_extras) and the carve-out bonus.
//
// Stages (the launch's `stage`):
//   0 (filter)  feas[N], the post-spread set feas_sp[N] (the soft spread
//               score's normalisation set: the reference takes spread_score
//               before the inter-pod and slice filters) and the carve-out
//               bonus[N];
//   1 (score)   the normalisation maxima over feas (affinity, taint) and
//               feas_sp (spread), then where(feas, score, -inf) with the
//               extra row;
//   2 (fused)   0 then 1 in one launch, for a pod without an extra row:
//               the filter's sets stay in each thread's registers (a bit a
//               node), the maxima are merged in one cluster exchange, and
//               feas, feas_sp and bonus are still written for the caller.
// A pod with an extra row (preferred inter-pod affinity, ImageLocality)
// takes 0, class_extras, 1: the extra row is normalised over the pod's
// post-filter feasible set (assign.py:1726-1736), which stage 0 computes.
//
// Bound on this card: bytes.  The stages read the node tables once (~60 B
// a node: allocatable, requested, nonzero, the static and raw rows, the
// spread and term rows the pod reads) and write a few bytes a node; at
// 8,192 nodes that is ~0.5 MB, well under a microsecond at the card's
// rate.  What a launch pays is its latency: the first design ran each
// stage on one block of 1,024 threads (8 nodes a thread at 8,192 nodes, one
// SM's L2 rate) and made two launches a pod.
//
// Design: each stage runs as one thread-block cluster of the scan's shape
// (cluster_common.cuh launch_shape: 16 blocks of 512 threads at 8,192
// nodes, about one node a thread), block b on its own 32-node chunks.
// Team-wide steps: each hard spread row's minimum (one cluster exchange),
// the slice grid of a shaped pod (cluster barriers), the maxima (one
// exchange; fmaxf / fminf, order-free).  A fused launch without spread or
// slices pays two cluster barriers: one before any block writes another's
// slot, one for the maxima.
//
// Numerics: the same bodies as the solves (solve_common.cuh: node_fits,
// spread_ok / spread_raw, interpod_ok, node_score; slices_common.cuh:
// carve_node), built with --fmad=false, so every score equals the
// reference bit for bit.

#include "cluster_common.cuh"

using namespace solve;

namespace {

constexpr int kStageFilter = 0, kStageScore = 1, kStageFused = 2;
constexpr int kMaxNodesAThread = 64;   // the fused stage's bits a thread

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1) single_kernel(
    int stage, int n, int r,
    const float* __restrict__ alloc, const float* __restrict__ requested,
    const float* __restrict__ nonzero,
    const uint8_t* __restrict__ srow,                                 // [N] static row of pod 0
    const float* __restrict__ arow, const float* __restrict__ trow,   // [N] raw rows of pod 0
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    Spread sp, Terms tm, slices::Slices sl,
    const float* __restrict__ extra,                                  // [N] or null (stage 1)
    uint8_t* feas, uint8_t* feas_sp, float* bonus, float* masked)     // [N] each
{
    __shared__ Config cfg;
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;
    __shared__ slices::PodCarve pc;
    __shared__ Slots slots;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    ClusterTeam team;
    team.init(&slots);
    const bool filter = stage != kStageScore, score = stage != kStageFilter;
    if (score && threadIdx.x == 0) load_config(cfg, iparams, fparams);
    for (int t = threadIdx.x; t < r; t += blockDim.x) {
        s_req[t] = pod_req[t];
        s_nz[t] = score ? pod_nz[t] : 0.0f;
    }
    if (filter && sl.on && threadIdx.x == 0) {
        slices::load_pod_carve(sl, 0, -1, 0, nullptr, nullptr, pc);
    }
    team.sync();   // every block runs before any block writes a slot
    if (sp.on) block_spread_pod(sp, n, 0, ps, sc, team);
    if (filter && tm.on) block_interpod_pod(tm, 0, pt);
    const bool shaped = filter && sl.on && pc.shaped;
    if (shaped) slices::block_build_grid(sl, n, requested, team);
    const bool sp_hard = sp.on && ps.any_hard;
    const bool sp_soft = sp.on && sp.soft_on && ps.any_soft;

    // the filter over this block's nodes (stage 1: its output read back),
    // and the maxima's partials
    Step st = step_zero();
    uint64_t fbits = 0, spbits = 0;   // the fused stage's sets, bit k: node first + k stride
    int k = 0;
    for (int nd = team.first(); nd < n; nd += team.stride(), ++k) {
        bool f, fsp;
        if (filter) {
            f = srow[nd] && node_fits(requested + (size_t)nd * r, alloc + (size_t)nd * r, s_req, r);
            if (sp_hard && f) f = spread_ok(sp, ps, n, nd);
            fsp = f;
            if (tm.on && f) f = interpod_ok(tm, pt, nd);
            float b = 0.0f;
            if (shaped) {
                const bool ok = slices::carve_node(sl, pc, requested, nd, b);
                if (sl.require) f = f && ok;
            }
            feas[nd] = f;
            feas_sp[nd] = fsp;
            bonus[nd] = b;
            fbits |= (uint64_t)f << k;
            spbits |= (uint64_t)fsp << k;
        } else {
            f = feas[nd] != 0;
            fsp = feas_sp[nd] != 0;
        }
        if (!score) continue;
        if (f) {
            st.max_aff = fmaxf(st.max_aff, arow[nd]);
            st.max_taint = fmaxf(st.max_taint, trow[nd]);
        }
        if (sp_soft && fsp) {
            bool ignored;
            const float raw = spread_raw(sp, ps, n, nd, ignored);
            if (!ignored) {
                st.sp_mx = fmaxf(st.sp_mx, raw);
                st.sp_mn = fminf(st.sp_mn, raw);
            }
        }
    }
    if (!score) return;
    const Step all = team.reduce_step(st, sc);
    k = 0;
    for (int nd = team.first(); nd < n; nd += team.stride(), ++k) {
        const bool f = filter ? ((fbits >> k) & 1) != 0 : feas[nd] != 0;
        float total = -INFINITY;
        if (f) {
            float b = 0.0f;
            if (shaped) slices::carve_node(sl, pc, requested, nd, b);
            else if (!filter && sl.on) b = bonus[nd];
            total = node_score(n, r, nd, alloc, requested, nonzero, s_req, s_nz, arow, trow, sp,
                               ps, sp_soft, extra, sl.on != 0, b, all, cfg);
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

// The stage value of the fused launch (filter and score in one launch, for
// a pod without an extra row); a library without it runs stage 0 then 1.
extern "C" int evaluate_single_fused_stage()
{
    return kStageFused;
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
    if (r > kMaxR || n < 1 || stage < kStageFilter || stage > kStageFused) {
        return (int)cudaErrorInvalidValue;
    }
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1)) return (int)cudaErrorInvalidValue;
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || tm_p != p)) {
        return (int)cudaErrorInvalidValue;
    }
    const bool filter = stage != kStageScore;
    if (filter && sl_on
        && (sl_z < 1 || sl_d < 1 || sl_d > slices::kMaxDim || sl_pods_col >= r)) {
        return (int)cudaErrorInvalidValue;
    }
    const Shape shape = launch_shape(n);
    const long long team = (long long)shape.blocks * shape.threads;
    if (stage == kStageFused && (extra != nullptr || n > kMaxNodesAThread * team)) {
        return (int)cudaErrorInvalidValue;
    }
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, sp_counts);
    const Terms tm = make_terms(filter ? tm_on : 0, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v,
                                tm_mi_slot, tm_anti_slot, tm_aff_bits, tm_anti_bits,
                                tm_self_match, tm_present, tm_blocked, tm_global_any, tm_cw,
                                tm_writes, tm_reads);
    const slices::Slices sl = slices::make_slices(
        sl_on, filter ? sl_require : 0, sl_z, sl_d, r, sl_pods_col, sl_node_valid, sl_slice_id,
        sl_coords, sl_dims, sl_pod_shape, sl_pres, sl_occ, sl_integral, sl_free_count);
    auto* kernel = shape.threads == kSmallThreads ? &single_kernel<kSmallThreads>
                                                  : &single_kernel<kClusterThreads>;
    return (int)launch_cluster(
        kernel, shape, 0, (cudaStream_t)stream, stage, n, r, (const float*)alloc,
        (const float*)requested, (const float*)nonzero, (const uint8_t*)srow,
        (const float*)arow, (const float*)trow, (const float*)pod_req, (const float*)pod_nz,
        (const int32_t*)iparams, (const float*)fparams, sp, tm, sl, (const float*)extra,
        (uint8_t*)feas, (uint8_t*)feas_sp, (float*)bonus, (float*)masked);
}

extern "C" const char* evaluate_single_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
