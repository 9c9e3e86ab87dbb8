// Kernel `greedy_scan`: the whole sequential-greedy batch solve, one launch.
//
// Replaces: kubernetes_tpu/ops/assign.py:591 `greedy_assign` — the lax.scan
// over pods in solve order of `_eval_pod` (assign.py:374: class statics,
// `fits_resources`, in-batch ports, `spread_filter` / `spread_score`,
// topology.py:121/153, `interpod_filter`, interpod.py:156), the scores
// (`least_allocated`, `most_allocated`, `requested_to_capacity_ratio`,
// `balanced_allocation`, `normalize`, `combine_scores` with the class's
// hoisted extra row, scores.py), `_pick` (first-max-index, assign.py:358)
// and the assume carry update (with `spread_update`, topology.py:201, and
// `interpod_update`, interpod.py:182), followed by the `_gang_release`
// epilogue (assign.py:558), which leaves the term bits as they are.  With
// the slice family, the carve-out stage (`carveout_eval`, slices.py:191)
// and the gangs' carve-out carry (assign.py:650-735: gang_sl, gang_lo,
// gang_corner) too.
//
// Bound on this card: latency of the sequential chain.  Pod k+1 must see
// pod k's placement, so the P steps run one after another; each step is
// two passes over the N nodes (about 60 bytes a node from L2: the class
// row, allocatable, requested and nonzero-requested) plus the reductions
// that end each pass.  The bytes the function must move (its inputs once,
// its outputs once) take tens of microseconds at the card's memory rate;
// the chain of P dependent steps is what the kernel pays.  On one block of
// 1,024 threads (the first design) a step cost ~21.5 us at 8,192 nodes on
// an H100: eight nodes a thread a pass, four block reductions, one SM's
// issue rate and L2 latency.
//
// Design: one thread-block cluster of G blocks on neighbouring SMs,
// launched with cudaLaunchKernelEx and the cluster dimension attribute
// (non-portable sizes allowed above 8).  The shape is a fixed function of
// N (cluster_common.cuh launch_shape), about one node a thread: blocks of 512 threads
// up to 8,192 nodes (a 512-thread block may use 128 registers a thread, so
// the evaluation runs without spills), of 1,024 threads (64 registers)
// above; G = N / threads, at least 2 and at most 16 — 2 blocks of 512 at
// 1,024 nodes and under, 8 at 4,096, 16 at 8,192; 9 to 16 blocks of 1,024
// up to 16,384 nodes, 16 above (65,536: 4 nodes a thread).  Block b owns
// the 32-node chunks q with q % G == b: a warp reads 32 neighbouring nodes,
// and the padded tail of the node axis, where no node is feasible, is
// spread over every block instead of idling the last ones.  Per step,
// every block holds the pod's rows in its own shared memory and:
//   spread  with the family, each hard row's min over its own nodes, then
//           the blocks' minima merged (one cluster barrier);
//   pass 1  over its own nodes: static row, resource fit, in-batch ports,
//           hard spread rows, the inter-pod bit checks, and each feasible
//           node's score against a guess of the normalisation maxima (the
//           last step's); warp reductions of the stage anys, the feasible
//           count, the maxima and the (score, lowest index) pick by
//           ranks_above, one block barrier, then thread t < G merges the
//           block's warps and writes both partials into slot [rank] of
//           block t's shared memory (cluster.map_shared_rank); one cluster
//           barrier (barrier.cluster arrive.release / wait.acquire), and
//           each block merges the G slots itself;
//   pass 2  only when the merged maxima the scores read differ from the
//           guess (bit for bit): the scores against the merged maxima and
//           the same exchange again.  A guess that holds makes every pass-1
//           score the one pass 2 would compute, so its pick is the pick;
//   carry   the block that owns the winner adds its requests and ports to
//           the winner's rows, and every block adds the spread counts and
//           ORs the term bits at the nodes of its own chunks that share the
//           winner's value (each row's value at the winner read once, one
//           thread a row, instead of one row after another).  Every later
//           read of these rows is a read of the same block's nodes, so a
//           block barrier orders them; the global term word is kept in each
//           block's shared memory (every block ORs the same words) and
//           written out once at the end.
// So a step pays one cluster barrier while the maxima hold (batches
// without affinity or taint rows: always), two when they move, one more
// with hard spread rows.  The exchange slots alternate between two buffers
// by step parity: a block writes step k+2's partials only after every
// block has passed a barrier of step k+1, hence after every read of step
// k's.
// Slice anchors: the grid and its integral image are built team-wide over
// the cluster (slices_common.cuh block_build_grid, cluster barriers
// between the occupancy and the integral passes).  Every block writes a new
// anchor's gang_sl / gang_lo (the same values; each block reads back its
// own store), and the winner's block its gang_corner.  The gang release
// runs team-wide after the loop, each node in its own block.
//
// Exactness: every merge across blocks is order-free — flags OR, the
// feasible count in integers, fmaxf / fminf maxima and minima, and the pick
// through ranks_above's total order (solve_common.cuh) — and a pass-1 pick
// stands only when the maxima its scores read equal the merged ones bit
// for bit, so the results equal the one-block kernel's, and the
// reference's, whatever G is.
// Host ports are checked against one carried port table that starts as the
// bound pods' claims: a node whose bound claims conflict is already outside
// the class's static row, so the test equals the reference's in-batch-only
// carry and the table is the post-solve port_bits as it stands.
// The carry tensors are copies made by the caller; nothing else is written.
//
// Slice carve-outs (slices_common.cuh): a shaped pod whose gang has no box
// yet (or a shaped pod outside any gang) is an anchor: the cluster first
// rebuilds the occupancy grid and its integral image from the carried
// `requested` in global scratch (64 slices of 16^3 cells do not fit in
// shared memory), then block_eval runs the carve-out stage on it.  An
// anchored member needs only the free test and its gang's box, and an
// unshaped pod only the zero bonus, so neither rebuilds the grid.  After
// the pick, a new anchor's slice, coordinates and whether it sat on a
// free-box corner of this step's grid are recorded (the reference's second
// corner_mask, assign.py:717-721, reads the same pre-placement state).
//
// The filters, scores and the team-generic evaluation of one pod live in
// solve_common.cuh, shared with the auction kernels (which evaluate with
// one block, BlockTeam); the cluster's shape, team and launch live in
// cluster_common.cuh, shared with wavefront.cu and evaluate_single.cu.
//
// Numerics: every score is a floor of IEEE float32 operations in the
// reference's order (__fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, and the
// file is built with --fmad=false), so the results equal the reference bit
// for bit.  The one multiply-add the reference's compiler fuses (inside
// jnp.interp) is fused here too (__fmaf_rn).

#include "cluster_common.cuh"

using namespace solve;

namespace {

template <int kThreads>
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
    Spread sp,                              // counts: the carry, in place
    Terms tm,                               // bits: the carry, in place
    const float* __restrict__ extra,        // [C, N] extra score rows, or null
    slices::Slices sl,                      // the carve-out family (sl.on = 0: off)
    int32_t* gang_sl, int32_t* gang_lo,     // [G], [G, 3] carry, or null
    uint8_t* gang_corner,                   // [G] carry, or null
    int32_t* assignment, float* scores, int32_t* feas_counts, int32_t* reasons,
    int32_t* incomplete)                    // [max(G, 1)] zeroed scratch
{
    __shared__ Config cfg;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    __shared__ uint32_t s_ports[kMaxPW];
    __shared__ uint32_t s_gany[kMaxTW];     // this block's copy of the term word carry
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;
    __shared__ slices::PodCarve pc;
    __shared__ Slots slots;
    __shared__ int s_vat[kThreads];
    const bool carry = sl.on && gang_sl != nullptr;

    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x;
    ClusterTeam team;
    team.init(&slots);
    const bool lead = team.rank_ == 0 && tid == 0;   // writes the per-pod outputs

    Terms tml = tm;                          // the term word carry read from shared memory
    tml.global_any = s_gany;
    if (tid == 0) load_config(cfg, iparams, fparams);
    if (tm.on) {
        for (int w = tid; w < tm.w; w += kThreads) s_gany[w] = tm.global_any[w];
    }
    cluster.sync();   // every block runs before any block writes a slot

    int i_next = order[0];   // the next step's pod, loaded a step ahead
    for (int k = 0; k < p; ++k) {
        team.par = k & 1;
        const int i = i_next;
        if (k + 1 < p) i_next = order[k + 1];
        const int c = min(max(class_id[i], 0), c_dim - 1);
        for (int t = tid; t < r; t += kThreads) {
            s_req[t] = pod_req[(size_t)i * r + t];
            s_nz[t] = pod_nz[(size_t)i * r + t];
        }
        if (use_ports) {
            for (int t = tid; t < pw; t += kThreads) s_ports[t] = pod_ports[(size_t)i * pw + t];
        }
        if (sl.on && tid == 0) {
            slices::load_pod_carve(sl, i, group_id[i], n_groups, carry ? gang_sl : nullptr, gang_lo, pc);
        }
        __syncthreads();
        if (sp.on) block_spread_pod(sp, n, i, ps, sc, team);
        if (tm.on) block_interpod_pod(tml, i, pt);
        if (sl.on && pc.shaped && !pc.anchored) slices::block_build_grid(sl, n, requested, team);

        const Eval ev = block_eval(
            n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
            sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
            s_req, s_nz, s_ports, sp, ps, tml, pt,
            extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, nullptr,
            sl.on ? &sl : nullptr, &pc, team);

        const int choice = ev.choice;
        const bool owner = ev.found && team.owns(choice);
        if (lead) {
            assignment[i] = ev.found ? choice : -1;
            scores[i] = ev.best;
            feas_counts[i] = ev.all.count;
            reasons[i] = ev.reason;
        }
        const int g = group_id[i];
        if (carry && ev.found && g >= 0 && pc.shaped && !pc.anchored) {
            // a new anchor (the pod is shaped, its gang has no box yet),
            // read against the pre-placement carry and this step's grid
            if (tid == 0) {
                const int gc = slices::clampi(g, 0, n_groups - 1);
                gang_sl[gc] = sl.slice_id[choice];
                for (int j = 0; j < 3; ++j) gang_lo[(size_t)gc * 3 + j] = sl.coords[(size_t)choice * 4 + j];
                if (owner) gang_corner[gc] = slices::corner_at(sl, pc, requested, choice) ? 1 : 0;
            }
            __syncthreads();
        }
        if (ev.found) {
            if (owner) {
                for (int t = tid; t < r; t += kThreads) {
                    const size_t o = (size_t)choice * r + t;
                    requested[o] = add(requested[o], s_req[t]);
                    nonzero[o] = add(nonzero[o], s_nz[t]);
                }
                if (use_ports) {
                    for (int t = tid; t < pw; t += kThreads) {
                        ports[(size_t)choice * pw + t] |= s_ports[t];
                    }
                }
            }
            if (sp.on) cluster_spread_update(sp, n, i, choice, team, s_vat);
            if (tm.on) block_interpod_update(tml, n, i, choice, team);
        }
        __syncthreads();
    }

    if (tm.on && team.rank_ == 0) {
        for (int w = tid; w < tm.w; w += kThreads) tm.global_any[w] = s_gany[w];
    }
    // every block's outputs and carry rows visible to the whole cluster
    cluster.sync();
    // gang all-or-nothing: release every placement of an incomplete group
    if (n_groups > 0) {
        block_gang_release(n, p, r, n_groups, pod_valid, group_id, pod_req, pod_nz,
                           requested, nonzero, assignment, scores, reasons, incomplete, team);
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
        case 6: return kMaxMC;
        case 7: return kMaxTW;
        case 8: return kMaxCluster;
        default: return -1;
    }
}

// The number of blocks in the scan's cluster for N nodes.
extern "C" int greedy_scan_cluster_size(int n)
{
    return launch_shape(n).blocks;
}

// The threads of each block of the scan's cluster for N nodes.
extern "C" int greedy_scan_block_threads(int n)
{
    return launch_shape(n).threads;
}

// The block of the scan's cluster at N nodes that owns node nd.
extern "C" int greedy_scan_node_block(int n, int nd)
{
    return block_of(nd, launch_shape(n).blocks);
}

extern "C" int greedy_scan_launch(
    int n, int r, int p, int c_dim, int pw, int use_ports, int n_groups,
    const void* alloc, void* requested, void* nonzero, void* ports,
    const void* sfeas, const void* aff, const void* taint,
    const void* order, const void* class_id, const void* pod_valid,
    const void* group_id, const void* pod_req, const void* pod_nz,
    const void* pod_ports, const void* iparams, const void* fparams,
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
    void* gang_sl, void* gang_lo, void* gang_corner,
    void* assignment, void* scores, void* feas_counts, void* reasons,
    void* incomplete, void* stream)
{
    if (sl_on && (sl_z < 1 || sl_d < 1 || sl_d > slices::kMaxDim || sl_pods_col >= r)) {
        return (int)cudaErrorInvalidValue;
    }
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1)) return (int)cudaErrorInvalidValue;
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || tm_p != p)) {
        return (int)cudaErrorInvalidValue;
    }
    if (p == 0) return 0;
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, sp_counts);
    const Terms tm = make_terms(tm_on, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v, tm_mi_slot,
                                tm_anti_slot, tm_aff_bits, tm_anti_bits, tm_self_match,
                                tm_present, tm_blocked, tm_global_any, tm_cw, tm_writes,
                                tm_reads);
    const slices::Slices sl = slices::make_slices(
        sl_on, sl_require, sl_z, sl_d, r, sl_pods_col, sl_node_valid, sl_slice_id, sl_coords,
        sl_dims, sl_pod_shape, sl_pres, sl_occ, sl_integral, sl_free_count);
    const Shape shape = launch_shape(n);
    auto* kernel = shape.threads == kSmallThreads ? &greedy_scan_kernel<kSmallThreads>
                                                  : &greedy_scan_kernel<kClusterThreads>;
    return (int)launch_cluster(
        kernel, shape, 0, (cudaStream_t)stream,
        n, r, p, c_dim, pw, use_ports, n_groups,
        (const float*)alloc, (float*)requested, (float*)nonzero,
        (uint32_t*)ports, (const uint8_t*)sfeas, (const float*)aff,
        (const float*)taint, (const int32_t*)order, (const int32_t*)class_id,
        (const uint8_t*)pod_valid, (const int32_t*)group_id,
        (const float*)pod_req, (const float*)pod_nz,
        (const uint32_t*)pod_ports, (const int32_t*)iparams,
        (const float*)fparams, sp, tm, (const float*)extra, sl, (int32_t*)gang_sl,
        (int32_t*)gang_lo, (uint8_t*)gang_corner, (int32_t*)assignment, (float*)scores,
        (int32_t*)feas_counts, (int32_t*)reasons, (int32_t*)incomplete);
}

extern "C" const char* greedy_scan_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
