// Kernel `wavefront`: the wave-parallel greedy solve, exact to the scan.
//
// Replaces: kubernetes_tpu/ops/assign.py:1090 `wavefront_assign` — the
// lax.scan over waves of the batched [K, N] member evaluation against the
// wave-start carry (`_eval_pod`, assign.py:374, with the spread filter and
// score of topology.py:121/153, the inter-pod filter of interpod.py:156 and
// the class's hoisted extra row), the top-(K+1) candidate lists (:1263),
// `wave_safe` (:1188, ports, the spread rows of :1182-1203 and the term
// rows of :1173-1180, :1204-1208), the O(K) mini-scan with its `cheap`
// closed-form correction (:1328-1377) and `full` re-evaluation on a fit
// flip (:1305-1326), the deferred port, spread and term commits
// (:1406-1446), the `serial` fallback for coupled waves (:1450-1521, with
// `spread_update` and `interpod_update` per member), the wave telemetry
// and the `_gang_release` epilogue (:558).  The wave plan itself is host numpy
// (`plan_waves`), as in the reference.
//
// Bound on this card: latency of the chain of waves.  Wave w+1 must see
// wave w's placements, so the W waves run one after another.  Per wave the
// work is K evaluations over N nodes (about 60 bytes and ~60 flops a node
// each), a top-(K+1) selection per member and a K-step mini-scan whose
// steps are O(K) unless a fit flips.  The bytes the function must move
// take microseconds at the card's memory rate; what this design pays is
// two launches a wave and one SM's latency for each mini-scan step.
//
// Design: for each wave, two launches on the caller's stream, no host sync:
//   wave_eval   K blocks of 256 threads, one per member: the scan's own
//               block-wide evaluation (solve_common.cuh `block_eval`)
//               against the wave-start carry, writing the member's masked
//               score row [N], then kk = min(K+1, N) rounds of a block
//               argmax over the entries after the previous pick, giving the
//               top list in (NaN first, score desc, index asc) order —
//               lax.top_k's order, with no sort;
//   wave_step   one block of 1024 threads: the coupling check (a host port,
//               a spread row or a term one member writes and a later one
//               reads), then
//               either the mini-scan (one warp corrects the wave-start
//               scores at nodes picked earlier in the wave, thread 0 picks
//               between them and the best unpicked top-list entry; a fit
//               flip at a picked node re-evaluates the member block-wide
//               against the live carry) and the deferred port commit, or
//               the serial fallback (the scan's step per member).  A safe
//               wave's spread counts and term bits are committed after its
//               mini-scan (no member read what another wrote).  It adds the
//               wave and its fallbacks to two device counters.
// A last single-block launch releases incomplete gangs.  One host call
// enqueues all of it.  The carry (requested, nonzero, ports) is the
// caller's copy, updated in place (the spread counts too); the port table
// starts as the bound claims (a node whose bound claims conflict is
// already outside the class's static row, so the test equals the
// reference's in-batch carry).  Spread members couple through their
// counts and inter-pod members through their term bits, so the planner
// gives them waves of one.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kEvalThreads = 256;
constexpr int kStepThreads = 1024;
constexpr int kMaxK = 32;  // wave width; the step block's warp 0 holds one lane a member

__global__ void __launch_bounds__(kEvalThreads) wave_eval_kernel(
    int n, int r, int c_dim, int pw, int kk, int use_ports,
    const int32_t* __restrict__ row,        // [K] this wave's members, -1 pad
    const float* __restrict__ alloc, const float* requested, const float* nonzero,
    const uint32_t* ports,
    const uint8_t* __restrict__ sfeas, const float* __restrict__ aff,
    const float* __restrict__ taint, const int32_t* __restrict__ class_id,
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const uint32_t* __restrict__ pod_ports,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    Spread sp,                              // counts read only
    Terms tm,                               // bits read only
    const float* __restrict__ extra,        // [C, N] or null
    float* masked,                          // [K, N]
    float* topv, int32_t* topi,             // [K, kk]
    int32_t* found_k, int32_t* reason_k, int32_t* cnt_k)  // [K]
{
    __shared__ Config cfg;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    __shared__ uint32_t s_ports[kMaxPW];
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;

    const int j = blockIdx.x;
    const int i = row[j];
    if (i < 0) return;  // a padding slot: nothing reads its outputs
    const int tid = threadIdx.x;
    if (tid == 0) load_config(cfg, iparams, fparams);
    for (int t = tid; t < r; t += blockDim.x) {
        s_req[t] = pod_req[(size_t)i * r + t];
        s_nz[t] = pod_nz[(size_t)i * r + t];
    }
    if (use_ports) {
        for (int t = tid; t < pw; t += blockDim.x) s_ports[t] = pod_ports[(size_t)i * pw + t];
    }
    __syncthreads();

    const int c = min(max(class_id[i], 0), c_dim - 1);
    float* mrow = masked + (size_t)j * n;
    if (sp.on) block_spread_pod(sp, n, i, ps, sc);
    if (tm.on) block_interpod_pod(tm, i, pt);
    const Eval ev = block_eval(
        n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
        sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
        s_req, s_nz, s_ports, sp, ps, tm, pt,
        extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, mrow);
    if (tid == 0) {
        found_k[j] = ev.found ? 1 : 0;
        reason_k[j] = ev.reason;
        cnt_k[j] = ev.all.count;
    }
    // each thread reads back only the entries it wrote in block_eval; the
    // order is ranks_above's (NaN first, then score desc, index asc), and
    // the (NaN, -1) start ranks above every entry
    float pv = NAN;
    int pi = -1;
    for (int t = 0; t < kk; ++t) {
        float best = -INFINITY;
        int bi = 0x7fffffff;
        for (int nd = tid; nd < n; nd += blockDim.x) {
            const float v = mrow[nd];
            if (ranks_above(pv, pi, v, nd)) better(best, bi, v, nd);
        }
        block_reduce_best(best, bi, sc);
        if (tid == 0) {
            topv[(size_t)j * kk + t] = best;
            topi[(size_t)j * kk + t] = bi;
        }
        pv = best;
        pi = bi;
    }
}

__device__ inline void load_pod(int i, int r, int pw, bool use_ports,
                                const float* pod_req, const float* pod_nz,
                                const uint32_t* pod_ports,
                                float* s_req, float* s_nz, uint32_t* s_ports)
{
    for (int t = threadIdx.x; t < r; t += blockDim.x) {
        s_req[t] = pod_req[(size_t)i * r + t];
        s_nz[t] = pod_nz[(size_t)i * r + t];
    }
    if (use_ports) {
        for (int t = threadIdx.x; t < pw; t += blockDim.x) s_ports[t] = pod_ports[(size_t)i * pw + t];
    }
}

__global__ void __launch_bounds__(kStepThreads, 1) wave_step_kernel(
    int n, int r, int c_dim, int pw, int k_dim, int kk, int use_ports,
    const int32_t* __restrict__ row,
    const float* __restrict__ alloc, float* requested, float* nonzero, uint32_t* ports,
    const uint8_t* __restrict__ sfeas, const float* __restrict__ aff,
    const float* __restrict__ taint, const int32_t* __restrict__ class_id,
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const uint32_t* __restrict__ pod_ports,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    Spread sp,                              // counts: the carry, in place
    Terms tm,                               // bits: the carry, in place
    const float* __restrict__ extra,        // [C, N] or null
    const float* masked, const float* topv, const int32_t* topi,
    const int32_t* found_k, const int32_t* reason_k, const int32_t* cnt_k,
    int32_t* assignment, float* scores, int32_t* feas_counts, int32_t* reasons,
    int32_t* counters)                      // [2]: wave_count, wave_fallbacks
{
    __shared__ Config cfg;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    __shared__ uint32_t s_ports[kMaxPW];
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;
    __shared__ int s_mem[kMaxK];
    __shared__ int s_pick[kMaxK];              // node member j took in this wave, -1 none
    __shared__ float s_r0[kMaxK][kMaxR];       // wave-start requested row of s_pick[j]
    __shared__ float s_z0[kMaxK][kMaxR];       // wave-start nonzero row of s_pick[j]
    __shared__ float s_cand[kMaxK];            // corrected score at s_pick[jj]
    __shared__ int s_found, s_choice, s_nfb;

    const int tid = threadIdx.x;
    if (tid == 0) {
        load_config(cfg, iparams, fparams);
        s_nfb = 0;
    }
    if (tid < k_dim) {
        s_mem[tid] = row[tid];
        s_pick[tid] = -1;
    }
    __syncthreads();
    int live = 0;
    for (int j = 0; j < k_dim; ++j) live += s_mem[j] >= 0 ? 1 : 0;
    if (live == 0) return;  // an all-padding row is skipped, not counted

    // wave_safe: no member claims a host port that a later member claims,
    // no member matches a spread row that a later member's constraints
    // read, and no member writes a term (matched, or carried as
    // anti-affinity) that a later member's terms read
    int clash = 0;
    if (use_ports) {
        const int total = k_dim * k_dim * pw;
        for (int t = tid; t < total; t += blockDim.x) {
            const int w = t % pw, ab = t / pw, a = ab / k_dim, b = ab % k_dim;
            const int ia = s_mem[a], ib = s_mem[b];
            if (a < b && ia >= 0 && ib >= 0
                && (pod_ports[(size_t)ia * pw + w] & pod_ports[(size_t)ib * pw + w]) != 0u) {
                clash = 1;
            }
        }
    }
    if (sp.on) {
        const int total = k_dim * k_dim * sp.mc;
        for (int t = tid; t < total; t += blockDim.x) {
            const int jj = t % sp.mc, ab = t / sp.mc, a = ab / k_dim, b = ab % k_dim;
            const int ia = s_mem[a], ib = s_mem[b];
            if (a < b && ia >= 0 && ib >= 0) {
                const int row = sp.pod_idx[(size_t)ib * sp.mc + jj];
                if (row >= 0 && row < sp.c_dim && sp.pod_matches[(size_t)ia * sp.c_dim + row]) {
                    clash = 1;
                }
            }
        }
    }
    if (tm.on) {
        const int total = k_dim * k_dim * tm.cw;
        for (int t = tid; t < total; t += blockDim.x) {
            const int w = t % tm.cw, ab = t / tm.cw, a = ab / k_dim, b = ab % k_dim;
            const int ia = s_mem[a], ib = s_mem[b];
            if (a < b && ia >= 0 && ib >= 0
                && (tm.writes[(size_t)ia * tm.cw + w] & tm.reads[(size_t)ib * tm.cw + w]) != 0u) {
                clash = 1;
            }
        }
    }
    const bool safe = !__syncthreads_or(clash);

    if (!safe) {
        // coupled wave: the scan's own step, member by member
        for (int j = 0; j < k_dim; ++j) {
            const int i = s_mem[j];
            if (i < 0) continue;
            load_pod(i, r, pw, use_ports != 0, pod_req, pod_nz, pod_ports, s_req, s_nz, s_ports);
            __syncthreads();
            const int c = min(max(class_id[i], 0), c_dim - 1);
            if (sp.on) block_spread_pod(sp, n, i, ps, sc);
            if (tm.on) block_interpod_pod(tm, i, pt);
            const Eval ev = block_eval(
                n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
                sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
                s_req, s_nz, s_ports, sp, ps, tm, pt,
                extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, nullptr);
            if (tid == 0) {
                assignment[i] = ev.found ? ev.choice : -1;
                scores[i] = ev.best;
                feas_counts[i] = ev.all.count;
                reasons[i] = ev.reason;
            }
            if (ev.found) {
                const int nd = ev.choice;
                if (tid < r) {
                    requested[(size_t)nd * r + tid] = add(requested[(size_t)nd * r + tid], s_req[tid]);
                    nonzero[(size_t)nd * r + tid] = add(nonzero[(size_t)nd * r + tid], s_nz[tid]);
                }
                if (use_ports) {
                    for (int t = tid; t < pw; t += blockDim.x) ports[(size_t)nd * pw + t] |= s_ports[t];
                }
                if (sp.on) block_spread_update(sp, n, i, nd);
                if (tm.on) block_interpod_update(tm, n, i, nd);
            }
            __syncthreads();
        }
        if (tid == 0) {
            counters[0] += 1;
            counters[1] += live;
        }
        return;
    }

    // the O(K) mini-scan
    for (int j = 0; j < k_dim; ++j) {
        const int i = s_mem[j];
        if (i < 0) continue;
        load_pod(i, r, pw, use_ports != 0, pod_req, pod_nz, pod_ports, s_req, s_nz, s_ports);
        __syncthreads();
        const int c = min(max(class_id[i], 0), c_dim - 1);

        // does the member's fit flip at a node picked earlier in the wave?
        int flip = 0;
        if (tid < j && s_pick[tid] >= 0) {
            const int nd = s_pick[tid];
            const float* cap = alloc + (size_t)nd * r;
            const bool f0 = node_fits(s_r0[tid], cap, s_req, r);
            const bool fc = node_fits(requested + (size_t)nd * r, cap, s_req, r);
            flip = sfeas[(size_t)c * n + nd] && (f0 != fc) ? 1 : 0;
        }
        if (__syncthreads_or(flip)) {
            // exact re-evaluation against the live carry (the port table, the
            // spread counts and the term bits are still the wave start's,
            // which a safe wave's members never touch)
            if (sp.on) block_spread_pod(sp, n, i, ps, sc);
            if (tm.on) block_interpod_pod(tm, i, pt);
            const Eval ev = block_eval(
                n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
                sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
                s_req, s_nz, s_ports, sp, ps, tm, pt,
                extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, nullptr);
            if (tid == 0) {
                s_found = ev.found ? 1 : 0;
                s_choice = ev.choice;
                assignment[i] = ev.found ? ev.choice : -1;
                scores[i] = ev.best;
                feas_counts[i] = ev.all.count;
                reasons[i] = ev.reason;
                s_nfb += 1;
            }
        } else {
            // the scores differ from the wave start's only at picked nodes, and
            // only in the allocation parts: correct those in closed form
            if (tid < j) {
                float v = -INFINITY;
                const int nd = s_pick[tid];
                if (nd >= 0) {
                    const float base = masked[(size_t)j * n + nd];
                    if (base > -INFINITY) {
                        const float* cap = alloc + (size_t)nd * r;
                        const float fit0 = fit_score(cap, s_z0[tid], s_nz, cfg);
                        const float bal0 = balanced_score(cap, s_r0[tid], s_req, cfg);
                        const float fitc = fit_score(cap, nonzero + (size_t)nd * r, s_nz, cfg);
                        const float balc = balanced_score(cap, requested + (size_t)nd * r, s_req, cfg);
                        const float d = add(mul(cfg.fit_weight, sub(fitc, fit0)),
                                            mul(cfg.bal_weight, sub(balc, bal0)));
                        v = add(base, d);
                    }
                }
                s_cand[tid] = v;
            }
            __syncthreads();
            if (tid == 0) {
                // the best unpicked entry of the member's top list
                float bu_v = -INFINITY;
                int bu_i = n;
                for (int t = 0; t < kk; ++t) {
                    const float tv = topv[(size_t)j * kk + t];
                    const int ti = topi[(size_t)j * kk + t];
                    bool picked = false;
                    for (int jj = 0; jj < j; ++jj) picked |= s_pick[jj] == ti;
                    if (!picked && tv > -INFINITY) {
                        bu_v = tv;
                        bu_i = ti;
                        break;
                    }
                }
                // jnp.max over the union: a NaN candidate makes it NaN, and
                // the member is then not found, as in the reference
                float best = bu_v;
                for (int jj = 0; jj < j; ++jj) {
                    if (s_pick[jj] >= 0) best = nan_max(best, s_cand[jj]);
                }
                const bool found = found_k[j] != 0 && best > -INFINITY;
                // first-max-index over the candidate union == over the
                // corrected [N] vector
                int choice = n;
                for (int jj = 0; jj < j; ++jj) {
                    if (s_pick[jj] >= 0 && s_cand[jj] >= best && s_cand[jj] > -INFINITY) {
                        choice = min(choice, s_pick[jj]);
                    }
                }
                if (bu_v >= best && bu_v > -INFINITY) choice = min(choice, bu_i);
                choice = min(max(choice, 0), n - 1);
                s_found = found ? 1 : 0;
                s_choice = choice;
                assignment[i] = found ? choice : -1;
                scores[i] = found ? best : -INFINITY;
                feas_counts[i] = cnt_k[j];
                reasons[i] = reason_k[j];
            }
        }
        __syncthreads();
        // commit to the live carry, remembering the node's wave-start row
        if (s_found) {
            const int nd = s_choice;
            if (tid < r) {
                int prev = -1;
                for (int jj = 0; jj < j; ++jj) {
                    if (prev < 0 && s_pick[jj] == nd) prev = jj;
                }
                s_r0[j][tid] = prev >= 0 ? s_r0[prev][tid] : requested[(size_t)nd * r + tid];
                s_z0[j][tid] = prev >= 0 ? s_z0[prev][tid] : nonzero[(size_t)nd * r + tid];
                requested[(size_t)nd * r + tid] = add(requested[(size_t)nd * r + tid], s_req[tid]);
                nonzero[(size_t)nd * r + tid] = add(nonzero[(size_t)nd * r + tid], s_nz[tid]);
            }
            __syncthreads();
            if (tid == 0) s_pick[j] = nd;
        }
        __syncthreads();
    }
    // deferred port, spread and term commits: no member of a safe wave read
    // these (each thread adds to the same nodes for every member, so the
    // spread adds and the term ORs need no barrier between members)
    if (use_ports) {
        for (int t = tid; t < k_dim * pw; t += blockDim.x) {
            const int j = t / pw, w = t % pw;
            if (s_mem[j] >= 0 && s_pick[j] >= 0) {
                atomicOr(&ports[(size_t)s_pick[j] * pw + w], pod_ports[(size_t)s_mem[j] * pw + w]);
            }
        }
    }
    if (sp.on) {
        for (int j = 0; j < k_dim; ++j) {
            if (s_mem[j] >= 0 && s_pick[j] >= 0) block_spread_update(sp, n, s_mem[j], s_pick[j]);
        }
    }
    if (tm.on) {
        for (int j = 0; j < k_dim; ++j) {
            if (s_mem[j] >= 0 && s_pick[j] >= 0) block_interpod_update(tm, n, s_mem[j], s_pick[j]);
        }
    }
    if (tid == 0) {
        counters[0] += 1;
        counters[1] += s_nfb;
    }
}

__global__ void __launch_bounds__(kStepThreads, 1) wave_gang_kernel(
    int n, int p, int r, int n_groups, const uint8_t* pod_valid, const int32_t* group_id,
    const float* pod_req, const float* pod_nz, float* requested, float* nonzero,
    int32_t* assignment, float* scores, int32_t* reasons, int32_t* incomplete)
{
    block_gang_release(n, p, r, n_groups, pod_valid, group_id, pod_req, pod_nz,
                       requested, nonzero, assignment, scores, reasons, incomplete);
}

}  // namespace

extern "C" int wavefront_max_k() { return kMaxK; }

extern "C" int wavefront_launch(
    int n, int r, int p, int c_dim, int pw, int k_dim, int w_rows, int use_ports,
    int n_groups,
    const void* members, const void* alloc, void* requested, void* nonzero, void* ports,
    const void* sfeas, const void* aff, const void* taint, const void* class_id,
    const void* pod_valid, const void* group_id, const void* pod_req,
    const void* pod_nz, const void* pod_ports, const void* iparams,
    const void* fparams,
    int sp_on, int sp_soft, int sp_c, int sp_mc, const void* sp_pod_idx,
    const void* sp_pod_matches, const void* sp_max_skew, const void* sp_min_domains,
    const void* sp_hard, const void* sp_eligible, const void* sp_v, const void* sp_sizes,
    void* sp_counts,
    int tm_on, int tm_w, int tm_u, int tm_p, int tm_cw, const void* tm_key_bits,
    const void* tm_slot_v, const void* tm_mi_slot, const void* tm_anti_slot,
    const void* tm_aff_bits, const void* tm_anti_bits, const void* tm_self_match,
    void* tm_present, void* tm_blocked, void* tm_global_any, const void* tm_writes,
    const void* tm_reads, const void* extra,
    void* masked, void* topv, void* topi, void* found_k,
    void* reason_k, void* cnt_k, void* assignment, void* scores,
    void* feas_counts, void* reasons, void* counters, void* incomplete,
    void* stream)
{
    if (k_dim < 1 || k_dim > kMaxK || r > kMaxR || pw > kMaxPW) return (int)cudaErrorInvalidValue;
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1)) return (int)cudaErrorInvalidValue;
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || tm_p != p || tm_cw < 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if (p == 0 || n == 0) return 0;
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, sp_counts);
    const Terms tm = make_terms(tm_on, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v, tm_mi_slot,
                                tm_anti_slot, tm_aff_bits, tm_anti_bits, tm_self_match,
                                tm_present, tm_blocked, tm_global_any, tm_cw, tm_writes,
                                tm_reads);
    const int kk = min(k_dim + 1, n);
    cudaStream_t s = (cudaStream_t)stream;
    for (int w = 0; w < w_rows; ++w) {
        const int32_t* row = (const int32_t*)members + (size_t)w * k_dim;
        wave_eval_kernel<<<k_dim, kEvalThreads, 0, s>>>(
            n, r, c_dim, pw, kk, use_ports, row, (const float*)alloc,
            (const float*)requested, (const float*)nonzero, (const uint32_t*)ports,
            (const uint8_t*)sfeas, (const float*)aff, (const float*)taint,
            (const int32_t*)class_id, (const float*)pod_req, (const float*)pod_nz,
            (const uint32_t*)pod_ports, (const int32_t*)iparams, (const float*)fparams,
            sp, tm, (const float*)extra, (float*)masked, (float*)topv, (int32_t*)topi,
            (int32_t*)found_k,
            (int32_t*)reason_k, (int32_t*)cnt_k);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        wave_step_kernel<<<1, kStepThreads, 0, s>>>(
            n, r, c_dim, pw, k_dim, kk, use_ports, row, (const float*)alloc,
            (float*)requested, (float*)nonzero, (uint32_t*)ports,
            (const uint8_t*)sfeas, (const float*)aff, (const float*)taint,
            (const int32_t*)class_id, (const float*)pod_req, (const float*)pod_nz,
            (const uint32_t*)pod_ports, (const int32_t*)iparams, (const float*)fparams,
            sp, tm, (const float*)extra, (const float*)masked, (const float*)topv,
            (const int32_t*)topi,
            (const int32_t*)found_k, (const int32_t*)reason_k, (const int32_t*)cnt_k,
            (int32_t*)assignment, (float*)scores, (int32_t*)feas_counts,
            (int32_t*)reasons, (int32_t*)counters);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (n_groups > 0) {
        wave_gang_kernel<<<1, kStepThreads, 0, s>>>(
            n, p, r, n_groups, (const uint8_t*)pod_valid, (const int32_t*)group_id,
            (const float*)pod_req, (const float*)pod_nz, (float*)requested,
            (float*)nonzero, (int32_t*)assignment, (float*)scores, (int32_t*)reasons,
            (int32_t*)incomplete);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* wavefront_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
