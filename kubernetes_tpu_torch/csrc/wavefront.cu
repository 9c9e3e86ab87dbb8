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
// each), a top list per member and a K-step mini-scan whose steps are O(K)
// unless a fit flips.  The bytes the function must move take microseconds
// at the card's memory rate; what a design pays is the barriers and the
// latency of each wave.  The first design made two launches a wave from a
// host loop (the evaluation on K blocks, each member's top-(K+1) list in
// K+1 block argmaxes over the row; the mini-scan on one block of 1,024
// threads, six block barriers a member): ~0.6 ms a wave of 32 members at
// 8,192 nodes, ~0.25 ms a one-pod wave, on an H100.
//
// Design: one launch a batch, one thread-block cluster of the scan's shape
// (cluster_common.cuh launch_shape: 16 blocks of 512 threads at 8,192
// nodes, block b on the 32-node chunks q with q % G == b).  Every block
// runs the wave loop; per wave:
//   coupling   every block computes wave_safe itself from the read-only pod
//              tables (a wave of one is safe).  A coupled wave runs the
//              scan's own step member by member (block_eval<ClusterTeam>,
//              the owner adds the carry rows, every block updates the
//              spread counts and term bits at its own nodes).
//   evaluation every live member against the wave-start carry over the
//              block's own nodes (member_pass), writing masked[j, nd] and,
//              at feasible nodes, the fit and balanced scores (the
//              mini-scan's wave-start parts).  A member whose class,
//              requests and ports equal an earlier member's (a replica's;
//              the spread and inter-pod families are never shared) shares
//              that member's evaluation, partials and list: the same
//              inputs give the same bits.  Each evaluation's partial —
//              stage flags, feasible count, maxima, its best entry that is
//              neither NaN nor -inf, its NaN count — is merged across the
//              cluster for all members in one exchange (part_exchange:
//              one warp a member merges the block's warps, then stores
//              into slot [rank] of every block; one cluster barrier).
//              Pass 1 scores against a guess of the maxima (the slot's last
//              merged ones, as the scan's pass 1); a member whose merged
//              maxima differ bit for bit from its guess takes pass 2 and
//              one more exchange.
//   top lists  member j (j-th live member) can find at most j picked nodes
//              ahead of it in its list, and the cheap pick skips NaN and
//              -inf entries, so it needs the top min(j + 1, kk - nan_j)
//              entries that are neither (kk = min(K + 1, N), nan_j = min(kk,
//              the row's NaN count): the reference's kk window exactly).  A
//              one-entry list is the merged best entry; a longer one (as
//              long as the last member sharing it needs): one warp reads
//              the block's own scores once (kChunks coalesced chunks in
//              flight, a chunk that cannot enter skipped) into a sorted
//              32-lane list (bitonic sort of the chunk, then a bitonic
//              merge), every block sends its lists to every block (one
//              cluster barrier), and every block merges the G lists with
//              the same merge.  The receive buffer, up to K(K+1)/2 entries
//              from each block (67.6 KB at K = 32, G = 16), is dynamic
//              shared memory.
//   mini-scan  one warp, replicated in every block from the same merged
//              lists: lane jj holds earlier pick jj; the flip test, the
//              closed-form correction (the live fit and balanced scores
//              against the stored wave-start ones), nan_max and the
//              first-max index run on the lanes, and each member's loads
//              (its wave-start score, parts and static bit at the picks,
//              and at its list's best unpicked entry the rows a first pick
//              commits) are issued while the member before it is decided.
//              Every block keeps each picked node's wave-start and live
//              rows in its own shared memory (live = wave start plus each
//              picker's requests, added in member order, so every block
//              holds the same bits; rows padded to 33 words, so the lanes'
//              reads of their own rows hit 32 banks), and no barrier is
//              taken per member.  No block writes a carry row during the
//              mini-scan (blocks run it at different speeds, and a slower
//              one may still read a node's wave-start row from device
//              memory); a fit flip first takes a cluster barrier, the
//              owners write the live rows picked so far, and
//              block_eval<ClusterTeam> re-evaluates the member against the
//              live carry.
//   commits    after a cluster barrier (waves of two or more members), each
//              picked node's live row is written once by its owner, and the
//              deferred port, spread and term commits are made at each
//              block's own nodes; block 0 counts the wave and its
//              fallbacks.
// A one-member wave (every spread and affinity-direction wave) pays one
// cluster barrier while the guess holds (two with hard spread rows), as a
// scan step does.  The gang release runs after the loop, each node in its
// own block.  The carry (requested, nonzero, ports) is the caller's copy,
// updated in place (the spread counts and term bits too); the port table
// starts as the bound claims (a node whose bound claims conflict is already
// outside the class's static row, so the test equals the reference's
// in-batch carry).  masked is [3, K, N] (the rows, then the fit and the
// balanced scores); topv, topi, found_k, reason_k and cnt_k are unused.
//
// Exactness: every merge across blocks is order-free (flags OR, integer
// counts, fmaxf / fminf, ranks_above's total order), a pass-1 score stands
// only when the maxima it read equal the merged ones bit for bit, and the
// carry rows are the one-block kernel's additions in its order, so the
// results equal the reference's whatever G is.

#include "cluster_common.cuh"

using namespace solve;

namespace {

constexpr int kMaxK = 32;             // wave width: one lane a member
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 0x7fffffff;    // the index of an empty list entry (-inf)
constexpr int kChunks = 8;            // a top list's chunk loads in flight
constexpr int kRowStride = kMaxR + 1;  // a member's rows: lane jj reads row jj, bank-free

// A member's partial over a set of nodes: the Step, its best entry that is
// neither NaN nor -inf (ranks_above order), and how many scores are NaN.
struct Part {
    Step st;
    float bv;
    int bi;
    int nan;
};

__device__ __forceinline__ Part part_zero()
{
    Part p;
    p.st = step_zero();
    p.bv = -INFINITY;
    p.bi = kEmpty;
    p.nan = 0;
    return p;
}

__device__ __forceinline__ Part part_merge(Part a, const Part& b)
{
    a.st = step_merge(a.st, b.st);
    better(a.bv, a.bi, b.bv, b.bi);
    a.nan += b.nan;
    return a;
}

// The dynamic shared memory of a launch (byte offsets): each member's
// spread and term rows (with the family), the warps' partials ([K][warps]),
// the exchange slots of the partials ([2][K][G]), the merged lists
// ([K][32]) and the receive buffer of the lists ([G][K(K+1)/2]).
struct WaveSmem {
    int ps, pt, wparts, pslots, mlist, recv, total;
};

__host__ __device__ inline int smem_take(int& at, int bytes)
{
    const int here = at;
    at += (bytes + 15) & ~15;
    return here;
}

__host__ __device__ inline WaveSmem wave_smem(int k_dim, int g, int warps, bool sp_on, bool tm_on)
{
    WaveSmem o;
    int at = 0;
    o.ps = smem_take(at, sp_on ? k_dim * (int)sizeof(PodSpread) : 0);
    o.pt = smem_take(at, tm_on ? k_dim * (int)sizeof(PodTerms) : 0);
    o.wparts = smem_take(at, warps * k_dim * (int)sizeof(Part));
    o.pslots = smem_take(at, 2 * g * k_dim * (int)sizeof(Part));
    o.mlist = smem_take(at, k_dim * 32 * (int)sizeof(int2));
    o.recv = smem_take(at, g * (k_dim * (k_dim + 1) / 2) * (int)sizeof(int2));
    o.total = at;
    return o;
}

__device__ __forceinline__ int2 entry(float v, int i) { return make_int2(__float_as_int(v), i); }

// The filters at node nd in the reference's stage order (wave batches have
// no slice family): the Step's stage flags the node reaches; bit 4 set
// when it passes every filter.
__device__ __forceinline__ int wave_filter(
    int n, int r, int pw, bool use_ports, int nd, const float* alloc, const float* requested,
    const uint32_t* ports, const uint8_t* srow, const float* req, const uint32_t* pports,
    const Spread& sp, const PodSpread& ps, bool sp_hard, const Terms& tm, const PodTerms& pt)
{
    if (!srow[nd]) return 0;
    if (!node_fits(requested + (size_t)nd * r, alloc + (size_t)nd * r, req, r)) return 1;
    if (use_ports && ports_clash(ports + (size_t)nd * pw, pports, pw)) return 3;
    if (sp_hard && !spread_ok(sp, ps, n, nd)) return 7;
    if (tm.on && !interpod_ok(tm, pt, nd)) return 15;
    return 63;
}

// One member over this block's nodes, its scores against the maxima m (pass
// 1: the guess; pass 2: the merged ones): the thread's partial, and
// mrow[nd] for its nodes (and, at a feasible node, its fit and balanced
// scores in frow[nd] and brow[nd]: the mini-scan's wave-start parts).
__device__ inline Part member_pass(
    int n, int r, int pw, bool use_ports, const ClusterTeam& team,
    const float* alloc, const float* requested, const float* nonzero, const uint32_t* ports,
    const uint8_t* srow, const float* arow, const float* trow, const float* erow,
    const float* req, const float* nz, const uint32_t* pports,
    const Spread& sp, const PodSpread& ps, const Terms& tm, const PodTerms& pt,
    const Step& m, const Config& cfg, float* mrow, float* frow, float* brow)
{
    const bool sp_hard = sp.on && ps.any_hard;
    const bool sp_soft = sp.on && sp.soft_on && ps.any_soft;
    Part pa = part_zero();
    for (int nd = team.first(); nd < n; nd += team.stride()) {
        const int fl = wave_filter(n, r, pw, use_ports, nd, alloc, requested, ports, srow, req,
                                   pports, sp, ps, sp_hard, tm, pt);
        pa.st.flags |= fl;
        float total = -INFINITY;
        if (fl & 16) {
            pa.st.count += 1;
            pa.st.max_aff = fmaxf(pa.st.max_aff, arow[nd]);
            pa.st.max_taint = fmaxf(pa.st.max_taint, trow[nd]);
            if (sp_soft) {
                bool ignored;
                const float raw = spread_raw(sp, ps, n, nd, ignored);
                if (!ignored) {
                    pa.st.sp_mx = fmaxf(pa.st.sp_mx, raw);
                    pa.st.sp_mn = fminf(pa.st.sp_mn, raw);
                }
            }
            float parts[2];
            total = node_score(n, r, nd, alloc, requested, nonzero, req, nz, arow, trow, sp, ps,
                               sp_soft, erow, false, 0.0f, m, cfg, parts);
            frow[nd] = parts[0];
            brow[nd] = parts[1];
        }
        mrow[nd] = total;
        if (isnan(total)) pa.nan += 1;
        else if (total > -INFINITY) better(pa.bv, pa.bi, total, nd);
    }
    return pa;
}

__device__ __forceinline__ Part warp_reduce_part(Part pa)
{
    pa.st = warp_reduce_step(pa.st);
    warp_reduce_best(pa.bv, pa.bi);
    for (int off = 16; off > 0; off >>= 1) pa.nan += __shfl_down_sync(kFull, pa.nan, off);
    return pa;
}

// The Part held by lane 0 after a warp reduction, in every lane.
__device__ __forceinline__ Part warp_bcast_part(Part pa)
{
    pa.st.flags = __shfl_sync(kFull, pa.st.flags, 0);
    pa.st.count = __shfl_sync(kFull, pa.st.count, 0);
    pa.st.max_aff = __shfl_sync(kFull, pa.st.max_aff, 0);
    pa.st.max_taint = __shfl_sync(kFull, pa.st.max_taint, 0);
    pa.st.sp_mx = __shfl_sync(kFull, pa.st.sp_mx, 0);
    pa.st.sp_mn = __shfl_sync(kFull, pa.st.sp_mn, 0);
    pa.bv = __shfl_sync(kFull, pa.bv, 0);
    pa.bi = __shfl_sync(kFull, pa.bi, 0);
    pa.nan = __shfl_sync(kFull, pa.nan, 0);
    return pa;
}

// Merge the evaluated members' partials across the cluster (s_order: the
// live slots in order, n_live of them; a slot whose s_rep is its own was
// evaluated, its warps' partials in wparts[j][warp]): for member j, one
// warp merges the block's warps and lane b stores the block's partial into
// slot [xq][j][rank] of block b; one cluster barrier; one warp merges the G
// slots into s_part[j].  Slot parity xq alternates between calls.  (A Part
// is 9 words, so lanes reading consecutive Parts hit distinct banks.)
__device__ inline void part_exchange(const ClusterTeam& team, int k_dim, int n_live,
                                     const int* s_order, const int* s_rep, const Part* wparts,
                                     Part* pslots, int xq, Part* s_part)
{
    const int g = (int)team.size_;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    __syncthreads();
    for (int k = warp; k < n_live; k += warps) {
        const int j = s_order[k];
        if (s_rep[j] != j) continue;
        Part acc = lane < warps ? wparts[j * warps + lane] : part_zero();
        acc = warp_bcast_part(warp_reduce_part(acc));
        if (lane < g) {
            *cg::this_cluster().map_shared_rank(&pslots[(xq * k_dim + j) * g + (int)team.rank_],
                                                lane) = acc;
        }
    }
    team.sync();
    for (int k = warp; k < n_live; k += warps) {
        const int j = s_order[k];
        if (s_rep[j] != j) continue;
        Part acc = lane < g ? pslots[(xq * k_dim + j) * g + lane] : part_zero();
        acc = warp_reduce_part(acc);
        if (lane == 0) s_part[j] = acc;
    }
    __syncthreads();
}

// One compare-exchange step of a warp's bitonic network over (v, i) in
// ranks_above order: lanes lane and lane ^ j exchange, and the lower lane
// keeps the higher-ranked entry when `desc`.
__device__ __forceinline__ void cmpx(float& v, int& i, int lane, int j, bool desc)
{
    const float ov = __shfl_xor_sync(kFull, v, j);
    const int oi = __shfl_xor_sync(kFull, i, j);
    const bool lower = (lane & j) == 0;
    const bool take = lower == desc ? ranks_above(ov, oi, v, i) : ranks_above(v, i, ov, oi);
    if (take) {
        v = ov;
        i = oi;
    }
}

// Sort the warp's 32 entries, lane t taking rank t.
__device__ __forceinline__ void warp_sort(float& v, int& i, int lane)
{
    for (int k = 2; k <= 32; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) cmpx(v, i, lane, j, (lane & k) == 0);
    }
}

// The top 32 of two sorted lists (lv, li) and (cv, ci), sorted into (lv, li):
// against the reversed second list the higher of each pair forms a bitonic
// sequence holding the top 32, and a bitonic merge sorts it.
__device__ __forceinline__ void warp_merge(float& lv, int& li, float cv, int ci, int lane)
{
    const float rv = __shfl_sync(kFull, cv, 31 - lane);
    const int ri = __shfl_sync(kFull, ci, 31 - lane);
    if (ranks_above(rv, ri, lv, li)) {
        lv = rv;
        li = ri;
    }
    for (int j = 16; j > 0; j >>= 1) cmpx(lv, li, lane, j, true);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1) wavefront_kernel(
    int n, int r, int p, int c_dim, int pw, int k_dim, int w_rows, int kk, int use_ports,
    int n_groups,
    const int32_t* __restrict__ members,    // [W, K] waves, -1 pad
    const float* __restrict__ alloc, float* requested, float* nonzero, uint32_t* ports,
    const uint8_t* __restrict__ sfeas, const float* __restrict__ aff,
    const float* __restrict__ taint, const int32_t* __restrict__ class_id,
    const uint8_t* __restrict__ pod_valid, const int32_t* __restrict__ group_id,
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const uint32_t* __restrict__ pod_ports,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    Spread sp,                              // counts: the carry, in place
    Terms tm,                               // bits: the carry, in place
    const float* __restrict__ extra,        // [C, N] or null
    float* masked,                          // [3, K, N]: the members' wave-start rows, and
                                            // their fit and balanced scores
    int32_t* assignment, float* scores, int32_t* feas_counts, int32_t* reasons,
    int32_t* counters,                      // [2]: wave_count, wave_fallbacks
    int32_t* incomplete)                    // [max(G, 1)] zeroed scratch
{
    __shared__ Config cfg;
    __shared__ Scratch sc;
    __shared__ Slots slots;
    __shared__ PodSpread ps;                // the coupled path's and nothing else's
    __shared__ PodTerms pt;
    __shared__ uint32_t s_gany[kMaxTW];     // this block's copy of the term word carry
    __shared__ int s_vat[kThreads];
    __shared__ int s_mem[kMaxK], s_cls[kMaxK], s_len[kMaxK], s_llen[kMaxK], s_miss[kMaxK];
    __shared__ int s_order[kMaxK];          // the live slots in order
    __shared__ int s_rep[kMaxK];            // the member whose evaluation slot j shares
    __shared__ int s_loff[kMaxK];           // a shared list's offset in a block's lists
    __shared__ int s_pick[kMaxK];           // node member j took in this wave, -1 none
    __shared__ int s_last[kMaxK];           // the last member that took s_pick[j]
    __shared__ Step s_guess[kMaxK];         // the slot's maxima guess
    __shared__ Part s_part[kMaxK];          // the members' merged partials
    __shared__ float s_req[kMaxK][kRowStride], s_nz[kMaxK][kRowStride];
    __shared__ float s_r0[kMaxK][kRowStride], s_z0[kMaxK][kRowStride];  // wave-start rows of s_pick[j]
    __shared__ float s_rl[kMaxK][kRowStride], s_zl[kMaxK][kRowStride];  // live rows after member j
    __shared__ float s_cap[kMaxK][kRowStride];                         // allocatable of s_pick[j]
    __shared__ unsigned s_lm;               // the live slots, a bit each
    __shared__ int s_lazy, s_stop;
    extern __shared__ __align__(16) unsigned char dyn[];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warps = kThreads / 32;
    ClusterTeam team;
    team.init(&slots);
    const int g = (int)team.size_;
    const bool lead = team.rank_ == 0 && tid == 0;   // writes the per-pod outputs
    const WaveSmem lay = wave_smem(k_dim, g, warps, sp.on != 0, tm.on != 0);
    PodSpread* s_ps = (PodSpread*)(dyn + lay.ps);
    PodTerms* s_pt = (PodTerms*)(dyn + lay.pt);
    Part* wparts = (Part*)(dyn + lay.wparts);
    Part* pslots = (Part*)(dyn + lay.pslots);
    int2* mlist = (int2*)(dyn + lay.mlist);
    int2* recv = (int2*)(dyn + lay.recv);
    const int l_total = k_dim * (k_dim + 1) / 2;   // list entries from one block
    float* mfit = masked + (size_t)k_dim * n;
    float* mbal = mfit + (size_t)k_dim * n;
    int xq = 0;                                     // the partials' slot parity

    Terms tml = tm;                          // the term word carry read from shared memory
    tml.global_any = s_gany;
    if (tid == 0) load_config(cfg, iparams, fparams);
    if (tm.on) {
        for (int w = tid; w < tm.w; w += kThreads) s_gany[w] = tm.global_any[w];
    }
    if (tid < kMaxK) s_guess[tid] = step_zero();
    team.sync();   // every block runs before any block writes a slot

    // warp 0: lane j's member of the next wave, loaded a wave ahead; the
    // lead's wave counters, written once at the end
    int next_i = warp == 0 && lane < k_dim ? members[lane] : -1;
    int n_waves = 0, n_fallbacks = 0;
    for (int w = 0; w < w_rows; ++w) {
        if (warp == 0) {
            const int i = next_i;
            if (w + 1 < w_rows && lane < k_dim) next_i = members[(size_t)(w + 1) * k_dim + lane];
            const unsigned lm = __ballot_sync(kFull, i >= 0);
            if (lane < k_dim) {
                s_mem[lane] = i;
                s_pick[lane] = -1;
                s_last[lane] = lane;
                if (i >= 0) {
                    s_cls[lane] = min(max(class_id[i], 0), c_dim - 1);
                    s_order[__popc(lm & ((1u << lane) - 1u))] = lane;
                    for (int e = 0; e < r; ++e) {
                        s_req[lane][e] = pod_req[(size_t)i * r + e];
                        s_nz[lane][e] = pod_nz[(size_t)i * r + e];
                    }
                }
            }
            // the first earlier member whose evaluation is this one's (same
            // class, requests and ports; the spread and inter-pod families
            // evaluate every member): its rows, partials and list serve both
            __syncwarp();
            int same_as = lane;
            if (i >= 0 && !sp.on && !tm.on) {
                for (int jj = 0; jj < lane && same_as == lane; ++jj) {
                    if (!((lm >> jj) & 1u) || s_cls[jj] != s_cls[lane]) continue;
                    bool eq = true;
                    for (int e = 0; e < r; ++e) {
                        eq &= same_bits(s_req[jj][e], s_req[lane][e])
                            && same_bits(s_nz[jj][e], s_nz[lane][e]);
                    }
                    for (int wd = 0; use_ports && eq && wd < pw; ++wd) {
                        eq = pod_ports[(size_t)s_mem[jj] * pw + wd] == pod_ports[(size_t)i * pw + wd];
                    }
                    if (eq) same_as = jj;
                }
            }
            if (lane < k_dim) s_rep[lane] = same_as;
            if (lane == 0) {
                s_lm = lm;
                s_lazy = -1;
            }
        }
        __syncthreads();
        const unsigned lm = s_lm;
        const int live = __popc(lm);
        if (live == 0) {   // an all-padding row is skipped, not counted
            __syncthreads();
            continue;
        }
        const int last_live = 31 - __clz(lm);

        // wave_safe: no member claims a host port that a later member
        // claims, no member matches a spread row that a later member's
        // constraints read, and no member writes a term (matched, or
        // carried as anti-affinity) that a later member's terms read
        int clash = 0;
        if (live >= 2 && use_ports) {
            const int total = k_dim * k_dim * pw;
            for (int t = tid; t < total; t += kThreads) {
                const int wd = t % pw, ab = t / pw, a = ab / k_dim, b = ab % k_dim;
                const int ia = s_mem[a], ib = s_mem[b];
                if (a < b && ia >= 0 && ib >= 0
                    && (pod_ports[(size_t)ia * pw + wd] & pod_ports[(size_t)ib * pw + wd]) != 0u) {
                    clash = 1;
                }
            }
        }
        if (live >= 2 && sp.on) {
            const int total = k_dim * k_dim * sp.mc;
            for (int t = tid; t < total; t += kThreads) {
                const int jj = t % sp.mc, ab = t / sp.mc, a = ab / k_dim, b = ab % k_dim;
                const int ia = s_mem[a], ib = s_mem[b];
                if (a < b && ia >= 0 && ib >= 0) {
                    const int rw = sp.pod_idx[(size_t)ib * sp.mc + jj];
                    if (rw >= 0 && rw < sp.c_dim && sp.pod_matches[(size_t)ia * sp.c_dim + rw]) {
                        clash = 1;
                    }
                }
            }
        }
        if (live >= 2 && tm.on) {
            const int total = k_dim * k_dim * tm.cw;
            for (int t = tid; t < total; t += kThreads) {
                const int wd = t % tm.cw, ab = t / tm.cw, a = ab / k_dim, b = ab % k_dim;
                const int ia = s_mem[a], ib = s_mem[b];
                if (a < b && ia >= 0 && ib >= 0
                    && (tm.writes[(size_t)ia * tm.cw + wd] & tm.reads[(size_t)ib * tm.cw + wd]) != 0u) {
                    clash = 1;
                }
            }
        }
        const bool safe = live < 2 || !__syncthreads_or(clash);

        if (!safe) {
            // coupled wave: the scan's own step, member by member
            for (int k = 0; k < live; ++k) {
                const int j = s_order[k], i = s_mem[j];
                const int c = s_cls[j];
                if (sp.on) {
                    block_spread_pod(sp, n, i, ps, sc, team);
                    if (ps.any_hard) team.par ^= 1;
                }
                if (tm.on) block_interpod_pod(tml, i, pt);
                const Eval ev = block_eval(
                    n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
                    sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
                    s_req[j], s_nz[j], pod_ports + (size_t)i * pw, sp, ps, tml, pt,
                    extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, nullptr,
                    nullptr, nullptr, team);
                team.par ^= 1;
                if (lead) {
                    assignment[i] = ev.found ? ev.choice : -1;
                    scores[i] = ev.best;
                    feas_counts[i] = ev.all.count;
                    reasons[i] = ev.reason;
                }
                if (ev.found) {
                    const int nd = ev.choice;
                    if (team.owns(nd)) {
                        for (int t = tid; t < r; t += kThreads) {
                            const size_t o = (size_t)nd * r + t;
                            requested[o] = add(requested[o], s_req[j][t]);
                            nonzero[o] = add(nonzero[o], s_nz[j][t]);
                        }
                        if (use_ports) {
                            for (int t = tid; t < pw; t += kThreads) {
                                ports[(size_t)nd * pw + t] |= pod_ports[(size_t)i * pw + t];
                            }
                        }
                    }
                    if (sp.on) cluster_spread_update(sp, n, i, nd, team, s_vat);
                    if (tm.on) block_interpod_update(tml, n, i, nd, team);
                }
                __syncthreads();
            }
            n_waves += 1;
            n_fallbacks += live;
            continue;
        }

        // each member's spread rows (the hard rows' minima merged across
        // the cluster) and term words, against the wave-start carry
        for (int k = 0; k < live && (sp.on || tm.on); ++k) {
            const int j = s_order[k], i = s_mem[j];
            if (sp.on) {
                block_spread_pod(sp, n, i, s_ps[j], sc, team);
                if (s_ps[j].any_hard) team.par ^= 1;
            }
            if (tm.on) block_interpod_pod(tml, i, s_pt[j]);
        }

        // pass 1 (and pass 2 for a member whose guess missed): every live
        // member over this block's nodes, merged in one exchange each
        for (int pass = 0; pass < 2; ++pass) {
            for (int k = 0; k < live; ++k) {
                const int j = s_order[k], i = s_mem[j];
                if (s_rep[j] != j || (pass == 1 && !s_miss[j])) continue;
                const int c = s_cls[j];
                Part pa = member_pass(
                    n, r, pw, use_ports != 0, team, alloc, requested, nonzero, ports,
                    sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
                    extra != nullptr ? extra + (size_t)c * n : nullptr, s_req[j], s_nz[j],
                    pod_ports + (size_t)i * pw, sp, sp.on ? s_ps[j] : ps, tml,
                    tm.on ? s_pt[j] : pt, pass == 1 ? s_part[j].st : s_guess[j], cfg,
                    masked + (size_t)j * n, mfit + (size_t)j * n, mbal + (size_t)j * n);
                pa = warp_reduce_part(pa);
                if (lane == 0) wparts[j * warps + warp] = pa;
            }
            part_exchange(team, k_dim, live, s_order, s_rep, wparts, pslots, xq, s_part);
            xq ^= 1;
            if (pass == 1) break;
            // every thread reads every member's verdict (the guesses are
            // replaced at the wave's end): no barrier
            bool any_miss = false;
            for (int k = 0; k < live; ++k) {
                const int j = s_order[k];
                if (s_rep[j] != j) continue;
                const Step& all = s_part[j].st;
                const Step& gs = s_guess[j];
                const PodSpread& pj = sp.on ? s_ps[j] : ps;
                const bool soft = sp.on && sp.soft_on && pj.any_soft;
                const bool hit = same_bits(all.max_aff, gs.max_aff)
                    && same_bits(all.max_taint, gs.max_taint)
                    && (!soft || (same_bits(all.sp_mx, gs.sp_mx) && same_bits(all.sp_mn, gs.sp_mn)));
                const bool miss = !hit && (all.flags & 16) != 0;
                if (tid == 0) s_miss[j] = miss;
                any_miss |= miss;
            }
            if (!any_miss) break;
            __syncthreads();
        }

        // the top lists: member j needs min(rank + 1, kk - nan_j) entries of
        // its evaluation's row; members that share an evaluation share its
        // list, as long as the last of them needs (its rank is the
        // highest), and a block's lists lie one after another (s_loff)
        int long_list = 0;
        if (warp == 0) {
            const bool on = lane < k_dim && ((lm >> lane) & 1u);
            const int rj = on ? s_rep[lane] : -1;
            int len = 0;
            if (on) {
                len = max(min(__popc(lm & ((1u << lane) - 1u)) + 1,
                              kk - min(kk, s_part[rj].nan)), 0);
            }
            const unsigned group = __match_any_sync(kFull, rj);
            const int glen = __shfl_sync(kFull, len, 31 - __clz(group));
            const int llen = on && rj == lane ? glen : 0;
            int incl = llen;   // inclusive prefix of the lists' lengths
            for (int off = 1; off < 32; off <<= 1) {
                const int v = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += v;
            }
            if (lane < k_dim) {
                s_len[lane] = len;
                s_llen[lane] = llen;
                s_loff[lane] = incl - llen;
            }
            if (llen == 1) mlist[lane * 32] = entry(s_part[lane].bv, s_part[lane].bi);
            long_list = __any_sync(kFull, llen >= 2);
        }
        // (s_len and the one-entry lists are warp 0's: a wave of one needs
        // no block barrier before the mini-scan)
        if (live < 2) {
            __syncwarp();
        } else if (__syncthreads_or(long_list)) {
            for (int j = warp; j < k_dim; j += warps) {
                const int m = s_llen[j];
                if (m < 2) continue;
                const float* mrow = masked + (size_t)j * n;
                float lv = -INFINITY;
                int li = kEmpty;
                for (int q0 = (int)team.rank_; q0 * 32 < n; q0 += kChunks * g) {
                    float v[kChunks];   // kChunks of the block's chunks, loaded together
                    #pragma unroll
                    for (int u = 0; u < kChunks; ++u) {
                        const int nd = (q0 + u * g) * 32 + lane;
                        v[u] = nd < n ? mrow[nd] : -INFINITY;
                    }
                    #pragma unroll
                    for (int u = 0; u < kChunks; ++u) {
                        const int nd = (q0 + u * g) * 32 + lane;
                        const float tv = __shfl_sync(kFull, lv, m - 1);
                        const int ti = __shfl_sync(kFull, li, m - 1);
                        const bool in = !isnan(v[u]) && v[u] > -INFINITY
                            && ranks_above(v[u], nd, tv, ti);
                        if (!__any_sync(kFull, in)) continue;
                        float cv = in ? v[u] : -INFINITY;
                        int ci = in ? nd : kEmpty;
                        warp_sort(cv, ci, lane);
                        warp_merge(lv, li, cv, ci, lane);
                    }
                }
                if (lane < m) {
                    const int at = (int)team.rank_ * l_total + s_loff[j] + lane;
                    for (int b = 0; b < g; ++b) {
                        *cg::this_cluster().map_shared_rank(&recv[at], b) = entry(lv, li);
                    }
                }
            }
            team.sync();
            for (int j = warp; j < k_dim; j += warps) {
                const int m = s_llen[j];
                if (m < 2) continue;
                const int at = s_loff[j] + lane;
                float lv = -INFINITY;
                int li = kEmpty;
                for (int b = 0; b < g; ++b) {
                    float cv = -INFINITY;
                    int ci = kEmpty;
                    if (lane < m) {
                        const int2 e = recv[b * l_total + at];
                        cv = __int_as_float(e.x);
                        ci = e.y;
                    }
                    if (b == 0) {
                        lv = cv;
                        li = ci;
                    } else {
                        warp_merge(lv, li, cv, ci, lane);
                    }
                }
                if (lane < m) mlist[j * 32 + lane] = entry(lv, li);
            }
            __syncthreads();
        }

        // commit member j's pick nd to the replicated live rows (warp 0;
        // lane jj holds pick jj in `mine`): its wave-start rows (requested,
        // nonzero, allocatable) from an earlier pick of nd, else (p_rq, p_nz,
        // p_cap) — lane e's element of a first pick's rows, read from device
        // memory, where no block has written them yet — deferred for the
        // wave's last member; its live rows the node's last live rows plus
        // its requests.  Returns the first earlier lane that picked nd, -1
        // for none.
        auto commit = [&](int j, int nd, int& mine, float p_rq, float p_nz, float p_cap) {
            const unsigned same = __ballot_sync(kFull, lane < j && mine == nd);
            const int first = same ? __ffs(same) - 1 : -1;
            const int last = same ? 31 - __clz(same) : -1;
            const bool lazy = !same && j == last_live;
            if (lane < r && !lazy) {
                const float r0 = same ? s_r0[first][lane] : p_rq;
                const float z0 = same ? s_z0[first][lane] : p_nz;
                s_r0[j][lane] = r0;
                s_z0[j][lane] = z0;
                s_cap[j][lane] = same ? s_cap[first][lane] : p_cap;
                s_rl[j][lane] = add(same ? s_rl[last][lane] : r0, s_req[j][lane]);
                s_zl[j][lane] = add(same ? s_zl[last][lane] : z0, s_nz[j][lane]);
            }
            if ((same >> lane) & 1u) s_last[lane] = j;
            if (lane == j) mine = nd;
            if (lane == 0) {
                s_pick[j] = nd;
                if (lazy) s_lazy = j;
            }
            __syncwarp();
            return first;
        };

        // the O(K) mini-scan, one warp, in every block; a fit flip stops it
        // and the cluster re-evaluates the member.  Each member's wave-start
        // scores and static bits at the earlier picks are fetched while the
        // member before it is decided (at its best unpicked entry too, the
        // likeliest new pick)
        int j0 = 0;
        while (true) {
            if (warp == 0) {
                int stop = k_dim;
                int mine = lane < j0 ? s_pick[lane] : -1;   // pick `lane`, -1 none yet
                float nb = -INFINITY;    // the member's wave-start score at `mine`,
                float nf = 0.0f, nl = 0.0f;   // its fit and balanced scores there,
                bool nsf = false;        // and its static bit
                bool ahead = false;      // these fetched a member ahead
                for (unsigned todo = j0 < 32 ? lm & ~((1u << j0) - 1u) : 0u; todo; todo &= todo - 1u) {
                    const int j = __ffs(todo) - 1;
                    const int i = s_mem[j], c = s_cls[j], rj = s_rep[j];
                    const bool held = lane < j && mine >= 0;
                    float base = nb, fit0 = nf, bal0 = nl;
                    bool sf = nsf;
                    if (!ahead && held) {
                        const size_t o = (size_t)rj * n + mine;
                        base = masked[o];
                        fit0 = mfit[o];
                        bal0 = mbal[o];
                        sf = sfeas[(size_t)c * n + mine] != 0;
                    }
                    // the best unpicked entry of the member's list (a prefix
                    // of its evaluation's), and its rows fetched now, ahead
                    // of a first pick's commit
                    const int m = s_len[j];
                    int2 e = make_int2(__float_as_int(-INFINITY), kEmpty);
                    if (lane < m) e = mlist[rj * 32 + lane];
                    bool ok = __int_as_float(e.x) > -INFINITY;
                    #pragma unroll
                    for (int jj = 0; jj < 32; ++jj) ok &= __shfl_sync(kFull, mine, jj) != e.y;
                    const unsigned hits = __ballot_sync(kFull, ok);
                    const int src = hits ? __ffs(hits) - 1 : 0;
                    const float bu_v = hits ? __int_as_float(__shfl_sync(kFull, e.x, src))
                                            : -INFINITY;
                    const int bu_i = hits ? __shfl_sync(kFull, e.y, src) : n;
                    float p_rq = 0.0f, p_nz = 0.0f, p_cap = 0.0f;
                    if (hits && lane < r && j != last_live) {
                        const size_t o = (size_t)bu_i * r + lane;
                        p_rq = requested[o];
                        p_nz = nonzero[o];
                        p_cap = alloc[o];
                    }
                    // the next member's fetches
                    const unsigned rest = todo & (todo - 1u);
                    const int jn = rest ? __ffs(rest) - 1 : -1;
                    float spec_b = -INFINITY, spec_f = 0.0f, spec_l = 0.0f;
                    bool spec_sf = false;
                    if (jn >= 0) {
                        const size_t on = (size_t)s_rep[jn] * n, oc = (size_t)s_cls[jn] * n;
                        if (held) {
                            nb = masked[on + mine];
                            nf = mfit[on + mine];
                            nl = mbal[on + mine];
                            nsf = sfeas[oc + mine] != 0;
                        }
                        if (lane == j && hits) {
                            spec_b = masked[on + bu_i];
                            spec_f = mfit[on + bu_i];
                            spec_l = mbal[on + bu_i];
                            spec_sf = sfeas[oc + bu_i] != 0;
                        }
                    }
                    // does the member's fit flip at a node picked earlier?
                    // else the scores differ from the wave start's only at
                    // picked nodes, and only in the allocation parts:
                    // correct those in closed form
                    bool flip = false;
                    float cand = -INFINITY;
                    if (held) {
                        const int lst = s_last[lane];
                        const float* cap = s_cap[lane];
                        const bool f0 = node_fits(s_r0[lane], cap, s_req[j], r);
                        const bool fc = node_fits(s_rl[lst], cap, s_req[j], r);
                        flip = sf && f0 != fc;
                        if (base > -INFINITY) {
                            const float fitc = fit_score(cap, s_zl[lst], s_nz[j], cfg);
                            const float balc = balanced_score(cap, s_rl[lst], s_req[j], cfg);
                            const float d = add(mul(cfg.fit_weight, sub(fitc, fit0)),
                                                mul(cfg.bal_weight, sub(balc, bal0)));
                            cand = add(base, d);
                        }
                    }
                    if (__any_sync(kFull, flip)) {
                        stop = j;
                        break;
                    }
                    // jnp.max over the union: a NaN candidate makes it NaN,
                    // and the member is then not found, as in the reference
                    float best = cand;
                    for (int off = 16; off > 0; off >>= 1) {
                        best = nan_max(best, __shfl_xor_sync(kFull, best, off));
                    }
                    best = nan_max(best, bu_v);
                    const Step& all = s_part[rj].st;
                    const bool found = (all.flags & 16) != 0 && best > -INFINITY;
                    // first-max-index over the candidate union == over the
                    // corrected [N] vector
                    int choice = cand >= best && cand > -INFINITY ? mine : n;
                    for (int off = 16; off > 0; off >>= 1) {
                        choice = min(choice, __shfl_xor_sync(kFull, choice, off));
                    }
                    if (bu_v >= best && bu_v > -INFINITY) choice = min(choice, bu_i);
                    choice = min(max(choice, 0), n - 1);
                    if (lead) {
                        assignment[i] = found ? choice : -1;
                        scores[i] = found ? best : -INFINITY;
                        feas_counts[i] = all.count;
                        reasons[i] = !(all.flags & 1) ? kReasonStatic
                            : !(all.flags & 2) ? kReasonResources
                            : !(all.flags & 4) ? kReasonPorts
                            : !(all.flags & 8) ? kReasonSpread
                            : !(all.flags & 16) ? kReasonInterpod : kReasonNone;
                    }
                    if (found) {
                        // the new pick's fetches for the next member: the
                        // speculative ones, or an earlier pick's of the node
                        const int first = commit(j, choice, mine, p_rq, p_nz, p_cap);
                        const int from = first < 0 ? 0 : first;
                        const float fb = __shfl_sync(kFull, nb, from);
                        const float ff = __shfl_sync(kFull, nf, from);
                        const float fl = __shfl_sync(kFull, nl, from);
                        const bool fsf = __shfl_sync(kFull, nsf, from);
                        if (lane == j) {
                            nb = first < 0 ? spec_b : fb;
                            nf = first < 0 ? spec_f : ff;
                            nl = first < 0 ? spec_l : fl;
                            nsf = first < 0 ? spec_sf : fsf;
                        }
                    }
                    ahead = jn >= 0;
                }
                if (lane == 0) s_stop = stop;
            }
            __syncthreads();
            const int jf = s_stop;
            if (jf >= k_dim) break;
            // a fit flip at member jf: once every block has reached it (no
            // block still reads a wave-start row from device memory), the
            // owners write the live rows picked so far, and the cluster
            // re-evaluates the member against the live carry (the port
            // table, the spread counts and the term bits are still the
            // wave start's, which a safe wave's members never touch)
            team.sync();
            for (int t = tid; t < jf * r; t += kThreads) {
                const int jj = t / r, e = t % r;
                const int nd = s_pick[jj];
                if (nd >= 0 && s_last[jj] == jj && team.owns(nd)) {
                    requested[(size_t)nd * r + e] = s_rl[jj][e];
                    nonzero[(size_t)nd * r + e] = s_zl[jj][e];
                }
            }
            __syncthreads();
            const int i = s_mem[jf], c = s_cls[jf];
            const Eval ev = block_eval(
                n, r, pw, use_ports != 0, alloc, requested, nonzero, ports,
                sfeas + (size_t)c * n, aff + (size_t)c * n, taint + (size_t)c * n,
                s_req[jf], s_nz[jf], pod_ports + (size_t)i * pw, sp, sp.on ? s_ps[jf] : ps, tml,
                tm.on ? s_pt[jf] : pt, extra != nullptr ? extra + (size_t)c * n : nullptr, cfg,
                sc, nullptr, nullptr, nullptr, team);
            team.par ^= 1;
            if (lead) {
                assignment[i] = ev.found ? ev.choice : -1;
                scores[i] = ev.best;
                feas_counts[i] = ev.all.count;
                reasons[i] = ev.reason;
            }
            n_fallbacks += 1;
            if (warp == 0 && ev.found) {
                int mine = lane < jf ? s_pick[lane] : -1;
                const size_t o = (size_t)ev.choice * r + min(lane, r - 1);
                commit(jf, ev.choice, mine, requested[o], nonzero[o], alloc[o]);
            }
            __syncthreads();
            j0 = jf + 1;
        }

        // every block is past the mini-scan before a carry row is written
        if (live >= 2) team.sync();
        // each picked node's live row, once, by its owner; the deferred
        // port, spread and term commits at each block's own nodes, in
        // member order (no member of a safe wave read these)
        for (int t = tid; t < k_dim * r; t += kThreads) {
            const int jj = t / r, e = t % r;
            const int nd = s_pick[jj];
            if (nd < 0 || s_last[jj] != jj || !team.owns(nd)) continue;
            const size_t o = (size_t)nd * r + e;
            if (jj == s_lazy) {
                requested[o] = add(requested[o], s_req[jj][e]);
                nonzero[o] = add(nonzero[o], s_nz[jj][e]);
            } else {
                requested[o] = s_rl[jj][e];
                nonzero[o] = s_zl[jj][e];
            }
        }
        if (use_ports) {
            for (int t = tid; t < k_dim * pw; t += kThreads) {
                const int j = t / pw, wd = t % pw;
                const int nd = s_pick[j];
                if (s_mem[j] >= 0 && nd >= 0 && team.owns(nd)) {
                    atomicOr(&ports[(size_t)nd * pw + wd], pod_ports[(size_t)s_mem[j] * pw + wd]);
                }
            }
        }
        for (int k = 0; k < live && (sp.on || tm.on); ++k) {
            const int j = s_order[k];
            if (s_pick[j] < 0) continue;
            if (sp.on) cluster_spread_update(sp, n, s_mem[j], s_pick[j], team, s_vat);
            if (tm.on) block_interpod_update(tml, n, s_mem[j], s_pick[j], team);
        }
        if (tid < k_dim && ((lm >> tid) & 1u)) s_guess[tid] = s_part[s_rep[tid]].st;
        n_waves += 1;
        __syncthreads();
    }
    if (lead) {
        counters[0] += n_waves;
        counters[1] += n_fallbacks;
    }

    if (tm.on && team.rank_ == 0) {
        for (int w = tid; w < tm.w; w += kThreads) tm.global_any[w] = s_gany[w];
    }
    // every block's outputs and carry rows visible to the whole cluster
    team.sync();
    // gang all-or-nothing: release every placement of an incomplete group
    if (n_groups > 0) {
        block_gang_release(n, p, r, n_groups, pod_valid, group_id, pod_req, pod_nz,
                           requested, nonzero, assignment, scores, reasons, incomplete, team);
    }
}

}  // namespace

extern "C" int wavefront_max_k() { return kMaxK; }

// The dynamic shared memory (bytes) of a launch at N nodes and waves of
// k_dim, with the spread and inter-pod families on or off.
extern "C" int wavefront_smem_bytes(int n, int k_dim, int sp_on, int tm_on)
{
    const Shape shape = launch_shape(n);
    return wave_smem(k_dim, shape.blocks, shape.threads / 32, sp_on != 0, tm_on != 0).total;
}

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
    if (p == 0 || n == 0 || w_rows == 0) return 0;
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, sp_counts);
    const Terms tm = make_terms(tm_on, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v, tm_mi_slot,
                                tm_anti_slot, tm_aff_bits, tm_anti_bits, tm_self_match,
                                tm_present, tm_blocked, tm_global_any, tm_cw, tm_writes,
                                tm_reads);
    const int kk = min(k_dim + 1, n);
    const Shape shape = launch_shape(n);
    const int smem = wave_smem(k_dim, shape.blocks, shape.threads / 32, sp_on != 0,
                               tm_on != 0).total;
    auto* kernel = shape.threads == kSmallThreads ? &wavefront_kernel<kSmallThreads>
                                                  : &wavefront_kernel<kClusterThreads>;
    return (int)launch_cluster(
        kernel, shape, smem, (cudaStream_t)stream,
        n, r, p, c_dim, pw, k_dim, w_rows, kk, use_ports, n_groups,
        (const int32_t*)members, (const float*)alloc, (float*)requested, (float*)nonzero,
        (uint32_t*)ports, (const uint8_t*)sfeas, (const float*)aff, (const float*)taint,
        (const int32_t*)class_id, (const uint8_t*)pod_valid, (const int32_t*)group_id,
        (const float*)pod_req, (const float*)pod_nz, (const uint32_t*)pod_ports,
        (const int32_t*)iparams, (const float*)fparams, sp, tm, (const float*)extra,
        (float*)masked, (int32_t*)assignment, (float*)scores, (int32_t*)feas_counts,
        (int32_t*)reasons, (int32_t*)counters, (int32_t*)incomplete);
}

extern "C" const char* wavefront_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
