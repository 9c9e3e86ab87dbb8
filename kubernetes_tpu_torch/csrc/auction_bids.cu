// Kernel `auction_bids`: one bidding round of the auction solve.
//
// Replaces: kubernetes_tpu/ops/auction.py:355-478 `bids` inside
// `auction_assign` (auction.py:140) — per spec class the resource fit and
// the fit / balanced score rows (`per_spec`), per constraint class the
// spread filter row (`spf_k`, topology.py:121) and the inter-pod filter row
// (`ipf_k`, interpod.py:156; auction.py:396-409), per joint class the
// combine with the affinity and taint rows, the soft spread score
// (topology.py:153) and the joint class's hoisted extra row (`joint_extra`,
// auction.py:303-318, built once by kernel class_extras;
// auction.py:372-425), the best score, the tie set, its
// hashed (key desc, index asc) top list of cnt = min(#ties, tie_k) nodes
// (`per_class`, auction.py:403-454), then per pod the within-class
// position j among active pods in solve order and its slot, bid and value
// (auction.py:460-477).
//
// Bound on this card: the class pass reads, per class, the class's static
// row, allocatable, requested and nonzero-requested (about 60 bytes a node)
// and does ~60 flops a feasible node; the pod pass compares each pod with
// the pods before it in solve order (P^2/2 integer tests).  At the shapes of
// the main path both are microseconds of the card's rates; this first
// design pays one SM per class for the [N] passes.
//
// Design: two launches per round, enqueued with the round's accept with no
// host sync; both return at once when the device's continue flag
// (state[1], written by the previous round's auction_accept) is down.
//   class_pass  one 1,024-thread block per joint class (grid-strided): the
//               scan's block-wide evaluation (solve_common.cuh `block_eval`,
//               with the spread rows and term words of the class's
//               constraint-class representative against the round's counts
//               and bits, and the class's extra row) writes the
//               class's masked score row and its best; a pass
//               over the ties counts them and histograms the top 12 bits of
//               their 30-bit keys (4,096 buckets in shared memory); a
//               descending exclusive scan of the histogram gives each
//               bucket's first rank; ties in the buckets that reach rank
//               cnt are listed per bucket, and each is placed by its rank
//               within its bucket under (key desc, index asc) — the order of
//               lax.top_k over the keys, with no sort.  The keys are a
//               Weyl-sequence hash of the node index, so buckets stay small.
//               A NaN score (a corrupt input) wins block_eval's pick, so
//               the class's best is NaN, as jnp.max's is: no node equals
//               it, and the class bids nowhere, as in the reference.
//   pod_pass    one thread per solve position, 256 a block: j counts the
//               active pods of the same class earlier in solve order (a
//               tiled pass over the positions before it), then slot = j mod
//               max(cnt, 1), bid and value.
// The hash is the reference's wrapping u32 arithmetic: rot = ((c * G) ^
// (rnd * R) ^ S) * M, key = ((node + 1) * G ^ rot) >> 2 (logical), with
// S = tie_seed * 2 + 1 = 1 for the tie_seed of 0 the scheduler uses.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;
constexpr int kPodThreads = 256;
constexpr int kKeyBits = 30;     // hkey >> 2
constexpr int kBucketBits = 12;
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kPerThread = kBuckets / kThreads;
static_assert(kPerThread * kThreads == kBuckets, "bucket scan layout");
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kRound = 0x85EBCA6Bu;
constexpr uint32_t kMix = 0x27D4EB2Fu;
constexpr uint32_t kSeedC = 1u;  // tie_seed 0

__device__ __forceinline__ uint32_t tie_key(uint32_t rot, int nd)
{
    return (((uint32_t)(nd + 1) * kGolden) ^ rot) >> 2;
}

__device__ __forceinline__ int bucket_of(uint32_t key)
{
    return (int)(key >> (kKeyBits - kBucketBits));
}

// (key desc, index asc): node a comes before node b in the tie list
__device__ __forceinline__ bool before(uint32_t ka, int a, uint32_t kb, int b)
{
    return ka > kb || (ka == kb && a < b);
}

__global__ void __launch_bounds__(kThreads, 1) class_pass_kernel(
    int n, int r, int c_dim, int cs_dim, int tie_k,
    const float* __restrict__ alloc, const float* __restrict__ requested,
    const float* __restrict__ nonzero,
    const uint8_t* __restrict__ sfeas_s, const float* __restrict__ aff_s,
    const float* __restrict__ taint_s,
    const int32_t* __restrict__ s_reps, const int32_t* __restrict__ jspec,
    const float* __restrict__ pod_req, const float* __restrict__ pod_nz,
    const int32_t* __restrict__ iparams, const float* __restrict__ fparams,
    const int32_t* __restrict__ state,
    int cc_dim, const int32_t* __restrict__ k_reps,  // [Cc] constraint-class reps
    const int32_t* __restrict__ jcons, Spread sp,     // [C]; counts read only
    Terms tm,                                         // bits read only
    const float* __restrict__ extra,                  // [C, N] or null
    int32_t* inv_c, int32_t* cnt_c, float* best_c,   // [C, tie_k], [C], [C]
    float* scratch_masked, int32_t* scratch_idx)     // [grid, N] each
{
    if (!state[1]) return;
    const uint32_t rnd = (uint32_t)state[0];
    __shared__ Config cfg;
    __shared__ float s_req[kMaxR], s_nz[kMaxR];
    __shared__ Scratch sc;
    __shared__ PodSpread ps;
    __shared__ PodTerms pt;
    __shared__ int s_fill[kBuckets];   // histogram, then each bucket's fill pointer
    __shared__ int s_start[kBuckets];  // first rank of each bucket
    __shared__ int s_warp_sum[kMaxWarps];
    __shared__ int s_cand;             // ties in the buckets that reach rank cnt

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) load_config(cfg, iparams, fparams);
    float* mrow = scratch_masked + (size_t)blockIdx.x * n;
    int32_t* slots = scratch_idx + (size_t)blockIdx.x * n;

    for (int c = blockIdx.x; c < c_dim; c += gridDim.x) {
        const int s = min(max(jspec[c], 0), cs_dim - 1);
        const int rep = s_reps[s];
        for (int t = tid; t < r; t += kThreads) {
            s_req[t] = pod_req[(size_t)rep * r + t];
            s_nz[t] = pod_nz[(size_t)rep * r + t];
        }
        for (int b = tid; b < kBuckets; b += kThreads) s_fill[b] = 0;
        __syncthreads();
        // the constraint class's representative carries the joint class's
        // spread rows, terms and match flags (the encoder's constraint
        // signature)
        const int k_rep = k_reps[min(max(jcons[c], 0), cc_dim - 1)];
        if (sp.on) block_spread_pod(sp, n, k_rep, ps, sc);
        if (tm.on) block_interpod_pod(tm, k_rep, pt);

        const Eval ev = block_eval(
            n, r, 0, false, alloc, requested, nonzero, nullptr,
            sfeas_s + (size_t)s * n, aff_s + (size_t)s * n, taint_s + (size_t)s * n,
            s_req, s_nz, nullptr, sp, ps, tm, pt,
            extra != nullptr ? extra + (size_t)c * n : nullptr, cfg, sc, mrow);
        const float best = ev.best;
        const uint32_t rot = (((uint32_t)c * kGolden) ^ (rnd * kRound) ^ kSeedC) * kMix;

        // the tie set (feasible nodes at the best score), counted and
        // histogrammed by the top bits of their keys
        Step st = step_zero();
        if (ev.found) {
            for (int nd = tid; nd < n; nd += kThreads) {
                if (mrow[nd] == best) {
                    st.count += 1;
                    atomicAdd(&s_fill[bucket_of(tie_key(rot, nd))], 1);
                }
            }
        }
        const int ties = block_reduce_step(st, sc).count;
        const int cnt = min(ties, tie_k);

        if (cnt > 0) {
            // exclusive scan of the histogram in descending bucket order;
            // thread t holds descending ranks [kPerThread t, kPerThread (t+1))
            int local[kPerThread];
            int sum = 0;
            for (int q = 0; q < kPerThread; ++q) {
                local[q] = s_fill[kBuckets - 1 - (kPerThread * tid + q)];
                sum += local[q];
            }
            int incl = sum;
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += y;
            }
            if (lane == 31) s_warp_sum[warp] = incl;
            __syncthreads();
            if (warp == 0) {
                int v = s_warp_sum[lane];
                for (int off = 1; off < 32; off <<= 1) {
                    const int y = __shfl_up_sync(0xffffffffu, v, off);
                    if (lane >= off) v += y;
                }
                s_warp_sum[lane] = v;
            }
            __syncthreads();
            int base = (warp > 0 ? s_warp_sum[warp - 1] : 0) + incl - sum;
            for (int q = 0; q < kPerThread; ++q) {
                const int b = kBuckets - 1 - (kPerThread * tid + q);
                s_start[b] = base;
                if (base < cnt && base + local[q] >= cnt) s_cand = base + local[q];
                base += local[q];
            }
            __syncthreads();
            for (int b = tid; b < kBuckets; b += kThreads) s_fill[b] = s_start[b];
            __syncthreads();
            // list the ties of the buckets that reach rank cnt, unordered
            // within a bucket
            for (int nd = tid; nd < n; nd += kThreads) {
                if (mrow[nd] == best) {
                    const int b = bucket_of(tie_key(rot, nd));
                    if (s_start[b] < cnt) slots[atomicAdd(&s_fill[b], 1)] = nd;
                }
            }
            __syncthreads();
            // each listed tie's rank within its bucket gives its position
            for (int q = tid; q < s_cand; q += kThreads) {
                const int nd = slots[q];
                const uint32_t key = tie_key(rot, nd);
                const int b = bucket_of(key);
                int rank = 0;
                for (int m = s_start[b]; m < s_fill[b]; ++m) {
                    const int o = slots[m];
                    if (o != nd && before(tie_key(rot, o), o, key, nd)) ++rank;
                }
                const int pos = s_start[b] + rank;
                if (pos < cnt) inv_c[(size_t)c * tie_k + pos] = nd;
            }
        }
        if (tid == 0) {
            cnt_c[c] = cnt;
            best_c[c] = best;
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kPodThreads) pod_pass_kernel(
    int n, int p, int c_dim, int tie_k,
    const int32_t* __restrict__ order, const int32_t* __restrict__ class_id,
    const uint8_t* __restrict__ pod_valid, const int32_t* __restrict__ assigned,
    const int32_t* __restrict__ inv_c, const int32_t* __restrict__ cnt_c,
    const float* __restrict__ best_c, const int32_t* __restrict__ state,
    int32_t* bid, float* val)
{
    if (!state[1]) return;
    __shared__ int s_key[kPodThreads];
    const int q = (int)(blockIdx.x * kPodThreads + threadIdx.x);
    int i = -1, cls = 0;
    bool act = false;
    if (q < p) {
        i = order[q];
        cls = min(max(class_id[i], 0), c_dim - 1);
        act = assigned[i] < 0 && pod_valid[i];
    }
    // j: active pods of the same class earlier in solve order
    int j = 0;
    const int q_end = min(p, (int)(blockIdx.x + 1) * kPodThreads);
    for (int base = 0; base < q_end; base += kPodThreads) {
        const int k = base + threadIdx.x;
        int key = -1;
        if (k < p) {
            const int o = order[k];
            if (assigned[o] < 0 && pod_valid[o]) key = min(max(class_id[o], 0), c_dim - 1);
        }
        s_key[threadIdx.x] = key;
        __syncthreads();
        const int lim = min(kPodThreads, q - base);
        for (int t = 0; t < lim; ++t) j += s_key[t] == cls ? 1 : 0;
        __syncthreads();
    }
    if (q >= p) return;
    const int cnt = cnt_c[cls];
    const float best = best_c[cls];
    const bool has = act && best > -INFINITY && cnt > 0;
    const int slot = j % max(cnt, 1);
    bid[i] = has ? inv_c[(size_t)cls * tie_k + slot] : n;
    val[i] = has ? best : -INFINITY;
}

}  // namespace

extern "C" int auction_bids_launch(
    int n, int r, int p, int c_dim, int cs_dim, int tie_k, int grid,
    const void* alloc, const void* requested, const void* nonzero,
    const void* sfeas_s, const void* aff_s, const void* taint_s,
    const void* s_reps, const void* jspec, const void* pod_req, const void* pod_nz,
    const void* order, const void* class_id, const void* pod_valid,
    const void* assigned, const void* iparams, const void* fparams,
    const void* state, int cc_dim, const void* k_reps, const void* jcons,
    int sp_on, int sp_soft, int sp_c, int sp_mc, const void* sp_pod_idx,
    const void* sp_pod_matches, const void* sp_max_skew, const void* sp_min_domains,
    const void* sp_hard, const void* sp_eligible, const void* sp_v, const void* sp_sizes,
    const void* sp_counts,
    int tm_on, int tm_w, int tm_u, int tm_p, int tm_cw, const void* tm_key_bits,
    const void* tm_slot_v, const void* tm_mi_slot, const void* tm_anti_slot,
    const void* tm_aff_bits, const void* tm_anti_bits, const void* tm_self_match,
    const void* tm_present, const void* tm_blocked, const void* tm_global_any,
    const void* tm_writes, const void* tm_reads, const void* extra,
    void* inv_c, void* cnt_c, void* best_c,
    void* scratch_masked, void* scratch_idx, void* bid, void* val, void* stream)
{
    if (r > kMaxR || tie_k < 1 || grid < 1 || cc_dim < 1) return (int)cudaErrorInvalidValue;
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1)) return (int)cudaErrorInvalidValue;
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || tm_p != p)) {
        return (int)cudaErrorInvalidValue;
    }
    if (p == 0 || n == 0 || c_dim == 0) return 0;
    const Spread sp = make_spread(sp_on, sp_soft, sp_c, sp_mc, sp_pod_idx, sp_pod_matches,
                                  sp_max_skew, sp_min_domains, sp_hard, sp_eligible, sp_v,
                                  sp_sizes, (void*)sp_counts);
    const Terms tm = make_terms(tm_on, tm_w, tm_u, tm_p, tm_key_bits, tm_slot_v, tm_mi_slot,
                                tm_anti_slot, tm_aff_bits, tm_anti_bits, tm_self_match,
                                (void*)tm_present, (void*)tm_blocked, (void*)tm_global_any,
                                tm_cw, tm_writes, tm_reads);
    cudaStream_t s = (cudaStream_t)stream;
    class_pass_kernel<<<grid, kThreads, 0, s>>>(
        n, r, c_dim, cs_dim, tie_k, (const float*)alloc,
        (const float*)requested, (const float*)nonzero, (const uint8_t*)sfeas_s,
        (const float*)aff_s, (const float*)taint_s, (const int32_t*)s_reps,
        (const int32_t*)jspec, (const float*)pod_req, (const float*)pod_nz,
        (const int32_t*)iparams, (const float*)fparams, (const int32_t*)state,
        cc_dim, (const int32_t*)k_reps, (const int32_t*)jcons, sp, tm, (const float*)extra,
        (int32_t*)inv_c, (int32_t*)cnt_c, (float*)best_c, (float*)scratch_masked,
        (int32_t*)scratch_idx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pod_pass_kernel<<<(p + kPodThreads - 1) / kPodThreads, kPodThreads, 0, s>>>(
        n, p, c_dim, tie_k, (const int32_t*)order, (const int32_t*)class_id,
        (const uint8_t*)pod_valid, (const int32_t*)assigned, (const int32_t*)inv_c,
        (const int32_t*)cnt_c, (const float*)best_c, (const int32_t*)state,
        (int32_t*)bid, (float*)val);
    return (int)cudaGetLastError();
}

extern "C" const char* auction_bids_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
