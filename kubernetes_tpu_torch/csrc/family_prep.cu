// Kernel `family_prep`: the constraint families' per-batch preps, three
// entries of one binding (kernels/bindings.py family_prep_*).
//
// Replaces: one JAX function an entry —
//   spread  kubernetes_tpu/ops/topology.py:50 `prep_spread` (plain
//           twin ops/topology.py prep_spread_plain): each constraint row's
//           eligible nodes (the owner's selector row, the owner's topology
//           keys, node and row validity), each node's value in the row's
//           slot, the bound pods' match counts summed per (row, value) and
//           gathered back to the nodes, and `sizes`, each row's distinct
//           eligible values.
//   terms   kubernetes_tpu/ops/interpod.py:86 `prep_terms` (+ the
//           packing of :57/71/76; plain twin ops/interpod.py
//           prep_terms_plain): the whole TermState — the present, blocked
//           and key words of every node, global_any, the used slots' node
//           values, and the pod-axis words (matches_incoming split by slot,
//           the pods' affinity and anti-affinity terms, split by slot too).
//   pref    kubernetes_tpu/ops/interpod.py:220 `prep_pref_pod`
//           (plain twin prep_pref_pod_plain): the preferred rows' bound-pod
//           counts and signed owner weights summed per (row, value) and
//           gathered back to the nodes.
//
// Each runs inside the reference's jitted device programs (_solver_prep,
// ops/assign.py:474; the auction program, ops/auction.py:285-333;
// evaluate_single, ops/assign.py:1697-1725); in the port every batch of a
// family, on every route, launches its entry once.
//
// Bound on this card: bytes.  Every entry reads its rows' per-node tables
// (R x N floats), the topology columns they name and the node validity
// once, and writes its node-space outputs once; the operations are a few
// integer compares and one float add a (row, node) pair.  At the 5000Nodes
// cells that is a few hundred kilobytes: microseconds of the card's memory
// rate, so what a design pays is launch latency and the atomics of the
// scatter.
//
// Design: two kernels a launch, as slice_stats and preempt_dry_run, on
// torch's stream, with the scratch — one buffer of 2 R z + R words: the
// (row, value) sums (spread: the sums and the presence flags) and a word a
// row — zeroed there by one cudaMemsetAsync before the first:
//   1. the scatter: a thread a (row, node) pair (grid-stride) adds the
//      node's values at `row * z + min(v, z - 1)` with global float
//      atomics — values are clipped into [0, z) and masked with v >= 0, as
//      both packages clip (a value >= z lands on bin z - 1; the reference
//      does not drop it).  The spread entry also writes `eligible` and `v`
//      here, and counts each row's distinct eligible values: a value counts
//      the first time atomicExch on its presence flag sees it.  The terms
//      entry marks a term whose count turned positive (global_any; every
//      count is >= 0, so "some count > 0" equals the reference's
//      `cm.sum(-1) > 0`).
//   2. the gather: spread and pref a thread a (row, node) pair; terms a
//      warp a 32-term word, lane t holding term 32w + t, `__ballot_sync`
//      packing the word (bit t % 32 of word t / 32, the u32 stored as its
//      int32 view, as _pack_bits_t lays it out): first the node words
//      (present, blocked, key bits; the warp of word 0 also writes the
//      node's used-slot values), then the pod words (the slot splits of
//      matches_incoming and of the pods' affinity / anti-affinity terms),
//      then global_any.
// A single cluster launch with the (row, value) table in distributed shared
// memory was the other choice: it holds R x z x 4 B only while that fits
// 16 blocks' shared memory, and a hostname-keyed row's z is the node count
// (65,536 at the north star's width); global atomics have no such limit,
// and the scratch is R x z x 4 B of device memory.
//
// Exactness: the atomics add in no fixed order.  Every addend is an
// integer-valued float32 (pod counts; owner weights 1-100 a term, signed),
// so every partial sum is exact, and the result is the reference's in any
// order, while the sum of the addends' magnitudes in a (row, value) group
// stays below 2^24 (the bounds each cell reaches are in the wrappers'
// docstrings, ops/topology.py and ops/interpod.py).  A zero addend is
// skipped: x + 0 is x for every sum that starts at +0 and adds no -0.
// The presence tests (count > 0) and the bit packing are order-free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxUsed = 32;     // used topology slots: a lane of the node warp each

enum { kEntrySpread = 0, kEntryTerms = 1, kEntryPref = 2, kEntryCount };

// The launch arguments: ints[kF_*] and ptrs[kQ_*] (host arrays), in
// kernels/bindings.py FAMILY_INTS / FAMILY_PTRS order; the terms entry's
// used slots follow the ints, ints[kF_COUNT + j] for j < ints[kF_U].
enum {
    kF_N, kF_TK, kF_ROWS, kF_Z, kF_HAS_BOUND, kF_P, kF_W, kF_MA, kF_MA_ANTI, kF_S, kF_U,
    kF_COUNT
};
enum {
    kQ_TOPO_IDS, kQ_NODE_VALID, kQ_ROW_VALID, kQ_ROW_SLOT, kQ_VALS_A, kQ_VALS_B,
    kQ_OWNER_SEL, kQ_OWNER_KEYS, kQ_SEL_MASK,
    kQ_MATCHES_INCOMING, kQ_AFF_IDX, kQ_ANTI_IDX,
    kQ_SCRATCH,
    kQ_ELIGIBLE, kQ_V, kQ_COUNTS, kQ_SIZES,
    kQ_PRESENT, kQ_BLOCKED, kQ_KEY_BITS, kQ_GLOBAL_ANY, kQ_SLOT_V, kQ_MI_SLOT,
    kQ_ANTI_SLOT, kQ_AFF_BITS, kQ_ANTI_BITS,
    kQ_COUNTS_DOM, kQ_OWNERW_DOM,
    kQ_COUNT
};

struct Args {
    int n, tk, rows, z, has_bound, p, w, ma, ma_anti, s, u;
    int used[kMaxUsed];
    const int32_t* topo;          // [N, TK]
    const uint8_t* node_valid;    // [N]
    const uint8_t* row_valid;     // [R]
    const int32_t* row_slot;      // [R]
    const float* vals_a;          // [R, N] node_matches / node_counts
    const float* vals_b;          // [R, N] node_owners / owner_weight
    const int32_t* owner_sel;     // spread: [C] the owner's selector row, -1 none
    const uint8_t* owner_keys;    // spread: [C, TK]
    const uint8_t* sel_mask;      // spread: [S, N]
    const uint32_t* mi;           // terms: [P, W] matches_incoming
    const int32_t* aff_idx;       // terms: [P, MA]
    const int32_t* anti_idx;      // terms: [P, MA_ANTI]
    // the scratch, one buffer of 2 R Z + R words (kQ_SCRATCH)
    float* sum_a;                 // [R, Z] the first table's sums
    float* sum_b;                 // [R, Z] the second's (terms, pref)
    int32_t* seen;                // spread: [R, Z] presence flags (sum_b's words)
    int32_t* row_count;           // [R] spread: distinct values; terms: a count > 0
    uint8_t* eligible;            // spread: [C, N]
    int32_t* v;                   // spread: [C, N]
    float* counts;                // spread: [C, N]
    float* sizes;                 // spread: [C]
    uint32_t* present;            // terms: [N, W]
    uint32_t* blocked;            // terms: [N, W]
    uint32_t* key_bits;           // terms: [N, W]
    uint32_t* global_any;         // terms: [W]
    int32_t* slot_v;              // terms: [U, N]
    uint32_t* mi_slot;            // terms: [U, P, W]
    uint32_t* anti_slot;          // terms: [U, P, W]
    uint32_t* aff_bits;           // terms: [P, W]
    uint32_t* anti_bits;          // terms: [P, W]
    float* counts_dom;            // pref: [U, N]
    float* ownerw_dom;            // pref: [U, N]
};

// The node's topology value in a row's slot (the slot clipped into the
// key axis, as the port clips it).
__device__ __forceinline__ int slot_value(const Args& a, int nd, int slot)
{
    return a.topo[(size_t)nd * a.tk + min(max(slot, 0), a.tk - 1)];
}

// The row's (row, value) bin of a node with value v >= 0.
__device__ __forceinline__ size_t bin_of(const Args& a, int row, int v)
{
    return (size_t)row * a.z + min(v, a.z - 1);
}

__device__ __forceinline__ void add_nonzero(float* at, float x)
{
    if (x != 0.0f) atomicAdd(at, x);
}

// ---- spread ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) spread_scatter(Args a)
{
    const size_t total = (size_t)a.rows * a.n;
    for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < total;
         k += (size_t)gridDim.x * blockDim.x) {
        const int c = (int)(k / a.n), nd = (int)(k % a.n);
        bool ok = a.row_valid[c] && a.node_valid[nd];
        const int sidx = a.owner_sel[c];
        if (ok && sidx >= 0) ok = a.s > 0 && a.sel_mask[(size_t)min(sidx, a.s - 1) * a.n + nd];
        for (int t = 0; ok && t < a.tk; ++t) {
            if (a.owner_keys[(size_t)c * a.tk + t] && a.topo[(size_t)nd * a.tk + t] < 0) ok = false;
        }
        const int v = slot_value(a, nd, a.row_slot[c]);
        a.eligible[k] = ok ? 1 : 0;
        a.v[k] = v;
        if (!ok || v < 0) continue;
        const size_t b = bin_of(a, c, v);
        if (a.has_bound) add_nonzero(&a.sum_a[b], a.vals_a[k]);
        if (atomicExch(&a.seen[b], 1) == 0) atomicAdd(&a.row_count[c], 1);
    }
}

__global__ void __launch_bounds__(kThreads) spread_gather(Args a)
{
    const size_t total = (size_t)a.rows * a.n;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    for (size_t k = first; k < total; k += stride) {
        const int c = (int)(k / a.n);
        const int v = a.v[k];
        a.counts[k] = a.has_bound && v >= 0 ? a.sum_a[bin_of(a, c, v)] : 0.0f;
    }
    for (size_t c = first; c < (size_t)a.rows; c += stride) a.sizes[c] = (float)a.row_count[c];
}

// ---- terms -----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) terms_scatter(Args a)
{
    const size_t total = (size_t)a.rows * a.n;
    for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < total;
         k += (size_t)gridDim.x * blockDim.x) {
        const int t = (int)(k / a.n), nd = (int)(k % a.n);
        if (!a.row_valid[t] || !a.node_valid[nd]) continue;
        const int v = slot_value(a, nd, a.row_slot[t]);
        if (v < 0) continue;
        const size_t b = bin_of(a, t, v);
        const float m = a.vals_a[k];
        add_nonzero(&a.sum_a[b], m);
        add_nonzero(&a.sum_b[b], a.vals_b[k]);
        if (m > 0.0f) a.row_count[t] = 1;
    }
}

// A warp a word: lane t holds term 32 w + t.  Warps [0, N W) the node
// words, [N W, N W + P W) the pod words, then the W words of global_any.
__global__ void __launch_bounds__(kThreads) terms_pack(Args a)
{
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const size_t node_words = (size_t)a.n * a.w, pod_words = (size_t)a.p * a.w;
    const size_t total = node_words + pod_words + a.w;
    const size_t stride = ((size_t)gridDim.x * blockDim.x) >> 5;
    for (size_t q = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5; q < total;
         q += stride) {
        if (q < node_words) {
            const int nd = (int)(q / a.w), w = (int)(q % a.w);
            const int t = w * 32 + lane;
            bool key = false, pres = false, blk = false;
            if (t < a.rows && a.row_valid[t] && a.node_valid[nd]) {
                const int v = slot_value(a, nd, a.row_slot[t]);
                if (v >= 0) {
                    key = true;
                    if (a.has_bound) {
                        const size_t b = bin_of(a, t, v);
                        pres = a.sum_a[b] > 0.0f;
                        blk = a.sum_b[b] > 0.0f;
                    }
                }
            }
            const uint32_t kb = __ballot_sync(full, key);
            const uint32_t pb = __ballot_sync(full, pres);
            const uint32_t bb = __ballot_sync(full, blk);
            if (lane == 0) {
                a.key_bits[q] = kb;
                a.present[q] = pb;
                a.blocked[q] = bb;
            }
            if (w == 0 && lane < a.u) {
                a.slot_v[(size_t)lane * a.n + nd] = a.topo[(size_t)nd * a.tk + a.used[lane]];
            }
        } else if (q < node_words + pod_words) {
            const size_t pq = q - node_words;
            const int p = (int)(pq / a.w), w = (int)(pq % a.w);
            const int t = w * 32 + lane;
            const bool live = t < a.rows;
            const bool valid = live && a.row_valid[t];
            bool aff = false, anti = false;
            if (valid) {
                for (int k = 0; k < a.ma; ++k) aff |= a.aff_idx[(size_t)p * a.ma + k] == t;
                for (int k = 0; k < a.ma_anti; ++k) anti |= a.anti_idx[(size_t)p * a.ma_anti + k] == t;
            }
            const int slot = live ? a.row_slot[t] : 0;
            const uint32_t vw = __ballot_sync(full, valid);
            const uint32_t aw = __ballot_sync(full, aff);
            const uint32_t nw = __ballot_sync(full, anti);
            const uint32_t mi = a.mi[pq] & vw;
            if (lane == 0) {
                a.aff_bits[pq] = aw;
                a.anti_bits[pq] = nw;
            }
            for (int j = 0; j < a.u; ++j) {
                const bool in_slot = live && slot == a.used[j];
                const uint32_t sw = __ballot_sync(full, in_slot);
                const uint32_t xw = __ballot_sync(full, anti && in_slot);
                if (lane == 0) {
                    a.mi_slot[(size_t)j * pod_words + pq] = mi & sw;
                    a.anti_slot[(size_t)j * pod_words + pq] = xw;
                }
            }
        } else {
            const int w = (int)(q - node_words - pod_words);
            const int t = w * 32 + lane;
            const bool any = a.has_bound && t < a.rows && a.row_valid[t] && a.row_count[t] != 0;
            const uint32_t gw = __ballot_sync(full, any);
            if (lane == 0) a.global_any[w] = gw;
        }
    }
}

// ---- pref ------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) pref_scatter(Args a)
{
    const size_t total = (size_t)a.rows * a.n;
    for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < total;
         k += (size_t)gridDim.x * blockDim.x) {
        const int u = (int)(k / a.n), nd = (int)(k % a.n);
        if (!a.row_valid[u] || !a.node_valid[nd]) continue;
        const int v = slot_value(a, nd, a.row_slot[u]);
        if (v < 0) continue;
        const size_t b = bin_of(a, u, v);
        add_nonzero(&a.sum_a[b], a.vals_a[k]);
        add_nonzero(&a.sum_b[b], a.vals_b[k]);
    }
}

__global__ void __launch_bounds__(kThreads) pref_gather(Args a)
{
    const size_t total = (size_t)a.rows * a.n;
    for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < total;
         k += (size_t)gridDim.x * blockDim.x) {
        const int u = (int)(k / a.n), nd = (int)(k % a.n);
        float cnt = 0.0f, wsum = 0.0f;
        if (a.has_bound && a.row_valid[u] && a.node_valid[nd]) {
            const int v = slot_value(a, nd, a.row_slot[u]);
            if (v >= 0) {
                const size_t b = bin_of(a, u, v);
                cnt = a.sum_a[b];
                wsum = a.sum_b[b];
            }
        }
        a.counts_dom[k] = cnt;
        a.ownerw_dom[k] = wsum;
    }
}

// ---- launch ----------------------------------------------------------------

int blocks_for(size_t items)
{
    const size_t b = (items + kThreads - 1) / kThreads;
    return (int)(b < (size_t)kMaxBlocks ? b : (size_t)kMaxBlocks);
}

int make_args(int entry, const int* ints, void* const* ptrs, Args& a)
{
    a = Args{};
    a.n = ints[kF_N];
    a.tk = ints[kF_TK];
    a.rows = ints[kF_ROWS];
    a.z = ints[kF_Z];
    a.has_bound = ints[kF_HAS_BOUND];
    a.p = ints[kF_P];
    a.w = ints[kF_W];
    a.ma = ints[kF_MA];
    a.ma_anti = ints[kF_MA_ANTI];
    a.s = ints[kF_S];
    a.u = ints[kF_U];
    if (entry < 0 || entry >= kEntryCount || a.n < 0 || a.tk < 1 || a.rows < 0 || a.z < 1
        || a.u < 0 || a.u > kMaxUsed) {
        return (int)cudaErrorInvalidValue;
    }
    if (entry == kEntryTerms
        && (a.rows < 1 || a.w != (a.rows + 31) / 32 || a.p < 0 || a.ma < 0 || a.ma_anti < 0)) {
        return (int)cudaErrorInvalidValue;
    }
    for (int j = 0; j < a.u; ++j) {
        a.used[j] = ints[kF_COUNT + j];
        if (a.used[j] < 0 || a.used[j] >= a.tk) return (int)cudaErrorInvalidValue;
    }
    a.topo = (const int32_t*)ptrs[kQ_TOPO_IDS];
    a.node_valid = (const uint8_t*)ptrs[kQ_NODE_VALID];
    a.row_valid = (const uint8_t*)ptrs[kQ_ROW_VALID];
    a.row_slot = (const int32_t*)ptrs[kQ_ROW_SLOT];
    a.vals_a = (const float*)ptrs[kQ_VALS_A];
    a.vals_b = (const float*)ptrs[kQ_VALS_B];
    a.owner_sel = (const int32_t*)ptrs[kQ_OWNER_SEL];
    a.owner_keys = (const uint8_t*)ptrs[kQ_OWNER_KEYS];
    a.sel_mask = (const uint8_t*)ptrs[kQ_SEL_MASK];
    a.mi = (const uint32_t*)ptrs[kQ_MATCHES_INCOMING];
    a.aff_idx = (const int32_t*)ptrs[kQ_AFF_IDX];
    a.anti_idx = (const int32_t*)ptrs[kQ_ANTI_IDX];
    // the scratch holds the sums only where the scatter runs (spread, or
    // bound pods); elsewhere it is one word and no kernel reads it
    const size_t bins = entry == kEntrySpread || a.has_bound ? (size_t)a.rows * a.z : 0;
    a.sum_a = (float*)ptrs[kQ_SCRATCH];
    a.sum_b = a.sum_a + bins;
    a.seen = (int32_t*)a.sum_b;
    a.row_count = (int32_t*)(a.sum_b + bins);
    a.eligible = (uint8_t*)ptrs[kQ_ELIGIBLE];
    a.v = (int32_t*)ptrs[kQ_V];
    a.counts = (float*)ptrs[kQ_COUNTS];
    a.sizes = (float*)ptrs[kQ_SIZES];
    a.present = (uint32_t*)ptrs[kQ_PRESENT];
    a.blocked = (uint32_t*)ptrs[kQ_BLOCKED];
    a.key_bits = (uint32_t*)ptrs[kQ_KEY_BITS];
    a.global_any = (uint32_t*)ptrs[kQ_GLOBAL_ANY];
    a.slot_v = (int32_t*)ptrs[kQ_SLOT_V];
    a.mi_slot = (uint32_t*)ptrs[kQ_MI_SLOT];
    a.anti_slot = (uint32_t*)ptrs[kQ_ANTI_SLOT];
    a.aff_bits = (uint32_t*)ptrs[kQ_AFF_BITS];
    a.anti_bits = (uint32_t*)ptrs[kQ_ANTI_BITS];
    a.counts_dom = (float*)ptrs[kQ_COUNTS_DOM];
    a.ownerw_dom = (float*)ptrs[kQ_OWNERW_DOM];
    return 0;
}

}  // namespace

// One entry (kEntry*) of the family preps on `stream`: the scratch zeroed,
// then the scatter (skipped where it adds nothing: terms and pref without
// bound pods) and the gather.  Returns a cudaError.
extern "C" int family_prep_launch(int entry, const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    int err = make_args(entry, ints, ptrs, a);
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t pairs = (size_t)a.rows * a.n;
    const size_t rows = (size_t)a.rows;
    // the scratch the entry's scatter adds into (none without bound pods
    // but for spread's presence flags), zeroed in one call
    if (entry == kEntrySpread || a.has_bound) {
        const size_t words = 2 * (size_t)a.rows * a.z + rows;
        if ((err = (int)cudaMemsetAsync(a.sum_a, 0, words * sizeof(int32_t), st))) return err;
    }
    if (entry == kEntrySpread) {
        if (pairs > 0) spread_scatter<<<blocks_for(pairs), kThreads, 0, st>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
        const size_t items = pairs > rows ? pairs : rows;
        if (items > 0) spread_gather<<<blocks_for(items), kThreads, 0, st>>>(a);
    } else if (entry == kEntryTerms) {
        if (pairs > 0 && a.has_bound) terms_scatter<<<blocks_for(pairs), kThreads, 0, st>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
        const size_t warps = ((size_t)a.n + a.p + 1) * a.w;
        terms_pack<<<blocks_for(warps * 32), kThreads, 0, st>>>(a);
    } else {
        if (pairs > 0 && a.has_bound) pref_scatter<<<blocks_for(pairs), kThreads, 0, st>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
        if (pairs > 0) pref_gather<<<blocks_for(pairs), kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

// What the bindings check on load: 0 the ints and 1 the pointers of a
// launch, 2 the most used slots, 3-5 the entries spread, terms and pref.
extern "C" int family_prep_layout(int which)
{
    const int v[] = {kF_COUNT, kQ_COUNT, kMaxUsed, kEntrySpread, kEntryTerms, kEntryPref};
    return which >= 0 && which < (int)(sizeof(v) / sizeof(v[0])) ? v[which] : -1;
}

extern "C" const char* family_prep_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
