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
// rate, so what a call pays is launch latency — on the card and in the
// binding on the host.
//
// Design: one launch an entry, one thread-block cluster of up to 16 blocks
// of 1,024 threads, on torch's stream, with no memset and no second
// kernel.  Each block first lists the valid rows in shared memory, in row
// order (a warp a chunk of 32 rows, ballots, a scan of the warps' counts):
// only they scatter and gather; a row that is not valid has fixed outputs.
//   1. the scatter (spread, or terms / pref with bound pods): a thread a
//      (valid row, node) pair, grid-stride over the cluster, adds the
//      node's values at `row * z + min(v, z - 1)` of the (row, value)
//      table with global float atomics — values are clipped into [0, z)
//      and masked with v >= 0, as both packages clip (a value >= z lands
//      on bin z - 1; the reference does not drop it).  The spread entry
//      also writes `eligible` and `v` here, and counts each row's distinct
//      eligible values: a value counts the first time atomicExch on its
//      presence flag sees it.  The terms entry marks a term whose count
//      turned positive (global_any; every count is >= 0, so "some count >
//      0" equals the reference's `cm.sum(-1) > 0`).  Beside it, what reads
//      no sum: the outputs of the rows that are not valid (a thread a node
//      over those rows: spread's eligible 0, v the slot value and counts
//      0; pref's zeros), the terms entry's used-slot values (a thread a
//      node) and its pod words (a warp a 32-term word, lane t holding term
//      32w + t, `__ballot_sync` packing the word: bit t % 32 of word t /
//      32, the u32 stored as its int32 view, as _pack_bits_t lays it out —
//      the slot splits of matches_incoming and of the pods' affinity /
//      anti-affinity terms).
//   -- cluster barrier (barrier.cluster arrive.release / wait.acquire:
//      every block's scatter is seen by every block) --
//   2. the gather: spread and pref a thread a (valid row, node) pair, and
//      spread's sizes a thread a row; the terms entry a thread a node,
//      building its key, present and blocked words from the valid terms
//      of each word (OR of the terms' bits: each word written by the one
//      thread that owns its node), then global_any a warp a word by
//      `__ballot_sync`.
//   -- cluster barrier: every gather has read the table --
//   3. the clear: every bin of every valid row (the only rows the scatter
//      adds to) and every valid row's word set back to zero.
// Without bound pods the terms and pref entries read no table: one phase,
// no barrier.  A cluster of 16 SMs has an eighth of the card's threads, so
// the design keeps each thread's chain of dependent loads short: one pass
// of loads a phase at the 5000Nodes cells, where the valid rows are a few
// and a thread has about one (valid row, node) pair; the node-major
// passes read a node's topology row once for all its rows.
// The (row, value) table stays in device memory: a hostname-keyed row's z
// is the node count (65,536 at the north star's width), and R x z x 4 B
// outgrows the cluster's distributed shared memory there.
//
// The scratch (2 R z + R words: the sums, spread's presence flags in the
// second table's words, and a word a row) is the binding's, one buffer per
// device and stream, zeroed once when it is allocated (or grown), and all
// zero between launches: a launch reads it as zero and leaves it zero
// (step 3).  Launches on one stream run in stream order, so one launch's
// clear has ended before the next launch's scatter begins, whatever z and
// R the two have (the next call lays its bins out anew over zeros); a
// buffer is never shared between streams.
//
// The outputs are one allocation (the binding's): `out` is its base and
// each output sits at out_offsets' 16-byte-aligned offset, in the order of
// the entry's output list; the binding checks its own offsets against
// family_prep_offset on load.
//
// Exactness: the atomics add in no fixed order.  Every addend is an
// integer-valued float32 (pod counts; owner weights 1-100 a term, signed),
// so every partial sum is exact, and the result is the reference's in any
// order, while the sum of the addends' magnitudes in a (row, value) group
// stays below 2^24 (the bounds each cell reaches are in the wrappers'
// docstrings, ops/topology.py and ops/interpod.py).  A zero addend is
// skipped: x + 0 is x for every sum that starts at +0 and adds no -0.
// The presence tests (count > 0) and the bit packing are order-free.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 16;   // H100: the largest non-portable cluster
constexpr int kMaxUsed = 32;     // used topology slots (the terms entry's, in Args)
constexpr int kAlign = 16;       // each output's byte offset in the allocation
constexpr int kMaxRows = 16384;  // rows a launch: the valid-row list in shared memory

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
    kQ_SCRATCH, kQ_OUT,
    kQ_COUNT
};

// Each entry's outputs, in allocation order: elements and element bytes
// (bindings.py FAMILY_OUTPUTS names them in the same order).
constexpr int kMaxOutputs = 9;
enum { kOutSpread = 4, kOutTerms = 9, kOutPref = 2 };

struct Dims {
    int n, rows, p, w, u;
};

// elems[k]: the elements of output k; bytes[k]: the bytes of one.
__host__ __device__ inline int outputs_of(int entry, const Dims& d, long long* elems, int* bytes)
{
    const long long rn = (long long)d.rows * d.n, nw = (long long)d.n * d.w;
    const long long pw = (long long)d.p * d.w, un = (long long)d.u * d.n;
    if (entry == kEntrySpread) {
        // v, counts, sizes, eligible
        const long long e[] = {rn, rn, d.rows, rn};
        const int b[] = {4, 4, 4, 1};
        for (int k = 0; k < kOutSpread; ++k) elems[k] = e[k], bytes[k] = b[k];
        return kOutSpread;
    }
    if (entry == kEntryTerms) {
        // present, blocked, key_bits, global_any, slot_v, mi_slot,
        // anti_slot, aff_bits, anti_bits
        const long long e[] = {nw, nw, nw, d.w, un, d.u * pw, d.u * pw, pw, pw};
        for (int k = 0; k < kOutTerms; ++k) elems[k] = e[k], bytes[k] = 4;
        return kOutTerms;
    }
    // counts_dom, ownerw_dom
    elems[0] = elems[1] = rn;
    bytes[0] = bytes[1] = 4;
    return kOutPref;
}

// Byte offset of each output (off[k]) and the allocation's size
// (off[count]), each offset a multiple of kAlign; returns the count.
__host__ __device__ inline int out_offsets(int entry, const Dims& d, long long* off)
{
    long long elems[kMaxOutputs];
    int bytes[kMaxOutputs];
    const int count = outputs_of(entry, d, elems, bytes);
    long long at = 0;
    for (int k = 0; k < count; ++k) {
        off[k] = at;
        at += (elems[k] * bytes[k] + kAlign - 1) / kAlign * kAlign;
    }
    off[count] = at;
    return count;
}

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
    // the scratch, one buffer of at least 2 R Z + R words (kQ_SCRATCH),
    // zero on entry and on exit
    float* sum_a;                 // [R, Z] the first table's sums
    float* sum_b;                 // [R, Z] the second's (terms, pref)
    int32_t* seen;                // spread: [R, Z] presence flags (sum_b's words)
    int32_t* row_count;           // [R] spread: distinct values; terms: a count > 0
    // the outputs, views of one allocation (kQ_OUT, out_offsets)
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

// The row's (row, value) bin of a node with value v >= 0.
__device__ __forceinline__ size_t bin_of(const Args& a, int row, int v)
{
    return (size_t)row * a.z + min(v, a.z - 1);
}

__device__ __forceinline__ void add_nonzero(float* at, float x)
{
    if (x != 0.0f) atomicAdd(at, x);
}

// The launch's threads: the cluster is the grid.
struct Span {
    size_t first, stride;
};

__device__ __forceinline__ Span span()
{
    return {blockIdx.x * (size_t)blockDim.x + threadIdx.x, (size_t)gridDim.x * blockDim.x};
}

// The valid rows in row order, listed by every block (dynamic shared
// memory): row[k] and its slot (clipped into the key axis) for k < n, and
// with terms each word's first listed row (first[w], w <= W).
struct Rows {
    int n;
    int* row;
    int* slot;
    int* first;
    uint8_t* valid;    // [R] every row's flag
};

// Bytes of Rows' arrays for R rows (the launch's dynamic shared memory).
__host__ __device__ inline size_t rows_smem(int rows)
{
    const int words = (rows + 31) / 32;
    return (size_t)(2 * rows + words + 1 + 33) * sizeof(int) + rows;
}

// Block-wide; ends on a block barrier.  A warp a chunk of 32 rows, the
// block's chunks at once: each warp's count, the counts scanned in shared
// memory, then each warp lists its valid rows at its offset.
__device__ inline Rows list_rows(const Args& a, unsigned char* dyn)
{
    const int rows = a.rows, words = (rows + 31) / 32;
    Rows r;
    r.row = (int*)dyn;
    r.slot = r.row + rows;
    r.first = r.slot + rows;
    int* counts = r.first + words + 1;   // [0, 32) a warp's valid rows, [32] the total
    r.valid = (uint8_t*)(counts + 33);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    int base = 0;
    for (int c0 = 0; c0 < words; c0 += nwarps) {
        const int w = c0 + warp;
        const int row = w * 32 + lane;
        const bool ok = w < words && row < rows && a.row_valid[row];
        const int slot = ok ? min(max(a.row_slot[row], 0), a.tk - 1) : 0;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) counts[warp] = __popc(m);
        if (row < rows) r.valid[row] = ok;
        __syncthreads();
        int at = base;
        for (int k = 0; k < warp; ++k) at += counts[k];
        if (w < words && lane == 0) r.first[w] = at;
        if (ok) {
            const int pos = at + __popc(m & ((1u << lane) - 1u));
            r.row[pos] = row;
            r.slot[pos] = slot;
        }
        for (int k = 0; k < nwarps; ++k) base += counts[k];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        r.first[words] = base;
        counts[32] = base;
    }
    __syncthreads();
    r.n = counts[32];
    return r;
}

// ---- spread ----------------------------------------------------------------

__device__ inline void spread_scatter(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.n;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const int j = (int)(e / a.n), nd = (int)(e % a.n);
        const int c = r.row[j];
        const size_t k = (size_t)c * a.n + nd;
        const int32_t* topo = a.topo + (size_t)nd * a.tk;
        // the node's loads issued together: no branch between them
        const int sidx = a.owner_sel[c];
        bool ok = a.node_valid[nd];
        if (sidx >= 0) ok &= a.s > 0 && a.sel_mask[(size_t)min(sidx, a.s - 1) * a.n + nd];
        for (int t = 0; t < a.tk; ++t) ok &= !(a.owner_keys[(size_t)c * a.tk + t] & (topo[t] < 0));
        const int v = topo[r.slot[j]];
        const float add = a.has_bound ? a.vals_a[k] : 0.0f;
        a.eligible[k] = ok ? 1 : 0;
        a.v[k] = v;
        if (!ok || v < 0) continue;
        const size_t b = bin_of(a, c, v);
        add_nonzero(&a.sum_a[b], add);
        if (atomicExch(&a.seen[b], 1) == 0) atomicAdd(&a.row_count[c], 1);
    }
}

// fn(node, row) for every row of every node, node-major: a thread a node
// and every lanes-th row from its lane, lanes the cluster's threads over
// the nodes (1 when the nodes are more), so a node's topology row is read
// once a thread.
template <class Fn>
__device__ inline void node_rows(const Args& a, Span sp, Fn fn)
{
    const size_t n = (size_t)a.n;
    const size_t lanes = n > 0 && sp.stride > n ? sp.stride / n : 1;
    for (size_t q = sp.first; q < n * lanes; q += sp.stride) {
        for (int row = (int)(q / n); row < a.rows; row += (int)lanes) fn(q % n, row);
    }
}

// The rows that are not valid: eligible 0, v the node's value in the
// row's slot, counts 0.
__device__ inline void spread_rest(const Args& a, const Rows& r, Span sp)
{
    node_rows(a, sp, [&](size_t nd, int c) {
        if (r.valid[c]) return;
        const size_t k = (size_t)c * a.n + nd;
        a.eligible[k] = 0;
        a.v[k] = a.topo[nd * a.tk + min(max(a.row_slot[c], 0), a.tk - 1)];
        a.counts[k] = 0.0f;
    });
}

__device__ inline void spread_gather(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.n;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const int j = (int)(e / a.n), nd = (int)(e % a.n);
        const int c = r.row[j];
        const int v = a.topo[(size_t)nd * a.tk + r.slot[j]];
        a.counts[(size_t)c * a.n + nd] =
            a.has_bound && v >= 0 ? a.sum_a[bin_of(a, c, v)] : 0.0f;
    }
    for (size_t c = sp.first; c < (size_t)a.rows; c += sp.stride) a.sizes[c] = (float)a.row_count[c];
}

// ---- terms -----------------------------------------------------------------

__device__ inline void terms_scatter(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.n;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const int j = (int)(e / a.n), nd = (int)(e % a.n);
        const int t = r.row[j];
        const size_t k = (size_t)t * a.n + nd;
        // the node's loads issued together: no branch between them
        const bool ok = a.node_valid[nd];
        const int v = a.topo[(size_t)nd * a.tk + r.slot[j]];
        const float m = a.vals_a[k], o = a.vals_b[k];
        if (!ok || v < 0) continue;
        const size_t b = bin_of(a, t, v);
        add_nonzero(&a.sum_a[b], m);
        add_nonzero(&a.sum_b[b], o);
        if (m > 0.0f) a.row_count[t] = 1;
    }
}

// The used slots' node values (a thread a node) and the pod words: a warp
// a 32-term word, lane t holding term 32 w + t.
__device__ inline void terms_pods(const Args& a, Span sp)
{
    for (size_t nd = sp.first; nd < (size_t)a.n; nd += sp.stride) {
        for (int j = 0; j < a.u; ++j) a.slot_v[(size_t)j * a.n + nd] = a.topo[nd * a.tk + a.used[j]];
    }
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const size_t pod_words = (size_t)a.p * a.w;
    for (size_t pq = sp.first >> 5; pq < pod_words; pq += sp.stride >> 5) {
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
    }
}

// The node words, a thread a node: word w's bits from the valid terms
// listed for it (key: a value in the term's slot; present / blocked: its
// (term, value) sums positive); then global_any, a warp a word.
__device__ inline void terms_nodes(const Args& a, const Rows& r, Span sp)
{
    for (size_t nd = sp.first; nd < (size_t)a.n; nd += sp.stride) {
        const bool node_ok = a.node_valid[nd];
        const int32_t* topo = a.topo + nd * a.tk;
        for (int w = 0; w < a.w; ++w) {
            uint32_t kb = 0u, pb = 0u, bb = 0u;
            for (int j = r.first[w]; j < r.first[w + 1]; ++j) {
                const int t = r.row[j];
                const int v = topo[r.slot[j]];
                if (!node_ok || v < 0) continue;
                const uint32_t bit = 1u << (t & 31);
                kb |= bit;
                if (a.has_bound) {
                    const size_t b = bin_of(a, t, v);
                    if (a.sum_a[b] > 0.0f) pb |= bit;
                    if (a.sum_b[b] > 0.0f) bb |= bit;
                }
            }
            const size_t q = nd * a.w + w;
            a.key_bits[q] = kb;
            a.present[q] = pb;
            a.blocked[q] = bb;
        }
    }
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    for (size_t w = sp.first >> 5; w < (size_t)a.w; w += sp.stride >> 5) {
        const int t = (int)w * 32 + lane;
        const bool any = a.has_bound && t < a.rows && a.row_valid[t] && a.row_count[t] != 0;
        const uint32_t gw = __ballot_sync(full, any);
        if (lane == 0) a.global_any[w] = gw;
    }
}

// ---- pref ------------------------------------------------------------------

__device__ inline void pref_scatter(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.n;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const int j = (int)(e / a.n), nd = (int)(e % a.n);
        const int u = r.row[j];
        const size_t k = (size_t)u * a.n + nd;
        // the node's loads issued together: no branch between them
        const bool ok = a.node_valid[nd];
        const int v = a.topo[(size_t)nd * a.tk + r.slot[j]];
        const float cnt = a.vals_a[k], wgt = a.vals_b[k];
        if (!ok || v < 0) continue;
        const size_t b = bin_of(a, u, v);
        add_nonzero(&a.sum_a[b], cnt);
        add_nonzero(&a.sum_b[b], wgt);
    }
}

// Zeros for the rows that are not valid (every row without bound pods).
__device__ inline void pref_rest(const Args& a, const Rows& r, Span sp)
{
    node_rows(a, sp, [&](size_t nd, int u) {
        if (r.valid[u] && a.has_bound) return;
        a.counts_dom[(size_t)u * a.n + nd] = 0.0f;
        a.ownerw_dom[(size_t)u * a.n + nd] = 0.0f;
    });
}

__device__ inline void pref_gather(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.n;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const int j = (int)(e / a.n), nd = (int)(e % a.n);
        const int u = r.row[j];
        const size_t k = (size_t)u * a.n + nd;
        const bool ok = a.node_valid[nd];
        const int v = ok ? a.topo[(size_t)nd * a.tk + r.slot[j]] : -1;
        const size_t b = bin_of(a, u, max(v, 0));
        a.counts_dom[k] = v >= 0 ? a.sum_a[b] : 0.0f;
        a.ownerw_dom[k] = v >= 0 ? a.sum_b[b] : 0.0f;
    }
}

// ---- the clear ---------------------------------------------------------------

// Every bin of every valid row in both tables (spread's presence flags are
// the second table's words) and every valid row's word, back to zero.
__device__ inline void clear_scratch(const Args& a, const Rows& r, Span sp)
{
    const size_t total = (size_t)r.n * a.z;
    for (size_t e = sp.first; e < total; e += sp.stride) {
        const size_t b = (size_t)r.row[e / a.z] * a.z + e % a.z;
        a.sum_a[b] = 0.0f;
        a.sum_b[b] = 0.0f;
    }
    for (size_t j = sp.first; j < (size_t)r.n; j += sp.stride) a.row_count[r.row[j]] = 0;
}

// ---- the kernel ----------------------------------------------------------------

template <int kEntry>
__global__ void __launch_bounds__(kThreads, 1) family_kernel(Args a)
{
    extern __shared__ __align__(16) unsigned char dyn[];
    const Span sp = span();
    const Rows r = list_rows(a, dyn);
    // the scratch takes part where the scatter adds something: spread's
    // presence flags always, the sums only with bound pods
    const bool scatter = kEntry == kEntrySpread || a.has_bound;
    if (kEntry == kEntrySpread) {
        spread_scatter(a, r, sp);
        spread_rest(a, r, sp);
    } else if (kEntry == kEntryTerms) {
        if (scatter) terms_scatter(a, r, sp);
        terms_pods(a, sp);
    } else {
        if (scatter) pref_scatter(a, r, sp);
        pref_rest(a, r, sp);
    }
    if (scatter) cg::this_cluster().sync();
    if (kEntry == kEntrySpread) spread_gather(a, r, sp);
    else if (kEntry == kEntryTerms) terms_nodes(a, r, sp);
    else if (scatter) pref_gather(a, r, sp);
    if (scatter) {
        cg::this_cluster().sync();
        clear_scratch(a, r, sp);
    }
}

// The cluster's blocks: about one work item a thread, 1 to 16 blocks.
int blocks_for(size_t items)
{
    const size_t b = (items + kThreads - 1) / kThreads;
    return (int)(b < 1 ? 1 : (b < (size_t)kMaxBlocks ? b : (size_t)kMaxBlocks));
}

// One cluster of `blocks` blocks (the grid) with `smem` bytes of dynamic
// shared memory.  The kernel's attributes are set before its first launch
// that needs them (the non-portable cluster size above 8 blocks; dynamic
// shared memory above 48 KB, raised to the most asked for); setting them
// again is harmless.  A refused launch returns its error; nothing retries.
template <int kEntry>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream)
{
    auto* kernel = &family_kernel<kEntry>;
    static bool wide = false;
    static size_t smem_set = 48 * 1024;
    const size_t smem = rows_smem(a.rows);
    cudaError_t err = cudaSuccess;
    if (blocks > 8 && !wide) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        wide = true;
    }
    if (smem > smem_set) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        smem_set = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

Dims dims_of(const int* ints)
{
    return {ints[kF_N], ints[kF_ROWS], ints[kF_P], ints[kF_W], ints[kF_U]};
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
    if (entry < 0 || entry >= kEntryCount || a.n < 0 || a.tk < 1 || a.rows < 0
        || a.rows > kMaxRows || a.z < 1 || a.u < 0 || a.u > kMaxUsed) {
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
    const size_t bins = (size_t)a.rows * a.z;
    a.sum_a = (float*)ptrs[kQ_SCRATCH];
    a.sum_b = a.sum_a + bins;
    a.seen = (int32_t*)a.sum_b;
    a.row_count = (int32_t*)(a.sum_b + bins);
    long long off[kMaxOutputs + 1];
    out_offsets(entry, dims_of(ints), off);
    uint8_t* out = (uint8_t*)ptrs[kQ_OUT];
    if (entry == kEntrySpread) {
        a.v = (int32_t*)(out + off[0]);
        a.counts = (float*)(out + off[1]);
        a.sizes = (float*)(out + off[2]);
        a.eligible = out + off[3];
    } else if (entry == kEntryTerms) {
        a.present = (uint32_t*)(out + off[0]);
        a.blocked = (uint32_t*)(out + off[1]);
        a.key_bits = (uint32_t*)(out + off[2]);
        a.global_any = (uint32_t*)(out + off[3]);
        a.slot_v = (int32_t*)(out + off[4]);
        a.mi_slot = (uint32_t*)(out + off[5]);
        a.anti_slot = (uint32_t*)(out + off[6]);
        a.aff_bits = (uint32_t*)(out + off[7]);
        a.anti_bits = (uint32_t*)(out + off[8]);
    } else {
        a.counts_dom = (float*)(out + off[0]);
        a.ownerw_dom = (float*)(out + off[1]);
    }
    return 0;
}

}  // namespace

// One entry (kEntry*) of the family preps on `stream`: one cluster launch
// (the scatter, where it adds something; the gather; the clear).  The
// scratch must be zero and hold 2 R Z + R words where the scatter runs.
// Returns a cudaError.
extern "C" int family_prep_launch(int entry, const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    const int err = make_args(entry, ints, ptrs, a);
    if (err) return err;
    const size_t pairs = (size_t)a.rows * a.n;
    cudaStream_t st = (cudaStream_t)stream;
    if (entry == kEntrySpread) {
        // sizes has a word a row even without nodes
        const size_t items = pairs > (size_t)a.rows ? pairs : (size_t)a.rows;
        return items > 0 ? (int)launch<kEntrySpread>(a, blocks_for(items), st) : 0;
    }
    if (entry == kEntryTerms) {
        // the pack's warps a word; the scatter's pairs with bound pods
        const size_t lanes = ((size_t)a.n + a.p + 1) * a.w * 32;
        const size_t items = a.has_bound && pairs > lanes ? pairs : lanes;
        return (int)launch<kEntryTerms>(a, blocks_for(items), st);
    }
    return pairs > 0 ? (int)launch<kEntryPref>(a, blocks_for(pairs), st) : 0;
}

// What the bindings check on load: 0 the ints and 1 the pointers of a
// launch, 2 the most used slots, 3-5 the entries spread, terms and pref,
// 6 the outputs' alignment, 7-9 each entry's outputs, 10 the most rows.
extern "C" int family_prep_layout(int which)
{
    const int v[] = {kF_COUNT, kQ_COUNT, kMaxUsed, kEntrySpread, kEntryTerms, kEntryPref,
                     kAlign, kOutSpread, kOutTerms, kOutPref, kMaxRows};
    return which >= 0 && which < (int)(sizeof(v) / sizeof(v[0])) ? v[which] : -1;
}

// The byte offset of output `which` of an entry's allocation at the launch
// ints `ints` (which == the entry's output count: the allocation's size);
// -1 outside.
extern "C" long long family_prep_offset(int entry, const int* ints, int which)
{
    if (entry < 0 || entry >= kEntryCount) return -1;
    long long off[kMaxOutputs + 1];
    const int count = out_offsets(entry, dims_of(ints), off);
    return which >= 0 && which <= count ? off[which] : -1;
}

extern "C" const char* family_prep_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
