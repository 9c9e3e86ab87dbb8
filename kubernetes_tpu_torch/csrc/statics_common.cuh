// Shared per-(class, node) bodies of the placement-independent tables.
//
// match_terms.cu, class_statics.cu and partials_eval.cu evaluate the same
// per-node functions: a selector row's term match (filters.py:88), the
// static Filter slice with the bound-port test (filters.py:166 + the port
// check of assign.py:316) and the two raw scores (scores.py:163, :173).
// pod_filters.cu (the preemption and Filter-chain kernel) calls the static
// slice without the port test.
// Cold statics (class_statics: the rows its classes name, then the class
// tables, in one launch), the masks-only entry (match_terms) and warm
// statics (partials_eval over a resident slot's stored spec) call these
// functions, so they cannot drift.  class_statics and match_terms share
// the node tile below: a block stages its 32 nodes' rows in shared memory
// once and evaluates every table row it needs from there.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace statics {

constexpr int kOpPos = 1;
constexpr int kOpNeg = 2;
constexpr int kTopoAnyValue = -2;
constexpr int kPadId = -1;
constexpr int kNoSchedule = 0;
constexpr int kPreferNoSchedule = 1;
constexpr int kNoExecute = 2;

// One table row at one node: OR over the row's valid terms of the AND over
// each term's expressions (filters.py:107-131).  OP_POS holds when any
// listed id is present, OP_NEG when none is, any other op (OP_PAD) always;
// in a topology slot TOPO_ANY_VALUE means "key present" and PAD_ID never
// matches.  ids [T, E, K], ops and slots [T, E], term_valid [T], all at
// the row's base.  Terms and expressions end early on the first decided
// outcome, as the boolean algebra allows.
__device__ inline bool match_row(
    const uint32_t* bits, int lw, const int32_t* topo, int tk,
    const int32_t* ids, const int32_t* ops, const int32_t* slots,
    const uint8_t* term_valid, int t, int e, int k)
{
    for (int ti = 0; ti < t; ++ti) {
        if (!term_valid[ti]) continue;
        bool all_sat = true;
        for (int ei = 0; ei < e && all_sat; ++ei) {
            const int ex = ti * e + ei;
            const int op = ops[ex];
            if (op != kOpPos && op != kOpNeg) continue;
            const int slot = slots[ex];
            const int32_t* id = ids + (size_t)ex * k;
            bool any = false;
            if (slot >= 0 && tk > 0) {
                const int v = topo[min(slot, tk - 1)];
                for (int ki = 0; ki < k; ++ki) {
                    const int x = id[ki];
                    if (x != kPadId && (v == x || (x == kTopoAnyValue && v >= 0))) any = true;
                }
            } else {
                for (int ki = 0; ki < k; ++ki) {
                    const int x = id[ki];
                    if (x >= 0) {
                        const int w = min(x >> 5, lw - 1);
                        if ((bits[w] >> (x & 31)) & 1u) any = true;
                    }
                }
            }
            all_sat = (op == kOpPos) ? any : !any;
        }
        if (all_sat) return true;
    }
    return false;
}

// The node side of the static tables.
struct Nodes {
    int n, tw, pw;
    const uint8_t* valid;     // [N]
    const int32_t* name;      // [N]
    const uint32_t* taint;    // [3, N, TW]
    const uint32_t* ports;    // [N, PW]
};

// One class's static spec: `row` of tables with `rows` rows (the pod axis
// of a batch, or the slot axis of the partials store).
struct Spec {
    int rows, row;
    const uint8_t* valid;     // [rows]
    const int32_t* name;      // [rows]
    const uint32_t* tol;      // [3, rows, TW]
    const uint8_t* tol_all;   // [3, rows]
    const uint32_t* ports;    // [rows, PW]
};

// static_feasible_for_pod (filters.py:166: node validity, NodeName,
// TaintToleration over NoSchedule and NoExecute), given the NodeAffinity
// outcome `sel_ok`.  No port test: preemption's Filter slice
// (pod_filters.cu) calls this alone, since eviction frees ports.
__device__ inline bool static_filters(const Nodes& nd, const Spec& sp, int node, bool sel_ok)
{
    bool ok = nd.valid[node] && sp.valid[sp.row] && sel_ok;
    const int pname = sp.name[sp.row];
    ok = ok && (pname == -1 || nd.name[node] == pname);
    for (int eff = kNoSchedule; eff <= kNoExecute; eff += kNoExecute - kNoSchedule) {
        if (sp.tol_all[eff * sp.rows + sp.row]) continue;
        const uint32_t* tb = nd.taint + ((size_t)eff * nd.n + node) * nd.tw;
        const uint32_t* tl = sp.tol + ((size_t)eff * sp.rows + sp.row) * nd.tw;
        for (int w = 0; w < nd.tw; ++w) {
            if (tb[w] & ~tl[w]) ok = false;
        }
    }
    return ok;
}

// The bound-port test (ports_free over the node's bound pods' ports).
__device__ inline bool bound_ports_free(const Nodes& nd, const Spec& sp, int node)
{
    const uint32_t* np = nd.ports + (size_t)node * nd.pw;
    const uint32_t* pp = sp.ports + (size_t)sp.row * nd.pw;
    bool ok = true;
    for (int w = 0; w < nd.pw; ++w) {
        if (np[w] & pp[w]) ok = false;
    }
    return ok;
}

// The class statics' Filter slice: static_filters and the bound-port test.
__device__ inline bool static_feasible(const Nodes& nd, const Spec& sp, int node, bool sel_ok)
{
    const bool ok = static_filters(nd, sp, node, sel_ok);
    return bound_ports_free(nd, sp, node) && ok;
}

// taint_toleration_raw (scores.py:173): untolerated PreferNoSchedule taints.
__device__ inline float prefer_taints(const Nodes& nd, const Spec& sp, int node)
{
    unsigned int cnt = 0;
    if (!sp.tol_all[kPreferNoSchedule * sp.rows + sp.row]) {
        const uint32_t* tb = nd.taint + ((size_t)kPreferNoSchedule * nd.n + node) * nd.tw;
        const uint32_t* tl = sp.tol + ((size_t)kPreferNoSchedule * sp.rows + sp.row) * nd.tw;
        for (int w = 0; w < nd.tw; ++w) cnt += __popc(tb[w] & ~tl[w]);
    }
    return (float)cnt;
}

// One term of node_affinity_raw (scores.py:163), added in term order:
// w * hit with IEEE operations, w = 0 for an unused term.
__device__ __forceinline__ float affinity_add(float a, float w, bool hit)
{
    return __fadd_rn(a, __fmul_rn(w, hit ? 1.0f : 0.0f));
}

// ---- the node tile (class_statics.cu, match_terms.cu) -----------------------

// Nodes a block: one 32-bit match word a table row, one lane a node.
constexpr int kTile = 32;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// A constraint table: `rows` rows of T terms of E expressions of K ids.
// The selector table as it is; the preferred table [F, E, K] as T = 1,
// its `valid` the term-valid column.
struct Table {
    int rows, t, e, k;
    const int32_t* ids;     // [rows, T, E, K]
    const int32_t* op;      // [rows, T, E]
    const int32_t* slot;    // [rows, T, E]
    const uint8_t* tv;      // [rows, T]
};

// The tile's node rows in shared memory (zeros past the last node).
struct Tile {
    int node0, nt, lw, tk;
    uint32_t* label;        // [kTile, LW], staged on first need
    int32_t* topo;          // [kTile, TK]
};

// Copy rows [node0, node0 + nt) of a row-major [N, W] table into s[kTile, W],
// zeros past nt: consecutive threads read consecutive words.
template <typename T>
__device__ inline void stage_rows(T* s, const T* __restrict__ g, int node0, int nt, int w)
{
    const size_t base = (size_t)node0 * w;
    for (int i = threadIdx.x; i < kTile * w; i += blockDim.x) {
        s[i] = i < nt * w ? g[base + i] : T(0);
    }
}

// Whether the row's valid terms hold a live expression that tests label
// words (match_row's label path: no topology slot, or no topology keys).
__device__ inline bool row_reads_labels(const Table& tb, int row, int tk, int item)
{
    const int ti = item / tb.e;
    const size_t ex = ((size_t)row * tb.t + ti) * tb.e + item % tb.e;
    const int op = tb.op[ex];
    return tb.tv[(size_t)row * tb.t + ti] && (op == kOpPos || op == kOpNeg)
        && !(tb.slot[ex] >= 0 && tk > 0);
}

// Stage the tile's label words once, the first time a row to evaluate
// reads them (`need`, block-uniform; `staged` a shared flag, 0 at first).
// Every thread calls it.
__device__ inline void stage_labels_if(Tile& tl, const uint32_t* __restrict__ label, bool need,
                                       int* staged)
{
    if (need && !*staged) {
        stage_rows(tl.label, label, tl.node0, tl.nt, tl.lw);
        __syncthreads();
        if (threadIdx.x == 0) *staged = 1;
    }
    __syncthreads();
}

// Row `row` of `tb` at the tile's node `lane`, from shared memory.
__device__ inline bool tile_match(const Tile& tl, const Table& tb, int row, int lane)
{
    const size_t te = (size_t)row * tb.t * tb.e;
    return match_row(tl.label + lane * tl.lw, tl.lw, tl.topo + lane * tl.tk, tl.tk,
                     tb.ids + te * tb.k, tb.op + te, tb.slot + te,
                     tb.tv + (size_t)row * tb.t, tb.t, tb.e, tb.k);
}

}  // namespace statics
