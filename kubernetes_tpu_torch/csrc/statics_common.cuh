// Shared per-(class, node) bodies of the placement-independent tables.
//
// match_terms.cu, class_statics.cu and partials_eval.cu evaluate the same
// per-node functions: a selector row's term match (filters.py:88), the
// static Filter slice with the bound-port test (filters.py:166 + the port
// check of assign.py:316) and the two raw scores (scores.py:163, :173).
// Cold statics (match_terms, then class_statics over the batch's masks)
// and warm statics (partials_eval over a resident slot's stored spec) call
// these functions, so the two cannot drift.
#pragma once

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
// TaintToleration over NoSchedule and NoExecute) and the bound-port test,
// given the NodeAffinity outcome `sel_ok`.
__device__ inline bool static_feasible(const Nodes& nd, const Spec& sp, int node, bool sel_ok)
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
    const uint32_t* np = nd.ports + (size_t)node * nd.pw;
    const uint32_t* pp = sp.ports + (size_t)sp.row * nd.pw;
    for (int w = 0; w < nd.pw; ++w) {
        if (np[w] & pp[w]) ok = false;
    }
    return ok;
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

}  // namespace statics
