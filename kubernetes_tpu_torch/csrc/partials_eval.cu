// Kernel `partials_eval`: the resident Filter/Score partials of the warm
// statics, evaluated from each slot's stored spec.
//
// Replaces: kubernetes_tpu/ops/partials.py:203 `eval_store`, :213
// `refresh_rows` and :232 `insert_slots` — each the vmap of `_eval_slot`
// (:97) over slots, on all columns, on the dirty columns (`take_rows`,
// :136) or for the missed slots (`take_specs`, :158), then a scatter into
// the store.  Per (slot g in slot_idx, column n in col_idx):
//
//   sel     = OR over g's valid selector terms of the AND of expressions
//             (match_terms over the slot's own rows), true without a
//             selector
//   sfeas   = node_valid & valid & name_ok & taints_ok & sel & ~port_clash
//   aff     = sum_j pref_weight[j] * (pref_valid[j] & match(pref row j))
//   taint   = untolerated PreferNoSchedule taints (0 under tol_all)
//
// written to store.sfeas / aff / taint [g, n].  The three reference
// functions differ only in the index lists: all slots x all columns, all
// slots x the dirty columns, the missed slots x all columns.
//
// Bound on this card: bytes.  Each column's node row (label words, topology
// ids, taint, port words) is read once for all slots; each (slot, column)
// writes 9 bytes; the specs are a few KB a slot and stay in L1/L2.  The
// selector and preferred tests are a few hundred integer tests a pair,
// under the card's integer rate at these sizes.
//
// Design: one thread per (slot, column) on a 2-D grid (x = column, y =
// slot), so neighbouring threads read neighbouring nodes' rows and share
// the slot's spec through L1.  The per-(slot, node) body is
// statics_common.cuh's, shared with match_terms and class_statics, so warm
// and cold statics cannot drift; the affinity sum is in term order with
// __fadd_rn / __fmul_rn (--fmad=false).  The store is written in place:
// the caller hands in fresh store tensors (a new allocation, or a copy of
// the resident one), never a buffer a solve or a bookmark may still read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statics_common.cuh"

namespace {

constexpr int kBlock = 256;

struct Store {
    int n;                          // columns of the store (= cluster rows)
    uint8_t* sfeas;                 // [G, N]
    float* aff;                     // [G, N]
    float* taint;                   // [G, N]
};

struct Specs {
    int g, t, e, k, mt;
    const uint8_t* valid;           // [G]
    const int32_t* name;            // [G]
    const uint8_t* has_sel;         // [G]
    const int32_t* sel_ids;         // [G, T, E, K]
    const int32_t* sel_op;          // [G, T, E]
    const int32_t* sel_slot;        // [G, T, E]
    const uint8_t* sel_tv;          // [G, T]
    const uint32_t* tol;            // [3, G, TW]
    const uint8_t* tol_all;         // [3, G]
    const uint32_t* ports;          // [G, PW]
    const int32_t* pref_ids;        // [G, MT, E, K]
    const int32_t* pref_op;         // [G, MT, E]
    const int32_t* pref_slot;       // [G, MT, E]
    const uint8_t* pref_valid;      // [G, MT]
    const float* pref_weight;       // [G, MT]
};

__global__ void partials_eval_kernel(
    statics::Nodes nd, const uint32_t* __restrict__ label_bits, int lw,
    const int32_t* __restrict__ topo_ids, int tk, Specs s,
    const int32_t* __restrict__ slot_idx, const int32_t* __restrict__ col_idx,
    int n_cols, Store out)
{
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= n_cols) return;
    const int node = col_idx ? col_idx[x] : x;
    const int g = slot_idx[blockIdx.y];
    const uint32_t* bits = label_bits + (size_t)node * lw;
    const int32_t* topo = topo_ids + (size_t)node * tk;
    const int tek = s.t * s.e * s.k;
    const int ek = s.e * s.k;

    bool sel_ok = true;
    if (s.has_sel[g]) {
        sel_ok = statics::match_row(
            bits, lw, topo, tk, s.sel_ids + (size_t)g * tek,
            s.sel_op + (size_t)g * s.t * s.e, s.sel_slot + (size_t)g * s.t * s.e,
            s.sel_tv + (size_t)g * s.t, s.t, s.e, s.k);
    }

    float a = 0.0f;
    for (int j = 0; j < s.mt; ++j) {
        const int row = g * s.mt + j;
        const bool live = s.pref_valid[row] != 0;
        const bool hit = live && statics::match_row(
            bits, lw, topo, tk, s.pref_ids + (size_t)row * ek,
            s.pref_op + (size_t)row * s.e, s.pref_slot + (size_t)row * s.e,
            s.pref_valid + row, 1, s.e, s.k);
        a = statics::affinity_add(a, live ? s.pref_weight[row] : 0.0f, hit);
    }

    const statics::Spec sp{s.g, g, s.valid, s.name, s.tol, s.tol_all, s.ports};
    const size_t o = (size_t)g * out.n + node;
    out.sfeas[o] = statics::static_feasible(nd, sp, node, sel_ok) ? 1 : 0;
    out.aff[o] = a;
    out.taint[o] = statics::prefer_taints(nd, sp, node);
}

}  // namespace

extern "C" int partials_eval_launch(
    int n, int lw, int tk, int tw, int pw, int g, int t, int e, int k, int mt,
    int n_slots, int n_cols,
    const void* node_valid, const void* node_name, const void* label_bits,
    const void* topo_ids, const void* taint_bits, const void* node_ports,
    const void* valid, const void* name_id, const void* has_sel,
    const void* sel_ids, const void* sel_op, const void* sel_slot,
    const void* sel_tv, const void* tol_bits, const void* tol_all,
    const void* port_bits, const void* pref_ids, const void* pref_op,
    const void* pref_slot, const void* pref_valid, const void* pref_weight,
    const void* slot_idx, const void* col_idx,
    void* sfeas, void* aff, void* taint, void* stream)
{
    if (n_slots == 0 || n_cols == 0) return 0;
    const statics::Nodes nd{n, tw, pw, (const uint8_t*)node_valid,
                            (const int32_t*)node_name,
                            (const uint32_t*)taint_bits,
                            (const uint32_t*)node_ports};
    const Specs s{g, t, e, k, mt,
                  (const uint8_t*)valid, (const int32_t*)name_id,
                  (const uint8_t*)has_sel, (const int32_t*)sel_ids,
                  (const int32_t*)sel_op, (const int32_t*)sel_slot,
                  (const uint8_t*)sel_tv, (const uint32_t*)tol_bits,
                  (const uint8_t*)tol_all, (const uint32_t*)port_bits,
                  (const int32_t*)pref_ids, (const int32_t*)pref_op,
                  (const int32_t*)pref_slot, (const uint8_t*)pref_valid,
                  (const float*)pref_weight};
    const Store out{n, (uint8_t*)sfeas, (float*)aff, (float*)taint};
    const dim3 grid((n_cols + kBlock - 1) / kBlock, n_slots);
    partials_eval_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        nd, (const uint32_t*)label_bits, lw, (const int32_t*)topo_ids, tk, s,
        (const int32_t*)slot_idx, (const int32_t*)col_idx, n_cols, out);
    return (int)cudaGetLastError();
}

extern "C" const char* partials_eval_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
