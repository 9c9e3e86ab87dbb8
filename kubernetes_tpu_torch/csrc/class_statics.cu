// Kernel `class_statics`: the cold statics prep in one launch — the
// selector and preferred rows the batch's classes name, then the
// placement-independent per-class tables, and the selector mask when the
// caller asks for it.
//
// Replaces: kubernetes_tpu/ops/assign.py:316 `class_statics` — the vmap over
// class representatives of `static_feasible_for_pod` (filters.py:166), the
// bound-port test, `node_affinity_raw` (scores.py:163) and
// `taint_toleration_raw` (scores.py:173) — together with the two
// `match_terms` (filters.py:88) calls that make its masks, `selector_match`
// (filters.py:134) and `preferred_match` (filters.py:144).  Per (class c,
// node n), with rep the class's representative pod:
//
//   sfeas[c, n] = node_valid & pod.valid & name_ok & taints_ok
//                 & sel_row(sel_idx[rep], n) & ~bound_port_conflict
//   aff[c, n]   = sum_j weight_j * pref_row(pref_idx[rep, j], n)
//   taint[c, n] = popcount(PreferNoSchedule taints & ~tolerations), 0 under
//                 tol_all
//   sel_mask[s, n] = sel_row(s, n) for every selector row (when asked for)
//
// Bound on this card: bytes.  Per node: the label words and topology ids
// that the named rows' valid expressions test, the taint words of each
// effect some class does not tolerate wholesale, the port words some class
// claims, the valid byte and the name id; per (c, n) 9 bytes written (and
// S bytes a node for the mask).  The arithmetic is a few dozen integer
// operations a word; the floor is the node rows moved once.
//
// Design: the node tile of statics_common.cuh.  A block owns 32 nodes: it
// stages their valid bytes, name ids, taint words and topology ids in
// shared memory with coalesced loads, once; their label words the first
// time a row it evaluates reads labels; their port words the first time a
// class claims a port.  Then, per chunk of kClassChunk classes and of
// kRowChunk rows of the row axis (the S selector rows, then the F
// preferred rows): the block marks the rows its classes name (and, with
// the mask asked for, every selector row), one warp compacts them into a
// list, each warp evaluates listed rows from shared memory (statics::
// match_row, a lane a node) into one 32-bit match word a row (a ballot),
// written to the mask when asked for; every class of the chunk then reads
// its rows' words.  Padding rows no class names are never evaluated.  When
// S + F <= kRowChunk the row marks persist across class chunks, so every
// named row is evaluated once a tile; past that, once a class chunk that
// names it.  The per-(class, node) pass is one warp a class and a lane a
// node: statics::static_feasible, prefer_taints and affinity_add (weights
// summed in term order with IEEE adds: every term is an integer weight,
// so the sum is exact and equals the reference's reduction) — the bodies
// partials_eval (the warm statics) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statics_common.cuh"

namespace {

constexpr int kRowChunk = 1024;   // table rows a pass: a match word and a mark each
constexpr int kClassChunk = 64;   // classes a pass

// The launch arguments: ints[kI_*] and ptrs[kP_*] (host arrays), in this
// order (class_statics_layout gives the lengths, checked by the bindings).
enum {
    kI_N, kI_LW, kI_TK, kI_TW, kI_PW, kI_P, kI_C, kI_MT,
    kI_S, kI_ST, kI_SE, kI_SK, kI_F, kI_FE, kI_FK, kI_WANT_MASK,
    kI_COUNT
};
enum {
    kP_NODE_VALID, kP_NODE_NAME, kP_LABEL_BITS, kP_TOPO_IDS, kP_TAINT_BITS, kP_NODE_PORTS,
    kP_SEL_IDS, kP_SEL_OP, kP_SEL_SLOT, kP_SEL_TV,
    kP_PREF_IDS, kP_PREF_OP, kP_PREF_SLOT, kP_PREF_VALID,
    kP_REPS, kP_POD_VALID, kP_POD_NAME, kP_SEL_IDX, kP_TOL_BITS, kP_TOL_ALL, kP_POD_PORTS,
    kP_PREF_IDX, kP_PREF_WEIGHT,
    kP_SFEAS, kP_AFF, kP_TAINT, kP_SEL_MASK,
    kP_COUNT
};

struct Args {
    int n, lw, tk, tw, pw, p, c, mt, want_mask;
    const uint8_t* node_valid;   // [N]
    const int32_t* node_name;    // [N]
    const uint32_t* label;       // [N, LW]
    const int32_t* topo;         // [N, TK]
    const uint32_t* taint;       // [3, N, TW]
    const uint32_t* ports;       // [N, PW]
    statics::Table sel;          // [S, T, E, K]
    statics::Table pref;         // [F, 1, E, K]
    const int32_t* reps;         // [C], clipped to [0, P) here
    const uint8_t* pod_valid;    // [P]
    const int32_t* pod_name;     // [P]
    const int32_t* sel_idx;      // [P]
    const uint32_t* tol;         // [3, P, TW]
    const uint8_t* tol_all;      // [3, P]
    const uint32_t* pod_ports;   // [P, PW]
    const int32_t* pref_idx;     // [P, MT]
    const float* pref_weight;    // [P, MT]
    uint8_t* sfeas;              // [C, N]
    float* aff;                  // [C, N]
    float* taint_out;            // [C, N]
    uint8_t* sel_mask;           // [S, N], null unless asked for
};

// Dynamic shared memory, in this order: label words [kTile, LW], taint
// words [3, kTile, TW], port words [kTile, PW], topology ids [kTile, TK],
// name ids [kTile], match words [kRowChunk], the class chunk's selector
// words [kClassChunk] and preferred words [kClassChunk, MT], its
// representatives [kClassChunk]; then the row list (u16) [kRowChunk],
// the row marks [kRowChunk] and the valid bytes [kTile].
int smem_bytes(int lw, int tk, int tw, int pw, int mt)
{
    const int words = statics::kTile * (lw + 3 * tw + pw + tk + 1) + kRowChunk
                      + kClassChunk * (mt + 2);
    return words * 4 + kRowChunk * 2 + kRowChunk + statics::kTile;
}

// The row (on the row axis: selector rows, then preferred rows at S) that
// slot j of class representative `rep` names: j = 0 its selector, j > 0
// its preferred term j - 1; -1 for none.
__device__ inline int named_row(const Args& a, int rep, int j)
{
    if (j == 0) {
        const int si = a.sel_idx[rep];
        return si < 0 ? -1 : min(si, a.sel.rows - 1);
    }
    const int pi = a.pref_idx[rep * a.mt + j - 1];
    return pi < 0 ? -1 : a.sel.rows + min(pi, a.pref.rows - 1);
}

__global__ void __launch_bounds__(statics::kTileThreads) class_statics_kernel(Args a)
{
    using statics::kTile;
    extern __shared__ uint32_t smem[];
    __shared__ int label_staged, ports_staged, flag, count;
    uint32_t* s_label = smem;
    uint32_t* s_taint = s_label + kTile * a.lw;
    uint32_t* s_ports = s_taint + 3 * kTile * a.tw;
    int32_t* s_topo = (int32_t*)(s_ports + kTile * a.pw);
    int32_t* s_name = s_topo + kTile * a.tk;
    uint32_t* s_word = (uint32_t*)(s_name + kTile);
    uint32_t* s_csel = s_word + kRowChunk;
    uint32_t* s_chit = s_csel + kClassChunk;
    int32_t* s_rep = (int32_t*)(s_chit + kClassChunk * a.mt);
    uint16_t* s_list = (uint16_t*)(s_rep + kClassChunk);
    uint8_t* s_mark = (uint8_t*)(s_list + kRowChunk);   // 0 none, 1 to evaluate, 2 done
    uint8_t* s_valid = s_mark + kRowChunk;

    statics::Tile tl;
    tl.node0 = blockIdx.x * kTile;
    tl.nt = min(kTile, a.n - tl.node0);
    tl.lw = a.lw;
    tl.tk = a.tk;
    tl.label = s_label;
    tl.topo = s_topo;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int u = a.sel.rows + a.pref.rows;
    const bool one_row_chunk = u <= kRowChunk;

    // the tile's node rows every class reads
    if (threadIdx.x == 0) {
        label_staged = 0;
        ports_staged = 0;
    }
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = i < tl.nt;
        s_valid[i] = in ? a.node_valid[tl.node0 + i] : 0;
        s_name[i] = in ? a.node_name[tl.node0 + i] : -1;
    }
    for (int eff = 0; eff < 3; ++eff) {
        statics::stage_rows(s_taint + eff * kTile * a.tw, a.taint + (size_t)eff * a.n * a.tw,
                            tl.node0, tl.nt, a.tw);
    }
    statics::stage_rows(s_topo, a.topo, tl.node0, tl.nt, a.tk);
    if (one_row_chunk) {
        for (int i = threadIdx.x; i < u; i += blockDim.x) s_mark[i] = 0;
    }
    __syncthreads();

    const int slots = 1 + a.mt;
    const int class_chunks = max(1, (a.c + kClassChunk - 1) / kClassChunk);
    for (int chunk = 0; chunk < class_chunks; ++chunk) {
        const int c0 = chunk * kClassChunk;
        const int cc = max(0, min(kClassChunk, a.c - c0));
        const bool mask_now = a.want_mask && chunk == 0;
        if (threadIdx.x == 0) flag = 0;
        for (int i = threadIdx.x; i < cc; i += blockDim.x) {
            const int rep = min(max(a.reps[c0 + i], 0), a.p - 1);
            s_rep[i] = rep;
            s_csel[i] = a.sel_idx[rep] < 0 ? ~0u : 0u;
            for (int j = 0; j < a.mt; ++j) s_chit[i * a.mt + j] = 0u;
        }
        __syncthreads();
        // a port claimed by a class of the chunk: stage the port words once
        for (int i = threadIdx.x; i < cc * a.pw; i += blockDim.x) {
            if (a.pod_ports[(size_t)s_rep[i / a.pw] * a.pw + i % a.pw]) flag = 1;
        }
        __syncthreads();
        if (flag && !ports_staged) {
            statics::stage_rows(s_ports, a.ports, tl.node0, tl.nt, a.pw);
            __syncthreads();
            if (threadIdx.x == 0) ports_staged = 1;
        }
        __syncthreads();

        for (int r0 = 0; r0 < u; r0 += kRowChunk) {
            const int rc = min(kRowChunk, u - r0);
            if (!one_row_chunk) {
                for (int i = threadIdx.x; i < rc; i += blockDim.x) s_mark[i] = 0;
                __syncthreads();
            }
            // mark the rows the chunk's classes name, and the selector rows
            // of the mask
            for (int i = threadIdx.x; i < cc * slots; i += blockDim.x) {
                const int row = named_row(a, s_rep[i / slots], i % slots) - r0;
                if (row >= 0 && row < rc && s_mark[row] == 0) s_mark[row] = 1;
            }
            if (mask_now) {
                for (int row = threadIdx.x; row < min(rc, a.sel.rows - r0); row += blockDim.x) {
                    if (s_mark[row] == 0) s_mark[row] = 1;
                }
            }
            __syncthreads();
            // one warp lists them in row order
            if (warp == 0) {
                int base = 0;
                for (int i = 0; i < rc; i += 32) {
                    const int row = i + lane;
                    const bool on = row < rc && s_mark[row] == 1;
                    const unsigned bal = __ballot_sync(0xffffffffu, on);
                    if (on) {
                        s_list[base + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)row;
                        s_mark[row] = 2;
                    }
                    base += __popc(bal);
                }
                if (lane == 0) {
                    count = base;
                    flag = 0;
                }
            }
            __syncthreads();
            if (!label_staged) {
                const int sel_items = a.sel.t * a.sel.e;
                const int items = max(sel_items, a.pref.e);
                for (int i = threadIdx.x; i < count * items; i += blockDim.x) {
                    const int row = r0 + s_list[i / items], it = i % items;
                    const bool reads = row < a.sel.rows
                        ? it < sel_items && statics::row_reads_labels(a.sel, row, a.tk, it)
                        : it < a.pref.e
                            && statics::row_reads_labels(a.pref, row - a.sel.rows, a.tk, it);
                    if (reads) flag = 1;
                }
                __syncthreads();
            }
            statics::stage_labels_if(tl, a.label, flag != 0, &label_staged);
            // each warp evaluates listed rows: a match word a row
            for (int i = warp; i < count; i += statics::kTileWarps) {
                const int local = s_list[i], row = r0 + local;
                const bool is_sel = row < a.sel.rows;
                const bool ok = lane < tl.nt && (is_sel
                    ? statics::tile_match(tl, a.sel, row, lane)
                    : statics::tile_match(tl, a.pref, row - a.sel.rows, lane));
                const unsigned word = __ballot_sync(0xffffffffu, ok);
                if (lane == 0) s_word[local] = word;
                if (mask_now && is_sel && lane < tl.nt) {
                    a.sel_mask[(size_t)row * a.n + tl.node0 + lane] = ok ? 1 : 0;
                }
            }
            __syncthreads();
            // every class of the chunk takes its rows' words
            for (int i = threadIdx.x; i < cc * slots; i += blockDim.x) {
                const int ci = i / slots, j = i % slots;
                const int row = named_row(a, s_rep[ci], j) - r0;
                if (row < 0 || row >= rc) continue;
                if (j == 0) s_csel[ci] = s_word[row];
                else s_chit[ci * a.mt + j - 1] = s_word[row];
            }
            __syncthreads();
        }

        // the class tables: a warp a class, a lane a node
        const statics::Nodes nd{kTile, a.tw, ports_staged ? a.pw : 0, s_valid, s_name,
                                s_taint, s_ports};
        for (int i = warp; i < cc; i += statics::kTileWarps) {
            if (lane >= tl.nt) continue;
            const int rep = s_rep[i];
            const statics::Spec sp{a.p, rep, a.pod_valid, a.pod_name, a.tol, a.tol_all,
                                   a.pod_ports};
            const bool sel_ok = (s_csel[i] >> lane) & 1u;
            float acc = 0.0f;
            for (int j = 0; j < a.mt; ++j) {
                const int pi = a.pref_idx[rep * a.mt + j];
                const float w = pi >= 0 ? a.pref_weight[rep * a.mt + j] : 0.0f;
                const bool hit = pi >= 0 && ((s_chit[i * a.mt + j] >> lane) & 1u);
                acc = statics::affinity_add(acc, w, hit);
            }
            const size_t o = (size_t)(c0 + i) * a.n + tl.node0 + lane;
            a.sfeas[o] = statics::static_feasible(nd, sp, lane, sel_ok) ? 1 : 0;
            a.aff[o] = acc;
            a.taint_out[o] = statics::prefer_taints(nd, sp, lane);
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int class_statics_launch(const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    a.n = ints[kI_N];
    a.lw = ints[kI_LW];
    a.tk = ints[kI_TK];
    a.tw = ints[kI_TW];
    a.pw = ints[kI_PW];
    a.p = ints[kI_P];
    a.c = ints[kI_C];
    a.mt = ints[kI_MT];
    a.want_mask = ints[kI_WANT_MASK];
    a.sel = statics::Table{ints[kI_S], ints[kI_ST], ints[kI_SE], ints[kI_SK],
                           (const int32_t*)ptrs[kP_SEL_IDS], (const int32_t*)ptrs[kP_SEL_OP],
                           (const int32_t*)ptrs[kP_SEL_SLOT], (const uint8_t*)ptrs[kP_SEL_TV]};
    a.pref = statics::Table{ints[kI_F], 1, ints[kI_FE], ints[kI_FK],
                            (const int32_t*)ptrs[kP_PREF_IDS], (const int32_t*)ptrs[kP_PREF_OP],
                            (const int32_t*)ptrs[kP_PREF_SLOT],
                            (const uint8_t*)ptrs[kP_PREF_VALID]};
    if (a.n == 0 || (a.c == 0 && !a.want_mask)) return 0;
    if (a.p < 1 || a.sel.rows < 1 || a.pref.rows < 1)
        return (int)cudaErrorInvalidValue;
    a.node_valid = (const uint8_t*)ptrs[kP_NODE_VALID];
    a.node_name = (const int32_t*)ptrs[kP_NODE_NAME];
    a.label = (const uint32_t*)ptrs[kP_LABEL_BITS];
    a.topo = (const int32_t*)ptrs[kP_TOPO_IDS];
    a.taint = (const uint32_t*)ptrs[kP_TAINT_BITS];
    a.ports = (const uint32_t*)ptrs[kP_NODE_PORTS];
    a.reps = (const int32_t*)ptrs[kP_REPS];
    a.pod_valid = (const uint8_t*)ptrs[kP_POD_VALID];
    a.pod_name = (const int32_t*)ptrs[kP_POD_NAME];
    a.sel_idx = (const int32_t*)ptrs[kP_SEL_IDX];
    a.tol = (const uint32_t*)ptrs[kP_TOL_BITS];
    a.tol_all = (const uint8_t*)ptrs[kP_TOL_ALL];
    a.pod_ports = (const uint32_t*)ptrs[kP_POD_PORTS];
    a.pref_idx = (const int32_t*)ptrs[kP_PREF_IDX];
    a.pref_weight = (const float*)ptrs[kP_PREF_WEIGHT];
    a.sfeas = (uint8_t*)ptrs[kP_SFEAS];
    a.aff = (float*)ptrs[kP_AFF];
    a.taint_out = (float*)ptrs[kP_TAINT];
    a.sel_mask = (uint8_t*)ptrs[kP_SEL_MASK];
    const int smem = smem_bytes(a.lw, a.tk, a.tw, a.pw, a.mt);
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            class_statics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const int grid = (a.n + statics::kTile - 1) / statics::kTile;
    class_statics_kernel<<<grid, statics::kTileThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The launch layout the bindings check on load: 0 the ints, 1 the
// pointers, 2 the tile's nodes, 3 the row chunk, 4 the class chunk.
extern "C" int class_statics_layout(int which)
{
    switch (which) {
        case 0: return kI_COUNT;
        case 1: return kP_COUNT;
        case 2: return statics::kTile;
        case 3: return kRowChunk;
        case 4: return kClassChunk;
        default: return -1;
    }
}

extern "C" const char* class_statics_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
