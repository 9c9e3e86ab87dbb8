// Kernel `pod_filters`: the per-pod Filter chain over every node, with the
// pods' selector rows evaluated in the launch.
//
// Replaces: kubernetes_tpu/ops/preemption.py:194 `static_feasible_batch`
// (static mode; and scheduler/preemption.py:973 `_static_row_from_snap`,
// one pod, through ops/filters.py:166 `static_feasible_for_pod`) and
// ops/filters.py:200 `feasible_for_pod` / :214 `feasible_batch` (full
// mode), each with the `selector_match` (filters.py:134, through
// match_terms :88) that makes its selector mask.  Per (pod p, node n):
//
//   static[p, n] = node_valid & pod.valid & name_ok & taints_ok
//                  & sel_row(sel_idx[p], n)
//   full[p, n]   = static & fits_resources & ports_free
//
// Static mode has no port test and no resources: eviction frees both, so
// preemption's Filter slice must not see them (statics_common.cuh splits
// static_filters from the class statics' bound-port test for this); its
// resource pointers are null.  Full mode adds solve_common.cuh's node_fits
// (requested + req <= allocatable on every requested resource, the
// reference's order, one __fadd_rn) and the port test (ports_clash, a
// node's word read only where the pod claims a port).
//
// Bound on this card: bytes.  Per node: the valid byte, the name id, the
// NoSchedule and NoExecute taint words, the label words and topology ids
// the named rows' valid expressions test, and in full mode the port words
// and R requested and allocatable floats; per (p, n) one byte written.  A
// few dozen integer operations a word.
//
// Design: the node tile of statics_common.cuh, as class_statics.  A block
// owns 32 nodes and stages their valid bytes, name ids, the two taint
// effects' words and topology ids in shared memory with coalesced loads,
// once; their label words the first time a row it evaluates reads labels;
// in full mode their port words, requested and allocatable rows.  Then,
// per chunk of kPodChunk pods and of kRowChunk selector rows: the block
// marks the rows its pods name (sel_idx >= 0), one warp compacts them into
// a list in row order (__ballot_sync), each warp evaluates listed rows
// from shared memory (statics::match_row, a lane a node) into one 32-bit
// match word a row, and every pod takes its row's word.  The 32-row
// floor's padding rows, and any row no pod names, are never evaluated;
// with S <= kRowChunk the marks persist across pod chunks, so a row is
// evaluated once a tile.  Then a warp a pod and a lane a node:
// statics::static_filters (+ node_fits and ports_clash in full mode), the
// pod row's 32 bytes written coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "solve_common.cuh"
#include "statics_common.cuh"

namespace {

constexpr int kRowChunk = 1024;   // selector rows a pass: a match word and a mark each
constexpr int kPodChunk = 64;     // pods a pass

// The launch arguments: ints[kI_*] and ptrs[kP_*] (host arrays), in this
// order (pod_filters_layout gives the lengths, checked by the bindings).
enum {
    kI_N, kI_LW, kI_TK, kI_TW, kI_PW, kI_R, kI_P, kI_S, kI_ST, kI_SE, kI_SK, kI_FULL,
    kI_COUNT
};
enum {
    kP_NODE_VALID, kP_NODE_NAME, kP_LABEL_BITS, kP_TOPO_IDS, kP_TAINT_BITS, kP_NODE_PORTS,
    kP_REQUESTED, kP_ALLOCATABLE,
    kP_SEL_IDS, kP_SEL_OP, kP_SEL_SLOT, kP_SEL_TV,
    kP_POD_VALID, kP_POD_NAME, kP_SEL_IDX, kP_TOL_BITS, kP_TOL_ALL, kP_POD_PORTS, kP_POD_REQ,
    kP_OUT,
    kP_COUNT
};

struct Args {
    int n, lw, tk, tw, pw, r, p, full;
    const uint8_t* node_valid;   // [N]
    const int32_t* node_name;    // [N]
    const uint32_t* label;       // [N, LW]
    const int32_t* topo;         // [N, TK]
    const uint32_t* taint;       // [3, N, TW]
    const uint32_t* ports;       // [N, PW]
    const float* requested;      // [N, R], full mode only
    const float* allocatable;    // [N, R], full mode only
    statics::Table sel;          // [S, T, E, K]
    const uint8_t* pod_valid;    // [P]
    const int32_t* pod_name;     // [P]
    const int32_t* sel_idx;      // [P]
    const uint32_t* tol;         // [3, P, TW]
    const uint8_t* tol_all;      // [3, P]
    const uint32_t* pod_ports;   // [P, PW]
    const float* pod_req;        // [P, R], full mode only
    uint8_t* out;                // [P, N]
};

// Dynamic shared memory, in this order: label words [kTile, LW], taint
// words [3, kTile, TW] (NoSchedule and NoExecute staged), port words
// [kTile, PW], topology ids [kTile, TK], name ids [kTile], requested and
// allocatable [2, kTile, R], match words [kRowChunk], the pod chunk's
// selector words [kPodChunk]; then the row list (u16) [kRowChunk], the row
// marks [kRowChunk] and the valid bytes [kTile].
int smem_bytes(int lw, int tk, int tw, int pw, int r)
{
    const int words = statics::kTile * (lw + 3 * tw + pw + tk + 1 + 2 * r) + kRowChunk
                      + kPodChunk;
    return words * 4 + kRowChunk * 2 + kRowChunk + statics::kTile;
}

// solve::ports_clash on the tile's staged port words, reading a node's word
// only where the pod claims a port: the pod's words are the same in every
// lane, so the test of a word no pod port sets is skipped by the whole warp
// (a word of zeros clashes with nothing, so the result is the same).
__device__ inline bool claimed_ports_clash(const uint32_t* node_ports,
                                           const uint32_t* __restrict__ pod_ports, int pw)
{
    bool clash = false;
    for (int w = 0; w < pw; ++w) {
        const uint32_t pp = pod_ports[w];
        if (pp != 0u) clash |= (node_ports[w] & pp) != 0u;
    }
    return clash;
}

// The selector row pod `pod` names, -1 for none.
__device__ inline int named_row(const Args& a, int pod)
{
    const int si = a.sel_idx[pod];
    return si < 0 ? -1 : min(si, a.sel.rows - 1);
}

__global__ void __launch_bounds__(statics::kTileThreads) pod_filters_kernel(Args a)
{
    using statics::kTile;
    extern __shared__ uint32_t smem[];
    __shared__ int label_staged, flag, count;
    uint32_t* s_label = smem;
    uint32_t* s_taint = s_label + kTile * a.lw;
    uint32_t* s_ports = s_taint + 3 * kTile * a.tw;
    int32_t* s_topo = (int32_t*)(s_ports + kTile * a.pw);
    int32_t* s_name = s_topo + kTile * a.tk;
    float* s_rq = (float*)(s_name + kTile);
    float* s_cap = s_rq + kTile * a.r;
    uint32_t* s_word = (uint32_t*)(s_cap + kTile * a.r);
    uint32_t* s_psel = s_word + kRowChunk;
    uint16_t* s_list = (uint16_t*)(s_psel + kPodChunk);
    uint8_t* s_mark = (uint8_t*)(s_list + kRowChunk);    // 0 none, 1 to evaluate, 2 done
    uint8_t* s_valid = s_mark + kRowChunk;

    statics::Tile tl;
    tl.node0 = blockIdx.x * kTile;
    tl.nt = min(kTile, a.n - tl.node0);
    tl.lw = a.lw;
    tl.tk = a.tk;
    tl.label = s_label;
    tl.topo = s_topo;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int u = a.sel.rows;
    const bool one_row_chunk = u <= kRowChunk;

    // the tile's node rows every pod reads
    if (threadIdx.x == 0) label_staged = 0;
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = i < tl.nt;
        s_valid[i] = in ? a.node_valid[tl.node0 + i] : 0;
        s_name[i] = in ? a.node_name[tl.node0 + i] : -1;
    }
    for (int eff = statics::kNoSchedule; eff <= statics::kNoExecute;
         eff += statics::kNoExecute - statics::kNoSchedule) {
        statics::stage_rows(s_taint + eff * kTile * a.tw, a.taint + (size_t)eff * a.n * a.tw,
                            tl.node0, tl.nt, a.tw);
    }
    statics::stage_rows(s_topo, a.topo, tl.node0, tl.nt, a.tk);
    if (a.full) {
        statics::stage_rows(s_ports, a.ports, tl.node0, tl.nt, a.pw);
        statics::stage_rows(s_rq, a.requested, tl.node0, tl.nt, a.r);
        statics::stage_rows(s_cap, a.allocatable, tl.node0, tl.nt, a.r);
    }
    if (one_row_chunk) {
        for (int i = threadIdx.x; i < u; i += blockDim.x) s_mark[i] = 0;
    }
    __syncthreads();

    const statics::Nodes nd{kTile, a.tw, a.pw, s_valid, s_name, s_taint, s_ports};
    for (int p0 = 0; p0 < a.p; p0 += kPodChunk) {
        const int pc = min(kPodChunk, a.p - p0);
        for (int i = threadIdx.x; i < pc; i += blockDim.x) {
            s_psel[i] = a.sel_idx[p0 + i] < 0 ? ~0u : 0u;
        }
        __syncthreads();
        for (int r0 = 0; r0 < u; r0 += kRowChunk) {
            const int rc = min(kRowChunk, u - r0);
            if (!one_row_chunk) {
                for (int i = threadIdx.x; i < rc; i += blockDim.x) s_mark[i] = 0;
                __syncthreads();
            }
            // mark the rows the chunk's pods name
            for (int i = threadIdx.x; i < pc; i += blockDim.x) {
                const int row = named_row(a, p0 + i) - r0;
                if (row >= 0 && row < rc && s_mark[row] == 0) s_mark[row] = 1;
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
                const int items = a.sel.t * a.sel.e;
                for (int i = threadIdx.x; i < count * items; i += blockDim.x) {
                    if (statics::row_reads_labels(a.sel, r0 + s_list[i / items], a.tk, i % items))
                        flag = 1;
                }
                __syncthreads();
            }
            statics::stage_labels_if(tl, a.label, flag != 0, &label_staged);
            // each warp evaluates listed rows: a match word a row
            for (int i = warp; i < count; i += statics::kTileWarps) {
                const int local = s_list[i];
                const bool ok = lane < tl.nt && statics::tile_match(tl, a.sel, r0 + local, lane);
                const unsigned word = __ballot_sync(0xffffffffu, ok);
                if (lane == 0) s_word[local] = word;
            }
            __syncthreads();
            // every pod of the chunk takes its row's word
            for (int i = threadIdx.x; i < pc; i += blockDim.x) {
                const int row = named_row(a, p0 + i) - r0;
                if (row >= 0 && row < rc) s_psel[i] = s_word[row];
            }
            __syncthreads();
        }

        // a warp a pod, a lane a node
        for (int i = warp; i < pc; i += statics::kTileWarps) {
            if (lane >= tl.nt) continue;
            const int pod = p0 + i;
            const statics::Spec sp{a.p, pod, a.pod_valid, a.pod_name, a.tol, a.tol_all,
                                   a.pod_ports};
            bool ok = statics::static_filters(nd, sp, lane, (s_psel[i] >> lane) & 1u);
            if (a.full) {
                const bool fits = solve::node_fits(s_rq + lane * a.r, s_cap + lane * a.r,
                                                   a.pod_req + (size_t)pod * a.r, a.r);
                const bool clash = claimed_ports_clash(s_ports + lane * a.pw,
                                                       a.pod_ports + (size_t)pod * a.pw, a.pw);
                ok = ok && fits && !clash;
            }
            a.out[(size_t)pod * a.n + tl.node0 + lane] = ok ? 1 : 0;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int pod_filters_launch(const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    a.n = ints[kI_N];
    a.lw = ints[kI_LW];
    a.tk = ints[kI_TK];
    a.tw = ints[kI_TW];
    a.pw = ints[kI_PW];
    a.r = ints[kI_R];
    a.p = ints[kI_P];
    a.full = ints[kI_FULL];
    a.sel = statics::Table{ints[kI_S], ints[kI_ST], ints[kI_SE], ints[kI_SK],
                           (const int32_t*)ptrs[kP_SEL_IDS], (const int32_t*)ptrs[kP_SEL_OP],
                           (const int32_t*)ptrs[kP_SEL_SLOT], (const uint8_t*)ptrs[kP_SEL_TV]};
    if (a.n == 0 || a.p == 0) return 0;
    a.requested = (const float*)ptrs[kP_REQUESTED];
    a.allocatable = (const float*)ptrs[kP_ALLOCATABLE];
    a.pod_req = (const float*)ptrs[kP_POD_REQ];
    if (a.sel.rows < 1 || (a.full && (a.requested == nullptr || a.allocatable == nullptr
                                       || a.pod_req == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (!a.full) a.r = 0;
    a.node_valid = (const uint8_t*)ptrs[kP_NODE_VALID];
    a.node_name = (const int32_t*)ptrs[kP_NODE_NAME];
    a.label = (const uint32_t*)ptrs[kP_LABEL_BITS];
    a.topo = (const int32_t*)ptrs[kP_TOPO_IDS];
    a.taint = (const uint32_t*)ptrs[kP_TAINT_BITS];
    a.ports = (const uint32_t*)ptrs[kP_NODE_PORTS];
    a.pod_valid = (const uint8_t*)ptrs[kP_POD_VALID];
    a.pod_name = (const int32_t*)ptrs[kP_POD_NAME];
    a.sel_idx = (const int32_t*)ptrs[kP_SEL_IDX];
    a.tol = (const uint32_t*)ptrs[kP_TOL_BITS];
    a.tol_all = (const uint8_t*)ptrs[kP_TOL_ALL];
    a.pod_ports = (const uint32_t*)ptrs[kP_POD_PORTS];
    a.out = (uint8_t*)ptrs[kP_OUT];
    const int smem = smem_bytes(a.lw, a.tk, a.tw, a.pw, a.r);
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            pod_filters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const int grid = (a.n + statics::kTile - 1) / statics::kTile;
    pod_filters_kernel<<<grid, statics::kTileThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The launch layout the bindings check on load: 0 the ints, 1 the
// pointers, 2 the tile's nodes, 3 the row chunk, 4 the pod chunk.
extern "C" int pod_filters_layout(int which)
{
    switch (which) {
        case 0: return kI_COUNT;
        case 1: return kP_COUNT;
        case 2: return statics::kTile;
        case 3: return kRowChunk;
        case 4: return kPodChunk;
        default: return -1;
    }
}

extern "C" const char* pod_filters_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
