// Kernel `pod_filters`: the per-pod Filter chain over every node.
//
// Replaces: kubernetes_tpu/ops/preemption.py:194 `static_feasible_batch`
// (static mode; and scheduler/preemption.py:973 `_static_row_from_snap`,
// one pod, through ops/filters.py:166 `static_feasible_for_pod`) and
// ops/filters.py:200 `feasible_for_pod` / :214 `feasible_batch` (full
// mode).  Per (pod p, node n), given the [S, N] selector mask that kernel
// match_terms computed:
//
//   static[p, n] = node_valid & pod.valid & name_ok & taints_ok & sel_ok
//   full[p, n]   = static & fits_resources & ports_free
//
// Static mode has no port test and no resources: eviction frees both, so
// preemption's Filter slice must not see them (statics_common.cuh splits
// static_filters from the class statics' bound-port test for this).  Full
// mode adds solve_common.cuh's node_fits (requested + req <= allocatable
// on every requested resource, the reference's order, one __fadd_rn) and
// ports_clash.
//
// Bound on this card: bytes.  Each (p, n) reads the node's taint words
// (2 x TW), one selector-mask byte and in full mode its R requested and
// allocatable floats and PW port words, and writes one byte; a few dozen
// integer operations a word.  With a pass's few preemptors the node rows
// are read about once from device memory and served from L2 after.
// Design: one thread per (pod, node) on a 2-D grid (x = node, y = pod),
// as class_statics; the pod's fields are the same across a row of
// threads and come from L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "solve_common.cuh"
#include "statics_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void pod_filters_kernel(
    int n, int p, int tw, int pw, int r, int s_rows, int full,
    const uint8_t* __restrict__ node_valid,   // [N]
    const int32_t* __restrict__ node_name,    // [N]
    const uint32_t* __restrict__ taint_bits,  // [3, N, TW]
    const uint32_t* __restrict__ node_ports,  // [N, PW]
    const float* __restrict__ requested,      // [N, R] (full mode)
    const float* __restrict__ allocatable,    // [N, R] (full mode)
    const uint8_t* __restrict__ pod_valid,    // [P]
    const int32_t* __restrict__ pod_name,     // [P]
    const int32_t* __restrict__ sel_idx,      // [P]
    const uint32_t* __restrict__ tol_bits,    // [3, P, TW]
    const uint8_t* __restrict__ tol_all,      // [3, P]
    const uint32_t* __restrict__ pod_ports,   // [P, PW]
    const float* __restrict__ pod_req,        // [P, R] (full mode)
    const uint8_t* __restrict__ sel_mask,     // [S, N]
    uint8_t* __restrict__ out)                // [P, N]
{
    const int node = blockIdx.x * blockDim.x + threadIdx.x;
    const int pod = blockIdx.y;
    if (node >= n) return;
    const statics::Nodes nd{n, tw, pw, node_valid, node_name, taint_bits, node_ports};
    const statics::Spec sp{p, pod, pod_valid, pod_name, tol_bits, tol_all, pod_ports};
    const int si = sel_idx[pod];
    const bool sel_ok = si < 0 || sel_mask[(size_t)min(si, s_rows - 1) * n + node];
    bool ok = statics::static_filters(nd, sp, node, sel_ok);
    if (full) {
        const bool fits = solve::node_fits(requested + (size_t)node * r,
                                           allocatable + (size_t)node * r,
                                           pod_req + (size_t)pod * r, r);
        const bool clash = solve::ports_clash(node_ports + (size_t)node * pw,
                                              pod_ports + (size_t)pod * pw, pw);
        ok = ok && fits && !clash;
    }
    out[(size_t)pod * n + node] = ok ? 1 : 0;
}

}  // namespace

extern "C" int pod_filters_launch(
    int n, int p, int tw, int pw, int r, int s_rows, int full,
    const void* node_valid, const void* node_name, const void* taint_bits,
    const void* node_ports, const void* requested, const void* allocatable,
    const void* pod_valid, const void* pod_name, const void* sel_idx,
    const void* tol_bits, const void* tol_all, const void* pod_ports,
    const void* pod_req, const void* sel_mask, void* out, void* stream)
{
    if (n == 0 || p == 0) return 0;
    const dim3 grid((n + kBlock - 1) / kBlock, p);
    pod_filters_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        n, p, tw, pw, r, s_rows, full,
        (const uint8_t*)node_valid, (const int32_t*)node_name,
        (const uint32_t*)taint_bits, (const uint32_t*)node_ports,
        (const float*)requested, (const float*)allocatable,
        (const uint8_t*)pod_valid, (const int32_t*)pod_name,
        (const int32_t*)sel_idx, (const uint32_t*)tol_bits,
        (const uint8_t*)tol_all, (const uint32_t*)pod_ports,
        (const float*)pod_req, (const uint8_t*)sel_mask, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* pod_filters_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
