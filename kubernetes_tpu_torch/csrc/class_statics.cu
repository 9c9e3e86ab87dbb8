// Kernel `class_statics`: the placement-independent per-class tables.
//
// Replaces: kubernetes_tpu/ops/assign.py:316 `class_statics` — the vmap over
// class representatives of `static_feasible_for_pod` (filters.py:166), the
// bound-port test, `node_affinity_raw` (scores.py:163) and
// `taint_toleration_raw` (scores.py:173).  Per (class c, node n):
//
//   sfeas[c, n] = node_valid & pod.valid & name_ok & taints_ok & sel_ok
//                 & ~bound_port_conflict
//   aff[c, n]   = sum_j weight_j * pref_mask[pref_idx_j, n]
//   taint[c, n] = popcount(PreferNoSchedule taints & ~tolerations), 0 under
//                 tol_all
//
// Bound on this card: bytes.  Every (c, n) reads the node's taint words
// (3 x TW), port words (PW) and one byte of each selector/preferred mask
// row it needs, and writes 9 bytes; the arithmetic is a few dozen integer
// operations per word.  With few classes (a Deployment is one) the node
// rows are read about once, so the floor is the node tables over the
// memory rate.
//
// Design: one thread per (class, node) on a 2-D grid (x = node, y = class).
// The per-class pod fields are the same for every thread of a row and are
// served from L1.  Affinity weights are summed in term order with IEEE adds
// (__fadd_rn / __fmul_rn): every term is an integer weight, so the sum is
// exact and equals the reference's reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kNoSchedule = 0;
constexpr int kPreferNoSchedule = 1;
constexpr int kNoExecute = 2;

__global__ void class_statics_kernel(
    int n, int p, int tw, int pw, int mt, int s_rows, int f_rows,
    const uint8_t* __restrict__ node_valid,   // [N]
    const int32_t* __restrict__ node_name,    // [N]
    const uint32_t* __restrict__ taint_bits,  // [3, N, TW]
    const uint32_t* __restrict__ node_ports,  // [N, PW]
    const int32_t* __restrict__ reps,         // [C] clipped to [0, P)
    const uint8_t* __restrict__ pod_valid,    // [P]
    const int32_t* __restrict__ pod_name,     // [P]
    const int32_t* __restrict__ sel_idx,      // [P]
    const uint32_t* __restrict__ tol_bits,    // [3, P, TW]
    const uint8_t* __restrict__ tol_all,      // [3, P]
    const uint32_t* __restrict__ pod_ports,   // [P, PW]
    const int32_t* __restrict__ pref_idx,     // [P, MT]
    const float* __restrict__ pref_weight,    // [P, MT]
    const uint8_t* __restrict__ sel_mask,     // [S, N]
    const uint8_t* __restrict__ pref_mask,    // [F, N]
    uint8_t* __restrict__ sfeas,              // [C, N]
    float* __restrict__ aff,                  // [C, N]
    float* __restrict__ taint)                // [C, N]
{
    const int node = blockIdx.x * blockDim.x + threadIdx.x;
    const int c = blockIdx.y;
    if (node >= n) return;
    const int rep = reps[c];

    bool ok = node_valid[node] && pod_valid[rep];
    const int pname = pod_name[rep];
    ok = ok && (pname == -1 || node_name[node] == pname);

    // TaintToleration filter: NoSchedule and NoExecute rows
    for (int eff = kNoSchedule; eff <= kNoExecute; eff += kNoExecute - kNoSchedule) {
        if (tol_all[eff * p + rep]) continue;
        const uint32_t* tb = taint_bits + ((size_t)eff * n + node) * tw;
        const uint32_t* tl = tol_bits + ((size_t)eff * p + rep) * tw;
        for (int w = 0; w < tw; ++w) {
            if (tb[w] & ~tl[w]) ok = false;
        }
    }

    // NodeAffinity / nodeSelector
    const int si = sel_idx[rep];
    if (si >= 0) ok = ok && sel_mask[(size_t)min(si, s_rows - 1) * n + node];

    // NodePorts against the bound pods' claims
    const uint32_t* np = node_ports + (size_t)node * pw;
    const uint32_t* pp = pod_ports + (size_t)rep * pw;
    for (int w = 0; w < pw; ++w) {
        if (np[w] & pp[w]) ok = false;
    }

    // NodeAffinity raw score: weights of matching preferred terms
    float a = 0.0f;
    for (int j = 0; j < mt; ++j) {
        const int pi = pref_idx[rep * mt + j];
        const float w = pi >= 0 ? pref_weight[rep * mt + j] : 0.0f;
        const int row = min(max(pi, 0), f_rows - 1);
        const float hit = pref_mask[(size_t)row * n + node] ? 1.0f : 0.0f;
        a = __fadd_rn(a, __fmul_rn(w, hit));
    }

    // TaintToleration raw score: untolerated PreferNoSchedule taints
    unsigned int cnt = 0;
    if (!tol_all[kPreferNoSchedule * p + rep]) {
        const uint32_t* tb = taint_bits + ((size_t)kPreferNoSchedule * n + node) * tw;
        const uint32_t* tl = tol_bits + ((size_t)kPreferNoSchedule * p + rep) * tw;
        for (int w = 0; w < tw; ++w) cnt += __popc(tb[w] & ~tl[w]);
    }

    const size_t o = (size_t)c * n + node;
    sfeas[o] = ok ? 1 : 0;
    aff[o] = a;
    taint[o] = (float)cnt;
}

}  // namespace

extern "C" int class_statics_launch(
    int n, int p, int c_dim, int tw, int pw, int mt, int s_rows, int f_rows,
    const void* node_valid, const void* node_name, const void* taint_bits,
    const void* node_ports, const void* reps, const void* pod_valid,
    const void* pod_name, const void* sel_idx, const void* tol_bits,
    const void* tol_all, const void* pod_ports, const void* pref_idx,
    const void* pref_weight, const void* sel_mask, const void* pref_mask,
    void* sfeas, void* aff, void* taint, void* stream)
{
    if (n == 0 || c_dim == 0) return 0;
    const dim3 grid((n + kBlock - 1) / kBlock, c_dim);
    class_statics_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        n, p, tw, pw, mt, s_rows, f_rows,
        (const uint8_t*)node_valid, (const int32_t*)node_name,
        (const uint32_t*)taint_bits, (const uint32_t*)node_ports,
        (const int32_t*)reps, (const uint8_t*)pod_valid,
        (const int32_t*)pod_name, (const int32_t*)sel_idx,
        (const uint32_t*)tol_bits, (const uint8_t*)tol_all,
        (const uint32_t*)pod_ports, (const int32_t*)pref_idx,
        (const float*)pref_weight, (const uint8_t*)sel_mask,
        (const uint8_t*)pref_mask, (uint8_t*)sfeas, (float*)aff,
        (float*)taint);
    return (int)cudaGetLastError();
}

extern "C" const char* class_statics_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
