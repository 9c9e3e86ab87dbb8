// Kernel `match_terms`: required-selector and preferred-term match masks.
//
// Replaces: kubernetes_tpu/ops/filters.py:88 `match_terms`, as reached by
// `selector_match` (filters.py:134) and `preferred_match` (filters.py:144):
// for every table row and every node, OR over the row's valid terms of the
// AND over the term's expressions of a label-bitset or topology-slot test.
//
// Bound on this card: bytes.  Each (row, node) reads at most one label word
// or one topology id per expanded id (T*E*K of them, 512 at the default
// caps) and writes one byte; the id tables are a few KB and stay in L1/L2.
// The work per (row, node) is a few hundred integer tests, far below the
// card's integer rate, so the floor is the label/topology rows moved once.
//
// Design: one thread per (row, node) on a 2-D grid (x = node, y = row), so
// neighbouring threads read neighbouring nodes' label rows.  Terms and
// expressions end early on the first decided outcome (a satisfied term, a
// failed expression), as the boolean algebra allows; the result is exact.
// Output is one uint8 per (row, node).  The per-(row, node) body is
// statics::match_row (statics_common.cuh), which partials_eval shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statics_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void match_terms_kernel(
    const uint32_t* __restrict__ label_bits,  // [N, LW]
    int n, int lw,
    const int32_t* __restrict__ topo_ids,     // [N, TK]
    int tk,
    const int32_t* __restrict__ expr_ids,     // [R, T, E, K]
    const int32_t* __restrict__ expr_op,      // [R, T, E]
    const int32_t* __restrict__ expr_slot,    // [R, T, E]
    const uint8_t* __restrict__ term_valid,   // [R, T]
    int t, int e, int k,
    uint8_t* __restrict__ out)                // [R, N]
{
    const int node = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y;
    if (node >= n) return;
    const bool ok = statics::match_row(
        label_bits + (size_t)node * lw, lw, topo_ids + (size_t)node * tk, tk,
        expr_ids + (size_t)row * t * e * k, expr_op + (size_t)row * t * e,
        expr_slot + (size_t)row * t * e, term_valid + (size_t)row * t, t, e, k);
    out[(size_t)row * n + node] = ok ? 1 : 0;
}

}  // namespace

extern "C" int match_terms_launch(
    const void* label_bits, int n, int lw, const void* topo_ids, int tk,
    const void* expr_ids, const void* expr_op, const void* expr_slot,
    const void* term_valid, int rows, int t, int e, int k, void* out,
    void* stream)
{
    if (n == 0 || rows == 0) return 0;
    const dim3 grid((n + kBlock - 1) / kBlock, rows);
    match_terms_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)label_bits, n, lw, (const int32_t*)topo_ids, tk,
        (const int32_t*)expr_ids, (const int32_t*)expr_op,
        (const int32_t*)expr_slot, (const uint8_t*)term_valid, t, e, k,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* match_terms_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
