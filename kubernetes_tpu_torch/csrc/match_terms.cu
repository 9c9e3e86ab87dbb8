// Kernel `match_terms`: a constraint table's match mask, for the callers
// that need only masks (the warm spread batches' selector mask, the
// preemption pass and its one-pod static row, feasible_batch).  The cold
// statics prep evaluates its rows inside class_statics.cu instead.
//
// Replaces: kubernetes_tpu/ops/filters.py:88 `match_terms`, as reached by
// `selector_match` (filters.py:134) and `preferred_match` (filters.py:144):
// for every table row and every node, OR over the row's valid terms of the
// AND over the term's expressions of a label-bitset or topology-slot test.
//
// Bound on this card: bytes.  Each node's label words and topology ids that
// the valid expressions test are read once, and each (row, node) writes one
// byte; the id tables are a few KB and stay in L1/L2.  The work per
// (row, node) is a few hundred integer tests, far below the card's integer
// rate, so the floor is the node rows moved once and the mask written.
//
// Design: the node tile of statics_common.cuh.  A block owns 32 nodes and
// stages their topology ids, and their label words when some row's valid
// expressions read labels, in shared memory with coalesced loads, once;
// then each warp evaluates whole rows (a lane a node) from shared memory
// and writes the row's 32 bytes.  The node rows are read once a block, not
// once a row.  Terms and expressions end early on the first decided
// outcome, as the boolean algebra allows; the result is exact.  The body
// is statics::match_row, which class_statics and partials_eval share.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statics_common.cuh"

namespace {

__global__ void __launch_bounds__(statics::kTileThreads) match_terms_kernel(
    const uint32_t* __restrict__ label_bits,  // [N, LW]
    int n, int lw,
    const int32_t* __restrict__ topo_ids,     // [N, TK]
    int tk, statics::Table tb,
    uint8_t* __restrict__ out)                // [R, N]
{
    extern __shared__ uint32_t smem[];
    statics::Tile tl;
    tl.node0 = blockIdx.x * statics::kTile;
    tl.nt = min(statics::kTile, n - tl.node0);
    tl.lw = lw;
    tl.tk = tk;
    tl.label = smem;
    tl.topo = (int32_t*)(smem + statics::kTile * lw);
    statics::stage_rows(tl.topo, topo_ids, tl.node0, tl.nt, tk);
    // whether some row reads label words, while the topology ids load
    const int items = tb.t * tb.e;
    int reads = 0;
    for (int i = threadIdx.x; i < tb.rows * items; i += blockDim.x) {
        reads |= statics::row_reads_labels(tb, i / items, tk, i % items);
    }
    if (__syncthreads_or(reads)) {
        statics::stage_rows(tl.label, label_bits, tl.node0, tl.nt, lw);
        __syncthreads();
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int row = warp; row < tb.rows; row += statics::kTileWarps) {
        const bool ok = statics::tile_match(tl, tb, row, lane);
        if (lane < tl.nt) out[(size_t)row * n + tl.node0 + lane] = ok ? 1 : 0;
    }
}

int smem_bytes(int lw, int tk)
{
    return statics::kTile * (lw + tk) * 4;
}

}  // namespace

extern "C" int match_terms_launch(
    const void* label_bits, int n, int lw, const void* topo_ids, int tk,
    const void* expr_ids, const void* expr_op, const void* expr_slot,
    const void* term_valid, int rows, int t, int e, int k, void* out,
    void* stream)
{
    if (n == 0 || rows == 0) return 0;
    const int smem = smem_bytes(lw, tk);
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            match_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const statics::Table tb{rows, t, e, k, (const int32_t*)expr_ids, (const int32_t*)expr_op,
                            (const int32_t*)expr_slot, (const uint8_t*)term_valid};
    const int grid = (n + statics::kTile - 1) / statics::kTile;
    match_terms_kernel<<<grid, statics::kTileThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)label_bits, n, lw, (const int32_t*)topo_ids, tk, tb, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* match_terms_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
