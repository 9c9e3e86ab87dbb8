// Kernel `slice_stats`: the slice carve-out telemetry of one solve.
//
// Replaces: kubernetes_tpu/ops/slices.py:269 `fragmentation` (with its
// `free_devices`:83, `_cell_grid`:96, `_integral`:123, `_box_sum`:130,
// `slice_free_counts`:173) over the post-release cluster, and the carve-out
// counters of kubernetes_tpu/ops/assign.py:776-818 (`carveouts`,
// `contiguous_gangs`, `carveout_fallbacks`) over the post-release
// assignment and the scan's final carve-out carry.
//
// Bound on this card: bytes.  The function reads the node tables once
// (valid, slice id, coordinates, extent, requested pods: ~36 B a node) and
// the pods' assignment, group and shape, and writes four scalars; at 4,096
// nodes that is ~0.15 MB, tens of nanoseconds at the card's rate.  This
// design pays two launch latencies and one pass over the nodes per slice.
//
// Design: launch 1 runs one block per slice.  Each block scans the node
// table for its slice's nodes, builds its grid (presence and occupancy,
// bytes) and the integral image in shared memory (at most 16^3 cells and
// 17^3 ints: 28 KB), takes the slice's declared extent (a max over its
// nodes) and free count, then sweeps k = 1..D as the reference does: a
// k-cube exists if some corner inside the extent has k^3 free cells; the
// largest such k is the slice's largest cube.  Launch 2, one block, adds
// largest^3 and the free counts (integers below 2^24: exact in any order),
// computes score = max(1 - placeable / max(free, 1), 0) with __fdiv_rn and
// __fsub_rn in the reference's order, and the three counters from the
// post-release assignment, one flag word a gang in global scratch.

#include "slices_common.cuh"

namespace {

constexpr int kStatsThreads = 256;
constexpr int kCounterThreads = 1024;
constexpr int kMaxCells = slices::kMaxDim * slices::kMaxDim * slices::kMaxDim;
constexpr int kMaxCells1 = (slices::kMaxDim + 1) * (slices::kMaxDim + 1) * (slices::kMaxDim + 1);

__global__ void __launch_bounds__(kStatsThreads) slice_grid_kernel(
    int n, int z, int d, int r, int pods_col,
    const uint8_t* __restrict__ node_valid, const int32_t* __restrict__ slice_id,
    const int32_t* __restrict__ coords, const int32_t* __restrict__ dims,
    const float* __restrict__ requested,
    int32_t* largest, int32_t* free_count)        // [S] each
{
    __shared__ uint8_t pres[kMaxCells], occ[kMaxCells];
    __shared__ int32_t integral[kMaxCells1];
    __shared__ int sdims[3];
    __shared__ int nfree;
    const int s = blockIdx.x;
    const int D = d, D1 = d + 1;
    const int cells = D * D * D, cells1 = D1 * D1 * D1;
    for (int t = threadIdx.x; t < cells; t += blockDim.x) pres[t] = occ[t] = 0;
    if (threadIdx.x < 3) sdims[threadIdx.x] = 0;
    if (threadIdx.x == 0) nfree = 0;
    __syncthreads();
    int my_free = 0;
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
        const int sid = slice_id[nd];
        if (slices::clampi(sid, 0, z - 1) != s) continue;
        const bool fr = node_valid[nd] && sid >= 0 && requested[(size_t)nd * r + pods_col] <= 0.0f;
        my_free += fr ? 1 : 0;
        if (sid < 0) continue;
        for (int j = 0; j < 3; ++j) atomicMax(&sdims[j], dims[(size_t)nd * 3 + j]);
        const int32_t* c = coords + (size_t)nd * 4;
        if (c[0] < 0 || c[1] < 0 || c[2] < 0) continue;
        const int idx = (min(c[0], D - 1) * D + min(c[1], D - 1)) * D + min(c[2], D - 1);
        pres[idx] = 1;
        if (!fr) occ[idx] = 1;
    }
    atomicAdd(&nfree, my_free);
    __syncthreads();
    for (int t = threadIdx.x; t < cells1; t += blockDim.x) {
        const int i = t / (D1 * D1), j = (t / D1) % D1, k = t % D1;
        int v = 0;
        if (i > 0 && j > 0 && k > 0) {
            const int cidx = ((i - 1) * D + j - 1) * D + k - 1;
            v = (pres[cidx] && !occ[cidx]) ? 1 : 0;
        }
        integral[t] = v;
    }
    __syncthreads();
    const int lines = D1 * D1;
    for (int t = threadIdx.x; t < lines; t += blockDim.x) {
        int32_t* row = integral + t * D1;
        for (int k = 1; k < D1; ++k) row[k] += row[k - 1];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < lines; t += blockDim.x) {
        int32_t* col = integral + (t / D1) * D1 * D1 + t % D1;    // (i, k), along j
        for (int j = 1; j < D1; ++j) col[j * D1] += col[(j - 1) * D1];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < lines; t += blockDim.x) {
        int32_t* col = integral + t;                              // (j, k), along i
        for (int i = 1; i < D1; ++i) col[i * D1 * D1] += col[(i - 1) * D1 * D1];
    }
    __syncthreads();
    int best = 0;
    for (int k = 1; k <= D; ++k) {
        bool exists = false;
        for (int t = threadIdx.x; t < cells && !exists; t += blockDim.x) {
            const int lo[3] = {t / (D * D), (t / D) % D, t % D};
            if (lo[0] + k > sdims[0] || lo[1] + k > sdims[1] || lo[2] + k > sdims[2]) continue;
            const int hi[3] = {min(lo[0] + k, D), min(lo[1] + k, D), min(lo[2] + k, D)};
            exists = slices::box_sum(integral, D1, lo, hi) >= k * k * k;
        }
        if (__syncthreads_or(exists)) best = k;
    }
    if (threadIdx.x == 0) {
        largest[s] = best;
        free_count[s] = nfree;
    }
}

__global__ void __launch_bounds__(kCounterThreads) slice_counters_kernel(
    int n, int z, int p, int n_groups,
    const int32_t* __restrict__ largest, const int32_t* __restrict__ free_count,
    const int32_t* __restrict__ slice_id, const int32_t* __restrict__ coords,
    const int32_t* __restrict__ assignment, const uint8_t* __restrict__ pod_valid,
    const int32_t* __restrict__ group_id, const int32_t* __restrict__ pod_shape,
    const int32_t* __restrict__ gang_sl, const int32_t* __restrict__ gang_lo,
    const uint8_t* __restrict__ gang_corner,
    int32_t* flags,                               // [max(G, 1)] scratch
    float* frag, int32_t* counters)               // [1], [3]
{
    __shared__ int s_carve, s_contig, s_complete;
    if (threadIdx.x == 0) {
        float placeable = 0.0f, total_free = 0.0f;
        for (int s = 0; s < z; ++s) {
            const float lf = (float)largest[s];
            placeable = __fadd_rn(placeable, __fmul_rn(__fmul_rn(lf, lf), lf));
            total_free = __fadd_rn(total_free, (float)free_count[s]);
        }
        const float score = __fsub_rn(1.0f, __fdiv_rn(placeable, fmaxf(total_free, 1.0f)));
        frag[0] = fmaxf(score, 0.0f);
        s_carve = s_contig = s_complete = 0;
    }
    if (n_groups > 0 && gang_sl != nullptr) {
        // per gang: bit 0 a shaped member, bit 1 one unplaced, bit 2 one
        // placed outside the carved box
        for (int g = threadIdx.x; g < n_groups; g += blockDim.x) flags[g] = 0;
        __syncthreads();
        for (int i = threadIdx.x; i < p; i += blockDim.x) {
            const int g = group_id[i];
            const int32_t* sh = pod_shape + (size_t)i * 3;
            if (!(pod_valid[i] && g >= 0 && sh[0] * sh[1] * sh[2] > 0)) continue;
            const int gc = slices::clampi(g, 0, n_groups - 1);
            int bits = 1;
            const int a = assignment[i];
            if (a < 0) {
                bits |= 2;
            } else {
                const int an = slices::clampi(a, 0, n - 1);
                const int32_t* c = coords + (size_t)an * 4;
                bool in = slice_id[an] == gang_sl[gc];
                for (int j = 0; j < 3; ++j) {
                    const int lo = gang_lo[(size_t)gc * 3 + j];
                    in = in && c[j] >= lo && c[j] < lo + sh[j];
                }
                if (!in) bits |= 4;
            }
            atomicOr(&flags[gc], bits);
        }
        __syncthreads();
        int carve = 0, contig = 0, complete = 0;
        for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
            const int f = flags[g];
            const bool any = (f & 1) != 0;
            const bool done = any && !(f & 2);
            const bool anchored = gang_sl[g] >= 0 && any;
            carve += anchored;
            complete += done;
            contig += done && anchored && gang_corner[g] && !(f & 4);
        }
        atomicAdd(&s_carve, carve);
        atomicAdd(&s_contig, contig);
        atomicAdd(&s_complete, complete);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        counters[0] = s_carve;
        counters[1] = s_contig;
        counters[2] = s_complete - s_contig;
    }
}

}  // namespace

extern "C" int slice_stats_limits() { return slices::kMaxDim; }

extern "C" int slice_stats_launch(
    int n, int z, int d, int r, int pods_col, int p, int n_groups,
    const void* node_valid, const void* slice_id, const void* coords, const void* dims,
    const void* requested, const void* assignment, const void* pod_valid,
    const void* group_id, const void* pod_shape, const void* gang_sl, const void* gang_lo,
    const void* gang_corner, void* largest, void* free_count, void* flags,
    void* frag, void* counters, void* stream)
{
    if (z < 1 || d < 1 || d > slices::kMaxDim || pods_col >= r || n < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    slice_grid_kernel<<<z, kStatsThreads, 0, st>>>(
        n, z, d, r, pods_col, (const uint8_t*)node_valid, (const int32_t*)slice_id,
        (const int32_t*)coords, (const int32_t*)dims, (const float*)requested,
        (int32_t*)largest, (int32_t*)free_count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    slice_counters_kernel<<<1, kCounterThreads, 0, st>>>(
        n, z, p, n_groups, (const int32_t*)largest, (const int32_t*)free_count,
        (const int32_t*)slice_id, (const int32_t*)coords, (const int32_t*)assignment,
        (const uint8_t*)pod_valid, (const int32_t*)group_id, (const int32_t*)pod_shape,
        (const int32_t*)gang_sl, (const int32_t*)gang_lo, (const uint8_t*)gang_corner,
        (int32_t*)flags, (float*)frag, (int32_t*)counters);
    return (int)cudaGetLastError();
}

extern "C" const char* slice_stats_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
