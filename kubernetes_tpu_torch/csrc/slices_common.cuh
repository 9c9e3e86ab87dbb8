// Device code of the TPU slice carve-out family (ops/slices.py), shared by
// the three kernels that use it — greedy_scan.cu (the scan's carve-out
// stage, through solve_common.cuh's block_eval), evaluate_single.cu (the
// single-pod anchor stage) and slice_stats.cu (fragmentation) — so that no
// route can drift from another:
//
//   free test     a node is free iff it is valid, belongs to a slice and
//                 hosts no pods (requested[:, RESOURCE_PODS] <= 0);
//   grid          presence and occupancy scattered into a value-space grid
//                 [S, D, D, D] (a coordinate shared by several nodes is free
//                 only when every node on it is free), then a zero-padded
//                 integral image [S, D+1, D+1, D+1] by three prefix passes;
//   box test      eight gathers of the integral give a box's free cells;
//   anchor        a free-box corner scores BONUS_CARVE - W_LEFTOVER *
//                 leftover - W_CORNER * coordinate sum (ok = the corner);
//   member        an anchored gang's member scores the anchored box by
//                 torus hops to its corner (ok = inside the box).
//
// Numerics: every count is an integer of at most D^3 = 4,096 cells, so the
// integral is kept in int32 and equals the reference's float32 cumsums
// exactly; the bonuses are integers below 2^24 in float32, exact whether a
// compiler fuses their multiply-adds or not.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slices {

// the reference's weights (ops/slices.py:68-72), verbatim
constexpr float kBonusCarve = 1000000.0f;
constexpr float kBonusSlice = 10000.0f;
constexpr float kWLeftover = 100.0f;
constexpr float kWHop = 10.0f;
constexpr float kWCorner = 10.0f;
constexpr int kMaxDim = 16;           // ops/schema.py max_slice_dim
constexpr int kReasonSlice = 7;

// The family's tables for one launch (on = 0: the batch has no slice
// family and nothing here is read).  The grid scratch is global memory:
// 64 slices of 16^3 cells take ~1.3 MB, more than a block's shared memory.
struct Slices {
    int on;                      // features.slices
    int require;                 // "require" policy: ok is a filter
    int z, d;                    // slice capacity S, cell edge D
    int r, pods_col;             // resource axis, the RESOURCE_PODS column
    const uint8_t* node_valid;   // [N]
    const int32_t* slice_id;     // [N] -1 none
    const int32_t* coords;       // [N, 4] (x, y, z, core), -1 absent
    const int32_t* dims;         // [N, 3] the node's slice extent
    const int32_t* pod_shape;    // [P, 3] 0 none
    int32_t* pres;               // [S, D, D, D] scratch
    int32_t* occ;                // [S, D, D, D] scratch
    int32_t* integral;           // [S, D+1, D+1, D+1] scratch
    int32_t* free_count;         // [S] scratch
};

inline Slices make_slices(int on, int require, int z, int d, int r, int pods_col,
                          const void* node_valid, const void* slice_id, const void* coords,
                          const void* dims, const void* pod_shape, void* pres, void* occ,
                          void* integral, void* free_count)
{
    Slices sl;
    sl.on = on;
    sl.require = require;
    sl.z = z;
    sl.d = d;
    sl.r = r;
    sl.pods_col = pods_col;
    sl.node_valid = (const uint8_t*)node_valid;
    sl.slice_id = (const int32_t*)slice_id;
    sl.coords = (const int32_t*)coords;
    sl.dims = (const int32_t*)dims;
    sl.pod_shape = (const int32_t*)pod_shape;
    sl.pres = (int32_t*)pres;
    sl.occ = (int32_t*)occ;
    sl.integral = (int32_t*)integral;
    sl.free_count = (int32_t*)free_count;
    return sl;
}

// One pod's view of the family, in shared memory (load_pod_carve).
struct PodCarve {
    int shaped;      // the pod asks for a carve-out (shape product > 0)
    int anchored;    // its gang has carved a box: member semantics
    int shape[3];
    int vol;
    int asl;         // the anchored slice
    int alo[3];      // the carved corner
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One thread fills `pc` for pod i; gang_sl / gang_lo are the carve-out
// carry (null without it: every shaped pod is an anchor).  The caller
// synchronises.
__device__ inline void load_pod_carve(const Slices& sl, int i, int g, int n_groups,
                                      const int32_t* gang_sl, const int32_t* gang_lo,
                                      PodCarve& pc)
{
    int vol = 1;
    for (int j = 0; j < 3; ++j) {
        pc.shape[j] = sl.pod_shape[(size_t)i * 3 + j];
        vol *= pc.shape[j];
        pc.alo[j] = -1;
    }
    pc.vol = vol;
    pc.shaped = vol > 0;
    pc.anchored = 0;
    pc.asl = -1;
    if (pc.shaped && gang_sl != nullptr && g >= 0) {
        const int gc = clampi(g, 0, n_groups - 1);
        if (gang_sl[gc] >= 0) {
            pc.anchored = 1;
            pc.asl = gang_sl[gc];
            for (int j = 0; j < 3; ++j) pc.alo[j] = gang_lo[(size_t)gc * 3 + j];
        }
    }
}

__device__ __forceinline__ bool has_coords(const Slices& sl, int nd)
{
    const int32_t* c = sl.coords + (size_t)nd * 4;
    return sl.slice_id[nd] >= 0 && c[0] >= 0 && c[1] >= 0 && c[2] >= 0;
}

// free_devices at node nd against the carried usage
__device__ __forceinline__ bool node_free(const Slices& sl, const float* requested, int nd)
{
    return sl.node_valid[nd] && sl.slice_id[nd] >= 0
        && requested[(size_t)nd * sl.r + sl.pods_col] <= 0.0f;
}

// The threads that build one grid together: one block over every node
// (BlockThreads, the default), or every block of a thread-block cluster,
// each over its own nodes (greedy_scan.cu).  rank() / size() number the
// team's threads; a thread of this block visits the nodes first(),
// first() + stride(), ... below end(n); sync() is the team's barrier, with
// release / acquire at the team's scope.
struct BlockThreads {
    __device__ int rank() const { return threadIdx.x; }
    __device__ int size() const { return blockDim.x; }
    __device__ int first() const { return threadIdx.x; }
    __device__ int stride() const { return blockDim.x; }
    __device__ int end(int n) const { return n; }
    __device__ void sync() const { __syncthreads(); }
};

// Team-wide: the occupancy grid, its integral image and the free node
// count of every slice, from `requested` (ops/slices.py _cell_grid,
// _integral, slice_free_counts).  Every thread of the team calls it; it
// ends on the team's barrier.  The grid is integers (any order of the
// scatter's stores and atomics gives the same cells), so a cluster builds
// the same grid as one block.
template <class Team = BlockThreads>
__device__ inline void block_build_grid(const Slices& sl, int n, const float* requested,
                                        const Team& team = Team())
{
    const int D = sl.d, D1 = sl.d + 1;
    const int cells = sl.z * D * D * D;
    const int t0 = team.rank(), ts = team.size();
    for (int t = t0; t < cells; t += ts) {
        sl.pres[t] = 0;
        sl.occ[t] = 0;
    }
    for (int t = t0; t < sl.z; t += ts) sl.free_count[t] = 0;
    team.sync();
    for (int nd = team.first(); nd < team.end(n); nd += team.stride()) {
        const bool fr = node_free(sl, requested, nd);
        const int s = clampi(sl.slice_id[nd], 0, sl.z - 1);
        if (fr) atomicAdd(&sl.free_count[s], 1);
        if (!has_coords(sl, nd)) continue;
        const int32_t* c = sl.coords + (size_t)nd * 4;
        const int idx = ((s * D + min(c[0], D - 1)) * D + min(c[1], D - 1)) * D + min(c[2], D - 1);
        sl.pres[idx] = 1;            // a scatter-max of ones: any store wins
        if (!fr) sl.occ[idx] = 1;
    }
    team.sync();
    const int vol1 = D1 * D1 * D1;
    for (int t = t0; t < sl.z * vol1; t += ts) {
        const int s = t / vol1, rem = t % vol1;
        const int i = rem / (D1 * D1), j = (rem / D1) % D1, k = rem % D1;
        int v = 0;
        if (i > 0 && j > 0 && k > 0) {
            const int cidx = ((s * D + i - 1) * D + j - 1) * D + k - 1;
            v = (sl.pres[cidx] > 0 && sl.occ[cidx] == 0) ? 1 : 0;
        }
        sl.integral[t] = v;
    }
    team.sync();
    // prefix sums along z, then y, then x (the cumsum axes 3, 2, 1)
    const int lines = sl.z * D1 * D1;
    for (int t = t0; t < lines; t += ts) {
        int32_t* row = sl.integral + (size_t)t * D1;
        for (int k = 1; k < D1; ++k) row[k] += row[k - 1];
    }
    team.sync();
    for (int t = t0; t < lines; t += ts) {
        const int s = t / (D1 * D1), i = (t / D1) % D1, k = t % D1;
        int32_t* col = sl.integral + (size_t)s * vol1 + (size_t)i * D1 * D1 + k;
        for (int j = 1; j < D1; ++j) col[j * D1] += col[(j - 1) * D1];
    }
    team.sync();
    for (int t = t0; t < lines; t += ts) {
        const int s = t / (D1 * D1), j = (t / D1) % D1, k = t % D1;
        int32_t* col = sl.integral + (size_t)s * vol1 + (size_t)j * D1 + k;
        for (int i = 1; i < D1; ++i) col[i * D1 * D1] += col[(i - 1) * D1 * D1];
    }
    team.sync();
}

// Free cells in [lo, hi) of the integral image `I` of one slice (edge D+1).
__device__ __forceinline__ int box_sum(const int32_t* I, int d1, const int* lo, const int* hi)
{
#define SLICES_AT(a, b, c) I[((a) * d1 + (b)) * d1 + (c)]
    return SLICES_AT(hi[0], hi[1], hi[2])
        - SLICES_AT(lo[0], hi[1], hi[2]) - SLICES_AT(hi[0], lo[1], hi[2])
        - SLICES_AT(hi[0], hi[1], lo[2])
        + SLICES_AT(lo[0], lo[1], hi[2]) + SLICES_AT(lo[0], hi[1], lo[2])
        + SLICES_AT(hi[0], lo[1], lo[2])
        - SLICES_AT(lo[0], lo[1], lo[2]);
#undef SLICES_AT
}

// corner_mask at node nd: the min-corner of a fully free shape box inside
// the node's declared extent (reads the grid block_build_grid built).
__device__ inline bool corner_at(const Slices& sl, const PodCarve& pc, const float* requested,
                                 int nd)
{
    if (!has_coords(sl, nd)) return false;
    const int32_t* c = sl.coords + (size_t)nd * 4;
    const int32_t* dm = sl.dims + (size_t)nd * 3;
    int lo[3], hi[3];
    for (int j = 0; j < 3; ++j) {
        if (c[j] + pc.shape[j] > dm[j]) return false;
        lo[j] = clampi(c[j], 0, sl.d);
        hi[j] = clampi(c[j] + pc.shape[j], 0, sl.d);
    }
    if (!node_free(sl, requested, nd)) return false;
    const int d1 = sl.d + 1;
    const int s = clampi(sl.slice_id[nd], 0, sl.z - 1);
    return box_sum(sl.integral + (size_t)s * d1 * d1 * d1, d1, lo, hi) >= pc.vol;
}

// carveout_eval at node nd for a shaped pod: returns ok (the require
// filter) and writes the bonus.  Anchors read the grid of this step.
__device__ inline bool carve_node(const Slices& sl, const PodCarve& pc, const float* requested,
                                  int nd, float& bonus)
{
    const int32_t* c = sl.coords + (size_t)nd * 4;
    const int sid = sl.slice_id[nd];
    if (pc.anchored) {
        const bool same = sid == pc.asl && sid >= 0 && node_free(sl, requested, nd);
        bool in = same;
        int hop = 0;
        for (int j = 0; j < 3; ++j) {
            in = in && c[j] >= pc.alo[j] && c[j] < pc.alo[j] + pc.shape[j];
            hop += abs(c[j] - pc.alo[j]);
        }
        const float hf = __fmul_rn(kWHop, (float)hop);
        bonus = in ? __fsub_rn(kBonusCarve + kBonusSlice, hf)
            : same ? __fsub_rn(kBonusSlice, hf) : 0.0f;
        return in;
    }
    const bool corner = corner_at(sl, pc, requested, nd);
    bonus = 0.0f;
    if (corner) {
        const float fc = (float)sl.free_count[clampi(sid, 0, sl.z - 1)];
        const float leftover = fmaxf(__fsub_rn(fc, (float)pc.vol), 0.0f);
        const bool all = c[0] >= 0 && c[1] >= 0 && c[2] >= 0;
        const float coordsum = all ? (float)(c[0] + c[1] + c[2]) : 0.0f;
        bonus = __fsub_rn(__fsub_rn(kBonusCarve, __fmul_rn(kWLeftover, leftover)),
                          __fmul_rn(kWCorner, coordsum));
    }
    return corner;
}

}  // namespace slices
