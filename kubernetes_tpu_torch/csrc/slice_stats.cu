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
// nodes that is ~0.15 MB, tens of nanoseconds at the card's rate.  What is
// left is a launch and its chain of dependent steps.
//
// Design: one launch, one thread-block cluster of G blocks (1-16, about one
// node a thread).  Block b owns the 32-node chunks q with q % G == b
// (cluster_common.cuh block_of) and the slices s with s % G == b.
//   1. Each block zeroes its own slices' free counts, extents and
//      presence and occupancy cells ([D, D, D] bytes each) in its shared
//      memory (the cells in the allocation's global grid instead when a
//      block's cells pass kCellBytes), and the cluster the gang flags.  Each
//      thread's first node, first pod and first gang are loaded before the
//      cluster barrier and used after it.
//   2. One pass over the node table: each node's presence and occupancy
//      stored into its slice's cells (a store of ones: any store wins), its
//      free count and extent added (integers: any order), all into the
//      owning block's shared memory through DSMEM, once a warp where its 32
//      nodes share a slice; one pass over the pods: the gang flags
//      (atomicOr).  Cluster barrier.
//   3. Each warp of a block takes one of the block's slices at a time and
//      finds its largest cube by erosion, with no block barrier: the
//      slice's free cells as D^2 rows of D bits (bit z of row (x, y)), then
//      for k = 1, 2, ...: the k-cube corners C_k inside the declared extent
//      (x + k, y + k, z + k within it) are tested with one __any_sync, and
//      C_{k+1}(p) = the AND of C_k over p's 8 neighbours p + {0, 1}^3
//      (outside the grid false), as a (k+1)-cube is the union of the eight
//      k-cubes at those corners.  A corner holds a free k-cube inside the
//      grid exactly when `fragmentation`'s box sum over [p, p + k) clamped
//      to the grid reaches k^3 (a clamped box has fewer than k^3 cells), and
//      C_{k+1}, the extent test included, implies C_k at the same corner, so
//      the first k with no corner ends the sweep over k = 1..D and the last
//      k with one is the slice's largest cube.  Then its share of largest^3,
//      of the free counts and of the gang counters is stored into block 0's
//      slot for the block through DSMEM.  Cluster barrier.
//   4. Block 0 writes score = max(1 - placeable / max(free, 1), 0) with
//      __fdiv_rn and __fsub_rn in the reference's order, and the three
//      counters.  placeable and free are integers below 2^24 (S D^3 and N),
//      so their float32 sums in the reference are exact and equal these.
// The outputs and the scratch are one allocation (slice_stats_words).

#include "cluster_common.cuh"
#include "slices_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCellBytes = 64 * 1024;       // a block's cells kept in its shared memory
constexpr int kRows = slices::kMaxDim * slices::kMaxDim;   // a slice's (x, y) rows

struct Args {
    int n, z, d, r, pods_col, p, n_groups;
    const uint8_t* node_valid;   // [N]
    const int32_t* slice_id;     // [N]
    const int32_t* coords;       // [N, 4]
    const int32_t* dims;         // [N, 3]
    const float* requested;      // [N, R]
    const int32_t* assignment;   // [P]
    const uint8_t* pod_valid;    // [P]
    const int32_t* group_id;     // [P]
    const int32_t* pod_shape;    // [P, 3]
    const int32_t* gang_sl;      // [G] or null
    const int32_t* gang_lo;      // [G, 3]
    const uint8_t* gang_corner;  // [G]
    float* frag;                 // the allocation: frag, counters[3], flags, pres, occ
    int32_t* counters;
    int32_t* flags;              // [max(G, 1)]
    uint8_t* pres;               // [S, D, D, D]
    uint8_t* occ;                // [S, D, D, D]
};

// Words of the one allocation: frag, three counters, the gang flags, then
// the presence and occupancy bytes.
__host__ __device__ inline long long words_of(int z, int d, int n_groups)
{
    const long long cells = (long long)z * d * d * d;
    return 4 + (n_groups > 0 ? n_groups : 1) + (2 * cells + 3) / 4;
}

// One node's part of the grid, loaded ahead of its scatter.
struct NodeRec {
    int s;          // the slice (clamped), -1 not a member
    int cell;       // its cell within the slice, -1 none
    int fr;         // free
    int dims[3];
};

// A node's fields as loaded (the loads are waited for where they are first
// used: a thread's first node is loaded before the first barrier).
struct NodeRaw {
    int nd, sid;
    uint8_t valid;
    float pods;
    int dims[3], c[3];
};

__device__ __forceinline__ NodeRaw load_node(const Args& a, int nd)
{
    NodeRaw raw = {nd, -1, 0, 0.0f, {0, 0, 0}, {-1, -1, -1}};
    if (nd < a.n) {
        raw.sid = a.slice_id[nd];
        raw.valid = a.node_valid[nd];
        raw.pods = a.requested[(size_t)nd * a.r + a.pods_col];
        for (int j = 0; j < 3; ++j) {
            raw.dims[j] = a.dims[(size_t)nd * 3 + j];
            raw.c[j] = a.coords[(size_t)nd * 4 + j];
        }
    }
    return raw;
}

__device__ __forceinline__ NodeRec node_of(const Args& a, const NodeRaw& raw)
{
    NodeRec rec = {-1, -1, 0, {0, 0, 0}};
    if (raw.nd >= a.n || raw.sid < 0) return rec;
    const int D = a.d;
    rec.s = slices::clampi(raw.sid, 0, a.z - 1);
    rec.fr = raw.valid && raw.pods <= 0.0f;
    for (int j = 0; j < 3; ++j) rec.dims[j] = raw.dims[j];
    if (raw.c[0] >= 0 && raw.c[1] >= 0 && raw.c[2] >= 0) {
        rec.cell = (min(raw.c[0], D - 1) * D + min(raw.c[1], D - 1)) * D + min(raw.c[2], D - 1);
    }
    return rec;
}

// The block's shared memory: its slices' free counts and extents, then
// (when they fit, kCellBytes) its slices' presence and occupancy cells,
// stored by every block through DSMEM; else the cells are the allocation's
// grid in global memory.
struct Owned {
    int* free_count;   // [m]
    int* dims;         // [m, 3]
    uint8_t* pres;     // [m, D^3] or null
    uint8_t* occ;      // [m, D^3] or null
};

// The largest free cube of slice s (the block's q-th) by erosion (step 3
// of the design), on one warp: rows[2][kRows] is the warp's shared scratch.
__device__ inline int largest_cube(const Args& a, const Owned& own, int q, int s,
                                   uint16_t (*rows)[kRows])
{
    const int lane = threadIdx.x & 31, D = a.d, vol = D * D * D;
    const int* sd = own.dims + 3 * q;
    uint16_t* cur = rows[0];
    uint16_t* nxt = rows[1];
    for (int r = lane; r < D * D; r += 32) {
        unsigned bits = 0;
        for (int z = 0; z < D; ++z) {
            const int cell = r * D + z;
            const bool free_cell = own.pres != nullptr
                ? own.pres[q * vol + cell] && !own.occ[q * vol + cell]
                : __ldcg(a.pres + (size_t)s * vol + cell) && !__ldcg(a.occ + (size_t)s * vol + cell);
            bits |= (unsigned)free_cell << z;
        }
        cur[r] = (uint16_t)bits;
    }
    __syncwarp();
    int best = 0;
    for (int k = 1; k <= D; ++k) {
        // corners p with p + k inside the extent: z < sd[2] - k + 1
        const int zn = sd[2] - k + 1;
        const unsigned zmask = zn <= 0 ? 0u : (zn >= 32 ? 0xffffffffu : (1u << zn) - 1u);
        bool any = false;
        for (int r = lane; r < D * D; r += 32) {
            const int x = r / D, y = r % D;
            any |= x + k <= sd[0] && y + k <= sd[1] && (cur[r] & zmask) != 0;
        }
        if (!__any_sync(0xffffffffu, any)) break;
        best = k;
        if (k == D) break;
        for (int r = lane; r < D * D; r += 32) {
            const int x = r / D, y = r % D;
            const unsigned t = cur[r] & (x + 1 < D ? cur[r + D] : 0u)
                & (y + 1 < D ? cur[r + 1] : 0u) & (x + 1 < D && y + 1 < D ? cur[r + D + 1] : 0u);
            nxt[r] = (uint16_t)(t & (t >> 1));
        }
        __syncwarp();
        uint16_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    __syncwarp();   // the rows are free for the warp's next slice
    return best;
}

// A warp's 32 nodes (every lane calls it): the cells stored lane by lane;
// the free counts and extents added into the owning block's shared memory,
// once a warp when its nodes share one slice (a ballot and three warp
// maxima; the common case: a slice's nodes are neighbours in the table),
// else lane by lane.
__device__ __forceinline__ void scatter_node(const Args& a, const NodeRec& rec, int g_dim,
                                             const Owned& own, cg::cluster_group& cluster)
{
    const int lane = threadIdx.x & 31;
    const int s0 = __shfl_sync(0xffffffffu, rec.s, 0);
    if (__all_sync(0xffffffffu, rec.s == s0)) {
        if (s0 < 0) return;
        const unsigned fr = __ballot_sync(0xffffffffu, rec.fr);
        int mx[3];
        for (int j = 0; j < 3; ++j) mx[j] = __reduce_max_sync(0xffffffffu, rec.dims[j]);
        if (lane == 0) {
            const int owner = s0 % g_dim, q = s0 / g_dim;
            if (fr) atomicAdd(cluster.map_shared_rank(&own.free_count[q], owner), __popc(fr));
            int* dm = cluster.map_shared_rank(&own.dims[3 * q], owner);
            for (int j = 0; j < 3; ++j) atomicMax(&dm[j], mx[j]);
        }
    } else if (rec.s >= 0) {
        const int owner = rec.s % g_dim, q = rec.s / g_dim;
        if (rec.fr) atomicAdd(cluster.map_shared_rank(&own.free_count[q], owner), 1);
        int* dm = cluster.map_shared_rank(&own.dims[3 * q], owner);
        for (int j = 0; j < 3; ++j) atomicMax(&dm[j], rec.dims[j]);
    }
    if (rec.cell >= 0) {
        const int vol = a.d * a.d * a.d;
        if (own.pres != nullptr) {
            const int at = rec.s / g_dim * vol + rec.cell;
            const unsigned owner = rec.s % g_dim;
            *cluster.map_shared_rank(&own.pres[at], owner) = 1;
            if (!rec.fr) *cluster.map_shared_rank(&own.occ[at], owner) = 1;
        } else {
            const size_t at = (size_t)rec.s * vol + rec.cell;
            a.pres[at] = 1;
            if (!rec.fr) a.occ[at] = 1;
        }
    }
}

// A pod's own fields as loaded (the first of its two rounds of loads).
struct PodRaw {
    int i, g, asg, sh[3];
    uint8_t valid;
};

__device__ __forceinline__ PodRaw load_pod(const Args& a, int i)
{
    PodRaw raw = {i, -1, -1, {0, 0, 0}, 0};
    if (i < a.p) {
        raw.g = a.group_id[i];
        raw.valid = a.pod_valid[i];
        raw.asg = a.assignment[i];
        for (int j = 0; j < 3; ++j) raw.sh[j] = a.pod_shape[(size_t)i * 3 + j];
    }
    return raw;
}

// The pod's bits for its gang gc (the second round: its node's and its
// gang's fields): bit 0 a shaped member, bit 1 one unplaced, bit 2 one
// placed outside the carved box; 0 for no member (or i >= P).
__device__ __forceinline__ int pod_bits(const Args& a, const PodRaw& raw, int& gc)
{
    gc = 0;
    if (raw.i >= a.p) return 0;
    gc = slices::clampi(raw.g, 0, a.n_groups - 1);
    const int an = slices::clampi(raw.asg, 0, a.n - 1);
    const int sl = a.gang_sl[gc], sid = a.slice_id[an];
    bool in = sid == sl;
    for (int j = 0; j < 3; ++j) {
        const int lo = a.gang_lo[(size_t)gc * 3 + j];
        const int c = a.coords[(size_t)an * 4 + j];
        in = in && c >= lo && c < lo + raw.sh[j];
    }
    if (!(raw.valid && raw.g >= 0 && raw.sh[0] * raw.sh[1] * raw.sh[2] > 0)) return 0;
    return 1 | (raw.asg < 0 ? 2 : (in ? 0 : 4));
}

__global__ void __launch_bounds__(kThreads, 1) slice_stats_kernel(Args a, int m, int cells_shared)
{
    extern __shared__ int dyn[];
    __shared__ int s_part[5];   // this block's placeable, free, carve, contig, complete
    __shared__ int s_tot[solve::kMaxCluster][5];   // block 0: each block's, by rank
    __shared__ uint16_t s_rows[kWarps][2][kRows];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), g_dim = (int)cluster.num_blocks();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int first = (rank + g_dim * warp) * 32 + lane;   // cluster_common.cuh block_of
    const int stride = g_dim * kThreads;
    const int team = rank * kThreads + tid, team_size = stride;
    const int vol = a.d * a.d * a.d;
    uint8_t* cells = (uint8_t*)(dyn + 4 * m);
    Owned own = {dyn, dyn + m, cells_shared ? cells : nullptr,
                 cells_shared ? cells + m * vol : nullptr};
    const bool gangs = a.n_groups > 0 && a.gang_sl != nullptr;

    // ---- 1. zero; the first node, pod and gang loaded meanwhile
    const NodeRaw first_node = load_node(a, first);
    const PodRaw first_pod = load_pod(a, gangs ? team : a.p);
    const bool gang_any = gangs && team < a.n_groups;
    int first_sl = -1;
    uint8_t first_corner = 0;
    if (gang_any) {
        first_sl = a.gang_sl[team];
        first_corner = a.gang_corner[team];
    }
    if (cells_shared) {
        for (int t = tid; t < 2 * m * vol; t += kThreads) cells[t] = 0;
    } else {
        const size_t n_cells = (size_t)a.z * vol;
        for (size_t t = team; t < n_cells; t += team_size) a.pres[t] = a.occ[t] = 0;
    }
    if (gangs) {
        for (int g = team; g < a.n_groups; g += team_size) a.flags[g] = 0;
    }
    for (int t = tid; t < 4 * m; t += kThreads) dyn[t] = 0;   // free counts, extents
    if (tid < 5) s_part[tid] = 0;
    cluster.sync();

    // ---- 2. the node pass (warp-uniform: a warp's 32 nodes at a time) and
    // the pod pass
    scatter_node(a, node_of(a, first_node), g_dim, own, cluster);
    for (int base = first - lane + stride; base < a.n; base += stride) {
        scatter_node(a, node_of(a, load_node(a, base + lane)), g_dim, own, cluster);
    }
    if (gangs) {
        for (int i = team; i < a.p; i += team_size) {
            int gc;
            const int bits = pod_bits(a, i == team ? first_pod : load_pod(a, i), gc);
            if (bits) atomicOr(&a.flags[gc], bits);
        }
    }
    cluster.sync();
    const int first_flags = gang_any ? __ldcg(a.flags + team) : 0;

    // ---- 3. this block's slices, a warp a slice
    int placeable = 0, free_total = 0;
    for (int q = warp; q < m; q += kWarps) {
        const int s = q * g_dim + rank;
        if (s >= a.z) break;
        const int lf = largest_cube(a, own, q, s, s_rows[warp]);
        if (lane == 0) {
            placeable += lf * lf * lf;
            free_total += own.free_count[q];
        }
    }
    int carve = 0, contig = 0, complete = 0;
    if (gangs) {
        for (int g = team; g < a.n_groups; g += team_size) {
            const bool ahead = g == team;   // the first gang: loaded ahead
            const int f = ahead ? first_flags : __ldcg(a.flags + g);
            const bool any = (f & 1) != 0;
            const bool done = any && !(f & 2);
            const bool anchored = (ahead ? first_sl : a.gang_sl[g]) >= 0 && any;
            carve += anchored;
            complete += done;
            contig += done && anchored && (ahead ? first_corner : a.gang_corner[g]) != 0
                && !(f & 4);
        }
    }
    int part[5] = {placeable, free_total, carve, contig, complete};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        const int v = __reduce_add_sync(0xffffffffu, part[j]);
        if (lane == 0 && v) atomicAdd(&s_part[j], v);
    }
    __syncthreads();
    if (tid < 5) *cluster.map_shared_rank(&s_tot[rank][tid], 0) = s_part[tid];
    cluster.sync();

    // ---- 4. the totals (integers: any order)
    if (rank == 0 && tid == 0) {
        int tot[5] = {0, 0, 0, 0, 0};
        for (int b = 0; b < g_dim; ++b) {
            for (int j = 0; j < 5; ++j) tot[j] += s_tot[b][j];
        }
        const float score = __fsub_rn(1.0f, __fdiv_rn((float)tot[0], fmaxf((float)tot[1], 1.0f)));
        a.frag[0] = fmaxf(score, 0.0f);
        a.counters[0] = tot[2];
        a.counters[1] = tot[3];
        a.counters[2] = tot[4] - tot[3];
    }
}

// The cluster's blocks at n nodes: about one node a thread, 1 to 16.
int blocks_for(int n)
{
    const int b = (n + kThreads - 1) / kThreads;
    return b < 1 ? 1 : (b > solve::kMaxCluster ? solve::kMaxCluster : b);
}

}  // namespace

extern "C" int slice_stats_limits() { return slices::kMaxDim; }

extern "C" long long slice_stats_words(int z, int d, int n_groups)
{
    return words_of(z, d, n_groups);
}

extern "C" int slice_stats_launch(
    int n, int z, int d, int r, int pods_col, int p, int n_groups,
    const void* node_valid, const void* slice_id, const void* coords, const void* dims,
    const void* requested, const void* assignment, const void* pod_valid,
    const void* group_id, const void* pod_shape, const void* gang_sl, const void* gang_lo,
    const void* gang_corner, void* buf, void* stream)
{
    if (z < 1 || d < 1 || d > slices::kMaxDim || pods_col >= r || n < 1) {
        return (int)cudaErrorInvalidValue;
    }
    int32_t* w = (int32_t*)buf;
    const int ng = n_groups > 0 ? n_groups : 1;
    const size_t cells = (size_t)z * d * d * d;
    uint8_t* pres = (uint8_t*)(w + 4 + ng);
    Args a = {n, z, d, r, pods_col, p, n_groups, (const uint8_t*)node_valid,
              (const int32_t*)slice_id, (const int32_t*)coords, (const int32_t*)dims,
              (const float*)requested, (const int32_t*)assignment, (const uint8_t*)pod_valid,
              (const int32_t*)group_id, (const int32_t*)pod_shape,
              n_groups > 0 ? (const int32_t*)gang_sl : nullptr, (const int32_t*)gang_lo,
              (const uint8_t*)gang_corner, (float*)w, w + 1, w + 4, pres, pres + cells};
    const solve::Shape shape = {kThreads, blocks_for(n)};
    const int m = (z + shape.blocks - 1) / shape.blocks;   // slices a block owns, at most
    const long long cell_bytes = 2LL * m * d * d * d;
    const int cells_shared = cell_bytes <= kCellBytes;
    const long long smem = 4LL * m * (long long)sizeof(int) + (cells_shared ? cell_bytes : 0);
    if (smem > 160 * 1024) return (int)cudaErrorInvalidValue;
    return (int)solve::launch_cluster(slice_stats_kernel, shape, (int)smem, (cudaStream_t)stream,
                                      a, m, cells_shared);
}

extern "C" const char* slice_stats_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
