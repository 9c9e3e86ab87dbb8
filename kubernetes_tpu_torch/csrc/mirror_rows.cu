// Kernel `mirror_rows`: one packed row delta applied to every resident
// leaf it names, in one launch, into fresh leaves: each fresh leaf is the
// old leaf with the delta's rows overlaid.
//
// Replaces: kubernetes_tpu/models/mirror.py:81 `_set_rows` and :86
// `_set_rows_ax1` as `_apply_deltas` (:481-517) calls them — one
// `arr.at[idx].set(vals)` dispatch and two uploads a leaf, 14 leaves a
// static-and-usage delta, each a new array — and
// kubernetes_tpu/ops/partials.py:180 `set_spec_rows` (the partials' spec
// rows, 15 leaves).  Here the host packs every leaf's rows into one pinned
// buffer, sends it in one copy, and this kernel writes
//
//   out[o, r, :] = packed[o, j, :]   where r = idx[j]
//   out[o, r, :] = src[o, r, :]      for every other row r
//
// for every leaf and outer slice o.  The old leaves are only read: a
// buffer a solve, a caller or a bookmark holds never changes.
//
// The buffer opens with one 64-byte descriptor a leaf (Leaf below: the old
// leaf's address, where its fresh copy lies in the launch's one output
// allocation, the bytes of an outer slice, where its row indices and
// packed rows lie in the buffer, the delta's rows, the row bytes, the
// outer count, the copy unit and the block split), then the prefix table
// of blocks (the first block of each leaf, then the total), then the
// index lists (ascending, distinct), then the rows, each segment 16-byte
// aligned.  `taint_bits` [3, N, TW] and the specs' `tol_bits` [3, G, TW] /
// `tol_all` [3, G] are effect-major: their row axis is dim 1, so outer = 3.
//
// Bound on this card: bytes.  Each old leaf is read once where the delta
// does not overwrite it, the packed rows once, and each fresh leaf written
// once; the descriptors, the prefix table and the indices are a few
// hundred bytes.  There is no arithmetic.
//
// Design: the host splits the work.  A block owns a contiguous byte range
// (a chunk, at most kChunk bytes) of one outer slice of one leaf: it finds
// its leaf by a binary search in the prefix table and its slice and chunk
// with one division, then the delta rows that fall in its range by two
// searches in the leaf's index list (a warp each, 32 probes a round), and
// stages those rows in shared memory.  Threads walk the range in
// copy units of 16, 4 or 1 bytes (the largest that the leaf's addresses
// and slice bytes allow, chosen on the host): a unit no delta row touches
// is copied from the old leaf; a unit inside one delta row, when the row
// bytes allow, is copied from the packed rows; a unit that straddles a
// delta row's edge is put together byte by byte in registers.  Every unit
// of a fresh leaf is written exactly once, by one thread, as one store, so
// no barrier between blocks is needed and no division runs per unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 16384;  // bytes a block copies, at most
constexpr int kStageRows = 1024;   // a chunk's delta rows held in shared memory, at most

struct Leaf {
    uint64_t src;           // device address of the old leaf's first byte
    uint64_t out_off;       // byte offset of the fresh leaf in the output allocation
    uint64_t slice_bytes;   // bytes of one outer slice (rows x row bytes)
    uint32_t idx_off;       // byte offset of the leaf's int32 row indices
    uint32_t vals_off;      // byte offset of the leaf's packed rows
    int32_t rows;           // rows in the delta
    int32_t row_bytes;      // bytes of one row
    int32_t outer;          // outer slices (3 for the effect-major leaves)
    int32_t unit;           // copy unit: 16, 4 or 1 bytes
    int32_t chunk_bytes;    // bytes of a block's range (a multiple of unit)
    int32_t chunks;         // blocks an outer slice
    int32_t pad[2];
};
static_assert(sizeof(Leaf) == 64, "descriptor layout shared with ops/device.py");

// The first j in [lo, hi) whose row ends past byte p: (idx[j] + 1) * rb > p.
__device__ __forceinline__ int first_ending_after(const int32_t* idx, int lo, int hi,
                                                  uint64_t rb, uint64_t p)
{
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((uint64_t)(idx[mid] + 1) * rb > p) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

template <int U> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<1> { using T = uint8_t; };

// Byte q of a unit put together in registers (U / 4 words, or one byte).
template <int U>
__device__ __forceinline__ void put_byte(typename Unit<U>::T& v, int q, uint32_t b)
{
    if constexpr (U == 16) {
        const uint32_t s = b << (8 * (q & 3));
        switch (q >> 2) {
            case 0: v.x |= s; break;
            case 1: v.y |= s; break;
            case 2: v.z |= s; break;
            default: v.w |= s; break;
        }
    } else if constexpr (U == 4) {
        v |= b << (8 * q);
    } else {
        v = (uint8_t)b;
    }
}

// The block's byte range [b0, b1) of one outer slice: src/dst/vals at the
// slice; rows[0, nj) (in shared memory, or the index list itself when the
// chunk holds too many) the delta rows that touch the range, the first of
// them delta row jb.
template <int U>
__device__ void copy_range(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                           const uint8_t* __restrict__ vals, const int32_t* rows, int jb,
                           int nj, uint64_t rb, uint64_t b0, uint64_t b1)
{
    using T = typename Unit<U>::T;
    if (nj == 0) {
        // no delta row in the range: four loads in flight a thread
        const T* s = reinterpret_cast<const T*>(src + b0);
        T* d = reinterpret_cast<T*>(dst + b0);
        const int n = (int)((b1 - b0) / U), bd = blockDim.x;
        int i = threadIdx.x;
        for (; i + 3 * bd < n; i += 4 * bd) {
            T v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = s[i + u * bd];
#pragma unroll
            for (int u = 0; u < 4; ++u) d[i + u * bd] = v[u];
        }
        for (; i < n; i += bd) d[i] = s[i];
        return;
    }
    const bool row_units = rb % U == 0;   // a unit inside a row is one aligned load
    for (uint64_t p = b0 + (uint64_t)threadIdx.x * U; p < b1; p += (uint64_t)blockDim.x * U) {
        int j = first_ending_after(rows, 0, nj, rb, p);
        const uint64_t start = j < nj ? (uint64_t)rows[j] * rb : ~0ull;
        T v;
        if (start >= p + U) {
            v = *reinterpret_cast<const T*>(src + p);                 // clean
        } else if (row_units && start <= p) {
            v = *reinterpret_cast<const T*>(vals + (uint64_t)(jb + j) * rb + (p - start));
        } else {
            v = T{};
#pragma unroll
            for (int q = 0; q < U; ++q) {
                const uint64_t at = p + q;
                while (j < nj && (uint64_t)(rows[j] + 1) * rb <= at) ++j;
                const bool in = j < nj && (uint64_t)rows[j] * rb <= at;
                put_byte<U>(v, q, in ? vals[(uint64_t)(jb + j) * rb + (at - (uint64_t)rows[j] * rb)]
                                     : src[at]);
            }
        }
        *reinterpret_cast<T*>(dst + p) = v;
    }
}

// The first j in [0, n) with pred(j) (false then true), by the calling
// warp: 32 probes a round, log32(n) rounds of loads.
template <typename Pred>
__device__ int warp_first(int n, Pred pred)
{
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;
    while (hi - lo > 32) {
        const int step = (hi - lo + 31) / 32;
        const int p = lo + lane * step;
        const int c = __popc(__ballot_sync(0xffffffffu, p < hi && !pred(p)));
        if (c == 0) return lo;
        const int nlo = lo + (c - 1) * step + 1;
        hi = min(hi, lo + c * step);
        lo = nlo;
    }
    return lo + __popc(__ballot_sync(0xffffffffu, lo + lane < hi && !pred(lo + lane)));
}

__global__ void __launch_bounds__(kBlock) mirror_rows_kernel(
    const uint8_t* __restrict__ buf, int n_leaves, uint8_t* __restrict__ out)
{
    __shared__ int s_j[2];
    __shared__ int32_t s_rows[kStageRows];
    const int32_t* prefix = reinterpret_cast<const int32_t*>(buf + n_leaves * sizeof(Leaf));
    int lo = 0, hi = n_leaves;   // the last leaf whose first block is <= blockIdx.x
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (prefix[mid] <= (int)blockIdx.x) lo = mid;
        else hi = mid;
    }
    const Leaf lf = reinterpret_cast<const Leaf*>(buf)[lo];
    const int b = blockIdx.x - prefix[lo];
    const int o = b / lf.chunks;
    const int c = b - o * lf.chunks;
    const uint64_t rb = (uint64_t)lf.row_bytes;
    const uint64_t b0 = (uint64_t)c * lf.chunk_bytes;
    const uint64_t end = b0 + (uint64_t)lf.chunk_bytes;
    const uint64_t b1 = end < lf.slice_bytes ? end : lf.slice_bytes;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(lf.src) + (uint64_t)o * lf.slice_bytes;
    uint8_t* dst = out + lf.out_off + (uint64_t)o * lf.slice_bytes;
    const uint8_t* vals = buf + lf.vals_off + (uint64_t)o * lf.rows * rb;
    const int32_t* idx = reinterpret_cast<const int32_t*>(buf + lf.idx_off);

    // the delta rows that touch [b0, b1): warp 0 finds the first ending
    // after b0, warp 1 the first starting at or past b1
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
        const int j = warp == 0
            ? warp_first(lf.rows, [&](int k) { return (uint64_t)(idx[k] + 1) * rb > b0; })
            : warp_first(lf.rows, [&](int k) { return (uint64_t)idx[k] * rb >= b1; });
        if ((threadIdx.x & 31) == 0) s_j[warp] = j;
    }
    __syncthreads();
    const int j0 = s_j[0], nj = s_j[1] - s_j[0];
    // the chunk's rows in shared memory when they fit
    const bool staged = nj <= kStageRows;
    if (staged) {
        for (int j = threadIdx.x; j < nj; j += blockDim.x) s_rows[j] = idx[j0 + j];
        __syncthreads();
    }
    const int32_t* rows = staged ? s_rows : idx + j0;
    if (lf.unit == 16) copy_range<16>(src, dst, vals, rows, j0, nj, rb, b0, b1);
    else if (lf.unit == 4) copy_range<4>(src, dst, vals, rows, j0, nj, rb, b0, b1);
    else copy_range<1>(src, dst, vals, rows, j0, nj, rb, b0, b1);
}

}  // namespace

extern "C" int mirror_rows_launch(const void* buf, int n_leaves, int blocks, void* out,
                                  void* stream)
{
    if (n_leaves == 0 || blocks == 0) return 0;
    mirror_rows_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, n_leaves, (uint8_t*)out);
    return (int)cudaGetLastError();
}

// The layout the bindings check on load: 0 the descriptor's bytes, 1 the
// block's threads, 2 the largest chunk a block copies.
extern "C" int mirror_rows_layout(int which)
{
    switch (which) {
        case 0: return (int)sizeof(Leaf);
        case 1: return kBlock;
        case 2: return kChunk;
        default: return -1;
    }
}

extern "C" const char* mirror_rows_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
