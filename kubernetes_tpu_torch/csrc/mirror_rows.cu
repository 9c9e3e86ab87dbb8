// Kernel `mirror_rows`: one packed row delta scattered into every resident
// leaf it names, in one launch.
//
// Replaces: kubernetes_tpu/models/mirror.py:81 `_set_rows` and :86
// `_set_rows_ax1` as `_apply_deltas` (:481-517) calls them — one
// `arr.at[idx].set(vals)` dispatch and two uploads a leaf, 14 leaves a
// static-and-usage delta — and kubernetes_tpu/ops/partials.py:180
// `set_spec_rows` (the partials' spec rows, 15 leaves).  Here the host
// packs every leaf's rows into one pinned buffer, sends it in one copy,
// and this kernel writes them:
//
//   dst[o, idx[r], :] = packed[o, r, :]    for every leaf, o < outer, r < rows
//
// The buffer opens with one 48-byte descriptor a leaf (Leaf below: the
// destination address, its outer and row strides, where the leaf's row
// indices and packed rows lie in the buffer, the row bytes, the outer
// count and the copy unit), then the index lists, then the rows, each
// segment 4-byte aligned.  `taint_bits` [3, N, TW] and the specs'
// `tol_bits` [3, G, TW] / `tol_all` [3, G] are effect-major: their row axis
// is dim 1, so outer = 3.
//
// Bound on this card: bytes.  The packed rows are read once and written
// once; the descriptors and indices are a few hundred bytes.  There is no
// arithmetic.
//
// Design: a 2-D grid, y = leaf, x = a grid-stride loop over the leaf's
// (outer, row, unit) triples, so neighbouring threads copy neighbouring
// words of one row.  Rows whose byte count is a multiple of 4 move as
// 4-byte words; bool leaves (one byte a row, or 3 a slot) move as bytes.
// The caller scatters into fresh copies of the resident leaves, never into
// a buffer a solve or a bookmark may still read, and gives each row at
// most once, so no two threads write one address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBlocksX = 1024;

struct Leaf {
    uint64_t dst;           // device address of the leaf's first element
    uint64_t outer_stride;  // bytes between outer slices of dst
    uint64_t row_stride;    // bytes between rows of dst
    uint32_t src_off;       // byte offset of the leaf's packed rows
    uint32_t idx_off;       // byte offset of the leaf's int32 row indices
    int32_t rows;           // rows in the delta
    int32_t row_bytes;      // bytes of one row
    int32_t outer;          // outer slices (3 for the effect-major leaves)
    int32_t unit;           // 4: copy words; 1: copy bytes
};
static_assert(sizeof(Leaf) == 48, "descriptor layout shared with ops/device.py");

__global__ void mirror_rows_kernel(const uint8_t* __restrict__ buf)
{
    const Leaf lf = reinterpret_cast<const Leaf*>(buf)[blockIdx.y];
    const int units = lf.row_bytes / lf.unit;
    const long long total = (long long)lf.outer * lf.rows * units;
    const int32_t* idx = reinterpret_cast<const int32_t*>(buf + lf.idx_off);
    const uint8_t* src = buf + lf.src_off;
    uint8_t* dst = reinterpret_cast<uint8_t*>(lf.dst);
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < total;
         u += (long long)gridDim.x * blockDim.x) {
        const long long orow = u / units;        // outer * rows + row
        const int w = (int)(u - orow * units);
        const int o = (int)(orow / lf.rows);
        const int r = (int)(orow - (long long)o * lf.rows);
        uint8_t* d = dst + o * lf.outer_stride + (uint64_t)idx[r] * lf.row_stride
                     + (uint64_t)w * lf.unit;
        const uint8_t* s = src + (uint64_t)orow * lf.row_bytes + (uint64_t)w * lf.unit;
        if (lf.unit == 4) {
            *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
        } else {
            *d = *s;
        }
    }
}

}  // namespace

extern "C" int mirror_rows_launch(const void* buf, int n_leaves, int max_units, void* stream)
{
    if (n_leaves == 0 || max_units == 0) return 0;
    int bx = (max_units + kBlock - 1) / kBlock;
    if (bx > kMaxBlocksX) bx = kMaxBlocksX;
    const dim3 grid(bx, n_leaves);
    mirror_rows_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>((const uint8_t*)buf);
    return (int)cudaGetLastError();
}

extern "C" int mirror_rows_leaf_bytes() { return (int)sizeof(Leaf); }

extern "C" const char* mirror_rows_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
