// Kernel `class_extras`: the hoisted static extra score row of each class —
// preferred inter-pod affinity and ImageLocality — once a batch.
//
// Replaces: kubernetes_tpu/ops/scores.py:337 `static_extra` over the classes
// (assign.py:513-537; the auction's `joint_extra`, auction.py:280-318), with
// `pref_pod_raw` (interpod.py:255), `normalize_minmax` (scores.py:370) and
// `image_locality_score` (scores.py:305).
//
// What it computes, for each (representative pod, feasible row) pair c:
//   pref  = floor(100 (raw - min) / max(max - min, 1e-30)) over the feasible
//           nodes (0 where max == min and outside the set), raw = the sum of
//           the pod's own preferred weights times the domain's matching
//           bound pods, plus the owner weights of the rows the pod matches;
//   image = floor(100 (clamp(sum, 23MB, 1000MB x containers) - 23MB) /
//           (1000MB x containers - 23MB)), the sum over the pod's images on
//           the node of size x (nodes having it / valid nodes);
//   out   = (0 + w_pref pref) + w_image image, each family only when on.
// The scan and the wavefront pass (class_rep[c], static row of class c); the
// auction passes (its constraint class's representative, its spec class's
// static row).
//
// Numerics.  Every float operation is the reference's, in its order, IEEE
// round-to-nearest (__fadd_rn etc., built with --fmad=false): the
// reference's compiler fuses none of these multiply-adds (its presence
// products are 0 or 1 times a size, exact either way).  The image terms are
// added one after another in slot order, as XLA's CPU reduction adds them;
// sizes times counts leave float32's exact range, so that order is part of
// the result.  The preferred raws are integer sums below 2^24, exact in any
// order; the per-image node counts are integers.
//
// Bound on this card: per pair, the preferred rows read (the pod's rows of
// the [U, N] tables), the image words of the pod's images and the node
// validity once, two passes over the output row.  Microseconds at the
// card's memory rate for the shapes of the main path.
//
// Design: one block of 1,024 threads a pair (grid-strided over the pairs,
// at most one a streaming multiprocessor); the min / max and the per-image
// counts are block reductions.

#include "solve_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxMI = 16;              // images per pod
constexpr float kImgMin = 24117248.0f;  // 23 MB, image_locality.go minThreshold
constexpr float kImgMaxPerContainer = 1048576000.0f;  // 1000 MB

// Block-wide float max; every thread returns it.
__device__ float block_max(float m, Scratch& sc)
{
    return -block_reduce_min(-m, sc);
}

__global__ void __launch_bounds__(kThreads, 1) class_extras_kernel(
    int n, int c_dim, int p, int pref_on, int img_on, float w_pref, float w_img,
    const int32_t* __restrict__ reps,          // [C]
    const uint8_t* __restrict__ feas,          // [C, N]
    int u_dim, int ma,
    const float* __restrict__ counts_dom,      // [U, N]
    const float* __restrict__ ownerw_dom,      // [U, N]
    const int32_t* __restrict__ pref_idx,      // [P, MA]
    const float* __restrict__ pref_weight,     // [P, MA]
    const uint8_t* __restrict__ pref_matches,  // [P, U]
    int iw, int i_dim, int mi,
    const uint32_t* __restrict__ image_bits,   // [N, IW]
    const uint8_t* __restrict__ node_valid,    // [N]
    const float* __restrict__ sizes,           // [I]
    const int32_t* __restrict__ pod_ids,       // [P, MI]
    const float* __restrict__ n_containers,    // [P]
    float* out)                                // [C, N]
{
    __shared__ Scratch sc;
    __shared__ int s_cnt[kMaxMI + 1];  // per-image node counts, then valid nodes
    __shared__ float s_scaled[kMaxMI];
    __shared__ int s_word[kMaxMI], s_bit[kMaxMI];
    const int tid = threadIdx.x;

    for (int c = blockIdx.x; c < c_dim; c += gridDim.x) {
        const int rep = min(max(reps[c], 0), p - 1);
        const uint8_t* frow = feas + (size_t)c * n;
        float* orow = out + (size_t)c * n;
        for (int nd = tid; nd < n; nd += blockDim.x) orow[nd] = 0.0f;

        if (pref_on) {
            // the raw row (into the output row), its max / min over the
            // feasible nodes
            float mx = -1e30f, mn = 1e30f;
            for (int nd = tid; nd < n; nd += blockDim.x) {
                float own = 0.0f;
                for (int j = 0; j < ma; ++j) {
                    const int idx = pref_idx[(size_t)rep * ma + j];
                    const float w = idx >= 0 ? pref_weight[(size_t)rep * ma + j] : 0.0f;
                    own = add(own, mul(w, counts_dom[(size_t)min(max(idx, 0), u_dim - 1) * n + nd]));
                }
                float theirs = 0.0f;
                for (int u = 0; u < u_dim; ++u) {
                    const float m = pref_matches[(size_t)rep * u_dim + u] ? 1.0f : 0.0f;
                    theirs = add(theirs, mul(m, ownerw_dom[(size_t)u * n + nd]));
                }
                const float raw = add(own, theirs);
                orow[nd] = raw;
                if (frow[nd]) {
                    mx = fmaxf(mx, raw);
                    mn = fminf(mn, raw);
                }
            }
            mx = block_max(mx, sc);
            mn = block_reduce_min(mn, sc);
            const float span = sub(mx, mn);
            for (int nd = tid; nd < n; nd += blockDim.x) {
                float s = span > 0.0f
                    ? floorf(dv(mul(kMaxNodeScore, sub(orow[nd], mn)), fmaxf(span, 1e-30f)))
                    : 0.0f;
                if (!frow[nd]) s = 0.0f;
                orow[nd] = add(0.0f, mul(w_pref, s));
            }
        }

        if (img_on) {
            if (tid <= mi) s_cnt[tid] = 0;
            if (tid < mi) {
                const int id = pod_ids[(size_t)rep * mi + tid];
                const int idc = min(max(id, 0), i_dim - 1);
                s_word[tid] = idc >> 5;
                s_bit[tid] = idc & 31;
            }
            __syncthreads();
            // per image, the valid nodes that hold it; and the valid nodes
            int local[kMaxMI + 1];
            for (int j = 0; j <= mi; ++j) local[j] = 0;
            for (int nd = tid; nd < n; nd += blockDim.x) {
                if (!node_valid[nd]) continue;
                local[mi] += 1;
                for (int j = 0; j < mi; ++j) {
                    local[j] += (image_bits[(size_t)nd * iw + s_word[j]] >> s_bit[j]) & 1u;
                }
            }
            for (int j = 0; j <= mi; ++j) {
                if (local[j]) atomicAdd(&s_cnt[j], local[j]);
            }
            __syncthreads();
            bool any_active = false;
            for (int j = 0; j < mi; ++j) any_active |= pod_ids[(size_t)rep * mi + j] >= 0;
            if (tid < mi) {
                const int id = pod_ids[(size_t)rep * mi + tid];
                const float nv = (float)max(s_cnt[mi], 1);
                s_scaled[tid] = id >= 0
                    ? dv(mul(sizes[min(max(id, 0), i_dim - 1)], (float)s_cnt[tid]), nv)
                    : 0.0f;
            }
            __syncthreads();
            const float lo = kImgMin;
            const float hi = mul(kImgMaxPerContainer, fmaxf(n_containers[rep], 1.0f));
            for (int nd = tid; nd < n; nd += blockDim.x) {
                float raw = 0.0f;
                for (int j = 0; j < mi; ++j) {
                    const uint32_t has = (image_bits[(size_t)nd * iw + s_word[j]] >> s_bit[j]) & 1u;
                    raw = add(raw, has ? s_scaled[j] : 0.0f);
                }
                const float s = any_active
                    ? floorf(dv(mul(kMaxNodeScore, sub(fminf(fmaxf(raw, lo), hi), lo)), sub(hi, lo)))
                    : 0.0f;
                orow[nd] = add(orow[nd], mul(w_img, s));
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int class_extras_limits() { return kMaxMI; }

extern "C" int class_extras_launch(
    int n, int c_dim, int p, int grid, int pref_on, int img_on, float w_pref, float w_img,
    const void* reps, const void* feas, int u_dim, int ma, const void* counts_dom,
    const void* ownerw_dom, const void* pref_idx, const void* pref_weight,
    const void* pref_matches, int iw, int i_dim, int mi, const void* image_bits,
    const void* node_valid, const void* sizes, const void* pod_ids,
    const void* n_containers, void* out, void* stream)
{
    if (grid < 1 || (img_on && (mi < 1 || mi > kMaxMI || i_dim < 1 || iw * 32 < i_dim))
        || (pref_on && (u_dim < 1 || ma < 1))) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0 || c_dim == 0 || p == 0) return 0;
    class_extras_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        n, c_dim, p, pref_on, img_on, w_pref, w_img, (const int32_t*)reps,
        (const uint8_t*)feas, u_dim, ma, (const float*)counts_dom,
        (const float*)ownerw_dom, (const int32_t*)pref_idx, (const float*)pref_weight,
        (const uint8_t*)pref_matches, iw, i_dim, mi, (const uint32_t*)image_bits,
        (const uint8_t*)node_valid, (const float*)sizes, (const int32_t*)pod_ids,
        (const float*)n_containers, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* class_extras_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
