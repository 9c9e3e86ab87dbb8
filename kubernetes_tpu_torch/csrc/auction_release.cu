// Kernel `auction_release`: the gang post-pass's release after the
// auction's rounds.
//
// Replaces: kubernetes_tpu/ops/auction.py:825-838, the subtraction of the
// dropped gang members' requests from requested and nonzero_requested
// (a masked scatter-add, in the gang post-pass of auction.py:771-848).
//
// Bound on this card: the dropped pods' requests and assignments in, each
// of their nodes' two usage rows read and written once: microseconds of
// the card's memory rate.
//
// Design: one thread a node subtracts the requests of every dropped pod
// assigned to it, in pod index order (the order of the reference's
// scatter-add), so the sums equal the plain version's bit for bit.

#include "solve_common.cuh"

using namespace solve;

namespace {

__global__ void release_kernel(
    int n, int r, int p, const int32_t* __restrict__ assigned,
    const uint8_t* __restrict__ dropped, const float* __restrict__ pod_req,
    const float* __restrict__ pod_nz, float* requested, float* nonzero)
{
    const int b = (int)(blockIdx.x * blockDim.x + threadIdx.x);
    if (b >= n) return;
    for (int i = 0; i < p; ++i) {
        if (!dropped[i] || assigned[i] != b) continue;
        for (int rr = 0; rr < r; ++rr) {
            requested[(size_t)b * r + rr] = sub(requested[(size_t)b * r + rr], pod_req[(size_t)i * r + rr]);
            nonzero[(size_t)b * r + rr] = sub(nonzero[(size_t)b * r + rr], pod_nz[(size_t)i * r + rr]);
        }
    }
}

}  // namespace

extern "C" int auction_release_launch(
    int n, int r, int p, const void* assigned, const void* dropped, const void* pod_req,
    const void* pod_nz, void* requested, void* nonzero, void* stream)
{
    if (p == 0 || n == 0) return 0;
    release_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        n, r, p, (const int32_t*)assigned, (const uint8_t*)dropped, (const float*)pod_req,
        (const float*)pod_nz, (float*)requested, (float*)nonzero);
    return (int)cudaGetLastError();
}

extern "C" const char* auction_release_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
