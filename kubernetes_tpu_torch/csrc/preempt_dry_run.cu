// Kernel `preempt_dry_run`: preemption's cumulative victim subtraction.
//
// Replaces: kubernetes_tpu/ops/preemption.py:129 `batched_dry_run` and :70
// `dry_run_victims`.  Both run one body in one launch (preempt_dry_run_launch:
// the victims entry passes `valid` and no perm, levels or flags).
//
// Per (level l, node n) row: gather the node's victims in the level's
// eviction order (perm; the identity in the victims entry), multiply each
// by its 0/1 mask (the level's evictable prefix, k < elig_len; or
// victim_valid, which need not be a prefix) as the reference does —
// padding slots may hold junk, and 0 x inf stays NaN —, and prefix-sum
// over k.  Then for every pod p of level l: the first k = 0..bound with
// req <= 0 || req <= free + cum[k - 1] on every resource (k = 0: free +
// 0.0, the reference's concatenated zero row) is min_k, 0 and infeasible
// when none fits (as jnp.argmax returns); bound is elig_len, or the count
// of valid slots; viol_k is the PDB-violation count of the evicted prefix.
//
// Numerics: the prefix sum adds in the reference compiler's CPU order for
// jnp.cumsum (ops/auction.py prefix_sum): sequentially inside blocks of 16
// slots (zero-padded), the block totals prefix-summed the same way (blocks
// of 16 totals, whose totals are summed sequentially), then each block's
// exclusive total added.  Requests that are not whole MiB leave float32's
// exact range once a node's victims pass 4,096 MiB, and then the order
// decides which k fits.  Every add and multiply is __fadd_rn / __fmul_rn
// (built --fmad=false); free is the host's allocatable - requested, used
// as given (never rearranged into req - cum <= free).  A run of zeros adds
// nothing (a sum that starts at +0.0 is never -0.0), so the padding of a
// block or of a chunk is skipped, not added.  The violation prefix is an
// integer count, order-free.
//
// Bound on this card: bytes.  The inputs (free, the victims' requests,
// the orders and flags, the pods' requests) are read once and the three
// [P, N] outputs written once; the work is a few float operations per
// (l, n, k, r) and per (p, n, k, r) the first-fit walk reaches.
//
// Design: a row of lanes owns one (level, node) row: a warp, or a
// segment of G = 4, 8 or 16 of its lanes when the launch has more rows
// than the card has warp slots (G is the widest that keeps every row's
// lanes in one wave, at least 4: c9's 131,072 rows take G = 4, 8 rows a
// warp); a block is 8 warps on consecutive nodes of one level (grid: node
// tiles x levels).  The row's lanes take it in chunks of 256 slots — one
// second-level block of the order above — held in shared memory as
// [R][K' + K'/16] floats (K' = min(256, K) rounded up to 16; a pad word
// every 16 slots, so lanes summing blocks of one resource hit distinct
// banks):
//   1. gather: a lane a slot reads perm, then the slot's R requests
//      (independent loads), masks with __fmul_rn; the PDB flags of each G
//      slots are one __ballot_sync word;
//   2. a lane sums 16-slot block b of resource r sequentially (__fadd_rn),
//      in place;
//   3. the block totals are copied aside; block b's lane sums totals
//      0..b-1 sequentially and adds that (plus, past the first chunk, the
//      running total of the earlier chunks: the second level) to block b;
//      the chunk's totals summed sequentially extend the running total,
//      so K up to MAX_VICTIM_SLOTS = 4,096 (16 chunks) needs no array in
//      registers or local memory.
// The first fit, per pod of the level (pods in groups of 32), chunk by
// chunk over the chunk's candidate k (0 included in the first): where
// they are at most kWalkSpan = 16, the row's lanes take a pod each (lane
// i the pending pods i, i + G, ...) and walk its k in order, every lane
// at once (a (pod, k) test is a few instructions, a ballot's
// bookkeeping dozens: with 16 pods and 5 k a row, ballots at every span
// took half the launch); past that, (pod, k) pairs, W = the span
// rounded up to a power of two (at most G) lanes a pod and G / W pods a
// __ballot_sync, a pod's first set bit (__ffs) its min_k — with W = G =
// 32 a lane a k, 32 k a ballot, one pod at a time.  The pods left over
// go to the next chunk (__reduce_or_sync).  viol_k is the popcount of the
// flag words below min_k plus the earlier chunks'.  With K <= 256 (one chunk) the sums are
// made once a row, whatever the number of pod groups; past that, once a
// pod group that needs them.  The results of a pod group go to shared
// memory and out a pod row of the block's nodes at a time.  No global
// scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanBlock = 16;                          // ops/auction.py SCAN_BLOCK
constexpr int kChunk = kScanBlock * kScanBlock;         // one second-level block
constexpr int kMaxK = kChunk * kScanBlock;              // two recursion levels
constexpr int kPodGroup = 32;                           // pods a group
constexpr int kMaxWarps = 8;
constexpr int kMinLanes = 4;                            // the narrowest row
constexpr int kWalkSpan = 16;                           // k a pod walks in turn, at most
constexpr int kSmemCap = 96 * 1024;                     // warps shrink to stay under it
constexpr int kSmemMax = 227 * 1024;                    // the card's opt-in limit

// The launch arguments: ints[kI_*] and ptrs[kP_*] (host arrays), in this
// order (preempt_dry_run_layout gives the lengths, checked by the bindings).
enum { kI_L, kI_N, kI_K, kI_R, kI_P, kI_COUNT };
enum {
    kP_FREE, kP_VICTIM_REQ, kP_PERM, kP_ELIG_LEN, kP_VALID, kP_VIOL, kP_PODS_REQ,
    kP_POD_LEVEL, kP_FEASIBLE, kP_MIN_K, kP_VIOL_K,
    kP_COUNT
};

struct Args {
    int l_dim, n, k, r, p;
    int g;                          // lanes a row: 4, 8, 16 or 32
    int kc, stride, nb;             // slots a chunk's buffer; floats a resource; blocks
    const float* free;              // [N, R]
    const float* victim_req;        // [N, K, R]
    const int32_t* perm;            // [L, N, K], null in the victims entry
    const int32_t* elig_len;        // [L, N], null in the victims entry
    const uint8_t* valid;           // [N, K], the victims entry only
    const uint8_t* viol;            // [L, N, K] or null
    const float* pods_req;          // [P, R]
    const int32_t* pod_level;       // [P] or null (level 0)
    uint8_t* feasible;              // [P, N]
    int32_t* min_k;                 // [P, N]
    int32_t* viol_k;                // [P, N] or null
};

// Words of shared memory a row: the chunk [R][stride], its block totals
// [R][nb], free [R], the running total [R], the flag words [kc / G].
__host__ __device__ inline int row_words(const Args& a)
{
    return a.r * a.stride + a.r * a.nb + 2 * a.r + (a.kc + a.g - 1) / a.g;
}

// Dynamic shared memory of a block of `warps` warps: the pod group's
// requests [32, R], the rows' areas, then the staged results min_k and
// viol_k [32, rows] (int32) and feasible [32, rows] (u8).
int smem_bytes(const Args& a, int warps)
{
    const int rows = warps * (32 / a.g);
    return 4 * (kPodGroup * a.r + rows * row_words(a) + 2 * kPodGroup * rows)
           + kPodGroup * rows;
}

__device__ __forceinline__ int slot_at(int s) { return s + (s >> 4); }

// Whether a pod fits its row after evicting the first k victims: free +
// cum[k - 1] (free + 0.0 at k = 0) holds its request on every resource
// it asks for; `cum` holds the chunk at `base`.
__device__ __forceinline__ bool fits(const Args& a, const float* fr, const float* req,
                                     const float* cum, int k, int base)
{
    bool ok = true;
#pragma unroll 4
    for (int rr = 0; rr < a.r; ++rr) {
        const float cv = k == 0 ? 0.0f : cum[rr * a.stride + slot_at(k - 1 - base)];
        const float f = __fadd_rn(fr[rr], cv);
        ok = ok & (req[rr] <= 0.0f || req[rr] <= f);
    }
    return ok;
}

// A row's lanes: the segment of g lanes at `shift`, their mask.
struct Seg {
    int g, sl, shift;
    unsigned mask, bits;
    __device__ unsigned ballot(bool pred) const
    {
        return (__ballot_sync(mask, pred) >> shift) & bits;
    }
};

// Chunk q of row (l, node) into `cum`: gathered, masked, prefix-summed in
// the reference's order given `carry` (the running total of chunks < q;
// extended here), its flag words into `vbits`.  Returns the chunk's
// violation count.  Every lane of the row calls it.
__device__ __forceinline__ int build_chunk(const Args& a, const Seg sg, int l, int node,
                                           int lim, int q, float* cum, float* tot,
                                           float* carry, uint32_t* vbits)
{
    const int base = q * kChunk;
    const int cs = min(kChunk, a.k - base);
    const int nblk = (cs + kScanBlock - 1) / kScanBlock;
    const size_t row = (size_t)l * a.n + node;
    // a lane a slot: its order, mask and flag loaded together, then its
    // victim's R requests; the flags of each G slots one ballot word
    int count = 0;
    for (int s0 = 0; s0 < cs; s0 += sg.g) {
        const int s = s0 + sg.sl, j = base + s;
        const bool at = s < cs;
        int src = j;
        bool in = false, flag = false;
        if (at) {
            if (a.valid != nullptr) {
                in = a.valid[(size_t)node * a.k + j] != 0;
            } else {
                src = min(max(a.perm[row * a.k + j], 0), a.k - 1);
                in = j < lim;
                flag = a.viol != nullptr && in && a.viol[row * a.k + j];
            }
            const float* v = a.victim_req + ((size_t)node * a.k + src) * a.r;
            for (int rr = 0; rr < a.r; ++rr) {
                cum[rr * a.stride + slot_at(s)] = __fmul_rn(v[rr], in ? 1.0f : 0.0f);
            }
        }
        const unsigned word = sg.ballot(flag);
        if (sg.sl == 0) vbits[s0 / sg.g] = word;
        count += __popc(word);
    }
    __syncwarp(sg.mask);
    // level 0: a lane a (block b, resource r)
    for (int it = sg.sl; it < nblk * a.r; it += sg.g) {
        const int b = it % nblk, rr = it / nblk;
        float* c = cum + rr * a.stride + b * (kScanBlock + 1);
        const int m = min(kScanBlock, cs - b * kScanBlock);
        float run = 0.0f;
        for (int j = 0; j < m; ++j) {
            run = __fadd_rn(run, c[j]);
            c[j] = run;
        }
        tot[rr * a.nb + b] = run;
    }
    __syncwarp(sg.mask);
    // level 1 (+ the level 2 carry): block b gains the totals of blocks
    // 0..b-1 summed in order, plus the earlier chunks' running total
    for (int it = sg.sl; it < nblk * a.r; it += sg.g) {
        const int b = it % nblk, rr = it / nblk;
        const float* t = tot + rr * a.nb;
        float run = 0.0f;
        for (int i = 0; i < b; ++i) run = __fadd_rn(run, t[i]);
        if (b == 0 && q == 0) continue;
        const float add = b == 0 ? carry[rr] : (q > 0 ? __fadd_rn(run, carry[rr]) : run);
        float* c = cum + rr * a.stride + b * (kScanBlock + 1);
        const int m = min(kScanBlock, cs - b * kScanBlock);
        for (int j = 0; j < m; ++j) c[j] = __fadd_rn(c[j], add);
    }
    __syncwarp(sg.mask);
    for (int rr = sg.sl; rr < a.r; rr += sg.g) {
        float run = 0.0f;
        for (int i = 0; i < nblk; ++i) run = __fadd_rn(run, tot[rr * a.nb + i]);
        carry[rr] = q == 0 ? run : __fadd_rn(carry[rr], run);
    }
    __syncwarp(sg.mask);
    return count;
}

// Pod `pod`'s first fit k on the block's row `row` into the staged
// results, with the PDB violations among slots 0..k-1: the earlier
// chunks' (vbase), the whole flag words below, the last word's low bits.
// Returns the pod's bit.
__device__ __forceinline__ unsigned record(const Args& a, int pod, int k, int base, int vbase,
                                           const uint32_t* vbits, int rows, int row,
                                           uint8_t* s_fe, int32_t* s_mk, int32_t* s_vk)
{
    int v = 0;
    if (k > 0) {
        const int last = k - 1 - base;
        v = vbase;
        for (int w = 0; w < last / a.g; ++w) v += __popc(vbits[w]);
        const int nbit = last % a.g + 1;
        v += __popc(vbits[last / a.g] & (nbit == 32 ? kFull : (1u << nbit) - 1u));
    }
    const int o = pod * rows + row;
    s_fe[o] = 1;
    s_mk[o] = k;
    s_vk[o] = v;
    return 1u << pod;
}

__global__ void __launch_bounds__(kMaxWarps * 32) dry_run_kernel(Args a)
{
    extern __shared__ float smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    Seg sg;
    sg.g = a.g;
    const int seg = lane / a.g;
    sg.sl = lane - seg * a.g;
    sg.shift = seg * a.g;
    sg.bits = a.g == 32 ? kFull : (1u << a.g) - 1u;
    sg.mask = sg.bits << sg.shift;
    const int rows = warps * (32 / a.g);                // the block's rows
    const int row = warp * (32 / a.g) + seg;
    const int l = blockIdx.y;
    const int node = blockIdx.x * rows + row;
    const bool live = node < a.n;
    const int rw = row_words(a);
    float* s_req = smem;                                                    // [32, R]
    float* cum = s_req + kPodGroup * a.r + row * rw;
    float* tot = cum + a.r * a.stride;                                      // [R, nb]
    float* fr = tot + a.r * a.nb;                                           // [R]
    float* carry = fr + a.r;                                                // [R]
    uint32_t* vbits = (uint32_t*)(carry + a.r);                             // [kc / G]
    int32_t* s_mk = (int32_t*)(s_req + kPodGroup * a.r + rows * rw);        // [32, rows]
    int32_t* s_vk = s_mk + kPodGroup * rows;
    uint8_t* s_fe = (uint8_t*)(s_vk + kPodGroup * rows);

    // a level no pod of the launch has: nothing to write (the whole block)
    bool here = false;
    for (int g0 = 0; g0 < a.p && !here; g0 += kPodGroup) {
        const int pi = g0 + lane;
        here = __any_sync(kFull, pi < a.p && (a.pod_level == nullptr
                                               || min(max(a.pod_level[pi], 0), a.l_dim - 1) == l));
    }
    if (!here) return;
    // issued together: the first pod group's requests, the row's bound
    // and free vector
    for (int i = threadIdx.x; i < kPodGroup * a.r; i += blockDim.x) {
        s_req[i] = i / a.r < a.p ? a.pods_req[i] : 0.0f;
    }
    int lim = 0;
    if (live) {
        if (a.valid != nullptr) {
            for (int j0 = 0; j0 < a.k; j0 += a.g) {
                const int j = j0 + sg.sl;
                lim += __popc(sg.ballot(j < a.k && a.valid[(size_t)node * a.k + j]));
            }
        } else {
            lim = a.elig_len[(size_t)l * a.n + node];
        }
        for (int rr = sg.sl; rr < a.r; rr += a.g) fr[rr] = a.free[(size_t)node * a.r + rr];
    }
    const int kmax = min(a.k, lim);
    int cached = -1;               // the chunk in `cum`
    int vbase = 0, vnext = 0;      // violations before the cached chunk, and through it
    if (live) {
        __syncwarp(sg.mask);
        if (kmax >= 1) {           // the first chunk, before the block's first barrier
            vnext = build_chunk(a, sg, l, node, lim, 0, cum, tot, carry, vbits);
            cached = 0;
        }
    }

    for (int g0 = 0; g0 < a.p; g0 += kPodGroup) {
        const int pi = g0 + lane;
        const int lvl = pi < a.p && a.pod_level != nullptr
                            ? min(max(a.pod_level[pi], 0), a.l_dim - 1) : 0;
        // the group's pods of this level: the same in every warp of the block
        const unsigned mine = __ballot_sync(kFull, pi < a.p && lvl == l);
        if (mine == 0) continue;
        if (g0 > 0) {               // the first group's requests are staged already
            __syncthreads();        // the previous group's staged results are out
            for (int i = threadIdx.x; i < kPodGroup * a.r; i += blockDim.x) {
                const int pp = g0 + i / a.r;
                s_req[i] = pp < a.p ? a.pods_req[(size_t)pp * a.r + i % a.r] : 0.0f;
            }
        }
        __syncthreads();
        if (live) {
            for (int i = sg.sl; i < kPodGroup; i += a.g) {
                if (!((mine >> i) & 1u)) continue;
                const int o = i * rows + row;        // infeasible until a fit is found
                s_fe[o] = 0;
                s_mk[o] = 0;
                s_vk[o] = 0;
            }
            __syncwarp(sg.mask);
            unsigned pending = kmax >= 0 ? mine : 0u;
            for (int q = 0; pending != 0u && q * kChunk <= kmax; ++q) {
                const int base = q * kChunk;
                const int cs = min(kChunk, a.k - base);
                const int k_lo = q == 0 ? 0 : base + 1;
                const int k_hi = min(base + cs, kmax);
                if (k_hi < k_lo) break;
                if (k_hi >= 1 && cached != q) {
                    vbase = q == 0 ? 0 : vnext;
                    vnext = vbase + build_chunk(a, sg, l, node, lim, q, cum, tot, carry, vbits);
                    cached = q;
                }
                const int span = k_hi - k_lo + 1;
                unsigned found = 0u;        // pods this lane recorded
                if (span <= kWalkSpan) {
                    // a lane a pod — lane i takes the pending pods i, i + G,
                    // ... in bit order —, k in order: each pod's first fit
                    unsigned m = pending;
                    for (int t = 0; t < sg.sl && m != 0u; ++t) m &= m - 1u;
                    while (m != 0u) {
                        const int pod = __ffs(m) - 1;
                        for (int kk = k_lo; kk <= k_hi; ++kk) {
                            if (fits(a, fr, s_req + pod * a.r, cum, kk, base)) {
                                found |= record(a, pod, kk, base, vbase, vbits, rows, row,
                                                s_fe, s_mk, s_vk);
                                break;
                            }
                        }
                        for (int t = 0; t < a.g && m != 0u; ++t) m &= m - 1u;
                    }
                } else {
                    // (pod, k) pairs: wk lanes a pod, g / wk pods a ballot; a
                    // pod's first set bit its first fit
                    int wk = 1;
                    while (wk < span && wk < a.g) wk <<= 1;
                    const unsigned wbits = wk == 32 ? kFull : (1u << wk) - 1u;
                    const int slot = sg.sl / wk, off = sg.sl - slot * wk;
                    for (unsigned left = pending; left != 0u;) {
                        unsigned m = left;
                        int pod = -1;
                        for (int t = 0; t < a.g / wk && m != 0u; ++t) {
                            const unsigned low = m & (0u - m);
                            if (t == slot) pod = __ffs(low) - 1;
                            left &= ~low;
                            m &= m - 1u;
                        }
                        bool done = pod < 0;
                        for (int j0 = 0; j0 < span; j0 += wk) {
                            const int kk = k_lo + j0 + off;
                            const bool ok = !done && j0 + off < span
                                            && fits(a, fr, s_req + pod * a.r, cum, kk, base);
                            const unsigned bits = (sg.ballot(ok) >> (slot * wk)) & wbits;
                            if (!done && bits != 0u) {
                                done = true;
                                if (off == 0) {
                                    found |= record(a, pod, k_lo + j0 + __ffs(bits) - 1, base,
                                                    vbase, vbits, rows, row, s_fe, s_mk, s_vk);
                                }
                            }
                            if (sg.ballot(!done) == 0u) break;
                        }
                    }
                }
                pending &= ~__reduce_or_sync(sg.mask, found);
            }
        }
        __syncthreads();
        // a pod row of the block's nodes at a time
        for (int t = threadIdx.x; t < kPodGroup * rows; t += blockDim.x) {
            const int i = t / rows, nd = blockIdx.x * rows + t % rows;
            if (!((mine >> i) & 1u) || nd >= a.n) continue;
            const size_t o = (size_t)(g0 + i) * a.n + nd;
            a.feasible[o] = s_fe[t];
            a.min_k[o] = s_mk[t];
            if (a.viol_k != nullptr) a.viol_k[o] = s_vk[t];
        }
    }
}

// The resident warps the card holds of this kernel with `a.g` lanes a
// row: SMs x blocks an SM (registers and shared memory) x the block's warps.
int warp_slots(Args a, int warps)
{
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dry_run_kernel, warps * 32,
                                                  smem_bytes(a, warps));
    return max(1, sms * max(blocks, 1) * warps);
}

// The lanes a row takes in a launch of a.l_dim x a.n rows: the widest
// (at most a warp, at least kMinLanes) that keeps every row's lanes in
// one wave of resident warps (8 warps a block).
int row_lanes(Args a)
{
    const long long rows = (long long)a.l_dim * a.n;
    for (a.g = 32; a.g > kMinLanes; a.g /= 2) {
        if (rows * a.g <= 32LL * warp_slots(a, kMaxWarps)) break;
    }
    return a.g;
}

}  // namespace

// One dry run: the batched entry (perm, elig_len, viol, pod_level; valid
// null) or the victims entry (valid; L = P = 1, the rest null).
extern "C" int preempt_dry_run_launch(const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    a.l_dim = ints[kI_L];
    a.n = ints[kI_N];
    a.k = ints[kI_K];
    a.r = ints[kI_R];
    a.p = ints[kI_P];
    a.free = (const float*)ptrs[kP_FREE];
    a.victim_req = (const float*)ptrs[kP_VICTIM_REQ];
    a.perm = (const int32_t*)ptrs[kP_PERM];
    a.elig_len = (const int32_t*)ptrs[kP_ELIG_LEN];
    a.valid = (const uint8_t*)ptrs[kP_VALID];
    a.viol = (const uint8_t*)ptrs[kP_VIOL];
    a.pods_req = (const float*)ptrs[kP_PODS_REQ];
    a.pod_level = (const int32_t*)ptrs[kP_POD_LEVEL];
    a.feasible = (uint8_t*)ptrs[kP_FEASIBLE];
    a.min_k = (int32_t*)ptrs[kP_MIN_K];
    a.viol_k = (int32_t*)ptrs[kP_VIOL_K];
    const bool victims = a.valid != nullptr;
    if (a.k < 1 || a.k > kMaxK || a.r < 1 || a.l_dim < 1 || a.l_dim > 65535
        || victims == (a.perm != nullptr) || (!victims && a.elig_len == nullptr))
        return (int)cudaErrorInvalidValue;
    if (a.n == 0 || a.p == 0) return 0;
    a.kc = min(kChunk, (a.k + kScanBlock - 1) / kScanBlock * kScanBlock);
    a.stride = a.kc + a.kc / kScanBlock;
    a.nb = a.kc / kScanBlock;
    a.g = row_lanes(a);
    int warps = kMaxWarps;
    while (warps > 1 && smem_bytes(a, warps) > kSmemCap) warps /= 2;
    const int smem = smem_bytes(a, warps);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            dry_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const int block_rows = warps * (32 / a.g);
    const dim3 grid((unsigned)((a.n + block_rows - 1) / block_rows), (unsigned)a.l_dim);
    dry_run_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The launch layout the bindings check on load: 0 the ints, 1 the
// pointers, 2 the widest victim axis, 3 the chunk, 4 the pod group.
extern "C" int preempt_dry_run_layout(int which)
{
    switch (which) {
        case 0: return kI_COUNT;
        case 1: return kP_COUNT;
        case 2: return kMaxK;
        case 3: return kChunk;
        case 4: return kPodGroup;
        default: return -1;
    }
}

// The lanes a row takes in a launch of L x N rows of K slots and R
// resources.
extern "C" int preempt_dry_run_lanes(int l, int n, int k, int r)
{
    Args a = {};
    a.l_dim = l;
    a.n = n;
    a.k = k;
    a.r = r;
    a.kc = min(kChunk, (k + kScanBlock - 1) / kScanBlock * kScanBlock);
    a.stride = a.kc + a.kc / kScanBlock;
    a.nb = a.kc / kScanBlock;
    return row_lanes(a);
}

extern "C" const char* preempt_dry_run_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
