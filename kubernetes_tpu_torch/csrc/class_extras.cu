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
// Only the terms that can change a sum are read.  counts_dom and
// ownerw_dom are finite: integer counts of bound pods and sums of their
// integer term weights (family_prep's pref entry, interpod.py:220).  So a
// term the reference multiplies by 0 (a pod_idx < 0 slot's weight, a row
// the pod does not match) is +0 or -0, and so is an image term of a node
// without the image or of an empty slot; each sum starts at +0 and no sum
// of these terms is ever -0 (x + -x is +0 under round-to-nearest), so
// adding such a term changes nothing.  The "own" sum reads the pod's
// pod_idx >= 0 rows, the "theirs" sum the rows its matches_incoming names
// (listed once a pair, in row order), the image sum the pod's images the
// node holds (in slot order).
//
// Bound on this card: per pair, its feasible row (with preferred terms) and
// its output row; the preferred rows it names, the image words of its images
// and the node validity once.  Microseconds at the card's memory rate for
// the shapes of the main path.
//
// Design: a grid of thread-block clusters (cluster_common.cuh
// launch_clusters; G and the cluster count by extras_shape), each cluster a
// contiguous range of the pairs, each of its G blocks the 32-node chunks q
// with q % G == rank.
//   Images, once a cluster: the images its pairs name (a bitmap; their
//   compact index is their rank in it), read with the pairs' slots, sizes
//   and clamps into the pair tables in shared memory; then one node pass
//   counts the valid nodes and, per named image, the valid nodes holding
//   it (warp ballots; each block's counts pulled from every block through
//   DSMEM after one cluster barrier), and every thread keeps a presence
//   mask of the named images for its first kKeep nodes.  The tables are
//   finished from shared memory alone: each slot's scaled size, and for a
//   pair with at most kLutSlots images its weighted image term for every
//   subset of them.
//   Pairs: with preferred terms, pair by pair, the raw row computed once
//   (kept in registers for the first kKeep nodes of a thread) and its
//   feasible max / min merged over the cluster through DSMEM (one barrier a
//   pair, two slot buffers); with images alone, each thread walks its nodes
//   and writes kPairUnroll pairs at a time from their tables.  The output
//   is written once.
// Every merge is order-free (fmaxf / fminf, integer counts), so any
// partition of the nodes and the pairs gives the same bits.

#include "cluster_common.cuh"

using namespace solve;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxMI = 16;              // images per pod
constexpr int kKeep = 8;                // nodes a thread keeps in registers
constexpr int kMaskImages = 64;         // named images a presence mask holds
constexpr int kMaskWords = 2;           // named image words the count pass loads ahead
constexpr int kPairChunkMax = 256;      // pairs whose image tables are staged at once
constexpr int kLutSlots = 5;            // a pair's image terms tabled up to 2^5 subsets
constexpr int kPairUnroll = 4;          // image-only pairs written together
constexpr int kWarps = kThreads / 32;
constexpr float kImgMin = 24117248.0f;  // 23 MB, image_locality.go minThreshold
constexpr float kImgMaxPerContainer = 1048576000.0f;  // 1000 MB
constexpr float kBig = 1e30f;

struct Args {
    int n, c_dim, p, pref_on, img_on;
    float w_pref, w_img;
    const int32_t* reps;          // [C]
    const uint8_t* feas;          // [C, N]
    int u_dim, ma;
    const float* counts_dom;      // [U, N]
    const float* ownerw_dom;      // [U, N]
    const int32_t* pref_idx;      // [P, MA]
    const float* pref_weight;     // [P, MA]
    const uint8_t* pref_matches;  // [P, U]
    int iw, i_dim, mi;
    const uint32_t* image_bits;   // [N, IW]
    const uint8_t* node_valid;    // [N]
    const float* sizes;           // [I]
    const int32_t* pod_ids;       // [P, MI]
    const float* n_containers;    // [P]
    float* out;                   // [C, N]
    int chunk;                    // pairs a staging of image tables holds
};

// One pair's image tables: per slot the compact index of its image (-1 an
// empty slot), the image id and its scaled size; the upper clamp, whether
// any slot is set; and for a pair with at most kLutSlots set slots (in a
// cluster whose named images fit a presence mask) its weighted image term
// for every subset of those slots (`lut`, bit t the t-th set slot in slot
// order) with the set slots' compact indices, 6 bits each (`lut_ks`);
// lut_n is their count, -1 without a table.
struct PairRow {
    int k[kMaxMI];
    int idc[kMaxMI];
    float scaled[kMaxMI];
    float lut[1 << kLutSlots];
    float hi;
    int any, lut_n;
    unsigned lut_ks;
};

// The dynamic shared memory, in words: with images the named-image bitmap
// and its word prefix ([IW] each), this block's counts and the cluster's
// ([I + 1] each: a compact index an image, then the valid nodes), and the
// pair tables ([chunk] PairRow); with preferred terms the pair's own rows
// and weights ([MA] each) and its listed matched rows ([U]).
struct Layout {
    int named, prefix, mine, all, tab, own_row, own_w, theirs, words;
};

__host__ __device__ inline Layout layout_of(int img_on, int iw, int i_dim, int chunk,
                                            int pref_on, int ma, int u_dim)
{
    Layout l;
    int at = 0;
    l.named = at;
    at += img_on ? iw : 0;
    l.prefix = at;
    at += img_on ? iw : 0;
    l.mine = at;
    at += img_on ? i_dim + 1 : 0;
    l.all = at;
    at += img_on ? i_dim + 1 : 0;
    at = (at + 3) & ~3;   // 16-byte rows
    l.tab = at;
    at += img_on ? chunk * (int)(sizeof(PairRow) / sizeof(int)) : 0;
    l.own_row = at;
    at += pref_on ? ma : 0;
    l.own_w = at;
    at += pref_on ? ma : 0;
    l.theirs = at;
    at += pref_on ? u_dim : 0;
    l.words = at;
    return l;
}

struct Shared {
    float mx[2][kMaxCluster], mn[2][kMaxCluster];   // the pairs' exchange slots
    float wmx[kWarps], wmn[kWarps];
    int n_own, n_theirs, n_named, n_words;
    int words[kMaskWords];   // the named bitmap's first nonzero words
};

__device__ __forceinline__ bool node_has(const Args& a, int nd, int idc)
{
    return (a.image_bits[(size_t)nd * a.iw + (idc >> 5)] >> (idc & 31)) & 1u;
}

// The ballots of one named word for the warp's 32 nodes: each named image's
// valid holders into this block's counts (compact index from k); sets the
// lane's presence bits in m.
__device__ __forceinline__ void count_word(uint32_t word, unsigned nm, int k, bool valid,
                                           int* mine, uint64_t& m)
{
    const int lane = threadIdx.x & 31;
    while (nm) {
        const int b = __ffs(nm) - 1;
        nm &= nm - 1;
        const bool has = (word >> b) & 1u;
        const unsigned bh = __ballot_sync(0xffffffffu, valid && has);
        if (lane == 0 && bh) atomicAdd(&mine[k], __popc(bh));
        if (has && k < kMaskImages) m |= 1ull << k;
        ++k;
    }
}

// The node pass of the image counts for the warp's 32 nodes from `base`
// (warp-uniform), every named word: the valid nodes and each named image's
// valid holders into this block's counts; returns this lane's node's
// presence mask of the named images (compact index k: bit k).
__device__ inline uint64_t count_node(const Args& a, int base, const uint32_t* named,
                                      const int* prefix, int* mine, int n_named)
{
    if (base >= a.n) return 0;
    const int lane = threadIdx.x & 31;
    const int nd = base + lane;
    const bool in = nd < a.n;
    const bool valid = in && a.node_valid[nd];
    const unsigned bv = __ballot_sync(0xffffffffu, valid);
    if (lane == 0 && bv) atomicAdd(&mine[n_named], __popc(bv));
    uint64_t m = 0;
    for (int w = 0; w < a.iw; ++w) {
        const unsigned nm = named[w];
        if (nm) count_word(in ? a.image_bits[(size_t)nd * a.iw + w] : 0u, nm, prefix[w], valid,
                           mine, m);
    }
    return m;
}

// The raw preferred score at node nd over the listed rows, in row order.
__device__ __forceinline__ float pref_raw(const Args& a, int nd, const int* own_row,
                                          const float* own_w, int n_own, const int* theirs,
                                          int n_theirs)
{
    float own = 0.0f;
    for (int j = 0; j < n_own; ++j) {
        own = add(own, mul(own_w[j], a.counts_dom[(size_t)own_row[j] * a.n + nd]));
    }
    float th = 0.0f;
    for (int t = 0; t < n_theirs; ++t) th = add(th, a.ownerw_dom[(size_t)theirs[t] * a.n + nd]);
    return add(own, th);
}

// ImageLocality's score from the raw sum of the held images' scaled sizes.
__device__ __forceinline__ float image_of_raw(float raw, float hi)
{
    const float lo = kImgMin;
    return floorf(dv(mul(kMaxNodeScore, sub(fminf(fmaxf(raw, lo), hi), lo)), sub(hi, lo)));
}

// The pair's weighted ImageLocality term at node nd: from its table and
// the node's presence mask (`kept`: the mask holds the node), else summed
// from the node's presence mask or, without one, its image words.
__device__ __forceinline__ float image_term(const Args& a, const PairRow& row, int nd,
                                            uint64_t mask, bool kept)
{
    const int ln = row.lut_n;
    if (kept && ln >= 0) {
        const unsigned ks = row.lut_ks;
        int sub_idx = 0;
#pragma unroll
        for (int t = 0; t < kLutSlots; ++t) {
            if (t < ln) sub_idx |= (int)((mask >> ((ks >> (6 * t)) & 63u)) & 1ull) << t;
        }
        return row.lut[sub_idx];
    }
    if (!row.any) return mul(a.w_img, 0.0f);
    float raw = 0.0f;
    for (int j = 0; j < a.mi; ++j) {
        const int k = row.k[j];
        if (k < 0) continue;
        const bool has = kept ? ((mask >> k) & 1ull) != 0 : node_has(a, nd, row.idc[j]);
        if (has) raw = add(raw, row.scaled[j]);
    }
    return mul(a.w_img, image_of_raw(raw, row.hi));
}

// The pair's preferred score at a node from its raw value.
__device__ __forceinline__ float pref_score(float raw, bool feasible, float mn, float span)
{
    const float s = span > 0.0f
        ? floorf(dv(mul(kMaxNodeScore, sub(raw, mn)), fmaxf(span, 1e-30f)))
        : 0.0f;
    return feasible ? s : 0.0f;
}

// Pairs [cb, ce)'s slot entries: each slot's image id (-1 empty), its size
// and, for slot 0, the pair's upper clamp (the loads of the staging).
__device__ __forceinline__ void load_slots(const Args& a, PairRow* tab, int cb, int ce)
{
    for (int e = threadIdx.x; e < (ce - cb) * a.mi; e += kThreads) {
        const int q = e / a.mi, j = e % a.mi;
        const int rep = min(max(a.reps[cb + q], 0), a.p - 1);
        const int id = a.pod_ids[(size_t)rep * a.mi + j];
        const int idc = min(max(id, 0), a.i_dim - 1);
        tab[q].idc[j] = id >= 0 ? idc : -1;
        tab[q].scaled[j] = id >= 0 ? a.sizes[idc] : 0.0f;
        if (j == 0) tab[q].hi = mul(kImgMaxPerContainer, fmaxf(a.n_containers[rep], 1.0f));
    }
}

// The rest of the staging, from shared memory alone: each slot's compact
// index and scaled size, each pair's set slots and table.  Begins and ends
// on a block barrier.
__device__ inline void finish_tables(const Args& a, PairRow* tab, int n_pairs,
                                     const uint32_t* named, const int* prefix, const int* all,
                                     float nv, bool mask_ok)
{
    __syncthreads();
    for (int e = threadIdx.x; e < n_pairs * a.mi; e += kThreads) {
        const int q = e / a.mi, j = e % a.mi;
        const int idc = tab[q].idc[j];
        int k = -1;
        if (idc >= 0) {
            const int w = idc >> 5, b = idc & 31;
            k = prefix[w] + __popc(named[w] & ((1u << b) - 1u));
            tab[q].scaled[j] = dv(mul(tab[q].scaled[j], (float)all[k]), nv);
        }
        tab[q].k[j] = k;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < n_pairs; q += kThreads) {
        int set = 0;
        unsigned ks = 0;
        for (int j = 0; j < a.mi; ++j) {
            const int k = tab[q].k[j];
            if (k < 0) continue;
            if (set < kLutSlots) ks |= (unsigned)k << (6 * set);
            ++set;
        }
        tab[q].any = set > 0;
        tab[q].lut_n = mask_ok && set <= kLutSlots ? set : -1;
        tab[q].lut_ks = ks;
    }
    __syncthreads();
    // each table: the weighted term of every subset of the set slots, the
    // held slots' sizes added in slot order
    for (int e = threadIdx.x; e < n_pairs << kLutSlots; e += kThreads) {
        const int q = e >> kLutSlots, sub_idx = e & ((1 << kLutSlots) - 1);
        const int ln = tab[q].lut_n;
        if (ln < 0 || sub_idx >= (1 << ln)) continue;
        float raw = 0.0f;
        int t = 0;
        for (int j = 0; j < a.mi; ++j) {
            if (tab[q].k[j] < 0) continue;
            if ((sub_idx >> t) & 1) raw = add(raw, tab[q].scaled[j]);
            ++t;
        }
        tab[q].lut[sub_idx] = mul(a.w_img, ln > 0 ? image_of_raw(raw, tab[q].hi) : 0.0f);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) class_extras_kernel(Args a)
{
    extern __shared__ __align__(16) int dyn[];
    __shared__ Shared sh;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), g_dim = (int)cluster.num_blocks();
    const int k_clu = (int)blockIdx.x / g_dim, n_clu = (int)gridDim.x / g_dim;
    const int c0 = (int)((long long)a.c_dim * k_clu / n_clu);
    const int c1 = (int)((long long)a.c_dim * (k_clu + 1) / n_clu);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int first = (rank + g_dim * warp) * 32 + lane;   // cluster_common.cuh block_of
    const int stride = g_dim * kThreads;
    const Layout l = layout_of(a.img_on, a.iw, a.i_dim, a.chunk, a.pref_on, a.ma, a.u_dim);
    uint32_t* named = (uint32_t*)(dyn + l.named);
    int* prefix = dyn + l.prefix;
    int* mine = dyn + l.mine;
    int* all = dyn + l.all;
    PairRow* tab = (PairRow*)(dyn + l.tab);

    // ---- the image counts: once a cluster, for the images its pairs name
    uint64_t mask[kKeep];
#pragma unroll
    for (int it = 0; it < kKeep; ++it) mask[it] = 0;
    bool mask_ok = false;
    float nv = 1.0f;
    // the cluster's pairs staged with the named images when they fit
    const bool staged = a.img_on && c1 - c0 <= a.chunk;
    // the kept nodes' validity and first kMaskWords image words, loaded
    // before the named images are known (the interned ids are dense from 0,
    // so a batch's images mostly sit in the first words)
    // (raw values: the loads are waited for where they are first used)
    uint8_t valid[kKeep];
    uint32_t word[kKeep][kMaskWords];
    if (a.img_on) {
#pragma unroll
        for (int it = 0; it < kKeep; ++it) {
            const int nd = first + it * stride;
            valid[it] = 0;
            if (nd < a.n) valid[it] = a.node_valid[nd];
#pragma unroll
            for (int v = 0; v < kMaskWords; ++v) {
                word[it][v] = 0u;
                if (nd < a.n && v < a.iw) word[it][v] = a.image_bits[(size_t)nd * a.iw + v];
            }
        }
        for (int w = tid; w < a.iw; w += kThreads) named[w] = 0;
        for (int t = tid; t <= a.i_dim; t += kThreads) mine[t] = all[t] = 0;
        __syncthreads();
        if (staged) load_slots(a, tab, c0, c1);
        for (int e = tid; e < (c1 - c0) * a.mi; e += kThreads) {
            int idc;
            if (staged) {
                idc = tab[e / a.mi].idc[e % a.mi];   // this thread's own entry
            } else {
                const int rep = min(max(a.reps[c0 + e / a.mi], 0), a.p - 1);
                const int id = a.pod_ids[(size_t)rep * a.mi + e % a.mi];
                idc = id >= 0 ? min(id, a.i_dim - 1) : -1;
            }
            if (idc >= 0) atomicOr(&named[idc >> 5], 1u << (idc & 31));
        }
        __syncthreads();
        if (tid == 0) {
            int acc = 0, nw = 0;
            for (int w = 0; w < a.iw; ++w) {
                prefix[w] = acc;
                acc += __popc(named[w]);
                if (named[w]) {
                    if (nw < kMaskWords) sh.words[nw] = w;
                    ++nw;
                }
            }
            sh.n_named = acc;
            sh.n_words = nw;
        }
        __syncthreads();
        const int n_named = sh.n_named;
        mask_ok = n_named <= kMaskImages;
        if (sh.n_words <= kMaskWords) {
            // the kept nodes' named words (those loaded ahead where they
            // are the named ones), then their ballots
            const int nw = sh.n_words;
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                const int nd = first + it * stride;
#pragma unroll
                for (int v = 0; v < kMaskWords; ++v) {
                    if (nd < a.n && v < nw && sh.words[v] != v) {
                        word[it][v] = a.image_bits[(size_t)nd * a.iw + sh.words[v]];
                    }
                }
            }
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                if (first - lane + it * stride >= a.n) continue;   // warp-uniform
                const unsigned bv = __ballot_sync(0xffffffffu, valid[it] != 0);
                if (lane == 0 && bv) atomicAdd(&mine[n_named], __popc(bv));
#pragma unroll
                for (int v = 0; v < kMaskWords; ++v) {
                    if (v < nw) {
                        const int w = sh.words[v];
                        count_word(word[it][v], named[w], prefix[w], valid[it] != 0, mine,
                                   mask[it]);
                    }
                }
            }
        } else {
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                mask[it] = count_node(a, first - lane + it * stride, named, prefix, mine, n_named);
            }
        }
        for (int base = first - lane + kKeep * stride; base < a.n; base += stride) {
            count_node(a, base, named, prefix, mine, n_named);
        }
        cluster.sync();
        // the cluster's counts: every block's pulled through DSMEM
        for (int e = tid; e < (n_named + 1) * g_dim; e += kThreads) {
            const int v = *cluster.map_shared_rank(&mine[e / g_dim], e % g_dim);
            if (v) atomicAdd(&all[e / g_dim], v);
        }
        __syncthreads();
        nv = (float)max(all[n_named], 1);
        // no block reads another's shared memory after its pull but
        // through the pairs' exchanges; without them the launch's last
        // barrier keeps every block until every pull is done (the pulled
        // values are used above: nothing to order, so a relaxed arrive)
        if (!a.pref_on) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    }

    const int* own_row = dyn + l.own_row;
    const float* own_w = (const float*)(dyn + l.own_w);
    const int* theirs = dyn + l.theirs;
    int par = 0;
    for (int cb = c0; cb < c1; cb += a.chunk) {
        const int ce = min(cb + a.chunk, c1);
        if (a.img_on) {
            if (!staged) {
                __syncthreads();   // the last chunk's tables are read
                load_slots(a, tab, cb, ce);
            }
            finish_tables(a, tab, ce - cb, named, prefix, all, nv, mask_ok);
        }
        if (!a.pref_on && !a.img_on) {   // neither family: zero rows
            for (int c = cb; c < ce; ++c) {
                for (int nd = first; nd < a.n; nd += stride) a.out[(size_t)c * a.n + nd] = 0.0f;
            }
            continue;
        }
        if (!a.pref_on) {
            // images alone: a thread's nodes in turn, kPairUnroll pairs at once
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                const int nd = first + it * stride;
                if (nd >= a.n) continue;
                float* col = a.out + nd;
                int c = cb;
                for (; c + kPairUnroll <= ce; c += kPairUnroll) {
                    float v[kPairUnroll];
#pragma unroll
                    for (int u = 0; u < kPairUnroll; ++u) {
                        v[u] = add(0.0f, image_term(a, tab[c + u - cb], nd, mask[it], mask_ok));
                    }
#pragma unroll
                    for (int u = 0; u < kPairUnroll; ++u) col[(size_t)(c + u) * a.n] = v[u];
                }
                for (; c < ce; ++c) {
                    col[(size_t)c * a.n] = add(0.0f, image_term(a, tab[c - cb], nd, mask[it],
                                                                mask_ok));
                }
            }
            for (int nd = first + kKeep * stride; nd < a.n; nd += stride) {
                for (int c = cb; c < ce; ++c) {
                    a.out[(size_t)c * a.n + nd] = add(0.0f, image_term(a, tab[c - cb], nd, 0,
                                                                       false));
                }
            }
            continue;
        }
        for (int c = cb; c < ce; ++c) {
            const int rep = min(max(a.reps[c], 0), a.p - 1);
            const uint8_t* frow = a.feas + (size_t)c * a.n;
            float* orow = a.out + (size_t)c * a.n;
            // the kept nodes' feasibility, loaded while the rows are listed
            uint32_t fbits = 0;
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                const int nd = first + it * stride;
                if (nd < a.n && frow[nd]) fbits |= 1u << it;
            }
            __syncthreads();   // the last pair's lists are read
            if (warp == 0) {
                // the pod's own rows (pod_idx >= 0), listed in slot order
                int k = 0;
                for (int j0 = 0; j0 < a.ma; j0 += 32) {
                    const int j = j0 + lane;
                    const int idx = j < a.ma ? a.pref_idx[(size_t)rep * a.ma + j] : -1;
                    const float w = j < a.ma ? a.pref_weight[(size_t)rep * a.ma + j] : 0.0f;
                    const unsigned bo = __ballot_sync(0xffffffffu, idx >= 0);
                    if (idx >= 0) {
                        const int at = k + __popc(bo & ((1u << lane) - 1u));
                        ((int*)own_row)[at] = min(idx, a.u_dim - 1);
                        ((float*)own_w)[at] = w;
                    }
                    k += __popc(bo);
                }
                if (lane == 0) sh.n_own = k;
            }
            if (warp == kWarps - 1) {
                // the matched rows, listed in row order
                const uint8_t* mrow = a.pref_matches + (size_t)rep * a.u_dim;
                int k = 0;
                for (int u0 = 0; u0 < a.u_dim; u0 += 32) {
                    const bool m = u0 + lane < a.u_dim && mrow[u0 + lane];
                    const unsigned bm = __ballot_sync(0xffffffffu, m);
                    if (m) ((int*)theirs)[k + __popc(bm & ((1u << lane) - 1u))] = u0 + lane;
                    k += __popc(bm);
                }
                if (lane == 0) sh.n_theirs = k;
            }
            __syncthreads();
            const int n_own = sh.n_own, n_th = sh.n_theirs;
            float keep[kKeep];
            float mx = -kBig, mn = kBig;
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                const int nd = first + it * stride;
                keep[it] = 0.0f;
                if (nd < a.n) {
                    const float raw = pref_raw(a, nd, own_row, own_w, n_own, theirs, n_th);
                    keep[it] = raw;
                    if ((fbits >> it) & 1u) {
                        mx = fmaxf(mx, raw);
                        mn = fminf(mn, raw);
                    }
                }
            }
            for (int nd = first + kKeep * stride; nd < a.n; nd += stride) {
                if (!frow[nd]) continue;
                const float raw = pref_raw(a, nd, own_row, own_w, n_own, theirs, n_th);
                mx = fmaxf(mx, raw);
                mn = fminf(mn, raw);
            }
            // the feasible max / min over the cluster
            for (int off = 16; off; off >>= 1) {
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
            }
            if (lane == 0) {
                sh.wmx[warp] = mx;
                sh.wmn[warp] = mn;
            }
            __syncthreads();
            if (tid < g_dim) {
                float bx = -kBig, bn = kBig;
                for (int w = 0; w < kWarps; ++w) {
                    bx = fmaxf(bx, sh.wmx[w]);
                    bn = fminf(bn, sh.wmn[w]);
                }
                *cluster.map_shared_rank(&sh.mx[par][rank], tid) = bx;
                *cluster.map_shared_rank(&sh.mn[par][rank], tid) = bn;
            }
            cluster.sync();
            mx = -kBig;
            mn = kBig;
            for (int b = 0; b < g_dim; ++b) {
                mx = fmaxf(mx, sh.mx[par][b]);
                mn = fminf(mn, sh.mn[par][b]);
            }
            par ^= 1;
            const float span = sub(mx, mn);
            // the output row, written once
#pragma unroll
            for (int it = 0; it < kKeep; ++it) {
                const int nd = first + it * stride;
                if (nd < a.n) {
                    float v = add(0.0f, mul(a.w_pref, pref_score(keep[it], (fbits >> it) & 1u,
                                                                 mn, span)));
                    if (a.img_on) v = add(v, image_term(a, tab[c - cb], nd, mask[it], mask_ok));
                    orow[nd] = v;
                }
            }
            for (int nd = first + kKeep * stride; nd < a.n; nd += stride) {
                const float raw = pref_raw(a, nd, own_row, own_w, sh.n_own, theirs, sh.n_theirs);
                float v = add(0.0f, mul(a.w_pref, pref_score(raw, frow[nd] != 0, mn, span)));
                if (a.img_on) v = add(v, image_term(a, tab[c - cb], nd, 0, false));
                orow[nd] = v;
            }
        }
    }
    if (a.img_on && !a.pref_on) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The launch: clusters of G blocks, G a power of two up to about one node a
// thread (at most 16), and as many clusters as pairs or as the card holds
// at once, whichever is fewer.  Of these shapes, the largest G that keeps
// at least 90 % as many SMs busy as the best one (a larger G counts the
// images fewer times, and gives each block fewer nodes).  Returns the
// error of the first refused shape.
cudaError_t extras_shape(int n, int c_dim, int smem, Shape* shape, int* clusters)
{
    int most = (n + kThreads - 1) / kThreads;
    most = most < 1 ? 1 : (most > kMaxCluster ? kMaxCluster : most);
    Shape cand[8];
    int count[8], used[8], n_cand = 0, best = 0;
    for (int g = 1; n_cand < 8; g *= 2) {
        const int blocks = g * 2 > most ? most : g;
        const Shape sh = {kThreads, blocks};
        int capacity = 0;
        const cudaError_t err = prepare_cluster(class_extras_kernel, sh, smem, &capacity);
        if (err != cudaSuccess) return err;
        cand[n_cand] = sh;
        count[n_cand] = c_dim < capacity ? c_dim : capacity;
        used[n_cand] = count[n_cand] * blocks;
        best = used[n_cand] > best ? used[n_cand] : best;
        ++n_cand;
        if (blocks == most) break;
    }
    for (int k = n_cand - 1; k >= 0; --k) {
        if (used[k] * 10 >= best * 9) {
            *shape = cand[k];
            *clusters = count[k];
            break;
        }
    }
    return cudaSuccess;
}

// The dynamic shared memory bytes of a launch.
int smem_of(int n_pairs, int img_on, int iw, int i_dim, int pref_on, int ma, int u_dim)
{
    const int chunk = n_pairs < kPairChunkMax ? n_pairs : kPairChunkMax;
    return layout_of(img_on, iw, i_dim, chunk, pref_on, ma, u_dim).words * (int)sizeof(int);
}

}  // namespace

extern "C" int class_extras_limits() { return kMaxMI; }

extern "C" int class_extras_launch(
    int n, int c_dim, int p, int pref_on, int img_on, float w_pref, float w_img,
    const void* reps, const void* feas, int u_dim, int ma, const void* counts_dom,
    const void* ownerw_dom, const void* pref_idx, const void* pref_weight,
    const void* pref_matches, int iw, int i_dim, int mi, const void* image_bits,
    const void* node_valid, const void* sizes, const void* pod_ids,
    const void* n_containers, void* out, void* stream)
{
    if ((img_on && (mi < 1 || mi > kMaxMI || i_dim < 1 || iw * 32 < i_dim))
        || (pref_on && (u_dim < 1 || ma < 1))) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0 || c_dim == 0 || p == 0) return 0;
    const int smem = smem_of(c_dim, img_on, iw, i_dim, pref_on, ma, u_dim);
    if (smem > 160 * 1024) return (int)cudaErrorInvalidValue;
    Args a = {n, c_dim, p, pref_on, img_on, w_pref, w_img, (const int32_t*)reps,
              (const uint8_t*)feas, u_dim, ma, (const float*)counts_dom,
              (const float*)ownerw_dom, (const int32_t*)pref_idx, (const float*)pref_weight,
              (const uint8_t*)pref_matches, iw, i_dim, mi, (const uint32_t*)image_bits,
              (const uint8_t*)node_valid, (const float*)sizes, (const int32_t*)pod_ids,
              (const float*)n_containers, (float*)out,
              c_dim < kPairChunkMax ? c_dim : kPairChunkMax};
    Shape shape = {kThreads, 1};
    int clusters = 1;
    const cudaError_t err = extras_shape(n, c_dim, smem, &shape, &clusters);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_clusters(class_extras_kernel, shape, clusters, smem,
                                (cudaStream_t)stream, a);
}

// The launch shape at n nodes and c_dim pairs (img_on, iw, i_dim, pref_on,
// ma, u_dim as the launch's): what = 0 the blocks a cluster, 1 the
// clusters.  -1 on an error.
extern "C" int class_extras_shape(int what, int n, int c_dim, int img_on, int iw, int i_dim,
                                  int pref_on, int ma, int u_dim)
{
    Shape shape = {kThreads, 1};
    int clusters = 1;
    if (extras_shape(n, c_dim, smem_of(c_dim, img_on, iw, i_dim, pref_on, ma, u_dim), &shape,
                     &clusters) != cudaSuccess) {
        return -1;
    }
    return what == 0 ? shape.blocks : clusters;
}

extern "C" const char* class_extras_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
