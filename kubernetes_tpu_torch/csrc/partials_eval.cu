// Kernel `partials_eval`: one sync of the resident Filter/Score partials of
// the warm statics — a fresh store written from the old one in one launch,
// each entry either copied or evaluated from its slot's stored spec.
//
// Replaces: kubernetes_tpu/ops/partials.py:203 `eval_store`, :213
// `refresh_rows` and :232 `insert_slots` — each the vmap of `_eval_slot`
// (:97) over slots, on all columns, on the dirty columns (`take_rows`,
// :136) or for the missed slots (`take_specs`, :158), then a scatter into
// a new store — together with :249 `grow_store_cols` / :268
// `shrink_store_cols`, as the reference's `_delta` runs them in one sync
// (kubernetes_tpu/models/partials.py:503-565: grow and refresh the grown
// columns, insert the missed slots, refresh the dirty columns).  Each of
// those evaluates the same cluster, and an inserted slot's row is
// overwritten whole, so the sync equals one pass over the union:
//
//   new[g, n] = eval(g, n)    if there is no old store, g is a missed slot,
//                             n is a dirty column, or n >= old width
//   new[g, n] = old[g, n]     otherwise
//
// with eval(g, n), per slot g and column (node) n:
//
//   sel     = OR over g's valid selector terms of the AND of expressions
//             (match_terms over the slot's own rows), true without a
//             selector
//   sfeas   = node_valid & valid & name_ok & taints_ok & sel & ~port_clash
//   aff     = sum_j pref_weight[j] * (pref_valid[j] & match(pref row j))
//   taint   = untolerated PreferNoSchedule taints (0 under tol_all)
//
// Bound on this card: bytes.  The old store's copied entries are read once
// (9 bytes each) and the whole new store written once; each evaluated
// column's node row (label words and topology ids that the live
// expressions test, taint words, port words where a slot claims a port)
// is read once for all slots; the specs are a few KB a slot.  The selector
// and preferred tests are a few hundred integer tests a (slot, column)
// pair, under the card's integer rate at these sizes.
//
// Design: three kinds of block in one grid.
//  * Copy blocks, one a (slot, chunk of kCopyCols columns) of the old
//    width: a missed slot's block returns; the others build a bitmap of
//    the chunk's listed columns in shared memory (two binary searches in
//    the ascending column list) and copy every other entry of the chunk
//    from the old store, 16-byte vectors where both widths allow.
//  * Column tiles, one a run of 32 listed columns (gathered through the
//    column list) and a chunk of slots, for every slot but the
//    missed ones and for the columns below the old width.
//  * Node tiles, one a run of 32 contiguous columns and a chunk of slots:
//    the missed slots at every column, and every slot at the columns from
//    the old width up (the grown columns; every column when there is no
//    old store).
// A tile is up to kSlotChunk slots over the 32-node tile of
// statics_common.cuh (kFewSlots when the tiles are few, so a refresh of a
// few columns still spreads over the card's multiprocessors): the block stages
// its 32 columns' node rows and its slots' specs in shared memory in one
// round of independent loads (the label words the first time a row it
// evaluates reads labels, the port words when a slot claims a port), the
// node words transposed (a word's 32 nodes side by side) and the label
// rows padded, so a lane a node reads them without bank conflicts; each
// warp stages one listed table row (a slot's selector, or one of its MT
// preferred terms, as `Table` rows) and matches it with statics::
// match_row into a 32-bit word (a lane a node, a ballot); then a warp a
// slot and a lane a column writes sfeas, aff and taint: the static
// filters, the bound-port test and the PreferNoSchedule count of
// statics::static_feasible / prefer_taints on the transposed words, and
// statics::affinity_add (term order, __fadd_rn / __fmul_rn,
// --fmad=false).  The three kinds partition the store, so every entry is
// written exactly once; the old store is only read, and the fresh store
// is the launch's own allocation: a store a solve or a bookmark still
// holds never changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statics_common.cuh"

namespace {

constexpr int kCopyCols = 2048;   // columns a copy block
constexpr int kSlotChunk = 32;    // slots a tile block, at most (the launch takes 8 or 32)
constexpr int kFewSlots = 8;      // slots a tile block when the tiles are few: a warp a slot
constexpr int kMaxSlots = 1024;   // the slot bitmap's capacity (PartialsCache.MAX_SLOTS)

// The launch arguments: ints[kI_*] and ptrs[kP_*] (host arrays), in this
// order (partials_eval_layout gives the lengths, checked by the bindings).
enum {
    kI_N, kI_LW, kI_TK, kI_TW, kI_PW, kI_G, kI_T, kI_E, kI_K, kI_MT,
    kI_OLD_N, kI_M, kI_D, kI_VEC,
    kI_COUNT
};
enum {
    kP_NODE_VALID, kP_NODE_NAME, kP_LABEL_BITS, kP_TOPO_IDS, kP_TAINT_BITS, kP_NODE_PORTS,
    kP_VALID, kP_NAME_ID, kP_HAS_SEL, kP_SEL_IDS, kP_SEL_OP, kP_SEL_SLOT, kP_SEL_TV,
    kP_TOL_BITS, kP_TOL_ALL, kP_PORT_BITS,
    kP_PREF_IDS, kP_PREF_OP, kP_PREF_SLOT, kP_PREF_VALID, kP_PREF_WEIGHT,
    kP_OLD_SFEAS, kP_OLD_AFF, kP_OLD_TAINT, kP_SLOTS, kP_COLS,
    kP_SFEAS, kP_AFF, kP_TAINT,
    kP_COUNT
};

struct Args {
    int n, lw, tk, tw, pw, g, mt, old_n, m, d, vec;
    int copy_blocks, copy_per_slot, col_tiles, tile0, sc, col_chunks, node_chunks;
    const uint8_t* node_valid;   // [N]
    const int32_t* node_name;    // [N]
    const uint32_t* label;       // [N, LW]
    const int32_t* topo;         // [N, TK]
    const uint32_t* taint;       // [3, N, TW]
    const uint32_t* ports;       // [N, PW]
    const uint8_t* valid;        // [G]
    const int32_t* name;         // [G]
    const uint8_t* has_sel;      // [G]
    statics::Table sel;          // [G, T, E, K]: slot g's selector is row g
    statics::Table pref;         // [G * MT, 1, E, K]: slot g's term j is row g * MT + j
    const uint32_t* tol;         // [3, G, TW]
    const uint8_t* tol_all;      // [3, G]
    const uint32_t* port_bits;   // [G, PW]
    const float* pref_weight;    // [G, MT]
    const uint8_t* old_sfeas;    // [G, OLD_N]
    const float* old_aff;        // [G, OLD_N]
    const float* old_taint;      // [G, OLD_N]
    const int32_t* slots;        // [M] ascending: the missed slots
    const int32_t* cols;         // [D] ascending: every slot re-evaluated there
    uint8_t* sfeas;              // [G, N]
    float* aff;                  // [G, N]
    float* taint_out;            // [G, N]
};

// Dynamic shared memory of a tile, in this order (words, then bytes):
//   node side    label words [kTile, LW + 1] (rows padded), taint words
//                [3, TW, kTile] and port words [PW, kTile] (transposed),
//                topology ids [kTile, TK], name ids [kTile], the columns
//                [kTile]
//   slot chunk   the slots [kSlotChunk], their tolerations [3, kSlotChunk,
//                TW], port words [kSlotChunk, PW], name ids [kSlotChunk],
//                preferred weights [kSlotChunk, MT], match words
//                [kSlotChunk, 1 + MT], the missed-slot bitmap
//                [kMaxSlots / 32]
//   row buffers  one a warp: a table row's ids [T, E, K], ops and slots
//                [T, E] (the largest row: a selector's)
//   bytes        node valid [kTile]; per slot valid, has_sel, live
//                [kSlotChunk] each, tol_all [3, kSlotChunk], pref_valid
//                [kSlotChunk, MT]; the row list (u16) [kSlotChunk (1 + MT)];
//                the row buffers' term flags [kTileWarps, T]
// A copy block uses the front as its column bitmap [kCopyCols / 32] and the
// bounds of its listed columns [2].
struct Smem {
    int node_words, chunk_words, row_words;
};

__host__ __device__ inline Smem smem_layout(int lw, int tk, int tw, int pw, int mt, int t,
                                            int e, int k)
{
    Smem l;
    l.node_words = statics::kTile * (lw + 1 + 3 * tw + pw + tk + 2);
    l.chunk_words = kSlotChunk * (1 + 3 * tw + pw + 1 + mt + 1 + mt) + kMaxSlots / 32;
    l.row_words = t * e * (k + 2);
    return l;
}

int smem_bytes(int lw, int tk, int tw, int pw, int mt, int t, int e, int k)
{
    const Smem l = smem_layout(lw, tk, tw, pw, mt, t, e, k);
    const int words = l.node_words + l.chunk_words + statics::kTileWarps * l.row_words;
    const int bytes = statics::kTile + kSlotChunk * (3 + 3 + mt) + 2 * kSlotChunk * (1 + mt)
                      + statics::kTileWarps * t;
    const int tile = words * 4 + bytes;
    const int copy = kCopyCols / 8 + 8;   // the column bitmap and its two list bounds
    return tile > copy ? tile : copy;
}

// The first i in [0, n) with list[i] >= v (list ascending), by the calling
// warp: 32 probes a round, so log32(n) rounds of loads, not log2(n).
__device__ __forceinline__ int warp_first_at_least(const int32_t* list, int n, int v)
{
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;
    while (hi - lo > 32) {
        const int step = (hi - lo + 31) / 32;
        const int p = lo + lane * step;
        const unsigned below = __ballot_sync(0xffffffffu, p < hi && list[p] < v);
        const int c = __popc(below);
        if (c == 0) return lo;
        const int nlo = lo + (c - 1) * step + 1;
        hi = min(hi, lo + c * step);
        lo = nlo;
    }
    const unsigned below = __ballot_sync(0xffffffffu, lo + lane < hi && list[lo + lane] < v);
    return lo + __popc(below);
}

// Words i in [0, n) moved by load(i) -> store(i, w), UNR loads in flight a
// thread before their stores: the block's threads (Stride = blockDim.x)
// or one warp's lanes (32).  Loads of independent words, all issued at
// once: a tile's time is its rounds of dependent loads.
template <int UNR, bool Warp, typename Load, typename Store>
__device__ __forceinline__ void batched(int n, Load load, Store store)
{
    const int stride = Warp ? 32 : (int)blockDim.x;
    for (int i0 = Warp ? (threadIdx.x & 31) : threadIdx.x; i0 < n; i0 += UNR * stride) {
        uint32_t v[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = i0 + u * stride;
            v[u] = i < n ? load(i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = i0 + u * stride;
            if (i < n) store(i, v[u]);
        }
    }
}

__device__ __forceinline__ void copy_block(const Args& a, uint32_t* s_bits)
{
    __shared__ int s_j[2];
    const int slot = blockIdx.x / a.copy_per_slot;
    const int c0 = (blockIdx.x - slot * a.copy_per_slot) * kCopyCols;
    const int width = min(a.old_n, a.n);
    const int c1 = min(c0 + kCopyCols, width);
    const int warp = threadIdx.x >> 5;
    // warp 0: is the slot missed?  warps 1, 2: the listed columns in [c0, c1)
    if (warp == 0) {
        const int k = warp_first_at_least(a.slots, a.m, slot);
        if ((threadIdx.x & 31) == 0) s_j[0] = k < a.m && a.slots[k] == slot;
    }
    if (warp == 1 || warp == 2) {
        const int j = warp_first_at_least(a.cols, a.d, warp == 1 ? c0 : c1);
        if ((threadIdx.x & 31) == 0) s_bits[kCopyCols / 32 + warp - 1] = (uint32_t)j;
    }
    for (int i = threadIdx.x; i < kCopyCols / 32; i += blockDim.x) s_bits[i] = 0u;
    __syncthreads();
    if (s_j[0]) return;   // a missed slot: the node tiles write its row
    const int j0 = (int)s_bits[kCopyCols / 32], j1 = (int)s_bits[kCopyCols / 32 + 1];
    for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
        const int c = a.cols[j] - c0;
        atomicOr(&s_bits[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
    const size_t src = (size_t)slot * a.old_n + c0, dst = (size_t)slot * a.n + c0;
    if (a.vec && j0 == j1) {
        // no listed column in the chunk: whole 16-byte vectors, the three
        // leaves' loads in flight together
        const float4* oa = reinterpret_cast<const float4*>(a.old_aff + src);
        const float4* ot = reinterpret_cast<const float4*>(a.old_taint + src);
        const uint4* os = reinterpret_cast<const uint4*>(a.old_sfeas + src);
        float4* na = reinterpret_cast<float4*>(a.aff + dst);
        float4* nt = reinterpret_cast<float4*>(a.taint_out + dst);
        uint4* ns = reinterpret_cast<uint4*>(a.sfeas + dst);
        const int n4 = (c1 - c0) / 4, n16 = (c1 - c0) / 16, bd = blockDim.x;
        for (int q = threadIdx.x; q < n4; q += 2 * bd) {
            const int q2 = q + bd;
            const bool two = q2 < n4, vs = q < n16, vs2 = q2 < n16;
            const float4 a0 = oa[q], t0 = ot[q];
            const float4 a1 = two ? oa[q2] : a0, t1 = two ? ot[q2] : t0;
            const uint4 s0 = vs ? os[q] : uint4{}, s1 = vs2 ? os[q2] : uint4{};
            na[q] = a0;
            nt[q] = t0;
            if (two) {
                na[q2] = a1;
                nt[q2] = t1;
            }
            if (vs) ns[q] = s0;
            if (vs2) ns[q2] = s1;
        }
    } else if (a.vec) {
        // both widths are multiples of 16, so the chunk is whole vectors
        for (int q = threadIdx.x; q < (c1 - c0) / 4; q += blockDim.x) {
            const int c = 4 * q;
            const uint32_t bits = (s_bits[c >> 5] >> (c & 31)) & 0xFu;
            if (bits == 0u) {
                *reinterpret_cast<float4*>(a.aff + dst + c) =
                    *reinterpret_cast<const float4*>(a.old_aff + src + c);
                *reinterpret_cast<float4*>(a.taint_out + dst + c) =
                    *reinterpret_cast<const float4*>(a.old_taint + src + c);
            } else if (bits != 0xFu) {
                for (int i = 0; i < 4; ++i) {
                    if (!((bits >> i) & 1u)) {
                        a.aff[dst + c + i] = a.old_aff[src + c + i];
                        a.taint_out[dst + c + i] = a.old_taint[src + c + i];
                    }
                }
            }
        }
        for (int q = threadIdx.x; q < (c1 - c0) / 16; q += blockDim.x) {
            const int c = 16 * q;
            const uint32_t bits = (s_bits[c >> 5] >> (c & 31)) & 0xFFFFu;
            if (bits == 0u) {
                *reinterpret_cast<uint4*>(a.sfeas + dst + c) =
                    *reinterpret_cast<const uint4*>(a.old_sfeas + src + c);
            } else if (bits != 0xFFFFu) {
                for (int i = 0; i < 16; ++i) {
                    if (!((bits >> i) & 1u)) a.sfeas[dst + c + i] = a.old_sfeas[src + c + i];
                }
            }
        }
    } else {
        for (int c = threadIdx.x; c < c1 - c0; c += blockDim.x) {
            if ((s_bits[c >> 5] >> (c & 31)) & 1u) continue;
            a.sfeas[dst + c] = a.old_sfeas[src + c];
            a.aff[dst + c] = a.old_aff[src + c];
            a.taint_out[dst + c] = a.old_taint[src + c];
        }
    }
}

// The shared-memory arrays of a tile (smem_layout's order).
struct TileSmem {
    uint32_t* label;     // [kTile, LW + 1]
    uint32_t* taint;     // [3, TW, kTile]
    uint32_t* ports;     // [PW, kTile]
    int32_t* topo;       // [kTile, TK]
    int32_t* name;       // [kTile]
    int32_t* col;        // [kTile]
    int32_t* slot;       // [SC]
    uint32_t* tol;       // [3, SC, TW]
    uint32_t* pport;     // [SC, PW]
    int32_t* sname;      // [SC]
    float* pw;           // [SC, MT]
    uint32_t* word;      // [SC, 1 + MT]
    uint32_t* miss;      // [kMaxSlots / 32]
    int32_t* rows;       // [warps, T E (K + 2)]
    uint8_t* valid;      // [kTile]
    uint8_t* sv;         // [SC]
    uint8_t* hsel;       // [SC]
    uint8_t* live;       // [SC]
    uint8_t* tolall;     // [3, SC]
    uint8_t* pv;         // [SC, MT]
    uint16_t* list;      // [SC (1 + MT)]
    uint8_t* tv;         // [warps, T]
};

__device__ inline TileSmem tile_smem(const Args& a, uint32_t* smem)
{
    using statics::kTile;
    const int T = a.sel.t, E = a.sel.e, K = a.sel.k, MT = a.mt;
    const Smem l = smem_layout(a.lw, a.tk, a.tw, a.pw, MT, T, E, K);
    TileSmem t;
    t.label = smem;
    t.taint = t.label + kTile * (a.lw + 1);
    t.ports = t.taint + 3 * kTile * a.tw;
    t.topo = (int32_t*)(t.ports + kTile * a.pw);
    t.name = t.topo + kTile * a.tk;
    t.col = t.name + kTile;
    t.slot = (int32_t*)smem + l.node_words;
    t.tol = (uint32_t*)(t.slot + kSlotChunk);
    t.pport = t.tol + 3 * kSlotChunk * a.tw;
    t.sname = (int32_t*)(t.pport + kSlotChunk * a.pw);
    t.pw = (float*)(t.sname + kSlotChunk);
    t.word = (uint32_t*)(t.pw + kSlotChunk * MT);
    t.miss = t.word + kSlotChunk * (1 + MT);
    t.rows = (int32_t*)smem + l.node_words + l.chunk_words;
    t.valid = (uint8_t*)(t.rows + statics::kTileWarps * l.row_words);
    t.sv = t.valid + kTile;
    t.hsel = t.sv + kSlotChunk;
    t.live = t.hsel + kSlotChunk;
    t.tolall = t.live + kSlotChunk;
    t.pv = t.tolall + 3 * kSlotChunk;
    t.list = (uint16_t*)(t.pv + kSlotChunk * MT);
    t.tv = (uint8_t*)(t.list + kSlotChunk * (1 + MT));
    return t;
}

// Words of a gathered, transposed node table: word i of [W, kTile] is
// row col[i % kTile]'s word i / kTile of a row-major [N, W] table.
template <int UNR>
__device__ __forceinline__ void stage_transposed(uint32_t* s, const uint32_t* __restrict__ g,
                                                 const int32_t* col, int nt, int w)
{
    batched<UNR, false>(w * statics::kTile, [&](int i) -> uint32_t {
        const int node = i & (statics::kTile - 1);
        return node < nt ? g[(size_t)col[node] * w + (i >> 5)] : 0u;
    }, [&](int i, uint32_t v) { s[i] = v; });
}

// The chunk's slot specs (valid, has_sel, name, tol_all, pref_valid,
// pref_weight, tolerations, port words; slots s.slot[0, cc)) and the
// tile's node rows (valid bytes, name ids, taint words transposed,
// topology ids): every load issued before the first store.
__device__ __forceinline__ void stage_round(const Args& a, const TileSmem& s, int nt, int cc)
{
    using statics::kTile;
    constexpr int U = 4;   // loads a thread a table, in flight together
    const int tw = a.tw, tk = a.tk, pw = a.pw, MT = a.mt, bd = blockDim.x, t = threadIdx.x;
    const int S = 6 + 2 * MT + 3 * tw;          // a slot's scalar and toleration words
    const int n_taint = 3 * tw * kTile, n_topo = kTile * tk;
    const int n_spec = cc * S, n_port = cc * pw;
    // the word j of the chunk's scalar and toleration words
    auto spec = [&](int j) -> uint32_t {
        const int ci = j / S;
        int q = j - ci * S;
        const int g = s.slot[ci];
        if (q == 0) return a.valid[g];
        if (q == 1) return a.has_sel[g];
        if (q == 2) return (uint32_t)a.name[g];
        if (q < 6) return a.tol_all[(q - 3) * a.g + g];
        q -= 6;
        if (q < MT) return a.pref.tv[g * MT + q];
        q -= MT;
        if (q < MT) return __float_as_uint(a.pref_weight[g * MT + q]);
        q -= MT;
        return a.tol[((size_t)(q / tw) * a.g + g) * tw + q % tw];
    };
    auto spec_store = [&](int j, uint32_t w) {
        const int ci = j / S;
        int q = j - ci * S;
        if (q == 0) { s.sv[ci] = (uint8_t)w; return; }
        if (q == 1) { s.hsel[ci] = (uint8_t)w; return; }
        if (q == 2) { s.sname[ci] = (int32_t)w; return; }
        if (q < 6) { s.tolall[(q - 3) * kSlotChunk + ci] = (uint8_t)w; return; }
        q -= 6;
        if (q < MT) { s.pv[ci * MT + q] = (uint8_t)w; return; }
        q -= MT;
        if (q < MT) { s.pw[ci * MT + q] = __uint_as_float(w); return; }
        q -= MT;
        s.tol[((q / tw) * kSlotChunk + ci) * tw + q % tw] = w;
    };
    uint32_t vt[U], vp[U], vs[U], vo = 0u, vv = 0u, vn = 0u;
    // every load first
    if (t < kTile) {
        const int col = s.col[t];
        vv = col >= 0 ? a.node_valid[col] : 0u;
        vn = col >= 0 ? (uint32_t)a.node_name[col] : 0xffffffffu;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int i = t + u * bd;
        // taint [3, TW, kTile]: word i's node i % kTile, effect and word above
        const int node = i & (kTile - 1), ew = i >> 5;
        vt[u] = i < n_taint && node < nt
            ? a.taint[((size_t)(ew / tw) * a.n + s.col[node]) * tw + ew % tw] : 0u;
        vs[u] = i < n_spec ? spec(i) : 0u;
        vp[u] = i < n_port ? a.port_bits[(size_t)s.slot[i / pw] * pw + i % pw] : 0u;
    }
    if (t < n_topo) {
        const int node = t / tk;
        vo = node < nt ? (uint32_t)a.topo[(size_t)s.col[node] * tk + t % tk] : 0u;
    }
    // then the stores
    if (t < kTile) {
        s.valid[t] = (uint8_t)vv;
        s.name[t] = (int32_t)vn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int i = t + u * bd;
        if (i < n_taint) s.taint[i] = vt[u];
        if (i < n_spec) spec_store(i, vs[u]);
        if (i < n_port) s.pport[i] = vp[u];
    }
    if (t < n_topo) s.topo[t] = (int32_t)vo;
    // what U loads a thread did not cover (wider tables than this card's)
    for (int i = t + U * bd; i < n_taint; i += bd) {
        const int node = i & (kTile - 1), ew = i >> 5;
        s.taint[i] = node < nt ? a.taint[((size_t)(ew / tw) * a.n + s.col[node]) * tw + ew % tw]
                               : 0u;
    }
    for (int i = t + U * bd; i < n_spec; i += bd) spec_store(i, spec(i));
    for (int i = t + U * bd; i < n_port; i += bd) {
        s.pport[i] = a.port_bits[(size_t)s.slot[i / pw] * pw + i % pw];
    }
    for (int i = t + bd; i < n_topo; i += bd) {
        const int node = i / tk;
        s.topo[i] = node < nt ? a.topo[(size_t)s.col[node] * tk + i % tk] : 0;
    }
}

// A column tile (gathered: the listed columns, the unmissed slots, the
// columns below the old width) or a node tile (contiguous: the missed
// slots everywhere, every slot at the grown columns), for the slot chunk
// `chunk`.  Its dependent rounds of loads: the columns (gathered), one
// round for the node rows and the chunk's specs, a row's ops, its ids,
// and the stores; the port and label words only when a slot claims a
// port or a row reads labels.
__device__ __forceinline__ void tile_block(const Args& a, uint32_t* smem, bool gathered, int tile,
                                           int chunk)
{
    using statics::kTile;
    using statics::kTileWarps;
    __shared__ int flag, count;
    const int T = a.sel.t, E = a.sel.e, K = a.sel.k, MT = a.mt;
    const Smem l = smem_layout(a.lw, a.tk, a.tw, a.pw, MT, T, E, K);
    const TileSmem s = tile_smem(a, smem);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // the tile's columns; the grown columns start at the old width
    int nt;
    bool grown_tile;
    if (gathered) {
        nt = min(kTile, a.d - tile * kTile);
        grown_tile = false;
    } else {
        const int node0 = (a.tile0 + tile) * kTile;
        nt = min(kTile, a.n - node0);
        grown_tile = node0 + nt > a.old_n;
    }
    // this block's slots: of every slot (a gathered tile, or a node tile
    // with grown columns) or of the missed ones (any other node tile)
    const bool all_slots = gathered || grown_tile;
    const int base = chunk * a.sc;
    const int cc = min(a.sc, (all_slots ? a.g : a.m) - base);
    if (cc <= 0) return;
    if (threadIdx.x == 0) flag = 0;
    if (threadIdx.x < kTile) {
        const int i = threadIdx.x;
        s.col[i] = i >= nt ? -1 : gathered ? a.cols[tile * kTile + i]
                                           : (a.tile0 + tile) * kTile + i;
    }
    if (threadIdx.x < cc) {
        const int i = threadIdx.x;
        s.slot[i] = all_slots ? base + i : a.slots[base + i];
    }
    for (int i = threadIdx.x; i < kMaxSlots / 32; i += blockDim.x) s.miss[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < a.m; i += blockDim.x) {
        const int g = a.slots[i];
        atomicOr(&s.miss[g >> 5], 1u << (g & 31));
    }
    stage_round(a, s, nt, cc);
    __syncthreads();
    // live slots, a port claimed, and the rows to evaluate in order: slot
    // ci's selector (j = 0) and its live preferred terms
    const int rows = 1 + MT;
    if (threadIdx.x < cc) {
        const int i = threadIdx.x, g = s.slot[i];
        const bool missed = (s.miss[g >> 5] >> (g & 31)) & 1u;
        s.live[i] = gathered ? !missed : 1;
    }
    for (int i = threadIdx.x; i < cc * a.pw; i += blockDim.x) {
        if (s.pport[i]) flag = 1;
    }
    __syncthreads();
    if (warp == 0) {
        int n_rows = 0;
        for (int i0 = 0; i0 < cc * rows; i0 += 32) {
            const int i = i0 + lane;
            const int ci = i / rows, j = i % rows;
            const bool on = i < cc * rows && s.live[ci]
                            && (j == 0 ? s.hsel[ci] != 0 : s.pv[ci * MT + j - 1] != 0);
            const unsigned bal = __ballot_sync(0xffffffffu, on);
            if (on) s.list[n_rows + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)i;
            n_rows += __popc(bal);
        }
        if (lane == 0) count = n_rows;
    }
    const bool ports = flag != 0;
    if (ports) stage_transposed<8>(s.ports, a.ports, s.col, nt, a.pw);
    __syncthreads();
    if (threadIdx.x == 0) flag = 0;
    __syncthreads();
    // the listed rows, a warp each and kTileWarps at a time: the row
    // staged in the warp's buffer in one round, the label words staged
    // once if a row reads them, then matched from shared memory into a
    // word
    int32_t* row_ids = s.rows + warp * l.row_words;
    int32_t* row_op = row_ids + T * E * K;
    int32_t* row_slot = row_op + T * E;
    uint8_t* row_tv = s.tv + warp * T;
    const int lws = a.lw + 1;   // the padded label row
    bool labels = false;
    for (int r0 = 0; r0 < count; r0 += kTileWarps) {
        const int r = r0 + warp;
        int i = 0, terms = 1;
        bool reads = false;
        if (r < count) {
            i = s.list[r];
            const int ci = i / rows, j = i % rows, g = s.slot[ci];
            const statics::Table& tb = j == 0 ? a.sel : a.pref;
            const int row = j == 0 ? g : g * MT + j - 1;
            terms = j == 0 ? T : 1;
            const size_t te = (size_t)row * terms * E;
            const int ne = terms * E;
            // the row's ops, slots, term flags and ids in one round (the ids
            // of unused expressions are never read by match_row)
            batched<20, true>(2 * ne + terms + ne * K, [&](int x) -> uint32_t {
                return x < ne ? (uint32_t)tb.op[te + x]
                     : x < 2 * ne ? (uint32_t)tb.slot[te + x - ne]
                     : x < 2 * ne + terms ? (uint32_t)tb.tv[(size_t)row * terms + x - 2 * ne]
                                          : (uint32_t)tb.ids[te * K + x - 2 * ne - terms];
            }, [&](int x, uint32_t w) {
                if (x < ne) row_op[x] = (int32_t)w;
                else if (x < 2 * ne) row_slot[x - ne] = (int32_t)w;
                else if (x < 2 * ne + terms) row_tv[x - 2 * ne] = (uint8_t)w;
                else row_ids[x - 2 * ne - terms] = (int32_t)w;
            });
            __syncwarp();
            auto live_expr = [&](int ex) {
                return row_tv[ex / E]
                    && (row_op[ex] == statics::kOpPos || row_op[ex] == statics::kOpNeg);
            };
            for (int ex = lane; ex < ne; ex += 32) {
                reads = reads || (live_expr(ex) && !(row_slot[ex] >= 0 && a.tk > 0));
            }
        }
        if (__any_sync(0xffffffffu, reads) && lane == 0) flag = 1;
        __syncthreads();
        if (flag && !labels) {
            // label rows, padded: lane n reads row n's word w at n (LW + 1) + w
            batched<8, false>(kTile * a.lw, [&](int x) -> uint32_t {
                const int node = x / a.lw;
                return node < nt ? a.label[(size_t)s.col[node] * a.lw + x % a.lw] : 0u;
            }, [&](int x, uint32_t w) { s.label[(x / a.lw) * lws + x % a.lw] = w; });
            labels = true;
            __syncthreads();
        }
        if (r < count) {
            __syncwarp();
            const bool ok = lane < nt && statics::match_row(
                s.label + lane * lws, a.lw, s.topo + lane * a.tk, a.tk, row_ids, row_op,
                row_slot, row_tv, terms, E, K);
            const unsigned word = __ballot_sync(0xffffffffu, ok);
            if (lane == 0) s.word[i] = word;
        }
        __syncthreads();
    }
    // the slots' entries: a warp a slot, a lane a column, every word from
    // shared memory — statics::static_feasible and prefer_taints on the
    // transposed node words
    for (int ci = warp; ci < cc; ci += kTileWarps) {
        const int g = s.slot[ci];
        const int col = s.col[lane];
        if (!s.live[ci] || lane >= nt) continue;
        const bool missed = (s.miss[g >> 5] >> (g & 31)) & 1u;
        // gathered: the unmissed slots below the old width; node tiles:
        // the missed slots, and every slot from the old width
        if (gathered ? col >= a.old_n : !(missed || col >= a.old_n)) continue;
        const bool sel_ok = s.hsel[ci] ? (s.word[ci * rows] >> lane) & 1u : true;
        // static_filters: validity, NodeName, NoSchedule and NoExecute taints
        bool ok = s.valid[lane] && s.sv[ci] && sel_ok;
        const int pname = s.sname[ci];
        ok = ok && (pname == -1 || s.name[lane] == pname);
        for (int eff = statics::kNoSchedule; eff <= statics::kNoExecute;
             eff += statics::kNoExecute - statics::kNoSchedule) {
            if (s.tolall[eff * kSlotChunk + ci]) continue;
            const uint32_t* tl = s.tol + (eff * kSlotChunk + ci) * a.tw;
            for (int w = 0; w < a.tw; ++w) {
                if (s.taint[(eff * a.tw + w) * kTile + lane] & ~tl[w]) ok = false;
            }
        }
        // bound_ports_free
        if (ports) {
            const uint32_t* pp = s.pport + ci * a.pw;
            for (int w = 0; w < a.pw; ++w) {
                if (s.ports[w * kTile + lane] & pp[w]) ok = false;
            }
        }
        // prefer_taints
        unsigned int cnt = 0;
        if (!s.tolall[statics::kPreferNoSchedule * kSlotChunk + ci]) {
            const uint32_t* tl = s.tol + (statics::kPreferNoSchedule * kSlotChunk + ci) * a.tw;
            for (int w = 0; w < a.tw; ++w) {
                cnt += __popc(s.taint[(statics::kPreferNoSchedule * a.tw + w) * kTile + lane]
                              & ~tl[w]);
            }
        }
        float acc = 0.0f;
        for (int j = 0; j < MT; ++j) {
            const bool live = s.pv[ci * MT + j] != 0;
            const bool hit = live && ((s.word[ci * rows + 1 + j] >> lane) & 1u);
            acc = statics::affinity_add(acc, live ? s.pw[ci * MT + j] : 0.0f, hit);
        }
        const size_t o = (size_t)g * a.n + col;
        a.sfeas[o] = ok ? 1 : 0;
        a.aff[o] = acc;
        a.taint_out[o] = (float)cnt;
    }
}

__global__ void __launch_bounds__(statics::kTileThreads) partials_eval_kernel(Args a)
{
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    if (b < a.copy_blocks) {
        copy_block(a, smem);
    } else if (b < a.copy_blocks + a.col_tiles * a.col_chunks) {
        const int x = b - a.copy_blocks;
        tile_block(a, smem, true, x / a.col_chunks, x % a.col_chunks);
    } else {
        const int x = b - a.copy_blocks - a.col_tiles * a.col_chunks;
        tile_block(a, smem, false, x / a.node_chunks, x % a.node_chunks);
    }
}

}  // namespace

extern "C" int partials_eval_launch(const int* ints, void* const* ptrs, void* stream)
{
    Args a;
    a.n = ints[kI_N];
    a.lw = ints[kI_LW];
    a.tk = ints[kI_TK];
    a.tw = ints[kI_TW];
    a.pw = ints[kI_PW];
    a.g = ints[kI_G];
    a.mt = ints[kI_MT];
    a.old_n = ints[kI_OLD_N];
    a.m = ints[kI_M];
    a.d = ints[kI_D];
    a.vec = ints[kI_VEC];
    if (a.n == 0 || a.g == 0) return 0;
    if (a.g > kMaxSlots || a.m > a.g || a.mt < 1) return (int)cudaErrorInvalidValue;
    a.sel = statics::Table{a.g, ints[kI_T], ints[kI_E], ints[kI_K],
                           (const int32_t*)ptrs[kP_SEL_IDS], (const int32_t*)ptrs[kP_SEL_OP],
                           (const int32_t*)ptrs[kP_SEL_SLOT], (const uint8_t*)ptrs[kP_SEL_TV]};
    a.pref = statics::Table{a.g * a.mt, 1, ints[kI_E], ints[kI_K],
                            (const int32_t*)ptrs[kP_PREF_IDS], (const int32_t*)ptrs[kP_PREF_OP],
                            (const int32_t*)ptrs[kP_PREF_SLOT],
                            (const uint8_t*)ptrs[kP_PREF_VALID]};
    a.node_valid = (const uint8_t*)ptrs[kP_NODE_VALID];
    a.node_name = (const int32_t*)ptrs[kP_NODE_NAME];
    a.label = (const uint32_t*)ptrs[kP_LABEL_BITS];
    a.topo = (const int32_t*)ptrs[kP_TOPO_IDS];
    a.taint = (const uint32_t*)ptrs[kP_TAINT_BITS];
    a.ports = (const uint32_t*)ptrs[kP_NODE_PORTS];
    a.valid = (const uint8_t*)ptrs[kP_VALID];
    a.name = (const int32_t*)ptrs[kP_NAME_ID];
    a.has_sel = (const uint8_t*)ptrs[kP_HAS_SEL];
    a.tol = (const uint32_t*)ptrs[kP_TOL_BITS];
    a.tol_all = (const uint8_t*)ptrs[kP_TOL_ALL];
    a.port_bits = (const uint32_t*)ptrs[kP_PORT_BITS];
    a.pref_weight = (const float*)ptrs[kP_PREF_WEIGHT];
    a.old_sfeas = (const uint8_t*)ptrs[kP_OLD_SFEAS];
    a.old_aff = (const float*)ptrs[kP_OLD_AFF];
    a.old_taint = (const float*)ptrs[kP_OLD_TAINT];
    a.slots = (const int32_t*)ptrs[kP_SLOTS];
    a.cols = (const int32_t*)ptrs[kP_COLS];
    a.sfeas = (uint8_t*)ptrs[kP_SFEAS];
    a.aff = (float*)ptrs[kP_AFF];
    a.taint_out = (float*)ptrs[kP_TAINT];
    // the grid: copy blocks over the old width, column tiles over the
    // listed columns, node tiles over every column when a slot is missed,
    // else from the old width's tile up
    const int width = a.old_n < a.n ? a.old_n : a.n;
    const int tiles = (a.n + statics::kTile - 1) / statics::kTile;
    a.copy_per_slot = (width + kCopyCols - 1) / kCopyCols;
    a.copy_blocks = a.g * a.copy_per_slot;
    a.col_tiles = (a.d + statics::kTile - 1) / statics::kTile;
    a.tile0 = a.m > 0 ? 0 : (a.n > a.old_n ? a.old_n / statics::kTile : tiles);
    // slot chunks a column tile (every slot) and a node tile (every slot
    // when columns grew, else the missed ones; a tile with no grown column
    // returns from the chunks past the missed slots')
    // a tile's slots over several blocks while that keeps its blocks to
    // about one a multiprocessor (a refresh of a few columns is a block's
    // latency, not the card's throughput), else kSlotChunk a block
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const int few = (a.g + kFewSlots - 1) / kFewSlots;
    a.sc = (a.col_tiles + tiles - a.tile0) * few <= sms ? kFewSlots : kSlotChunk;
    a.col_chunks = (a.g + a.sc - 1) / a.sc;
    a.node_chunks = ((a.n > a.old_n ? a.g : a.m) + a.sc - 1) / a.sc;
    const int grid = a.copy_blocks + a.col_tiles * a.col_chunks
                     + (tiles - a.tile0) * a.node_chunks;
    if (grid == 0) return 0;
    const int smem = smem_bytes(a.lw, a.tk, a.tw, a.pw, a.mt, a.sel.t, a.sel.e, a.sel.k);
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            partials_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    partials_eval_kernel<<<grid, statics::kTileThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The launch layout the bindings check on load: 0 the ints, 1 the
// pointers, 2 the tile's columns, 3 a copy block's columns, 4 the most
// slots a tile block, 5 the most slots.
extern "C" int partials_eval_layout(int which)
{
    switch (which) {
        case 0: return kI_COUNT;
        case 1: return kP_COUNT;
        case 2: return statics::kTile;
        case 3: return kCopyCols;
        case 4: return kSlotChunk;
        case 5: return kMaxSlots;
        default: return -1;
    }
}

extern "C" const char* partials_eval_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
