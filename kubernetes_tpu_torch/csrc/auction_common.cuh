// The auction solve's round on a thread-block cluster: the stage bodies
// of the one kernel that auction_loop.cu launches, as the whole loop (one
// launch a batch) or as one stage of a round at the same cluster shape
// (the bindings' stage entry points), so a round-by-round check holds the
// very code the program runs.
//
// Replaces: kubernetes_tpu/ops/auction.py:140 `auction_assign`'s round
// loop — the `bids` (:355-478), the repairs (:507-678), the `body`
// (:680-745) and the `cond` (:742-745), one lax.while_loop (:762) inside
// auction_assign_jit (:855).
//
// A round, every stage separated from the next by a cluster barrier
// (barrier.cluster arrive.release / wait.acquire, cluster_common.cuh
// ClusterTeam::sync), so one stage's global writes are seen by every block
// in the next:
//   class sort   the solve order stably sorted by class key (the class of
//                an active pod, C for any other) — a least-significant-
//                digit radix sort over the cluster (radix_sort: 8-bit
//                digits, a tile of blockDim positions a block, a digit's
//                lanes in a warp found by __match_any_sync, a warp's
//                counts in shared memory, an exclusive scan over (digit,
//                tile)), then each key's first sorted position.  A pod's
//                j, its position among the active pods of its class in
//                solve order, is its sorted position less its class's
//                first: O(P) a pass, against the first design's P^2 / 2
//                tiled count.  Each class with an active pod is stamped
//                with the round; the class pass skips the others (no pod
//                reads their rows).
//   class pass   per stamped class: the evaluation (solve_common.cuh
//                block_eval, non-speculating, so every node's masked score
//                is written), the best, the tie set, and its hashed (key
//                desc, index asc) top list of cnt = min(#ties, tie_k)
//                nodes.  Each tie is histogrammed by the top 10 bits of
//                its 30-bit key; a descending exclusive scan of the
//                histogram gives each bucket's first rank; the ties of the
//                buckets that reach rank cnt are listed per bucket, and
//                each is placed by its rank within its bucket — lax.top_k's
//                order, with no sort.  The keys are a Weyl-sequence hash of
//                the node index, so buckets stay small.  Each class in
//                turn runs over the whole cluster: every block evaluates
//                its round-robin 32-node chunks, the best merges under
//                ranks_above, the histogram is summed across the blocks
//                through distributed shared memory — integer adds, so
//                order-free — and each block lists its ties at its own
//                offset within each bucket, the sum of the lower-ranked
//                blocks' counts.  A NaN best (a corrupt input) equals no
//                score, so the class bids nowhere, as in the reference.
//   bids         per pod: slot = j mod max(cnt, 1), bid = the slot's tie
//                node, val = the class's best (no bid, N and -inf, for an
//                inactive pod or a class without a tie).
//   bid sorts    the solve order and the pod index order, both stably
//                sorted by bid (a node index, N for no bid) with the same
//                radix sort (the two sorts share each pass's barriers):
//                `perm` and `perm_idx`; each node group's first position
//                (searchsorted left) from the run starts of `perm`.
//   prefix       the requests in `perm` order summed in XLA's CPU cumsum
//                order (sequential scans of blocks of 16 rows, the block
//                totals scanned the same way, recursively, each block's
//                exclusive total added back): the 16-row blocks of level 0
//                are independent and run over the whole cluster; the upper
//                levels run on block 0; a position's final prefix is its
//                level-0 sum plus its block's exclusive total, the same add
//                the first design's down-sweep made.
//   acceptance   per sorted position: within = prefix - prefix[first] +
//                req[first] against the node's remaining capacity;
//                `progress` is the OR over the cluster.
//   repairs      the spread repair (the first design's body, written for
//                any block size) on block 0 while the other blocks wait at
//                the barrier; then the inter-pod anti-affinity repair over
//                the cluster (its pods and nodes split over the blocks,
//                below).
//   commit       each node group's first sorted position adds its accepted
//                members' requests in pod index order (the group spans the
//                same positions of perm_idx), the order of the reference's
//                scatter-add; accepted pods take their bid and value; the
//                flag = rounds < max_rounds && progress && some valid pod
//                unplaced, an OR over the cluster.
// After the rounds, in the same launch: the reasons pass (kStageReasons,
// round_reasons below), one node pass for every joint class (32 a pass)
// against the final state, each pod's REASON_* into `reasons`; then, with
// gangs, the gang post-pass (kStageGang, round_gang below): incomplete
// gangs release their placed members, their requests subtracted node by
// node in pod index order, with no sort when no pod drops.
// state (i32[3] on the card): rounds executed, the continue flag, the last
// round's progress.  Every stage entry point of a round returns at once
// when the flag is down; the reasons pass and the gang stage run whatever
// the flag.
//
// Exactness: the sorts are integer and stable, the histogram and the
// flags are integer sums and ORs, the best merges under ranks_above's
// total order, and every float sum (the prefix, the commit, the gang
// release) is added in the first design's order, so the program equals the plain loop
// (ops/auction.py _rounds_plain) bit for bit whatever G is.

#pragma once

#include "cluster_common.cuh"

namespace auction {

using namespace solve;

constexpr int kKeyBits = 30;     // hkey >> 2
constexpr int kBucketBits = 10;
constexpr int kBuckets = 1 << kBucketBits;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kRound = 0x85EBCA6Bu;
constexpr uint32_t kMix = 0x27D4EB2Fu;
constexpr uint32_t kSeedC = 1u;  // tie_seed 0
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kScanBlock = 16;   // XLA's block for a rewritten cumulative sum
constexpr int kMaxLevels = 9;    // 16^8 rows
constexpr int kRepairIters = 3;  // ops/auction.py SPREAD_REPAIR_ITERS
constexpr int kShZ = 256;        // spread counters a warp keeps in shared memory
constexpr int kBatch = 8;        // spread walk: chunks of 32 positions loaded at once
constexpr int kRowChunk = 1024;  // spread rows listed at once
constexpr int kBigI = 1 << 30;   // ops/auction.py _BIG_I
constexpr int kMaxTK = 32767;    // topology keys: a live term's slot in 16 bits

// The launch arguments: ints[kI_*] and ptrs[kP_*] (host arrays), in
// kernels/bindings.py AUCTION_INTS / AUCTION_PTRS order.
enum {
    kI_N, kI_R, kI_P, kI_C_DIM, kI_CS_DIM, kI_CC_DIM, kI_TIE_K, kI_MAX_ROUNDS,
    kI_SP_ON, kI_SP_SOFT, kI_SP_C, kI_SP_MC, kI_SP_Z,
    kI_TM_ON, kI_TM_W, kI_TM_U, kI_TM_T, kI_TM_TK, kI_TM_Z, kI_TM_MA,
    kI_N_GROUPS,
    kI_COUNT
};
enum {
    kP_ALLOC, kP_REQUESTED, kP_NONZERO, kP_SFEAS_S, kP_AFF_S, kP_TAINT_S, kP_S_REPS,
    kP_JSPEC, kP_K_REPS, kP_JCONS, kP_POD_REQ, kP_POD_NZ, kP_POD_VALID, kP_ORDER,
    kP_CLASS_ID, kP_GROUP_ID, kP_IPARAMS, kP_FPARAMS, kP_EXTRA,
    kP_SP_POD_IDX, kP_SP_POD_MATCHES, kP_SP_MAX_SKEW, kP_SP_MIN_DOMAINS, kP_SP_HARD,
    kP_SP_ELIGIBLE, kP_SP_V, kP_SP_SIZES, kP_SP_COUNTS,
    kP_TM_KEY_BITS, kP_TM_SLOT_V, kP_TM_MI_SLOT, kP_TM_ANTI_SLOT, kP_TM_AFF_BITS,
    kP_TM_ANTI_BITS, kP_TM_SELF_MATCH, kP_TM_PRESENT, kP_TM_BLOCKED, kP_TM_GLOBAL_ANY,
    kP_TOPO_IDS, kP_SLOT_OF_T, kP_TM_MATCHES_IN, kP_TM_ANTI_IDX, kP_TM_VALID, kP_SOLVE_POS,
    kP_PAIR_INV, kP_LIVE_TERMS,
    kP_ASSIGNED, kP_BID_SCORES, kP_STATE, kP_BID, kP_VAL, kP_INV_C, kP_CNT_C, kP_BEST_C,
    kP_MASKED, kP_SLOTS, kP_CPERM, kP_CFIRST, kP_CSEEN, kP_PERM, kP_PERM_IDX, kP_BFIRST,
    kP_RTMP, kP_RCNT, kP_RBASE, kP_PREFIX, kP_SCAN, kP_ACCEPT,
    kP_COUNTS_IT, kP_ADDS, kP_MINC, kP_KEPT, kP_CAND, kP_ADMIT,
    kP_MINPOS, kP_CARRIER, kP_Z_MI, kP_Z_AN, kP_RELEASE,
    kP_REASON_C, kP_REASONS,
    kP_GANG_DROPPED, kP_GANG_FLAGS,
    kP_COUNT
};

// Everything a round reads and writes.
struct Ctx {
    int n, r, p, c_dim, cs_dim, cc_dim, tie_k, max_rounds;
    int sp_z;                    // the spread slots' value capacity
    int t_dim, tk, tz, tm_ma;    // inter-pod repair: terms, topology keys, value capacity,
                                 // anti terms a pod
    int n_groups;                // gangs (0: no gang stage)
    const float* alloc;          // [N, R]
    float* requested;            // [N, R] carry
    float* nonzero;              // [N, R] carry
    const uint8_t* sfeas_s;      // [Cs, N]
    const float* aff_s;          // [Cs, N]
    const float* taint_s;        // [Cs, N]
    const int32_t* s_reps;       // [Cs]
    const int32_t* jspec;        // [C]
    const int32_t* k_reps;       // [Cc]
    const int32_t* jcons;        // [C]
    const float* pod_req;        // [P, R]
    const float* pod_nz;         // [P, R]
    const uint8_t* pod_valid;    // [P]
    const int32_t* order;        // [P] solve order
    const int32_t* class_id;     // [P]
    const int32_t* group_id;     // [P] gang, -1 none
    const int32_t* iparams;
    const float* fparams;
    const float* extra;          // [C, N] or null
    Spread sp;                   // counts: the carry
    Terms tm;                    // bits: the carry
    const int32_t* topo_ids;     // [N, TK]
    const int32_t* slot_of_t;    // [T]
    const uint32_t* mi_words;    // [P, W] terms.matches_incoming: bit t of word t / 32
    const int32_t* anti_idx;     // [P, MA] terms.anti_idx (-1 pad)
    const uint8_t* term_valid;   // [T] terms.valid
    int32_t* solve_pos;          // [P] each pod's solve position (written by start)
    uint8_t* pair_inv;           // [P, L] a pod's flags of each live term (written by start)
    int32_t* live_terms;         // [1 + T] L, then the live terms' keys (written by start)
    int32_t* assigned;           // [P] carry
    float* bid_scores;           // [P] carry
    int32_t* state;              // [3]
    int32_t* bid;                // [P]
    float* val;                  // [P]
    int32_t* inv_c;              // [C, tie_k]
    int32_t* cnt_c;              // [C]
    float* best_c;               // [C]
    float* masked;               // [N] scratch
    int32_t* slots;              // [N] scratch
    int32_t* cperm;              // [P] solve order sorted by class key
    int32_t* cfirst;             // [C + 1] each class key's first sorted position
    int32_t* cseen;              // [C + 1] the round a class last had an active pod
    int32_t* perm;               // [P] solve order sorted by bid
    int32_t* perm_idx;           // [P] pod index order sorted by bid
    int32_t* bfirst;             // [N + 1] each bid's first position in perm; the gang
                                 // stage's run starts
    int32_t* rtmp;               // [2, P] radix ping-pong
    int32_t* rcnt;               // [2, tiles, kRadix]
    int32_t* rbase;              // [2, tiles, kRadix]
    float* prefix;               // [P, R]
    float* scan;                 // [levels, R]
    uint8_t* accept;             // [P]
    float* counts_it;            // spread repair: [C_sp, N]
    int32_t* adds;               // [C_sp, Z]
    float* minc;                 // [C_sp]
    uint8_t* kept;               // [P]
    uint8_t* cand;               // [P]
    uint8_t* admit;              // [P]
    int32_t* minpos;             // inter-pod repair: [Z * T]
    uint8_t* carrier;            // [Z * T]
    uint8_t* z_mi;               // [Z * T]
    uint8_t* z_an;               // [Z * T]
    uint8_t* release;            // [P]
    int32_t* reason_c;           // reasons pass: [C] each joint class's reason
    int32_t* reasons;            // [P] output
    uint8_t* gang_dropped;       // [P] output: placed, then released with its gang
    int32_t* gang_flags;         // [G] scratch: the gang has an unplaced member
};

// The argument check and the context of a launch; returns a cudaError.
inline int make_ctx(const int* ints, void* const* ptrs, Ctx& a)
{
    a = Ctx{};
    a.n = ints[kI_N];
    a.r = ints[kI_R];
    a.p = ints[kI_P];
    a.c_dim = ints[kI_C_DIM];
    a.cs_dim = ints[kI_CS_DIM];
    a.cc_dim = ints[kI_CC_DIM];
    a.tie_k = ints[kI_TIE_K];
    a.max_rounds = ints[kI_MAX_ROUNDS];
    a.sp_z = ints[kI_SP_Z];
    a.t_dim = ints[kI_TM_T];
    a.tk = ints[kI_TM_TK];
    a.tz = ints[kI_TM_Z];
    a.tm_ma = ints[kI_TM_MA];
    a.n_groups = ints[kI_N_GROUPS];
    const int sp_on = ints[kI_SP_ON], sp_c = ints[kI_SP_C], sp_mc = ints[kI_SP_MC];
    const int tm_on = ints[kI_TM_ON], tm_w = ints[kI_TM_W], tm_u = ints[kI_TM_U];
    if (a.r < 1 || a.r > kMaxR || a.tie_k < 1 || a.c_dim < 1 || a.cs_dim < 1 || a.cc_dim < 1
        || a.n_groups < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (sp_on && (sp_mc < 1 || sp_mc > kMaxMC || sp_c < 1 || a.sp_z < 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if (tm_on && (tm_w < 1 || tm_w > kMaxTW || tm_u < 1 || a.t_dim < 1 || a.tk < 1 || a.tz < 1
                  || a.tm_ma < 1 || tm_w != (a.t_dim + 31) / 32 || a.tk > kMaxTK)) {
        return (int)cudaErrorInvalidValue;
    }
    auto f = [&](int k) { return (const float*)ptrs[k]; };
    auto i = [&](int k) { return (const int32_t*)ptrs[k]; };
    auto u = [&](int k) { return (const uint8_t*)ptrs[k]; };
    a.alloc = f(kP_ALLOC);
    a.requested = (float*)ptrs[kP_REQUESTED];
    a.nonzero = (float*)ptrs[kP_NONZERO];
    a.sfeas_s = u(kP_SFEAS_S);
    a.aff_s = f(kP_AFF_S);
    a.taint_s = f(kP_TAINT_S);
    a.s_reps = i(kP_S_REPS);
    a.jspec = i(kP_JSPEC);
    a.k_reps = i(kP_K_REPS);
    a.jcons = i(kP_JCONS);
    a.pod_req = f(kP_POD_REQ);
    a.pod_nz = f(kP_POD_NZ);
    a.pod_valid = u(kP_POD_VALID);
    a.order = i(kP_ORDER);
    a.class_id = i(kP_CLASS_ID);
    a.group_id = i(kP_GROUP_ID);
    a.iparams = i(kP_IPARAMS);
    a.fparams = f(kP_FPARAMS);
    a.extra = f(kP_EXTRA);
    a.sp = make_spread(sp_on, ints[kI_SP_SOFT], sp_c, sp_mc, ptrs[kP_SP_POD_IDX],
                       ptrs[kP_SP_POD_MATCHES], ptrs[kP_SP_MAX_SKEW], ptrs[kP_SP_MIN_DOMAINS],
                       ptrs[kP_SP_HARD], ptrs[kP_SP_ELIGIBLE], ptrs[kP_SP_V], ptrs[kP_SP_SIZES],
                       ptrs[kP_SP_COUNTS]);
    a.tm = make_terms(tm_on, tm_w, tm_u, a.p, ptrs[kP_TM_KEY_BITS], ptrs[kP_TM_SLOT_V],
                      ptrs[kP_TM_MI_SLOT], ptrs[kP_TM_ANTI_SLOT], ptrs[kP_TM_AFF_BITS],
                      ptrs[kP_TM_ANTI_BITS], ptrs[kP_TM_SELF_MATCH], ptrs[kP_TM_PRESENT],
                      ptrs[kP_TM_BLOCKED], ptrs[kP_TM_GLOBAL_ANY], 0, nullptr, nullptr);
    a.topo_ids = i(kP_TOPO_IDS);
    a.slot_of_t = i(kP_SLOT_OF_T);
    a.mi_words = (const uint32_t*)ptrs[kP_TM_MATCHES_IN];
    a.anti_idx = i(kP_TM_ANTI_IDX);
    a.term_valid = u(kP_TM_VALID);
    a.solve_pos = (int32_t*)ptrs[kP_SOLVE_POS];
    a.pair_inv = (uint8_t*)ptrs[kP_PAIR_INV];
    a.live_terms = (int32_t*)ptrs[kP_LIVE_TERMS];
    a.assigned = (int32_t*)ptrs[kP_ASSIGNED];
    a.bid_scores = (float*)ptrs[kP_BID_SCORES];
    a.state = (int32_t*)ptrs[kP_STATE];
    a.bid = (int32_t*)ptrs[kP_BID];
    a.val = (float*)ptrs[kP_VAL];
    a.inv_c = (int32_t*)ptrs[kP_INV_C];
    a.cnt_c = (int32_t*)ptrs[kP_CNT_C];
    a.best_c = (float*)ptrs[kP_BEST_C];
    a.masked = (float*)ptrs[kP_MASKED];
    a.slots = (int32_t*)ptrs[kP_SLOTS];
    a.cperm = (int32_t*)ptrs[kP_CPERM];
    a.cfirst = (int32_t*)ptrs[kP_CFIRST];
    a.cseen = (int32_t*)ptrs[kP_CSEEN];
    a.perm = (int32_t*)ptrs[kP_PERM];
    a.perm_idx = (int32_t*)ptrs[kP_PERM_IDX];
    a.bfirst = (int32_t*)ptrs[kP_BFIRST];
    a.rtmp = (int32_t*)ptrs[kP_RTMP];
    a.rcnt = (int32_t*)ptrs[kP_RCNT];
    a.rbase = (int32_t*)ptrs[kP_RBASE];
    a.prefix = (float*)ptrs[kP_PREFIX];
    a.scan = (float*)ptrs[kP_SCAN];
    a.accept = (uint8_t*)ptrs[kP_ACCEPT];
    a.counts_it = (float*)ptrs[kP_COUNTS_IT];
    a.adds = (int32_t*)ptrs[kP_ADDS];
    a.minc = (float*)ptrs[kP_MINC];
    a.kept = (uint8_t*)ptrs[kP_KEPT];
    a.cand = (uint8_t*)ptrs[kP_CAND];
    a.admit = (uint8_t*)ptrs[kP_ADMIT];
    a.minpos = (int32_t*)ptrs[kP_MINPOS];
    a.carrier = (uint8_t*)ptrs[kP_CARRIER];
    a.z_mi = (uint8_t*)ptrs[kP_Z_MI];
    a.z_an = (uint8_t*)ptrs[kP_Z_AN];
    a.release = (uint8_t*)ptrs[kP_RELEASE];
    a.reason_c = (int32_t*)ptrs[kP_REASON_C];
    a.reasons = (int32_t*)ptrs[kP_REASONS];
    a.gang_dropped = (uint8_t*)ptrs[kP_GANG_DROPPED];
    a.gang_flags = (int32_t*)ptrs[kP_GANG_FLAGS];
    return 0;
}

// ---- shared memory ---------------------------------------------------------

constexpr int kNoTerm = 0x7fffffff;   // an invalid term's key: after every live one

// The inter-pod repair's live terms (listed by every block's start,
// prepare_repair, and kept in the launch's scratch, live_terms: a round's
// repair loads them into its shared memory).
struct LiveTerms {
    int n;                          // L: live terms
    int32_t term[kMaxTW * 32];      // (slot << 16) | t, ascending
};

// The inter-pod repair's dynamic shared memory (the other stages' buffers
// are free while it runs; the static shared memory stays the other
// stages', as a larger one would shrink the SM's L1 cache for all).
struct RepairSmem {
    LiveTerms live;
    int list[kClusterThreads];      // a chunk's accepted pods; the start's term keys
    int count;
    uint32_t gany[kMaxTW];          // the block's global_any bits
};

// The block's static shared memory (every stage).
struct Shared {
    Config cfg;
    Scratch sc;
    Slots slots;
    PodSpread ps;
    PodTerms pt;
    float req[kMaxR], nz[kMaxR];   // the class representative's requests
};

// The tie histogram of the class pass (dynamic shared memory; `hist` is
// read by the other blocks of the cluster).
struct HistSmem {
    int hist[kBuckets];    // this block's ties a bucket
    int start[kBuckets];   // the cluster's ties a bucket, then each bucket's first rank
    int fill[kBuckets];    // this block's next slot in each bucket
    int warp_sum[kMaxWarps];
    int cand;              // ties in the buckets that reach rank cnt
};

// One of the sorts a radix_sort call runs side by side.
struct SortSpec {
    const int32_t* src;   // the initial order (null: the identity)
    int32_t* out;         // the items stably sorted by key
    int32_t* tmp;         // [P] ping-pong
    int32_t* cnt;         // [tiles, kRadix] each tile's digit counts
    int32_t* base;        // [tiles, kRadix] each tile's first slot of each digit
};

// A radix sort pass (dynamic shared memory).
struct RadixSmem {
    int wc[kMaxWarps * kRadix];   // a warp's count of each digit, then its first slot
    int warp_sum[kMaxWarps];
    SortSpec spec[2];             // the acceptance's two sorts (as an array on the stack
                                  // they took local memory and the frame grew)
};

// The spread repair (dynamic shared memory, block 0).
struct SpreadSmem {
    int tab[kMaxWarps * kShZ];   // each warp's counter table (Z <= kShZ)
    float part[kMaxWarps];       // partial minima
    int rows[kRowChunk];         // the current chunk's hard rows
    int rows2[kRowChunk];        // the rows a commit added to
    int n_rows;
    uint8_t touched[kRowChunk];
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of a launch (bytes).
constexpr int kDynSmem = cmax(cmax(cmax((int)sizeof(HistSmem), (int)sizeof(RadixSmem)),
                                   (int)sizeof(SpreadSmem)), (int)sizeof(RepairSmem));

// ---- teams and block helpers ---------------------------------------------

// The cluster as block_eval's team without pass 1's speculation: pass 2
// writes every node's masked score, which the tie set is read from.
struct ExactTeam : ClusterTeam {
    static constexpr bool kSpeculate = false;
};

// Block-wide exclusive scan of one int a thread; every thread gets its
// exclusive prefix and the block's total.  Ends on a barrier.
__device__ inline int block_exclusive_scan(int v, int& total, int* warp_sum)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (int)(blockDim.x >> 5);
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int x = lane < nwarps ? warp_sum[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, off);
            if (lane >= off) x += y;
        }
        warp_sum[lane] = x;
    }
    __syncthreads();
    const int base = (warp > 0 ? warp_sum[warp - 1] : 0) + incl - v;
    total = warp_sum[nwarps - 1];
    __syncthreads();
    return base;
}

// Whether any thread of the cluster has `flag`: one exchange of the team's
// Step slots (flags OR), and the slot parity advanced.
__device__ inline bool cluster_any(bool flag, Shared& S, ExactTeam& team)
{
    Step st = step_zero();
    st.flags = flag ? 1 : 0;
    const Step all = team.reduce_step(st, S.sc);
    team.par ^= 1;
    return (all.flags & 1) != 0;
}

// ---- the class pass ------------------------------------------------------

__device__ __forceinline__ uint32_t tie_key(uint32_t rot, int nd)
{
    return (((uint32_t)(nd + 1) * kGolden) ^ rot) >> 2;
}

__device__ __forceinline__ int bucket_of(uint32_t key)
{
    return (int)(key >> (kKeyBits - kBucketBits));
}

// (key desc, index asc): node a comes before node b in the tie list
__device__ __forceinline__ bool before(uint32_t ka, int a, uint32_t kb, int b)
{
    return ka > kb || (ka == kb && a < b);
}

__device__ __forceinline__ uint32_t class_rot(int c, uint32_t rnd)
{
    return (((uint32_t)c * kGolden) ^ (rnd * kRound) ^ kSeedC) * kMix;
}

// H.start holds each bucket's ties: replace them by each bucket's first
// rank in descending bucket order (thread t holds descending ranks
// [per t, per (t + 1)), per = kBuckets / blockDim) and return the end of
// the bucket holding rank cnt - 1 (cnt > 0).  Block-wide.
__device__ inline int bucket_starts(HistSmem& H, int cnt)
{
    const int per = kBuckets / (int)blockDim.x;   // 1 or 2
    int local[2] = {0, 0};
    int sum = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        if (q < per) {
            local[q] = H.start[kBuckets - 1 - (per * (int)threadIdx.x + q)];
            sum += local[q];
        }
    }
    int total;
    int base = block_exclusive_scan(sum, total, H.warp_sum);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        if (q < per) {
            const int b = kBuckets - 1 - (per * (int)threadIdx.x + q);
            H.start[b] = base;
            if (base < cnt && base + local[q] >= cnt) H.cand = base + local[q];
            base += local[q];
        }
    }
    __syncthreads();
    return H.cand;
}

// Block-wide sum of one int a thread (every thread gets it).
__device__ inline int block_sum(int v, int* warp_sum)
{
    int total;
    block_exclusive_scan(v, total, warp_sum);
    return total;
}

// Class c's evaluation by the cluster: the class representative's requests
// into shared memory, the spread rows and term words of its constraint
// class's representative, then block_eval (every node's masked score into
// a.masked at the block's own nodes).
__device__ inline Eval class_eval(const Ctx& a, int c, Shared& S, const ExactTeam& team)
{
    const int s = min(max(a.jspec[c], 0), a.cs_dim - 1);
    const int rep = a.s_reps[s];
    for (int t = threadIdx.x; t < a.r; t += blockDim.x) {
        S.req[t] = a.pod_req[(size_t)rep * a.r + t];
        S.nz[t] = a.pod_nz[(size_t)rep * a.r + t];
    }
    __syncthreads();
    // the constraint class's representative carries the joint class's
    // spread rows, terms and match flags (the encoder's constraint
    // signature)
    const int k_rep = a.k_reps[min(max(a.jcons[c], 0), a.cc_dim - 1)];
    if (a.sp.on) block_spread_pod(a.sp, a.n, k_rep, S.ps, S.sc, team);
    if (a.tm.on) block_interpod_pod(a.tm, k_rep, S.pt);
    return block_eval(
        a.n, a.r, 0, false, a.alloc, a.requested, a.nonzero, nullptr,
        a.sfeas_s + (size_t)s * a.n, a.aff_s + (size_t)s * a.n, a.taint_s + (size_t)s * a.n,
        S.req, S.nz, nullptr, a.sp, S.ps, a.tm, S.pt,
        a.extra != nullptr ? a.extra + (size_t)c * a.n : nullptr, S.cfg, S.sc, a.masked,
        nullptr, nullptr, team);
}

// Class c's best, tie count and top list (inv_c[c], cnt_c[c], best_c[c])
// at round rnd, by the cluster.  Ends on a cluster barrier.
__device__ inline void class_pass(const Ctx& a, int c, uint32_t rnd, Shared& S, HistSmem& H,
                                  ExactTeam& team)
{
    const float* mrow = a.masked;
    int32_t* slots = a.slots;
    const Eval ev = class_eval(a, c, S, team);
    team.par ^= 1;
    const float best = ev.best;
    const uint32_t rot = class_rot(c, rnd);
    const int n = a.n;

    // this block's ties, histogrammed by the top bits of their keys
    for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) H.hist[b] = 0;
    __syncthreads();
    if (ev.found) {
        for (int nd = team.first(); nd < team.end(n); nd += team.stride()) {
            if (mrow[nd] == best) atomicAdd(&H.hist[bucket_of(tie_key(rot, nd))], 1);
        }
    }
    team.sync();
    // the team's ties a bucket, and this block's offset within each bucket
    // (the ties of the lower-ranked blocks)
    int part = 0;
    for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) {
        int tot = 0, off = 0;
        cg::cluster_group cluster = cg::this_cluster();
        for (unsigned g = 0; g < team.size_; ++g) {
            const int v = *cluster.map_shared_rank(&H.hist[b], g);
            tot += v;
            off += g < team.rank_ ? v : 0;
        }
        H.start[b] = tot;
        H.fill[b] = off;
        part += tot;
    }
    const int ties = block_sum(part, H.warp_sum);
    const int cnt = min(ties, a.tie_k);
    int cand = 0;
    if (cnt > 0) {
        cand = bucket_starts(H, cnt);
        // list the ties of the buckets that reach rank cnt, each block at
        // its own offset, unordered within a block's share
        for (int nd = team.first(); nd < team.end(n); nd += team.stride()) {
            if (mrow[nd] == best) {
                const int b = bucket_of(tie_key(rot, nd));
                if (H.start[b] < cnt) slots[H.start[b] + atomicAdd(&H.fill[b], 1)] = nd;
            }
        }
    }
    team.sync();
    if (cnt > 0) {
        // each listed tie's rank within its bucket gives its position
        for (int q = team.rank(); q < cand; q += team.size()) {
            const int nd = slots[q];
            const uint32_t key = tie_key(rot, nd);
            const int b = bucket_of(key);
            const int lo = H.start[b], hi = b > 0 ? H.start[b - 1] : ties;
            int rank = 0;
            for (int m = lo; m < hi; ++m) {
                const int o = slots[m];
                if (o != nd && before(tie_key(rot, o), o, key, nd)) ++rank;
            }
            const int pos = lo + rank;
            if (pos < cnt) a.inv_c[(size_t)c * a.tie_k + pos] = nd;
        }
    }
    if (team.rank() == 0) {
        a.cnt_c[c] = cnt;
        a.best_c[c] = best;
    }
}

// ---- the radix sort --------------------------------------------------------

// The digit of sorted position s of a tile (kRadix past the items), its
// lanes' match mask, and this warp's digit counts into R.wc.  Block-wide.
template <class KeyFn>
__device__ inline int tile_digits(int p, int s, const int32_t* src, KeyFn key, int shift,
                                  int& item, unsigned& peers, RadixSmem& R)
{
    const int warps = (int)(blockDim.x >> 5);
    item = s < p ? (src != nullptr ? src[s] : s) : -1;
    const int d = item >= 0 ? (key(item) >> shift) & (kRadix - 1) : kRadix;
    for (int e = threadIdx.x; e < warps * kRadix; e += blockDim.x) R.wc[e] = 0;
    __syncthreads();
    peers = __match_any_sync(0xffffffffu, d);
    if (d < kRadix && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        R.wc[(threadIdx.x >> 5) * kRadix + d] = __popc(peers);
    }
    __syncthreads();
    return d;
}

// Stably sort the `nsort` orders of spec by key(item) in [0, key_max],
// over the cluster: least-significant digit first, kRadixBits a pass.  A
// pass: each block counts the digits of its tiles (blockDim positions;
// tile t on block t % G), one barrier, each block scans the (digit, tile)
// counts for its own tiles' first slots and scatters its items, one
// barrier.  A tile's items keep their order within a digit: a warp's
// lanes of a digit by __match_any_sync, the warps in order, the tiles in
// order.
template <class KeyFn>
__device__ inline void radix_sort(int p, int key_max, int nsort, const SortSpec* spec,
                                  KeyFn key, RadixSmem& R, const ExactTeam& team)
{
    const int T = (int)blockDim.x, tid = (int)threadIdx.x;
    const int warps = T >> 5, lane = tid & 31;
    const int g = (int)team.size_, rank = (int)team.rank_;
    const int tiles = (p + T - 1) / T;
    const int bits = 32 - __clz(max(key_max, 1));
    const int passes = (bits + kRadixBits - 1) / kRadixBits;
    for (int pass = 0; pass < passes; ++pass) {
        const int shift = pass * kRadixBits;
        // the last pass writes `out`; earlier ones alternate so it does
        const bool to_out = ((passes - 1 - pass) & 1) == 0;
        for (int k = 0; k < nsort; ++k) {
            const SortSpec& sp = spec[k];
            const int32_t* src = pass == 0 ? sp.src : (to_out ? sp.tmp : sp.out);
            for (int t = rank; t < tiles; t += g) {
                int item;
                unsigned peers;
                tile_digits(p, t * T + tid, src, key, shift, item, peers, R);
                for (int d = tid; d < kRadix; d += T) {
                    int sum = 0;
                    for (int w = 0; w < warps; ++w) sum += R.wc[w * kRadix + d];
                    sp.cnt[(size_t)t * kRadix + d] = sum;
                }
                __syncthreads();
            }
        }
        team.sync();
        for (int k = 0; k < nsort; ++k) {
            const SortSpec& sp = spec[k];
            const int32_t* src = pass == 0 ? sp.src : (to_out ? sp.tmp : sp.out);
            int32_t* dst = to_out ? sp.out : sp.tmp;
            // each digit's first slot: the digits below it, then the
            // same digit's items in the tiles before
            int tot = 0;
            if (tid < kRadix) {
                for (int t = 0; t < tiles; ++t) tot += sp.cnt[(size_t)t * kRadix + tid];
            }
            int all;
            int run = block_exclusive_scan(tot, all, R.warp_sum);
            if (tid < kRadix) {
                for (int t = 0; t < tiles; ++t) {
                    if (t % g == rank) sp.base[(size_t)t * kRadix + tid] = run;
                    run += sp.cnt[(size_t)t * kRadix + tid];
                }
            }
            for (int t = rank; t < tiles; t += g) {
                int item;
                unsigned peers;
                const int d = tile_digits(p, t * T + tid, src, key, shift, item, peers, R);
                if (tid < kRadix) {
                    int x = sp.base[(size_t)t * kRadix + tid];
                    for (int w = 0; w < warps; ++w) {
                        const int c = R.wc[w * kRadix + tid];
                        R.wc[w * kRadix + tid] = x;
                        x += c;
                    }
                }
                __syncthreads();
                if (d < kRadix) {
                    const unsigned below = (1u << lane) - 1u;
                    dst[R.wc[(tid >> 5) * kRadix + d] + __popc(peers & below)] = item;
                }
                __syncthreads();
            }
        }
        team.sync();
    }
}

// first[key] = the first sorted position of each key present (and with
// `seen`, seen[key] = stamp), over the cluster.  The caller's next barrier
// publishes them.
template <class KeyFn>
__device__ inline void run_starts(int p, const int32_t* sorted, KeyFn key, int32_t* first,
                                  int32_t* seen, int stamp, const ExactTeam& team)
{
    for (int s = team.rank(); s < p; s += team.size()) {
        const int k = key(sorted[s]);
        if (s == 0 || key(sorted[s - 1]) != k) {
            first[k] = s;
            if (seen != nullptr) seen[k] = stamp;
        }
    }
}

// ---- the round's stages ------------------------------------------------------

// The class key of pod i: its class while active (unplaced and valid),
// else C.
__device__ __forceinline__ int class_key(const Ctx& a, int i)
{
    return (a.assigned[i] < 0 && a.pod_valid[i]) ? min(max(a.class_id[i], 0), a.c_dim - 1)
                                                 : a.c_dim;
}

// Bids of round rnd into bid / val, and each class's row in inv_c, cnt_c,
// best_c.  Ends on a cluster barrier.
__device__ inline void round_bids(const Ctx& a, int rnd, Shared& S, unsigned char* dyn,
                                  ExactTeam& team)
{
    RadixSmem& R = *(RadixSmem*)dyn;
    HistSmem& H = *(HistSmem*)dyn;
    auto ckey = [&](int i) { return class_key(a, i); };
    SortSpec cs = {a.order, a.cperm, a.rtmp, a.rcnt, a.rbase};
    radix_sort(a.p, a.c_dim, 1, &cs, ckey, R, team);
    run_starts(a.p, a.cperm, ckey, a.cfirst, a.cseen, rnd, team);
    team.sync();

    for (int c = 0; c < a.c_dim; ++c) {
        if (a.cseen[c] == rnd) class_pass(a, c, (uint32_t)rnd, S, H, team);
    }
    team.sync();

    // per pod: j = its sorted position less its class's first, then the
    // slot, the bid and the value
    for (int s = team.rank(); s < a.p; s += team.size()) {
        const int i = a.cperm[s];
        const int k = class_key(a, i);
        int b = a.n;
        float v = -INFINITY;
        if (k < a.c_dim) {
            const int cnt = a.cnt_c[k];
            const float best = a.best_c[k];
            if (best > -INFINITY && cnt > 0) {
                const int slot = (s - a.cfirst[k]) % max(cnt, 1);
                b = a.inv_c[(size_t)k * a.tie_k + slot];
                v = best;
            }
        }
        a.bid[i] = b;
        a.val[i] = v;
    }
    team.sync();
}

// Sequential inclusive scans of the blocks of kScanBlock rows of a [len, r]
// array, in place, over this block's threads; with `totals`, each block's
// total goes to its row there.
__device__ inline void scan_blocks(float* x, int len, int r, float* totals)
{
    const int nb = (len + kScanBlock - 1) / kScanBlock;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
        const int lo = b * kScanBlock, hi = min(len, lo + kScanBlock);
        for (int rr = 0; rr < r; ++rr) {
            float run = 0.0f;
            for (int q = lo; q < hi; ++q) {
                run = add(run, x[(size_t)q * r + rr]);
                x[(size_t)q * r + rr] = run;
            }
            if (totals) totals[(size_t)b * r + rr] = run;
        }
    }
}

// The acceptance of the round's bids into accept[i]: the bid sorts, the
// prefix and the capacity test.  Returns the cluster's progress (some pod
// accepted); ends on a cluster barrier.
__device__ inline bool round_accept(const Ctx& a, Shared& S, unsigned char* dyn,
                                    ExactTeam& team)
{
    RadixSmem& R = *(RadixSmem*)dyn;
    const int n = a.n, r = a.r, p = a.p;
    auto bkey = [&](int i) { return a.bid[i]; };
    const int tiles = (p + (int)blockDim.x - 1) / (int)blockDim.x;
    if (threadIdx.x == 0) {
        R.spec[0] = SortSpec{a.order, a.perm, a.rtmp, a.rcnt, a.rbase};
        R.spec[1] = SortSpec{nullptr, a.perm_idx, a.rtmp + p, a.rcnt + (size_t)tiles * kRadix,
                             a.rbase + (size_t)tiles * kRadix};
    }
    __syncthreads();
    radix_sort(p, n, 2, R.spec, bkey, R, team);
    run_starts(p, a.perm, bkey, a.bfirst, nullptr, 0, team);

    // level 0 of the prefix: each 16-row block summed in sequence, over
    // the cluster (gathered in perm order), its total into level 1
    const int nb0 = (p + kScanBlock - 1) / kScanBlock;
    for (int blk = team.rank(); blk < nb0; blk += team.size()) {
        const int lo = blk * kScanBlock, hi = min(p, lo + kScanBlock);
        for (int rr = 0; rr < r; ++rr) {
            float run = 0.0f;
            for (int q = lo; q < hi; ++q) {
                run = add(run, a.pod_req[(size_t)a.perm[q] * r + rr]);
                a.prefix[(size_t)q * r + rr] = run;
            }
            if (nb0 > 1) a.scan[(size_t)blk * r + rr] = run;
        }
    }
    team.sync();
    // the upper levels (block totals, recursively) on block 0: scanned
    // upwards, then each block's exclusive total added downwards; level 0
    // takes its add when read
    if (team.rank_ == 0 && nb0 > 1) {
        float* level[kMaxLevels];
        int len[kMaxLevels];
        level[1] = a.scan;
        len[1] = nb0;
        int top = 1;
        float* next = a.scan + (size_t)nb0 * r;
        while (len[top] > kScanBlock) {
            len[top + 1] = (len[top] + kScanBlock - 1) / kScanBlock;
            level[top + 1] = next;
            next += (size_t)len[top + 1] * r;
            ++top;
        }
        for (int k = 1; k <= top; ++k) {
            scan_blocks(level[k], len[k], r, k < top ? level[k + 1] : nullptr);
            __syncthreads();
        }
        for (int k = top - 1; k >= 1; --k) {
            for (int q = threadIdx.x; q < len[k]; q += blockDim.x) {
                const int b = q / kScanBlock;
                if (b == 0) continue;
                for (int rr = 0; rr < r; ++rr) {
                    level[k][(size_t)q * r + rr] = add(level[k][(size_t)q * r + rr],
                                                       level[k + 1][(size_t)(b - 1) * r + rr]);
                }
            }
            __syncthreads();
        }
    }
    team.sync();

    // acceptance per sorted position
    auto pre = [&](int q, int rr) {
        float v = a.prefix[(size_t)q * r + rr];
        const int b = q / kScanBlock;
        if (b > 0) v = add(v, a.scan[(size_t)(b - 1) * r + rr]);
        return v;
    };
    bool any_ok = false;
    for (int q = team.rank(); q < p; q += team.size()) {
        const int i = a.perm[q];
        const int b = a.bid[i];
        bool ok = b < n;
        if (ok) {
            const int f = a.bfirst[b];
            const int fi = a.perm[f];
            for (int rr = 0; rr < r; ++rr) {
                const float req = a.pod_req[(size_t)i * r + rr];
                const float within = add(sub(pre(q, rr), pre(f, rr)),
                                         a.pod_req[(size_t)fi * r + rr]);
                const float remaining = sub(a.alloc[(size_t)b * r + rr],
                                            a.requested[(size_t)b * r + rr]);
                if (!(req <= 0.0f || within <= remaining)) ok = false;
            }
        }
        a.accept[i] = ok ? 1 : 0;
        any_ok |= ok;
    }
    return cluster_any(any_ok, S, team);
}

// The commit of accept[] and the round state.  Returns the flag; ends on
// a cluster barrier.
__device__ inline bool round_commit(const Ctx& a, int rnd, bool progress, Shared& S,
                                    ExactTeam& team)
{
    const int n = a.n, r = a.r, p = a.p;
    // each node group's first position adds the accepted requests in pod
    // index order (the group spans the same positions in perm_idx)
    for (int q = team.rank(); q < p; q += team.size()) {
        const int b = a.bid[a.perm[q]];
        if (b >= n || a.bfirst[b] != q) continue;
        for (int q2 = q; q2 < p; ++q2) {
            const int i2 = a.perm_idx[q2];
            if (a.bid[i2] != b) break;
            if (!a.accept[i2]) continue;
            for (int rr = 0; rr < r; ++rr) {
                a.requested[(size_t)b * r + rr] = add(a.requested[(size_t)b * r + rr],
                                                      a.pod_req[(size_t)i2 * r + rr]);
                a.nonzero[(size_t)b * r + rr] = add(a.nonzero[(size_t)b * r + rr],
                                                    a.pod_nz[(size_t)i2 * r + rr]);
            }
        }
    }
    bool unplaced = false;
    for (int i = team.rank(); i < p; i += team.size()) {
        if (a.accept[i]) {
            a.assigned[i] = a.bid[i];
            a.bid_scores[i] = a.val[i];
        }
        unplaced |= a.assigned[i] < 0 && a.pod_valid[i];
    }
    unplaced = cluster_any(unplaced, S, team);
    const int rounds = rnd + 1;
    const bool go = rounds < a.max_rounds && progress && unplaced;
    if (team.rank() == 0) {
        a.state[0] = rounds;
        a.state[1] = go ? 1 : 0;
        a.state[2] = progress ? 1 : 0;
    }
    return go;
}

// ---- the spread repair (block 0) -------------------------------------------
//
// A pass takes the accepted pods not yet kept, the critical-path minimum
// of every row (min count over eligible nodes, 0 without one or under
// minDomains), and for each such pod and each of its hard rows whose bid
// node has a value: its rank, the number of earlier pods of the pass in
// solve order that match the row and bid a node of the same value; the pod
// is admitted unless some row has rank >= maxSkew + min - count + (1 -
// selfMatch).  The admits are committed into a working copy of the
// counts, so the next pass sees the raised minimum.  Then the kept pods are
// committed into the counts, and `accept` becomes the kept set.
//   rows     only the hard rows are read within a round (a soft row ranks
//            no pod), so the block lists them and keeps the working counts
//            of those rows alone;
//   minima   every hard row's critical-path minimum: with L listed rows
//            and W warps, W / L warps a row (one warp a row when L >= W),
//            each strided over N, merged by fminf;
//   ranks    a warp walks a hard row's P positions in solve order, 32 at
//            a time (kBatch chunks' loads issued, branch-free, before they
//            are walked); __match_any_sync gives the lanes of a value, and
//            the rank is that value's running counter plus the matching
//            peers in lower lanes; the lowest lane of each value then adds
//            the value's matching peers to the counter.  The counters are
//            the row's [Z] table: in shared memory when Z <= kShZ (a zone
//            key), else the row's slice of the global [C, Z] scratch `adds`
//            (a hostname key).  With shared tables and L < W hard rows,
//            each row gets W / L warps over contiguous segments of the
//            solve order (a counting sweep and an exclusive prefix over the
//            row's warps give each segment its starting counters);
//   commit   integer counts added in value space with integer atomics, then
//            read back per node in the rows some pod added to.
// Exactness: ranks are integers and counts integer-valued floats below
// 2^24, so neither the order of the atomics nor the split of the minima
// changes a bit.

// List map(q) for every q < count with keep(q) into out (in no particular
// order).  Block-wide; ends on a barrier.  Returns the count listed.
template <class Keep, class Map>
__device__ inline int list_rows(int count, Keep keep, Map map, int* out, SpreadSmem& sh)
{
    if (threadIdx.x == 0) sh.n_rows = 0;
    __syncthreads();
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
        if (keep(q)) out[atomicAdd(&sh.n_rows, 1)] = map(q);
    }
    __syncthreads();
    return sh.n_rows;
}

__device__ inline int list_hard(const Spread& sp, int cb, SpreadSmem& sh)
{
    return list_rows(min(kRowChunk, sp.c_dim - cb), [&](int q) { return sp.hard[cb + q] != 0; },
                     [&](int q) { return cb + q; }, sh.rows, sh);
}

// counts[c, n] += the marked pods' placements in row c at the nodes that
// share their bid node's value: with hard_only in the hard rows (the
// working counts), else in every row.
__device__ inline void commit_marked(const Spread& sp, int n, int p, int z, const int32_t* bid,
                                     const uint8_t* marked, bool hard_only, int32_t* adds,
                                     float* counts, SpreadSmem& sh)
{
    const int tid = threadIdx.x;
    const int c_dim = sp.c_dim;
    for (int cb = 0; cb < c_dim; cb += kRowChunk) {
        const int rows = hard_only ? list_hard(sp, cb, sh) : min(kRowChunk, c_dim - cb);
        auto row = [&](int q) { return hard_only ? sh.rows[q] : cb + q; };
        for (int q = tid; q < rows; q += blockDim.x) sh.touched[q] = 0;
        for (int t = tid; t < rows * z; t += blockDim.x) adds[(size_t)row(t / z) * z + t % z] = 0;
        __syncthreads();
#pragma unroll 4
        for (int t = tid; t < p * rows; t += blockDim.x) {
            const int i = t / rows, q = t % rows, c = row(q);
            if (!(marked[i] & sp.pod_matches[(size_t)i * c_dim + c])) continue;
            const size_t o = (size_t)c * n + min(max(bid[i], 0), n - 1);
            const int val = sp.v[o];
            if (sp.eligible[o] && val >= 0) {
                atomicAdd(&adds[(size_t)c * z + min(val, z - 1)], 1);
                sh.touched[q] = 1;
            }
        }
        __syncthreads();
        const int nt = list_rows(rows, [&](int q) { return sh.touched[q] != 0; }, row,
                                 sh.rows2, sh);
        for (int t = tid; t < nt * n; t += blockDim.x) {
            const int c = sh.rows2[t / n];
            const size_t o = (size_t)c * n + t % n;
            const int val = sp.v[o];
            if (val < 0) continue;
            const int x = adds[(size_t)c * z + min(val, z - 1)];
            if (x) counts[o] = add(counts[o], (float)x);
        }
        __syncthreads();
    }
}

// The critical-path minimum of each listed row against the working counts.
__device__ inline void row_minima(const Spread& sp, int n, int n_rows, const float* counts_it,
                                  float* minc, SpreadSmem& sh)
{
    if (n_rows == 0) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warps = (int)(blockDim.x >> 5);
    const int wpr = n_rows >= warps ? 1 : warps / n_rows;   // warps a row
    const int at_once = warps / wpr;                        // rows in flight
    for (int base = 0; base < n_rows; base += at_once) {
        const int rw = base + warp / wpr, part = warp % wpr;
        float m = kBig;
        if (warp < at_once * wpr && rw < n_rows) {
            const size_t o = (size_t)sh.rows[rw] * n;
            for (int nd = part * 32 + lane; nd < n; nd += wpr * 32) {
                if (sp.eligible[o + nd]) m = fminf(m, counts_it[o + nd]);
            }
        }
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
        if (lane == 0) sh.part[warp] = m;
        __syncthreads();
        if (tid < at_once && base + tid < n_rows) {
            float mm = kBig;
            for (int q = 0; q < wpr; ++q) mm = fminf(mm, sh.part[tid * wpr + q]);
            const int c = sh.rows[base + tid];
            minc[c] = spread_min_final(sp, c, mm);
        }
        __syncthreads();
    }
}

// One solve position in row c: the candidate's value key (-1: not a
// candidate matching or ranked in the row), whether it counts (matches the
// row) and is ranked (the row is its own hard row), and its bound.
struct Entry {
    int key, pod;
    bool from, ranked;
    float allowed;
};

__device__ __forceinline__ Entry load_entry(const Spread& sp, int n, int p, int z, int c,
                                            float skew_min, int k, const int32_t* order,
                                            const int32_t* bid, const uint8_t* cand,
                                            const float* counts_it)
{
    const bool in = k < p;
    const int i = order[in ? k : 0];
    const size_t o = (size_t)c * n + min(max(bid[i], 0), n - 1);
    const bool m = sp.pod_matches[(size_t)i * sp.c_dim + c] != 0;
    bool own = false;
    for (int j = 0; j < sp.mc; ++j) {
        const int cidx = sp.pod_idx[(size_t)i * sp.mc + j];
        own |= cidx >= 0 && min(cidx, sp.c_dim - 1) == c;
    }
    const int val = sp.v[o];
    const float cnt = counts_it[o];
    const bool act = in && cand[i] && val >= 0 && (m || own);
    Entry e;
    e.key = act ? min(val, z - 1) : -1;
    e.pod = i;
    e.from = act && m;
    e.ranked = act && own;
    e.allowed = add(sub(skew_min, cnt), sub(1.0f, m ? 1.0f : 0.0f));
    return e;
}

// The admit test of one pass over the listed (hard) rows.
__device__ inline void rank_rows(const Spread& sp, int n, int p, int z, int n_rows,
                                 const int32_t* order, const int32_t* bid, const uint8_t* cand,
                                 const float* counts_it, const float* minc, int32_t* adds,
                                 uint8_t* admit, SpreadSmem& sh)
{
    if (n_rows == 0) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = (int)(blockDim.x >> 5);
    const unsigned below = (1u << lane) - 1u;   // lanemask_lt
    const bool in_shared = z <= kShZ;
    const int wpr = in_shared && n_rows < warps ? warps / n_rows : 1;   // warps a row
    const int at_once = warps / wpr;
    const int seg = (p + wpr * 32 - 1) / (wpr * 32) * 32;   // a warp's positions
    for (int base = 0; base < n_rows; base += at_once) {
        const int rw = base + warp / wpr, part = warp % wpr;
        const bool active = warp < at_once * wpr && rw < n_rows;
        const int c = active ? sh.rows[rw] : 0;
        int* tab = in_shared ? sh.tab + warp * kShZ : adds + (size_t)c * z;
        const int k_lo = min(p, part * seg), k_hi = min(p, k_lo + seg);
        const float skew_min = active ? add(sp.max_skew[c], minc[c]) : 0.0f;
        if (active) {
            for (int t = lane; t < z; t += 32) tab[t] = 0;
            __syncwarp();
        }
        if (wpr > 1) {
            if (active) {
                for (int k = k_lo + lane; k < k_hi; k += 32) {
                    const Entry e = load_entry(sp, n, p, z, c, skew_min, k, order, bid, cand,
                                               counts_it);
                    if (e.from) atomicAdd(&tab[e.key], 1);
                }
            }
            __syncthreads();
            // exclusive prefix over each row's warps, value by value
            for (int t = threadIdx.x; t < at_once * z; t += blockDim.x) {
                const int rr = t / z, v = t % z;
                if (base + rr >= n_rows) continue;
                int run = 0;
                for (int q = 0; q < wpr; ++q) {
                    int* cell = sh.tab + (rr * wpr + q) * kShZ + v;
                    const int x = *cell;
                    *cell = run;
                    run += x;
                }
            }
            __syncthreads();
        }
        if (active) {
            for (int k0 = k_lo; k0 < k_hi; k0 += 32 * kBatch) {
                Entry e[kBatch];
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const int k = k0 + b * 32 + lane;
                    e[b] = load_entry(sp, n, p, z, c, skew_min, k < k_hi ? k : p, order, bid,
                                      cand, counts_it);
                }
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const unsigned peers = __match_any_sync(0xffffffffu, e[b].key);
                    const unsigned group = peers & __ballot_sync(0xffffffffu, e[b].from);
                    const int before = e[b].key >= 0 ? tab[e[b].key] : 0;
                    if (e[b].ranked && (float)(before + __popc(group & below)) >= e[b].allowed) {
                        admit[e[b].pod] = 0;
                    }
                    __syncwarp();
                    if (e[b].key >= 0 && group != 0u && lane == __ffs(peers) - 1) {
                        tab[e[b].key] = before + __popc(group);
                    }
                    __syncwarp();
                }
            }
        }
        __syncthreads();
    }
}

// The spread repair of accept[] against bid[] and the commit of the kept
// pods into sp.counts.  Block-wide (any block size).
__device__ inline void spread_repair(const Ctx& a, SpreadSmem& sh)
{
    const Spread& sp = a.sp;
    const int n = a.n, p = a.p, z = a.sp_z;
    const int tid = threadIdx.x;
    const int c_dim = sp.c_dim;
    for (int i = tid; i < p; i += blockDim.x) a.kept[i] = 0;
    // the working counts: only the hard rows are ever read
    for (int cb = 0; cb < c_dim; cb += kRowChunk) {
        const int nh = list_hard(sp, cb, sh);
        for (int t = tid; t < nh * n; t += blockDim.x) {
            const size_t o = (size_t)sh.rows[t / n] * n + t % n;
            a.counts_it[o] = sp.counts[o];
        }
        __syncthreads();
    }
    for (int it = 0; it < kRepairIters; ++it) {
        for (int i = tid; i < p; i += blockDim.x) {
            const uint8_t cd = a.accept[i] && !a.kept[i];
            a.cand[i] = cd;
            a.admit[i] = cd;
        }
        for (int cb = 0; cb < c_dim; cb += kRowChunk) {
            const int nh = list_hard(sp, cb, sh);         // ends on a barrier
            row_minima(sp, n, nh, a.counts_it, a.minc, sh);
            rank_rows(sp, n, p, z, nh, a.order, a.bid, a.cand, a.counts_it, a.minc, a.adds,
                      a.admit, sh);
            __syncthreads();
        }
        commit_marked(sp, n, p, z, a.bid, a.admit, true, a.adds, a.counts_it, sh);
        for (int i = tid; i < p; i += blockDim.x) a.kept[i] |= a.admit[i];
        __syncthreads();
    }
    // the kept pods' counts, and the accepted set the commit reads
    commit_marked(sp, n, p, z, a.bid, a.kept, false, a.adds, sp.counts, sh);
    for (int i = tid; i < p; i += blockDim.x) a.accept[i] = a.kept[i];
    __syncthreads();
}

// ---- the inter-pod anti-affinity repair (over the cluster) ----------------
//
// Replaces: kubernetes_tpu/ops/auction.py:587-614 `interpod_repair` and
// :654-678 `commit_terms` (plain twins ops/auction.py interpod_repair_plain
// and commit_terms_plain).
//
// A pod of the accepted set is involved in group (v, t) when it matches
// term t or carries t as an anti-affinity term, and its bid node has value
// v in t's topology slot.  In every group that holds an involved carrier
// of the term, every involved pod after the group's first in solve order
// is released.  Then the kept pods commit: the terms they match turn
// present, and their anti terms blocked, on every node that shares the bid
// node's value in the term's slot; the terms they match turn globally
// present.
//
// Once a launch, in every block's start (prepare_repair):
//   live terms   the valid terms (every valid term has a slot: its slot is
//                clipped into the key axis), listed by (slot, term), each
//                as (slot << 16) | t; L of them, kept in the scratch
//                (live_terms) and loaded into the dynamic shared memory at
//                each round's repair.  A group is (value, live index):
//                tables of Z x L entries, not Z x T.
//   pair flags   [P, L] bytes over the cluster: bit 0 the pod matches the
//                live term (terms.matches_incoming), bit 1 it carries it
//                as an anti term (terms.anti_idx); each pod's solve
//                position.  At A, reading the bits in every pass instead
//                of a table made the loop's launch 28-31 us slower (0.390
//                against 0.362 ms in turns on an NVIDIA H100 80GB HBM3 at
//                700 W, PERF.md §6).
//   groups       every group's minimum set to kBigI and its three flags to
//                0, and every release flag to 0, over the cluster.
// A round, over the cluster (a cluster barrier between passes):
//   pairs        block b owns the pods [b P / G, (b + 1) P / G) (ceil),
//                walked in chunks of its threads: the chunk's accepted pods
//                are compacted into shared memory (warp ballots), and the
//                block's threads walk (compacted pod, live term) pairs,
//                skipping the pairs the flags leave out and the pods whose
//                bid node has no value in the term's slot.
//     1. minima  atomicMin of the pod's solve position into its group's
//                minimum; a carrier stores 1 into the group's carrier flag.
//     2. release a pod after its group's minimum in a group with a carrier
//                is released (its flag, then accept cleared: the block owns
//                the pod, so a block barrier orders them).
//     3. commit  each kept pod stores 1 into its groups' z_mi (matched
//                terms) and z_an (anti terms); the matched terms' bits are
//                OR-ed into a block word set in shared memory, then into
//                global_any (one atomicOr a word a block).
//     4. nodes   a thread a node (the team's 32-node chunks): the node's
//                value in each live slot read once (the list runs slot by
//                slot), and for each live term its group's two flags; a
//                set flag ORs the term's bit into the node's present /
//                blocked word, which only this thread writes.
//   clear        after the round's last barrier, each block walks its pods
//                that were accepted before the release (accept | release)
//                and resets their groups — every group the round wrote —
//                and their release flags.  No block reads the groups again
//                before the next round's pass 1, several cluster barriers
//                later, so no stale group survives into the next round.
// Exactness: the minima are integer atomicMin, the flags stores of 1, the
// global words OR: each pass's result is the same whatever order its
// threads run in and however the pods and nodes are split over the blocks,
// so the cluster gives the bits one block gives, and the group tables a
// round reads hold only that round's writes (the start's reset, then the
// clear of each round's groups).  The group of (pod, term) is
// (min(v, Z - 1), term) as before: only its index in the table changed.

// Pod i matches valid term t / carries valid term t as an anti term.
__device__ __forceinline__ bool term_mi(const Ctx& a, int i, int t)
{
    return a.term_valid[t] && ((a.mi_words[(size_t)i * a.tm.w + (t >> 5)] >> (t & 31)) & 1u);
}

__device__ __forceinline__ bool term_anti(const Ctx& a, int i, int t)
{
    if (!a.term_valid[t]) return false;
    bool hit = false;
    for (int j = 0; j < a.tm_ma; ++j) hit |= a.anti_idx[(size_t)i * a.tm_ma + j] == t;
    return hit;
}

// The launch's repair tables (every block; its start, before its
// cluster barrier): the block's list of live terms (block 0 keeps it in
// live_terms), then over the cluster the solve positions, the pair flags
// and the reset groups.
__device__ inline void prepare_repair(const Ctx& a, RepairSmem& sm, const ExactTeam& team)
{
    const int t_dim = a.t_dim;
    LiveTerms& lt = sm.live;
    if (threadIdx.x == 0) lt.n = 0;
    for (int t = threadIdx.x; t < t_dim; t += blockDim.x) {
        const int s = min(max(a.slot_of_t[t], 0), a.tk - 1);
        sm.list[t] = a.term_valid[t] ? (s << 16) | t : kNoTerm;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < t_dim; t += blockDim.x) {
        const int key = sm.list[t];
        if (key == kNoTerm) continue;
        int rank = 0;
        for (int u = 0; u < t_dim; ++u) rank += sm.list[u] < key;
        lt.term[rank] = key;
        atomicAdd(&lt.n, 1);
    }
    __syncthreads();
    const int nl = lt.n;
    if (team.rank_ == 0) {
        for (int k = threadIdx.x; k < nl; k += blockDim.x) a.live_terms[1 + k] = lt.term[k];
        if (threadIdx.x == 0) a.live_terms[0] = nl;
    }
    for (int s = team.rank(); s < a.p; s += team.size()) {
        a.solve_pos[a.order[s]] = s;
        a.release[s] = 0;
    }
    const size_t pairs = (size_t)a.p * nl;
    for (size_t e = team.rank(); e < pairs; e += team.size()) {
        const int i = (int)(e / nl), t = lt.term[e % nl] & 0xffff;
        a.pair_inv[e] = (uint8_t)(term_mi(a, i, t) | (term_anti(a, i, t) << 1));
    }
    const size_t groups = (size_t)a.tz * nl;
    for (size_t g = team.rank(); g < groups; g += team.size()) {
        a.minpos[g] = kBigI;
        a.carrier[g] = 0;
        a.z_mi[g] = 0;
        a.z_an[g] = 0;
    }
}

// This block's pods [lo, hi): ceil(P / G) a block.
__device__ __forceinline__ void block_pods(const Ctx& a, const ExactTeam& team, int& lo, int& hi)
{
    const int per = (a.p + (int)team.size_ - 1) / (int)team.size_;
    lo = min(a.p, (int)team.rank_ * per);
    hi = min(a.p, lo + per);
}

// fn(i, t, gi, inv) for every involved (pod, live term) pair of this
// block's pods with keep(i) whose bid node has a value in the term's slot:
// gi its group, inv its pair flags.  Block-wide; ends on a block barrier.
template <class Keep, class Fn>
__device__ inline void walk_pairs(const Ctx& a, RepairSmem& sm, const ExactTeam& team, Keep keep,
                                  Fn fn)
{
    const LiveTerms& lt = sm.live;
    int lo, hi;
    block_pods(a, team, lo, hi);
    const int nl = lt.n;
    const int lane = threadIdx.x & 31;
    for (int base = lo; base < hi; base += blockDim.x) {
        if (threadIdx.x == 0) sm.count = 0;
        __syncthreads();
        const int i = base + threadIdx.x;
        const bool take = i < hi && keep(i);
        const unsigned mask = __ballot_sync(0xffffffffu, take);
        int first = 0;
        if (lane == 0 && mask) first = atomicAdd(&sm.count, __popc(mask));
        first = __shfl_sync(0xffffffffu, first, 0);
        if (take) sm.list[first + __popc(mask & ((1u << lane) - 1u))] = i;
        __syncthreads();
        const int pairs = sm.count * nl;
        for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
            const int ip = sm.list[e / nl], k = e % nl;
            const int inv = a.pair_inv[(size_t)ip * nl + k];
            if (!inv) continue;
            const int key = lt.term[k];
            const int node = min(max(a.bid[ip], 0), a.n - 1);
            const int v = a.topo_ids[(size_t)node * a.tk + (key >> 16)];
            if (v < 0) continue;
            fn(ip, key & 0xffff, min(v, a.tz - 1) * nl + k, inv);
        }
        __syncthreads();
    }
}

// One round's repair of the accepted set and the kept pods' term commit,
// over the cluster: the live terms loaded into shared memory, then the
// passes.  Ends after the node pass (no barrier).
__device__ inline void interpod_repair(const Ctx& a, RepairSmem& sm, const ExactTeam& team)
{
    LiveTerms& lt = sm.live;
    const int nl = a.live_terms[0];
    for (int k = threadIdx.x; k < nl; k += blockDim.x) lt.term[k] = a.live_terms[1 + k];
    if (threadIdx.x == 0) lt.n = nl;
    __syncthreads();
    auto accepted = [&](int i) { return a.accept[i] != 0; };
    // 1. each group's first involved position in solve order, and its carriers
    walk_pairs(a, sm, team, accepted, [&](int i, int, int gi, int inv) {
        atomicMin(&a.minpos[gi], a.solve_pos[i]);
        if (inv & 2) a.carrier[gi] = 1;
    });
    team.sync();
    // 2. release every involved pod after the first of a group with a carrier
    walk_pairs(a, sm, team, accepted, [&](int i, int, int gi, int) {
        if (a.carrier[gi] && a.solve_pos[i] > a.minpos[gi]) a.release[i] = 1;
    });
    int lo, hi;
    block_pods(a, team, lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        if (a.release[i]) a.accept[i] = 0;
    }
    if (threadIdx.x < a.tm.w) sm.gany[threadIdx.x] = 0u;
    // 3. the kept pods' terms in value space, and the global bits
    walk_pairs(a, sm, team, accepted, [&](int, int t, int gi, int inv) {
        if (inv & 1) {
            a.z_mi[gi] = 1;
            atomicOr(&sm.gany[t >> 5], 1u << (t & 31));
        }
        if (inv & 2) a.z_an[gi] = 1;
    });
    if (threadIdx.x < a.tm.w && sm.gany[threadIdx.x]) {
        atomicOr(&a.tm.global_any[threadIdx.x], sm.gany[threadIdx.x]);
    }
    team.sync();
    // 4. node space: bit t of a node turns on when its group in t's slot did
    const int w = a.tm.w;
    for (int nd = team.first(); nd < a.n; nd += team.stride()) {
        int slot = -1, v = -1;
        for (int k = 0; k < nl; ++k) {
            const int key = lt.term[k];
            if ((key >> 16) != slot) {
                slot = key >> 16;
                v = a.topo_ids[(size_t)nd * a.tk + slot];
            }
            if (v < 0) continue;
            const size_t gi = (size_t)min(v, a.tz - 1) * nl + k;
            const int t = key & 0xffff;
            const uint32_t bit = 1u << (t & 31);
            if (a.z_mi[gi]) a.tm.present[(size_t)nd * w + (t >> 5)] |= bit;
            if (a.z_an[gi]) a.tm.blocked[(size_t)nd * w + (t >> 5)] |= bit;
        }
    }
}

// After the round's last cluster barrier: the groups of this block's pods
// accepted before the release, and their release flags, back to their
// reset values (the live terms still in shared memory from the repair).
__device__ inline void interpod_clear(const Ctx& a, RepairSmem& sm, const ExactTeam& team)
{
    walk_pairs(a, sm, team, [&](int i) { return (a.accept[i] | a.release[i]) != 0; },
               [&](int, int, int gi, int) {
                   a.minpos[gi] = kBigI;
                   a.carrier[gi] = 0;
                   a.z_mi[gi] = 0;
                   a.z_an[gi] = 0;
               });
    int lo, hi;
    block_pods(a, team, lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) a.release[i] = 0;
}

// The repairs of the round's accepted set: the spread repair on block 0
// while the others wait, then the inter-pod repair over the cluster.  The
// inter-pod clear follows the last barrier.
__device__ inline void round_repairs(const Ctx& a, unsigned char* dyn, const ExactTeam& team)
{
    if (a.sp.on) {
        if (team.rank_ == 0) spread_repair(a, *(SpreadSmem*)dyn);
        team.sync();
    }
    if (a.tm.on) {
        RepairSmem& sm = *(RepairSmem*)dyn;
        interpod_repair(a, sm, team);
        team.sync();
        interpod_clear(a, sm, team);
    }
}

// ---- the reasons pass ------------------------------------------------------
//
// Replaces: kubernetes_tpu/ops/auction.py:765-823 (inside
// auction_assign_jit, :855), after the loop's flag falls, against the
// final state (requested, the spread counts and the term bits — before the
// gang stage below, as the reference names its reasons before its gang
// post-pass): per joint class, the stage anys of block_eval's pass-1
// filter chain for its spec class's representative (static row, resource
// fit) and its constraint class's (hard spread rows with their
// critical-path minima, the inter-pod words); the first stage that empties
// the set names the class's reason, and a class with survivors at every
// stage parked on contention (a resource reason), as class_reason does
// (:797-818).  Every class is evaluated: a padded pod takes its class's
// reason too.  No host port stage: the auction takes no batch with
// in-batch host ports.
//
// Bound on this card: allocatable and the final usage (8 R bytes a node),
// each spec class's static row (a byte a node) and its representative's
// requests read once; with the spread family each constraint class's hard
// rows (eligible, value and count: 9 bytes a node a row), with the
// inter-pod family the nodes' present, blocked and key words (12 W bytes
// a node) and each constraint class's pod words; each pod's class and
// assignment read and its reason written (12 bytes a pod).  A few flops a
// node and class: microseconds of the card's memory rate
// (chip_smoke.reasons_need).  What a design pays is its cluster barriers
// and the passes over the nodes.
//
// Design, over the cluster: a class's flags are ORs of per-node bits, so
// any order of the nodes gives the same flags.  The joint classes go in
// groups of 32, a class a bit of a word.  A group's distinct spec classes
// and distinct constraint classes (at most 32 each, __match_any_sync over
// its jspec / jcons) are staged in the dynamic shared memory once: the
// spec classes' representative requests, the constraint classes' spread
// rows and term words (pod_spread_rows, pod_terms_words), and with the
// spread family each hard row's block minimum, merged over the cluster by
// one pull through distributed shared memory (one cluster barrier a group;
// the minima double-buffered, so no second barrier).  Then one pass over
// the nodes: for its node a thread ORs the group's class mask of each spec
// class whose static row holds (static) and whose requests fit
// (resources), then, where some class fits, of each constraint class
// whose hard spread rows pass (spread) and then its inter-pod test; a
// class's spread and inter-pod bits are those masks ANDed with the fit.
// The four words reach the block by __reduce_or_sync and one shared
// atomicOr a warp.  After the last group one cluster barrier, and each
// block pulls every block's words (4 a group) through DSMEM, names each
// class's reason and writes its pods'.  Cluster barriers: one a group
// with the spread family, and one for the flags, whatever c_dim is (up to
// 2,048 classes; past them, one more a batch of 2,048).

constexpr int kReasonGroup = 32;     // joint classes of a node pass: a bit each
constexpr int kReasonWords = 256;    // flag words merged at once: 4 a group

// The reasons pass's dynamic shared memory (`flags` and `bmin` are read by
// the other blocks of the cluster).
struct ReasonsSmem {
    float req[kReasonGroup * kMaxR];        // the group's spec classes' representative requests
    PodSpread ps[kReasonGroup];             // its constraint classes' spread rows
    PodTerms pt[kReasonGroup];              // and term words
    float bmin[2][kReasonGroup * kMaxMC];   // this block's minimum of each hard row
    uint32_t spec_mask[kReasonGroup];       // the group's joint classes of each spec class
    uint32_t cons_mask[kReasonGroup];       // ... of each constraint class
    int spec_of[kReasonGroup];              // the group's distinct spec classes
    int cons_of[kReasonGroup];              // ... constraint classes
    int n_spec, n_cons;
    uint32_t flags[kReasonWords];           // this block's stage anys: word 4 g + f, bit c % 32
    uint32_t all[kReasonWords];             // the cluster's
};
static_assert(sizeof(ReasonsSmem) <= kDynSmem, "the reasons pass fits the launch's buffers");

// Joint class c's flags (Step.flags bits 0 static, 1 resources, 3 spread,
// 5 inter-pod) in a batch's words: group c / 32, bit c % 32.
__device__ __forceinline__ int class_flags_of(const uint32_t* words, int c)
{
    const uint32_t* w = words + 4 * (c / kReasonGroup);
    const int b = c % kReasonGroup;
    return (int)((w[0] >> b) & 1u) | (int)((w[1] >> b) & 1u) << 1
        | (int)((w[2] >> b) & 1u) << 3 | (int)((w[3] >> b) & 1u) << 5;
}

// class_reason's code of a class's stage flags.
__device__ __forceinline__ int reason_of(int flags)
{
    return (flags & 32) ? kReasonResources   // feasible yet unplaced: contention
        : !(flags & 1) ? kReasonStatic
        : !(flags & 2) ? kReasonResources
        : !(flags & 8) ? kReasonSpread
        : kReasonInterpod;
}

// The distinct spec and constraint classes of the joint classes [c0, c0 +
// size): warp 0 matches their indices; each distinct class gets a slot,
// its index and the mask of its joint classes.  Block-wide.
__device__ inline void group_classes(const Ctx& a, int c0, int size, ReasonsSmem& R)
{
    if (threadIdx.x < 32) {
        const int lane = (int)threadIdx.x;
        const bool in = lane < size;
        const int s = in ? min(max(a.jspec[c0 + lane], 0), a.cs_dim - 1) : -1;
        const int k = in ? min(max(a.jcons[c0 + lane], 0), a.cc_dim - 1) : -1;
        const unsigned below = (1u << lane) - 1u;
        const unsigned s_peers = __match_any_sync(0xffffffffu, s);
        const unsigned k_peers = __match_any_sync(0xffffffffu, k);
        const bool s_lead = in && __ffs(s_peers) - 1 == lane;
        const bool k_lead = in && __ffs(k_peers) - 1 == lane;
        const unsigned s_leads = __ballot_sync(0xffffffffu, s_lead);
        const unsigned k_leads = __ballot_sync(0xffffffffu, k_lead);
        if (s_lead) {
            const int u = __popc(s_leads & below);
            R.spec_mask[u] = s_peers;
            R.spec_of[u] = s;
        }
        if (k_lead) {
            const int v = __popc(k_leads & below);
            R.cons_mask[v] = k_peers;
            R.cons_of[v] = k;
        }
        if (lane == 0) {
            R.n_spec = __popc(s_leads);
            R.n_cons = __popc(k_leads);
        }
    }
    __syncthreads();
}

// The group's preps: its spec classes' representative requests, its
// constraint classes' rows and words (a thread a class), and with the
// spread family each hard row's minimum over the cluster — this block's
// into bmin[par], one cluster barrier, every block's pulled.  Block-wide.
__device__ inline void group_preps(const Ctx& a, int par, ReasonsSmem& R, Shared& S,
                                   const ExactTeam& team)
{
    const int r = a.r, ns = R.n_spec, nc = R.n_cons;
    for (int e = threadIdx.x; e < ns * r; e += blockDim.x) {
        R.req[e] = a.pod_req[(size_t)a.s_reps[R.spec_of[e / r]] * r + e % r];
    }
    if ((int)threadIdx.x < nc) {
        const int k_rep = a.k_reps[R.cons_of[threadIdx.x]];
        if (a.sp.on) pod_spread_rows(a.sp, k_rep, R.ps[threadIdx.x]);
        if (a.tm.on) pod_terms_words(a.tm, k_rep, R.pt[threadIdx.x]);
    }
    __syncthreads();
    if (!a.sp.on) return;
    const int mc = a.sp.mc;
    for (int e = 0; e < nc * mc; ++e) {
        const PodSpread& ps = R.ps[e / mc];
        const int j = e % mc;
        if (!ps.enforced[j]) continue;   // uniform: read from shared memory
        const float m = block_spread_min(a.sp, a.n, team.first(), team.stride(), a.n, ps.c[j],
                                         S.sc);
        if (threadIdx.x == 0) R.bmin[par][(e / mc) * kMaxMC + j] = m;
    }
    team.sync();
    cg::cluster_group cluster = cg::this_cluster();
    for (int e = threadIdx.x; e < nc * mc; e += blockDim.x) {
        PodSpread& ps = R.ps[e / mc];
        const int j = e % mc;
        if (!ps.enforced[j]) continue;
        const int o = (e / mc) * kMaxMC + j;
        float m = kBig;
        for (unsigned b = 0; b < team.size_; ++b) {
            m = fminf(m, *cluster.map_shared_rank(&R.bmin[par][o], b));
        }
        ps.minm[j] = spread_min_final(a.sp, ps.c[j], m);
    }
    __syncthreads();
}

// The group's pass over this block's nodes: its four class words OR-ed
// into the block's words at `w` (warp reductions, one shared atomicOr a
// warp and word).  kR > 0: a node's usage and allocatable rows are read
// once into registers (the batch's r <= kR, the rows padded with zero
// requests, which every test passes); 0: read at each spec class's test
// (an L1 hit after the first).
template <int kR>
__device__ inline void group_nodes(const Ctx& a, uint32_t* w, const ReasonsSmem& R,
                                   const ExactTeam& team)
{
    const int n = a.n, r = a.r, ns = R.n_spec, nc = R.n_cons;
    uint32_t hard = 0u;   // the constraint classes with a hard spread row
    if (a.sp.on) {
        for (int v = 0; v < nc; ++v) hard |= R.ps[v].any_hard ? 1u << v : 0u;
    }
    uint32_t f_static = 0u, f_res = 0u, f_spread = 0u, f_inter = 0u;
    for (int nd = team.first(); nd < n; nd += team.stride()) {
        const float* rq = a.requested + (size_t)nd * r;
        const float* cap = a.alloc + (size_t)nd * r;
        float rq_r[kR > 0 ? kR : 1], cap_r[kR > 0 ? kR : 1];
        if constexpr (kR > 0) {
#pragma unroll
            for (int rr = 0; rr < kR; ++rr) {
                rq_r[rr] = rr < r ? rq[rr] : 0.0f;
                cap_r[rr] = rr < r ? cap[rr] : 0.0f;
            }
        }
        uint32_t stat = 0u, fit = 0u;
        for (int u = 0; u < ns; ++u) {
            if (!a.sfeas_s[(size_t)R.spec_of[u] * n + nd]) continue;
            stat |= R.spec_mask[u];
            const float* req = R.req + u * r;
            bool fits;
            if constexpr (kR > 0) {
                fits = true;
#pragma unroll
                for (int rr = 0; rr < kR; ++rr) {
                    const float q = rr < r ? req[rr] : 0.0f;
                    if (q > 0.0f && !(add(rq_r[rr], q) <= cap_r[rr])) fits = false;
                }
            } else {
                fits = node_fits(rq, cap, req, r);
            }
            if (fits) fit |= R.spec_mask[u];
        }
        f_static |= stat;
        f_res |= fit;
        if (!fit) continue;
        uint32_t spread = 0u, inter = 0u;
        for (int v = 0; v < nc; ++v) {
            const uint32_t m = R.cons_mask[v];
            if (!(m & fit)) continue;
            if (((hard >> v) & 1u) && !spread_ok(a.sp, R.ps[v], n, nd)) continue;
            spread |= m;
            if (a.tm.on && !interpod_ok(a.tm, R.pt[v], nd)) continue;
            inter |= m;
        }
        f_spread |= fit & spread;
        f_inter |= fit & inter;
    }
    f_static = __reduce_or_sync(0xffffffffu, f_static);
    f_res = __reduce_or_sync(0xffffffffu, f_res);
    f_spread = __reduce_or_sync(0xffffffffu, f_spread);
    f_inter = __reduce_or_sync(0xffffffffu, f_inter);
    if ((threadIdx.x & 31) == 0) {
        if (f_static) atomicOr(&w[0], f_static);
        if (f_res) atomicOr(&w[1], f_res);
        if (f_spread) atomicOr(&w[2], f_spread);
        if (f_inter) atomicOr(&w[3], f_inter);
    }
}

constexpr int kRegR = 4;   // resources a node pass keeps in registers

// Every joint class's reason into reason_c (block 0), then each pod's:
// REASON_NONE when placed, else its class's.  Ends after the pods' writes
// (no cluster barrier: the caller's next one publishes them, and no block
// may leave or rewrite its flag words before it).
__device__ inline void round_reasons(const Ctx& a, Shared& S, unsigned char* dyn,
                                     const ExactTeam& team)
{
    ReasonsSmem& R = *(ReasonsSmem*)dyn;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int kBatch = kReasonWords / 4 * kReasonGroup;   // classes merged at once
    int par = 0;
    for (int base = 0; base < a.c_dim; base += kBatch) {
        const int end = min(a.c_dim, base + kBatch);
        const int words = 4 * ((end - base + kReasonGroup - 1) / kReasonGroup);
        if (base > 0) team.sync();   // the last batch's words pulled by every block
        for (int e = threadIdx.x; e < words; e += blockDim.x) R.flags[e] = 0u;
        for (int c0 = base; c0 < end; c0 += kReasonGroup) {
            group_classes(a, c0, min(kReasonGroup, end - c0), R);
            group_preps(a, par, R, S, team);
            par ^= 1;
            uint32_t* w = R.flags + 4 * ((c0 - base) / kReasonGroup);
            if (a.r <= kRegR) {
                group_nodes<kRegR>(a, w, R, team);
            } else {
                group_nodes<0>(a, w, R, team);
            }
            __syncthreads();   // the group's tables read before the next group's
        }
        team.sync();
        for (int e = threadIdx.x; e < words; e += blockDim.x) {
            uint32_t x = 0u;
            for (unsigned b = 0; b < team.size_; ++b) x |= *cluster.map_shared_rank(&R.flags[e], b);
            R.all[e] = x;
        }
        __syncthreads();
        if (team.rank_ == 0) {
            for (int c = base + threadIdx.x; c < end; c += blockDim.x) {
                a.reason_c[c] = reason_of(class_flags_of(R.all, c - base));
            }
        }
        for (int i = team.rank(); i < a.p; i += team.size()) {
            const int c = min(max(a.class_id[i], 0), a.c_dim - 1);
            if (a.assigned[i] >= 0) {
                if (base == 0) a.reasons[i] = kReasonNone;
            } else if (c >= base && c < end) {
                a.reasons[i] = reason_of(class_flags_of(R.all, c - base));
            }
        }
    }
}

// ---- the gang post-pass ----------------------------------------------------
//
// Replaces: kubernetes_tpu/ops/auction.py:825-843 (inside
// auction_assign_jit, :855): a gang with an unplaced valid member
// (`incomplete`, groups clipped into [0, G) as jnp.clip does) releases
// every placed member (`gang_dropped`); each dropped pod's requests and
// nonzero requests leave its node's two usage rows (the masked
// scatter-add, in pod index order), and it takes assigned -1, bid score
// -inf and REASON_GANG.  It runs after the reasons pass on the final state,
// so the other reasons are named before the release, as in the reference.
//
// Bound on this card: each pod's group, assignment and validity read and
// its flag written (10 bytes a pod), and of the D dropped pods their two
// request rows read (8 R bytes), their assignment, score and reason
// written (12 bytes) and their nodes' two usage rows read and written (16
// R bytes a node); one subtraction a dropped pod, resource and row.
// Microseconds of the card's memory rate; what a design pays is its
// cluster barriers and, when pods drop, ordering them by node.
//
// Design, over the cluster (each block its pod range [b P / G, (b + 1) P
// / G), ceil): the [G] flags, 0 at the launch's entry, take plain stores
// of 1 from the unplaced members (order-free) before a cluster barrier
// the launch makes anyway (the start's when the stage runs alone, the one
// after the reasons in the loop's launch); each block writes its pods'
// gang_dropped and counts its dropped pods, and pushes the count into
// every block's shared memory; one cluster barrier, after which every
// block knows D and its offset, and the markers clear the flags (every
// block has read them) for the next launch.
//   D == 0    the stage ends: no sort, no release (every c5 batch whose
//             gangs all complete).
//   D ≤ kGangCap (and node and pod indices in 32 bits)
//             each block writes its dropped pods, in pod index order at
//             its offset (a block scan), as (node << bits(P)) | pod into
//             block 0's shared memory through DSMEM; one cluster barrier;
//             the other blocks leave, and block 0 sorts the keys (a bitonic
//             network: the key orders by node, then pod index; up to a key
//             a thread, the pairs within a warp by shuffles and the wider
//             ones through shared memory), and one thread a (node run,
//             resource) subtracts the run in pod index order with
//             __fsub_rn; then the dropped pods' rewrites.
//   above     the dropped pods compacted the same way into `perm`, stably
//             radix-sorted by node over the cluster (radix_sort on D items,
//             key N - 1: one pass up to 256 nodes), their nodes listed and
//             each node's run start marked, then the same walk a (node,
//             resource) over the cluster.
// The subtraction order is the reference's, so the usage equals the plain
// version's bit for bit past float32's exact range; no atomics on floats.
// No block reads another's shared memory after the stage's last cluster
// barrier, so the launch ends without one: with no drop the stage costs
// one cluster barrier of its own.  G == 0 skips the stage: no barrier on a
// gang-free batch.

constexpr int kGangCap = 8192;   // dropped pods block 0 sorts in shared memory

// The gang stage's dynamic shared memory (`count` and, in block 0, `keys`
// are written by the other blocks of the cluster).
struct GangSmem {
    int count[kMaxCluster];     // each block's dropped pods
    int warp_sum[kMaxWarps];
    uint32_t keys[kGangCap];    // block 0: (node << bits(P)) | pod of every dropped pod
};
static_assert(sizeof(GangSmem) <= kDynSmem, "the gang stage fits the launch's buffers");

// Bits to hold 0 .. x (x >= 0).
__device__ __forceinline__ int bits_to_hold(int x)
{
    return 32 - __clz(max(x, 1));
}

// This block's dropped pods, in pod index order, each as key(i) at
// dst[off + its rank] (dst may be another block's shared memory).
// Block-wide; uniform trip count.
template <class KeyFn>
__device__ inline void compact_dropped(const Ctx& a, int lo, int hi, int off, uint32_t* dst,
                                       KeyFn key, int* warp_sum)
{
    for (int base = lo; base < hi; base += blockDim.x) {
        const int i = base + (int)threadIdx.x;
        const int d = i < hi && a.gang_dropped[i];
        int tot;
        const int pos = block_exclusive_scan(d, tot, warp_sum);
        if (d) dst[off + pos] = key(i);
        off += tot;
    }
}

// Release node `node`'s run of dropped pods pod(s), pod(s + 1), ... (while
// node_at(t) == node, t < total) from its usage row at resource rr, in
// pod index order; the next pod's index is read while the current one's
// requests load.
template <class NodeAt, class PodAt>
__device__ inline void release_run(const Ctx& a, int s, int total, int rr, NodeAt node_at,
                                   PodAt pod_at)
{
    const int node = node_at(s), r = a.r;
    const size_t o = (size_t)node * r + rr;
    float q = a.requested[o], z = a.nonzero[o];
    for (int t = s, i = pod_at(s);;) {
        const float dq = a.pod_req[(size_t)i * r + rr], dz = a.pod_nz[(size_t)i * r + rr];
        const bool more = ++t < total && node_at(t) == node;
        const int next = more ? pod_at(t) : 0;
        q = sub(q, dq);
        z = sub(z, dz);
        if (!more) break;
        i = next;
    }
    a.requested[o] = q;
    a.nonzero[o] = z;
}

__device__ __forceinline__ void drop_pod(const Ctx& a, int i)
{
    a.assigned[i] = -1;
    a.bid_scores[i] = -INFINITY;
    a.reasons[i] = kReasonGang;
}

// Up to kGangCap dropped pods: compacted into block 0, sorted and released
// there.  Ends without a cluster barrier.
__device__ inline void gang_release_block(const Ctx& a, GangSmem& G, int lo, int hi, int off,
                                          int count, int total, const ExactTeam& team)
{
    const int n = a.n, r = a.r, tid = (int)threadIdx.x, T = (int)blockDim.x;
    const int ib = bits_to_hold(a.p - 1);
    if (count > 0) {
        uint32_t* keys = cg::this_cluster().map_shared_rank(G.keys, 0);
        compact_dropped(a, lo, hi, off, keys, [&](int i) {
            return ((uint32_t)min(a.assigned[i], n - 1) << ib) | (uint32_t)i;
        }, G.warp_sum);
    }
    team.sync();
    if (team.rank_ != 0) return;
    // a bitonic network over the keys padded to a power of two: the pair
    // (x, x + j) in order ascending where x & k is 0
    const int m = total <= 1 ? 1 : 1 << bits_to_hold(total - 1);
    for (int e = total + tid; e < m; e += T) G.keys[e] = 0xffffffffu;
    __syncthreads();
    if (m <= T) {
        // a key a thread: the pairs within a warp (j < 32) by shuffles,
        // the wider ones through shared memory
        uint32_t key = tid < m ? G.keys[tid] : 0u;
        for (int k = 2; k <= m; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                uint32_t other;
                if (j >= 32) {
                    __syncthreads();
                    if (tid < m) G.keys[tid] = key;
                    __syncthreads();
                    other = tid < m ? G.keys[tid ^ j] : 0u;
                } else {
                    other = __shfl_xor_sync(0xffffffffu, key, j);
                }
                key = (((tid & j) == 0) == ((tid & k) == 0)) ? min(key, other) : max(key, other);
            }
        }
        __syncthreads();
        if (tid < m) G.keys[tid] = key;
    } else {
        for (int k = 2; k <= m; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int t = tid; t < (m >> 1); t += T) {
                    const int x = ((t & ~(j - 1)) << 1) | (t & (j - 1)), y = x + j;
                    const uint32_t kx = G.keys[x], ky = G.keys[y];
                    if ((kx > ky) == ((x & k) == 0)) {
                        G.keys[x] = ky;
                        G.keys[y] = kx;
                    }
                }
                __syncthreads();
            }
        }
    }
    __syncthreads();
    const uint32_t mask = (1u << ib) - 1u;
    auto node_at = [&](int t) { return (int)(G.keys[t] >> ib); };
    auto pod_at = [&](int t) { return (int)(G.keys[t] & mask); };
    for (int e = tid; e < total * r; e += T) {
        const int s = e / r;
        if (s > 0 && node_at(s - 1) == node_at(s)) continue;
        release_run(a, s, total, e - s * r, node_at, pod_at);
    }
    for (int t = tid; t < total; t += T) drop_pod(a, pod_at(t));
}

// More dropped pods: compacted into perm, radix-sorted by node over the
// cluster into perm_idx, their nodes into rtmp and each node's run start
// into bfirst (-1 without one), then one thread a (node, resource)
// releases the node's run.  Ends without a cluster barrier.
__device__ inline void gang_release_cluster(const Ctx& a, GangSmem& G, unsigned char* dyn,
                                            int lo, int hi, int off, int total,
                                            const ExactTeam& team)
{
    const int n = a.n, r = a.r;
    compact_dropped(a, lo, hi, off, (uint32_t*)a.perm, [](int i) { return (uint32_t)i; },
                    G.warp_sum);
    for (int b = team.rank(); b < n; b += team.size()) a.bfirst[b] = -1;
    team.sync();
    auto node_of = [&](int i) { return min(a.assigned[i], n - 1); };
    SortSpec spec = {a.perm, a.perm_idx, a.rtmp, a.rcnt, a.rbase};
    radix_sort(total, n - 1, 1, &spec, node_of, *(RadixSmem*)dyn, team);
    for (int s = team.rank(); s < total; s += team.size()) {
        const int b = node_of(a.perm_idx[s]);
        a.rtmp[s] = b;
        if (s == 0 || node_of(a.perm_idx[s - 1]) != b) a.bfirst[b] = s;
    }
    team.sync();
    auto node_at = [&](int t) { return a.rtmp[t]; };
    auto pod_at = [&](int t) { return a.perm_idx[t]; };
    for (int e = team.rank(); e < n * r; e += team.size()) {
        const int s = a.bfirst[e / r];
        if (s >= 0) release_run(a, s, total, e % r, node_at, pod_at);
    }
    for (int s = team.rank(); s < total; s += team.size()) drop_pod(a, a.perm_idx[s]);
}

// Pod i's gang, clipped into [0, G) as jnp.clip does.
__device__ __forceinline__ int gang_of(const Ctx& a, int i)
{
    return min(max(a.group_id[i], 0), a.n_groups - 1);
}

// Pod i is an unplaced valid member: its gang is incomplete.
__device__ __forceinline__ bool gang_marker(const Ctx& a, int i)
{
    return a.group_id[i] >= 0 && a.assigned[i] < 0 && a.pod_valid[i];
}

// The incomplete gangs' flags, set to 1 (order-free) over the cluster;
// the caller's next cluster barrier publishes them.  The flags are 0 at
// every launch's entry: zeroed when allocated, and cleared by the stage
// that read them (round_gang).
__device__ inline void gang_marks(const Ctx& a, const ExactTeam& team)
{
    for (int i = team.rank(); i < a.p; i += team.size()) {
        if (gang_marker(a, i)) a.gang_flags[gang_of(a, i)] = 1;
    }
}

// The gang post-pass, after gang_marks and a cluster barrier.  Ends
// without a cluster barrier and reads no other block's shared memory
// after its last one, so the launch needs none after it (with no drop, or
// past the compaction, a block may leave at once).
__device__ inline void round_gang(const Ctx& a, unsigned char* dyn, const ExactTeam& team)
{
    GangSmem& G = *(GangSmem*)dyn;
    const int p = a.p;
    auto grp = [&](int i) { return gang_of(a, i); };
    int lo, hi;
    block_pods(a, team, lo, hi);
    int mine = 0;
    for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) {
        const bool d = a.group_id[i] >= 0 && a.gang_flags[grp(i)] && a.assigned[i] >= 0;
        a.gang_dropped[i] = d;
        mine += d;
    }
    mine = block_sum(mine, G.warp_sum);
    if ((int)threadIdx.x < (int)team.size_) {
        *cg::this_cluster().map_shared_rank(&G.count[team.rank_], threadIdx.x) = mine;
    }
    team.sync();
    // every block has read the flags: their markers clear them for the next
    // launch (the rewrites below only add dropped pods of flagged gangs)
    for (int i = team.rank(); i < p; i += team.size()) {
        if (gang_marker(a, i)) a.gang_flags[grp(i)] = 0;
    }
    int total = 0, off = 0;
    for (unsigned b = 0; b < team.size_; ++b) {
        total += G.count[b];
        off += b < team.rank_ ? G.count[b] : 0;
    }
    if (total == 0) return;
    if (total <= kGangCap && bits_to_hold(a.p - 1) + bits_to_hold(a.n - 1) <= 32) {
        gang_release_block(a, G, lo, hi, off, mine, total, team);
    } else {
        gang_release_cluster(a, G, dyn, lo, hi, off, total, team);
    }
}

// ---- kernels -------------------------------------------------------------

// The stages of a launch: kStageBids, kStageAccept (1), kStageCommit (2),
// kStageSpread, kStageInterpod, the whole loop, kStageReasons (alone, or
// after the loop in the same launch) and kStageGang (alone, or after the
// loop and the reasons pass in the same launch).
enum { kStageAccept = 1, kStageCommit = 2, kStageBids = 4, kStageSpread = 8,
       kStageInterpod = 16, kStageLoop = 32, kStageReasons = 64, kStageGang = 128 };

// The block's start: the team, the score parameters, the inter-pod
// repair's tables, the gang stage's marks when it runs alone, and a
// cluster barrier before any block writes another's shared memory.
__device__ inline void start(const Ctx& a, int stages, Shared& S, unsigned char* dyn,
                             ExactTeam& team)
{
    team.init(&S.slots);
    if (threadIdx.x == 0) load_config(S.cfg, a.iparams, a.fparams);
    if (a.tm.on) prepare_repair(a, *(RepairSmem*)dyn, team);
    if (stages == kStageGang && a.n_groups > 0) gang_marks(a, team);
    team.sync();
}

template <int kT>
__global__ void __launch_bounds__(kT, 1) auction_kernel(Ctx a, int stages)
{
    __shared__ Shared S;
    extern __shared__ __align__(16) unsigned char dyn[];
    // every block reads the flag before any block writes it; the rounds'
    // stages return at once when it is down, the reasons pass and the gang
    // stage run anyway
    const bool go = a.state[1] != 0;
    if (!go && !(stages & (kStageReasons | kStageGang))) return;
    const int rnd0 = a.state[0];
    const int progress0 = a.state[2];
    ExactTeam team;
    if (stages & kStageSpread) {
        // the spread repair alone: block 0, no exchange
        if (cg::this_cluster().block_rank() == 0 && a.sp.on) spread_repair(a, *(SpreadSmem*)dyn);
        return;
    }
    start(a, stages, S, dyn, team);
    if (stages & kStageInterpod) {
        // the inter-pod repair alone, over the cluster
        if (a.tm.on) {
            RepairSmem& sm = *(RepairSmem*)dyn;
            interpod_repair(a, sm, team);
            team.sync();
            interpod_clear(a, sm, team);
        }
        team.sync();
        return;
    }
    if (stages & kStageLoop) {
        for (int rnd = rnd0; go; ++rnd) {
            round_bids(a, rnd, S, dyn, team);
            const bool progress = round_accept(a, S, dyn, team);
            if (a.sp.on || a.tm.on) round_repairs(a, dyn, team);
            if (!round_commit(a, rnd, progress, S, team)) break;
        }
    } else if (go) {
        if (stages & kStageBids) round_bids(a, rnd0, S, dyn, team);
        bool progress = progress0 != 0;
        if (stages & kStageAccept) {
            progress = round_accept(a, S, dyn, team);
            if (!(stages & kStageCommit) && team.rank() == 0) a.state[2] = progress ? 1 : 0;
        }
        if (stages & kStageCommit) round_commit(a, rnd0, progress, S, team);
    }
    const bool gang = (stages & kStageGang) && a.n_groups > 0;
    if (stages & kStageReasons) {
        round_reasons(a, S, dyn, team);
        if (gang) {
            // the reasons written, every block's flag words pulled and the
            // gang marks published before the gang stage
            gang_marks(a, team);
            team.sync();
        }
    }
    if (gang) {
        // it reads no other block's shared memory after its last cluster
        // barrier: no final barrier
        round_gang(a, dyn, team);
        return;
    }
    // no block leaves while another may still read its shared memory
    team.sync();
}

// Launch `stages` on the cluster of launch_shape(n): kStageLoop alone, with
// kStageReasons or with kStageReasons | kStageGang; kStageReasons,
// kStageGang, kStageSpread or kStageInterpod alone; or any of bids,
// acceptance and commit.
inline int launch(const int* ints, void* const* ptrs, int stages, void* stream)
{
    constexpr int kOneRound = kStageBids | kStageAccept | kStageCommit;
    if (stages != kStageLoop && stages != (kStageLoop | kStageReasons)
        && stages != (kStageLoop | kStageReasons | kStageGang) && stages != kStageGang
        && stages != kStageReasons && stages != kStageSpread && stages != kStageInterpod
        && (stages == 0 || (stages & ~kOneRound) != 0)) {
        return (int)cudaErrorInvalidValue;
    }
    Ctx a;
    const int err = make_ctx(ints, ptrs, a);
    if (err) return err;
    if (a.p == 0 || a.n == 0) return 0;
    const Shape shape = launch_shape(a.n);
    auto* kernel = shape.threads == kSmallThreads ? &auction_kernel<kSmallThreads>
                                                  : &auction_kernel<kClusterThreads>;
    return (int)launch_cluster(kernel, shape, kDynSmem, (cudaStream_t)stream, a, stages);
}

}  // namespace auction
