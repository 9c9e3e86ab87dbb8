// Kernel `auction_loop`: the auction solve's whole round loop, its reasons
// pass and its gang post-pass, one launch a batch; and each stage launched
// alone (the bindings' stage entry points auction_bids, auction_accept,
// auction_spread, auction_interpod, auction_reasons and auction_gang), the
// same kernel at the same cluster shape.
//
// Replaces: kubernetes_tpu/ops/auction.py:140 `auction_assign`'s
// lax.while_loop (:762, inside auction_assign_jit, :855): rounds of the
// bids (:355-478), the acceptance and commit (:680-745) and the spread and
// inter-pod repairs (:507-678) while rnd < max_rounds, the last round
// progressed and a valid pod is unplaced (:742-745).  Stage by stage:
//   bids      :355-478 — per spec class the resource fit and the fit /
//             balanced score rows, per constraint class the spread filter
//             row (topology.py:121) and the inter-pod filter row
//             (interpod.py:156), per joint class the combine with the
//             affinity and taint rows, the soft spread score
//             (topology.py:153) and the hoisted extra row (`joint_extra`,
//             :303-318, built once by kernel class_extras), the best score,
//             the tie set and its hashed (key desc, index asc) top list of
//             cnt = min(#ties, tie_k) nodes; per pod its position j among
//             the active pods of its class in solve order, its slot, bid
//             and value.  The hash is the reference's wrapping u32
//             arithmetic: rot = ((c * G) ^ (rnd * R) ^ S) * M, key =
//             ((node + 1) * G ^ rot) >> 2 (logical), with S = tie_seed * 2
//             + 1 = 1 for the tie_seed of 0 the scheduler uses.
//   accept    :680-745 — pods in solve order stably sorted by bid
//             (:694-695); a pod's demand on its node as a difference of
//             global prefix sums, within = prefix - prefix[first] +
//             sreq[first] (:697-699), held against the node's remaining
//             capacity (:700-705); the commit scatter of requested and
//             nonzero_requested (:727-730); assigned and bid_scores
//             (:737-738); the progress flag and the loop condition (:725,
//             :742-745).  Stage 1 is the acceptance, 2 the commit and the
//             state, 3 both.
//   spread    :482-652 — `spread_repair` (SPREAD_REPAIR_ITERS = 3 admit
//             passes over the round's capacity-accepted pods, with
//             `_slot_sorts` and `_spread_ranks`) and `commit_spread` of
//             the kept pods into the node-space counts (:716-720,
//             :731-732).
//   interpod  :587-614 `interpod_repair` (after the spread repair,
//             :717-720) and :654-678 `commit_terms` of the kept pods into
//             the present / blocked / global_any bits (:733-736).
//   reasons   :765-823, the staged reasons pass after the while_loop, in
//             the same jitted program: per spec class the resource fit of
//             its representative, per constraint class the spread and
//             inter-pod filters of its representative, per joint class the
//             stage anys and `class_reason`'s code; each pod its class's
//             code or REASON_NONE.  The loop launch runs it once after the
//             flag falls (stages kStageLoop | kStageReasons), on the final
//             state, before the gang post-pass; alone (kStageReasons) it
//             is the bindings' auction_reasons.  Its bound: allocatable,
//             the final usage (8 R bytes a node) and each spec class's
//             static row (a byte a node) read once, with the families each
//             constraint class's hard spread rows (9 bytes a node a row)
//             and the nodes' term words (12 W bytes a node), 12 bytes a
//             pod; a few flops a node and class.
//   gang      :825-843, the gang post-pass after the reasons, in the same
//             jitted program: `incomplete`, `gang_dropped`, the release of
//             the dropped pods' requests (scatter_add_rows in pod index
//             order) and the rewrites of assigned, bid_scores and reasons.
//             The loop launch runs it last (stages kStageLoop |
//             kStageReasons | kStageGang) when the batch has gangs; alone
//             (kStageGang) it is the bindings' auction_gang.  Its bound:
//             10 bytes a pod, 8 R + 12 bytes a dropped pod, 16 R bytes a
//             node that holds one; one subtraction a dropped pod, resource
//             and row.
//   tables    the inter-pod repair's term tables and each pod's solve
//             position (mi_dense, anti_dense, solve_pos, built inside
//             auction_assign_jit, :320-349): written once a launch by
//             every block's start — the live terms, each pod's flags of
//             them ([P, L] bytes, from the bits of terms.matches_incoming
//             and terms.anti_idx) and the reset group tables.
//
// Bound on this card: per round, the class pass reads each active class's
// static row, allocatable, requested and nonzero-requested (about 60 bytes
// a node) and does ~60 flops a feasible node; the sorts, the prefix, the
// acceptance and the commit move each pod's requests and bid node's rows a
// few times; the spread repair moves the [C, N] counts a few times, the
// inter-pod repair the accepted pods' (pod, term) pairs and the nodes'
// (node, term) pairs.  A round is microseconds of the card's rates; what a
// design pays is latency: the rounds run one after another, and within a
// round each stage waits for the one before.  The first design enqueued
// max_rounds = 64 rounds of 2 to 5 launches from the host whatever the
// batch needed (each launch after the loop's end returned at once), with
// a P^2 stable sort and a P^2 / 2 class count per round on one SM each,
// and one 1,024-thread block per class.
//
// Design: one thread-block cluster of launch_shape(n) (16 blocks of 512
// threads up to 8,192 nodes, of 1,024 above; block b on the 32-node chunks
// q with q % G == b) loops the rounds until the device's state flag falls,
// with no host sync; the stages and their barriers are
// auction_common.cuh's: the class-key radix sort over the cluster gives j
// as a sorted position less its class's first; each active class is
// evaluated over the whole cluster, its tie histogram summed across the
// blocks through distributed shared memory and its ties ranked within
// their buckets; the two bid sorts (solve order and pod index order) are
// the same radix sort (8-bit digits; two passes at 8,192 nodes, three at
// 65,536), O(P + tiles x 256) a pass, each node group's first position
// (searchsorted left) a run start of the sorted order; the prefix adds in
// the order XLA's CPU backend adds the reference's jnp.cumsum (sequential
// scans of blocks of 16 rows, the block totals scanned the same way,
// recursively, then each block's exclusive total added back: level 0 over
// the cluster, the upper levels on block 0), so the kernel, its plain
// version (ops/auction.py `prefix_sum`) and the reference on the CPU agree
// for any request values; the spread repair runs on block 0 while the
// other blocks wait (its ranks a __match_any_sync warp walk); the
// inter-pod repair runs over the cluster (each block its share of the
// accepted pods x live terms, then of the nodes; integer atomicMin group
// minima and stores of 1, order-free; auction_common.cuh has its
// design); the commit adds each node's accepted requests in pod index
// order, one thread a node group.  The reasons pass evaluates every joint
// class in one pass over the nodes (32 classes a pass: a class a bit of a
// word; each group's distinct spec and constraint classes staged in shared
// memory once, the hard spread rows' minima merged over the cluster in one
// pull a group), the four stage words OR-merged over the cluster in one
// pull through distributed shared memory (order-free: exact), then one
// write a pod.  The gang stage marks the incomplete gangs, writes and
// counts the drops (each block's count pushed into every block's shared
// memory) and, when some pod drops, orders the dropped pods by node — in
// block 0's shared memory up to 8,192 of them, past that by the radix
// sort above over the dropped pods alone — and subtracts each node's run
// in pod index order; with no drop it ends there.  auction_common.cuh has
// both designs.

#include "auction_common.cuh"

// `stages` (auction_common.cuh kStage*): the whole loop from state
// (rounds, flag, progress) until the flag falls, then with kStageReasons
// the reasons pass and with kStageGang the gang post-pass; or one stage of
// round state[0] (each returns at once when state[1] is down), or the
// reasons pass or the gang stage alone.
extern "C" int auction_loop_launch(int stages, const int* ints, void* const* ptrs,
                                   void* stream)
{
    return auction::launch(ints, ptrs, stages, stream);
}

// What the bindings check on load: 0 the ints and 1 the pointers of a
// launch, 2 the largest spread value space counted in shared memory, 3-10
// the stage flags of the loop, the bids, the acceptance, the commit, the
// spread and the inter-pod repairs, the reasons pass and the gang stage.
extern "C" int auction_loop_layout(int which)
{
    using namespace auction;
    const int v[] = {kI_COUNT, kP_COUNT, kShZ, kStageLoop, kStageBids, kStageAccept,
                     kStageCommit, kStageSpread, kStageInterpod, kStageReasons, kStageGang};
    return which >= 0 && which < (int)(sizeof(v) / sizeof(v[0])) ? v[which] : -1;
}

extern "C" const char* auction_loop_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
