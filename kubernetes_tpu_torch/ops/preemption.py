"""Preemption dry-run as a cumulative victim subtraction.

Replaces kubernetes_tpu/ops/preemption.py: `dry_run_victims` (:70),
`batched_dry_run` (:129) and `static_feasible_batch` (:194).  Per
candidate node the victims are sorted by priority ascending; a prefix
sum of their resource vectors answers "after evicting the k cheapest
victims, does the preemptor fit?" for every k at once, and the first k
that fits is the node's minimal eviction set.

  * dry_run_victims: ONE preemptor against its candidate set (the
    per-pod path of scheduler/preemption.py);
  * batched_dry_run: EVERY failed pod of a PostFilter pass against every
    node with victims.  Per priority level the victims are taken in that
    level's eviction order (`perm`, PDB-clean victims first), masked to
    the level's evictable prefix (`elig_len`), and prefix-summed once;
    every pod of the level reads the same sums.  The PDB-violation count
    of each minimal prefix comes back as `viol_k`;
  * static_feasible_batch: the placement-independent Filter slice of
    every preemptor (node validity, NodeName, taints, NodeAffinity) —
    no resources and no ports, which eviction frees.

The prefix sums are float32 and added in the reference compiler's CPU
order for jnp.cumsum (ops.auction.prefix_sum: sequential in blocks of 16,
the block totals prefix-summed the same way), never torch.cumsum's:
requests that are not whole MiB leave float32's exact range, and then
the order of additions decides which k fits.

Each entry point sends tensors on the CPU to its plain version (`*_plain`)
and tensors on the card to the CUDA kernels: `preempt_dry_run`
(csrc/preempt_dry_run.cu, both dry-runs) and `pod_filters`
(csrc/pod_filters.cu, the Filter chain, after `match_terms` gave the
selector mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .auction import prefix_sum
from .filters import filter_rows, selector_match


class DryRunResult(NamedTuple):
    feasible: torch.Tensor  # bool[C]  pod fits after evicting min_k victims
    min_k: torch.Tensor     # i32[C]  victims needed (only valid if feasible)


class PreemptionBatch(NamedTuple):
    """One PostFilter pass's inputs, encoded once from the cluster state:
    N candidate nodes, K victim slots per node sorted by (priority asc,
    pod key), L preemptor priority levels, P failed pods.  Victims
    evictable at level l are the first elig_len[l, n] entries of
    perm[l, n], PDB-clean victims first."""

    free: torch.Tensor        # f32[N, R]  allocatable - requested per node
    victim_req: torch.Tensor  # f32[N, K, R]  usage per victim slot
    perm: torch.Tensor        # i32[L, N, K]  eviction order per level
    elig_len: torch.Tensor    # i32[L, N]  evictable victims per level
    viol: torch.Tensor        # bool[L, N, K]  PDB violation, eviction order
    pods_req: torch.Tensor    # f32[P, R]  preemptor resource vectors
    pod_level: torch.Tensor   # i32[P]  priority-level index per preemptor


class BatchDryRunResult(NamedTuple):
    feasible: torch.Tensor  # bool[P, N]  pod p fits on node n after min_k
    min_k: torch.Tensor     # i32[P, N]  victims needed (valid if feasible)
    viol_k: torch.Tensor    # i32[P, N]  PDB violations in the evicted prefix


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum along `dim` in prefix_sum's order."""
    return torch.movedim(prefix_sum(torch.movedim(x, dim, 0)), 0, dim)


def _first_fit(free, cum, req, bound):
    """(feasible, min_k) of the fit test over k = 0..K: free [..., R],
    cum [..., K, R], req [..., R], bound [...] (the largest admissible k).
    k = 0 is free + 0.0, as the reference's concatenated zero row."""
    zero = torch.zeros_like(cum[..., :1, :])
    free_k = free[..., None, :] + torch.cat([zero, cum], dim=-2)     # [..., K+1, R]
    req = req[..., None, :]
    fits = ((req <= 0) | (req <= free_k)).all(dim=-1)                 # [..., K+1]
    ks = torch.arange(cum.shape[-2] + 1, dtype=torch.int32, device=cum.device)
    fits = fits & (ks <= bound[..., None])
    feasible = fits.any(dim=-1)
    # first True, 0 when none (jnp.argmax)
    min_k = torch.where(feasible, fits.to(torch.int8).argmax(dim=-1), 0).to(torch.int32)
    return feasible, min_k


def dry_run_victims_plain(free, victim_req, victim_valid, pod_req) -> DryRunResult:
    """Plain version of dry_run_victims."""
    w = victim_valid[..., None].to(victim_req.dtype)
    cum = _cumsum(victim_req * w, 1)                                  # [C, K, R]
    n_victims = victim_valid.sum(dim=1).to(torch.int32)
    feasible, min_k = _first_fit(free, cum, pod_req.expand_as(free), n_victims)
    return DryRunResult(feasible, min_k)


def dry_run_victims(free, victim_req, victim_valid, pod_req) -> DryRunResult:
    """For each candidate node: the smallest victim prefix whose eviction
    admits the pod (victims masked by victim_valid, k at most the count of
    valid slots).  Ranking statistics (max/sum of evicted priorities) stay
    on the host with exact integer math."""
    if free.device.type == "cpu":
        return dry_run_victims_plain(free, victim_req, victim_valid, pod_req)
    from ..kernels import bindings

    return DryRunResult(*bindings.dry_run_victims(free, victim_req, victim_valid, pod_req))


def batched_dry_run_plain(batch: PreemptionBatch) -> BatchDryRunResult:
    """Plain version of batched_dry_run."""
    l, n, k = batch.perm.shape
    r = batch.victim_req.shape[2]
    ordered = torch.gather(
        batch.victim_req[None].expand(l, n, k, r), 2,
        batch.perm.long()[..., None].expand(l, n, k, r),
    )                                                                 # [L, N, K, R]
    in_prefix = (
        torch.arange(k, dtype=torch.int32, device=batch.perm.device)[None, None, :]
        < batch.elig_len[:, :, None]
    )                                                                 # [L, N, K]
    cum = _cumsum(ordered * in_prefix[..., None].to(ordered.dtype), 2)
    cum_viol = torch.cumsum((batch.viol & in_prefix).to(torch.int32), dim=2)
    lvl = batch.pod_level.long()
    feasible, min_k = _first_fit(
        batch.free[None], cum[lvl], batch.pods_req[:, None, :], batch.elig_len[lvl]
    )                                                                 # [P, N]
    at = torch.clamp(min_k - 1, min=0).long()[..., None]
    viol_at = torch.gather(cum_viol[lvl], 2, at)[..., 0]
    viol_k = torch.where(min_k > 0, viol_at, 0).to(torch.int32)
    return BatchDryRunResult(feasible, min_k, viol_k)


def run_batched_dry_run(batch: PreemptionBatch) -> BatchDryRunResult:
    """Every (failed pod, candidate node) dry run of one PostFilter pass:
    kernel `preempt_dry_run` on the card, the plain version on the CPU."""
    if batch.free.device.type == "cpu":
        return batched_dry_run_plain(batch)
    from ..kernels import bindings

    return BatchDryRunResult(*bindings.batched_dry_run(*batch))


def static_feasible_batch_plain(cluster, pods, selectors) -> torch.Tensor:
    """Plain version of static_feasible_batch."""
    from .filters import filter_rows_plain, match_rows_plain

    sel_mask = match_rows_plain(cluster, selectors.expr_ids, selectors.expr_op,
                                selectors.expr_slot, selectors.term_valid)
    return filter_rows_plain(cluster, pods, sel_mask, full=False)


def run_static_feasible_batch(cluster, pods, selectors) -> torch.Tensor:
    """bool[P, N]: the placement-independent Filter slice (NodeName /
    taints / affinity / validity) of every preemptor of the pass,
    resources and ports excluded: kernels match_terms and pod_filters on
    the card, the plain versions on the CPU."""
    return filter_rows(cluster, pods, selector_match(cluster, selectors), full=False)
