"""Score functions — the Score extension point as one weighted-sum pass.

Plain-torch versions of the reference package's scorers.  Implemented:

  NodeResourcesFit/LeastAllocated   least_allocated.go:30-61
  NodeResourcesBalancedAllocation   balanced_allocation.go:138-176
  NodeResourcesMostAllocated        most_allocated.go:30-53 (opt-in strategy)
  RequestedToCapacityRatio          requested_to_capacity_ratio.go
  NodeAffinity (preferred terms)    nodeaffinity/node_affinity.go Score
  TaintToleration (PreferNoSchedule) tainttoleration/taint_toleration.go Score
  InterPodAffinity (preferred terms) interpodaffinity/scoring.go (normalize_minmax)
  ImageLocality                     imagelocality/image_locality.go

Go-side scorers run in int64 with truncating division; these mimic that
with float32 + floor, which is exact for the quantities the schema
carries (schema.DEVICE_UNIT_DIVISOR).  The operation order is the
reference package's, operation for operation: one ulp of difference
before a floor flips a score, so any reordering is a behaviour change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .filters import PodView
from .schema import RESOURCE_CPU, RESOURCE_MEMORY, ClusterTensors

MAX_NODE_SCORE = 100.0
_PREFER_NO_SCHEDULE = 1  # taint-effect row
_F32 = torch.float32


@dataclass(frozen=True)
class ScoreConfig:
    """Plugin weights (reference defaults:
    apis/config/v1/default_plugins.go:38-50) and the resource sets the
    allocation scorers consider (default cpu+memory, weight 1 each —
    apis/config/v1/defaults.go defaultResourceSpec)."""

    fit_weight: float = 1.0              # NodeResourcesFit
    balanced_weight: float = 1.0         # NodeResourcesBalancedAllocation
    node_affinity_weight: float = 2.0    # NodeAffinity
    taint_weight: float = 3.0            # TaintToleration
    spread_weight: float = 2.0           # PodTopologySpread
    # (resource_index, weight) pairs for Least/MostAllocated
    fit_resources: Tuple[Tuple[int, float], ...] = (
        (RESOURCE_CPU, 1.0),
        (RESOURCE_MEMORY, 1.0),
    )
    # resource indices for BalancedAllocation
    balanced_resources: Tuple[int, ...] = (RESOURCE_CPU, RESOURCE_MEMORY)
    fit_strategy: str = "LeastAllocated"  # or MostAllocated | RequestedToCapacityRatio
    interpod_weight: float = 2.0         # InterPodAffinity
    image_weight: float = 1.0            # ImageLocality
    # RequestedToCapacityRatio shape: (utilization%, score) points,
    # piecewise-linear (requested_to_capacity_ratio.go buildBrokenLinear).
    rtcr_shape: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (100.0, 10.0))


DEFAULT_SCORE_CONFIG = ScoreConfig()

# jnp.interp's degenerate-segment threshold: spacing(eps) of float32
INTERP_EPSILON = float(np.spacing(np.finfo(np.float32).eps))


def _floor(x: torch.Tensor) -> torch.Tensor:
    """Go int64 division truncates; operands here are non-negative."""
    return torch.floor(x)


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=_F32, device=like.device)


def least_allocated(
    cluster: ClusterTensors, pod: PodView, cfg: ScoreConfig
) -> torch.Tensor:
    """score = sum_r w_r * floor((cap - req) * 100 / cap) / sum w, skipping
    resources a node doesn't expose (allocable==0 skips the weight too —
    least_allocated.go:34-37).  Uses NonZeroRequested."""
    req = cluster.nonzero_requested + pod.nonzero_req[None, :]
    cap = cluster.allocatable
    total = _zeros(cap.shape[0], cap)
    wsum = _zeros(cap.shape[0], cap)
    for idx, weight in cfg.fit_resources:
        c = cap[:, idx]
        q = req[:, idx]
        ok = c > 0
        s = torch.where(
            ok & (q <= c),
            _floor((c - q) * MAX_NODE_SCORE / torch.clamp(c, min=1.0)),
            0.0,
        )
        total = total + weight * s * ok
        wsum = wsum + weight * ok
    return torch.where(wsum > 0, _floor(total / torch.clamp(wsum, min=1.0)), 0.0)


def most_allocated(
    cluster: ClusterTensors, pod: PodView, cfg: ScoreConfig
) -> torch.Tensor:
    """score = sum_r w_r * floor(req * 100 / cap) / sum w (most_allocated.go:30-53)."""
    req = cluster.nonzero_requested + pod.nonzero_req[None, :]
    cap = cluster.allocatable
    total = _zeros(cap.shape[0], cap)
    wsum = _zeros(cap.shape[0], cap)
    for idx, weight in cfg.fit_resources:
        c = cap[:, idx]
        q = req[:, idx]
        ok = c > 0
        s = torch.where(
            ok & (q <= c),
            _floor(q * MAX_NODE_SCORE / torch.clamp(c, min=1.0)),
            0.0,
        )
        total = total + weight * s * ok
        wsum = wsum + weight * ok
    return torch.where(wsum > 0, _floor(total / torch.clamp(wsum, min=1.0)), 0.0)


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add gives
    it.  The product of two float32 values is exact in float64; the sum
    with c is rounded to float64 and then to float32, and where that first
    rounding was inexact the float64 sum is moved one step towards the
    exact sum, so the second rounding cannot land on a tie the exact sum
    is not on (no double rounding)."""
    dev = next(t.device for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = torch.broadcast_tensors(
        *(torch.as_tensor(t, dtype=_F32, device=dev) for t in (a, b, c))
    )
    prod = a.double() * b.double()
    cd = c.double()
    s = prod + cd
    bb = s - prod
    err = (prod - (s - bb)) + (cd - bb)   # s + err == prod + c exactly
    inf = torch.full_like(s, float("inf"))
    s = torch.where(err > 0, torch.nextafter(s, inf),
                    torch.where(err < 0, torch.nextafter(s, -inf), s))
    return s.float()


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp with its defaults (constant extrapolation), written out
    with searchsorted in jnp's operation order.  XLA contracts jnp's
    `fp[i-1] + (delta / dx) * df` into one fused multiply-add, so the port
    rounds it once too (fma32)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= INTERP_EPSILON
    f = torch.where(
        dx0, fp[i - 1], fma32(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1])
    )
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def requested_to_capacity_ratio(
    cluster: ClusterTensors, pod: PodView, cfg: ScoreConfig
) -> torch.Tensor:
    """Piecewise-linear score of utilization percent per resource,
    weight-averaged (noderesources/requested_to_capacity_ratio.go
    buildRequestedToCapacityRatioScorerFunction): the shape maps
    utilization (0..100) to a 0..10 score, rescaled to 0..100."""
    req = cluster.nonzero_requested + pod.nonzero_req[None, :]
    cap = cluster.allocatable
    xs = torch.tensor([p[0] for p in cfg.rtcr_shape], dtype=_F32, device=cap.device)
    ys = torch.tensor([p[1] for p in cfg.rtcr_shape], dtype=_F32, device=cap.device)
    total = _zeros(cap.shape[0], cap)
    wsum = _zeros(cap.shape[0], cap)
    for idx, weight in cfg.fit_resources:
        c = cap[:, idx]
        q = req[:, idx]
        ok = c > 0
        util = torch.clamp(q * 100.0 / torch.clamp(c, min=1.0), 0.0, 100.0)
        s = _interp(util, xs, ys) * (MAX_NODE_SCORE / 10.0)
        total = total + weight * torch.where(ok & (q <= c), _floor(s), 0.0)
        wsum = wsum + weight * ok
    return torch.where(wsum > 0, _floor(total / torch.clamp(wsum, min=1.0)), 0.0)


def balanced_allocation(
    cluster: ClusterTensors, pod: PodView, cfg: ScoreConfig
) -> torch.Tensor:
    """score = floor((1 - std(fractions)) * 100) with fractions clamped to 1,
    over resources with allocable > 0 (balanced_allocation.go:138-176).
    Uses actual Requested (useRequested=true, balanced_allocation.go:130)."""
    req = cluster.requested + pod.req[None, :]
    cap = cluster.allocatable
    fracs = []
    valids = []
    for idx in cfg.balanced_resources:
        c = cap[:, idx]
        ok = c > 0
        f = torch.clamp(req[:, idx] / torch.clamp(c, min=1.0), max=1.0)
        fracs.append(torch.where(ok, f, 0.0))
        valids.append(ok)
    f = torch.stack(fracs, dim=-1)          # [N, B]
    v = torch.stack(valids, dim=-1)         # [N, B]
    count = torch.clamp(v.sum(dim=-1, dtype=torch.int32), min=1).to(_F32)
    mean = f.sum(dim=-1) / count
    d = f - mean[:, None]
    var = torch.where(v, d * d, 0.0).sum(dim=-1) / count
    std = torch.sqrt(var)
    return _floor((1.0 - std) * MAX_NODE_SCORE)


def node_affinity_raw(pod: PodView, pref_mask: torch.Tensor) -> torch.Tensor:
    """Sum of weights of matching preferred terms (nodeaffinity Score).
    pref_mask: bool[F, N] from filters.preferred_match."""
    f = pref_mask.shape[0]
    idx = torch.clamp(pod.pref_idx, 0, f - 1).long()     # [MT]
    hit = pref_mask[idx]                                 # [MT, N]
    w = torch.where(pod.pref_idx >= 0, pod.pref_weight, 0.0)
    return (w[:, None] * hit).sum(dim=0)                 # [N]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (an int32 view), as int64: the SWAR
    bit trick on the zero-extended word (torch has no popcount op)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def taint_toleration_raw(cluster: ClusterTensors, pod: PodView) -> torch.Tensor:
    """Count of untolerated PreferNoSchedule taints per node
    (tainttoleration countIntolerableTaintsPreferNoSchedule)."""
    untol = (
        cluster.taint_bits[_PREFER_NO_SCHEDULE]
        & ~pod.tol_bits[_PREFER_NO_SCHEDULE][None, :]
    )
    counts = popcount32(untol).sum(dim=-1).to(_F32)
    return torch.where(pod.tol_all[_PREFER_NO_SCHEDULE], 0.0, counts)


def normalize(
    raw: torch.Tensor, feasible: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """helper.DefaultNormalizeScore: scale by the max over feasible nodes to
    [0,100] with truncating division; if the max is 0, scores become 0
    (or 100 when reversed)."""
    m = torch.max(torch.where(feasible, raw, 0.0))
    scaled = _floor(MAX_NODE_SCORE * raw / torch.clamp(m, min=1e-30))
    out = torch.where(m > 0, scaled, 0.0)
    if reverse:
        out = torch.where(m > 0, MAX_NODE_SCORE - out, MAX_NODE_SCORE)
    return out


def score_from_raw(
    cluster: ClusterTensors,
    pod: PodView,
    feasible: torch.Tensor,
    aff_raw: torch.Tensor,
    taint_raw: torch.Tensor,
    cfg: ScoreConfig = DEFAULT_SCORE_CONFIG,
    spread_score: torch.Tensor = None,
    extra: torch.Tensor = None,
) -> torch.Tensor:
    """Weighted plugin-score sum with precomputed *raw* static scores
    (hoisted per pod class); normalization stays per step because its
    maxima range over the pod's current feasible set.  spread_score: the
    already-normalized PodTopologySpread row (ops/topology.py); extra: the
    class's already-weighted static extras (static_extra)."""
    fit, bal = resource_score_parts(cluster, pod, cfg)
    return combine_scores(fit, bal, aff_raw, taint_raw, feasible, cfg,
                          spread_score=spread_score, extra=extra)


def resource_score_parts(
    cluster: ClusterTensors, pod: PodView, cfg: ScoreConfig
) -> tuple:
    """(fit, bal) — the requested-state-dependent score rows."""
    if cfg.fit_strategy == "MostAllocated":
        fit = most_allocated(cluster, pod, cfg)
    elif cfg.fit_strategy == "RequestedToCapacityRatio":
        fit = requested_to_capacity_ratio(cluster, pod, cfg)
    else:
        fit = least_allocated(cluster, pod, cfg)
    return fit, balanced_allocation(cluster, pod, cfg)


def combine_scores(
    fit: torch.Tensor,
    bal: torch.Tensor,
    aff_raw: torch.Tensor,
    taint_raw: torch.Tensor,
    feasible: torch.Tensor,
    cfg: ScoreConfig,
    spread_score: torch.Tensor = None,
    extra: torch.Tensor = None,
) -> torch.Tensor:
    """Normalize + weight-sum precomputed score rows over a feasible set
    (the RunScorePlugins NormalizeScore pass, runtime/framework.go:1147).
    The extras are added after the spread term, as separate float32 adds
    (the reference's compiler fuses neither).  Infeasible nodes score -1."""
    aff = normalize(aff_raw, feasible)
    taint = normalize(taint_raw, feasible, reverse=True)
    total = (
        cfg.fit_weight * fit
        + cfg.balanced_weight * bal
        + cfg.node_affinity_weight * aff
        + cfg.taint_weight * taint
    )
    if spread_score is not None:
        total = total + cfg.spread_weight * spread_score
    if extra is not None:
        total = total + extra
    return torch.where(feasible, total, -1.0)


_IMG_MB = 1024.0 * 1024.0
_IMG_MIN = 23.0 * _IMG_MB              # minThreshold (image_locality.go)
_IMG_MAX_PER_CONTAINER = 1000.0 * _IMG_MB


def image_locality_score(cluster: ClusterTensors, images, p: int) -> torch.Tensor:
    """ImageLocality Score, 0..100 per node (imagelocality/image_locality.go):
    the sum of the pod's image sizes already present on the node, each
    scaled by its spread ratio (nodes having it / valid nodes), clamped into
    [23MB, 1000MB x containers] and mapped linearly onto the score range.
    No NormalizeScore pass.

    Sizes in bytes times node counts leave float32's exact range, so the
    order of operations is the reference compiler's: (size * count) /
    n_valid, then the image terms added one after another in slot order
    (XLA on the CPU reduces the [MI] axis sequentially; a pairwise or
    reversed sum rounds differently, tests/test_torch_extras.py).  Its
    multiply-add is not a question: presence is 0 or 1, so each product is
    exact and a fused add rounds as the plain one does."""
    ids = images.pod_ids[p]                                     # [MI]
    active = ids >= 0
    idc = torch.clamp(ids, 0, images.sizes.shape[0] - 1).long()
    word, bit = idc // 32, (idc % 32).to(torch.int32)
    present = ((cluster.image_bits[:, word] >> bit) & 1).to(_F32)   # [N, MI]
    n_valid = torch.clamp(cluster.node_valid.sum(), min=1).to(_F32)
    counts = (present * cluster.node_valid[:, None]).sum(dim=0)     # [MI], integers
    scaled = torch.where(active, images.sizes[idc] * counts / n_valid, 0.0)
    raw = torch.zeros(present.shape[0], dtype=_F32, device=present.device)
    for j in range(present.shape[1]):
        raw = raw + present[:, j] * scaled[j]
    # the threshold scales with the pod's image-bearing container count
    n_containers = torch.clamp(images.n_containers[p], min=1.0)
    lo = _IMG_MIN
    hi = _IMG_MAX_PER_CONTAINER * n_containers
    score = _floor(MAX_NODE_SCORE * (torch.minimum(torch.clamp(raw, min=lo), hi) - lo)
                   / (hi - lo))
    return torch.where(active.any(), score, 0.0)


def normalize_minmax(raw: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """interpodaffinity/scoring.go NormalizeScore: scale to [0, 100] by
    (raw - min) / (max - min) over the feasible nodes — unlike the default
    normalizer this handles negative raws (anti-affinity weights); 0 where
    max == min and outside the feasible set."""
    big = 1e30
    mx = torch.max(torch.where(feasible, raw, -big))
    mn = torch.min(torch.where(feasible, raw, big))
    span = mx - mn
    out = torch.where(
        span > 0, _floor(MAX_NODE_SCORE * (raw - mn) / torch.clamp(span, min=1e-30)), 0.0
    )
    return torch.where(feasible, out, 0.0)


def static_extra(cluster: ClusterTensors, prefpod, images, features, cfg: ScoreConfig,
                 rep: int, feasible: torch.Tensor, pp_state=None) -> torch.Tensor:
    """The hoisted static score extras of one class (preferred inter-pod
    affinity, normalised over `feasible`, and ImageLocality), already
    weighted: f32[N].  Each weighted term is its own multiply and add (the
    reference's compiler fuses neither, tests/test_torch_extras.py);
    pp_state is prep_pref_pod's output (required with
    features.interpod_pref)."""
    from .interpod import pref_pod_raw

    total = torch.zeros(cluster.allocatable.shape[0], dtype=_F32,
                        device=cluster.allocatable.device)
    if features.interpod_pref:
        raw = pref_pod_raw(pp_state, prefpod, rep)
        total = total + cfg.interpod_weight * normalize_minmax(raw, feasible)
    if features.images:
        total = total + cfg.image_weight * image_locality_score(cluster, images, rep)
    return total
