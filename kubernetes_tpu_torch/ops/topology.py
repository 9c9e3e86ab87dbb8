"""PodTopologySpread as tensor ops.

The reference scheduler precomputes per-(topologyKey, value) match counts
and a critical-path minimum in PreFilter, then filters on
  matchNum + selfMatch - globalMin > maxSkew
(podtopologyspread/filtering.go:313-365) and scores soft constraints by
log-weighted match counts (scoring.go:190-310).

Counts live in NODE space: counts_node[c, n] is the match count of node
n's topology value for constraint row c, so a placement adds one on every
node that shares the chosen node's value, and the critical-path minimum is
the min over eligible nodes (every eligible value has an eligible node).
The semantics are the reference package's (kubernetes_tpu/ops/topology.py),
including its documented divergences: minDomains uses the prep-time count
of eligible domains (`sizes`), and the soft score's log weight uses the
distinct eligible values, not a per-cycle recount over feasible nodes.
On the card the per-batch prep is kernel `family_prep` (entry spread,
csrc/family_prep.cu); `prep_spread_plain` is its plain twin.

Numerics: the soft score is `round(sum of cnt * log(sizes + 2) + (maxSkew
- 1))`, and the reference's compiler (XLA on the CPU) computes both the log
and the multiply-add its own way: `log32` is its float32 log, bit for bit
(not torch's, not CUDA's, not correctly rounded), and the multiply-add is
fused (`fma32`), as XLA fuses it.  The CUDA kernels carry the same
operations (csrc/solve_common.cuh `log32`, `__fmaf_rn`, `rintf`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .schema import ClusterTensors, SpreadTable
from .scores import fma32

_BIG = 1e9
_F32 = torch.float32


class SpreadState(NamedTuple):
    counts_node: torch.Tensor  # f32[C, N] match count of n's topo value
    eligible: torch.Tensor     # bool[C, N] nodes counted for this constraint
    v: torch.Tensor            # i32[C, N] node's topo value per constraint (-1 absent)
    sizes: torch.Tensor        # f32[C] distinct eligible values (scoring weight)


def prep_spread(
    cluster: ClusterTensors,
    sel_mask: torch.Tensor,
    spread: SpreadTable,
    z: int,
    has_bound: bool = True,
) -> SpreadState:
    """Wrapper of kernel `family_prep` (entry spread): the kernel for
    tensors on the card, prep_spread_plain for tensors on the CPU.  The
    kernel adds the bound-pod counts with atomics, in no fixed order: each
    count is an integer-valued float32 (at most 110 pods a node), so a
    (row, value) sum is exact in any order while it stays below 2^24 —
    152,520 nodes of 110 matching pods in one domain.  Every cell run so
    far stays far below (the widest, the north star's 50,000 nodes, has no
    spread rows; TopologySpreading/5000Nodes at most 5,000 x 110)."""
    if cluster.node_valid.device.type == "cpu":
        return prep_spread_plain(cluster, sel_mask, spread, z, has_bound)
    from ..kernels import bindings

    return bindings.family_prep_spread(cluster, sel_mask, spread, z, has_bound)


def prep_spread_plain(
    cluster: ClusterTensors,
    sel_mask: torch.Tensor,
    spread: SpreadTable,
    z: int,
    has_bound: bool = True,
) -> SpreadState:
    """Plain version of kernel `family_prep`'s spread entry: the per-batch
    assembly (the PreFilter/PreScore analogue).  Eligibility
    honours the owner pod's node selector/affinity and requires every
    topology key the owner's constraints use.  z bounds the value-space
    scatter that folds bound-pod counts; has_bound=False
    (FeatureFlags.bound_spread) leaves the counts at zero.  JAX drops
    out-of-range scatter rows and torch raises, so values are clipped
    into [0, z) and masked with v >= 0, as the reference clips and masks.
    Every scattered count is an integer-valued float32 below 2^24, so the
    order of the additions does not matter."""
    c_dim = spread.owner_keys.shape[0]
    n = cluster.node_valid.shape[0]
    dev = cluster.node_valid.device
    s_dim = sel_mask.shape[0]
    owner_ok = torch.where(
        (spread.owner_sel_idx < 0)[:, None],
        torch.ones((c_dim, n), dtype=torch.bool, device=dev),
        sel_mask[torch.clamp(spread.owner_sel_idx, 0, max(s_dim - 1, 0)).long()],
    )
    keys_present = cluster.topo_ids >= 0                            # [N, TK]
    keys_ok = (
        (~spread.owner_keys[:, None, :]) | keys_present[None, :, :]
    ).all(dim=-1)                                                   # [C, N]
    eligible = (
        owner_ok & keys_ok & cluster.node_valid[None, :] & spread.valid[:, None]
    )
    tk = cluster.topo_ids.shape[1]
    slot = torch.clamp(spread.slot, 0, tk - 1).long()
    v = cluster.topo_ids[:, slot].T.contiguous()                    # [C, N]
    vc = torch.clamp(v, 0, z - 1).long()
    ok = eligible & (v >= 0)
    flat = (torch.arange(c_dim, device=dev)[:, None] * z + vc).reshape(-1)   # [C N]
    vmask = torch.zeros(c_dim * z, dtype=torch.int32, device=dev)
    vmask = vmask.index_add_(0, flat, ok.reshape(-1).to(torch.int32)).view(c_dim, z) > 0
    if has_bound:
        counts_z = torch.zeros(c_dim * z, dtype=_F32, device=dev)
        counts_z.index_add_(0, flat, (spread.node_matches * ok).reshape(-1))
        counts_node = torch.gather(counts_z.view(c_dim, z), 1, vc)
        counts_node = torch.where(v >= 0, counts_node, 0.0)
    else:
        counts_node = torch.zeros((c_dim, n), dtype=_F32, device=dev)
    return SpreadState(
        counts_node=counts_node,
        eligible=eligible,
        v=v,
        sizes=vmask.sum(dim=-1).to(_F32),
    )


def _rows(spread: SpreadTable, state: SpreadState, p):
    cidx = spread.pod_idx[p]                                        # [..., MC]
    c = torch.clamp(cidx, 0, state.counts_node.shape[0] - 1).long()
    return cidx, c


def spread_min_match(state: SpreadState, spread: SpreadTable, c: torch.Tensor) -> torch.Tensor:
    """The critical-path minimum of rows c: the min count over eligible
    nodes, 0 where no node is eligible or where fewer eligible domains
    exist than minDomains asks for (0 in the table means unset)."""
    counts = state.counts_node[c]
    min_match = torch.where(state.eligible[c], counts, _BIG).min(dim=-1).values
    min_match = torch.where(min_match >= _BIG, 0.0, min_match)
    md = spread.min_domains[c]
    return torch.where((md > 0) & (state.sizes[c] < md), 0.0, min_match)


def spread_filter(state: SpreadState, spread: SpreadTable, p) -> torch.Tensor:
    """Hard (DoNotSchedule) constraint check for pod p over all nodes:
    bool[N].  p may also be a tensor of K pod indices (bool[K, N]), so a
    batch of pods is checked with no host read of the indices."""
    cidx, c = _rows(spread, state, p)
    active = cidx >= 0
    counts = state.counts_node[c]                                   # [..., MC, N]
    min_match = spread_min_match(state, spread, c)                  # [..., MC]
    self_match = torch.gather(spread.pod_matches[p], -1, c).to(_F32)  # [..., MC]
    skew = counts + self_match[..., None] - min_match[..., None]
    ok = (skew <= spread.max_skew[c][..., None]) & (state.v[c] >= 0)
    enforced = active & spread.hard[c]
    return (ok | ~enforced[..., None]).all(dim=-2)


def spread_score(
    state: SpreadState, spread: SpreadTable, p: int, feasible: torch.Tensor,
) -> torch.Tensor:
    """Soft (ScheduleAnyway) constraint score, normalized to [0, 100]:
    lower matching count => higher score, log topology-size weights,
    maxSkew - 1 damping (scoring.go Score + NormalizeScore).  The rows
    are summed one after another, as the reference's reduction adds them."""
    cidx, c = _rows(spread, state, p)
    soft = (cidx >= 0) & ~spread.hard[c]
    v = state.v[c]                                                  # [MC, N]
    ignored = (soft[:, None] & (v < 0)).any(dim=0)
    scored = feasible & ~ignored
    weight = log32(state.sizes[c] + 2.0)                            # [MC]
    cnt = state.counts_node[c]                                      # [MC, N]
    per_c = fma32(cnt, weight[:, None], spread.max_skew[c][:, None] - 1.0)
    total = torch.zeros_like(feasible, dtype=_F32)
    for j in range(c.shape[0]):
        total = total + torch.where(soft[j], per_c[j], 0.0)
    raw = torch.round(total)
    mx = torch.where(scored, raw, -_BIG).max()
    mn = torch.where(scored, raw, _BIG).min()
    norm = torch.where(
        mx <= 0.0,
        100.0,
        torch.floor(100.0 * (mx + mn - raw) / torch.clamp(mx, min=1e-30)),
    )
    out = torch.where(scored, norm, 0.0)
    return torch.where(soft.any(), out, 0.0)


def spread_update(
    state: SpreadState, spread: SpreadTable, p: int, choice: int,
) -> SpreadState:
    """Account pod p placed on node `choice`: every constraint whose
    selector the pod matches (and whose eligible set holds the node) gains
    one match on every node sharing the node's topology value."""
    v_at = state.v[:, choice]
    add = (spread.pod_matches[p] & state.eligible[:, choice] & (v_at >= 0)).to(_F32)
    counts = state.counts_node + add[:, None] * (state.v == v_at[:, None])
    return state._replace(counts_node=counts)


# -- the reference compiler's float32 log ----------------------------------
#
# XLA's CPU backend lowers jnp.log of float32 to a Cephes-style polynomial
# (frexp into [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three Horner
# chains, the exponent folded back in two parts), which LLVM compiles with
# fused multiply-adds in the places below, and it runs with denormals
# treated as zero.  The constants are the float32 roundings of Cephes'
# logf coefficients.  log32 equals jax.jit(jnp.log) on the CPU bit for bit
# (tests/test_torch_topology.py); torch.log and CUDA's logf do not.

_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_FLT_MIN = float(np.finfo(np.float32).tiny)


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, equal to XLA's CPU jnp.log bit for bit."""
    x = x.to(_F32)
    m = torch.where(x.abs() < _FLT_MIN, 1.0, x)   # zeros / denormals: below
    m = torch.where(m > 0, m, 1.0)                 # negatives / NaN: below
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    xm = ((bits & -2139095041) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    small = xm < _SQRTHF
    xr = (xm - 1.0) + torch.where(small, xm, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = xr * xr
    x3 = x2 * xr
    p = _LOG_P
    y = fma32(fma32(xr, p[0], p[1]), xr, p[2])
    y1 = fma32(fma32(xr, p[3], p[4]), xr, p[5])
    y2 = fma32(fma32(xr, p[6], p[7]), xr, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _LOG_Q1 * e)
    r = fma32(_LOG_Q2, e, (xr - 0.5 * x2) + y)
    r = torch.where((x < 0) | torch.isnan(x), float("nan"), r)
    r = torch.where(x.abs() < _FLT_MIN, float("-inf"), r)
    return torch.where(x == float("inf"), float("inf"), r)
