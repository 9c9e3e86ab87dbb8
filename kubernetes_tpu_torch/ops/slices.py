"""TPU slice topology — torus-aware gang carve-outs, plain torch.

A TPU slice is a torus of devices; a training gang wants a contiguous
axis-aligned sub-cuboid of one slice, not G scattered hosts.  The cluster
tensors carry each node's slice id, torus coordinates and the owning
slice's extent (ops/schema.py, from the api.LABEL_TPU_* node labels).
This module holds the plain versions of the carve-out family, each equal to
the reference package's ops/slices.py function of the same name:

  contiguity     corner_mask: is node n the min-corner of a fully free
                 a x b x c box of its slice?  Free occupancy is scattered
                 into a value-space grid [S, D, D, D], a zero-padded 3-D
                 integral image makes every box sum eight gathers.
  adjacency      carveout_eval: anchors (a gang's first member, or a solo
                 shaped pod) score free-box corners by best-fit leftover,
                 then by coordinate-sum packing; anchored members score the
                 anchored box by torus hops to its corner.
  fragmentation  per slice the largest placeable free cube and the score
                 1 - placeable / free.

On the card these run fused inside the kernels that use them
(csrc/slices_common.cuh: `greedy_scan`'s carve-out stage,
`evaluate_single`, `slice_stats`); what runs here is what the CPU tests
hold against the reference and what chip_smoke.py holds the kernels to.

Semantics (shared by every solve, the oracle and the reference):
  * a node is FREE iff it belongs to a slice, is valid and carries no
    (bound or in-scan assumed) pods — requested[:, RESOURCE_PODS] <= 0;
  * a carve-out is a non-wrapping box [lo, lo + shape) inside one slice's
    declared extent;
  * a gang's first placed member anchors the box at its own coordinates;
    "require" turns both preferences into filters, "prefer" falls back to
    scattered placement.

Numerics: every count is an integer below 2^24 (at most D^3 = 4,096 cells
a slice), so the integral image, the box sums and the bonuses are exact in
float32 whatever the order of additions, fused or not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.vocab import pad_dim
from .schema import RESOURCE_PODS, ClusterTensors

# Carve-out score-family weights, the reference's verbatim: exact small
# integers, so contiguous placements rank strictly above fragmenting ones.
BONUS_CARVE = 1_000_000.0   # in-carve-out member / free-box corner anchor
BONUS_SLICE = 10_000.0      # anchored gang's slice (prefer-mode fallback)
W_LEFTOVER = 100.0          # anchor best-fit: slice free count minus volume
W_HOP = 10.0                # member compactness: torus hops to the corner
W_CORNER = 10.0             # anchor packing: corner coordinate sum

_F32 = torch.float32


class SliceStats(NamedTuple):
    """fragmentation() report."""

    score: torch.Tensor         # f32[]  1 - largest-placeable-cube share of free
    largest_cube: torch.Tensor  # i32[S] per-slice largest free cube edge
    free_count: torch.Tensor    # f32[S] free devices per slice


def free_devices(cluster: ClusterTensors) -> torch.Tensor:
    """bool[N]: slice-member nodes hosting no pods (RESOURCE_PODS counts
    bound and in-scan assumed pods, so the mask tightens as a solve places
    gangs)."""
    return (
        cluster.node_valid
        & (cluster.slice_id >= 0)
        & (cluster.requested[:, RESOURCE_PODS] <= 0)
    )


def _has_coords(cluster: ClusterTensors) -> torch.Tensor:
    xyz = cluster.torus_coords[:, :3]
    return (cluster.slice_id >= 0) & (xyz >= 0).all(dim=-1)


def _cell_grid(cluster: ClusterTensors, free: torch.Tensor, slice_z: int,
               dmax: int) -> torch.Tensor:
    """bool[S, D, D, D]: coordinate (s, x, y, z) is present and free.  A
    coordinate shared by several nodes (core index) is free only when every
    node on it is free: a scatter-max of presence and of occupancy."""
    xyz = cluster.torus_coords[:, :3]
    has = _has_coords(cluster)
    sc = torch.clamp(cluster.slice_id, 0, slice_z - 1).long()
    cc = torch.clamp(xyz, 0, dmax - 1).long()
    flat = ((sc * dmax + cc[:, 0]) * dmax + cc[:, 1]) * dmax + cc[:, 2]
    size = slice_z * dmax ** 3
    zeros = torch.zeros(size, dtype=torch.int32, device=free.device)
    pres = zeros.scatter_reduce(0, flat, has.to(torch.int32), "amax")
    occ = zeros.scatter_reduce(0, flat, (has & ~free).to(torch.int32), "amax")
    return ((pres > 0) & (occ == 0)).view(slice_z, dmax, dmax, dmax)


def _integral(cell: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3-D integral image: I[s, i, j, k] = free cells with
    x < i, y < j, z < k."""
    g = torch.nn.functional.pad(cell.to(_F32), (1, 0, 1, 0, 1, 0))
    return g.cumsum(dim=1).cumsum(dim=2).cumsum(dim=3)


def _box_sum(integral: torch.Tensor, s, lo, hi) -> torch.Tensor:
    """Free-cell count in [lo, hi) of slice s (lo / hi i32[..., 3] already
    within [0, D])."""
    s = s.long()
    l0, l1, l2 = (lo[..., j].long() for j in range(3))
    h0, h1, h2 = (hi[..., j].long() for j in range(3))

    def at(a, b, c):
        return integral[s, a, b, c]

    return (
        at(h0, h1, h2)
        - at(l0, h1, h2) - at(h0, l1, h2) - at(h0, h1, l2)
        + at(l0, l1, h2) + at(l0, h1, l2) + at(h0, l1, l2)
        - at(l0, l1, l2)
    )


def corner_mask(cluster: ClusterTensors, free: torch.Tensor, shape: torch.Tensor,
                slice_z: int, dmax: int,
                integral: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[N]: node n is the min-corner of a fully free `shape` box
    inside its slice's declared extent (shape: i32[3])."""
    if integral is None:
        integral = _integral(_cell_grid(cluster, free, slice_z, dmax))
    xyz = cluster.torus_coords[:, :3]
    fits = _has_coords(cluster) & (
        (xyz + shape[None, :]) <= cluster.slice_dims).all(dim=-1)
    s = torch.clamp(cluster.slice_id, 0, slice_z - 1)
    lo = torch.clamp(xyz, 0, dmax)
    hi = torch.clamp(xyz + shape[None, :], 0, dmax)
    vol = shape.prod().to(_F32)
    full = _box_sum(integral, s, lo, hi) >= vol
    return fits & full & free


def slice_free_counts(cluster: ClusterTensors, free: torch.Tensor,
                      slice_z: int) -> torch.Tensor:
    """f32[S]: free nodes per slice (integers, exact)."""
    sc = torch.clamp(cluster.slice_id, 0, slice_z - 1).long()
    counts = torch.zeros(slice_z, dtype=_F32, device=free.device)
    return counts.index_add(0, sc, torch.where(free, 1.0, 0.0))


def carveout_eval(cluster: ClusterTensors, pods, i: int,
                  gang_sl: Optional[torch.Tensor], gang_lo: Optional[torch.Tensor],
                  features) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carve-out Filter + Score of pod i against the carry:
    (bonus f32[N], ok bool[N]).  `ok` is the require-mode filter (anchors:
    free-box corners; members: the anchored box); `bonus` is added after
    the normalised base scores.  Unshaped pods get (0, True).  Only the
    branch pod i takes is computed; the reference computes both and
    selects, with the same result."""
    n = cluster.slice_id.shape[0]
    dev = cluster.slice_id.device
    shape = pods.pod_shape[i]
    zero = torch.zeros(n, dtype=_F32, device=dev)
    if int(shape.prod()) <= 0:
        return zero, torch.ones(n, dtype=torch.bool, device=dev)
    g = int(pods.group_id[i])
    sid = cluster.slice_id
    xyz = cluster.torus_coords[:, :3]
    free = free_devices(cluster)
    anchored = False
    if gang_sl is not None and g >= 0:
        gc = min(max(g, 0), gang_sl.shape[0] - 1)
        asl, alo = int(gang_sl[gc]), gang_lo[gc]
        anchored = asl >= 0
    if anchored:
        # one member per device: free in-box nodes, nearest to the corner
        same = (sid == asl) & (sid >= 0) & free
        in_cub = (
            same
            & (xyz >= alo[None, :]).all(dim=-1)
            & (xyz < alo[None, :] + shape[None, :]).all(dim=-1)
        )
        hop = torch.abs(xyz - alo[None, :]).sum(dim=-1).to(_F32)
        bonus = torch.where(
            in_cub, BONUS_CARVE + BONUS_SLICE - W_HOP * hop,
            torch.where(same, BONUS_SLICE - W_HOP * hop, 0.0),
        )
        return bonus, in_cub
    corner = corner_mask(cluster, free, shape, features.slice_z, features.slice_dim)
    fc = slice_free_counts(cluster, free, features.slice_z)
    leftover = torch.clamp(
        fc[torch.clamp(sid, 0, features.slice_z - 1).long()] - shape.prod().to(_F32),
        min=0.0,
    )
    coordsum = torch.where(
        (xyz >= 0).all(dim=-1), xyz.sum(dim=-1), 0).to(_F32)
    bonus = torch.where(
        corner, BONUS_CARVE - W_LEFTOVER * leftover - W_CORNER * coordsum, 0.0)
    return bonus, corner


def fragmentation(cluster: ClusterTensors, slice_z: int, dmax: int) -> SliceStats:
    """Cluster-wide packing health from the current free mask: per slice
    the largest placeable free cube (the window check swept over
    k = 1..D) and the share of free devices those cubes cover."""
    free = free_devices(cluster)
    integral = _integral(_cell_grid(cluster, free, slice_z, dmax))
    dev = free.device
    sc = torch.clamp(cluster.slice_id, 0, slice_z - 1).long()
    member = (cluster.slice_id >= 0)[:, None]
    sdims = torch.zeros((slice_z, 3), dtype=torch.int32, device=dev).scatter_reduce(
        0, sc[:, None].expand(-1, 3).contiguous(),
        torch.where(member, cluster.slice_dims, 0).to(torch.int32), "amax")
    coords = torch.arange(dmax, device=dev, dtype=torch.int32)
    lo = torch.stack(torch.meshgrid(coords, coords, coords, indexing="ij"), dim=-1)
    shape4 = (slice_z, dmax, dmax, dmax)
    s_idx = torch.arange(slice_z, device=dev)[:, None, None, None].expand(shape4)
    lo_b = lo[None].expand(slice_z, dmax, dmax, dmax, 3)
    largest = torch.zeros(slice_z, dtype=torch.int32, device=dev)
    for k in range(1, dmax + 1):
        hi_b = torch.clamp(lo_b + k, 0, dmax)
        cnt = _box_sum(integral, s_idx, lo_b, hi_b)
        in_bounds = ((lo[None] + k) <= sdims[:, None, None, None, :]).all(dim=-1)
        exists = (in_bounds & (cnt >= float(k ** 3))).flatten(1).any(dim=1)
        largest = torch.where(exists, k, largest).to(torch.int32)
    free_count = slice_free_counts(cluster, free, slice_z)
    lf = largest.to(_F32)
    placeable = (lf * lf * lf).sum()
    total_free = free_count.sum()
    score = 1.0 - placeable / torch.clamp(total_free, min=1.0)
    return SliceStats(score=torch.clamp(score, min=0.0), largest_cube=largest,
                      free_count=free_count)


def fragmentation_report(cluster: ClusterTensors) -> dict:
    """Host convenience: derive the capacities from the cluster tensors
    (numpy or torch) and return plain numbers, as the reference's does."""
    def host(x):
        return torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))

    cl = cluster._replace(**{f: host(getattr(cluster, f)) for f in (
        "node_valid", "slice_id", "requested", "torus_coords", "slice_dims")})
    sids = cl.slice_id.numpy()
    if not (sids >= 0).any():
        return {"score": 0.0, "largest_cube": [], "free_count": []}
    slice_z = pad_dim(int(sids.max()) + 1, 1)
    dmax = max(int(cl.slice_dims.max()), 1)
    stats = fragmentation(cl, slice_z, dmax)
    n_real = int(sids.max()) + 1
    return {
        "score": float(stats.score),
        "largest_cube": stats.largest_cube[:n_real].tolist(),
        "free_count": stats.free_count[:n_real].tolist(),
    }


def carve_stats_plain(cluster: ClusterTensors, pods, assignment: torch.Tensor,
                      gang, features, n_groups: int) -> tuple:
    """Plain version of kernel `slice_stats`: (frag_score f32[],
    carveouts i32[], contiguous_gangs i32[], carveout_fallbacks i32[]) of
    the post-release `cluster` and `assignment` (reference greedy_assign's
    carve-out telemetry, ops/assign.py:776-818).  gang: the scan's final
    (gang_sl, gang_lo, gang_corner), or None without the gang carry."""
    dev = assignment.device
    i32 = torch.int32
    frag = fragmentation(cluster, features.slice_z, features.slice_dim).score
    if gang is None:
        z = torch.zeros((), dtype=i32, device=dev)
        return frag, z, z.clone(), z.clone()
    gang_sl, gang_lo, gang_corner = gang
    g = pods.group_id
    gc = torch.clamp(g, 0, n_groups - 1).long()
    member = pods.valid & (g >= 0) & (pods.pod_shape.prod(dim=-1) > 0)

    def any_by_group(flag):
        out = torch.zeros(n_groups, dtype=i32, device=dev)
        return out.scatter_reduce(0, gc, flag.to(i32), "amax") > 0

    any_member = any_by_group(member)
    complete = any_member & ~any_by_group(member & (assignment < 0))
    n_total = cluster.slice_id.shape[0]
    a = torch.clamp(assignment, 0, n_total - 1).long()
    a_sid = cluster.slice_id[a]
    a_xyz = cluster.torus_coords[a][:, :3]
    lo = gang_lo[gc]
    in_cub = (
        (a_sid == gang_sl[gc])
        & (a_xyz >= lo).all(dim=-1)
        & (a_xyz < lo + pods.pod_shape).all(dim=-1)
    )
    out_of_cub = any_by_group(member & (assignment >= 0) & ~in_cub)
    anchored = (gang_sl >= 0) & any_member
    carveouts = anchored.sum().to(i32)
    contiguous = (complete & anchored & gang_corner & ~out_of_cub).sum().to(i32)
    fallbacks = complete.sum().to(i32) - contiguous
    return frag, carveouts, contiguous, fallbacks


def slice_stats(cluster: ClusterTensors, pods, assignment: torch.Tensor, gang,
                features, n_groups: int) -> tuple:
    """Wrapper of kernel `slice_stats`: the kernel for tensors on the card,
    the plain version (carve_stats_plain) for tensors on the CPU."""
    if assignment.device.type == "cpu":
        return carve_stats_plain(cluster, pods, assignment, gang, features, n_groups)
    from ..kernels import bindings

    return bindings.slice_stats(cluster, pods, assignment, gang, features, n_groups)
