"""The designs of kernels class_extras and slice_stats, on the CPU.

Both kernels run only on the card, so their designs are emulated in numpy
step for step and held to the reference package (jitted, as its solves
run it), exactly:

  * class_extras (csrc/class_extras.cu): a grid of thread-block clusters,
    each a contiguous range of the pairs, each of its G blocks the 32-node
    chunks q with q % G == rank.  Per cluster, once: the images its pairs
    name (ascending ids: the compact index of each), and the valid nodes and
    each named image's valid holders counted per block and summed over the
    blocks (the DSMEM pull); the image scores read the pair's images from
    that table.  Per pair: the "own" terms over its pod_idx >= 0 rows and
    the "theirs" terms over the rows it matches, listed in row order and
    added in that order from +0; the feasible max / min per block, then
    merged over the blocks; the output written once as
    (0 + w_pref pref) + w_img image, the image terms added in slot order,
    only where the node holds the image; a pair with at most 5 set slots
    (and at most 64 named images in its cluster) reads its weighted image
    term from a table of every subset of its slots.  Against static_extra over each
    pair (preferred terms with negative weights, a pod that names and
    matches no row, an all-infeasible row, a row with one feasible node,
    more than 64 named images: the presence mask's limit, and sizes on
    which a sum in another order than the slots' gives another score).
  * slice_stats (csrc/slice_stats.cu): one cluster; the node chunks dealt
    over its blocks scatter presence and occupancy and their free counts
    and extents into the owning block's slices (s % G); each slice's
    largest cube by erosion (free cells as rows of bits; the k-cube corners
    inside the extent tested, then ANDed over the eight neighbours for
    k + 1); the totals and the gang counters summed over the blocks.  Against fragmentation and the carve-out counters of the
    reference's greedy_assign on slice clusters whose slices interleave in
    the node table and share a coordinate between several cores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace as NS

from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.ops import slices as jslices
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.testing import cases

F32 = np.float32
MB = 1024 * 1024
MASK_IMAGES, LUT_SLOTS = 64, 5     # class_extras.cu kMaskImages, kLutSlots
IMG_MIN, IMG_MAX = F32(23 * MB), F32(1000 * MB)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def block_of(n: int, g_dim: int) -> np.ndarray:
    """cluster_common.cuh block_of: 32-node chunks dealt round robin."""
    return (np.arange(n) >> 5) % g_dim


# ---- class_extras ----------------------------------------------------------------


def extras_tables(kind: str, seed: int = 0) -> dict:
    """Seeded tables of one launch: N = 200 nodes (a ragged last chunk),
    P = 24 pods, U = 12 preferred rows, MA = 4, MI = 8."""
    rng = np.random.default_rng(seed)
    n, p, u, ma, mi = 200, 24, 12, 4, 8
    t = {"n": n, "p": p}
    if kind in ("pref", "both"):
        t["counts_dom"] = rng.integers(0, 30, (u, n)).astype(F32)
        t["ownerw_dom"] = rng.integers(-300, 300, (u, n)).astype(F32)
        idx = rng.integers(-1, u, (p, ma)).astype(np.int32)
        idx[3, 2] = u + 4                       # clamped to the last row
        idx[5] = -1                             # pod 5 names no row ...
        t["pref_idx"] = idx
        t["pref_weight"] = rng.integers(-100, 101, (p, ma)).astype(F32)
        m = rng.random((p, u)) < 0.3
        m[5] = False                            # ... and matches none
        t["pref_matches"] = m
    if kind in ("image", "both", "many_images"):
        i_dim = 100 if kind == "many_images" else 40
        iw = (i_dim + 31) // 32
        present = rng.random((n, i_dim)) < rng.uniform(0.2, 0.5, i_dim)
        ib = np.zeros((n, iw), np.uint32)
        for nd, img in zip(*np.nonzero(present)):
            ib[nd, img // 32] |= np.uint32(1 << (img % 32))
        t["image_bits"] = ib
        t["node_valid"] = rng.random(n) < 0.9
        t["sizes"] = np.where(rng.random(i_dim) < 0.5,
                              rng.integers(1, 1500, i_dim) * MB + rng.integers(0, MB, i_dim),
                              rng.random(i_dim) * 1500 * MB).astype(F32)
        ids = rng.integers(-1, i_dim, (p, mi)).astype(np.int32)
        if kind != "many_images":
            ids[::2, 2:] = -1                   # at most 2 set slots: the table
            ids[1::4, 5] = -1
        ids[7] = -1                             # no image: score 0
        ids[8, 0] = i_dim + 3                   # clamped to the last image
        t["pod_ids"] = ids
        t["n_containers"] = rng.integers(0, 8, p).astype(F32)
    if kind == "order":
        # sizes on which the order of the image sum decides the score (as
        # tests/test_torch_extras.py test_image_sum_order_pinned finds
        # them): pod h names images 8h .. 8h+7, all held by node 0, the one
        # valid node, so each term is its size
        search = np.random.default_rng(1)
        sz = (search.uniform(100, 1000, size=(2_000_000, 8)) * MB).astype(F32)
        lo, hi = F32(23 * MB), F32(8000 * MB)

        def score(raw):
            return np.floor((F32(100) * (np.clip(raw, lo, hi) - lo).astype(F32)).astype(F32)
                            / F32(hi - lo))

        fwd = np.zeros(sz.shape[0], F32)
        rev = np.zeros(sz.shape[0], F32)
        for j in range(8):
            fwd = (fwd + sz[:, j]).astype(F32)
            rev = (rev + sz[:, 7 - j]).astype(F32)
        rows = sz[np.nonzero(score(fwd) != score(rev))[0][:4]]
        h = rows.shape[0]
        t["sizes"] = rows.reshape(-1)
        t["image_bits"] = np.zeros((n, 1), np.uint32)
        t["image_bits"][0] = np.uint32(0xFFFFFFFF)
        t["node_valid"] = np.arange(n) == 0
        ids = np.full((p, mi), -1, np.int32)
        ids[:h] = np.arange(8 * h, dtype=np.int32).reshape(h, 8)
        t["pod_ids"] = ids
        t["n_containers"] = np.full(p, 8, F32)
    return t


def extras_pairs(t: dict, seed: int = 0):
    """(reps, feas) of 20 pairs: random representatives and feasible rows,
    pair 1 all-infeasible, pair 2 with one feasible node, pair 4 pod 5."""
    rng = np.random.default_rng(seed + 1)
    c = 20
    reps = rng.integers(0, t["p"], c).astype(np.int32)
    reps[4] = 5
    reps[10:14] = np.arange(4)
    feas = rng.random((c, t["n"])) < 0.6
    feas[1] = False
    feas[2] = False
    feas[2, 77] = True
    return reps, feas


def reference_extras(t: dict, reps, feas, w_pref: float, w_img: float) -> np.ndarray:
    """static_extra of every pair, as the reference's hoist runs it."""
    pref_on, img_on = "counts_dom" in t, "sizes" in t
    n = t["n"]
    t = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in t.items()}
    feat = NS(interpod_pref=pref_on, images=img_on)
    cfg = jscores.ScoreConfig(interpod_weight=w_pref, image_weight=w_img)
    cluster = NS(allocatable=np.zeros((n, 1), F32), image_bits=t.get("image_bits"),
                 node_valid=t.get("node_valid"))
    prefpod = NS(pod_idx=t.get("pref_idx"), pod_weight=t.get("pref_weight"),
                 matches_incoming=t.get("pref_matches"))
    images = NS(sizes=t.get("sizes"), pod_ids=t.get("pod_ids"),
                n_containers=t.get("n_containers"))
    pp = NS(counts_dom=t.get("counts_dom"), ownerw_dom=t.get("ownerw_dom"))
    one = jax.jit(jax.vmap(lambda rep, f: jscores.static_extra(
        cluster, prefpod, images, feat, cfg, rep, f, pp)))
    return np.asarray(one(jnp.asarray(reps), jnp.asarray(feas)))


def emulate_extras(t: dict, reps, feas, w_pref: float, w_img: float, g_dim: int,
                   n_clu: int) -> np.ndarray:
    """class_extras.cu's design over a grid of n_clu clusters of g_dim
    blocks."""
    pref_on, img_on = "counts_dom" in t, "sizes" in t
    n, p = t["n"], t["p"]
    c_dim = len(reps)
    owner = block_of(n, g_dim)
    out = np.full((c_dim, n), np.nan, F32)
    w_pref, w_img = F32(w_pref), F32(w_img)
    for k in range(n_clu):
        c0, c1 = c_dim * k // n_clu, c_dim * (k + 1) // n_clu
        if img_on:
            i_dim = t["sizes"].shape[0]
            named = sorted({min(int(i), i_dim - 1)
                            for c in range(c0, c1)
                            for i in t["pod_ids"][min(max(reps[c], 0), p - 1)] if i >= 0})
            compact = {img: j for j, img in enumerate(named)}
            holds = np.stack([(t["image_bits"][:, img >> 5] >> np.uint32(img & 31)) & 1
                              for img in named] or [np.zeros(n, np.uint32)], axis=1) > 0
            valid = t["node_valid"]
            table = np.zeros(len(named) + 1, np.int64)   # the cluster's counts
            for b in range(g_dim):                       # each block's, pulled
                mine = owner == b
                table[:len(named)] += (holds[mine] & valid[mine, None]).sum(axis=0)[:len(named)]
                table[len(named)] += (valid & mine).sum()
            nv = F32(max(table[len(named)], 1))
        for c in range(c0, c1):
            rep = min(max(int(reps[c]), 0), p - 1)
            v = np.zeros(n, F32)
            if pref_on:
                u_dim = t["counts_dom"].shape[0]
                own = [(min(int(i), u_dim - 1), t["pref_weight"][rep, j])
                       for j, i in enumerate(t["pref_idx"][rep]) if i >= 0]
                theirs = [u for u in range(u_dim) if t["pref_matches"][rep, u]]
                o = np.zeros(n, F32)
                for row, w in own:
                    o = (o + (F32(w) * t["counts_dom"][row]).astype(F32)).astype(F32)
                th = np.zeros(n, F32)
                for u in theirs:
                    th = (th + t["ownerw_dom"][u]).astype(F32)
                raw = (o + th).astype(F32)
                mx, mn = F32(-1e30), F32(1e30)
                for b in range(g_dim):                   # each block's, merged
                    sel = feas[c] & (owner == b)
                    if sel.any():
                        mx, mn = max(mx, raw[sel].max()), min(mn, raw[sel].min())
                span = F32(mx - mn)
                s = (np.floor((F32(100) * (raw - mn).astype(F32)).astype(F32)
                              / max(span, F32(1e-30))) if span > 0 else np.zeros(n, F32))
                s = np.where(feas[c], s, F32(0)).astype(F32)
                v = (F32(0) + (w_pref * s).astype(F32)).astype(F32)
            if img_on:
                # the pair's set slots in slot order: (compact index, scaled size)
                slots = [(compact[min(int(i), i_dim - 1)],
                          F32(F32(t["sizes"][min(int(i), i_dim - 1)]
                                  * F32(table[compact[min(int(i), i_dim - 1)]])) / nv))
                         for i in t["pod_ids"][rep] if i >= 0]
                hi = F32(IMG_MAX * max(t["n_containers"][rep], F32(1)))

                def weighted(held):       # held: bool[len(slots)] per node
                    if not slots:
                        return (w_img * np.zeros(held.shape[0], F32)).astype(F32)
                    raw = np.zeros(held.shape[0], F32)
                    for t_, (_k, scaled) in enumerate(slots):      # slot order
                        raw = np.where(held[:, t_], (raw + scaled).astype(F32), raw)
                    img = np.floor((F32(100) * (np.minimum(np.maximum(raw, IMG_MIN), hi)
                                                - IMG_MIN).astype(F32)).astype(F32)
                                   / F32(hi - IMG_MIN)).astype(F32)
                    return (w_img * img).astype(F32)

                held = np.stack([holds[:, k] for k, _s in slots] or [np.zeros(n, bool)], axis=1)
                if len(named) <= MASK_IMAGES and len(slots) <= LUT_SLOTS:
                    # the pair's table: every subset of its set slots, then
                    # a lookup a node by its subset's index
                    subsets = ((np.arange(1 << len(slots))[:, None] >> np.arange(len(slots)))
                               & 1).astype(bool)
                    table_w = weighted(subsets)
                    index = (held[:, :len(slots)] << np.arange(len(slots))).sum(axis=1)
                    term = table_w[index]
                else:
                    term = weighted(held)
                v = (v + term).astype(F32)
            out[c] = v
    return out


@functools.lru_cache(maxsize=None)
def _extras_case(kind: str):
    t = extras_tables(kind)
    reps, feas = extras_pairs(t)
    w = (1.3, 0.7) if kind != "pref" else (2.0, 1.0)
    return t, reps, feas, w, reference_extras(t, reps, feas, *w)


@pytest.mark.parametrize("kind", ["pref", "image", "both", "many_images", "order"])
@pytest.mark.parametrize("g_dim,n_clu", [(1, 1), (3, 2), (16, 20)])
def test_class_extras_design_matches_reference(kind, g_dim, n_clu):
    t, reps, feas, w, want = _extras_case(kind)
    got = emulate_extras(t, reps, feas, *w, g_dim, n_clu)
    assert np.array_equal(bits(got), bits(want))


def test_class_extras_cases_reach_their_edges():
    """The tables hold what the design's edges need: negative raws, a pair
    whose pod names and matches nothing (pref 0), an all-infeasible row,
    more than 64 named images in one cluster."""
    t, reps, feas, _w, want = _extras_case("pref")
    assert (t["pref_weight"] < 0).any() and (t["ownerw_dom"] < 0).any()
    assert not want[1].any() and not want[4].any()
    t, reps, _f, _w, _want = _extras_case("many_images")
    named = {int(i) for r in reps for i in t["pod_ids"][r] if i >= 0}
    assert len(named) > MASK_IMAGES
    t, reps, _f, _w, _want = _extras_case("image")
    set_slots = (t["pod_ids"][reps] >= 0).sum(axis=1)
    assert (set_slots <= LUT_SLOTS).any() and (set_slots > LUT_SLOTS).any()
    t, reps, feas, w, want = _extras_case("order")
    assert t["sizes"].shape[0] == 32                 # four pods whose sum order shows
    rev = dict(t, pod_ids=t["pod_ids"][:, ::-1].copy())
    assert not np.array_equal(emulate_extras(rev, reps, feas, *w, 1, 1), want)


@pytest.mark.parametrize("g_dim", [1, 16])
def test_class_extras_design_matches_the_plain_twin(g_dim):
    """The emulation against the port's class_extras_plain on the image and
    preferred rows of cases.py's seeded batch."""
    nodes, pods, bound = cases.prefpod_objects(jw, 5)
    inodes, ipods, _ = cases.image_objects(jw, 5, n_nodes=len(nodes), n_pods=len(pods))
    for nd, ind in zip(nodes, inodes):
        nd.status.images = ind.status.images
    for pod, ipod in zip(pods, ipods):
        pod.spec.containers[0].image = ipod.spec.containers[0].image
    snap, _ = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    features = tassign.features_of(tsnap)
    assert features.interpod_pref and features.images
    cfg = tassign.DEFAULT_SCORE_CONFIG
    z = tassign.required_topo_z_split(tsnap)
    cluster, tpods, sfeas, *_rest, extra = tassign._solver_prep(tsnap, features, z, cfg)
    pp = tassign.prep_pref_pod(tsnap.cluster, tsnap.prefpod, z[1], has_bound=features.bound_pref)
    reps = torch.clamp(tpods.class_rep, 0, tpods.req.shape[0] - 1).numpy()
    t = {"n": cluster.node_valid.shape[0], "p": tpods.req.shape[0],
         "counts_dom": pp.counts_dom.numpy(), "ownerw_dom": pp.ownerw_dom.numpy(),
         "pref_idx": tsnap.prefpod.pod_idx.numpy(), "pref_weight": tsnap.prefpod.pod_weight.numpy(),
         "pref_matches": tsnap.prefpod.matches_incoming.numpy(),
         "image_bits": cluster.image_bits.numpy().view(np.uint32),
         "node_valid": cluster.node_valid.numpy(), "sizes": tsnap.images.sizes.numpy(),
         "pod_ids": tsnap.images.pod_ids.numpy(), "n_containers": tsnap.images.n_containers.numpy()}
    got = emulate_extras(t, reps, sfeas.numpy(), cfg.interpod_weight, cfg.image_weight, g_dim, 3)
    assert np.array_equal(bits(got), bits(extra.numpy()))


# ---- slice_stats -----------------------------------------------------------------


def slice_objects(seed: int):
    """Slices of several extents whose nodes interleave in the node table,
    two cores sharing each coordinate of one slice, plain nodes, bound pods
    on some nodes, and gangs of several shapes (one that no slice can
    carve)."""
    rng = np.random.default_rng(seed)
    nodes = (cases.mk_slices(jw, 2, (2, 2, 2), prefix="a")
             + cases.mk_slices(jw, 1, (4, 4, 4), prefix="b")
             + cases.mk_slices(jw, 1, (3, 2, 1), prefix="c")
             + [cases.slice_node(jw, "mc", x, y, 0, (2, 2, 1), core=c)
                for y in range(2) for x in range(2) for c in range(2)]
             + [jw.make_node(f"plain-{i}").capacity(cpu_milli=4000, mem=8 * jw.GI, pods=16).obj()
                for i in range(3)])
    nodes = [nodes[i] for i in rng.permutation(len(nodes))]
    bound = [jw.make_pod(f"bound-{i}").req(cpu_milli=100).node_name(nd.meta.name).obj()
             for i, nd in enumerate(nodes) if rng.random() < 0.2]
    pods = (cases.gang(jw, "g0", 4, "2x2x1") + cases.gang(jw, "g1", 8, "2x2x2")
            + cases.gang(jw, "g2", 2, "1x2x1") + cases.gang(jw, "g3", 6, "3x2x1")
            + cases.gang(jw, "g4", 27, "3x3x3") + cases.gang(jw, "g5", 5, "5x1x1")
            + [jw.make_pod(f"solo-{i}").req(cpu_milli=100).obj() for i in range(3)])
    return nodes, pods, bound


@functools.lru_cache(maxsize=None)
def _slices_case(seed: int, policy: str):
    """(slice_stats' arguments as the port's scan passes them, the
    reference's telemetry and fragmentation on its own final state)."""
    nodes, pods, bound = slice_objects(seed)
    snap, _m = jschema.SnapshotBuilder().build(nodes, pods, bound_pods=bound)
    jf = jassign.features_of(snap, slice_policy=policy)
    n_groups = jschema.num_groups(snap)
    want = jassign.greedy_assign(snap, jscores.DEFAULT_SCORE_CONFIG, features=jf,
                                 n_groups=n_groups)
    frag = jslices.fragmentation(want.cluster, jf.slice_z, jf.slice_dim)
    tsnap = dv.to_device(dv.snapshot_from_numpy(snap), "cpu")
    tf = tassign.features_of(tsnap, slice_policy=policy)
    seen = []
    real = tassign.slice_stats

    def capture(*args):
        seen.append(args)
        return real(*args)

    tassign.slice_stats = capture
    try:
        tassign.greedy_assign(tsnap, tassign.DEFAULT_SCORE_CONFIG, features=tf, n_groups=n_groups)
    finally:
        tassign.slice_stats = real
    assert len(seen) == 1
    return seen[0], want, frag


def emulate_slice_stats(args, g_dim: int):
    """slice_stats.cu's design on one cluster of g_dim blocks: (score f32,
    carveouts, contiguous, fallbacks, largest[S], free_count[S])."""
    final, pods, assignment, gang, features, n_groups = args
    valid = final.node_valid.numpy()
    sid = final.slice_id.numpy()
    coords = final.torus_coords.numpy()
    dims = final.slice_dims.numpy()
    req = final.requested.numpy()
    z, d = int(features.slice_z), int(features.slice_dim)
    n = sid.shape[0]
    pres = np.zeros((z, d, d, d), np.uint8)
    occ = np.zeros((z, d, d, d), np.uint8)
    # each block's shared memory: its slices' free counts and extents
    free = np.zeros(z, np.int64)
    ext = np.zeros((z, 3), np.int64)
    owner = block_of(n, g_dim)
    for b in range(g_dim):
        for nd in np.nonzero(owner == b)[0]:
            if sid[nd] < 0:
                continue
            s = min(int(sid[nd]), z - 1)
            fr = bool(valid[nd]) and req[nd, tschema.RESOURCE_PODS] <= 0
            free[s] += fr
            ext[s] = np.maximum(ext[s], dims[nd])
            c = coords[nd]
            if (c[:3] >= 0).all():
                cell = (s, *np.minimum(c[:3], d - 1))
                pres[cell] = 1
                occ[cell] |= not fr
    largest = np.zeros(z, np.int64)
    parts = np.zeros((g_dim, 2), np.int64)
    for b in range(g_dim):
        for s in range(b, z, g_dim):               # a warp a slice: erosion
            rows = np.zeros((d, d), np.int64)      # bit z of row (x, y): a free cell
            for zz in range(d):
                rows |= ((pres[s, :, :, zz] > 0) & (occ[s, :, :, zz] == 0)).astype(np.int64) << zz
            best = 0
            for k in range(1, d + 1):
                zn = ext[s][2] - k + 1
                zmask = 0 if zn <= 0 else (1 << min(zn, 31)) - 1
                xs, ys = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
                inside = (xs + k <= ext[s][0]) & (ys + k <= ext[s][1])
                if not (inside & ((rows & zmask) != 0)).any():
                    break
                best = k
                if k == d:
                    break
                shifted = np.zeros((d + 1, d + 1), np.int64)
                shifted[:d, :d] = rows
                t = rows & shifted[1:, :d] & shifted[:d, 1:] & shifted[1:, 1:]
                rows = t & (t >> 1)
            largest[s] = best
            parts[b] += (best ** 3, free[s])
    placeable, free_total = parts.sum(axis=0)
    score = F32(1) - F32(F32(placeable) / max(F32(free_total), F32(1)))
    counters = [0, 0, 0]
    if gang is not None and n_groups > 0:
        gang_sl, gang_lo, corner = (x.numpy() for x in gang)
        flags = np.zeros(n_groups, np.int64)
        gid, shape = pods.group_id.numpy(), pods.pod_shape.numpy()
        a = assignment.numpy()
        for i in range(gid.shape[0]):
            g = gid[i]
            if not (pods.valid.numpy()[i] and g >= 0 and shape[i].prod() > 0):
                continue
            gc = min(max(int(g), 0), n_groups - 1)
            f = 1
            if a[i] < 0:
                f |= 2
            else:
                an = min(max(int(a[i]), 0), n - 1)
                inside = sid[an] == gang_sl[gc] and all(
                    gang_lo[gc, j] <= coords[an, j] < gang_lo[gc, j] + shape[i, j]
                    for j in range(3))
                f |= 0 if inside else 4
            flags[gc] |= f
        carve = contig = complete = 0
        for b in range(g_dim):                     # each block's gangs, summed
            for g in range(b, n_groups, g_dim):
                anyf, done = bool(flags[g] & 1), bool(flags[g] & 1) and not flags[g] & 2
                anchored = gang_sl[g] >= 0 and anyf
                carve += anchored
                complete += done
                contig += done and anchored and bool(corner[g]) and not flags[g] & 4
        counters = [carve, contig, complete - contig]
    return F32(max(score, F32(0))), counters, largest, free


@pytest.mark.parametrize("policy", ["prefer", "require"])
@pytest.mark.parametrize("g_dim", [1, 3, 16])
def test_slice_stats_design_matches_reference(policy, g_dim):
    args, want, frag = _slices_case(3, policy)
    score, counters, largest, free = emulate_slice_stats(args, g_dim)
    assert np.array_equal(largest, np.asarray(frag.largest_cube))
    assert np.array_equal(free, np.asarray(frag.free_count))
    assert bits(score) == bits(want.frag_score)
    assert counters == [int(want.carveouts), int(want.contiguous_gangs),
                        int(want.carveout_fallbacks)]


def test_slice_stats_cases_reach_their_edges():
    """The batch interleaves its slices in the node table and shares a
    coordinate between cores; under "prefer" a gang that no slice can carve
    completes as a fallback, under "require" it stays incomplete."""
    args, want, frag = _slices_case(3, "prefer")
    sid = args[0].slice_id.numpy()
    real = sid[sid >= 0]
    assert (np.diff(real) != 0).sum() > len(set(real.tolist()))   # interleaved
    xyz = args[0].torus_coords.numpy()[:, :3]
    keys = [(int(s), *map(int, c)) for s, c in zip(sid, xyz) if s >= 0]
    assert len(keys) > len(set(keys))                              # shared coordinates
    assert int(want.carveouts) > 0 and int(want.carveout_fallbacks) > 0
    assert 0.0 < float(want.frag_score) < 1.0
    _args, want, _frag = _slices_case(3, "require")
    assert int(want.contiguous_gangs) + int(want.carveout_fallbacks) < 6
