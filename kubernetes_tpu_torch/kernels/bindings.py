"""ctypes bindings of the CUDA kernels, with their launch counters.

Each function takes tensors on one CUDA device, checks their dtypes,
allocates the outputs with torch, launches the kernel on torch's current
stream, raises if the launch returned a CUDA error, and adds one to
`LAUNCHES[name]` for every call of the kernel's C launch function.  A call
enqueues the kernel's work for one unit: one table (match_terms), one
batch (class_statics, class_extras, greedy_scan, wavefront — the
wavefront's call enqueues two kernels a wave —, slice_stats — two kernels),
one stage of one pod's evaluation (evaluate_single: its filter and its
score, one call each), one index-list pair of
the partials store (partials_eval), one packed row delta (mirror_rows:
every leaf it names), one bidding round
(auction_bids — two kernels; auction_spread, auction_interpod — one), one
stage of a round (auction_accept: a round whole, or with a repair family
its acceptance and its commit, one call each).  Nothing here
synchronises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..ops.assign import term_bits_copy, wave_term_rows
from . import build

LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int

_F = ctypes.c_float

# the spread family's launch arguments (_spread_args): 4 ints, 9 pointers
_SPREAD = [_I] * 4 + [_P] * 9
# the inter-pod family's (_terms_args): 5 ints, 12 pointers; then the
# classes' extra score rows (one pointer, null without extras)
_TERMS = [_I] * 5 + [_P] * 12 + [_P]
# the slice carve-out family's (_slices_args): 5 ints, 9 pointers
_SLICES = [_I] * 5 + [_P] * 9

_ARGTYPES = {
    "match_terms": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "class_statics": [_I] * 8 + [_P] * 19,
    "greedy_scan": [_I] * 7 + [_P] * 16 + _SPREAD + _TERMS + _SLICES + [_P] * 9,
    "slice_stats": [_I] * 7 + [_P] * 18,
    "evaluate_single": [_I] * 4 + [_P] * 10 + _SPREAD + _TERMS + _SLICES + [_P] * 5,
    "wavefront": [_I] * 9 + [_P] * 16 + _SPREAD + _TERMS + [_P] * 13,
    "auction_bids": [_I] * 7 + [_P] * 17 + [_I, _P, _P] + _SPREAD + _TERMS + [_P] * 8,
    "auction_accept": [_I] * 5 + [_P] * 19,
    "auction_spread": [_I] * 5 + [_P] * 20,
    "auction_interpod": [_I] * 6 + [_P] * 17,
    "class_extras": [_I] * 6 + [_F] * 2 + [_P] * 2 + [_I] * 2 + [_P] * 5 + [_I] * 3 + [_P] * 7,
    "partials_eval": [_I] * 12 + [_P] * 27,
    "mirror_rows": [_P, _I, _I, _P],
    "preempt_dry_run": [_I] * 5 + [_P] * 14,
    "pod_filters": [_I] * 7 + [_P] * 16,
}
# preempt_dry_run's second entry (dry_run_victims): 3 ints, 9 pointers
_DRY_RUN_VICTIMS = [_I] * 3 + [_P] * 9

# greedy_scan.cu's static capacities and parameter-block layout
MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE, MAX_MC, MAX_TW = 32, 256, 8, 16, 8, 32
IP_COUNT = 4 + 2 * MAX_FIT
FP_COUNT = 5 + MAX_FIT + 2 * MAX_SHAPE + 1
_STRATEGY = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_GRID_Y = 65535
MAX_WAVE = 32        # wavefront.cu's widest wave
BIDS_GRID = 132      # auction_bids' class-pass blocks: one an SM, at most
MAX_MI = 16          # class_extras.cu's images a pod
MAX_SLICE_DIM = 16   # slices_common.cuh's widest slice extent
LEAF_BYTES = 48      # mirror_rows.cu's descriptor (ops/device.py LEAF_DTYPE)
MAX_VICTIM_SLOTS = 4096  # preempt_dry_run.cu's widest victim axis


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launcher(name: str):
    lib = build.library(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        if name == "greedy_scan":
            limits = getattr(lib, "greedy_scan_limits")
            limits.restype, limits.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(limits(i) for i in range(8))
            want = (MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE, IP_COUNT, FP_COUNT, MAX_MC, MAX_TW)
            if got != want:
                raise RuntimeError(f"greedy_scan limits {got} != bindings {want}")
        if name == "wavefront":
            max_k = getattr(lib, "wavefront_max_k")
            max_k.restype, max_k.argtypes = ctypes.c_int, []
            if max_k() != MAX_WAVE:
                raise RuntimeError(f"wavefront max K {max_k()} != bindings {MAX_WAVE}")
        if name == "mirror_rows":
            leaf = getattr(lib, "mirror_rows_leaf_bytes")
            leaf.restype, leaf.argtypes = ctypes.c_int, []
            if leaf() != LEAF_BYTES:
                raise RuntimeError(f"mirror_rows descriptor {leaf()} B != bindings {LEAF_BYTES} B")
        if name in ("slice_stats", "evaluate_single"):
            lim = getattr(lib, f"{name}_limits")
            if name == "slice_stats":
                lim.restype, lim.argtypes = ctypes.c_int, []
                got, want = (lim(),), (MAX_SLICE_DIM,)
            else:
                lim.restype, lim.argtypes = ctypes.c_int, [ctypes.c_int]
                got = tuple(lim(i) for i in range(4))
                want = (MAX_R, MAX_MC, MAX_TW, MAX_SLICE_DIM)
            if got != want:
                raise RuntimeError(f"{name} limits {got} != bindings {want}")
        if name == "preempt_dry_run":
            max_k = getattr(lib, "preempt_dry_run_max_k")
            max_k.restype, max_k.argtypes = ctypes.c_int, []
            if max_k() != MAX_VICTIM_SLOTS:
                raise RuntimeError(f"preempt_dry_run max K {max_k()} != bindings "
                                   f"{MAX_VICTIM_SLOTS}")
        if name == "class_extras":
            max_mi = getattr(lib, "class_extras_limits")
            max_mi.restype, max_mi.argtypes = ctypes.c_int, []
            if max_mi() != MAX_MI:
                raise RuntimeError(f"class_extras max MI {max_mi()} != bindings {MAX_MI}")
    return fn


def _arg(t: torch.Tensor, dtype: torch.dtype, device: torch.device, what: str) -> torch.Tensor:
    """The tensor as the kernel reads it: on `device`, of `dtype` (bool
    passes as its uint8 storage), contiguous."""
    if t.device != device:
        raise ValueError(f"{what}: tensor on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
    t = t.contiguous()
    return t.view(torch.uint8) if dtype == torch.bool else t


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        code = _launcher(name)(*args, _stream(device))
    build.check(name, code)
    LAUNCHES[name] += 1


def match_terms(
    label_bits, topo_ids, expr_ids, expr_op, expr_slot, term_valid,
) -> torch.Tensor:
    """bool[R, N]: per row, OR over valid terms of the AND of expressions."""
    dev = label_bits.device
    i32 = torch.int32
    label_bits = _arg(label_bits, i32, dev, "label_bits")
    topo_ids = _arg(topo_ids, i32, dev, "topo_ids")
    expr_ids = _arg(expr_ids, i32, dev, "expr_ids")
    expr_op = _arg(expr_op, i32, dev, "expr_op")
    expr_slot = _arg(expr_slot, i32, dev, "expr_slot")
    term_valid = _arg(term_valid, torch.bool, dev, "term_valid")
    n, lw = label_bits.shape
    tk = topo_ids.shape[1]
    rows, t, e, k = expr_ids.shape
    if expr_op.shape != (rows, t, e) or expr_slot.shape != (rows, t, e):
        raise ValueError("expr_op / expr_slot must be [R, T, E]")
    if term_valid.shape != (rows, t) or topo_ids.shape[0] != n:
        raise ValueError("term_valid must be [R, T] and topo_ids [N, TK]")
    if rows > MAX_GRID_Y:
        raise ValueError(f"{rows} table rows exceed the grid's {MAX_GRID_Y}")
    out = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    if n == 0 or rows == 0:
        return out.view(torch.bool)
    _launch(
        "match_terms", dev,
        _ptr(label_bits), n, lw, _ptr(topo_ids), tk, _ptr(expr_ids),
        _ptr(expr_op), _ptr(expr_slot), _ptr(term_valid), rows, t, e, k,
        _ptr(out),
    )
    return out.view(torch.bool)


def class_statics(cluster, pods, sel_mask, pref_mask, reps) -> Tuple[torch.Tensor, ...]:
    """(sfeas bool[C, N], aff f32[C, N], taint f32[C, N])."""
    dev = cluster.allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    node_valid = _arg(cluster.node_valid, b, dev, "node_valid")
    node_name = _arg(cluster.name_id, i32, dev, "name_id")
    taint_bits = _arg(cluster.taint_bits, i32, dev, "taint_bits")
    node_ports = _arg(cluster.port_bits, i32, dev, "port_bits")
    reps = _arg(reps, i32, dev, "reps")
    pod_valid = _arg(pods.valid, b, dev, "pods.valid")
    pod_name = _arg(pods.name_id, i32, dev, "pods.name_id")
    sel_idx = _arg(pods.sel_idx, i32, dev, "pods.sel_idx")
    tol_bits = _arg(pods.tol_bits, i32, dev, "pods.tol_bits")
    tol_all = _arg(pods.tol_all, b, dev, "pods.tol_all")
    pod_ports = _arg(pods.port_bits, i32, dev, "pods.port_bits")
    pref_idx = _arg(pods.pref_idx, i32, dev, "pods.pref_idx")
    pref_weight = _arg(pods.pref_weight, f32, dev, "pods.pref_weight")
    sel_mask = _arg(sel_mask, b, dev, "sel_mask")
    pref_mask = _arg(pref_mask, b, dev, "pref_mask")
    n = node_valid.shape[0]
    p = pod_valid.shape[0]
    c_dim = reps.shape[0]
    tw = taint_bits.shape[2]
    pw = node_ports.shape[1]
    mt = pref_idx.shape[1]
    if tol_bits.shape[2] != tw or pod_ports.shape[1] != pw:
        raise ValueError("pod and node bitset widths differ")
    if c_dim > MAX_GRID_Y:
        raise ValueError(f"{c_dim} classes exceed the grid's {MAX_GRID_Y}")
    sfeas = torch.empty((c_dim, n), dtype=torch.uint8, device=dev)
    aff = torch.empty((c_dim, n), dtype=f32, device=dev)
    taint = torch.empty((c_dim, n), dtype=f32, device=dev)
    if n and c_dim:
        _launch(
            "class_statics", dev,
            n, p, c_dim, tw, pw, mt, sel_mask.shape[0], pref_mask.shape[0],
            _ptr(node_valid), _ptr(node_name), _ptr(taint_bits),
            _ptr(node_ports), _ptr(reps), _ptr(pod_valid), _ptr(pod_name),
            _ptr(sel_idx), _ptr(tol_bits), _ptr(tol_all), _ptr(pod_ports),
            _ptr(pref_idx), _ptr(pref_weight), _ptr(sel_mask), _ptr(pref_mask),
            _ptr(sfeas), _ptr(aff), _ptr(taint),
        )
    return sfeas.view(torch.bool), aff, taint


def partials_eval(cluster, specs, slot_idx, col_idx, store) -> None:
    """Evaluate the partials store at (slot in slot_idx) x (column in
    col_idx, or every column when None) from the slots' stored specs,
    writing store.sfeas / aff / taint [G, N] in place (the caller hands in
    fresh store tensors)."""
    dev = cluster.allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    node_valid = _arg(cluster.node_valid, b, dev, "node_valid")
    node_name = _arg(cluster.name_id, i32, dev, "name_id")
    label_bits = _arg(cluster.label_bits, i32, dev, "label_bits")
    topo_ids = _arg(cluster.topo_ids, i32, dev, "topo_ids")
    taint_bits = _arg(cluster.taint_bits, i32, dev, "taint_bits")
    node_ports = _arg(cluster.port_bits, i32, dev, "port_bits")
    sp = [
        _arg(specs.valid, b, dev, "specs.valid"),
        _arg(specs.name_id, i32, dev, "specs.name_id"),
        _arg(specs.has_sel, b, dev, "specs.has_sel"),
        _arg(specs.sel_ids, i32, dev, "specs.sel_ids"),
        _arg(specs.sel_op, i32, dev, "specs.sel_op"),
        _arg(specs.sel_slot, i32, dev, "specs.sel_slot"),
        _arg(specs.sel_tv, b, dev, "specs.sel_tv"),
        _arg(specs.tol_bits, i32, dev, "specs.tol_bits"),
        _arg(specs.tol_all, b, dev, "specs.tol_all"),
        _arg(specs.port_bits, i32, dev, "specs.port_bits"),
        _arg(specs.pref_ids, i32, dev, "specs.pref_ids"),
        _arg(specs.pref_op, i32, dev, "specs.pref_op"),
        _arg(specs.pref_slot, i32, dev, "specs.pref_slot"),
        _arg(specs.pref_valid, b, dev, "specs.pref_valid"),
        _arg(specs.pref_weight, f32, dev, "specs.pref_weight"),
    ]
    slot_idx = _arg(slot_idx, i32, dev, "slot_idx")
    n, lw = label_bits.shape
    tk = topo_ids.shape[1]
    tw = taint_bits.shape[2]
    pw = node_ports.shape[1]
    g, t, e, k = sp[3].shape
    mt = sp[10].shape[1]
    if (sp[7].shape != (3, g, tw) or sp[9].shape != (g, pw) or sp[10].shape != (g, mt, e, k)
            or sp[0].shape != (g,) or sp[6].shape != (g, t)):
        raise ValueError("partials specs do not match the cluster's widths")
    outs = []
    for t_, dtype, what in ((store.sfeas, b, "sfeas"), (store.aff, f32, "aff"),
                            (store.taint, f32, "taint")):
        if (t_.device != dev or t_.dtype != dtype or not t_.is_contiguous()
                or tuple(t_.shape) != (g, n)):
            raise ValueError(f"store.{what}: a contiguous {dtype} [{g}, {n}] tensor on {dev}")
        outs.append(t_.view(torch.uint8) if dtype == b else t_)
    if col_idx is None:
        n_cols, col_ptr = n, ctypes.c_void_p(None)
    else:
        col_idx = _arg(col_idx, i32, dev, "col_idx")
        n_cols, col_ptr = col_idx.shape[0], _ptr(col_idx)
    n_slots = slot_idx.shape[0]
    if n_slots > MAX_GRID_Y:
        raise ValueError(f"{n_slots} slots exceed the grid's {MAX_GRID_Y}")
    if n_slots == 0 or n_cols == 0:
        return
    _launch(
        "partials_eval", dev,
        n, lw, tk, tw, pw, g, t, e, k, mt, n_slots, n_cols,
        _ptr(node_valid), _ptr(node_name), _ptr(label_bits), _ptr(topo_ids),
        _ptr(taint_bits), _ptr(node_ports), *[_ptr(x) for x in sp],
        _ptr(slot_idx), col_ptr, *[_ptr(x) for x in outs],
    )


def mirror_rows(buf: torch.Tensor, n_leaves: int, max_units: int) -> None:
    """Scatter a packed row delta (ops/device.py pack_rows: descriptors,
    indices, rows) into the leaves its descriptors name, in one launch."""
    dev = buf.device
    buf = _arg(buf, torch.uint8, dev, "packed rows")
    if buf.numel() < n_leaves * LEAF_BYTES:
        raise ValueError("packed rows shorter than their descriptors")
    if n_leaves > MAX_GRID_Y:
        raise ValueError(f"{n_leaves} leaves exceed the grid's {MAX_GRID_Y}")
    if n_leaves == 0 or max_units == 0:
        return
    _launch("mirror_rows", dev, _ptr(buf), n_leaves, max_units)


def score_params(cfg, r: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iparams i32[IP_COUNT], fparams f32[FP_COUNT]) of a ScoreConfig, on
    `device`, in greedy_scan.cu's parameter-block layout."""
    from ..ops.scores import INTERP_EPSILON

    if cfg.fit_strategy not in _STRATEGY:
        raise ValueError(f"unknown fit strategy {cfg.fit_strategy!r}")
    fit, bal, shape = cfg.fit_resources, cfg.balanced_resources, cfg.rtcr_shape
    if len(fit) > MAX_FIT or len(bal) > MAX_FIT:
        raise ValueError(f"at most {MAX_FIT} fit / balanced resources")
    if not 2 <= len(shape) <= MAX_SHAPE:
        raise ValueError(f"rtcr_shape needs 2..{MAX_SHAPE} points")
    if any(not 0 <= idx < r for idx, _ in fit) or any(not 0 <= i < r for i in bal):
        raise ValueError("score resource index outside the resource axis")
    ip = [0] * IP_COUNT
    fp = [0.0] * FP_COUNT
    ip[0:4] = [_STRATEGY[cfg.fit_strategy], len(fit), len(bal), len(shape)]
    for j, (idx, w) in enumerate(fit):
        ip[4 + j] = idx
        fp[5 + j] = w
    for j, idx in enumerate(bal):
        ip[4 + MAX_FIT + j] = idx
    fp[0:5] = [cfg.fit_weight, cfg.balanced_weight, cfg.node_affinity_weight,
               cfg.taint_weight, INTERP_EPSILON]
    for j, (x, y) in enumerate(shape):
        fp[5 + MAX_FIT + j] = x
        fp[5 + MAX_FIT + MAX_SHAPE + j] = y
    fp[FP_COUNT - 1] = cfg.spread_weight
    return (
        torch.tensor(ip, dtype=torch.int32, device=device),
        torch.tensor(fp, dtype=torch.float32, device=device),
    )


def _spread_args(sp_args, features, dev, n: int, p: int, counts=None):
    """The spread family's checked launch arguments: ([on, soft_on, C, MC]
    + 9 pointers, the tensors they point into).  `counts` is the f32[C, N]
    carry the kernel reads (and updates, where it does); without the
    family, zeros and a placeholder pointer."""
    if not features.spread:
        pad = torch.zeros(1, dtype=torch.int32, device=dev)
        return [0, 0, 1, 1] + [_ptr(pad)] * 9, [pad]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    table, st = sp_args.table, sp_args.state
    keep = [
        _arg(table.pod_idx, i32, dev, "spread.pod_idx"),
        _arg(table.pod_matches, b, dev, "spread.pod_matches"),
        _arg(table.max_skew, f32, dev, "spread.max_skew"),
        _arg(table.min_domains, f32, dev, "spread.min_domains"),
        _arg(table.hard, b, dev, "spread.hard"),
        _arg(st.eligible, b, dev, "spread eligible"),
        _arg(st.v, i32, dev, "spread v"),
        _arg(st.sizes, f32, dev, "spread sizes"),
        counts,
    ]
    c_dim = keep[6].shape[0]
    mc = keep[0].shape[1]
    if not 1 <= mc <= MAX_MC:
        raise ValueError(f"the kernels take 1..{MAX_MC} spread constraints a pod, got {mc}")
    if (keep[0].shape[0] != p or keep[1].shape != (p, c_dim)
            or keep[5].shape != (c_dim, n) or counts.shape != (c_dim, n)
            or counts.dtype != f32 or not counts.is_contiguous() or counts.device != dev):
        raise ValueError("spread tables do not match the batch's pod and node axes")
    return [1, int(features.soft_spread), c_dim, mc] + [_ptr(t) for t in keep], keep


def _terms_args(tm_args, features, dev, n: int, p: int, bits=None, rows=None,
                extra=None, c_dim: int = 0):
    """The inter-pod family's checked launch arguments ([on, W, U, P, CW] +
    12 pointers) and the extra rows' pointer, and the tensors they point
    into.  `bits` is the (present, blocked, global_any) carry the kernel
    reads (and updates, where it does); `rows` the wavefront's (writes,
    reads) safety rows; `extra` the f32[C, N] rows or None.  Without the
    family, zeros and placeholder pointers."""
    i32, f32, b = torch.int32, torch.float32, torch.bool
    keep = []
    extra_ptr = ctypes.c_void_p(None)
    if extra is not None:
        extra = _arg(extra, f32, dev, "extra")
        if extra.shape != (c_dim, n):
            raise ValueError(f"extra rows {tuple(extra.shape)} are not [{c_dim}, {n}]")
        keep.append(extra)
        extra_ptr = _ptr(extra)
    if not features.interpod:
        pad = torch.zeros(1, dtype=i32, device=dev)
        return [0, 1, 1, p, 0] + [_ptr(pad)] * 12 + [extra_ptr], keep + [pad]
    st = tm_args.state
    tabs = [
        _arg(st.key_bits, i32, dev, "term key_bits"),
        _arg(st.slot_v, i32, dev, "term slot_v"),
        _arg(st.mi_slot_bits, i32, dev, "term mi_slot_bits"),
        _arg(st.anti_slot_bits, i32, dev, "term anti_slot_bits"),
        _arg(st.aff_bits, i32, dev, "term aff_bits"),
        _arg(st.anti_bits, i32, dev, "term anti_bits"),
        _arg(tm_args.table.self_match_all, b, dev, "terms.self_match_all"),
    ]
    for t, what in zip(bits, ("present", "blocked", "global_any")):
        if t.device != dev or t.dtype != i32 or not t.is_contiguous():
            raise ValueError(f"term {what}: the carry must be a contiguous {i32} tensor on {dev}")
    u, w = tabs[1].shape[0], bits[0].shape[1]
    if rows is None:
        rows = (bits[2], bits[2])  # placeholders: the wavefront alone reads them
        cw = 0
    else:
        rows = tuple(_arg(t, i32, dev, "wave term rows") for t in rows)
        cw = rows[0].shape[1]
    if not 1 <= w <= MAX_TW:
        raise ValueError(f"the kernels take 1..{MAX_TW} term words, got {w}")
    if (tabs[0].shape != (n, w) or tabs[1].shape != (u, n) or tabs[2].shape != (u, p, w)
            or tabs[3].shape != (u, p, w) or tabs[4].shape != (p, w)
            or tabs[5].shape != (p, w) or tabs[6].shape != (p,)
            or bits[1].shape != (n, w) or bits[2].shape != (w,)
            or (cw and (rows[0].shape != (p, cw) or rows[1].shape != (p, cw)))):
        raise ValueError("term tables do not match the batch's pod and node axes")
    ptrs = [_ptr(t) for t in tabs + list(bits) + list(rows)]
    return [1, w, u, p, cw] + ptrs + [extra_ptr], keep + tabs + list(bits) + list(rows)


def _slices_args(cluster, pods, features, dev, r: int):
    """The slice carve-out family's checked launch arguments ([on, require,
    S, D, RESOURCE_PODS] + 9 pointers: the node and pod tables and the grid
    scratch) and the tensors they point into; without the family, zeros
    and placeholder pointers."""
    from ..ops.schema import RESOURCE_PODS

    i32, b = torch.int32, torch.bool
    if not features.slices:
        pad = torch.zeros(1, dtype=i32, device=dev)
        return [0, 0, 1, 1, 0] + [_ptr(pad)] * 9, [pad]
    z, d = int(features.slice_z), int(features.slice_dim)
    if not 1 <= d <= MAX_SLICE_DIM or RESOURCE_PODS >= r:
        raise ValueError(f"slice extent {d} outside 1..{MAX_SLICE_DIM}, or no pods column")
    n = cluster.allocatable.shape[0]
    tabs = [
        _arg(cluster.node_valid, b, dev, "node_valid"),
        _arg(cluster.slice_id, i32, dev, "slice_id"),
        _arg(cluster.torus_coords, i32, dev, "torus_coords"),
        _arg(cluster.slice_dims, i32, dev, "slice_dims"),
        _arg(pods.pod_shape, i32, dev, "pods.pod_shape"),
    ]
    if (tabs[1].shape != (n,) or tabs[2].shape != (n, 4) or tabs[3].shape != (n, 3)
            or tabs[4].shape != (pods.req.shape[0], 3)):
        raise ValueError("slice tables do not match the batch's pod and node axes")
    scratch = [
        torch.empty(z * d ** 3, dtype=i32, device=dev),
        torch.empty(z * d ** 3, dtype=i32, device=dev),
        torch.empty(z * (d + 1) ** 3, dtype=i32, device=dev),
        torch.empty(z, dtype=i32, device=dev),
    ]
    keep = tabs + scratch
    return ([1, int(features.slice_require), z, d, RESOURCE_PODS]
            + [_ptr(t) for t in keep], keep)


def greedy_scan(cluster, pods, sfeas_c, aff_c, taint_c, order, features,
                n_groups: int, cfg, sp_args=None, tm_args=None, extra_c=None):
    """The whole greedy solve in one launch.  Returns (assignment,
    scores, feasible_counts, reasons, requested, nonzero_requested,
    port_bits, spread counts, inter-pod present, blocked and global_any
    bits; None for a family the batch does not use; then the carve-out
    carry gang_sl, gang_lo, gang_corner for a slice batch with gangs); the
    carry tensors are fresh copies."""
    from ..ops.assign import gang_carry

    dev = cluster.allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    alloc = _arg(cluster.allocatable, f32, dev, "allocatable")
    requested = _arg(cluster.requested, f32, dev, "requested").clone()
    nonzero = _arg(cluster.nonzero_requested, f32, dev, "nonzero_requested").clone()
    use_ports = bool(features.ports)
    ports = _arg(cluster.port_bits, i32, dev, "port_bits")
    if use_ports:
        ports = ports.clone()
    sfeas_c = _arg(sfeas_c, b, dev, "sfeas")
    aff_c = _arg(aff_c, f32, dev, "aff")
    taint_c = _arg(taint_c, f32, dev, "taint")
    order = _arg(order, i32, dev, "order")
    class_id = _arg(pods.class_id, i32, dev, "pods.class_id")
    pod_valid = _arg(pods.valid, b, dev, "pods.valid")
    group_id = _arg(pods.group_id, i32, dev, "pods.group_id")
    pod_req = _arg(pods.req, f32, dev, "pods.req")
    pod_nz = _arg(pods.nonzero_req, f32, dev, "pods.nonzero_req")
    pod_ports = _arg(pods.port_bits, i32, dev, "pods.port_bits")
    n, r = alloc.shape
    p = pod_req.shape[0]
    pw = ports.shape[1]
    if r > MAX_R or pw > MAX_PW:
        raise ValueError(
            f"greedy_scan takes at most {MAX_R} resources and {MAX_PW} port "
            f"words, got {r} and {pw}"
        )
    iparams, fparams = score_params(cfg, r, dev)
    counts = sp_args.state.counts_node.clone().contiguous() if features.spread else None
    sp, _keep = _spread_args(sp_args, features, dev, n, p, counts)
    bits = term_bits_copy(tm_args, features)
    tm, _keep_tm = _terms_args(tm_args, features, dev, n, p, bits, None, extra_c,
                               sfeas_c.shape[0])
    sl, _keep_sl = _slices_args(cluster, pods, features, dev, r)
    gang = gang_carry(features, n_groups, dev)
    null = ctypes.c_void_p(None)
    gang_ptrs = [_ptr(t) for t in gang] if gang is not None else [null] * 3
    assignment = torch.empty(p, dtype=i32, device=dev)
    scores = torch.empty(p, dtype=f32, device=dev)
    feas_counts = torch.empty(p, dtype=i32, device=dev)
    reasons = torch.empty(p, dtype=i32, device=dev)
    incomplete = torch.zeros(max(n_groups, 1), dtype=i32, device=dev)
    if p:
        _launch(
            "greedy_scan", dev,
            n, r, p, sfeas_c.shape[0], pw, int(use_ports), int(n_groups),
            _ptr(alloc), _ptr(requested), _ptr(nonzero), _ptr(ports),
            _ptr(sfeas_c), _ptr(aff_c), _ptr(taint_c), _ptr(order),
            _ptr(class_id), _ptr(pod_valid), _ptr(group_id), _ptr(pod_req),
            _ptr(pod_nz), _ptr(pod_ports), _ptr(iparams), _ptr(fparams), *sp, *tm, *sl,
            *gang_ptrs, _ptr(assignment), _ptr(scores), _ptr(feas_counts), _ptr(reasons),
            _ptr(incomplete),
        )
    return (assignment, scores, feas_counts, reasons, requested, nonzero,
            ports if use_ports else cluster.port_bits, counts, *(bits or (None,) * 3),
            *(gang or ()))


def slice_stats(cluster, pods, assignment, gang, features, n_groups: int) -> tuple:
    """(frag_score f32[], carveouts, contiguous_gangs, carveout_fallbacks
    i32[]) of the post-release cluster and assignment, in one call (two
    kernels: the per-slice grids, then the totals).  gang: the scan's
    final (gang_sl, gang_lo, gang_corner), or None."""
    from ..ops.schema import RESOURCE_PODS

    dev = assignment.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    z, d = int(features.slice_z), int(features.slice_dim)
    requested = _arg(cluster.requested, f32, dev, "requested")
    n, r = requested.shape
    if not 1 <= d <= MAX_SLICE_DIM or RESOURCE_PODS >= r or n < 1:
        raise ValueError(f"slice extent {d} outside 1..{MAX_SLICE_DIM}, or no pods column")
    tabs = [
        _arg(cluster.node_valid, b, dev, "node_valid"),
        _arg(cluster.slice_id, i32, dev, "slice_id"),
        _arg(cluster.torus_coords, i32, dev, "torus_coords"),
        _arg(cluster.slice_dims, i32, dev, "slice_dims"),
        requested,
        _arg(assignment, i32, dev, "assignment"),
        _arg(pods.valid, b, dev, "pods.valid"),
        _arg(pods.group_id, i32, dev, "pods.group_id"),
        _arg(pods.pod_shape, i32, dev, "pods.pod_shape"),
    ]
    p = tabs[5].shape[0]
    if gang is None:
        n_groups = 0
        pad = torch.zeros(1, dtype=i32, device=dev)
        gang = (pad, pad, pad)
    else:
        gang = (_arg(gang[0], i32, dev, "gang_sl"), _arg(gang[1], i32, dev, "gang_lo"),
                _arg(gang[2], b, dev, "gang_corner"))
        if gang[0].shape != (n_groups,) or gang[1].shape != (n_groups, 3):
            raise ValueError("the carve-out carry does not match n_groups")
    largest = torch.empty(z, dtype=i32, device=dev)
    free_count = torch.empty(z, dtype=i32, device=dev)
    flags = torch.empty(max(n_groups, 1), dtype=i32, device=dev)
    frag = torch.empty((), dtype=f32, device=dev)
    counters = torch.empty(3, dtype=i32, device=dev)
    _launch("slice_stats", dev, n, z, d, r, RESOURCE_PODS, p, int(n_groups),
            *(_ptr(t) for t in tabs), *(_ptr(t) for t in gang), _ptr(largest),
            _ptr(free_count), _ptr(flags), _ptr(frag), _ptr(counters))
    return frag, counters[0], counters[1], counters[2]


def evaluate_single_filter(cluster, pods, srow, features, sp_args=None, tm_args=None):
    """Stage 1 of kernel `evaluate_single`: pod 0's (feas bool[N], post-
    spread feasible set bool[N], carve-out bonus f32[N])."""
    dev = cluster.allocatable.device
    f32, b = torch.float32, torch.bool
    alloc = _arg(cluster.allocatable, f32, dev, "allocatable")
    requested = _arg(cluster.requested, f32, dev, "requested")
    srow = _arg(srow, b, dev, "static row")
    pod_req = _arg(pods.req[0], f32, dev, "pods.req[0]")
    n, r = alloc.shape
    p = pods.req.shape[0]
    if r > MAX_R or srow.shape != (n,):
        raise ValueError(f"evaluate_single takes at most {MAX_R} resources and one static row")
    sp, _keep = _spread_args(sp_args, features, dev, n, p,
                             sp_args.state.counts_node.contiguous() if features.spread else None)
    bits = term_bits_copy(tm_args, features)
    tm, _keep_tm = _terms_args(tm_args, features, dev, n, p, bits, None, None, 0)
    sl, _keep_sl = _slices_args(cluster, pods, features, dev, r)
    feas = torch.empty(n, dtype=b, device=dev)
    feas_sp = torch.empty(n, dtype=b, device=dev)
    bonus = torch.empty(n, dtype=f32, device=dev)
    null = ctypes.c_void_p(None)
    _launch("evaluate_single", dev, 0, n, r, p, _ptr(alloc), _ptr(requested), null,
            _ptr(srow), null, null, _ptr(pod_req), null, null, null, *sp, *tm, *sl,
            _ptr(feas.view(torch.uint8)), _ptr(feas_sp.view(torch.uint8)), _ptr(bonus), null)
    return feas, feas_sp, bonus


def evaluate_single_score(cluster, pods, feas, feas_sp, bonus, arow, trow, extra,
                          features, cfg, sp_args=None) -> torch.Tensor:
    """Stage 2 of kernel `evaluate_single`: pod 0's where(feas, score,
    -inf) f32[N], with the extra row (or None) normalised over feas."""
    dev = cluster.allocatable.device
    f32, b = torch.float32, torch.bool
    alloc = _arg(cluster.allocatable, f32, dev, "allocatable")
    requested = _arg(cluster.requested, f32, dev, "requested")
    nonzero = _arg(cluster.nonzero_requested, f32, dev, "nonzero_requested")
    n, r = alloc.shape
    p = pods.req.shape[0]
    rows = [_arg(feas, b, dev, "feas"), _arg(feas_sp, b, dev, "feas_sp"),
            _arg(bonus, f32, dev, "bonus"), _arg(arow, f32, dev, "aff row"),
            _arg(trow, f32, dev, "taint row")]
    if extra is not None:
        rows.append(_arg(extra, f32, dev, "extra row"))
    if any(t.shape != (n,) for t in rows):
        raise ValueError("evaluate_single's rows are not [N]")
    pod_req = _arg(pods.req[0], f32, dev, "pods.req[0]")
    pod_nz = _arg(pods.nonzero_req[0], f32, dev, "pods.nonzero_req[0]")
    iparams, fparams = score_params(cfg, r, dev)
    sp, _keep = _spread_args(sp_args, features, dev, n, p,
                             sp_args.state.counts_node.contiguous() if features.spread else None)
    tm, _keep_tm = _terms_args(None, features._replace(interpod=False), dev, n, p)
    null = ctypes.c_void_p(None)
    sl = [int(features.slices), 0, 1, 1, 0] + [null] * 9
    masked = torch.empty(n, dtype=f32, device=dev)
    _launch("evaluate_single", dev, 1, n, r, p, _ptr(alloc), _ptr(requested), _ptr(nonzero),
            null, _ptr(rows[3]), _ptr(rows[4]), _ptr(pod_req), _ptr(pod_nz), _ptr(iparams),
            _ptr(fparams), *sp, *tm[:-1], _ptr(rows[5]) if extra is not None else null, *sl,
            _ptr(rows[0]), _ptr(rows[1]), _ptr(rows[2]), _ptr(masked))
    return masked


def wavefront(cluster, pods, sfeas_c, aff_c, taint_c, members, features,
              n_groups: int, cfg, sp_args=None, tm_args=None, extra_c=None):
    """The whole wavefront solve in one call (two kernels a wave, then the
    gang release).  Returns (assignment, scores, feasible_counts, reasons,
    requested, nonzero_requested, port_bits, wave_count, wave_fallbacks,
    spread counts, inter-pod present, blocked and global_any bits; None for
    a family the batch does not use); the carry tensors are fresh
    copies."""

    dev = cluster.allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    alloc = _arg(cluster.allocatable, f32, dev, "allocatable")
    requested = _arg(cluster.requested, f32, dev, "requested").clone()
    nonzero = _arg(cluster.nonzero_requested, f32, dev, "nonzero_requested").clone()
    use_ports = bool(features.ports)
    ports = _arg(cluster.port_bits, i32, dev, "port_bits")
    if use_ports:
        ports = ports.clone()
    sfeas_c = _arg(sfeas_c, b, dev, "sfeas")
    aff_c = _arg(aff_c, f32, dev, "aff")
    taint_c = _arg(taint_c, f32, dev, "taint")
    members = _arg(members, i32, dev, "members")
    class_id = _arg(pods.class_id, i32, dev, "pods.class_id")
    pod_valid = _arg(pods.valid, b, dev, "pods.valid")
    group_id = _arg(pods.group_id, i32, dev, "pods.group_id")
    pod_req = _arg(pods.req, f32, dev, "pods.req")
    pod_nz = _arg(pods.nonzero_req, f32, dev, "pods.nonzero_req")
    pod_ports = _arg(pods.port_bits, i32, dev, "pods.port_bits")
    n, r = alloc.shape
    p = pod_req.shape[0]
    pw = ports.shape[1]
    w_rows, k_dim = members.shape
    if r > MAX_R or pw > MAX_PW or not 1 <= k_dim <= MAX_WAVE:
        raise ValueError(
            f"wavefront takes at most {MAX_R} resources, {MAX_PW} port words "
            f"and waves of 1..{MAX_WAVE}, got {r}, {pw} and {k_dim}"
        )
    iparams, fparams = score_params(cfg, r, dev)
    counts = sp_args.state.counts_node.clone().contiguous() if features.spread else None
    sp, _keep = _spread_args(sp_args, features, dev, n, p, counts)
    bits = term_bits_copy(tm_args, features)
    rows = wave_term_rows(tm_args.table) if features.interpod else None
    tm, _keep_tm = _terms_args(tm_args, features, dev, n, p, bits, rows, extra_c,
                               sfeas_c.shape[0])
    kk = min(k_dim + 1, n)
    masked = torch.empty((k_dim, n), dtype=f32, device=dev)
    topv = torch.empty((k_dim, kk), dtype=f32, device=dev)
    topi = torch.empty((k_dim, kk), dtype=i32, device=dev)
    found_k, reason_k, cnt_k = (torch.empty(k_dim, dtype=i32, device=dev) for _ in range(3))
    # pods in no wave keep the reference's scatter defaults
    assignment = torch.full((p,), -1, dtype=i32, device=dev)
    scores = torch.full((p,), float("-inf"), dtype=f32, device=dev)
    feas_counts = torch.zeros(p, dtype=i32, device=dev)
    reasons = torch.full((p,), -1, dtype=i32, device=dev)
    counters = torch.zeros(2, dtype=i32, device=dev)
    incomplete = torch.zeros(max(n_groups, 1), dtype=i32, device=dev)
    if p and n and w_rows:
        _launch(
            "wavefront", dev,
            n, r, p, sfeas_c.shape[0], pw, k_dim, w_rows, int(use_ports), int(n_groups),
            _ptr(members), _ptr(alloc), _ptr(requested), _ptr(nonzero), _ptr(ports),
            _ptr(sfeas_c), _ptr(aff_c), _ptr(taint_c), _ptr(class_id),
            _ptr(pod_valid), _ptr(group_id), _ptr(pod_req), _ptr(pod_nz),
            _ptr(pod_ports), _ptr(iparams), _ptr(fparams), *sp, *tm, _ptr(masked),
            _ptr(topv), _ptr(topi), _ptr(found_k), _ptr(reason_k), _ptr(cnt_k),
            _ptr(assignment), _ptr(scores), _ptr(feas_counts), _ptr(reasons),
            _ptr(counters), _ptr(incomplete),
        )
    return (assignment, scores, feas_counts, reasons, requested, nonzero,
            ports if use_ports else cluster.port_bits, counters[0], counters[1],
            counts, *(bits or (None,) * 3))


def auction_state(rnd: int, go: bool, device) -> torch.Tensor:
    """i32[3] round state the auction kernels share on the device:
    (rounds executed, continue flag, last round's progress)."""
    return torch.tensor([rnd, int(go), 0], dtype=torch.int32, device=device)


def auction_bids(cluster, pods, st, requested, nonzero, assigned, state,
                 tie_k: int, cfg, bufs, sp_counts=None, term_bits=None):
    """One bidding round at round state[0], if state[1] is set, into the
    buffers of `auction_buffers`, against the round's spread counts
    (st.features.spread) and term bits (st.features.interpod).  Returns
    (bid i32[P], val f32[P], (inv_c, cnt_c, best_c)), views of those
    buffers (left at "no bid" when the flag is down)."""
    args, _keep = _bids_args(cluster, pods, st, requested, nonzero, assigned,
                             state, tie_k, cfg, bufs, sp_counts, term_bits)
    _launch("auction_bids", requested.device, *args)
    return bufs["bid"], bufs["val"], (bufs["inv_c"], bufs["cnt_c"], bufs["best_c"])


def _scan_rows(p: int) -> int:
    """Rows of auction_accept's prefix-scan scratch: the block totals of
    every level above the P requests (ops.auction.prefix_sum's levels)."""
    from ..ops.auction import SCAN_BLOCK

    rows = 0
    while p > SCAN_BLOCK:
        p = -(-p // SCAN_BLOCK)
        rows += p
    return rows


def auction_buffers(cluster, pods, tie_k: int, sp_args=None,
                    tm_args=None) -> Dict[str, torch.Tensor]:
    """Scratch and outputs of the auction kernels, allocated once a
    batch (with sp_args, auction_spread's too; with tm_args,
    auction_interpod's group tables)."""
    dev = cluster.allocatable.device
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    c_dim = pods.class_rep.shape[0]
    grid = max(1, min(c_dim, BIDS_GRID))
    spread = {}
    if sp_args is not None:
        rows = sp_args.state.v.shape[0]
        spread = {
            "counts_it": torch.empty((rows, n), dtype=f32, device=dev),
            "adds": torch.empty((rows, sp_args.z), dtype=i32, device=dev),
            "minc": torch.empty(rows, dtype=f32, device=dev),
            "kept": torch.empty(p, dtype=u8, device=dev),
            "cand": torch.empty(p, dtype=u8, device=dev),
            "admit": torch.empty(p, dtype=u8, device=dev),
        }
    terms = {}
    if tm_args is not None:
        groups = tm_args.z * tm_args.table.valid.shape[0]
        terms = {
            "minpos": torch.empty(groups, dtype=i32, device=dev),
            "carrier": torch.empty(groups, dtype=u8, device=dev),
            "z_mi": torch.empty(groups, dtype=u8, device=dev),
            "z_an": torch.empty(groups, dtype=u8, device=dev),
            "release": torch.empty(p, dtype=u8, device=dev),
        }
    return {
        **spread,
        **terms,
        "grid": grid,
        "inv_c": torch.zeros((c_dim, tie_k), dtype=i32, device=dev),
        "cnt_c": torch.zeros(c_dim, dtype=i32, device=dev),
        "best_c": torch.empty(c_dim, dtype=f32, device=dev),
        "masked": torch.empty((grid, n), dtype=f32, device=dev),
        "slots": torch.empty((grid, n), dtype=i32, device=dev),
        "bid": torch.full((p,), n, dtype=i32, device=dev),
        "val": torch.full((p,), float("-inf"), dtype=f32, device=dev),
        "perm": torch.empty(p, dtype=i32, device=dev),
        "firstpos": torch.empty(p, dtype=i32, device=dev),
        "perm_idx": torch.empty(p, dtype=i32, device=dev),
        "prefix": torch.empty((p, r), dtype=f32, device=dev),
        "scan": torch.empty((max(1, _scan_rows(p)), r), dtype=f32, device=dev),
        "accept": torch.empty(p, dtype=torch.uint8, device=dev),
    }


def _bids_args(cluster, pods, st, requested, nonzero, assigned, state, tie_k,
               cfg, bufs, sp_counts=None, term_bits=None):
    """The checked ctypes arguments of one auction_bids launch, and the
    tensors they point into (kept alive by the caller)."""
    dev = requested.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    keep = [
        _arg(cluster.allocatable, f32, dev, "allocatable"),
        _arg(requested, f32, dev, "requested"),
        _arg(nonzero, f32, dev, "nonzero_requested"),
        _arg(st.sfeas_s, b, dev, "sfeas_s"),
        _arg(st.aff_s, f32, dev, "aff_s"),
        _arg(st.taint_s, f32, dev, "taint_s"),
        _arg(st.s_reps, i32, dev, "s_reps"),
        _arg(st.jspec, i32, dev, "jspec"),
        _arg(pods.req, f32, dev, "pods.req"),
        _arg(pods.nonzero_req, f32, dev, "pods.nonzero_req"),
        _arg(st.order, i32, dev, "order"),
        _arg(pods.class_id, i32, dev, "pods.class_id"),
        _arg(pods.valid, b, dev, "pods.valid"),
        _arg(assigned, i32, dev, "assigned"),
    ]
    for t, what in ((requested, "requested"), (nonzero, "nonzero_requested"),
                    (assigned, "assigned"), (state, "state")):
        if not t.is_contiguous():
            raise ValueError(f"{what}: rounds update it in place; it must be contiguous")
    n, r = keep[0].shape
    p = keep[8].shape[0]
    if r > MAX_R:
        raise ValueError(f"auction_bids takes at most {MAX_R} resources, got {r}")
    if not 1 <= tie_k <= n:
        raise ValueError(f"tie_k {tie_k} outside 1..{n}")
    iparams, fparams = score_params(cfg, r, dev)
    keep += [iparams, fparams, _arg(state, i32, dev, "state")]
    k_reps = _arg(st.k_reps, i32, dev, "k_reps")
    jcons = _arg(st.jcons, i32, dev, "jcons")
    if jcons.shape != st.jspec.shape:
        raise ValueError("jcons and jspec must both be [C]")
    sp, sp_keep = _spread_args(st.sp, st.features, dev, n, p, sp_counts)
    tm, tm_keep = _terms_args(st.tm, st.features, dev, n, p, term_bits, None, st.extra,
                              st.jspec.shape[0])
    outs = [bufs[k] for k in ("inv_c", "cnt_c", "best_c", "masked", "slots", "bid", "val")]
    args = (n, r, p, st.jspec.shape[0], st.s_reps.shape[0], tie_k, bufs["grid"],
            *(_ptr(t) for t in keep), k_reps.shape[0], _ptr(k_reps), _ptr(jcons),
            *sp, *tm, *(_ptr(t) for t in outs))
    return args, keep + [k_reps, jcons] + sp_keep + tm_keep + outs


def _accept_args(allocatable, pods, order, bid, val, requested, nonzero,
                 assigned, bid_scores, state, max_rounds, bufs, stage=3):
    """The checked ctypes arguments of one auction_accept launch, and the
    tensors they point into."""
    dev = allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    for t, dt, what in ((requested, f32, "requested"), (nonzero, f32, "nonzero"),
                        (assigned, i32, "assigned"), (bid_scores, f32, "bid_scores"),
                        (state, i32, "state")):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: the kernel updates it in place; it must be a "
                             f"contiguous {dt} tensor on {dev}")
    keep = [
        _arg(allocatable, f32, dev, "allocatable"), requested, nonzero,
        _arg(pods.req, f32, dev, "pods.req"),
        _arg(pods.nonzero_req, f32, dev, "pods.nonzero_req"),
        _arg(pods.valid, b, dev, "pods.valid"),
        _arg(order, i32, dev, "order"),
        _arg(bid, i32, dev, "bid"),
        _arg(val, f32, dev, "val"),
        assigned, bid_scores, state,
    ]
    n, r = keep[0].shape
    p = keep[3].shape[0]
    if r > MAX_R:
        raise ValueError(f"auction_accept takes at most {MAX_R} resources, got {r}")
    keep += [bufs[k] for k in ("perm", "firstpos", "perm_idx", "prefix", "scan", "accept")]
    return (n, r, p, int(max_rounds), int(stage), *(_ptr(t) for t in keep)), keep


def auction_accept(allocatable, pods, order, bid, val, requested, nonzero,
                   assigned, bid_scores, state, max_rounds: int, bufs,
                   stage: int = 3) -> None:
    """One round's acceptance and commit (stage 3), or its acceptance into
    bufs["accept"] (stage 1) or its commit of bufs["accept"] (stage 2), in
    place on (requested, nonzero, assigned, bid_scores, state), if
    state[1] is set, with the scratch of `auction_buffers`."""
    dev = allocatable.device
    args, _keep = _accept_args(allocatable, pods, order, bid, val, requested,
                               nonzero, assigned, bid_scores, state, max_rounds,
                               bufs, stage)
    _launch("auction_accept", dev, *args)


def auction_release(allocatable, pods, assigned, dropped, requested, nonzero) -> None:
    """The gang post-pass's subtraction, in place on (requested, nonzero):
    each node takes off its dropped pods' requests in pod index order
    (kernel auction_accept's release entry point)."""
    dev = allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    for t, what in ((requested, "requested"), (nonzero, "nonzero")):
        if t.device != dev or t.dtype != f32 or not t.is_contiguous():
            raise ValueError(f"{what}: updated in place; it must be a contiguous {f32} "
                             f"tensor on {dev}")
    keep = [_arg(assigned, i32, dev, "assigned"), _arg(dropped, b, dev, "dropped"),
            _arg(pods.req, f32, dev, "pods.req"), _arg(pods.nonzero_req, f32, dev,
                                                         "pods.nonzero_req")]
    n, r = requested.shape
    p = keep[0].shape[0]
    fn = build.library("auction_accept").auction_accept_release
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_I] * 3 + [_P] * 7
    with torch.cuda.device(dev):
        code = fn(n, r, p, *(_ptr(t) for t in keep), _ptr(requested), _ptr(nonzero),
                  _stream(dev))
    build.check("auction_accept", code)
    LAUNCHES["auction_accept"] += 1


def _spread_repair_args(cluster, pods, st, counts, state, bufs):
    """The checked ctypes arguments of one auction_spread launch, and the
    tensors they point into."""
    dev = cluster.allocatable.device
    i32 = torch.int32
    n = cluster.allocatable.shape[0]
    p = pods.req.shape[0]
    sp, keep = _spread_args(st.sp, st.features, dev, n, p, counts)
    keep += [_arg(st.order, i32, dev, "order"), bufs["bid"], state, bufs["accept"]]
    scratch = [bufs[k] for k in ("counts_it", "adds", "minc", "kept", "cand", "admit")]
    if scratch[0].shape != counts.shape:
        raise ValueError("auction_spread scratch does not match the counts")
    args = (n, p, int(st.sp.z), *sp[2:],
            *(_ptr(t) for t in keep[-4:]), *(_ptr(t) for t in scratch))
    return args, keep + scratch


def auction_spread(cluster, pods, st, counts, state, bufs) -> None:
    """One round's spread repair of bufs["accept"] (against bufs["bid"])
    and the commit of the kept pods into `counts`, in place, if state[1]
    is set."""
    args, _keep = _spread_repair_args(cluster, pods, st, counts, state, bufs)
    _launch("auction_spread", cluster.allocatable.device, *args)


def _interpod_repair_args(cluster, pods, st, bits, state, bufs):
    """The checked ctypes arguments of one auction_interpod launch, and the
    tensors they point into."""
    dev = cluster.allocatable.device
    i32, b = torch.int32, torch.bool
    n, tk = cluster.topo_ids.shape
    p = pods.req.shape[0]
    table = st.tm.table
    t_dim = table.valid.shape[0]
    keep = [
        _arg(cluster.topo_ids, i32, dev, "topo_ids"), _arg(table.slot, i32, dev, "terms.slot"),
        bufs["bid"], _arg(st.mi_dense, b, dev, "mi_dense"),
        _arg(st.anti_dense, b, dev, "anti_dense"), _arg(st.solve_pos, i32, dev, "solve_pos"),
        state, bufs["accept"], *bits,
        *(bufs[k] for k in ("minpos", "carrier", "z_mi", "z_an", "release")),
    ]
    w = bits[0].shape[1]
    if (keep[3].shape != (p, t_dim) or keep[4].shape != (p, t_dim)
            or bits[0].shape != (n, w) or bits[2].shape != (w,)
            or bufs["minpos"].shape[0] != st.tm.z * t_dim):
        raise ValueError("auction_interpod tables do not match the batch's axes")
    return (n, p, t_dim, tk, int(st.tm.z), w, *(_ptr(t) for t in keep)), keep


def auction_interpod(cluster, pods, st, bits, state, bufs) -> None:
    """One round's anti-affinity repair of bufs["accept"] (against
    bufs["bid"]) and the commit of the kept pods into the (present,
    blocked, global_any) `bits`, in place, if state[1] is set."""
    args, _keep = _interpod_repair_args(cluster, pods, st, bits, state, bufs)
    _launch("auction_interpod", cluster.allocatable.device, *args)


def auction_rounds(cluster, pods, st, tie_k: int, cfg, max_rounds: int):
    """All rounds with no host sync: max_rounds rounds are enqueued, their
    arguments checked once — (bids, accept) pairs, or with a repair family
    (bids, accept stage 1, auction_spread and/or auction_interpod, accept
    stage 2); every launch after the loop's end returns at once on the
    device's flag.  Returns (assigned, bid_scores, requested, nonzero,
    rounds i32[], spread counts, inter-pod present, blocked and global_any
    bits; None for a family the batch does not use)."""
    dev = cluster.allocatable.device
    p = pods.req.shape[0]
    use_spread = bool(st.features.spread)
    use_terms = bool(st.features.interpod)
    requested = cluster.requested.clone().contiguous()
    nonzero = cluster.nonzero_requested.clone().contiguous()
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bid_scores = torch.full((p,), float("-inf"), dtype=torch.float32, device=dev)
    counts = st.sp.state.counts_node.clone().contiguous() if use_spread else None
    bits = term_bits_copy(st.tm, st.features)
    # the loop condition before round 0: max_rounds > 0 and a valid pod
    state = torch.zeros(3, dtype=torch.int32, device=dev)
    state[1] = pods.valid.any().to(torch.int32) * int(max_rounds > 0)
    bufs = auction_buffers(cluster, pods, tie_k, st.sp if use_spread else None,
                           st.tm if use_terms else None)
    bids, _k1 = _bids_args(cluster, pods, st, requested, nonzero, assigned,
                           state, tie_k, cfg, bufs, counts, bits)
    split = use_spread or use_terms
    accept_args = [
        _accept_args(cluster.allocatable, pods, st.order, bufs["bid"],
                     bufs["val"], requested, nonzero, assigned, bid_scores,
                     state, max_rounds, bufs, stage)
        for stage in ((1, 2) if split else (3,))
    ]
    if use_spread:
        spread_repair, _k3 = _spread_repair_args(cluster, pods, st, counts, state, bufs)
    if use_terms:
        term_repair, _k4 = _interpod_repair_args(cluster, pods, st, bits, state, bufs)
    for _ in range(max_rounds):
        _launch("auction_bids", dev, *bids)
        _launch("auction_accept", dev, *accept_args[0][0])
        if use_spread:
            _launch("auction_spread", dev, *spread_repair)
        if use_terms:
            _launch("auction_interpod", dev, *term_repair)
        if split:
            _launch("auction_accept", dev, *accept_args[1][0])
    return (assigned, bid_scores, requested, nonzero, state[0], counts,
            *(bits or (None,) * 3))


def class_extras(cluster, prefpod, images, features, cfg, reps, feas, pp) -> torch.Tensor:
    """f32[C, N]: each (reps[c], feas[c]) pair's already-weighted extra
    score row (preferred inter-pod affinity normalised over feas[c], plus
    ImageLocality), in one launch."""
    dev = cluster.allocatable.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    n = cluster.allocatable.shape[0]
    reps = _arg(reps, i32, dev, "reps")
    feas = _arg(feas, b, dev, "feas")
    c_dim = reps.shape[0]
    p = images.pod_ids.shape[0]
    if feas.shape != (c_dim, n):
        raise ValueError(f"feasible rows {tuple(feas.shape)} are not [{c_dim}, {n}]")
    pref_on, img_on = bool(features.interpod_pref), bool(features.images)
    pad = torch.zeros(1, dtype=i32, device=dev)
    if pref_on:
        pref = [_arg(pp.counts_dom, f32, dev, "counts_dom"),
                _arg(pp.ownerw_dom, f32, dev, "ownerw_dom"),
                _arg(prefpod.pod_idx, i32, dev, "prefpod.pod_idx"),
                _arg(prefpod.pod_weight, f32, dev, "prefpod.pod_weight"),
                _arg(prefpod.matches_incoming, b, dev, "prefpod.matches_incoming")]
        u_dim, ma = pref[0].shape[0], pref[2].shape[1]
        if (pref[0].shape != (u_dim, n) or pref[1].shape != (u_dim, n)
                or pref[3].shape != (p, ma) or pref[4].shape != (p, u_dim)):
            raise ValueError("preferred inter-pod tables do not match the batch's axes")
    else:
        pref, u_dim, ma = [pad] * 5, 0, 0
    if img_on:
        img = [_arg(cluster.image_bits, i32, dev, "image_bits"),
               _arg(cluster.node_valid, b, dev, "node_valid"),
               _arg(images.sizes, f32, dev, "images.sizes"),
               _arg(images.pod_ids, i32, dev, "images.pod_ids"),
               _arg(images.n_containers, f32, dev, "images.n_containers")]
        iw, i_dim, mi = img[0].shape[1], img[2].shape[0], img[3].shape[1]
        if mi > MAX_MI or img[0].shape[0] != n or img[4].shape != (p,):
            raise ValueError(f"image tables do not match the batch's axes (at most {MAX_MI} "
                             "images a pod)")
    else:
        img, iw, i_dim, mi = [pad] * 5, 0, 0, 0
    out = torch.empty((c_dim, n), dtype=f32, device=dev)
    if n and c_dim and p:
        _launch(
            "class_extras", dev,
            n, c_dim, p, max(1, min(c_dim, BIDS_GRID)), int(pref_on), int(img_on),
            float(cfg.interpod_weight), float(cfg.image_weight), _ptr(reps), _ptr(feas),
            u_dim, ma, *(_ptr(t) for t in pref), iw, i_dim, mi, *(_ptr(t) for t in img),
            _ptr(out),
        )
    return out


def batched_dry_run(free, victim_req, perm, elig_len, viol, pods_req, pod_level):
    """(feasible bool[P, N], min_k i32[P, N], viol_k i32[P, N]) of one
    PostFilter pass (kernel preempt_dry_run, its batched entry)."""
    dev = free.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    free = _arg(free, f32, dev, "free")
    victim_req = _arg(victim_req, f32, dev, "victim_req")
    perm = _arg(perm, i32, dev, "perm")
    elig_len = _arg(elig_len, i32, dev, "elig_len")
    viol = _arg(viol, b, dev, "viol")
    pods_req = _arg(pods_req, f32, dev, "pods_req")
    pod_level = _arg(pod_level, i32, dev, "pod_level")
    n, k, r = victim_req.shape
    l = perm.shape[0]
    p = pods_req.shape[0]
    if (free.shape != (n, r) or perm.shape != (l, n, k) or elig_len.shape != (l, n)
            or viol.shape != (l, n, k) or pods_req.shape != (p, r)
            or pod_level.shape != (p,)):
        raise ValueError("preemption batch tables do not match its axes "
                         "(free [N, R], victim_req [N, K, R], perm / viol [L, N, K], "
                         "elig_len [L, N], pods_req [P, R], pod_level [P])")
    if not 1 <= k <= MAX_VICTIM_SLOTS or r < 1 or l < 1:
        raise ValueError(f"victim slots {k} outside [1, {MAX_VICTIM_SLOTS}], or no "
                         f"resources ({r}) or levels ({l})")
    feasible = torch.empty((p, n), dtype=torch.uint8, device=dev)
    min_k = torch.empty((p, n), dtype=i32, device=dev)
    viol_k = torch.empty((p, n), dtype=i32, device=dev)
    if n and p:
        cum = torch.empty((l, n, k, r), dtype=f32, device=dev)
        cum_viol = torch.empty((l, n, k), dtype=i32, device=dev)
        bound = torch.empty((l, n), dtype=i32, device=dev)
        _launch("preempt_dry_run", dev, l, n, k, r, p,
                *(_ptr(t) for t in (free, victim_req, perm, elig_len, viol, pods_req,
                                    pod_level, cum, cum_viol, bound, feasible, min_k,
                                    viol_k)))
    return feasible.view(torch.bool), min_k, viol_k


def dry_run_victims(free, victim_req, victim_valid, pod_req):
    """(feasible bool[C], min_k i32[C]) of one pod over its C candidates
    (kernel preempt_dry_run, its dry_run_victims entry)."""
    dev = free.device
    i32, f32 = torch.int32, torch.float32
    free = _arg(free, f32, dev, "free")
    victim_req = _arg(victim_req, f32, dev, "victim_req")
    victim_valid = _arg(victim_valid, torch.bool, dev, "victim_valid")
    pod_req = _arg(pod_req, f32, dev, "pod_req")
    c, k, r = victim_req.shape
    if free.shape != (c, r) or victim_valid.shape != (c, k) or pod_req.shape != (r,):
        raise ValueError("dry-run tables do not match its axes (free [C, R], "
                         "victim_req [C, K, R], victim_valid [C, K], pod_req [R])")
    if not 1 <= k <= MAX_VICTIM_SLOTS or r < 1:
        raise ValueError(f"victim slots {k} outside [1, {MAX_VICTIM_SLOTS}], or no "
                         f"resources ({r})")
    feasible = torch.empty(c, dtype=torch.uint8, device=dev)
    min_k = torch.empty(c, dtype=i32, device=dev)
    if c:
        cum = torch.empty((c, k, r), dtype=f32, device=dev)
        cum_viol = torch.empty((c, k), dtype=i32, device=dev)
        bound = torch.empty(c, dtype=i32, device=dev)
        _launcher("preempt_dry_run")  # binds the library and checks its limits
        fn = build.library("preempt_dry_run").preempt_dry_run_victims_launch
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = _DRY_RUN_VICTIMS + [_P]
        with torch.cuda.device(dev):
            code = fn(c, k, r, *(_ptr(t) for t in (free, victim_req, victim_valid, pod_req,
                                                    cum, cum_viol, bound, feasible, min_k)),
                      _stream(dev))
        build.check("preempt_dry_run", code)
        LAUNCHES["preempt_dry_run"] += 1
    return feasible.view(torch.bool), min_k


def pod_filters(cluster, pods, sel_mask, full: bool) -> torch.Tensor:
    """bool[P, N]: per pod the static Filter slice, and with `full` the
    whole chain with resources and ports (kernel pod_filters)."""
    dev = cluster.node_valid.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    nodes = [_arg(cluster.node_valid, b, dev, "node_valid"),
             _arg(cluster.name_id, i32, dev, "name_id"),
             _arg(cluster.taint_bits, i32, dev, "taint_bits"),
             _arg(cluster.port_bits, i32, dev, "port_bits")]
    n = nodes[0].shape[0]
    tw, pw = nodes[2].shape[2], nodes[3].shape[1]
    spec = [_arg(pods.valid, b, dev, "pods.valid"),
            _arg(pods.name_id, i32, dev, "pods.name_id"),
            _arg(pods.sel_idx, i32, dev, "pods.sel_idx"),
            _arg(pods.tol_bits, i32, dev, "pods.tol_bits"),
            _arg(pods.tol_all, b, dev, "pods.tol_all"),
            _arg(pods.port_bits, i32, dev, "pods.port_bits")]
    p = spec[0].shape[0]
    sel_mask = _arg(sel_mask, b, dev, "sel_mask")
    if full:
        res = [_arg(cluster.requested, f32, dev, "requested"),
               _arg(cluster.allocatable, f32, dev, "allocatable")]
        req = _arg(pods.req, f32, dev, "pods.req")
        r = res[0].shape[1]
        if res[1].shape != (n, r) or req.shape != (p, r):
            raise ValueError("requested / allocatable [N, R] and pods.req [P, R] disagree")
    else:
        pad = torch.zeros(1, dtype=f32, device=dev)
        res, req, r = [pad, pad], pad, 0
    if (nodes[2].shape[:2] != (3, n) or spec[3].shape != (3, p, tw)
            or spec[4].shape != (3, p) or spec[5].shape != (p, pw)):
        raise ValueError("taint / toleration / port words do not match the axes")
    s_rows = sel_mask.shape[0]
    if sel_mask.shape[1:] != (n,) or s_rows < 1:
        raise ValueError(f"selector mask {tuple(sel_mask.shape)} is not [S >= 1, {n}]")
    if p > MAX_GRID_Y:
        raise ValueError(f"{p} pods exceed the grid's {MAX_GRID_Y}")
    out = torch.empty((p, n), dtype=torch.uint8, device=dev)
    if n and p:
        _launch("pod_filters", dev, n, p, tw, pw, r, s_rows, int(full),
                *(_ptr(t) for t in nodes + res + spec + [req, sel_mask, out]))
    return out.view(torch.bool)
