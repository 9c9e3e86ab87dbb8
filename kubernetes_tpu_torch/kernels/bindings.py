"""ctypes bindings of the three CUDA kernels, with their launch counters.

Each function takes tensors on one CUDA device, checks their dtypes,
allocates the outputs with torch, launches the kernel on torch's current
stream, raises if the launch returned a CUDA error, and adds one to
`LAUNCHES[name]` for every kernel launch.  Nothing here synchronises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int

_ARGTYPES = {
    "match_terms": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "class_statics": [_I] * 8 + [_P] * 19,
    "greedy_scan": [_I] * 7 + [_P] * 22,
}

# greedy_scan.cu's static capacities and parameter-block layout
MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE = 32, 256, 8, 16
IP_COUNT = 4 + 2 * MAX_FIT
FP_COUNT = 5 + MAX_FIT + 2 * MAX_SHAPE
_STRATEGY = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_GRID_Y = 65535


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
            got = tuple(limits(i) for i in range(6))
            want = (MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE, IP_COUNT, FP_COUNT)
            if got != want:
                raise RuntimeError(f"greedy_scan limits {got} != bindings {want}")
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
    return (
        torch.tensor(ip, dtype=torch.int32, device=device),
        torch.tensor(fp, dtype=torch.float32, device=device),
    )


def greedy_scan(cluster, pods, sfeas_c, aff_c, taint_c, order, features,
                n_groups: int, cfg):
    """The whole greedy solve in one launch.  Returns (assignment,
    scores, feasible_counts, reasons, requested, nonzero_requested,
    port_bits); the carry tensors are fresh copies."""
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
            _ptr(pod_nz), _ptr(pod_ports), _ptr(iparams), _ptr(fparams),
            _ptr(assignment), _ptr(scores), _ptr(feas_counts), _ptr(reasons),
            _ptr(incomplete),
        )
    return (assignment, scores, feas_counts, reasons, requested, nonzero,
            ports if use_ports else cluster.port_bits)
