"""ctypes bindings of the CUDA kernels, with their launch counters.

Each function takes tensors on one CUDA device, checks their dtypes,
allocates the outputs with torch, launches the kernel on torch's current
stream, raises if the launch returned a CUDA error, and adds one to
`LAUNCHES[name]` for every call of the kernel's C launch function.  A call
enqueues the kernel's work for one unit: one table (match_terms, the
masks-only entry), one batch (class_statics — the cold statics prep: the
rows the classes name, the class tables and the selector mask when asked
for —, class_extras, greedy_scan, wavefront and
auction_loop — one thread-block cluster for the whole batch —,
slice_stats), one pod's evaluation (evaluate_single: filter
and score in one call for a pod without an extra row, else its filter and
its score, one call each, with class_extras between them), one
sync of the partials store (partials_eval: a fresh store from the old
one, the listed columns and slots evaluated, the rest copied), one packed
row delta (mirror_rows: every leaf it names, into fresh leaves), one stage of an auction round
(AuctionRun's stage methods: auction_loop's kernel launched for one stage,
counted under the stage's own name — auction_bids, auction_accept for
the acceptance, the commit or both, auction_spread, auction_interpod,
auction_reasons, auction_gang).  Nothing here synchronises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..ops.assign import term_bits_copy, wave_term_rows
from . import build

# the auction program's stage entry points: auction_loop's kernel launched
# for one stage of a round (AuctionRun.bids, accept, spread, interpod), for
# the reasons pass alone (AuctionRun.reasons_stage) or for the gang
# post-pass alone (AuctionRun.gang_stage)
AUCTION_STAGES = ("auction_bids", "auction_accept", "auction_spread", "auction_interpod",
                  "auction_reasons", "auction_gang")

LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS + AUCTION_STAGES}

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
    # the cold statics prep: (ints array, pointer array, stream)
    "class_statics": [_P, _P, _P],
    "greedy_scan": [_I] * 7 + [_P] * 16 + _SPREAD + _TERMS + _SLICES + [_P] * 9,
    "slice_stats": [_I] * 7 + [_P] * 14,
    "evaluate_single": [_I] * 4 + [_P] * 10 + _SPREAD + _TERMS + _SLICES + [_P] * 5,
    "wavefront": [_I] * 9 + [_P] * 16 + _SPREAD + _TERMS + [_P] * 13,
    # the auction program: (stages, ints array, pointer array, stream)
    "auction_loop": [_I, _P, _P, _P],
    "class_extras": [_I] * 5 + [_F] * 2 + [_P] * 2 + [_I] * 2 + [_P] * 5 + [_I] * 3 + [_P] * 7,
    # one sync of the partials store: (ints array, pointer array, stream)
    "partials_eval": [_P, _P, _P],
    # the packed delta, its leaves, its blocks, the fresh leaves' allocation
    "mirror_rows": [_P, _I, _I, _P, _P],
    # the dry run and the Filter chain: (ints array, pointer array, stream)
    "preempt_dry_run": [_P, _P, _P],
    "pod_filters": [_P, _P, _P],
    # the family preps: (entry, ints array, pointer array, stream)
    "family_prep": [_I, _P, _P, _P],
}

# greedy_scan.cu's static capacities and parameter-block layout
MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE, MAX_MC, MAX_TW = 32, 256, 8, 16, 8, 32
MAX_CLUSTER = 16     # greedy_scan.cu's largest cluster (blocks)
IP_COUNT = 4 + 2 * MAX_FIT
FP_COUNT = 5 + MAX_FIT + 2 * MAX_SHAPE + 1
_STRATEGY = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_GRID_Y = 65535
MAX_WAVE = 32        # wavefront.cu's widest wave
MAX_MI = 16          # class_extras.cu's images a pod
MAX_SLICE_DIM = 16   # slices_common.cuh's widest slice extent
LEAF_BYTES = 64      # mirror_rows.cu's descriptor (ops/device.py LEAF_DTYPE)
MIRROR_BLOCK, MIRROR_CHUNK = 256, 16384   # its threads a block, bytes a block at most
MAX_VICTIM_SLOTS = 4096  # preempt_dry_run.cu's widest victim axis
DRY_RUN_CHUNK, DRY_RUN_POD_GROUP = 256, 32   # its slots a chunk, pods a group
SPREAD_SHARED_Z = 256    # the auction's spread value spaces counted in shared memory
# auction_common.cuh's stage flags (auction_loop_layout(3..10) checked on load)
STAGE = {"loop": 32, "bids": 4, "accept": 1, "commit": 2, "spread": 8, "interpod": 16,
         "reasons": 64, "gang": 128}


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
            got = tuple(limits(i) for i in range(9))
            want = (MAX_R, MAX_PW, MAX_FIT, MAX_SHAPE, IP_COUNT, FP_COUNT, MAX_MC, MAX_TW,
                    MAX_CLUSTER)
            if got != want:
                raise RuntimeError(f"greedy_scan limits {got} != bindings {want}")
        if name == "wavefront":
            max_k = getattr(lib, "wavefront_max_k")
            max_k.restype, max_k.argtypes = ctypes.c_int, []
            if max_k() != MAX_WAVE:
                raise RuntimeError(f"wavefront max K {max_k()} != bindings {MAX_WAVE}")
        if name == "mirror_rows":
            layout = getattr(lib, "mirror_rows_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(3))
            if got != (LEAF_BYTES, MIRROR_BLOCK, MIRROR_CHUNK):
                raise RuntimeError(f"mirror_rows layout {got} != bindings "
                                   f"{(LEAF_BYTES, MIRROR_BLOCK, MIRROR_CHUNK)}")
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
            layout = getattr(lib, "preempt_dry_run_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(5))
            want = (len(DRY_RUN_INTS), len(DRY_RUN_PTRS), MAX_VICTIM_SLOTS, DRY_RUN_CHUNK,
                    DRY_RUN_POD_GROUP)
            if got != want:
                raise RuntimeError(f"preempt_dry_run layout {got} != bindings {want}")
        if name == "pod_filters":
            layout = getattr(lib, "pod_filters_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(5))
            want = (len(FILTERS_INTS), len(FILTERS_PTRS), STATICS_TILE, FILTERS_ROW_CHUNK,
                    FILTERS_POD_CHUNK)
            if got != want:
                raise RuntimeError(f"pod_filters layout {got} != bindings {want}")
        if name == "auction_loop":
            layout = getattr(lib, "auction_loop_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(11))
            want = (len(AUCTION_INTS), len(AUCTION_PTRS), SPREAD_SHARED_Z,
                    *(STAGE[k] for k in ("loop", "bids", "accept", "commit", "spread",
                                         "interpod", "reasons", "gang")))
            if got != want:
                raise RuntimeError(f"auction_loop layout {got} != bindings {want}")
        if name == "class_statics":
            layout = getattr(lib, "class_statics_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(5))
            want = (len(STATICS_INTS), len(STATICS_PTRS), STATICS_TILE, STATICS_ROW_CHUNK,
                    STATICS_CLASS_CHUNK)
            if got != want:
                raise RuntimeError(f"class_statics layout {got} != bindings {want}")
        if name == "partials_eval":
            layout = getattr(lib, "partials_eval_layout")
            layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
            got = tuple(layout(i) for i in range(6))
            want = (len(PARTIALS_INTS), len(PARTIALS_PTRS), STATICS_TILE, PARTIALS_COPY_COLS,
                    PARTIALS_SLOT_CHUNK, PARTIALS_MAX_SLOTS)
            if got != want:
                raise RuntimeError(f"partials_eval layout {got} != bindings {want}")
        if name == "family_prep":
            _check_family_layout(lib)
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
    """bool[R, N]: per row, OR over valid terms of the AND of expressions
    (the masks-only entry; the cold prep evaluates its rows inside
    class_statics)."""
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


# class_statics.cu's launch arguments: ints[k] and ptrs[k] in the order of
# its kI_* / kP_* enums (class_statics_layout gives the lengths, the tile,
# the row chunk and the class chunk, checked on load)
STATICS_INTS = ("n", "lw", "tk", "tw", "pw", "p", "c", "mt", "s", "st", "se", "sk", "f", "fe",
                "fk", "want_mask")
STATICS_PTRS = (
    "node_valid", "node_name", "label_bits", "topo_ids", "taint_bits", "node_ports",
    "sel_ids", "sel_op", "sel_slot", "sel_tv",
    "pref_ids", "pref_op", "pref_slot", "pref_valid",
    "reps", "pod_valid", "pod_name", "sel_idx", "tol_bits", "tol_all", "pod_ports",
    "pref_idx", "pref_weight",
    "sfeas", "aff", "taint", "sel_mask",
)
STATICS_TILE, STATICS_ROW_CHUNK, STATICS_CLASS_CHUNK = 32, 1024, 64

_I32, _F32, _U8 = torch.int32, torch.float32, torch.uint8


def _checked(dev: torch.device, specs, keep: list) -> list:
    """The data pointers of (tensor, dtype, what) triples, each checked
    once: on `dev`, of `dtype` (bool as its uint8 storage); a tensor that
    is not contiguous is copied (the copy kept in `keep` until the
    launch is enqueued)."""
    index = dev.index if dev.type == "cuda" else -1
    ptrs = []
    for t, dtype, what in specs:
        if t.get_device() != index:
            raise ValueError(f"{what}: tensor on {t.device}, kernel runs on {dev}")
        if t.dtype is not dtype:
            raise TypeError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        ptrs.append(t.data_ptr())
    return ptrs


def class_statics(cluster, pods, sel, pref, reps,
                  want_sel_mask: bool = False) -> Tuple[torch.Tensor, ...]:
    """The cold statics prep in one launch: (sfeas bool[C, N], aff
    f32[C, N], taint f32[C, N], the selector mask bool[S, N] or None)
    from the selector and preferred tables and the classes'
    representatives (reps, clipped to the pod axis by the kernel).  One
    allocation; the outputs are views of it."""
    dev = cluster.node_valid.device
    b = torch.bool
    n, lw = cluster.label_bits.shape
    tk = cluster.topo_ids.shape[1]
    tw = cluster.taint_bits.shape[2]
    pw = cluster.port_bits.shape[1]
    p = pods.valid.shape[0]
    c = reps.shape[0]
    mt = pods.pref_idx.shape[1]
    s_rows, st, se, sk = sel.expr_ids.shape
    f_rows, fe, fk = pref.expr_ids.shape
    if (cluster.topo_ids.shape[0] != n or cluster.taint_bits.shape[:2] != (3, n)
            or cluster.port_bits.shape[0] != n or cluster.node_valid.shape != (n,)
            or cluster.name_id.shape != (n,)):
        raise ValueError("node tables do not share the node axis")
    if (sel.expr_op.shape != (s_rows, st, se) or sel.expr_slot.shape != (s_rows, st, se)
            or sel.term_valid.shape != (s_rows, st) or pref.expr_op.shape != (f_rows, fe)
            or pref.expr_slot.shape != (f_rows, fe) or pref.valid.shape != (f_rows,)
            or s_rows < 1 or f_rows < 1):
        raise ValueError("selector [S, T, E, K] or preferred [F, E, K] tables malformed")
    if (pods.tol_bits.shape != (3, p, tw) or pods.port_bits.shape != (p, pw)
            or pods.tol_all.shape != (3, p) or pods.pref_idx.shape[0] != p
            or pods.pref_weight.shape != (p, mt)
            or pods.name_id.shape != (p,) or pods.sel_idx.shape != (p,)
            or reps.shape != (c,) or p < 1):
        raise ValueError("pod tables do not match the pod axis or the node bitset widths")
    # one buffer: aff, taint (f32), sfeas, then the mask (u8)
    cn = c * n
    mask_n = s_rows * n if want_sel_mask else 0
    buf = torch.empty(8 * cn + cn + mask_n, dtype=_U8, device=dev)
    aff, taint = buf[: 8 * cn].view(_F32).view(2, c, n).unbind(0)
    if want_sel_mask:
        sfeas, mask = buf[8 * cn :].split((cn, mask_n))
        sfeas, mask = sfeas.view(c, n), mask.view(s_rows, n)
    else:
        sfeas, mask = buf[8 * cn :].view(c, n), None
    keep = []
    ptrs = _checked(dev, (
        (cluster.node_valid, b, "node_valid"), (cluster.name_id, _I32, "name_id"),
        (cluster.label_bits, _I32, "label_bits"), (cluster.topo_ids, _I32, "topo_ids"),
        (cluster.taint_bits, _I32, "taint_bits"), (cluster.port_bits, _I32, "port_bits"),
        (sel.expr_ids, _I32, "sel.expr_ids"), (sel.expr_op, _I32, "sel.expr_op"),
        (sel.expr_slot, _I32, "sel.expr_slot"), (sel.term_valid, b, "sel.term_valid"),
        (pref.expr_ids, _I32, "pref.expr_ids"), (pref.expr_op, _I32, "pref.expr_op"),
        (pref.expr_slot, _I32, "pref.expr_slot"), (pref.valid, b, "pref.valid"),
        (reps, _I32, "reps"), (pods.valid, b, "pods.valid"),
        (pods.name_id, _I32, "pods.name_id"), (pods.sel_idx, _I32, "pods.sel_idx"),
        (pods.tol_bits, _I32, "pods.tol_bits"), (pods.tol_all, b, "pods.tol_all"),
        (pods.port_bits, _I32, "pods.port_bits"), (pods.pref_idx, _I32, "pods.pref_idx"),
        (pods.pref_weight, _F32, "pods.pref_weight"),
    ), keep)
    if n and (c or want_sel_mask):
        out = buf.data_ptr()
        ptrs += [out + 8 * cn, out, out + 4 * cn, out + 9 * cn if want_sel_mask else None]
        ints = (n, lw, tk, tw, pw, p, c, mt, s_rows, st, se, sk, f_rows, fe, fk,
                int(want_sel_mask))
        arr_i = (ctypes.c_int * len(STATICS_INTS))(*ints)
        arr_p = (ctypes.c_void_p * len(STATICS_PTRS))(*ptrs)
        with torch.cuda.device(dev):
            code = _launcher("class_statics")(arr_i, arr_p, _stream(dev))
        build.check("class_statics", code)
        LAUNCHES["class_statics"] += 1
    return (sfeas.view(b), aff, taint, mask.view(b) if mask is not None else None)


# partials_eval.cu's launch arguments: ints[k] and ptrs[k] in the order of
# its kI_* / kP_* enums (partials_eval_layout gives the lengths, the tile,
# a copy block's columns, the most slots a tile block and the most slots,
# checked on load)
PARTIALS_INTS = ("n", "lw", "tk", "tw", "pw", "g", "t", "e", "k", "mt", "old_n", "m", "d",
                 "vec")
PARTIALS_PTRS = (
    "node_valid", "node_name", "label_bits", "topo_ids", "taint_bits", "node_ports",
    "valid", "name_id", "has_sel", "sel_ids", "sel_op", "sel_slot", "sel_tv",
    "tol_bits", "tol_all", "port_bits",
    "pref_ids", "pref_op", "pref_slot", "pref_valid", "pref_weight",
    "old_sfeas", "old_aff", "old_taint", "slots", "cols",
    "sfeas", "aff", "taint",
)
PARTIALS_COPY_COLS, PARTIALS_SLOT_CHUNK, PARTIALS_MAX_SLOTS = 2048, 32, 1024


def partials_eval(cluster, specs, old, slots, cols):
    """One sync of the partials store in one launch: a fresh (sfeas
    bool[G, N], aff f32[G, N], taint f32[G, N]) — one allocation, the
    three views of it — with every slot evaluated at the columns `cols`
    and from the old store's width up, the slots `slots` at every column,
    every other entry copied from `old` (None: every entry evaluated).
    `slots` and `cols` are ascending, distinct int32 lists (or None)."""
    dev = cluster.node_valid.device
    b = torch.bool
    n, lw = cluster.label_bits.shape
    tk = cluster.topo_ids.shape[1]
    tw = cluster.taint_bits.shape[2]
    pw = cluster.port_bits.shape[1]
    g, t, e, k = specs.sel_ids.shape
    mt = specs.pref_ids.shape[1]
    if (cluster.topo_ids.shape[0] != n or cluster.taint_bits.shape[:2] != (3, n)
            or cluster.port_bits.shape[0] != n or cluster.node_valid.shape != (n,)
            or cluster.name_id.shape != (n,)):
        raise ValueError("node tables do not share the node axis")
    if (specs.tol_bits.shape != (3, g, tw) or specs.port_bits.shape != (g, pw)
            or specs.pref_ids.shape != (g, mt, e, k) or specs.valid.shape != (g,)
            or specs.sel_tv.shape != (g, t) or specs.tol_all.shape != (3, g) or mt < 1):
        raise ValueError("partials specs do not match the cluster's widths")
    if g > PARTIALS_MAX_SLOTS:
        raise ValueError(f"{g} slots exceed partials_eval's {PARTIALS_MAX_SLOTS}")
    old_n = 0 if old is None else old.aff.shape[1]
    if old is not None and any(tuple(x.shape) != (g, old_n) for x in old):
        raise ValueError("the old store's leaves do not share [G, N]")
    gn = g * n
    buf = torch.empty(9 * gn, dtype=_U8, device=dev)
    aff, taint = buf[: 8 * gn].view(_F32).view(2, g, n).unbind(0)
    sfeas = buf[8 * gn :].view(g, n)
    keep = []
    i32 = _I32
    none = torch.empty(0, dtype=i32, device=dev)
    slots = none if slots is None else slots
    cols = none if cols is None else cols
    old_t = (none.view(_U8), none.view(_F32), none.view(_F32)) if old is None else \
        (old.sfeas.view(_U8) if old.sfeas.dtype is b else old.sfeas, old.aff, old.taint)
    ptrs = _checked(dev, (
        (cluster.node_valid, b, "node_valid"), (cluster.name_id, i32, "name_id"),
        (cluster.label_bits, i32, "label_bits"), (cluster.topo_ids, i32, "topo_ids"),
        (cluster.taint_bits, i32, "taint_bits"), (cluster.port_bits, i32, "port_bits"),
        (specs.valid, b, "specs.valid"), (specs.name_id, i32, "specs.name_id"),
        (specs.has_sel, b, "specs.has_sel"), (specs.sel_ids, i32, "specs.sel_ids"),
        (specs.sel_op, i32, "specs.sel_op"), (specs.sel_slot, i32, "specs.sel_slot"),
        (specs.sel_tv, b, "specs.sel_tv"), (specs.tol_bits, i32, "specs.tol_bits"),
        (specs.tol_all, b, "specs.tol_all"), (specs.port_bits, i32, "specs.port_bits"),
        (specs.pref_ids, i32, "specs.pref_ids"), (specs.pref_op, i32, "specs.pref_op"),
        (specs.pref_slot, i32, "specs.pref_slot"), (specs.pref_valid, b, "specs.pref_valid"),
        (specs.pref_weight, _F32, "specs.pref_weight"),
        (old_t[0], _U8, "old.sfeas"), (old_t[1], _F32, "old.aff"),
        (old_t[2], _F32, "old.taint"), (slots, i32, "slots"), (cols, i32, "cols"),
    ), keep)
    out = buf.data_ptr()
    ptrs += [out + 8 * gn, out, out + 4 * gn]
    aligned = all(p % 16 == 0 for p in ptrs[-8:-5] + ptrs[-3:])   # old and new leaves
    vec = int(aligned and old_n % 16 == 0 and n % 16 == 0)
    m, d = slots.numel(), cols.numel()
    if m > g:
        raise ValueError(f"{m} missed slots of {g}")
    if n and g:
        ints = (n, lw, tk, tw, pw, g, t, e, k, mt, old_n, m, d, vec)
        arr_i = (ctypes.c_int * len(PARTIALS_INTS))(*ints)
        arr_p = (ctypes.c_void_p * len(PARTIALS_PTRS))(*ptrs)
        with torch.cuda.device(dev):
            code = _launcher("partials_eval")(arr_i, arr_p, _stream(dev))
        build.check("partials_eval", code)
        LAUNCHES["partials_eval"] += 1
    return sfeas.view(b), aff, taint


def mirror_rows(pack) -> list:
    """Apply a packed row delta (ops/device.py pack_rows: descriptors, the
    prefix table of blocks, indices, rows) in one launch: the fresh leaves,
    each the old leaf with its rows written, as views of one allocation."""
    buf = pack.buf
    dev = buf.device
    if buf.dtype != torch.uint8 or not buf.is_contiguous() or dev.type != "cuda":
        raise ValueError("packed rows: a contiguous uint8 tensor on the card")
    n_leaves = len(pack.layouts)
    if buf.numel() < n_leaves * LEAF_BYTES + 4 * (n_leaves + 1):
        raise ValueError("packed rows shorter than their descriptors")
    for src in pack.srcs:
        if src.device != dev or not src.is_contiguous():
            raise ValueError(f"mirror_rows: a leaf on {src.device} or not contiguous")
    out = torch.empty(max(pack.out_bytes, 256), dtype=torch.uint8, device=dev)
    fresh, bases = [], {}
    for src, lay in zip(pack.srcs, pack.layouts):
        base = bases.get(src.dtype)
        if base is None:
            base = bases[src.dtype] = out.view(src.dtype)
        fresh.append(base.as_strided(src.shape, src.stride(), lay.out_off // src.element_size()))
    if pack.blocks:
        _launch("mirror_rows", dev, _ptr(buf), n_leaves, pack.blocks, _ptr(out))
    return fresh


_PARAMS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def score_params(cfg, r: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iparams i32[IP_COUNT], fparams f32[FP_COUNT]) of a ScoreConfig, on
    `device`, in greedy_scan.cu's parameter-block layout; made (two copies
    to the card) once for each (cfg, r, device), read only by the kernels."""
    key = (cfg, r, device)
    if key not in _PARAMS:
        _PARAMS[key] = _score_params(cfg, r, device)
    return _PARAMS[key]


def _score_params(cfg, r: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
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


_PADS: Dict[torch.device, torch.Tensor] = {}


def _pad(dev: torch.device) -> torch.Tensor:
    """A zero i32[1] on `dev`, made once: the placeholder behind the
    pointers of a family the launch does not use (no kernel reads or
    writes it)."""
    if dev not in _PADS:
        _PADS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _PADS[dev]


def _spread_args(sp_args, features, dev, n: int, p: int, counts=None):
    """The spread family's checked launch arguments: ([on, soft_on, C, MC]
    + 9 pointers, the tensors they point into).  `counts` is the f32[C, N]
    carry the kernel reads (and updates, where it does); without the
    family, zeros and a placeholder pointer."""
    if not features.spread:
        pad = _pad(dev)
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
        pad = _pad(dev)
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
        pad = _pad(dev)
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


def _scan_query(name: str, *args: int) -> int:
    """An integer that greedy_scan's library computes (greedy_scan_NAME)."""
    fn = getattr(build.library("greedy_scan"), f"greedy_scan_{name}")
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * len(args)
    return int(fn(*(int(a) for a in args)))


def scan_shape(n: int) -> Tuple[int, int]:
    """(blocks, threads a block) of greedy_scan's thread-block cluster at n
    nodes: the kernel's own launch_shape."""
    return _scan_query("cluster_size", n), _scan_query("block_threads", n)


def scan_node_block(n: int, nd: int) -> int:
    """The block of greedy_scan's cluster at n nodes that owns node nd."""
    return _scan_query("node_block", n, nd)


def slice_stats(cluster, pods, assignment, gang, features, n_groups: int) -> tuple:
    """(frag_score f32[], carveouts, contiguous_gangs, carveout_fallbacks
    i32[]) of the post-release cluster and assignment, in one launch; the
    four are views of one allocation that also holds the launch's scratch
    (the gang flags and the grid: slice_stats_words).  gang: the scan's
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
        gang = (tabs[1],) * 3   # not read without gangs
    else:
        gang = (_arg(gang[0], i32, dev, "gang_sl"), _arg(gang[1], i32, dev, "gang_lo"),
                _arg(gang[2], b, dev, "gang_corner"))
        if gang[0].shape != (n_groups,) or gang[1].shape != (n_groups, 3):
            raise ValueError("the carve-out carry does not match n_groups")
    buf = torch.empty(_slice_stats_words(z, d, int(n_groups)), dtype=i32, device=dev)
    _launch("slice_stats", dev, n, z, d, r, RESOURCE_PODS, p, int(n_groups),
            *(_ptr(t) for t in tabs), *(_ptr(t) for t in gang), _ptr(buf))
    counters = buf[1:4]
    return buf[0].view(f32), counters[0], counters[1], counters[2]


@functools.lru_cache(maxsize=64)
def _slice_stats_words(z: int, d: int, n_groups: int) -> int:
    """int32 words of slice_stats' one allocation (its library's
    slice_stats_words: frag, the counters, the gang flags, the grid)."""
    _launcher("slice_stats")   # binds the library and checks its limits
    fn = build.library("slice_stats").slice_stats_words
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    return int(fn(z, d, n_groups))


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


def fused_single_stage() -> int:
    """The stage value of evaluate_single's fused launch (filter and score
    in one launch), or -1 when the loaded library has none."""
    fn = getattr(build.library("evaluate_single"), "evaluate_single_fused_stage", None)
    if fn is None:
        return -1
    fn.restype, fn.argtypes = ctypes.c_int, []
    return int(fn())


def evaluate_single_fused(cluster, pods, srow, arow, trow, features, cfg, sp_args=None,
                          tm_args=None):
    """Kernel `evaluate_single`'s filter and score stages in one launch, for
    a pod without an extra row: pod 0's (feas bool[N], post-spread
    feasible set bool[N], carve-out bonus f32[N], where(feas, score, -inf)
    f32[N])."""
    dev = cluster.allocatable.device
    f32, b = torch.float32, torch.bool
    alloc = _arg(cluster.allocatable, f32, dev, "allocatable")
    requested = _arg(cluster.requested, f32, dev, "requested")
    nonzero = _arg(cluster.nonzero_requested, f32, dev, "nonzero_requested")
    srow = _arg(srow, b, dev, "static row")
    rows = [_arg(arow, f32, dev, "aff row"), _arg(trow, f32, dev, "taint row")]
    pod_req = _arg(pods.req[0], f32, dev, "pods.req[0]")
    pod_nz = _arg(pods.nonzero_req[0], f32, dev, "pods.nonzero_req[0]")
    n, r = alloc.shape
    p = pods.req.shape[0]
    if r > MAX_R or srow.shape != (n,) or any(t.shape != (n,) for t in rows):
        raise ValueError(f"evaluate_single takes at most {MAX_R} resources and [N] rows")
    if features.interpod_pref or features.images:
        raise ValueError("evaluate_single's fused launch takes no extra row")
    stage = fused_single_stage()
    if stage < 0:
        raise RuntimeError("the evaluate_single library has no fused stage")
    iparams, fparams = score_params(cfg, r, dev)
    sp, _keep = _spread_args(sp_args, features, dev, n, p,
                             sp_args.state.counts_node.contiguous() if features.spread else None)
    bits = term_bits_copy(tm_args, features)
    tm, _keep_tm = _terms_args(tm_args, features, dev, n, p, bits, None, None, 0)
    sl, _keep_sl = _slices_args(cluster, pods, features, dev, r)
    feas = torch.empty(n, dtype=b, device=dev)
    feas_sp = torch.empty(n, dtype=b, device=dev)
    bonus = torch.empty(n, dtype=f32, device=dev)
    masked = torch.empty(n, dtype=f32, device=dev)
    _launch("evaluate_single", dev, stage, n, r, p, _ptr(alloc), _ptr(requested), _ptr(nonzero),
            _ptr(srow), _ptr(rows[0]), _ptr(rows[1]), _ptr(pod_req), _ptr(pod_nz),
            _ptr(iparams), _ptr(fparams), *sp, *tm, *sl,
            _ptr(feas.view(torch.uint8)), _ptr(feas_sp.view(torch.uint8)), _ptr(bonus),
            _ptr(masked))
    return feas, feas_sp, bonus, masked


def wavefront(cluster, pods, sfeas_c, aff_c, taint_c, members, features,
              n_groups: int, cfg, sp_args=None, tm_args=None, extra_c=None):
    """The whole wavefront solve in one launch (one thread-block cluster
    runs every wave and the gang release).  Returns (assignment, scores,
    feasible_counts, reasons, requested, nonzero_requested, port_bits,
    wave_count, wave_fallbacks, spread counts, inter-pod present, blocked
    and global_any bits; None for a family the batch does not use); the
    carry tensors are fresh copies."""

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
    # the members' wave-start rows and their fit and balanced scores
    masked = torch.empty((3, k_dim, n), dtype=f32, device=dev)
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


# the auction program's launch arguments: ints[k] and ptrs[k] in the order
# of csrc/auction_common.cuh's kI_* / kP_* enums (auction_loop_layout gives
# the lengths, checked on load)
AUCTION_INTS = (
    "n", "r", "p", "c_dim", "cs_dim", "cc_dim", "tie_k", "max_rounds",
    "sp_on", "sp_soft", "sp_c", "sp_mc", "sp_z",
    "tm_on", "tm_w", "tm_u", "tm_t", "tm_tk", "tm_z", "tm_ma",
    "n_groups",
)
AUCTION_PTRS = (
    "alloc", "requested", "nonzero", "sfeas_s", "aff_s", "taint_s", "s_reps", "jspec",
    "k_reps", "jcons", "pod_req", "pod_nz", "pod_valid", "order", "class_id", "group_id",
    "iparams", "fparams", "extra",
    "sp_pod_idx", "sp_pod_matches", "sp_max_skew", "sp_min_domains", "sp_hard",
    "sp_eligible", "sp_v", "sp_sizes", "sp_counts",
    "tm_key_bits", "tm_slot_v", "tm_mi_slot", "tm_anti_slot", "tm_aff_bits",
    "tm_anti_bits", "tm_self_match", "tm_present", "tm_blocked", "tm_global_any",
    "topo_ids", "slot_of_t", "tm_matches_in", "tm_anti_idx", "tm_valid", "solve_pos",
    "pair_inv", "live_terms",
    "assigned", "bid_scores", "state", "bid", "val", "inv_c", "cnt_c", "best_c",
    "masked", "slots", "cperm", "cfirst", "cseen", "perm", "perm_idx", "bfirst",
    "rtmp", "rcnt", "rbase", "prefix", "scan", "accept",
    "counts_it", "adds", "minc", "kept", "cand", "admit",
    "minpos", "carrier", "z_mi", "z_an", "release",
    "reason_c", "reasons",
    "gang_dropped", "gang_flags",
)
RADIX = 256            # auction_common.cuh's radix sort digits
SORT_TILE = 512        # its tile at the smallest launch_shape block


def _scan_rows(p: int) -> int:
    """Rows of the acceptance prefix's scratch: the block totals of every
    level above the P requests (ops.auction.prefix_sum's levels)."""
    from ..ops.auction import SCAN_BLOCK

    rows = 0
    while p > SCAN_BLOCK:
        p = -(-p // SCAN_BLOCK)
        rows += p
    return rows


def auction_buffers(cluster, pods, tie_k: int, sp_args=None, tm_args=None,
                    n_groups: int = 0) -> Dict[str, torch.Tensor]:
    """Scratch and outputs of the auction program, allocated once a batch
    (with sp_args, the spread repair's too; with tm_args, the inter-pod
    repair's group tables, pair flags and solve positions — room for all
    T terms; the launch writes them over its live terms —; with gangs,
    their flags —
    the gang stage's release sort reuses the bid sorts' buffers)."""
    dev = cluster.allocatable.device
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    n, r = cluster.allocatable.shape
    p = pods.req.shape[0]
    c_dim = pods.class_rep.shape[0]
    tiles = -(-p // SORT_TILE)
    out = {
        "bid": torch.full((p,), n, dtype=i32, device=dev),
        "val": torch.full((p,), float("-inf"), dtype=f32, device=dev),
        "inv_c": torch.zeros((c_dim, tie_k), dtype=i32, device=dev),
        "cnt_c": torch.zeros(c_dim, dtype=i32, device=dev),
        "best_c": torch.empty(c_dim, dtype=f32, device=dev),
        "masked": torch.empty(n, dtype=f32, device=dev),
        "slots": torch.empty(n, dtype=i32, device=dev),
        "cperm": torch.empty(p, dtype=i32, device=dev),
        "cfirst": torch.empty(c_dim + 1, dtype=i32, device=dev),
        "cseen": torch.full((c_dim + 1,), -1, dtype=i32, device=dev),
        "perm": torch.empty(p, dtype=i32, device=dev),
        "perm_idx": torch.empty(p, dtype=i32, device=dev),
        "bfirst": torch.empty(n + 1, dtype=i32, device=dev),
        "rtmp": torch.empty(2 * p, dtype=i32, device=dev),
        "rcnt": torch.empty(2 * tiles * RADIX, dtype=i32, device=dev),
        "rbase": torch.empty(2 * tiles * RADIX, dtype=i32, device=dev),
        "prefix": torch.empty((p, r), dtype=f32, device=dev),
        "scan": torch.empty((max(1, _scan_rows(p)), r), dtype=f32, device=dev),
        "accept": torch.zeros(p, dtype=u8, device=dev),
        "reason_c": torch.empty(c_dim, dtype=i32, device=dev),
        "reasons": torch.empty(p, dtype=i32, device=dev),
        "gang_dropped": torch.zeros(p, dtype=torch.bool, device=dev),
    }
    if n_groups > 0:
        # zero at every launch's entry: the gang stage clears what it set
        out["gang_flags"] = torch.zeros(n_groups, dtype=i32, device=dev)
    if sp_args is not None:
        rows = sp_args.state.v.shape[0]
        out.update({
            "counts_it": torch.empty((rows, n), dtype=f32, device=dev),
            "adds": torch.empty((rows, sp_args.z), dtype=i32, device=dev),
            "minc": torch.empty(rows, dtype=f32, device=dev),
            "kept": torch.empty(p, dtype=u8, device=dev),
            "cand": torch.empty(p, dtype=u8, device=dev),
            "admit": torch.empty(p, dtype=u8, device=dev),
        })
    if tm_args is not None:
        t_dim = tm_args.table.valid.shape[0]
        groups = tm_args.z * t_dim
        out.update({
            "minpos": torch.empty(groups, dtype=i32, device=dev),
            "carrier": torch.empty(groups, dtype=u8, device=dev),
            "z_mi": torch.empty(groups, dtype=u8, device=dev),
            "z_an": torch.empty(groups, dtype=u8, device=dev),
            "release": torch.empty(p, dtype=u8, device=dev),
            "solve_pos": torch.empty(p, dtype=i32, device=dev),
            "pair_inv": torch.empty((p, t_dim), dtype=u8, device=dev),
            "live_terms": torch.empty(1 + t_dim, dtype=i32, device=dev),
        })
    return out


class AuctionRun:
    """One auction batch on the card: the carries the rounds update in
    place (requested, nonzero, assigned, bid_scores, the spread counts,
    the term bits — fresh copies — and `state`, i32[3]: rounds executed,
    the continue flag, the last round's progress), the scratch of
    `auction_buffers` (`bufs`: the round's bids in bufs["bid"] /
    bufs["val"], its accepted set in bufs["accept"]) and the checked
    launch arguments, two host arrays made once.  `loop()` runs every
    round in one launch; `bids()`, `accept(stage)`, `spread()` and
    `interpod()` launch one stage of the same program at round state[0]
    (`load` sets the carries and the state first).  Every launch of a
    round's stage returns at once on the card when state[1] is down.  The
    loop's launch ends with the reasons pass on the final state, each
    pod's REASON_* into `reasons` (bufs["reasons"]), then, with
    n_groups > 0, the gang post-pass: incomplete gangs' placed members
    released from the carries, flagged in `gang_dropped`
    (bufs["gang_dropped"]).  `reasons_stage()` and `gang_stage()` launch
    those two alone.  Nothing here syncs."""

    def __init__(self, cluster, pods, st, tie_k: int, cfg, max_rounds: int = 64,
                 n_groups: int = 0):
        dev = cluster.allocatable.device
        self.device = dev
        i32, f32, b = torch.int32, torch.float32, torch.bool
        features = st.features
        n, r = cluster.allocatable.shape
        p = pods.req.shape[0]
        c_dim = st.jspec.shape[0]
        if r > MAX_R:
            raise ValueError(f"the auction takes at most {MAX_R} resources, got {r}")
        if not 1 <= tie_k <= n:
            raise ValueError(f"tie_k {tie_k} outside 1..{n}")
        if st.jcons.shape != st.jspec.shape or pods.class_rep.shape[0] != c_dim:
            raise ValueError("jcons, jspec and the class axis must all be [C]")
        if n_groups < 0:
            raise ValueError(f"n_groups {n_groups} < 0")
        group_id = _arg(pods.group_id, i32, dev, "pods.group_id")
        if group_id.shape != (p,):
            raise ValueError(f"pods.group_id {tuple(group_id.shape)} is not [{p}]")
        self.requested = _arg(cluster.requested, f32, dev, "requested").clone()
        self.nonzero = _arg(cluster.nonzero_requested, f32, dev, "nonzero_requested").clone()
        self.assigned = torch.full((p,), -1, dtype=i32, device=dev)
        self.bid_scores = torch.full((p,), float("-inf"), dtype=f32, device=dev)
        self.counts = (st.sp.state.counts_node.clone().contiguous() if features.spread
                       else None)
        self.bits = term_bits_copy(st.tm, features)
        # the loop condition before round 0: max_rounds > 0 and a valid pod
        self.state = torch.zeros(3, dtype=i32, device=dev)
        self.state[1] = pods.valid.any().to(i32) * int(max_rounds > 0)
        self.bufs = auction_buffers(cluster, pods, tie_k, st.sp if features.spread else None,
                                    st.tm if features.interpod else None, n_groups)
        self.reasons = self.bufs["reasons"]
        self.gang_dropped = self.bufs["gang_dropped"]
        iparams, fparams = score_params(cfg, r, dev)
        pad = _pad(dev)
        t = {
            "alloc": _arg(cluster.allocatable, f32, dev, "allocatable"),
            "requested": self.requested, "nonzero": self.nonzero,
            "sfeas_s": _arg(st.sfeas_s, b, dev, "sfeas_s"),
            "aff_s": _arg(st.aff_s, f32, dev, "aff_s"),
            "taint_s": _arg(st.taint_s, f32, dev, "taint_s"),
            "s_reps": _arg(st.s_reps, i32, dev, "s_reps"),
            "jspec": _arg(st.jspec, i32, dev, "jspec"),
            "k_reps": _arg(st.k_reps, i32, dev, "k_reps"),
            "jcons": _arg(st.jcons, i32, dev, "jcons"),
            "pod_req": _arg(pods.req, f32, dev, "pods.req"),
            "pod_nz": _arg(pods.nonzero_req, f32, dev, "pods.nonzero_req"),
            "pod_valid": _arg(pods.valid, b, dev, "pods.valid"),
            "order": _arg(st.order, i32, dev, "order"),
            "class_id": _arg(pods.class_id, i32, dev, "pods.class_id"),
            "group_id": group_id,
            "iparams": iparams, "fparams": fparams,
            "assigned": self.assigned, "bid_scores": self.bid_scores, "state": self.state,
            **self.bufs,
        }
        if t["sfeas_s"].shape != (st.s_reps.shape[0], n) or t["pod_req"].shape != (p, r):
            raise ValueError("auction tables do not match the batch's pod and node axes")
        sp, sp_keep = _spread_args(st.sp, features, dev, n, p, self.counts)
        t.update(zip(("sp_pod_idx", "sp_pod_matches", "sp_max_skew", "sp_min_domains",
                      "sp_hard", "sp_eligible", "sp_v", "sp_sizes", "sp_counts"),
                     sp_keep if features.spread else [pad] * 9))
        tm, tm_keep = _terms_args(st.tm, features, dev, n, p, self.bits, None, st.extra, c_dim)
        extra_ptr = tm[-1]
        ints = dict(n=n, r=r, p=p, c_dim=c_dim, cs_dim=st.s_reps.shape[0],
                    cc_dim=st.k_reps.shape[0], tie_k=int(tie_k), max_rounds=int(max_rounds),
                    sp_on=sp[0], sp_soft=sp[1], sp_c=sp[2],
                    sp_mc=sp[3], sp_z=int(st.sp.z) if features.spread else 1,
                    tm_on=tm[0], tm_w=tm[1], tm_u=tm[2], tm_t=1, tm_tk=1, tm_z=1, tm_ma=1,
                    n_groups=int(n_groups))
        term_names = ("tm_key_bits", "tm_slot_v", "tm_mi_slot", "tm_anti_slot", "tm_aff_bits",
                      "tm_anti_bits", "tm_self_match", "tm_present", "tm_blocked",
                      "tm_global_any")
        # the inter-pod repair's dense tables are written in the launch from
        # the term table's own words: the terms a pod matches, its anti
        # terms, the valid terms
        repair = ("topo_ids", "slot_of_t", "tm_matches_in", "tm_anti_idx", "tm_valid")
        if features.interpod:
            tabs = tm_keep[1:] if st.extra is not None else tm_keep
            t.update(zip(term_names, tabs[:10]))
            table = st.tm.table
            t_dim = table.valid.shape[0]
            t.update(zip(repair, (
                _arg(cluster.topo_ids, i32, dev, "topo_ids"),
                _arg(table.slot, i32, dev, "terms.slot"),
                _arg(table.matches_incoming, i32, dev, "terms.matches_incoming"),
                _arg(table.anti_idx, i32, dev, "terms.anti_idx"),
                _arg(table.valid, b, dev, "terms.valid"))))
            ma = t["tm_anti_idx"].shape[1] if t["tm_anti_idx"].dim() == 2 else 0
            if (t["tm_matches_in"].shape != (p, tm[1]) or t["tm_anti_idx"].shape != (p, ma)
                    or ma < 1 or t["tm_valid"].shape != (t_dim,)
                    or t["slot_of_t"].shape != (t_dim,) or tm[1] != -(-t_dim // 32)):
                raise ValueError("inter-pod repair tables do not match the batch's axes")
            ints.update(tm_t=t_dim, tm_tk=cluster.topo_ids.shape[1], tm_z=int(st.tm.z),
                        tm_ma=ma)
        else:
            t.update((k, pad) for k in term_names + repair)
        for k in ("counts_it", "adds", "minc", "kept", "cand", "admit", "minpos", "carrier",
                  "z_mi", "z_an", "release", "solve_pos", "pair_inv", "live_terms",
                  "gang_flags"):
            t.setdefault(k, pad)
        ptrs = [extra_ptr if k == "extra" else _ptr(t[k]) for k in AUCTION_PTRS]
        self.ints = (ctypes.c_int * len(AUCTION_INTS))(*(int(ints[k]) for k in AUCTION_INTS))
        self.ptrs = (ctypes.c_void_p * len(AUCTION_PTRS))(*(q.value for q in ptrs))
        self._keep = list(t.values()) + sp_keep + tm_keep

    def _run(self, name: str, stages: int) -> None:
        """One launch of auction_loop's kernel for `stages`, counted under
        `name`."""
        with torch.cuda.device(self.device):
            code = _launcher("auction_loop")(stages, self.ints, self.ptrs,
                                             _stream(self.device))
        build.check("auction_loop", code)
        LAUNCHES[name] += 1

    def loop(self) -> None:
        """Every round from state[0] until the flag falls, then the reasons
        pass on the final state, then the gang post-pass (a batch without
        gangs skips it on the card): one launch."""
        self._run("auction_loop", STAGE["loop"] | STAGE["reasons"] | STAGE["gang"])

    def reasons_stage(self) -> None:
        """The reasons pass alone on the carries (whatever the flag)."""
        self._run("auction_reasons", STAGE["reasons"])

    def gang_stage(self) -> None:
        """The gang post-pass alone on the carries and `reasons` (whatever
        the flag): gang_dropped, and the dropped pods released."""
        self._run("auction_gang", STAGE["gang"])

    def bids(self) -> None:
        """Round state[0]'s bids into bufs["bid"] / bufs["val"]."""
        self._run("auction_bids", STAGE["bids"])

    def accept(self, stage: int = 3) -> None:
        """The round's acceptance into bufs["accept"] (stage 1, progress
        into state[2]), its commit of bufs["accept"] and the state (stage
        2), or both (stage 3)."""
        if stage not in (1, 2, 3):
            raise ValueError(f"auction_accept stage {stage} not in 1, 2, 3")
        self._run("auction_accept", (STAGE["accept"] if stage & 1 else 0)
                  | (STAGE["commit"] if stage & 2 else 0))

    def spread(self) -> None:
        """The spread repair of bufs["accept"] and the kept pods' count
        commit."""
        self._run("auction_spread", STAGE["spread"])

    def interpod(self) -> None:
        """The anti-affinity repair of bufs["accept"] and the kept pods'
        term-bit commit."""
        self._run("auction_interpod", STAGE["interpod"])

    def load(self, rnd: int, requested, nonzero, assigned, bid_scores, counts=None,
             bits=None, go: bool = True, progress: int = 0) -> None:
        """Set the carries (copies of the given tensors) and the state."""
        self.requested.copy_(requested)
        self.nonzero.copy_(nonzero)
        self.assigned.copy_(assigned)
        self.bid_scores.copy_(bid_scores)
        if counts is not None:
            self.counts.copy_(counts)
        if bits is not None:
            for dst, src in zip(self.bits, bits):
                dst.copy_(src)
        self.state.copy_(torch.tensor([rnd, int(go), int(progress)], dtype=torch.int32))

    def result(self) -> tuple:
        """(assigned, bid_scores, requested, nonzero, rounds i32[], spread
        counts, inter-pod present, blocked and global_any bits; None for a
        family the batch does not use)."""
        return (self.assigned, self.bid_scores, self.requested, self.nonzero, self.state[0],
                self.counts, *(self.bits or (None,) * 3))


def auction_rounds(cluster, pods, st, tie_k: int, cfg, max_rounds: int):
    """Every round of the auction in one launch (kernel auction_loop: one
    thread-block cluster loops the rounds until the device's flag falls,
    then runs the reasons pass), its arguments checked once, with no host
    sync.  Returns (assigned, bid_scores, requested, nonzero, rounds i32[],
    spread counts, inter-pod present, blocked and global_any bits; None for
    a family the batch does not use)."""
    return auction_solve(cluster, pods, st, tie_k, cfg, max_rounds)[0]


def auction_solve(cluster, pods, st, tie_k: int, cfg, max_rounds: int, n_groups: int = 0):
    """auction_rounds' tuple, the reasons pass's i32[P] and gang_dropped
    bool[P], from the one launch of kernel auction_loop; with n_groups > 0
    the tuple's assigned, bid_scores, requested and nonzero and the
    reasons are after the gang post-pass."""
    run = AuctionRun(cluster, pods, st, tie_k, cfg, max_rounds, n_groups)
    run.loop()
    return run.result(), run.reasons, run.gang_dropped


def auction_reasons(cluster, pods, st, assigned, requested, nonzero, sp_counts=None,
                    term_bits=None) -> torch.Tensor:
    """The reasons pass alone (auction_loop's kernel, stage reasons) on the
    given final state: i32[P].  Its carries are copies; no host sync."""
    from ..ops.scores import DEFAULT_SCORE_CONFIG

    run = AuctionRun(cluster, pods, st, 1, DEFAULT_SCORE_CONFIG, 0)
    run.load(0, requested, nonzero, assigned, run.bid_scores, sp_counts, term_bits, go=False)
    run.reasons_stage()
    return run.reasons


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
            n, c_dim, p, int(pref_on), int(img_on),
            float(cfg.interpod_weight), float(cfg.image_weight), _ptr(reps), _ptr(feas),
            u_dim, ma, *(_ptr(t) for t in pref), iw, i_dim, mi, *(_ptr(t) for t in img),
            _ptr(out),
        )
    return out


def class_extras_shape(cluster, prefpod, images, features, reps) -> Tuple[int, int]:
    """(blocks a cluster, clusters) of class_extras' launch for these pairs
    on this card (the library's class_extras_shape)."""
    _launcher("class_extras")   # binds the library and checks its limits
    fn = build.library("class_extras").class_extras_shape
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 9
    pref_on, img_on = bool(features.interpod_pref), bool(features.images)
    dims = (int(cluster.allocatable.shape[0]), int(reps.shape[0]), int(img_on),
            int(cluster.image_bits.shape[1]) if img_on else 0,
            int(images.sizes.shape[0]) if img_on else 0, int(pref_on),
            int(prefpod.pod_idx.shape[1]) if pref_on else 0,
            int(prefpod.matches_incoming.shape[1]) if pref_on else 0)
    return fn(0, *dims), fn(1, *dims)


# ---- preemption: the dry run and the Filter chain ------------------------------

# preempt_dry_run.cu's and pod_filters.cu's launch arguments: ints[k] and
# ptrs[k] in the order of their kI_* / kP_* enums (the *_layout functions
# give the lengths and the chunks, checked on load)
DRY_RUN_INTS = ("l", "n", "k", "r", "p")
DRY_RUN_PTRS = ("free", "victim_req", "perm", "elig_len", "valid", "viol", "pods_req",
                "pod_level", "feasible", "min_k", "viol_k")
FILTERS_INTS = ("n", "lw", "tk", "tw", "pw", "r", "p", "s", "st", "se", "sk", "full")
FILTERS_PTRS = (
    "node_valid", "node_name", "label_bits", "topo_ids", "taint_bits", "node_ports",
    "requested", "allocatable", "sel_ids", "sel_op", "sel_slot", "sel_tv",
    "pod_valid", "pod_name", "sel_idx", "tol_bits", "tol_all", "pod_ports", "pod_req", "out",
)
FILTERS_ROW_CHUNK, FILTERS_POD_CHUNK = 1024, 64


def _enqueue(name: str, dev: torch.device, ints, ptrs) -> None:
    """One launch of a kernel with the (ints, pointers, stream) interface."""
    arr_i = (ctypes.c_int * len(ints))(*ints)
    arr_p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(dev):
        code = _launcher(name)(arr_i, arr_p, _stream(dev))
    build.check(name, code)
    LAUNCHES[name] += 1


def dry_run_lanes(l: int, n: int, k: int, r: int) -> int:
    """The lanes preempt_dry_run gives a (level, node) row in a launch of
    L x N rows of K slots and R resources on this card: 32, or 16, 8, 4
    when the rows outnumber the card's resident warps."""
    _launcher("preempt_dry_run")  # binds the library and checks its layout
    fn = build.library("preempt_dry_run").preempt_dry_run_lanes
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 4
    return fn(l, n, k, r)


def _dry_run_args(batch, keep: list) -> tuple:
    """(ints, input pointers, P, N) of the batched dry run, each table
    checked once."""
    free, victim_req, perm, elig_len, viol, pods_req, pod_level = batch
    dev = free.device
    n, k, r = victim_req.shape
    l = perm.shape[0]
    p = pods_req.shape[0]
    if (free.shape != (n, r) or perm.shape != (l, n, k) or elig_len.shape != (l, n)
            or viol.shape != (l, n, k) or pods_req.shape != (p, r)
            or pod_level.shape != (p,)):
        raise ValueError("preemption batch tables do not match its axes "
                         "(free [N, R], victim_req [N, K, R], perm / viol [L, N, K], "
                         "elig_len [L, N], pods_req [P, R], pod_level [P])")
    if not 1 <= k <= MAX_VICTIM_SLOTS or r < 1 or not 1 <= l <= MAX_GRID_Y:
        raise ValueError(f"victim slots {k} outside [1, {MAX_VICTIM_SLOTS}], or no "
                         f"resources ({r}), or levels ({l}) outside [1, {MAX_GRID_Y}]")
    f = _checked(dev, ((free, _F32, "free"), (victim_req, _F32, "victim_req"),
                       (perm, _I32, "perm"), (elig_len, _I32, "elig_len"),
                       (viol, torch.bool, "viol"), (pods_req, _F32, "pods_req"),
                       (pod_level, _I32, "pod_level")), keep)
    # free, victim_req, perm, elig_len, valid (none), viol, pods_req, pod_level
    return (l, n, k, r, p), [*f[:4], None, *f[4:]], p, n


def _filters_args(cluster, pods, sel, full: bool, keep: list) -> tuple:
    """(ints, pointers without the output, P, N) of pod_filters, each
    table checked once; the resource pointers null in static mode."""
    dev = cluster.node_valid.device
    b = torch.bool
    n, lw = cluster.label_bits.shape
    tk = cluster.topo_ids.shape[1]
    tw = cluster.taint_bits.shape[2]
    pw = cluster.port_bits.shape[1]
    p = pods.valid.shape[0]
    s_rows, st, se, sk = sel.expr_ids.shape
    if (cluster.topo_ids.shape[0] != n or cluster.taint_bits.shape[:2] != (3, n)
            or cluster.port_bits.shape[0] != n or cluster.node_valid.shape != (n,)
            or cluster.name_id.shape != (n,)):
        raise ValueError("node tables do not share the node axis")
    if (sel.expr_op.shape != (s_rows, st, se) or sel.expr_slot.shape != (s_rows, st, se)
            or sel.term_valid.shape != (s_rows, st) or s_rows < 1):
        raise ValueError("selector table not [S >= 1, T, E, K]")
    if (pods.tol_bits.shape != (3, p, tw) or pods.tol_all.shape != (3, p)
            or pods.port_bits.shape != (p, pw) or pods.name_id.shape != (p,)
            or pods.sel_idx.shape != (p,)):
        raise ValueError("pod tables do not match the pod axis or the node bitset widths")
    res = ()
    r = 0
    if full:
        r = cluster.allocatable.shape[1]
        if cluster.requested.shape != (n, r) or pods.req.shape != (p, r):
            raise ValueError("requested / allocatable [N, R] and pods.req [P, R] disagree")
        res = ((cluster.requested, _F32, "requested"),
               (cluster.allocatable, _F32, "allocatable"), (pods.req, _F32, "pods.req"))
    ptrs = _checked(dev, (
        (cluster.node_valid, b, "node_valid"), (cluster.name_id, _I32, "name_id"),
        (cluster.label_bits, _I32, "label_bits"), (cluster.topo_ids, _I32, "topo_ids"),
        (cluster.taint_bits, _I32, "taint_bits"), (cluster.port_bits, _I32, "port_bits"),
        (sel.expr_ids, _I32, "sel.expr_ids"), (sel.expr_op, _I32, "sel.expr_op"),
        (sel.expr_slot, _I32, "sel.expr_slot"), (sel.term_valid, b, "sel.term_valid"),
        (pods.valid, b, "pods.valid"), (pods.name_id, _I32, "pods.name_id"),
        (pods.sel_idx, _I32, "pods.sel_idx"), (pods.tol_bits, _I32, "pods.tol_bits"),
        (pods.tol_all, b, "pods.tol_all"), (pods.port_bits, _I32, "pods.port_bits"),
        *res), keep)
    rq, cap, req = ptrs[16:] if full else (None, None, None)
    ints = (n, lw, tk, tw, pw, r, p, s_rows, st, se, sk, int(full))
    return ints, [*ptrs[:6], rq, cap, *ptrs[6:16], req], p, n


def batched_dry_run(free, victim_req, perm, elig_len, viol, pods_req, pod_level):
    """(feasible bool[P, N], min_k i32[P, N], viol_k i32[P, N]) of one
    PostFilter pass (kernel preempt_dry_run, its batched entry): one
    launch, one allocation (the outputs views of it)."""
    keep = []
    batch = (free, victim_req, perm, elig_len, viol, pods_req, pod_level)
    ints, ptrs, p, n = _dry_run_args(batch, keep)
    dev = free.device
    buf = torch.empty(9 * p * n, dtype=_U8, device=dev)
    min_k, viol_k = buf[: 8 * p * n].view(_I32).view(2, p, n).unbind(0)
    feasible = buf[8 * p * n :].view(p, n)
    if n and p:
        out = buf.data_ptr()
        _enqueue("preempt_dry_run", dev, ints, ptrs + [out + 8 * p * n, out, out + 4 * p * n])
    return feasible.view(torch.bool), min_k, viol_k


def dry_run_victims(free, victim_req, victim_valid, pod_req):
    """(feasible bool[C], min_k i32[C]) of one pod over its C candidates
    (kernel preempt_dry_run, its victims entry: L = P = 1, the mask
    victim_valid): one launch, one allocation."""
    dev = free.device
    c, k, r = victim_req.shape
    if free.shape != (c, r) or victim_valid.shape != (c, k) or pod_req.shape != (r,):
        raise ValueError("dry-run tables do not match its axes (free [C, R], "
                         "victim_req [C, K, R], victim_valid [C, K], pod_req [R])")
    if not 1 <= k <= MAX_VICTIM_SLOTS or r < 1:
        raise ValueError(f"victim slots {k} outside [1, {MAX_VICTIM_SLOTS}], or no "
                         f"resources ({r})")
    keep = []
    f = _checked(dev, ((free, _F32, "free"), (victim_req, _F32, "victim_req"),
                       (victim_valid, torch.bool, "victim_valid"), (pod_req, _F32, "pod_req")),
                 keep)
    buf = torch.empty(5 * c, dtype=_U8, device=dev)
    min_k, feasible = buf[: 4 * c].view(_I32), buf[4 * c :]
    if c:
        out = buf.data_ptr()
        _enqueue("preempt_dry_run", dev, (1, c, k, r, 1),
                 [f[0], f[1], None, None, f[2], None, f[3], None, out + 4 * c, out, None])
    return feasible.view(torch.bool), min_k


def pod_filters(cluster, pods, sel, full: bool) -> torch.Tensor:
    """bool[P, N]: per pod the static Filter slice, and with `full` the
    whole chain with resources and ports (kernel pod_filters, the pods'
    selector rows of `sel` evaluated in the launch)."""
    keep = []
    ints, ptrs, p, n = _filters_args(cluster, pods, sel, full, keep)
    out = torch.empty((p, n), dtype=_U8, device=cluster.node_valid.device)
    if n and p:
        _enqueue("pod_filters", cluster.node_valid.device, ints, ptrs + [out.data_ptr()])
    return out.view(torch.bool)


def preemption_pass(batch, cluster, pods, sel) -> Tuple[torch.Tensor, ...]:
    """A PostFilter pass's device work in one call: (feasible bool[P, N],
    min_k i32[P, N], viol_k i32[P, N]) of the batched dry run and the
    static Filter slice bool[Ps, Ns] of the pass's snapshot; kernels
    preempt_dry_run and pod_filters enqueued back to back, the four
    outputs views of one allocation (one readback copies them together)."""
    keep = []
    d_ints, d_ptrs, p, n = _dry_run_args(tuple(batch), keep)
    f_ints, f_ptrs, ps, ns = _filters_args(cluster, pods, sel, False, keep)
    dev = batch[0].device
    if cluster.node_valid.device != dev:
        raise ValueError(f"the static snapshot is on {cluster.node_valid.device}, the "
                         f"batch on {dev}")
    pn = p * n
    buf = torch.empty(9 * pn + ps * ns, dtype=_U8, device=dev)
    min_k, viol_k = buf[: 8 * pn].view(_I32).view(2, p, n).unbind(0)
    feasible, static = buf[8 * pn :].split((pn, ps * ns))
    out = buf.data_ptr()
    if n and p:
        _enqueue("preempt_dry_run", dev, d_ints, d_ptrs + [out + 8 * pn, out, out + 4 * pn])
    if ns and ps:
        _enqueue("pod_filters", dev, f_ints, f_ptrs + [out + 9 * pn])
    return (feasible.view(p, n).view(torch.bool), min_k, viol_k,
            static.view(ps, ns).view(torch.bool))


# ---- the family preps (kernel family_prep) ----------------------------------

# family_prep.cu's entries and launch arguments: ints[k] and ptrs[k] in the
# order of its kF_* / kQ_* enums (family_prep_layout gives the lengths and
# the entries, checked on load); the terms entry's used slots follow the ints
FAMILY_ENTRIES = {"spread": 0, "terms": 1, "pref": 2}
FAMILY_INTS = ("n", "tk", "rows", "z", "has_bound", "p", "w", "ma", "ma_anti", "s", "u")
FAMILY_PTRS = (
    "topo_ids", "node_valid", "row_valid", "row_slot", "vals_a", "vals_b",
    "owner_sel", "owner_keys", "sel_mask",
    "matches_incoming", "aff_idx", "anti_idx",
    "scratch", "out",
)
MAX_USED_SLOTS = 32    # family_prep.cu's used topology slots
FAMILY_ALIGN = 16      # its outputs' byte offsets in their one allocation
FAMILY_MAX_ROWS = 16384   # its rows a launch (the valid-row list in shared memory)
# each entry's outputs in allocation order (family_prep.cu outputs_of)
FAMILY_OUTPUTS = {
    "spread": (("v", _I32), ("counts", _F32), ("sizes", _F32), ("eligible", torch.bool)),
    "terms": tuple((k, _I32) for k in ("present", "blocked", "key_bits", "global_any",
                                       "slot_v", "mi_slot", "anti_slot", "aff_bits",
                                       "anti_bits")),
    "pref": (("counts_dom", _F32), ("ownerw_dom", _F32)),
}
# the zero scratch of each (device, stream): 2 R z + R words at least
_FAMILY_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def family_layout(entry: str, n: int, rows: int, p: int = 0, w: int = 0, u: int = 0):
    """(((name, dtype, shape, byte offset), ...), bytes) of an entry's
    outputs in their one allocation: each offset a multiple of
    FAMILY_ALIGN, in FAMILY_OUTPUTS order (family_prep.cu out_offsets)."""
    shapes = {
        "spread": ((rows, n), (rows, n), (rows,), (rows, n)),
        "terms": ((n, w), (n, w), (n, w), (w,), (u, n), (u, p, w), (u, p, w), (p, w),
                  (p, w)),
        "pref": ((rows, n), (rows, n)),
    }[entry]
    out, at = [], 0
    for (name, dtype), shape in zip(FAMILY_OUTPUTS[entry], shapes):
        out.append((name, dtype, shape, at))
        size = 1 if dtype is torch.bool else 4
        for d in shape:
            size *= d
        at += -(-size // FAMILY_ALIGN) * FAMILY_ALIGN
    return tuple(out), at


def _family_outputs(entry: str, dev, dims: dict):
    """(allocation, {name: view}) of an entry's outputs: one allocation of
    int32 words, split at family_layout's offsets (each output's words,
    then its padding: one split, then a view an output)."""
    layout, total = _family_pieces(entry, dims["n"], dims["rows"], dims.get("p", 0),
                                   dims.get("w", 0), dims.get("u", 0))
    buf = torch.empty(total // 4, dtype=_I32, device=dev)
    parts = buf.split(layout[1])
    views = {}
    for k, (name, dtype, shape, size) in enumerate(layout[0]):
        part = parts[2 * k]
        if dtype is torch.bool:
            part = part.view(_U8)[:size].view(torch.bool)
        elif dtype is not _I32:
            part = part.view(dtype)
        views[name] = part.view(shape)
    return buf, views


@functools.lru_cache(maxsize=256)
def _family_pieces(entry: str, n: int, rows: int, p: int, w: int, u: int):
    """(((name, dtype, shape, elements), ...), the split's word counts —
    each output's, then its padding's —), and the allocation's bytes."""
    layout, total = family_layout(entry, n, rows, p, w, u)
    total = max(total, FAMILY_ALIGN)
    outs, pieces = [], []
    for k, (name, dtype, shape, off) in enumerate(layout):
        size = 1
        for d in shape:
            size *= d
        words = -(-size // 4) if dtype is torch.bool else size
        end = layout[k + 1][3] if k + 1 < len(layout) else total
        outs.append((name, dtype, shape, size))
        pieces += [words, (end - off) // 4 - words]
    return (tuple(outs), tuple(pieces)), total


def family_scratch(dev: torch.device, words: int = 0, stream=None):
    """The zero scratch of family_prep on `dev`'s current stream (or the
    torch stream `stream`): one buffer a (device, stream), zeroed when it
    is allocated and grown to a power of two of at least `words` int32
    words; every launch leaves it zero.  With words == 0, the buffer as it
    is (None before the first)."""
    stream = torch.cuda.current_stream(dev) if stream is None else stream
    key = (stream.device.index, stream.cuda_stream)
    buf = _FAMILY_SCRATCH.get(key)
    if words and (buf is None or buf.numel() < words):
        size = 1 << max(12, (words - 1).bit_length())
        buf = _FAMILY_SCRATCH[key] = torch.zeros(size, dtype=_I32, device=dev)
    return buf


def _check_family_layout(lib) -> None:
    """family_prep.cu's launch arrays, entries and output layout against
    these bindings': its counts, then each entry's output offsets at a
    probe shape (ragged sizes, so every alignment pad shows)."""
    layout = lib.family_prep_layout
    layout.restype, layout.argtypes = ctypes.c_int, [ctypes.c_int]
    got = tuple(layout(i) for i in range(11))
    want = (len(FAMILY_INTS), len(FAMILY_PTRS), MAX_USED_SLOTS,
            *(FAMILY_ENTRIES[k] for k in ("spread", "terms", "pref")), FAMILY_ALIGN,
            *(len(FAMILY_OUTPUTS[k]) for k in ("spread", "terms", "pref")), FAMILY_MAX_ROWS)
    if got != want:
        raise RuntimeError(f"family_prep layout {got} != bindings {want}")
    offset = lib.family_prep_offset
    offset.restype, offset.argtypes = ctypes.c_longlong, [ctypes.c_int, _P, ctypes.c_int]
    probe = dict(n=37, tk=3, rows=5, z=7, p=11, w=2, u=3)
    arr = (ctypes.c_int * len(FAMILY_INTS))(*(probe.get(k, 0) for k in FAMILY_INTS))
    for entry, code in FAMILY_ENTRIES.items():
        views, total = family_layout(entry, probe["n"], probe["rows"], probe["p"], probe["w"],
                                     probe["u"])
        mine = [off for _n, _d, _s, off in views] + [total]
        theirs = [offset(code, ctypes.cast(arr, _P), k) for k in range(len(mine))]
        if theirs != mine:
            raise RuntimeError(f"family_prep {entry} offsets {theirs} != bindings {mine}")


def _family_launch(entry: str, dev: torch.device, stream, ints: dict, ptrs: dict,
                   slots=()) -> None:
    """One launch of kernel family_prep's `entry` on the torch stream
    `stream`; pointers not named are null (the entry reads none of them)."""
    vals = [int(ints.get(k, 0)) for k in FAMILY_INTS] + [int(s) for s in slots]
    arr_i = (ctypes.c_int * len(vals))(*vals)
    arr_p = (ctypes.c_void_p * len(FAMILY_PTRS))(*(ptrs.get(k) for k in FAMILY_PTRS))
    with torch.cuda.device(dev):
        code = _launcher("family_prep")(FAMILY_ENTRIES[entry], arr_i, arr_p,
                                        ctypes.c_void_p(stream.cuda_stream))
    build.check("family_prep", code)
    LAUNCHES["family_prep"] += 1


def _family_common(cluster, valid, slot, what: str, keep: list):
    """The node and row tables every entry reads, checked once: (pointers,
    n, tk, rows)."""
    dev = cluster.node_valid.device
    n, tk = cluster.topo_ids.shape
    rows = valid.shape[0]
    if cluster.node_valid.shape != (n,) or tk < 1 or slot.shape != (rows,):
        raise ValueError(f"topo_ids [N, TK >= 1], node_valid [N] and {what}.slot [R] "
                         f"disagree")
    if rows > FAMILY_MAX_ROWS:
        raise ValueError(f"{what}: {rows} rows exceed family_prep's {FAMILY_MAX_ROWS}")
    topo, nv, rv, rs = _checked(dev, ((cluster.topo_ids, _I32, "topo_ids"),
                                      (cluster.node_valid, torch.bool, "node_valid"),
                                      (valid, torch.bool, f"{what}.valid"),
                                      (slot, _I32, f"{what}.slot")), keep)
    return dict(topo_ids=topo, node_valid=nv, row_valid=rv, row_slot=rs), n, tk, rows


def _family_vals(dev, n: int, rows: int, tables, what: str, keep: list) -> dict:
    """vals_a / vals_b: a family's per-node tables f32[R, N], checked."""
    if any(t.shape != (rows, n) for t in tables):
        raise ValueError(f"{what} node tables do not match the row and node axes")
    ptrs = _checked(dev, [(t, _F32, f"{what} node table") for t in tables], keep)
    return dict(zip(("vals_a", "vals_b"), ptrs))


def _family_ptrs(dev, entry: str, dims: dict, z: int, scatter: bool, ptrs: dict):
    """The outputs' allocation and the scratch (where the scatter runs)
    added to `ptrs`; returns (the views, torch's current stream)."""
    buf, views = _family_outputs(entry, dev, dims)
    ptrs["out"] = buf.data_ptr()
    stream = torch.cuda.current_stream(dev)
    if scatter:
        if z < 1:
            raise ValueError(f"value capacity {z} < 1")
        ptrs["scratch"] = family_scratch(dev, 2 * dims["rows"] * z + dims["rows"],
                                         stream).data_ptr()
    return views, stream


def family_prep_spread(cluster, sel_mask, spread, z: int, has_bound: bool):
    """prep_spread's SpreadState in one launch (kernel family_prep, entry
    spread), its outputs views of one allocation."""
    from ..ops.topology import SpreadState

    dev = cluster.node_valid.device
    keep = []
    ptrs, n, tk, rows = _family_common(cluster, spread.valid, spread.slot, "spread", keep)
    if (spread.owner_sel_idx.shape != (rows,) or spread.owner_keys.shape != (rows, tk)
            or sel_mask.shape[1:] != (n,)):
        raise ValueError("spread owner tables or the selector mask do not match the axes")
    ptrs.update(zip(("owner_sel", "owner_keys", "sel_mask"), _checked(dev, (
        (spread.owner_sel_idx, _I32, "spread.owner_sel_idx"),
        (spread.owner_keys, torch.bool, "spread.owner_keys"),
        (sel_mask, torch.bool, "sel_mask")), keep)))
    if has_bound:
        ptrs.update(_family_vals(dev, n, rows, (spread.node_matches,), "spread", keep))
    dims = dict(n=n, tk=tk, rows=rows, z=int(z), has_bound=int(has_bound), s=sel_mask.shape[0])
    out, stream = _family_ptrs(dev, "spread", dims, int(z), True, ptrs)
    _family_launch("spread", dev, stream, dims, ptrs)
    return SpreadState(out["counts"], out["eligible"], out["v"], out["sizes"])


def family_prep_terms(cluster, terms, z: int, slots, has_bound: bool):
    """prep_terms' TermState in one launch (kernel family_prep, entry
    terms), its outputs views of one allocation; `slots` the used topology
    slots (Python ints, passed in the launch's int array: no host-to-card
    copy)."""
    from ..ops.interpod import TermState

    dev = cluster.node_valid.device
    keep = []
    ptrs, n, tk, t_dim = _family_common(cluster, terms.valid, terms.slot, "terms", keep)
    w = (t_dim + 31) // 32
    p = terms.matches_incoming.shape[0]
    slots = tuple(int(s) for s in slots)
    if (t_dim < 1 or terms.matches_incoming.shape != (p, w) or terms.aff_idx.shape[0] != p
            or terms.anti_idx.shape[0] != p):
        raise ValueError("term tables do not match the term and pod axes")
    if not 1 <= len(slots) <= MAX_USED_SLOTS or any(not 0 <= s < tk for s in slots):
        raise ValueError(f"used slots {slots} outside 0..{tk - 1} or more than "
                         f"{MAX_USED_SLOTS}")
    ptrs.update(zip(("matches_incoming", "aff_idx", "anti_idx"), _checked(dev, (
        (terms.matches_incoming, _I32, "terms.matches_incoming"),
        (terms.aff_idx, _I32, "terms.aff_idx"), (terms.anti_idx, _I32, "terms.anti_idx")),
        keep)))
    if has_bound:
        ptrs.update(_family_vals(dev, n, t_dim, (terms.node_matches, terms.node_owners),
                                 "terms", keep))
    dims = dict(n=n, tk=tk, rows=t_dim, z=int(z), has_bound=int(has_bound), p=p, w=w,
                ma=terms.aff_idx.shape[1], ma_anti=terms.anti_idx.shape[1], u=len(slots))
    out, stream = _family_ptrs(dev, "terms", dims, int(z), has_bound, ptrs)
    _family_launch("terms", dev, stream, dims, ptrs, slots)
    return TermState(out["present"], out["blocked"], out["global_any"], out["key_bits"],
                     out["slot_v"], out["mi_slot"], out["anti_slot"], out["aff_bits"],
                     out["anti_bits"])


def family_prep_pref(cluster, table, z: int, has_bound: bool):
    """prep_pref_pod's PrefPodState in one launch (kernel family_prep,
    entry pref), its outputs views of one allocation."""
    from ..ops.interpod import PrefPodState

    dev = cluster.node_valid.device
    keep = []
    ptrs, n, tk, rows = _family_common(cluster, table.valid, table.slot, "prefpod", keep)
    if has_bound:
        ptrs.update(_family_vals(dev, n, rows, (table.node_counts, table.owner_weight),
                                 "prefpod", keep))
    dims = dict(n=n, tk=tk, rows=rows, z=int(z), has_bound=int(has_bound))
    out, stream = _family_ptrs(dev, "pref", dims, int(z), has_bound, ptrs)
    _family_launch("pref", dev, stream, dims, ptrs)
    return PrefPodState(out["counts_dom"], out["ownerw_dom"])
