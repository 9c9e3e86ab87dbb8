"""Build and load the CUDA kernels of csrc/.

Each source is compiled by its own `nvcc` process into a shared library
with a plain C interface (all processes started together), then bound
with ctypes.  Libraries are named by a hash of their source, the shared
headers of csrc/ and the flags, and kept in `kubernetes_tpu_torch/_build/`,
so an unchanged source is built once.  A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

KERNELS = ("match_terms", "class_statics", "greedy_scan", "wavefront", "auction_loop",
           "class_extras", "partials_eval", "mirror_rows", "slice_stats", "evaluate_single",
           "preempt_dry_run", "pod_filters", "family_prep")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> Dict[str, float]:
    """Build every named kernel whose library is missing, one nvcc per
    source, all started together.  Returns the seconds each build took
    (0.0 for a library already on disk)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first if
    any library is missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            err = getattr(lib, f"{name}_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code)
        raise RuntimeError(
            f"kernel {name} launch failed: cudaError {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )
