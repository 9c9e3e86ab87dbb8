"""The loop's retrace counter: the CUDA analogue of the reference's
runtime retrace tracker (kubernetes_tpu/analysis/retrace.py).

The reference counts XLA traces of its solver executables; a trace in
the steady window means a kernel argument escaped the pad-bucket lattice
and ate a compile on the hot path.  This package has no tracer: its
kernels are hand-written CUDA built once per source by nvcc
(kernels/build.py) and loaded with ctypes.  What compiles mid-run here is
a kernel library that the process first needs after its first batch —
built (when missing) and loaded on a scheduling cycle instead of at
start-up.  `total()` counts those: the kernel libraries kernels/build.py
loaded into this process after `mark_steady()`, which the Scheduler calls
once its first cycle finishes.  On the CPU no library is ever loaded, so
`total()` is 0 there.

Import-light: it reads a counter of kernels/build.py, which imports the
standard library only.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..kernels import build as _build

_mu = threading.Lock()
_steady_at: Optional[int] = None


def mark_steady() -> None:
    """Start the steady window at the libraries loaded so far (the first
    call wins; later calls change nothing)."""
    global _steady_at
    with _mu:
        if _steady_at is None:
            _steady_at = _build.loads_total


def total() -> int:
    """Kernel libraries loaded since `mark_steady()` (0 before it)."""
    with _mu:
        if _steady_at is None:
            return 0
        return _build.loads_total - _steady_at


def reset() -> None:
    """Forget the steady mark (tests)."""
    global _steady_at
    with _mu:
        _steady_at = None
