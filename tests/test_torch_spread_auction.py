"""PodTopologySpread through the port's auction, against the reference.

The cases of tests/test_torch_spread_solves.py go to the reference's
jitted auction_assign and (as torch CPU tensors, so every kernel wrapper
runs its plain version: the bids with the spread rows, the acceptance,
the spread repair and its count commit) to the port's, with the same
tie_k and score config.  Compared exactly: assignment, scores, reasons,
gang_dropped, rounds, the final spread counts (debug_sp_counts) and the
post-solve requested / nonzero_requested.
"""

import numpy as np
import pytest

from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import scores as tscores

from test_torch_spread_solves import (
    ALL_CASES,
    CONFIGS,
    assert_fields,
    auction_spread_completeness,
    build_case,
    encode,
)


@pytest.mark.parametrize("case", ALL_CASES)
def test_auction_matches_reference(case):
    objs, cfg = build_case(case)
    snap, tsnap = encode(objs)
    n_groups = jschema.num_groups(snap)
    tie_k = jauction.default_tie_k(snap)
    want = jauction.auction_assign_jit(jscores.ScoreConfig(**CONFIGS[cfg]))(
        snap, n_groups=n_groups, tie_k=tie_k)
    got = tauction.auction_assign(tsnap, tscores.ScoreConfig(**CONFIGS[cfg]),
                                  n_groups=n_groups, tie_k=tie_k)
    assert_fields(want, got, ("assignment", "scores", "reasons", "gang_dropped", "rounds",
                              "debug_sp_counts"))


def test_auction_spread_keeps_every_hard_constraint():
    """The repair's output is constraint-valid: per service and zone the
    skew of the placed pods stays within maxSkew 1, all 256 placed."""
    snap, tsnap = encode(auction_spread_completeness())
    got = tauction.auction_assign(tsnap)
    a = got.assignment.numpy()[:256]
    assert (a >= 0).all()
    counts = np.zeros((4, 8), int)
    for i, node in enumerate(a):
        counts[i % 4, node % 8] += 1
    assert (counts.max(axis=1) - counts.min(axis=1) <= 1).all()
