"""The port's Oracle (kubernetes_tpu_torch/testing/oracle.py) against the
reference's (kubernetes_tpu/testing/oracle.py), on the CPU.

The port's copy is the host fallback's solver and its second witness, so
it must place exactly as the reference's: every parity batch of
testing/cases.py — mixed, contended, gangs, spread, required and
preferred inter-pod, images, slices under both policies — built with each
package's own wrappers, equal names; and on the preemption clusters,
equal nominated nodes and victims per preemptor.
"""

import pytest

from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.testing.oracle import Oracle as JOracle
from kubernetes_tpu_torch.testing import cases
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.oracle import Oracle as TOracle


def _schedule_case(name, seed):
    """(nodes, pods, bound, policy) builder of one parity batch."""
    def build(w):
        if name == "mixed":
            return (*cases.mixed_objects(w, seed), "prefer")
        if name == "contended":
            return (*cases.contended_objects(w), "prefer")
        if name == "gang":
            return (*cases.gang_objects(w), "prefer")
        if name == "spread":
            return (*cases.spread_objects(w, seed), "prefer")
        if name == "interpod":
            return (*cases.interpod_objects(w, seed), "prefer")
        if name == "preferred":
            return (*cases.prefpod_objects(w, seed), "prefer")
        if name == "images":
            return (*cases.image_objects(w, seed), "prefer")
        nodes, pods, bound, _ = cases.random_slice_objects(w, seed)
        return nodes, pods, bound, name.split("/")[1]
    return build


SCHEDULE_CASES = (
    [("mixed", s) for s in range(6)]
    + [("contended", 0), ("gang", 0)]
    + [(fam, s) for fam in ("spread", "interpod", "preferred", "images") for s in range(3)]
    + [(f"slices/{pol}", s) for pol in ("prefer", "require") for s in range(4)]
)


@pytest.mark.parametrize("name,seed", SCHEDULE_CASES,
                         ids=[f"{n}-{s}" for n, s in SCHEDULE_CASES])
def test_schedule_matches_reference_oracle(name, seed):
    build = _schedule_case(name, seed)
    got = {}
    for key, w, oracle in (("ref", jw, JOracle), ("port", tw, TOracle)):
        nodes, pods, bound, policy = build(w)
        got[key] = oracle(nodes, bound_pods=bound, slice_policy=policy).schedule(pods)
    assert got["port"] == got["ref"]
    assert any(n is not None for n in got["port"]), "a vacuous case: nothing placed"


def _plan(result):
    if result is None:
        return None
    node, victims = result
    return node, sorted(v.meta.name for v in victims)


def _preempt_case(name):
    """(nodes, bound, preemptors) of one preemption cluster."""
    def build(w):
        if name == "basic":
            return cases.preemption_basic_objects(w, 12, 48, 6)
        nodes, victims, preemptors, _pdb = cases.c9_objects(w, 24, 6)
        return nodes, victims, preemptors
    return build


@pytest.mark.parametrize("name", ["basic", "c9"])
def test_preempt_matches_reference_oracle(name):
    """Oracle.preempt, one preemptor at a time against the same cluster:
    the same node and the same victims as the reference's."""
    build = _preempt_case(name)
    got = {}
    for key, w, oracle in (("ref", jw, JOracle), ("port", tw, TOracle)):
        nodes, bound, preemptors = build(w)
        o = oracle(nodes, bound_pods=bound)
        got[key] = [_plan(o.preempt(p)) for p in preemptors]
    assert got["port"] == got["ref"]
    assert any(p is not None for p in got["port"]), "a vacuous case: no preemption"
