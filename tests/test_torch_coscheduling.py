"""Coscheduling at Permit in the port against the reference package's.

kubernetes_tpu_torch/scheduler/coscheduling.py's `CoschedulingPermit`
and `carveout_contiguous` over the port's waiting-pods map and loop
(`Scheduler(..., device="cpu")`) against kubernetes_tpu/scheduler/
coscheduling.py's on the same objects: tests/test_permit.py's six cases
and tests/test_slices.py::test_coscheduling_carveout_release (both
carve-out modes), each run on both packages with equal transcripts; and
chip_smoke.front_sequence — the card's `front` phase — at a reduced
size on both packages: 200 nodes, three PodGroups of 20, 60 ungrouped
pods and a short group of 8 members under a minMember of 10, all
created over REST through each package's APIServer before the first
schedule_batch, the batches then driven by hand.  The placements, the
Permit releases, the refused writes and the final stores are equal.

The loop cases drive `schedule_batch` by hand instead of the loop's
thread, so every wait is a bounded poll of at most 2 s (WAIT_S) on an
event the case itself caused.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import chip_smoke
from kubernetes_tpu.api import admission as jadm
from kubernetes_tpu.api import auth as jauth
from kubernetes_tpu.api import crd as jcrd
from kubernetes_tpu.api import flowcontrol as jflow
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.api import wire as jwire
from kubernetes_tpu.api.server import APIServer as JAPIServer
from kubernetes_tpu.client.rest import RestClient as JRestClient
from kubernetes_tpu.scheduler import config as jconfig
from kubernetes_tpu.scheduler import coscheduling as jcos
from kubernetes_tpu.scheduler import metrics as jmetrics
from kubernetes_tpu.scheduler import scheduler as jsched
from kubernetes_tpu.scheduler import waitingpods as jwp
from kubernetes_tpu.scheduler.debugger import CacheComparer as JCacheComparer
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.scheduler import config as tconfig
from kubernetes_tpu_torch.scheduler import coscheduling as tcos
from kubernetes_tpu_torch.scheduler import metrics as tmetrics
from kubernetes_tpu_torch.scheduler import scheduler as tsched
from kubernetes_tpu_torch.scheduler import waitingpods as twp

PORT_M = chip_smoke.front_package()
REF_M = SimpleNamespace(w=jw, api=japi, st=jst, adm=jadm, auth=jauth, crd=jcrd,
                        flowcontrol=jflow, wire=jwire, APIServer=JAPIServer,
                        RestClient=JRestClient, CoschedulingPermit=jcos.CoschedulingPermit,
                        CacheComparer=JCacheComparer)
PORT = SimpleNamespace(name="port", m=PORT_M, w=PORT_M.w, api=PORT_M.api, st=PORT_M.st,
                       config=tconfig, cos=tcos, wp=twp, metrics=tmetrics,
                       Scheduler=tsched.Scheduler, kw={"device": "cpu"}, store_kw={})
REF = SimpleNamespace(name="reference", m=REF_M, w=jw, api=japi, st=jst, config=jconfig,
                      cos=jcos, wp=jwp, metrics=jmetrics, Scheduler=jsched.Scheduler,
                      kw={}, store_kw={"shards": 1})
WAIT_S = 2.0
# the front phase at a reduced size: (nodes, PodGroups, minMember, ungrouped
# pods, (the short group's minMember, its members)); the PodGroups'
# scheduleTimeoutSeconds, the short one's
FRONT_SMALL = (200, 3, 20, 60, (10, 8))
FRONT_SMALL_TIMEOUTS = (30.0, 0.5)


def _on_both(case):
    return case(PORT), case(REF)


def _poll(cond, timeout=WAIT_S, step=None):
    """Poll cond() (calling step() between polls, if given) for at most
    `timeout` seconds; whether it held."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        if step is not None:
            step()
        else:
            time.sleep(0.01)
    return bool(cond())


def _config(pkg):
    return pkg.config.SchedulerConfiguration(
        pod_initial_backoff_seconds=0.05, pod_max_backoff_seconds=0.2,
        batch_window_seconds=0.0, adaptive_batch_window=False)


def _sched(pkg, store):
    """A scheduler with its informers synced and no loop thread: the case
    drives schedule_batch itself."""
    s = pkg.Scheduler(store, config=_config(pkg), **pkg.kw)
    for kind in ("Node", "Pod"):
        s.informers.informer(kind).start()
    assert s.informers.wait_for_sync(WAIT_S)
    return s


def _node(pkg, name, cpu=4000, pods=10):
    return pkg.w.make_node(name).capacity(cpu_milli=cpu, pods=pods).obj()


def _member(pkg, name, group, namespace="default"):
    p = pkg.w.make_pod(name, namespace=namespace).req(cpu_milli=500).obj()
    p.spec.scheduling_group = group  # no size: the queue does not stage it
    return p


def _node_of(store, name, namespace="default"):
    return store.get("Pod", name, namespace).spec.node_name


def _queued(sched, n):
    return _poll(lambda: sched.queue.stats()["active"] + sched.queue.stats()["backoff"] >= n)


# -- tests/test_permit.py --------------------------------------------------------


def _waiting_pod_verdicts(pkg):
    wp = pkg.wp.WaitingPod(pkg.w.make_pod("p").obj(), "n0", timeout=5)
    wp.allow()
    wp2 = pkg.wp.WaitingPod(pkg.w.make_pod("q").obj(), "n0", timeout=5)
    wp2.reject("custom")
    wp3 = pkg.wp.WaitingPod(pkg.w.make_pod("r").obj(), "n0", timeout=0.05)
    return [wp.wait(), wp2.wait(), wp3.wait()]


def _wait_blocks_bind(pkg):
    store = pkg.st.Store(**pkg.store_kw)
    store.create(_node(pkg, "n0"))
    store.create(pkg.w.make_pod("p").req(cpu_milli=100).obj())
    sched = _sched(pkg, store)
    sched.profiles.default.register("permit", lambda pod, node: ("wait", 10.0))
    try:
        stats = sched.schedule_batch(timeout=WAIT_S)
        parked = sched.waiting.get(store.get("Pod", "p")) is not None
        before = _node_of(store, "p")
        allowed = sched.waiting.allow(store.get("Pod", "p"))
        assert _poll(lambda: _node_of(store, "p") == "n0")
        return [stats, parked, before, allowed, _node_of(store, "p")]
    finally:
        sched.stop()
        store.close()


def _reject_requeues(pkg):
    store = pkg.st.Store(**pkg.store_kw)
    store.create(_node(pkg, "n0"))
    store.create(pkg.w.make_pod("p").req(cpu_milli=100).obj())
    sched = _sched(pkg, store)
    verdicts = iter([("reject", 0.0)])
    sched.profiles.default.register("permit", lambda pod, node: next(verdicts, ("allow", 0.0)))
    try:
        first = sched.schedule_batch(timeout=WAIT_S)
        rejected_node = _node_of(store, "p")
        # the retry, once its backoff ends, is allowed and binds
        assert _poll(lambda: _node_of(store, "p") == "n0",
                     step=lambda: sched.schedule_batch(timeout=0.1))
        assert sched.flush_binds(WAIT_S)
        return [first, rejected_node, _node_of(store, "p")]
    finally:
        sched.stop()
        store.close()


def _timeout_retries(pkg):
    store = pkg.st.Store(**pkg.store_kw)
    store.create(_node(pkg, "n0"))
    store.create(pkg.w.make_pod("p").req(cpu_milli=100).obj())
    sched = _sched(pkg, store)
    calls = {"n": 0}
    timed_out = threading.Event()

    def permit(pod, node):
        calls["n"] += 1
        if calls["n"] == 1:
            return "wait", 0.2  # nobody allows: times out
        return "allow", 0.0

    sched.profiles.default.register("permit", permit)
    forget = sched.cache.forget

    def forgotten(pod):
        out = forget(pod)
        timed_out.set()
        return out

    sched.cache.forget = forgotten
    try:
        first = sched.schedule_batch(timeout=WAIT_S)
        assert timed_out.wait(WAIT_S)  # the 0.2 s Permit window lapsed
        assert _poll(lambda: _node_of(store, "p") == "n0",
                     step=lambda: sched.schedule_batch(timeout=0.1))
        assert sched.flush_binds(WAIT_S)
        return [first, calls["n"] >= 2, _node_of(store, "p")]
    finally:
        sched.stop()
        store.close()


# A gang with a member parked at Permit is in flight: the queue's
# gang-atomic pop skips its later members until the parked ones' Permit
# window lapses and the whole gang is pulled into one batch.  The gang
# cases use a GANG_PERMIT_S window so that happens inside WAIT_S.
GANG_PERMIT_S = 0.3


def _gang_holds(pkg):
    store = pkg.st.Store(**pkg.store_kw)
    for i in range(4):
        store.create(_node(pkg, f"n{i}", cpu=2000))
    for i in range(2):
        store.create(_member(pkg, f"g{i}", "band"))
    sched = _sched(pkg, store)
    cos = pkg.cos.CoschedulingPermit(sched.waiting, sizes={"band": 3}, timeout=GANG_PERMIT_S)
    for fwk in sched.profiles:
        fwk.register("permit", cos.permit)
    try:
        first = sched.schedule_batch(timeout=WAIT_S)
        parked = sorted(wp.pod.meta.name for wp in sched.waiting.iterate())
        held = [_node_of(store, f"g{i}") for i in range(2)]
        # the third member completes the gang: everyone binds
        store.create(_member(pkg, "g2", "band"))
        assert _queued(sched, 1)
        assert _poll(lambda: all(_node_of(store, f"g{i}") for i in range(3)),
                     step=lambda: sched.schedule_batch(timeout=0.1))
        assert sched.flush_binds(WAIT_S)
        return [first, parked, held, [_node_of(store, f"g{i}") for i in range(3)]]
    finally:
        sched.stop()
        store.close()


def _gangs_namespaced(pkg):
    store = pkg.st.Store(**pkg.store_kw)
    for i in range(6):
        store.create(_node(pkg, f"n{i}", cpu=2000))
    for ns in ("team-a", "team-b"):
        store.create(_member(pkg, "w0", "workers", namespace=ns))
    sched = _sched(pkg, store)
    cos = pkg.cos.CoschedulingPermit(sched.waiting, sizes={"workers": 2},
                                     timeout=GANG_PERMIT_S)
    for fwk in sched.profiles:
        fwk.register("permit", cos.permit)
    try:
        first = sched.schedule_batch(timeout=WAIT_S)
        parked = sorted((wp.pod.meta.namespace, wp.pod.meta.name)
                        for wp in sched.waiting.iterate())
        held = [_node_of(store, "w0", ns) for ns in ("team-a", "team-b")]
        # team-a's second member completes ONLY team-a's gang
        store.create(_member(pkg, "w1", "workers", namespace="team-a"))
        assert _queued(sched, 1)
        assert _poll(lambda: _node_of(store, "w0", "team-a") and _node_of(store, "w1", "team-a"),
                     step=lambda: sched.schedule_batch(timeout=0.1))
        assert sched.flush_binds(WAIT_S)
        # which nodes team-a's pair takes depends on whether team-b's
        # lone member, cycling through its own Permit window, is parked
        # at that batch: the transcript keeps whether each pod is bound
        return [first, parked, held,
                [bool(_node_of(store, n, ns)) for n, ns in (("w0", "team-a"), ("w1", "team-a"),
                                                            ("w0", "team-b"))]]
    finally:
        # team-b's half gang is parked or backing off: reject what waits
        for wp in sched.waiting.iterate():
            wp.reject("test over")
        sched.stop()
        store.close()


PERMIT_CASES = {
    "waiting_pod_allow_reject_timeout": _waiting_pod_verdicts,
    "permit_wait_blocks_bind_until_allow": _wait_blocks_bind,
    "permit_reject_requeues": _reject_requeues,
    "permit_timeout_requeues_and_retries": _timeout_retries,
    "coscheduling_gang_holds_at_permit": _gang_holds,
    "coscheduling_gangs_namespaced": _gangs_namespaced,
}


@pytest.mark.parametrize("case", sorted(PERMIT_CASES))
def test_permit_matches_reference(case):
    """tests/test_permit.py's cases on both packages: Wait parks the pod
    and its bind waits for Allow; Reject and a lapsed Permit window
    requeue it and the retry binds; a gang declared out of band (sizes)
    is released whole when its last member arrives, and same-named
    gangs in two namespaces never pool toward one quorum."""
    got, want = _on_both(PERMIT_CASES[case])
    assert got == want


def test_permit_transcripts_hold_the_reference_contract():
    """The transcripts say what tests/test_permit.py asserts."""
    assert _waiting_pod_verdicts(PORT) == ["allow", "custom", "timeout"]
    stats, parked, before, allowed, after = _wait_blocks_bind(PORT)
    assert parked and before == "" and allowed and after == "n0"
    first, parked, held, nodes = _gang_holds(PORT)
    assert parked == ["g0", "g1"] and held == ["", ""] and all(nodes)
    first, parked, held, nodes = _gangs_namespaced(PORT)
    assert len(parked) == 2 and held == ["", ""] and nodes == [True, True, False]


# -- tests/test_slices.py::test_coscheduling_carveout_release -------------------


def _slice_nodes(pkg, n_slices, dims):
    api = pkg.api
    return [
        pkg.w.make_node(f"slice-{s}-{x}{y}{z}")
        .capacity(cpu_milli=4000, mem=8 * pkg.w.GI, pods=16)
        .label(api.LABEL_TPU_SLICE, f"slice-{s}")
        .label(api.LABEL_TPU_TOPOLOGY, "x".join(map(str, dims)))
        .label(api.LABEL_TPU_COORDS, f"{x},{y},{z}")
        .obj()
        for s in range(n_slices) for z in range(dims[2]) for y in range(dims[1])
        for x in range(dims[0])
    ]


def _gang(pkg, name, size, shape):
    out = []
    for i in range(size):
        p = pkg.w.make_pod(f"{name}-{i}").req(cpu_milli=100).group(name).obj()
        p.spec.tpu_topology = shape
        out.append(p)
    return out


def _release_gang(pkg, permit, members):
    """All but the last member park at Permit; the last one's call
    releases (or rejects) the gang.  The verdicts by pod."""
    verdicts, threads = {}, []
    for pod, node in members[:-1]:
        verdict, timeout = permit.permit(pod, node)
        assert verdict == "wait"
        wp = pkg.wp.WaitingPod(pod, node, timeout)
        permit.waiting.add(wp)

        def waiter(wp=wp, pod=pod):
            verdicts[pod.meta.name] = wp.wait()

        t = threading.Thread(target=waiter)
        t.start()
        threads.append(t)
    last_pod, last_node = members[-1]
    verdicts[last_pod.meta.name] = permit.permit(last_pod, last_node)[0]
    for t in threads:
        t.join(timeout=WAIT_S)
    return verdicts


def _carveout(pkg, carveout):
    nodes = {n.meta.name: n for n in _slice_nodes(pkg, 1, (2, 2, 1))}
    metrics = pkg.metrics.Registry()
    permit = pkg.cos.CoschedulingPermit(
        pkg.wp.WaitingPodsMap(), sizes={"g": 2}, timeout=2.0,
        carveout=carveout, node_lookup=nodes.get, metrics=metrics)
    out = []
    for pair in (["slice-0-000", "slice-0-100"], ["slice-0-000", "slice-0-110"]):
        pods = _gang(pkg, "g", 2, "2x1x1")
        verdicts = _release_gang(pkg, permit, list(zip(pods, pair)))
        out.append((sorted(verdicts.items()), metrics.gang_contiguous_placements.total,
                    metrics.slice_carveout_fallbacks.total))
    helper = pkg.cos.carveout_contiguous
    nodes2 = {n.meta.name: n for n in _slice_nodes(pkg, 2, (2, 2, 1))}
    out.append([helper([nodes2[a], nodes2[b]]) for a, b in (
        ("slice-0-000", "slice-0-100"), ("slice-0-000", "slice-0-110"),
        ("slice-0-000", "slice-1-000"), ("slice-0-000", "slice-0-000"))])
    return out


@pytest.mark.parametrize("carveout", ["prefer", "require"])
def test_coscheduling_carveout_release_matches_reference(carveout):
    """A contiguous pair is released either way and counted contiguous; a
    diagonal pair is released and counted a fallback under prefer, and
    rejected whole under require; carveout_contiguous on the four cases
    of tests/test_slices.py — on both packages."""
    got, want = _on_both(lambda pkg: _carveout(pkg, carveout))
    assert got == want
    contiguous, diagonal, helper = got
    assert {v for _, v in contiguous[0]} == {"allow"} and contiguous[1] == 1
    assert diagonal[2] == 1 and helper == [True, False, False, False]
    if carveout == "prefer":
        assert {v for _, v in diagonal[0]} == {"allow"}
    else:
        assert "allow" not in {v for _, v in diagonal[0]}


# -- the card's front phase at a reduced size ------------------------------------


def _store_docs(m, store) -> dict:
    """Every object the store holds but the scheduler's Events, as wire
    documents without the fields a run draws (uid, creation time,
    resourceVersion): two packages' final stores."""
    out = {}
    for kind in sorted(store.kinds()):
        if kind == "Event":
            continue
        for obj in store.list(kind)[0]:
            doc = m.wire.to_wire(obj)
            for k in ("uid", "creation_timestamp", "resource_version"):
                doc["meta"].pop(k, None)
            out[f"{kind}/{obj.meta.namespace}/{obj.meta.name}"] = doc
    return out


def _front(pkg):
    def make(store):
        return pkg.Scheduler(store, config=_config(pkg), **pkg.kw)

    # one client: the nodes' row order and the pods' queue order follow the
    # creation order, so both packages see the same cluster and batches
    got = chip_smoke.front_sequence(pkg.m, make, FRONT_SMALL, FRONT_SMALL_TIMEOUTS, 1,
                                    hand=True, wait_s=30.0)
    try:
        out = chip_smoke.front_checks(got, FRONT_SMALL)
        out["store"] = _store_docs(pkg.m, got["store"])
        out["refusals_host"] = chip_smoke.front_refusals(pkg.m)
        out["apf_rejected"] = got["apf_rejected_total"]
        return out
    finally:
        got["store"].close()


def test_front_sequence_matches_reference():
    """chip_smoke.front_sequence at 200 nodes, three PodGroups of 20, 60
    ungrouped pods and 8 members of a short group of minMember 10 (its
    Permit window 0.5 s), over REST through each package's APIServer
    (TokenAuthenticator, RBACAuthorizer, an APFGate from FRONT_APF),
    everything created in order by one client before the first
    schedule_batch: every group
    released once with 19 members parked, every pod but the short ones
    bound once on the same node in both packages, the short members
    cycled through Permit and gone from the waiting map and the cache
    after their delete, the same three refusals as a host-only server's,
    and equal final stores."""
    got, want = _on_both(_front)
    assert got["refusals"] == got["refusals_host"]
    assert [c for c, _ in got["refusals"]] == ["RuntimeError"] * 3
    assert got["releases"] == {f"gang-{g}": 19 for g in range(3)}
    assert got["apf_rejected"] == 0
    assert len(got["placed"]) == 120
    assert got == want


def test_front_phase_on_the_cpu(monkeypatch):
    """chip_smoke.front_phase at the reduced size with the scheduler's own
    loop running while the pods arrive (the card's shape), every
    Scheduler on device="cpu", the groups' Permit window cut to 1.5 s:
    a group's first-popped members park and time out before the whole
    group is pulled into one batch; every check, the host-only refusals
    and the replay of every recorded batch over the state the loop held
    then — the card's launch counting stubbed."""
    from kubernetes_tpu_torch.kernels import bindings
    from kubernetes_tpu_torch.models import batch_scheduler as tbs

    class CPU(tbs.TorchBatchScheduler):
        def __init__(self, *a, **kw):
            kw["device"] = "cpu"
            super().__init__(*a, **kw)

    def drive(name, fn, bindings, scheds, extra=(), armed=False):
        return fn(), {k: 1 for k in bindings.LAUNCHES}

    monkeypatch.setattr(chip_smoke, "CARD_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "drive_phase", drive)
    monkeypatch.setattr(chip_smoke, "SCHEDULERS", [])
    monkeypatch.setattr(chip_smoke, "FRONT", FRONT_SMALL)
    monkeypatch.setattr(chip_smoke, "FRONT_TIMEOUTS", (1.5, 0.5))
    monkeypatch.setattr(chip_smoke, "FRONT_WAIT_S", 30.0)
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = chip_smoke.front_phase(chip_smoke.recording(CPU), bindings, "cpu")
    assert out["equal_direct"] and out["bound"] == 120
    assert out["permit"]["releases"] == 3 and out["permit"]["timeouts"] >= 16
    assert out["apf"]["rejected_total"] == 0 and out["refusals"] == ["RuntimeError"] * 3
    assert out["batches"] == sum(out["batches_by_route"].values())
