"""The scheduler's front half in the port against the reference package.

The host modules that feed TorchBatchScheduler — the versioned
configuration (scheduler/config.py), the feature gates
(utils/featuregate.py), the profiles (scheduler/framework.py), the
scheduling queue (scheduler/queue.py), the Permit wait map
(scheduler/waitingpods.py), the dispatch arbiter and the obligation ledger
(analysis/ledger.py) — each driven the same way as the reference's copy,
on the CPU, with equal outcomes: configurations field for field, queue
transcripts, placements and failure reasons exactly.

The cases copy tests/test_config_featuregates.py (the mesh case keeps its
gate-off half; with the gate on the port raises NotImplementedError, as it
has no multi-device solves) and the loop-free cases of
tests/test_queueing_hints.py.  The slice test drives SchedulingBasic with
500 nodes and 500 pods through queue -> FrameworkRegistry(device="cpu") ->
solve, against the reference's FrameworkRegistry on the same sequence and
against testing/oracle.py; chip_smoke.front_half_sequence (the card
script's `profiles` phase) runs at a reduced size on both packages.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu.analysis import ledger as jledger
from kubernetes_tpu.models import batch_scheduler as jbs
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import auction as jauction
from kubernetes_tpu.ops import schema as jschema
from kubernetes_tpu.scheduler import cache as jcache
from kubernetes_tpu.scheduler import config as jconfig
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import queue as jqueue
from kubernetes_tpu.scheduler import waitingpods as jwaiting
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.utils import featuregate as jgate
from kubernetes_tpu_torch.analysis import ledger as tledger
from kubernetes_tpu_torch.models import batch_scheduler as tbs
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import auction as tauction
from kubernetes_tpu_torch.ops import device as dv
from kubernetes_tpu_torch.ops import schema as tschema
from kubernetes_tpu_torch.scheduler import cache as tcache
from kubernetes_tpu_torch.scheduler import config as tconfig
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import queue as tqueue
from kubernetes_tpu_torch.scheduler import waitingpods as twaiting
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.oracle import Oracle
from kubernetes_tpu_torch.utils import featuregate as tgate

CONFIG_YAML = """
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
parallelism: 8
podInitialBackoffSeconds: 2
podMaxBackoffSeconds: 30
featureGates:
  AuctionSolver: false
profiles:
  - schedulerName: default-scheduler
    plugins:
      score:
        disabled:
          - name: ImageLocality
        enabled:
          - name: NodeAffinity
            weight: 3
    pluginConfig:
      - name: NodeResourcesFit
        args:
          scoringStrategy:
            type: MostAllocated
  - schedulerName: batch-scheduler
"""


def _port_registry(cfg, **kw):
    return tframework.FrameworkRegistry(cfg, device="cpu", **kw)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# -- configuration and feature gates (tests/test_config_featuregates.py) -----

@pytest.mark.parametrize("source", ["yaml", "file", "dict"])
def test_load_config_round_trip(source, tmp_path):
    if source == "yaml":
        doc = CONFIG_YAML
    elif source == "file":
        doc = tmp_path / "sched.yaml"
        doc.write_text(CONFIG_YAML)
        doc = str(doc)
    else:
        import yaml

        doc = yaml.safe_load(CONFIG_YAML)
    cfg = tconfig.load_config(doc)
    assert _fields(cfg) == _fields(jconfig.load_config(doc))
    assert cfg.parallelism == 8
    assert cfg.pod_initial_backoff_seconds == 2.0
    assert cfg.pod_max_backoff_seconds == 30.0
    assert cfg.feature_gates == {"AuctionSolver": False}
    assert [p.scheduler_name for p in cfg.profiles] == ["default-scheduler", "batch-scheduler"]
    prof = cfg.profiles[0]
    assert prof.disabled_score_plugins == ("ImageLocality",)
    eff = prof.effective_score_config()
    assert eff.image_weight == 0.0
    assert eff.node_affinity_weight == 3.0
    assert eff.fit_strategy == "MostAllocated"


@pytest.mark.parametrize("doc,match", [
    ({"bogusKnob": 1}, "unknown configuration fields"),
    ({"apiVersion": "v999"}, "unsupported apiVersion"),
    ({"profiles": [{"schedulerName": "x", "oops": 1}]}, "unknown profile fields"),
    ({"featureGates": {"Nope": True}}, "unknown feature gate"),
    ({"meshDevices": 3}, "power of two"),
])
def test_load_config_rejects(doc, match):
    with pytest.raises(ValueError, match=match) as got:
        tconfig.load_config(doc)
    with pytest.raises(ValueError) as want:
        jconfig.load_config(doc)
    assert str(got.value) == str(want.value)


def test_feature_gate_validation():
    assert tgate.DEFAULT_FEATURES == {
        k: tgate.FeatureSpec(v.default, v.stage, v.lock_to_default)
        for k, v in jgate.DEFAULT_FEATURES.items()}
    g = tgate.FeatureGate()
    assert g.enabled("AuctionSolver")
    assert g.enabled("GangScheduling")
    assert g.as_map() == jgate.FeatureGate().as_map()
    with pytest.raises(ValueError, match="unknown feature gate"):
        tgate.FeatureGate(overrides={"Bogus": True})
    with pytest.raises(ValueError, match="locked"):
        tgate.FeatureGate(overrides={"GangScheduling": False})
    g2 = tgate.FeatureGate.from_flag("AuctionSolver=false,VolumeBinding=true")
    assert not g2.enabled("AuctionSolver")
    assert g2.enabled("VolumeBinding")
    with pytest.raises(ValueError, match="true|false"):
        tgate.FeatureGate.from_flag("AuctionSolver=maybe")


def test_validate_catches_bad_gates_in_config():
    cfg = tconfig.SchedulerConfiguration(feature_gates={"Nope": True})
    with pytest.raises(ValueError, match="unknown feature gate"):
        cfg.validate()


@pytest.mark.parametrize("gates", [
    {}, {"AuctionSolver": False}, {"DeviceClusterMirror": False},
    {"IncrementalSolve": False},
])
def test_gates_map_to_scheduler_knobs(gates):
    """AuctionSolver -> mode, DeviceClusterMirror -> use_mirror,
    IncrementalSolve (with the mirror) -> the partials, as the reference's
    registry maps them."""
    mine = _port_registry(tconfig.SchedulerConfiguration(feature_gates=gates)).default.tpu
    ref = jframework.FrameworkRegistry(
        jconfig.SchedulerConfiguration(feature_gates=gates)).default.tpu
    assert mine.mode == ref.mode
    assert mine.use_mirror == ref.use_mirror
    assert (mine._partials is None) == (ref._partials is None)
    assert mine.device.type == "cpu"


def test_auction_gate_flips_router():
    """With AuctionSolver off every profile's solver routes greedy, even
    for a gang batch; both place the gang as the reference does."""
    def objects(wr):
        nodes = [wr.make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * wr.GI, pods=20).obj()
                 for i in range(8)]
        pods = [wr.make_pod(f"p{i}").req(cpu_milli=500, mem=wr.MI).group("g", size=4).obj()
                for i in range(4)]
        return nodes, pods

    for gates, result in (({}, "AuctionResult"), ({"AuctionSolver": False}, "SolveResult")):
        reg = _port_registry(tconfig.SchedulerConfiguration(feature_gates=gates))
        jreg = jframework.FrameworkRegistry(jconfig.SchedulerConfiguration(feature_gates=gates))
        assert reg.default.tpu.mode == ("auto" if not gates else "greedy")
        names = {}
        for tag, r, wr in (("port", reg, tw), ("ref", jreg, jw)):
            nodes, pods = objects(wr)
            for nd in nodes:
                r.default.tpu.add_node(nd)
            names[tag] = r.default.tpu.schedule_pending(pods)
            assert type(r.default.tpu.last_result).__name__ == result
        assert all(n is not None for n in names["port"])
        assert names["port"] == names["ref"]


def test_mesh_devices_knob_loads_and_validates():
    cfg = tconfig.load_config({"meshDevices": 8})
    assert cfg.mesh_devices == 8
    assert tconfig.SchedulerConfiguration().mesh_devices == 0
    with pytest.raises(ValueError, match="power of two"):
        tconfig.SchedulerConfiguration(mesh_devices=3).validate()
    with pytest.raises(ValueError, match=">= 0"):
        tconfig.SchedulerConfiguration(mesh_devices=-1).validate()
    g = tgate.FeatureGate()
    assert g.enabled("ShardedSolve")
    assert not tgate.FeatureGate(overrides={"ShardedSolve": False}).enabled("ShardedSolve")


def test_mesh_registry_build_respects_gate():
    """Gate off: the mesh knob is ignored and every profile stays on one
    card, as in the reference.  Gate on: the port has no multi-device
    solves, so the registry raises instead of ignoring the knob."""
    off = _port_registry(tconfig.SchedulerConfiguration(
        mesh_devices=8, feature_gates={"ShardedSolve": False}))
    joff = jframework.FrameworkRegistry(jconfig.SchedulerConfiguration(
        mesh_devices=8, feature_gates={"ShardedSolve": False}))
    assert joff.default.tpu.mesh is None
    assert all(f.tpu.device.type == "cpu" for f in off)
    with pytest.raises(NotImplementedError, match="multi-device"):
        _port_registry(tconfig.SchedulerConfiguration(mesh_devices=8))


def test_mirror_gate_off_still_schedules():
    placed = {}
    for tag, reg, wr in (
            ("port", _port_registry(tconfig.SchedulerConfiguration(
                feature_gates={"DeviceClusterMirror": False})), tw),
            ("ref", jframework.FrameworkRegistry(jconfig.SchedulerConfiguration(
                feature_gates={"DeviceClusterMirror": False})), jw)):
        tpu = reg.default.tpu
        assert not tpu.use_mirror
        for i in range(4):
            tpu.add_node(wr.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * wr.GI, pods=10)
                         .obj())
        placed[tag] = tpu.schedule_pending(
            [wr.make_pod(f"p{i}").req(cpu_milli=1000, mem=wr.MI).obj() for i in range(4)])
    assert all(n is not None for n in placed["port"])
    assert placed["port"] == placed["ref"]


def test_registry_builds_on_the_card_or_raises():
    """device=None means the CUDA card; without one the registry raises
    (TorchBatchScheduler's refusal) rather than carry on on the CPU."""
    cfg = tconfig.SchedulerConfiguration()
    if torch.cuda.is_available():
        assert tframework.FrameworkRegistry(cfg).default.tpu.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tframework.FrameworkRegistry(cfg)


@pytest.mark.parametrize("n_profiles", [1, 2, 3])
def test_registry_profiles_share_state_and_arbiter(n_profiles):
    profiles = [tconfig.ProfileConfig(scheduler_name=f"s{i}") for i in range(n_profiles)]
    reg = _port_registry(tconfig.SchedulerConfiguration(profiles=profiles))
    jreg = jframework.FrameworkRegistry(jconfig.SchedulerConfiguration(
        profiles=[jconfig.ProfileConfig(scheduler_name=f"s{i}") for i in range(n_profiles)]))
    tpus = [f.tpu for f in reg]
    assert [f.scheduler_name for f in reg] == [f.scheduler_name for f in jreg]
    assert all(t.state is reg.state for t in tpus)
    assert (reg.arbiter is None) == (jreg.arbiter is None) == (n_profiles == 1)
    assert all(t.arbiter is reg.arbiter for t in tpus)
    pod = tw.make_pod("x").obj()
    pod.spec.scheduler_name = "s0"
    assert reg.for_pod(pod) is reg.frameworks["s0"]
    pod.spec.scheduler_name = "elsewhere"
    assert reg.for_pod(pod) is None


# -- failure reasons and the event-scoped wake (tests/test_queueing_hints.py) --

def _reason_case(wr, case):
    api = wr.api
    bound = []
    if case == "static":
        nodes = [wr.make_node("n0").capacity(cpu_milli=4000).taint("k", "v").obj()]
        pods = [wr.make_pod("p").req(cpu_milli=100).obj()]
    elif case == "resources":
        nodes = [wr.make_node("n0").capacity(cpu_milli=100).obj()]
        pods = [wr.make_pod("p").req(cpu_milli=4000).obj()]
    elif case == "spread":
        nodes = [wr.make_node("n0").capacity(cpu_milli=8000, pods=110).zone("z0").obj(),
                 wr.make_node("n1").capacity(cpu_milli=100, pods=110).zone("z1").obj()]
        pods = [wr.make_pod(f"p{i}").req(cpu_milli=500).label("app", "s")
                .spread(1, api.LABEL_ZONE, "DoNotSchedule", {"app": "s"}).obj()
                for i in range(4)]
    elif case == "interpod":
        nodes = [wr.make_node("n0").capacity(cpu_milli=8000).obj()]
        bound = [wr.make_pod("b").label("app", "x").node_name("n0").obj()]
        pods = [wr.make_pod("p").req(cpu_milli=100).label("app", "x")
                .pod_anti_affinity({"app": "x"}).obj()]
    elif case == "placed":
        nodes = [wr.make_node("n0").capacity(cpu_milli=4000).obj()]
        pods = [wr.make_pod("p").req(cpu_milli=100).obj()]
    else:  # auction: two pods contend for one node
        nodes = [wr.make_node("n0").capacity(cpu_milli=1000, pods=110).obj()]
        pods = [wr.make_pod(f"p{i}").req(cpu_milli=800).obj() for i in range(2)]
    return nodes, pods, bound


@pytest.mark.parametrize("case,want", [
    ("static", [jassign.REASON_STATIC]),
    ("resources", [jassign.REASON_RESOURCES]),
    ("spread", None),
    ("interpod", [jassign.REASON_INTERPOD]),
    ("placed", [jassign.REASON_NONE]),
    ("auction", None),
])
def test_solver_reasons(case, want):
    """The solve's failure stage, read back per pod: the port's plain
    solves equal the reference's (the greedy scan; the auction for the
    contended pair)."""
    jn, jp, jb = _reason_case(jw, case)
    tn, tp, tb = _reason_case(tw, case)
    jsnap, _ = jschema.SnapshotBuilder().build(jn, jp, bound_pods=jb)
    tsnap, _ = tschema.SnapshotBuilder().build(tn, tp, bound_pods=tb)
    tsnap = dv.to_device(tsnap, "cpu")
    if case == "auction":
        jr, tr = jauction.auction_assign(jsnap), tauction.auction_assign(tsnap)
    else:
        jr, tr = jassign.greedy_assign(jsnap), tassign.greedy_assign(tsnap)
    n = len(jp)
    ja, ta = np.asarray(jr.assignment)[:n], tr.assignment.numpy()[:n]
    jrs, trs = np.asarray(jr.reasons)[:n], tr.reasons.numpy()[:n]
    assert np.array_equal(ja, ta) and np.array_equal(jrs, trs)
    assert tassign.REASON_NONE == jassign.REASON_NONE
    if case == "spread":
        assert (trs[ta < 0] == tassign.REASON_SPREAD).all()
    elif case == "auction":
        assert (ta >= 0).sum() == 1
        assert trs[ta < 0][0] == tassign.REASON_RESOURCES
    else:
        assert trs.tolist() == want


def test_event_wakes_match_reference():
    assert tqueue.EVENT_WAKES == jqueue.EVENT_WAKES


def _wake_transcript(mod, wr, assign):
    """test_event_scoped_wake and test_unknown_reason_always_wakes."""
    out = []
    q = mod.SchedulingQueue()
    for name in ("res", "static"):
        q.add(wr.make_pod(name).obj())
    infos = {i.pod.meta.name: i for i in q.pop_batch(10, timeout=0.2)}
    q.add_unschedulable(infos["res"], reason=assign.REASON_RESOURCES)
    q.add_unschedulable(infos["static"], reason=assign.REASON_STATIC)
    out.append(q.move_for_event("AssignedPodDelete"))
    out.append(q.stats()["unschedulable"])
    out.append(q.move_for_event("NodeAdd"))
    q2 = mod.SchedulingQueue()
    q2.add(wr.make_pod("u").obj())
    (info,) = q2.pop_batch(10, timeout=0.2)
    q2.add_unschedulable(info)
    out.append(q2.move_for_event("AssignedPodAdd"))
    return out


def test_event_scoped_wake():
    got = _wake_transcript(tqueue, tw, tassign)
    assert got == _wake_transcript(jqueue, jw, jassign)
    assert got == [1, 1, 1, 1]


def _queue_scenario(mod, wr, assign, case):
    """A queue transcript: pop order, tiers and wake counts on a manual
    clock."""
    now = [0.0]
    q = mod.SchedulingQueue(backoff_base=1.0, backoff_max=4.0, clock=lambda: now[0])
    out = []

    def pop(**kw):
        got = q.pop_batch(kw.pop("max_n", 100), timeout=0, window=0, **kw)
        out.append([i.pod.meta.name for i in got])
        return got

    if case == "gang":
        # a gang of 3 is staged until whole, then pops atomically past max_n
        for i in range(2):
            q.add(wr.make_pod(f"g{i}").group("ring", size=3).obj())
        q.add(wr.make_pod("solo").priority(5).obj())
        out.append(q.stats())
        pop(max_n=1)
        q.add(wr.make_pod("g2").group("ring", size=3).obj())
        infos = pop(max_n=1)
        for info in infos:
            q.done(info.pod)
    elif case == "profiles":
        # deficit round robin over profile classes; a lane pops its own
        for i in range(6):
            p = wr.make_pod(f"a{i}").obj()
            p.spec.scheduler_name = "hot"
            q.add(p)
        for i in range(2):
            p = wr.make_pod(f"b{i}").obj()
            p.spec.scheduler_name = "cold"
            q.add(p)
        pop(max_n=4)
        pop(profiles={"cold"})
        pop(profiles={"hot"})
    elif case == "backoff":
        # a requeued pod waits out its exponential backoff
        q.add(wr.make_pod("b").obj())
        (info,) = pop()
        q.requeue_backoff(info)
        pop()
        now[0] += 0.5
        pop()
        now[0] += 0.6
        (info,) = pop()
        q.requeue_backoff(info)
        now[0] += 1.5
        pop()
        now[0] += 1.0
        pop()
    elif case == "gated":
        # a gated pod stays out of every tier until its gates clear
        p = wr.make_pod("gated").obj()
        p.spec.scheduling_gates = ["wait"]
        q.add(p)
        out.append(q.stats())
        pop()
        p2 = wr.make_pod("gated").obj()
        q.update(p2)
        pop()
    elif case == "missed_event":
        # an event arriving while the pod is in flight is replayed
        q.add(wr.make_pod("m").obj())
        (info,) = pop()
        q.move_for_event("NodeAdd")
        q.add_unschedulable(info, reason=assign.REASON_RESOURCES)
        out.append(q.stats())
        now[0] += 2.0
        pop()
    out.append(q.stats())
    return out


@pytest.mark.parametrize("case", ["gang", "profiles", "backoff", "gated", "missed_event"])
def test_queue_transcript_matches_reference(case):
    got = _queue_scenario(tqueue, tw, tassign, case)
    assert got == _queue_scenario(jqueue, jw, jassign, case)
    if case == "gang":
        assert got[1] == ["solo"] and sorted(got[2]) == ["g0", "g1", "g2"]
    elif case == "profiles":
        assert got[0] == ["a0", "b0", "a1", "b1"] and got[1] == [] and len(got[2]) == 4
    elif case == "backoff":
        assert got[:6] == [["b"], [], [], ["b"], [], ["b"]]


# -- Permit's wait map, the arbiter and the ledger ---------------------------

@pytest.mark.parametrize("verdict", ["allow", "reject", "timeout"])
def test_waiting_pods_map(verdict):
    outs = []
    for mod, wr in ((twaiting, tw), (jwaiting, jw)):
        wmap = mod.WaitingPodsMap()
        pod = wr.make_pod("w").obj()
        wp = mod.WaitingPod(pod, "n0", timeout=0.05 if verdict == "timeout" else 5.0)
        wmap.add(wp)
        assert wmap.get(pod) is wp and wmap.iterate() == [wp]
        if verdict == "allow":
            threading.Timer(0.01, wmap.allow, args=(pod,)).start()
        elif verdict == "reject":
            threading.Timer(0.01, wmap.reject, args=(pod, "quota")).start()
        got = wp.wait()
        wmap.remove(pod)
        # a decision latches: a late allow cannot overturn it
        outs.append((got, wp.allow(), wmap.get(pod)))
    assert outs[0] == outs[1]
    assert outs[0][0] == {"allow": "allow", "reject": "quota", "timeout": "timeout"}[verdict]


def test_dispatch_arbiter_depth_forced_and_release():
    for mod in (tbs, jbs):
        arb = mod.DispatchArbiter(depth=2, timeout=0.05)
        assert arb.acquire() and arb.acquire()
        assert arb.inflight() == 2
        # a third admission waits out the deadline, then is forced
        assert arb.acquire() is False
        assert (arb.acquires, arb.forced, arb.inflight()) == (3, 1, 3)
        for _ in range(3):
            arb.release()
        assert arb.inflight() == 0
        arb.release()  # below zero: the counter stays sane
        assert arb.inflight() == 0
        # a waiter is admitted when a slot comes back
        arb2 = mod.DispatchArbiter(depth=1, timeout=5.0)
        arb2.acquire()
        threading.Timer(0.02, arb2.release).start()
        assert arb2.acquire() is True and arb2.forced == 0


def test_arbiter_slot_follows_the_solve():
    """A two-profile registry takes a slot before each dispatch and gives
    it back on the decode; a DeviceSolve dropped undecoded gives it back
    through release_slot, once."""
    profiles = [tconfig.ProfileConfig(scheduler_name=f"s{i}") for i in range(2)]
    reg = _port_registry(tconfig.SchedulerConfiguration(profiles=profiles))
    tpu = reg.frameworks["s1"].tpu
    for i in range(8):
        tpu.add_node(tw.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * tw.GI).obj())
    pods = [tw.make_pod(f"p{i}").req(cpu_milli=100).obj() for i in range(5)]
    assert all(n is not None for n in tpu.schedule_pending(pods))
    assert (reg.arbiter.acquires, reg.arbiter.inflight()) == (1, 0)
    with tledger.tracked() as led:
        ds = tpu.schedule_pending_async(pods)
        assert reg.arbiter.inflight() == 1 and ds._slot is reg.arbiter
        ds.release_slot()
        ds.release_slot()  # idempotent
        assert reg.arbiter.inflight() == 0
        led.assert_clean()


@pytest.mark.parametrize("which", ["ref", "port"])
def test_ledger_pod_assume_slot_and_fault(which):
    """A popped pod is discharged by done, and a second discharge of it is
    a double discharge; assume/forget and the arbiter's slot likewise; an
    armed fault registry is held until disarmed."""
    mods = {"ref": (jledger, jqueue, jcache, jbs, jschema, jw),
            "port": (tledger, tqueue, tcache, tbs, tschema, tw)}[which]
    ledger, queue, cache, bs, schema, wr = mods
    from kubernetes_tpu.testing import faults as jfaults
    from kubernetes_tpu_torch.testing import faults as tfaults

    faults = {"ref": jfaults, "port": tfaults}[which]
    with ledger.tracked() as led:
        q = queue.SchedulingQueue()
        q.add(wr.make_pod("p").obj())
        (info,) = q.pop_batch(1, timeout=0)
        assert led.outstanding() != []
        q.done(info.pod)
        q.done(info.pod)  # the queue's own guard: no second disposition
        assert led.outstanding() == []
        with pytest.raises(ledger.ObligationViolation, match="double-discharge of pod"):
            ledger.discharge("pod", "default/p")
        st = schema.ClusterState(schema.SnapshotBuilder())
        st.add_node(wr.make_node("n0").capacity(cpu_milli=1000).obj())
        c = cache.SchedulerCache(st)
        pod = wr.make_pod("a").req(cpu_milli=10).obj()
        c.assume(pod, "n0")
        assert len(led.outstanding(("assume",))) == 1
        assert c.forget(pod)
        assert led.outstanding(("assume",)) == []
        arb = bs.DispatchArbiter()
        arb.acquire()
        arb.release()
        with pytest.raises(ledger.ObligationViolation, match="slot"):
            arb.release()
        with faults.armed(faults.FaultRegistry(seed=0)):
            assert len(led.outstanding(("fault",))) == 1
        assert led.outstanding() == []
        assert led.double_discharge_total == 2


# -- the slice: queue -> FrameworkRegistry -> solve ---------------------------

def _basic_500(reg, wr, assign, queue_mod, cache_mod):
    """SchedulingBasic, 500 nodes and 500 pod-default pods, one cycle of
    chip_smoke.front_half_sequence (no odd pods, no events)."""
    out = chip_smoke.front_half_sequence(wr, assign, reg, cache_mod.SchedulerCache,
                                         queue_mod.SchedulingQueue, 500, 500,
                                         odd=0, delete=0, new_nodes=0)
    (first, _, _) = out["cycles"]
    assert out["dispatches"] == 1 and out["assumed"] == 500
    return [first[f"fh-{i}"][1] for i in range(500)]


def test_scheduling_basic_500_through_the_front_half():
    """SchedulingBasic/500Nodes' shape, 500 pods: queue -> registry ->
    solve on the port (the wavefront route, warm) equals the reference's
    registry on the same sequence and the host oracle."""
    reg = _port_registry(tconfig.SchedulerConfiguration())
    jreg = jframework.FrameworkRegistry(jconfig.SchedulerConfiguration())
    got = _basic_500(reg, tw, tassign, tqueue, tcache)
    assert None not in got
    assert got == _basic_500(jreg, jw, jassign, jqueue, jcache)
    tpu = reg.default.tpu
    assert tpu.last_solve.meta.route == "wavefront"
    assert tpu.last_encode_rows_per_s > 0
    oracle = Oracle(chip_smoke.make_cluster(tw, 500))
    assert oracle.schedule(chip_smoke.make_pods(tw, 500, "fh")) == got


def test_front_half_sequence_matches_reference():
    """chip_smoke's profiles sequence at a reduced size (200 nodes, 100
    pod-default pods, 4 odd pods of each kind) on both packages: two
    profiles with different weights over one state, the fit failures
    woken by AssignedPodDelete and parked again, every parked pod woken by
    NodeAdd; every cycle's placements and reasons equal, and the port's
    arbiter took one slot a dispatch and holds none."""
    dims = dict(n_nodes=200, n_pods=100, odd=4, delete=4, new_nodes=8)
    reg = _port_registry(tconfig.load_config(chip_smoke.PROFILES_CONFIG))
    jreg = jframework.FrameworkRegistry(jconfig.load_config(chip_smoke.PROFILES_CONFIG))
    got = chip_smoke.front_half_sequence(tw, tassign, reg, tcache.SchedulerCache,
                                         tqueue.SchedulingQueue, **dims)
    want = chip_smoke.front_half_sequence(jw, jassign, jreg, jcache.SchedulerCache,
                                          jqueue.SchedulingQueue, **dims)
    assert got["cycles"] == want["cycles"]
    assert got["moved"] == want["moved"] == {"AssignedPodDelete": 4, "NodeAdd": 8}
    assert got["dispatches"] == want["dispatches"] == reg.arbiter.acquires == 6
    assert reg.arbiter.forced == 0 and reg.arbiter.inflight() == 0
    assert jreg.arbiter.acquires == reg.arbiter.acquires
