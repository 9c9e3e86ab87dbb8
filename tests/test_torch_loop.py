"""The scheduler loop in the port against the reference package's.

kubernetes_tpu_torch/scheduler/scheduler.py's `Scheduler` on the CPU
(`device="cpu"`: the plain versions of every kernel) against
kubernetes_tpu/scheduler/scheduler.py's on the same objects: the API
objects are made alike in both packages' stores, both loops are driven
the same way (informers, `schedule_batch` cycles, bind waves through
`Store.update_wave`, the PostFilter pass), and what they leave in their
stores — every pod's node, the evictions, the claim and volume writes —
is compared exactly.  The store's watch and wave commit are held against
the reference's one-shard `Store` event for event.

The cases copy tests/test_scheduler_loop.py, the loop-driven breaker and
binder tests of tests/test_fault_hardening.py and the loop-driven
preemption tests of tests/test_preemption.py, each run on both packages
in one parametrised test.  The gate is SchedulingBasic 500/500 (500
node-default nodes, 500 pod-default pods) through both loops and
testing/oracle.py.  Every wait is bounded; every test stops its
schedulers and closes its stores in a `finally`.
"""

import time
from types import SimpleNamespace

import pytest

import chip_smoke
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.models import batch_scheduler as jbs
from kubernetes_tpu.scheduler import config as jconfig
from kubernetes_tpu.scheduler import scheduler as jsched
from kubernetes_tpu.testing import faults as jfaults
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.analysis import retrace as tretrace
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.client import informers as tinformers
from kubernetes_tpu.client import informers as jinformers
from kubernetes_tpu_torch.models import batch_scheduler as tbs
from kubernetes_tpu_torch.scheduler import config as tconfig
from kubernetes_tpu_torch.scheduler import scheduler as tsched
from kubernetes_tpu_torch.testing import faults as tfaults
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.oracle import Oracle

PORT = SimpleNamespace(
    name="port", st=tst, api=tapi, w=tw, Scheduler=tsched.Scheduler,
    faults=tfaults, config=tconfig, bs=tbs, informers=tinformers,
    kw={"device": "cpu"}, store_kw={},
)
REF = SimpleNamespace(
    name="reference", st=jst, api=japi, w=jw, Scheduler=jsched.Scheduler,
    faults=jfaults, config=jconfig, bs=jbs, informers=jinformers,
    kw={}, store_kw={"shards": 1},
)
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    tfaults.disarm()
    jfaults.disarm()


def _store(pkg, **kw):
    return pkg.st.Store(**pkg.store_kw, **kw)


def _mk(pkg, store, start=("Node", "Pod"), **kw):
    s = pkg.Scheduler(store, **pkg.kw, **kw)
    for kind in start:
        s.informers.informer(kind).start()
    assert s.informers.wait_for_sync(10)
    return s


def _bound(store):
    return {p.meta.name: p.spec.node_name for p in store.list("Pod")[0]}


def _until(cond, timeout=WAIT_S, step=None):
    """Call step() (if any) until cond() holds or the timeout passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        if step is not None:
            step()
        else:
            time.sleep(0.02)
    return bool(cond())


def _cycle_until_placed(sched, store, name, timeout=WAIT_S):
    placed = [None]

    def done():
        placed[0] = store.get("Pod", name).spec.node_name
        return bool(placed[0])

    _until(done, timeout, lambda: sched.schedule_batch(timeout=0.2))
    return placed[0]


def _on_both(case):
    """Run case(pkg) on the port and on the reference; each stops its own
    schedulers.  Returns both transcripts."""
    return case(PORT), case(REF)


# -- the gate ------------------------------------------------------------------


def _basic_500(pkg):
    store = _store(pkg)
    for node in chip_smoke.make_cluster(pkg.w, 500):
        store.create(node)
    for pod in chip_smoke.make_pods(pkg.w, 500, "gate"):
        store.create(pod)
    sched = _mk(pkg, store)
    try:
        stats = sched.schedule_batch(timeout=2.0)
        assert stats == {"popped": 500, "scheduled": 500, "unschedulable": 0,
                         "bind_errors": 0}, stats
        assert sched.flush_binds(30)
        assert _until(lambda: sched.cache.assumed_count() == 0)
        route = sched.tpu.last_solve.meta.route
        return _bound(store), route, sched.queue.stats()
    finally:
        sched.stop()
        store.close()


def test_scheduling_basic_500_through_the_loop():
    """The gate: SchedulingBasic 500/500 through both loops — informers,
    one cycle, one bind wave through the store, the echo confirming every
    assume — every pod bound on the node where the reference's loop and
    the host oracle place it, on the reference's route."""
    (got, route, queue), (want, jroute, jqueue) = _on_both(_basic_500)
    assert all(got.values()) and len(got) == 500
    assert got == want
    assert route == jroute == "wavefront"
    assert queue == jqueue
    oracle = Oracle(chip_smoke.make_cluster(tw, 500))
    placed = oracle.schedule(chip_smoke.make_pods(tw, 500, "gate"))
    assert {f"gate-{i}": n for i, n in enumerate(placed)} == got


def test_scheduler_without_a_card_raises():
    """Scheduler(store) builds its profiles on the CUDA card and raises
    without one, as TorchBatchScheduler does; an injected CPU scheduler
    brings its device."""
    store = tst.Store()
    if not tbs.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsched.Scheduler(store)
    tpu = tbs.TorchBatchScheduler(device="cpu")
    sched = tsched.Scheduler(store, tpu=tpu)
    try:
        assert sched.tpu is tpu and sched.profiles.default.tpu is tpu
        assert all(f.tpu.device.type == "cpu" for f in sched.profiles)
    finally:
        sched.stop()
        store.close()


def test_retrace_total_counts_kernel_loads_after_the_first_cycle():
    """analysis/retrace.py: 0 before the steady mark and on the CPU (no
    kernel library ever loads); a load after the mark counts."""
    from kubernetes_tpu_torch.kernels import build

    tretrace.reset()
    saved = build.loads_total
    try:
        assert tretrace.total() == 0
        tretrace.mark_steady()
        build.loads_total += 1
        tretrace.mark_steady()  # the first mark wins
        assert tretrace.total() == 1
    finally:
        build.loads_total = saved
        tretrace.reset()


# -- tests/test_scheduler_loop.py on both packages -----------------------------


def _loop_binds_through_api(pkg):
    store = _store(pkg)
    for i in range(4):
        store.create(pkg.w.make_node(f"n{i}")
                     .capacity(cpu_milli=4000, mem=8 * pkg.w.GI, pods=10).obj())
    for i in range(8):
        store.create(pkg.w.make_pod(f"p{i}").req(cpu_milli=500, mem=512 * pkg.w.MI).obj())
    sched = _mk(pkg, store)
    try:
        stats = sched.schedule_batch(timeout=2)
        assert stats["scheduled"] == 8, stats
        assert sched.flush_binds(timeout=30)
        assert all(_bound(store).values())
        assert _until(lambda: sched.cache.assumed_count() == 0)
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _loop_node_add_wakes(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("small").capacity(cpu_milli=500, mem=pkg.w.GI, pods=10).obj())
    store.create(pkg.w.make_pod("big").req(cpu_milli=4000).obj())
    sched = _mk(pkg, store)
    try:
        stats = sched.schedule_batch(timeout=2)
        assert stats["unschedulable"] == 1
        assert sched.queue.stats()["unschedulable"] == 1
        store.create(pkg.w.make_node("big-node")
                     .capacity(cpu_milli=8000, mem=8 * pkg.w.GI, pods=10).obj())
        assert _cycle_until_placed(sched, store, "big") == "big-node"
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _loop_gates(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=4000, mem=8 * pkg.w.GI).obj())
    pod = pkg.w.make_pod("gated").req(cpu_milli=100).obj()
    pod.spec.scheduling_gates = ["wait-for-quota"]
    store.create(pod)
    sched = _mk(pkg, store)
    try:
        stats = sched.schedule_batch(timeout=0.3)
        assert stats["popped"] == 0
        assert sched.queue.stats()["gated"] == 1
        cur = store.get("Pod", "gated")
        cur.spec.scheduling_gates = []
        store.update(cur)
        assert _cycle_until_placed(sched, store, "gated") == "n0"
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _loop_delete_frees(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=1000, mem=8 * pkg.w.GI, pods=10).obj())
    store.create(pkg.w.make_pod("first").req(cpu_milli=1000).obj())
    sched = _mk(pkg, store)
    try:
        assert sched.schedule_batch(timeout=2)["scheduled"] == 1
        assert sched.flush_binds(timeout=30)
        store.create(pkg.w.make_pod("second").req(cpu_milli=1000).obj())
        stats = sched.schedule_batch(timeout=2)
        assert stats["unschedulable"] == 1
        store.delete("Pod", "first")
        assert _cycle_until_placed(sched, store, "second") == "n0"
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _loop_priority(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=1000, mem=8 * pkg.w.GI, pods=10).obj())
    store.create(pkg.w.make_pod("low").req(cpu_milli=1000).priority(1).obj())
    store.create(pkg.w.make_pod("high").req(cpu_milli=1000).priority(100).obj())
    sched = _mk(pkg, store)
    try:
        stats = sched.schedule_batch(timeout=2)
        assert sched.flush_binds(timeout=30)
        assert store.get("Pod", "high").spec.node_name == "n0"
        assert not store.get("Pod", "low").spec.node_name
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _loop_backoff(pkg):
    from importlib import import_module

    queue_mod = import_module(pkg.Scheduler.__module__.rsplit(".", 1)[0] + ".queue")
    now = [0.0]
    q = queue_mod.SchedulingQueue(backoff_base=1.0, backoff_max=10.0,
                                  unschedulable_flush_after=300.0, clock=lambda: now[0])
    q.add(pkg.w.make_pod("x").req(cpu_milli=1).obj())
    trace = []
    (info,) = q.pop_batch(10, timeout=0)
    q.requeue_backoff(info)
    trace.append(len(q.pop_batch(10, timeout=0)))
    now[0] = 1.1
    (info,) = q.pop_batch(10, timeout=0)
    q.add_unschedulable(info)
    for t in (200.0, 302.0):
        now[0] = t
        trace.append(len(q.pop_batch(10, timeout=0)))
    now[0] = 304.2
    (info,) = q.pop_batch(10, timeout=0)
    assert trace == [0, 0, 0]
    assert info.attempts == 3
    return trace, info.attempts


LOOP_CASES = {
    "schedules_and_binds_through_api": _loop_binds_through_api,
    "unschedulable_requeues_on_node_add_then_places": _loop_node_add_wakes,
    "scheduling_gates_hold_until_cleared": _loop_gates,
    "deleted_assigned_pod_frees_resources_for_pending": _loop_delete_frees,
    "priority_order_in_contended_batch": _loop_priority,
    "queue_backoff_and_flush": _loop_backoff,
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_scheduler_loop_matches_reference(case):
    """tests/test_scheduler_loop.py's six cases, each on both packages:
    its assertions hold on both, and the cycle's counters and the final
    placements in the store are equal."""
    got, want = _on_both(LOOP_CASES[case])
    assert got == want


# -- the breaker and the binder (tests/test_fault_hardening.py) ----------------


def _cluster(pkg, store, nodes=2, cpu=4000):
    for i in range(nodes):
        store.create(pkg.w.make_node(f"n{i}")
                     .capacity(cpu_milli=cpu, mem=8 * pkg.w.GI, pods=50).obj())


def _pods(pkg, store, n, prefix="p"):
    for i in range(n):
        store.create(pkg.w.make_pod(f"{prefix}{i}").req(cpu_milli=100).obj())


def _breaker_trips(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    _pods(pkg, store, 4)
    sched = _mk(pkg, store)
    reg = pkg.faults.FaultRegistry().fail("batch.solve", n=-1)
    try:
        with pkg.faults.armed(reg):
            stats = sched.schedule_batch(timeout=2)
            assert stats["scheduled"] == 4
            assert sched.flush_binds(30)
        br = sched.tpu.breaker
        assert br.state == pkg.bs.SolveCircuitBreaker.OPEN and br.fallbacks >= 1
        assert reg.fired["batch.solve"] == 2
        assert all(_bound(store).values())
        assert sched.metrics.solve_breaker_state.get() == 2.0
        assert sched.metrics.solve_fallback_total.get() >= 1.0
        return stats, _bound(store), br.state, reg.fired["batch.solve"]
    finally:
        sched.stop()
        store.close()


def _breaker_open_keeps_scheduling(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    sched = _mk(pkg, store)
    sched.tpu.breaker.record_failure()
    sched.tpu.breaker.cooldown = 3600.0
    try:
        store.create(pkg.w.make_pod("q0").req(cpu_milli=100).obj())
        stats = sched.schedule_batch(timeout=2)
        assert stats["scheduled"] == 1
        assert sched.flush_binds(30)
        assert store.get("Pod", "q0").spec.node_name
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _breaker_nonfinite(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    _pods(pkg, store, 2)
    sched = _mk(pkg, store)
    reg = pkg.faults.FaultRegistry().corrupt("batch.solve", n=-1)
    try:
        with pkg.faults.armed(reg):
            stats = sched.schedule_batch(timeout=2)
            assert stats["scheduled"] == 2
            assert sched.flush_binds(30)
        br = sched.tpu.breaker
        assert br.state == pkg.bs.SolveCircuitBreaker.OPEN and br.fallbacks >= 1
        return stats, _bound(store), br.state
    finally:
        sched.stop()
        store.close()


def _breaker_half_open(pkg):
    now = [0.0]
    br = pkg.bs.SolveCircuitBreaker(cooldown=5.0, clock=lambda: now[0])
    trace = [br.allow_device()]
    br.record_failure()
    trace += [br.state, br.allow_device()]
    now[0] = 6.0
    trace += [br.allow_device(), br.state, br.allow_device()]
    br.record_success()
    trace.append(br.state)
    br.record_failure()
    now[0] = 12.0
    trace.append(br.allow_device())
    br.record_failure()
    trace += [br.state, br.allow_device()]
    assert trace[-2] == br.OPEN and not trace[-1]
    return trace


def _fallback_parity(pkg):
    w = pkg.w
    nodes = [w.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20)
             .zone(f"z{i % 2}").label("disk", "ssd" if i % 2 else "hdd").obj()
             for i in range(6)]

    def pods():
        out = []
        for i in range(12):
            p = w.make_pod(f"p{i}").req(cpu_milli=200 + 50 * (i % 3), mem=w.GI)
            if i % 4 == 0:
                p = p.label("app", "web").pod_anti_affinity({"app": "web"})
            if i % 3 == 0:
                p = p.node_selector(disk="ssd")
            out.append(p.obj())
        return out

    make = pkg.bs.TorchBatchScheduler if pkg is PORT else pkg.bs.TPUBatchScheduler
    device = make(**pkg.kw)
    for n in nodes:
        device.add_node(n)
    want = device.schedule_pending(pods())
    host = make(**pkg.kw)
    for n in nodes:
        host.add_node(n)
    host.breaker.record_failure()
    host.breaker.cooldown = 3600.0
    got = host.schedule_pending(pods())
    assert host.breaker.fallbacks >= 1
    assert got == want
    return got


def _binder_watchdog(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    _pods(pkg, store, 3)
    sched = _mk(pkg, store, config=pkg.config.SchedulerConfiguration(stream_subwaves=False))
    reg = pkg.faults.FaultRegistry().crash("binder.commit_wave", n=1)
    try:
        with pkg.faults.armed(reg):
            stats = sched.schedule_batch(timeout=2)
            assert stats["scheduled"] == 3
            assert sched.flush_binds(30)
        assert sched.metrics.binder_restarts.total >= 1
        assert all(_bound(store).values())
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def _poison_wave(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    _pods(pkg, store, 3)
    sched = _mk(pkg, store, config=pkg.config.SchedulerConfiguration(stream_subwaves=False))
    reg = pkg.faults.FaultRegistry().fail("binder.commit_wave", n=3)
    try:
        with pkg.faults.armed(reg):
            sched.schedule_batch(timeout=2)
            assert sched.flush_binds(30)
            first = sorted(k for k, v in _bound(store).items() if v)
            assert len(first) == 2
            assert sched.queue.stats()["backoff"] == 1
            assert sched.metrics.binder_poison_waves.total == 1

            def step():
                sched.schedule_batch(timeout=0.3)
                sched.flush_binds(10)

            assert _until(lambda: all(_bound(store).values()), step=step)
        return first, _bound(store)
    finally:
        sched.stop()
        store.close()


BREAKER_CASES = {
    "breaker_trips_after_retry_and_falls_back_to_host": _breaker_trips,
    "tripped_breaker_keeps_scheduling_throughput": _breaker_open_keeps_scheduling,
    "nonfinite_scores_trip_breaker_via_health_check": _breaker_nonfinite,
    "breaker_half_open_probe_recovers": _breaker_half_open,
    "fallback_parity_with_device_solve": _fallback_parity,
    "binder_watchdog_restarts_crashed_worker_and_recommits": _binder_watchdog,
    "poison_pod_in_split_requeues_with_backoff": _poison_wave,
}


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_breaker_and_binder_match_reference(case):
    """The loop-driven breaker cases of tests/test_fault_hardening.py and
    its binder supervision cases, each under one FaultRegistry schedule on
    both packages: the placements, the breaker's state and the faults
    fired are equal."""
    got, want = _on_both(BREAKER_CASES[case])
    assert got == want


def _reconcile(pkg):
    store = _store(pkg)
    _cluster(pkg, store)
    _pods(pkg, store, 3)
    sched = _mk(pkg, store)
    try:
        # the breaker opened under a predecessor's device, and a pod was
        # assumed but never committed
        sched.tpu.breaker.record_failure()
        sched.tpu.breaker.cooldown = 3600.0
        popped = sched.queue.pop_batch(1, timeout=1.0)
        sched.cache.assume(popped[0].pod, "n0")
        mirror = sched.tpu._mirror
        sched._reconcile_leadership()
        state = sched.tpu.breaker.state
        assert state == sched.tpu.breaker.CLOSED
        assert not sched.cache.is_assumed(popped[0].pod)
        assert mirror.epoch() is None
        assert sched.metrics.leader_reconcile_total.total == 1.0
        return state, sched.queue.stats()
    finally:
        sched.stop()
        store.close()


def test_reconcile_leadership_resets_the_breaker():
    """_reconcile_leadership: the breaker back to closed, the mirror
    invalidated, an uncommitted assume forgotten and its pod re-queued —
    on both packages alike."""
    got, want = _on_both(_reconcile)
    assert got == want


# -- the PostFilter pass through the loop (tests/test_preemption.py) -----------


def _bound_low(pkg, store, name, cpu, prio, node, labels=None):
    w = pkg.w.make_pod(name).req(cpu_milli=cpu).priority(prio).node_name(node)
    if labels:
        w = w.labels(**labels)
    p = w.obj()
    p.status.phase = "Running"
    store.create(p)


def _survivors(store):
    return sorted(p.meta.name for p in store.list("Pod")[0])


def _pre_end_to_end(pkg):
    store = _store(pkg)
    for n in ("n0", "n1"):
        store.create(pkg.w.make_node(n).capacity(cpu_milli=2000, pods=10).obj())
    for i, node in [(0, "n0"), (1, "n0"), (2, "n1"), (3, "n1")]:
        _bound_low(pkg, store, f"low-{i}", 1000, i, node)
    sched = _mk(pkg, store)
    try:
        store.create(pkg.w.make_pod("hi").req(cpu_milli=1000).priority(100).obj())
        assert _cycle_until_placed(sched, store, "hi") == "n0"
        assert sched.metrics.preemption_attempts.get("nominated") >= 1
        assert sched.metrics.preemption_victims.n >= 1
        return _bound(store), _survivors(store)
    finally:
        sched.stop()
        store.close()


def _pre_feasible_elsewhere(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=1000, pods=10).obj())
    store.create(pkg.w.make_node("n1").capacity(cpu_milli=2000, pods=10).obj())
    store.create(pkg.w.make_pod("low").req(cpu_milli=1000).priority(0).node_name("n0").obj())
    sched = _mk(pkg, store)
    try:
        store.create(pkg.w.make_pod("hi").req(cpu_milli=1000).priority(100).obj())
        assert _cycle_until_placed(sched, store, "hi") == "n1"
        assert sched.metrics.preemption_attempts.get("attempted") == 0
        return _bound(store), _survivors(store)
    finally:
        sched.stop()
        store.close()


def _pre_pdb(pkg):
    api = pkg.api
    store = _store(pkg)
    for n in ("n0", "n1"):
        store.create(pkg.w.make_node(n).capacity(cpu_milli=2000, pods=10).obj())
    _bound_low(pkg, store, "guarded", 2000, 1, "n0", {"app": "db"})
    _bound_low(pkg, store, "free", 2000, 1, "n1", {"app": "web"})
    pdb = api.PodDisruptionBudget(
        meta=api.ObjectMeta(name="db-pdb", namespace="default"),
        spec=api.PodDisruptionBudgetSpec(
            selector=api.LabelSelector(match_labels={"app": "db"})),
    )
    pdb.status.disruptions_allowed = 0
    store.create(pdb)
    sched = _mk(pkg, store)
    try:
        store.create(pkg.w.make_pod("hi").req(cpu_milli=1500).priority(100).obj())
        assert _cycle_until_placed(sched, store, "hi") == "n1"
        assert "guarded" in _survivors(store) and "free" not in _survivors(store)
        return _bound(store), _survivors(store)
    finally:
        sched.stop()
        store.close()


def _pre_batched_pass(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=2000, pods=10).obj())
    for i in range(2):
        _bound_low(pkg, store, f"low-{i}", 1000, i, "n0")
    sched = _mk(pkg, store)
    try:
        store.create(pkg.w.make_pod("hi").req(cpu_milli=1500).priority(100).obj())
        assert _cycle_until_placed(sched, store, "hi") == "n0"
        assert sched.metrics.preemption_batch_size.n >= 1
        assert sched.metrics.preemption_solve_duration.n >= 1
        return _bound(store), _survivors(store)
    finally:
        sched.stop()
        store.close()


def _pre_overload_level1(pkg):
    store = _store(pkg)
    store.create(pkg.w.make_node("n0").capacity(cpu_milli=2000, pods=10).obj())
    _bound_low(pkg, store, "low", 2000, 0, "n0")
    sched = _mk(pkg, store)
    try:
        for _ in range(10):
            sched.overload.note_cycle(2 * sched.overload.slo * 0.9)
        assert sched.overload.level() == 1
        store.create(pkg.w.make_pod("hi").req(cpu_milli=1500).priority(100).obj())
        assert _cycle_until_placed(sched, store, "hi") == "n0"
        assert sched.metrics.preemption_attempts.get("nominated") >= 1
        return _bound(store), _survivors(store)
    finally:
        sched.stop()
        store.close()


def _pre_gang(pkg):
    store = _store(pkg)
    for i in range(2):
        store.create(pkg.w.make_node(f"n{i}").capacity(cpu_milli=2000, pods=10).obj())
        _bound_low(pkg, store, f"low-{i}", 2000, 0, f"n{i}")
    sched = _mk(pkg, store)
    try:
        for i in range(2):
            store.create(pkg.w.make_pod(f"g{i}").req(cpu_milli=2000).priority(100)
                         .group("band", size=2).obj())

        def both_placed():
            b = _bound(store)
            return bool(b.get("g0") and b.get("g1"))

        assert _until(both_placed, step=lambda: sched.schedule_batch(timeout=0.2))
        got = _bound(store)
        assert sorted([got["g0"], got["g1"]]) == ["n0", "n1"]
        assert _survivors(store) == ["g0", "g1"]
        return got, _survivors(store)
    finally:
        sched.stop()
        store.close()


PREEMPTION_CASES = {
    "preemption_end_to_end": _pre_end_to_end,
    "preemption_not_triggered_when_feasible_elsewhere": _pre_feasible_elsewhere,
    "pdb_steers_victim_choice_end_to_end": _pre_pdb,
    "scheduler_postfilter_uses_batched_pass": _pre_batched_pass,
    "overload_level1_caps_instead_of_deferring": _pre_overload_level1,
    "gang_preemption_evicts_across_nodes": _pre_gang,
}


@pytest.mark.parametrize("case", sorted(PREEMPTION_CASES))
def test_loop_preemption_matches_reference(case):
    """tests/test_preemption.py's loop-driven cases on both packages: the
    preemptors' nodes and the pods left in the store (the evictions) are
    equal."""
    got, want = _on_both(PREEMPTION_CASES[case])
    assert got == want


# -- claims and volumes through the loop ---------------------------------------


def _volume_case(pkg):
    w, api = pkg.w, pkg.api
    store = _store(pkg)
    for zi, z in enumerate(("z1", "z2", "z3")):
        for i in range(2):
            store.create(w.make_node(f"n-{z}-{i}")
                         .capacity(cpu_milli=8000, mem=16 * w.GI, pods=32).zone(z).obj())
    # a bound claim pins its pod to the volume's zone
    pv = w.make_pv("pv-z2", 10 * w.GI, "manual", zone="z2")
    pv.spec.claim_ref = "default/bound"
    pv.status.phase = api.PV_BOUND
    store.create(pv)
    pvc = w.make_pvc("bound", 5 * w.GI, "manual")
    pvc.spec.volume_name = "pv-z2"
    pvc.status.phase = api.PVC_BOUND
    store.create(pvc)
    # an unbound claim binds the smallest sufficient volume at PreBind
    for name, size in (("pv-big", 100), ("pv-small", 10), ("pv-tiny", 1)):
        store.create(w.make_pv(name, size * w.GI, "manual", zone="z1"))
    store.create(w.make_pvc("unbound", 5 * w.GI, "manual"))
    store.create(w.make_pod("p-bound").req(cpu_milli=100, mem=w.MI).pvc("bound").obj())
    store.create(w.make_pod("p-unbound").req(cpu_milli=100, mem=w.MI).pvc("unbound").obj())
    store.create(w.make_pod("p-plain").req(cpu_milli=100, mem=w.MI).obj())
    sched = _mk(pkg, store, start=(), batch_size=32)
    sched.start()
    try:
        assert _until(lambda: all(_bound(store).values()))
        got = _bound(store)
        assert got["p-bound"].startswith("n-z2-") and got["p-unbound"].startswith("n-z1-")
        claim = store.get("PersistentVolumeClaim", "unbound", "default")
        vol = store.get("PersistentVolume", "pv-small")
        assert claim.spec.volume_name == "pv-small" and vol.spec.claim_ref == "default/unbound"
        return got, (claim.spec.volume_name, claim.status.phase,
                     vol.spec.claim_ref, vol.status.phase)
    finally:
        sched.stop()
        store.close()


def _claim_case(pkg):
    w, api = pkg.w, pkg.api
    store = _store(pkg)
    for i in range(3):
        store.create(w.make_node(f"n{i}").capacity(
            cpu_milli=8000, mem=16 * w.GI, pods=32,
            **{api.device_resource("gpu"): 2}).obj())
    store.create(api.DeviceClass(meta=api.ObjectMeta(name="gpu")))
    for name, count in (("shared", 2), ("solo", 1)):
        store.create(api.ResourceClaim(
            meta=api.ObjectMeta(name=name),
            spec=api.ResourceClaimSpec(device_class_name="gpu", count=count)))
    a = w.make_pod("a").req(cpu_milli=100, mem=w.MI).obj()
    a.spec.resource_claims = ["shared"]
    store.create(a)
    sched = _mk(pkg, store, start=(), batch_size=32)
    sched.start()
    try:
        assert _until(lambda: bool(store.get("Pod", "a").spec.node_name))
        # a consumer of the bound (allocated) claim lands beside it
        b = w.make_pod("b").req(cpu_milli=100, mem=w.MI).obj()
        b.spec.resource_claims = ["shared"]
        store.create(b)
        c = w.make_pod("c").req(cpu_milli=100, mem=w.MI).obj()
        c.spec.resource_claims = ["solo"]
        store.create(c)
        assert _until(lambda: all(_bound(store).values()))
        got = _bound(store)
        assert got["b"] == got["a"]
        claims = {cl.meta.name: (cl.status.phase, cl.status.allocated_node, cl.status.carrier)
                  for cl in store.list("ResourceClaim")[0]}
        assert claims["shared"] == ("Allocated", got["a"], "default/a")
        return got, claims
    finally:
        sched.stop()
        store.close()


@pytest.mark.parametrize("case", ["volume", "claim"])
def test_claims_and_volumes_through_the_loop(case):
    """A bound and an unbound volume claim, and a shared and a solo
    resource claim, through both loops started with every informer: the
    pods' nodes and the claim and volume writes of PreBind are equal (the
    encode's pod transform folds the claims into the pod's requirements,
    and the columnar store keys them by the transformed spec)."""
    fn = {"volume": _volume_case, "claim": _claim_case}[case]
    got, want = _on_both(fn)
    assert got == want


# -- the store's watch and wave commit against the reference -------------------


def _events(w, store, timeout=0.05):
    store.close()  # drains the fan-out backlog into the watchers
    out = []
    while True:
        ev = w.get(timeout=timeout)
        if ev is None:
            return out
        out.append((ev.type, ev.kind, ev.obj.meta.name, ev.rv, ev.obj.spec.node_name))


def _store_sequence(pkg, capacity=64):
    """Writes against a watcher that does not consume: coalescing of
    MODIFIED runs, ADDED+DELETED annihilation, DELETED after MODIFIED,
    delete + recreate, then the events it holds."""
    w_ = pkg.w
    store = _store(pkg, watch_capacity=capacity)
    store.create(w_.make_pod("before").obj())
    w = store.watch("Pod", from_rv=0)
    try:
        for name in ("a", "b", "c", "d"):
            store.create(w_.make_pod(name).obj())
        for node in ("n1", "n2", "n3"):           # a MODIFIED run on a
            cur = store.get("Pod", "a")
            cur.spec.node_name = node
            store.update(cur)
        store.delete("Pod", "b")                  # ADDED+DELETED: gone
        cur = store.get("Pod", "before")
        cur.spec.node_name = "n9"
        store.update(cur)
        store.delete("Pod", "before")             # MODIFIED -> DELETED
        store.delete("Pod", "c")
        store.create(w_.make_pod("c").obj())      # recreate
        evs = _events(w, store)
        stats = store.watch_stats()
        return evs, stats["watch_coalesced_total"], store.resource_version
    finally:
        w.stop()


def test_watch_coalesces_and_annihilates_like_the_reference():
    got, want = _on_both(_store_sequence)
    assert got == want
    names = [e[2] for e in got[0]]
    assert "b" not in names                       # annihilated
    assert [e[0] for e in got[0] if e[2] == "a"] == ["ADDED"]
    assert [e[4] for e in got[0] if e[2] == "a"] == ["n3"]  # latest wins
    rvs = [e[3] for e in got[0]]
    assert rvs == sorted(rvs)                     # resourceVersion order


def _store_expired(pkg):
    w_ = pkg.w
    store = _store(pkg, watch_capacity=2, buffer_size=8)
    out = []
    w = store.watch("Pod")
    try:
        for i in range(3):                        # 3 distinct objects > 2
            store.create(w_.make_pod(f"x{i}").obj())
        store.close()
        out.append((w.expired, w.stopped, w.expired_rv))
        with pytest.raises(pkg.st.Expired):
            next(iter(w))
        out.append(store.watch_stats()["watch_expired_total"])
        for i in range(12):                       # roll the ring past rv 1
            store.create(w_.make_pod(f"y{i}").obj())
        with pytest.raises(pkg.st.Expired):
            store.watch("Pod", from_rv=1)
        return out
    finally:
        w.stop()


def test_watch_expires_past_its_capacity_like_the_reference():
    got, want = _on_both(_store_expired)
    assert got == want
    assert got[0][0] and got[1] == 1


def _informer_relist(pkg):
    """An informer whose watch expires (an injected watch.offer drop)
    relists and recovers every object, its handlers seeing each once."""
    w_ = pkg.w
    store = _store(pkg)
    for i in range(2):
        store.create(w_.make_pod(f"a{i}").obj())
    inf = pkg.informers.SharedInformer(store, "Pod")
    seen = []
    inf.add_handler(lambda typ, obj, old: seen.append((typ, obj.meta.name)))
    inf.start()
    try:
        assert inf.wait_for_sync(10)
        reg = pkg.faults.FaultRegistry().drop("watch.offer", n=1)
        with pkg.faults.armed(reg):
            store.create(w_.make_pod("x").obj())
            assert _until(lambda: inf.relists >= 2 and inf.get("x") is not None)
        store.create(w_.make_pod("y").obj())
        assert _until(lambda: inf.get("y") is not None)
        return seen, inf.relists, store.watch_stats()["watch_expired_total"], \
            sorted(p.meta.name for p in inf.list())
    finally:
        inf.stop()
        store.close()


def test_informer_relists_after_expired_like_the_reference():
    got, want = _on_both(_informer_relist)
    assert got == want
    assert got[1] == 2 and got[2] == 1
    assert got[0] == [("ADDED", "a0"), ("ADDED", "a1"), ("ADDED", "x"), ("ADDED", "y")]


def _store_wave(pkg):
    w_ = pkg.w
    store = _store(pkg)
    for name in ("p0", "p1", "p2"):
        store.create(w_.make_pod(name).obj())
    store.create(pkg.api.Lease(meta=pkg.api.ObjectMeta(name="sched", namespace="kube-system"),
                               spec=pkg.api.LeaseSpec(holder_identity="me", lease_transitions=3)))
    w = store.watch("Pod")
    try:
        def bind(node):
            def mutate(pod):
                if pod.meta.name == "p1":
                    raise pkg.st.Conflict("p1 refuses")
                pod.spec.node_name = node
            return mutate

        good = pkg.st.FenceToken("sched", "kube-system", "me", 3)
        applied, errs = store.update_wave(
            "Pod", [("p0", "default", bind("n0")), ("p1", "default", bind("n1")),
                    ("ghost", "default", bind("n2")), ("p2", "default", bind("n3"))],
            fence=good)
        stale = pkg.st.FenceToken("sched", "kube-system", "me", 2)
        with pytest.raises(pkg.st.Fenced):
            store.update_wave("Pod", [("p1", "default", lambda p: None)], fence=stale)
        other = pkg.st.FenceToken("sched", "kube-system", "you", None)
        with pytest.raises(pkg.st.Fenced):
            store.update_wave("Pod", [("p1", "default", lambda p: None)], fence=other)
        # update(copy_result=False) hands back the committed object
        cur = store.get("Pod", "p1")
        cur.spec.node_name = "n5"
        committed = store.update(cur, copy_result=False)
        return (applied, {k: type(e).__name__ for k, e in errs.items()},
                store.fenced_writes_total, committed.spec.node_name,
                _bound(store), _events(w, store))
    finally:
        w.stop()


def test_update_wave_splits_errors_and_fences_like_the_reference():
    got, want = _on_both(_store_wave)
    assert got == want
    applied, errs, fenced = got[:3]
    assert applied == ["default/p0", "default/p2"]
    assert errs == {"default/p1": "Conflict", "default/ghost": "NotFound"}
    assert fenced == 2


# -- the card script's loop sequences, at a reduced size -----------------------


def _ref_store():
    return jst.Store(shards=1)


def test_loop_phase_basic_sequence_matches_reference():
    """chip_smoke.loop_basic_sequence (the card script's `loop` phase,
    step A) at 200 nodes and two batches of 100 pods on both packages:
    the popped batches, every pod's node in the store, the routes and the
    cycles' counters equal; every pod bound, no assume left, the breaker
    closed."""
    got = chip_smoke.loop_basic_sequence(tw, tst.Store, tsched.Scheduler, 200, 100, 100,
                                         device="cpu")
    want = chip_smoke.loop_basic_sequence(jw, _ref_store, jsched.Scheduler, 200, 100, 100)
    for key in ("placed", "popped", "assumed", "breaker_state", "fallback_total", "queue"):
        assert got[key] == want[key], key
    for side in ("init", "measured"):
        assert [(c["stats"], c["route"]) for c in got[side]] == \
            [(c["stats"], c["route"]) for c in want[side]]
    assert all(got["placed"].values()) and got["assumed"] == 0
    assert got["commit_wave_s"]["n"] == 2 and got["commit_subwave_s"]["n"] == 2
    assert [[n for n in b] for b in got["popped"]] == \
        [[f"init-{i}" for i in range(100)], [f"measured-{i}" for i in range(100)]]


def test_loop_phase_preemption_sequence_matches_reference():
    """chip_smoke.loop_preemption_sequence (step B) at 50 nodes, 200
    victims bound four a node and 4 preemptors on both packages: every
    preemptor bound on the same node, the same three victims a preemptor
    evicted."""
    got = chip_smoke.loop_preemption_sequence(tw, tst.Store, tsched.Scheduler, (50, 200, 4),
                                              10, device="cpu")
    want = chip_smoke.loop_preemption_sequence(jw, _ref_store, jsched.Scheduler,
                                               (50, 200, 4), 10)
    assert got["nodes"] == want["nodes"] and all(got["nodes"].values())
    assert got["evicted"] == want["evicted"] and len(got["evicted"]) == 12
    assert got["passes"] >= 1 and got["breaker_state"] == 0.0


# -- speculation and lanes (tests/test_multilane_pipeline.py) -------------------


def _small_pod(pkg, name, cls=None):
    pod = pkg.w.make_pod(name).req(cpu_milli=50, mem=pkg.w.GI // 8).obj()
    if cls is not None:
        pod.spec.scheduler_name = cls
    return pod


def _lone_node(pkg, store, profiles=None, **cfg_kw):
    cfg = pkg.config.SchedulerConfiguration(
        pod_initial_backoff_seconds=0.02, pod_max_backoff_seconds=0.1,
        batch_window_seconds=0.0, adaptive_batch_window=False, **cfg_kw)
    if profiles:
        cfg.profiles = [pkg.config.ProfileConfig(scheduler_name=n) for n in profiles]
    sched = pkg.Scheduler(store, config=cfg, **pkg.kw)
    node = pkg.w.make_node("n1").capacity(cpu_milli=64000, mem=64 * pkg.w.GI, pods=110).obj()
    store.create(node)
    sched.cache.add_node(node)
    return sched


def _speculation(pkg, fail: bool, profiles=None):
    store = _store(pkg)
    sched = _lone_node(pkg, store, profiles)
    arb = sched.profiles.arbiter
    try:
        for i in range(2):
            pod = _small_pod(pkg, f"p{i}")
            store.create(pod)
            sched.queue.add(pod)
        sched._waves_in_flight = lambda: True  # a wave is "committing"
        cycle = sched._dispatch_batch(sched.queue.pop_batch(4, timeout=0))
        assert cycle.spec_token is not None
        assert sched.metrics.speculative_solves_total.total == 1.0
        if fail:
            sched._note_commit_failure()  # the wave failed before the harvest
        stats = sched._finish_cycle(cycle)
        record = [stats, sched.metrics.misspeculation_total.total]
        if arb is not None:
            # the misspeculated solve gave its dispatch slot back undecoded
            record.append((arb.acquires, arb.inflight()))
            assert arb.inflight() == 0
        if fail:
            # nothing is in flight here: the failed wave requeued the batch
            assert stats["scheduled"] == 0 and sched.cache.assumed_count() == 0
            time.sleep(0.15)
            sched._waves_in_flight = lambda: False
            record.append(sched.schedule_batch(timeout=0))
        else:
            # the staged wave commits on the binder's thread, so the store
            # may show none, one or both binds yet; whichever way that race
            # goes, both pods stay assumed (no informer echo runs here to
            # confirm them) and a bound pod is bound on n1
            assert sched.cache.assumed_count() == 2
            assert set(_bound(store).values()) <= {"", "n1"}
        assert sched.flush_binds(10)
        # sampled with every wave committed: nothing in flight either way
        record += [sched.cache.assumed_count(), sched.queue.stats()]
        assert record[-1]["inflight"] == 0
        assert all(n == "n1" for n in _bound(store).values())
        return record, _bound(store)
    finally:
        sched.stop()
        store.close()


def _gate_off(pkg):
    store = _store(pkg)
    sched = _lone_node(pkg, store, speculative_solve=False)
    try:
        assert not sched._speculation_enabled
        for i in range(4):
            pod = _small_pod(pkg, f"p{i}")
            store.create(pod)
            sched.queue.add(pod)
        stats = sched.schedule_batch(timeout=0)
        assert stats["scheduled"] == 4
        assert sched.metrics.speculative_solves_total.total == 0.0
        assert sched.flush_binds(10)
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


SPECULATION_CASES = {
    "speculative_batch_invalidated_by_commit_failure": lambda pkg: _speculation(pkg, True),
    "speculation_holds_on_healthy_commits": lambda pkg: _speculation(pkg, False),
    "misspeculation_releases_the_arbiter_slot":
        lambda pkg: _speculation(pkg, True, ["default-scheduler", "batch-scheduler"]),
    "speculative_solve_gate_off_serializes": _gate_off,
}


@pytest.mark.parametrize("case", sorted(SPECULATION_CASES))
def test_speculation_matches_reference(case):
    """tests/test_multilane_pipeline.py's speculation cases on both
    packages: a batch dispatched over an in-flight wave is requeued whole
    when the wave fails (its solve dropped undecoded, its arbiter slot
    given back, nothing assumed) and staged when it holds."""
    got, want = _on_both(SPECULATION_CASES[case])
    assert got == want


def _two_lanes(pkg):
    store = _store(pkg)
    cfg = pkg.config.SchedulerConfiguration(
        profiles=[pkg.config.ProfileConfig(),
                  pkg.config.ProfileConfig(scheduler_name="batch-scheduler")],
        pod_initial_backoff_seconds=0.05, pod_max_backoff_seconds=0.4,
        batch_window_seconds=0.01)
    sched = pkg.Scheduler(store, config=cfg, **pkg.kw)
    assert len(sched._lane_profiles) == 2 and sched.profiles.arbiter is not None
    # the lanes encode under the cache lock: no two residents' syncs of the
    # one shared ClusterState overlap
    active, peak = [0], [0]

    def guarded(sync):
        def run(*a, **k):
            with sched.cache.lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            try:
                return sync(*a, **k)
            finally:
                with sched.cache.lock:
                    active[0] -= 1
        return run

    for fwk in sched.profiles:
        fwk.tpu._mirror.sync = guarded(fwk.tpu._mirror.sync)
    for i in range(3):
        store.create(pkg.w.make_node(f"n{i}").capacity(
            cpu_milli=8000, mem=16 * pkg.w.GI, pods=110).obj())
    try:
        sched.start()
        for i in range(12):
            store.create(_small_pod(pkg, f"d-{i}"))
            store.create(_small_pod(pkg, f"b-{i}", cls="batch-scheduler"))
        assert _until(lambda: len(_bound(store)) == 24 and all(_bound(store).values()),
                      timeout=30)
        assert sched.flush_binds(10)
        assert peak[0] == 1
        arb = sched.profiles.arbiter
        assert arb.inflight() == 0 and arb.forced == 0
        return sorted(_bound(store)), peak[0]
    finally:
        sched.stop()
        store.close()


def test_two_profile_lanes_match_reference():
    """Two profiles run as two concurrent lanes sharing one device
    through the dispatch arbiter, on both packages: every pod of both
    classes binds, no two residents' syncs overlap (the encode holds the
    cache lock), the arbiter forced nothing and holds nothing."""
    got, want = _on_both(_two_lanes)
    assert got == want


def _warmup(pkg):
    store = _store(pkg)
    for node in chip_smoke.make_cluster(pkg.w, 50):
        store.create(node)
    sched = _mk(pkg, store)
    try:
        templates = chip_smoke.make_pods(pkg.w, 40, "tmpl")
        spread = [pkg.w.make_pod(f"sp-{i}").req(cpu_milli=100).labels(app="s")
                  .spread(1, pkg.api.LABEL_ZONE, selector={"app": "s"}).obj() for i in range(8)]
        before = sched.tpu.state.requested.copy()
        assert sched.warmup(templates, max_batch=40) > 0.0
        assert sched.warmup(spread) > 0.0  # the bound round: one clone assumed, forgotten
        assert sched.cache.assumed_count() == 0
        assert (sched.tpu.state.requested == before).all()
        assert sched.queue.stats()["active"] == 0
        store.create(templates[0])
        stats = sched.schedule_batch(timeout=2)
        assert sched.flush_binds(10)
        return stats, _bound(store)
    finally:
        sched.stop()
        store.close()


def test_warmup_runs_the_buckets_and_assumes_nothing():
    """Scheduler.warmup on both packages: every pod bucket up to the
    first full batch encoded and solved (the port one bucket after
    another), the bound round's clone assumed and forgotten, nothing left
    assumed or accounted; a later cycle places as the reference's."""
    got, want = _on_both(_warmup)
    assert got == want
