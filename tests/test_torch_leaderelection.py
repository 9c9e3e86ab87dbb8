"""Lease-based leader election in the port against the reference package's.

kubernetes_tpu_torch/client/leaderelection.py's `LeaderElector` over the
port's `Store` and `Lease`, against kubernetes_tpu/client/leaderelection.py
over the reference's: tests/test_durability_leaderelection.py's seven
election cases and tests/test_restart_recovery.py's two fencing cases, each
run on both packages in one test and the outcomes compared (the port's schedulers on
`device="cpu"`; the reference's store with one shard, the port has no
journal); one exact case that drives both electors by hand on one injected
clock and compares the stored Lease and the fence token after every step;
and chip_smoke.leader_sequence — the card's `leader` phase — at a reduced
size on both packages.  Every wait is bounded; every test stops its
electors and schedulers in a `finally`.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import chip_smoke
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.client import leaderelection as jle
from kubernetes_tpu.scheduler import scheduler as jsched
from kubernetes_tpu.scheduler.http import HealthServer as JHealthServer
from kubernetes_tpu.testing import faults as jfaults
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.client import LeaderElector
from kubernetes_tpu_torch.client import leaderelection as tle
from kubernetes_tpu_torch.scheduler import scheduler as tsched
from kubernetes_tpu_torch.scheduler.http import HealthServer as THealthServer
from kubernetes_tpu_torch.testing import faults as tfaults
from kubernetes_tpu_torch.testing import wrappers as tw

PORT = SimpleNamespace(
    name="port", st=tst, le=tle, w=tw, faults=tfaults, health=THealthServer,
    Scheduler=lambda store, **kw: tsched.Scheduler(store, device="cpu", **kw),
    store_kw={},
)
REF = SimpleNamespace(
    name="reference", st=jst, le=jle, w=jw, faults=jfaults, health=JHealthServer,
    Scheduler=jsched.Scheduler, store_kw={"shards": 1},
)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    tfaults.disarm()
    jfaults.disarm()


def _store(pkg):
    return pkg.st.Store(**pkg.store_kw)


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return bool(cond())


def test_port_exports_the_elector_and_the_lease():
    assert LeaderElector is tle.LeaderElector
    lease = tapi.Lease()
    assert lease.KIND == "Lease"
    assert [f for f in tapi.LeaseSpec.__dataclass_fields__] == [
        "holder_identity", "lease_duration_seconds", "acquire_time", "renew_time",
        "lease_transitions"]
    assert "leader.renew" in tfaults.KNOWN_POINTS


# -- tests/test_durability_leaderelection.py's election cases -----------------


def _single_winner(pkg):
    store = _store(pkg)
    a = pkg.le.LeaderElector(store, "sched", "A", lease_duration=0.5, renew_period=0.05).start()
    b = pkg.le.LeaderElector(store, "sched", "B", lease_duration=0.5, renew_period=0.05).start()
    try:
        assert a.wait_for_leadership(5) or b.wait_for_leadership(5)
        time.sleep(0.3)
        assert a.is_leader() != b.is_leader(), "split brain"
        return sorted([a.is_leader(), b.is_leader()])
    finally:
        a.stop()
        b.stop()


def _failover_within_lease(pkg):
    store = _store(pkg)
    a = pkg.le.LeaderElector(store, "sched", "A", lease_duration=0.6, renew_period=0.05).start()
    assert a.wait_for_leadership(5)
    b = pkg.le.LeaderElector(store, "sched", "B", lease_duration=0.6, renew_period=0.05).start()
    try:
        time.sleep(0.2)
        assert not b.is_leader()
        # leader dies WITHOUT releasing (hard crash): standby must take
        # over within lease_duration + renew_period
        a._stop.set()
        a._thread.join(timeout=5)
        t0 = time.monotonic()
        assert b.wait_for_leadership(5)
        took = time.monotonic() - t0
        assert took <= 0.6 + 0.5, f"failover took {took:.2f}s"
        return _holder(store, "sched"), b.fence_token().generation
    finally:
        b.stop()
        a.stop(release=False)


def _graceful_release(pkg):
    store = _store(pkg)
    a = pkg.le.LeaderElector(store, "sched", "A", lease_duration=5.0, renew_period=0.05).start()
    assert a.wait_for_leadership(5)
    b = pkg.le.LeaderElector(store, "sched", "B", lease_duration=5.0, renew_period=0.05).start()
    try:
        a.stop(release=True)  # zeroes renew_time
        assert b.wait_for_leadership(2), "release did not hand over quickly"
        return _holder(store, "sched"), b.fence_token().generation
    finally:
        b.stop()


def _transitions_recorded(pkg):
    store = _store(pkg)
    a = pkg.le.LeaderElector(store, "s", "A", lease_duration=0.3, renew_period=0.05).start()
    assert a.wait_for_leadership(5)
    a.stop(release=True)
    b = pkg.le.LeaderElector(store, "s", "B", lease_duration=0.3, renew_period=0.05).start()
    try:
        assert b.wait_for_leadership(5)
        lease = store.get("Lease", "s", "kube-system")
        assert lease.spec.holder_identity == "B"
        assert lease.spec.lease_transitions >= 1
        return _holder(store, "s")
    finally:
        b.stop()


def _holder(store, name):
    spec = store.get("Lease", name, "kube-system").spec
    return spec.holder_identity, spec.lease_transitions


def _run_thread(s):
    for kind in ("Node", "Pod"):
        s.informers.informer(kind).start()
    assert s.informers.wait_for_sync(10)
    s._thread = threading.Thread(target=s._run, daemon=True)
    s._thread.start()


def _bound_to(store, name, timeout=10.0):
    _until(lambda: bool(store.get("Pod", name).spec.node_name), timeout)
    return store.get("Pod", name).spec.node_name


def _two_schedulers_fail_over(pkg):
    w = pkg.w
    store = _store(pkg)
    store.create(w.make_node("n0").capacity(cpu_milli=8000, mem=8 * w.GI, pods=20).obj())
    el_a = pkg.le.LeaderElector(store, "kube-scheduler", "A", lease_duration=0.6,
                                renew_period=0.05).start()
    el_b = pkg.le.LeaderElector(store, "kube-scheduler", "B", lease_duration=0.6,
                                renew_period=0.05).start()
    sa = pkg.Scheduler(store, leader_elector=el_a)
    sb = pkg.Scheduler(store, leader_elector=el_b)
    try:
        for s in (sa, sb):
            _run_thread(s)
        assert el_a.wait_for_leadership(5)
        store.create(w.make_pod("p1").req(cpu_milli=100).obj())
        assert _bound_to(store, "p1") == "n0"
        # hard-kill the leader (loop + elector stop, no release)
        sa._stop.set()
        el_a._stop.set()
        el_a._thread.join(timeout=5)
        assert el_b.wait_for_leadership(5), "standby never took over"
        store.create(w.make_pod("p2").req(cpu_milli=100).obj())
        assert _bound_to(store, "p2") == "n0"
        return (el_a.fence_token().generation, el_b.fence_token().generation,
                _holder(store, "kube-scheduler"))
    finally:
        sa.stop()
        sb.stop()
        el_a.stop()
        el_b.stop()


def _renew_failure_steps_down_once(pkg):
    store = _store(pkg)
    started, stopped = [], []
    a = pkg.le.LeaderElector(
        store, "sched", "A", lease_duration=5.0, renew_period=0.05,
        on_started_leading=lambda: started.append(time.monotonic()),
        on_stopped_leading=lambda: stopped.append(time.monotonic()),
    ).start()
    try:
        assert a.wait_for_leadership(5)
        assert len(started) == 1 and not stopped
        reg = pkg.faults.FaultRegistry().fail("leader.renew", n=1)
        with pkg.faults.armed(reg):
            _until(lambda: bool(stopped), 5)
        assert len(stopped) == 1, "step-down did not fire exactly once"
        assert a.renew_errors == 1
        # the lease is still ours in the store: the next healthy renew
        # re-acquires and leadership resumes
        assert a.wait_for_leadership(5), "never re-acquired after renew blip"
        assert len(started) == 2
        assert len(stopped) == 1  # no spurious extra step-downs
        return reg.fired, a.renew_errors, _holder(store, "sched")
    finally:
        pkg.faults.disarm()
        a.stop()


def _renew_failure_pauses_dispatch(pkg):
    w = pkg.w
    store = _store(pkg)
    store.create(w.make_node("n0").capacity(cpu_milli=8000, mem=8 * w.GI, pods=20).obj())
    el = pkg.le.LeaderElector(store, "kube-scheduler", "A", lease_duration=5.0,
                              renew_period=0.05).start()
    sched = pkg.Scheduler(store, leader_elector=el)
    try:
        _run_thread(sched)
        assert el.wait_for_leadership(5)
        # renew fails persistently: the holder steps down and STAYS down
        reg = pkg.faults.FaultRegistry().fail("leader.renew", n=-1)
        with pkg.faults.armed(reg):
            _until(lambda: not el.is_leader(), 5)
            assert not el.is_leader()
            store.create(w.make_pod("paused").req(cpu_milli=100).obj())
            time.sleep(0.4)  # several loop iterations while stepped down
            assert not store.get("Pod", "paused").spec.node_name, (
                "scheduler dispatched while not leading")
        # faults disarmed: renewal recovers, dispatch resumes
        assert el.wait_for_leadership(5)
        assert _bound_to(store, "paused") == "n0"
        return el.renew_errors > 0, _holder(store, "kube-scheduler")
    finally:
        pkg.faults.disarm()
        sched.stop()
        el.stop()


ELECTION_CASES = {
    "single_winner": _single_winner,
    "failover_within_lease": _failover_within_lease,
    "graceful_release": _graceful_release,
    "transitions_recorded": _transitions_recorded,
    "two_schedulers_fail_over": _two_schedulers_fail_over,
    "renew_failure_steps_down_once": _renew_failure_steps_down_once,
    "renew_failure_pauses_dispatch": _renew_failure_pauses_dispatch,
}


ELECTION_WANT = {
    "single_winner": [False, True],
    "failover_within_lease": (("B", 1), 1),
    "graceful_release": (("B", 1), 1),
    "transitions_recorded": ("B", 1),
    "two_schedulers_fail_over": (0, 1, ("B", 1)),
    "renew_failure_steps_down_once": ({"leader.renew": 1}, 1, ("A", 0)),
    "renew_failure_pauses_dispatch": (True, ("A", 0)),
}


@pytest.mark.parametrize("case", sorted(ELECTION_CASES))
def test_election_matches_reference(case):
    got = ELECTION_CASES[case](PORT)
    assert got == ELECTION_CASES[case](REF)
    assert got == ELECTION_WANT[case]


# -- tests/test_restart_recovery.py's fencing cases ----------------------------


def _acquire(pkg, store, lease, ident):
    e = pkg.le.LeaderElector(store, lease, ident, lease_duration=0.4, renew_period=0.05)
    assert e.try_acquire_or_renew()
    e._leading.set()
    return e


def _binder(node):
    def mutate(pod):
        pod.spec.node_name = node
    return mutate


def _expire(store, name):
    lease = store.get("Lease", name, "kube-system")
    lease.spec.renew_time = -1e9
    store.update(lease, force=True)


def _fenced_after_takeover(pkg):
    w = pkg.w
    store = _store(pkg)
    store.create(w.make_node("n0").capacity(cpu_milli=8000, mem=16 * w.GI).obj())
    store.create(w.make_pod("p0").req(cpu_milli=100).obj())
    a = _acquire(pkg, store, "sched-lease", "holder-a")
    token_a = a.fence_token()
    assert token_a is not None and token_a.generation == 0
    _expire(store, "sched-lease")
    b = _acquire(pkg, store, "sched-lease", "holder-b")
    assert b.fence_token().generation == 1
    # a's late wave carries the stale token -> fenced, nothing applied
    with pytest.raises(pkg.st.Fenced):
        store.update_wave("Pod", [("p0", "default", _binder("n0"))], fence=token_a)
    assert store.fenced_writes_total == 1
    assert store.get("Pod", "p0").spec.node_name == ""
    # b's wave commits under its own token
    applied, errors = store.update_wave(
        "Pod", [("p0", "default", _binder("n0"))], fence=b.fence_token())
    assert applied == ["default/p0"] and not errors
    return tuple(token_a), tuple(b.fence_token()), store.get("Pod", "p0").spec.node_name


def _fence_refreshes_on_reacquisition(pkg):
    w = pkg.w
    store = _store(pkg)
    store.create(w.make_node("n0").capacity(cpu_milli=8000, mem=16 * w.GI).obj())
    store.create(w.make_pod("p0").req(cpu_milli=100).obj())
    a = _acquire(pkg, store, "l", "a")
    stale = a.fence_token()
    _expire(store, "l")
    _acquire(pkg, store, "l", "b")
    _expire(store, "l")
    assert a.try_acquire_or_renew()  # a reacquires: generation 2
    assert a.fence_token().generation == 2
    with pytest.raises(pkg.st.Fenced):
        store.update_wave("Pod", [("p0", "default", _binder("n0"))], fence=stale)
    applied, errors = store.update_wave(
        "Pod", [("p0", "default", _binder("n0"))], fence=a.fence_token())
    assert applied and not errors
    return tuple(stale), tuple(a.fence_token()), store.fenced_writes_total


FENCE_CASES = {
    "fenced_wave_rejected_after_takeover": _fenced_after_takeover,
    "fence_token_refreshes_on_reacquisition": _fence_refreshes_on_reacquisition,
}


@pytest.mark.parametrize("case", sorted(FENCE_CASES))
def test_fencing_matches_reference(case):
    got = FENCE_CASES[case](PORT)
    want = FENCE_CASES[case](REF)
    assert got == want


# -- both electors by hand on one clock ------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _lease_fields(store):
    try:
        s = store.get("Lease", "kube-scheduler", "kube-system").spec
    except (tst.NotFound, jst.NotFound):
        return None
    return (s.holder_identity, s.lease_duration_seconds, s.acquire_time, s.renew_time,
            s.lease_transitions)


def _hand_driven(pkg):
    """acquire, renew, a standby refused, a hard stop, the takeover, a
    refused old holder, a release and the old holder's reacquisition;
    after every step the stored Lease, both fence tokens and the step's
    return value."""
    clock = _Clock()
    store = _store(pkg)
    mk = lambda ident: pkg.le.LeaderElector(store, "kube-scheduler", ident,
                                            lease_duration=3.0, renew_period=0.5,
                                            clock=clock)
    a, b = mk("A"), mk("B")
    tok = lambda e: None if e.fence_token() is None else tuple(e.fence_token())
    steps = []

    def step(label, t, fn):
        clock.t = t
        ret = fn()
        steps.append((label, ret, _lease_fields(store), tok(a), tok(b)))

    step("start", 0.0, lambda: None)
    step("a acquires", 0.0, a.try_acquire_or_renew)
    step("b refused", 0.5, b.try_acquire_or_renew)
    step("a renews", 1.0, a.try_acquire_or_renew)
    step("a hard stop", 1.2, lambda: a.stop(release=False))
    step("b still refused", 3.9, b.try_acquire_or_renew)
    step("b takes over", 4.1, b.try_acquire_or_renew)
    step("a refused", 4.2, a.try_acquire_or_renew)
    step("b renews", 4.6, b.try_acquire_or_renew)
    step("b releases", 4.7, lambda: b.stop(release=True))
    step("a reacquires", 4.8, a.try_acquire_or_renew)
    step("a releases", 5.0, lambda: a.stop(release=True))
    return steps


def test_hand_driven_electors_match_reference_step_for_step():
    got, want = _hand_driven(PORT), _hand_driven(REF)
    assert got == want
    # the transcript itself: two takeovers, the last token generation 2
    assert [s[1] for s in got] == [None, True, False, True, None, False, True, False,
                                   True, None, True, None]
    assert got[-1][2] == ("A", 3, 4.8, 0.0, 2)
    assert got[-1][3] == ("kube-scheduler", "kube-system", "A", 2)


# -- the card's leader phase, reduced, on both packages --------------------------


def _leader_sequence(pkg):
    got = chip_smoke.leader_sequence(pkg.w, pkg.st.Store, pkg.Scheduler, pkg.le.LeaderElector,
                                     pkg.health, (60, 24, 24), 0.6, 0.05)
    try:
        placed = {p.meta.name: p.spec.node_name for p in got["store"].list("Pod")[0]}
        seen = chip_smoke.bind_transcript(got["events"])
        return {
            "placed": placed,
            "bound_once": all(len(v) == 1 for v in seen.values()) and set(seen) == set(placed),
            "refused": got["refused"], "fenced": got["fenced"],
            "applied": got["stale_wave_applied"], "holder": got["holder"],
            "generations": (got["a_generation"], got["b_generation"]),
            "reconciles": got["b_reconciles"],
            "failover_ok": got["failover_s"] <= 0.6 + 0.05 + 0.5,
            "standby": got["standby"],
        }
    finally:
        got["store"].close()


def test_leader_sequence_matches_reference():
    """chip_smoke.leader_sequence at 60 nodes, 24 + 24 pods: the same
    placements, fence and takeover on both packages; the standby's
    /readyz differs by design (503 in the port, 200 in the reference)."""
    got, want = _leader_sequence(PORT), _leader_sequence(REF)
    assert got["standby"] == {"b_batches": 0, "b_attempts": 0, "readyz_a": 200,
                              "readyz_b": 503}
    assert want["standby"]["readyz_b"] == 200
    got.pop("standby"), want.pop("standby")
    assert got == want
    assert all(got["placed"].values()) and got["bound_once"]
    assert got["refused"] and got["fenced"] == 1 and not got["applied"]
    assert got["holder"] == "B" and got["generations"] == (0, 1) and got["reconciles"] == 1
    assert got["failover_ok"]
