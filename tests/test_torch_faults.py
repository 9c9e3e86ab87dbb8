"""Degraded mode — the solve circuit breaker, the host fallback and the
fault points — of the port against the reference's, on the CPU.

Each test drives the reference's TPUBatchScheduler and the port's
TorchBatchScheduler(device="cpu") through the same seeded FaultRegistry
schedule, each package arming its own registry (testing/faults.py), and
asserts equal placements, equal `fired` counts and equal breaker state,
trips, probes and fallbacks:

  * the breaker unit with an injected clock (the reference's
    tests/test_fault_hardening.py test_breaker_half_open_probe_recovers);
  * `batch.solve` fail-forever: the dispatch and its one retry fail, the
    breaker trips and the batch solves on the host; a breaker pinned open
    keeps scheduling on the host, and the half-open probe closes it on
    the device (test_fault_hardening.py:193-232, through schedule_pending:
    the scheduler loop that drives them there is not ported yet);
  * `batch.solve` CORRUPT: NaN scores trip the decode's health check
    (:234-250); one corrupt batch is healed by the retry;
  * fallback parity with the device solve (:273-305), with reservations;
  * `solve.partials` CORRUPT and fail-grade (tests/test_partials.py
    :285-322) on the scan, and CORRUPT on the wavefront, where the
    reference's cheap pick reads NaN top entries as no candidate: the
    batch places nothing and nothing trips (ROADMAP Queue 3, note 4);
  * `mirror.grow` fail and CORRUPT at a pad-bucket crossing on the scan,
    the wavefront and the auction;
  * `solve.carveout` fail-forever on a small c10-shaped cluster: the host
    fallback runs the Oracle with the scheduler's slice policy;
  * the plain pick and the wavefront's top list on rows holding NaN, +inf
    and ties, against jnp.argmax and lax.top_k;
  * the port's own rule on the card (solve_fault_recoverable), with the
    CPU scheduler held to it: a CUDA error at the dispatch, the readback
    or the partials sync re-raises, and only injected faults degrade.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.batch_scheduler import SolveCircuitBreaker as JBreaker
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.testing import faults as jfaults
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.models import batch_scheduler as tbs
from kubernetes_tpu_torch.models.batch_scheduler import SolveCircuitBreaker as TBreaker
from kubernetes_tpu_torch.models.batch_scheduler import SolveUnhealthy as TSolveUnhealthy
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.models.batch_scheduler import solve_fault_recoverable
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.testing import cases
from kubernetes_tpu_torch.testing import faults as tfaults
from kubernetes_tpu_torch.testing import wrappers as tw

REF = {"w": jw, "faults": jfaults, "breaker": JBreaker,
       "sched": lambda **kw: TPUBatchScheduler(**kw)}
PORT = {"w": tw, "faults": tfaults, "breaker": TBreaker,
        "sched": lambda **kw: TorchBatchScheduler(device="cpu", **kw)}


@pytest.fixture(autouse=True)
def _quiet_fault_logs():
    """The retry and fallback paths log every injected fault with its
    traceback; keep the test output readable."""
    names = ("kubernetes_tpu.models.batch_scheduler", "kubernetes_tpu.models.mirror",
             "kubernetes_tpu_torch.models.batch_scheduler", "kubernetes_tpu_torch.models.mirror")
    saved = [(logging.getLogger(n), logging.getLogger(n).level) for n in names]
    for lg, _ in saved:
        lg.setLevel(logging.CRITICAL)
    yield
    for lg, level in saved:
        lg.setLevel(level)


def both(run):
    """run(pkg) for the reference and the port; their outcomes equal."""
    ref, port = run(REF), run(PORT)
    assert port == ref
    return port


def breaker_of(s) -> tuple:
    b = s.breaker
    return b.state, b.trips, b.probes, b.fallback_count()


def nodes(w, n=6, cpu=4000, prefix="n"):
    return [w.make_node(f"{prefix}{i}").capacity(cpu_milli=cpu, mem=8 * w.GI, pods=50)
            .zone(f"z{i % 3}").obj() for i in range(n)]


def pods(w, prefix, n, cpu=100):
    return [w.make_pod(f"{prefix}{i}").req(cpu_milli=cpu + 50 * (i % 4), mem=w.GI).obj()
            for i in range(n)]


def cluster(pkg, n_nodes=6, **kw):
    s = pkg["sched"](**kw)
    for nd in nodes(pkg["w"], n_nodes):
        s.add_node(nd)
    return s


# -- the breaker unit --------------------------------------------------------


def test_breaker_unit_with_injected_clock():
    """The reference's half-open probe test, step by step on both
    breakers: every answer and every counter equal."""
    def run(pkg):
        now = [0.0]
        br = pkg["breaker"](cooldown=5.0, clock=lambda: now[0])
        trace = []

        def snap(tag, v=None):
            trace.append((tag, v, br.state, br.trips, br.probes, br.fallback_count(),
                          br.state_code()))

        snap("allow", br.allow_device())
        br.record_failure()
        snap("fail")
        snap("allow in cooldown", br.allow_device())
        now[0] = 6.0
        snap("probe", br.allow_device())
        snap("second probe", br.allow_device())
        br.record_success()
        snap("closed")
        br.record_failure()
        now[0] = 12.0
        snap("probe", br.allow_device())
        br.record_failure()
        snap("reopened", br.allow_device())
        br.record_fallback()
        br.reset()
        snap("reset", br.allow_device())
        return trace

    trace = both(run)
    assert trace[3][1] is True and trace[4][1] is False  # one probe flows
    assert trace[-1][2:6] == ("closed", 3, 2, 1)


# -- batch.solve: trip after the retry, pinned open, the probe ---------------


def test_trip_after_retry_falls_back_to_host():
    def run(pkg):
        s = cluster(pkg)
        twin = cluster(pkg)
        batch = pods(pkg["w"], "p", 4)
        reg = pkg["faults"].FaultRegistry().fail("batch.solve", n=-1)  # device dead
        with pkg["faults"].armed(reg):
            got = s.schedule_pending(batch)
        assert got == twin.schedule_pending(batch)
        assert s.last_result is None  # no reason tensor aligns with host names
        return got, dict(reg.fired), breaker_of(s)

    got, fired, br = both(run)
    assert all(n is not None for n in got)
    assert fired == {"batch.solve": 2}  # the attempt and ONE retry
    assert br == ("open", 1, 0, 1)


def test_pinned_open_breaker_keeps_throughput_then_probe_closes():
    """With the breaker open inside its cooldown every batch solves on the
    host with no device attempt (an armed batch.solve never fires); once
    the clock passes the cooldown the next batch probes the device and
    closes the breaker."""
    def run(pkg):
        now = [0.0]
        s = cluster(pkg)
        s.breaker = pkg["breaker"](cooldown=3600.0, clock=lambda: now[0])
        s.breaker.record_failure()
        reg = pkg["faults"].FaultRegistry().fail("batch.solve", n=-1)
        with pkg["faults"].armed(reg):
            host = s.schedule_pending(pods(pkg["w"], "q", 3))
            host_subset = s.schedule_pending_no_retry(pods(pkg["w"], "r", 2))
        assert type(s.last_solve).__name__ == "HostSolve"
        fired = dict(reg.fired)
        for p, n in zip(pods(pkg["w"], "q", 3), host):
            s.assume(p, n)
        now[0] = 3601.0
        probe = s.schedule_pending(pods(pkg["w"], "s", 3))
        assert type(s.last_solve).__name__ == "DeviceSolve"
        return host, host_subset, fired, probe, breaker_of(s)

    host, subset, fired, probe, br = both(run)
    assert fired == {}
    assert all(n is not None for n in host + subset + probe)
    assert br == ("closed", 1, 1, 2)


# -- batch.solve CORRUPT: the health check ----------------------------------


@pytest.mark.parametrize("n", [1, -1])
def test_nonfinite_scores_trip_health_check(n):
    """CORRUPT fills the scores with NaN: the decode raises SolveUnhealthy.
    Once, and the retry (a fresh encode with both residents dropped)
    heals it on the device; forever, and the breaker trips to the host."""
    def run(pkg):
        s, twin = cluster(pkg), cluster(pkg)
        batch = pods(pkg["w"], "p", 5)
        reg = pkg["faults"].FaultRegistry().corrupt("batch.solve", n=n)
        with pkg["faults"].armed(reg):
            got = s.schedule_pending(batch)
        assert got == twin.schedule_pending(batch)
        return got, dict(reg.fired), breaker_of(s)

    _, fired, br = both(run)
    if n == 1:
        assert fired == {"batch.solve": 1} and br == ("closed", 0, 0, 0)
    else:
        assert fired == {"batch.solve": 2} and br == ("open", 1, 0, 1)


# -- fallback parity ----------------------------------------------------------


@pytest.mark.parametrize("reserve", [False, True])
def test_fallback_parity_with_device_solve(reserve):
    """A breaker pinned open places exactly as the device solve on a
    healthy snapshot (anti-affinity and node-selector families), with
    nominated reservations accounted on their nodes."""
    def run(pkg):
        w = pkg["w"]
        ns = [w.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20)
              .zone(f"z{i % 2}").label("disk", "ssd" if i % 2 else "hdd").obj()
              for i in range(6)]

        def batch():
            out = []
            for i in range(12):
                p = w.make_pod(f"p{i}").req(cpu_milli=200 + 50 * (i % 3), mem=w.GI)
                if i % 4 == 0:
                    p = p.label("app", "web").pod_anti_affinity({"app": "web"})
                if i % 3 == 0:
                    p = p.node_selector(disk="ssd")
                out.append(p.obj())
            return out

        res = ([("n1", w.make_pod("nom").req(cpu_milli=3000, mem=w.GI).obj())]
               if reserve else [])
        device, host = pkg["sched"](), pkg["sched"]()
        for nd in ns:
            device.add_node(nd)
            host.add_node(nd)
        want = device.schedule_pending(batch(), reservations=res)
        host.breaker.record_failure()
        host.breaker.cooldown = 3600.0
        got = host.schedule_pending(batch(), reservations=res)
        assert got == want, "fallback placements diverge from the device solve"
        return got, breaker_of(host)

    got, br = both(run)
    assert br == ("open", 1, 0, 1)
    assert sum(n is not None for n in got) >= 10


# -- solve.partials -----------------------------------------------------------


def _warm_cold(pkg, n_nodes=8, **kw):
    warm = cluster(pkg, n_nodes, **kw)
    cold = cluster(pkg, n_nodes, use_mirror=False, **kw)
    return warm, cold


def _solve_pair(warm, cold, batch_w, batch_c):
    got = warm.schedule_pending(batch_w)
    assert got == cold.schedule_pending(batch_c)
    for p, n in zip(batch_w, got):
        if n is not None:
            warm.assume(p, n)
    for p, n in zip(batch_c, got):
        if n is not None:
            cold.assume(p, n)
    return got


def test_partials_corrupt_trips_and_recomputes():
    """solve.partials CORRUPT on a warm scan batch: the poisoned store's
    NaN scores trip the health check, the retry invalidates both
    residents and recomputes in full, and the batch places as cold."""
    def run(pkg):
        w = pkg["w"]
        warm, cold = _warm_cold(pkg)
        _solve_pair(warm, cold, pods(w, "a", 8), pods(w, "a", 8))
        full0 = warm._partials.full_recomputes
        reg = pkg["faults"].FaultRegistry(seed=1).corrupt("solve.partials", n=1)
        with pkg["faults"].armed(reg):
            got = warm.schedule_pending(pods(w, "b", 8))
        assert got == cold.schedule_pending(pods(w, "b", 8))
        after = _solve_pair(warm, cold, pods(w, "c", 8), pods(w, "c", 8))
        return (got, after, dict(reg.fired), warm._partials.full_recomputes - full0,
                breaker_of(warm))

    got, _, fired, full, br = both(run)
    assert fired == {"solve.partials": 1}
    assert full >= 1 and br == ("closed", 0, 0, 0)
    assert all(n is not None for n in got)


def test_partials_corrupt_on_the_wavefront_places_nothing_as_the_reference():
    """On the wavefront the reference's cheap pick drops NaN entries of
    the top list (tv > -inf is False), so a batch whose every feasible
    score is NaN places nothing, with -inf scores: the health check does
    not trip and the store stays poisoned.  The port does the same.  A
    later scan batch then trips on the poisoned store and heals."""
    def run(pkg):
        w = pkg["w"]
        warm, cold = _warm_cold(pkg)
        _solve_pair(warm, cold, pods(w, "a", 8), pods(w, "a", 8))
        reg = pkg["faults"].FaultRegistry(seed=1).corrupt("solve.partials", n=1)
        with pkg["faults"].armed(reg):
            wave = warm.schedule_pending(pods(w, "b", 64))
        route = warm.last_solve.meta.route
        heal = warm.schedule_pending(pods(w, "c", 8))
        assert heal == cold.schedule_pending(pods(w, "c", 8))
        return wave, route, heal, dict(reg.fired), breaker_of(warm)

    wave, route, heal, fired, br = both(run)
    assert route == "wavefront" and all(n is None for n in wave)
    assert all(n is not None for n in heal)
    assert fired == {"solve.partials": 1} and br == ("closed", 0, 0, 0)


def test_partials_fail_grade_solves_cold_then_warm_again():
    def run(pkg):
        w = pkg["w"]
        warm, cold = _warm_cold(pkg)
        reg = pkg["faults"].FaultRegistry(seed=2).fail("solve.partials", n=1)
        with pkg["faults"].armed(reg):
            first = _solve_pair(warm, cold, pods(w, "a", 8), pods(w, "a", 8))
        cold_stats = warm._partials.stats()["slots"]
        second = _solve_pair(warm, cold, pods(w, "b", 8), pods(w, "b", 8))
        return first, second, dict(reg.fired), cold_stats, warm._partials.stats()["slots"]

    _, _, fired, slots_after_fault, slots = both(run)
    assert fired == {"solve.partials": 1}
    assert slots_after_fault == 0 and slots > 0


# -- mirror.grow at a bucket crossing -----------------------------------------


ROUTES = {"greedy": ({"mode": "greedy", "use_wavefront": False}, 6),
          "wavefront": ({"mode": "greedy"}, 64),
          "auction": ({"mode": "auction"}, 12)}


@pytest.mark.parametrize("kind", ["fail", "corrupt"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_mirror_grow_at_bucket_crossing(kind, route):
    """The crossing batch (28 nodes grown past 32 padded rows) with
    mirror.grow armed, warm against cold.  fail: the resize declines and a
    full upload follows (resync_total + 1, grow_syncs unchanged), warm ==
    cold.  CORRUPT: the grown allocatable is +inf; on the scan the NaN
    scores trip the health check and the retry re-uploads and places as
    cold, and on the wavefront too (a NaN score reaches the decode); the
    auction reads a class with a NaN score as bidding nowhere, so the
    batch places nothing and nothing trips, in the reference and in the
    port (ROADMAP Queue 3, note 4)."""
    kw, n_pods = ROUTES[route]

    def run(pkg):
        w = pkg["w"]
        warm, cold = _warm_cold(pkg, 28, **kw)
        _solve_pair(warm, cold, pods(w, "a", 6), pods(w, "a", 6))
        for s in (warm, cold):
            for nd in nodes(w, 6, prefix="m"):
                s.add_node(nd)
        before = warm._mirror.stats()
        reg = pkg["faults"].FaultRegistry(seed=3)
        getattr(reg, kind)("mirror.grow", n=1)
        with pkg["faults"].armed(reg):
            got = warm.schedule_pending(pods(w, "b", n_pods))
        want = cold.schedule_pending(pods(w, "b", n_pods))
        delta = {k: v - before[k] for k, v in warm._mirror.stats().items()}
        return got, want, delta, dict(reg.fired), breaker_of(warm)

    got, want, delta, fired, br = both(run)
    assert fired == {"mirror.grow": 1} and br == ("closed", 0, 0, 0)
    if kind == "fail":
        assert got == want
        assert delta["resync_total"] == 1 and delta["grow_syncs"] == 0
    elif route == "auction":
        # every class's best is NaN (jnp.max): no bid anywhere
        assert all(n is None for n in got) and delta["resync_total"] == 0
    else:
        # the rows the delta carried are finite, the rest score NaN: a
        # NaN score reaches the decode on both routes, the health check
        # trips and the retry re-uploads
        assert got == want and delta["resync_total"] == 1 and delta["grow_syncs"] == 1


# -- solve.carveout -----------------------------------------------------------


@pytest.mark.parametrize("policy", ["prefer", "require"])
def test_carveout_fault_falls_back_with_slice_policy(policy):
    """solve.carveout fail-forever on a small c10-shaped cluster (two 2x2x2
    slices, three shaped gangs): the dispatch and its retry fail, the
    breaker trips, and the host fallback runs the Oracle under the
    scheduler's carveout_policy, placing as the device solve does."""
    def run(pkg):
        w = pkg["w"]
        batch = (cases.gang(w, "g0", 4, "2x2x1") + cases.gang(w, "g1", 8, "2x2x2")
                 + cases.gang(w, "g2", 2, "2x1x1"))
        s = pkg["sched"](carveout_policy=policy)
        twin = pkg["sched"](carveout_policy=policy)
        for nd in cases.mk_slices(w, 2, (2, 2, 2)):
            s.add_node(nd)
            twin.add_node(nd)
        reg = pkg["faults"].FaultRegistry().fail("solve.carveout", n=-1)
        with pkg["faults"].armed(reg):
            got = s.schedule_pending(batch)
        assert got == twin.schedule_pending(batch)
        return got, dict(reg.fired), breaker_of(s)

    got, fired, br = both(run)
    assert fired["solve.carveout"] == 2 and br == ("open", 1, 0, 1)
    assert sum(n is not None for n in got) >= 8


# -- the plain pick on NaN rows -----------------------------------------------


NAN_ROWS = [
    [1.0, np.nan, 3.0, -np.inf, np.nan, 3.0, np.inf, 0.0],
    [np.nan] * 8,
    [-np.inf, np.nan, -np.inf, 2.0, 2.0, np.nan, -np.inf, -np.inf],
    [-np.inf] * 3 + [5.0] + [-np.inf] * 4,
]


@pytest.mark.parametrize("row", range(len(NAN_ROWS)))
def test_plain_pick_and_top_list_on_nan_rows(row):
    """torch.argmax and the wavefront's stable descending sort order a row
    as jnp.argmax and lax.top_k do: NaN first by index, then the values
    descending, ties by index — the order the repaired kernels follow."""
    x = np.asarray(NAN_ROWS[row], dtype=np.float32)
    assert int(tassign._pick(torch.from_numpy(x))) == int(jnp.argmax(jnp.asarray(x)))
    for k in (1, 3, 8):
        tv, ti = tassign._top_stable(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        assert ti.tolist() == np.asarray(ji).tolist()
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- the card's rule: only a corrupt result and an injected fault degrade ----


@pytest.mark.parametrize("exc,device,want", [
    (tfaults.FaultInjected("injected"), "cuda", True),
    (TSolveUnhealthy("nan"), "cuda", True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "cuda", False),
    (RuntimeError("kernel build failed"), "cuda", False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "cpu", True),
])
def test_solve_fault_recoverable(exc, device, want):
    assert solve_fault_recoverable(exc, torch.device(device)) is want


def card_rule(monkeypatch):
    """Hold the port's CPU scheduler to the card's rule."""
    real = tbs.solve_fault_recoverable
    monkeypatch.setattr(tbs, "solve_fault_recoverable",
                        lambda exc, device: real(exc, torch.device("cuda")))


@pytest.mark.parametrize("stage", ["dispatch", "readback", "partials"])
def test_card_reraises_a_kernel_error(monkeypatch, stage):
    """A CUDA error at the dispatch, the readback or the partials sync
    reaches the caller: no retry, no trip, no host fallback, no cold
    batch counted."""
    card_rule(monkeypatch)
    s = cluster(PORT)

    def boom(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    if stage == "dispatch":
        monkeypatch.setattr(s, "_dispatch", boom)
    elif stage == "readback":
        monkeypatch.setattr(tbs.DeviceSolve, "names", boom)
    else:
        monkeypatch.setattr(s._partials, "sync", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.schedule_pending(pods(tw, "p", 4))
    assert breaker_of(s) == ("closed", 0, 0, 0)
    assert s._partials.sync_failures == 0


def test_card_degrades_on_injected_faults(monkeypatch):
    """Under the card's rule an injected solve.partials failure solves its
    batch cold and is counted, and an injected batch.solve failure trips
    the breaker and falls back, as on the CPU."""
    card_rule(monkeypatch)
    s, twin = cluster(PORT), cluster(PORT)
    batch = pods(tw, "p", 4)
    reg = tfaults.FaultRegistry().fail("solve.partials", n=1).fail("batch.solve", n=-1)
    with tfaults.armed(reg):
        got = s.schedule_pending(batch)
    assert got == twin.schedule_pending(batch)
    assert reg.fired == {"solve.partials": 1, "batch.solve": 2}
    assert s._partials.sync_failures == 1
    assert breaker_of(s) == ("open", 1, 0, 1)
