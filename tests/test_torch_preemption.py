"""The port's PreemptionEvaluator equals the reference's, preemptor for preemptor.

Each case builds its cluster twice from one seed, through each package's
own wrappers, and runs the reference's evaluator (kubernetes_tpu/scheduler/
preemption.py on TPUBatchScheduler, on the CPU) and the port's
(kubernetes_tpu_torch/scheduler/preemption.py on
TorchBatchScheduler(device="cpu"), where every kernel wrapper runs its
plain version) on the same objects.  Every PreemptionResult must agree —
node and victim names — and so must the surviving accounted state
(`_pod_node`).  The reference's Oracle is the second witness of victim
choice.  Ported from tests/test_preemption.py, case for case, apart from
the cases that need the scheduler loop (not ported yet).
"""

import numpy as np
import pytest

from kubernetes_tpu.api import store as jst
from kubernetes_tpu.models.batch_scheduler import TPUBatchScheduler
from kubernetes_tpu.scheduler.cache import SchedulerCache as JCache
from kubernetes_tpu.scheduler.metrics import Registry as JRegistry
from kubernetes_tpu.scheduler.preemption import PreemptionEvaluator as JEvaluator
from kubernetes_tpu.testing import faults as jfaults
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu.testing.oracle import Oracle
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.models.batch_scheduler import TorchBatchScheduler
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.scheduler.metrics import Registry as TRegistry
from kubernetes_tpu_torch.scheduler.preemption import PreemptionEvaluator as TEvaluator
from kubernetes_tpu_torch.scheduler.queue import pod_key
from kubernetes_tpu_torch.testing import faults as tfaults
from kubernetes_tpu_torch.testing import wrappers as tw

REF = dict(w=jw, store=jst, sched=TPUBatchScheduler, cache=JCache, reg=JRegistry,
           ev=JEvaluator, faults=jfaults)
PORT = dict(w=tw, store=tst, sched=lambda: TorchBatchScheduler(device="cpu"), cache=TCache,
            reg=TRegistry, ev=TEvaluator, faults=tfaults)


def result_key(res):
    if res is None:
        return None
    return (res.nominated_node, sorted(v.meta.name for v in res.victims))


def plan_key(plan):
    if plan is None:
        return None
    node, victims = plan
    return node, sorted(v.meta.name for v in victims)


def pdb(w, name, selector, allowed):
    api = w.api
    b = api.PodDisruptionBudget(
        meta=api.ObjectMeta(name=name, namespace="default"),
        spec=api.PodDisruptionBudgetSpec(selector=api.LabelSelector(match_labels=selector)),
    )
    b.status.disruptions_allowed = allowed
    return b


def evaluator(pkg, nodes, bound, preemptors=(), pdbs=(), metrics=True):
    """An evaluator with a store behind it (preempt() re-fetches the
    preemptor and deletes victims through the API)."""
    tpu = pkg["sched"]()
    store = pkg["store"].Store()
    for n in nodes:
        tpu.add_node(n)
        store.create(n)
    for p in bound:
        tpu.assume(p, p.spec.node_name)
        store.create(p)
    for p in list(preemptors) + list(pdbs):
        store.create(p)
    return pkg["ev"](tpu, pkg["cache"](tpu.state), store, pkg["reg"]() if metrics else None)


def build_cluster(w, seed, n_nodes=6, n_victims=12):
    """Every node gets >= 2 victims, so a 3500m preemptor on 4000m nodes
    never fits without eviction."""
    rng = np.random.default_rng(seed)
    nodes = [w.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20).obj()
             for i in range(n_nodes)]
    bound = [
        w.make_pod(f"v{i}").req(cpu_milli=int(rng.choice([500, 1000, 1500])), mem=w.GI)
        .priority(int(rng.integers(0, 5))).node_name(f"n{i % n_nodes}").obj()
        for i in range(n_victims)
    ]
    return nodes, bound, w.make_pod("hi").req(cpu_milli=3500, mem=w.GI).priority(100).obj()


def mixed_cluster(w, seed, n_nodes=6, n_victims=14, n_preemptors=4, gang_of=0, db_every=0):
    rng = np.random.default_rng(seed)
    nodes = [w.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20).obj()
             for i in range(n_nodes)]
    bound = []
    for i in range(n_victims):
        pw = (w.make_pod(f"v{i}").req(cpu_milli=int(rng.choice([500, 1000, 1500])), mem=w.GI)
              .priority(int(rng.integers(0, 5))).node_name(f"n{i % n_nodes}"))
        if db_every and i % db_every == 0:
            pw = pw.labels(app="db")
        p = pw.obj()
        p.status.phase = "Running"
        bound.append(p)
    preemptors = []
    for j in range(n_preemptors):
        pw = w.make_pod(f"hi{j}").req(cpu_milli=3500, mem=w.GI).priority(
            int(rng.choice([50, 100, 200])))
        if gang_of and j < gang_of:
            pw = pw.group("band", size=gang_of)
        preemptors.append(pw.obj())
    return nodes, bound, preemptors


def sequential(ev, preemptors):
    return [ev.preempt(p) if ev.eligible(p) else None for p in preemptors]


def assert_same_outcome(ev_ref, ev_port, ref_results, port_results):
    assert [result_key(r) for r in port_results] == [result_key(r) for r in ref_results]
    assert sorted(ev_port.tpu.state._pod_node.items()) == sorted(
        ev_ref.tpu.state._pod_node.items())


def run_batch_case(seed, pdb_allowed=None, **kw):
    """preempt_batch through both packages, each equal to its own
    sequential loop and to the other package.  Returns the port's batched
    evaluator."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        nodes, bound, preemptors = mixed_cluster(pkg["w"], seed, **kw)
        pdbs = [pdb(pkg["w"], "db-pdb", {"app": "db"}, pdb_allowed)] if pdb_allowed is not None else []
        ev_seq = evaluator(pkg, nodes, bound, preemptors, pdbs)
        seq = sequential(ev_seq, preemptors)
        ev_bat = evaluator(pkg, nodes, bound, preemptors, pdbs)
        bat = ev_bat.preempt_batch(preemptors)
        assert_same_outcome(ev_seq, ev_bat, seq, bat)
        out[name] = (ev_bat, bat)
    assert_same_outcome(out["ref"][0], out["port"][0], out["ref"][1], out["port"][1])
    return out["port"][0]


# -- victim choice ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_victim_choice_matches_reference_and_oracle(seed):
    """The classic per-pod plan (no shared pass) equals the reference's and
    the Oracle's minimal-prefix policy."""
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        nodes, bound, preemptor = build_cluster(pkg["w"], seed)
        ev = evaluator(pkg, nodes, bound, metrics=False)
        with ev.cache.lock:
            got[name] = plan_key(ev._plan(preemptor))
    nodes, bound, preemptor = build_cluster(jw, seed)
    assert got["port"] == got["ref"]
    assert got["port"] == plan_key(Oracle(nodes, bound_pods=bound).preempt(preemptor))


@pytest.mark.parametrize("seed", range(4))
def test_batched_plan_matches_reference_and_oracle(seed):
    """The shared pass's plan for a single preemptor (no fallback) equals
    the reference's and the Oracle's."""
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        nodes, bound, preemptor = build_cluster(pkg["w"], 10 + seed)
        ev = evaluator(pkg, nodes, bound, [preemptor])
        with ev.shared_pass([preemptor]):
            assert not ev._shared.fallback
            got[name] = plan_key(ev._plan(preemptor))
    nodes, bound, preemptor = build_cluster(jw, 10 + seed)
    assert got["port"] == got["ref"]
    assert got["port"] == plan_key(Oracle(nodes, bound_pods=bound).preempt(preemptor))


# -- eligibility -----------------------------------------------------------


@pytest.mark.parametrize("case", ["never", "no_lower_priority"])
def test_not_eligible(case):
    for pkg in (REF, PORT):
        w = pkg["w"]
        nodes = [w.make_node("n0").capacity(cpu_milli=1000).obj()]
        prio = 0 if case == "never" else 50
        bound = [w.make_pod("v").req(cpu_milli=1000).priority(prio).node_name("n0").obj()]
        ev = evaluator(pkg, nodes, bound, metrics=False)
        pod = w.make_pod("hi").req(cpu_milli=1000).priority(10).obj()
        if case == "never":
            pod.spec.preemption_policy = "Never"
        assert not ev.eligible(pod)


def test_eligible_uses_shared_min_priority():
    """Inside a shared pass eligibility reads the pass's cached minimum
    priority; outside it the live scan is back."""
    for pkg in (REF, PORT):
        w = pkg["w"]
        nodes = [w.make_node("n0").capacity(cpu_milli=2000, pods=10).obj()]
        victim = w.make_pod("v").req(cpu_milli=2000).priority(5).node_name("n0").obj()
        victim.status.phase = "Running"
        hi = w.make_pod("hi").req(cpu_milli=500).priority(100).obj()
        lo = w.make_pod("lo").req(cpu_milli=500).priority(3).obj()
        ev = evaluator(pkg, nodes, [victim], [hi, lo])
        assert ev.min_existing_priority() == 5
        with ev.shared_pass([hi, lo]) as ctx:
            assert ctx.min_prio == 5
            assert ev.eligible(hi) and not ev.eligible(lo)
            ev.tpu.state.remove_pod(victim)
            assert ev.eligible(hi)
        assert ev.min_existing_priority() is None
        assert not ev.eligible(hi)


# -- verify ----------------------------------------------------------------


def verify_case(w, blocked: bool):
    """The pod is anti-affine to app=x.  blocked: the label survives
    eviction (a higher-priority pod carries it), so the resource-only
    candidate must fail verification; else evicting the conflicter clears
    both the shortage and the conflict."""
    if blocked:
        nodes = [w.make_node("n0").capacity(cpu_milli=2000, pods=10).obj()]
        bound = [
            w.make_pod("blocker").req(cpu_milli=1000).priority(200).label("app", "x")
            .node_name("n0").obj(),
            w.make_pod("filler").req(cpu_milli=1000).priority(0).node_name("n0").obj(),
        ]
    else:
        nodes = [w.make_node("n0").capacity(cpu_milli=1000, pods=10).obj()]
        bound = [w.make_pod("conflicter").req(cpu_milli=1000).priority(0).label("app", "x")
                 .node_name("n0").obj()]
    pod = w.make_pod("hi").req(cpu_milli=500).priority(100).pod_anti_affinity({"app": "x"}).obj()
    return nodes, bound, pod


@pytest.mark.parametrize("blocked", [True, False])
def test_verify(blocked):
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        nodes, bound, pod = verify_case(pkg["w"], blocked)
        ev = evaluator(pkg, nodes, bound, metrics=False)
        with ev.cache.lock:
            got[name] = plan_key(ev._plan(pod))
    assert got["port"] == got["ref"]
    assert got["port"] == (None if blocked else ("n0", ["conflicter"]))


# -- nominations -----------------------------------------------------------


def test_nominated_reservation_blocks_stealers():
    """A nominated pod's requests overlay its node in other pods'
    snapshots; the nominee's own batch excludes it and lands."""
    tpu = TorchBatchScheduler(device="cpu")
    tpu.add_node(tw.make_node("n0").capacity(cpu_milli=1000, pods=10).obj())
    nominee = tw.make_pod("hi").req(cpu_milli=1000).priority(100).obj()
    stealer = tw.make_pod("thief").req(cpu_milli=1000).priority(100).obj()
    assert tpu.schedule_pending([stealer]) == ["n0"]
    assert tpu.schedule_pending([stealer], reservations=[("n0", nominee)]) == [None]
    assert tpu.schedule_pending([nominee]) == ["n0"]


def test_nomination_lifecycle_in_cache():
    tpu = TorchBatchScheduler(device="cpu")
    tpu.add_node(tw.make_node("n0").capacity(cpu_milli=2000, pods=10).obj())
    cache = TCache(tpu.state)
    pod = tw.make_pod("p").req(cpu_milli=500).priority(5).obj()
    cache.nominate(pod, "n0")
    assert cache.nominations_excluding(set()) == [("n0", pod)]
    assert cache.nominations_excluding({pod_key(pod)}) == []
    cache.assume(pod, "n0")  # it landed: the reservation is spent
    assert cache.nominations_excluding(set()) == []


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port_store", "reference_store"])
def test_nominate_survives_conflict_and_notfound(pkg):
    """_nominate is best effort: a Conflict between its get and update is
    retried against the re-read object; a NotFound (pod deleted) is
    dropped.  The port's evaluator against its own store and against the
    reference's."""
    st = pkg["store"]
    store = st.Store()
    pod = pkg["w"].make_pod("prey").obj()
    store.create(pod)

    class RacingStore:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def get(self, *a, **k):
            return self.inner.get(*a, **k)

        def update(self, obj):
            self.calls += 1
            if self.calls == 1:
                raise st.Conflict("resourceVersion mismatch")
            return self.inner.update(obj)

    ev = object.__new__(TEvaluator)
    ev.store = RacingStore(store)
    ev._nominate(pod, "node-x")
    assert store.get("Pod", "prey", pod.meta.namespace).status.nominated_node_name == "node-x"
    ev.store = store
    ev._nominate(pkg["w"].make_pod("gone").obj(), "node-y")  # must not raise


def test_store_conflict_and_notfound():
    store = tst.Store()
    pod = store.create(tw.make_pod("p").obj())
    stale = store.get("Pod", "p")
    store.update(pod)
    with pytest.raises(tst.Conflict):
        store.update(stale)
    with pytest.raises(tst.AlreadyExists):
        store.create(tw.make_pod("p").obj())
    store.delete("Pod", "p")
    with pytest.raises(tst.NotFound):
        store.get("Pod", "p")
    with pytest.raises(KeyError):
        store.delete("Pod", "p")


# -- PDBs ------------------------------------------------------------------


def test_pdb_flags_partition_victims():
    pdbs = [pdb(tw, "b", {"app": "db"}, 1)]
    victims = [tw.make_pod(f"v{i}").labels(app="db").priority(i).obj() for i in range(3)]
    assert TEvaluator._pdb_flags(victims, pdbs) == [False, True, True]


@pytest.mark.parametrize("batched", [True, False])
def test_pdb_steers_victim_choice(batched):
    """Two equivalent candidates; the one whose victim a zero-budget PDB
    guards loses (fewest violations is the first criterion) and counts
    into preemption_pdb_blocked_total."""
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        w = pkg["w"]
        nodes = [w.make_node(f"n{i}").capacity(cpu_milli=2000, pods=10).obj() for i in range(2)]
        bound = []
        for pname, node, app in (("guarded", "n0", "db"), ("free", "n1", "web")):
            p = (w.make_pod(pname).labels(app=app).req(cpu_milli=2000).priority(1)
                 .node_name(node).obj())
            p.status.phase = "Running"
            bound.append(p)
        hi = w.make_pod("hi").req(cpu_milli=1500).priority(100).obj()
        ev = evaluator(pkg, nodes, bound, [hi], [pdb(w, "db-pdb", {"app": "db"}, 0)])
        res = ev.preempt_batch([hi])[0] if batched else ev.preempt(hi)
        got[name] = (result_key(res), ev.metrics.preemption_pdb_blocked_total.total,
                     sorted(ev.tpu.state._pod_node))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("n1", ["free"]) and got["port"][1] >= 1


# -- the batched PostFilter pass ------------------------------------------


def test_preempt_batch_matches_sequential():
    """Randomized mixed-priority clusters: batched == sequential == the
    reference, including passes where an earlier preemptor's evictions
    touch a later one's candidates (the conflict recompute)."""
    conflicts = 0
    for seed in range(6):
        ev = run_batch_case(seed)
        conflicts += ev.metrics.preemption_conflict_serializations.total
        assert ev.metrics.preemption_batch_size.n >= 1
    assert conflicts > 0, "no case exercised a cross-preemptor conflict"


@pytest.mark.parametrize("seed", range(3))
def test_preempt_batch_gang_parity(seed):
    run_batch_case(100 + seed, n_nodes=4, n_victims=8, n_preemptors=3, gang_of=2)


@pytest.mark.parametrize("seed", range(3))
def test_preempt_batch_pdb_parity(seed):
    ev = run_batch_case(200 + seed, pdb_allowed=1, db_every=2)
    assert ev.pdb_aware


@pytest.mark.parametrize("mode", ["fail", "corrupt"])
def test_preempt_batch_fault_parity(mode):
    """An injected failure (or a corrupt result, which the health check
    rejects) on the batched dispatch and its retry: the pass falls back to
    the per-pod path and still equals the sequential loop and the
    reference, and the shared solve breaker trips in both packages (the
    reference's tests/test_preemption.py test_preempt_batch_fallback_parity)."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        nodes, bound, preemptors = mixed_cluster(pkg["w"], 300)
        ev_seq = evaluator(pkg, nodes, bound, preemptors)
        seq = sequential(ev_seq, preemptors)
        ev_bat = evaluator(pkg, nodes, bound, preemptors)
        reg = pkg["faults"].FaultRegistry(seed=1)
        getattr(reg, mode)("batch.preemption", n=2)  # first attempt AND its retry
        with pkg["faults"].armed(reg):
            with ev_bat.shared_pass(preemptors) as ctx:
                assert ctx.fallback
                bat = ev_bat.preempt_batch(preemptors)
        assert reg.fired.get("batch.preemption") == 2
        br = ev_bat.tpu.breaker
        assert br.state == br.OPEN and br.trips == 1
        assert_same_outcome(ev_seq, ev_bat, seq, bat)
        out[name] = (ev_bat, bat)
    assert_same_outcome(out["ref"][0], out["port"][0], out["ref"][1], out["port"][1])
    ref_br, port_br = (out[k][0].tpu.breaker for k in ("ref", "port"))
    assert (port_br.state, port_br.trips, port_br.fallback_count()) == (
        ref_br.state, ref_br.trips, ref_br.fallback_count())


@pytest.mark.parametrize("batched", [True, False])
def test_candidate_cap_counts_nodes_that_cannot_fit(batched):
    """The reference lists at most MAX_CANDIDATES nodes holding a
    lower-priority pod BEFORE its fit test: with the first 256 such nodes
    unable to admit the preemptor even empty, a node past them that could
    is never considered, in the batched pass and in the classic walk.  The
    port keeps that semantics (ROADMAP Queue 3, note 3)."""
    from kubernetes_tpu_torch.scheduler.preemption import MAX_CANDIDATES

    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        w = pkg["w"]
        nodes = [w.make_node(f"n{i:03d}").capacity(cpu_milli=1000 if i < MAX_CANDIDATES else 4000,
                                                   pods=10).obj()
                 for i in range(MAX_CANDIDATES + 1)]
        bound = [w.make_pod(f"v{i:03d}").req(cpu_milli=1000 if i < MAX_CANDIDATES else 4000)
                 .priority(0).node_name(f"n{i:03d}").obj() for i in range(MAX_CANDIDATES + 1)]
        hi = w.make_pod("hi").req(cpu_milli=3000).priority(10).obj()
        ev = evaluator(pkg, nodes, bound, [hi])
        got[name] = result_key(ev.preempt_batch([hi])[0] if batched else ev.preempt(hi))
    assert got["port"] == got["ref"] is None
