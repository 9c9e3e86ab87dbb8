"""The scheduler_perf harness, the cache debugger and the health server in
the port against the reference package's.

kubernetes_tpu_torch/perf (the JSON config and its templates, the loader,
the collectors, the runner and its CLI), scheduler/debugger.py and
scheduler/http.py against kubernetes_tpu/perf (its YAML config),
scheduler/debugger.py and scheduler/http.py on the same inputs: the
documents, the expanded workloads and every selection, the `$index`
substitution, the template objects, the DataItems and the exposition of
two registries fed the same observations, the comparer's findings on a
seeded drift; tests/test_perf_harness.py's end-to-end cases on
`device="cpu"` at tiny sizes; the CLI; and chip_smoke's perf phase helpers.
"""

import copy
import dataclasses
import json
import os
import random
import sys
import time

import pytest
import yaml

import chip_smoke
from kubernetes_tpu import perf as jperf
from kubernetes_tpu.api import kubeyaml as jky
from kubernetes_tpu.api import store as jst
from kubernetes_tpu.perf import collectors as jcol
from kubernetes_tpu.perf import runner as jrun
from kubernetes_tpu.scheduler import debugger as jdbg
from kubernetes_tpu.scheduler import http as jhttp
from kubernetes_tpu.scheduler import metrics as jmet
from kubernetes_tpu.scheduler import scheduler as jsched
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch import perf as tperf
from kubernetes_tpu_torch.api import kubeyaml as tky
from kubernetes_tpu_torch.api import store as tst
from kubernetes_tpu_torch.client.leaderelection import LeaderElector
from kubernetes_tpu_torch.perf import __main__ as tcli
from kubernetes_tpu_torch.perf import collectors as tcol
from kubernetes_tpu_torch.perf import runner as trun
from kubernetes_tpu_torch.perf import workload as twl
from kubernetes_tpu_torch.scheduler import debugger as tdbg
from kubernetes_tpu_torch.scheduler import http as thttp
from kubernetes_tpu_torch.scheduler import metrics as tmet
from kubernetes_tpu_torch.scheduler import scheduler as tsched
from kubernetes_tpu_torch.testing import wrappers as tw

REF_DIR = os.path.dirname(jperf.DEFAULT_CONFIG)
PORT_DIR = os.path.dirname(tperf.DEFAULT_CONFIG)
STEMS = sorted(f[:-5] for f in os.listdir(REF_DIR) if f.endswith(".yaml"))
TEMPLATES = [s for s in STEMS if s != "performance-config"]


def _json_paths(doc):
    """The reference's document with its template paths named .json."""
    if isinstance(doc, dict):
        return {k: ([p[:-5] + ".json" for p in v] if k == "templatePaths"
                    else v[:-5] + ".json" if k.endswith("Path") and isinstance(v, str)
                    else _json_paths(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_json_paths(x) for x in doc]
    return doc


# -- the config ----------------------------------------------------------------


def test_config_holds_every_reference_document():
    assert sorted(f[:-5] for f in os.listdir(PORT_DIR)) == STEMS
    assert os.path.basename(tperf.DEFAULT_CONFIG) == "performance-config.json"


@pytest.mark.parametrize("stem", STEMS)
def test_json_document_equals_the_reference_yaml(stem):
    with open(os.path.join(REF_DIR, stem + ".yaml")) as f:
        want = _json_paths(yaml.safe_load(f))
    with open(os.path.join(PORT_DIR, stem + ".json")) as f:
        got = json.load(f)
    assert got == want


def _ops(wl):
    return [dataclasses.asdict(op) for op in wl.ops]


def test_load_config_equals_the_reference_op_for_op():
    got, want = tperf.load_config(tperf.DEFAULT_CONFIG), jperf.load_config(jperf.DEFAULT_CONFIG)
    assert [w.full_name for w in got] == [w.full_name for w in want]
    for g, w in zip(got, want):
        assert (g.case_name, g.name, g.labels) == (w.case_name, w.name, w.labels)
        assert _ops(g) == _ops(w), g.full_name


def _selections(pkg, wls):
    labels = sorted({lb for w in wls for lb in w.labels}) + ["missing", None]
    names = sorted({w.full_name for w in wls} | {w.case_name for w in wls}
                   | {"5000Nodes", "500Nodes", "Scheduling", "nope"}) + [None]
    return {(lb, n): [w.full_name for w in pkg.select(wls, label=lb, name=n)]
            for lb in labels for n in names}


def test_select_by_every_label_and_name_matches_reference():
    got = _selections(tperf, tperf.load_config(tperf.DEFAULT_CONFIG))
    want = _selections(jperf, jperf.load_config(jperf.DEFAULT_CONFIG))
    assert got == want
    assert got[("performance", None)] == [
        "SchedulingBasic/5000Nodes", "SchedulingPodAntiAffinity/5000Nodes",
        "SchedulingPodAffinity/5000Nodes", "SchedulingNodeAffinity/5000Nodes",
        "TopologySpreading/5000Nodes", "SchedulingWithMixedChurn/5000Nodes"]
    assert got[(None, "PreemptionBasic/500Nodes")] == ["PreemptionBasic/500Nodes"]
    assert got[(None, "SchedulingBasic/500Nodes")] == ["SchedulingBasic/500Nodes"]


def test_yaml_path_reads_through_pyyaml_and_raises_without_it(tmp_path, monkeypatch):
    """The loader reads a .yaml path only through PyYAML, imported then;
    without PyYAML it raises rather than read the file some other way."""
    got = tperf.load_config(jperf.DEFAULT_CONFIG)
    assert [_ops(w) for w in got] == [_ops(w) for w in jperf.load_config(jperf.DEFAULT_CONFIG)]
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        tperf.load_config(jperf.DEFAULT_CONFIG)
    # the shipped JSON needs no PyYAML
    assert len(tperf.load_config(tperf.DEFAULT_CONFIG)) == len(got)


def test_the_port_imports_no_yaml_at_module_level():
    import ast
    import pathlib

    root = pathlib.Path(tperf.__file__).parent
    for path in list(root.glob("*.py")) + [pathlib.Path(chip_smoke.__file__)]:
        tree = ast.parse(path.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert "yaml" not in mods, path


def test_unknown_opcode_raises(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps([{"name": "X", "workloadTemplate": [{"opcode": "createVolume"}],
                                "workloads": [{"name": "w", "params": {}}]}]))
    with pytest.raises(ValueError, match="createVolume"):
        tperf.load_config(str(cfg))


@pytest.mark.parametrize("v", ["5s", "100ms", "1m", "2h", "0.5", 3, 1.5])
def test_parse_duration_matches_reference(v):
    from kubernetes_tpu.perf import workload as jwl

    assert twl._parse_duration(v) == jwl._parse_duration(v)


# -- $index and the template objects ---------------------------------------------


def _template(stem):
    with open(os.path.join(PORT_DIR, stem + ".json")) as f:
        return json.load(f)


def test_substitute_index_matches_reference_over_a_sweep():
    rng = random.Random(22)
    tokens = ["$index", "$index_mod8", "$index_mod", "$index_mod13x", "zone-", "a$indexb", "-"]
    templates = [_template(s) for s in TEMPLATES] + [trun._DEFAULT_NODE, trun._DEFAULT_POD]
    for _ in range(40):
        templates.append({"metadata": {"labels": {
            "k": "".join(rng.choice(tokens) for _ in range(rng.randint(1, 4)))}},
            "list": [rng.choice(tokens), 7, None]})
    for t in templates:
        for index in (0, 1, 7, 8, 13, 4999, 123457):
            assert trun._substitute_index(t, index) == jrun._substitute_index(t, index)


def _same_fields(got, want, path="obj"):
    """Every field of the port's object equal to the reference's (the port's
    types are a cut of the reference's, with the same names), but the uid:
    each package mints it from its own process-wide counter."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            if f.name != "uid":
                _same_fields(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _same_fields(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_fields(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("stem", TEMPLATES)
def test_template_objects_match_reference(stem):
    for index in (0, 5):
        d = trun._substitute_index(_template(stem), index)
        d.setdefault("metadata", {})["name"] = f"obj-{index}"
        if d.get("kind") == "Node":
            _same_fields(tky.node_from_dict(copy.deepcopy(d)), jky.node_from_dict(d))
        else:
            _same_fields(tky.pod_from_dict(copy.deepcopy(d)), jky.pod_from_dict(d))


# -- collectors and the exposition ------------------------------------------------


def _fed(metrics_mod, seed):
    """A Registry with every metric fed the same seeded observations."""
    reg = metrics_mod.Registry()
    rng = random.Random(seed)
    for name, m in sorted(reg.snapshot().items()):
        if isinstance(m, metrics_mod.Histogram):
            for _ in range(rng.randint(0, 40)):
                m.observe(rng.choice([rng.random() * 0.3, rng.randint(1, 600)]))
        elif isinstance(m, metrics_mod.Counter):
            for _ in range(rng.randint(0, 3)):
                m.inc(*rng.choice([(), ("a",), ("b",)]), by=float(rng.randint(1, 9)))
        elif isinstance(m, metrics_mod.Gauge):
            m.set(float(rng.randint(0, 5)), *rng.choice([(), ("x",)]))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_collector_matches_reference(seed):
    t_reg, j_reg = _fed(tmet, seed), _fed(jmet, seed)
    assert sorted(t_reg.snapshot()) == sorted(j_reg.snapshot())
    labels = {"Name": "w"}
    assert tcol.MetricsCollector(t_reg, labels).collect() == \
        jcol.MetricsCollector(j_reg, labels).collect()
    t_base, j_base = tcol.histogram_baseline(t_reg), jcol.histogram_baseline(j_reg)
    assert t_base == j_base
    # more observations after the baseline: the windowed summaries
    for reg in (t_reg, j_reg):
        rng = random.Random(seed + 100)
        for name, m in sorted(reg.snapshot().items()):
            if type(m).__name__ == "Histogram":
                for _ in range(rng.randint(0, 10)):
                    m.observe(rng.random())
    assert tcol.MetricsCollector(t_reg, labels, t_base).collect() == \
        jcol.MetricsCollector(j_reg, labels, j_base).collect()
    assert tcol.MetricsCollector.DEFAULT_METRICS == jcol.MetricsCollector.DEFAULT_METRICS
    assert tcol.MetricsCollector.COUNT_METRICS == jcol.MetricsCollector.COUNT_METRICS
    assert tcol.MetricsCollector.SCALAR_METRICS == jcol.MetricsCollector.SCALAR_METRICS


def test_percentiles_and_data_items_match_reference():
    rng = random.Random(7)
    for n in (0, 1, 2, 3, 10, 99, 100, 101, 1000):
        vals = sorted(rng.random() * 1000 for _ in range(n))
        assert tcol._percentiles(vals) == jcol._percentiles(vals)
    assert tcol.DataItem({"a": 1.0}, "s", {"b": "c"}) == jcol.DataItem({"a": 1.0}, "s", {"b": "c"})


@pytest.mark.parametrize("seed", [0, 3])
def test_render_prometheus_matches_reference(seed):
    text = thttp.render_prometheus(_fed(tmet, seed))
    assert text == jhttp.render_prometheus(_fed(jmet, seed))
    series = chip_smoke.parse_exposition(text)
    assert "scheduler_schedule_attempts_total" in "".join(series)


def test_parse_exposition_refuses_a_bad_line():
    assert chip_smoke.parse_exposition('# TYPE a counter\na 1\nb{x="y"} 2.5\n') == \
        {"a": 1.0, 'b{x="y"}': 2.5}
    with pytest.raises(AssertionError):
        chip_smoke.parse_exposition("a b c\n")


def test_throughput_collector_matches_reference_on_one_store():
    """Both collectors sample the same pods of one store; a burst inside
    one interval still yields a sample (the reference's fix)."""
    out = []
    for mod, st_mod, w in ((tcol, tst, tw), (jcol, jst, jw)):
        store = st_mod.Store(**({} if st_mod is tst else {"shards": 1}))
        for i in range(6):
            store.create(w.make_pod(f"p{i}").obj())
        names = {f"p{i}" for i in range(4)}
        c = mod.ThroughputCollector(store, namespaces=["default"], interval=0.05,
                                    labels={"Name": "w"}, pod_names=names).start()
        time.sleep(0.12)
        for i in range(6):
            p = store.get("Pod", f"p{i}")
            p.spec.node_name = "n0"
            store.update(p)
        time.sleep(0.12)
        c.stop()
        items = c.collect()
        out.append((len(items), items[0]["unit"], items[0]["labels"], sorted(items[0]["data"])))
        assert c._scheduled_count() == 4
    assert out[0] == out[1]


# -- the cache debugger ------------------------------------------------------------


def _debugger_case(pkg):
    st_mod, sched_mod, dbg, w, kw, store_kw = pkg
    store = st_mod.Store(**store_kw)
    for i in range(4):
        store.create(w.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * w.GI, pods=20).obj())
    for i in range(6):
        store.create(w.make_pod(f"p{i}").req(cpu_milli=100).obj())
    s = sched_mod.Scheduler(store, **kw)
    try:
        for kind in ("Node", "Pod"):
            s.informers.informer(kind).start()
        assert s.informers.wait_for_sync(10)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not all(
                p.spec.node_name for p in store.list("Pod")[0]):
            s.schedule_batch(timeout=0.2)
            s.flush_binds(10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and s.cache.assumed_count():
            time.sleep(0.02)
        comparer = dbg.CacheComparer(store, s.cache)
        clean = comparer.compare()
        dump = comparer.dump()
        s.informers.stop()
        # the seeded drift, behind the stopped informers' back
        store.create(w.make_node("n9").capacity(cpu_milli=4000, mem=8 * w.GI).obj())
        store.delete("Node", "n3", "")
        p = store.get("Pod", "p0")
        moved = "n1" if p.spec.node_name != "n1" else "n2"
        p.spec.node_name = moved
        store.update(p)
        store.delete("Pod", "p1", "default")
        q = w.make_pod("late").req(cpu_milli=100).obj()
        q.spec.node_name = "n0"
        store.create(q)
        drift = sorted(comparer.compare())
        return clean, dump, drift
    finally:
        s.stop()


def test_cache_comparer_matches_reference():
    got = _debugger_case((tst, tsched, tdbg, tw, {"device": "cpu"}, {}))
    want = _debugger_case((jst, jsched, jdbg, jw, {}, {"shards": 1}))
    assert got[0] == [] and want[0] == []
    assert got[1] == want[1] and got[1]["nodes"] == 4 and got[1]["bound_pods"] == 6
    assert got[2] == want[2]
    assert len(got[2]) >= 4


# -- the health server ---------------------------------------------------------------


def test_health_server_on_a_cpu_scheduler():
    """/healthz, /livez, /metrics, /debug/threads and /debug/profile on a
    CPU scheduler; /readyz 503 on a standby and 200 on the leader."""
    store = tst.Store()
    store.create(tw.make_node("n0").capacity(cpu_milli=4000, mem=8 * tw.GI, pods=20).obj())
    el_a = LeaderElector(store, "kube-scheduler", "A", lease_duration=5.0, renew_period=0.05)
    el_b = LeaderElector(store, "kube-scheduler", "B", lease_duration=5.0, renew_period=0.05)
    assert el_a.try_acquire_or_renew()
    el_a._leading.set()
    assert not el_b.try_acquire_or_renew()
    scheds = [tsched.Scheduler(store, device="cpu", leader_elector=e) for e in (el_a, el_b)]
    alone = tsched.Scheduler(store, device="cpu")
    servers = []
    try:
        for s in scheds + [alone]:
            for kind in ("Node", "Pod"):
                s.informers.informer(kind).start()
            assert s.informers.wait_for_sync(10)
            servers.append(thttp.HealthServer(s).start())
        a, b, c = (srv.port for srv in servers)
        assert chip_smoke.http_get(a, "/readyz") == (200, "ok\nleader: True")
        assert chip_smoke.http_get(b, "/readyz") == (503, "not leading")
        assert chip_smoke.http_get(c, "/readyz") == (200, "ok\nleader: True")
        for port in (a, b):
            assert chip_smoke.http_get(port, "/healthz") == (200, "ok")
            assert chip_smoke.http_get(port, "/livez") == (200, "ok")
            assert chip_smoke.http_get(port, "/nope")[0] == 404
        code, text = chip_smoke.http_get(a, "/metrics")
        assert code == 200 and "scheduler_leader_reconcile_total" in chip_smoke.parse_exposition(text)
        code, text = chip_smoke.http_get(a, "/debug/threads")
        assert code == 200 and "scheduler-health" in text
        code, text = chip_smoke.http_get(a, "/debug/profile?seconds=0.05")
        assert code == 200 and text.startswith("samples: ")
        scrape = chip_smoke.health_scrape(scheds[0], servers[0])
        assert scrape["readyz"] == 200 and scrape["healthz"] == 200 and scrape["series"] > 50
    finally:
        for srv in servers:
            srv.stop()
        for s in scheds + [alone]:
            s.stop()


# -- tests/test_perf_harness.py's end-to-end cases, on the CPU -------------------------


def _tiny_config(tmp_path, cases, templates=()):
    for name, doc in templates:
        (tmp_path / name).write_text(json.dumps(doc))
    cfg = tmp_path / "perf.json"
    cfg.write_text(json.dumps(cases))
    return str(cfg)


def test_default_config_loads_and_selects():
    wls = tperf.load_config(tperf.DEFAULT_CONFIG)
    names = [w.full_name for w in wls]
    assert "SchedulingBasic/500Nodes" in names
    assert "TopologySpreading/5000Nodes" in names
    assert "PreemptionBasic/500Nodes" in names
    fast = tperf.select(wls, label="integration-test")
    assert all("integration-test" in w.labels for w in fast)
    assert len(tperf.select(wls, name="SchedulingBasic/500Nodes")) == 1


BASIC = [{"name": "Tiny", "workloadTemplate": [
    {"opcode": "createNodes", "countParam": "$nodes"},
    {"opcode": "createPods", "countParam": "$pods", "collectMetrics": True}],
    "workloads": [{"name": "basic", "params": {"nodes": 8, "pods": 24}}]}]


def test_basic_workload_end_to_end(tmp_path):
    result = tperf.run_workloads(tperf.load_config(_tiny_config(tmp_path, BASIC)),
                                 sample_interval=0.02, device="cpu")
    metrics = {i["labels"]["Metric"] for i in result["dataItems"]}
    assert result["version"] == "v1"
    assert "WallClockThroughput" in metrics, result["dataItems"]
    assert "WarmupDuration" in metrics
    assert "scheduler_scheduling_algorithm_duration_seconds" in metrics, result["dataItems"]
    wall = [i for i in result["dataItems"] if i["labels"]["Metric"] == "WallClockThroughput"][0]
    assert wall["data"]["Average"] > 0, result["dataItems"]


def test_churn_and_barrier_end_to_end(tmp_path):
    cases = [{"name": "TinyChurn", "workloadTemplate": [
        {"opcode": "createNodes", "count": 4},
        {"opcode": "churn", "mode": "recreate", "number": 3, "intervalMilliseconds": 5},
        {"opcode": "createPods", "count": 8, "collectMetrics": True},
        {"opcode": "barrier"},
        {"opcode": "sleep", "duration": "10ms"}],
        "workloads": [{"name": "w", "params": {}}]}]
    result = tperf.run_workloads(tperf.load_config(_tiny_config(tmp_path, cases)),
                                 sample_interval=0.02, device="cpu")
    assert result["dataItems"]


def test_unschedulable_workload_terminates(tmp_path):
    node = {"kind": "Node", "spec": {"unschedulable": True},
            "status": {"capacity": {"cpu": "4", "memory": "32Gi", "pods": "110"}}}
    cases = [{"name": "TinyUnsched", "workloadTemplate": [
        {"opcode": "createNodes", "count": 2, "nodeTemplatePath": "bad-node.json"},
        {"opcode": "createPods", "count": 5, "collectMetrics": True}],
        "workloads": [{"name": "w", "params": {}}]}]
    result = tperf.run_workloads(
        tperf.load_config(_tiny_config(tmp_path, cases, [("bad-node.json", node)])),
        sample_interval=0.02, device="cpu")
    # nothing scheduled; the run must still terminate via the parked path
    assert all(i["labels"]["Metric"] != "SchedulingThroughput" or not i["data"]
               for i in result["dataItems"])


def test_runner_without_a_card_raises(tmp_path):
    wls = tperf.load_config(_tiny_config(tmp_path, BASIC))
    with pytest.raises(RuntimeError, match="CUDA"):
        tperf.run_workloads(wls)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.WorkloadRunner().run(wls[0])


def test_cli_on_the_cpu_prints_the_reference_shape(tmp_path, monkeypatch, capsys):
    cfg = _tiny_config(tmp_path, BASIC)
    out = tmp_path / "out.json"
    monkeypatch.setattr(sys, "argv", ["perf", "--device", "cpu", "--config", cfg,
                                      "--out", str(out), "--batch-size", "64"])
    tcli.main()
    printed = capsys.readouterr().out
    assert "running 1 workloads: ['Tiny/basic']" in printed
    result = json.loads(out.read_text())
    assert sorted(result) == ["dataItems", "version"] and result["version"] == "v1"
    assert {"data", "unit", "labels"} == set(result["dataItems"][0])
    assert any(i["labels"]["Metric"] == "WallClockThroughput" for i in result["dataItems"])
    # without --device cpu the CLI runs on the card, and raises without one
    monkeypatch.setattr(sys, "argv", ["perf", "--config", cfg])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main()
    monkeypatch.setattr(sys, "argv", ["perf", "--config", cfg, "--name", "nothing"])
    with pytest.raises(SystemExit):
        tcli.main()


# -- chip_smoke's perf phase helpers -----------------------------------------------------


def test_measured_of_names_the_runners_pods():
    wls = {w.full_name: w for w in tperf.load_config(tperf.DEFAULT_CONFIG)}
    names, ns, earlier = chip_smoke.measured_of(wls["SchedulingPodAntiAffinity/5000Nodes"])
    assert (names[0], names[-1], ns, len(earlier)) == ("pod-1000", "pod-1999", "sched-1", 1000)
    names, ns, earlier = chip_smoke.measured_of(wls["SchedulingWithMixedChurn/5000Nodes"])
    assert (len(names), ns, earlier) == (2000, "default", [])


def test_perf_phase_on_the_cpu(monkeypatch):
    """chip_smoke.perf_phase on SchedulingBasic/500Nodes and
    Unschedulable/500Pods with every Scheduler on device="cpu": the
    checks, the replay through a direct solver, the scrape and the CLI
    (--device cpu) — the card's launch counting stubbed."""
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
    monkeypatch.setattr(chip_smoke, "PERF_CLI", ("--name", "Unschedulable/500Pods",
                                                 "--device", "cpu", "--no-warmup"))
    monkeypatch.setattr(chip_smoke, "SCHEDULERS", [])
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    every = tperf.load_config(tperf.DEFAULT_CONFIG)
    wls = [w for n in ("SchedulingBasic/500Nodes", "Unschedulable/500Pods")
           for w in tperf.select(every, name=n)]
    out = chip_smoke.perf_phase(chip_smoke.recording(CPU), bindings, "cpu", workloads=wls)
    basic, unsched = out["workloads"]
    assert basic["bound"] == 1000 and basic["equal_direct"]
    assert basic["scrape"]["readyz"] == 200
    assert "WallClockThroughput" in basic["items"] and "WarmupDuration" in basic["items"]
    assert unsched["parked"] == 500
    assert out["cli"]["items"]["WallClockThroughput"]["Average"] == 0.0
