"""Seeded mixed scheduling batches for parity checks.

`mixed_objects(wrappers, seed)` builds nodes, pending pods and bound pods
through a wrapper module (this package's testing.wrappers, or any module
with the same builders and an `api` attribute), drawing every choice from
numpy's seeded generator, so two wrapper sets given one seed build the
same cluster.  The batch exercises what the greedy route solves: required
selectors (In, NotIn, Exists, DoesNotExist, Gt over labels and topology
slots), preferred terms, taints of every effect with and without
tolerations, host ports (bound and in-batch), NodeName, priorities and
gangs.

The other builders size batches to each solve route (the route is decided
on the padded pod axis: < 64 greedy, 64-512 wavefront, >= 1024 or any
gang auction): `basic_objects` (SchedulingBasic's shape), `contended_objects`
(a uniform cluster and identical pods, so every node ties and more pods
contend than the tie list holds), `gang_objects` (gangs, one of which
cannot be placed whole), and `capacity_edge_objects` /
`fractional_mix_objects` (memory requests that are not whole MiB, whose
sums leave float32's exact range, so the auction's order of additions
shows).  `fractional_gang_objects` adds an incomplete gang to such a batch,
so the auction's gang post-pass subtracts past the exact range too.

`spread_objects` builds PodTopologySpread batches (zone and hostname
keys, maxSkew 1-5, hard and soft constraints, minDomains, carriers whose
own labels do not match their selector, nodes without a zone, matching
bound pods and gangs); `topology_spreading_objects` is scheduler_perf's
TopologySpreading workload at any scale.

`interpod_objects`, `prefpod_objects` and `image_objects` build seeded
batches of required inter-pod (anti-)affinity, preferred inter-pod terms
and ImageLocality; `many_anti_terms_objects` anti-affinity over more
than 32 distinct terms on two key slots; `pod_anti_affinity_objects`, `pod_affinity_objects`
and `preferred_affinity_objects` are scheduler_perf's
SchedulingPodAntiAffinity, SchedulingPodAffinity and (upstream's)
SchedulingPreferredPodAffinity workloads at any scale.

The TPU slice builders: `slice_node` / `mk_slices` label nodes as members
of slices (api.LABEL_TPU_SLICE, LABEL_TPU_TOPOLOGY, LABEL_TPU_COORDS, and
LABEL_TPU_CORE for several nodes on one coordinate), `gang` makes a
shaped gang (pod.spec.tpu_topology), and `SliceChurn` is bench.py's c10
slice-packing mix: 64 slices of 4x4x4 (a TPU v4 pod's cubes), rounds of
208 pods in 26 gangs (2x2x1 x 12, 2x2x2 x 8, 4x2x2 x 4, 4x4x1 x 2), half
the live gangs leaving between rounds.

Preemption: `preemption_basic_objects` is scheduler_perf's PreemptionBasic
at any scale, `c9_objects` bench.py's c9 preemption cluster (one victim a
node, a zero-budget PDB on every fourth), and `dry_run_inputs` random
inputs of the batched dry-run.
"""

from __future__ import annotations

import numpy as np

SIZES = ((24, 20), (40, 45), (70, 90))


def mixed_objects(wrappers, seed: int, n_nodes: int = 0, n_pods: int = 0):
    api = wrappers.api
    gi, mi = wrappers.GI, wrappers.MI
    if not n_nodes or not n_pods:
        n_nodes, n_pods = SIZES[seed % len(SIZES)]
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        w = wrappers.make_node(f"n{i}").capacity(
            cpu_milli=int(rng.integers(1, 9)) * 1000,
            mem=int(rng.integers(2, 33)) * gi,
            pods=int(rng.integers(3, 110)),
        ).zone(f"z{i % 3}")
        if rng.random() < 0.2:
            w = w.taint("dedicated", "ml", api.NO_SCHEDULE)
        if rng.random() < 0.3:
            w = w.taint(f"soft{int(rng.integers(0, 3))}", "x", api.PREFER_NO_SCHEDULE)
        if rng.random() < 0.1:
            w = w.taint("evict", "", api.NO_EXECUTE)
        if rng.random() < 0.5:
            w = w.label("disk", "ssd" if rng.random() < 0.5 else "hdd")
        if rng.random() < 0.3:
            w = w.label("gen", str(int(rng.integers(1, 6))))
        if rng.random() < 0.05:
            w = w.unschedulable()
        nodes.append(w.obj())
    pods = []
    for i in range(n_pods):
        w = wrappers.make_pod(f"p{i}").req(
            cpu_milli=int(rng.integers(1, 30)) * 100,
            mem=int(rng.integers(1, 60)) * 64 * mi,
        ).priority(int(rng.integers(0, 3)))
        r = rng.random()
        if r < 0.15:
            w = w.node_selector_kv("disk", "ssd")
        elif r < 0.25:
            w = w.required_affinity("gen", api.OP_GT, ["2"])
        elif r < 0.3:
            w = w.required_affinity("disk", api.OP_DOES_NOT_EXIST)
        elif r < 0.35:
            w = w.required_affinity(api.LABEL_ZONE, api.OP_NOT_IN, ["z0"])
        elif r < 0.4:
            w = w.required_affinity(api.LABEL_ZONE, api.OP_EXISTS)
        elif r < 0.43:
            w = w.required_affinity("gen", api.OP_LT, ["3"]).required_affinity(
                "disk", api.OP_IN, ["hdd"]
            )
        if rng.random() < 0.3:
            w = w.preferred_affinity(int(rng.integers(1, 100)), "disk", api.OP_IN, ["ssd"])
        if rng.random() < 0.2:
            w = w.preferred_affinity(
                int(rng.integers(1, 100)), api.LABEL_ZONE, api.OP_IN, ["z1"]
            )
        if rng.random() < 0.3:
            w = w.toleration("dedicated", api.OP_EQUAL, "ml", api.NO_SCHEDULE)
        if rng.random() < 0.2:
            w = w.toleration("soft1", api.OP_EXISTS, effect=api.PREFER_NO_SCHEDULE)
        if rng.random() < 0.05:
            w = w.toleration()
        if rng.random() < 0.15:
            w = w.host_port(int(rng.choice([80, 443, 8080])))
        if rng.random() < 0.05:
            w = w.node_name(f"n{int(rng.integers(0, n_nodes))}")
        if rng.random() < 0.2:
            w = w.group(f"g{int(rng.integers(0, 4))}")
        pods.append(w.obj())
    bound = [
        wrappers.make_pod(f"b{i}").req(cpu_milli=500, mem=512 * mi)
        .host_port(80).node_name(f"n{i}").obj()
        for i in range(0, n_nodes, 5)
    ]
    return nodes, pods, bound


def basic_objects(wrappers, n_nodes: int, n_pods: int, seed: int = 0):
    """SchedulingBasic's node-default / pod-default shape (4 CPU, 32Gi,
    110 pods, zone-$index_mod8; pods 100m / 500Mi), with a seeded share of
    pods that differ in size, priority and a zone selector, so the batch
    has several pod classes."""
    api = wrappers.api
    gi, mi = wrappers.GI, wrappers.MI
    rng = np.random.default_rng(seed)
    nodes = [
        wrappers.make_node(f"node-{i}")
        .capacity(cpu_milli=4000, mem=32 * gi, pods=110)
        .zone(f"zone-{i % 8}").obj()
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        w = wrappers.make_pod(f"pod-{i}")
        r = rng.random()
        if r < 0.7:
            w = w.req(cpu_milli=100, mem=500 * mi)
        elif r < 0.85:
            w = w.req(cpu_milli=900, mem=2 * gi).priority(int(rng.integers(0, 3)))
        else:
            w = w.req(cpu_milli=300, mem=1 * gi).node_selector_kv(
                api.LABEL_ZONE, f"zone-{int(rng.integers(0, 8))}"
            )
        pods.append(w.obj())
    return nodes, pods, []


def contended_objects(wrappers, n_nodes: int = 8, n_pods: int = 64,
                      pod_slots: int = 110):
    """A uniform cluster and identical pods: every node ties for every
    pod, so tie order decides each pick; with n_pods > n_nodes more pods
    contend than there are tie nodes."""
    gi, mi = wrappers.GI, wrappers.MI
    nodes = [
        wrappers.make_node(f"n{i}").capacity(cpu_milli=4000, mem=16 * gi, pods=pod_slots).obj()
        for i in range(n_nodes)
    ]
    pods = [wrappers.make_pod(f"p{i}").req(cpu_milli=250, mem=512 * mi).obj()
            for i in range(n_pods)]
    return nodes, pods, []


def gang_objects(wrappers, n_nodes: int = 4, n_gangs: int = 4, size: int = 3,
                 loose: int = 4):
    """Gangs of `size` members and `loose` ungrouped pods on a small
    cluster; the last gang asks for more than the cluster has left, so it
    is released whole (REASON_GANG for its placed members)."""
    gi, mi = wrappers.GI, wrappers.MI
    nodes = [
        wrappers.make_node(f"n{i}").capacity(cpu_milli=4000, mem=8 * gi, pods=110)
        .zone(f"z{i % 2}").obj()
        for i in range(n_nodes)
    ]
    pods = []
    for g in range(n_gangs):
        cpu = 3000 if g == n_gangs - 1 else 700
        for m in range(size):
            pods.append(
                wrappers.make_pod(f"g{g}-{m}").req(cpu_milli=cpu, mem=512 * mi)
                .group(f"gang-{g}").priority(g % 2).obj()
            )
    for i in range(loose):
        pods.append(wrappers.make_pod(f"loose-{i}").req(cpu_milli=400, mem=256 * mi).obj())
    return nodes, pods, []


# 100M: 95.367431640625 MiB, a multiple of 2^-12 MiB, so float32 holds a
# sum of such requests exactly only below 4,096 MiB
FRACTIONAL_MEM = 100_000_000


def capacity_edge_objects(wrappers, n_nodes: int, n_pods: int, per_node: int,
                          priorities: int = 1):
    """Identical pods whose memory request is not a whole number of MiB, on
    nodes that hold exactly `per_node` of them: the last pod a node takes
    lands on its capacity, and past the 43rd pod in the auction's sorted
    order the acceptance prefix leaves float32's exact range, so the order
    of the additions decides acceptance at each node's edge."""
    nodes = [
        wrappers.make_node(f"n{i}")
        .capacity(cpu_milli=64000, mem=per_node * FRACTIONAL_MEM, pods=110).obj()
        for i in range(n_nodes)
    ]
    pods = [
        wrappers.make_pod(f"p{i}").req(cpu_milli=10, mem=FRACTIONAL_MEM)
        .priority(i % priorities).obj()
        for i in range(n_pods)
    ]
    return nodes, pods, []


def fractional_mix_objects(wrappers, seed: int, n_nodes: int = 8, n_pods: int = 1000):
    """Pods of several memory sizes that are not whole MiB, in four
    priorities, on nodes of 60 GB and up: each node's committed sum passes
    float32's exact range, so the order in which a round adds its accepted
    pods to a node decides the rounding of requested."""
    rng = np.random.default_rng(seed)
    sizes = (FRACTIONAL_MEM, 150_000_000, 333_000_000, 77_777_777, 1_234_567)
    nodes = [
        wrappers.make_node(f"n{i}")
        .capacity(cpu_milli=64000, mem=(60 + i) * 1_000_000_000, pods=500).obj()
        for i in range(n_nodes)
    ]
    pods = [
        wrappers.make_pod(f"p{i}").req(cpu_milli=10, mem=int(rng.choice(sizes)))
        .priority(int(rng.integers(0, 4))).obj()
        for i in range(n_pods)
    ]
    return nodes, pods, []


def fractional_gang_objects(wrappers, seed: int, n_nodes: int = 8, n_pods: int = 1000,
                            n_gangs: int = 6):
    """fractional_mix_objects with every 7th pod in one of `n_gangs` gangs
    and one extra gang member that fits nowhere, so the gang post-pass
    releases a whole gang whose members sit on nodes whose sums are past
    float32's exact range."""
    nodes, pods, bound = fractional_mix_objects(wrappers, seed, n_nodes, n_pods)
    for i in range(0, n_pods, 7):
        pods[i].spec.scheduling_group = f"fg{(i // 7) % n_gangs}"
    pods.append(
        wrappers.make_pod("fg-too-big").req(cpu_milli=10, mem=120 * 10**9)
        .group("fg0").obj()
    )
    return nodes, pods, bound


def _spread_constraint(wrappers, w, rng, app: str, key: str, hard: bool,
                       min_domains: int = 0):
    w = w.spread(
        max_skew=int(rng.integers(1, 6)),
        topology_key=key,
        when_unsatisfiable="DoNotSchedule" if hard else "ScheduleAnyway",
        selector={"app": app},
    )
    if hard and min_domains:
        w.pod.spec.topology_spread_constraints[-1].min_domains = min_domains
    return w


def spread_objects(wrappers, seed: int, n_nodes: int = 24, n_pods: int = 60,
                   gangs: bool = True, soft_share: float = 0.4):
    """A PodTopologySpread batch drawn from numpy's seeded generator: nodes
    in 2-5 zones (one in ten without a zone label), three services whose
    pods mostly carry a zone or hostname constraint over their own service
    (hard or soft, maxSkew 1-5, sometimes minDomains, sometimes both keys),
    carriers labelled with another service than the one they spread over
    (selfMatch 0), plain pods, matching bound pods (so the bound counts
    are folded in) and, with `gangs`, gang members."""
    api = wrappers.api
    gi, mi = wrappers.GI, wrappers.MI
    rng = np.random.default_rng(seed)
    n_zones = int(rng.integers(2, 6))
    nodes = []
    for i in range(n_nodes):
        w = wrappers.make_node(f"n{i}").capacity(
            cpu_milli=int(rng.integers(2, 9)) * 1000,
            mem=int(rng.integers(4, 33)) * gi,
            pods=int(rng.integers(4, 40)),
        )
        if rng.random() >= 0.1:
            w = w.zone(f"z{i % n_zones}")
        nodes.append(w.obj())
    apps = ("a", "b", "c")
    pods = []
    for i in range(n_pods):
        app = str(rng.choice(apps))
        w = wrappers.make_pod(f"p{i}").req(
            cpu_milli=int(rng.integers(1, 10)) * 100,
            mem=int(rng.integers(1, 16)) * 128 * mi,
        ).priority(int(rng.integers(0, 2)))
        r = rng.random()
        sel_app = app
        if r < 0.1:
            sel_app = apps[(apps.index(app) + 1) % 3]  # selfMatch 0
        if r < 0.8:
            w = w.label("app", app)
        if r < 0.75:
            key = api.LABEL_ZONE if rng.random() < 0.6 else api.LABEL_HOSTNAME
            hard = rng.random() >= soft_share
            md = int(rng.integers(2, 8)) if rng.random() < 0.15 else 0
            w = _spread_constraint(wrappers, w, rng, sel_app, key, hard, md)
            if rng.random() < 0.2:
                other = api.LABEL_HOSTNAME if key == api.LABEL_ZONE else api.LABEL_ZONE
                w = _spread_constraint(wrappers, w, rng, sel_app, other,
                                       rng.random() >= soft_share)
        if gangs and rng.random() < 0.15:
            w = w.group(f"g{int(rng.integers(0, 3))}")
        pods.append(w.obj())
    bound = [
        wrappers.make_pod(f"b{i}").label("app", str(rng.choice(apps)))
        .req(cpu_milli=100, mem=128 * mi).node_name(f"n{int(rng.integers(0, n_nodes))}").obj()
        for i in range(max(1, n_nodes // 3))
    ]
    return nodes, pods, bound


def topology_spreading_objects(wrappers, n_nodes: int, n_init: int, n_measure: int,
                               when: str = "DoNotSchedule"):
    """scheduler_perf's TopologySpreading workload
    (kubernetes_tpu/perf/config/performance-config.yaml:115-139):
    node-default nodes (4 CPU, 32Gi, 110 pods, zone-$index_mod8),
    pod-default init pods (100m / 500Mi, no labels) and measured pods of
    pod-with-topology-spreading.yaml (label color=blue; maxSkew 5 on
    topology.kubernetes.io/zone over color=blue; 100m / 500Mi).  `when` is
    the template's whenUnsatisfiable: "ScheduleAnyway" gives upstream's
    PreferredTopologySpreading shape with the same counts.
    Returns (nodes, init_pods, measured_pods)."""
    api = wrappers.api
    gi, mi = wrappers.GI, wrappers.MI
    nodes = [
        wrappers.make_node(f"scheduler-perf-{i}")
        .capacity(cpu_milli=4000, mem=32 * gi, pods=110)
        .zone(f"zone-{i % 8}").obj()
        for i in range(n_nodes)
    ]
    init = [wrappers.make_pod(f"pod-{i}").req(cpu_milli=100, mem=500 * mi).obj()
            for i in range(n_init)]
    measured = [
        wrappers.make_pod(f"spreading-pod-{i}").label("color", "blue")
        .req(cpu_milli=100, mem=500 * mi)
        .spread(5, api.LABEL_ZONE, when, {"color": "blue"}).obj()
        for i in range(n_measure)
    ]
    return nodes, init, measured


def _term(api, selector, key: str, namespaces=()):
    return api.PodAffinityTerm(
        label_selector=api.LabelSelector(match_labels=dict(selector)),
        topology_key=key, namespaces=list(namespaces),
    )


def _add_terms(api, pod, req_aff=(), req_anti=(), pref_aff=(), pref_anti=()):
    """Attach inter-pod terms to a pod object: required lists of terms,
    preferred lists of (weight, term)."""
    aff = pod.spec.affinity or api.Affinity()
    if req_aff or pref_aff:
        aff.pod_affinity = aff.pod_affinity or api.PodAffinity()
        aff.pod_affinity.required.extend(req_aff)
        aff.pod_affinity.preferred.extend(
            api.WeightedPodAffinityTerm(wt, t) for wt, t in pref_aff)
    if req_anti or pref_anti:
        aff.pod_anti_affinity = aff.pod_anti_affinity or api.PodAntiAffinity()
        aff.pod_anti_affinity.required.extend(req_anti)
        aff.pod_anti_affinity.preferred.extend(
            api.WeightedPodAffinityTerm(wt, t) for wt, t in pref_anti)
    pod.spec.affinity = aff
    return pod


def _interpod_nodes(wrappers, rng, n_nodes: int, zones: int = 3, bare: float = 0.1):
    gi = wrappers.GI
    nodes = []
    for i in range(n_nodes):
        w = wrappers.make_node(f"n{i}").capacity(
            cpu_milli=int(rng.integers(2, 9)) * 1000, mem=int(rng.integers(4, 33)) * gi,
            pods=int(rng.integers(4, 110)))
        if rng.random() >= bare:
            w = w.zone(f"z{i % zones}")
        nodes.append(w.obj())
    return nodes


def interpod_objects(wrappers, seed: int, n_nodes: int = 24, n_pods: int = 60,
                     anti_only: bool = False):
    """A seeded batch of required inter-pod terms: hostname and zone keys,
    anti-affinity within and across apps, affinity (with and without a
    matching bound pod, so the first-pod escape both applies and does
    not), pods that do not match their own affinity term, terms limited to
    other namespaces, nodes without a zone, and bound pods that match or
    carry terms.  anti_only=True leaves the affinity direction out (the
    auction's families).  Returns (nodes, pending, bound)."""
    api = wrappers.api
    mi = wrappers.MI
    rng = np.random.default_rng(seed)
    nodes = _interpod_nodes(wrappers, rng, n_nodes)
    apps = ["a", "b", "c", "d"]
    keys = [api.LABEL_HOSTNAME, api.LABEL_ZONE]
    bound = []
    for i in range(int(rng.integers(0, n_nodes // 2 + 1))):
        app = str(rng.choice(apps))
        pod = wrappers.make_pod(f"b{i}", str(rng.choice(["default", "other"]))).label(
            "app", app).node_name(f"n{int(rng.integers(0, n_nodes))}").obj()
        if rng.random() < 0.3:
            _add_terms(api, pod, req_anti=[_term(api, {"app": str(rng.choice(apps))},
                                                 str(rng.choice(keys)))])
        bound.append(pod)
    pending = []
    for i in range(n_pods):
        app = str(rng.choice(apps))
        pod = wrappers.make_pod(f"p{i}").label("app", app).req(
            cpu_milli=int(rng.integers(1, 10)) * 100, mem=int(rng.integers(1, 16)) * 64 * mi,
        ).priority(int(rng.integers(0, 3))).obj()
        r = rng.random()
        key = str(rng.choice(keys))
        ns = ("default", "other") if rng.random() < 0.2 else ()
        if r < 0.35:
            _add_terms(api, pod, req_anti=[_term(api, {"app": app}, key, ns)])
        elif r < 0.5:
            _add_terms(api, pod, req_anti=[_term(api, {"app": str(rng.choice(apps))}, key)])
        elif r < 0.7 and not anti_only:
            # self-matching affinity (the first-pod escape applies), or an
            # affinity to another app (only a present pod satisfies it)
            target = app if rng.random() < 0.6 else str(rng.choice(apps))
            _add_terms(api, pod, req_aff=[_term(api, {"app": target}, key, ns)])
        elif r < 0.8 and not anti_only:
            _add_terms(api, pod, req_aff=[_term(api, {"app": app}, api.LABEL_ZONE)],
                       req_anti=[_term(api, {"app": app}, api.LABEL_HOSTNAME)])
        pending.append(pod)
    return nodes, pending, bound


def many_anti_terms_objects(wrappers, n_nodes: int = 24, services: int = 20,
                            per_service: int = 3, zones: int = 3):
    """Anti-affinity over many distinct terms: `services` apps, pod j of
    app k anti-affine to app (k + j) % services on the hostname (even k)
    or the zone (odd k), so the batch holds 2 x services distinct terms
    (40 by default: a second term word, padded to 64 with terms that are
    not valid) on two key slots, and apps contend for nodes and zones round
    after round.
    Returns (nodes, pending, bound)."""
    api = wrappers.api
    nodes = [wrappers.make_node(f"n{i}").capacity(cpu_milli=8000, mem=16 * wrappers.GI,
                                                  pods=110).zone(f"z{i % zones}").obj()
             for i in range(n_nodes)]
    keys = (api.LABEL_HOSTNAME, api.LABEL_ZONE)
    pods = [wrappers.make_pod(f"p{k}-{j}").req(cpu_milli=100).label("app", f"s{k}")
            .pod_anti_affinity({"app": f"s{(k + j) % services}"}, keys[k % 2]).obj()
            for k in range(services) for j in range(per_service)]
    return nodes, pods, []


def prefpod_objects(wrappers, seed: int, n_nodes: int = 24, n_pods: int = 60):
    """A seeded batch of preferred inter-pod terms: affinity and
    anti-affinity (negative raws) of weights 1-100 on hostname and zone
    keys, several terms a pod, bound pods that match them, bound pods that
    carry preferred terms and required affinity terms (the owner
    direction, the hard-affinity weight), and pods with no term at all.
    Returns (nodes, pending, bound)."""
    api = wrappers.api
    mi = wrappers.MI
    rng = np.random.default_rng(seed)
    nodes = _interpod_nodes(wrappers, rng, n_nodes, zones=4)
    apps = ["a", "b", "c"]
    keys = [api.LABEL_HOSTNAME, api.LABEL_ZONE]

    def weighted(k):
        return [(int(rng.integers(1, 101)),
                 _term(api, {"app": str(rng.choice(apps))}, str(rng.choice(keys))))
                for _ in range(k)]

    bound = []
    for i in range(int(rng.integers(n_nodes // 2, 2 * n_nodes))):
        pod = wrappers.make_pod(f"b{i}").label("app", str(rng.choice(apps))).node_name(
            f"n{int(rng.integers(0, n_nodes))}").obj()
        r = rng.random()
        if r < 0.25:
            _add_terms(api, pod, pref_aff=weighted(1), pref_anti=weighted(int(rng.integers(0, 2))))
        elif r < 0.35:
            _add_terms(api, pod, req_aff=[_term(api, {"app": str(rng.choice(apps))},
                                                str(rng.choice(keys)))])
        bound.append(pod)
    pending = []
    for i in range(n_pods):
        pod = wrappers.make_pod(f"p{i}").label("app", str(rng.choice(apps))).req(
            cpu_milli=int(rng.integers(1, 10)) * 100, mem=int(rng.integers(1, 16)) * 64 * mi,
        ).obj()
        if rng.random() < 0.8:
            _add_terms(api, pod, pref_aff=weighted(int(rng.integers(0, 3))),
                       pref_anti=weighted(int(rng.integers(0, 3))))
        pending.append(pod)
    return nodes, pending, bound


# ImageLocality's clamps: images straddle the 23 MB threshold and the
# 1000 MB a container ceiling
IMAGE_SIZES_MB = (1, 22, 23, 24, 150, 480, 999, 1000, 1001, 1900, 2600, 3800)


def image_objects(wrappers, seed: int, n_nodes: int = 24, n_pods: int = 60,
                  n_images: int = 8):
    """A seeded ImageLocality batch (a synthetic check, not a user
    workload): nodes hold a few of `n_images` images whose sizes straddle
    the 23 MB and 1000 MB x containers clamps (whole MB and odd byte
    counts, so sums leave float32's exact range); pods run one to three
    containers, some with init containers, some images unknown to every
    node.  Returns (nodes, pending, [])."""
    api = wrappers.api
    mi = wrappers.MI
    rng = np.random.default_rng(seed)
    mb = 1024 * 1024
    sizes = [int(rng.choice(IMAGE_SIZES_MB)) * mb + int(rng.integers(0, mb))
             for _ in range(n_images)]
    nodes = []
    for i in range(n_nodes):
        w = wrappers.make_node(f"n{i}").capacity(cpu_milli=8000, mem=32 * wrappers.GI,
                                                 pods=110).zone(f"z{i % 3}")
        for k in range(n_images):
            if rng.random() < 0.35:
                w = w.image(f"img{k}:v1", sizes[k])
        nodes.append(w.obj())
    pending = []
    for i in range(n_pods):
        pod = wrappers.make_pod(f"p{i}").req(
            cpu_milli=int(rng.integers(1, 10)) * 100, mem=int(rng.integers(1, 16)) * 64 * mi,
        ).obj()
        n_c = int(rng.integers(1, 4))
        pod.spec.containers = [
            api.Container(name=f"c{j}", image=f"img{int(rng.integers(0, n_images + 2))}:v1",
                          requests=dict(pod.spec.containers[0].requests) if j == 0 else {})
            for j in range(n_c)
        ]
        if rng.random() < 0.3:
            pod.spec.init_containers = [
                api.Container(name="init", image=f"img{int(rng.integers(0, n_images))}:v1")]
        pending.append(pod)
    return nodes, pending, []


def _perf_nodes(wrappers, n_nodes: int):
    """node-default.yaml's nodes as scheduler_perf names them."""
    gi = wrappers.GI
    return [
        wrappers.make_node(f"scheduler-perf-{i}")
        .capacity(cpu_milli=4000, mem=32 * gi, pods=110)
        .zone(f"zone-{i % 8}").obj()
        for i in range(n_nodes)
    ]


def _perf_pods(wrappers, n: int, prefix: str, namespace: str, color: str, terms):
    """n pods of a scheduler_perf inter-pod template: label color, 100m /
    500Mi, each given its own copy of `terms(api)` (req_aff, req_anti,
    pref_aff, pref_anti keyword lists)."""
    api = wrappers.api
    mi = wrappers.MI
    return [
        _add_terms(api, wrappers.make_pod(f"{prefix}{i}", namespace).label("color", color)
                   .req(cpu_milli=100, mem=500 * mi).obj(), **terms(api))
        for i in range(n)
    ]


SCHED_NAMESPACES = ("sched-1", "sched-0")


def pod_anti_affinity_objects(wrappers, n_nodes: int, n_init: int, n_measure: int):
    """scheduler_perf's SchedulingPodAntiAffinity workload
    (kubernetes_tpu/perf/config/performance-config.yaml:30-58,
    pod-with-pod-anti-affinity.yaml): node-default nodes; init pods in
    namespace sched-0 and measured pods in sched-1, both of the template:
    label color=green, required anti-affinity to color=green on
    kubernetes.io/hostname over namespaces [sched-1, sched-0], 100m /
    500Mi.  Returns (nodes, init_pods, measured_pods)."""
    def terms(api):
        return {"req_anti": [_term(api, {"color": "green"}, api.LABEL_HOSTNAME,
                                   SCHED_NAMESPACES)]}

    return (_perf_nodes(wrappers, n_nodes),
            _perf_pods(wrappers, n_init, "anti-affinity-pod-", "sched-0", "green", terms),
            _perf_pods(wrappers, n_measure, "anti-affinity-pod-", "sched-1", "green", terms))


def pod_affinity_objects(wrappers, n_nodes: int, n_init: int, n_measure: int):
    """scheduler_perf's SchedulingPodAffinity workload
    (performance-config.yaml:60-88, pod-with-pod-affinity.yaml):
    node-default nodes; init pods in sched-0 and measured pods in sched-1
    of the template: label color=blue, required affinity to color=blue on
    topology.kubernetes.io/zone over namespaces [sched-1, sched-0], 100m /
    500Mi.  Returns (nodes, init_pods, measured_pods)."""
    def terms(api):
        return {"req_aff": [_term(api, {"color": "blue"}, api.LABEL_ZONE, SCHED_NAMESPACES)]}

    return (_perf_nodes(wrappers, n_nodes),
            _perf_pods(wrappers, n_init, "affinity-pod-", "sched-0", "blue", terms),
            _perf_pods(wrappers, n_measure, "affinity-pod-", "sched-1", "blue", terms))


def preferred_affinity_objects(wrappers, n_nodes: int, n_init: int, n_measure: int):
    """Upstream scheduler_perf's SchedulingPreferredPodAffinity shape
    (test/integration/scheduler_perf/config/performance-config.yaml,
    template pod-with-preferred-pod-affinity.yaml, which this repo does
    not carry): SchedulingPodAffinity's counts and namespaces with the
    template's term moved under preferredDuringScheduling, weight 1, on
    kubernetes.io/hostname over color=red; pods labelled color=red.
    Returns (nodes, init_pods, measured_pods)."""
    def terms(api):
        return {"pref_aff": [(1, _term(api, {"color": "red"}, api.LABEL_HOSTNAME,
                                       SCHED_NAMESPACES))]}

    return (_perf_nodes(wrappers, n_nodes),
            _perf_pods(wrappers, n_init, "preferred-affinity-pod-", "sched-0", "red", terms),
            _perf_pods(wrappers, n_measure, "preferred-affinity-pod-", "sched-1", "red", terms))


def mixed_churn_objects(wrappers, n_nodes: int, n_measure: int):
    """scheduler_perf's SchedulingWithMixedChurn workload
    (kubernetes_tpu/perf/config/performance-config.yaml:163-188):
    node-default nodes (4 CPU, 32Gi, 110 pods, zone-$index_mod8) and
    pod-default measured pods (100m / 500Mi).  Returns (nodes, measured,
    churn) where churn(round) gives the template's 100 recreated churn
    pods of pod-large-cpu.yaml (cpu 9, 500Mi, priority 10 — more CPU than
    any node has, so each is refused with the fit reason) under names
    fresh to that round."""
    gi, mi = wrappers.GI, wrappers.MI
    nodes = _perf_nodes(wrappers, n_nodes)
    measured = [wrappers.make_pod(f"pod-{i}").req(cpu_milli=100, mem=500 * mi).obj()
                for i in range(n_measure)]

    def churn(round_: int, n: int = 100):
        return [wrappers.make_pod(f"pod-churn-{round_}-{i}").req(cpu_milli=9000, mem=500 * mi)
                .priority(10).obj() for i in range(n)]

    return nodes, measured, churn


class Churn:
    """Seeded cluster churn: mutations and pending batches drawn from
    numpy's generator, so two instances of one seed (over this package's
    wrappers and the reference's) make the same objects and the same
    operations, given the same placements.

    nodes(n)          the initial cluster (zones, some labels and taints)
    batch(step, n)    pending pods whose static specs repeat across steps
                      (selectors, preferred terms, tolerations, host ports)
                      with a class first seen now and then
    mutate(placed)    operations after a batch: assume most placements,
                      forget some earlier ones, update a node, remove one
                      and add a fresh one
    apply(ops, *s)    run the operations against schedulers

    An operation is ("add_node", node) | ("update_node", node) |
    ("remove_node", name) | ("assume", pod, node_name) | ("forget", pod)."""

    def __init__(self, wrappers, seed: int):
        self.w = wrappers
        self.api = wrappers.api
        self.rng = np.random.default_rng(seed)
        self.live: list = []       # node names, in add order
        self.bound: list = []      # (pod, node_name) assumed, in order
        self.fresh = 0

    def _node(self, name: str, cpu: int = 8000):
        w, api, rng = self.w, self.api, self.rng
        nd = (w.make_node(name).capacity(cpu_milli=cpu, mem=16 * w.GI, pods=110)
              .zone(f"z-{int(rng.integers(0, 3))}"))
        if rng.random() < 0.3:
            nd = nd.label("disk", "ssd")
        if rng.random() < 0.2:
            nd = nd.taint("dedicated", "gpu", api.PREFER_NO_SCHEDULE)
        if rng.random() < 0.1:
            nd = nd.taint("maint", "true", api.NO_SCHEDULE)
        return nd.obj()

    def nodes(self, n: int):
        out = [self._node(f"n-{i}") for i in range(n)]
        self.live = [f"n-{i}" for i in range(n)]
        return out

    def batch(self, step: int, n: int, ports: bool = True):
        """ports=False leaves host ports out (the auction solves no batch
        that claims one)."""
        w, api, rng = self.w, self.api, self.rng
        pods = []
        for i in range(n):
            p = w.make_pod(f"s{step}-p{i}").req(
                cpu_milli=int(rng.choice([100, 250, 500])), mem=256 * w.MI)
            r = int(rng.integers(0, 8))
            if r == 0:
                p = p.required_affinity(api.LABEL_ZONE, api.OP_IN, [f"z-{i % 3}"])
            elif r == 1:
                p = p.preferred_affinity(10, "disk", api.OP_IN, ["ssd"])
            elif r == 2:
                p = p.toleration("dedicated", api.OP_EQUAL, "gpu", api.PREFER_NO_SCHEDULE)
            elif r == 3:
                p = p.toleration("maint", api.OP_EQUAL, "true", api.NO_SCHEDULE)
            elif r == 4 and ports:
                p = p.host_port(7000 + i % 4)
            elif r == 5 and rng.random() < 0.5:
                # a class first seen at this step
                p = p.preferred_affinity(1 + step, api.LABEL_ZONE, api.OP_IN, ["z-1"])
            pods.append(p.obj())
        return pods

    def mutate(self, placed):
        """Operations after a batch; `placed` is [(pod, node_name or None)]."""
        rng = self.rng
        ops = []
        for pod, name in placed:
            if name is not None and name in self.live and rng.random() < 0.6:
                ops.append(("assume", pod, name))
                self.bound.append((pod, name))
        if self.bound and rng.random() < 0.5:
            pod, _ = self.bound.pop(int(rng.integers(0, len(self.bound))))
            ops.append(("forget", pod))
        if self.live and rng.random() < 0.5:
            name = self.live[int(rng.integers(0, len(self.live)))]
            ops.append(("update_node", self._node(name, cpu=16000)))
        if len(self.live) > 4 and rng.random() < 0.3:
            name = self.live.pop(int(rng.integers(0, len(self.live))))
            gone = [b for b in self.bound if b[1] == name]
            for b in gone:
                self.bound.remove(b)
                ops.append(("forget", b[0]))
            ops.append(("remove_node", name))
            self.fresh += 1
            fresh = f"fresh-{self.fresh}"
            self.live.append(fresh)
            ops.append(("add_node", self._node(fresh)))
        return ops

    @staticmethod
    def apply(ops, *scheds) -> None:
        for op in ops:
            for s in scheds:
                getattr(s, op[0])(*op[1:])


def slice_node(wrappers, slice_name: str, x: int, y: int, z: int, dims, name=None,
               cpu: int = 4000, core=None, pods: int = 16):
    """A node of TPU slice `slice_name` at (x, y, z) of a `dims` torus
    (with `core`, one of several nodes on that coordinate)."""
    api = wrappers.api
    nw = (
        wrappers.make_node(name or f"{slice_name}-{x}{y}{z}" + (f"c{core}" if core else ""))
        .capacity(cpu_milli=cpu, mem=8 * wrappers.GI, pods=pods)
        .label(api.LABEL_TPU_SLICE, slice_name)
        .label(api.LABEL_TPU_TOPOLOGY, "x".join(map(str, dims)))
        .label(api.LABEL_TPU_COORDS, f"{x},{y},{z}")
    )
    if core is not None:
        nw.label(api.LABEL_TPU_CORE, str(core))
    return nw.obj()


def mk_slices(wrappers, n_slices: int, dims, cpu: int = 4000, prefix: str = "slice"):
    """n_slices whole slices of extent `dims`, x fastest."""
    return [
        slice_node(wrappers, f"{prefix}-{s}", x, y, z, dims, cpu=cpu)
        for s in range(n_slices)
        for z in range(dims[2])
        for y in range(dims[1])
        for x in range(dims[0])
    ]


def gang(wrappers, name: str, size: int, shape: str, cpu: int = 100, priority: int = 0):
    """A gang of `size` pods asking for one `shape` carve-out."""
    out = []
    for i in range(size):
        p = (wrappers.make_pod(f"{name}-{i}").req(cpu_milli=cpu).group(name)
             .priority(priority).obj())
        p.spec.tpu_topology = shape
        out.append(p)
    return out


def random_slice_objects(wrappers, seed: int):
    """The reference's randomized slice parity case (tests/test_slices.py
    test_randomized_topology_parity) for one seed: (nodes, pending pods,
    bound pods, policy)."""
    rng = np.random.default_rng(seed)
    policy = ["prefer", "require"][seed % 2]
    dims = tuple(int(d) for d in rng.choice([1, 2, 3], size=3) + 1)
    nodes = mk_slices(wrappers, int(rng.integers(1, 4)), dims)
    for i in range(int(rng.integers(0, 3))):
        nodes.append(wrappers.make_node(f"plain-{i}")
                     .capacity(cpu_milli=4000, mem=8 * wrappers.GI, pods=16).obj())
    bound = []
    for i, nd in enumerate(nodes):
        if rng.random() < 0.2:
            bound.append(wrappers.make_pod(f"bound-{i}").req(cpu_milli=100)
                         .node_name(nd.meta.name).obj())
    pods = []
    for g in range(int(rng.integers(1, 4))):
        shape = [int(s) for s in rng.integers(1, 4, size=3)]
        vol = shape[0] * shape[1] * shape[2]
        pods += gang(wrappers, f"g{g}", int(rng.integers(1, vol + 1)),
                     "x".join(map(str, shape)), priority=int(rng.integers(0, 3)))
    for i in range(int(rng.integers(0, 4))):
        pods.append(wrappers.make_pod(f"solo-{i}").req(cpu_milli=100).obj())
    return nodes, pods, bound, policy


class SliceChurn:
    """bench.py's c10 slice-packing churn (config10), at any slice count:
    nodes() are n_slices slices of 4x4x4 (16 CPU, 32Gi, 110 pods),
    round_pods(r) the fixed mix of 26 gangs / 208 pods, and
    depart(live) forgets half of the live gangs, drawn from numpy's
    generator of seed 10 (bench.py's), so two instances over the two
    packages' wrappers make the same objects and the same departures,
    given the same placements.  live: a list of gangs, each a list of
    (pod, node_name)."""

    DIMS = (4, 4, 4)
    MIX = (("2x2x1", 4, 12), ("2x2x2", 8, 8), ("4x2x2", 16, 4), ("4x4x1", 16, 2))

    def __init__(self, wrappers, n_slices: int = 64, seed: int = 10):
        self.w = wrappers
        self.n_slices = n_slices
        self.rng = np.random.default_rng(seed)

    def nodes(self):
        w, api = self.w, self.w.api
        d = self.DIMS
        return [
            w.make_node(f"s{s:02d}-{x}{y}{z}")
            .capacity(cpu_milli=16000, mem=32 * w.GI, pods=110)
            .label(api.LABEL_TPU_SLICE, f"slice-{s:02d}")
            .label(api.LABEL_TPU_TOPOLOGY, "4x4x4")
            .label(api.LABEL_TPU_COORDS, f"{x},{y},{z}")
            .obj()
            for s in range(self.n_slices)
            for z in range(d[2])
            for y in range(d[1])
            for x in range(d[0])
        ]

    def round_pods(self, r: int):
        pods, gid = [], 0
        for shape, size, count in self.MIX:
            for _k in range(count):
                for i in range(size):
                    p = (self.w.make_pod(f"c10-r{r}-g{gid}-{i}").req(cpu_milli=100)
                         .group(f"c10-r{r}-g{gid}").obj())
                    p.spec.tpu_topology = shape
                    pods.append(p)
                gid += 1
        return pods

    @staticmethod
    def placed_gangs(pods, names):
        """The round's placed members grouped by gang, in first-seen order."""
        by_gang = {}
        for p, n in zip(pods, names):
            if n is not None:
                by_gang.setdefault(p.spec.scheduling_group, []).append((p, n))
        return list(by_gang.values())

    def depart(self, live):
        """Shuffle `live` in place and remove the first half: the gangs
        that leave, whose members the caller forgets."""
        self.rng.shuffle(live)
        gone = live[: len(live) // 2]
        del live[: len(live) // 2]
        return gone


# -- preemption ----------------------------------------------------------------

PREEMPT_FRAC_MIB = 100_000_000 / 2**20  # 100M in MiB: not a whole MiB


def preemption_basic_objects(wrappers, n_nodes: int, n_init: int, n_measure: int):
    """scheduler_perf's PreemptionBasic (kubernetes_tpu/perf/config/
    performance-config.yaml:141-161): node-default nodes (4 CPU, 32Gi, 110
    pods, zone-$index_mod8); `n_init` pod-low-priority.yaml pods (priority
    0, 900m / 500Mi) bound round-robin — four a node at initPods = 4 x
    initNodes, the only packing a scheduler can reach, since a fifth does
    not fit —; `n_measure` pod-high-priority.yaml pods (priority 10, 3000m /
    500Mi), each of which fits nowhere (0.4 CPU free) until three victims
    of one node are evicted.  Returns (nodes, victims, preemptors)."""
    mi = wrappers.MI
    nodes = _perf_nodes(wrappers, n_nodes)
    victims = []
    for i in range(n_init):
        p = (wrappers.make_pod(f"low-{i}").req(cpu_milli=900, mem=500 * mi).priority(0)
             .node_name(nodes[i % n_nodes].meta.name).obj())
        p.status.phase = "Running"
        victims.append(p)
    preemptors = [
        wrappers.make_pod(f"high-{i}").req(cpu_milli=3000, mem=500 * mi).priority(10).obj()
        for i in range(n_measure)
    ]
    return nodes, victims, preemptors


def c9_objects(wrappers, n_nodes: int, n_preempt: int, prefix: str = "plan"):
    """bench.py's c9 preemption cluster (bench.py:971-1002): nodes of 2 CPU
    / 8Gi / 16 pods in 16 zones, one victim a node (1600m, 512Mi, priority
    i % 5, every fourth labelled app=guarded and held by a zero-budget
    PodDisruptionBudget), preemptors of 1800m / 512Mi at priorities 50,
    100 and 200 in turn.  Returns (nodes, victims, preemptors, pdb)."""
    api = wrappers.api
    gi = wrappers.GI
    nodes = [
        wrappers.make_node(f"node-{i}").capacity(cpu_milli=2000, mem=8 * gi, pods=16)
        .zone(f"zone-{i % 16}").obj()
        for i in range(n_nodes)
    ]
    victims = []
    for i in range(n_nodes):
        w = (wrappers.make_pod(f"victim-{i}").req(cpu_milli=1600, mem=gi // 2)
             .priority(i % 5).node_name(f"node-{i}"))
        if i % 4 == 0:
            w = w.labels(app="guarded")
        p = w.obj()
        p.status.phase = "Running"
        victims.append(p)
    preemptors = [
        wrappers.make_pod(f"{prefix}-{i}").req(cpu_milli=1800, mem=gi // 2)
        .priority([50, 100, 200][i % 3]).obj()
        for i in range(n_preempt)
    ]
    pdb = api.PodDisruptionBudget(
        meta=api.ObjectMeta(name="guard", namespace="default"),
        spec=api.PodDisruptionBudgetSpec(
            selector=api.LabelSelector(match_labels={"app": "guarded"})),
    )
    pdb.status.disruptions_allowed = 0
    return nodes, victims, preemptors, pdb


def dry_run_inputs(seed: int, n: int = 40, k: int = 8, r: int = 4, levels: int = 1,
                   pods: int = 8, frac: bool = False):
    """Random inputs of a batched preemption dry-run, as numpy arrays in
    PreemptionBatch's field order (free, victim_req, perm, elig_len, viol,
    pods_req, pod_level): per node a random victim count with junk (99.0)
    in the padding slots; per level a random evictable prefix (0 on some
    nodes, past the slots on one) reordered PDB-clean first with its
    violation flags; pods that fit with no eviction, after some, or never,
    with some requests at 0.  With `frac` the memory column is in
    not-whole-MiB units, so the victims' sums leave float32's exact
    range."""
    rng = np.random.default_rng(seed)
    unit = PREEMPT_FRAC_MIB if frac else 1.0
    count = rng.integers(0, k + 1, size=n)
    victim_req = np.full((n, k, r), 99.0, np.float32)
    for j in range(n):
        c = int(count[j])
        victim_req[j, :c, 0] = rng.integers(1, 16, size=c) * 100.0
        victim_req[j, :c, 1] = (rng.integers(50, 900, size=c) * unit).astype(np.float32)
        victim_req[j, :c, 2:] = 0.0
        victim_req[j, :c, r - 1] = 1.0
    free = np.zeros((n, r), np.float32)
    free[:, 0] = rng.integers(0, 8, size=n) * 100.0
    free[:, 1] = (rng.integers(0, 2000, size=n) * unit).astype(np.float32)
    free[:, r - 1] = rng.integers(0, 3, size=n)
    perm = np.tile(np.arange(k, dtype=np.int32), (levels, n, 1))
    elig_len = np.zeros((levels, n), np.int32)
    viol = np.zeros((levels, n, k), bool)
    for li in range(levels):
        for j in range(n):
            e = int(rng.integers(0, int(count[j]) + 1))
            elig_len[li, j] = e
            flags = rng.random(e) < 0.3
            order = sorted(range(e), key=lambda i: flags[i])
            perm[li, j, :e] = order
            viol[li, j, :e] = flags[order]
    elig_len[0, 0] = k + 3  # a bound past the slots
    total = victim_req[..., 1].sum(axis=1, where=np.arange(k)[None, :] < count[:, None])
    pods_req = np.zeros((pods, r), np.float32)
    for p in range(pods):
        pods_req[p, 0] = rng.integers(0, 30) * 100.0
        hi = max(float(total.max()), 1.0)
        pods_req[p, 1] = np.float32(rng.random() * hi * 0.8) if p % 4 else 0.0
        pods_req[p, r - 1] = 1.0
    pods_req[pods - 1] = 1e9  # fits nowhere
    pod_level = rng.integers(0, levels, size=pods).astype(np.int32)
    return free, victim_req, perm, elig_len, viol, pods_req, pod_level


def dry_run_edges(inputs, seed: int):
    """The batched dry-run's edges on inputs of dry_run_inputs (copies):
    at rows 1-4 of each level the bound (elig_len) is 0, 1, K - 1 and K
    over a random eviction order of every slot, its flags random, so the
    padding's junk enters the prefix at K; the last three nodes have +inf
    free memory; three more hold +inf junk at slot K // 2 (masked out:
    0 x inf is NaN from there on, as in the reference; let in: +inf)."""
    free, victim_req, perm, elig_len, viol, pods_req, pod_level = (a.copy() for a in inputs)
    rng = np.random.default_rng(seed)
    levels, n, k = perm.shape
    for li in range(levels):
        for j, e in enumerate((0, 1, k - 1, k)):
            row = 1 + j
            if row >= n - 6:
                continue
            elig_len[li, row] = e
            perm[li, row] = rng.permutation(k).astype(np.int32)
            viol[li, row] = rng.random(k) < 0.3
    free[n - 3:, 1] = np.inf
    victim_req[n - 6 : n - 3, k // 2, 1] = np.inf
    return free, victim_req, perm, elig_len, viol, pods_req, pod_level


def victim_masks(seed: int, n: int, k: int):
    """bool[N, K] victim masks of the per-pod dry-run: random (not
    prefixes), and at rows 1-4 no valid slot, one, all but one and all
    (bounds 0, 1, K - 1 and K)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, k)) < 0.7
    valid[1] = False
    valid[2] = False
    valid[2, rng.integers(k)] = True
    valid[3] = True
    valid[3, rng.integers(k)] = False
    valid[4] = True
    return valid
