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
shows).
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
