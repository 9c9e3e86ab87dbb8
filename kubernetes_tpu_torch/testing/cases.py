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
