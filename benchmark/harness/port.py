"""The program's side: its objects built from the benchmark's plain data,
its entry points, and its answers read back as plain data.

Only the public entry points of `karpenter_tpu_torch` are used: the
models, `ops.facade.Solver`, `fleet.SolverService`, the tracer, the
transfer ledger and the delta plane's counter.
"""

from __future__ import annotations

from typing import Dict, List


def instance_types(types: List[dict]):
    """The program's InstanceTypes for the plain catalog."""
    from karpenter_tpu_torch import models as M
    from karpenter_tpu_torch.models.instancetype import Offering, Overhead
    from karpenter_tpu_torch.models.requirements import Requirements
    out = []
    for t in types:
        kube, system, evict = t["overhead"]
        out.append(M.InstanceType(
            name=t["name"],
            requirements=Requirements.from_labels(dict(t["labels"])),
            capacity=M.Resources(dict(t["capacity"])),
            overhead=Overhead(kube_reserved=M.Resources(dict(kube)),
                              system_reserved=M.Resources(dict(system)),
                              eviction_threshold=M.Resources(dict(evict))),
            offerings=[Offering(
                zone=o["zone"], capacity_type=o["capacity_type"],
                price=o["price"], reservation_id=o["reservation_id"],
                reservation_capacity=o["reservation_capacity"],
                reservation_type=o["reservation_type"])
                for o in t["offerings"]]))
    return out


def _taints(pool: dict):
    from karpenter_tpu_torch import models as M
    return [M.Taint(key=t["key"], value=t["value"], effect=t["effect"])
            for t in pool.get("taints", [])]


def _tolerations(pool: dict):
    from karpenter_tpu_torch import models as M
    return [M.Toleration(key=t["key"], value=t["value"], effect=t["effect"])
            for t in pool.get("taints", [])]


def node_pool(pool: dict):
    from karpenter_tpu_torch import models as M
    return M.NodePool(name=pool["name"], labels=dict(pool.get("labels", {})),
                      taints=_taints(pool))


def daemon_sets(daemonsets: List[dict], pool: dict):
    from karpenter_tpu_torch import models as M
    tol = _tolerations(pool)
    return [M.DaemonSet(name=d["name"],
                        tolerations=list(tol) if d.get("tolerates_pool")
                        else [],
                        requests=M.Resources.parse(dict(d["requests"])),
                        node_selector=dict(d.get("node_selector", {})))
            for d in daemonsets]


def pods(ps, pool: dict) -> list:
    """The program's Pods for a plain PodSet, in its order."""
    from karpenter_tpu_torch import models as M
    from ..harness.pods import CPU_GRID, MEM_GRID, HOSTNAME, ZONE
    topo = {"zone": ZONE, "hostname": HOSTNAME}
    tol = _tolerations(pool)
    kw = []
    for c in ps.classes:
        k = {"labels": dict(c.labels), "tolerations": list(tol)
             if c.tolerates else []}
        if c.owner:
            k["owner"] = c.owner
        if c.zones is not None:
            k["node_affinity"] = [{"key": ZONE, "operator": "In",
                                   "values": tuple(c.zones)}]
        if c.spread is not None:
            k["topology_spread"] = [M.TopologySpreadConstraint(
                topology_key=topo[c.spread["topology"]],
                max_skew=c.spread["max_skew"],
                label_selector=dict(c.spread["selector"]))]
        terms = []
        for term, anti in ((c.anti, True), (c.affinity, False)):
            if term is not None:
                terms.append(M.PodAffinityTerm(
                    topology_key=topo[term["topology"]],
                    label_selector=dict(term["selector"]), anti=anti))
        if terms:
            k["affinity_terms"] = terms
        kw.append(k)
    req = {}
    out = []
    for name, ci, mi, c in zip(ps.names, ps.cpu_idx.tolist(),
                               ps.mem_idx.tolist(), ps.cls.tolist()):
        r = req.get((ci, mi))
        if r is None:
            # every pod takes one of its node's pod slots, as the
            # kubelet counts it (models.resources.pod_requests)
            r = req[(ci, mi)] = {"cpu": CPU_GRID[ci], "memory": MEM_GRID[mi],
                                 "pods": "1"}
        k = kw[c]
        out.append(M.Pod(name=name, requests=M.Resources.parse(r),
                         labels=dict(k["labels"]),
                         tolerations=list(k["tolerations"]),
                         **{x: (list(v) if isinstance(v, list) else v)
                            for x, v in k.items()
                            if x not in ("labels", "tolerations")}))
    return out


def output(out) -> dict:
    """A SolveOutput as plain data: the launches (type, zone, capacity
    type, price, pod keys), placements onto existing nodes and the
    unschedulable keys."""
    return {"launches": [(l.instance_type, l.zone, l.capacity_type,
                          float(l.price), list(l.pod_keys))
                         for l in out.launches],
            "existing": {k: list(v) for k, v in
                         out.existing_placements.items()},
            "unschedulable": list(out.unschedulable)}


def catalog_provider(types):
    from karpenter_tpu_torch import catalog
    return catalog.CatalogProvider(lambda: types)


def decided(out) -> int:
    """Pods whose placement a SolveOutput decided."""
    return (sum(len(l.pod_keys) for l in out.launches)
            + sum(len(v) for v in out.existing_placements.values())
            + len(out.unschedulable))


def counters() -> Dict[str, float]:
    """The program's counters a per-layer metric reads."""
    from karpenter_tpu_torch.metrics import DELTA_MEMO
    from karpenter_tpu_torch.ops.solver import transfer_bytes
    return {"h2d_bytes": float(transfer_bytes()[0]),
            "delta_served": DELTA_MEMO.value(stage="solve", event="served")}


def request_span(name: str):
    """A root span of the program's tracer around one request, so that
    every span the request opens reaches the tracer's sinks (a span with
    no parent and no children is dropped); nothing when tracing is off."""
    import contextlib
    from karpenter_tpu_torch.obs.tracer import TRACER
    return TRACER.trace(name) if TRACER.enabled else contextlib.nullcontext()
