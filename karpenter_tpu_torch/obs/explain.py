"""Decision provenance: why was my pod placed there / throttled? (the
port's copy of `karpenter_tpu/obs/explain.py`, unchanged in semantics:
the same funnel over the same host arrays, so a record equals the
reference's for the same solve).

CvxCluster's and Tesserae's placement policies (PAPERS.md) presume you
can explain an allocation decision; the reference answers "why is my
pod pending" with scheduler events. This module gives the tensor solver
the same answer: per solve, a CONSTRAINT ELIMINATION FUNNEL (instance-
type / offering counts surviving each lowering stage: resource fit ->
requirements compat -> zone mask -> capability mask -> price argmin)
plus per-pod placement records (chosen offering, runner-up, binding
constraint), queryable at `/debug/explain?pod=<ns>/<name>` and attached
to fleet/chaos reports so a starvation or divergence finding arrives
with a causal trail.

Recording is bounded and read-only: the recorder keeps an LRU of the
most recent per-pod records, skips solves larger than
`MAX_PODS_PER_SOLVE` (the 100k bench solve must not pay a per-group
funnel pass), and never mutates solver state — chaos determinism
(end-state hashes, fault fingerprints) is unchanged with it enabled.

Throttle provenance: a solve refused by the fleet's in-flight cap never
reaches the solver, so `note_throttle` records the refusal per pod; the
eventual successful solve overwrites the outcome but PRESERVES the
throttle count — the record then reads "throttled N times, finally
placed on <offering> because <binding constraint>".
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..metrics.tenant import current_tenant
from .exposition import register_debug_route

# funnel stages in elimination order (documented in docs/observability.md)
FUNNEL_STAGES = ("catalog", "resource_fit", "requirements", "zone_mask",
                 "capability_mask", "price_argmin")


class ExplainRecorder:
    """Bounded per-pod placement provenance for recent solves."""

    MAX_PODS = 65536           # process-wide per-pod record LRU bound
    MAX_PODS_PER_SOLVE = 4096  # skip funnel recording above this
    # ...and above this many encoded groups: funnel cost scales with
    # G x [T,Z,C], not pods — a 2000-signature cluster must not pay
    # 2000 offering-tensor passes per solve for diagnostics
    MAX_GROUPS_PER_SOLVE = 512

    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, pod_key) -> record dict (LRU: most recent last)
        self._pods: "OrderedDict[tuple, dict]" = OrderedDict()
        self.enabled = True
        self.stats: Dict[str, int] = {"solves": 0, "skipped": 0,
                                      "throttles": 0, "errors": 0}

    # --- recording --------------------------------------------------------
    def record_solve(self, cat, enc, out) -> None:
        """Attribute one finished facade solve: funnel per group, then a
        record per pod from the SolveOutput's placement maps. `enc` is
        the FINAL EncodedPods (post affinity/spread/relaxation) — the
        masks the backend actually solved. Defensive like the phase
        ledger: provenance must never take down the solve it explains
        (failures are counted, visible at /debug/explain)."""
        if not self.enabled:
            return
        try:
            self._record_solve(cat, enc, out)
        except Exception:  # noqa: BLE001 — observability must not crash the path it observes
            self.stats["errors"] += 1

    def _record_solve(self, cat, enc, out) -> None:
        total = int(enc.counts.sum()) if enc.G else 0
        if total > self.MAX_PODS_PER_SOLVE \
                or enc.G > self.MAX_GROUPS_PER_SOLVE:
            self.stats["skipped"] += 1
            return
        tenant = current_tenant()
        self.stats["solves"] += 1
        funnels: Dict[int, dict] = {}
        pod_group: Dict[str, int] = {}
        for gi, grp in enumerate(enc.groups):
            for p in grp.pods:
                pod_group.setdefault(f"{p.namespace}/{p.name}", gi)
        solve_seq = self.stats["solves"]

        def funnel_for(gi: int) -> dict:
            hit = funnels.get(gi)
            if hit is None:
                hit = funnels[gi] = _group_funnel(cat, enc, gi)
            return hit

        # chosen/runner-up per launched node, keyed by its pods
        for launch in out.launches:
            chosen = {"instance_type": launch.instance_type,
                      "zone": launch.zone,
                      "capacity_type": launch.capacity_type,
                      "price": launch.price}
            runner_up = None
            for row in launch.overrides:
                if (row[0], row[1], row[2]) != (launch.instance_type,
                                                launch.zone,
                                                launch.capacity_type):
                    runner_up = {"instance_type": row[0], "zone": row[1],
                                 "capacity_type": row[2], "price": row[3]}
                    break
            for key in launch.pod_keys:
                gi = pod_group.get(key)
                self._put(tenant, key, {
                    "outcome": "placed_new_node",
                    "chosen": chosen, "runner_up": runner_up,
                    "solve_seq": solve_seq,
                    "funnel": funnel_for(gi)["stages"] if gi is not None
                    else None,
                    "binding_constraint": (funnel_for(gi)["binding"]
                                           if gi is not None
                                           else "colocation_bundle"),
                })
        for node_name, keys in out.existing_placements.items():
            for key in keys:
                gi = pod_group.get(key)
                self._put(tenant, key, {
                    "outcome": "placed_existing_node", "node": node_name,
                    "solve_seq": solve_seq,
                    "funnel": funnel_for(gi)["stages"] if gi is not None
                    else None,
                    "binding_constraint": "existing_headroom",
                })
        dropped = set(enc.dropped_keys or ())
        for key in out.unschedulable:
            gi = pod_group.get(key)
            fun = funnel_for(gi) if gi is not None else None
            self._put(tenant, key, {
                "outcome": "unschedulable",
                "solve_seq": solve_seq,
                "funnel": fun["stages"] if fun else None,
                "binding_constraint": ("taints" if key in dropped
                                       else (fun["binding"] if fun
                                             else "unknown")),
            })

    def note_throttle(self, tenant: str, pod_keys: List[str]) -> None:
        """A fleet in-flight-cap refusal: the solve never ran, but the
        pods it carried deserve a trail."""
        if not self.enabled:
            return
        self.stats["throttles"] += 1
        for key in pod_keys:
            self._put(tenant, key, {"outcome": "throttled",
                                    "binding_constraint":
                                        "fleet_inflight_cap"})

    def _put(self, tenant: str, pod_key: str, record: dict) -> None:
        with self._lock:
            k = (tenant, pod_key)
            prev = self._pods.pop(k, None)
            throttles = (prev or {}).get("throttles", 0)
            if record.get("outcome") == "throttled":
                throttles += 1
            record["throttles"] = throttles
            record["tenant"] = tenant
            record["pod"] = pod_key
            self._pods[k] = record
            while len(self._pods) > self.MAX_PODS:
                self._pods.popitem(last=False)

    # --- read side --------------------------------------------------------
    def explain(self, pod_key: str,
                tenant: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            if tenant is not None:
                return self._pods.get((tenant, pod_key))
            # no tenant given: latest record for the pod across tenants
            for (t, k), rec in reversed(self._pods.items()):
                if k == pod_key:
                    return rec
        return None

    def tenant_pods(self, tenant: str,
                    outcome: Optional[str] = None) -> List[str]:
        with self._lock:
            return [k for (t, k), rec in self._pods.items()
                    if t == tenant
                    and (outcome is None or rec.get("outcome") == outcome
                         or (outcome == "throttled"
                             and rec.get("throttles", 0) > 0))]

    def payload(self, query: str = "") -> dict:
        from urllib.parse import parse_qs
        q = parse_qs(query)
        pod = (q.get("pod") or [""])[0]
        tenant = (q.get("tenant") or [None])[0]
        if pod:
            rec = self.explain(pod, tenant)
            return ({"found": True, **rec} if rec is not None
                    else {"found": False, "pod": pod})
        with self._lock:
            return {"pods_recorded": len(self._pods),
                    "stats": dict(self.stats),
                    "stages": list(FUNNEL_STAGES),
                    "usage": "/debug/explain?pod=<ns>/<name>[&tenant=t]"}

    def reset(self) -> None:
        with self._lock:
            self._pods.clear()
            self.stats = {"solves": 0, "skipped": 0, "throttles": 0,
                          "errors": 0}


def _group_funnel(cat, enc, gi: int) -> dict:
    """The elimination funnel for one encoded group: how many instance
    types / offerings survive each stage, and which stage binds. Uses
    the FINAL masks (post zone-affinity surgery and preference
    relaxation) — the problem the backend actually solved."""
    from ..ops.encode import align_resources
    T = int(cat.T)
    avail = cat.available
    alloc = align_resources(cat.allocatable, enc.requests.shape[1])
    req = enc.requests[gi]
    fits = (alloc >= req[None, :] - 1e-6).all(axis=1)
    compat = fits & enc.compat[gi]
    zmask = enc.allow_zone[gi]
    cmask = enc.allow_cap[gi]
    off_all = int(avail.sum())
    off_fit = int(avail[fits].sum())
    off_req = int(avail[compat].sum())
    o_zone = avail & compat[:, None, None] & zmask[None, :, None]
    off_zone = int(o_zone.sum())
    o_cap = o_zone & cmask[None, None, :]
    off_cap = int(o_cap.sum())
    stages = [
        {"stage": "catalog", "types": T, "offerings": off_all},
        {"stage": "resource_fit", "types": int(fits.sum()),
         "offerings": off_fit},
        {"stage": "requirements", "types": int(compat.sum()),
         "offerings": off_req},
        {"stage": "zone_mask", "types": int(o_zone.any(axis=(1, 2)).sum()),
         "offerings": off_zone},
        {"stage": "capability_mask",
         "types": int(o_cap.any(axis=(1, 2)).sum()), "offerings": off_cap},
    ]
    binding = "price"  # default: multiple offerings survived, price chose
    chosen = None
    if off_cap == 0:
        for s in stages[1:]:
            if s["offerings"] == 0:
                binding = s["stage"]
                break
        stages.append({"stage": "price_argmin", "types": 0, "offerings": 0})
    else:
        prices = np.where(o_cap, cat.price, np.inf)
        t, z, c = np.unravel_index(int(np.argmin(prices)), prices.shape)
        chosen = {"instance_type": cat.names[int(t)],
                  "zone": cat.zones[int(z)],
                  "capacity_type": cat.captypes[int(c)],
                  "price": float(prices[t, z, c])}
        stages.append({"stage": "price_argmin", "types": 1, "offerings": 1,
                       "chosen": chosen})
        if off_cap > 1:
            binding = "price"
        else:
            # exactly one survivor: the narrowest prior stage binds
            drops = [(stages[i - 1]["offerings"] - stages[i]["offerings"],
                      stages[i]["stage"])
                     for i in range(1, len(stages) - 1)]
            binding = max(drops)[1] if drops else "price"
    has_conflict = bool(enc.conflict is not None
                        and np.asarray(enc.conflict[gi]).any())
    return {"stages": stages, "binding": binding,
            "has_anti_affinity_conflict": has_conflict,
            "max_per_node": int(enc.max_per_node[gi]),
            "pods": int(enc.counts[gi])}


# THE process-wide recorder (bounded LRU; cheap enough to stay on).
RECORDER = ExplainRecorder()

register_debug_route("/debug/explain",
                     lambda rec, query: rec.payload(query),
                     owner=RECORDER)
