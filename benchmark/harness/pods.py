"""The one pod generator every traffic mix reads.

A mix is data: a list of pod kinds, each with a count per 100,000 pods
(scaled to the size asked for) and its terms. Pods come out as plain
columns (`PodSet`) that both the program's adapter and the reference
read; each pod's (cpu, memory) is drawn from the seeded grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

CPU_GRID = ("100m", "250m", "500m", "750m", "1", "1500m", "2", "3", "4", "6")
MEM_GRID = ("128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "3Gi", "4Gi", "8Gi",
            "16Gi")
ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
NAMESPACE = "default"


def quantity(q: str) -> float:
    """A Kubernetes quantity of the grids in base units."""
    units = {"m": 1e-3, "Ki": 2.0**10, "Mi": 2.0**20, "Gi": 2.0**30}
    for suffix, scale in units.items():
        if q.endswith(suffix):
            return float(q[: -len(suffix)]) * scale
    return float(q)


CPU_VALUES = np.array([quantity(q) for q in CPU_GRID])
MEM_VALUES = np.array([quantity(q) for q in MEM_GRID])


@dataclass
class PodClass:
    """The terms every pod of a class shares (a Kubernetes pod spec's
    scheduling part). `spread`, `anti` and `affinity` hold terms of the
    form {"topology": "zone" | "hostname", "selector": {label: value}};
    `spread` adds "max_skew"."""
    prefix: str
    labels: Dict[str, str] = field(default_factory=dict)
    owner: str = ""
    tolerates: bool = True
    zones: Optional[List[str]] = None
    spread: Optional[dict] = None
    anti: Optional[dict] = None
    affinity: Optional[dict] = None


@dataclass
class PodSet:
    names: List[str]
    cpu_idx: np.ndarray   # int [n] into CPU_GRID
    mem_idx: np.ndarray   # int [n] into MEM_GRID
    cls: np.ndarray       # int [n] into classes
    classes: List[PodClass]

    def __len__(self) -> int:
        return len(self.names)

    def take(self, idx: np.ndarray) -> "PodSet":
        idx = np.asarray(idx)
        return PodSet([self.names[i] for i in idx.tolist()],
                      self.cpu_idx[idx], self.mem_idx[idx], self.cls[idx],
                      self.classes)

    def keys(self) -> List[str]:
        return [f"{NAMESPACE}/{n}" for n in self.names]

    def cpu(self) -> np.ndarray:
        return CPU_VALUES[self.cpu_idx]

    def mem(self) -> np.ndarray:
        return MEM_VALUES[self.mem_idx]


def _count(per_100k: float, n: int) -> int:
    return max(1, int(round(per_100k * n / 100_000)))


def generate(kinds: List[dict], n: int, seed: int,
             prefix: str = "") -> PodSet:
    """n pods of the mix `kinds`, shuffled, from `seed`. Kinds:

    - {"kind": "spread", "per_100k", "apps", "max_skew", "template"}:
      `apps` deployments, each spread over zones with the given skew;
      with "template" true a deployment's replicas share one pod template
      (one (cpu, memory) draw), otherwise each replica draws its own;
    - {"kind": "zone_affinity", "per_100k", "zones"}: required zone
      node affinity;
    - {"kind": "anti_hostname", "per_100k"}: one pod to a node;
    - {"kind": "anti_zone_ring", "per_100k", "apps"}: app k may not share
      a zone with app k + 1;
    - {"kind": "bundle", "per_100k", "size"}: bundles joined by required
      hostname affinity (per_100k counts bundles);
    - {"kind": "untolerated", "per_100k"}: pods that do not tolerate the
      pool's taint;
    - {"kind": "grid"}: every pod left over, plain.
    """
    rng = np.random.default_rng(seed)
    classes: List[PodClass] = []
    names: List[str] = []
    cls: List[int] = []
    templated: List[int] = []

    def add(c: PodClass, m: int) -> None:
        classes.append(c)
        names.extend(f"{prefix}{c.prefix}{i}" for i in range(m))
        cls.extend([len(classes) - 1] * m)

    for kd in kinds:
        kind = kd["kind"]
        if kind == "spread":
            for a in range(kd["apps"]):
                app = f"spread-{a}"
                add(PodClass(f"{app}-", labels={"app": app}, owner=app,
                             spread={"topology": "zone",
                                     "max_skew": kd.get("max_skew", 1),
                                     "selector": {"app": app}}),
                    _count(kd["per_100k"], n))
                if kd.get("template"):
                    templated.append(len(classes) - 1)
        elif kind == "zone_affinity":
            add(PodClass("zone-", zones=list(kd["zones"])),
                _count(kd["per_100k"], n))
        elif kind == "anti_hostname":
            add(PodClass("solo-", labels={"app": "solo"},
                         anti={"topology": "hostname",
                               "selector": {"app": "solo"}}),
                _count(kd["per_100k"], n))
        elif kind == "anti_zone_ring":
            k = kd["apps"]
            for a in range(k):
                add(PodClass(f"zanti{a}-", labels={"app": f"zanti{a}"},
                             anti={"topology": "zone",
                                   "selector": {"app": f"zanti{(a + 1) % k}"}}),
                    _count(kd["per_100k"], n))
        elif kind == "bundle":
            for b in range(_count(kd["per_100k"], n)):
                add(PodClass(f"bundle{b}-", labels={"bundle": f"b{b}"},
                             affinity={"topology": "hostname",
                                       "selector": {"bundle": f"b{b}"}}),
                    kd.get("size", 3))
        elif kind == "untolerated":
            add(PodClass("untolerated-", tolerates=False),
                _count(kd["per_100k"], n))
        elif kind == "grid":
            pass
        else:
            raise ValueError(f"unknown pod kind {kind!r}")
    rest = n - len(names)
    if rest < 0:
        raise ValueError(f"the mix's kinds need {len(names)} pods, more "
                         f"than the {n} asked for")
    if any(kd["kind"] == "grid" for kd in kinds) and rest:
        add(PodClass("p"), rest)
    m = len(names)
    ci = rng.integers(0, len(CPU_GRID), m)
    mi = rng.integers(0, len(MEM_GRID), m)
    c_arr = np.asarray(cls, np.int64)
    for k in templated:
        one = c_arr == k
        ci[one], mi[one] = ci[one][0], mi[one][0]
    order = rng.permutation(m)
    return PodSet([names[i] for i in order.tolist()], ci[order], mi[order],
                  c_arr[order], classes)
