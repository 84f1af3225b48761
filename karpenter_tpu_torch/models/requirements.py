"""Requirements set-algebra.

The port's own copy of `karpenter_tpu/models/requirements.py`, unchanged in
semantics (the port imports nothing of the JAX package).

A `Requirements` object is a conjunction of per-label-key value constraints,
with operators In / NotIn / Exists / DoesNotExist / Gt / Lt and an optional
minValues (minimum flexibility) per key. This mirrors the semantics the
reference consumes from its core module (`scheduling.Requirements`,
`NewNodeSelectorRequirementsWithMinValues` — see SURVEY.md §2.3 and the
behavioral docs in the reference's website/content/en/docs/concepts/
scheduling.md:17-31).

Internal representation per key: a `ValueSet` that is either a finite set of
strings or the complement of a finite set, plus optional numeric (gt, lt)
bounds. All operators reduce to this representation, and intersection /
non-emptiness / membership are exact — this is what the encoder
(`ops.encode`) lowers to integer-coded masks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, Iterator, Optional


class Operator(str, Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


@dataclass(frozen=True)
class ValueSet:
    """A possibly-complemented finite string set with numeric bounds.

    complement=False: allowed = values (filtered by bounds)
    complement=True:  allowed = universe - values (filtered by bounds)
    gt/lt are exclusive numeric bounds (reference Gt/Lt take integers).

    dne=True marks `DoesNotExist` — satisfied only by key absence. This is
    distinct from an empty non-complemented set WITHOUT dne, which marks an
    unsatisfiable conflict (e.g. In{a} ∩ In{b}): a conflict matches nothing,
    not even absence.
    """

    values: frozenset = frozenset()
    complement: bool = False
    gt: Optional[float] = None
    lt: Optional[float] = None
    dne: bool = False

    # --- constructors from operators ---
    @staticmethod
    def of(op: Operator, values: Iterable[str] = ()) -> "ValueSet":
        vals = frozenset(str(v) for v in values)
        if op == Operator.IN:
            return ValueSet(values=vals)
        if op == Operator.NOT_IN:
            return ValueSet(values=vals, complement=True)
        if op == Operator.EXISTS:
            return ValueSet(complement=True)
        if op == Operator.DOES_NOT_EXIST:
            return ValueSet(dne=True)
        if op == Operator.GT:
            (v,) = vals
            return ValueSet(complement=True, gt=float(v))
        if op == Operator.LT:
            (v,) = vals
            return ValueSet(complement=True, lt=float(v))
        raise ValueError(f"unknown operator {op}")

    # --- predicates ---
    def _passes_bounds(self, v: str) -> bool:
        if self.gt is None and self.lt is None:
            return True
        if not _is_number(v):
            return False
        f = float(v)
        if self.gt is not None and not f > self.gt:
            return False
        if self.lt is not None and not f < self.lt:
            return False
        return True

    def contains(self, v: str) -> bool:
        v = str(v)
        if not self._passes_bounds(v):
            return False
        return (v not in self.values) if self.complement else (v in self.values)

    def is_universe(self) -> bool:
        return self.complement and not self.values and self.gt is None and self.lt is None

    def is_empty(self) -> bool:
        """True if no value can satisfy this set (DoesNotExist or conflict).

        Gt/Lt are integer operators (reference semantics), so a complement
        set is empty iff no integer n satisfies gt < n < lt.
        """
        if self.complement:
            return self.gt is not None and self.lt is not None and self.gt + 1 >= self.lt
        return not any(self._passes_bounds(v) for v in self.values)

    def is_does_not_exist(self) -> bool:
        return self.dne

    def is_conflict(self) -> bool:
        """Unsatisfiable: matches no value and does not accept absence."""
        return (not self.dne and not self.complement and not self.values
                and self.gt is None and self.lt is None)

    # --- algebra ---
    def intersection(self, other: "ValueSet") -> "ValueSet":
        if self.dne or other.dne:
            # DoesNotExist ∩ X: stays DoesNotExist if X tolerates absence
            # (NotIn / DoesNotExist), else it's an unsatisfiable conflict.
            a, b = (self, other) if self.dne else (other, self)
            if b.dne or (b.complement and not b.is_universe()
                         and b.gt is None and b.lt is None):
                return ValueSet(dne=True)
            return ValueSet()  # conflict
        gt = max((b for b in (self.gt, other.gt) if b is not None), default=None)
        lt = min((b for b in (self.lt, other.lt) if b is not None), default=None)
        if self.complement and other.complement:
            vs = ValueSet(values=self.values | other.values, complement=True, gt=gt, lt=lt)
        elif not self.complement and not other.complement:
            vs = ValueSet(values=self.values & other.values, gt=gt, lt=lt)
        else:
            fin, comp = (self, other) if not self.complement else (other, self)
            vs = ValueSet(values=fin.values - comp.values, gt=gt, lt=lt)
        if not vs.complement:
            # normalize: drop finite members that violate bounds
            kept = frozenset(v for v in vs.values if vs._passes_bounds(v))
            vs = ValueSet(values=kept, gt=vs.gt, lt=vs.lt)
        return vs

    def intersects(self, other: "ValueSet") -> bool:
        inter = self.intersection(other)
        if inter.complement:
            return not inter.is_empty()  # contradictory Gt/Lt bounds
        return len(inter.values) > 0

    def __len__(self) -> int:
        """Count of enumerable allowed values; complements raise."""
        if self.complement:
            raise ValueError("cannot enumerate a complemented value set")
        return len(self.values)


def _tolerates_absence(want: ValueSet) -> bool:
    """Whether a constraint is satisfied by a key being absent.

    DoesNotExist: yes. NotIn(...): yes (k8s nodeAffinity semantics — an
    absent label trivially isn't in the set). Exists / In / Gt / Lt: no.
    """
    if want.is_does_not_exist():
        return True
    return (want.complement and not want.is_universe()
            and want.gt is None and want.lt is None)


@dataclass
class Requirement:
    key: str
    op: Operator
    values: tuple = ()
    min_values: Optional[int] = None

    def to_set(self) -> ValueSet:
        return ValueSet.of(self.op, self.values)


class Requirements:
    """Conjunction of per-key ValueSets with tightening semantics.

    `add` intersects with any existing constraint on the same key (the
    reference core's `Requirements.Add` tightening). A key mapping to an
    empty, non-complemented set with no bounds means DoesNotExist.
    """

    def __init__(self, *reqs: Requirement):
        self._sets: Dict[str, ValueSet] = {}
        self._min_values: Dict[str, int] = {}
        for r in reqs:
            self.add(r)

    # --- construction ---
    @classmethod
    def from_labels(cls, labels: "Dict[str, str] | None") -> "Requirements":
        r = cls()
        for k, v in (labels or {}).items():
            r.add(Requirement(k, Operator.IN, (v,)))
        return r

    @classmethod
    def from_node_selector_terms(cls, terms: Iterable[dict]) -> "Requirements":
        """Build from a list of {key, operator, values} dicts (k8s shape)."""
        r = cls()
        for t in terms:
            r.add(Requirement(t["key"], Operator(t["operator"]), tuple(t.get("values", ()))))
        return r

    def __eq__(self, other) -> bool:
        """Value equality over the constraint sets and minValues floors —
        what the wire codec's round-trip (cloud/remote.py) verifies."""
        if not isinstance(other, Requirements):
            return NotImplemented
        return (self._sets == other._sets
                and self._min_values == other._min_values)

    __hash__ = None  # mutable container semantics, like dict/list

    def add(self, req: Requirement) -> "Requirements":
        vs = req.to_set()
        if req.key in self._sets:
            vs = self._sets[req.key].intersection(vs)
        self._sets[req.key] = vs
        if req.min_values is not None:
            self._min_values[req.key] = max(self._min_values.get(req.key, 0), req.min_values)
        return self

    def union_with(self, other: "Requirements") -> "Requirements":
        """Conjunction of two Requirements (tightening merge)."""
        out = self.copy()
        for k, vs in other._sets.items():
            out._sets[k] = out._sets[k].intersection(vs) if k in out._sets else vs
        for k, mv in other._min_values.items():
            out._min_values[k] = max(out._min_values.get(k, 0), mv)
        return out

    def copy(self) -> "Requirements":
        out = Requirements()
        out._sets = dict(self._sets)
        out._min_values = dict(self._min_values)
        return out

    # --- access ---
    def keys(self) -> Iterator[str]:
        return iter(self._sets.keys())

    def get(self, key: str) -> Optional[ValueSet]:
        return self._sets.get(key)

    def min_values(self, key: str) -> Optional[int]:
        return self._min_values.get(key)

    def has(self, key: str) -> bool:
        return key in self._sets

    def __contains__(self, key: str) -> bool:
        return key in self._sets

    def __len__(self) -> int:
        return len(self._sets)

    def single_values(self) -> Dict[str, str]:
        """Keys pinned to exactly one value -> node labels (reference:
        pkg/cloudprovider/cloudprovider.go instanceToNodeClaim derives node
        labels from single-valued requirements the same way)."""
        out = {}
        for k, vs in self._sets.items():
            if not vs.complement and len(vs.values) == 1:
                (out[k],) = vs.values
        return out

    # --- compatibility ---
    def compatible(self, provided: "Requirements") -> bool:
        """True if something satisfying `provided` can satisfy self.

        `provided` describes what a node/instance-type WILL offer (its label
        value sets); self is the demand side (pod / nodepool constraints).
        For each of self's keys: if provided has the key, the sets must
        intersect; if provided lacks the key, self's set must allow absence
        (NotIn/DoesNotExist/Exists-negative semantics: only DoesNotExist and
        NotIn/complement sets tolerate absence).
        """
        for k, want in self._sets.items():
            have = provided._sets.get(k)
            if have is None:
                if not _tolerates_absence(want):
                    return False
            else:
                if want.is_does_not_exist():
                    return False
                if not want.intersects(have):
                    return False
        return True

    def intersect_ok(self, other: "Requirements") -> bool:
        """Symmetric non-empty-intersection check on shared keys only."""
        for k, a in self._sets.items():
            b = other._sets.get(k)
            if b is not None and not a.intersects(b):
                return False
        return True

    def labels_satisfy(self, labels: Dict[str, str]) -> bool:
        """Check concrete labels (a live node) against self."""
        for k, want in self._sets.items():
            if k in labels:
                if want.is_does_not_exist() or not want.contains(labels[k]):
                    return False
            else:
                if not _tolerates_absence(want):
                    return False
        return True

    def __repr__(self) -> str:
        parts = []
        for k, vs in sorted(self._sets.items()):
            if vs.is_universe():
                parts.append(f"{k} Exists")
            elif vs.is_does_not_exist():
                parts.append(f"{k} DoesNotExist")
            elif vs.complement:
                b = ""
                if vs.gt is not None:
                    b += f" >{vs.gt:g}"
                if vs.lt is not None:
                    b += f" <{vs.lt:g}"
                parts.append(f"{k} NotIn{sorted(vs.values)}{b}")
            else:
                parts.append(f"{k} In{sorted(vs.values)}")
        return f"Requirements({', '.join(parts)})"
