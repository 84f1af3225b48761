"""The port's spans around host work that no span of the reference covers:
the facade's output passes (`output.assign`, `output.overrides`,
`output.merge_plan` under `solve.output`), the explain recorder
(`explain.record`), the delta plane's lookup and record (`delta.lookup`,
`delta.record`), the reserved-capacity retry's pass over unschedulable
pods (`solve.reserved_retry`) and the batched path's node budget
(`solve.prep` under `fleet.batch_stage`); their phase buckets; the tracer's Chrome export on
torch.profiler's clock; and the benchmark's readers of the new spans.

Port only: the reference has none of these spans.
"""

from __future__ import annotations

import copy
import json
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.catalog import CatalogProvider, small_catalog
from karpenter_tpu_torch.fleet.service import SolverService
from karpenter_tpu_torch.integrity import INTEGRITY
from karpenter_tpu_torch.metrics import DELTA_MEMO, OVERRIDES_ROWS
from karpenter_tpu_torch.models import labels as L
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.models.instancetype import Offering
from karpenter_tpu_torch.models.pod import (Pod, PodAffinityTerm, Taint,
                                            Toleration,
                                            TopologySpreadConstraint)
from karpenter_tpu_torch.models.requirements import (Operator, Requirement,
                                                     Requirements)
from karpenter_tpu_torch.models.resources import Resources
from karpenter_tpu_torch.obs import profile as P
from karpenter_tpu_torch.obs import tracer as T
from karpenter_tpu_torch.obs.explain import RECORDER
from karpenter_tpu_torch.ops import facade as F
from karpenter_tpu_torch.ops.binpack import (SolveResult, VirtualNode,
                                            solve_host)
from karpenter_tpu_torch.ops.delta import DELTA
from karpenter_tpu_torch.ops.encode import encode_catalog, encode_pods
from karpenter_tpu_torch.ops.facade import NodeLaunch, SolveOutput, Solver
from karpenter_tpu_torch.ops.resident import RESIDENT
from karpenter_tpu_torch.utils.clock import FakeClock
from karpenter_tpu_torch.utils.profiling import maybe_trace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmark.harness import registry  # noqa: E402
from benchmark.harness.trace import SpanSums  # noqa: E402

POOL = NodePool(name="default")
CPUS = ("250m", "500m", "1", "2", "3")
MEMS = ("512Mi", "1Gi", "2Gi", "4Gi")


def _reset_planes():
    for plane in (DELTA, RESIDENT, INTEGRITY, RECORDER):
        plane.reset()


@pytest.fixture(autouse=True)
def _fresh():
    """Planes and the tracer as found: every test's memos are its own."""
    saved = (T.TRACER.enabled, T.TRACER.recorder)
    T.TRACER.recorder = T.FlightRecorder(16)
    _reset_planes()
    yield
    T.TRACER.enabled, T.TRACER.recorder = saved
    _reset_planes()


def _grid(rng: random.Random, n: int, prefix: str, **kw):
    return [Pod(name=f"{prefix}-{i}", requests=Resources.parse(
        {"cpu": rng.choice(CPUS), "memory": rng.choice(MEMS)}), **kw)
        for i in range(n)]


def _host_term(sel, anti=False):
    return PodAffinityTerm(topology_key=L.HOSTNAME, label_selector=sel,
                           anti=anti)


def _colocation_pods(seed: int = 0):
    """Bundles by hostname affinity (the colocation planner's plan),
    anti-affine pods and grid pods."""
    rng = random.Random(seed)
    pods = []
    for b in range(3):
        pods += [Pod(name=f"b{b}-{i}", labels={"bundle": f"b{b}"},
                     requests=Resources.parse({"cpu": "500m",
                                               "memory": "1Gi"}),
                     affinity_terms=[_host_term({"bundle": f"b{b}"})])
                 for i in range(3)]
    pods += _grid(rng, 4, "x", labels={"app": "x"},
                  affinity_terms=[_host_term({"app": "x"}, anti=True)])
    return pods + _grid(rng, 30, "p")


def _facade():
    types = small_catalog()
    return Solver(CatalogProvider(lambda: types), backend="device",
                  device="cpu")


class _Traces:
    """Every finished trace of the tracer, kept by a sink."""

    def __init__(self):
        self.got = []
        T.TRACER.add_sink(self.got.append)

    def __enter__(self):
        T.TRACER.configure(enabled=True)
        return self

    def __exit__(self, *exc):
        T.TRACER.configure(enabled=False)
        T.TRACER._sinks.remove(self.got.append)
        return False


def _served() -> float:
    return DELTA_MEMO.value(stage="solve", event="served")


def _named(trace, name):
    return [s for s in trace.spans if s.name == name]


def _parent(trace, span):
    return next(s for s in trace.spans if s.span_id == span.parent_id)


# --- the facade's spans ------------------------------------------------------


def test_colocation_solve_nests_the_new_spans():
    """A traced facade solve with a colocation plan: the output passes
    and the plan's merge under solve.output, in that order; the delta
    plane's lookup and record and the explain recorder under the
    request; the answer as untraced."""
    pods = _colocation_pods()
    want = _facade().solve(pods, POOL)
    with _Traces() as tr:
        with T.TRACER.trace("test.request"):
            got = _facade().solve(pods, POOL)
    assert got == want
    trace, = tr.got
    out, = _named(trace, "solve.output")
    assert [s.name for s in trace.children(out)] == [
        "output.assign", "output.overrides", "output.merge_plan"]
    top = [s.name for s in trace.children(trace.root)]
    for name in ("delta.lookup", "delta.record", "explain.record"):
        assert top.count(name) == 1, (name, top)
    assert top.index("delta.lookup") < top.index("solve.run") \
        < top.index("delta.record") < top.index("solve.output") \
        < top.index("explain.record")


def test_merge_plan_span_only_with_a_plan():
    """Plain pods: no plan, so no output.merge_plan."""
    with _Traces() as tr:
        with T.TRACER.trace("test.request"):
            _facade().solve(_grid(random.Random(1), 40, "g"), POOL)
    trace, = tr.got
    out, = _named(trace, "solve.output")
    assert [s.name for s in trace.children(out)] == ["output.assign",
                                                     "output.overrides"]


def test_explain_span_only_when_the_recorder_records(monkeypatch):
    """A solve above the recorder's pod cap is skipped, and opens no
    explain.record span."""
    monkeypatch.setattr(RECORDER, "MAX_PODS_PER_SOLVE", 10)
    with _Traces() as tr:
        with T.TRACER.trace("test.request"):
            _facade().solve(_grid(random.Random(2), 40, "g"), POOL)
    trace, = tr.got
    assert not _named(trace, "explain.record")
    assert RECORDER.stats["skipped"] == 1


def test_served_repeat_closes_the_lookup_before_its_decode():
    """The delta plane serves the repeat of an unchanged solve: no run,
    and its delta.lookup has closed before its solve.output opens; its
    decode, integrity check and explain record sit under the request,
    not under the lookup."""
    f = _facade()
    pods = _grid(random.Random(3), 40, "g")
    want = f.solve(pods, POOL)
    served = _served()
    with _Traces() as tr:
        with T.TRACER.trace("test.request"):
            got = f.solve(pods, POOL)
    assert got == want
    assert _served() == served + 1
    trace, = tr.got
    assert not _named(trace, "solve.run")
    look, = _named(trace, "delta.lookup")
    out, = _named(trace, "solve.output")
    assert look.t1 <= out.t0
    for name in ("solve.output", "integrity.verify", "explain.record"):
        span, = _named(trace, name)
        assert _parent(trace, span) is trace.root, name


def _blocked_catalog():
    """small_catalog(8) and one prepaid capacity block, so that a pool
    that does not target reserved capacity solves gated."""
    types = small_catalog(8)
    for t in types:
        if t.name == "g5.4xlarge":
            t.offerings.append(Offering(
                zone="zone-b", capacity_type=L.CAPACITY_RESERVED, price=0.0,
                reservation_id="cb-g5", reservation_capacity=2,
                reservation_type="capacity-block"))
    return types


@pytest.mark.parametrize("dropped", (0, 5))
def test_reserved_retry_span_only_with_unschedulable_pods(dropped):
    """A gated solve that leaves pods unschedulable (here: pods that do
    not tolerate the pool's taint) looks for reserved intent among them
    under solve.reserved_retry, a child of the request; one that
    schedules every pod opens no such span."""
    types = _blocked_catalog()
    f = Solver(CatalogProvider(lambda: types), backend="device",
               device="cpu")
    pool = NodePool(name="tainted", taints=[
        Taint(key="team", value="ml", effect="NoSchedule")])
    ok = _grid(random.Random(6), 20, "t", tolerations=[Toleration(
        key="team", operator="Equal", value="ml", effect="NoSchedule")])
    pods = ok + _grid(random.Random(7), dropped, "d")
    with _Traces() as tr:
        with T.TRACER.trace("test.request"):
            out = f.solve(pods, pool)
    assert len(out.unschedulable) == dropped
    trace, = tr.got
    spans = _named(trace, "solve.reserved_retry")
    assert len(spans) == (1 if dropped else 0)
    for sp in spans:
        assert _parent(trace, sp) is trace.root


def test_batched_pump_spans_the_node_budget():
    """A batched SolverService pump runs each staged request's node
    budget under solve.prep, a child of its fleet.batch_stage, with the
    shape class the serial path stamps."""
    types = small_catalog()
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    clients = [svc.register(f"t{i}", CatalogProvider(lambda: types))
               for i in range(3)]
    with _Traces() as tr:
        tickets = [c.solve_async(_grid(random.Random(i), 12, f"t{i}"), POOL)
                   for i, c in enumerate(clients)]
        svc.pump()
        for t in tickets:
            t.result()
    trace, = [t for t in tr.got if t.root.name == "fleet.pump"]
    preps = _named(trace, "solve.prep")
    assert len(preps) == 3
    for sp in preps:
        assert _parent(trace, sp).name == "fleet.batch_stage"
    assert {f"g{sp.attrs['groups_padded']}/n{sp.attrs['n_max']}"
            for sp in preps} == {t.shape_class for t in tickets}


def test_tracing_off_makes_no_span(monkeypatch):
    """With tracing off, a solve, a served repeat and a batched pump
    create no Span object."""
    made = []

    class Counting(T.Span):
        def __post_init__(self):
            made.append(self.name)
    monkeypatch.setattr(T, "Span", Counting)
    T.TRACER.configure(enabled=False)
    f = _facade()
    pods = _colocation_pods(1)
    f.solve(pods, POOL)
    plain = _grid(random.Random(4), 30, "g")
    f.solve(plain, POOL)
    served = _served()
    f.solve(plain, POOL)
    assert _served() == served + 1
    types = small_catalog()
    svc = SolverService(FakeClock(), backend="device", batch=True,
                        device="cpu")
    c = svc.register("t", CatalogProvider(lambda: types))
    ticket = c.solve_async(_grid(random.Random(5), 12, "t"), POOL)
    svc.pump()
    ticket.result()
    assert made == []


# --- the two-pass decode -----------------------------------------------------


def _one_pass_decode(self, cat, enc, result, nodepool, dropped):
    """The decode as one node loop, each launch's overrides built with
    its pods: the yardstick the two-pass `Solver._decode` must equal."""
    cursors = {}

    def take_pods(g, cnt):
        grp = enc.groups[g]
        k = id(grp)
        at = cursors.get(k, 0)
        cursors[k] = at + cnt
        return grp.pods[at: at + cnt]
    launches = []
    existing_placements = {}
    li = 0
    for node in result.nodes:
        keys = []
        reqs = Resources()
        for g, cnt in sorted(node.pods_by_group.items()):
            take = take_pods(g, cnt)
            keys.extend(F._pod_key(p) for p in take)
            for p in take:
                reqs = reqs.add(p.requests)
        if node.existing_name is not None:
            if keys:
                existing_placements[node.existing_name] = keys
            continue
        t, zi, ci, price = result.launches[li]
        li += 1
        it_name = cat.names[node.type_idx]
        labels = self._node_labels(cat, node, nodepool)
        group_compat = np.ones(cat.T, bool)
        for g in node.pods_by_group:
            group_compat &= enc.compat[g]
        launches.append(NodeLaunch(
            instance_type=it_name, zone=cat.zones[zi],
            capacity_type=cat.captypes[ci], price=price,
            overrides=self._overrides(cat, node, group_compat,
                                      nodepool.requirements),
            pod_keys=keys, requests=reqs, labels=labels))
    unschedulable = list(dropped)
    for g, cnt in result.unschedulable.items():
        unschedulable.extend(F._pod_key(p) for p in take_pods(g, cnt))
    return SolveOutput(launches=launches,
                       existing_placements=existing_placements,
                       unschedulable=unschedulable)


def _spread_pods(rng):
    return _grid(rng, 14, "h", labels={"app": "web"},
                 topology_spread=[TopologySpreadConstraint(
                     topology_key=L.ZONE, max_skew=1,
                     label_selector={"app": "web"})]) + _grid(rng, 20, "p")


def _one_shape(n, cpu, prefix):
    """n pods of one shape: FFD fills many identical full nodes."""
    return [Pod(name=f"{prefix}-{i}", requests=Resources.parse(
        {"cpu": cpu, "memory": "1Gi"})) for i in range(n)]


def _huge_pods(rng):
    return _grid(rng, 10, "p") + [Pod(name=f"big-{i}", requests=Resources.parse(
        {"cpu": "4000", "memory": "1Gi"})) for i in range(3)]


MIN_VALUES = NodePool(name="mv", requirements=Requirements(
    Requirement(L.INSTANCE_TYPE, Operator.EXISTS, min_values=6),
    Requirement(L.ZONE, Operator.EXISTS, min_values=2)))
# floors on the type, the zone and one label of the type
MIN_VALUES_LABEL = NodePool(name="mvl", requirements=Requirements(
    Requirement(L.INSTANCE_TYPE, Operator.EXISTS, min_values=6),
    Requirement(L.ZONE, Operator.EXISTS, min_values=2),
    Requirement(L.INSTANCE_FAMILY, Operator.EXISTS, min_values=3)))

DECODE_CASES = {
    "plain": (lambda rng: _grid(rng, 60, "p"), POOL),
    "colocation": (lambda rng: _colocation_pods(), POOL),
    "spread": (_spread_pods, POOL),
    "unschedulable": (_huge_pods, POOL),
    "min_values": (lambda rng: _grid(rng, 50, "p"), MIN_VALUES),
    "min_values_label": (lambda rng: _grid(rng, 50, "p"), MIN_VALUES_LABEL),
    "repeats": (lambda rng: _one_shape(90, "1", "r"), POOL),
}


def _standing_nodes(types, n: int):
    """The nodes a host solve of n grid pods opens, as existing nodes,
    each in its cheapest offering's zone."""
    cat = encode_catalog(types)
    base = solve_host(cat, encode_pods(_grid(random.Random(7), n, "res"),
                                       cat))
    for i, (node, (_, zi, _, _)) in enumerate(zip(base.nodes,
                                                  base.launches)):
        node.existing_name = f"node-{i}"
        node.zone_mask = np.arange(len(cat.zones)) == zi
    return base.nodes


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("rung", ("host", "device"))
def test_two_pass_decode_equals_the_one_pass(case, rung, monkeypatch):
    """Every decode of a solve, and of one onto existing nodes, gives a
    SolveOutput equal to the one-pass decode's: launches in the same
    order with the same overrides (each a fresh `_overrides` call's
    rows, element for element and in order, where launches with equal
    inputs share one computation), keys, requests and labels, the same
    existing placements and unschedulable pods. No two launches hold
    one list object."""
    make, pool = DECODE_CASES[case]
    calls = []
    real = Solver._decode

    def spy(self, *args):
        out = real(self, *args)
        lists = {id(launch.overrides) for launch in out.launches}
        assert len(lists) == len(out.launches)
        # as decoded: the plan's merge appends its bundles afterwards
        calls.append((self, args, copy.deepcopy(out)))
        return out
    monkeypatch.setattr(Solver, "_decode", spy)
    types = small_catalog()
    f = Solver(CatalogProvider(lambda: types), backend=rung,
               device="cpu" if rung == "device" else None)
    counted = _rows_counted()
    assert f.solve(make(random.Random(0)), pool).launches
    f.solve(make(random.Random(1)), pool,
            existing=_standing_nodes(types, 12))
    assert len(calls) == 2
    for self_, args, out in calls:
        assert _one_pass_decode(self_, *args) == out
    assert calls[1][2].existing_placements
    if case == "unschedulable":
        assert all(out.unschedulable for _, _, out in calls)
    if case == "repeats":
        assert _rows_counted(since=counted)["shared"] > 0


def _rows_counted(since=None):
    """karpenter_tpu_overrides_rows_total by event, less `since`."""
    since = since or {"computed": 0, "shared": 0}
    return {e: OVERRIDES_ROWS.value(event=e) - n for e, n in since.items()}


def _two_group_decode(differs: str):
    """A hand-made solve result of three launches of one type and one
    load: the second differs from the first in exactly one input of
    `_overrides` (its zone mask, its capacity-type mask or its group,
    whose compat row is narrower), the third equals the first."""
    types = small_catalog()
    cat = encode_catalog(types)
    req = {"cpu": "1", "memory": "1Gi"}
    pods = ([Pod(name=f"a-{i}", requests=Resources.parse(req))
             for i in range(2)]
            + [Pod(name=f"b-{i}", requests=Resources.parse(req),
                   node_selector={L.INSTANCE_FAMILY: "c5"})
               for i in range(2)])
    enc = encode_pods(pods, cat)
    ga, gb = (next(g for g, grp in enumerate(enc.groups)
                   if grp.pods[0].name.startswith(p)) for p in "ab")
    assert (enc.requests[ga] == enc.requests[gb]).all()
    assert (enc.compat[ga] != enc.compat[gb]).any()
    t = cat.names.index("c5.xlarge")
    assert enc.compat[ga][t] and enc.compat[gb][t]
    Z, C = len(cat.zones), len(cat.captypes)

    def node(group=ga, zones=Z, caps=C):
        return VirtualNode(type_idx=t, zone_mask=np.arange(Z) < zones,
                           cap_mask=np.arange(C) < caps,
                           cum=enc.requests[ga].astype(np.float32),
                           pods_by_group={group: 1})
    second = {"zone_mask": node(zones=1), "cap_mask": node(caps=1),
              "group": node(group=gb)}[differs]
    nodes = [node(), second, node()]
    result = SolveResult(nodes=nodes, unschedulable={}, launches=[
        (t, 0, 0, float(cat.price[t, 0, 0]))] * 3)
    compat = [enc.compat[next(iter(n.pods_by_group))] for n in nodes]
    return cat, enc, result, compat


@pytest.mark.parametrize("differs", ("zone_mask", "cap_mask", "group"))
def test_launches_that_differ_in_one_input_get_their_own_overrides(differs):
    """Two launches of one type and one load that differ in only their
    zone mask, capacity-type mask or group each get their own rows (a key
    that left that input out would hand the second the first's); a third
    equal to the first shares its rows, in a list of its own."""
    f = _facade()
    cat, enc, result, compat = _two_group_decode(differs)
    counted = _rows_counted()
    out = f._decode(cat, enc, result, POOL, [])
    got = [launch.overrides for launch in out.launches]
    want = [f._overrides(cat, n, c, POOL.requirements)
            for n, c in zip(result.nodes, compat)]
    assert got == want
    assert got[0] != got[1] and got[0] == got[2]
    assert got[0] is not got[2]
    assert _rows_counted(since=counted) == {"computed": 2, "shared": 1}


@pytest.mark.parametrize("pods,shares", [
    # many identical full nodes of one group
    (lambda: _one_shape(120, "1", "g"), True),
    # each pod more than half the largest type: one node each, and no two
    # with one load
    (lambda: [Pod(name=f"d-{c}", requests=Resources.parse(
        {"cpu": str(c), "memory": "1Gi"})) for c in range(17, 22)], False),
], ids=("identical", "distinct"))
@pytest.mark.parametrize("rung", ("host", "device"))
def test_overrides_counter_counts_every_launch(pods, shares, rung):
    """Every launch of the decode counts once, as computed or shared, in
    the registry's karpenter_tpu_overrides_rows_total; launches share
    rows only where their inputs repeat."""
    types = small_catalog()
    f = Solver(CatalogProvider(lambda: types), backend=rung,
               device="cpu" if rung == "device" else None)
    counted = _rows_counted()
    out = f.solve(pods(), POOL)
    counted = _rows_counted(since=counted)
    assert counted["computed"] + counted["shared"] == len(out.launches) > 0
    assert (counted["shared"] > 0) == shares


# --- the phase ledger --------------------------------------------------------


@pytest.mark.parametrize("name,bucket", [
    ("solve.output", "decode"), ("output.assign", "decode"),
    ("output.overrides", "decode"), ("output.merge_plan", "decode"),
    ("explain.record", "solver_overhead"), ("delta.lookup", "solver_overhead"),
    ("delta.record", "solver_overhead"),
    ("solve.reserved_retry", "solver_overhead")])
def test_new_spans_leave_the_queue_wait(name, bucket):
    """Under a fleet span (queue_wait) each new span's self time lands in
    its own bucket; no phase is added."""
    assert bucket in P.PHASES
    tr = T.Tracer(enabled=True, ring_size=4)
    tr.trace_dir = ""
    led = P.PhaseLedger()
    tr.add_sink(led.ingest)
    with tr.trace("fleet.dispatch", tenant="a"):
        with tr.span(name):
            x = 0
            for i in range(20000):
                x += i
    phases = led.snapshot()["phases"]["a"]["reconcile"]
    assert phases[bucket]["count"] == 1 and phases[bucket]["ms"] > 0
    assert phases["queue_wait"]["count"] == 1       # the root alone
    assert P.span_bucket(T.Span(name, "t", 1, None, 0.0), None) == bucket


# --- one clock with the device trace -----------------------------------------


@pytest.mark.parametrize("step_s", [0.0, 5.0])
def test_profiled_block_writes_its_spans_on_the_profilers_clock(
        tmp_path, monkeypatch, step_s):
    """maybe_trace writes the request's spans that close in its block into
    the Chrome trace it exports, on torch.profiler's clock: a span around
    a torch op encloses the op's event within 100 us at each end. With
    step_s, perf_counter moves against the wall clock after tracing is
    enabled and before the block (as a step of the wall clock would): the
    spans still land on the op. Best of three blocks, so that the host
    preempting the test between the span's edge and the op cannot fail
    it. The op is small enough to run on the calling thread: a larger
    one's hand-off to the intra-op pool lies inside the span and outside
    the op's event."""
    x = torch.randn(32, 32)
    x @ x
    T.TRACER.configure(enabled=True)
    real = time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: real() + step_s)
    misses = []
    try:
        for attempt in range(3):
            d = tmp_path / str(attempt)
            with T.TRACER.trace("test.request"):
                with maybe_trace(str(d)):
                    x @ x       # the profiler's first op pays its set-up
                    with T.TRACER.span("test.op"):
                        x @ x
            path, = d.glob("solve-*.json")
            events = json.loads(path.read_text())["traceEvents"]
            span, = [e for e in events if e.get("name") == "test.op"]
            assert not [e for e in events
                        if e.get("name") == "test.request"]
            op = max((e for e in events if e.get("name") == "aten::mm"),
                     key=lambda e: e["ts"])
            lead = op["ts"] - span["ts"]
            tail = (span["ts"] + span["dur"]) - (op["ts"] + op["dur"])
            if 0 <= lead <= 100 and 0 <= tail <= 100:
                break
            misses.append((lead, tail))
        else:
            pytest.fail(f"span edges off the op's by (lead, tail) us: "
                        f"{misses}")
    finally:
        T.TRACER.configure(enabled=False)


def test_profiled_block_outside_a_trace_writes_no_spans(tmp_path):
    """A span that is its own root trace is not the profiled request's:
    the block writes the profile alone."""
    T.TRACER.configure(enabled=True)
    try:
        with maybe_trace(str(tmp_path)):
            with T.TRACER.trace("test.op"):
                torch.ones(4).sum()
    finally:
        T.TRACER.configure(enabled=False)
    path, = tmp_path.glob("solve-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("name") == "test.op"]


def test_chrome_export_keeps_its_relative_clock():
    """Without a base, a file still opens at 0 on the earliest root; with
    one, a span's ts is its wall time through the given anchor, less the
    base."""
    with _Traces() as tr:
        with T.TRACER.trace("a"):
            with T.TRACER.span("b"):
                pass
    ev = T.to_chrome_events(tr.got)
    assert ev[0]["ts"] == 0.0 and {e["name"] for e in ev} == {"a", "b"}
    base_ns = 1_700_000_000 * 10**9
    wall, pc = 1_700_000_012.5, tr.got[0].root.t0 - 3.0
    based = T.to_chrome_events(tr.got, base_ns=base_ns, anchor=(wall, pc))
    assert based[0]["ph"] == "M"
    assert based[1]["ts"] == pytest.approx(15.5e6, abs=1.0)


# --- the benchmark's readers -------------------------------------------------

READERS = {"explain.record_ms": "explain.record",
           "facade.assign_ms": "output.assign",
           "facade.overrides_ms": "output.overrides",
           "delta.lookup_ms": "delta.lookup",
           "solver.budget_ms": "solve.prep"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_its_span_a_request(metric):
    """Each new reader gives its span's ms a request, and nothing where
    the span is absent or no request ran."""
    read = registry.reader(metric).read
    sums = SpanSums()
    assert read({"spans": sums, "solves": 4}) is None
    sums.total["solve.output"] = 1.0
    sums.count["solve.output"] = 4
    assert read({"spans": sums, "solves": 4}) is None
    sums.total[READERS[metric]] = 0.02
    sums.count[READERS[metric]] = 3
    assert read({"spans": sums, "solves": 4}) == pytest.approx(5.0)
    assert read({"spans": sums, "solves": 0}) is None
    entry = next(m for m in registry.spec()["per_layer"]
                 if m["name"] == metric)
    assert entry["source"] == "program_span"
    assert entry["moves"] == "pods_per_s"
