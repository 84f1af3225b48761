"""Interruption wire format: raw cloud-event JSON → typed messages.

The port's own copy of `karpenter_tpu/cloud/messages.py`, unchanged in
semantics.

The interruption queue delivers RAW BYTES from the cloud's event bus —
malformed payloads, unknown event schemas, and duplicate deliveries are
normal operating conditions, not exceptions. This module owns that
boundary: a versioned envelope keyed by (version, source, detail-type)
routes to per-kind detail parsers; anything unrecognized degrades to a
no-op message instead of crashing the consumer.

Reference: pkg/controllers/interruption/parser.go (parser registry keyed
on Version/Source/DetailType, unknown key → noop.Message) and
messages/{spotinterruption,rebalancerecommendation,scheduledchange,
statechange}/*.go (per-kind detail schemas and acceptance filters).
The envelope mirrors the reference's EventBridge metadata shape with
cloud-neutral sources (compute./health.karpenter.tpu).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# message kinds (reference messages/types.go Kind constants)
SPOT_INTERRUPTION = "spot-interruption"
REBALANCE_RECOMMENDATION = "rebalance-recommendation"
SCHEDULED_CHANGE = "scheduled-change"
STATE_CHANGE = "state-change"
NOOP = "no-op"

SOURCE_COMPUTE = "compute.karpenter.tpu"
SOURCE_HEALTH = "health.karpenter.tpu"

# states that mean capacity is going away (statechange/parser.go:27 —
# anything else, e.g. pending/running, parses to a no-op)
ACCEPTED_STATES = {"stopping", "stopped", "shutting-down", "terminated"}


class ParseError(Exception):
    """The payload claims a known schema but violates it (bad JSON, wrong
    envelope shape, missing required detail fields)."""


@dataclass
class Metadata:
    """Envelope fields common to every event (messages/types.go Metadata).
    Plain dataclass, not frozen: frozen __init__ goes through
    object.__setattr__ per field, which is measurable at 15k-msg/drain
    queue benchmarks (interruption_benchmark_test.go's grid)."""

    version: str = ""
    source: str = ""
    detail_type: str = ""
    id: str = ""
    time: float = 0.0
    resources: Tuple[str, ...] = ()


@dataclass
class ParsedMessage:
    kind: str
    instance_ids: Tuple[str, ...]
    metadata: Metadata

    @property
    def start_time(self) -> float:
        return self.metadata.time


def _noop(md: Metadata) -> ParsedMessage:
    return ParsedMessage(kind=NOOP, instance_ids=(), metadata=md)


def _require(detail: dict, key: str, detail_type: str) -> object:
    try:
        v = detail[key]
    except (KeyError, TypeError):
        raise ParseError(f"{detail_type}: detail missing required {key!r}")
    if not v:
        raise ParseError(f"{detail_type}: detail field {key!r} is empty")
    return v


def _parse_spot(md: Metadata, detail: dict) -> ParsedMessage:
    iid = _require(detail, "instance-id", md.detail_type)
    return ParsedMessage(SPOT_INTERRUPTION, (str(iid),), md)


def _parse_rebalance(md: Metadata, detail: dict) -> ParsedMessage:
    iid = _require(detail, "instance-id", md.detail_type)
    return ParsedMessage(REBALANCE_RECOMMENDATION, (str(iid),), md)


def _parse_state_change(md: Metadata, detail: dict) -> ParsedMessage:
    iid = _require(detail, "instance-id", md.detail_type)
    state = str(detail.get("state", "")).lower()
    if state not in ACCEPTED_STATES:
        return _noop(md)  # e.g. pending/running: nothing to react to
    return ParsedMessage(STATE_CHANGE, (str(iid),), md)


def _parse_scheduled_change(md: Metadata, detail: dict) -> ParsedMessage:
    # only compute-service scheduledChange health events are actionable
    # (scheduledchange/parser.go:30-36 accepts service EC2 + category
    # scheduledChange, anything else → nil/noop)
    if (detail.get("service") != "COMPUTE"
            or detail.get("event-type-category") != "scheduledChange"):
        return _noop(md)
    entities = detail.get("affected-entities")
    if not isinstance(entities, list) or not entities:
        raise ParseError(f"{md.detail_type}: no affected-entities")
    ids = []
    for e in entities:
        if not isinstance(e, dict) or not e.get("entity-value"):
            raise ParseError(f"{md.detail_type}: malformed affected-entity")
        ids.append(str(e["entity-value"]))
    return ParsedMessage(SCHEDULED_CHANGE, tuple(ids), md)


# (version, source, detail-type) → detail parser (parser.go parserKey)
_PARSERS: Dict[Tuple[str, str, str],
               Callable[[Metadata, dict], ParsedMessage]] = {
    ("0", SOURCE_COMPUTE, "Spot Interruption Warning"): _parse_spot,
    ("0", SOURCE_COMPUTE, "Instance Rebalance Recommendation"):
        _parse_rebalance,
    ("0", SOURCE_COMPUTE, "Instance State-change Notification"):
        _parse_state_change,
    ("0", SOURCE_HEALTH, "Health Event"): _parse_scheduled_change,
}


def parse(raw) -> ParsedMessage:
    """Raw queue payload (bytes or str) → ParsedMessage.

    Raises ParseError for payloads that are garbage or violate a known
    schema; returns a NOOP message for empty payloads and well-formed
    events of unknown (version, source, detail-type) — forward
    compatibility with event kinds this build doesn't know."""
    if isinstance(raw, (bytes, bytearray)):
        try:
            raw = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ParseError(f"undecodable payload: {e}")
    if not isinstance(raw, str):
        raise ParseError(f"payload must be bytes or str, got {type(raw)}")
    if not raw.strip():
        return _noop(Metadata())
    try:
        obj = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ParseError(f"invalid JSON: {e}")
    if not isinstance(obj, dict):
        raise ParseError(f"envelope must be an object, got {type(obj)}")
    # hot path: well-formed envelopes carry str fields already — look up
    # the parser on the raw values and coerce defensively only on the
    # slow (noop / malformed) path. str-coercing every field cost ~25%
    # of the 15k-message drain benchmark.
    ver = obj.get("version", "")
    src = obj.get("source", "")
    dt = obj.get("detail-type", "")
    t = obj.get("time", 0.0)
    if type(t) is not float:
        try:
            t = float(t or 0.0)
        except (TypeError, ValueError):
            t = 0.0
    res = obj.get("resources")
    md = Metadata(
        version=ver if type(ver) is str else str(ver),
        source=src if type(src) is str else str(src),
        detail_type=dt if type(dt) is str else str(dt),
        id=str(obj.get("id", "")),
        time=t,
        resources=tuple(str(r) for r in res) if isinstance(res, list) else ())
    parser = _PARSERS.get((md.version, md.source, md.detail_type))
    if parser is None:
        return _noop(md)
    detail = obj.get("detail")
    if not isinstance(detail, dict):
        raise ParseError(f"{md.detail_type}: missing detail object")
    return parser(md, detail)


# --- envelope factories: what a real event bus would emit; the fake cloud
# uses these so the controller consumes genuine wire bytes ---

_counter = [0]


def _envelope(source: str, detail_type: str, detail: dict, time: float,
              resources: Optional[List[str]] = None,
              msg_id: Optional[str] = None) -> str:
    _counter[0] += 1
    return json.dumps({
        "version": "0",
        "id": msg_id or f"evt-{_counter[0]:08d}",
        "source": source,
        "detail-type": detail_type,
        "time": time,
        "resources": resources or [],
        "detail": detail,
    })


def spot_interruption_event(instance_id: str, provider_id: str,
                            time: float, **kw) -> str:
    return _envelope(SOURCE_COMPUTE, "Spot Interruption Warning",
                     {"instance-id": instance_id,
                      "instance-action": "terminate"},
                     time, resources=[provider_id], **kw)


def rebalance_recommendation_event(instance_id: str, provider_id: str,
                                   time: float, **kw) -> str:
    return _envelope(SOURCE_COMPUTE, "Instance Rebalance Recommendation",
                     {"instance-id": instance_id},
                     time, resources=[provider_id], **kw)


def state_change_event(instance_id: str, provider_id: str, state: str,
                       time: float, **kw) -> str:
    return _envelope(SOURCE_COMPUTE, "Instance State-change Notification",
                     {"instance-id": instance_id, "state": state},
                     time, resources=[provider_id], **kw)


def scheduled_change_event(instance_ids: List[str],
                           provider_ids: List[str], time: float,
                           **kw) -> str:
    return _envelope(
        SOURCE_HEALTH, "Health Event",
        {"service": "COMPUTE", "event-type-category": "scheduledChange",
         "affected-entities": [{"entity-value": i} for i in instance_ids]},
        time, resources=list(provider_ids), **kw)
