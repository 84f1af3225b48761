"""Run-stamped wire envelopes for the federation plane.

The port's own copy of `karpenter_tpu/federation/envelopes.py`: the same
classes, the same codec (the port's `cloud/remote`) and the same bytes on
the wire, so either package decodes the other's frames.

Everything that crosses the process boundary rides one of the frozen
dataclasses below, wrapped in a `{"__fed__": <classname>, "f": {...}}`
dict by `encode_envelope` so the receiving end can reconstruct the
exact type without guessing from shape. Field values are encoded with
the `cloud/remote.py` codec (tuples survive as tuples, dataclass
payloads round-trip), which keeps the federation plane on the same
wire dialect — and the same schema-version handshake — as the remote
CloudProvider.

Two stamps appear on every envelope:

- ``schema``: the `WIRE_SCHEMA_VERSION` the sender speaks. The server
  rejects skew with `WireVersionError` before touching the body, so a
  v1 client never half-parses a v2 reply (cloud/remote.py owns the
  version; federation does not fork it).
- ``run_id``: the run stamp of the fleet run this envelope belongs
  to. Derived from the scenario seed, never from wall clock —
  a replayed run produces byte-identical envelopes, which is what lets
  the cross-process determinism tests hash them.

Numpy tensors travel as `pack_array` dicts: dtype string, shape tuple,
and base64 of the C-contiguous bytes. Base64 over JSON is ~4/3 the
tensor size; chip_smoke.py prints the measured wire-bytes-to-tensor-
bytes ratio (`c17_wire_overhead_frac`) so the overhead stays visible.

Compression is a pack_array-internal affair, not a schema change: a
sender that learned (via the handshake's ``compress`` capability) that
its peer decodes zlib may pass ``compress=True``, which adds ``"z": 1``
to the dict and base64s the DEFLATE stream instead of the raw bytes.
`unpack_array` handles both forms unconditionally, so capability skew
is one-directional and safe: an old server simply never advertises,
an old client simply never sets the flag, and either way the bytes
decode. Solver gbufs are mostly padding zeros, so the win is large;
payloads the codec cannot shrink (or under the 512-byte floor) stay
uncompressed even when asked.
"""

from __future__ import annotations

import base64
import zlib
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Optional, Tuple

import numpy as np

from ..cloud import remote as wire

# tensors smaller than this never compress: the DEFLATE header + the
# CPU spent are not worth shaving a few wire bytes off a row vector
COMPRESS_MIN_BYTES = 512

# ---------------------------------------------------------------------------
# numpy <-> base64


def pack_array(arr, compress: bool = False) -> dict:
    """Encode an ndarray as a JSON-safe dict (dtype, shape, base64 bytes).

    ``compress=True`` (only pass it when the peer's handshake advertised
    the ``compress`` capability) zlib-deflates the raw bytes first and
    marks the dict with ``"z": 1`` — skipped when the tensor is tiny or
    the stream would not actually shrink."""
    a = np.ascontiguousarray(arr)
    out = {
        "dtype": str(a.dtype),
        "shape": tuple(int(d) for d in a.shape),
    }
    raw = a.tobytes()
    if compress and len(raw) >= COMPRESS_MIN_BYTES:
        z = zlib.compress(raw, 1)
        if len(z) < len(raw):
            out["z"] = 1
            out["b64"] = base64.b64encode(z).decode("ascii")
            return out
    out["b64"] = base64.b64encode(raw).decode("ascii")
    return out


def unpack_array(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["b64"])
    if obj.get("z"):
        raw = zlib.decompress(raw)
    a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
    return a.reshape(tuple(obj["shape"])).copy()


def packed_wire_bytes(obj: Optional[dict]) -> int:
    """Actual base64 payload size of a pack_array dict as it rides the
    wire — compression-aware, unlike `tensor_bytes` (the logical
    numerator vs denominator of the compression ratio)."""
    if not obj:
        return 0
    return len(obj.get("b64", ""))


def tensor_bytes(obj: Optional[dict]) -> int:
    """Raw (pre-base64) tensor payload size of a pack_array dict."""
    if not obj:
        return 0
    n = int(np.dtype(obj["dtype"]).itemsize)
    for d in obj["shape"]:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# envelope classes


@dataclass(frozen=True)
class HandshakeEnvelope:
    """Client introduces itself: schema + run stamp + process name."""

    schema: int
    run_id: str
    process: str


@dataclass(frozen=True)
class CatalogUploadEnvelope:
    """Catalog tensors, shipped only after a token-announce MISS.

    ``token`` is the content-keyed SharedCatalogCache token — ("shared",
    nc_hash, fingerprint) — so the server's store is keyed by catalog
    CONTENT, not by which client happened to upload it. The arrays are
    exactly what `ops/solver.device_catalog` would have staged: aligned
    allocatable/price/availability matrices and the per-zone overhead
    vector for R resource columns.
    """

    schema: int
    run_id: str
    process: str
    token: Tuple[Any, ...]
    alloc: dict
    price: dict
    avail: dict
    ovh_z: dict
    R: int


@dataclass(frozen=True)
class SolveBucketRequest:
    """One batched-dispatch bucket: the device payload, nothing else.

    ``gbuf`` is the packed [B, Gp, W] request stack the in-process
    dispatcher would have uploaded; ``statics`` the jit static args
    (n_max/k_max/cols/track_conflicts/zone_ovh); ``conf`` the optional
    conflict matrices. The server never sees catalogs views, encodings,
    or tenant stores — only this.
    """

    schema: int
    run_id: str
    process: str
    token: Tuple[Any, ...]
    shape_class: str
    Gp: int
    B: int
    statics: dict
    gbuf: dict
    conf: Optional[dict]
    tenants: Tuple[str, ...]


@dataclass(frozen=True)
class SolveBucketResult:
    """Raw packed int32 result rows; the CLIENT decodes them."""

    schema: int
    run_id: str
    rows: dict
    span_s: float
    padded: int


@dataclass(frozen=True)
class AdmissionVerdictEnvelope:
    """A shard's admission decision, mirrored to the server ledger."""

    schema: int
    run_id: str
    process: str
    tenant: str
    action: str
    reason: str


@dataclass(frozen=True)
class IntegrityVerdictEnvelope:
    """A client-side integrity-oracle verdict crossing the wire."""

    schema: int
    run_id: str
    process: str
    tenant: str
    check: str
    ok: bool
    detail: str


@dataclass(frozen=True)
class WatchdogFindingEnvelope:
    """A watchdog finding, mirrored so the cluster sees one ledger."""

    schema: int
    run_id: str
    process: str
    invariant: str
    severity: str
    key: str
    message: str


@dataclass(frozen=True)
class ReportAck:
    """Server acknowledgement for a report upload (count accepted)."""

    schema: int
    run_id: str
    accepted: int


ENVELOPE_TYPES = {
    cls.__name__: cls
    for cls in (
        HandshakeEnvelope, CatalogUploadEnvelope, SolveBucketRequest,
        SolveBucketResult, AdmissionVerdictEnvelope,
        IntegrityVerdictEnvelope, WatchdogFindingEnvelope, ReportAck,
    )
}


def encode_envelope(env) -> dict:
    if not is_dataclass(env) or type(env).__name__ not in ENVELOPE_TYPES:
        raise TypeError(f"not a federation envelope: {type(env).__name__}")
    return {
        "__fed__": type(env).__name__,
        "f": {f.name: wire.encode(getattr(env, f.name)) for f in fields(env)},
    }


def decode_envelope(obj: dict):
    cls = ENVELOPE_TYPES.get(obj.get("__fed__", ""))
    if cls is None:
        raise ValueError(f"unknown federation envelope: {obj.get('__fed__')!r}")
    return cls(**{k: wire.decode(v) for k, v in obj["f"].items()})
