"""Federation plane: the fleet across a real process boundary.

The port's own copy of `karpenter_tpu/federation/` (the same modules and
exports). A `SolverServer` (server.py) hosts the one real solver stack —
device-resident catalogs and the batched dispatcher, one launch each of
kernels B0 and B per bucket on the card — and N fleet processes, each a
full TenantShard stack on its own store/journal/warm path, reach it
through a `FederatedSolverClient` (client.py) over the `cloud/remote.py`
wire layer (the same codec, error taxonomy, and schema-version handshake
the remote CloudProvider rides).

The split line is deliberate: clients keep the ENTIRE host-side solve
path — catalog views, encode, spread, integrity oracle, warm path,
decode — and ship only the packed device-dispatch payload (the [B, Gp,
W] request stack the batched dispatcher would have uploaded anyway).
The server runs exactly `ops/solver.dispatch_packed` and returns the
raw packed rows; the client decodes them with its own catalogs. A
federated solve and an in-process solve therefore share every byte of
the encode/decode path, which is how the three-digest determinism
contract (state hash, fault fingerprint, load fingerprint) crosses the
process boundary unchanged. The frames are the reference's byte for
byte, so either package's client talks to either package's server.

Catalog tensors cross the wire ONCE PER CLUSTER: content-keyed
`SharedCatalogCache` tokens become the cross-process protocol — a
client announces its token first and ships tensor bytes only on server
miss; ICE/price divergence re-fingerprints into a new token and re-keys
automatically, exactly like the in-process view split.

Failure ladder: a wire error degrades exactly the affected bucket to
its tickets' own facades, arms a count-based cooldown so the next
buckets don't spin on a dead server, and surfaces on the watchdog's
`federation_degraded` invariant before any SLO burns.
"""

from .client import (FederatedSolverClient, FederatedSolverService,
                     build_federated_service)
from .envelopes import (AdmissionVerdictEnvelope, CatalogUploadEnvelope,
                        HandshakeEnvelope, IntegrityVerdictEnvelope,
                        ReportAck, SolveBucketRequest, SolveBucketResult,
                        WatchdogFindingEnvelope, decode_envelope,
                        encode_envelope)
from .server import SolverServer, make_fed_server
from .transport import HTTPTransport, InMemoryTransport

__all__ = [
    "AdmissionVerdictEnvelope", "CatalogUploadEnvelope",
    "FederatedSolverClient", "FederatedSolverService", "HTTPTransport",
    "HandshakeEnvelope", "InMemoryTransport", "IntegrityVerdictEnvelope",
    "ReportAck", "SolveBucketRequest", "SolveBucketResult", "SolverServer",
    "WatchdogFindingEnvelope", "build_federated_service",
    "decode_envelope", "encode_envelope", "make_fed_server",
]
