"""Cloud API metering middleware — the aws-sdk-go-prometheus analog.

The port's own copy of `karpenter_tpu/cloud/metering.py`, semantics unchanged.

The reference wires a Prometheus middleware into the AWS SDK config so
every SDK call exports duration + error metrics
(pkg/operator/operator.go:98; families in website reference/metrics.md's
cloudprovider group). Here the same seam is the CloudProvider protocol
boundary: MeteredCloud wraps the WIRE-level cloud — below the batcher,
so one coalesced wire call is one observation, exactly like the SDK
middleware sits below the reference's request coalescing.

create_fleet reports partial failures in-band (a list mixing Instances
and CloudErrors, mirroring CreateFleet's per-item error array); those
count as errors too — an ICE storm must be visible on the error counter
even though nothing raises.
"""

from __future__ import annotations

import time

from ..metrics import CLOUD_API_DURATION, CLOUD_API_ERRORS
from .provider import CloudError

# the CloudProvider protocol's wire surface (cloud/provider.py:157-196);
# anything else (clock, instances, tick, snapshot/restore, callbacks) is
# simulation plumbing and passes through unmetered
_API_METHODS = frozenset({
    "create_fleet", "terminate", "describe", "describe_types",
    "describe_images", "describe_nodes", "describe_network_groups",
    "create_profile", "delete_profile", "update_profile_role",
    "describe_profiles", "poll_interruptions", "delete_message",
    "describe_spot_prices", "describe_zone_capacity", "expire_reservation",
})


class MeteredCloud:
    """Transparent CloudProvider wrapper timing every wire call."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name not in _API_METHODS or not callable(attr):
            return attr

        inner = self._inner

        def call(*args, __name=name, **kwargs):
            # resolve per call: swapping/monkeypatching a method on the
            # wrapped cloud (test seams, snapshot-restore) must take
            # effect — a captured bound method would silently pin the old
            # one. One attribute lookup per call.
            t0 = time.perf_counter()
            try:
                out = getattr(inner, __name)(*args, **kwargs)
            except Exception as e:
                CLOUD_API_DURATION.observe(time.perf_counter() - t0,
                                           method=__name)
                CLOUD_API_ERRORS.inc(method=__name,
                                     error=type(e).__name__)
                raise
            CLOUD_API_DURATION.observe(time.perf_counter() - t0,
                                       method=__name)
            if __name == "create_fleet":
                for item in out:
                    if isinstance(item, CloudError):
                        CLOUD_API_ERRORS.inc(method=__name,
                                             error=type(item).__name__)
            return out

        # cache on the instance so __getattr__ (and the wrapper build)
        # runs once per method, not once per call
        object.__setattr__(self, name, call)
        return call
