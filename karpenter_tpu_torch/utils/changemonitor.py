"""ChangeMonitor: log-once-per-change dedupe.

The port's own copy of `karpenter_tpu/utils/changemonitor.py`, unchanged
in semantics.

Reference: `pretty.ChangeMonitor` (used at instancetype.go:261-266,305-321)
— noisy periodic reconciles log "discovered X" only when X actually
changed, with a TTL so steady-state re-logs occasionally.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Tuple

from .clock import Clock, RealClock


class ChangeMonitor:
    def __init__(self, ttl: float = 24 * 3600, clock: Optional[Clock] = None):
        self.ttl = ttl
        self.clock = clock or RealClock()
        self._seen: Dict[str, Tuple[str, float]] = {}

    def has_changed(self, key: str, value: Any) -> bool:
        """True (and remembers) if value differs from last call or the TTL
        lapsed — callers log only on True."""
        digest = hashlib.sha256(
            json.dumps(value, sort_keys=True, default=str).encode()).hexdigest()
        now = self.clock.now()
        prev = self._seen.get(key)
        if prev is not None and prev[0] == digest and now - prev[1] < self.ttl:
            return False
        self._seen[key] = (digest, now)
        return True
