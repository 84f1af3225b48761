"""TTL cache.

Reference parity: pkg/cache/cache.go:19-65 defines per-provider TTLs
(instance types 5m, offerings 5m, SSM 24h, discovered capacity 60d, ...).
Ours takes an injectable clock so tests can step time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from .clock import Clock, RealClock

# TTL constants (seconds) — mirrors pkg/cache/cache.go
INSTANCE_TYPES_TTL = 5 * 60
OFFERINGS_TTL = 5 * 60
UNAVAILABLE_OFFERINGS_TTL = 3 * 60
PRICING_REFRESH = 12 * 3600
IMAGE_RESOLUTION_TTL = 24 * 3600
DISCOVERED_CAPACITY_TTL = 60 * 24 * 3600


class TTLCache:
    def __init__(self, ttl: float, clock: Optional[Clock] = None):
        self.ttl = ttl
        self.clock = clock or RealClock()
        self._store: Dict[Any, Tuple[float, Any]] = {}

    def get(self, key: Any) -> Optional[Any]:
        ent = self._store.get(key)
        if ent is None:
            return None
        exp, val = ent
        if self.clock.now() >= exp:
            del self._store[key]
            return None
        return val

    def set(self, key: Any, value: Any, ttl: Optional[float] = None) -> None:
        self._store[key] = (self.clock.now() + (ttl if ttl is not None else self.ttl), value)

    def get_or_set(self, key: Any, fn: Callable[[], Any]) -> Any:
        v = self.get(key)
        if v is None:
            v = fn()
            self.set(key, v)
        return v

    def delete(self, key: Any) -> None:
        self._store.pop(key, None)

    def prune(self) -> int:
        """Evict expired entries; returns how many were removed (callers
        that version their contents — the ICE cache — bump on expiry)."""
        now = self.clock.now()
        expired = [k for k, (exp, _) in self._store.items() if now >= exp]
        for k in expired:
            del self._store[k]
        return len(expired)

    def flush(self) -> None:
        self._store.clear()

    def items(self):
        now = self.clock.now()
        return [(k, v) for k, (exp, v) in self._store.items() if now < exp]

    def __len__(self) -> int:
        return len(self.items())
