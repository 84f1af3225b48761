"""Clock, TTL cache and cron windows (the port's copies of
`karpenter_tpu.utils`' framework-free helpers) and the profiling hook."""

from .cache import TTLCache
from .clock import Clock, FakeClock, RealClock

__all__ = ["TTLCache", "Clock", "FakeClock", "RealClock"]
