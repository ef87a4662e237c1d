"""Global EWMA metric registry — DelayProfiler analog.

Re-creation of ``src/edu/umass/cs/utils/DelayProfiler.java:11,61-165``:
string-keyed exponentially-weighted moving averages, rates, and counters,
dumped as a single stats line.  Used on the hot host path, so updates are
lock-light (a single dict with per-key tuples; GIL-atomic enough for stats).
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class DelayProfiler:
    _lock = threading.Lock()
    _avgs: Dict[str, float] = {}
    _counts: Dict[str, float] = {}
    _rates: Dict[str, tuple] = {}  # key -> (ewma_rate, last_ts)
    ALPHA = 1.0 / 16  # reference uses ~1/10..1/100 depending on call site

    @classmethod
    def update_delay(cls, key: str, t0: float, n: int = 1) -> None:
        """Record elapsed seconds since t0 (divided over n samples)."""
        cls.update_mov_avg(key, (time.monotonic() - t0) / max(n, 1))

    @classmethod
    def update_mov_avg(cls, key: str, sample: float) -> None:
        with cls._lock:
            old = cls._avgs.get(key)
            cls._avgs[key] = (
                sample if old is None else (1 - cls.ALPHA) * old + cls.ALPHA * sample
            )

    @classmethod
    def update_count(cls, key: str, n: float = 1) -> None:
        with cls._lock:
            cls._counts[key] = cls._counts.get(key, 0) + n

    @classmethod
    def update_rate(cls, key: str, n: int = 1) -> None:
        now = time.monotonic()
        with cls._lock:
            ewma, last = cls._rates.get(key, (0.0, now))
            dt = max(now - last, 1e-9)
            inst = n / dt
            cls._rates[key] = ((1 - cls.ALPHA) * ewma + cls.ALPHA * inst, now)

    @classmethod
    def get(cls, key: str) -> float:
        with cls._lock:
            if key in cls._avgs:
                return cls._avgs[key]
            if key in cls._counts:
                return cls._counts[key]
            if key in cls._rates:
                return cls._rates[key][0]
        return 0.0

    @classmethod
    def get_stats(cls) -> str:
        """One-line dump, like the reference's ``DelayProfiler.getStats()``."""
        with cls._lock:
            parts = [f"{k}:{v:.3g}" for k, v in sorted(cls._avgs.items())]
            parts += [f"#{k}:{v:.4g}" for k, v in sorted(cls._counts.items())]
            parts += [f"R({k}):{v:.4g}/s" for k, (v, _) in sorted(cls._rates.items())]
        return "[" + " ".join(parts) + "]"

    @classmethod
    def get_snapshot(cls) -> Dict[str, Dict[str, float]]:
        """Structured (JSON-safe) form of :meth:`get_stats` — the ``stats``
        admin op and the metrics endpoints ship this instead of making
        machine consumers parse the human one-liner."""
        with cls._lock:
            return {
                "avgs": dict(cls._avgs),
                "counts": dict(cls._counts),
                "rates": {k: v for k, (v, _) in cls._rates.items()},
            }

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._avgs.clear()
            cls._counts.clear()
            cls._rates.clear()
