"""RTT estimation + latency-aware server selection.

API-parity targets: ``nioutils/RTTEstimator`` (EWMA RTT per address) and
``paxosutil/E2ELatencyAwareRedirector.java:18`` (the client-side policy:
send to the lowest-learned-latency server, with a small probe ratio of
random picks so alternatives keep being measured), plus the echo-probe
orientation of ``Reconfigurator.java:2420`` — estimates can be SEEDED
from active probes so the first pick is already latency-aware instead of
arbitrary (cold start was previously blind until real traffic taught
the EWMA)."""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple


class RTTEstimator:
    """EWMA round-trip estimate per key (server id / address)."""

    ALPHA = 1.0 / 8

    def __init__(self):
        self._rtt: Dict[Any, float] = {}
        self._lock = threading.Lock()

    def record(self, key: Any, rtt_s: float) -> None:
        with self._lock:
            old = self._rtt.get(key)
            self._rtt[key] = (
                rtt_s if old is None else (1 - self.ALPHA) * old
                + self.ALPHA * rtt_s
            )

    def seed(self, key: Any, rtt_s: float) -> bool:
        """Install a probe-derived estimate ONLY when the key is still
        unmeasured (an echo RTT is pure network time; once real traffic
        has taught the EWMA its end-to-end number — queueing included —
        a probe must not drag it back down).  Returns True if seeded."""
        with self._lock:
            if key in self._rtt:
                return False
            self._rtt[key] = float(rtt_s)
            return True

    def get(self, key: Any) -> Optional[float]:
        with self._lock:
            return self._rtt.get(key)

    def pop(self, key: Any) -> None:
        """Drop a key's estimate (e.g. a server removed from the
        cluster — its stale RTT must not keep ranking it)."""
        with self._lock:
            self._rtt.pop(key, None)

    def items(self) -> Iterable[Tuple[Any, float]]:
        with self._lock:
            return list(self._rtt.items())


def _stable_key(c: Any):
    """Deterministic secondary sort key for candidate ids of any type."""
    return (str(type(c).__name__), str(c))


class LatencyAwareRedirector:
    """Pick the fastest-known candidate, probing randomly at PROBE_RATIO
    so a currently-slow server can redeem itself (E2ELatencyAwareRedirector
    semantics: learned EWMA + probe rate).  Exact-RTT ties break
    DETERMINISTICALLY (lowest stable key) — two clients with the same
    measurements pick the same server, and a test can assert the pick."""

    PROBE_RATIO = 0.1

    def __init__(self, estimator: Optional[RTTEstimator] = None):
        self.rtt = estimator or RTTEstimator()

    def pick(self, candidates: List[Any]) -> Any:
        if not candidates:
            raise ValueError("no candidates")
        if random.random() < self.PROBE_RATIO:
            return random.choice(candidates)
        unknown = [c for c in candidates if self.rtt.get(c) is None]
        if unknown:
            return random.choice(unknown)  # measure everyone once
        return min(
            candidates, key=lambda c: (self.rtt.get(c), _stable_key(c))
        )

    def record(self, key: Any, rtt_s: float) -> None:
        self.rtt.record(key, rtt_s)

    def seed(self, key: Any, rtt_s: float) -> bool:
        """Cold-start orientation: adopt an echo-probe RTT unless real
        traffic already measured this key (see RTTEstimator.seed)."""
        return self.rtt.seed(key, rtt_s)
