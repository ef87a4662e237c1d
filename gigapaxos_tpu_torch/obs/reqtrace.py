"""Per-request tracing — the ``RequestInstrumenter`` analog.

Ref: ``paxosutil/RequestInstrumenter.java:36-80`` — a static map of
per-request message logs, populated by ``received()``/``sent()`` calls
sprinkled through the send/receive paths, all compiled away unless the
debug flag is on, and dumped on demand to reconstruct one request's
journey through the system.

Redesign for this runtime: a :class:`RequestTracer` instance PER NODE
(every test topology runs many nodes in one process, so a static map
would interleave their timelines) holding a bounded FIFO ring of
``key -> [(t_monotonic, event, detail)]`` timelines.  Keys are request
ids on the data plane and ``"epoch:<name>"`` strings on the
reconfiguration plane.  A secondary bounded index maps service name ->
recently traced keys so a chaos-soak divergence on a NAME can dump the
requests that touched it (``testing/chaos.py:_name_diag``).

Gating contract (the hot-path budget): callers check ``tracer.enabled``
— one attribute read — before composing event details; ``note()`` also
checks it, so an unguarded call site is correct, just one function call
less cheap.  When disabled the tracer records nothing and allocates
nothing.  ``enabled`` defaults from ``GP_TRACE=1`` or a DEBUG-level
``gp.trace`` logger (``GP_LOG=trace:DEBUG``) at construction; soaks and
tests flip the attribute directly.

Cross-node tracing (the Dapper half the reference never had): a request
sampled at its ORIGIN (``GP_TRACE_SAMPLE``, a probability) carries a
compact trace context ``(trace_id, origin, hop)`` on every wire hop —
client frame, coordinator forward, payload gossip — and every node on
the path records its events for that request REGARDLESS of its local
``enabled`` flag (``note(..., force=True)``): sampling is decided once,
where the request is born, and the whole cluster honors it.  Timestamps
are WALL-clock (``time.time()``) so per-node dumps merge into one causal
cross-node timeline (``obs/tracemerge.py``); clock skew between hosts is
clamped at merge time, exactly as Dapper does.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

_TRUE = frozenset(("1", "true", "yes", "on"))

# trace context = (trace_id, origin node, hop counter)
TraceCtx = Tuple[int, int, int]


def trace_enabled() -> bool:
    """Process-default gate: ``GP_TRACE`` env or ``gp.trace`` at DEBUG."""
    if os.environ.get("GP_TRACE", "").strip().lower() in _TRUE:
        return True
    from .gplog import get_logger

    return get_logger("trace").isEnabledFor(logging.DEBUG)


def trace_sample_rate() -> float:
    """``GP_TRACE_SAMPLE`` env: probability in [0, 1] that a request
    minted at this process carries a trace context.  0 (default) = no
    sampling; 1 = trace everything.  Cheap enough to leave >0 in
    production — only sampled requests pay any tracing cost downstream."""
    raw = os.environ.get("GP_TRACE_SAMPLE", "").strip()
    if not raw:
        return 0.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 0.0


def maybe_mint_trace(
    origin: int, rate: Optional[float] = None
) -> Optional[TraceCtx]:
    """Sampling decision + context mint at a request's origin: returns
    ``(trace_id, origin, 0)`` with probability ``rate`` (default: the
    ``GP_TRACE_SAMPLE`` env), else None.  Trace ids are random 63-bit
    and never 0, so ``tid`` in an event detail is always truthy."""
    r = trace_sample_rate() if rate is None else rate
    if r <= 0.0 or (r < 1.0 and random.random() >= r):
        return None
    return (random.getrandbits(63) | 1, int(origin), 0)


class RequestTracer:
    """Bounded per-node ring of per-request event timelines."""

    DEFAULT_CAPACITY = 1024
    NAME_KEYS = 8  # per-name recent-key window for dump_name
    # per-KEY timeline cap: epoch keys live for a name's whole lifetime,
    # so a wedged epoch's retransmit rounds would otherwise grow one
    # key's list without bound (the key-count FIFO never fires for a
    # reconfigurator, which only ever traces one key per name).  The
    # first event stays as the t0 anchor; the oldest tail entries drop.
    EVENTS_PER_KEY = 512

    def __init__(self, node, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self.node = int(node)
        self.capacity = (
            self.DEFAULT_CAPACITY if capacity is None else max(1, int(capacity))
        )
        self.enabled = trace_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        # key -> [(t, event, detail dict)]; FIFO-evicted at capacity
        self._events: "OrderedDict[object, List[Tuple]]" = OrderedDict()
        # name -> deque of recently traced keys (for name-keyed dumps)
        self._by_name: Dict[str, deque] = {}

    # ---- recording (hot path when enabled, no-op when not) -----------
    def note(self, key, event: str, name: Optional[str] = None,
             force: bool = False, **detail) -> None:
        """Append one event to ``key``'s timeline.  ``name`` additionally
        indexes the key under that service name for dump_name().
        ``force=True`` records even when the tracer is disabled — the
        cross-node sampling contract: a request that arrived CARRYING a
        trace context was sampled at its origin, and every node on its
        path owes it events (callers pass ``force=tc is not None``).
        Timestamps are wall-clock so per-node rings merge causally."""
        if not (self.enabled or force):
            return
        t = time.time()
        with self._lock:
            timeline = self._events.get(key)
            if timeline is None:
                while len(self._events) >= self.capacity:
                    self._events.popitem(last=False)  # FIFO eviction
                timeline = self._events[key] = []
            if len(timeline) >= self.EVENTS_PER_KEY:
                del timeline[1]  # keep event 0: it anchors dump()'s t0
            timeline.append((t, event, detail))
            if name is not None:
                dq = self._by_name.get(name)
                if dq is None:
                    # bound the name index like the ring (names are
                    # few in practice; this is a leak guard, not a
                    # working-set tune)
                    while len(self._by_name) >= self.capacity:
                        self._by_name.pop(next(iter(self._by_name)))
                    dq = self._by_name[name] = deque(maxlen=self.NAME_KEYS)
                if not dq or dq[-1] != key:
                    dq.append(key)

    # ---- inspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def __contains__(self, key) -> bool:
        return key in self._events

    def events(self, key) -> List[Tuple]:
        with self._lock:
            return list(self._events.get(key, ()))

    def keys_for_name(self, name: str) -> List:
        with self._lock:
            return list(self._by_name.get(name, ()))

    def dump(self, key) -> str:
        """One request's timeline, timestamps relative to its first event
        (the reference's ``getLog()`` dump shape)."""
        evs = self.events(key)
        if not evs:
            return f"<no trace for {key!r} at node {self.node}>"
        t0 = evs[0][0]
        lines = [f"request {key!r} @ node {self.node}:"]
        for t, event, detail in evs:
            tail = " ".join(f"{k}={v}" for k, v in detail.items())
            lines.append(
                f"  +{(t - t0) * 1e3:9.3f}ms {event}"
                + (f" [{tail}]" if tail else "")
            )
        return "\n".join(lines)

    def export(self, keys=None, name: Optional[str] = None,
               limit: int = 256) -> Dict[str, List]:
        """JSON-safe dump of (a slice of) the ring for the ``trace_dump``
        admin op and the cross-node merge: ``{str(key): [[t_wall, event,
        detail], ...]}``.  ``keys`` selects specific request keys;
        ``name`` selects that service name's recently traced keys; with
        neither, the NEWEST ``limit`` keys ship (the ring is insertion-
        ordered, so the tail is the recent traffic)."""
        with self._lock:
            if keys is None:
                if name is not None:
                    keys = list(self._by_name.get(name, ()))
                else:
                    keys = list(self._events.keys())[-max(0, int(limit)):]
            out: Dict[str, List] = {}
            for k in keys:
                evs = self._events.get(k)
                if evs:
                    out[str(k)] = [
                        [t, ev, dict(detail)] for t, ev, detail in evs
                    ]
        return out

    def dump_name(self, name: str, limit: int = 4) -> str:
        """Timelines of the most recent ``limit`` distinct keys traced
        under ``name`` — the chaos-soak failure-message payload.  (The
        per-name key window only suppresses CONSECUTIVE repeats, so
        interleaved keys must dedup here or one request prints twice.)"""
        seen = []
        for k in self.keys_for_name(name):
            if k in seen:
                seen.remove(k)  # keep the LAST occurrence's position
            seen.append(k)
        keys = seen[-limit:]
        if not keys:
            return f"<no traces for name {name!r} at node {self.node}>"
        return "\n".join(self.dump(k) for k in keys)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._by_name.clear()
