"""Keyed protocol tasks with periodic restarts — tick-driven, not threaded.

The reference runs tasks on a scheduled thread pool
(``ProtocolExecutor.java:39``: ``MultiArrayMap`` task store, MAX_TASKS 10k,
periodic restart default 60s for retransmission).  Here the executor is
**tick-driven**: the owning node's event loop calls :meth:`ProtocolExecutor.tick`
at its own cadence, which fits the framework's single tick loop (one engine
step per tick) and makes protocol behavior deterministic in tests — no
timers firing mid-assertion.

A task emits :class:`MessagingTask`s — ``(dst, kind, body)`` triples in the
host-channel message shape — which the owner routes over its transport.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# (dst, kind, body) — dst is opaque to the executor (node id / (role, id))
MessagingTask = Tuple[Any, str, Dict]


class ProtocolTask:
    """One keyed state machine (``ProtocolTask.java`` analog).

    Subclasses override :meth:`start` (initial sends), :meth:`handle_event`
    (route an incoming event; return follow-up sends), and
    :meth:`restart` (periodic retransmission).  A task signals completion
    by setting ``self.done = True`` (the executor then drops it).
    """

    #: seconds between restart() calls (reference default 60s, the
    #: reconfiguration tasks use a few seconds)
    restart_period_s: float = 2.0
    #: give up after this long (None = run forever until done/cancelled)
    max_lifetime_s: Optional[float] = 60.0

    def __init__(self, key: str):
        self.key = key
        self.done = False

    def start(self) -> Iterable[MessagingTask]:
        return ()

    def handle_event(self, kind: str, body: Dict) -> Iterable[MessagingTask]:
        return ()

    def restart(self) -> Iterable[MessagingTask]:
        """Periodic retransmission; default = re-run start()."""
        return self.start()

    def on_expire(self) -> None:
        """Called when max_lifetime_s elapses without completion."""


class ThresholdProtocolTask(ProtocolTask):
    """Wait for acks from >= threshold of a node set, retransmitting to
    laggards only (``ThresholdProtocolTask.java`` analog).

    Subclasses override :meth:`send_to` (build the message for one node)
    and :meth:`on_threshold` (fired once when the threshold is met; its
    sends are emitted and the task completes).  ``is_ack`` decides whether
    an event counts as an ack and from whom.
    """

    def __init__(self, key: str, nodes: Iterable[Any], threshold: Optional[int] = None):
        super().__init__(key)
        self.nodes = list(nodes)
        # default threshold: majority
        self.threshold = (
            len(self.nodes) // 2 + 1 if threshold is None else int(threshold)
        )
        self.acked: set = set()
        self._fired = False

    # -- subclass surface ------------------------------------------------
    def send_to(self, node: Any) -> Optional[MessagingTask]:
        raise NotImplementedError

    def is_ack(self, kind: str, body: Dict) -> Optional[Any]:
        """Return the acking node (or None if this event is not an ack)."""
        return None

    def on_threshold(self) -> Iterable[MessagingTask]:
        return ()

    # -- machinery -------------------------------------------------------
    def start(self) -> Iterable[MessagingTask]:
        return self._send_to_laggards()

    def restart(self) -> Iterable[MessagingTask]:
        return self._send_to_laggards()

    def _send_to_laggards(self) -> List[MessagingTask]:
        out = []
        for n in self.nodes:
            if n not in self.acked:
                m = self.send_to(n)
                if m is not None:
                    out.append(m)
        return out

    def handle_event(self, kind: str, body: Dict) -> Iterable[MessagingTask]:
        node = self.is_ack(kind, body)
        if node is None or node not in self.nodes:
            return ()
        self.acked.add(node)
        if not self._fired and len(self.acked) >= self.threshold:
            self._fired = True
            self.done = True
            return list(self.on_threshold())
        return ()


class ProtocolExecutor:
    """Keyed task store + event router + restart scheduler.

    ``spawn_if_not_running`` gives the reference's idempotent-spawn
    behavior (``ProtocolExecutor.spawnIfNotRunning``); events whose key
    matches no task are dropped (the caller's default handler sees them
    first).  MAX_TASKS guards runaway spawns (reference cap 10k).
    """

    MAX_TASKS = 10_000

    def __init__(self, send: Optional[Callable[[MessagingTask], None]] = None):
        self._tasks: Dict[str, ProtocolTask] = {}
        self._meta: Dict[str, Tuple[float, float]] = {}  # key -> (born, last_restart)
        self._send = send
        self.outbox: List[MessagingTask] = []  # used when no send fn given

    def _emit(self, msgs: Iterable[MessagingTask]) -> None:
        for m in msgs:
            if self._send is not None:
                self._send(m)
            else:
                self.outbox.append(m)

    def spawn(self, task: ProtocolTask, now: Optional[float] = None) -> bool:
        if task.key in self._tasks:
            return False
        if len(self._tasks) >= self.MAX_TASKS:
            raise RuntimeError("protocol task store full")
        now = time.time() if now is None else now
        self._tasks[task.key] = task
        self._meta[task.key] = (now, now)
        self._emit(task.start())
        self._reap(task)
        return True

    def spawn_if_not_running(
        self, key: str, factory: Callable[[], ProtocolTask],
        now: Optional[float] = None,
    ) -> bool:
        if key in self._tasks:
            return False
        return self.spawn(factory(), now=now)

    def is_running(self, key: str) -> bool:
        return key in self._tasks

    def cancel(self, key: str) -> bool:
        self._meta.pop(key, None)
        return self._tasks.pop(key, None) is not None

    def handle_event(self, key: str, kind: str, body: Dict) -> bool:
        """Route an event to the task with this key; returns True if a
        task consumed it."""
        task = self._tasks.get(key)
        if task is None:
            return False
        self._emit(task.handle_event(kind, body))
        self._reap(task)
        return True

    def tick(self, now: Optional[float] = None) -> None:
        """Run restarts/expiries due at `now` (call from the node loop)."""
        now = time.time() if now is None else now
        for key in list(self._tasks.keys()):
            task = self._tasks.get(key)
            if task is None:
                continue
            born, last = self._meta[key]
            if task.max_lifetime_s is not None and now - born > task.max_lifetime_s:
                task.on_expire()
                self.cancel(key)
                continue
            if now - last >= task.restart_period_s:
                self._meta[key] = (born, now)
                self._emit(task.restart())
                self._reap(task)

    def _reap(self, task: ProtocolTask) -> None:
        if task.done:
            self.cancel(task.key)

    def __len__(self) -> int:
        return len(self._tasks)
