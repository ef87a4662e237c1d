"""Lazy per-name hydration — serve hot names now, restore the cold tail
in the background.

At scale, a cold restart's dominant cost is not the engine arrays (one
bulk npz load) or the journal rollforward (vectorized per block) — it is
the quarter-million ``app.restore(name, state)`` calls and the JSON
parse of their state strings.  The hydration plane defers exactly that
work: the manager marks every checkpoint-domain name *un-hydrated* (its
on-disk shard is its idle form, like a paused group's journal record),
restores only the recency-ordered hot set synchronously, and serves.
Un-hydrated rows are gated everywhere their app state could leak —
request admission, decided-slot execution, local reads, pause/hibernate
snapshots, checkpoint writes, and donor state serving — and a request
touching a cold name promotes it to the front of the hydration queue.

The background worker restores ``RECOVERY_HYDRATION_BATCH`` names per
manager-lock acquisition, then yields, so hydration never starves the
tick loop; when the backlog drains the node flips from ``recovering`` to
``serving`` (the ``stats`` admin op's ``phase`` field).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Dict, Optional, Tuple

if TYPE_CHECKING:  # circular at runtime: manager builds the hydrator
    from ..manager import PaxosManager
    from ..storage.checkpoint import CheckpointView


class Hydrator:
    """Background app-state restoration for a restarting manager.

    Thread-safety: :meth:`request` is called under the manager's state
    lock and takes only the hydrator's own lock; the worker pops under
    the hydrator lock, RELEASES it, then takes the manager lock for the
    batch — neither path ever holds both, so the two locks cannot
    deadlock."""

    def __init__(
        self,
        manager: "PaxosManager",
        view: "CheckpointView",
        batch: int = 256,
    ):
        self.m = manager
        self.view = view
        self.batch = max(1, int(batch))
        self._lock = threading.Lock()
        # name -> shard holding its checkpoint app state
        self._cold: Dict[str, int] = {}
        self._priority: deque = deque()  # names a request is waiting on
        self._prioritized: set = set()   # dedup: request() fires per tick
        self._order: deque = deque()     # background order (hot first)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.t_start = time.monotonic()
        self.t_done: Optional[float] = None
        self.n_hydrated = 0

    # ---- planning (called from _recover, under the manager lock) ------
    def add_cold(self, name: str, shard: int) -> None:
        self._cold[name] = shard
        self._order.append(name)

    @property
    def backlog(self) -> int:
        return len(self._cold)

    # ---- priority promotion (any thread) -------------------------------
    def request(self, name: str) -> None:
        """A live request touched a cold name: hydrate it next.  Deduped
        — the admission/execution gates re-request every tick, and an
        unbounded duplicate deque would grow by O(cold rows) per tick."""
        with self._lock:
            if name in self._cold and name not in self._prioritized:
                self._prioritized.add(name)
                self._priority.append(name)

    # ---- hydration ------------------------------------------------------
    def _pop(self) -> Optional[str]:
        with self._lock:
            while self._priority:
                name = self._priority.popleft()
                self._prioritized.discard(name)
                if name in self._cold:
                    return name
            while self._order:
                name = self._order.popleft()
                if name in self._cold:
                    return name
        return None

    def hydrate_name_locked(self, name: str) -> bool:
        """Restore one name's checkpoint app state (manager lock held).
        Names whose row was killed/re-created since recovery just
        un-gate — their state has a newer owner."""
        shard = self._cold.pop(name, None)
        if shard is None:
            return False
        m = self.m
        row = m.names.get(name)
        done = False
        if row is not None and row in m.hydrating_rows:
            m.app.restore(name, self.view.app_states(shard).get(name))
            done = True
        if row is not None:
            m.hydrating_rows.discard(row)
        self.n_hydrated += 1
        m.metrics.count("recovery_groups_hydrated")
        if not self._cold:
            self.t_done = time.monotonic()
            # drop the checkpoint view: it pins the full engine-array
            # host copies plus every shard's app-state bytes (hundreds
            # of MB at 256k groups) and nothing needs them anymore
            self.view = None
            self._order.clear()
            self._priority.clear()
            self._prioritized.clear()
        return done

    def hydrate_batch(self) -> int:
        """One background quantum: up to ``batch`` names under one
        manager-lock acquisition, then a pending-execution drain for the
        rows just un-gated."""
        picked = []
        for _ in range(self.batch):
            name = self._pop()
            if name is None:
                break
            picked.append(name)
        if not picked:
            return 0
        m = self.m
        with m._state_lock:
            for name in picked:
                self.hydrate_name_locked(name)
            # decided-but-unexecuted slots parked on the hydrated rows
            # (journal replay / peer blobs) execute now
            m._drain_pending_exec()
            m.metrics.gauge("recovery_hydration_backlog", self.backlog)
        return len(picked)

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Hydrate synchronously until the backlog is empty (tests,
        shutdown); True when fully drained."""
        t0 = time.monotonic()
        while self._cold:
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                return False
            if self.hydrate_batch() == 0:
                break
        return not self._cold

    # ---- background worker ---------------------------------------------
    def start_background(self) -> None:
        if self._thread is not None or not self._cold:
            return
        self._thread = threading.Thread(
            target=self._run, name="gp-hydrator", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _run(self) -> None:
        delay = 0.01
        failures = 0
        while not self._stop.is_set():
            try:
                n = self.hydrate_batch()
            except Exception:
                # retry-forever with backoff, LOUDLY (the
                # _app_execute_retrying philosophy: silently dying here
                # would wedge the node in `recovering` with no signal,
                # and un-gating without the restore would diverge the
                # RSM — the only safe alternatives are retry or a loud
                # wedge)
                failures += 1
                if failures in (1, 10) or failures % 100 == 0:
                    self.m.log.exception(
                        "hydration batch failed (%d failures); retrying "
                        "— node stays `recovering` until it succeeds",
                        failures,
                    )
                self._stop.wait(delay)
                delay = min(delay * 2, 5.0)
                continue
            delay = 0.01
            if n == 0:
                break
            # yield between batches: the tick loop and transport threads
            # must win the lock promptly while we chew the cold tail
            time.sleep(0)
        with self.m._state_lock:
            self.m.metrics.gauge(
                "recovery_hydration_backlog", self.backlog
            )
