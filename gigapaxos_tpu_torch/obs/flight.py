"""Black-box flight recorder: always-on bounded rings of engine history,
dumped to disk when something goes wrong.

The chaos campaign's recurring problem: a timing-dependent breach
surfaces MINUTES after the step that caused it, and by then the live
state shows only the symptom.  The per-request tracer answers "what
happened to THIS request" but is sampled/gated; the flight recorder is
the complement — always on, O(1) per tick, recording the ENGINE's recent
past regardless of what anyone thought to trace:

* a ring of per-step summaries (tick, wall time, admitted, decided,
  preempts, coordinator flips, ballot rises, frontier stalls, inflight)
  — only "interesting" ticks are recorded, so the ring spans real
  history, not idle heartbeats;
* a ring of the last-K decided slots ``(group, slot, ballot, vid)`` for
  this node/worker shard — the exact decision sequence a divergence
  post-mortem needs to diff across members.

Dumps land as JSON under ``FLIGHT_DIR`` on: a chaos ``SoakDivergence``
(``testing/chaos.py`` attaches every member's dump path to the failure
diagnostics), a tick-loop exception (``server._run``), or an explicit
``flightdump`` admin op.  The rings are bounded by ``FLIGHT_STEPS`` /
``FLIGHT_DECIDED`` — a multi-hour soak costs the same RAM as a minute.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..paxos_config import PC
from ..utils.config import Config


class FlightRecorder:
    """Per-node (per worker shard, under ``SERVING_WORKERS``) bounded
    engine-history rings.  ``record_*`` calls run under the manager's
    state lock (the post-step path); ``dump`` may be called from any
    thread and snapshots under its own lock."""

    def __init__(self, node: int, steps: Optional[int] = None,
                 decided: Optional[int] = None):
        self.node = int(node)
        steps = Config.get_int(PC.FLIGHT_STEPS) if steps is None else steps
        decided = (
            Config.get_int(PC.FLIGHT_DECIDED) if decided is None else decided
        )
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=max(1, int(steps)))
        self._decided: deque = deque(maxlen=max(1, int(decided)))
        self._dumped_reasons: set = set()

    # ---- recording (post-step path, O(1) per tick) --------------------
    def record_step(self, tick: int, admitted: int, decided: int,
                    preempts: int, coordinator_flips: int,
                    ballot_rises: int, frontier_stalls: int,
                    inflight: int) -> None:
        if not (admitted or decided or preempts or coordinator_flips
                or ballot_rises or frontier_stalls):
            return  # idle tick: recording it would age real history out
        with self._lock:
            self._steps.append({
                "tick": int(tick), "t": time.time(),
                "admitted": int(admitted), "decided": int(decided),
                "preempts": int(preempts),
                "coordinator_flips": int(coordinator_flips),
                "ballot_rises": int(ballot_rises),
                "frontier_stalls": int(frontier_stalls),
                "inflight": int(inflight),
            })

    def record_decided(self, group: int, slot: int, ballot: int,
                       vid: int) -> None:
        with self._lock:
            self._decided.append(
                (int(group), int(slot), int(ballot), int(vid))
            )

    # ---- inspection ----------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "node": self.node,
                "steps": list(self._steps),
                "decided": [list(d) for d in self._decided],
            }

    def decided_for_group(self, group: int) -> List:
        with self._lock:
            return [list(d) for d in self._decided if d[0] == int(group)]

    # ---- the black box hitting the ground ------------------------------
    def dump(self, reason: str, extra: Optional[Dict] = None,
             once: bool = False) -> Optional[str]:
        """Write the rings to ``FLIGHT_DIR`` as one JSON file; returns
        the path (None only if the write itself failed — the recorder
        must never take the node down with it).  ``once=True`` dedups by
        reason (the tick-loop exception hook fires per tick while a bug
        persists; one dump per reason is the useful artifact).

        ``reason`` should be a structured slug (``divergence.<kind>``,
        ``tick-exception``) and ``extra`` the attribution a post-mortem
        needs WITHOUT the producing process — soak family, seed,
        divergence kind, offending group/name.  A bare
        ``reason="divergence"`` dump is unattributable once the run's
        stdout is gone (the pre-r17 repo carried 84 of those)."""
        if once:
            with self._lock:
                if reason in self._dumped_reasons:
                    return None
                self._dumped_reasons.add(reason)
        doc = self.snapshot()
        doc["reason"] = str(reason)
        doc["t_dump"] = time.time()
        if extra:
            doc["extra"] = extra
        dir_ = Config.get_str(PC.FLIGHT_DIR) or "flight_dumps"
        safe = "".join(
            ch if ch.isalnum() or ch in "._-" else "_" for ch in str(reason)
        )[:64]
        path = os.path.join(
            dir_, f"flight_node{self.node}_{safe}_{int(time.time() * 1e3)}.json"
        )
        try:
            os.makedirs(dir_, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)  # a torn dump must not look complete
        except OSError:
            return None
        self._rotate(dir_)
        return path

    @staticmethod
    def _rotate(dir_: str) -> None:
        """Cap the dump directory at ``FLIGHT_MAX_DUMPS`` files, oldest
        out first, so repeated local soak runs stop accumulating
        unbounded JSON (0 disables).  Best-effort: rotation must never
        fail a dump."""
        try:
            cap = Config.get_int(PC.FLIGHT_MAX_DUMPS)
        except Exception:
            cap = 0
        if cap <= 0:
            return
        try:
            files = [
                os.path.join(dir_, f) for f in os.listdir(dir_)
                if f.startswith("flight_") and f.endswith(".json")
            ]
            if len(files) <= cap:
                return
            files.sort(key=lambda p: os.path.getmtime(p))
            for p in files[:len(files) - cap]:
                os.remove(p)
        except OSError:
            pass
