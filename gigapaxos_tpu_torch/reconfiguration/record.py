"""Reconfiguration records: the per-name epoch state machine.

API-parity target: ``reconfigurationutils/ReconfigurationRecord.java``
(``RCStates`` enum at :53-91 and the epoch/actives/newActives fields).
A record is plain JSON-serializable data — it IS the app state of the
reconfigurators' own RSM (``rc_app.RCRepliconfigurableApp``), so every
mutation happens deterministically inside ``Replicable.execute`` on all
reconfigurators.

State machine (``RCStates`` / ``setState`` transitions)::

    READY --(INTENT: epoch e -> e+1, newActives)--> WAIT_ACK_STOP
    WAIT_ACK_STOP --(old epoch stopped, final state fetched)--> WAIT_ACK_START
    WAIT_ACK_START --(COMPLETE: majority of new actives ack)--> READY  (epoch e+1)
    READY --(DELETE_INTENT)--> WAIT_DELETE --(drop acks / age-out)--> (purged)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class RCState(str, enum.Enum):
    READY = "READY"
    WAIT_ACK_STOP = "WAIT_ACK_STOP"
    WAIT_ACK_START = "WAIT_ACK_START"
    WAIT_DELETE = "WAIT_DELETE"
    # residency (pause/unpause, PaxosManager.java:2264-2392 analog): the
    # group's row is being freed / has been freed on its actives; a touch
    # re-homes it at a freshly probed row via the start-epoch machinery
    WAIT_PAUSE = "WAIT_PAUSE"
    PAUSED = "PAUSED"


@dataclass
class ReconfigurationRecord:
    name: str
    epoch: int = 0
    state: RCState = RCState.READY
    actives: List[int] = field(default_factory=list)      # current epoch's replica set
    new_actives: List[int] = field(default_factory=list)  # target set during a change
    row: int = -1        # engine row of the current epoch's group (creator-chosen)
    new_row: int = -1    # engine row for the pending epoch
    deleted: bool = False
    # creation-time initial app state, kept so an expired/re-driven start
    # task can rebuild the StartEpoch without the original client request
    initial_state: Optional[str] = None
    # the previous epoch still awaiting its drop round (GC on the old
    # actives): kept ON the record — paxos-replicated — so an RC restart
    # or primary handover can re-drive the drop instead of leaking the
    # stopped rows forever; cleared by the DROP_DONE op
    pending_drop_epoch: Optional[int] = None
    pending_drop_actives: List[int] = field(default_factory=list)
    # a reactivation start round keeps the SAME epoch (the group is not
    # migrating, just re-homing to a fresh row after pause)
    resuming: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "epoch": self.epoch, "state": self.state.value,
            "actives": self.actives, "new_actives": self.new_actives,
            "row": self.row, "new_row": self.new_row, "deleted": self.deleted,
            "initial_state": self.initial_state,
            "pending_drop_epoch": self.pending_drop_epoch,
            "pending_drop_actives": self.pending_drop_actives,
            "resuming": self.resuming,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ReconfigurationRecord":
        return cls(
            name=d["name"], epoch=int(d["epoch"]), state=RCState(d["state"]),
            actives=list(d["actives"]), new_actives=list(d["new_actives"]),
            row=int(d.get("row", -1)), new_row=int(d.get("new_row", -1)),
            deleted=bool(d.get("deleted", False)),
            initial_state=d.get("initial_state"),
            pending_drop_epoch=d.get("pending_drop_epoch"),
            pending_drop_actives=list(d.get("pending_drop_actives") or []),
            resuming=bool(d.get("resuming", False)),
        )

    # ---- transitions (setState analog, ReconfigurationRecord.java:466+) --
    def start_reconfigure(self, new_actives: List[int], new_row: int) -> bool:
        """INTENT: begin epoch e -> e+1 (READY -> WAIT_ACK_STOP)."""
        if self.state is not RCState.READY or self.deleted:
            return False
        self.new_actives = list(new_actives)
        self.new_row = int(new_row)
        self.state = RCState.WAIT_ACK_STOP
        return True

    def stop_done(self) -> bool:
        """Old epoch stopped & final state in hand (-> WAIT_ACK_START)."""
        if self.state is not RCState.WAIT_ACK_STOP:
            return False
        self.state = RCState.WAIT_ACK_START
        return True

    def complete(self) -> bool:
        """COMPLETE: majority of new actives running the target epoch
        (-> READY).  For an initial create (no prior actives) the epoch
        stays as born; for a reconfiguration it advances e -> e+1."""
        if self.state is not RCState.WAIT_ACK_START:
            return False
        if self.actives and not self.resuming:
            # the outgoing epoch owes a drop round on its old actives
            self.pending_drop_epoch = self.epoch
            self.pending_drop_actives = list(self.actives)
            self.epoch += 1
        self.actives = list(self.new_actives)
        self.row = self.new_row
        self.new_actives = []
        self.new_row = -1
        self.resuming = False
        self.state = RCState.READY
        return True

    # ---- residency (pause/unpause, §3.4 analog) -----------------------
    def start_pause(self) -> bool:
        """READY -> WAIT_PAUSE: free the row on every active."""
        if self.state is not RCState.READY or self.deleted:
            return False
        self.state = RCState.WAIT_PAUSE
        return True

    def pause_done(self) -> bool:
        if self.state is not RCState.WAIT_PAUSE:
            return False
        self.state = RCState.PAUSED
        self.row = -1
        return True

    def start_reactivate(
        self, new_row: int, actives: Optional[List[int]] = None
    ) -> bool:
        """PAUSED/WAIT_PAUSE -> WAIT_ACK_START at a fresh row, same epoch
        (also serves as the cancel path for a half-completed pause).
        `actives` narrows the resume set when members left the cluster
        while the group was paused."""
        if self.state not in (RCState.PAUSED, RCState.WAIT_PAUSE) or self.deleted:
            return False
        self.new_actives = list(actives) if actives else list(self.actives)
        self.new_row = int(new_row)
        self.resuming = True
        self.state = RCState.WAIT_ACK_START
        return True

    def drop_done(self) -> bool:
        """The previous epoch's drop round reached every old active."""
        if self.pending_drop_epoch is None:
            return False
        self.pending_drop_epoch = None
        self.pending_drop_actives = []
        return True

    def start_delete(self) -> bool:
        """DELETE intent: READY -> WAIT_DELETE (two-phase delete,
        Reconfigurator.java:747)."""
        if self.state is not RCState.READY or self.deleted:
            return False
        self.state = RCState.WAIT_DELETE
        return True

    def finish_delete(self) -> bool:
        if self.state is not RCState.WAIT_DELETE:
            return False
        self.deleted = True
        return True
