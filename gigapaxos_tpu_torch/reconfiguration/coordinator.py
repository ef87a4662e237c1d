"""Replica-coordination SPI between the app and the reconfiguration layer.

API-parity target: ``AbstractReplicaCoordinator`` (abstract
``coordinateRequest`` / ``createReplicaGroup`` / ``deleteReplicaGroup`` /
``getReplicaGroup``, ``AbstractReplicaCoordinator.java:100-117``) and its
only production subclass ``PaxosReplicaCoordinator``
(``PaxosReplicaCoordinator.java:47`` — maps service names to paxos groups,
``coordinateRequest`` -> ``PaxosManager.propose[Stop]``).

The TPU re-design keeps the same seam: :class:`ActiveReplica` talks only
to this interface, so alternative coordination protocols (chain
replication, primary-backup) could slot in without touching the epoch
machinery — exactly the reference's intent.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..interfaces.app import Replicable
from ..manager import PaxosManager


class AbstractReplicaCoordinator:
    """Coordination SPI (``AbstractReplicaCoordinator.java:78``)."""

    def __init__(self, app: Replicable):
        self.app = app

    # -- request plane ---------------------------------------------------
    def coordinate_request(
        self,
        name: str,
        value: str,
        callback: Optional[Callable] = None,
        stop: bool = False,
        request_id: Optional[int] = None,
    ) -> bool:
        raise NotImplementedError

    # -- epoch plane -----------------------------------------------------
    def create_replica_group(
        self,
        name: str,
        epoch: int,
        members: List[int],
        initial_state: Optional[str],
        row: Optional[int] = None,
        pending: bool = False,
        dedup=None,
    ) -> bool:
        """``dedup``: exactly-once entries snapshotted WITH
        ``initial_state`` — installed only if this create adopts the
        state (install/restore pairing; see PaxosManager)."""
        raise NotImplementedError

    def commit_replica_group(
        self, name: str, epoch: int, row: Optional[int] = None
    ) -> None:
        """The RC's COMPLETE confirmed this epoch's placement at `row`:
        lift the pre-COMPLETE admission gate (no-op for non-pending groups
        or a mismatched — losing — row)."""
        raise NotImplementedError

    def delete_replica_group(self, name: str, epoch: int,
                             final: bool = False) -> bool:
        """Free the epoch's group; ``final``: a majority is known to have
        executed its stop (a reconfigurator's drop), so a member that has
        not is freed too."""
        raise NotImplementedError

    def pause_replica_group(self, name: str, epoch: int) -> str:
        """Residency: free the group's engine row, snapshotting state for a
        later resume.  Returns "ok" / "unknown" / "busy"."""
        raise NotImplementedError

    def resume_replica_group(
        self, name: str, epoch: int, members: List[int], row: int,
        pending: bool = True, initial_state=None,
    ) -> bool:
        """Residency: reactivate at a freshly probed row (raises on a row
        collision, like create).  ``initial_state`` seeds a member with no
        local state joining a BIRTH epoch."""
        raise NotImplementedError

    def idle_groups(self, idle_s: float):
        """(name, epoch) pairs idle long enough for a Deactivator sweep."""
        raise NotImplementedError

    def eviction_candidates(self, idle_s: float, limit=None):
        """Admission-aware sweep order: idle_groups sorted coldest-first
        (and capped), hot/queued names excluded.  Default: the unsorted
        idle set truncated — coordinators without heat telemetry still
        honor the cap."""
        out = list(self.idle_groups(idle_s))
        return out if limit is None else out[: max(0, int(limit))]

    def pause_record_keys(self):
        """(name, epoch) of locally held pause records (probe targets)."""
        return []

    def pending_row_keys(self):
        """(name, epoch, row) of rows stuck pre-COMPLETE (probe targets)."""
        return []

    def stopped_row_keys(self):
        """(name, epoch) of current rows whose epoch-final stop has
        executed (probe targets: they await a transition that a race can
        lose)."""
        return []

    def drop_pending_row(self, name: str, epoch: int, row: int) -> None:
        """Free a pending row whose epoch the RC says is gone."""

    def drop_pause_record(self, name: str, epoch: int) -> None:
        """Discard a pause record the RC says is obsolete."""

    def drain_demand(self):
        """{name: (request count since last drain, epoch)} for demand
        reporting (updateDemandStats analog)."""
        raise NotImplementedError

    def demand_backlog(self) -> int:
        """Total unreported request count (early-flush trigger)."""
        raise NotImplementedError

    def hosted_names_count(self) -> int:
        """Names this node currently hosts (the placement plane's
        names-per-active load signal, served to echo probes)."""
        return 0

    def get_replica_group(self, name: str) -> Optional[List[int]]:
        raise NotImplementedError

    # -- epoch introspection (used by ActiveReplica's epoch ops; part of
    # the SPI so non-paxos coordinators can slot in without ActiveReplica
    # reaching into implementation internals) -----------------------------
    def current_epoch(self, name: str) -> Optional[int]:
        raise NotImplementedError

    def is_stopped(self, name: str) -> bool:
        raise NotImplementedError

    def app_caught_up(self, name: str) -> bool:
        """App cursor == device frontier (``app.checkpoint`` is a
        consistent snapshot of everything executed)."""
        raise NotImplementedError

    def hosts_epoch(self, name: str, epoch: int) -> bool:
        """True if this node still holds (name, epoch) — current or demoted."""
        raise NotImplementedError

    def has_pause_record(self, name: str, epoch: int) -> bool:
        """True if (name, epoch) is paged out here (residency pause)."""
        raise NotImplementedError

    def epoch_row_of(self, name: str, epoch: int):
        """The engine row hosting (name, epoch) here, or None."""
        raise NotImplementedError

    def dedup_for_name(self, name: str):
        """Exactly-once entries to ship WITH an app-state handoff.
        There is deliberately NO bare install counterpart on this SPI:
        entries install only THROUGH a create that adopts their state
        (``create_replica_group(dedup=...)``) — an unpaired install was
        the seed-662625602 exactly-once breach."""
        raise NotImplementedError

    def set_stop_callback(self, cb) -> None:
        """Register cb(name, row, epoch), fired when an epoch-final stop
        executes locally (on every replica)."""
        raise NotImplementedError


class PaxosReplicaCoordinator(AbstractReplicaCoordinator):
    """Names -> engine rows via a :class:`PaxosManager`."""

    def __init__(self, app: Replicable, manager: PaxosManager):
        super().__init__(app)
        self.manager = manager

    def coordinate_request(
        self,
        name: str,
        value: str,
        callback: Optional[Callable] = None,
        stop: bool = False,
        request_id: Optional[int] = None,
    ) -> bool:
        if not stop:
            from ..manager import execute_uncoordinated

            handled = execute_uncoordinated(
                self.app, self.manager.names, name, value, request_id,
                callback, gate=self.manager.local_read_ok,
            )
            if handled is not None:
                return handled
        vid = self.manager.propose(
            name, value, callback=callback, stop=stop, request_id=request_id
        )
        # None means either unknown name (failure) or an exactly-once
        # cache hit (already answered through the callback) — both are
        # "nothing new was coordinated"
        return vid is not None

    def create_replica_group(
        self,
        name: str,
        epoch: int,
        members: List[int],
        initial_state: Optional[str],
        row: Optional[int] = None,
        pending: bool = False,
        dedup=None,
    ) -> bool:
        return self.manager.create_paxos_instance(
            name, members, initial_state=initial_state, version=epoch,
            row=row, pending=pending, dedup=dedup,
        )

    def commit_replica_group(
        self, name: str, epoch: int, row: Optional[int] = None
    ) -> None:
        self.manager.commit_row(name, epoch, row=row)

    def delete_replica_group(self, name: str, epoch: int,
                             final: bool = False) -> bool:
        return self.manager.kill_epoch(name, epoch, final=final)

    def pause_replica_group(self, name: str, epoch: int) -> str:
        return self.manager.pause_group(name, epoch)

    def resume_replica_group(
        self, name: str, epoch: int, members: List[int], row: int,
        pending: bool = True, initial_state=None,
    ) -> bool:
        return self.manager.resume_group(
            name, epoch, members, row, pending=pending,
            initial_state=initial_state,
        )

    def idle_groups(self, idle_s: float):
        return self.manager.idle_names(idle_s)

    def eviction_candidates(self, idle_s: float, limit=None):
        return self.manager.eviction_candidates(idle_s, limit=limit)

    def pause_record_keys(self):
        return self.manager.pause_record_keys()

    def pending_row_keys(self):
        return self.manager.pending_row_keys()

    def stopped_row_keys(self):
        return self.manager.stopped_row_keys()

    def drop_pending_row(self, name: str, epoch: int, row: int) -> None:
        self.manager.drop_pending_row(name, epoch, row)

    def drop_pause_record(self, name: str, epoch: int) -> None:
        self.manager.drop_pause_record(name, epoch)

    def drain_demand(self):
        return self.manager.drain_demand()

    def demand_backlog(self) -> int:
        return self.manager.demand_backlog

    def hosted_names_count(self) -> int:
        return len(self.manager.names)

    def get_replica_group(self, name: str) -> Optional[List[int]]:
        return self.manager.get_replica_group(name)

    def current_epoch(self, name: str) -> Optional[int]:
        return self.manager.current_epoch(name)

    def is_stopped(self, name: str) -> bool:
        return self.manager.is_stopped(name)

    def app_caught_up(self, name: str) -> bool:
        return self.manager.app_caught_up(name)

    def hosts_epoch(self, name: str, epoch: int) -> bool:
        return self.manager.epoch_row(name, epoch) is not None

    def has_pause_record(self, name: str, epoch: int) -> bool:
        return (name, int(epoch)) in self.manager.paused

    def epoch_row_of(self, name: str, epoch: int):
        return self.manager.epoch_row(name, epoch)

    def dedup_for_name(self, name: str):
        return self.manager.dedup_for_name(name)

    def set_stop_callback(self, cb) -> None:
        self.manager.on_stop_executed = cb
