"""Reconfigurator: the control-plane replica orchestrating epochs.

API-parity target: ``Reconfigurator`` (``Reconfigurator.java:125``) —
consistent-hashed ownership of names, create (``handleCreateServiceName``
:484), delete (``handleDeleteServiceName``:747, two-phase), replica-set
migration via the protocol-task chain ``WaitAckStopEpoch`` ->
``WaitAckStartEpoch`` -> ``WaitAckDropEpoch`` (§3.5 of SURVEY.md), and
``handleRequestActiveReplicas``:889.  Every RC-record mutation is a paxos
commit on the reconfigurators' own RSM (:mod:`.rc_app`); the record
OWNER (first on the RC consistent-hash ring) drives the protocol tasks
when the commit executes (``CommitWorker`` + primary semantics).

Row allocation (TPU-specific): the engine aligns groups across replicas
by row index, so every member must host a name's epoch at the SAME row.
The RC derives a candidate row from hash(name:epoch) and carries it in
StartEpoch; a member whose row is occupied NACKs, and the start task
re-probes (hash+attempt) until a row clears on a majority — converging
because capacity G far exceeds live names (PINSTANCES_CAPACITY 2M analog).
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..manager import PaxosManager
from ..obs import gplog
from ..obs.reqtrace import RequestTracer
from ..protocoltask import ProtocolExecutor, ProtocolTask, ThresholdProtocolTask
from ..utils.config import Config
from .active_replica import stop_request_id
from .chash import ConsistentHashing
from .rc_config import RC
from .rc_app import (
    AR_ADD,
    AR_REMOVE,
    COMPLETE,
    CREATE_INTENT,
    DELETE_FINAL,
    DELETE_INTENT,
    DROP_DONE,
    PAUSE_DONE,
    PAUSE_INTENT,
    RC_ADD_NODE,
    RC_NODE_DONE,
    RC_REMOVE_NODE,
    REACTIVATE,
    RECONFIGURE_INTENT,
    STOP_DONE,
    RCRecordsApp,
)
from .record import RCState

Addr = Tuple[str, int]

# The reconfigurators' record RSM: one paxos group among all RCs on the
# RC cluster's own engine (RepliconfigurableReconfiguratorDB analog).
RC_GROUP = "__RC_RECORDS__"


def row_for(name: str, epoch: int, attempt: int, n_groups: int) -> int:
    return (zlib.crc32(f"{name}:{epoch}".encode()) + attempt) % n_groups


class StartEpochTask(ProtocolTask):
    """WaitAckStartEpoch analog with row-probe NACK retry."""

    restart_period_s = 1.0
    max_lifetime_s = 30.0

    def __init__(self, key: str, rcf: "Reconfigurator", op: Dict):
        super().__init__(key)
        self.rcf = rcf
        self.op = op  # {name, epoch, actives, prev_actives, prev_epoch, initial_state}
        self.attempt = int(op.get("attempt", 0))
        self.acked: set = set()
        self.majority = len(op["actives"]) // 2 + 1

    @property
    def row(self) -> int:
        return row_for(
            self.op["name"], int(self.op["epoch"]), self.attempt,
            self.rcf.n_groups,
        )

    def start(self):
        tr = self.rcf.tracer
        if tr.enabled:
            tr.note(
                f"epoch:{self.op['name']}", "start-epoch-round",
                name=self.op["name"], node=self.rcf.my_id,
                epoch=self.op["epoch"], row=self.row,
                attempt=self.attempt, pending=sorted(
                    set(self.op["actives"]) - self.acked
                ),
            )
        out = []
        for a in self.op["actives"]:
            if a not in self.acked:
                out.append((("AR", a), "start_epoch", {
                    "name": self.op["name"], "epoch": self.op["epoch"],
                    "actives": self.op["actives"], "row": self.row,
                    "attempt": self.attempt,
                    "initial_state": self.op.get("initial_state"),
                    "prev_actives": self.op.get("prev_actives") or [],
                    "prev_epoch": self.op.get("prev_epoch", -1),
                    "resume": bool(self.op.get("resume")),
                    "rc": ["RC", self.rcf.my_id],
                }))
        return out

    def handle_event(self, kind: str, body: Dict):
        if kind != "ack_start_epoch" or int(body["row"]) != self.row:
            return ()
        if not body.get("ok"):
            if body.get("reason") == "collision":
                # row occupied somewhere: probe the next candidate everywhere
                self.attempt += 1
                # remember the probe position so an expired task's re-drive
                # resumes here instead of restarting at attempt 0
                self.rcf._last_attempt[self.op["name"]] = self.attempt
                self.acked.clear()
                return self.start()
            # transient refusal ("not-ready": e.g. the old epoch's stop
            # hasn't landed on that member yet) — same row, just wait for
            # the periodic retransmit; re-probing would churn rows
            return ()
        self.acked.add(int(body["from"]))
        if len(self.acked) >= self.majority:
            self.done = True
            # commit COMPLETE (with the row that won) through RC paxos;
            # prev-epoch info rides along so the applied callback can GC
            # it, and the ack set so laggards get a late-start retransmit
            self.rcf.propose_op({
                "op": COMPLETE, "name": self.op["name"], "row": self.row,
                "attempt": self.attempt,
                "acked": sorted(self.acked),
                "prev_actives": self.op.get("prev_actives") or [],
                "prev_epoch": self.op.get("prev_epoch", -1),
                "resume": bool(self.op.get("resume")),
            })
        return ()


class PauseEpochTask(ThresholdProtocolTask):
    """Residency pause round: every active frees the group's row (all-ack
    threshold — a row is only reusable on members that freed it, and the
    collision NACK protects against partial pauses).  A busy NACK (traffic
    resumed) cancels the pause by reactivating immediately."""

    restart_period_s = 1.0
    max_lifetime_s = 30.0

    def __init__(self, key: str, rcf: "Reconfigurator", name: str,
                 epoch: int, actives: List[int]):
        super().__init__(key, actives, threshold=len(actives))
        self.rcf = rcf
        self.name = name
        self.epoch = epoch

    def send_to(self, node):
        return (("AR", node), "pause_epoch", {
            "name": self.name, "epoch": self.epoch,
            "rc": ["RC", self.rcf.my_id],
        })

    def is_ack(self, kind, body):
        if kind != "ack_pause_epoch" or body["name"] != self.name \
                or int(body["epoch"]) != self.epoch:
            return None
        if not body.get("ok"):
            # busy: the group saw traffic — cancel by reactivating (the
            # members that already paused re-home via the resume round)
            self.done = True
            self.rcf.kick_reactivate(self.name)
            return None
        return int(body["from"])

    def on_threshold(self):
        self.rcf.propose_op({"op": PAUSE_DONE, "name": self.name})
        return ()


class LateStartTask(ThresholdProtocolTask):
    """Post-COMPLETE retransmit of start_epoch to members that had not yet
    acked when the majority was reached — without it those members never
    learn the epoch and the group runs under-replicated until a
    missed-birth discovery finds them.  ``on_finished`` fires exactly once
    when every laggard acked OR the task expires — the previous epoch's
    drop is chained off it so a laggard's final-state fetch still finds
    donors (dropping concurrently would purge them)."""

    restart_period_s = 2.0
    max_lifetime_s = 120.0

    def __init__(self, key: str, rcf: "Reconfigurator", body: Dict,
                 laggards: List[int],
                 on_finished: Optional[Callable[[], None]] = None):
        super().__init__(key, laggards, threshold=len(laggards))
        self.rcf = rcf
        self.body = body  # the winning start_epoch body (final row/attempt)
        self._on_finished = on_finished

    def send_to(self, node):
        return (("AR", node), "start_epoch", self.body)

    def is_ack(self, kind, body):
        if kind == "ack_start_epoch" and body.get("ok") \
                and int(body["row"]) == int(self.body["row"]):
            return int(body["from"])
        return None

    def on_threshold(self):
        self._finish()
        return ()

    def on_expire(self):
        self._finish()

    def _finish(self):
        cb, self._on_finished = self._on_finished, None
        if cb is not None:
            cb()


class EpochCommitTask(ThresholdProtocolTask):
    """Post-COMPLETE confirmation of the winning row to EVERY new active:
    lifts the pre-COMPLETE admission gate (manager ``pending_rows``).  All
    members must confirm — a member stuck pending holds every proposal it
    receives (fatal for the whole group if that member is the ballot
    coordinator) — so an unconfirmed round is re-driven from the record
    scan until every active acks (``_redrive_records``; a fresh RC also
    re-drives rounds for READY records it can't prove confirmed, covering
    the restart-after-COMPLETE case)."""

    restart_period_s = 2.0
    max_lifetime_s = 120.0

    def __init__(self, key: str, rcf: "Reconfigurator", name: str,
                 epoch: int, actives: List[int], row: int,
                 initial_state: Optional[str] = None):
        super().__init__(key, actives, threshold=len(actives))
        self.rcf = rcf
        self.name = name
        self.epoch = epoch
        self.row = row
        self.initial_state = initial_state

    def send_to(self, node):
        # the winning row rides along: a laggard still holding a LOSING
        # row for this epoch must NOT un-pend it (the losing row may alias
        # another group on its peers) — it waits for the late-start.
        # The actives list rides too: a member at the right (epoch, row)
        # but with a STALE member set would otherwise ack ok and keep
        # ignoring the true members' blobs forever (mask split-brain)
        return (("AR", node), "epoch_commit", {
            "name": self.name, "epoch": self.epoch, "row": self.row,
            "actives": sorted(self.nodes),
            "rc": ["RC", self.rcf.my_id],
        })

    def is_ack(self, kind, body):
        if kind != "ack_epoch_commit" or body["name"] != self.name \
                or int(body["epoch"]) != self.epoch:
            return None
        if body.get("reason") == "missing":
            # the member never joined the epoch (its start_epoch was lost
            # and the one-shot late-start may have expired): heal its
            # membership here — a committed start re-creates the group.
            # GUARD: only while the record is STILL at this epoch and
            # READY — a late retransmit of an old commit round must never
            # resurrect a dropped epoch as a zombie group on a
            # migrated-off member.
            rec = self.rcf.rc_app.get_record(self.name)
            if rec is None or rec.deleted or rec.epoch != self.epoch \
                    or rec.state is not RCState.READY \
                    or rec.row != self.row \
                    or int(body["from"]) not in rec.actives:
                # rec.row check (ADVICE r3): after a pause->reactivate the
                # epoch survives but the row moves — this round's heal
                # would resume the member back onto the OBSOLETE row
                return None
            self.rcf.send_committed_resume(
                int(body["from"]), self.name, self.epoch,
                list(self.nodes), self.row, self.initial_state,
            )
            return None  # the retransmitted commit confirms after the join
        return int(body["from"])

    def on_threshold(self):
        # keyed by ROW as well: a reactivation keeps the epoch but moves
        # the row, and its commit round must be re-drivable independently
        self.rcf._commit_done[(self.name, self.epoch, self.row)] = (
            time.monotonic()
        )
        return ()


class StopEpochTask(ThresholdProtocolTask):
    """WaitAckStopEpoch analog: majority-stop the old epoch."""

    restart_period_s = 1.0
    max_lifetime_s = 30.0

    def __init__(self, key: str, rcf: "Reconfigurator", name: str,
                 epoch: int, actives: List[int],
                 on_stopped: Callable[[], None], row: int = -1):
        super().__init__(key, actives)  # majority threshold default
        self.rcf = rcf
        self.name = name
        self.epoch = epoch
        self.row = row
        self._on_stopped = on_stopped

    def send_to(self, node):
        return (("AR", node), "stop_epoch", {
            "name": self.name, "epoch": self.epoch, "row": self.row,
            "rc": ["RC", self.rcf.my_id],
        })

    def is_ack(self, kind, body):
        if kind == "ack_stop_epoch" and body["name"] == self.name \
                and int(body["epoch"]) == self.epoch:
            return int(body["from"])
        return None

    def on_threshold(self):
        self._on_stopped()
        return ()


class DropEpochTask(ThresholdProtocolTask):
    """WaitAckDropEpoch analog: GC the old epoch everywhere.

    Two completion policies: the DELETE chain sets
    ``fire_done_on_expire=True`` so a dead active can't wedge DELETE_FINAL
    (stragglers go to the in-memory re-drop list); the reconfiguration
    prev-epoch drop sets it False — its re-drive is record-level
    (``pending_drop_epoch``, paxos-replicated) and survives RC restarts."""

    restart_period_s = 2.0
    max_lifetime_s = 60.0

    def __init__(self, key: str, rcf: "Reconfigurator", name: str,
                 epoch: int, actives: List[int],
                 on_done: Optional[Callable[[], None]] = None,
                 fire_done_on_expire: bool = True):
        super().__init__(key, actives, threshold=len(actives))
        self.rcf = rcf
        self.name = name
        self.epoch = epoch
        self._on_done = on_done
        self._fire_on_expire = fire_done_on_expire

    def send_to(self, node):
        return (("AR", node), "drop_epoch", {
            "name": self.name, "epoch": self.epoch,
            "rc": ["RC", self.rcf.my_id],
        })

    def is_ack(self, kind, body):
        if kind == "ack_drop_epoch" and body["name"] == self.name \
                and int(body["epoch"]) == self.epoch:
            return int(body["from"])
        return None

    def on_threshold(self):
        self._fire_done()
        return ()

    def on_expire(self):
        if not self._fire_on_expire:
            return  # record-level re-drive respawns this drop
        # Best-effort GC: a dead active must not wedge the chain forever
        # (the delete path gates DELETE_FINAL on this).  Stragglers are
        # remembered and re-dropped periodically once they resurface
        # (MAX_FINAL_STATE_AGE re-drop analog, Reconfigurator.java:747) —
        # without that a 60s-partitioned active would leak the stopped row
        # until process death.
        self._fire_done()
        stragglers = [n for n in self.nodes if n not in self.acked]
        if stragglers:
            self.rcf.note_unfinished_drop(self.name, self.epoch, stragglers)

    def _fire_done(self):
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb()


class RCJoinTask(ThresholdProtocolTask):
    """Drive every member of the NEW reconfigurator epoch to host it
    (the RC-node transition's start round, handleReconfigureRCNodeConfig
    analog — ref ``Reconfigurator.java:1023-1075``).  Surviving members
    created the epoch locally at stop time and ack immediately; a joining
    node blank-creates it and heals through the manager's state-transfer
    (which carries app state + dedup entries).  All-ack threshold: the
    transition only commits (RC_NODE_DONE) once every member of the new
    control plane hosts the record RSM."""

    restart_period_s = 1.0
    max_lifetime_s = 120.0

    def __init__(self, key: str, rcf: "Reconfigurator", epoch: int,
                 members: List[int], row: int,
                 on_all: Callable[[], None]):
        super().__init__(key, members, threshold=len(members))
        self.rcf = rcf
        self.epoch = int(epoch)
        self.members = [int(m) for m in members]
        self.row = int(row)
        self._on_all = on_all

    def send_to(self, node):
        return (("RC", node), "rc_join", {
            "epoch": self.epoch, "members": self.members, "row": self.row,
            "rc": ["RC", self.rcf.my_id],
        })

    def is_ack(self, kind, body):
        if kind == "ack_rc_join" and int(body["epoch"]) == self.epoch:
            return int(body["from"])
        return None

    def on_threshold(self):
        self._on_all()
        return ()


class Reconfigurator:
    def __init__(
        self,
        my_id: int,
        rc_manager: PaxosManager,
        rc_app: RCRecordsApp,
        actives: List[int],
        reconfigurators: List[int],
        send: Callable[[Addr, str, Dict], None],
        default_replicas: Optional[int] = None,  # None -> RC.DEFAULT_NUM_REPLICAS
        ar_n_groups: Optional[int] = None,       # row space of the AR engine
        is_node_up: Optional[Callable[[int], bool]] = None,  # RC liveness
        demand_profiler=None,  # AggregateDemandProfiler override (tests)
        placement_policy_cls=None,  # AbstractPlacementPolicy override (tests)
    ):
        self.my_id = int(my_id)
        self.rc_manager = rc_manager
        self.rc_app = rc_app
        self.send = send
        self.log = gplog.node_logger("rc", my_id)
        # epoch-plane tracing (same DEBUG gate as the data plane): epoch
        # ops for a name trace under the key "epoch:<name>", so a soak
        # divergence can dump the name's reconfiguration timeline next to
        # its request timelines
        self.tracer = RequestTracer(my_id)
        # rows are probed in the APP engine's row space; default to the RC
        # engine's only for legacy in-process setups that share the shape
        self.n_groups = (
            rc_manager.cfg.n_groups if ar_n_groups is None else int(ar_n_groups)
        )
        self.default_replicas = (
            Config.get_int(RC.DEFAULT_NUM_REPLICAS)
            if default_replicas is None else int(default_replicas)
        )
        self.REDRIVE_EVERY = Config.get_int(RC.REDRIVE_EVERY)
        self.MAX_REDROPS = Config.get_int(RC.MAX_REDROPS)
        # elastic membership: the replicated AR set (rc_app.ar_nodes) wins
        # over the boot configuration once any add/remove has committed
        self._boot_actives = [int(a) for a in actives]
        live = (rc_app.ar_nodes if rc_app.ar_nodes is not None
                else self._boot_actives)
        self.ar_ids = set(int(a) for a in live)
        self.ar_ring = ConsistentHashing(sorted(self.ar_ids))
        # the RC ring re-splits record ownership when the control plane
        # itself grows/shrinks (RC_ADD_NODE/RC_REMOVE_NODE): the replicated
        # set wins over the boot configuration, and a transition past its
        # stop point hands ownership to the TARGET set
        self._boot_rcs = sorted(int(r) for r in reconfigurators)
        self.rc_ring = ConsistentHashing(self._rc_set())
        # RC-peer liveness for primary takeover (default: all alive)
        self.is_node_up = is_node_up or (lambda _rc: True)
        # demand aggregation at the record's primary (handleDemandReport)
        from .demand import AggregateDemandProfiler

        self.demand = (
            AggregateDemandProfiler() if demand_profiler is None
            else demand_profiler
        )
        # the placement plane (ProximateBalance analog): per-active load
        # + probed-RTT signal tables and the pluggable policy, consulted
        # at create time and on the demand-report reconfigure path.
        # Decisions surface through the RC manager's metrics registry
        # (stats admin op / RC /metrics)
        from .placement import PlacementEngine

        self.placement = PlacementEngine(
            my_id, policy_cls=placement_policy_cls,
            metrics=rc_manager.metrics,
        )
        self.echo_probe_period_s = Config.get_float(RC.ECHO_PROBE_PERIOD_S)
        self._last_echo_probe = 0.0  # never probed: first tick orients
        self.tasks = ProtocolExecutor(send=lambda m: self.send(m[0], m[1], m[2]))
        # client replies owed on COMPLETE / DELETE_FINAL: name -> client addr
        self._pending_clients: Dict[str, Any] = {}
        # epochs whose drop expired with unreached stragglers: re-dropped
        # periodically so a long-partitioned active doesn't leak the row
        # forever (MAX_FINAL_STATE_AGE re-drop analog)
        # (name, epoch) -> (stragglers, attempts, last attempt time)
        self._unfinished_drops: Dict[Tuple[str, int], Tuple] = {}
        # epochs whose commit round every active confirmed; READY records
        # not in here get the round re-driven (in-memory: a restarted RC
        # re-confirms each READY record once — idempotent at the ARs)
        # (name, epoch, row) -> completion time of the last commit
        # round.  A TIMESTAMP, not a set: a member can lose its row
        # AFTER the round completed (failed re-home, aborted pause)
        # with nothing left to probe — the READY audit re-runs the
        # idempotent commit round at a slow cadence so such members
        # are eventually re-healed (chaos-sweep find: a READY record
        # with one member hosting nothing, forever)
        self._commit_done: Dict[Tuple[str, int, int], float] = {}
        self.ready_audit_period_s = Config.get_float(
            RC.READY_AUDIT_PERIOD_S
        )
        # last row-probe attempt per name: an expired start task's re-drive
        # resumes probing here instead of restarting at attempt 0
        self._last_attempt: Dict[str, int] = {}
        # batched creates (Reconfigurator.java:484-680 batch path):
        # batch_id -> {client, pending names, per-name results}; one
        # create_batch_ack per batch when every member settles.  In-memory
        # like _pending_clients — a client retransmit rebuilds it.
        self._batches: Dict[str, Dict] = {}
        # name -> batch ids awaiting it (a SET: two concurrent batches may
        # both contain the same in-flight name; completing one must not
        # strand the other)
        self._batch_of: Dict[str, set] = {}
        self._tick_count = 0
        # RC-node transition scratch: the stop-time capture of the record
        # RSM ({"from_epoch", "row", "old"}) — set by the manager's stop
        # hook, consumed by _advance_rc_transition on the next tick (the
        # hook fires inside the manager's execution loop; group surgery is
        # deferred out of it)
        self._rc_final: Optional[Dict] = None
        rc_app.on_applied = self._on_applied
        rc_app.on_restored = self._refresh_rings
        rc_manager.on_stop_executed = self._on_rc_stop

    # ------------------------------------------------------------------
    def primary_of(self, name: str) -> int:
        """Effective record owner: the first LIVE reconfigurator on the
        name's ring (WaitPrimaryExecution analog,
        ``WaitPrimaryExecution.java:60`` — a secondary takes over a dead
        primary's pending reconfigurations).  Liveness comes from the
        injected ``is_node_up`` hook (the RC cluster's failure detector);
        the default considers everyone alive (= static ring primary)."""
        order = self.rc_ring.get_replicated_servers(
            name, len(self.rc_ring.nodes)
        )
        for rc in order:
            if rc == self.my_id or self.is_node_up(rc):
                return rc
        return order[0] if order else self.my_id

    def is_primary(self, name: str) -> bool:
        return self.primary_of(name) == self.my_id

    def propose_op(self, op: Dict) -> None:
        """Commit an RC-record mutation through the RC paxos group
        (CommitWorker semantics: the protocol task retransmits around it)."""
        if self.tracer.enabled and op.get("name"):
            self.tracer.note(
                f"epoch:{op['name']}", f"rc-propose:{op.get('op')}",
                name=op["name"], node=self.my_id,
                epoch=op.get("epoch"), actives=op.get("actives"),
                new_actives=op.get("new_actives"),
            )
        self.rc_manager.propose(RC_GROUP, json.dumps(op))

    # ------------------------------------------------------------------
    # client/admin ingress
    # ------------------------------------------------------------------
    def handle_message(self, kind: str, body: Dict, frm: Optional[Any] = None) -> None:
        if kind == "create_service":
            self._handle_create(body)
        elif kind == "create_service_batch":
            self._handle_create_batch(body)
        elif kind == "delete_service":
            self._handle_delete(body)
        elif kind == "reconfigure":
            self._handle_reconfigure(body)
        elif kind == "request_actives":
            self._handle_request_actives(body)
        elif kind in ("ack_start_epoch",):
            # start tasks are keyed by (name, epoch) so an old epoch's
            # late-start ack isn't swallowed by a newer epoch's start task
            name, epoch = body["name"], body.get("epoch")
            if not self.tasks.handle_event(f"start:{name}:{epoch}", kind, body):
                self.tasks.handle_event(
                    f"latestart:{name}:{epoch}", kind, body
                )
        elif kind in ("ack_stop_epoch",):
            self.tasks.handle_event(f"stop:{body['name']}", kind, body)
        elif kind in ("ack_drop_epoch",):
            # drop tasks are keyed by (name, epoch): an ack for an older
            # epoch's redrop must not be swallowed by a newer epoch's task
            dkey = f"drop:{body['name']}:{body.get('epoch')}"
            if not self.tasks.handle_event(dkey, kind, body):
                self.tasks.handle_event(
                    f"redrop:{body['name']}:{body.get('epoch')}", kind, body
                )
        elif kind in ("ack_epoch_commit",):
            # row-keyed (ADVICE r3): a reactivation keeps the epoch but
            # moves the row — its commit round must be independent of a
            # stale round still live for the old row, or the correct-row
            # round cannot spawn until the stale task expires
            self.tasks.handle_event(
                f"commit:{body['name']}:{body.get('epoch')}"
                f":{body.get('row')}",
                kind, body,
            )
        elif kind in ("ack_pause_epoch",):
            self.tasks.handle_event(f"pause:{body['name']}", kind, body)
        elif kind == "suggest_pause":
            self._handle_suggest_pause(body)
        elif kind == "epoch_probe":
            self._handle_epoch_probe(body)
        elif kind == "reactivate_service":
            self.kick_reactivate(body["name"])
        elif kind == "demand_report":
            self._handle_demand_report(body)
        elif kind == "echo_reply":
            self._handle_echo_reply(body)
        elif kind in ("add_active", "remove_active"):
            self._handle_membership(kind, body)
        elif kind in ("add_reconfigurator", "remove_reconfigurator"):
            self._handle_rc_membership(kind, body)
        elif kind == "rc_join":
            self._handle_rc_join(body)
        elif kind == "ack_rc_join":
            self.tasks.handle_event(
                f"rcjoin:{int(body['epoch'])}", kind, body
            )

    def tick(self, now: Optional[float] = None) -> None:
        self.tasks.tick(now)
        self._tick_count += 1
        self._advance_rc_transition()
        self._maybe_echo_probe(now)
        if self._tick_count % self.REDRIVE_EVERY == 0:
            self._redrive_records()
            self._redrive_unfinished_drops()

    # ---- active orientation (EchoRequest, Reconfigurator.java:2420) ----
    def _maybe_echo_probe(self, now: Optional[float] = None) -> None:
        """Periodic echo round to every live active: replies populate the
        placement plane's RTT row and load table, so create-time
        placement is latency/load-aware BEFORE any real traffic."""
        if self.echo_probe_period_s <= 0:
            return
        now = time.time() if now is None else now
        if now - self._last_echo_probe < self.echo_probe_period_s:
            return
        self._last_echo_probe = now
        for a in sorted(self.ar_ids):
            self.send(("AR", a), "echo", {
                "ts": time.time(), "rc": ["RC", self.my_id],
            })

    def _handle_echo_reply(self, body: Dict) -> None:
        ts = body.get("ts")
        rtt = max(0.0, time.time() - float(ts)) if ts is not None else None
        if rtt is None:
            return
        self.placement.note_echo(
            int(body["from"]), rtt, body.get("names"), body.get("rps")
        )

    def note_unfinished_drop(
        self, name: str, epoch: int, stragglers: List[int]
    ) -> None:
        if self.tracer.enabled:
            self.tracer.note(
                f"epoch:{name}", "drop-unfinished", name=name,
                node=self.my_id, epoch=epoch, stragglers=list(stragglers),
            )
        prev = self._unfinished_drops.get((name, epoch))
        # preserve the previous attempt timestamp: resetting it to 0.0
        # made the post-budget slow cadence (`_redrive_unfinished_drops`'s
        # audit-period gate) always appear expired, turning the bounded
        # fallback into continuous retransmits
        self._unfinished_drops[(name, epoch)] = (
            list(stragglers), prev[1] if prev else 0,
            prev[2] if prev else 0.0,
        )

    def _redrive_unfinished_drops(self) -> None:
        for (name, epoch), (nodes, att, last_t) in list(
            self._unfinished_drops.items()
        ):
            key = f"redrop:{name}:{epoch}"
            if self.tasks.is_running(key):
                continue
            if att >= self.MAX_REDROPS:
                # budget exhausted: fall back to the slow audit cadence
                # instead of giving up FOREVER (chaos-sweep find: names
                # lingering post-delete once the redrop budget burned out
                # during a lossy phase) — one attempt per audit period is
                # bounded traffic, and a straggler that heals mid-window
                # acks the next attempt
                if time.monotonic() - last_t < self.ready_audit_period_s:
                    continue
            self._unfinished_drops[(name, epoch)] = (
                list(nodes), att + 1, time.monotonic()
            )
            self.tasks.spawn_if_not_running(
                key,
                lambda k=key, n=name, e=epoch, nd=list(nodes): DropEpochTask(
                    k, self, n, e, nd,
                    on_done=lambda n=n, e=e: self._unfinished_drops.pop(
                        (n, e), None
                    ),
                    fire_done_on_expire=False,
                ),
            )

    # ---- create (handleCreateServiceName, Reconfigurator.java:484) -----
    def _create_locally(
        self, name: str, actives: Optional[List[int]],
        initial_state: Optional[str],
    ):
        """Shared create core: returns "pending" (CREATE_INTENT proposed),
        "inflight" (an identical creation already mid-flight), or a dict
        result for an immediate answer."""
        rec = self.rc_app.get_record(name)
        if rec is not None and not rec.deleted:
            if rec.state is RCState.WAIT_ACK_START and not rec.actives:
                return "inflight"
            return {"ok": False, "reason": "exists", "actives": rec.actives}
        # create-time placement: the placement policy picks from the
        # load/latency signal tables (probed before any traffic); the
        # consistent-hash ring stays as the fallback for a policy that
        # returns nothing usable
        actives = actives or self.placement.place_initial(
            name, sorted(self.ar_ids), self.default_replicas
        ) or self.ar_ring.get_replicated_servers(
            name, self.default_replicas
        )
        if self._bad_actives(actives):
            return {"ok": False, "reason": "bad-actives"}
        self.propose_op({
            "op": CREATE_INTENT, "name": name, "epoch": 0,
            "actives": actives, "row": row_for(name, 0, 0, self.n_groups),
            "initial_state": initial_state,
        })
        return "pending"

    def _handle_create(self, body: Dict) -> None:
        name = body["name"]
        if not self.is_primary(name):
            # forward to the owner (the reference redirects via the ring)
            self.send(("RC", self.primary_of(name)), "create_service", body)
            return
        status = self._create_locally(
            name, body.get("actives"), body.get("initial_state")
        )
        if status in ("pending", "inflight"):
            # client answered at COMPLETE (a retransmit during an
            # in-flight creation re-registers instead of a false "exists")
            if body.get("client") is not None:
                self._pending_clients[name] = body["client"]
            return
        self._reply(body, "create_ack", name,
                    **{k: v for k, v in status.items() if k != "actives"})

    def _handle_create_batch(self, body: Dict) -> None:
        """Batched creates (the reference's batched CreateServiceName
        split by RC group: ``Reconfigurator.java:484-680``,
        ``CreateServiceName.java`` nested name-states): N names cost the
        client ONE round trip to this RC instead of N.  Names that hash
        to another RC (client ring drift) are forwarded singly and
        reported ``forwarded`` — the client retries those individually."""
        batch_id = str(body.get("batch_id"))
        ent = self._batches.get(batch_id)
        if ent is None:
            ent = self._batches[batch_id] = {
                "client": body.get("client"), "pending": set(), "results": {},
            }
        elif body.get("client") is not None:
            ent["client"] = body["client"]  # retransmit re-registers
        for c in body.get("creates", ()):
            name = c.get("name")
            if not name or name in ent["pending"]:
                continue
            if not self.is_primary(name):
                self.send(("RC", self.primary_of(name)), "create_service", {
                    "name": name, "actives": c.get("actives"),
                    "initial_state": c.get("initial_state"),
                })
                ent["results"][name] = {"ok": False, "reason": "forwarded"}
                continue
            status = self._create_locally(
                name, c.get("actives"), c.get("initial_state")
            )
            if status in ("pending", "inflight"):
                ent["pending"].add(name)
                self._batch_of.setdefault(name, set()).add(batch_id)
            elif status.get("reason") == "exists":
                # idempotent batch retransmit: an existing name is success
                ent["results"][name] = {
                    "ok": True, "existed": True,
                    "actives": status.get("actives"),
                }
            else:
                ent["results"][name] = status
        self._maybe_finish_batch(batch_id)

    def _note_batch_done(self, name: str, **fields) -> None:
        bids = self._batch_of.pop(name, None)
        if not bids:
            return
        for bid in bids:
            ent = self._batches.get(bid)
            if ent is None:
                continue
            ent["pending"].discard(name)
            ent["results"][name] = fields
            self._maybe_finish_batch(bid)

    def _maybe_finish_batch(self, bid: str) -> None:
        ent = self._batches.get(bid)
        if ent is None or ent["pending"]:
            return
        del self._batches[bid]
        client = ent.get("client")
        if client is not None:
            # "name" carries the batch id: the client's waiter table keys
            # acks by (kind, name)
            self.send(tuple(client), "create_batch_ack", {
                "name": bid, "batch_id": bid, "results": ent["results"],
            })

    # ---- reconfigure (epoch e -> e+1, §3.5) ----------------------------
    def _handle_reconfigure(self, body: Dict) -> None:
        name = body["name"]
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)), "reconfigure", body)
            return
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted:
            self._reply(body, "reconfigure_ack", name, ok=False,
                        reason="not-ready")
            return
        if rec.state is not RCState.READY:
            if rec.state in (RCState.PAUSED, RCState.WAIT_PAUSE):
                # wake the record so the client's retry can succeed
                self.kick_reactivate(name)
            if rec.new_actives == list(body["new_actives"]) and \
                    not rec.resuming:
                # same migration already in flight: a client retransmit
                # re-registers for the eventual COMPLETE reply
                if body.get("client") is not None:
                    self._pending_clients[name] = body["client"]
            else:
                self._reply(body, "reconfigure_ack", name, ok=False,
                            reason="not-ready")
            return
        if self._bad_actives(body["new_actives"]):
            # an unknown/empty target set would commit an epoch bump whose
            # start round can never complete — the record would wedge in
            # WAIT_ACK_START forever with no error to anyone
            self._reply(body, "reconfigure_ack", name, ok=False,
                        reason="bad-actives")
            return
        if sorted(rec.actives) == sorted(body["new_actives"]):
            # already at the target set: a completed migration's delayed
            # retransmit must NOT start a redundant epoch bump (the
            # reference skips same-set reconfigurations unless
            # RECONFIGURE_IN_PLACE, ReconfigurationConfig.java:268)
            self._reply(body, "reconfigure_ack", name, ok=True,
                        actives=rec.actives, epoch=rec.epoch)
            return
        new_actives = body["new_actives"]
        if body.get("client") is not None:
            self._pending_clients[name] = body["client"]
        self.propose_op({
            "op": RECONFIGURE_INTENT, "name": name,
            "new_actives": new_actives,
            "new_row": row_for(name, rec.epoch + 1, 0, self.n_groups),
        })

    # ---- delete (two-phase, Reconfigurator.java:747) -------------------
    def _handle_delete(self, body: Dict) -> None:
        name = body["name"]
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)), "delete_service", body)
            return
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted:
            self._reply(body, "delete_ack", name, ok=False, reason="unknown")
            return
        if rec.state is RCState.WAIT_DELETE:
            # same delete already in flight: a retransmit re-registers for
            # the eventual DELETE_FINAL reply instead of a false failure
            if body.get("client") is not None:
                self._pending_clients[name] = body["client"]
            return
        if rec.state is not RCState.READY:
            if rec.state in (RCState.PAUSED, RCState.WAIT_PAUSE):
                # a paused name must stay deletable: wake it so the
                # client's delete retry finds it READY
                self.kick_reactivate(name)
            # mid-transition: DELETE_INTENT would be refused by the
            # record RSM and the client would never hear back — reply now
            self._reply(body, "delete_ack", name, ok=False, reason="not-ready")
            return
        if body.get("client") is not None:
            self._pending_clients[name] = body["client"]
        self.propose_op({"op": DELETE_INTENT, "name": name})

    # ---- reads (handleRequestActiveReplicas, :889) ---------------------
    def _handle_request_actives(self, body: Dict) -> None:
        rec = self.rc_app.get_record(body["name"])
        if rec is not None and not rec.deleted and \
                rec.state in (RCState.PAUSED, RCState.WAIT_PAUSE):
            # a touch reactivates (message-triggered unpause analog,
            # PaxosManager.java:2350); the client retries until READY
            self.kick_reactivate(body["name"])
            self._reply(body, "actives_response", body["name"], ok=False,
                        reason="paused", actives=[], epoch=rec.epoch, row=-1)
            return
        ok = rec is not None and not rec.deleted and bool(rec.actives)
        self._reply(body, "actives_response", body["name"], ok=ok,
                    actives=(rec.actives if ok else []),
                    epoch=(rec.epoch if ok else -1),
                    row=(rec.row if ok else -1))

    # ---- elastic membership (handleReconfigureActiveNodeConfig,
    # Reconfigurator.java:1023-1075) -------------------------------------
    def _handle_membership(self, kind: str, body: Dict) -> None:
        nid = self._membership_ingress(kind, body, "#m")
        if nid is None:
            return
        self.propose_op({
            "op": AR_ADD if kind == "add_active" else AR_REMOVE,
            "id": nid,
            "boot_actives": sorted(self.ar_ids),
        })

    # ------------------------------------------------------------------
    # runtime reconfigurator membership (handleReconfigureRCNodeConfig
    # analog, ref Reconfigurator.java:1023-1075): the record RSM stops its
    # current epoch and restarts under the target set; ring ownership of
    # every record re-splits at the stop point
    # ------------------------------------------------------------------
    def _membership_ingress(self, kind: str, body: Dict,
                            key_prefix: str) -> Optional[int]:
        """Shared AR/RC membership ingress: id-mask guard (engine
        membership is a 32-bit bitmask), concurrent-requester client list,
        and the always-propose rule (the committed outcome — not this
        RC's possibly-stale local view — decides the ack)."""
        nid = int(body["id"])
        if not (0 <= nid < 32):
            self._reply(body, f"{kind}_ack", str(nid), id=nid, ok=False,
                        reason="bad-id")
            return None
        # a node that cannot own the committed outcome must hand the
        # request to a live member that can (the create-path primary
        # forward, applied to membership ops — review find): either it
        # does not host the record RSM at all (standby, or removed from
        # the control plane — its propose would silently return None), or
        # it IS the node a remove targets (it kills its row at phase 2
        # and never applies RC_NODE_DONE, so its client ack would leak)
        removes_me = (
            key_prefix == "#rc" and kind == "remove_reconfigurator"
            and nid == self.my_id
        )
        # `fwd` carries the ids that already held (and could not own) this
        # op: each hop adds itself and only unvisited RCs are candidates,
        # so the forward chain is bounded by the RC set — two RCs that
        # each consider themselves unable to own the op (e.g. both still
        # bootstrapping the record RSM) can no longer ping-pong the frame
        # forever, yet the op still reaches a capable THIRD node instead
        # of dying at the second
        if self.rc_manager.names.get(RC_GROUP) is None or removes_me:
            visited = set(body.get("fwd") or ()) | {self.my_id}
            for rc in self._rc_set():
                if rc in visited or not self.is_node_up(rc):
                    continue
                if key_prefix == "#rc" and kind == "remove_reconfigurator" \
                        and rc == nid:
                    continue  # the removal target cannot own its own ack
                self.send(
                    ("RC", int(rc)), kind, dict(body, fwd=sorted(visited))
                )
                return None
            # every live candidate already saw this op (or none is live):
            # fall through and try locally
        if body.get("client") is not None:
            self._pending_clients.setdefault(
                f"{key_prefix}:{kind}:{nid}", []
            ).append(body["client"])
        return nid

    def _handle_rc_membership(self, kind: str, body: Dict) -> None:
        nid = self._membership_ingress(kind, body, "#rc")
        if nid is None:
            return
        self.propose_op({
            "op": RC_ADD_NODE if kind == "add_reconfigurator"
            else RC_REMOVE_NODE,
            "id": nid,
            "boot_rcs": self._rc_set(),
        })

    def _ack_rc_membership(self, op: Dict, ok: bool,
                           reason: Optional[str] = None) -> None:
        kind = ("add_reconfigurator" if op["op"] == RC_ADD_NODE
                else "remove_reconfigurator")
        clients = self._pending_clients.pop(
            f"#rc:{kind}:{int(op['id'])}", None
        )
        for client in clients or []:
            body = {"id": int(op["id"]), "name": str(op["id"]), "ok": ok,
                    "reconfigurators": self._rc_set()}
            if reason:
                body["reason"] = reason
            self.send(tuple(client), f"{kind}_ack", body)

    def _rc_transition_driver(self, cands: List[int]) -> bool:
        """Deterministic transition driver with liveness takeover: the
        first live candidate in sorted order (WaitPrimaryExecution-style
        — a dead driver's duties fall to the next survivor)."""
        for rc in sorted(set(int(c) for c in cands)):
            if rc == self.my_id:
                return True
            if self.is_node_up(rc):
                return False
        return False

    def _on_rc_stop(self, name: str, row: int, epoch: int) -> None:
        """Manager hook: the record RSM's own epoch-final stop executed.
        Capture the transition point; the group surgery happens on the
        next tick (this hook fires inside the manager's execution loop)."""
        if name != RC_GROUP:
            return
        old = self.rc_manager.get_replica_group(RC_GROUP) or []
        self._rc_final = {
            "from_epoch": int(epoch), "row": int(row),
            "old": [int(m) for m in old],
        }

    def _rc_row(self, new_epoch: int, avoid: set) -> Optional[int]:
        """Deterministic row for the record RSM's next epoch, skipping
        occupied rows.  None when no free row exists (a one-row RC
        engine): the caller must free the old row before creating."""
        G = self.rc_manager.cfg.n_groups
        for attempt in range(G):
            r = row_for(RC_GROUP, new_epoch, attempt, G)
            if r not in avoid:
                return r
        return None

    def _advance_rc_transition(self) -> None:
        """Per-tick driver of an armed RC-node transition (idempotent, so
        a restarted/laggard RC re-walks whatever phase it finds itself in):

          phase 1 (pre-stop): the driver proposes the epoch-final stop on
            the record RSM (deterministic request id — every member may
            propose, dedup collapses to one execution);
          phase 2 (stop executed locally): surviving members re-create the
            RSM at epoch+1 under the target set from their own stop-time
            state; the removed node GCs its row and drops out;
          phase 3 (post, driver): an RCJoinTask drives every target member
            to host the new epoch (survivors ack immediately, joiners
            blank-create and heal via state transfer), then RC_NODE_DONE
            commits the new set."""
        nxt = self.rc_app.rc_next
        fin = self._rc_final
        if nxt is None and fin is None:
            return
        mgr = self.rc_manager
        cur = mgr.current_epoch(RC_GROUP)
        if nxt is None:
            self._rc_final = None  # transition committed: scratch done
            return
        target = [int(x) for x in nxt["target"]]
        members = sorted(mgr.get_replica_group(RC_GROUP) or [])
        if fin is None and cur is not None and members != target \
                and self.my_id in members and mgr.is_stopped(RC_GROUP):
            # a restart between the stop execution and the epoch switch
            # lost the in-memory stop-time capture — and a stuck LIVE
            # first-sorted survivor wedges the whole transition (phase-3
            # drivers defer to it forever).  Within an epoch the member
            # set is immutable, so the capture is reconstructible from
            # the stopped group itself: its row and member set ARE the
            # stop-time values.
            row = mgr.epoch_row(RC_GROUP, cur)
            if row is not None:
                self._rc_final = fin = {
                    "from_epoch": int(cur), "row": int(row),
                    "old": list(members),
                }
        post = members == target and cur is not None
        if post:
            # phase 3: drive joins, then commit the new set.  The driver
            # pool is the SURVIVOR set (target ∩ stop-time members): a
            # joiner can't drive before it joins (its rc_next is empty),
            # so deferring to a joiner that sorts first — e.g. adding id 0
            # under members [1,2,3] — would deadlock the transition.  A
            # restarted survivor that lost the stop-time capture falls
            # back to the full target: by then a joiner defers only if it
            # completed its join (rc_next restored via state transfer),
            # at which point it CAN drive.
            drivers = (
                sorted(set(target) & set(fin["old"]))
                if fin is not None and set(target) & set(fin["old"])
                else target
            )
            if not self._rc_transition_driver(drivers):
                return
            row = mgr.epoch_row(RC_GROUP, cur)
            key = f"rcjoin:{cur}"

            def commit_done(tgt=target, nid=int(nxt["id"]),
                            knd=nxt["kind"]):
                self.propose_op({
                    "op": RC_NODE_DONE, "target": tgt, "id": nid,
                    "kind": knd,
                })

            self.tasks.spawn_if_not_running(
                key, lambda: RCJoinTask(
                    key, self, cur, target, int(row), on_all=commit_done
                )
            )
            return
        if fin is not None and cur == fin["from_epoch"]:
            # phase 2: the stop executed here — switch epochs locally
            new_epoch = cur + 1
            new_row = self._rc_row(new_epoch, avoid={int(fin["row"])})
            if self.my_id in target:
                # my stop-time app state IS the final state (RSM
                # invariant); my dedup entries are already in my cache
                state = mgr.app.checkpoint(RC_GROUP)
                if new_row is None:
                    # one-row engine: the old row must free first
                    mgr.kill_epoch(RC_GROUP, cur)
                    new_row = int(fin["row"])
                    mgr.create_paxos_instance(
                        RC_GROUP, target, initial_state=state,
                        version=new_epoch, row=new_row, pending=False,
                    )
                else:
                    mgr.create_paxos_instance(
                        RC_GROUP, target, initial_state=state,
                        version=new_epoch, row=new_row, pending=False,
                    )
                    mgr.kill_epoch(RC_GROUP, cur)
            else:
                # removed from the control plane: GC and step aside (still
                # forwards client traffic via the refreshed ring)
                mgr.kill_epoch(RC_GROUP, cur)
            self._refresh_rings()
            return
        if cur is not None and self.my_id in members \
                and not mgr.is_stopped(RC_GROUP):
            # phase 1: stop not yet decided — the driver (re-)proposes it
            if self._rc_transition_driver(
                sorted(set(members) & set(target)) or members
            ):
                mgr.propose(
                    RC_GROUP, json.dumps({"__stop__": int(cur)}), stop=True,
                    request_id=stop_request_id(RC_GROUP, int(cur)),
                )

    def _handle_rc_join(self, body: Dict) -> None:
        """A transition driver asks this node to host the record RSM's new
        epoch.  Survivors already host it (ack); a joiner blank-creates at
        the carried row and heals app state + dedup through the manager's
        state transfer (the same machinery as an AR blank join)."""
        epoch, row = int(body["epoch"]), int(body["row"])
        target = [int(m) for m in body["members"]]
        mgr = self.rc_manager
        cur = mgr.current_epoch(RC_GROUP)
        if cur is None or cur < epoch:
            if cur is not None:
                cur_members = mgr.get_replica_group(RC_GROUP) or []
                if self.my_id in cur_members:
                    if not mgr.is_stopped(RC_GROUP):
                        # live member lagging the stop: my own stop
                        # execution advances me; the join retransmit
                        # finds me hosting the epoch afterwards
                        return
                    # stopped but scratch lost (restart): fall through —
                    # resume_group's epoch-upgrade path re-maps the name
                else:
                    # frozen non-member leftover of the old ring: it holds
                    # no obligations (it never voted) — free the row
                    mgr.kill(RC_GROUP)
            try:
                ok = mgr.resume_group(
                    RC_GROUP, epoch, target, row, pending=False
                )
            except RuntimeError:
                return  # row occupied locally; retransmit retries after GC
            if not ok:
                return
            if cur is not None:
                # the resume's epoch-upgrade demoted my stopped old row
                # into old_epochs — GC it (phase 2 does the same for the
                # in-memory path; leaking it would collide with a later
                # transition's deterministic row and wedge that join)
                mgr.kill_epoch(RC_GROUP, cur)
            self._refresh_rings()
        if (mgr.current_epoch(RC_GROUP) or -1) >= epoch:
            self.send(tuple(body["rc"]), "ack_rc_join", {
                "epoch": epoch, "from": self.my_id,
            })

    def _refresh_ar_ring(self) -> None:
        live = (self.rc_app.ar_nodes if self.rc_app.ar_nodes is not None
                else self._boot_actives)
        new_ids = set(int(a) for a in live)
        for gone in self.ar_ids - new_ids:
            # a removed active's stale load/RTT must not bias placement
            self.placement.forget(gone)
        self.ar_ids = new_ids
        self.ar_ring = ConsistentHashing(sorted(self.ar_ids))

    def _rc_set(self) -> List[int]:
        """The effective reconfigurator set.  During a transition whose
        stop point has passed (rc_next armed), ownership belongs to the
        TARGET set: the rings of nodes that learned the target via the
        stop / a join / a checkpoint adoption must agree, and a node that
        only ever sees the post-transition state (a fresh joiner restoring
        mid-transition) has nothing else to go by."""
        if self.rc_app.rc_next is not None:
            return [int(x) for x in self.rc_app.rc_next["target"]]
        if self.rc_app.rc_nodes is not None:
            return [int(x) for x in self.rc_app.rc_nodes]
        return list(self._boot_rcs)

    def _refresh_rings(self) -> None:
        self._refresh_ar_ring()
        self.rc_ring = ConsistentHashing(self._rc_set())

    def _rehome_set(self, name: str, actives: List[int]) -> List[int]:
        """Replacement set after membership loss: keep surviving members,
        fill from the refreshed ring (capped by availability)."""
        keep = [a for a in actives if a in self.ar_ids]
        want = min(len(actives), len(self.ar_ids))
        for cand in self.ar_ring.get_replicated_servers(
            name, min(want, len(self.ar_ids))
        ):
            if len(keep) >= want:
                break
            # belt: the ring rebuild and ar_ids update are two steps — a
            # torn read must never re-admit a removed node
            if cand not in keep and cand in self.ar_ids:
                keep.append(cand)
        return keep

    # ---- demand (handleDemandReport, Reconfigurator.java:311) ----------
    def _handle_demand_report(self, body: Dict) -> None:
        name = body["name"]
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)), "demand_report", body)
            return
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted:
            self.demand.pop(name)
            self.placement.note_name_gone(name)
            return
        # the report's load summary feeds the placement plane even when
        # no migration follows (every active's rate/names view matters)
        self.placement.note_report(body)
        prof = self.demand.combine(name, body)
        if rec.state is not RCState.READY:
            return
        target = prof.reconfigure(list(rec.actives), sorted(self.ar_ids))
        if not target:
            # the locality profile declined: the placement policy may
            # still spread a hot name onto less-loaded actives
            # (ProximateBalance — locality first, balance second)
            target = self.placement.rebalance(
                name, prof, list(rec.actives), sorted(self.ar_ids)
            )
        if not target or sorted(target) == sorted(rec.actives) or \
                self._bad_actives(target):
            return
        prof.just_reconfigured()
        self.propose_op({
            "op": RECONFIGURE_INTENT, "name": name,
            "new_actives": list(target),
            "new_row": row_for(name, rec.epoch + 1, 0, self.n_groups),
        })

    def send_committed_resume(
        self, dst_ar: int, name: str, epoch: int, actives: List[int],
        row: int, initial_state: Optional[str] = None,
    ) -> None:
        """The uniform missing-member heal (shared by the epoch-commit
        NACK branch and the pause probe): a committed RESUME start — a
        losing pending row re-homes with its held queue, a pause record
        restores, and a member with no state joins empty and heals via
        state transfer."""
        self.send(("AR", dst_ar), "start_epoch", {
            "name": name, "epoch": epoch,
            "actives": list(actives), "row": row,
            "initial_state": initial_state if epoch == 0 else None,
            "prev_actives": [], "prev_epoch": -1,
            "resume": True, "committed": True,
            "rc": ["RC", self.my_id],
        })

    def _handle_epoch_probe(self, body: Dict) -> None:
        """THE stranded-member heal protocol: a member asks where
        (name, epoch) really lives.  One handler for every stranded form
        the chaos soak has produced — a held pause record after an
        aborted pause round (no ``row``: a frozen ballot coordinator
        wedges its whole group, and nothing else heals it because it
        still answers pings and stays in the member mask), or a row
        stuck behind the pre-COMPLETE admission gate after its
        late-start retransmits expired (``row``: a member stranded at a
        LOSING probe row refuses every proposal forever, and the commit
        round that would heal it already completed on the others).

        Answers: an epoch_commit re-send when the prober's row IS the
        winning one (only its confirm was lost); a committed resume
        (rejoin in place / re-home to the winning row); epoch_gone when
        the probed epoch is deleted or superseded (GC whatever the
        prober holds); or silence while another round owns the record —
        the mirror of the reference's one sync protocol for stragglers
        (``PaxosInstanceStateMachine.java:2161-2340``), applied to the
        control plane."""
        name, epoch = body["name"], int(body["epoch"])
        row = body.get("row")
        frm = int(body["from"])
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)), "epoch_probe", body)
            return
        gone = {"name": name, "epoch": epoch}
        if row is not None:
            gone["row"] = int(row)
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted or rec.epoch > epoch:
            self.send(("AR", frm), "epoch_gone", gone)
            return
        if rec.epoch != epoch:
            return  # prober lags the record; other machinery owns it
        if rec.state not in (RCState.READY, RCState.WAIT_ACK_STOP):
            # PAUSED/WAIT_PAUSE: holding a pause record is right.
            # WAIT_ACK_START/reactivation: the row is still a PROBE — a
            # committed resume there would bypass the pending gate and
            # wedge the row-collision machinery.  WAIT_DELETE: deletion
            # owns it.  READY and WAIT_ACK_STOP both have a SETTLED
            # committed row, and the stranded member is needed live
            # (under WAIT_ACK_STOP the stop round cannot commit without
            # it — the original wedge shape this probe exists for).
            return
        if frm not in rec.actives or rec.row < 0:
            # the live epoch moved on without this member; its local
            # leftovers are superseded by the epoch state transfer
            self.send(("AR", frm), "epoch_gone", gone)
            return
        if row is not None and rec.row == int(row):
            # the member holds the WINNING row; only its confirm was lost
            self.send(("AR", frm), "epoch_commit", {
                "name": name, "epoch": epoch, "row": rec.row,
                "actives": sorted(rec.actives),
                "rc": ["RC", self.my_id],
            })
        else:
            # stranded member of a live epoch: rejoin at the winning row
            self.send_committed_resume(
                frm, name, rec.epoch, rec.actives, rec.row,
                rec.initial_state,
            )

    # ---- residency (suggest_pause / reactivate) ------------------------
    def _handle_suggest_pause(self, body: Dict) -> None:
        name = body["name"]
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)), "suggest_pause", body)
            return
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted or rec.state is not RCState.READY:
            return
        if int(body.get("epoch", -1)) != rec.epoch:
            return  # stale suggestion from a lagging active
        self.propose_op({"op": PAUSE_INTENT, "name": name})

    def kick_reactivate(self, name: str) -> None:
        """Touch of a paused name: drive PAUSED/WAIT_PAUSE -> resume round
        (forwarded to the record's primary)."""
        if not self.is_primary(name):
            self.send(("RC", self.primary_of(name)),
                      "reactivate_service", {"name": name})
            return
        rec = self.rc_app.get_record(name)
        if rec is None or rec.deleted or \
                rec.state not in (RCState.PAUSED, RCState.WAIT_PAUSE):
            return
        live = [a for a in rec.actives if a in self.ar_ids]
        if not live:
            # every member that holds this group's journal left the
            # cluster: resuming on fresh nodes would silently reset the
            # RSM to empty.  Stay paused — re-admitting any old member
            # makes the next touch succeed (the AR_REMOVE guard makes
            # this state unreachable except via direct record surgery).
            return
        self.propose_op({
            "op": REACTIVATE, "name": name,
            "new_row": row_for(name, rec.epoch, 0, self.n_groups),
            # resume only on members still in the cluster (the READY
            # re-home scan grows the set back afterwards if short)
            "actives": live,
        })

    def _bad_actives(self, actives) -> bool:
        return not actives or any(int(a) not in self.ar_ids for a in actives)

    def _reply(self, body: Dict, kind: str, name: str, **fields) -> None:
        client = body.get("client")
        if client is not None:
            self.send(tuple(client), kind, {"name": name, **fields})

    # ------------------------------------------------------------------
    # record re-drive: an expired task (long partition) must not strand a
    # record mid-transition — the owner periodically respawns the pending
    # step (CommitWorker re-propose + WaitPrimaryExecution retry analog)
    # ------------------------------------------------------------------
    def _redrive_records(self) -> None:
        for name, rec in list(self.rc_app.records.items()):
            if rec.deleted or not self.is_primary(name):
                continue
            if rec.state is RCState.READY:
                lost = [a for a in rec.actives if a not in self.ar_ids]
                if lost:
                    # a member left the cluster: migrate the group off it
                    # (ring-refresh re-homing, Reconfigurator.java:1075)
                    target = self._rehome_set(name, rec.actives)
                    if target and sorted(target) != sorted(rec.actives):
                        self.propose_op({
                            "op": RECONFIGURE_INTENT, "name": name,
                            "new_actives": target,
                            "new_row": row_for(
                                name, rec.epoch + 1, 0, self.n_groups
                            ),
                        })
                        continue
                done_t = self._commit_done.get(
                    (name, rec.epoch, rec.row)
                )
                if done_t is None or (
                    time.monotonic() - done_t > self.ready_audit_period_s
                ):
                    ckey = f"commit:{name}:{rec.epoch}:{rec.row}"
                    self.tasks.spawn_if_not_running(
                        ckey,
                        lambda k=ckey, n=name, r=rec: EpochCommitTask(
                            k, self, n, r.epoch, r.actives, r.row,
                            initial_state=r.initial_state,
                        ),
                    )
                if rec.pending_drop_epoch is not None and \
                        not self.tasks.is_running(
                            f"latestart:{name}:{rec.epoch}"):
                    # previous epoch's GC owed (survives RC restarts via
                    # the record); deferred while a late-start still needs
                    # its final-state donors
                    pde = int(rec.pending_drop_epoch)
                    dkey = f"drop:{name}:{pde}"
                    self.tasks.spawn_if_not_running(
                        dkey,
                        lambda k=dkey, n=name, e=pde,
                        a=list(rec.pending_drop_actives): DropEpochTask(
                            k, self, n, e, a,
                            on_done=lambda n=n, e=e: self.propose_op(
                                {"op": DROP_DONE, "name": n, "epoch": e}
                            ),
                            fire_done_on_expire=False,
                        ),
                    )
            elif rec.state is RCState.WAIT_ACK_STOP:
                self.tasks.spawn_if_not_running(
                    f"stop:{name}",
                    lambda n=name, r=rec: StopEpochTask(
                        f"stop:{n}", self, n, r.epoch, r.actives,
                        on_stopped=lambda: self.propose_op(
                            {"op": STOP_DONE, "name": n}
                        ),
                        row=r.row,
                    ),
                )
            elif rec.state is RCState.WAIT_PAUSE:
                # target only members still in the cluster: a removed node
                # can never ack and would wedge the all-ack round forever
                live = [a for a in rec.actives if a in self.ar_ids]
                if not live:
                    continue
                self.tasks.spawn_if_not_running(
                    f"pause:{name}",
                    lambda n=name, r=rec, lv=live: PauseEpochTask(
                        f"pause:{n}", self, n, r.epoch, lv
                    ),
                )
            elif rec.state is RCState.WAIT_ACK_START:
                if rec.resuming:  # reactivation at a fresh row, same epoch
                    op = {"name": name, "epoch": rec.epoch,
                          "actives": rec.new_actives, "resume": True}
                elif rec.actives:  # reconfiguration e -> e+1
                    op = {"name": name, "epoch": rec.epoch + 1,
                          "actives": rec.new_actives,
                          "prev_actives": rec.actives,
                          "prev_epoch": rec.epoch}
                else:            # initial create
                    op = {"name": name, "epoch": rec.epoch,
                          "actives": rec.new_actives,
                          "initial_state": rec.initial_state}
                # resume the row probe where the expired task left off —
                # restarting at attempt 0 would re-collide forever against
                # members already past it
                op["attempt"] = self._last_attempt.get(name, 0)
                skey = f"start:{name}:{op['epoch']}"
                self.tasks.spawn_if_not_running(
                    skey,
                    lambda k=skey, o=op: StartEpochTask(k, self, o),
                )
            elif rec.state is RCState.WAIT_DELETE:
                if self.tasks.is_running(f"stop:{name}") or \
                        self.tasks.is_running(f"drop:{name}:{rec.epoch}"):
                    continue
                epoch, actives = rec.epoch, list(rec.actives)

                def after_drop(n=name):
                    self.propose_op({"op": DELETE_FINAL, "name": n})

                def after_stop(n=name, e=epoch, a=actives):
                    self.tasks.spawn_if_not_running(
                        f"drop:{n}:{e}",
                        lambda: DropEpochTask(
                            f"drop:{n}:{e}", self, n, e, a, on_done=after_drop
                        ),
                    )

                self.tasks.spawn_if_not_running(
                    f"stop:{name}",
                    lambda n=name, e=epoch, a=actives, rw=rec.row:
                    StopEpochTask(
                        f"stop:{n}", self, n, e, a, on_stopped=after_stop,
                        row=rw,
                    ),
                )
        # confirmed-commit entries for purged records / superseded
        # epochs / moved rows
        live = {
            (n, r.epoch, r.row) for n, r in self.rc_app.records.items()
        }
        self._commit_done = {
            k: t for k, t in self._commit_done.items() if k in live
        }

    # ------------------------------------------------------------------
    # RC-record commit callbacks (CommitWorker execution path)
    # ------------------------------------------------------------------
    def _on_applied(self, op: Dict) -> None:
        """Fires on EVERY reconfigurator when an RC-record op executes;
        only the record's primary drives the next protocol step."""
        if self.tracer.enabled and op.get("name"):
            self.tracer.note(
                f"epoch:{op['name']}", f"rc-applied:{op.get('op')}",
                name=str(op["name"]), node=self.my_id,
                applied=bool(op.get("applied")), epoch=op.get("epoch"),
            )
        if op["op"] in (AR_ADD, AR_REMOVE):
            # membership ops affect every RC: refresh the ring, answer the
            # client wherever it registered; affected names migrate off a
            # removed node via the READY re-drive scan
            if op.get("applied"):
                self._refresh_ar_ring()
            kind = "add_active" if op["op"] == AR_ADD else "remove_active"
            clients = self._pending_clients.pop(
                f"#m:{kind}:{int(op['id'])}", None
            )
            for client in clients or []:
                self.send(tuple(client), f"{kind}_ack", {
                    "id": int(op["id"]), "name": str(op["id"]),
                    "ok": bool(op.get("applied")),
                    "actives": sorted(self.ar_ids),
                })
            return
        if op["op"] in (RC_ADD_NODE, RC_REMOVE_NODE):
            if not op.get("applied"):
                # refused: another transition in flight, or removing the
                # last reconfigurator
                self._ack_rc_membership(op, ok=False, reason="refused")
            elif op.get("noop"):
                self._ack_rc_membership(op, ok=True)
            # applied + armed: _advance_rc_transition drives the epochs;
            # the client is answered when RC_NODE_DONE commits
            return
        if op["op"] == RC_NODE_DONE:
            if op.get("applied"):
                self._refresh_rings()
                self._rc_final = None
                self._ack_rc_membership(
                    {"op": op.get("kind", RC_ADD_NODE), "id": op["id"]},
                    ok=True,
                )
            return
        name = op["name"]
        if not op.get("applied") or not self.is_primary(name):
            return
        rec = self.rc_app.get_record(name)
        kind = op["op"]
        if kind == CREATE_INTENT:
            skey = f"start:{name}:{int(op.get('epoch', 0))}"
            self.tasks.spawn_if_not_running(
                skey,
                lambda: StartEpochTask(skey, self, {
                    "name": name, "epoch": op.get("epoch", 0),
                    "actives": op["actives"],
                    "initial_state": op.get("initial_state"),
                }),
            )
        elif kind == RECONFIGURE_INTENT:
            assert rec is not None
            self.tasks.spawn_if_not_running(
                f"stop:{name}",
                lambda: StopEpochTask(
                    f"stop:{name}", self, name, rec.epoch, rec.actives,
                    on_stopped=lambda: self.propose_op(
                        {"op": STOP_DONE, "name": name}
                    ),
                    row=rec.row,
                ),
            )
        elif kind == STOP_DONE:
            assert rec is not None
            skey = f"start:{name}:{rec.epoch + 1}"
            self.tasks.spawn_if_not_running(
                skey,
                lambda: StartEpochTask(skey, self, {
                    "name": name, "epoch": rec.epoch + 1,
                    "actives": rec.new_actives,
                    "prev_actives": rec.actives,
                    "prev_epoch": rec.epoch,
                }),
            )
        elif kind == COMPLETE:
            assert rec is not None
            was_create = not op.get("prev_actives")
            client = self._pending_clients.pop(name, None)
            if client is not None:
                self.send(tuple(client),
                          "create_ack" if was_create else "reconfigure_ack",
                          {"name": name, "ok": True, "actives": rec.actives,
                           "epoch": rec.epoch})
            self._note_batch_done(
                name, ok=True, actives=rec.actives, epoch=rec.epoch
            )
            self._last_attempt.pop(name, None)  # probe settled
            # lift the pre-COMPLETE admission gate on every new active
            ckey = f"commit:{name}:{rec.epoch}:{rec.row}"
            self.tasks.spawn_if_not_running(
                ckey, lambda: EpochCommitTask(
                    ckey, self, name, rec.epoch, rec.actives, rec.row,
                    initial_state=rec.initial_state,
                )
            )
            laggards = [a for a in rec.actives
                        if a not in (op.get("acked") or rec.actives)]

            def spawn_prev_drop():
                if was_create:
                    return
                # GC the previous epoch on its old actives — only after
                # every laggard fetched its final state (or gave up):
                # dropping purges the final-state donors.  Completion is
                # committed as DROP_DONE so a restarted RC knows whether
                # the round finished; expiry leaves the record's
                # pending_drop set and the READY re-drive respawns it.
                prev_actives = list(op.get("prev_actives") or [])
                prev_epoch = int(op.get("prev_epoch", rec.epoch - 1))
                self.tasks.spawn_if_not_running(
                    f"drop:{name}:{prev_epoch}",
                    lambda: DropEpochTask(
                        f"drop:{name}:{prev_epoch}", self, name, prev_epoch,
                        prev_actives,
                        on_done=lambda: self.propose_op(
                            {"op": DROP_DONE, "name": name,
                             "epoch": prev_epoch}
                        ),
                        fire_done_on_expire=False,
                    ),
                )

            if laggards:
                key = f"latestart:{name}:{rec.epoch}"
                body = {
                    "name": name, "epoch": rec.epoch, "actives": rec.actives,
                    "row": rec.row, "attempt": int(op.get("attempt", 0)),
                    "initial_state": rec.initial_state if was_create else None,
                    "prev_actives": op.get("prev_actives") or [],
                    "prev_epoch": int(op.get("prev_epoch", -1)),
                    "resume": bool(op.get("resume")),
                    "rc": ["RC", self.my_id],
                    "committed": True,
                }
                self.tasks.spawn_if_not_running(
                    key, lambda: LateStartTask(
                        key, self, body, laggards,
                        on_finished=spawn_prev_drop,
                    )
                )
            else:
                spawn_prev_drop()
        elif kind == PAUSE_INTENT:
            assert rec is not None
            live = [a for a in rec.actives if a in self.ar_ids]
            if live:
                self.tasks.spawn_if_not_running(
                    f"pause:{name}",
                    lambda lv=live: PauseEpochTask(
                        f"pause:{name}", self, name, rec.epoch, lv
                    ),
                )
        elif kind == REACTIVATE:
            assert rec is not None
            skey = f"start:{name}:{rec.epoch}"
            self.tasks.spawn_if_not_running(
                skey,
                lambda: StartEpochTask(skey, self, {
                    "name": name, "epoch": rec.epoch,
                    "actives": rec.new_actives, "resume": True,
                    "attempt": self._last_attempt.get(name, 0),
                }),
            )
        elif kind == DELETE_INTENT:
            assert rec is not None
            # stop the live epoch, then drop it everywhere, then purge the
            # record (two-phase delete; the final-state age-out of the
            # reference is subsumed by the explicit drop round)
            epoch, actives = rec.epoch, list(rec.actives)

            def after_drop():
                self.propose_op({"op": DELETE_FINAL, "name": name})

            def after_stop():
                self.tasks.spawn_if_not_running(
                    f"drop:{name}:{epoch}",
                    lambda: DropEpochTask(
                        f"drop:{name}:{epoch}", self, name, epoch, actives,
                        on_done=after_drop,
                    ),
                )

            self.tasks.spawn_if_not_running(
                f"stop:{name}",
                lambda: StopEpochTask(
                    f"stop:{name}", self, name, epoch, actives,
                    on_stopped=after_stop, row=rec.row,
                ),
            )
        elif kind == DELETE_FINAL:
            self.placement.note_name_gone(name)
            client = self._pending_clients.pop(name, None)
            if client is not None:
                self.send(tuple(client), "delete_ack",
                          {"name": name, "ok": True})
