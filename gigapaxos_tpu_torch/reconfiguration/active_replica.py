"""ActiveReplica: executes epoch operations against the app's coordinator.

API-parity target: ``ActiveReplica`` (``ActiveReplica.java:128``) —
demultiplexes reconfiguration packets vs app requests and executes epoch
ops: ``handleStartEpoch``:796 (create the new epoch's group, fetching the
previous epoch's final state if any), ``handleStopEpoch``:917 (coordinate
an epoch-final stop through the group), ``handleDropEpochFinalState``:968
(GC the old epoch), ``handleRequestEpochFinalState``:1051 (serve a stored
final state to a new-epoch replica).

Messaging is transport-agnostic: a ``send(dst, kind, body)`` callable is
injected (dst = ("AR"|"RC", id)); the epoch-final-state fetch runs as a
:class:`WaitEpochFinalState` protocol task (``WaitEpochFinalState.java``
analog), retransmitting round-robin over the previous epoch's actives.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# module level, not only in __init__: _maybe_sweep reads them too (the
# JAX package imports them in __init__ alone, so its pause sweep raises
# NameError once a deactivation period has passed)
from ..paxos_config import PC
from ..protocoltask import ProtocolExecutor, ProtocolTask
from ..utils.config import Config
from .coordinator import AbstractReplicaCoordinator

Addr = Tuple[str, int]  # ("AR"|"RC", node id)


def stop_request_id(name: str, epoch: int) -> int:
    """Deterministic id for the epoch-final stop request: every active may
    propose it, the response cache dedupes execution to exactly once.
    64-bit keyed hash with a reserved high bit — the id lives in the
    manager-global request-id namespace, where a 32-bit hash would hit
    birthday collisions at the ~1M-group design scale (a cross-name
    collision answers one name's stop from another's cached response)."""
    h = int.from_bytes(
        hashlib.blake2b(
            f"__stop__:{name}:{epoch}".encode(), digest_size=8
        ).digest(), "big",
    )
    return (1 << 62) | (h & ((1 << 62) - 1))


class WaitEpochFinalState(ProtocolTask):
    """Fetch the previous epoch's final state from its actives, then create
    the new epoch's group (``WaitEpochFinalState.java`` analog)."""

    restart_period_s = 1.0
    max_lifetime_s = 30.0

    def __init__(self, key: str, ar: "ActiveReplica", body: Dict):
        super().__init__(key)
        self.ar = ar
        self.body = body  # the start_epoch body this fetch serves
        self._rr = 0      # round-robin cursor over prev actives

    def start(self):
        prev = [a for a in self.body["prev_actives"]]
        if not prev:
            self.done = True
            return ()
        dst = prev[self._rr % len(prev)]
        self._rr += 1
        return [(("AR", dst), "request_epoch_final_state", {
            "name": self.body["name"],
            "epoch": self.body["prev_epoch"],
            "from": self.ar.my_id,
        })]

    def handle_event(self, kind: str, body: Dict):
        if kind != "epoch_final_state":
            return ()
        self.done = True
        # the dedup snapshot travels WITH the state into the create, and
        # installs only if the create adopts the state (install/execute
        # pairing).  Installing it up-front here was the seed-662625602
        # exactly-once breach: a create that failed (collision/not-ready)
        # or no-opped (idempotent re-create over a blank join) left the
        # entries behind, and the member skip-executed decisions its app
        # state did not contain
        return self.ar._finish_start_epoch(
            self.body, body.get("state"), body.get("dedup")
        )


class ActiveReplica:
    def __init__(
        self,
        my_id: int,
        coordinator: AbstractReplicaCoordinator,
        send: Callable[[Addr, str, Dict], None],
        rc_ids: Optional[List[int]] = None,
    ):
        self.my_id = int(my_id)
        self.coordinator = coordinator
        self.send = send
        # reconfigurator ids for Deactivator pause suggestions (any RC
        # forwards to the name's primary); empty = no sweeps from here
        self.rc_ids = list(rc_ids or [])
        self._last_sweep = time.time()
        # flag snapshots — tick runs every ~10ms and must not contend on
        # the global Config lock
        from ..paxos_config import PC
        from ..utils.config import Config

        self.pause_option = Config.get_bool(PC.PAUSE_OPTION)
        self.deactivation_period_s = Config.get_float(PC.DEACTIVATION_PERIOD_S)
        # probe backoff: (name, epoch) for pause records, or
        # ("pending", name, epoch, row) -> (next probe time, interval)
        self._probe_backoff: Dict[Tuple, Tuple[float, float]] = {}
        from .rc_config import RC

        self.demand_report_period_s = Config.get_float(
            RC.DEMAND_REPORT_PERIOD_S
        )
        self.demand_report_every = Config.get_int(RC.DEMAND_REPORT_EVERY)
        # retention cap for served epoch-final states (MAX_FINAL_STATE_AGE
        # 3600s, ReconfigurationConfig analog): the explicit drop rounds
        # GC them normally — this ages out snapshots whose drop never
        # arrived (e.g. the RC died mid-reconfiguration)
        self.max_final_state_age_s = Config.get_float(
            RC.MAX_FINAL_STATE_AGE_S
        )
        self._last_demand_flush = time.time()
        # load summary for the placement plane: EWMA of this node's
        # request rate, updated at each demand flush and decayed between
        # them (an idle node must read ~0, not its last busy number)
        self._load_rps = 0.0
        self.tasks = ProtocolExecutor(
            send=lambda m: self.send(m[0], m[1], m[2])
        )
        # (name, epoch) -> final app state captured when the stop executed
        # (LargeCheckpointer / getEpochFinalCheckpointState analog)
        # (name, epoch) -> {"state": app checkpoint, "dedup": stop-time
        # exactly-once snapshot} captured when the epoch-final stop ran
        self.final_states: Dict[Tuple[str, int], Dict] = {}
        # stop acks owed once the local stop executes: (name, epoch) -> [rc]
        self._pending_stop_acks: Dict[Tuple[str, int], List[Addr]] = {}
        # hook the coordinator's stop-execution signal (fires on execution
        # AND on a checkpoint jump that lands past the stop)
        coordinator.set_stop_callback(self._on_stop_executed)

    # ------------------------------------------------------------------
    # epoch-op handlers (dispatch table)
    # ------------------------------------------------------------------
    def handle_message(self, kind: str, body: Dict, frm: Optional[Addr] = None) -> None:
        if kind == "start_epoch":
            self._handle_start_epoch(body)
        elif kind == "stop_epoch":
            self._handle_stop_epoch(body)
        elif kind == "drop_epoch":
            self._handle_drop_epoch(body)
        elif kind == "request_epoch_final_state":
            self._handle_request_final_state(body)
        elif kind == "epoch_final_state":
            self.tasks.handle_event(
                f"wefs:{body['name']}:{body['epoch']}", kind, body
            )
        elif kind == "epoch_commit":
            self._handle_epoch_commit(body)
        elif kind == "pause_epoch":
            self._handle_pause_epoch(body)
        elif kind == "echo":
            # active orientation (EchoRequest analog, Reconfigurator.
            # java:2420): bounce the prober's timestamp back so it can
            # measure RTT, and ride this node's load summary along so one
            # probe round gives the placement plane both signals
            self.send(tuple(body["rc"]), "echo_reply", {
                "from": self.my_id, "ts": body.get("ts"),
                **self.load_summary(),
            })
        elif kind == "epoch_gone":
            # RC's answer to an epoch_probe: the probed (name, epoch) is
            # obsolete — GC whichever stranded form this member holds (a
            # pause record, a row stuck behind the admission gate, or a
            # live STOPPED row whose drop round this member missed)
            if body.get("row") is not None:
                self.coordinator.drop_pending_row(
                    body["name"], int(body["epoch"]), int(body["row"])
                )
            else:
                name, epoch = body["name"], int(body["epoch"])
                self.coordinator.drop_pause_record(name, epoch)
                if self.coordinator.current_epoch(name) == epoch and \
                        self.coordinator.is_stopped(name):
                    # safe: only a STOPPED row dies (never a live group),
                    # and only after the RC confirmed the epoch is gone
                    self.coordinator.delete_replica_group(name, epoch)
                    self.final_states.pop((name, epoch), None)

    def tick(self, now: Optional[float] = None) -> None:
        self.tasks.tick(now)
        self._maybe_sweep(now)
        self._maybe_report_demand(now)
        # age out final-state snapshots whose drop round never arrived
        if self.final_states:
            cut = (now or time.time()) - self.max_final_state_age_s
            for k in [k for k, s in self.final_states.items()
                      if s.get("t", 0) < cut]:
                del self.final_states[k]

    # ---- demand reporting (updateDemandStats -> DemandReport,
    # ActiveReplica demand hooks / DemandReport.java) --------------------
    def current_rps(self, now: Optional[float] = None) -> float:
        """This node's request-rate estimate, decayed by idle time since
        the last demand flush (served to echo probes and demand reports
        as the placement plane's load signal)."""
        now = time.time() if now is None else now
        idle = max(0.0, now - self._last_demand_flush)
        if idle <= 2 * self.demand_report_period_s:
            return self._load_rps
        return self._load_rps * 0.5 ** (idle / self.demand_report_period_s)

    def load_summary(self) -> Dict:
        """THE load payload — every surface that reports this node's
        load (epoch-plane echo replies, client-plane echo replies via
        the server hook, demand-report ride-alongs) uses this one shape
        so the signals cannot drift apart."""
        return {
            "names": self.coordinator.hosted_names_count(),
            "rps": round(self.current_rps(), 3),
        }

    def _maybe_report_demand(self, now: Optional[float] = None) -> None:
        if not self.rc_ids:
            return
        now = time.time() if now is None else now
        # flush on period OR when the unreported backlog crosses the count
        # threshold (a hot name must not wait out the period)
        if now - self._last_demand_flush < self.demand_report_period_s and \
                self.coordinator.demand_backlog() < self.demand_report_every:
            return
        drained = self.coordinator.drain_demand()
        dt = max(1e-3, now - self._last_demand_flush)
        self._last_demand_flush = now
        inst = sum(c for c, _e in drained.values()) / dt
        self._load_rps = 0.7 * self._load_rps + 0.3 * inst
        # the load summary rides every report: the record's primary RC
        # aggregates {names hosted, request rate} per active for the
        # placement policies (ProximateBalance's load-balance signal)
        load = self.load_summary()
        for name, (count, epoch) in drained.items():
            self.send(("RC", self.rc_ids[hash(name) % len(self.rc_ids)]),
                      "demand_report", {
                          "name": name, "epoch": epoch,
                          "count": count, "from": self.my_id,
                          "load": load,
                      })

    # ---- Deactivator sweep (PaxosManager.java:2931,2786) ---------------
    def _maybe_sweep(self, now: Optional[float] = None) -> None:
        if not self.rc_ids:
            return
        now = time.time() if now is None else now
        period = self.deactivation_period_s
        if now - self._last_sweep < period:
            return
        self._last_sweep = now
        # ONE probe protocol for every stranded-epoch form (chaos finds,
        # unified): a held pause record after an aborted pause round
        # (row=None), or a row stuck behind the pre-COMPLETE admission
        # gate after its late-start retransmits expired (row=int).  Both
        # ask the RC "where does (name, epoch) really live?"; the RC
        # answers with a committed resume / an epoch_commit re-send /
        # epoch_gone / silence (holding is right).
        # NOT gated by pause_option: records can predate a config change,
        # and healing them is unrelated to whether we SUGGEST new pauses.
        # Per-key EXPONENTIAL BACKOFF (up to 16 periods): long-paused
        # groups are the normal steady state at residency scale, and
        # re-asking about each of them every period would cost
        # O(paused * members) control traffic forever.
        probes = [
            (n, int(e), None) for n, e in self.coordinator.pause_record_keys()
        ] + [
            (n, int(e), int(r))
            for n, e, r in self.coordinator.pending_row_keys()
        ] + [
            # live STOPPED current rows: awaiting a transition a race can
            # lose (a drop acked while this member was paused)
            (n, int(e), None)
            for n, e in self.coordinator.stopped_row_keys()
        ]
        live = set(probes)
        for k in [k for k in self._probe_backoff if k not in live]:
            del self._probe_backoff[k]
        for key in probes:
            ent = self._probe_backoff.get(key)
            if ent is not None and ent[0] > now:
                continue
            interval = min((ent[1] * 2) if ent else period, period * 16)
            self._probe_backoff[key] = (now + interval, interval)
            name, epoch, row = key
            body = {"name": name, "epoch": epoch, "from": self.my_id}
            if row is not None:
                body["row"] = row
            self.send(("RC", self.rc_ids[hash(name) % len(self.rc_ids)]),
                      "epoch_probe", body)
        if not self.pause_option:
            return
        # admission-aware eviction order (group-heat telemetry): the
        # sweep is CAPPED per period (PAUSE_BATCH_SIZE — the reference's
        # batched Deactivator), so ordering decides who sleeps — the
        # coldest names go first, and a name with queued admissions or a
        # recent resume is never suggested ahead of a truly cold one
        for name, epoch in self.coordinator.eviction_candidates(
            period, limit=Config.get_int(PC.PAUSE_BATCH_SIZE)
        ):
            rc = self.rc_ids[hash(name) % len(self.rc_ids)]
            self.send(("RC", rc), "suggest_pause", {
                "name": name, "epoch": epoch, "from": self.my_id,
            })

    # ---- pause (the RC-coordinated row free) ---------------------------
    def _handle_pause_epoch(self, body: Dict) -> None:
        name, epoch = body["name"], int(body["epoch"])
        outcome = self.coordinator.pause_replica_group(name, epoch)
        self.send(tuple(body["rc"]), "ack_pause_epoch", {
            "name": name, "epoch": epoch, "from": self.my_id,
            "ok": outcome in ("ok", "unknown"), "reason": outcome,
        })

    # ---- start (handleStartEpoch, ActiveReplica.java:796) --------------
    def _handle_start_epoch(self, body: Dict) -> None:
        name, epoch = body["name"], int(body["epoch"])
        prev_actives = body.get("prev_actives") or []
        if not prev_actives:
            # fresh create: initial state rides in the packet
            self._ack_start(body, self._create(body, body.get("initial_state")))
            return
        fs_key = (name, int(body["prev_epoch"]))
        if fs_key in self.final_states:
            # I was in the previous epoch and hold the final state locally
            # (my own dedup entries are already in my cache)
            self._ack_start(
                body, self._create(body, self.final_states[fs_key]["state"])
            )
            return
        # fetch the previous epoch's final state from its actives; the task
        # is keyed by the PREVIOUS epoch (what is being fetched)
        key = f"wefs:{name}:{int(body['prev_epoch'])}"
        self.tasks.spawn_if_not_running(
            key, lambda: WaitEpochFinalState(key, self, body)
        )

    def _finish_start_epoch(self, body: Dict, state: Optional[str],
                            dedup: Optional[Dict] = None):
        self._ack_start(body, self._create(body, state, dedup))
        return ()

    def _create(self, body: Dict, state: Optional[str],
                dedup: Optional[Dict] = None) -> str:
        """Returns "ok", "collision" (row occupied -> RC must probe a new
        row) or "not-ready" (transient local refusal, e.g. the old epoch's
        stop hasn't landed here yet -> RC just retransmits, same row).

        No attempt-staleness guard here: the manager's rules make delayed
        duplicate probes safe — a pending, never-executed row may be
        recreated at a new row (the live probe's retransmit wins the last
        word), while a confirmed or executed row refuses the move as a
        collision.  An attempt-number guard would instead livelock a
        restarted RC whose re-driven probe resumes below the recorded
        attempt."""
        try:
            # a start_epoch creates the group PENDING (proposals queue but
            # are not admitted to consensus)
            # until the RC's COMPLETE confirms the row via epoch_commit;
            # a late-start retransmit carries committed=True and creates
            # (or confirms) the group live
            if body.get("resume"):
                # reactivation after pause: restore from the local pause
                # record / re-home a live row — same epoch, fresh row
                ok = self.coordinator.resume_replica_group(
                    body["name"], int(body["epoch"]), list(body["actives"]),
                    int(body["row"]),
                    pending=not body.get("committed", False),
                    initial_state=body.get("initial_state"),
                )
            else:
                ok = self.coordinator.create_replica_group(
                    body["name"], int(body["epoch"]), list(body["actives"]),
                    state, row=int(body["row"]),
                    pending=not body.get("committed", False),
                    dedup=dedup,
                )
            return "ok" if ok else "not-ready"
        except RuntimeError:
            return "collision"

    def _ack_start(self, body: Dict, outcome: str) -> None:
        self.send(tuple(body["rc"]), "ack_start_epoch", {
            "name": body["name"], "epoch": body["epoch"],
            "row": body["row"], "ok": outcome == "ok", "reason": outcome,
            "from": self.my_id,
        })

    # ---- commit (the RC's COMPLETE confirmation of the row) ------------
    def _handle_epoch_commit(self, body: Dict) -> None:
        """Ack ok ONLY when this member truly runs the current epoch at
        the winning row — an ok over a silent no-op would complete the
        commit round with this member still pending / paused / missing,
        and nothing would ever heal it.  The NACK drives the RC's heal
        (a committed RESUME start, which uniformly re-homes a losing
        pending row, restores a pause record, or joins empty)."""
        name, epoch = body["name"], int(body["epoch"])
        cur = self.coordinator.current_epoch(name)
        row = body.get("row")
        if cur is not None and cur > epoch:
            # historic round for a superseded epoch: nothing to confirm
            self.send(tuple(body["rc"]), "ack_epoch_commit", {
                "name": name, "epoch": epoch, "from": self.my_id,
                "ok": True, "row": row,
            })
            return
        hosted_row = self.coordinator.epoch_row_of(name, epoch)
        want_actives = body.get("actives")
        members = self.coordinator.get_replica_group(name)
        members_ok = (
            want_actives is None or members is None
            or sorted(members) == sorted(want_actives)
        )
        if cur == epoch and (row is None or hosted_row == int(row)) \
                and members_ok:
            self.coordinator.commit_replica_group(name, epoch, row)
            self.send(tuple(body["rc"]), "ack_epoch_commit", {
                "name": name, "epoch": epoch, "from": self.my_id,
                "ok": True, "row": row,
            })
            return
        # not running the winning row of this epoch in any live form:
        # missing entirely, paused, stuck at a losing pending row, or
        # never started — all healed by the RC's committed resume
        self.send(tuple(body["rc"]), "ack_epoch_commit", {
            "name": name, "epoch": epoch, "from": self.my_id,
            "ok": False, "reason": "missing", "row": row,
        })

    # ---- stop (handleStopEpoch, ActiveReplica.java:917) ----------------
    def _handle_stop_epoch(self, body: Dict) -> None:
        name, epoch = body["name"], int(body["epoch"])
        # a stop for epoch e implies the record reached READY at e (the RC
        # only reconfigures/deletes READY records) — a lost epoch_commit
        # must not wedge the stop proposal behind the admission gate (the
        # row rides along so a stale losing row is never un-pended)
        self.coordinator.commit_replica_group(name, epoch, body.get("row"))
        rc = tuple(body["rc"])
        if (name, epoch) in self.final_states:
            self._ack_stop(rc, name, epoch)  # already stopped + captured
            return
        cur_epoch = self.coordinator.current_epoch(name)
        if cur_epoch is None or cur_epoch > epoch:
            # unknown here (I never created this epoch) or already moved
            # past it: nothing to stop — ack so the task can make progress
            # (a STALE duplicate must never stop the live e+1 group)
            self._ack_stop(rc, name, epoch)
            return
        if cur_epoch < epoch:
            return  # start_epoch for this epoch hasn't landed yet; retransmit finds us later
        self._pending_stop_acks.setdefault((name, epoch), [])
        if rc not in self._pending_stop_acks[(name, epoch)]:
            self._pending_stop_acks[(name, epoch)].append(rc)
        if self.coordinator.is_stopped(name):
            # stop decided on-device (e.g. proposed by a peer) but the local
            # app hasn't executed it yet — the on_stop_executed hook will
            # fire the ack; don't re-propose
            return
        # propose the epoch-final stop through the group; deterministic
        # request id makes concurrent proposals from every active collapse
        # to one execution (exactly-once via the response cache)
        self.coordinator.coordinate_request(
            name, json.dumps({"__stop__": epoch}), stop=True,
            request_id=stop_request_id(name, epoch),
        )

    def _on_stop_executed(self, name: str, row: int, epoch: int) -> None:
        """Manager hook: fires on EVERY replica when the stop executes.
        The dedup set is SNAPSHOTTED with the final state: entries this
        node adds later (executing in the NEXT epoch) must not ride with
        the previous epoch's state — they describe executions the fetched
        state does not contain."""
        self.final_states[(name, epoch)] = {
            "state": self.coordinator.app.checkpoint(name),
            "dedup": self.coordinator.dedup_for_name(name),
            "t": time.time(),
        }
        for rc in self._pending_stop_acks.pop((name, epoch), []):
            self._ack_stop(rc, name, epoch)

    def _ack_stop(self, rc: Addr, name: str, epoch: int) -> None:
        self.send(rc, "ack_stop_epoch", {
            "name": name, "epoch": epoch, "from": self.my_id,
        })

    # ---- final-state serving (handleRequestEpochFinalState, :1051) -----
    def _handle_request_final_state(self, body: Dict) -> None:
        name, epoch = body["name"], int(body["epoch"])
        key = (name, epoch)
        snap = self.final_states.get(key)
        if key not in self.final_states:
            # Restart fallback: the in-memory capture was lost, but if this
            # node still hosts (name, epoch) as its CURRENT mapping and the
            # stop fully applied, serve a fresh checkpoint of it.
            # (Old-epoch rows on overlap members can't serve — their app
            # state moved on — but the requester round-robins over all
            # prev actives.)  `is_stopped` alone is NOT enough: it is the
            # DEVICE flag, and the host app cursor can lag behind missing
            # payloads — app.checkpoint would then be a truncated
            # mid-epoch state served as "final", with a dedup set missing
            # the tail executions, and the next epoch's joiners would
            # adopt DIFFERENT histories (the chaos sweep's exactly-once
            # divergence: one joiner with n_executed+1 vs its peer at
            # equal frontiers).  Require the app caught up to the device.
            if (
                self.coordinator.current_epoch(name) != epoch
                or not self.coordinator.is_stopped(name)
                or not self.coordinator.app_caught_up(name)
            ):
                return
            # safe here: this node hasn't moved past `epoch`, so its live
            # dedup set has no next-epoch entries
            snap = {
                "state": self.coordinator.app.checkpoint(name),
                "dedup": self.coordinator.dedup_for_name(name),
                "t": time.time(),
            }
            self.final_states[key] = snap
        self.send(("AR", int(body["from"])), "epoch_final_state", {
            "name": name,
            "epoch": epoch,  # the PREV epoch being served
            "state": snap["state"],
            # the STOP-TIME dedup snapshot travels with the state: the
            # receiver's adopted history must carry exactly its own set
            "dedup": snap["dedup"],
        })

    # ---- drop (handleDropEpochFinalState, :968) ------------------------
    def _handle_drop_epoch(self, body: Dict) -> None:
        name, epoch = body["name"], int(body["epoch"])
        if self.coordinator.hosts_epoch(name, epoch):
            # final: the reconfigurator drops an epoch only after a majority
            # executed its stop, so a member still behind that stop is freed
            # too — its peers drop their rows on this same message, after
            # which the stop could never land here (the JAX package stays
            # silent and keeps such a row forever)
            if not self.coordinator.delete_replica_group(name, epoch, final=True):
                return
        self.final_states.pop((name, epoch), None)
        self.send(tuple(body["rc"]), "ack_drop_epoch", {
            "name": name, "epoch": epoch, "from": self.my_id,
        })
