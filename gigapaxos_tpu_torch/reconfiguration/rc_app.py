"""The reconfigurators' own RSM: reconfiguration records as a Replicable.

API-parity target: ``AbstractReconfiguratorDB`` /
``RepliconfigurableReconfiguratorDB`` (``AbstractReconfiguratorDB.java:84-96``,
``RepliconfigurableReconfiguratorDB.java:54``) — RC records are themselves
paxos-replicated among the reconfigurators, so every RC applies the same
record transitions in the same order (the reference's recursion: the
control plane rides the same consensus engine as the data plane).

Requests are JSON ops (``RCRecordRequest`` INTENT/COMPLETE analog); the
executing replica reports each applied op through ``on_applied`` so the
local :class:`Reconfigurator` can advance its protocol tasks
(``CommitWorker`` callback analog).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

from ..interfaces.app import Replicable, Request
from ..packets.paxos_packets import RequestPacket
from .record import RCState, ReconfigurationRecord

# op kinds (RCRecordRequest.RequestTypes analog)
CREATE_INTENT = "create_intent"      # new name: record born in WAIT_ACK_START
RECONFIGURE_INTENT = "reconfigure_intent"  # epoch e -> e+1: -> WAIT_ACK_STOP
STOP_DONE = "stop_done"              # old epoch stopped: -> WAIT_ACK_START
COMPLETE = "complete"                # majority of new actives up: -> READY
DELETE_INTENT = "delete_intent"      # -> WAIT_DELETE
DELETE_FINAL = "delete_final"        # purge record
DROP_DONE = "drop_done"              # previous epoch's drop round finished
PAUSE_INTENT = "pause_intent"        # residency: -> WAIT_PAUSE
PAUSE_DONE = "pause_done"            # every active freed the row: -> PAUSED
REACTIVATE = "reactivate"            # -> WAIT_ACK_START at a fresh row
AR_ADD = "ar_add"                    # elastic membership: add an active
AR_REMOVE = "ar_remove"              # elastic membership: remove an active
# runtime reconfigurator membership (handleReconfigureRCNodeConfig analog,
# ref Reconfigurator.java:1023-1075): the control plane grows/shrinks
# ITSELF.  An intent arms a one-at-a-time transition (rc_next); the RC
# record group then stops its current epoch and every surviving member
# deterministically creates epoch e+1 under the target set; RC_NODE_DONE
# commits the new set and re-splits ring ownership.
RC_ADD_NODE = "rc_add"               # -> rc_next armed (target = cur + id)
RC_REMOVE_NODE = "rc_remove"         # -> rc_next armed (target = cur - id)
RC_NODE_DONE = "rc_done"             # transition complete: rc_nodes = target


class RCRecordsApp(Replicable):
    """Replicable over the {name -> ReconfigurationRecord} map."""

    def __init__(self, on_applied: Optional[Callable[[Dict], None]] = None):
        self.records: Dict[str, ReconfigurationRecord] = {}
        self.on_applied = on_applied
        # elastic membership: the replicated active-node set (AR_NODES
        # record analog, AbstractReconfiguratorDB.java:84-96); None means
        # "as configured at boot"
        self.ar_nodes: Optional[list] = None
        # the replicated RECONFIGURATOR set (RC_NODES record analog) and
        # the armed-but-uncommitted transition ({"target", "id", "kind"});
        # rc_next also marks "control-plane change in progress" so
        # concurrent membership ops serialize (the reference serializes
        # NC changes through the NC record's own epoch)
        self.rc_nodes: Optional[list] = None
        self.rc_next: Optional[Dict] = None
        # fired after restore() replaces the whole state (checkpoint
        # transfer / recovery): the Reconfigurator refreshes its rings —
        # ar_nodes can change without any op executing locally
        self.on_restored: Optional[Callable[[], None]] = None

    # ---- Replicable ----------------------------------------------------
    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        assert isinstance(request, RequestPacket)
        op = json.loads(request.request_value)
        if "__stop__" in op and "op" not in op:
            # the RC group's own epoch-final stop (the RC-node transition):
            # no record mutation — the manager's stop hook owns the switch
            request.response_value = json.dumps({"ok": True})
            return True
        applied = self._apply(op)
        op["applied"] = applied
        request.response_value = json.dumps({"ok": applied})
        if self.on_applied is not None:
            self.on_applied(op)
        return True

    def _apply(self, op: Dict) -> bool:
        kind = op["op"]
        if kind in (AR_ADD, AR_REMOVE):
            # idempotent: a duplicate/raced proposal of an op that already
            # took effect applies True (the client ack must not claim
            # failure for a succeeded operation)
            nid = int(op["id"])
            cur = list(self.ar_nodes if self.ar_nodes is not None
                       else op.get("boot_actives") or [])
            if kind == AR_ADD:
                if nid not in cur:
                    cur.append(nid)
            else:
                if nid in cur:
                    if len(cur) <= 1:
                        return False  # never remove the last active
                    # a removal that would leave any record with NO live
                    # member is refused: its data exists only in the
                    # removed members' journals (silent loss otherwise)
                    after = set(cur) - {nid}
                    for rec in self.records.values():
                        if not rec.deleted and rec.actives and \
                                not (set(rec.actives) & after):
                            return False
                    cur.remove(nid)
            self.ar_nodes = sorted(cur)
            return True
        if kind in (RC_ADD_NODE, RC_REMOVE_NODE):
            nid = int(op["id"])
            cur = list(self.rc_nodes if self.rc_nodes is not None
                       else op.get("boot_rcs") or [])
            if self.rc_next is not None:
                # a retransmitted duplicate of the armed transition applies
                # True (idempotent re-arm); a DIFFERENT change is refused
                # until the in-flight one commits (one NC change at a time)
                if self.rc_next.get("id") == nid and \
                        self.rc_next.get("kind") == kind:
                    return True
                return False
            if kind == RC_ADD_NODE:
                if nid in cur:
                    op["noop"] = True  # already a member: ack, no transition
                    return True
                target = sorted(cur + [nid])
            else:
                if nid not in cur:
                    op["noop"] = True
                    return True
                if len(cur) <= 1:
                    return False  # never remove the last reconfigurator
                target = sorted(x for x in cur if x != nid)
            self.rc_next = {"target": target, "id": nid, "kind": kind}
            return True
        if kind == RC_NODE_DONE:
            if self.rc_next is None or \
                    list(op.get("target") or []) != list(self.rc_next["target"]):
                return False  # duplicate/stale completion
            self.rc_nodes = list(self.rc_next["target"])
            self.rc_next = None
            return True
        name = op["name"]
        rec = self.records.get(name)
        if kind == CREATE_INTENT:
            if rec is not None and not rec.deleted:
                return False
            rec = ReconfigurationRecord(
                name=name, epoch=int(op.get("epoch", 0)),
                state=RCState.WAIT_ACK_START,
                actives=[], new_actives=list(op["actives"]),
                row=-1, new_row=int(op["row"]),
                initial_state=op.get("initial_state"),
            )
            self.records[name] = rec
            return True
        if rec is None or rec.deleted:
            return False
        if kind == RECONFIGURE_INTENT:
            return rec.start_reconfigure(list(op["new_actives"]), int(op["new_row"]))
        if kind == STOP_DONE:
            return rec.stop_done()
        if kind == COMPLETE:
            if rec.state is not RCState.WAIT_ACK_START:
                return False  # duplicate/late COMPLETE: don't touch the record
            # row retry: a start-epoch NACK (row collision) re-proposes with
            # a probed row; the committed COMPLETE records the row that won
            if "row" in op:
                rec.new_row = int(op["row"])
            return rec.complete()
        if kind == DROP_DONE:
            pde = rec.pending_drop_epoch
            if pde is None or int(op.get("epoch", -1)) != pde:
                return False  # stale/duplicate drop confirmation
            return rec.drop_done()
        if kind == PAUSE_INTENT:
            return rec.start_pause()
        if kind == PAUSE_DONE:
            return rec.pause_done()
        if kind == REACTIVATE:
            return rec.start_reactivate(
                int(op["new_row"]), actives=op.get("actives")
            )
        if kind == DELETE_INTENT:
            return rec.start_delete()
        if kind == DELETE_FINAL:
            if rec.finish_delete():
                del self.records[name]
                return True
            return False
        return False

    def checkpoint(self, name: str) -> Optional[str]:
        # the whole record map is ONE RSM (one paxos group among the RCs),
        # so the checkpoint is the full map regardless of `name`
        return json.dumps({
            "__fmt__": 2,  # versioned envelope: no service-name collisions
            "records": {n: r.to_json() for n, r in self.records.items()},
            "ar_nodes": self.ar_nodes,
            "rc_nodes": self.rc_nodes,
            "rc_next": self.rc_next,
        })

    def restore(self, name: str, state: Optional[str]) -> bool:
        if not state:
            self.records = {}
            self.ar_nodes = None
            self.rc_nodes = None
            self.rc_next = None
        else:
            d = json.loads(state)
            # accept: versioned envelope, the brief unversioned envelope
            # (both keys present and "records" not itself a record), and
            # the original flat record map
            enveloped = d.get("__fmt__") == 2 or (
                "records" in d and "ar_nodes" in d
                and "name" not in (d["records"] or {})
            )
            if not enveloped:
                d = {"records": d, "ar_nodes": None}
            self.records = {
                n: ReconfigurationRecord.from_json(r)
                for n, r in d["records"].items()
            }
            self.ar_nodes = d.get("ar_nodes")
            self.rc_nodes = d.get("rc_nodes")
            self.rc_next = d.get("rc_next")
        if self.on_restored is not None:
            self.on_restored()
        return True

    # ---- reads (RequestActiveReplicas analog) --------------------------
    def get_record(self, name: str) -> Optional[ReconfigurationRecord]:
        return self.records.get(name)

    def get_request(self, stringified: str) -> Request:
        return RequestPacket.from_json(json.loads(stringified))
