"""The transaction RSM: participant and coordinator state machines in one
Replicable wrapper.

Every 2PC state transition is itself a REPLICATED REQUEST (Gray &
Lampson, *Consensus on Transaction Commit*; Spanner's 2PC layered over
Paxos groups): reserved ``__tx__:``-prefixed values are PARTICIPANT ops
executed inside the data group's own consensus log, and
``__txc__:``-prefixed values are COORDINATOR-RECORD ops executed inside
a dedicated coordinator group's log.  Because each transition is a
decided log entry, crash recovery is just journal replay — a restarted
replica re-derives its lock table, staged ops, and coordinator records
from the same decisions everyone else executed, and the resolver
(:mod:`.recovery`) re-drives any transaction that was in doubt.

Participant protocol (per data group):

* ``prepare``   — stage the transaction's ops for this name AND acquire
  the name's lock, in ONE replicated step.  Refused retryably while a
  rival holds the lock; refused terminally once the transaction is
  already resolved here (the late-prepare fence: a straggling prepare
  decided after the transaction's abort must not re-acquire the lock).
* ``commit``    — apply the staged ops through the inner app, release
  the lock, remember the outcome.  Idempotent (re-drives answer from
  the resolved ring).
* ``abort``     — discard the staged ops (nothing was ever applied —
  the staged-until-decision rule is what closes the old stub's no-undo
  hole), release the lock, remember ``aborted`` even when nothing was
  staged (presumed abort + the late-prepare fence).

Coordinator protocol (per coordinator group, any name works — the
convention is :data:`TXN_COORD` / ``__txc__0``):

* ``begin``     — durably create the transaction record (names + ops +
  the client's logical begin time) in state ``begun``.
* ``prepared``  — bookkeeping transition once every participant staged.
* ``decide``    — the COMMIT POINT.  First decide wins; every later
  decide (a racing resolver, a retransmit) is answered with the
  already-decided outcome, so all drivers converge on one global
  outcome.
* ``end``       — retire the record once the outcome reached every
  participant; the outcome parks in a bounded resolved ring so late
  ``outcome`` queries (and killed-driver audits) still get an answer.
* ``outcome`` / ``list`` — reads used by the resolver and the audits.

All of it — locks, staged ops, per-name resolved rings, coordinator
records — rides :meth:`TxnApp.checkpoint` / :meth:`TxnApp.restore`, so
pause/hibernate, state transfer, and restart-from-journal carry the
transaction plane exactly like app state.

Refusals that the client should simply retry (lock held by a rival, or
a plain request against a locked group) set ``request.txn_retry`` — the
manager skips the response cache for those, so the SAME request id can
be retried after the lock clears without tripping exactly-once dedup.
The skip is deterministic (every replica computes the same refusal from
the same replicated state), so the RSM stays convergent.
"""

from __future__ import annotations

import json
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..interfaces.app import Replicable, Request

TX_PREFIX = "__tx__:"
TXC_PREFIX = "__txc__:"
#: default coordinator-group name (create it like any other group)
TXN_COORD = "__txc__0"

COMMITTED = "committed"
ABORTED = "aborted"

#: per-name resolved-transaction ring bound: the late-prepare fence only
#: needs to outlive the retransmit horizon of one transaction, not all
#: history (a prepare delayed past 512 later transactions on the same
#: name is beyond any retransmit schedule this repo runs)
RESOLVED_RING = 512


def tx_op(kind: str, txid: str, **kw) -> str:
    """Encode one participant op as a request value."""
    kw.update(kind=kind, txid=txid)
    return TX_PREFIX + json.dumps(kw, sort_keys=True, separators=(",", ":"))


def txc_op(kind: str, txid: str = "", **kw) -> str:
    """Encode one coordinator-record op as a request value."""
    kw.update(kind=kind, txid=txid)
    return TXC_PREFIX + json.dumps(kw, sort_keys=True, separators=(",", ":"))


def _ring_put(ring: "OrderedDict[str, str]", txid: str, outcome: str) -> None:
    ring[txid] = outcome
    ring.move_to_end(txid)
    while len(ring) > RESOLVED_RING:
        ring.popitem(last=False)


class TxnApp(Replicable):
    """Replicable wrapper holding the transaction plane's replicated
    state next to the inner app's: per-name locks, staged-until-decision
    ops, resolved rings, and coordinator records.  Everything mutates
    only inside :meth:`execute` (a decided log entry), so all replicas
    agree on it by construction."""

    def __init__(self, app: Replicable):
        self.app = app
        self.locks: Dict[str, str] = {}              # name -> holding txid
        # name -> (txid, [op values]) staged until the global decision
        self.staged: Dict[str, Tuple[str, List[str]]] = {}
        # name -> bounded ring txid -> outcome (idempotent re-drives +
        # the late-prepare fence)
        self.resolved: Dict[str, "OrderedDict[str, str]"] = {}
        # coordinator-group name -> txid -> live record
        self.records: Dict[str, Dict[str, Dict]] = {}
        # coordinator-group name -> bounded ring txid -> final outcome
        self.ended: Dict[str, "OrderedDict[str, str]"] = {}

    # ---- Replicable ----------------------------------------------------
    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        name = request.paxos_id
        value = request.request_value or ""
        if value.startswith(TX_PREFIX):
            op = json.loads(value[len(TX_PREFIX):])
            out = self._participant_op(name, op)
        elif value.startswith(TXC_PREFIX):
            op = json.loads(value[len(TXC_PREFIX):])
            out = self._coordinator_op(name, op)
        else:
            holder = self.locks.get(name)
            if holder is None:
                return self.app.execute(request, do_not_reply_to_client)
            # group locked by an in-flight transaction: refuse retryably
            # and keep the refusal OUT of the response cache so the same
            # request id flows once the lock clears
            request.txn_retry = True
            out = {"ok": False, "locked_by": holder, "retry": True}
        if out.pop("_retry", False):
            request.txn_retry = True
        request.response_value = json.dumps(out, sort_keys=True)
        return True

    # ---- participant RSM ----------------------------------------------
    def _resolved_outcome(self, name: str, txid: str) -> Optional[str]:
        ring = self.resolved.get(name)
        return ring.get(txid) if ring else None

    def _participant_op(self, name: str, op: Dict) -> Dict:
        kind, txid = op["kind"], op["txid"]
        holder = self.locks.get(name)
        if kind == "prepare":
            res = self._resolved_outcome(name, txid)
            if res is not None:
                # the late-prepare fence: this transaction was already
                # decided here — a straggler prepare must not re-lock
                return {"ok": False, "resolved": res}
            if holder is not None and holder != txid:
                return {"ok": False, "locked_by": holder, "retry": True,
                        "_retry": True}
            vals = [str(v) for v in (op.get("vals") or [])]
            self.locks[name] = txid
            self.staged[name] = (txid, vals)
            return {"ok": True, "staged": len(vals)}
        if kind == "commit":
            res = self._resolved_outcome(name, txid)
            if res == COMMITTED:
                return {"ok": True, "already": True}
            if res == ABORTED:
                # cannot happen under first-decide-wins; visible if it does
                return {"ok": False, "conflict": res}
            if holder != txid:
                return {"ok": False, "unprepared": True}
            _, vals = self.staged.pop(name, (txid, []))
            responses = []
            # deterministic inner request ids (this runs inside a
            # replicated execute — every replica must mint the same)
            base_rid = zlib.crc32(txid.encode("utf-8")) << 8
            from ..packets.paxos_packets import RequestPacket

            for i, v in enumerate(vals):
                inner = RequestPacket(
                    paxos_id=name, request_id=base_rid + i,
                    request_value=v,
                )
                self.app.execute(inner, True)
                responses.append(getattr(inner, "response_value", None))
            del self.locks[name]
            _ring_put(self.resolved.setdefault(name, OrderedDict()),
                      txid, COMMITTED)
            return {"ok": True, "responses": responses}
        if kind == "abort":
            if holder == txid:
                del self.locks[name]
            st = self.staged.get(name)
            if st is not None and st[0] == txid:
                del self.staged[name]
            # record the abort even when nothing was staged: presumed
            # abort + the fence against a prepare decided after this
            _ring_put(self.resolved.setdefault(name, OrderedDict()),
                      txid, ABORTED)
            return {"ok": True}
        if kind == "status":
            st = self.staged.get(name)
            return {
                "ok": True, "locked_by": holder,
                "staged": (list(st[1]) if st and st[0] == txid else None),
                "resolved": self._resolved_outcome(name, txid),
            }
        return {"ok": False, "error": f"unknown tx op {kind!r}"}

    # ---- coordinator RSM ----------------------------------------------
    def _coordinator_op(self, name: str, op: Dict) -> Dict:
        kind, txid = op["kind"], op.get("txid", "")
        recs = self.records.setdefault(name, {})
        ended = self.ended.setdefault(name, OrderedDict())
        rec = recs.get(txid)
        if kind == "begin":
            if txid in ended:
                return {"ok": True, "outcome": ended[txid], "ended": True}
            if rec is None:
                rec = recs[txid] = {
                    "txid": txid,
                    "names": sorted(str(n) for n in (op.get("names") or [])),
                    "ops": list(op.get("ops") or []),
                    "state": "begun",
                    "t": float(op.get("t") or 0.0),
                }
            out = {"ok": True, "state": rec["state"]}
            if rec["state"] in (COMMITTED, ABORTED):
                out["outcome"] = rec["state"]
            return out
        if kind == "prepared":
            if txid in ended:
                return {"ok": True, "outcome": ended[txid], "ended": True}
            if rec is None:
                return {"ok": False, "unknown": True}
            if rec["state"] == "begun":
                rec["state"] = "prepared"
            out = {"ok": True, "state": rec["state"]}
            if rec["state"] in (COMMITTED, ABORTED):
                out["outcome"] = rec["state"]
            return out
        if kind == "decide":
            if txid in ended:
                return {"ok": True, "outcome": ended[txid], "ended": True}
            want = op.get("outcome")
            if want not in (COMMITTED, ABORTED):
                return {"ok": False, "error": f"bad outcome {want!r}"}
            if rec is None:
                # decide for a record never begun: only reachable by a
                # retransmit straddling an end+ring-eviction; presume
                # abort so nothing can commit without a begin record
                _ring_put(ended, txid, ABORTED)
                return {"ok": True, "outcome": ABORTED, "presumed": True}
            if rec["state"] in (COMMITTED, ABORTED):
                return {"ok": True, "outcome": rec["state"]}
            rec["state"] = want  # the commit point — first decide wins
            return {"ok": True, "outcome": want, "decided": True}
        if kind == "end":
            if rec is None:
                return {"ok": True, "already": True,
                        "outcome": ended.get(txid)}
            if rec["state"] not in (COMMITTED, ABORTED):
                return {"ok": False, "undecided": rec["state"]}
            del recs[txid]
            _ring_put(ended, txid, rec["state"])
            return {"ok": True, "outcome": rec["state"]}
        if kind == "outcome":
            if rec is not None:
                live = rec["state"] if rec["state"] in (COMMITTED, ABORTED) \
                    else None
                return {"ok": True, "outcome": live, "state": rec["state"]}
            return {"ok": True, "outcome": ended.get(txid)}
        if kind == "list":
            return {
                "ok": True,
                "records": {t: dict(r) for t, r in sorted(recs.items())},
            }
        return {"ok": False, "error": f"unknown txc op {kind!r}"}

    # ---- admission / local-read interaction ----------------------------
    def is_coordinated(self, value: str) -> bool:
        """Transaction ops always coordinate; everything else follows
        the inner app's routing (local reads keep working — they see
        committed state only, since staged ops are never applied)."""
        if value.startswith(TX_PREFIX) or value.startswith(TXC_PREFIX):
            return True
        inner = getattr(self.app, "is_coordinated", None)
        return True if inner is None else inner(value)

    def txn_local_read_blocked(self, name: str) -> bool:
        """Consulted by ``PaxosManager.local_read_ok``: a locked/staged
        name's reads must serialize through consensus (where they are
        refused retryably until the decision lands) — a local read racing
        the commit apply could otherwise be un-serializable against the
        transaction."""
        return name in self.locks or name in self.staged

    def txn_stats(self) -> Dict:
        """Admin-op surface (``server._on_admin`` "stats")."""
        return {
            "locks": len(self.locks),
            "staged": len(self.staged),
            "live_records": sum(len(r) for r in self.records.values()),
        }

    # ---- checkpoint / restore ------------------------------------------
    def checkpoint(self, name: str) -> Optional[str]:
        doc: Dict = {"app": self.app.checkpoint(name)}
        if name in self.locks:
            doc["lock"] = self.locks[name]
        st = self.staged.get(name)
        if st is not None:
            doc["staged"] = [st[0], list(st[1])]
        ring = self.resolved.get(name)
        if ring:
            doc["resolved"] = list(ring.items())
        recs = self.records.get(name)
        if recs:
            doc["records"] = {t: dict(r) for t, r in sorted(recs.items())}
        ended = self.ended.get(name)
        if ended:
            doc["ended"] = list(ended.items())
        return json.dumps(doc, sort_keys=True)

    def _clear_name(self, name: str) -> None:
        self.locks.pop(name, None)
        self.staged.pop(name, None)
        self.resolved.pop(name, None)
        self.records.pop(name, None)
        self.ended.pop(name, None)

    def restore(self, name: str, state: Optional[str]) -> bool:
        if not state:
            self._clear_name(name)
            return self.app.restore(name, state)
        try:
            d = json.loads(state)
        except (json.JSONDecodeError, TypeError):
            d = None
        if not (isinstance(d, dict) and "app" in d):
            # a plain inner-app state (e.g. an initial_state at create)
            self._clear_name(name)
            return self.app.restore(name, state)
        self._clear_name(name)
        if d.get("lock") is not None:
            self.locks[name] = d["lock"]
        if d.get("staged"):
            txid, vals = d["staged"][0], d["staged"][1]
            self.staged[name] = (txid, [str(v) for v in vals])
        if d.get("resolved"):
            self.resolved[name] = OrderedDict(
                (t, o) for t, o in d["resolved"]
            )
        if d.get("records"):
            self.records[name] = {t: dict(r) for t, r in d["records"].items()}
        if d.get("ended"):
            self.ended[name] = OrderedDict((t, o) for t, o in d["ended"])
        return self.app.restore(name, d["app"])

    def get_request(self, stringified: str):
        return self.app.get_request(stringified)

    # convenience passthroughs for fixtures
    def __getattr__(self, item):
        return getattr(self.app, item)
