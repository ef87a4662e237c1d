"""Poll-driven 2PC transaction driver.

One :class:`TxnDriver` drives one transaction through the replicated
state machines in :mod:`.app` without ever blocking: every call to
:meth:`poll` inspects the responses that have arrived, retransmits what
timed out (logical clock — the chaos-compressed convention, never a
wall-clock gate), and submits the next protocol step.  The chaos soak
polls many drivers between cluster steps; the synchronous
:class:`~gigapaxos_tpu_torch.txn.transactor.Transactor` wraps one driver in a
step loop.

Protocol order (the invariants the resolver relies on):

1. ``begin`` to the coordinator group — ACKED before any prepare is
   sent, so every lock in the system is traceable to a begin record
   (no orphan prepares: presumed abort can always find the record).
2. ``prepare`` per participant IN SORTED NAME ORDER, strictly
   sequentially — the classic deadlock-freedom argument: all
   transactions acquire locks along one global order.
3. ``prepared`` marker, then ``decide committed`` — the coordinator
   answers with the FINAL outcome (first decide wins), which may be
   ``aborted`` if a resolver presumed-abort beat us; the driver obeys
   whatever came back.
4. Drive the decided outcome (``commit``/``abort``) to EVERY
   participant named by the transaction — including ones never
   prepared, so a straggling prepare retransmit hits the participant's
   resolved-ring fence instead of re-locking.
5. ``end`` the coordinator record.

Retransmits reuse the SAME request id: an executed-and-cached step is
answered from the response cache (exactly-once), while retryable
refusals are deliberately left uncached by the manager
(``request.txn_retry``) so the same id retries the op after the lock
clears.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional

from ..paxos_config import PC
from ..utils.config import Config
from .app import ABORTED, COMMITTED, tx_op, txc_op

# driver states
_BEGIN, _PREPARE, _MARK, _DECIDE, _DRIVE, _END, _DONE = range(7)


class _Op:
    """One in-flight replicated op: value + rid + response box."""

    __slots__ = ("name", "value", "rid", "box", "sent_at", "attempts")

    def __init__(self, name: str, value: str, rid: int):
        self.name = name
        self.value = value
        self.rid = rid
        self.box: List = []
        self.sent_at = float("-inf")
        self.attempts = 0

    def latest(self) -> Optional[Dict]:
        if not self.box:
            return None
        import json

        try:
            return json.loads(self.box[-1]) if self.box[-1] else None
        except (ValueError, TypeError):
            return None


class TxnDriver:
    """Drive one transaction to a single global outcome.

    ``submit(name, value, request_id, callback)`` proposes one
    replicated request through any entry replica (async; the callback
    receives ``(request_id, response)``).  ``clock()`` returns logical
    seconds — the soak advances it per cluster step.
    """

    def __init__(
        self,
        txn,
        submit: Callable[[str, str, int, Callable], None],
        coord: str,
        clock: Callable[[], float],
        *,
        prepare_timeout_s: Optional[float] = None,
        retransmit_s: float = 0.25,
        metrics=None,
        rng: Optional[random.Random] = None,
    ):
        self.txn = txn
        self.submit = submit
        self.coord = coord
        self.clock = clock
        self.prepare_timeout_s = (
            Config.get_float(PC.TXN_PREPARE_TIMEOUT_S)
            if prepare_timeout_s is None else float(prepare_timeout_s)
        )
        self.retransmit_s = float(retransmit_s)
        self.metrics = metrics
        self._rng = rng or random
        self._state = _BEGIN
        self._t0 = None  # logical time of first poll
        self._wall0 = None  # wall time, for the latency histogram only
        self._op: Optional[_Op] = None
        self._drive: List[_Op] = []
        self._prep_idx = 0
        self.outcome: Optional[str] = None
        self._abort_why: Optional[str] = None
        self._responses: Dict[str, List] = {}
        self.result: Optional[Dict] = None
        # ops per name, in sorted-lock-order
        self._vals: Dict[str, List[str]] = {}
        for n, v in txn.ops:
            self._vals.setdefault(n, []).append(v)
        self.names = sorted(self._vals)

    # ---- submission helpers -------------------------------------------
    def _rid(self) -> int:
        return self._rng.randrange(1 << 48, 1 << 62)

    def _send(self, op: _Op) -> None:
        op.sent_at = self.clock()
        op.attempts += 1
        self.submit(op.name, op.value, op.rid,
                    lambda rid, resp, b=op.box: b.append(resp))

    def _start(self, name: str, value: str) -> _Op:
        op = _Op(name, value, self._rid())
        self._op = op
        self._send(op)
        return op

    def _retransmit(self, op: _Op, now: float) -> None:
        if now - op.sent_at >= self.retransmit_s:
            self._send(op)

    # ---- the state machine --------------------------------------------
    def poll(self) -> Optional[Dict]:
        """Advance as far as arrived responses allow; returns the result
        dict once the transaction reached END, else None."""
        if self._state == _DONE:
            return self.result
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
            self._wall0 = time.time()
            self._start(self.coord, txc_op(
                "begin", self.txn.txid, names=self.names,
                ops=list(map(list, self.txn.ops)), t=now,
            ))
            if self.metrics is not None:
                self.metrics.count("txn_begun")
            return None

        if self._state == _BEGIN:
            r = self._op.latest()
            if r is None:
                self._retransmit(self._op, now)
                return None
            if r.get("outcome"):  # retransmit of an already-decided txn
                self.outcome = r["outcome"]
                self._enter_drive()
                return None
            self._state = _PREPARE
            self._prep_idx = 0
            self._start_prepare()
            return None

        if self._state == _PREPARE:
            r = self._op.latest()
            if r is None:
                self._retransmit(self._op, now)
            elif r.get("ok"):
                self._prep_idx += 1
                if self._prep_idx >= len(self.names):
                    self._state = _MARK
                    self._start(self.coord,
                                txc_op("prepared", self.txn.txid))
                else:
                    self._start_prepare()
                return None
            elif r.get("resolved"):
                # already decided here (a resolver raced us): learn the
                # global outcome through decide and obey it
                self._abort_why = f"resolved:{r['resolved']}"
                self._state = _DECIDE
                self._start(self.coord, txc_op(
                    "decide", self.txn.txid, outcome=ABORTED))
                return None
            elif r.get("retry"):
                # lock held by a rival: same-rid retransmit IS the retry
                # (the refusal was not cached), paced by the logical clock
                self._retransmit(self._op, now)
            else:
                self._begin_abort(f"prepare-refused:{r}")
                return None
            # sorted sequential lock waits bound total wait; past the
            # prepare budget, presume abort ourselves
            if now - self._t0 > self.prepare_timeout_s:
                self._begin_abort("prepare-timeout")
            return None

        if self._state == _MARK:
            r = self._op.latest()
            if r is None:
                self._retransmit(self._op, now)
                return None
            self._state = _DECIDE
            self._start(self.coord, txc_op(
                "decide", self.txn.txid, outcome=COMMITTED))
            return None

        if self._state == _DECIDE:
            r = self._op.latest()
            if r is None:
                self._retransmit(self._op, now)
                return None
            self.outcome = r.get("outcome") or ABORTED
            if self.metrics is not None:
                if self.outcome == COMMITTED:
                    self.metrics.count("txn_committed")
                    self.metrics.observe(
                        "txn_commit_latency_s", time.time() - self._wall0
                    )
                else:
                    self.metrics.count("txn_aborted")
            self._enter_drive()
            return None

        if self._state == _DRIVE:
            done = True
            for op in self._drive:
                r = op.latest()
                if r is None:
                    done = False
                    self._retransmit(op, now)
                elif not r.get("ok") and r.get("retry"):
                    done = False
                    self._retransmit(op, now)
                elif r.get("ok") and r.get("responses") is not None:
                    self._responses[op.name] = r["responses"]
            if done:
                self._state = _END
                self._start(self.coord, txc_op("end", self.txn.txid))
            return None

        if self._state == _END:
            r = self._op.latest()
            if r is None:
                self._retransmit(self._op, now)
                return None
            self._state = _DONE
            self.result = {
                "txid": self.txn.txid,
                "committed": self.outcome == COMMITTED,
                "outcome": self.outcome,
                "responses": self._responses,
                "latency_s": time.time() - self._wall0,
            }
            if self._abort_why and self.outcome != COMMITTED:
                self.result["aborted"] = self._abort_why
            return self.result
        return None

    # ---- transitions ---------------------------------------------------
    def _start_prepare(self) -> None:
        name = self.names[self._prep_idx]
        self._start(name, tx_op(
            "prepare", self.txn.txid, vals=self._vals[name],
        ))

    def _begin_abort(self, why: str) -> None:
        self._abort_why = why
        self._state = _DECIDE
        self._start(self.coord, txc_op(
            "decide", self.txn.txid, outcome=ABORTED))

    def _enter_drive(self) -> None:
        """Drive the decided outcome to EVERY named participant (even
        never-prepared ones — the abort writes the resolved-ring fence a
        straggling prepare retransmit will hit)."""
        self._state = _DRIVE
        kind = "commit" if self.outcome == COMMITTED else "abort"
        self._drive = []
        for name in self.names:
            op = _Op(name, tx_op(kind, self.txn.txid), self._rid())
            self._drive.append(op)
            self._send(op)
