"""Presumed-abort transaction resolution: the crash-recovery path.

A driver can die at any protocol step — before any prepare, mid-lock,
after the decide, mid-outcome-drive.  Because every transition is a
replicated log entry, the coordinator group's live records are a
complete inventory of every transaction that might still hold locks
anywhere, and re-driving them is idempotent (participants answer
re-drives from their resolved rings).  The :class:`TxnResolver` closes
the loop:

* records already DECIDED (``committed``/``aborted``) but never ended —
  the driver died mid-drive — are re-driven to every participant and
  then ended;
* records still ``begun``/``prepared`` past the presumed-abort horizon
  (logical clock vs. the record's begin time) are decided ABORTED —
  first-decide-wins makes the race against a slow-but-alive driver
  safe: whoever decides first fixes the global outcome and the other
  obeys it.

Run one resolver per deployment (or several — every step is
idempotent), poll it on the soak/serving cadence, and restart recovery
needs nothing special: journal replay rebuilds the records and the next
resolver pass re-drives them.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional

from ..paxos_config import PC
from ..utils.config import Config
from .app import ABORTED, COMMITTED, tx_op, txc_op
from .driver import _Op


class _Job:
    """Re-drive one decided record: outcome to every participant, then
    end the record."""

    def __init__(self, txid: str, outcome: str, names: List[str]):
        self.txid = txid
        self.outcome = outcome
        self.names = list(names)
        self.drive: List[_Op] = []
        self.end_op: Optional[_Op] = None


class TxnResolver:
    """Poll-driven in-doubt transaction resolver (presumed abort).

    ``submit``/``clock`` follow the :class:`~.driver.TxnDriver`
    conventions; ``resolve_period_s`` (logical) paces the coordinator
    ``list`` scans and ``presume_abort_s`` is the begin-to-abort horizon
    for undecided records.
    """

    def __init__(
        self,
        submit: Callable,
        coord: str,
        clock: Callable[[], float],
        *,
        resolve_period_s: Optional[float] = None,
        presume_abort_s: Optional[float] = None,
        retransmit_s: float = 0.25,
        metrics=None,
        rng: Optional[random.Random] = None,
    ):
        self.submit = submit
        self.coord = coord
        self.clock = clock
        self.resolve_period_s = (
            Config.get_float(PC.TXN_RESOLVE_PERIOD_S)
            if resolve_period_s is None else float(resolve_period_s)
        )
        self.presume_abort_s = (
            Config.get_float(PC.TXN_PREPARE_TIMEOUT_S)
            if presume_abort_s is None else float(presume_abort_s)
        )
        self.retransmit_s = float(retransmit_s)
        self.metrics = metrics
        self._rng = rng or random
        self._list_op: Optional[_Op] = None
        self._last_list = float("-inf")
        self._jobs: Dict[str, _Job] = {}
        self._deciding: Dict[str, _Op] = {}
        self._record_names: Dict[str, List[str]] = {}
        self.live_records = 0  # from the last completed list scan
        self.resolved_count = 0
        self.scans = 0  # completed list scans (settle loops gate on it)

    def _rid(self) -> int:
        return self._rng.randrange(1 << 48, 1 << 62)

    def _send(self, op: _Op) -> None:
        op.sent_at = self.clock()
        op.attempts += 1
        self.submit(op.name, op.value, op.rid,
                    lambda rid, resp, b=op.box: b.append(resp))

    def _retx(self, op: _Op, now: float) -> None:
        if now - op.sent_at >= self.retransmit_s:
            self._send(op)

    def idle(self) -> bool:
        """True when the last scan saw no live records and no re-drive
        is in flight — the settle loop's convergence signal."""
        return not self._jobs and not self._deciding \
            and self.live_records == 0

    # ---- the poll ------------------------------------------------------
    def poll(self) -> None:
        now = self.clock()
        # 1. periodic coordinator scan
        if self._list_op is not None:
            r = self._list_op.latest()
            if r is None:
                self._retx(self._list_op, now)
            else:
                self._list_op = None
                self._on_records(r.get("records") or {}, now)
        elif now - self._last_list >= self.resolve_period_s:
            self._last_list = now
            self._list_op = _Op(self.coord, txc_op("list"), self._rid())
            self._send(self._list_op)

        # 2. pending presume-abort decides
        for txid, op in list(self._deciding.items()):
            r = op.latest()
            if r is None:
                self._retx(op, now)
                continue
            del self._deciding[txid]
            # whatever outcome won (ours or a racing driver's commit),
            # re-drive it now rather than waiting for the next scan
            outcome = r.get("outcome") or ABORTED
            if txid not in self._jobs:
                names = self._record_names.get(txid, [])
                self._start_job(txid, outcome, names)

        # 3. advance re-drive jobs
        for txid, job in list(self._jobs.items()):
            if job.end_op is not None:
                r = job.end_op.latest()
                if r is None:
                    self._retx(job.end_op, now)
                else:
                    del self._jobs[txid]
                    self.resolved_count += 1
                    if self.metrics is not None:
                        self.metrics.count("txn_in_doubt_resolved")
                continue
            done = True
            for op in job.drive:
                r = op.latest()
                if r is None or (not r.get("ok") and r.get("retry")):
                    done = False
                    self._retx(op, now)
            if done:
                job.end_op = _Op(
                    self.coord, txc_op("end", job.txid), self._rid()
                )
                self._send(job.end_op)

    # ---- record handling ----------------------------------------------
    def _on_records(self, records: Dict[str, Dict], now: float) -> None:
        self.scans += 1
        self.live_records = len(records)
        self._record_names = {
            txid: list(rec.get("names") or [])
            for txid, rec in records.items()
        }
        for txid, rec in records.items():
            if txid in self._jobs or txid in self._deciding:
                continue
            state = rec.get("state")
            if state in (COMMITTED, ABORTED):
                # decided but never ended: the driver died mid-drive
                self._start_job(txid, state, rec.get("names") or [])
            elif now - float(rec.get("t") or 0.0) >= self.presume_abort_s:
                op = _Op(self.coord, txc_op(
                    "decide", txid, outcome=ABORTED), self._rid())
                self._deciding[txid] = op
                self._send(op)

    def _start_job(self, txid: str, outcome: str, names: List[str]) -> None:
        job = _Job(txid, outcome, names)
        kind = "commit" if outcome == COMMITTED else "abort"
        for name in job.names:
            op = _Op(name, tx_op(kind, txid), self._rid())
            job.drive.append(op)
            self._send(op)
        if not job.names:
            job.end_op = _Op(self.coord, txc_op("end", txid), self._rid())
            self._send(job.end_op)
        self._jobs[txid] = job
