"""Synchronous transaction front-end over the poll-driven
:class:`~gigapaxos_tpu_torch.txn.driver.TxnDriver`.

:class:`Transaction` names the ops; :class:`Transactor` runs one
transaction to its single global outcome by alternating driver polls
with cluster steps.  Time inside :meth:`Transactor.run` is LOGICAL —
each ``step()`` advances an internal clock by ``step_dt`` — so lock
waits, retransmits, and the prepare timeout all follow the
chaos-compressed clock convention (no ``time.time()`` gate anywhere in
the protocol path; ROADMAP item 1's no-hard-wall-clock-gates rule).
A caller with real time to spend can inject its own ``clock``.

``DistTransactor`` remains as the reference-named alias
(``txn/DistTransactor.java``), now implemented — not a capability
stub: aborts discard STAGED ops, so no participant is ever mutated by
a transaction that did not commit.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

from .app import TXN_COORD
from .driver import TxnDriver


class Transaction:
    """An ordered set of (name, request_value) ops applied atomically:
    either every op executes (exactly once) or none does."""

    def __init__(self, ops: List[Tuple[str, str]],
                 txid: Optional[str] = None,
                 rng: Optional[random.Random] = None):
        self.ops = list(ops)
        r = rng or random
        self.txid = txid or f"tx{r.randrange(1 << 48):012x}"

    @property
    def names(self) -> List[str]:
        return sorted({n for n, _ in self.ops})


class Transactor:
    """Run transactions synchronously against a stepped cluster.

    ``submit(name, value, request_id, callback)`` proposes one
    replicated request (async); ``step()`` advances the cluster one
    tick.  Each step advances the logical clock by ``step_dt`` seconds.
    """

    def __init__(
        self,
        submit: Callable[[str, str, int, Callable], None],
        step: Callable[[], None],
        coord: str = TXN_COORD,
        *,
        step_dt: float = 0.05,
        prepare_timeout_s: Optional[float] = None,
        retransmit_s: float = 0.25,
        metrics=None,
        rng: Optional[random.Random] = None,
    ):
        self.submit = submit
        self.step = step
        self.coord = coord
        self.step_dt = float(step_dt)
        self.prepare_timeout_s = prepare_timeout_s
        self.retransmit_s = retransmit_s
        self.metrics = metrics
        self.rng = rng
        self._steps = 0

    def clock(self) -> float:
        """Logical seconds: steps taken x step_dt (chaos-compressed)."""
        return self._steps * self.step_dt

    def driver(self, txn: Transaction) -> TxnDriver:
        return TxnDriver(
            txn, self.submit, self.coord, self.clock,
            prepare_timeout_s=self.prepare_timeout_s,
            retransmit_s=self.retransmit_s,
            metrics=self.metrics, rng=self.rng,
        )

    def run(self, txn: Transaction, max_steps: int = 20000) -> Dict:
        """Drive ``txn`` to its decided outcome; returns the driver's
        result dict (``committed``/``outcome``/``responses``).  Raises
        ``TimeoutError`` only if the cluster makes no progress within
        ``max_steps`` ticks — a liveness budget, not a wall clock."""
        d = self.driver(txn)
        for _ in range(max_steps):
            out = d.poll()
            if out is not None:
                return out
            self.step()
            self._steps += 1
        raise TimeoutError(
            f"transaction {txn.txid} undecided after {max_steps} steps "
            f"(state={d._state})"
        )


#: reference-named alias (``txn/DistTransactor.java``)
DistTransactor = Transactor
