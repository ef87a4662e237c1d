"""The transaction chaos family (``testing/chaos.py:run_txn_soak``) on the
port, on the CPU.

Port replicas of ``tests/test_chaos.py``'s txn tests, at its seeds and
parameters, with the soak's own audit as the check (every driver
finishes, no lock or staged op survives, one outcome per killed driver,
balances agree, conservation, per-name ledger), each in a fresh
interpreter on a scripted clock with the string hash pinned
(``torch_soak``).  ``test_txn_soak_pinned`` stays ``slow`` as there.
``test_txn_fresh_seeds`` draws its seeds from the wall clock as there, but
its default budget runs one soak (``CHAOS_TXN_BUDGET_S`` raises it).
"""

import os
import time

import pytest

from torch_soak import fresh, in_child

_TXN_BREACH_SEEDS = [786083501, 786384423, 495514]

_TXN_SEEDS = (
    [int(os.environ["CHAOS_TXN_SEED"])]
    if os.environ.get("CHAOS_TXN_SEED") else [11, 1, 2]
)


@pytest.mark.parametrize("seed", _TXN_BREACH_SEEDS)
def test_txn_breach_shapes(seed):
    out = in_child("port", "txn_soak", seed)
    assert out["seed"] == seed and out["txns"] >= 1


@pytest.mark.parametrize("seed", _TXN_SEEDS)
@pytest.mark.slow
def test_txn_soak_pinned(seed):
    in_child("port", "txn_soak", seed)


def test_txn_fresh_seeds():
    budget = float(os.environ.get("CHAOS_TXN_BUDGET_S", "0"))
    base = (int(time.time()) + 104729) % 1_000_000_007
    deadline = time.time() + budget
    ran = 0
    while ran == 0 or time.time() < deadline:
        seed = base + ran * 7919
        if not fresh(seed, f"CHAOS_TXN_SEED={seed} pytest "
                     "tests/test_torch_chaos_txn.py::test_txn_soak_pinned",
                     family="txn_soak"):
            break
        ran += 1
