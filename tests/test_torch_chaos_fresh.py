"""The chaos discovery tests of ``tests/test_chaos.py`` on the port.

Same seeds where they are fixed (the traced liveness seeds), the same
wall-clock seed streams where they are fresh, the same soak parameters
and the same DISCOVERY convention: a fresh-seed hit warns with its
reproduce line, or fails under ``CHAOS_FRESH_STRICT=1``.  Each soak runs
in a fresh interpreter on a scripted clock with the string hash pinned
(``torch_soak``).  The time budgets of the fresh-seed loops default to
one soak each here (the JAX file's 90 s and 60 s loops would take most
of a test worker's share); the same variables raise them.
"""

import os
import time

from torch_soak import fresh


def test_chaos_fresh_seeds():
    budget = float(os.environ.get("CHAOS_FRESH_BUDGET_S", "0"))
    base = int(time.time()) % 1_000_000_007
    deadline = time.time() + budget
    ran = 0
    while ran == 0 or time.time() < deadline:
        seed = base + ran * 7919
        if not fresh(seed, f"CHAOS_SEED={seed} pytest "
                     "tests/test_torch_chaos_soak.py::test_chaos_soak"):
            break
        ran += 1


def test_chaos_duplicate_retransmits():
    budget = float(os.environ.get("CHAOS_DUP_BUDGET_S", "0"))
    base = (int(time.time()) + 7919) % 1_000_000_007
    deadline = time.time() + budget
    ran = 0
    while ran == 0 or time.time() < deadline:
        seed = base + ran * 104729
        if not fresh(seed, f"run_soak({seed}, dup_rate=0.3)", dup_rate=0.3):
            break
        ran += 1


def test_chaos_traced_liveness_seeds():
    budget = float(os.environ.get("CHAOS_TRACED_BUDGET_S", "40"))
    deadline = time.time() + budget
    for seed in (661118786, 661277166, 555688974, 662625602):
        if not fresh(seed, f"run_soak({seed}, rounds=90, loss=0.3)",
                     rounds=90, loss=0.3):
            break
        if time.time() > deadline:
            break


def test_chaos_large_shape():
    seed = int(os.environ.get("CHAOS_LARGE_SEED", str(int(time.time()))))
    fresh(seed, f"CHAOS_LARGE_SEED={seed}", rounds=90, n_names=10,
          ar_cfg=(64, 16, 4, 5), rc_cfg=(8, 8, 4, 3))
