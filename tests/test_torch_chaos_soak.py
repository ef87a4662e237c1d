"""The chaos soak (``testing/chaos.py:run_soak``) on the port, on the CPU.

Port replicas of ``tests/test_chaos.py::test_chaos_soak``: the same pinned
seeds (``CHAOS_SEED`` overrides them, as there) at the same parameters,
with the soak's own end-state audit as the check (settle, RC agreement,
alignment, RSM convergence, the exactly-once triple and the per-step
probe).  Each soak runs in a fresh interpreter on a scripted clock with
the string hash pinned (``torch_soak``), so a seed replays one schedule on
every run.  Plus the family's parity seed: ``run_soak(662625602)`` at its
breach shape on both packages, equal results and member end states.
"""

import os

import pytest

from torch_soak import in_child

_SEEDS = (
    [int(os.environ["CHAOS_SEED"])] if os.environ.get("CHAOS_SEED")
    else [1234, 7, 20260730, 1280113, 777063353]
)


@pytest.mark.parametrize("seed", _SEEDS)
def test_chaos_soak(seed):
    out = in_child("port", "soak", seed)
    assert out["seed"] == seed


def test_chaos_soak_parity_662625602():
    out = in_child("parity", "soak", 662625602, rounds=90, loss=0.3)
    assert out["seed"] == 662625602
