"""The chaos breach shapes and the multistep pinned seeds on the port.

Port replicas, at the JAX package's seeds and parameters, with the soaks'
own audits as the check (each in a fresh interpreter on a scripted clock
with the string hash pinned, ``torch_soak``):

* ``tests/test_chaos.py::test_chaos_breach_shapes`` (``_BREACH_SEEDS`` at
  90 rounds and 30% loss) and ``test_unpaired_dedup_install_regression``
  (in process, the port's ``PaxosManager`` on the CPU);
* ``tests/test_unified_step.py``'s two pinned seeds with
  ``ENGINE_STEPS_PER_DISPATCH=4``: ``run_soak(662625602, rounds=30)`` and
  ``run_sharded_soak(20260804, workers=2, rounds=30, n_names=6)``.

Seed 881578088 is the one whose JAX test passed in one run and failed in
another: its schedule depends on the wall clock and on the string hash,
and on one schedule its settle outlasts the 60 s deactivation period,
where the JAX package's sweep raises ``NameError`` (ROADMAP section C).
Here it replays one schedule on every run.
"""

import time

import pytest

from gigapaxos_tpu_torch.manager import PaxosManager
from gigapaxos_tpu_torch.models import StatefulAdderApp
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from torch_soak import in_child

_BREACH_SEEDS = [991134624, 881578088, 881205895, 662625602]


@pytest.mark.parametrize("seed", _BREACH_SEEDS)
def test_chaos_breach_shapes(seed):
    out = in_child("port", "soak", seed, rounds=90, loss=0.3)
    assert out["seed"] == seed


def test_unpaired_dedup_install_regression():
    """The JAX test's schedule-independent guard, on the port: dedup
    entries shipped with an epoch-state handoff install if and only if
    the create adopts the state."""
    m = PaxosManager(
        0, StatefulAdderApp(),
        EngineConfig(n_groups=4, window=4, req_lanes=2, n_replicas=3),
        device="cpu",
    )
    try:
        dedup = {"123": [time.time(), "7", "svc"]}
        m.create_paxos_instance("other", [0, 1, 2], row=0)
        with pytest.raises(RuntimeError):
            m.create_paxos_instance(
                "svc", [0, 1, 2], initial_state="5", version=1, row=0,
                dedup=dedup,
            )
        assert 123 not in m.response_cache
        assert m.create_paxos_instance(
            "svc", [0, 1, 2], initial_state="5", version=1, row=1, dedup=dedup
        )
        assert m.app.totals.get("svc") == 5
        assert m.response_cache[123][1] == "7"
        assert m.create_paxos_instance(
            "svc", [0, 1, 2], initial_state="5", version=1, row=1,
            dedup={"456": [time.time(), "9", "svc"]},
        )
        assert 456 not in m.response_cache
    finally:
        m.close()


def test_chaos_pinned_seed_multistep_662625602():
    out = in_child("port", "soak", 662625602, rounds=30,
                   config={"ENGINE_STEPS_PER_DISPATCH": 4})
    assert out["seed"] == 662625602


def test_chaos_pinned_seed_multistep_20260804_sharded():
    out = in_child("port", "sharded_soak", 20260804, workers=2, rounds=30,
                   n_names=6, config={"ENGINE_STEPS_PER_DISPATCH": 4})
    assert out["workers"] == 2
