"""The port's own scripted clock (``gigapaxos_tpu_torch/testing/clock.py``).

``chip_smoke.py`` runs its chaos soaks on this clock, in a child
interpreter with ``PYTHONHASHSEED`` pinned and without JAX or the test
helpers, so that one seed replays one schedule on every call.  Here, on
the CPU: two such children of one seed give identical results (the
soak's result dictionary, its manager ticks, cluster steps and scripted
seconds), and the result equals what the parity harness's clock
(``tests/torch_soak.py``, both packages' modules patched) gives for the
port.
"""

import pytest

from gigapaxos_tpu_torch.testing.clock import ScriptedClock, run_in_child
from torch_soak import in_child

REPLAYED = ("result", "cluster_steps", "manager_ticks", "scripted_s")


@pytest.mark.parametrize("family,seed", [("soak", 1234), ("density_soak", 1)])
def test_scripted_soak_replays_one_schedule(family, seed):
    a = run_in_child(family, seed, "cpu")
    b = run_in_child(family, seed, "cpu")
    assert {k: a[k] for k in REPLAYED} == {k: b[k] for k in REPLAYED}
    assert a["manager_ticks"] > 0 and a["result"]["seed"] == seed
    assert not any(a["launches"].values()), a["launches"]   # the plain engine
    assert a["result"] == in_child("port", family, seed)


def test_one_scripted_clock_class():
    """The parity harnesses use the package's class, not a copy."""
    import test_torch_reconfiguration
    import torch_soak

    assert test_torch_reconfiguration.ScriptedClock is ScriptedClock
    assert torch_soak.clock_mod.ScriptedClock is ScriptedClock
