"""The port's window limit on the card: W <= 32.

``gp_step`` maps one group's ring to at most one warp, so the card path
refuses W > 32 before it touches the device; no configuration of the
reference uses more (``SLOT_WINDOW`` is 16).  The plain engine on the CPU
takes any power-of-two window: at W=64 the port's simulator stays bit
equal to the JAX package's over a seeded schedule.
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.testing import sim as jsim
from gigapaxos_tpu_torch.ops import gp_kernels
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.ops.engine import init_state, to_host
from gigapaxos_tpu_torch.testing import sim as tsim

G, W, K, R = 6, 64, 4, 3


def test_plain_engine_at_w64_matches_jax():
    cj = jsim.SimCluster(JConfig(G, W, K, R))
    ct = tsim.SimCluster(TConfig(G, W, K, R), device="cpu")
    cj.create_all_groups()
    ct.create_all_groups()
    rng = np.random.default_rng(64)
    vid = 1
    for t in range(12):
        reqs = {}
        for r in range(R):
            a = np.full((G, K), -1, np.int32)
            for g in range(G):
                if rng.random() < 0.6:
                    a[g, 0] = vid
                    vid += 1
            reqs[r] = a
        delivery = rng.choice([tsim.DELIVER, tsim.DROP], size=(R, R), p=[0.8, 0.2])
        np.fill_diagonal(delivery, tsim.DELIVER)
        oj = cj.step_all(reqs=reqs, delivery=delivery)
        ot = ct.step_all(reqs=reqs, delivery=delivery)
        for r in range(R):
            for f in cj.states[r]._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(cj.states[r], f)),
                    to_host(getattr(ct.states[r], f)), err_msg=f"t={t} r={r} {f}")
            for f in oj[r]._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(oj[r], f)), to_host(getattr(ot[r], f)),
                    err_msg=f"t={t} r={r} out {f}")
    ct.assert_rsm_invariant()
    assert ct.states[0].acc_slot.shape == (G, W)
    assert int(to_host(ct.states[0].exec_slot).max()) > 0


def test_check_cfg_refuses_w64_for_the_card():
    with pytest.raises(NotImplementedError, match="W=64 > 32"):
        gp_kernels._check_cfg(TConfig(G, W, K, R))
    gp_kernels._check_cfg(TConfig(G, 32, K, R))  # the largest the card takes


@pytest.mark.parametrize("entry", ["step", "step_stacked", "step_launch_plan"])
def test_card_entry_points_refuse_w64_before_any_launch(entry):
    """Every card entry point checks the window first: W=64 is refused
    with the limit's message on any box, card or not."""
    cfg = TConfig(G, W, K, R)
    st = init_state(cfg, "cpu")
    stacked = type(st)(*(torch.stack([x] * R) for x in st))
    calls = {
        "step": lambda: gp_kernels.step(st, None, None, None, None, 0, cfg),
        "step_stacked": lambda: gp_kernels.step_stacked(
            stacked, None, None, None, None, cfg),
        "step_launch_plan": lambda: gp_kernels.step_launch_plan(cfg),
    }
    with pytest.raises(NotImplementedError, match="W=64 > 32"):
        calls[entry]()
