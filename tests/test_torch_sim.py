"""SimCluster parity: the port's simulator in lock step with the reference.

One reference and one port cluster run the same seeded DELIVER / DROP /
STALE schedule (traffic at random replicas, election pulses, membership
subsets); every leaf of every replica and every StepOutputs field must be
equal after every step, both safety checkers must agree on every chosen
(group, slot), and the port's cluster must pass ``assert_rsm_invariant``.
"""

import numpy as np
import pytest

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.testing import sim as jsim
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.ops.engine import STOP_BIT, to_host
from gigapaxos_tpu_torch.testing import sim as tsim
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

G, W, K, R = 6, 8, 4, 3
NULL = -1


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def _eq(a, b, what):
    for f in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), to_host(getattr(b, f)),
            err_msg=f"{what}: {f}",
        )


def _pair(create_all=True):
    cj = jsim.SimCluster(JConfig(G, W, K, R))
    ct = tsim.SimCluster(TConfig(G, W, K, R), device="cpu")
    if create_all:
        cj.create_all_groups()
        ct.create_all_groups()
    return cj, ct


def _both(cj, ct, **kw):
    oj = cj.step_all(**kw)
    ot = ct.step_all(**kw)
    for r in range(R):
        _eq(cj.states[r], ct.states[r], f"state[{r}] t={ct.t}")
        _eq(oj[r], ot[r], f"out[{r}] t={ct.t}")


@pytest.mark.parametrize("seed", [7, 2026])
def test_lockstep_seeded_schedule(seed):
    cj, ct = _pair()
    rng = np.random.default_rng(seed)
    vid = 1
    codes = [tsim.DELIVER, tsim.DROP, tsim.STALE]
    for t in range(60):
        delivery = rng.choice(codes, size=(R, R), p=[0.7, 0.2, 0.1])
        reqs = {}
        for g in range(G):
            if rng.random() < 0.6:
                rid = int(rng.integers(0, R))
                arr = reqs.setdefault(rid, np.full((G, K), NULL, np.int32))
                n = int(rng.integers(1, K + 1))
                arr[g, :n] = np.arange(vid, vid + n)
                vid += n
        wc = {}
        if t % 13 == 5:
            wc[int(rng.integers(0, R))] = rng.random(G) < 0.5
        _both(cj, ct, reqs=reqs, want_coord=wc, delivery=delivery)
    for t in range(12):
        _both(cj, ct)
    assert ct.checker.chosen == cj.checker.chosen
    assert ct.checker.total_committed() > 20
    ct.assert_rsm_invariant()
    np.testing.assert_array_equal(ct.exec_frontiers(), cj.exec_frontiers())
    np.testing.assert_array_equal(ct.app_hashes(), cj.app_hashes())


def test_lockstep_membership_subset_and_stop():
    cj, ct = _pair(create_all=False)
    for c in (cj, ct):
        c.create_group(0, members=[0, 1])
        c.create_group(1, members=[0, 1, 2])
        c.create_group(2, members=[1, 2])
    assert ct.coordinator_of(0) == cj.coordinator_of(0)
    arr = np.full((G, K), NULL, np.int32)
    arr[0, :2] = [10, 11]
    arr[1, :4] = [20, 21, 22 | STOP_BIT, 23]
    arr[2, 0] = 30
    reqs = {}
    for g in range(3):
        rid = ct.coordinator_of(g)
        a = reqs.setdefault(rid, np.full((G, K), NULL, np.int32))
        a[g] = arr[g]
    _both(cj, ct, reqs=reqs)
    for _ in range(6):
        _both(cj, ct)
    ct.assert_rsm_invariant()
    assert ct.checker.chosen == cj.checker.chosen
    assert ct.checker.chosen[(1, 2)] == 22 | STOP_BIT
