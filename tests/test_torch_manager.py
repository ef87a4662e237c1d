"""Manager parity: ManagerCluster on both packages, the same submits.

Three full PaxosManagers per package (engine + logger + app + callbacks),
stepped in lock step under the same seeded delivery schedule with the
same client submits at the same entry replicas: after every tick every
engine leaf of every manager is equal (so the decided vids are), and at
the end the app states, the responses handed to callbacks and the app
cursors are equal.  A durable variant crash-restarts one member from its
journal and checkpoints on both packages and requires the same again.
"""

import numpy as np
import pytest

from gigapaxos_tpu.models import StatefulAdderApp as JAdder
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.testing.cluster import ManagerCluster as JCluster
from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.models import StatefulAdderApp as TAdder
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP
from gigapaxos_tpu_torch.testing.cluster import ManagerCluster as TCluster
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

G, W, K, R = 6, 8, 4, 3
NAMES = ["acct", "svc", "zed"]


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def _clusters(tmp_path=None):
    kw = {}
    kw_t = {}
    if tmp_path is not None:
        kw = dict(log_dirs=[str(tmp_path / f"jax{i}") for i in range(R)],
                  checkpoint_every=5)
        kw_t = dict(log_dirs=[str(tmp_path / f"torch{i}") for i in range(R)],
                    checkpoint_every=5)
    cj = JCluster(JConfig(G, W, K, R), JAdder, **kw)
    ct = TCluster(TConfig(G, W, K, R), TAdder, device="cpu", **kw_t)
    for nm in NAMES:
        assert cj.create(nm) == ct.create(nm)
    return cj, ct


def _assert_same(cj, ct, what):
    for i, (mj, mt) in enumerate(zip(cj.managers, ct.managers)):
        for leaf in mj.state._fields:
            np.testing.assert_array_equal(
                mj._np(leaf), mt._np(leaf), err_msg=f"{what} mgr{i}.{leaf}"
            )
        assert mj.app.totals == mt.app.totals, (what, i)
        np.testing.assert_array_equal(mj.app_exec_slot, mt.app_exec_slot)


def _drive(cj, ct, rng, steps, log_j, log_t):
    for t in range(steps):
        delivery = np.where(rng.random((R, R)) < 0.2, DROP, DELIVER)
        for _ in range(int(rng.integers(0, 3))):
            nm = NAMES[int(rng.integers(0, len(NAMES)))]
            v = str(int(rng.integers(1, 50)))
            e = int(rng.integers(0, R))
            rj = cj.submit(nm, v, entry=e,
                           callback=lambda rid, resp: log_j.append(resp))
            rt = ct.submit(nm, v, entry=e,
                           callback=lambda rid, resp: log_t.append(resp))
            assert (rj is None) == (rt is None)
        cj.step_all(delivery=delivery)
        ct.step_all(delivery=delivery)
        _assert_same(cj, ct, f"t={t}")


def test_manager_cluster_parity():
    cj, ct = _clusters()
    rng = np.random.default_rng(11)
    log_j, log_t = [], []
    try:
        _drive(cj, ct, rng, 30, log_j, log_t)
        cj.run(10)
        ct.run(10)
        _assert_same(cj, ct, "settled")
        assert log_j == log_t and len(log_t) > 10
        totals = [m.app.totals for m in ct.managers]
        assert totals == [totals[0]] * R
    finally:
        cj.close()
        ct.close()


def test_manager_cluster_parity_crash_restart(tmp_path):
    cj, ct = _clusters(tmp_path)
    rng = np.random.default_rng(5)
    log_j, log_t = [], []
    try:
        _drive(cj, ct, rng, 15, log_j, log_t)
        cj.restart(1)
        ct.restart(1)
        _assert_same(cj, ct, "restarted")
        _drive(cj, ct, rng, 10, log_j, log_t)
        cj.run(10)
        ct.run(10)
        _assert_same(cj, ct, "settled")
        assert log_j == log_t and len(log_t) > 5
    finally:
        cj.close()
        ct.close()
        JaxConfig.clear()
