"""Recovery at scale on both packages (slow): ``tests/test_recovery_scale.py``
run on the JAX package and the port (``device="cpu"``).

A node hosting thousands of groups restarts, serves a hot name before
background hydration completes, holds a cold name's request until its
name hydrates, and converges.  Both packages must give the same recovery
counts, the same engine leaves after the restart and at the end, and the
same totals.  Phase and ordering facts only, never wall clock.
"""

import time

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH, assert_leaves_equal, leaves

G = 4096
N_NAMES = 2048
HOT = 64


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _ticks(m, n=6):
    for _ in range(n):
        vec, _st = m.publish_snapshot()
        m.tick_host(np.stack([vec]), np.array([True]))


def _run(pkg, d):
    Config = pkg.mod("utils.config").Config
    Config.set("RECOVERY_CHECKPOINT_SHARDS", "8")
    Config.set("RECOVERY_HOT_NAMES", str(HOT))
    Config.set("RECOVERY_REPLAY_WORKERS", "4")
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=G, window=8, req_lanes=4,
                                             n_replicas=1)
    names = [f"svc{i:05d}" for i in range(N_NAMES)]
    PaxosManager = pkg.mod("manager").PaxosManager
    Hydrator = pkg.mod("recovery.hydration").Hydrator
    make = lambda: PaxosManager(
        0, pkg.mod("models").StatefulAdderApp(), cfg, log_dir=str(d),
        checkpoint_every=10 ** 9, sync_journal=False, **pkg.dev)
    m = make()
    for lo in range(0, N_NAMES, 512):
        m.create_paxos_batch(names[lo:lo + 512], [0])
    active = names[-32:]
    for i, nm in enumerate(active):
        m.propose(nm, str(i + 1))
    _ticks(m, 10)
    m.checkpoint_now()
    m.logger.drain_checkpoints()
    m.propose(active[0], "100")
    _ticks(m, 8)
    m.close()

    # the background worker held, so "hot served while the cold backlog is
    # outstanding" is deterministic
    held = []
    orig = Hydrator.start_background
    try:
        Hydrator.start_background = lambda self: held.append(self)
        m2 = make()
    finally:
        Hydrator.start_background = orig
    out = {}
    try:
        st = m2.recovery_stats()
        out["stats"] = {k: st[k] for k in ("phase", "hydration_backlog",
                                            "hot_hydrated", "segments", "blocks",
                                            "checkpoint_generation")}
        out["restart_leaves"] = leaves(m2)
        hot_name, cold_name = active[-1], names[0]
        out["hot_is_hot"] = m2.names[hot_name] not in m2.hydrating_rows
        got = {}
        m2.propose(hot_name, "5", callback=lambda r, v: got.update(v=v))
        _ticks(m2, 8)
        out["hot_reply"], out["phase_after_hot"] = got.get("v"), m2.recovery_phase
        out["cold_is_cold"] = m2.names[cold_name] in m2.hydrating_rows
        got2 = {}
        m2.propose(cold_name, "9", callback=lambda r, v: got2.update(v=v))
        _ticks(m2, 3)
        out["cold_held"] = not got2
        out["held"] = len(held)
        held[0].start_background()
        deadline = time.time() + 120
        while m2.recovery_phase != "serving" and time.time() < deadline:
            time.sleep(0.05)
        out["phase_end"] = m2.recovery_phase
        _ticks(m2, 8)
        out["cold_reply"] = got2.get("v")
        out["totals"] = {nm: m2.app.totals.get(nm) for nm in names}
        out["end_leaves"] = leaves(m2)
        return out
    finally:
        m2.close()


@pytest.mark.slow
def test_restart_serves_hot_before_hydration_completes(tmp_path):
    got = {pkg.root: _run(pkg, tmp_path / pkg.root) for pkg in PKGS}
    a, b = got[JAX.root], got[TORCH.root]
    for k in a:
        if k.endswith("leaves"):
            assert_leaves_equal(a[k], b[k], k)
        else:
            assert a[k] == b[k], (k, a[k], b[k])
    st = b["stats"]
    assert st["phase"] == "recovering"
    assert st["hydration_backlog"] >= N_NAMES - HOT - 64 and st["hot_hydrated"] > 0
    assert b["hot_is_hot"] and b["phase_after_hot"] == "recovering"
    active = [f"svc{i:05d}" for i in range(N_NAMES)][-32:]
    expected = {nm: i + 1 for i, nm in enumerate(active)}
    expected[active[0]] += 100
    expected[active[-1]] += 5
    assert b["hot_reply"] == str(expected[active[-1]])
    assert b["cold_is_cold"] and b["cold_held"] and b["held"] >= 1
    assert b["phase_end"] == "serving" and b["cold_reply"] == "9"
    for nm, exp in expected.items():
        assert b["totals"][nm] == exp, nm
