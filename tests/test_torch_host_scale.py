"""Host-path scale on both packages: ``tests/test_host_scale.py`` run on
the JAX package and the port (``device="cpu"``).

A tick's host work must grow with activity, not with G: at G=131,072 with
a few live groups, the host side of a tick (the tick minus its engine
steps) stays under the reference's 4 us per group on the port, and hot
accessors read the host mirror instead of pulling the device on both.  Under
a dead member the majority keeps committing on both, at the same count,
with bounded payload retention.
"""

import time

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _cfg(pkg, G):
    return pkg.mod("ops.engine").EngineConfig(
        n_groups=G, window=8, req_lanes=4, n_replicas=3)


def _cluster(pkg, G):
    return pkg.mod("testing.cluster").ManagerCluster(
        _cfg(pkg, G), pkg.mod("models.apps").NoopPaxosApp, **pkg.dev)


def tick_host_cost(pkg, G, n_ticks=12, warmup=3):
    """Median host-side tick cost (the cluster tick minus the managers'
    engine steps) of idle managers with a few live groups."""
    c = _cluster(pkg, G)
    try:
        for i in range(8):
            c.create(f"g{i}", members=[0, 1, 2])
        c.run(warmup)
        costs = []
        for _ in range(n_ticks):
            t0 = time.perf_counter()
            c.step_all()
            total = time.perf_counter() - t0
            costs.append(total - sum(m.last_engine_step_s for m in c.managers))
        return sorted(costs)[len(costs) // 2]
    finally:
        c.close()


def test_idle_group_host_cost_is_array_speed():
    """Idle groups cost the port array speed on the host, not Python
    speed: under the reference's 4 us per group for the whole 3-replica
    round at G=131,072 (``tests/test_host_scale.py`` holds the JAX
    package to the same bound)."""
    per_group = tick_host_cost(TORCH, 131_072) / 131_072
    assert per_group < 4e-6, (
        f"host tick cost {per_group * 1e6:.2f} us/group at G=131k")


def _accessors(pkg):
    """Three hot accessors' answers, and the time of 10k rounds of them,
    on a G=131k manager."""
    m = pkg.mod("manager").PaxosManager(
        0, pkg.mod("models.apps").NoopPaxosApp(), _cfg(pkg, 131_072), **pkg.dev)
    try:
        m.create_paxos_instance("svc", [0, 1, 2], row=7)
        first = (m.coordinator_of_row(7), m.current_epoch("svc"), m.is_stopped("svc"))
        t0 = time.perf_counter()
        for _ in range(10_000):
            m.coordinator_of_row(7)
            m.current_epoch("svc")
            m.is_stopped("svc")
        return first, time.perf_counter() - t0
    finally:
        m.close()


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.root)
def test_accessors_do_not_transfer_per_call(pkg):
    """10k rounds of three hot accessors on a G=131k manager take well
    under a second, and answer as the JAX package's do."""
    first, dt = _accessors(pkg)
    assert first == _accessors(JAX)[0]
    assert dt < 1.0, f"{pkg}: 30k hot accessor calls took {dt:.2f} s"


def _commits(pkg, drop_member, n_rounds=60):
    c = _cluster(pkg, 8)
    try:
        c.create("svc", members=[0, 1, 2])
        delivery = np.zeros((3, 3), int)
        if drop_member is not None:
            delivery[drop_member, :] = 1
            delivery[:, drop_member] = 1
        done = {}
        live = [r for r in range(3) if r != drop_member]
        for i in range(n_rounds):
            c.submit("svc", f"v{i}", entry=live[0],
                     callback=lambda rid, r: done.setdefault(rid, r))
            c.step_all(delivery=delivery)
        c.run(10, delivery=delivery)
        return len(done), max(len(m.retained) for m in c.managers)
    finally:
        c.close()


def test_throughput_survives_lagging_member():
    """With one member's delivery cut, the majority commits at least half
    as much as the full set, with the same counts on both packages, and
    the jump-horizon write-off bounds payload retention."""
    got = {pkg.root: (_commits(pkg, None), _commits(pkg, 2)) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    (full, _), (lagged, retained) = got[TORCH.root]
    assert lagged >= 0.5 * full, (lagged, full)
    assert retained <= 8 * 8, retained
