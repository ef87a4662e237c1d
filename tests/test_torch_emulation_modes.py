"""EMULATE_UNREPLICATED and LAZY_PROPAGATION (``PaxosManager.java:1731-1778``)
on both packages, the counterpart of ``tests/test_emulation_modes.py``:
the same scenarios on the JAX package's and the port's ``ManagerCluster``
(the port on the CPU), with the reference test's assertions on each and
the same responses, execution counts and app states on both."""

import pytest

from torch_pkgs import JAX, TORCH


def _cluster(pkg):
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=8, window=8, req_lanes=4,
                                              n_replicas=3)
    return pkg.mod("testing.cluster").ManagerCluster(
        cfg, pkg.mod("models.apps").HashChainApp, **pkg.dev)


def _unreplicated(pkg):
    Config = pkg.mod("utils.config").Config
    Config.set("EMULATE_UNREPLICATED", "true")
    try:
        c = _cluster(pkg)
        c.create("u", members=[0, 1, 2])
        done = {}
        for i in range(10):
            c.submit("u", f"v{i}", entry=0,
                     callback=lambda rid, r: done.setdefault(rid, r))
        # no cluster tick ran: the responses are already there
        assert len(done) == 10
        assert all(r is not None for r in done.values())
        assert c.managers[0].app.n_executed.get("u") == 10
        # peers never executed anything (consensus bypassed)
        assert c.managers[1].app.n_executed.get("u") is None
        # a retransmitted id answers from the cache without re-execution
        rid = next(iter(done))
        got = []
        c.managers[0].propose("u", "dup", request_id=rid,
                              callback=lambda r, resp: got.append(resp))
        assert got == [done[rid]]
        assert c.managers[0].app.n_executed.get("u") == 10
        out = (sorted(done.values()), got,
               [m.app.n_executed.get("u") for m in c.managers],
               [m.app.checkpoint("u") for m in c.managers])
        c.close()
        return out
    finally:
        Config.clear()


def _lazy(pkg):
    Config = pkg.mod("utils.config").Config
    Config.set("LAZY_PROPAGATION", "true")
    try:
        c = _cluster(pkg)
        c.create("l", members=[0, 1, 2])
        done = {}
        for i in range(8):
            c.submit("l", f"v{i}", entry=0,
                     callback=lambda rid, r: done.setdefault(rid, r))
        assert len(done) == 8  # answered before any tick
        c.run(15)  # ...but the proposals still flow through the group
        counts = [m.app.n_executed.get("l") for m in c.managers]
        # peers executed every request through consensus; the entry's
        # early executions were deduped at commit time
        assert counts == [8, 8, 8], counts
        out = (sorted(done.values()), counts,
               [m.app.checkpoint("l") for m in c.managers])
        c.close()
        return out
    finally:
        Config.clear()


@pytest.mark.parametrize("scenario", [_unreplicated, _lazy],
                         ids=["emulate_unreplicated", "lazy_propagation"])
def test_emulation_mode_matches_the_reference(scenario):
    assert scenario(TORCH) == scenario(JAX)
