"""The frontier-stall heal on both packages: ``tests/test_frontier_stall_heal.py``
run on the JAX package and on the port (``device="cpu"``).

A member stranded a small distance behind the majority heals even when
the decisions it needs left every peer's window; the heal is the state
pull and the small-gap checkpoint jump (``manager.py:_apply_state_reply``,
which on the card launches ``gp_jump_rows``).  Each scenario runs once per
package on a scripted clock: after every cluster step the digest of every
engine leaf and name map of the three managers is recorded, and the two
packages' digests, app states and responses must be equal step for step;
the reference's own assertions hold on each.
"""

import numpy as np
import pytest

from torch_pkgs import JAX, TORCH, digest, scripted


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


class Run:
    """One package's ``ManagerCluster`` with every step recorded."""

    def __init__(self, pkg, clock):
        self.pkg, self.clock = pkg, clock
        cfg = pkg.mod("ops.engine").EngineConfig(n_groups=8, window=8, req_lanes=4,
                                                 n_replicas=3)
        self.cm = pkg.mod("testing.cluster")
        self.c = self.cm.ManagerCluster(cfg, pkg.mod("models.apps").HashChainApp,
                                        **pkg.dev)
        self.trace = []

    def step(self, delivery=None):
        self.clock.t += 0.01
        self.c.step_all(delivery=delivery)
        self.trace.append((digest(self.c.managers), self.apps()))

    def apps(self):
        return tuple(m.app.state.get("svc") for m in self.c.managers)

    def exec_slot(self, r, row):
        return int(np.asarray(self.c.managers[r].state.exec_slot)[row])

    def isolate(self, dead):
        d = np.full((3, 3), self.cm.DELIVER)
        d[dead, :] = self.cm.DROP
        d[:, dead] = self.cm.DROP
        return d

    def commit_two(self, delivery=None):
        done = {}
        for v in ("x1", "x2"):
            self.c.managers[0].propose(
                "svc", v, callback=lambda r, resp: done.setdefault(r, resp))
        for _ in range(40):
            if len(done) == 2:
                break
            self.step(delivery)
        assert len(done) == 2
        return sorted(done.values())


def small_gap_straggler(pkg, clock):
    run = Run(pkg, clock)
    c = run.c
    c.create("svc", members=[0, 1, 2])
    row = c.managers[0].names["svc"]
    # commit TWO slots on the majority while member 2 is isolated
    out = [run.commit_two(run.isolate(2))]
    # the live majority pause + resume in place: the decided slots BELOW
    # the frontier leave every ring
    epoch = c.managers[0].current_epoch("svc")
    for m in (c.managers[0], c.managers[1]):
        assert m.pause_group("svc", epoch, force=True) == "ok"
        assert m.resume_group("svc", epoch, [0, 1, 2], row, pending=False)
    c.blobs = [m.blob() for m in c.managers]
    # reconnect member 2: 2 slots behind (< W=8, < jump horizon); the
    # frontier-stall heal pulls it up to the majority frontier
    for _ in range(400):
        run.step()
        if run.exec_slot(2, row) >= 2 and \
                c.managers[2].app.state.get("svc") == c.managers[0].app.state.get("svc"):
            break
    h2, h0 = c.managers[2].app.state.get("svc"), c.managers[0].app.state.get("svc")
    assert h0 is not None and h2 == h0, (
        "small-gap straggler never healed", run.exec_slot(2, row), h2, h0)
    out.append(len(run.trace))
    # and new traffic keeps all three in agreement
    done2 = {}
    c.managers[0].propose("svc", "x3", callback=lambda r, resp: done2.setdefault(r, resp))
    for _ in range(40):
        if done2:
            break
        run.step()
    assert done2
    for _ in range(40):
        states = set(run.apps())
        if len(states) == 1:
            break
        run.step()
    assert len(states) == 1, states
    out.append(sorted(done2.values()))
    c.close()
    return out, run.trace


def majority_behind(pkg, clock):
    """The inverted shape: TWO members blank-rejoin at frontier 0 while ONE
    resumed member sits at frontier 2 with no below-frontier lanes; the
    detector measures against the MAX known frontier."""
    run = Run(pkg, clock)
    c = run.c
    c.create("svc", members=[0, 1, 2])
    row = c.managers[0].names["svc"]
    out = [run.commit_two()]
    epoch = c.managers[0].current_epoch("svc")
    assert c.managers[2].pause_group("svc", epoch, force=True) == "ok"
    assert c.managers[2].resume_group("svc", epoch, [0, 1, 2], row, pending=False)
    for r in (0, 1):
        m = c.managers[r]
        assert m.kill("svc")
        assert m.create_paxos_instance("svc", [0, 1, 2], row=row, version=epoch)
    c.blobs = [m.blob() for m in c.managers]
    for _ in range(400):
        run.step()
        if all(run.exec_slot(r, row) >= 2 for r in range(3)) and len(set(run.apps())) == 1:
            break
    states = set(run.apps())
    assert len(states) == 1 and None not in states, (
        "majority-behind stragglers never healed",
        [run.exec_slot(r, row) for r in range(3)], states)
    out.append(len(run.trace))
    c.close()
    return out, run.trace


@pytest.mark.parametrize("scenario", [small_gap_straggler, majority_behind],
                         ids=["small_gap_straggler_heals_after_majority_resume",
                              "majority_behind_single_ahead_member_heals"])
def test_frontier_stall_heal(monkeypatch, scenario):
    clock = scripted(monkeypatch)
    jumps = {}
    for pkg in (JAX, TORCH):
        life = pkg.mod("ops.lifecycle")

        def spy(*a, _real=life.jump_rows, _pkg=pkg, **kw):
            jumps[_pkg] = jumps.get(_pkg, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(life, "jump_rows", spy)
    t0 = clock.t
    ref_out, ref_trace = scenario(JAX, clock)
    clock.t = t0
    out, trace = scenario(TORCH, clock)
    assert out == ref_out
    # the heal is the checkpoint jump, on both
    assert jumps[TORCH] == jumps[JAX] >= 1, jumps
    assert len(trace) == len(ref_trace)
    for i, (a, b) in enumerate(zip(ref_trace, trace)):
        assert a == b, f"step {i}: leaves or app states differ"
