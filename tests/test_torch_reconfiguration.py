"""Reconfiguration layer on the port against the JAX package, step by step.

The JAX package's reconfiguration scenarios (``tests/test_reconfiguration.py``
and ``tests/test_rc_membership.py``) run on both packages'
``ReconfigurableCluster`` in lock step: the same client operations, the
same fault injection (each cluster gets its own identically seeded drop
generator) and a scripted clock.  The clock replaces the ``time`` module
of every loaded module of both packages (the layer reads ``time.time()``
in places even when a ``now`` is passed), each step advances it by
``DT``, and each cluster keeps its own ``random`` state, seeded alike, so
node-minted request ids match.  After every step:

* the client messages of that step are equal (kind and body, in order);
* every reconfigurator's records are equal (``to_json``);
* every active's ``HashChainApp`` state and execution counts are equal;
* every engine leaf of every manager (actives and reconfigurators) is
  bit-equal, and so are the name -> row maps.

The port runs on the CPU (``device="cpu"``: its plain engine).  Each
scenario ends with the reference test's own assertions, on the port.
"""

import contextlib
import random

import numpy as np
import pytest

# imported here, not at first use, so that the scripted clock reaches
# them too (the cluster harness and the reconfigurators import them lazily)
import gigapaxos_tpu.failure_detection  # noqa: F401
import gigapaxos_tpu.reconfiguration.demand  # noqa: F401
import gigapaxos_tpu_torch.failure_detection  # noqa: F401
import gigapaxos_tpu_torch.reconfiguration.demand  # noqa: F401
from gigapaxos_tpu.models.apps import HashChainApp as JHashChain
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.reconfiguration import ConsistentHashing as JHashing
from gigapaxos_tpu.reconfiguration import ReconfigurationRecord as JRecord
from gigapaxos_tpu.reconfiguration import active_replica as j_ar
from gigapaxos_tpu.reconfiguration import reconfigurator as j_rc
from gigapaxos_tpu.testing.rc_cluster import ReconfigurableCluster as JCluster
from gigapaxos_tpu_torch.models.apps import HashChainApp as THashChain
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.reconfiguration import ConsistentHashing as THashing
from gigapaxos_tpu_torch.reconfiguration import RCState
from gigapaxos_tpu_torch.reconfiguration import ReconfigurationRecord as TRecord
from gigapaxos_tpu_torch.reconfiguration import active_replica as t_ar
from gigapaxos_tpu_torch.reconfiguration import reconfigurator as t_rc
from gigapaxos_tpu_torch.testing.clock import ScriptedClock
from gigapaxos_tpu_torch.testing.clock import patch_clocks as _patch_clocks
from gigapaxos_tpu_torch.testing.rc_cluster import ReconfigurableCluster as TCluster

DT = 0.02          # scripted seconds per cluster step
SEED = 1234        # both clusters' `random` state
PACKAGES = ("gigapaxos_tpu.", "gigapaxos_tpu_torch.")


def patch_clocks(mp, clock: ScriptedClock) -> None:
    """The same scripted clock in every loaded module of both packages."""
    _patch_clocks(mp, clock, PACKAGES)


class Twin:
    """Both packages' clusters, driven alike and compared after every
    step (module docstring)."""

    def __init__(self, mp, ar, rc, **kw):
        self.clock = ScriptedClock()
        patch_clocks(mp, self.clock)
        random.seed(SEED)
        state0 = random.getstate()
        self._rand = {}
        with self._random("j", state0):
            self.j = JCluster(JConfig(*ar), JConfig(*rc), JHashChain, **kw)
        with self._random("p", state0):
            self.p = TCluster(TConfig(*ar), TConfig(*rc), THashChain,
                              device="cpu", **kw)
        self.pending = []
        self.n_steps = 0
        self.check("boot")

    @contextlib.contextmanager
    def _random(self, who, init=None):
        saved = random.getstate()
        random.setstate(init if init is not None else self._rand[who])
        try:
            yield
        finally:
            self._rand[who] = random.getstate()
            random.setstate(saved)

    def both(self):
        """(cluster, tag) pairs, each run under its own random state."""
        for who, c in (("j", self.j), ("p", self.p)):
            with self._random(who):
                yield c

    # ---- driving --------------------------------------------------------
    def client_request(self, kind, body, rc=0):
        for c in self.both():
            c.client_request(kind, dict(body), rc=rc)

    def set_filter(self, make):
        """``make()`` builds one cluster's filter (a fresh one each, so
        seeded drop generators advance alike); None heals the network."""
        for c in self.both():
            c.msg_filter = None if make is None else make()

    def step(self):
        self.clock.t += DT
        for c in self.both():
            c.step(now=self.clock.t)
        self.n_steps += 1
        self.check(f"step {self.n_steps}")

    def run(self, n):
        for _ in range(n):
            self.step()

    def wait_for(self, kind, max_steps=60):
        """``ReconfigurableCluster.wait_for`` over the compared stream."""
        for _ in range(max_steps):
            msgs, self.pending = self.pending, []
            for k, body in msgs:
                if k == kind:
                    return body
            self.step()
        return None

    def propose(self, entry, name, values):
        """Propose ``values`` at active ``entry`` on both; returns the two
        request id -> response maps the callbacks fill."""
        done = []
        for c in self.both():
            d = {}
            done.append(d)
            mgr = c.ars.managers[entry]
            for v in values:
                mgr.propose(name, v, callback=lambda rid, resp, d=d: d.setdefault(rid, resp))
        return done

    def run_requests(self, name, values, entry):
        done = self.propose(entry, name, values)
        for _ in range(40):
            if all(len(d) == len(values) for d in done):
                break
            self.step()
        assert len(done[1]) == len(values), f"only {len(done[1])}/{len(values)} executed"
        assert sorted(done[0].values()) == sorted(done[1].values())
        return done[1]

    # ---- comparison -----------------------------------------------------
    def check(self, when):
        jm, pm = self.j.drain_client(), self.p.drain_client()
        assert jm == pm, f"{when}: client messages differ: {jm} vs {pm}"
        self.pending.extend(pm)
        for i, (a, b) in enumerate(zip(self.j.reconfigurators, self.p.reconfigurators)):
            ra = {n: r.to_json() for n, r in a.rc_app.records.items()}
            rb = {n: r.to_json() for n, r in b.rc_app.records.items()}
            assert ra == rb, f"{when}: RC{i} records differ"
        for i, (a, b) in enumerate(zip(self.j.ars.managers, self.p.ars.managers)):
            assert a.app.state == b.app.state, f"{when}: AR{i} app state"
            assert a.app.n_executed == b.app.n_executed, f"{when}: AR{i} executed"
        for role, cj, cp in (("AR", self.j.ars, self.p.ars), ("RC", self.j.rcs, self.p.rcs)):
            for i, (a, b) in enumerate(zip(cj.managers, cp.managers)):
                assert a.names == b.names, f"{when}: {role}{i} names"
                for f in a.state._fields:
                    x, y = a._np(f), b._np(f)
                    if not np.array_equal(x, y):
                        raise AssertionError(
                            f"{when}: {role}{i}.{f}: {int((x != y).sum())} words differ")

    def close(self):
        for c in self.both():
            c.close()


def _twin(mp, ar=(16, 8, 4, 3), rc=(8, 8, 4, 3), **kw):
    return Twin(mp, ar, rc, **kw)


# ---------------------------------------------------------------------------
# units, on both packages
# ---------------------------------------------------------------------------


def test_consistent_hashing_matches():
    names = [f"name{i}" for i in range(500)]
    for nodes in ([0, 1, 2, 3, 4], [0, 1, 2, 3], [2, 5, 7]):
        j, p = JHashing(nodes), THashing(nodes)
        assert [p.get_node(n) for n in names] == [j.get_node(n) for n in names]
        for n in names[:40]:
            reps = p.get_replicated_servers(n, min(3, len(nodes)))
            assert reps == j.get_replicated_servers(n, min(3, len(nodes)))
            assert len(reps) == len(set(reps))


def test_record_lifecycle_matches():
    traces = []
    for cls in (JRecord, TRecord):
        r = cls("svc", actives=[0, 1, 2], row=3)
        tr = [r.stop_done(), r.start_reconfigure([1, 2, 3], 9),
              r.start_reconfigure([1, 2, 3], 9), r.stop_done() and r.complete(),
              (r.epoch, r.actives, r.row, r.state.value), r.to_json(),
              r.start_delete() and r.finish_delete() and r.deleted, r.to_json()]
        traces.append(tr)
    assert traces[0] == traces[1]
    tr = traces[1]
    assert tr[:4] == [False, True, False, True]
    assert tr[4] == (1, [1, 2, 3], 9, RCState.READY.value) and tr[6]
    rt = TRecord.from_json(tr[7])
    assert rt.to_json() == tr[7] == JRecord.from_json(tr[7]).to_json()


# ---------------------------------------------------------------------------
# test_reconfiguration.py's integration scenarios
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin():
    mp = pytest.MonkeyPatch()
    t = Twin(mp, (32, 8, 4, 4), (8, 8, 4, 3))
    yield t
    t.close()
    mp.undo()


def test_create_request_migrate_delete(twin):
    t = twin
    t.client_request("create_service", {
        "name": "svc", "actives": [0, 1, 2], "initial_state": None,
    }, rc=0)
    ack = t.wait_for("create_ack")
    assert ack and ack["ok"], ack
    assert sorted(ack["actives"]) == [0, 1, 2] and ack["epoch"] == 0

    t.client_request("request_actives", {"name": "svc"}, rc=1)
    resp = t.wait_for("actives_response")
    assert resp["ok"] and sorted(resp["actives"]) == [0, 1, 2]

    t.run_requests("svc", [f"r{i}" for i in range(5)], entry=0)
    apps = [t.p.ars.managers[i].app for i in range(4)]
    h0 = apps[0].state["svc"]
    assert apps[1].state["svc"] == h0 and apps[2].state["svc"] == h0
    assert "svc" not in apps[3].state

    t.client_request("reconfigure", {"name": "svc", "new_actives": [1, 2, 3]})
    ack = t.wait_for("reconfigure_ack", max_steps=120)
    assert ack and ack["ok"], ack
    assert sorted(ack["actives"]) == [1, 2, 3] and ack["epoch"] == 1
    t.run(30)
    n1 = apps[1].n_executed["svc"]
    assert apps[3].state["svc"] == apps[1].state["svc"] == apps[2].state["svc"]
    assert t.p.ars.managers[0].names.get("svc") is None
    assert t.p.ars.managers[1].old_epochs == {}

    t.run_requests("svc", [f"s{i}" for i in range(4)], entry=1)
    assert apps[1].n_executed["svc"] == n1 + 4
    assert apps[3].state["svc"] == apps[1].state["svc"]

    t.client_request("delete_service", {"name": "svc"})
    ack = t.wait_for("delete_ack", max_steps=120)
    assert ack and ack["ok"], ack
    t.run(5)
    for i in (1, 2, 3):
        assert t.p.ars.managers[i].names.get("svc") is None
    for rc in t.p.reconfigurators:
        assert rc.rc_app.get_record("svc") is None

    t.client_request("create_service", {"name": "svc", "actives": [0, 2, 3]})
    ack = t.wait_for("create_ack", max_steps=120)
    assert ack and ack["ok"] and sorted(ack["actives"]) == [0, 2, 3]


def test_create_duplicate_rejected(twin):
    t = twin
    t.client_request("create_service", {"name": "dup"})
    ack = t.wait_for("create_ack", max_steps=120)
    assert ack and ack["ok"]
    t.client_request("create_service", {"name": "dup"})
    ack2 = t.wait_for("create_ack", max_steps=120)
    assert ack2 and not ack2["ok"] and ack2["reason"] == "exists"


def test_reconfigure_unknown_name_rejected(twin):
    t = twin
    t.client_request("reconfigure", {"name": "ghost", "new_actives": [0, 1, 2]})
    ack = t.wait_for("reconfigure_ack", max_steps=60)
    assert ack and not ack["ok"]


def test_stale_stop_epoch_cannot_stop_live_epoch(twin):
    t = twin
    t.client_request("create_service", {"name": "stale", "actives": [0, 1, 2]})
    ack = t.wait_for("create_ack", max_steps=120)
    assert ack and ack["ok"]
    t.client_request("reconfigure", {"name": "stale", "new_actives": [1, 2, 3]})
    ack = t.wait_for("reconfigure_ack", max_steps=120)
    assert ack and ack["ok"] and ack["epoch"] == 1
    t.run(10)
    for c in t.both():
        c.active_replicas[1].handle_message(
            "stop_epoch", {"name": "stale", "epoch": 0, "rc": ["RC", 0]}
        )
    t.run(10)
    assert not t.p.ars.managers[1].is_stopped("stale"), "stale stop wedged the live epoch"
    t.run_requests("stale", ["x", "y"], entry=1)


def _set_class_attrs(mp, attrs):
    """The same class-attribute override on both packages' classes."""
    for (j_cls, t_cls), name, value in attrs:
        mp.setattr(j_cls, name, value)
        mp.setattr(t_cls, name, value)


def test_delete_completes_with_dead_active(monkeypatch):
    _set_class_attrs(monkeypatch, [
        ((j_rc.DropEpochTask, t_rc.DropEpochTask), "max_lifetime_s", 0.3),
        ((j_rc.DropEpochTask, t_rc.DropEpochTask), "restart_period_s", 0.05),
    ])
    t = _twin(monkeypatch)
    try:
        t.client_request("create_service", {"name": "dd", "actives": [0, 1, 2]})
        ack = t.wait_for("create_ack", max_steps=120)
        assert ack and ack["ok"]
        t.set_filter(lambda: (lambda dst, kind, body: dst != ("AR", 2)))
        t.client_request("delete_service", {"name": "dd"})
        ack = t.wait_for("delete_ack", max_steps=300)
        assert ack and ack["ok"], ack
        for rc in t.p.reconfigurators:
            assert rc.rc_app.get_record("dd") is None
    finally:
        t.close()


def test_laggard_active_gets_late_start(monkeypatch):
    _set_class_attrs(monkeypatch, [
        ((j_rc.LateStartTask, t_rc.LateStartTask), "restart_period_s", 0.02),
    ])
    t = _twin(monkeypatch)
    try:
        t.set_filter(lambda: (
            lambda dst, kind, body: not (dst == ("AR", 2) and kind == "start_epoch")))
        t.client_request("create_service", {"name": "lag", "actives": [0, 1, 2]})
        ack = t.wait_for("create_ack", max_steps=120)
        assert ack and ack["ok"]
        assert t.p.ars.managers[2].names.get("lag") is None
        t.set_filter(None)
        for _ in range(60):
            if t.p.ars.managers[2].names.get("lag") is not None:
                break
            t.step()
        assert t.p.ars.managers[2].names.get("lag") is not None, \
            "laggard never received the late start_epoch"
        t.run_requests("lag", ["p", "q"], entry=2)
    finally:
        t.close()


def test_migration_survives_lossy_control_plane(monkeypatch):
    _set_class_attrs(monkeypatch, [
        ((j_cls, t_cls), "restart_period_s", 0.02)
        for j_cls, t_cls in (
            (j_rc.StartEpochTask, t_rc.StartEpochTask),
            (j_rc.StopEpochTask, t_rc.StopEpochTask),
            (j_rc.DropEpochTask, t_rc.DropEpochTask),
            (j_rc.EpochCommitTask, t_rc.EpochCommitTask),
            (j_rc.LateStartTask, t_rc.LateStartTask),
            (j_ar.WaitEpochFinalState, t_ar.WaitEpochFinalState),
        )
    ])
    t = _twin(monkeypatch, ar=(16, 8, 4, 4))
    try:
        for c in t.both():
            for rc in c.reconfigurators:
                rc.echo_probe_period_s = 0.0

        def lossy():
            rng = np.random.RandomState(7)
            return lambda dst, kind, body: rng.rand() > 0.3

        t.set_filter(lossy)

        def request_with_retry(kind, body, ack_kind, tries=8, max_steps=60):
            for _ in range(tries):
                t.client_request(kind, dict(body))
                ack = t.wait_for(ack_kind, max_steps=max_steps)
                if ack is not None:
                    return ack
            return None

        ack = request_with_retry(
            "create_service", {"name": "lossy", "actives": [0, 1, 2]}, "create_ack")
        assert ack and ack["ok"], ack
        t.run_requests("lossy", ["a", "b", "c"], entry=1)
        ack = request_with_retry(
            "reconfigure", {"name": "lossy", "new_actives": [1, 2, 3]},
            "reconfigure_ack", max_steps=100)
        assert ack and ack["ok"], ack
        t.run(20)
        apps = [m.app for m in t.p.ars.managers]
        assert apps[3].state["lossy"] == apps[1].state["lossy"]
    finally:
        t.close()


def test_pause_sweep_suggests_pauses_after_a_deactivation_period(monkeypatch):
    """The port's active replica runs its pause sweep once a deactivation
    period has passed and suggests the idle name for a pause (the JAX
    package's sweep raises NameError there: ``Config`` and ``PC`` are
    imported only inside ``ActiveReplica.__init__``; the port imports them
    at module level, a recorded divergence)."""
    from gigapaxos_tpu_torch.paxos_config import PC
    from gigapaxos_tpu_torch.utils.config import Config

    clock = ScriptedClock()
    patch_clocks(monkeypatch, clock)
    c = TCluster(TConfig(16, 8, 4, 3), TConfig(8, 8, 4, 3), THashChain, device="cpu")
    try:
        c.client_request("create_service", {"name": "cold", "actives": [0, 1, 2]})
        for _ in range(120):
            clock.t += DT
            c.step(now=clock.t)
            if any(k == "create_ack" and b["ok"] for k, b in c.drain_client()):
                break
        else:
            raise AssertionError("no create_ack")
        for _ in range(20):   # the epoch commit releases the new rows
            clock.t += DT
            c.step(now=clock.t)
        sent = []
        ar = c.active_replicas[0]
        ar.send = lambda dst, kind, body: sent.append((tuple(dst), kind, body))
        clock.t += 3 * Config.get_float(PC.DEACTIVATION_PERIOD_S)
        ar.tick(clock.t)
        pauses = [b for _d, k, b in sent if k == "suggest_pause"]
        assert [(b["name"], b["from"]) for b in pauses] == [("cold", 0)], sent
    finally:
        c.close()


def test_delete_frees_a_member_that_lags_behind_the_stop(monkeypatch):
    """A member cut off from consensus while a delete stops the epoch never
    executes the stop; its peers drop their rows on the reconfigurator's
    drop.  The port frees the laggard's row on that drop too (a majority
    executed the stop, so the epoch is final) and the delete's drop round
    completes with every member's ack; the JAX package's active replica
    stays silent and keeps the row (a recorded divergence)."""
    from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP

    clock = ScriptedClock()
    patch_clocks(monkeypatch, clock)
    c = TCluster(TConfig(16, 8, 4, 3), TConfig(8, 8, 4, 3), THashChain, device="cpu")

    def step():
        clock.t += DT
        c.step(now=clock.t)
        return c.drain_client()

    def wait_for(kind, budget=200):
        for _ in range(budget):
            for k, b in step():
                if k == kind:
                    return b
        return None

    try:
        c.client_request("create_service", {"name": "lag", "actives": [0, 1, 2]})
        assert (wait_for("create_ack") or {}).get("ok")
        for _ in range(20):
            step()
        # AR2's engine hears no peer (and no peer hears it) from here on
        cut = np.full((3, 3), DELIVER)
        cut[2, :] = DROP
        cut[:, 2] = DROP
        cut[2, 2] = DELIVER
        step_all = c.ars.step_all
        monkeypatch.setattr(c.ars, "step_all", lambda: step_all(delivery=cut))
        c.client_request("delete_service", {"name": "lag"})
        ack = wait_for("delete_ack")
        assert ack and ack["ok"], ack
        for _ in range(5):
            step()
        for i in range(3):
            assert c.ars.managers[i].names.get("lag") is None, i
        for rc in c.reconfigurators:
            assert rc.rc_app.get_record("lag") is None
    finally:
        c.close()
