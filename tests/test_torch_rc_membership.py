"""Runtime add/remove of reconfigurators on the port against the JAX package.

The JAX package's ``tests/test_rc_membership.py`` scenarios (a standby RC
added at runtime, a founding RC removed, an add below every member, the
driver restarting after its stop, a remove ingressing at the removed node,
and the membership guards) run on both packages' ``ReconfigurableCluster``
in lock step through the :class:`Twin` harness of
``test_torch_reconfiguration.py``: after every step the client messages,
the RC records, the app states and every engine leaf of every manager are
equal.  Each scenario ends with the reference test's own assertions, on
the port (``device="cpu"``).
"""

from gigapaxos_tpu.reconfiguration.reconfigurator import RC_GROUP
from gigapaxos_tpu_torch.reconfiguration import RCState
from test_torch_reconfiguration import _twin

def _wait_ack(t, kind, budget=400):
    body = t.wait_for(kind, max_steps=budget)
    assert body is not None, f"no {kind} within {budget} steps"
    return body


def _records_agree(t, names, members):
    for nm in names:
        views = [t.p.reconfigurators[j].rc_app.get_record(nm) for j in members]
        datas = [None if v is None else v.to_json() for v in views]
        assert all(d == datas[0] for d in datas), (nm, datas)


def _epochs(t, n):
    return [t.p.rcs.managers[j].current_epoch(RC_GROUP) for j in range(n)]


def _step_until_epochs(t, n, done, budget):
    epochs = _epochs(t, n)
    for _ in range(budget):
        t.step()
        epochs = _epochs(t, n)
        if done(epochs):
            break
    return epochs


def _membership_twin(mp, rc_members=(0, 1, 2)):
    return _twin(mp, ar=(16, 8, 4, 3), rc=(8, 8, 4, 4), rc_members=list(rc_members))


def test_add_then_remove_reconfigurator(monkeypatch):
    t = _membership_twin(monkeypatch)
    try:
        names = [f"svc{i}" for i in range(4)]
        for nm in names:
            t.client_request("create_service", {"name": nm})
            assert _wait_ack(t, "create_ack")["ok"]
        t.client_request("add_reconfigurator", {"id": 3})
        body = _wait_ack(t, "add_reconfigurator_ack")
        assert body["ok"] and body["reconfigurators"] == [0, 1, 2, 3], body
        epochs = _step_until_epochs(t, 4, lambda e: e == [1, 1, 1, 1], 200)
        assert epochs == [1, 1, 1, 1], epochs
        for _ in range(400):
            if all(t.p.reconfigurators[3].rc_app.get_record(nm) is not None
                   for nm in names):
                break
            t.step()
        _records_agree(t, names, members=[0, 1, 2, 3])
        for j in range(4):
            assert t.p.reconfigurators[j].rc_ring.nodes == [0, 1, 2, 3]

        for c in t.both():
            c.ars.managers[0].propose(names[0], "after-add")
        t.client_request("reconfigure", {"name": names[0], "new_actives": [0, 1, 2]}, rc=3)
        assert _wait_ack(t, "reconfigure_ack")["ok"]

        t.client_request("remove_reconfigurator", {"id": 0}, rc=1)
        body = _wait_ack(t, "remove_reconfigurator_ack")
        assert body["ok"] and body["reconfigurators"] == [1, 2, 3], body
        epochs = _step_until_epochs(
            t, 4, lambda e: e[0] is None and e[1:] == [2, 2, 2], 200)
        assert epochs[0] is None and epochs[1:] == [2, 2, 2], epochs
        _records_agree(t, names, members=[1, 2, 3])
        for j in range(4):
            assert t.p.reconfigurators[j].rc_ring.nodes == [1, 2, 3], j

        t.client_request("create_service", {"name": "post-remove"}, rc=0)
        assert _wait_ack(t, "create_ack")["ok"]
        rec = t.p.reconfigurators[1].rc_app.get_record("post-remove")
        assert rec is not None and rec.state is RCState.READY
        for nm in names:
            rec = t.p.reconfigurators[1].rc_app.get_record(nm)
            assert rec is not None and rec.state in (RCState.READY, RCState.PAUSED)
    finally:
        t.close()


def test_add_reconfigurator_below_all_members(monkeypatch):
    t = _membership_twin(monkeypatch, rc_members=(1, 2, 3))
    try:
        t.client_request("create_service", {"name": "low"}, rc=1)
        assert _wait_ack(t, "create_ack")["ok"]
        t.client_request("add_reconfigurator", {"id": 0}, rc=1)
        body = _wait_ack(t, "add_reconfigurator_ack")
        assert body["ok"] and body["reconfigurators"] == [0, 1, 2, 3], body
        epochs = _step_until_epochs(t, 4, lambda e: e == [1, 1, 1, 1], 200)
        assert epochs == [1, 1, 1, 1], epochs
        for _ in range(400):
            if t.p.reconfigurators[0].rc_app.get_record("low") is not None:
                break
            t.step()
        _records_agree(t, ["low"], members=[0, 1, 2, 3])
    finally:
        t.close()


def test_add_survives_driver_restart_after_stop(monkeypatch):
    t = _membership_twin(monkeypatch)
    try:
        t.client_request("create_service", {"name": "svc"}, rc=1)
        assert _wait_ack(t, "create_ack")["ok"]
        rc0s = []
        for c in t.both():
            rc0 = c.reconfigurators[0]
            orig = type(rc0)._advance_rc_transition

            def crashed_after_stop(c=c, rc0=rc0, orig=orig):
                if c.rcs.managers[0].is_stopped(RC_GROUP):
                    return
                orig(rc0)

            rc0._advance_rc_transition = crashed_after_stop
            rc0s.append(rc0)
        t.client_request("add_reconfigurator", {"id": 3}, rc=1)
        for _ in range(300):
            t.step()
            if t.p.rcs.managers[0].is_stopped(RC_GROUP):
                break
        assert t.p.rcs.managers[0].is_stopped(RC_GROUP)
        assert t.j.rcs.managers[0].is_stopped(RC_GROUP)
        for rc0 in rc0s:
            rc0._rc_final = None
            del rc0.__dict__["_advance_rc_transition"]
        body = _wait_ack(t, "add_reconfigurator_ack", budget=800)
        assert body["ok"] and body["reconfigurators"] == [0, 1, 2, 3], body
        epochs = _step_until_epochs(t, 4, lambda e: e == [1, 1, 1, 1], 300)
        assert epochs == [1, 1, 1, 1], epochs
        for _ in range(400):
            if t.p.reconfigurators[3].rc_app.get_record("svc") is not None:
                break
            t.step()
        _records_agree(t, ["svc"], members=[0, 1, 2, 3])
    finally:
        t.close()


def test_remove_reconfigurator_via_self(monkeypatch):
    t = _membership_twin(monkeypatch)
    try:
        t.client_request("remove_reconfigurator", {"id": 2}, rc=2)
        body = _wait_ack(t, "remove_reconfigurator_ack", budget=800)
        assert body["ok"] and body["reconfigurators"] == [0, 1], body
        t.client_request("add_reconfigurator", {"id": 2}, rc=2)
        body = _wait_ack(t, "add_reconfigurator_ack", budget=800)
        assert body["ok"] and body["reconfigurators"] == [0, 1, 2], body
        epochs = _step_until_epochs(t, 3, lambda e: e == [2, 2, 2], 300)
        assert epochs == [2, 2, 2], epochs
    finally:
        t.close()


def test_rc_membership_guards(monkeypatch):
    t = _membership_twin(monkeypatch)
    try:
        t.client_request("add_reconfigurator", {"id": 1})
        assert _wait_ack(t, "add_reconfigurator_ack")["ok"]
        assert t.p.rcs.managers[0].current_epoch(RC_GROUP) == 0
        for nid, expect_ok in ((0, True), (1, True), (2, False)):
            t.client_request("remove_reconfigurator", {"id": nid}, rc=2)
            body = _wait_ack(t, "remove_reconfigurator_ack", budget=800)
            assert body["ok"] is expect_ok, (nid, body)
        assert t.p.reconfigurators[2].rc_ring.nodes == [2]
    finally:
        t.close()
