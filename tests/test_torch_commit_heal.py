"""The epoch-commit round's truthful ack and its RESUME heal on both
packages: ``tests/test_commit_heal.py`` run on the JAX package and on the
port (``device="cpu"``).

* The ack matrix and the heal shapes run once per package: the acks (kind,
  body, in order), the name -> row maps, the pending rows, the held
  queues, the app totals and every engine leaf are equal across the two,
  and the reference's own assertions hold on each.
* The READY audit heals a member that lost its row after the commit round:
  both packages' ``ReconfigurableCluster``s in lock step on a scripted
  clock (``tests/test_torch_reconfiguration.py``'s ``Twin``, which compares
  client messages, records, app states and every leaf after every step).
"""

import pytest

from test_torch_reconfiguration import Twin
from torch_pkgs import JAX, PKGS, TORCH, assert_leaves_equal, leaves, set_leaf


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def make_ar(pkg):
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=8, window=8, req_lanes=4,
                                             n_replicas=3)
    mgr = pkg.mod("manager").PaxosManager(0, pkg.mod("models.apps").StatefulAdderApp(),
                                          cfg, **pkg.dev)
    coord = pkg.mod("reconfiguration.coordinator").PaxosReplicaCoordinator(mgr.app, mgr)
    sent = []
    ar = pkg.mod("reconfiguration.active_replica").ActiveReplica(
        0, coord, lambda dst, kind, body: sent.append((dst, kind, body)))
    return ar, mgr, sent


def commit(ar, name, epoch, row) -> None:
    ar.handle_message("epoch_commit", {
        "name": name, "epoch": epoch, "row": row, "rc": ["RC", 0],
    })


def last_ack(sent):
    kind_bodies = [(k, b) for (_d, k, b) in sent if k == "ack_epoch_commit"]
    assert kind_bodies, "no ack sent"
    return kind_bodies[-1][1]


def _snapshot(mgr, sent):
    return {
        "sent": list(sent), "names": dict(mgr.names),
        "pending": sorted(mgr.pending_rows), "paused": sorted(mgr.paused),
        "queues": {r: list(q) for r, q in mgr.queues.items() if q},
        "totals": dict(mgr.app.totals), "leaves": leaves(mgr),
    }


def _assert_same(a, b):
    assert_leaves_equal(a.pop("leaves"), b.pop("leaves"), "engine")
    assert a == b


def ack_matrix(pkg):
    ar, mgr, sent = make_ar(pkg)
    # live at the winning row, pending -> ok + unpended
    mgr.create_paxos_instance("a", [0, 1, 2], row=3, pending=True)
    commit(ar, "a", 0, 3)
    assert last_ack(sent)["ok"] and 3 not in mgr.pending_rows
    # losing pending row (commit names row 6, we hold row 4) -> missing
    mgr.create_paxos_instance("b", [0, 1, 2], row=4, pending=True)
    commit(ar, "b", 0, 6)
    ack = last_ack(sent)
    assert not ack["ok"] and ack["reason"] == "missing"
    assert 4 in mgr.pending_rows  # the losing row must stay gated
    # not hosting at all -> missing
    commit(ar, "ghost", 0, 7)
    ack = last_ack(sent)
    assert not ack["ok"] and ack["reason"] == "missing"
    # paused -> missing (the member needs a resume, not a silent ok)
    mgr.create_paxos_instance("c", [0, 1, 2], row=5)
    assert mgr.pause_group("c", 0) == "ok"
    commit(ar, "c", 0, 5)
    ack = last_ack(sent)
    assert not ack["ok"] and ack["reason"] == "missing"
    # historic round for a superseded epoch -> ok (nothing to confirm)
    mgr.create_paxos_instance("d", [0, 1, 2], row=6)
    mgr.propose_stop("d")
    # simulate the stop having executed so the epoch can move on
    st = mgr.state
    mgr.state = st._replace(stopped=set_leaf(pkg, st.stopped, 6, 1))
    mgr.create_paxos_instance("d", [0, 1, 2], row=7, version=1)
    commit(ar, "d", 0, 6)
    assert last_ack(sent)["ok"]
    return _snapshot(mgr, sent)


def test_ack_matrix():
    _assert_same(ack_matrix(JAX), ack_matrix(TORCH))


def resume_heal_shapes(pkg):
    """The committed resume start heals each missing shape."""
    ar, mgr, sent = make_ar(pkg)

    def heal(name, epoch, row, initial=None):
        ar.handle_message("start_epoch", {
            "name": name, "epoch": epoch, "actives": [0, 1, 2], "row": row,
            "initial_state": initial, "prev_actives": [], "prev_epoch": -1,
            "resume": True, "committed": True, "rc": ["RC", 0],
        })

    # losing pending row -> re-homed to the winning row, unpended, queue kept
    mgr.create_paxos_instance("x", [0, 1, 2], row=1, pending=True)
    mgr.propose("x", "5")
    heal("x", 0, 2)
    assert mgr.names["x"] == 2 and 2 not in mgr.pending_rows
    assert mgr.queues.get(2), "held queue lost in the re-home"
    # paused -> restored at the new row with its state
    mgr.create_paxos_instance("y", [0, 1, 2], row=3)
    assert mgr.pause_group("y", 0) == "ok"
    heal("y", 0, 4)
    assert mgr.names["y"] == 4 and ("y", 0) not in mgr.paused
    # nothing at all -> empty join with the birth state
    heal("z", 0, 5, initial="7")
    assert mgr.names["z"] == 5
    assert mgr.app.totals.get("z") == 7  # StatefulAdder restore("7")
    # after healing, the commit retransmit acks ok
    for nm, row in (("x", 2), ("y", 4), ("z", 5)):
        commit(ar, nm, 0, row)
        assert last_ack(sent)["ok"], nm
    return _snapshot(mgr, sent)


def test_resume_heal_shapes():
    _assert_same(resume_heal_shapes(JAX), resume_heal_shapes(TORCH))


def test_ready_audit_heals_post_commit_row_loss(monkeypatch):
    """Chaos-sweep find: a member can lose its row AFTER the epoch's commit
    round completed; the slow READY audit re-runs the idempotent commit
    round and its missing-NACK drives the committed resume that re-joins
    the member.  Both packages in lock step, compared every step."""
    t = Twin(monkeypatch, (16, 8, 4, 3), (8, 8, 4, 3))
    try:
        for c in (t.j, t.p):
            for rc in c.reconfigurators:
                rc.REDRIVE_EVERY = 4
                rc.ready_audit_period_s = 0.3  # fast audit for the test
            for ar in c.active_replicas:
                ar.pause_option = False
        t.client_request("create_service", {"name": "pl", "actives": [0, 1, 2]})
        ack = t.wait_for("create_ack", max_steps=200)
        assert ack and ack["ok"], ack
        t.run_requests("pl", ["w"], entry=0)

        # post-commit row loss on member 2: no pause record, no pending
        # row — only the audit can see it
        for c in t.both():
            m2 = c.ars.managers[2]
            assert m2.kill("pl")
            assert m2.names.get("pl") is None
        t.check("after the kill")
        steps = 0
        while t.p.ars.managers[2].names.get("pl") is None and steps < 3000:
            t.step()
            steps += 1
        assert t.p.ars.managers[2].names.get("pl") is not None, "audit never re-healed"
        # the audit fired on the scripted clock, not at once
        assert steps * 0.02 >= 0.3, steps
        # and the healed member converges to the group state
        for _ in range(3000):
            states = {m.app.state.get("pl") for m in t.p.ars.managers}
            if len(states) == 1:
                break
            t.step()
        assert len(states) == 1, states
    finally:
        t.close()


@pytest.mark.parametrize("pkg", PKGS, ids=str)
def test_commit_for_a_stale_epoch_of_a_live_name_acks_ok(pkg):
    """A commit round for an epoch below the one a member runs is history:
    the member acks ok and its row, pending state and leaves are left as
    they were, on both packages."""
    ar, mgr, sent = make_ar(pkg)
    mgr.create_paxos_instance("e", [0, 1, 2], row=2, version=3)
    before = leaves(mgr)
    commit(ar, "e", 1, 2)
    assert last_ack(sent)["ok"]
    assert mgr.names["e"] == 2 and 2 not in mgr.pending_rows
    assert_leaves_equal(before, leaves(mgr), "stale commit")
