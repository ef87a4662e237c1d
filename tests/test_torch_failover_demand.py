"""RC primary failover and demand-driven reconfiguration on both packages:
``tests/test_failover_demand.py`` run on the JAX package and on the port
(``device="cpu"``).

The cluster scenarios run both packages' ``ReconfigurableCluster``s in
lock step on a scripted clock (``tests/test_torch_reconfiguration.py``'s
``Twin``: client messages, records, app states and every engine leaf
compared after every step), the same faults injected into both; the
reference's wall-clock deadlines become step budgets of the same scripted
seconds.  The demand profiles are each package's own classes.  The units
(the default profile, the failure detector's election, the proximity
profile without a region map) run on both and give equal answers.
"""

import numpy as np
import pytest

from test_torch_reconfiguration import DT, Twin
from torch_pkgs import PKGS


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


def make_twin(mp, kw_of=None, ar=(16, 8, 4, 4), rc=(8, 8, 4, 3)):
    """The ``Twin`` at the reference test's shapes (actives G=16, W=8,
    K=4, R=4; reconfigurators G=8, W=8, K=4, R=3) by default."""
    return Twin(mp, ar, rc, kw_of=kw_of)


def create(t, name, actives):
    t.client_request("create_service", {"name": name, "actives": actives})
    ack = t.wait_for("create_ack", max_steps=120)
    assert ack and ack["ok"], ack


def steps_for(seconds):
    return int(seconds / DT)


def _serve_after(t, entry, name, value, max_steps=240):
    """Propose ``value`` at ``entry`` each step (both packages) until it
    is answered; returns the port's responses."""
    done = [{}, {}]
    for _ in range(max_steps):
        if done[1]:
            break
        for d, c in zip(done, t.both()):
            c.ars.managers[entry].propose(
                name, value, callback=lambda rid, r, d=d: d.setdefault(rid, r))
        t.step()
    assert sorted(done[0].values()) == sorted(done[1].values())
    return done[1]


def test_secondary_rc_completes_migration_after_primary_death(monkeypatch):
    """Kill the record's primary RC mid-migration: a secondary adopts the
    re-drive and the migration completes (WaitPrimaryExecution.java:60)."""
    t = make_twin(monkeypatch)
    try:
        for c in (t.j, t.p):
            for rc in c.reconfigurators:
                rc.REDRIVE_EVERY = 4
        create(t, "ha", [0, 1, 2])
        primary = t.p.reconfigurators[0].primary_of("ha")
        assert primary == t.j.reconfigurators[0].primary_of("ha")
        t.client_request("reconfigure", {"name": "ha", "new_actives": [1, 2, 3]},
                         rc=primary)
        t.run(3)
        for c in (t.j, t.p):
            c.dead_rcs.add(primary)
            c.msg_filter = lambda dst, kind, body: dst != ("RC", primary)
            dead_layer = c.reconfigurators[primary]
            monkeypatch.setattr(dead_layer, "tick", lambda now=None: None)
            monkeypatch.setattr(dead_layer, "handle_message", lambda *a, **k: None)
        rec = None
        for _ in range(steps_for(30)):
            t.step()
            rec = t.p.reconfigurators[(primary + 1) % 3].rc_app.get_record("ha")
            if rec is not None and rec.state.value == "READY" \
                    and sorted(rec.actives) == [1, 2, 3]:
                break
        assert rec is not None and rec.state.value == "READY", rec
        assert sorted(rec.actives) == [1, 2, 3]
        assert _serve_after(t, 1, "ha", "post-failover"), \
            "migrated group does not serve after RC failover"
    finally:
        t.close()


def hot_spot(pkg):
    """The reference test's policy on ``pkg``'s ``AbstractDemandProfile``:
    once cumulative demand crosses a threshold, migrate to the target."""
    base = pkg.mod("reconfiguration.demand").AbstractDemandProfile

    class HotSpotProfile(base):
        THRESHOLD = 12
        TARGET = [1, 2, 3]

        def __init__(self, name):
            super().__init__(name)
            self.total = 0

        def combine(self, report):
            self.total += int(report.get("count", 0))

        def reconfigure(self, cur_actives, all_actives):
            if self.total >= self.THRESHOLD:
                return [a for a in self.TARGET if a in all_actives]
            return None

        def just_reconfigured(self):
            self.total = 0

    return HotSpotProfile


def _load_until(t, name, entry, done_when, seconds=40):
    """One proposal a step at ``entry`` on both until ``done_when(record)``
    holds on the port's primary-0 record view; returns that record."""
    rec, i = None, 0
    for _ in range(steps_for(seconds)):
        i += 1
        for c in t.both():
            c.ars.managers[entry].propose(name, f"v{i}")
        t.step()
        rec = t.p.reconfigurators[0].rc_app.get_record(name)
        if done_when(rec):
            break
    return rec


def test_demand_report_drives_auto_migration(monkeypatch):
    """Sustained load auto-migrates a name through the demand pipeline
    (Reconfigurator.java:311, AbstractDemandProfile.java:103-149)."""
    t = make_twin(monkeypatch, lambda pkg: {"demand_profile_cls": hot_spot(pkg)})
    try:
        for c in (t.j, t.p):
            for ar in c.active_replicas:
                ar.demand_report_period_s = 0.05
        create(t, "hot", [0, 1, 2])
        rec = _load_until(t, "hot", 0, lambda r: r.state.value == "READY"
                          and sorted(r.actives) == [1, 2, 3])
        assert rec is not None and sorted(rec.actives) == [1, 2, 3], \
            f"demand did not migrate: {rec and rec.to_json()}"
        assert rec.epoch == 1
    finally:
        t.close()


@pytest.mark.parametrize("pkg", PKGS, ids=str)
def test_default_profile_measures_but_never_migrates(pkg):
    demand = pkg.mod("reconfiguration.demand")
    prof = demand.DemandProfile("x")
    prof.combine({"count": 1000, "from": 0})
    assert prof.num_requests == 1000
    assert prof.reconfigure([0, 1, 2], [0, 1, 2, 3]) is None
    profiler = demand.AggregateDemandProfiler(demand.DemandProfile)
    p = profiler.combine("x", {"count": 5, "from": 1})
    assert p.num_requests == 5


def test_elastic_membership_remove_and_add_active(monkeypatch):
    """Remove an active at runtime: the set shrinks, rings refresh, the
    removed node's groups migrate off it (Reconfigurator.java:1023-1075);
    re-adding restores the pool."""
    t = make_twin(monkeypatch)
    try:
        for c in (t.j, t.p):
            for rc in c.reconfigurators:
                rc.REDRIVE_EVERY = 4
        create(t, "el", [0, 1, 2])
        t.run_requests("el", [f"v{i}" for i in range(3)], entry=0)

        t.client_request("remove_active", {"id": 0})
        ack = t.wait_for("remove_active_ack", max_steps=120)
        assert ack and ack["ok"], ack
        assert 0 not in ack["actives"]
        rec = None
        for _ in range(steps_for(30)):
            t.step()
            rec = t.p.reconfigurators[0].rc_app.get_record("el")
            if rec.state.value == "READY" and 0 not in rec.actives \
                    and len(rec.actives) == 3:
                break
        assert rec is not None and 0 not in rec.actives, rec.to_json()
        assert sorted(rec.actives) == [1, 2, 3]
        for _ in range(steps_for(20)):
            if t.p.ars.managers[0].names.get("el") is None:
                break
            t.step()
        assert t.p.ars.managers[0].names.get("el") is None
        assert _serve_after(t, 1, "el", "after"), \
            "group does not serve after membership removal"
        assert t.p.ars.managers[1].app.n_executed["el"] >= 4

        t.client_request("add_active", {"id": 0})
        ack = t.wait_for("add_active_ack", max_steps=120)
        assert ack and ack["ok"] and 0 in ack["actives"], ack
        t.client_request("reconfigure", {"name": "el", "new_actives": [0, 1, 2]})
        ack = t.wait_for("reconfigure_ack", max_steps=200)
        assert ack and ack["ok"], ack
    finally:
        t.close()


def test_election_fires_for_alive_nonmember_coordinator():
    """An ALIVE coordinator that is no longer a member counts as dead (any
    member may run); a member coordinator that is up triggers nothing."""
    wants = []
    for pkg in PKGS:
        FailureDetector = pkg.mod("failure_detection").FailureDetector
        encode_ballot = pkg.mod("ops.ballot").encode_ballot
        bal = np.array([int(encode_ballot(5, 2))])  # coordinator = node 2
        mask = np.array([0b011])                    # members {0, 1} only
        got = []
        for me, expect in ((0, True), (1, True), (2, False)):
            want = FailureDetector(me, [0, 1, 2]).want_coord(bal, mask, 3)
            assert bool(want[0]) is expect, (pkg, me, want)
            got.append(np.asarray(want).tolist())
        bal_ok = np.array([int(encode_ballot(5, 1))])
        assert not FailureDetector(0, [0, 1, 2]).want_coord(bal_ok, mask, 3).any()
        wants.append(got)
    assert wants[0] == wants[1]


def test_proximity_profile_migrates_toward_demand_region(monkeypatch):
    """GeoIP-profile analog: one entry active sourcing the dominant share
    pulls the name onto its region (the fork's GeoIpDemandProfile.java)."""
    for pkg in PKGS:
        cfg = pkg.mod("utils.config").Config
        for a, region in enumerate(("east", "east", "west", "west")):
            cfg.set(f"REGION.{a}", region)
    t = make_twin(monkeypatch, lambda pkg: {
        "demand_profile_cls": pkg.mod("reconfiguration.demand").ProximityDemandProfile})
    try:
        for c in (t.j, t.p):
            for ar in c.active_replicas:
                ar.demand_report_period_s = 0.05
        # hosted mostly in the WEST, but all traffic enters via 0 (east)
        create(t, "geo", [0, 2, 3])
        rec = _load_until(t, "geo", 0, lambda r: r.state.value == "READY"
                          and sorted(r.actives) == [0, 1, 2])
        # east has only 2 actives; the top-up keeps size 3
        assert rec is not None and rec.epoch >= 1, rec and rec.to_json()
        assert 1 in rec.actives and 0 in rec.actives, rec.to_json()
        assert rec.actives[0] == 0  # anchored at the hot entry
    finally:
        t.close()


@pytest.mark.parametrize("pkg", PKGS, ids=str)
def test_proximity_profile_measures_only_without_region_map(pkg):
    p = pkg.mod("reconfiguration.demand").ProximityDemandProfile("x")
    for _ in range(10):
        p.combine({"count": 100, "from": 0})
    assert p.reconfigure([0, 1, 2], [0, 1, 2, 3]) is None
