"""The placement plane on both packages: ``tests/test_placement.py`` run on
the JAX package and on the port (``device="cpu"`` where an engine runs).

* Decision level: every scenario runs once per package on the same load
  signals; the decisions (initial placements, rebalance targets) and the
  metrics counters are equal across the two, and the reference's own
  assertions hold on each.
* The echo probes and the placement-driven migration of a hot name run
  both packages' ``ReconfigurableCluster``s in lock step on a scripted
  clock (``tests/test_torch_reconfiguration.py``'s ``Twin``; client
  messages, records, app states and every engine leaf compared after
  every step); the probes' snapshots are equal too.
* Over real sockets (one active and one reconfigurator a package), the
  ``stats`` admin op, the HTTP front's ``/stats`` and ``/metrics`` and the
  client's echo seeding show the same fields and series on both.
"""

import json
import time
import urllib.request

import pytest

from test_torch_failover_demand import make_twin, steps_for
from torch_pkgs import JAX, PKGS, TORCH


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


class FakeProfile:
    """Stand-in demand profile: just the signal fields policies read."""

    def __init__(self, rate=30.0, num_requests=512, by_active=None):
        self.rate = rate
        self.num_requests = num_requests
        if by_active is not None:
            self.by_active = by_active


def _engine(pkg, metrics=False):
    m = pkg.mod("obs.metrics").MetricsRegistry(node=0) if metrics else None
    e = pkg.mod("reconfiguration.placement").PlacementEngine(0, **(
        {"metrics": m} if metrics else {}))
    return e, m


def place_initial_least_loaded(pkg):
    e, _ = _engine(pkg)
    e.note_echo(0, 0.030, names=50, rps=40.0)
    e.note_echo(1, 0.020, names=2, rps=0.0)
    e.note_echo(2, 0.010, names=2, rps=0.0)
    e.note_echo(3, 0.040, names=60, rps=80.0)
    target = e.place_initial("svc", [0, 1, 2, 3], 2)
    # the two lightly-loaded actives win; nearest (2) anchors first
    assert target == [2, 1]
    again = e.place_initial("svc", [0, 1, 2, 3], 2)
    assert again == [2, 1]
    return [target, again]


def place_initial_spreads_bursts(pkg):
    e, _ = _engine(pkg)
    per_active = {a: 0 for a in range(6)}
    picks = []
    for i in range(60):
        t = e.place_initial(f"n{i}", list(range(6)), 3)
        picks.append(t)
        for a in t:
            per_active[a] += 1
    assert all(n > 0 for n in per_active.values()), per_active
    assert max(per_active.values()) <= 2 * min(per_active.values()), per_active
    return picks


def hot_names_spread(pkg):
    e, m = _engine(pkg, metrics=True)
    busy, idle = [0, 1, 2], [3, 4, 5, 6, 7]
    for a in busy:
        e.note_echo(a, 0.010, names=64, rps=50.0)
    for a in idle:
        e.note_echo(a, 0.010, names=0, rps=0.0)
    landed = {a: 0 for a in range(8)}
    moves, targets = 0, []
    for i in range(64):
        prof = FakeProfile(rate=30.0, num_requests=512, by_active={0: 40, 1: 30, 2: 30})
        target = e.rebalance(f"hot{i}", prof, list(busy), list(range(8)))
        targets.append(target)
        if target is None:
            continue
        moves += 1
        for a in target:
            landed[a] += 1
    assert moves >= 64 * 3 // 4, f"only {moves}/64 names moved"
    touched = [a for a in idle if landed[a] > 0]
    assert len(touched) >= 3, (landed, "spread must reach >=3 actives")
    per_idle = [landed[a] for a in idle]
    assert max(per_idle) <= 3 * (sum(per_idle) // len(per_idle) + 1), landed
    assert m.get("placement_moves_proposed") == moves
    return targets


def hysteresis_no_flap(pkg):
    e, m = _engine(pkg, metrics=True)
    e.cooldown_s = 0.0  # isolate hysteresis from the cooldown guard
    for a in (0, 1, 2):
        e.note_echo(a, 0.010, names=10, rps=10.0)
    for a in (3, 4, 5):
        e.note_echo(a, 0.010, names=9, rps=9.0)  # near-equal: within margin
    prof = FakeProfile(rate=30.0, num_requests=512)
    assert e.rebalance("n", prof, [0, 1, 2], list(range(6))) is None
    assert m.get("placement_suppressed_hysteresis") == 1
    for a in (3, 4, 5):
        e.note_echo(a, 0.010, names=0, rps=0.0)
    target = e.rebalance("n", prof, [0, 1, 2], list(range(6)))
    assert target is not None and set(target) == {3, 4, 5}
    assert e.rebalance("n", prof, target, list(range(6))) is None
    return [target]


def cooldown_blocks(pkg):
    e, m = _engine(pkg, metrics=True)  # default cooldown: 30s
    for a in (0, 1, 2):
        e.note_echo(a, 0.010, names=30, rps=50.0)
    for a in (3, 4, 5):
        e.note_echo(a, 0.010, names=0, rps=0.0)
    prof = FakeProfile(rate=30.0, num_requests=512)
    first = e.rebalance("n", prof, [0, 1, 2], list(range(6)))
    assert first is not None
    assert e.rebalance("n", prof, [0, 1, 2], list(range(6))) is None
    assert m.get("placement_suppressed_cooldown") == 1
    return [first]


def keeps_dominant_anchor(pkg):
    e, _ = _engine(pkg)
    e.cooldown_s = 0.0
    for a in (0, 1, 2):
        e.note_echo(a, 0.010, names=40, rps=50.0)
    for a in (3, 4, 5):
        e.note_echo(a, 0.010, names=0, rps=0.0)
    prof = FakeProfile(rate=30.0, num_requests=512, by_active={0: 90, 1: 5, 2: 5})
    target = e.rebalance("n", prof, [0, 1, 2], list(range(6)))
    assert target is not None and 0 in target, target
    assert set(target) - {0} <= {3, 4, 5}, target
    return [target]


def never_shrinks(pkg):
    e, m = _engine(pkg, metrics=True)
    e.cooldown_s = 0.0
    e.note_echo(0, 0.010, names=40, rps=50.0)
    e.note_echo(1, 0.010, names=40, rps=50.0)
    e.note_echo(3, 0.010, names=0, rps=0.0)
    prof = FakeProfile(rate=30.0, num_requests=512)
    assert e.rebalance("n", prof, [0, 1, 2], [0, 1, 3]) is None
    assert m.get("placement_suppressed_short_set") == 1
    return [m.get("placement_suppressed_short_set")]


def avoids_stale_dead(pkg):
    e, _ = _engine(pkg)  # default probing: 5s period -> 20s staleness
    e.cooldown_s = 0.0
    for a in (0, 1, 2):
        e.note_echo(a, 0.010, names=20, rps=20.0)
    e.note_echo(3, 0.010, names=0, rps=0.0)
    e.loads[3].last_seen = time.time() - 999  # echoes stopped
    first = e.place_initial("n", [0, 1, 2, 3], 3)
    assert 3 not in first
    four = e.place_initial("n4", [0, 1, 2, 3], 4)
    assert sorted(four) == [0, 1, 2, 3]
    prof = FakeProfile(rate=30.0, num_requests=512)
    target = e.rebalance("n", prof, [0, 1, 2], [0, 1, 2, 3])
    assert target is None or 3 not in target
    e.note_echo(3, 0.010, names=0, rps=0.0)
    back = e.rebalance("n", prof, [0, 1, 2], [0, 1, 2, 3])
    assert 3 in back
    return [first, four, target, back]


def cold_names_stay_put(pkg):
    e, _ = _engine(pkg)
    for a in (0, 1, 2):
        e.note_echo(a, 0.010, names=50, rps=50.0)
    e.note_echo(3, 0.010, names=0, rps=0.0)
    out = [e.rebalance("cold", FakeProfile(rate=0.1, num_requests=512), [0, 1, 2],
                       [0, 1, 2, 3]),
           e.rebalance("young", FakeProfile(rate=50.0, num_requests=8), [0, 1, 2],
                       [0, 1, 2, 3])]
    assert out == [None, None]
    return out


def proximity_hysteresis(pkg):
    Config = pkg.mod("utils.config").Config
    for a, region in enumerate(("east", "east", "west", "west")):
        Config.set(f"REGION.{a}", region)
    p = pkg.mod("reconfiguration.demand").ProximityDemandProfile("n")
    p.by_active = {0: 300, 2: 280}
    p.num_requests = 580
    out = [p.reconfigure([0, 1, 2], [0, 1, 2, 3])]
    assert out[0] is None  # already right
    p.by_active = {0: 290, 2: 312}
    out.append(p.reconfigure([0, 1, 2], [0, 1, 2, 3]))
    assert out[1] is None  # within the margin: stays put
    p.by_active = {0: 50, 2: 550}
    target = p.reconfigure([0, 1, 2], [0, 1, 2, 3])
    assert target is not None and target[0] == 2 and 3 in target
    out.append(target)
    return out


@pytest.mark.parametrize("scenario", [
    place_initial_least_loaded, place_initial_spreads_bursts, hot_names_spread,
    hysteresis_no_flap, cooldown_blocks, keeps_dominant_anchor, never_shrinks,
    avoids_stale_dead, cold_names_stay_put, proximity_hysteresis,
], ids=lambda f: f.__name__)
def test_decisions_equal_the_reference(scenario):
    assert scenario(TORCH) == scenario(JAX)


def test_echo_probes_populate_rtt_matrix_before_traffic(monkeypatch):
    """Every RC's placement engine learns RTT + load for every active from
    echo rounds alone, on both packages alike."""
    t = make_twin(monkeypatch)
    try:
        for c in (t.j, t.p):
            for rc in c.reconfigurators:
                rc.echo_probe_period_s = 0.01
        t.run(8)
        snaps = [[rc.placement.snapshot() for rc in c.reconfigurators]
                 for c in (t.j, t.p)]
        assert snaps[0] == snaps[1]
        for rc, snap in zip(t.p.reconfigurators, snaps[1]):
            assert set(snap["probe_rtt_ms"]) == {"0", "1", "2", "3"}, snap
            assert set(snap["loads"]) == {"0", "1", "2", "3"}, snap
            for a in t.p.ar_ids:
                assert rc.placement.rtt.get(a) is not None
    finally:
        t.close()


def eager_balance(pkg):
    """The production policy with test-speed hot gates."""
    base = pkg.mod("reconfiguration.placement").ProximateBalancePolicy
    return type("EagerBalancePolicy", (base,), {"MIN_REQUESTS": 24})


def test_placement_rebalance_migrates_hot_name_e2e(monkeypatch):
    """AR demand reports + echo rounds -> the primary RC's placement engine
    -> RECONFIGURE_INTENT -> epoch migration: a hot name on three loaded
    actives picks up the idle fourth."""
    for pkg in PKGS:
        pkg.mod("utils.config").Config.set("PLACEMENT_MIN_RATE_RPS", "0.1")
    t = make_twin(monkeypatch, lambda pkg: {"placement_policy_cls": eager_balance(pkg)})
    try:
        for c in (t.j, t.p):
            for ar in c.active_replicas:
                ar.demand_report_period_s = 0.05
            for rc in c.reconfigurators:
                rc.echo_probe_period_s = 0.1
        for name in [f"bg{i}" for i in range(6)] + ["hx"]:
            t.client_request("create_service", {"name": name, "actives": [0, 1, 2]})
            assert t.wait_for("create_ack", max_steps=120)["ok"]
        rec, i = None, 0
        for _ in range(steps_for(40)):
            i += 1
            for c in t.both():
                c.ars.managers[0].propose("hx", f"v{i}")
            t.step()
            rec = t.p.reconfigurators[0].rc_app.get_record("hx")
            if rec.state.value == "READY" and rec.epoch >= 1 and 3 in rec.actives:
                break
        assert rec is not None and 3 in rec.actives, \
            f"placement never spread onto the idle active: {rec.to_json()}"
        assert len(rec.actives) == 3
    finally:
        t.close()


def stats_surface(pkg):
    """One AR + one RC over loopback sockets: what the RC's ``stats`` op,
    its HTTP front and the client's echo seeding show."""
    Config = pkg.mod("utils.config").Config
    ports = pkg.mod("testing.ports").free_ports(2)
    Config.set("active.AR0", f"127.0.0.1:{ports[0]}")
    Config.set("reconfigurator.RC0", f"127.0.0.1:{ports[1]}")
    Config.set("ECHO_PROBE_PERIOD_S", "0.2")
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=16, window=8, req_lanes=4,
                                             n_replicas=1)
    Node = pkg.mod("reconfigurable_node").ReconfigurableNode
    Noop = pkg.mod("models").NoopPaxosApp
    nodes = [Node(n, Noop, ar_cfg=cfg, rc_cfg=cfg, tick_interval=0.01, **pkg.dev)
             for n in ("AR0", "RC0")]
    for n in nodes:
        n.start()
    admin = pkg.mod("clients").PaxosClientAsync([("127.0.0.1", ports[1])])
    app_client = pkg.mod("clients.reconfigurable_client").ReconfigurableAppClient(
        {0: ("127.0.0.1", ports[0])}, [("127.0.0.1", ports[1])])
    try:
        assert app_client.probe_actives(wait_s=5.0) == 1
        assert app_client.redirector.rtt.get(0) is not None
        deadline = time.time() + 30
        layer = None
        while time.time() < deadline:
            r = admin.admin_sync(0, {"op": "stats"}, timeout=10)
            layer = (r or {}).get("layer")
            if layer and layer["placement"]["probe_rtt_ms"].get("0"):
                break
            time.sleep(0.2)
        assert layer, "stats admin op never carried placement"
        placement = layer["placement"]
        assert placement["policy"] == "ProximateBalancePolicy"
        assert placement["probe_rtt_ms"].get("0") is not None
        assert placement["loads"].get("0") is not None
        http = ports[1] + Config.get_int(pkg.mod("paxos_config").PC.HTTP_PORT_OFFSET)
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/stats", timeout=10) as resp:
            body = json.loads(resp.read())
        assert body["placement"]["probe_rtt_ms"].get("0") is not None
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "gp_probe_rtt_ms_active_0" in text
        assert "gp_placement_echo_replies_total" in text
        series = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                         if ln.startswith("gp_placement") or ln.startswith("gp_probe")})
        return {"placement_keys": sorted(placement), "loads": sorted(placement["loads"]),
                "stats_keys": sorted(body["placement"]), "series": series}
    finally:
        admin.close()
        app_client.close()
        for n in nodes:
            n.stop()
        Config.clear()


def test_placement_stats_surface_admin_http_and_client_seeding():
    assert stats_surface(TORCH) == stats_surface(JAX)
