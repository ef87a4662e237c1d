"""The device-plane observatory (``obs/device.py`` and the manager and
server hooks) on both packages: ``tests/test_device_obs.py`` run on the
JAX package and the port (``device="cpu"``).

Where the reference lowers a jitted function, the port has an eager
equivalent: its sentinel records first-seen argument signatures, and
``step_cost`` counts a step's bytes from its shapes.  The same call
sequence gives the same compile and retrace counts and events on both
sentinels; the deployed dispatch compiles once and never retraces on both
loopback clusters; the heat accumulator equals a longhand recount on both,
and the two packages' heat vectors are equal; the summaries, histogram
folds and SLO parsing agree.  The JAX package's perf-baseline artifact
has no port counterpart yet.
"""

import json
import os
import time

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH, boot_cluster


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _dev(pkg):
    return pkg.mod("obs.device")


def _double(pkg):
    """A doubling function as each package's step runs: jitted on JAX,
    eager on the port."""
    if pkg.is_torch:
        return lambda x: x * 2
    import jax

    return jax.jit(lambda x: x * 2)


def _ones(pkg, n):
    if pkg.is_torch:
        import torch

        return torch.ones((n,), dtype=torch.int32)
    import jax.numpy as jnp

    return jnp.ones((n,), jnp.int32)


def _sentinel_run(pkg):
    s = _dev(pkg).StepSentinel(_double(pkg), label="unit-test-step")
    seen = []
    s(_ones(pkg, 4))
    seen.append((s.n_compiles, s.n_retraces))
    s(_ones(pkg, 4))
    seen.append((s.n_compiles, s.n_retraces))
    s.assert_no_retraces()
    s.mark_warm()
    s(_ones(pkg, 4))
    s(_ones(pkg, 5))
    seen.append((s.n_compiles, s.n_retraces))
    with pytest.raises(RuntimeError, match="retrace"):
        s.assert_no_retraces()
    st = s.stats()
    json.dumps(s.events())
    return {"seen": seen, "kinds": [e["kind"] for e in s.events()],
            "stats": (st["label"], st["compiles"], st["retraces"], st["warm"],
                      st["last"]["kind"])}


def test_sentinel_counts_compiles_and_flags_shape_instability():
    got = {pkg.root: _sentinel_run(pkg) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    assert got[TORCH.root] == {
        "seen": [(1, 0), (1, 0), (2, 1)], "kinds": ["compile", "retrace"],
        "stats": ("unit-test-step", 2, 1, True, "retrace")}


def test_step_cost_counts_bytes_without_touching_the_sentinel():
    """The port's ``step_cost`` (bytes from shapes, the reference's AOT
    cost analysis has no eager counterpart) leaves the sentinel's counts
    alone, and attribute access passes through to the wrapped step."""
    import torch

    obs = TORCH.mod("obs")
    make_step = TORCH.mod("parallel.spmd").make_step
    EngineConfig = TORCH.mod("ops.engine").EngineConfig
    cfg = EngineConfig(n_groups=11, window=8, req_lanes=4, n_replicas=3)
    packed = make_step(cfg, None, 2, io="packed_host", heat=True, device="cpu")
    stacked = make_step(cfg, None, 1, io="stacked", device="cpu")
    gvec = torch.zeros((3, 5), dtype=torch.int32)
    cost = obs.step_cost(packed, gvec)
    per = _dev(TORCH).step_bytes(11, 8, 4, 3)
    assert cost["flops"] == 0.0 and cost["replica_steps"] == 2
    assert cost["bytes_accessed"] == 2 * per == 2 * cost["bytes_per_replica_step"]
    assert obs.step_cost(stacked)["replica_steps"] == 3
    assert obs.step_cost(packed.fn) == obs.step_cost(packed)
    assert packed.n_compiles == 0 and packed.fn.cfg is cfg
    assert packed.n_steps == 2  # passthrough to the wrapped step
    # the same byte model as chip_smoke.py's (the package keeps a copy)
    words = 2 * (12 + 7 * 8) + 3 * (4 + 4 * 8) + 4 + (6 + 3 * 8) + (4 + 4 * 8)
    assert per == 11 * (4 * words + 1) + 3


def test_all_sentinels_and_compile_stats():
    obs = TORCH.mod("obs")
    EngineConfig = TORCH.mod("ops.engine").EngineConfig
    before = obs.compile_stats()
    f = TORCH.mod("parallel.spmd").make_step(
        EngineConfig(n_groups=13, window=8, req_lanes=4, n_replicas=2), None, 3,
        io="packed_host", device="cpu")
    assert f in obs.all_sentinels()
    st = obs.compile_stats()
    assert st["compiles"] == sum(s.n_compiles for s in obs.all_sentinels())
    assert len(st["instances"]) >= len(before["instances"])
    assert f.label in [i["label"] for i in st["instances"]]


def test_device_memory_stats_empty_on_the_cpu():
    got = {pkg.root: _dev(pkg).device_memory_stats() for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root] == {}
    assert TORCH.mod("obs").device_memory_stats() == {}


def _loopback(pkg):
    EngineConfig = pkg.mod("ops.engine").EngineConfig
    cfg = EngineConfig(n_groups=7, window=8, req_lanes=4, n_replicas=3)
    servers, client, _ = boot_cluster(pkg, cfg, fd_timeout_s=2.0)
    try:
        assert client.create_paxos_instance("obsdev", [0, 1, 2], timeout=30)
        resps = [client.send_request_sync("obsdev", str(i), timeout=30)
                 for i in range(12)]
        time.sleep(0.5)
        sent = []
        for s in servers:
            d = s.manager._dispatch_step
            sent.append((d.warm, d.n_compiles, d.n_retraces,
                         s.manager._tick_step.n_retraces))
        r = client.admin_sync(0, {"op": "stats"}, timeout=10)
        assert r and r["ok"]
        eng = r["engine"]
        heat = eng["heat"]
        out = {
            "resps": resps, "sentinels": sent,
            "compile": (eng["compile"]["dispatch"]["compiles"],
                        eng["compile"]["dispatch"]["retraces"]),
            "counters": (eng["counters"].get("engine_compiles", 0) >= 1,
                         eng["counters"].get("engine_retraces", 0)),
            "heat": (heat["total"] > 0, heat["active_groups"] >= 1,
                     heat["top_groups"][0]["heat"] > 0),
            # the reference's keys of the mesh descriptor
            "mesh": {k: eng["mesh"][k] for k in ("n_devices", "shape", "platform")},
        }
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            p = client.admin_sync(0, {"op": "profile", "dir": td, "seconds": 0.02},
                                  timeout=15)
            out["profile"] = (bool(p and p["ok"]), p["dir"].startswith(td),
                              os.path.isdir(p["dir"]), p["seconds"] > 0)
        return out
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_hot_dispatch_compiles_exactly_once_loopback():
    """Across a loopback run with client traffic, the deployed dispatch
    step of every server compiles once (warmup) and never retraces, on
    both packages, and the stats and profile admin ops say the same."""
    got = {pkg.root: _loopback(pkg) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    r = got[TORCH.root]
    assert r["resps"] == [str(sum(range(i + 1))) for i in range(12)]
    assert r["sentinels"] == [(True, 1, 0, 0)] * 3
    assert r["compile"] == (1, 0) and r["counters"] == (True, 0)
    assert r["heat"] == (True, True, True)
    assert r["mesh"] == {"n_devices": 1, "shape": {}, "platform": "cpu"}
    assert r["profile"] == (True, True, True, True)


def _heat_run(pkg):
    EngineConfig = pkg.mod("ops.engine").EngineConfig
    StepOutputs = pkg.mod("ops.engine").StepOutputs
    cl = pkg.mod("testing.cluster")
    cfg = EngineConfig(n_groups=8, window=4, req_lanes=2, n_replicas=3)
    R, G = cfg.n_replicas, cfg.n_groups
    c = cl.ManagerCluster(cfg, pkg.mod("models.apps").HashChainApp, **pkg.dev)
    try:
        expected = [np.zeros(G, np.int64) for _ in range(R)]

        def _wrap(m, exp):
            orig = m._post_step_locked

            def wrapped(outs):
                lst = [outs] if isinstance(outs, StepOutputs) else outs
                for o in lst:
                    exp[:] += np.asarray(o.n_committed).astype(np.int64)
                    exp[:] += np.asarray(o.n_admitted).astype(np.int64)
                return orig(outs)

            m._post_step_locked = wrapped

        for rid, m in enumerate(c.managers):
            _wrap(m, expected[rid])
        names = ["heat0", "heat1", "heat2"]
        for nm in names:
            c.create(nm)
        rng = np.random.default_rng(20260807)
        for step in range(40):
            for _ in range(int(rng.integers(0, 4))):
                nm = names[int(rng.integers(0, len(names)))]
                c.submit(nm, f"v{step}-{rng.integers(1 << 20)}",
                         entry=int(rng.integers(0, R)))
            delivery = np.where(rng.random((R, R)) < 0.2, cl.DROP, cl.DELIVER)
            np.fill_diagonal(delivery, cl.DELIVER)
            c.step_all(delivery=delivery)
        c.run(10)
        out = []
        for rid, m in enumerate(c.managers):
            delta = m.pull_group_heat()
            assert delta.dtype == np.int64
            np.testing.assert_array_equal(m._heat_host, expected[rid])
            assert not m.pull_group_heat().any()
            summ = m.group_heat_stats()
            assert summ["total"] == int(expected[rid].sum())
            assert summ["active_groups"] == int((expected[rid] > 0).sum())
            out.append(m._heat_host.tolist())
        return out
    finally:
        c.close()


def test_group_heat_bitmatches_host_recount_chaos_run():
    """The heat accumulator equals a longhand recount of every substep's
    decided and admitted counts on both packages, over one seeded run with
    link drops, and the two packages' heat vectors are equal."""
    got = {pkg.root: _heat_run(pkg) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    assert any(any(h) for h in got[TORCH.root]), "the run decided nothing"


def test_heat_summary_longhand():
    heat = np.zeros(200, np.int64)
    heat[7], heat[13], heat[99] = 100, 30, 1
    got = {pkg.root: (_dev(pkg).heat_summary(heat, topk=2, name_of={7: "hot"}.get),
                      _dev(pkg).heat_summary(np.zeros(4, np.int64)))
           for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    s, empty = got[TORCH.root]
    assert s["total"] == 131 and s["active_groups"] == 3
    assert [r["row"] for r in s["top_groups"]] == [7, 13]
    assert s["top_groups"][0]["name"] == "hot" and "name" not in s["top_groups"][1]
    assert s["hot_set"]["rows"] == 2
    assert s["hot_set"]["traffic_share"] == pytest.approx(130 / 131)
    assert empty["total"] == 0


def test_observe_bulk_bitmatches_scalar_observe():
    samples = np.random.default_rng(7).integers(1, 100_000, size=500).astype(np.float64)
    got = {}
    for pkg in PKGS:
        Reg = pkg.mod("obs.metrics").MetricsRegistry
        bounds = _dev(pkg).HEAT_BOUNDS
        a, b = Reg(node=0), Reg(node=0)
        for x in samples:
            a.observe("group_heat", float(x), bounds=bounds)
        b.observe_bulk("group_heat", samples, bounds=bounds)
        sa, sb = (r.snapshot()["hists"]["group_heat"] for r in (a, b))
        assert sa["buckets"] == sb["buckets"] and sa["count"] == sb["count"]
        assert sa["min"] == sb["min"] and sa["max"] == sb["max"]
        assert sa["sum"] == pytest.approx(sb["sum"])
        b.observe_bulk("other", np.array([]))
        assert "other" not in b.snapshot()["hists"]
        got[pkg.root] = (bounds, sa["buckets"], sa["count"])
    assert got[JAX.root] == got[TORCH.root]


def test_provenance_roundtrips_json():
    p = _dev(TORCH).provenance(donate=True, extra={"run": "unit"})
    assert json.loads(json.dumps(p)) == p
    for key in ("torch", "cuda", "platform", "device_kind", "n_devices",
                "python", "donation"):
        assert key in p, key
    assert p["donation"] is True and p["run"] == "unit"
    assert p["platform"] == "cpu" and p["device_kind"] == "cpu"


def test_capture_profile_writes_and_bounds_dump_dir(tmp_path):
    capture_profile = _dev(TORCH).capture_profile
    root = str(tmp_path / "profiles")
    caps = [capture_profile(root, seconds=0.01, max_dumps=2) for _ in range(4)]
    for cap in caps[-2:]:
        assert os.path.isdir(cap["dir"])
        assert os.path.isfile(os.path.join(cap["dir"], "trace.json"))
    dumps = [d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))]
    assert len(dumps) <= 2, dumps
    assert sum(c["rotated_out"] for c in caps) >= 2
    cap = capture_profile(root, seconds=99.0, max_dumps=2, max_seconds=0.05)
    assert cap["seconds"] < 1.0


def test_slo_budget_parse_and_breach():
    trace = {"hops": [{"phase": "ingress", "dt_s": 0.040},
                      {"phase": "ingress", "dt_s": 0.020},
                      {"phase": "consensus", "dt_s": 0.100}],
             "total_s": 0.160}
    got = {}
    for pkg in PKGS:
        tm = pkg.mod("obs.tracemerge")
        Config, PC = pkg.mod("utils.config").Config, pkg.mod("paxos_config").PC
        budgets = tm.parse_slo_budgets(Config.get_str(PC.SLO_BUDGETS_MS))
        assert budgets["total"] == pytest.approx(2.0)
        with pytest.raises(ValueError, match="unknown phase"):
            tm.parse_slo_budgets("execute=10")
        over = tm.slo_breaches(trace, budgets)
        assert not tm.slo_breaches(trace, {"consensus": 0.5})
        got[pkg.root] = (budgets, [b["phase"] for b in over])
    assert got[JAX.root] == got[TORCH.root]
    assert got[TORCH.root][1] == ["ingress"]
