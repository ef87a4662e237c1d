"""The observability plane on both packages: ``tests/test_obs.py`` run on
the JAX package and on the port (``device="cpu"`` where an engine runs).

Each scenario runs once per package; what it yields (tracer events with
their times made relative, dumps, log lines, level settings, metric
snapshots and their rendered text, trace merges, flight-recorder rings
and dumps, the ``stats`` admin op's fields) is equal across the two, and
the reference's own assertions hold on each.  The merged cross-member
timeline of a chaos diagnosis comes from both packages'
``ReconfigurableCluster``s in lock step on a scripted clock, equal after
the times are normalized.  The hygiene gate runs the
reference's script on each package's root.
"""

import io
import json
import logging
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from torch_pkgs import JAX, PKGS, TORCH

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


def both(fn, *a, **kw):
    """``fn(pkg)`` on the JAX package then the port; asserts equal."""
    ref, port = fn(JAX, *a, **kw), fn(TORCH, *a, **kw)
    assert port == ref
    return port


def _tracer(pkg):
    return pkg.mod("obs.reqtrace").RequestTracer


def _events(t, key):
    """A key's events with times made relative to its first."""
    evs = t.events(key)
    t0 = evs[0][0] if evs else 0.0
    return [(round(e[0] - t0, 3) >= 0, e[1], e[2]) for e in evs]


# ---- tracer ----------------------------------------------------------
def tracer_ring(pkg):
    t = _tracer(pkg)(0, capacity=4, enabled=True)
    for rid in range(10):
        t.note(rid, "recv", name="svc", node=0)
        t.note(rid, "execute", slot=rid)
    assert len(t) == 4
    assert all(rid in t for rid in range(6, 10))
    assert all(rid not in t for rid in range(6))
    t.note(7, "respond-flush")
    assert [e[1] for e in t.events(7)] == ["recv", "execute", "respond-flush"]
    return [_events(t, k) for k in range(10)]


def test_tracer_ring_bound_and_fifo_eviction():
    both(tracer_ring)


def tracer_disabled(pkg):
    t = _tracer(pkg)(1, capacity=16, enabled=False)
    t.note(42, "recv", name="svc", node=1)
    t.note(42, "execute", slot=3)
    assert len(t) == 0
    assert t.events(42) == []
    assert "no trace" in t.dump(42)
    assert "no traces" in t.dump_name("svc")
    return [t.dump(42), t.dump_name("svc")]


def test_tracer_disabled_records_nothing():
    both(tracer_disabled)


def _no_times(text):
    return re.sub(r"[+-]?\d+\.\d+ ?ms", "<t>ms", text)


def tracer_dump(pkg):
    t = _tracer(pkg)(2, enabled=True)
    t.note(7, "recv", name="a", node=2)
    t.note(7, "propose", name="a", vid=99, row=3)
    t.note(8, "recv", name="a", node=2)
    t.note(9, "recv", name="b", node=2)
    d = t.dump(7)
    assert "request 7 @ node 2" in d
    assert "recv" in d and "propose" in d and "vid=99" in d
    assert "ms" in d
    assert t.keys_for_name("a") == [7, 8]
    nd = t.dump_name("a")
    assert "request 7" in nd and "request 8" in nd and "request 9" not in nd
    return [_no_times(d), _no_times(nd), t.keys_for_name("a")]


def test_tracer_dump_timeline_and_name_index():
    both(tracer_dump)


def tracer_gate(pkg, monkeypatch):
    gplog = pkg.mod("obs.gplog")
    RequestTracer = _tracer(pkg)
    gplog.reset_for_tests()
    try:
        monkeypatch.delenv("GP_TRACE", raising=False)
        monkeypatch.setenv("GP_LOG", "")
        out = [RequestTracer(0).enabled]
        monkeypatch.setenv("GP_LOG", "trace:DEBUG")
        gplog.configure(stream=io.StringIO(), force=True)
        out.append(RequestTracer(0).enabled)
        monkeypatch.setenv("GP_LOG", "")
        monkeypatch.setenv("GP_TRACE", "1")
        gplog.reset_for_tests()
        out.append(RequestTracer(0).enabled)
    finally:
        gplog.reset_for_tests()
    assert out == [False, True, True]
    return out


def test_tracer_default_gate_follows_gp_log(monkeypatch):
    both(tracer_gate, monkeypatch)


# ---- logging ---------------------------------------------------------
class _Sentinel:
    """__str__ counter: proves %-args only format past the level check."""

    def __init__(self):
        self.n = 0

    def __str__(self):
        self.n += 1
        return "S"


def _log_lines(text):
    """Log lines without their timestamps."""
    return [re.sub(r"^\S+ \S+ ", "", ln) for ln in text.splitlines()]


def lazy_formatting(pkg):
    gplog = pkg.mod("obs.gplog")
    gplog.reset_for_tests()
    try:
        sink = io.StringIO()
        gplog.configure(stream=sink, force=True)  # default WARNING
        log = gplog.node_logger("lazytest", 7)
        s = _Sentinel()
        log.debug("value=%s", s)
        log.info("value=%s", s)
        assert s.n == 0, "args formatted below the enabled level"
        log.warning("value=%s", s)
        assert s.n == 1
        out = sink.getvalue()
        assert "[node 7]" in out and "value=S" in out
        assert "gp.lazytest" in out
    finally:
        gplog.reset_for_tests()
    return _log_lines(out)


def test_gplog_lazy_formatting_below_level():
    both(lazy_formatting)


def env_grammar(pkg):
    gplog = pkg.mod("obs.gplog")
    gplog.reset_for_tests()
    try:
        gplog.configure(stream=io.StringIO(), force=True)
        gplog.apply_env_levels("INFO,server:DEBUG, rc:ERROR")
        levels = [logging.getLogger(n).level for n in ("gp", "gp.server", "gp.rc")]
        assert levels == [logging.INFO, logging.DEBUG, logging.ERROR]
        gplog.apply_env_levels("server:NOTALEVEL,garbage")
        assert logging.getLogger("gp.server").level == logging.DEBUG
    finally:
        gplog.reset_for_tests()
    return levels


def test_gplog_env_grammar():
    both(env_grammar)


def warn_once(pkg):
    gplog = pkg.mod("obs.gplog")
    gplog.reset_for_tests()
    try:
        sink = io.StringIO()
        gplog.configure(stream=sink, force=True)
        log = gplog.node_logger("oncetest", 3)
        for _ in range(5):
            gplog.warn_once(log, "kindX", "dropping frame of kind %s", "X")
        gplog.warn_once(log, "kindY", "dropping frame of kind %s", "Y")
        out = sink.getvalue()
        assert out.count("kind X") == 1
        assert out.count("kind Y") == 1
    finally:
        gplog.reset_for_tests()
    return _log_lines(out)


def test_warn_once_dedup():
    both(warn_once)


# ---- metrics ---------------------------------------------------------
def _metrics(pkg):
    return pkg.mod("obs.metrics")


def histogram(pkg):
    h = _metrics(pkg).Histogram(bounds=(1.0, 10.0, 100.0))
    for x in (0.5, 5, 5, 50, 500):
        h.observe(x)
    snap = h.snapshot()
    assert snap["count"] == 5
    assert snap["min"] == 0.5 and snap["max"] == 500
    assert snap["buckets"] == [[1.0, 1], [10.0, 2], [100.0, 1], ["+inf", 1]]
    return snap


def test_histogram_buckets_and_stats():
    both(histogram)


def inf_bucket(pkg):
    m = _metrics(pkg).MetricsRegistry(node=1)
    m.observe("lat_s", 0.5, bounds=(1.0, 10.0))
    snap = m.snapshot()["hists"]["lat_s"]
    assert snap["buckets"] == [[1.0, 1], [10.0, 0], ["+inf", 0]]
    text = m.render()
    assert 'le="+Inf"} 1' in text
    return [snap, text]


def test_histogram_always_ships_inf_bucket():
    both(inf_bucket)


def full_precision(pkg):
    m = _metrics(pkg).MetricsRegistry(node=1)
    m.count("decisions_executed", 10_000_000_019)
    text = m.render()
    assert 'gp_decisions_executed_total{node="1"} 10000000019' in text
    return text


def test_render_counters_full_precision():
    both(full_precision)


def event_cap(pkg):
    RequestTracer = _tracer(pkg)
    t = RequestTracer(0, enabled=True)
    t.note("epoch:n0", "rc-propose:create_intent", name="n0")
    for i in range(2 * RequestTracer.EVENTS_PER_KEY):
        t.note("epoch:n0", "start-epoch-round", attempt=i)
    evs = t.events("epoch:n0")
    assert len(evs) == RequestTracer.EVENTS_PER_KEY
    assert evs[0][1] == "rc-propose:create_intent"  # t0 anchor survives
    assert evs[-1][2]["attempt"] == 2 * RequestTracer.EVENTS_PER_KEY - 1
    return _events(t, "epoch:n0")


def test_tracer_per_key_event_cap_keeps_anchor():
    both(event_cap)


def registry_roundtrip(pkg):
    m = _metrics(pkg).MetricsRegistry(node=5)
    m.count("decisions_executed", 3)
    m.count("decisions_executed", 4)
    m.gauge("frontier_stall_groups", 2)
    m.observe("engine_step_s", 0.002)
    assert m.get("decisions_executed") == 7
    assert m.get("frontier_stall_groups") == 2
    snap = m.snapshot()
    assert snap["node"] == 5
    assert snap["counters"]["decisions_executed"] == 7
    assert snap["hists"]["engine_step_s"]["count"] == 1
    text = m.render()
    assert 'gp_decisions_executed_total{node="5"} 7' in text
    assert "gp_engine_step_s_bucket" in text
    line = m.summary_line()
    assert "decisions_executed:7" in line
    return [snap, text, line]


def test_metrics_registry_roundtrip():
    both(registry_roundtrip)


# ---- the stats admin op over a live loopback cluster -----------------
def stats_roundtrip(pkg):
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=6, window=8, req_lanes=4,
                                             n_replicas=2)
    ports = pkg.mod("testing.ports").free_ports(2)
    nc = pkg.mod("net.node_config").NodeConfig(
        {i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    servers = [pkg.mod("server").PaxosServer(i, nc, pkg.mod("models").StatefulAdderApp(),
                                             cfg, tick_interval=0.01, **pkg.dev)
               for i in range(2)]
    for s in servers:
        s.start()
    client = pkg.mod("clients").PaxosClientAsync([("127.0.0.1", p) for p in ports])
    try:
        r = client.admin_sync(0, {"op": "frobnicate", "name": "x"}, timeout=10)
        assert r is not None, "unknown admin op never answered"
        assert r["ok"] is False and r["error"] == "unknown_op"
        unknown = r
        assert client.create_paxos_instance("obs", [0, 1], timeout=30)
        assert client.send_request_sync("obs", "5", timeout=30) == "5"
        deadline = time.time() + 30
        while True:
            r = client.admin_sync(0, {"op": "stats"}, timeout=10)
            assert r is not None and r["ok"] is True
            eng = r["engine"]
            if eng["counters"].get("decisions_executed", 0) >= 1:
                break
            assert time.time() < deadline, eng["counters"]
            time.sleep(0.2)
        assert "engine_step_s" in eng["hists"]
        assert eng["mesh"]["n_devices"] >= 1
        assert eng["mesh"]["platform"] == "cpu"
        assert isinstance(eng["mesh"]["shape"], dict)
        assert eng["counters"].get("blob_bytes_sent", 0) > 0
        assert "profiler" in r and "counts" in r["profiler"]
        assert r["profiler_line"].startswith("[")
        # the port's engine section carries port-only fields (ROADMAP §C,
        # "Port-only fields and ops"): shape, launches, device_memory, and
        # the mesh descriptor's physical_devices (a mesh of the port is
        # one of logical devices)
        extra = {"shape", "launches", "device_memory"} if pkg.is_torch else set()
        mesh = dict(eng["mesh"])
        if pkg.is_torch:
            assert mesh.pop("physical_devices") == 1
        return {"unknown": unknown, "top": sorted(r), "mesh": mesh,
                "engine": sorted(set(eng) - extra)}
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_stats_admin_roundtrip_and_unknown_op():
    both(stats_roundtrip)


# ---- chaos-diag trace ride-along -------------------------------------
def test_name_diag_carries_merged_cross_member_trace(monkeypatch):
    """With tracing on, ``_name_diag`` carries the name's merged
    cross-member timeline, equal on both packages after the times are
    normalized, and the soak's failure message contains it."""
    from test_torch_failover_demand import make_twin

    t = make_twin(monkeypatch, ar=(8, 8, 4, 3), rc=(4, 8, 4, 3))
    try:
        for c in (t.j, t.p):
            for m in c.ars.managers:
                m.tracer.enabled = True
            for rc in c.reconfigurators:
                rc.tracer.enabled = True
        t.client_request("create_service", {"name": "tn", "actives": [0, 1, 2]})
        t.run(40)
        rid = (1 << 55) + 12345
        for c in t.both():
            c.ars.managers[0].propose("tn", "v0", request_id=rid)
        for _ in range(3000):
            t.step()
            if all(m.app.state.get("tn") for m in t.p.ars.managers):
                break
        assert t.p.ars.managers[0].app.state.get("tn"), "request never executed"
        diags = []
        for pkg, c in ((JAX, t.j), (TORCH, t.p)):
            chaos = pkg.mod("testing.chaos")
            diag = chaos._name_diag(c, "tn", [0, 1, 2])
            merged = diag.get("merged_trace", "")
            assert str(rid) in merged, merged
            assert "propose" in merged and "execute" in merged
            for a in (0, 1, 2):
                assert f"@ node {a}" in merged, (a, merged)
            assert "phases:" in merged
            assert "rc_epoch_trace" in diag
            assert any("rc-applied" in v or "rc-propose" in v
                       for v in diag["rc_epoch_trace"].values())
            msg = str(chaos.SoakDivergence("synthetic", {"members": diag}))
            assert str(rid) in msg and "+" in msg
            assert c.ars.managers[0].metrics.get("decisions_executed") >= 1
            diags.append(_no_times(repr(diag)))
        assert diags[0] == diags[1]
    finally:
        t.close()


# ---- cross-node trace plumbing (sampling, export, merge) --------------
def sampling(pkg, monkeypatch):
    reqtrace = pkg.mod("obs.reqtrace")
    monkeypatch.delenv("GP_TRACE_SAMPLE", raising=False)
    out = [reqtrace.trace_sample_rate(), reqtrace.maybe_mint_trace(3)]
    assert out == [0.0, None]
    monkeypatch.setenv("GP_TRACE_SAMPLE", "1")
    assert reqtrace.trace_sample_rate() == 1.0
    tc = reqtrace.maybe_mint_trace(3)
    assert tc is not None and tc[1] == 3 and tc[2] == 0 and tc[0] > 0
    out.append(tuple(tc[1:]))
    monkeypatch.setenv("GP_TRACE_SAMPLE", "garbage")
    out.append(reqtrace.trace_sample_rate())
    monkeypatch.setenv("GP_TRACE_SAMPLE", "7")  # clamped
    out.append(reqtrace.trace_sample_rate())
    assert out[-2:] == [0.0, 1.0]
    return out


def test_trace_sampling_gate(monkeypatch):
    both(sampling, monkeypatch)


def force_records(pkg):
    t = _tracer(pkg)(4, enabled=False)
    t.note(99, "decide", name="svc", force=True, tid=123, slot=5)
    t.note(99, "ignored")  # unforced + disabled: dropped
    evs = t.events(99)
    assert [e[1] for e in evs] == ["decide"]
    assert evs[0][2]["tid"] == 123
    return _events(t, 99)


def test_tracer_force_records_when_disabled():
    both(force_records)


def export_shapes(pkg):
    t = _tracer(pkg)(1, enabled=True)
    t.note(5, "recv", name="a", node=1)
    t.note(5, "propose", name="a", vid=9)
    t.note(6, "recv", name="b", node=1)
    out = t.export(keys=[5])
    assert set(out) == {"5"}
    assert [e[1] for e in out["5"]] == ["recv", "propose"]
    assert out["5"][0][0] <= out["5"][1][0]
    by_name = t.export(name="a")
    assert set(by_name) == {"5"}
    everything = t.export()
    assert set(everything) == {"5", "6"}
    assert t.export(limit=1) == {"6": everything["6"]}
    strip = lambda d: {k: [e[1:] for e in v] for k, v in d.items()}
    return [strip(out), strip(by_name), strip(everything), strip(t.export(limit=1))]


def test_tracer_export_shapes():
    both(export_shapes)


def merge_attribution(pkg):
    tracemerge = pkg.mod("obs.tracemerge")
    t0 = 1000.0
    dumps = {
        1: {"42": [
            [t0, "recv", {"tid": 7, "hop": 0}],
            [t0 + 0.001, "propose", {"tid": 7, "hop": 0}],
            [t0 + 0.002, "forward-out", {"tid": 7, "hop": 0, "to": 0}],
        ]},
        0: {"42": [
            [t0 + 0.002, "forward-in", {"tid": 7, "hop": 1}],
            [t0 + 0.004, "decide", {"tid": 7, "slot": 0, "ballot": 3}],
        ]},
    }
    traces = tracemerge.merge_node_dumps(dumps)
    assert len(traces) == 1
    tr = traces[0]
    assert tr["trace_id"] == 7
    assert [e["event"] for e in tr["events"]] == [
        "recv", "propose", "forward-out", "forward-in", "decide"]
    assert all(h["dt_s"] >= 0.0 for h in tr["hops"])
    phases = [h["phase"] for h in tr["hops"]]
    assert "ingress" in phases and "forward-wire" in phases
    wire = [h for h in tr["hops"] if h["phase"] == "forward-wire"][0]
    assert wire["dt_s"] == 0.0
    assert wire["from_node"] == 1 and wire["to_node"] == 0
    text = tracemerge.render_trace(tr)
    assert "tid=0x7" in text and "@ node 1" in text
    plain = tracemerge.merge_node_dumps({
        0: {"9": [[t0, "recv", {}]]},
        1: {"9": [[t0 + 0.01, "execute", {"slot": 1}]]},
    })
    assert len(plain) == 1 and plain[0]["trace_id"] is None
    assert len(plain[0]["events"]) == 2
    return [traces, text, plain]


def test_tracemerge_attribution_and_skew_clamp():
    both(merge_attribution)


def process_gauges(pkg):
    m = _metrics(pkg).MetricsRegistry(node=9)
    _metrics(pkg).collect_process_gauges(m)
    snap = m.snapshot()["gauges"]
    assert snap.get("process_rss_bytes", 0) > 0
    assert snap.get("process_open_fds", 0) > 0
    assert snap.get("process_threads", 0) >= 1
    assert "process_gc_collections" in snap
    assert "gp_process_rss_bytes" in m.render()
    return sorted(snap)


def test_process_gauges_collect():
    both(process_gauges)


def flight(pkg, tmp_path):
    d = tmp_path / str(pkg)
    pkg.mod("utils.config").Config.set("FLIGHT_DIR", str(d))
    fl = pkg.mod("obs.flight").FlightRecorder(2, steps=4, decided=6)
    fl.record_step(tick=1, admitted=0, decided=0, preempts=0, coordinator_flips=0,
                   ballot_rises=0, frontier_stalls=0, inflight=0)  # idle
    for i in range(10):
        fl.record_step(tick=i, admitted=1, decided=1, preempts=0, coordinator_flips=0,
                       ballot_rises=0, frontier_stalls=0, inflight=2)
        fl.record_decided(3, i, 17, 100 + i)
    snap = fl.snapshot()
    assert len(snap["steps"]) == 4
    assert len(snap["decided"]) == 6
    assert snap["decided"][-1] == [3, 9, 17, 109]
    assert fl.decided_for_group(3) and not fl.decided_for_group(4)
    path = fl.dump(reason="unit test?/x")
    assert path and path.endswith(".json")
    doc = json.loads(open(path).read())
    assert doc["node"] == 2 and doc["reason"] == "unit test?/x"
    assert len(doc["decided"]) == 6
    assert fl.dump(reason="boom", once=True)
    assert fl.dump(reason="boom", once=True) is None
    drop_t = lambda rows: [[v for k, v in sorted(r.items()) if k not in ("t", "wall")]
                           if isinstance(r, dict) else r for r in rows]
    return [drop_t(snap["steps"]), snap["decided"], sorted(doc),
            re.sub(r"\d{6,}", "<ms>", Path(path).name), drop_t(doc["steps"]),
            doc["decided"]]


def test_flight_recorder_rings_and_dump(tmp_path):
    both(flight, tmp_path)


# ---- hygiene gate ----------------------------------------------------
def test_obs_hygiene_gate():
    """The reference's AST gate, run on each package's root: no bare
    print/std-stream writes outside obs/, and the METRICS.md inventory
    matches the registered metric names both ways, on both."""
    outs = []
    for pkg in PKGS:
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "check_obs_hygiene.py"),
             str(REPO / pkg.root)], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "metric inventory" in proc.stdout
        outs.append(proc.stdout.replace(pkg.root, "<root>"))
    assert outs[0] == outs[1]
