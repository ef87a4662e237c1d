"""Cluster-wide observability on both packages: ``tests/test_cluster_trace.py``
run on the JAX package and on the port (``device="cpu"``).

* One sampled request through a live loopback cluster of each package
  merges into one causal timeline; the timelines are equal across the
  two after the ids are normalized (trace id, request id, times, node
  ids as roles): the same (event, role) hops and per-hop phases where
  their presence does not follow the sockets' timing, the same decided
  row.
* ``trace_dump`` and ``flightdump`` mid-load answer alike (fields, the
  dump document's keys, the decided entries' shape).
* A forced exactly-once divergence in the stepped chaos harness lands
  the flight recorder on disk on both; both packages'
  ``ReconfigurableCluster``s run in lock step on a scripted clock, and
  the dumps' decided entries are equal.
* The RC and AR HTTP fronts serve ``/stats`` and ``/metrics`` over TLS on
  both (certificates from a local ``openssl``; skipped without it), with
  the same top-level fields and series, and refuse plaintext.
"""

import json
import os
import ssl
import subprocess
import time
import urllib.request

import pytest

from test_torch_failover_demand import make_twin
from torch_pkgs import JAX, PKGS, TORCH


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


def both(fn, *a):
    ref, port = fn(JAX, *a), fn(TORCH, *a)
    assert port == ref
    return port


def _boot_cluster(pkg, n, groups=8):
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=groups, window=8, req_lanes=4,
                                             n_replicas=n)
    ports = pkg.mod("testing.ports").free_ports(n)
    nc = pkg.mod("net.node_config").NodeConfig(
        {i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    servers = [pkg.mod("server").PaxosServer(i, nc, pkg.mod("models").StatefulAdderApp(),
                                             cfg, tick_interval=0.01, **pkg.dev)
               for i in range(n)]
    for s in servers:
        s.start()
    return servers, ports, pkg.mod("clients").PaxosClientAsync(
        [("127.0.0.1", p) for p in ports])


STABLE_EVENTS = ("recv", "propose", "forward-out", "forward-in", "decide", "execute",
                 "respond-flush")


def traced_request(pkg, monkeypatch):
    monkeypatch.setenv("GP_TRACE_SAMPLE", "1")
    tracemerge = pkg.mod("obs.tracemerge")
    servers, ports, client = _boot_cluster(pkg, 3)
    try:
        assert all(not s.tracer.enabled for s in servers)
        assert client.create_paxos_instance("tr0", [0, 1, 2], timeout=30)
        m0 = servers[0].manager
        row = m0.names["tr0"]
        coord = m0.coordinator_of_row(row)
        entry = (coord + 1) % 3
        assert client.send_request_sync("tr0", "7", timeout=30, server=entry) == "7"
        deadline = time.time() + 30
        while time.time() < deadline:
            if all(s.manager.app.totals.get("tr0") == 7 for s in servers):
                break
            time.sleep(0.1)
        dumps = {}
        for i in range(3):
            r = client.admin_sync(i, {"op": "trace_dump"}, timeout=10)
            assert r and r["ok"], r
            assert r["enabled"] is False  # forced recording, not GP_TRACE
            dumps[r["node"]] = r["events"]
        traces = tracemerge.merge_node_dumps(dumps)
        assert len(traces) == 1, [t["keys"] for t in traces]
        tr = traces[0]
        assert tr["trace_id"], tr
        assert {e["detail"]["tid"] for e in tr["events"]
                if "tid" in e["detail"]} == {tr["trace_id"]}
        by = {}
        for e in tr["events"]:
            by.setdefault(e["event"], set()).add(e["node"])
        for ev in ("recv", "propose", "forward-out", "respond-flush"):
            assert entry in by.get(ev, set()), ev
        assert coord in by.get("forward-in", set())
        assert coord in by.get("propose", set())
        fwd_in = [e for e in tr["events"] if e["event"] == "forward-in"]
        assert fwd_in and all(e["detail"].get("hop", 0) >= 1 for e in fwd_in)
        assert by.get("decide") == {0, 1, 2}, by
        assert by.get("execute") == {0, 1, 2}, by
        for e in tr["events"]:
            if e["event"] == "decide":
                assert e["detail"]["row"] == row
                assert "slot" in e["detail"] and "ballot" in e["detail"]
        assert tr["events"][0]["event"] == "recv"
        assert all(h["dt_s"] >= 0.0 for h in tr["hops"])
        assert tr["total_s"] >= 0.0
        phases = {h["phase"] for h in tr["hops"]}
        assert "forward-wire" in phases and "ingress" in phases
        text = tracemerge.render_trace(tr)
        assert "forward-wire" in text and "@ node" in text
        # the timeline with its ids normalized (roles for node ids), over
        # the hops whose presence does not follow the sockets' timing (a
        # re-propose, or a phase "a->b" between a late replica's decide and
        # the entry's flush, does)
        role = {entry: "entry", coord: "coord"}
        role.update({n: "other" for n in range(3) if n not in role})
        return {"hops": sorted({(e["event"], role[e["node"]]) for e in tr["events"]
                                if e["event"] in STABLE_EVENTS}),
                "phases": sorted(phases & {"ingress", "forward-wire", "consensus"}),
                "decided_row": row,
                "detail_keys": sorted({(e["event"], k) for e in tr["events"]
                                       if e["event"] in ("decide", "execute")
                                       for k in e["detail"]})}
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_traced_request_merges_into_one_causal_timeline(monkeypatch):
    both(traced_request, monkeypatch)


def mid_load(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("GP_TRACE_SAMPLE", "1")
    pkg.mod("utils.config").Config.set("FLIGHT_DIR", str(tmp_path / str(pkg) / "flight"))
    servers, ports, client = _boot_cluster(pkg, 2)
    try:
        assert client.create_paxos_instance("mid", [0, 1], timeout=30)
        for _ in range(40):
            client.send_request("mid", "1")
        assert client.send_request_sync("mid", "1", timeout=30) is not None
        r = client.admin_sync(0, {"op": "trace_dump", "name": "mid"}, timeout=10)
        assert r and r["ok"] and r["node"] == 0
        assert r["events"], "mid-load trace_dump returned an empty ring"
        assert any(ev[1] == "propose" for evs in r["events"].values() for ev in evs)
        f = client.admin_sync(0, {"op": "flightdump"}, timeout=10)
        assert f and f["ok"], f
        assert f["steps"] > 0 and f["decided"] > 0, f
        assert os.path.isfile(f["path"]), f
        doc = json.loads(open(f["path"]).read())
        assert doc["node"] == 0 and doc["reason"] == "admin"
        assert doc["steps"] and doc["decided"]
        row = servers[0].manager.names["mid"]
        mine = [d for d in doc["decided"] if d[0] == row]
        assert mine, doc["decided"][:5]
        assert all(len(d) == 4 for d in mine)
        # which events node 0 holds follows the client's entry choice:
        # the fields are compared
        return {"trace_dump": sorted(r), "flightdump": sorted(f), "doc": sorted(doc)}
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_trace_dump_and_flightdump_mid_load(tmp_path, monkeypatch):
    both(mid_load, tmp_path, monkeypatch)


def test_soak_divergence_dumps_flight_recorder(tmp_path, monkeypatch):
    """A forced exactly-once divergence lands the flight recorder on disk,
    attached to the failure, with the divergent group's last-K decided
    entries; equal on both packages."""
    t = make_twin(monkeypatch, ar=(8, 8, 4, 3), rc=(4, 8, 4, 3))
    try:
        for c in (t.j, t.p):
            for m in c.ars.managers:
                m.tracer.enabled = True
        t.client_request("create_service", {"name": "dv", "actives": [0, 1, 2]})
        t.run(40)
        rid = (1 << 55) + 777
        for c in t.both():
            c.ars.managers[0].propose("dv", "v0", request_id=rid)
        for _ in range(6000):
            t.step()
            if all(m.app.state.get("dv") for m in t.p.ars.managers):
                break
        assert t.p.ars.managers[0].app.state.get("dv"), "request never ran"
        row = t.p.ars.managers[0].names["dv"]
        for _ in range(6000):
            if all(int(m.app_exec_slot[m.names["dv"]])
                   == int(m._np("exec_slot")[m.names["dv"]]) > 0
                   for m in t.p.ars.managers):
                break
            t.step()
        docs = []
        for pkg, c in ((JAX, t.j), (TORCH, t.p)):
            pkg.mod("utils.config").Config.set("FLIGHT_DIR", str(tmp_path / str(pkg)))
            chaos = pkg.mod("testing.chaos")
            c.ars.managers[0].app.state["dv"] = "CORRUPTED"
            with pytest.raises(chaos.SoakDivergence) as ei:
                chaos.probe_exactly_once(c, ["dv"])
            paths = ei.value.diag.get("flight_dumps")
            assert paths, "divergence carried no flight dumps"
            assert "flight_dumps" in str(ei.value)
            found, decided_all = False, []
            for p in paths:
                assert os.path.isfile(p)
                doc = json.loads(open(p).read())
                decided = [d for d in doc["decided"] if d[0] == row]
                decided_all.append((doc["node"], doc["reason"], doc["decided"]))
                if decided:
                    found = True
                    assert all(len(d) == 4 for d in decided)
                    slots = [d[1] for d in decided]
                    assert slots == sorted(slots)
            assert found, (paths, row)
            docs.append(decided_all)
        assert docs[0] == docs[1]
    finally:
        t.close()


def _make_cert(tmp_path):
    key, crt = tmp_path / "key.pem", tmp_path / "cert.pem"
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(crt), "-days", "1", "-subj", "/CN=127.0.0.1"],
        capture_output=True, timeout=60)
    if r.returncode != 0:
        pytest.skip("openssl unavailable for cert generation")
    return str(key), str(crt)


def tls_fronts(pkg, key, crt):
    Config = pkg.mod("utils.config").Config
    ports = pkg.mod("testing.ports").free_ports(2)
    Config.set("active.AR0", f"127.0.0.1:{ports[0]}")
    Config.set("reconfigurator.RC0", f"127.0.0.1:{ports[1]}")
    Config.set("STATS_LOG_PERIOD_S", "0.5")
    Config.set("SSL_MODE", "SERVER_AUTH")
    Config.set("SSL_KEY_FILE", key)
    Config.set("SSL_CERT_FILE", crt)
    Config.set("SSL_CA_FILE", crt)
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=8, window=8, req_lanes=4,
                                             n_replicas=1)
    Node = pkg.mod("reconfigurable_node").ReconfigurableNode
    Noop = pkg.mod("models").NoopPaxosApp
    nodes = [Node(n, Noop, ar_cfg=cfg, rc_cfg=cfg, tick_interval=0.01, **pkg.dev)
             for n in ("AR0", "RC0")]
    for n in nodes:
        n.start()
    try:
        ctx = ssl.create_default_context(cafile=crt)
        ctx.check_hostname = False  # node identity = address book
        off = Config.get_int(pkg.mod("paxos_config").PC.HTTP_PORT_OFFSET)
        seen_keys = {}
        for port, want in ((ports[1] + off, "placement"), (ports[0] + off, "stats")):
            with urllib.request.urlopen(f"https://127.0.0.1:{port}/stats", timeout=10,
                                        context=ctx) as resp:
                body = json.loads(resp.read())
            assert want in body, (port, body)
            seen_keys[want] = sorted(body)
            with urllib.request.urlopen(f"https://127.0.0.1:{port}/metrics", timeout=10,
                                        context=ctx) as resp:
                text = resp.read().decode()
            assert "# delayprofiler" in text
        deadline = time.time() + 30
        seen = ""
        while time.time() < deadline:
            with urllib.request.urlopen(f"https://127.0.0.1:{ports[1] + off}/metrics",
                                        timeout=10, context=ctx) as resp:
                seen = resp.read().decode()
            if "gp_process_rss_bytes" in seen:
                break
            time.sleep(0.5)
        assert "gp_process_rss_bytes" in seen
        assert "gp_process_open_fds" in seen
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{ports[1] + off}/stats", timeout=5)
        return {"keys": seen_keys,
                "process": sorted({ln.split("{")[0].split(" ")[0] for ln in seen.splitlines()
                                   if ln.startswith("gp_process")})}
    finally:
        for n in nodes:
            n.stop()
        Config.clear()


def test_rc_http_stats_and_metrics_under_tls(tmp_path):
    key, crt = _make_cert(tmp_path)
    out = [tls_fronts(pkg, key, crt) for pkg in PKGS]
    # the AR front's /stats of the port carries its port-only engine
    # fields inside "stats" (ROADMAP §C, "Port-only fields and ops"):
    # the top-level keys compared here are the same
    assert out[1] == out[0]
