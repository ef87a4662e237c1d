"""The port's HTTP fronts and a sharded active node over real sockets, on
the CPU.

* ``tests/test_reconfigurable_node.py::test_http_front_ends`` on the
  port's 3 actives + 3 reconfigurators (``device="cpu"``): a REST create
  and resolve through a reconfigurator's front, an app request POSTed to
  an active's front (answered as the binary path answers it: the next
  link of the name's hash chain), a REST delete; ``GET /stats`` and
  ``GET /metrics`` from both fronts;
* "HTTP port taken: binary protocol still serves": a node whose HTTP port
  is bound by someone else boots without its front and still serves
  binary clients;
* ``tests/test_serving_workers.py::test_sharded_node_socket_smoke`` on the
  port: one active with ``SERVING_WORKERS=2`` boots a parent router over
  two worker processes (``DEVICE=cpu``), which serve creates and requests
  on both shards; the aggregated ``stats`` op reports both workers
  serving, their launch counts and their (CPU: no) card memory;
* names created through a reconfigurator on sharded actives land inside
  their worker's rows (a deliberate divergence, ROADMAP section C), and
  the admin plane's ``app_state`` reads a member's state on its shard.
"""

import hashlib
import json
import socket
import urllib.request

import pytest

from gigapaxos_tpu_torch.clients.paxos_client import PaxosClientAsync
from gigapaxos_tpu_torch.models.apps import HashChainApp
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.paxos_config import PC
from gigapaxos_tpu_torch.reconfigurable_node import ReconfigurableNode
from gigapaxos_tpu_torch.serving import shard_of_name
from gigapaxos_tpu_torch.serving.router import ShardedActiveNode
from gigapaxos_tpu_torch.testing.ports import free_ports
from gigapaxos_tpu_torch.utils.config import Config
from test_torch_reconfigurable_node import _boot, _shutdown, _wait


def _chain(values):
    h = ""
    for v in values:
        h = hashlib.sha256((h + v).encode("utf-8")).hexdigest()
    return h


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=20):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_http_front_ends():
    nodes, client = _boot(HashChainApp, EngineConfig(32, 8, 4, 3),
                          EngineConfig(8, 8, 4, 3))
    try:
        off = Config.get_int(PC.HTTP_PORT_OFFSET)
        rc, ar = nodes[3].servers[0], nodes[0].servers[0]
        assert rc._http is not None and ar._http is not None
        rc_url = f"http://127.0.0.1:{rc.transport.listen_port + off}"
        ar_url = f"http://127.0.0.1:{ar.transport.listen_port + off}"

        code, body = _post(rc_url, {"type": "CREATE", "name": "httpsvc",
                                    "actives": [0, 1, 2]})
        assert code == 200 and body["ok"], body
        _code, _ct, text = _get(f"{rc_url}/?name=httpsvc")
        resolved = json.loads(text)
        assert resolved["ok"] and sorted(resolved["actives"]) == [0, 1, 2]

        code, body = _post(ar_url, {"name": "httpsvc", "request": "via-http"})
        assert code == 200, body
        # the binary path's answer: the first link of the name's chain
        assert body == {"name": "httpsvc", "response": _chain(["via-http"])[:16]}
        apps = [nodes[i].servers[0].manager.app for i in range(3)]
        assert _wait(lambda: all(a.state.get("httpsvc") == _chain(["via-http"])
                                 for a in apps), 20)

        for url in (rc_url, ar_url):
            code, ctype, text = _get(f"{url}/stats")
            assert code == 200 and ctype == "application/json"
            assert "stats" in json.loads(text)
            code, ctype, text = _get(f"{url}/metrics")
            assert code == 200 and ctype.startswith("text/plain")
            assert "# delayprofiler " in text
        assert "placement" in json.loads(_get(f"{rc_url}/stats")[2])

        code, body = _post(rc_url, {"type": "DELETE", "name": "httpsvc"})
        assert code == 200 and body["ok"], body
    finally:
        _shutdown(nodes, client)


def test_http_port_taken_binary_still_serves():
    ports = free_ports(2)
    Config.clear()
    Config.set("active.AR0", f"127.0.0.1:{ports[0]}")
    Config.set("reconfigurator.RC0", f"127.0.0.1:{ports[1]}")
    off = Config.get_int(PC.HTTP_PORT_OFFSET)
    squat = socket.socket()
    squat.bind(("127.0.0.1", ports[0] + off))
    squat.listen(1)
    node = ReconfigurableNode("AR0", HashChainApp, ar_cfg=EngineConfig(8, 8, 4, 1),
                              rc_cfg=EngineConfig(8, 8, 4, 1), device="cpu")
    node.start()
    client = PaxosClientAsync([("127.0.0.1", ports[0])])
    try:
        assert node.servers[0]._http is None
        assert client.create_paxos_instance("busy", [0], timeout=30)
        assert client.send_request_sync("busy", "x", timeout=30) == _chain(["x"])[:16]
    finally:
        client.close()
        node.stop()
        squat.close()
        Config.clear()


def test_sharded_node_socket_smoke():
    Config.clear()
    port = free_ports(1)[0]
    Config.set("active.AR0", f"127.0.0.1:{port}")
    Config.set("ENGINE_ROWS", "128")
    Config.set("SLOT_WINDOW", "8")
    Config.set("SERVING_WORKERS", "2")
    Config.set("APPLICATION", "gigapaxos_tpu_torch.models.apps.HashChainApp")
    node = ReconfigurableNode("AR0", HashChainApp, device="cpu")
    assert isinstance(node.servers[0], ShardedActiveNode)
    node.start()
    client = PaxosClientAsync([("127.0.0.1", port)])
    try:
        names = [f"shard-smoke-{i}" for i in range(6)]
        assert {shard_of_name(nm, 2) for nm in names} == {0, 1}
        for nm in names:
            assert client.create_paxos_instance(nm, [0], timeout=30), nm
        for i, nm in enumerate(names):
            resp = client.send_request_sync(nm, f"v{i}", timeout=30)
            assert resp == _chain([f"v{i}"])[:16], (nm, resp)
        st = client.admin_sync(0, {"op": "stats"}, timeout=20)
        assert st and st.get("ok"), st
        assert st["phase"] == "serving"
        srv = st["serving"]
        assert srv["serving_workers"] == 2
        assert srv["worker_phases"] == ["serving", "serving"]
        assert len(st["workers"]) == 2 and srv["requests_routed"] >= 6
        # per worker: its own launch counters (plain engine: no kernels)
        # and no card memory on the CPU
        engines = [w["engine"] for w in st["workers"]]
        assert all(set(e["launches"]) >= {"gp_step", "gp_make_blob"}
                   and e["launches"]["gp_step"] == 0 for e in engines), engines
        assert [e["device_memory"] for e in engines] == [None, None]
        hosted = [w["residency"]["active_names"] for w in st["workers"]]
        assert sum(hosted) == 6 and all(h > 0 for h in hosted), hosted
    finally:
        client.close()
        node.stop()
        Config.clear()


def test_sharded_actives_behind_reconfigurators():
    """Names created through a reconfigurator land on sharded actives at
    rows inside their worker's engine: the reconfigurators probe rows in
    ``ENGINE_ROWS / SERVING_WORKERS``, a deliberate divergence from the
    JAX package, which probes ``ENGINE_ROWS`` and can place a name beyond
    its worker's rows (ROADMAP section C).  At 128 rows and 2 workers of
    64, most of these names' rows in the full space are 64 or more."""
    from gigapaxos_tpu_torch.clients.reconfigurable_client import ReconfigurableAppClient
    from gigapaxos_tpu_torch.reconfiguration.reconfigurator import row_for

    Config.clear()
    ports = free_ports(2)
    Config.set("active.AR0", f"127.0.0.1:{ports[0]}")
    Config.set("reconfigurator.RC0", f"127.0.0.1:{ports[1]}")
    Config.set("ENGINE_ROWS", "128")
    Config.set("SLOT_WINDOW", "8")
    Config.set("SERVING_WORKERS", "2")
    Config.set("APPLICATION", "gigapaxos_tpu_torch.models.apps.HashChainApp")
    names = [f"rcsh{i}" for i in range(8)]
    assert sum(row_for(nm, 0, 0, 128) >= 64 for nm in names) >= 3
    nodes = [ReconfigurableNode(n, HashChainApp, rc_cfg=EngineConfig(8, 8, 4, 1),
                                device="cpu") for n in ("AR0", "RC0")]
    assert nodes[1].servers[0].reconfigurator.n_groups == 64
    for n in nodes:
        n.start()
    client = ReconfigurableAppClient.from_properties()
    admin = PaxosClientAsync([("127.0.0.1", ports[0])])
    try:
        acks = client.create_names(names, timeout=60)
        assert all((acks.get(nm) or {}).get("ok") for nm in names), acks
        for nm in names:
            resp = client.send_request_sync(nm, "v", timeout=30)
            assert resp == _chain(["v"])[:16], (nm, resp)
            st = admin.admin_sync(0, {"op": "app_state", "name": nm}, timeout=20)
            assert st["hosted"] and 0 <= st["row"] < 64, st
            assert json.loads(st["checkpoint"]) == {"h": _chain(["v"]), "n": 1}
    finally:
        admin.close()
        client.close()
        for n in nodes:
            n.stop()
        Config.clear()


@pytest.fixture(autouse=True)
def _clear():
    yield
    Config.clear()
