"""The port's deployable reconfigurable node over real sockets, on the CPU.

The JAX package's socket tests re-run on the port (``device="cpu"``, the
plain engine), at their own tiny shapes and with their own checks:

* ``tests/test_reconfigurable_node.py``: 3 actives + 3 reconfigurators
  booted from properties config, create -> requests -> migrate -> a
  request from a stale actives cache -> delete, through
  ``ReconfigurableAppClient``; the same client sequence also runs on the
  JAX package's socket deployment, and the name's ``HashChainApp`` state
  and execution count (after the first requests, and after the migration
  and the stale-cache request) must be equal on the two;
* ``tests/test_anycast_batch_create.py``: 100 batched creates (idempotent
  on re-issue) and anycast with one active dead, exactly once.

Plus the entry points' device contract: with no card and no device the
node and the stepped harness raise, ``SERVING_WORKERS > 1`` boots the
sharded parent (``serving/``) on the node's device, and the CLI (``python -m gigapaxos_tpu_torch.reconfigurable_node NAME...
DEVICE=cpu``) serves a client from one process.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from gigapaxos_tpu.clients.reconfigurable_client import ReconfigurableAppClient as JClient
from gigapaxos_tpu.models.apps import HashChainApp as JHashChain
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.packets.paxos_packets import RequestPacket as JRequest
from gigapaxos_tpu.reconfigurable_node import ReconfigurableNode as JNode
from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.clients.reconfigurable_client import ReconfigurableAppClient
from gigapaxos_tpu_torch.models.apps import HashChainApp, NoopPaxosApp
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.reconfigurable_node import ReconfigurableNode
from gigapaxos_tpu_torch.testing.ports import free_ports
from gigapaxos_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each package's entry points (the port's on the CPU)
PORT = SimpleNamespace(Node=ReconfigurableNode, Client=ReconfigurableAppClient,
                       Config=Config, EngineConfig=EngineConfig,
                       HashChainApp=HashChainApp, kw={"device": "cpu"})
JAX = SimpleNamespace(Node=JNode, Client=JClient, Config=JaxConfig,
                      EngineConfig=JConfig, HashChainApp=JHashChain, kw={})


def _boot(make_app, ar_cfg, rc_cfg, pkg=PORT):
    ports = free_ports(6)
    pkg.Config.clear()
    for i in range(3):
        pkg.Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
        pkg.Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[3 + i]}")
    nodes = [
        pkg.Node(f"{role}{i}", make_app, ar_cfg=ar_cfg, rc_cfg=rc_cfg, **pkg.kw)
        for role in ("AR", "RC") for i in range(3)
    ]
    for n in nodes:
        n.start()
    return nodes, pkg.Client.from_properties()


def _shutdown(nodes, client, pkg=PORT):
    client.close()
    for n in nodes:
        n.stop()
    pkg.Config.clear()


def _wait(pred, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return pred()


def _jax_chain(values, name="svc"):
    """The JAX package's HashChainApp state after ``values`` in order."""
    app = JHashChain()
    for v in values:
        app.execute(JRequest(paxos_id=name, request_value=v))
    return app.state[name], app.n_executed[name]


def _over_sockets(pkg):
    """The reference test's script and checks on ``pkg``; returns the
    name's (HashChainApp state, executions) after the first requests and
    after the migration and the stale-cache request."""
    nodes, client = _boot(pkg.HashChainApp, pkg.EngineConfig(32, 8, 4, 3),
                          pkg.EngineConfig(8, 8, 4, 3), pkg)
    ar = lambda i: nodes[i].servers[0]
    try:
        ack = client.create_name("svc", actives=[0, 1, 2], timeout=30)
        assert ack and ack.get("ok"), ack
        assert sorted(ack["actives"]) == [0, 1, 2]
        # wait on the record itself before resolving (a loaded box can
        # stall six in-process nodes for many seconds)
        record = lambda: nodes[3].servers[0].rc_app.get_record("svc")
        assert _wait(lambda: record() is not None and record().actives, 90)
        acts = None
        for _ in range(6):
            acts = client.request_actives("svc", timeout=10, force=True)
            if acts:
                break
        assert acts is not None and sorted(acts) == [0, 1, 2]
        values = [f"r{i}" for i in range(5)]
        for v in values:
            assert client.send_request_sync("svc", v, timeout=20) is not None, v
        apps = [ar(i).manager.app for i in range(3)]
        _wait(lambda: apps[0].state.get("svc") is not None
              and apps[0].state.get("svc") == apps[1].state.get("svc")
              == apps[2].state.get("svc"), 10)
        states = [a.state.get("svc") for a in apps]
        assert states[0] == states[1] == states[2], states
        first = (states[0], apps[0].n_executed.get("svc"))

        ack = client.reconfigure("svc", [1, 2], timeout=40)
        assert ack and ack.get("ok"), ack
        assert sorted(ack["actives"]) == [1, 2] and ack["epoch"] == 1
        assert _wait(lambda: ar(0).manager.names.get("svc") is None, 20)

        # a request from a stale actives cache lands at the departed active
        with client._lock:
            client._actives_cache["svc"] = (time.time() + 60, [0])
        resp = client.send_request_sync("svc", "post-migration", timeout=20)
        assert resp is not None, "mid-migration request did not recover"
        acts = None
        for _ in range(3):
            acts = client.request_actives("svc", force=True)
            if acts:
                break
        assert acts is not None and sorted(acts) == [1, 2]
        a1, a2 = ar(1).manager.app, ar(2).manager.app
        _wait(lambda: a1.state.get("svc") == a2.state.get("svc")
              and a1.n_executed.get("svc", 0) >= 6, 10)
        assert a1.state.get("svc") == a2.state.get("svc")
        assert a1.n_executed.get("svc", 0) >= 6
        migrated = (a1.state["svc"], a1.n_executed["svc"])

        ack = client.delete_name("svc", timeout=40)
        assert ack and ack.get("ok"), ack
        _wait(lambda: all(ar(i).manager.names.get("svc") is None for i in (1, 2)), 10)
        for i in (1, 2):
            assert ar(i).manager.names.get("svc") is None
        _wait(lambda: all(nodes[i].servers[0].rc_app.get_record("svc") is None
                          for i in (3, 4, 5)), 20)
        for i in (3, 4, 5):
            assert nodes[i].servers[0].rc_app.get_record("svc") is None
        return first, migrated
    finally:
        _shutdown(nodes, client, pkg)


def test_create_request_migrate_delete_over_sockets():
    first, migrated = _over_sockets(PORT)
    # five requests, each executed once on a chain that starts empty
    assert first == _jax_chain([f"r{i}" for i in range(5)])
    assert (first, migrated) == _over_sockets(JAX)


@pytest.fixture()
def anycast_cluster():
    nodes, client = _boot(NoopPaxosApp, EngineConfig(256, 8, 4, 3),
                          EngineConfig(16, 8, 4, 3))
    yield nodes, client
    _shutdown(nodes, client)


def test_batched_creates_few_round_trips(anycast_cluster):
    _nodes, client = anycast_cluster
    names = [f"bc{i}" for i in range(100)]
    t0 = time.time()
    results = client.create_names(names, timeout=60)
    took = time.time() - t0
    assert set(results) == set(names), (sorted(set(names) - set(results))[:5], len(results))
    bad = {n: r for n, r in results.items() if not r.get("ok")}
    assert not bad, dict(list(bad.items())[:3])
    for nm in names[::17]:
        assert client.request_actives(nm), nm
    again = client.create_names(names, timeout=60)
    assert all(r.get("ok") for r in again.values()), again
    assert any(r.get("existed") for r in again.values())
    assert took < 60, took


def test_anycast_survives_dead_active(anycast_cluster):
    nodes, client = anycast_cluster
    ack = client.create_name("any", actives=[0, 1, 2], timeout=30)
    assert ack and ack.get("ok"), ack
    assert client.send_request_sync("any", "warm", timeout=15) is not None
    mgr0 = nodes[0].servers[0].manager
    coord = mgr0.coordinator_of_row(mgr0.names["any"])
    dead = (coord + 1) % 3
    nodes[dead].stop()
    time.sleep(0.5)

    got, ev = [], threading.Event()

    def cb(rid, resp, error):
        got.append((resp, error))
        ev.set()

    rid = client.send_request_anycast("any", "hello", cb)
    assert rid is not None
    assert ev.wait(30), "no anycast response with one active dead"
    assert got[0][1] is None and got[0][0] is not None, got[0]
    ev2, out2 = threading.Event(), []
    client.send_request_anycast(
        "any", "hello", lambda r, rp, e: (out2.append((rp, e)), ev2.set()),
        request_id=rid,
    )
    assert ev2.wait(15)
    assert out2[0][1] is None


# ---------------------------------------------------------------------------
# the entry points' device contract
# ---------------------------------------------------------------------------


def _one_node_config(tmp_path, extra=""):
    ports = free_ports(2)
    props = tmp_path / "gigapaxos.properties"
    props.write_text(f"active.AR0=127.0.0.1:{ports[0]}\n"
                     f"reconfigurator.RC0=127.0.0.1:{ports[1]}\n"
                     "ENGINE_ROWS=64\nSLOT_WINDOW=8\n" + extra)
    return props


def test_node_without_a_device_raises_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    Config.clear()
    try:
        Config.set("active.AR0", "127.0.0.1:1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReconfigurableNode("AR0", HashChainApp,
                               ar_cfg=EngineConfig(8, 8, 4, 1))
    finally:
        Config.clear()


def test_cluster_without_a_device_raises_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from gigapaxos_tpu_torch.testing.rc_cluster import ReconfigurableCluster

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReconfigurableCluster(EngineConfig(8, 8, 4, 3), EngineConfig(8, 8, 4, 3),
                              HashChainApp)


def test_sharded_serving_is_not_ported():
    """The refusal of sharded serving is gone: ``SERVING_WORKERS > 1``
    gives the active role a ``ShardedActiveNode`` (the accept/route
    parent) whose workers will run on the node's device, and raises no
    ``NotImplementedError``; the reconfigurator role stays unsharded.
    (The name dates from when the port raised here; it is kept so that
    the test's record carries on.)"""
    from gigapaxos_tpu_torch.reconfigurable_node import ReconfiguratorServer
    from gigapaxos_tpu_torch.serving.router import ShardedActiveNode

    Config.clear()
    try:
        Config.set("active.AR0", "127.0.0.1:1")
        Config.set("reconfigurator.AR0", "127.0.0.1:2")
        Config.set("SERVING_WORKERS", "2")
        node = ReconfigurableNode("AR0", HashChainApp,
                                  ar_cfg=EngineConfig(8, 8, 4, 1),
                                  rc_cfg=EngineConfig(8, 8, 4, 1), device="cpu")
        sharded, rc = node.servers
        assert isinstance(sharded, ShardedActiveNode)
        assert sharded.router.n_workers == 2 and sharded.device.type == "cpu"
        assert sharded.supervisor.extra_args[-1] == "DEVICE=cpu"
        assert isinstance(rc, ReconfiguratorServer)
        sharded.router.link.close()
        if rc._http is not None:  # mounted at construction; never started
            rc._http.shutdown()
            rc._http.server_close()
        rc.manager.close()
    finally:
        Config.clear()


def test_cli_serves_on_the_cpu(tmp_path):
    """One CLI process hosts AR0 and RC0 with ``DEVICE=cpu``; a client
    creates a name and gets a reply; SIGTERM stops it cleanly."""
    props = _one_node_config(tmp_path)
    env = dict(os.environ, GIGAPAXOS_CONFIG=str(props), PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gigapaxos_tpu_torch.reconfigurable_node",
         "AR0", "RC0", "DEVICE=cpu",
         "APPLICATION=gigapaxos_tpu_torch.models.apps.HashChainApp"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    Config.clear()
    client = None
    try:
        Config.load_file(str(props))
        client = ReconfigurableAppClient.from_properties()
        ack = None
        deadline = time.time() + 60
        while ack is None and time.time() < deadline and proc.poll() is None:
            ack = client.create_name("cli", actives=[0], timeout=5)
        assert ack and ack.get("ok"), (ack, proc.poll())
        resp = client.send_request_sync("cli", "x", timeout=20)
        assert resp == _jax_chain(["x"], "cli")[0][:16]
    finally:
        if client is not None:
            client.close()
        Config.clear()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]


def test_cli_without_a_device_fails_with_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    props = _one_node_config(tmp_path)
    env = dict(os.environ, GIGAPAXOS_CONFIG=str(props), PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "gigapaxos_tpu_torch.reconfigurable_node", "AR0"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]
