"""Loopback soaks on the port, the counterpart of ``tests/test_loopback_soak.py``
(ref: ``tests/loopback_1_group/testing.properties:1-9``, 10,000 requests
at 1,000 req/s over 1 group x 3 replicas on 127.0.0.1, and the
``loopback_10_groups`` variant): fixed-load soaks against the deployable
node path (sockets and client) of the port on the CPU, held to the
reference probe's bar: at least 90% answered, mean latency under 2 s.
The JAX package's own file holds the reference to the same bar.

Two topologies, each at the reference test's active engine (32 rows,
W=16, K=8, R=3): the port's nodes one process each, booted by the port's
launcher (``gigapaxos_tpu_torch.gp_server``, ``--device cpu``); and the
reference test's own, six nodes in this process (``ReconfigurableNode``
with ``device="cpu"``, the reconfigurators' engine at 8 rows, W=8, K=4),
the plain steps of one process run one at a time (``ops/engine.py``
``_PLAIN_LOCK``) and one intra-op thread, as the port's probe gives its
CPU nodes.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import torch

from gigapaxos_tpu_torch.clients.reconfigurable_client import ReconfigurableAppClient
from gigapaxos_tpu_torch.models.apps import NoopPaxosApp
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.reconfigurable_node import ReconfigurableNode
from gigapaxos_tpu_torch.testing.ports import free_ports
from gigapaxos_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = tmp_path_factory.mktemp("loopback_soak")
    ports = free_ports(6)
    cfg = d / "soak.properties"
    cfg.write_text("\n".join(
        [f"active.AR{i}=127.0.0.1:{ports[i]}" for i in range(3)]
        + [f"reconfigurator.RC{i}=127.0.0.1:{ports[3 + i]}" for i in range(3)]
        + ["APPLICATION=gigapaxos_tpu_torch.models.apps.NoopPaxosApp",
           "ENGINE_ROWS=32", "SLOT_WINDOW=16", ""]))
    gp = [sys.executable, "-m", "gigapaxos_tpu_torch.gp_server", "--config", str(cfg),
          "--run-dir", str(d / "run")]
    # one intra-op thread a node, as the port's probe gives its CPU nodes
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    try:
        r = subprocess.run(gp + ["--device", "cpu", "start", "all"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, (r.stdout, r.stderr)
        Config.clear()
        Config.load_file(str(cfg))
        client = ReconfigurableAppClient.from_properties()
        yield client
        client.close()
    finally:
        subprocess.run(gp + ["stop", "all"], cwd=REPO, capture_output=True, timeout=120)
        Config.clear()


@pytest.fixture(scope="module")
def in_process():
    """The reference test's topology: 3 actives and 3 reconfigurators in
    this process (``tests/test_loopback_soak.py``'s fixture), on the CPU."""
    ports = free_ports(6)
    Config.clear()
    for i in range(3):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[3 + i]}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ar_cfg = EngineConfig(n_groups=32, window=16, req_lanes=8, n_replicas=3)
    rc_cfg = EngineConfig(n_groups=8, window=8, req_lanes=4, n_replicas=3)
    nodes = [ReconfigurableNode(f"{kind}{i}", NoopPaxosApp, ar_cfg=ar_cfg,
                                rc_cfg=rc_cfg, device="cpu")
             for kind in ("AR", "RC") for i in range(3)]
    try:
        for n in nodes:
            n.start()
        client = ReconfigurableAppClient.from_properties()
        yield client
        client.close()
    finally:
        for n in nodes:
            n.stop()
        torch.set_num_threads(threads)
        Config.clear()


def soak(client, names, n_requests, rate, latency_grace_s=2.0):
    """Fire ``n_requests`` at ``rate``/s round-robin over ``names``;
    returns (response_rate, mean_latency_s)."""
    lock = threading.Lock()
    lats = []

    def cb_factory(t0):
        def cb(rid, resp, error):
            if not error:
                with lock:
                    lats.append(time.time() - t0)
        return cb

    interval = 1.0 / rate
    next_t = time.time()
    for i in range(n_requests):
        now = time.time()
        while now < next_t:
            time.sleep(min(interval, next_t - now))
            now = time.time()
        next_t += interval
        client.send_request(names[i % len(names)], f"s{i}", cb_factory(time.time()))
    time.sleep(latency_grace_s)
    with lock:
        n_ok = len(lats)
        mean = sum(lats) / n_ok if n_ok else float("inf")
    return n_ok / n_requests, mean


@pytest.mark.timeout(180)
def test_loopback_1_group_soak(cluster):
    """1 group x 3 replicas, 10k requests at 1k/s, >= 90% answered."""
    client = cluster
    ack = client.create_name("soak1", actives=[0, 1, 2], timeout=30)
    assert ack and ack.get("ok"), ack
    assert client.send_request_sync("soak1", "warm", timeout=15) is not None
    resp_rate, mean_lat = soak(client, ["soak1"], 10_000, 1_000.0)
    print(f"answered {resp_rate:.4f}, mean {mean_lat:.4f} s")
    assert resp_rate >= 0.90, (resp_rate, mean_lat)
    assert mean_lat < 2.0, mean_lat


@pytest.mark.timeout(180)
def test_loopback_10_groups_soak(cluster):
    """The same load spread over 10 names, >= 90% answered."""
    client = cluster
    names = [f"soak10_{i}" for i in range(10)]
    for nm in names:
        ack = client.create_name(nm, actives=[0, 1, 2], timeout=30)
        assert ack and ack.get("ok"), ack
        assert client.send_request_sync(nm, "warm", timeout=15) is not None
    resp_rate, mean_lat = soak(client, names, 10_000, 1_000.0)
    print(f"answered {resp_rate:.4f}, mean {mean_lat:.4f} s")
    assert resp_rate >= 0.90, (resp_rate, mean_lat)
    assert mean_lat < 2.0, mean_lat


@pytest.mark.timeout(180)
def test_loopback_1_group_soak_in_process(in_process):
    """The reference's topology: six nodes in one process, 1 group, 10k
    requests at 1k/s, >= 90% answered."""
    client = in_process
    ack = client.create_name("soak1", actives=[0, 1, 2], timeout=30)
    assert ack and ack.get("ok"), ack
    assert client.send_request_sync("soak1", "warm", timeout=15) is not None
    resp_rate, mean_lat = soak(client, ["soak1"], 10_000, 1_000.0)
    print(f"answered {resp_rate:.4f}, mean {mean_lat:.4f} s")
    assert resp_rate >= 0.90, (resp_rate, mean_lat)
    assert mean_lat < 2.0, mean_lat


@pytest.mark.timeout(180)
def test_loopback_10_groups_soak_in_process(in_process):
    """The same in one process over 10 names, >= 90% answered."""
    client = in_process
    names = [f"soak10_{i}" for i in range(10)]
    for nm in names:
        ack = client.create_name(nm, actives=[0, 1, 2], timeout=30)
        assert ack and ack.get("ok"), ack
        assert client.send_request_sync(nm, "warm", timeout=15) is not None
    resp_rate, mean_lat = soak(client, names, 10_000, 1_000.0)
    print(f"answered {resp_rate:.4f}, mean {mean_lat:.4f} s")
    assert resp_rate >= 0.90, (resp_rate, mean_lat)
    assert mean_lat < 2.0, mean_lat
