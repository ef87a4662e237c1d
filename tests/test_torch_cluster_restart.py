"""Whole-cluster crash and restart on both packages:
``tests/test_cluster_restart.py`` run on the JAX package and the port
(``device="cpu"``).

Six journaled nodes (AR0..AR2, RC0..RC2) serve a name, stop cold, and new
node objects on the same directories and ports recover the records, the
name map and the app state, then serve a request that continues the
history (``TESTPaxosMain.java:154``).  Both packages must give the same
responses before and after the restart (the hash chain is deterministic)
and the same recovered replica states.
"""

import time

from torch_pkgs import JAX, PKGS, TORCH


def _boot(pkg, tmp_path, ports):
    Config = pkg.mod("utils.config").Config
    Config.clear()
    for i in range(3):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[3 + i]}")
    EngineConfig = pkg.mod("ops.engine").EngineConfig
    ar_cfg = EngineConfig(n_groups=32, window=8, req_lanes=4, n_replicas=3)
    rc_cfg = EngineConfig(n_groups=8, window=8, req_lanes=4, n_replicas=3)
    Node = pkg.mod("reconfigurable_node").ReconfigurableNode
    HashChainApp = pkg.mod("models.apps").HashChainApp
    nodes = [
        Node(name, HashChainApp, ar_cfg=ar_cfg, rc_cfg=rc_cfg,
             log_dir=str(tmp_path / name), **pkg.dev)
        for name in [f"AR{i}" for i in range(3)] + [f"RC{i}" for i in range(3)]
    ]
    for n in nodes:
        n.start()
    return nodes


def _client(pkg):
    return pkg.mod("clients.reconfigurable_client").ReconfigurableAppClient.from_properties()


def _run(pkg, tmp_path):
    ports = pkg.mod("testing.ports").free_ports(6)
    nodes = _boot(pkg, tmp_path, ports)
    client = _client(pkg)
    out = {}
    try:
        ack = client.create_name("dur", actives=[0, 1, 2], timeout=60)
        assert ack and ack.get("ok"), ack
        out["pre"] = [client.send_request_sync("dur", f"v{i}", timeout=20)
                      for i in range(12)]
    finally:
        client.close()
        for n in nodes:
            n.stop()

    time.sleep(0.5)
    nodes = _boot(pkg, tmp_path, ports)
    client = _client(pkg)
    try:
        acts = None
        deadline = time.time() + 60
        while time.time() < deadline and not acts:
            acts = client.request_actives("dur", timeout=5, force=True)
        out["actives"] = sorted(acts or [])
        out["post"] = client.send_request_sync("dur", "after", timeout=30)
        deadline = time.time() + 30
        states = set()
        while time.time() < deadline:
            states = {n.servers[0].manager.app.state.get("dur") for n in nodes[:3]}
            if len(states) == 1 and None not in states:
                break
            time.sleep(0.5)
        out["states"] = sorted(states, key=str)
        return out
    finally:
        client.close()
        for n in nodes:
            n.stop()
        pkg.mod("utils.config").Config.clear()


def test_full_cluster_restart_resumes_service(tmp_path):
    got = {pkg.root: _run(pkg, tmp_path / pkg.root) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    r = got[TORCH.root]
    assert None not in r["pre"]
    assert r["actives"] == [0, 1, 2]
    # the response continues the pre-restart history: the 13-step chain
    expect = TORCH.mod("models.apps").HashChainApp()
    for v in [f"v{i}" for i in range(12)] + ["after"]:
        req = expect.get_request(v)
        req.paxos_id = "dur"
        expect.execute(req)
    assert r["post"] == req.response_value
    assert len(r["states"]) == 1 and r["states"][0] is not None
