"""Sharded serving (``serving/``) on the port against the JAX package.

* ``shard_of_name`` equals the JAX package's for thousands of seeded
  names at several worker counts (a mixed deployment can never disagree
  on a name's shard), and ``apply_worker_view`` leaves both packages'
  configuration with the same effective view; the JAX file's own shard
  tests run on the port;
* ``run_sharded_soak(20260804, workers=2, rounds=30, n_names=6)`` on both
  packages: equal result dictionaries and member end states, each shard
  passing the soak's audits (``torch_soak.parity``);
* the router's split of a mixed binary/JSON client frame into per-shard
  frames, and its demultiplexing of worker replies back to each client
  connection, byte for byte against the JAX router's output;
* the supervisor spawns the port's worker module with the parent's
  effective device in every worker's argv, and with a card the parent
  builds the kernel libraries before it spawns.
"""

import sys

import numpy as np
import pytest

import gigapaxos_tpu.serving as jserving
import gigapaxos_tpu.serving.router as jrouter
import gigapaxos_tpu_torch.serving as tserving
import gigapaxos_tpu_torch.serving.router as trouter
import gigapaxos_tpu_torch.serving.supervisor as tsupervisor
from gigapaxos_tpu.net import codec as jcodec
from gigapaxos_tpu.net import hot_codec as jhot
from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.net import codec as tcodec
from gigapaxos_tpu_torch.net import hot_codec as thot
from gigapaxos_tpu_torch.paxos_config import PC
from gigapaxos_tpu_torch.utils.config import Config
from torch_soak import in_child


@pytest.fixture(autouse=True)
def _clear_both():
    Config.clear()
    JaxConfig.clear()
    yield
    Config.clear()
    JaxConfig.clear()


def _names(n, seed=20260804):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-_./"))
    out = []
    for i in range(n):
        k = int(rng.integers(1, 40))
        out.append("".join(alpha[rng.integers(0, len(alpha), k)]) + f"#{i}")
    out += ["", "svc", "é-ünïcode-名前"]
    return out


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 7, 16])
def test_shard_of_name_matches_the_reference(n_workers):
    names = _names(4096)
    port = [tserving.shard_of_name(nm, n_workers) for nm in names]
    ref = [jserving.shard_of_name(nm, n_workers) for nm in names]
    assert port == ref
    assert tserving.partition_by_shard(names, n_workers) == \
        jserving.partition_by_shard(names, n_workers)


@pytest.mark.parametrize("w, n_workers", [(0, 2), (1, 2), (2, 4), (3, 8)])
def test_apply_worker_view_matches_the_reference(w, n_workers):
    """Both packages' config, given the same file and override tiers,
    hold the same effective view after ``apply_worker_view``."""
    for cfg in (Config, JaxConfig):
        cfg.set("active.AR0", "127.0.0.1:2000")
        cfg.set("active.AR1", "10.0.0.2:2001")
        cfg.set("active.AR2", "10.0.0.3:2002")
        cfg.set("reconfigurator.RC0", "127.0.0.1:3000")
        cfg.set("ENGINE_ROWS", "65536")
        cfg.set("SERVING_WORKERS", str(n_workers))
    tserving.apply_worker_view(w, n_workers)
    jserving.apply_worker_view(w, n_workers)
    assert Config.overrides() == JaxConfig.overrides()
    for role in ("active", "reconfigurator"):
        assert Config.node_addresses(role) == JaxConfig.node_addresses(role)
    assert Config.get_int(PC.ENGINE_ROWS) == max(64, 65536 // n_workers)
    assert tserving.worker_address(("h", 2000), w) == \
        jserving.worker_address(("h", 2000), w)


def test_shard_of_name_deterministic_and_spread():
    names = [f"svc{i}" for i in range(512)]
    a = [tserving.shard_of_name(nm, 4) for nm in names]
    assert a == [tserving.shard_of_name(nm, 4) for nm in names]
    counts = [a.count(w) for w in range(4)]
    assert all(c > 64 for c in counts), counts
    assert all(tserving.shard_of_name(nm, 1) == 0 for nm in names[:8])


def test_partition_by_shard_covers_everything():
    names = [f"p{i}" for i in range(40)]
    parts = tserving.partition_by_shard(names, 3)
    assert sorted(nm for sub in parts.values() for nm in sub) == sorted(names)
    for w, sub in parts.items():
        assert all(tserving.shard_of_name(nm, 3) == w for nm in sub)


def test_apply_worker_view():
    Config.set("active.AR0", "127.0.0.1:2000")
    Config.set("active.AR1", "10.0.0.2:2001")
    Config.set("reconfigurator.RC0", "127.0.0.1:3000")
    Config.set("ENGINE_ROWS", "1024")
    Config.set("SERVING_WORKERS", "4")
    off = Config.get_int(PC.SERVING_WORKER_PORT_OFFSET)
    tserving.apply_worker_view(2, 4)
    acts = Config.node_addresses("active")
    assert acts["AR0"] == ("127.0.0.1", 2000 + off + 2)
    assert acts["AR1"] == ("10.0.0.2", 2001 + off + 2)
    assert Config.node_addresses("reconfigurator")["RC0"] == ("127.0.0.1", 3000)
    assert Config.get_int(PC.ENGINE_ROWS) == 256
    assert Config.get_int(PC.SERVING_WORKERS) == 1


def test_sharded_soak_parity_20260804():
    out = in_child("parity", "sharded_soak", 20260804, workers=2, rounds=30,
                   n_names=6)
    assert out["workers"] == 2


# ---------------------------------------------------------------------------
# the router's split and demux, in process, against the JAX router
# ---------------------------------------------------------------------------


def _router(mod, cfg, n_workers=3):
    cfg.set("active.AR0", "127.0.0.1:2000")
    cfg.set("active.AR1", "127.0.0.1:2001")
    r = mod.ShardRouter("AR0", n_workers)
    sent = []
    r._send_worker = lambda w, frame: sent.append((w, frame))
    return r, sent


def _route_and_demux(mod, hot, codec, cfg):
    """Drive one router: a binary and a JSON client frame in (from two
    connections), then worker replies back; returns every frame it
    forwarded to a worker and every frame it sent to a client."""
    r, sent = _router(mod, cfg)
    to_client = {"bin": [], "json": []}
    try:
        names = [f"nm{i}" for i in range(12)]
        items = [(1000 + i, nm, f"v{i}", False) for i, nm in enumerate(names)]
        bin_reply, json_reply = to_client["bin"].append, to_client["json"].append
        r._on_message(hot.encode_request_batch(7, items), None, bin_reply)
        reqs = [{"name": nm, "request_id": 2000 + i, "value": f"j{i}"}
                for i, nm in enumerate(names[:7])]
        r._on_message(codec.encode_json("client_request_batch", 8, {"reqs": reqs}),
                      None, json_reply)
        r._on_message(codec.encode_json("client_request", 8, reqs[0]), None,
                      json_reply)
        routed = list(sent)
        # workers answer: a binary batch mixing both clients' requests, a
        # JSON batch with an overload shed (kept for the retransmit), one
        # JSON single; an unknown request id is dropped
        resp = [{"request_id": 1000 + i, "name": nm, "response": f"r{i}"}
                for i, nm in enumerate(names[:6])]
        resp += [{"request_id": 2000 + i, "name": names[i], "response": f"s{i}"}
                 for i in range(3)]
        r._on_worker_frame(hot.encode_response_batch(5, resp))
        r._on_worker_frame(codec.encode_json("client_response_batch", 6, {"resps": [
            {"request_id": 1006, "name": names[6], "response": "r6"},
            {"request_id": 2003, "name": names[3], "error": "overload"},
            {"request_id": 99, "name": "ghost", "response": "x"},
        ]}))
        r._on_worker_frame(codec.encode_json(
            "client_response", 6,
            {"request_id": 2003, "name": names[3], "response": "s3"}))
        return routed, to_client, r.n_routed
    finally:
        r.link.close()  # the transport was never started


def test_router_split_and_demux_match_the_reference():
    port = _route_and_demux(trouter, thot, tcodec, Config)
    ref = _route_and_demux(jrouter, jhot, jcodec, JaxConfig)
    routed, to_client, n = port
    assert n == 12 + 7 + 1
    # every forwarded frame carries only its shard's names
    for w, frame in routed:
        if frame[:1] == b"R":
            _s, items = thot.decode_request_batch(frame)
            got = [it[1] for it in items]
        else:
            _k, _s, body = tcodec.decode_json(frame)
            got = [b["name"] for b in body.get("reqs", [body])]
        assert got and all(tserving.shard_of_name(nm, 3) == w for nm in got)
    assert {w for w, _ in routed} == {0, 1, 2}
    assert len(to_client["bin"]) == 2 and len(to_client["json"]) == 3
    assert port == ref


# ---------------------------------------------------------------------------
# the supervisor's spawn line and the build before spawning
# ---------------------------------------------------------------------------


class _FakeProc:
    def __init__(self, argv, **kw):
        self.argv, self.kw = argv, kw

    def poll(self):
        return None

    def terminate(self):
        pass

    def wait(self, timeout=None):
        return 0


def _spawned(monkeypatch, device, cuda=False):
    spawned, built = [], []
    monkeypatch.setattr(tsupervisor.subprocess, "Popen",
                        lambda argv, **kw: spawned.append(argv) or _FakeProc(argv))
    from gigapaxos_tpu_torch.ops import engine, gp_kernels

    monkeypatch.setattr(gp_kernels, "build", lambda force=False: built.append(1) or {})
    if cuda:
        monkeypatch.setattr(engine.torch.cuda, "is_available", lambda: True)
    Config.set("active.AR0", "127.0.0.1:2000")
    Config.set("ENGINE_ROWS", "128")
    Config.set("DEVICE", "cuda")  # an override the parent's device must beat
    node = trouter.ShardedActiveNode("AR0", 2, device=device)
    monkeypatch.setattr(node.supervisor, "wait_listening", lambda *a: True)
    monkeypatch.setattr(node.router, "start", lambda: None)
    node.start()
    node.router.link.close()
    return spawned, built


def test_supervisor_spawns_the_port_worker_on_the_parent_device(monkeypatch):
    spawned, built = _spawned(monkeypatch, "cpu")
    assert len(spawned) == 2 and not built
    for w, argv in enumerate(spawned):
        assert argv[:3] == [sys.executable, "-m", "gigapaxos_tpu_torch.serving.worker"]
        assert argv[-2:] == ["AR0", str(w)]
        devs = [a for a in argv if a.startswith("DEVICE=")]
        assert devs[-1] == "DEVICE=cpu", argv
        # the shipped override tiers ride along, the device last
        assert "ENGINE_ROWS=128" in argv
        assert argv.index(devs[-1]) > argv.index("ENGINE_ROWS=128")


def test_sharded_parent_builds_the_kernels_before_spawning(monkeypatch):
    spawned, built = _spawned(monkeypatch, None, cuda=True)
    assert built == [1] and len(spawned) == 2
    for argv in spawned:
        assert [a for a in argv if a.startswith("DEVICE=")][-1] == "DEVICE=cuda"


def test_sharded_node_without_a_device_raises_with_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    Config.set("active.AR0", "127.0.0.1:2000")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trouter.ShardedActiveNode("AR0", 2)


def test_worker_entry_without_a_device_raises_with_no_card(tmp_path):
    """``python -m gigapaxos_tpu_torch.serving.worker`` with no DEVICE and
    no card fails before it serves (no silent CPU engine)."""
    import os
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from gigapaxos_tpu_torch.testing.ports import free_ports

    port = free_ports(1)[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "gigapaxos_tpu_torch.serving.worker",
         f"active.AR0=127.0.0.1:{port}", "ENGINE_ROWS=128", "SERVING_WORKERS=2",
         "AR0", "0"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]

