"""The port's loopback server path on the CPU.

The reference's ``tests/test_server.py::test_loopback_1_group_end_to_end``
scenario run on the port with ``device="cpu"``: 3 PaxosServers on real
loopback sockets, a PaxosClientAsync and a StatefulAdderApp.  Every
response is the expected running total, all replicas converge to the same
app state, and a retransmitted request id is answered without
re-execution.  A second case checks that the server's ``D`` frames carry
the same bytes as the reference codec for the same blob vector.
"""

import time

import numpy as np
import pytest

from gigapaxos_tpu_torch.clients import PaxosClientAsync
from gigapaxos_tpu_torch.models import StatefulAdderApp
from gigapaxos_tpu_torch.net.node_config import NodeConfig
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.server import PaxosServer
from gigapaxos_tpu_torch.testing.ports import free_ports
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

CFG = EngineConfig(n_groups=6, window=8, req_lanes=4, n_replicas=3)


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def wait_until(cond, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def test_loopback_1_group_end_to_end_on_port():
    ports = free_ports(3)
    nc = NodeConfig({i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    servers = [
        PaxosServer(i, nc, StatefulAdderApp(), CFG, tick_interval=0.01,
                    fd_timeout_s=2.0, device="cpu")
        for i in range(3)
    ]
    for s in servers:
        s.start()
    client = PaxosClientAsync([("127.0.0.1", p) for p in ports])
    try:
        assert all(s.manager.device.type == "cpu" for s in servers)
        assert client.create_paxos_instance("svc", [0, 1, 2], timeout=30)
        total = 0
        for i in range(5):
            resp = client.send_request_sync("svc", str(i + 1), timeout=30)
            total += i + 1
            assert resp == str(total), (resp, total)
        assert wait_until(lambda: all(
            s.manager.app.totals.get("svc") == total for s in servers
        ))
        # duplicate request id answered from cache, not re-executed
        client.send_request("svc", "999")
        time.sleep(1.0)
        client.send_request_sync("svc", "999")  # fresh id, executes
        assert wait_until(lambda: all(
            s.manager.app.totals.get("svc") == total + 999 + 999
            for s in servers
        ))
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_blob_frames_match_reference_codec():
    """D frames: the port's codec (leaf table from its own engine) gives
    the reference's bytes for the same blob, both per-leaf and packed."""
    import jax.numpy as jnp
    import torch

    from gigapaxos_tpu.net import codec as jcodec
    from gigapaxos_tpu.ops import engine as je
    from gigapaxos_tpu_torch.net import codec as tcodec
    from gigapaxos_tpu_torch.ops import engine as te

    rng = np.random.default_rng(3)
    G, W = CFG.n_groups, CFG.window
    d = {}
    for f in te.EngineState._fields:
        shape = (G,) if f in ("member_mask", "majority", "version", "stopped",
                              "tag", "bal", "exec_slot", "app_hash", "n_execd",
                              "c_phase", "c_bal", "c_next_slot") else (G, W)
        d[f] = rng.integers(-1, 300, size=shape).astype(np.int32)
    d["c_phase"] = rng.integers(0, 3, size=G).astype(np.int32)
    jb = je.make_blob(je.EngineState(**{k: jnp.asarray(v) for k, v in d.items()}))
    tb = te.make_blob(te.EngineState(**{k: torch.as_tensor(v) for k, v in d.items()}))
    jcfg = je.EngineConfig(*CFG)
    a = jcodec.encode_blob(2, 17, jb)
    b = tcodec.encode_blob(2, 17, te.Blob(*(x.numpy() for x in tb)))
    assert a == b
    vec = te.pack_blob(tb).numpy()
    assert tcodec.encode_blob_vec(2, 17, vec) == jcodec.encode_blob_vec(
        2, 17, np.asarray(je.pack_blob(jb))) == a
    sender, tick, back = tcodec.decode_blob_vec(a, CFG)
    assert (sender, tick) == (2, 17)
    np.testing.assert_array_equal(back, vec)
    _s, _t, leaves = tcodec.decode_blob(a, CFG)
    _sj, _tj, leaves_j = jcodec.decode_blob(a, jcfg)
    for x, y in zip(leaves, leaves_j):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_latest_wins_blob_sends_coalesce():
    """The port's one transport divergence: ``send_latest_to_id`` keeps at
    most one queued frame per (peer, key); a burst of snapshots reaches
    the receiver in order, ending with the newest, possibly skipping
    superseded ones — while ordinary sends are never coalesced."""
    _check_latest_wins(None)


def test_latest_wins_blob_sends_coalesce_under_link_delay():
    """With a link-delay emulator set, latest-wins frames take the same
    coalescing queue after the delay."""
    _check_latest_wins(lambda addr: 0.02)


def _check_latest_wins(delay_fn):
    import threading

    from gigapaxos_tpu_torch.net.transport import MessageTransport

    ports = free_ports(2)
    nc = NodeConfig({i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    got, lock, done = [], threading.Lock(), threading.Event()

    def handler(payload, sender, reply):
        with lock:
            got.append(payload)
            if payload == b"plain-last":
                done.set()

    rx = MessageTransport(1, nc, handler)
    tx = MessageTransport(0, nc, lambda *a: None)
    tx.delay_fn = delay_fn
    rx.start()
    tx.start()
    try:
        big = 1 << 20
        for i in range(40):
            assert tx.send_latest_to_id(1, "blob", bytes([i]) * big)
        for i in range(5):
            assert tx.send_to_id(1, b"plain-%d" % i)
        assert tx.send_to_id(1, b"plain-last")
        assert done.wait(30)
        assert wait_until(lambda: any(
            p[:1] == bytes([39]) and len(p) == big for p in list(got)), 30)
        with lock:
            blobs = [p[0] for p in got if len(p) == big]
            plain = [p for p in got if len(p) != big]
        assert blobs == sorted(blobs) and blobs[-1] == 39
        assert len(blobs) + tx.n_coalesced == 40
        assert plain == [b"plain-%d" % i for i in range(5)] + [b"plain-last"]
    finally:
        tx.stop()
        rx.stop()
