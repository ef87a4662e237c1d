"""The port's transport receive path (``net/transport.py:_FrameReader``):
frames of every size, split at arbitrary points on the wire, reach the
handler whole and in order; a frame larger than the receive stage arrives
in a buffer of its own; a bad header drops the connection; replies ride
the same connection."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from gigapaxos_tpu_torch.net.node_config import NodeConfig
from gigapaxos_tpu_torch.net.transport import MAGIC, MessageTransport, _FrameReader

_HDR = struct.Struct(">II")
STAGE = _FrameReader.STAGE_BYTES


def _frame(payload: bytes) -> bytes:
    return _HDR.pack(MAGIC, len(payload)) + payload


@pytest.fixture
def transport():
    got, lock = [], threading.Lock()

    def handler(payload, peer, reply):
        with lock:
            got.append(payload)
        reply(struct.pack(">I", len(payload)))

    t = MessageTransport(0, NodeConfig({0: ("127.0.0.1", 1)}), handler,
                         listen_host="127.0.0.1", listen_port=0)
    t.start()
    try:
        yield t, got, lock
    finally:
        t.stop()


def _wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _read_replies(sock, n):
    buf = b""
    out = []
    sock.settimeout(30)
    while len(out) < n:
        chunk = sock.recv(65536)
        assert chunk, "connection closed before every reply arrived"
        buf += chunk
        while len(buf) >= _HDR.size:
            magic, length = _HDR.unpack_from(buf)
            if len(buf) < _HDR.size + length:
                break
            assert magic == MAGIC
            out.append(struct.unpack(">I", buf[_HDR.size:_HDR.size + length])[0])
            buf = buf[_HDR.size + length:]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_of_every_size_arrive_whole_and_in_order(transport, seed):
    t, got, lock = transport
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 100, 70_000, STAGE - _HDR.size, STAGE - _HDR.size + 1,
             STAGE + 1, 3_000_001, 5, 0, 18_000_000, 7]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    wire = b"".join(_frame(p) for p in payloads)
    with socket.create_connection(("127.0.0.1", t.listen_port)) as s:
        off = 0
        while off < len(wire):
            # cut the stream at arbitrary points: inside headers, inside
            # small frames, across the stage's end, inside large bodies
            n = int(rng.choice([1, 3, 7, 100, 5_000, 300_000, 4_000_000]))
            s.sendall(wire[off:off + n])
            off += n
        replies = _read_replies(s, len(payloads))
    assert replies == sizes
    with lock:
        assert [bytes(p) for p in got] == payloads
        for p, n in zip(got, sizes):
            # a frame larger than the stage is handed over in its own
            # buffer, a smaller one as bytes
            assert isinstance(p, bytearray if _HDR.size + n > STAGE else bytes)
    assert t.n_rcvd == len(payloads)


def test_bad_header_drops_the_connection(transport):
    t, got, lock = transport
    with socket.create_connection(("127.0.0.1", t.listen_port)) as s:
        s.sendall(_frame(b"ok") + _HDR.pack(MAGIC ^ 1, 4) + b"junk" + _frame(b"late"))
        s.settimeout(30)
        while s.recv(65536):
            pass  # until the node closes the connection
    assert _wait_for(lambda: len(got) >= 1)
    time.sleep(0.2)
    with lock:
        assert got == [b"ok"]


def test_stop_closes_accepted_connections(transport):
    t, got, lock = transport
    s = socket.create_connection(("127.0.0.1", t.listen_port))
    try:
        s.sendall(_frame(b"x"))
        assert _read_replies(s, 1) == [1]
        t.stop()
        s.settimeout(30)
        assert s.recv(65536) == b""
    finally:
        s.close()
