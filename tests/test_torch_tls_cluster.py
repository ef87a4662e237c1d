"""Mutual-auth TLS across the deployable cluster on both packages:
``tests/test_tls_cluster.py`` run on the JAX package and on the port
(``device="cpu"``; the port's plain steps on one intra-op thread, as its
in-process soak runs them).

Six ``ReconfigurableNode``s of a package boot with ``MUTUAL_AUTH``;
create -> request -> response runs through a certified client, the
replicas converge, and a certificate-less client is refused at the
handshake.  A ``MUTUAL_AUTH`` mesh serves ``SERVER_AUTH`` clients on the
client plane (port + ``CLIENT_PORT_OFFSET``).  Both packages give the same
acks, responses and converged app state.  Each scenario runs under a
deadline (``bounded``): a wedged handshake fails the test instead of
holding its worker.  Certificates come from a local ``openssl``; the
tests skip without it.
"""

import socket
import ssl
import subprocess
import threading
import time

import pytest
import torch

from torch_pkgs import PKGS

DEADLINE_S = 240.0


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_cert(tmp_path):
    key, crt = tmp_path / "key.pem", tmp_path / "cert.pem"
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(crt), "-days", "1", "-subj", "/CN=127.0.0.1"],
        capture_output=True, timeout=60)
    if r.returncode != 0:
        pytest.skip("openssl unavailable for cert generation")
    return str(key), str(crt)


def bounded(fn, *args):
    """``fn(*args)`` in a daemon thread; fails after ``DEADLINE_S``."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(DEADLINE_S)
    if th.is_alive():
        pytest.fail(f"{fn.__name__}{args[:1]} still running after {DEADLINE_S} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _paired_ports(n: int, offset: int):
    """``n`` free loopback ports p whose client-plane partner p + ``offset``
    is free too.  Every probe socket stays bound until all n are chosen, so
    no port or partner is handed out twice (``free_ports`` reserves no
    partner, and another worker could hold it)."""
    held, ports = [], []
    try:
        for _ in range(4096):
            if len(ports) == n:
                return ports
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            held.append(s)
            p = s.getsockname()[1]
            if p + offset > 65535:
                continue
            t = socket.socket()
            try:
                t.bind(("127.0.0.1", p + offset))
            except OSError:
                t.close()
                continue
            held.append(t)
            ports.append(p)
        raise OSError(f"no {n} loopback ports with free partners at +{offset}")
    finally:
        for s in held:
            s.close()


def _boot(pkg, key, crt, **extra):
    Config = pkg.mod("utils.config").Config
    Config.clear()
    offset = int(extra.get("CLIENT_PORT_OFFSET",
                           Config.get_int(pkg.mod("paxos_config").PC.CLIENT_PORT_OFFSET)))
    ports = _paired_ports(6, offset)
    for i in range(3):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[3 + i]}")
    for k, v in dict(SSL_MODE="MUTUAL_AUTH", SSL_KEY_FILE=key, SSL_CERT_FILE=crt,
                     SSL_CA_FILE=crt, **extra).items():
        Config.set(k, v)
    ec = pkg.mod("ops.engine").EngineConfig
    ar_cfg, rc_cfg = ec(32, 8, 4, 3), ec(8, 8, 4, 3)
    Node = pkg.mod("reconfigurable_node").ReconfigurableNode
    app = pkg.mod("models.apps").HashChainApp
    nodes = [Node(f"{kind}{i}", app, ar_cfg=ar_cfg, rc_cfg=rc_cfg, **pkg.dev)
             for kind in ("AR", "RC") for i in range(3)]
    for n in nodes:
        n.start()
    return nodes


def _bare_ctx(crt):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(crt)
    ctx.check_hostname = False  # verifies the server, presents nothing
    return ctx


def mutual_auth(pkg, key, crt):
    Client = pkg.mod("clients.reconfigurable_client").ReconfigurableAppClient
    nodes = _boot(pkg, key, crt)
    client = Client.from_properties()
    try:
        ack = client.create_name("tls", actives=[0, 1, 2], timeout=60)
        assert ack and ack.get("ok"), ack
        resp = client.send_request_sync("tls", "hello", timeout=30)
        assert resp is not None
        deadline = time.time() + 30
        while time.time() < deadline:
            states = {n.servers[0].manager.app.state.get("tls") for n in nodes[:3]}
            if len(states) == 1 and None not in states:
                break
            time.sleep(0.5)
        assert len(states) == 1 and None not in states, states
        bare = Client.from_properties()
        bare._ssl_ctx = _bare_ctx(crt)
        try:
            got, ev = [], threading.Event()
            bare.send_request("tls", "nope", lambda rid, r, e: (got.append((r, e)), ev.set()))
            # resolution needs an RC connection, which the handshake refuses
            assert not ev.wait(5), got
        finally:
            bare.close()
        return {"ack": {k: ack[k] for k in ("ok", "name") if k in ack},
                "actives": sorted(ack.get("actives", [])), "resp": resp,
                "state": states.pop()}
    finally:
        client.close()
        for n in nodes:
            n.stop()
        pkg.mod("utils.config").Config.clear()


def test_mutual_auth_cluster_end_to_end(tmp_path):
    key, crt = make_cert(tmp_path)
    ref, port = (bounded(mutual_auth, pkg, key, crt) for pkg in PKGS)
    assert port == ref


def client_plane(pkg, key, crt):
    Client = pkg.mod("clients.reconfigurable_client").ReconfigurableAppClient
    nodes = _boot(pkg, key, crt, CLIENT_PORT_OFFSET=1000, CLIENT_SSL_MODE="SERVER_AUTH")
    client = Client.from_properties()
    client._ssl_ctx = _bare_ctx(crt)
    try:
        ack = client.create_name("split", actives=[0, 1, 2], timeout=60)
        assert ack and ack.get("ok"), ack
        resp = client.send_request_sync("split", "x", timeout=30)
        assert resp is not None
        return {"ok": ack["ok"], "actives": sorted(ack.get("actives", [])), "resp": resp}
    finally:
        client.close()
        for n in nodes:
            n.stop()
        pkg.mod("utils.config").Config.clear()


def test_client_plane_port_split(tmp_path):
    key, crt = make_cert(tmp_path)
    ref, port = (bounded(client_plane, pkg, key, crt) for pkg in PKGS)
    assert port == ref
