"""TLS on the message transport on both packages: ``tests/test_ssl_transport.py``
run on the JAX package and on the port.

Each mesh peer listens with a server context and dials with a verifying
client context (SERVER_AUTH, ``SSLDataProcessingWorker.java:59``); frames
flow encrypted in both directions, and both packages deliver the same
payloads.  Certificates come from a local ``openssl``; the test skips
without it.
"""

import ssl
import subprocess
import threading

import pytest

from torch_pkgs import PKGS


def make_cert(tmp_path):
    key, crt = tmp_path / "key.pem", tmp_path / "cert.pem"
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(crt), "-days", "1", "-subj", "/CN=127.0.0.1"],
        capture_output=True, timeout=60)
    if r.returncode != 0:
        pytest.skip("openssl unavailable for cert generation")
    return str(key), str(crt)


def frames_both_directions(pkg, key, crt):
    NodeConfig = pkg.mod("net.node_config").NodeConfig
    MessageTransport = pkg.mod("net.transport").MessageTransport

    def contexts():
        server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        server.load_cert_chain(crt, key)
        client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        client.load_verify_locations(crt)
        client.check_hostname = False
        return server, client

    nc = NodeConfig({0: ("127.0.0.1", 0), 1: ("127.0.0.1", 0)})
    got = {0: threading.Event(), 1: threading.Event()}
    inbox = {0: [], 1: []}

    def handler(me):
        def h(payload, peer, reply):
            inbox[me].append(payload)
            got[me].set()
        return h

    transports = []
    for nid in (0, 1):
        srv_ctx, cli_ctx = contexts()
        t = MessageTransport(nid, nc, handler(nid), listen_host="127.0.0.1",
                             listen_port=0, ssl_server_context=srv_ctx,
                             ssl_client_context=cli_ctx)
        t.start()
        nc.add(nid, "127.0.0.1", t.listen_port)
        transports.append(t)
    try:
        assert transports[0].send_to_id(1, b"J" + b'{"dir":"0->1"}')
        assert got[1].wait(10), "0->1 TLS frame not delivered"
        assert inbox[1][0].endswith(b'{"dir":"0->1"}')
        # the reverse direction needs the server/client context split
        assert transports[1].send_to_id(0, b"J" + b'{"dir":"1->0"}')
        assert got[0].wait(10), "1->0 TLS frame not delivered"
        assert inbox[0][0].endswith(b'{"dir":"1->0"}')
        return {k: [bytes(p) for p in v] for k, v in inbox.items()}
    finally:
        for t in transports:
            t.stop()


def test_tls_frames_both_directions(tmp_path):
    key, crt = make_cert(tmp_path)
    ref, port = (frames_both_directions(pkg, key, crt) for pkg in PKGS)
    assert port == ref
