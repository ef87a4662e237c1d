"""TLS context construction from the flag system.

Re-creation of the reference's SSL mode selection
(``SSLDataProcessingWorker.java:59`` modes CLEAR / SERVER_AUTH /
MUTUAL_AUTH, configured at ``PaxosConfig.java:548-553``) on Python's
``ssl`` module with PEM files instead of JKS keystores:

* ``SERVER_AUTH`` — listeners present ``SSL_CERT_FILE``; dialers verify
  against ``SSL_CA_FILE``.
* ``MUTUAL_AUTH`` — additionally, listeners REQUIRE a peer certificate
  chained to ``SSL_CA_FILE``, and dialers present their own cert (so
  every mesh/client connection is mutually authenticated).

The mesh needs both a server and a client context per node (each peer
both listens and dials — one context cannot play both TLS roles).
"""

from __future__ import annotations

import ssl
from typing import Optional, Tuple

from ..paxos_config import PC
from ..utils.config import Config

MODES = ("CLEAR", "SERVER_AUTH", "MUTUAL_AUTH")


def _paths() -> Tuple[str, str, str]:
    return (
        Config.get_str(PC.SSL_KEY_FILE),
        Config.get_str(PC.SSL_CERT_FILE),
        Config.get_str(PC.SSL_CA_FILE),
    )


def _make_contexts(mode: str) -> Tuple[
    Optional[ssl.SSLContext], Optional[ssl.SSLContext]
]:
    """Single source of truth for (listener, dialer) context wiring."""
    if mode not in MODES:
        raise ValueError(f"unknown SSL mode {mode!r} (want one of {MODES})")
    if mode == "CLEAR":
        return None, None
    key, cert, ca = _paths()
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(cert, key)
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.load_verify_locations(ca)
    client.check_hostname = False  # node identity = address book, not CN
    if mode == "MUTUAL_AUTH":
        server.load_verify_locations(ca)
        server.verify_mode = ssl.CERT_REQUIRED
        client.load_cert_chain(cert, key)
    return server, client


def build_ssl_contexts() -> Tuple[
    Optional[ssl.SSLContext], Optional[ssl.SSLContext]
]:
    """(server_ctx, client_ctx) for the configured SSL_MODE, or
    (None, None) under CLEAR."""
    return _make_contexts(Config.get_str(PC.SSL_MODE).upper() or "CLEAR")


def client_plane_split() -> bool:
    """True when CLIENT_SSL_MODE is set: nodes open a SEPARATE
    client-facing listener at port + CLIENT_PORT_OFFSET running that
    mode (the reference's per-plane port split,
    ``PaxosConfig.java:219-224``)."""
    return bool(Config.get_str(PC.CLIENT_SSL_MODE).strip())


def client_plane_mode() -> str:
    mode = Config.get_str(PC.CLIENT_SSL_MODE).strip().upper()
    return mode or (Config.get_str(PC.SSL_MODE).upper() or "CLEAR")


def build_client_plane_contexts() -> Tuple[
    Optional[ssl.SSLContext], Optional[ssl.SSLContext]
]:
    """(server_ctx, client_ctx) for the client-facing listener's mode."""
    return _make_contexts(client_plane_mode())


def client_ssl_context() -> Optional[ssl.SSLContext]:
    """Dialer-side context for CLIENTS (PaxosClientAsync /
    ReconfigurableAppClient): the client-plane mode when the port split
    is configured, else the mesh mode; None under CLEAR.  Under
    MUTUAL_AUTH the client must hold its own cert."""
    return _make_contexts(client_plane_mode())[1]
