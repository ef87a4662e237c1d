"""HTTP front-ends for the reconfigurator and active-replica roles.

API-parity targets: ``HttpReconfigurator`` (``http/HttpReconfigurator.
java:51,79`` — netty REST for create/delete/request-actives; commands as
``{"type": "CREATE", "name": ..., "initialState": ...}``) and the fork's
``HttpActiveReplica`` (``HttpActiveReplica.java:29`` — POST app requests).

Python re-design: a stdlib ``ThreadingHTTPServer`` per role, mounted next
to the socket transport at ``port + PC.HTTP_PORT_OFFSET``.  Handlers
bridge into the same demux paths the binary protocol uses (an HTTP create
is exactly an ``rc_client`` op with the reply parked on the HTTP worker
thread), so the front-end adds no new semantics — just a wire format.

Endpoints (reconfigurator):
  GET  /?name=N                 -> request actives (also /?type=REQ_ACTIVES)
  POST / {"type": "CREATE",  "name": N, "initialState": S}
  POST / {"type": "DELETE",  "name": N}
  POST / {"type": "RECONFIGURE", "name": N, "actives": [..]}
  GET  /stats                   -> DelayProfiler + placement snapshot
  GET  /metrics                 -> RC engine registry (placement gauges)
Endpoints (active replica):
  POST / {"name": N, "request": value}   -> execute through consensus
  GET  /stats                            -> DelayProfiler snapshot
  GET  /metrics                          -> engine registry (Prometheus)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .utils.profiler import DelayProfiler

# HTTP op type -> (rc_client kind, ack kind) — HttpRequestType analog
_RC_OPS = {
    "CREATE": ("create_service", "create_ack"),
    "DELETE": ("delete_service", "delete_ack"),
    "RECONFIGURE": ("reconfigure", "reconfigure_ack"),
    "REQ_ACTIVES": ("request_actives", "actives_response"),
}


def _body_of(op_type: str, payload: Dict) -> Dict:
    name = payload["name"]
    if op_type == "CREATE":
        body = {"name": name, "initial_state": payload.get("initialState")}
        if payload.get("actives") is not None:
            body["actives"] = list(payload["actives"])
        return body
    if op_type == "RECONFIGURE":
        return {"name": name, "new_actives": list(payload["actives"])}
    return {"name": name}


class _Waiter:
    """Parks an HTTP worker thread until the layer's async reply lands."""

    def __init__(self):
        self.ev = threading.Event()
        self.reply: Optional[Dict] = None

    def __call__(self, kind: str, body: Dict) -> None:
        self.reply = {"kind": kind, "body": body}
        self.ev.set()


# shared response plumbing for BOTH role handlers (AR and RC serve the
# same /stats-/metrics exposition shapes; one copy, no drift)
def _send_json(handler: BaseHTTPRequestHandler, code: int, obj: Dict) -> None:
    _send_bytes(handler, code, json.dumps(obj).encode("utf-8"),
                "application/json")


def _send_text(handler: BaseHTTPRequestHandler, code: int, text: str) -> None:
    _send_bytes(handler, code, text.encode("utf-8"),
                "text/plain; charset=utf-8")


def _send_bytes(handler, code: int, data: bytes, ctype: str) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def _metrics_body(metrics: Optional[Callable[[], str]]) -> str:
    """The /metrics exposition: the node's registry render with the
    DelayProfiler line riding along so one scrape sees both planes."""
    body = metrics() if metrics is not None else ""
    return body + "# delayprofiler " + DelayProfiler.get_stats() + "\n"


def _http_server(host: str, port: int, handler_cls) -> ThreadingHTTPServer:
    srv = ThreadingHTTPServer((host, port), handler_cls)
    srv.daemon_threads = True
    # the HTTP fronts are CLIENT-plane listeners: under a TLS deployment
    # they serve HTTPS with the same contexts/policy as the client
    # socket plane (SERVER_AUTH presents the node cert; MUTUAL_AUTH
    # additionally requires a client cert — a cert-less scraper is
    # rejected at the handshake, same as a cert-less binary client)
    from .net.ssl_util import build_client_plane_contexts

    ctx, _dialer = build_client_plane_contexts()
    if ctx is not None:
        srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name=f"http-{port}")
    t.start()
    return srv


def start_rc_http(
    host: str,
    port: int,
    submit: Callable[[str, Dict, Callable[[str, Dict], None]], None],
    timeout_s: float = 20.0,
    metrics: Optional[Callable[[], str]] = None,
    stats: Optional[Callable[[], Dict]] = None,
) -> ThreadingHTTPServer:
    """Mount the reconfigurator REST API.  ``submit(kind, body, reply)``
    injects the op into the RC demux with `reply` as the client sink.
    ``metrics()`` renders the RC engine's registry (``GET /metrics``,
    Prometheus-style — carries the placement gauges/counters);
    ``stats()`` returns the layer's structured stats (``GET /stats`` —
    the placement snapshot: per-active loads, probe RTTs)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _run(self, op_type: str, payload: Dict) -> None:
            if op_type not in _RC_OPS:
                _send_json(self, 400, {"error": f"unknown type {op_type!r}"})
                return
            if not payload.get("name"):
                _send_json(self, 400, {"error": "missing name"})
                return
            kind, _ack = _RC_OPS[op_type]
            w = _Waiter()
            submit(kind, _body_of(op_type, payload), w)
            if not w.ev.wait(timeout_s):
                _send_json(self, 504, {"error": "timeout"})
                return
            body = w.reply["body"]
            code = 200 if body.get("ok") else 409
            _send_json(self, code, body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/stats":
                body = {"stats": DelayProfiler.get_stats()}
                if stats is not None:
                    body.update(stats() or {})
                _send_json(self, 200, body)
                return
            if path == "/metrics":
                _send_text(self, 200, _metrics_body(metrics))
                return
            q = parse_qs(urlparse(self.path).query)
            name = (q.get("name") or [None])[0]
            op = (q.get("type") or ["REQ_ACTIVES"])[0].upper()
            self._run(op, {"name": name})

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                _send_json(self, 400, {"error": "bad json"})
                return
            self._run(str(payload.get("type", "")).upper(), payload)

    return _http_server(host, port, Handler)


def start_ar_http(
    host: str,
    port: int,
    propose: Callable[[str, str, Callable], Optional[int]],
    timeout_s: float = 20.0,
    overloaded: Optional[Callable[[], bool]] = None,
    metrics: Optional[Callable[[], str]] = None,
) -> ThreadingHTTPServer:
    """Mount the active-replica app-request API (HttpActiveReplica analog).
    ``propose(name, value, callback)`` is the manager's propose;
    ``overloaded()`` gates admission (503) so the MAX_OUTSTANDING back
    -pressure covers every entry path, not just the binary protocol;
    ``metrics()`` renders the node's engine-metrics registry as text
    (``GET /metrics``, Prometheus-style — the obs-plane dump endpoint)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/stats":
                _send_json(self, 200, {"stats": DelayProfiler.get_stats()})
            elif path == "/metrics":
                _send_text(self, 200, _metrics_body(metrics))
            else:
                _send_json(self, 404, {"error": "POST app requests to /"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                _send_json(self, 400, {"error": "bad json"})
                return
            name = payload.get("name")
            value = payload.get("request", payload.get("value"))
            if not name or value is None:
                _send_json(self, 400, {"error": "need name and request"})
                return
            if overloaded is not None and overloaded():
                _send_json(self, 503, {"error": "overload", "name": name})
                return
            ev = threading.Event()
            box: Dict = {}

            def cb(rid, resp):
                box["response"] = resp
                ev.set()

            vid = propose(name, str(value), cb)
            if vid is None:
                _send_json(self, 404, {"error": "unknown_name", "name": name})
                return
            if not ev.wait(timeout_s):
                _send_json(self, 504, {"error": "timeout"})
                return
            _send_json(self, 200,
                       {"name": name, "response": box.get("response")})

    return _http_server(host, port, Handler)
