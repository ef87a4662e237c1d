"""PaxosClientAsync — minimal async client speaking request frames to
paxos servers.

Ref: ``PaxosClientAsync.java:47-95`` — callback table in a GC'd map with
8s timeout, requests sent to a random/chosen server; responses matched by
request id.  Retransmission with the same request id is safe end-to-end:
servers answer duplicates from the response cache (exactly-once).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..net.codec import decode_json, decode_kind, encode_json
from .base import AsyncFrameClient


class PaxosClientAsync(AsyncFrameClient):
    def __init__(self, servers: List[Tuple[str, int]], my_tag: int = -1):
        super().__init__()
        self.servers = list(servers)
        self.my_tag = my_tag
        self._callbacks: Dict[int, Tuple[float, Callable]] = {}

    # ---- public API ----------------------------------------------------
    def send_request(
        self,
        name: str,
        value: str,
        callback: Optional[Callable] = None,
        server: Optional[int] = None,
        stop: bool = False,
        request_id: Optional[int] = None,
    ) -> int:
        """Fire a request; returns its request id (for retransmission)."""
        if request_id is None:
            request_id = self.mint_id()
        with self._lock:
            if callback is not None:
                self._callbacks[request_id] = (time.time(), callback)
        idx = random.randrange(len(self.servers)) if server is None else server
        body = {
            "name": name, "value": value,
            "request_id": request_id, "stop": stop,
        }
        tc = self._mint_trace()
        if tc is not None:
            body["tc"] = list(tc)
        self.send_request_body(tuple(self.servers[idx]), body)
        return request_id

    def send_request_sync(
        self,
        name: str,
        value: str,
        timeout: float = 10.0,
        server: Optional[int] = None,
        stop: bool = False,
        retransmit_every: float = 1.0,
    ) -> Optional[str]:
        """Blocking convenience: retransmits (same id, rotating servers)
        until a response arrives or timeout."""
        ev = threading.Event()
        out: Dict[str, Optional[str]] = {}

        def cb(rid, resp):
            out["resp"] = resp
            ev.set()

        rid = self.send_request(name, value, cb, server=server, stop=stop)
        deadline = time.time() + timeout
        attempt = 0
        while not ev.wait(retransmit_every):
            if time.time() > deadline:
                with self._lock:
                    self._callbacks.pop(rid, None)
                return None
            attempt += 1
            nxt = (server if server is not None else 0) + attempt
            with self._lock:
                self._callbacks[rid] = (time.time(), cb)
            self.send_request(
                name, value, cb,
                server=nxt % len(self.servers), request_id=rid,
            )
        return out.get("resp")

    # ---- admin helpers --------------------------------------------------
    def admin_sync(self, server: int, body: Dict, timeout: float = 5.0) -> Optional[Dict]:
        fut_box: Dict[str, Dict] = {}
        ev = threading.Event()
        key = f"admin:{body.get('op')}:{body.get('name')}"
        with self._lock:
            self._admin_waiters = getattr(self, "_admin_waiters", {})
            self._admin_waiters[key] = (ev, fut_box)
        frame = encode_json("admin", self.my_tag, body)
        self.send_frame(tuple(self.servers[server]), frame)
        if ev.wait(timeout):
            return fut_box.get("resp")
        return None

    def create_paxos_instance(
        self, name: str, members: List[int],
        initial_state: Optional[str] = None, timeout: float = 5.0,
    ) -> bool:
        """Create on every server with a creator-chosen row (keeps group
        rows aligned across replicas — see PaxosManager.default_row_for)."""
        r = self.admin_sync(0, {"op": "rowfor", "name": name}, timeout)
        if r is None:
            return False
        row = int(r["row"])
        ok = True
        for s in range(len(self.servers)):
            resp = self.admin_sync(s, {
                "op": "create", "name": name, "members": members,
                "row": row, "initial_state": initial_state,
            }, timeout)
            ok = ok and bool(resp and resp.get("ok"))
        return ok

    def _dispatch(self, payload: bytes) -> None:
        kind = decode_kind(payload)
        if kind == "S":  # binary response batch (hot path)
            from ..net import hot_codec

            try:
                _sender, items = hot_codec.decode_response_batch(payload)
            except ValueError:
                return
            for sub in items:
                self._on_response(sub)
            return
        if kind != "J":
            return
        k, _s, body = decode_json(payload)
        if k == "client_response":
            self._on_response(body)
        elif k == "client_response_batch":
            for sub in body.get("resps", ()):
                self._on_response(sub)
        elif k == "admin_response":
            key = f"admin:{body.get('op')}:{body.get('name')}"
            waiters = getattr(self, "_admin_waiters", {})
            ent = waiters.pop(key, None)
            if ent:
                ev, box = ent
                box["resp"] = body
                ev.set()

    def _on_response(self, body: Dict) -> None:
        rid = int(body["request_id"])
        if body.get("error") == "overload":
            # transient shed, not an answer: keep the callback so the
            # sync wrapper's retransmission gets the request through
            return
        now = time.time()
        with self._lock:
            ent = self._callbacks.pop(rid, None)
            # REQUEST_TIMEOUT_S sweep (the PaxosClientAsync 8s GC analog)
            self._gc_callbacks_locked(now)
        if ent:
            self._observe_latency(ent[0], now)
            ent[1](rid, body.get("response"))
