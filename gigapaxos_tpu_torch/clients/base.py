"""Shared async client substrate: one loop thread + per-address framed
connections with a reply read-loop.

Both clients (:class:`~gigapaxos_tpu_torch.clients.paxos_client.PaxosClientAsync`
and the reconfiguration-aware
:class:`~gigapaxos_tpu_torch.clients.reconfigurable_client.ReconfigurableAppClient`)
speak the same ``MAGIC``+length framing to servers and match responses by
id on the same connection (the reference pattern:
``PaxosClientAsync.java:47-95`` under ``ReconfigurableAppClientAsync``).
"""

from __future__ import annotations

import asyncio
import random
import ssl
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..net import hot_codec
from ..net.codec import encode_json
from ..net.transport import MAGIC, _HDR
from ..obs.metrics import MetricsRegistry
from ..obs.reqtrace import maybe_mint_trace, trace_sample_rate
from ..paxos_config import PC
from ..utils.config import Config

# the only body shape the binary 'R' frame can carry; anything richer
# (future fields) falls back to the JSON frame for the whole batch.
# "tc" is the cross-node trace context — a first-class fixed-layout
# field in the R frame, not a fallback trigger
_R_BODY_KEYS = frozenset(("name", "value", "request_id", "stop", "tc"))

Addr = Tuple[str, int]


class AsyncFrameClient:
    """Loop thread + per-address connections; subclasses override
    :meth:`_dispatch` for inbound frames."""

    def __init__(self, ssl_context=None) -> None:
        # TLS dialer context (client_ssl_context() under SERVER_AUTH /
        # MUTUAL_AUTH; None = cleartext).  Defaults from the flag system
        # so `from_properties`-style constructions pick the cluster mode
        # up automatically.
        if ssl_context is None:
            from ..net.ssl_util import client_ssl_context

            ssl_context = client_ssl_context()
        self._ssl_ctx = ssl_context
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever,
            name=type(self).__name__, daemon=True,
        )
        self._thread.start()
        self._conns: Dict[Addr, Tuple[asyncio.StreamReader, asyncio.StreamWriter]] = {}
        self._read_tasks: Dict[Addr, asyncio.Task] = {}
        self._lock = threading.Lock()
        # flag snapshot (re-reading Config per message would contend on its
        # global lock inside the response hot path)
        self.callback_ttl = Config.get_float(PC.REQUEST_TIMEOUT_S)
        # client ids live in [2^53, 2^62): disjoint from reconfiguration
        # stop ids (bit 62 set) and ABOVE the server-minted id range
        # (nonce<<24 | counter < 2^61 — the two ranges overlap in
        # [2^53, 2^61) and collisions are tolerated probabilistically,
        # like the reference's random 63-bit ids, RequestPacket.java:83)
        self._next_id = random.randrange(1 << 53, 1 << 62)
        # request aggregation: bodies buffered per address and flushed in
        # one loop hop as a client_request_batch frame — under load the
        # loop thread naturally lags a burst, so frames carry many
        # requests (one json parse + one syscall each at the server)
        self._agg: Dict[Addr, List[Dict]] = {}
        self._agg_scheduled = False
        self._last_cb_gc = 0.0  # periodic callback-TTL sweep clock
        # binary hot-path frames ('R' out / 'S' back, net/hot_codec.py):
        # one fixed-layout scan per frame instead of a JSON round trip
        self._binary_frames = Config.get_bool(PC.BINARY_CLIENT_FRAMES)
        # cross-node trace sampling (GP_TRACE_SAMPLE, snapshotted: an env
        # read per request would be hot-path cost) + the client-side SLO
        # surface: end-to-end request latency lands in a log-bucket
        # histogram here — the "client wait" phase the server can't see
        self._trace_rate = trace_sample_rate()
        self.metrics = MetricsRegistry(node=-1)

    def _mint_trace(self):
        """Sampling decision for one outgoing request: (tid, origin,
        hop=0) or None.  Zero-cost when sampling is off."""
        if not self._trace_rate:
            return None
        return maybe_mint_trace(
            getattr(self, "my_tag", -1), self._trace_rate
        )

    def _observe_latency(self, t_sent: float, now: float) -> None:
        """One end-to-end latency sample (response received for a
        request registered at ``t_sent``)."""
        self.metrics.observe("client_request_latency_s", now - t_sent)

    def mint_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def _gc_callbacks_locked(self, now: float) -> None:
        """PERIODIC TTL sweep of ``self._callbacks`` (subclass-owned dict
        whose entries lead with the registration time).  Call under
        ``self._lock``.  Periodic, not per-response: sweeping on every
        response is O(outstanding) per response — quadratic under load,
        and it was the single largest client cost in the capacity probe
        before being throttled."""
        if now - self._last_cb_gc <= 1.0:
            return
        self._last_cb_gc = now
        cut = now - self.callback_ttl
        callbacks = self._callbacks
        for dead in [r for r, ent in callbacks.items() if ent[0] < cut]:
            del callbacks[dead]

    # ---- transport -----------------------------------------------------
    def send_frame(self, addr: Addr, frame: bytes) -> None:
        asyncio.run_coroutine_threadsafe(self._asend(addr, frame), self._loop)

    def send_request_body(self, addr: Addr, body: Dict) -> None:
        """Queue one app-request body for `addr`; bodies accumulated
        before the loop thread runs the flush ride ONE
        ``client_request_batch`` frame."""
        with self._lock:
            self._agg.setdefault(addr, []).append(body)
            need_schedule = not self._agg_scheduled
            self._agg_scheduled = True
        if need_schedule:
            self._loop.call_soon_threadsafe(self._flush_agg)

    def send_request_bodies(self, addr: Addr, bodies: List[Dict]) -> None:
        """Bulk :meth:`send_request_body`: one lock hold and at most one
        flush schedule for a whole quantum of requests."""
        with self._lock:
            self._agg.setdefault(addr, []).extend(bodies)
            need_schedule = not self._agg_scheduled
            self._agg_scheduled = True
        if need_schedule:
            self._loop.call_soon_threadsafe(self._flush_agg)

    def _flush_agg(self) -> None:
        with self._lock:
            bufs, self._agg = self._agg, {}
            self._agg_scheduled = False
        tag = getattr(self, "my_tag", -1)
        for addr, bodies in bufs.items():
            frame = None
            if self._binary_frames:
                frame = self._encode_binary(tag, bodies)
            if frame is None:
                if len(bodies) == 1:
                    frame = encode_json("client_request", tag, bodies[0])
                else:
                    frame = encode_json(
                        "client_request_batch", tag, {"reqs": bodies}
                    )
            self._loop.create_task(self._asend(addr, frame))

    @staticmethod
    def _encode_binary(tag: int, bodies: List[Dict]) -> Optional[bytes]:
        """One 'R' frame for the whole batch, or None when any body
        doesn't fit the fixed layout (the JSON path owes those)."""
        items = []
        for b in bodies:
            rid = b.get("request_id")
            if rid is None or not _R_BODY_KEYS.issuperset(b):
                return None
            item = (
                int(rid), b["name"], b.get("value", ""),
                bool(b.get("stop")),
            )
            tc = b.get("tc")
            if tc:
                item += ((int(tc[0]), int(tc[1]), int(tc[2])),)
            items.append(item)
        try:
            return hot_codec.encode_request_batch(tag, items)
        except (ValueError, OverflowError, struct.error):
            return None  # oversize name/id etc.: JSON handles it

    async def _asend(self, addr: Addr, frame: bytes) -> None:
        conn = self._conns.get(addr)
        if conn is None:
            try:
                reader, writer = await asyncio.open_connection(
                    addr[0], addr[1], ssl=self._ssl_ctx
                )
            except (OSError, ssl.SSLError):
                return
            raced = self._conns.get(addr)
            if raced is not None:
                # a concurrent send connected while we awaited — keep the
                # established one, discard ours (else its writer leaks)
                writer.close()
                conn = raced
            else:
                self._conns[addr] = (reader, writer)
                self._read_tasks[addr] = self._loop.create_task(
                    self._read_loop(addr, reader)
                )
                conn = (reader, writer)
        _r, writer = conn
        try:
            writer.write(_HDR.pack(MAGIC, len(frame)) + frame)
            await writer.drain()
        except (ConnectionError, OSError):
            self._evict_conn(addr, conn)

    def _evict_conn(self, addr: Addr, conn) -> None:
        """Drop a dead connection AND its read task — an orphaned read
        task would linger until its reader errors, leaking one task per
        reconnect under a flaky server.  Identity-guarded: a concurrent
        reconnect may already have replaced the entry, and evicting the
        replacement would destroy a healthy connection."""
        if self._conns.get(addr) is not conn:
            return
        self._conns.pop(addr, None)
        task = self._read_tasks.pop(addr, None)
        if task is not None and task is not asyncio.current_task():
            task.cancel()

    async def _read_loop(self, addr: Addr, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                hdr = await reader.readexactly(_HDR.size)
                magic, length = _HDR.unpack(hdr)
                if magic != MAGIC:
                    break
                payload = await reader.readexactly(length)
                self._dispatch(payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            # only clear entries still OWNED by this task: a reconnect may
            # already have replaced them, and popping the replacement would
            # orphan the live connection
            if self._read_tasks.get(addr) is asyncio.current_task():
                self._conns.pop(addr, None)
                self._read_tasks.pop(addr, None)

    def _dispatch(self, payload: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        async def _close():
            for task in self._read_tasks.values():
                task.cancel()
            for _r, w in list(self._conns.values()):
                try:
                    w.close()
                    await w.wait_closed()
                except Exception:
                    pass
            self._conns.clear()

        try:
            asyncio.run_coroutine_threadsafe(_close(), self._loop).result(3)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=3)
