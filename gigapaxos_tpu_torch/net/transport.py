"""MessageTransport — async TCP message substrate (ref: ``NIOTransport``).

Re-creation of the reference's from-scratch NIO layer
(``nio/NIOTransport.java:115``: single selector thread, non-blocking
connect/accept/read/write, per-destination pending-write queues with
congestion back-pressure, auto-reconnect; wire format = 4-byte magic
preamble + 4-byte length + payload, ``NIOTransport.java:483-524``) on top
of one asyncio event loop running in a dedicated thread, so synchronous
callers (the manager tick loop) can ``send_to_id`` without owning a loop.

Differences by design, not omission: SSL is delegated to asyncio's native
TLS support (``ssl_context`` arg vs the reference's hand-rolled SSLEngine
wrapper, ``SSLDataProcessingWorker.java:59``); byte-order and magic match
no one — this framework's peers only speak to each other.
"""

from __future__ import annotations

import asyncio
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

MAGIC = 0x47503270  # "GP2p"
_HDR = struct.Struct(">II")  # magic, payload length
MAX_PAYLOAD = 256 * 1024 * 1024
CONGESTION_LIMIT = 4096  # per-peer queued messages before drops (isCongested)
# frames at least this long are written after their header, not copied
# into one concatenated write
_SPLIT_WRITE_BYTES = 64 * 1024


def _write_frame(writer, payload) -> None:
    """One framed payload onto a stream writer.  A small payload goes as
    one write (one segment); a large one (a multi-MB blob frame) as a
    second write after the header, so that it is not copied."""
    hdr = _HDR.pack(MAGIC, len(payload))
    if len(payload) < _SPLIT_WRITE_BYTES:
        writer.write(hdr + payload)
    else:
        writer.write(hdr)
        writer.write(payload)


class _Latest:
    """Queue token standing for the newest payload of one coalescing key
    (see :meth:`MessageTransport.send_latest_to_id`)."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key


class _FrameReader(asyncio.BufferedProtocol):
    """The receive side of one accepted connection.  Frames that fit the
    staging buffer are parsed out of it and handed over as ``bytes``; a
    frame too large for it (a multi-MB blob frame) is read straight into
    a buffer of its own (``recv_into``, which copies with the interpreter
    lock released) and handed over as that ``bytearray``.  A stream
    reader would copy such a frame twice more, holding the lock, into
    fresh allocations, while the node's tick thread waits for the lock."""

    STAGE_BYTES = 256 * 1024

    def __init__(self, owner: "MessageTransport"):
        self._owner = owner
        self._stage = bytearray(self.STAGE_BYTES)
        self._n = 0            # bytes of the stage not yet parsed
        self._body = None      # a large frame's own buffer while it fills
        self._pos = 0
        self._tr = None
        self._peer = ("?", 0)
        self._reply = None

    def connection_made(self, transport) -> None:
        self._tr = transport
        self._peer = transport.get_extra_info("peername") or ("?", 0)
        self._reply = self._owner._reply_fn(transport)
        self._owner._conns.add(transport)

    def connection_lost(self, exc) -> None:
        self._owner._conns.discard(self._tr)

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._body is not None:
            return memoryview(self._body)[self._pos:]
        return memoryview(self._stage)[self._n:]

    def buffer_updated(self, nbytes: int) -> None:
        if self._body is not None:
            self._pos += nbytes
            if self._pos == len(self._body):
                body, self._body = self._body, None
                self._owner._deliver(body, self._peer, self._reply)
            return
        self._n += nbytes
        stage, n, off = self._stage, self._n, 0
        view = memoryview(stage)
        while n - off >= _HDR.size:
            magic, length = _HDR.unpack_from(stage, off)
            if magic != MAGIC or length > MAX_PAYLOAD:
                self._n = 0
                self._tr.close()  # protocol violation: drop the connection
                return
            start = off + _HDR.size
            if n - start >= length:
                off = start + length
                self._owner._deliver(bytes(view[start:off]), self._peer,
                                     self._reply)
                continue
            if _HDR.size + length > len(stage):
                # too large for the stage: the rest goes straight into
                # the frame's own buffer
                body = bytearray(length)
                body[:n - start] = view[start:n]
                self._body, self._pos, self._n = body, n - start, 0
                return
            break
        if off:
            # move the partial frame to the front of the stage
            rest = bytes(view[off:n])
            stage[:len(rest)] = rest
        self._n = n - off

    def eof_received(self) -> bool:
        return False  # close the connection


# handler(payload: bytes, sender: (host, port), reply) -> None; a frame
# larger than the receive stage arrives as a bytearray (see _FrameReader)
# ``reply(bytes)`` queues a frame back on the SAME connection (needed for
# client request/response: clients don't listen on a port).
Handler = Callable[[bytes, Tuple[str, int], Callable[[bytes], None]], None]


class MessageTransport:
    def __init__(
        self,
        my_id: int,
        node_config,
        handler: Handler,
        listen_host: Optional[str] = None,
        listen_port: Optional[int] = None,
        ssl_context=None,
        ssl_server_context=None,
        ssl_client_context=None,
    ):
        self.my_id = int(my_id)
        self.node_config = node_config
        self.handler = handler
        if listen_host is None or listen_port is None:
            listen_host, listen_port = node_config.get_node_address(my_id)
        self.listen_host, self.listen_port = listen_host, int(listen_port)
        # TLS: a mesh peer both LISTENS and DIALS, and asyncio requires a
        # TLS_SERVER context on the listener and a TLS_CLIENT context on
        # outbound connects — one context cannot serve both directions.
        # `ssl_context` remains as a single-role convenience.
        self._ssl_server = ssl_server_context or ssl_context
        self._ssl_client = ssl_client_context or ssl_context
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name=f"transport-{my_id}", daemon=True
        )
        self._writers: Dict[Tuple[str, int], asyncio.StreamWriter] = {}
        self._queues: Dict[Tuple[str, int], asyncio.Queue] = {}
        self._senders: Dict[Tuple[str, int], asyncio.Task] = {}
        # newest payload per (addr, key) whose _Latest token is queued
        self._latest: Dict[Tuple[Tuple[str, int], str], bytes] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # the accepted connections' transports (closed at stop)
        self._conns: set = set()
        self._started = threading.Event()
        self._stopped = False
        self.n_sent = 0
        self.n_rcvd = 0
        self.n_dropped = 0  # congestion drops (NIOInstrumenter analog)
        self.n_coalesced = 0  # queued snapshots replaced by newer ones
        # WAN emulation hook (JSONDelayEmulator analog, nio/
        # JSONDelayEmulator.java:36-56): delay_fn(addr) -> seconds of
        # artificial link delay before a frame is queued for delivery
        self.delay_fn: Optional[Callable[[Tuple[str, int]], float]] = None

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start_server(), self._loop)
        fut.result(timeout=10)
        self._started.set()

    async def _start_server(self) -> None:
        self._server = await self._loop.create_server(
            lambda: _FrameReader(self), self.listen_host, self.listen_port,
            ssl=self._ssl_server,
        )
        if self.listen_port == 0 and self._server.sockets:
            # ephemeral bind: report the kernel-chosen port (race-free
            # alternative to probe-and-rebind in tests/tools)
            self.listen_port = self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True

        async def _shutdown():
            if self._server is not None:
                self._server.close()
            # cancel every task on this loop (senders AND the per-connection
            # read handlers — leaving them pending spews "Task was
            # destroyed" / "Event loop is closed" at interpreter exit)
            me = asyncio.current_task()
            for task in asyncio.all_tasks():
                if task is not me:
                    task.cancel()
            for w in list(self._writers.values()) + list(self._conns):
                try:
                    w.close()
                except Exception:
                    pass

        try:
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop).result(5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    # ---- receive path --------------------------------------------------
    # reply-path write-buffer cap: a slow client must not buffer replies
    # unboundedly in its connection's writer (congestion -> drop, like the
    # forward path; clients retransmit)
    REPLY_BUFFER_LIMIT = 8 * 1024 * 1024

    def _reply_fn(self, transport) -> Callable[[bytes], None]:
        """``reply(payload)``: queue a frame back on one connection."""
        def reply(payload: bytes) -> None:
            def _w():
                try:
                    if transport.get_write_buffer_size() \
                            > self.REPLY_BUFFER_LIMIT:
                        self.n_dropped += 1
                        return
                    _write_frame(transport, payload)
                except Exception:
                    self.n_dropped += 1
            self._loop.call_soon_threadsafe(_w)
        return reply

    def _deliver(self, payload, peer, reply) -> None:
        self.n_rcvd += 1
        try:
            self.handler(payload, peer, reply)
        except Exception:
            pass  # handler errors must not kill the read loop

    # ---- send path -----------------------------------------------------
    def send_to_id(self, node_id: int, payload: bytes) -> bool:
        """Queue for delivery to a node id; False when congested/unknown."""
        if node_id not in self.node_config:
            return False
        return self.send_to_address(
            self.node_config.get_node_address(node_id), payload
        )

    def send_to_address(self, addr: Tuple[str, int], payload: bytes,
                        delay: float = 0.0) -> bool:
        """Queue a frame; `delay` postpones the enqueue (chunk pacing /
        emulation) on top of any configured delay_fn link delay."""
        if self._stopped:
            return False
        addr = (addr[0], int(addr[1]))
        if self.delay_fn is not None:
            delay += self.delay_fn(addr)
        if delay > 0:
            self._loop.call_soon_threadsafe(
                self._loop.call_later, delay, self._enqueue, addr, payload
            )
        else:
            self._loop.call_soon_threadsafe(self._enqueue, addr, payload)
        return True

    def send_latest_to_id(self, node_id: int, key: str,
                          payload: bytes) -> bool:
        """Queue ``payload`` as the newest value of ``key`` for a node: a
        frame of the same key still waiting in the queue is REPLACED, not
        followed.  For state snapshots that supersede each other (the
        engine blob): a sender producing them faster than the link drains
        would otherwise queue stale multi-MB frames, and every receiver
        would read through the backlog before reaching a fresh one.  A
        replaced frame is a dropped frame, which the state-exchange
        protocol tolerates by design.  A link-delay emulator delays the
        frame before it reaches the queue, as for :meth:`send_to_address`."""
        if node_id not in self.node_config or self._stopped:
            return False
        addr = self.node_config.get_node_address(node_id)
        addr = (addr[0], int(addr[1]))
        delay = self.delay_fn(addr) if self.delay_fn is not None else 0.0
        if delay > 0:
            self._loop.call_soon_threadsafe(
                self._loop.call_later, delay, self._enqueue_latest, addr, key,
                payload,
            )
        else:
            self._loop.call_soon_threadsafe(
                self._enqueue_latest, addr, key, payload
            )
        return True

    def _enqueue_latest(self, addr: Tuple[str, int], key: str,
                        payload: bytes) -> None:
        slot = (addr, key)
        if slot in self._latest:  # a token is queued: replace its payload
            self._latest[slot] = payload
            self.n_coalesced += 1
            return
        if self._enqueue(addr, _Latest(key)):
            self._latest[slot] = payload

    def _enqueue(self, addr: Tuple[str, int], payload) -> bool:
        q = self._queues.get(addr)
        if q is None:
            q = asyncio.Queue()
            self._queues[addr] = q
            self._senders[addr] = self._loop.create_task(self._sender(addr, q))
        if q.qsize() >= CONGESTION_LIMIT:
            self.n_dropped += 1  # congestion: drop, like the reference
            return False
        q.put_nowait(payload)
        return True

    def is_congested(self, node_id: int) -> bool:
        try:
            addr = self.node_config.get_node_address(node_id)
        except KeyError:
            return True
        q = self._queues.get((addr[0], int(addr[1])))
        return q is not None and q.qsize() >= CONGESTION_LIMIT

    async def _sender(self, addr: Tuple[str, int], q: asyncio.Queue) -> None:
        """Per-peer writer with auto-reconnect (pending-writes analog)."""
        writer: Optional[asyncio.StreamWriter] = None
        while not self._stopped:
            payload = await q.get()
            if isinstance(payload, _Latest):
                payload = self._latest.pop((addr, payload.key), None)
                if payload is None:
                    continue
            for _attempt in (0, 1):
                if writer is None:
                    try:
                        _r, writer = await asyncio.open_connection(
                            addr[0], addr[1], ssl=self._ssl_client
                        )
                        self._writers[addr] = writer
                    except OSError:
                        writer = None
                        await asyncio.sleep(0.05)
                        continue
                try:
                    _write_frame(writer, payload)
                    await writer.drain()
                    self.n_sent += 1
                    break
                except (ConnectionError, OSError):
                    try:
                        writer.close()
                    except Exception:
                        pass
                    writer = None  # retry once with a fresh connection
