"""PaxosServer — a standalone replica node over real sockets.

Ref: ``gigapaxos/PaxosServer.java:135`` (boot a PaxosManager behind NIO
transport).  Each server runs:

* a :class:`~gigapaxos_tpu_torch.manager.PaxosManager` (engine + durability +
  app execution),
* a :class:`~gigapaxos_tpu_torch.net.transport.MessageTransport` carrying blob
  frames (the consensus state exchange — loopback/DCN stand-in for the
  ICI all_gather), host-channel JSON (payload replication, forwards,
  pulls), failure-detection pings, client requests, and admin ops,
* a :class:`~gigapaxos_tpu_torch.failure_detection.FailureDetector` driving the
  engine's vectorized election mask,
* a tick-loop thread (the RequestBatcher/BatchedLogger thread-pipeline
  analog collapsed into one cadence).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .failure_detection import FailureDetector
from .manager import PaxosManager, execute_uncoordinated
from .net import hot_codec
from .net.codec import (
    decode_blob_vec,
    decode_json,
    decode_kind,
    encode_blob_vec,
    encode_json,
    extract_trace,
)
from .obs.metrics import collect_process_gauges
from .net.node_config import NodeConfig
from .net.transport import MessageTransport
from .obs import gplog
from .ops.engine import LAUNCHES, EngineConfig
from .paxos_config import PC
from .utils.config import Config
from .utils.profiler import DelayProfiler


def _device_memory(device) -> Optional[Dict[str, int]]:
    """Free, total and allocated bytes of the card the engine runs on
    (None on the CPU): with several serving workers on one card, each
    reports its own view through the ``stats`` op."""
    if device.type != "cuda":
        return None
    import torch

    free, total = torch.cuda.mem_get_info(device)
    return {"free": int(free), "total": int(total),
            "allocated": int(torch.cuda.memory_allocated(device))}


class PaxosServer:
    def __init__(
        self,
        my_id: int,
        node_config: NodeConfig,
        app,
        cfg: EngineConfig,
        log_dir: Optional[str] = None,
        tick_interval: Optional[float] = None,
        fd_timeout_s: Optional[float] = None,
        device=None,
    ):
        self.my_id = int(my_id)
        self.node_config = node_config
        self.cfg = cfg
        self.log = gplog.node_logger("server", my_id)
        self.manager = PaxosManager(
            my_id, app, cfg, log_dir=log_dir, device=device
        )
        # the node's tracer lives on the manager (propose/decide/execute
        # record there); the server notes ingress/egress on the same ring
        self.tracer = self.manager.tracer
        # TLS per the configured SSL_MODE (CLEAR/SERVER_AUTH/MUTUAL_AUTH,
        # SSLDataProcessingWorker.java:59 analog)
        from .net.ssl_util import (
            build_client_plane_contexts,
            build_ssl_contexts,
            client_plane_split,
        )

        ssl_server, ssl_client = build_ssl_contexts()
        self.transport = MessageTransport(
            my_id, node_config, self._on_message,
            ssl_server_context=ssl_server, ssl_client_context=ssl_client,
        )
        # per-plane port split (PaxosConfig.java:219-224): when
        # CLIENT_SSL_MODE is set, clients speak to a SEPARATE listener at
        # port + CLIENT_PORT_OFFSET under that mode (e.g. a MUTUAL_AUTH
        # mesh serving SERVER_AUTH clients)
        self.client_transport: Optional[MessageTransport] = None
        if client_plane_split():
            c_srv, c_cli = build_client_plane_contexts()
            host, port = node_config.get_node_address(my_id)
            self.client_transport = MessageTransport(
                my_id, node_config, self._on_client_plane_message,
                listen_host=host,
                listen_port=int(port) + Config.get_int(PC.CLIENT_PORT_OFFSET),
                ssl_server_context=c_srv, ssl_client_context=c_cli,
            )
        self.fd = FailureDetector(my_id, node_config.get_node_ids(), fd_timeout_s)
        self.tick_interval = (
            Config.get_float(PC.TICK_INTERVAL_S)
            if tick_interval is None else tick_interval
        )
        # adaptive cadence under load (the RequestBatcher adaptive-sleep
        # analog, RequestBatcher.java:83 updateSleepDuration): the tick IS
        # the batch aging window, so while a backlog exists the loop ticks
        # as fast as the engine sustains, floored by BATCH_SLEEP_MS —
        # shorter quantum = lower latency and smaller batches, exactly the
        # trade the reference's sleep tuning makes
        self._batching = Config.get_bool(PC.BATCHING_ENABLED)
        self._batch_sleep_s = Config.get_float(PC.BATCH_SLEEP_MS) / 1000.0
        self._peer_blobs: Dict[int, np.ndarray] = {}  # packed [N] vectors
        self._blob_lock = threading.Lock()
        self._my_blob_vec: Optional[np.ndarray] = None
        self._my_blob_state = None
        self._tick = 0
        self._last_ping = 0.0
        self._stop = threading.Event()
        # event-kicked cadence: a frame carrying NEW work (client request,
        # forward, payloads, epoch-plane control) always wakes the loop;
        # a peer BLOB wakes it only while consensus work is in flight —
        # per-hop tick-quantum delays otherwise make the socket path's
        # round trip ~10 unsynchronized quanta (~100ms) for a 3-tick
        # protocol.  The reference needs none of this because it is fully
        # event-driven per packet; the kick gives the tick loop the same
        # arrival-driven latency while keeping the batched tick.
        self._kick = threading.Event()
        self._in_flight = False
        # in-flight-without-progress bound: past this many stalled ticks
        # blob arrivals stop kicking (a minority partition would otherwise
        # busy-spin at engine speed until the partition heals)
        self.STALL_TICKS = 512
        # idle skip: with no new peer blob, no backlog, no in-flight work
        # and no election pressure, the engine step is a pure no-op — skip
        # it and run only host housekeeping.  Essential on small hosts: N
        # idle node processes each burning an engine step per 10ms quantum
        # starve the request path (this box has 1 core for 6 nodes).  A
        # slow periodic full tick still runs so stragglers keep receiving
        # blobs even from otherwise-idle peers.
        self._blob_dirty = False
        self._last_full_tick = 0.0
        self._last_publish = 0.0
        self.IDLE_REPUBLISH_S = 0.5
        # per-connection client-response buffer: responses fired during a
        # tick coalesce into ONE frame per connection (the
        # PaxosPacketBatcher idea applied at the client boundary — on a
        # small host, per-response frames dominate CPU).  Flushing
        # happens ONCE per loop cycle (tick or idle), across the
        # pipeline boundary — ingress handlers only buffer, so one
        # syscall carries every completion a cycle produced for a peer
        self._resp_lock = threading.Lock()
        self._resp_buf: Dict[Tuple[int, bool], Tuple[Callable, list, bool]] = {}
        # connections that spoke the binary 'R' request frame get binary
        # 'S' response frames; weak so short-lived client connections
        # don't accumulate (the reply closure dies with its connection)
        self._binary_replies: "weakref.WeakSet" = weakref.WeakSet()
        # serving pipeline: double-buffered dispatch (the engine step for
        # batch N computes while this thread frames/publishes tick N-1's
        # outputs and transport threads admit batch N+1)
        self._pipeline = Config.get_bool(PC.PIPELINE_DISPATCH)
        self._pub: Optional[Dict] = None  # pending publish of last tick
        self._self_msgs: list = []  # self-destined forwards, post-overlap
        # large-message streaming (LargeCheckpointer analog,
        # LargeCheckpointer.java:43 / CheckpointServer:1237): a control
        # frame above MAX_LOG_MESSAGE_SIZE is split into paced chunk
        # frames so a multi-MB app state never monopolizes a peer link
        # and stalls the epoch/consensus planes; the receiver reassembles
        # and re-dispatches the original frame
        self.max_frame_bytes = Config.get_int(PC.MAX_LOG_MESSAGE_SIZE)
        self.CHUNK_BYTES = 512 * 1024
        self.CHUNK_PACE_S = 0.002  # per-chunk stagger: lets other frames in
        self._xfer_seq = 0
        self._schema_skew_warned: set = set()
        # periodic INFO stats line (the reference's DelayProfiler dump
        # cadence): emitted only when gp.server is at INFO, so a default
        # deployment stays silent and pays one level check per period
        self._stats_period_s = Config.get_float(PC.STATS_LOG_PERIOD_S)
        self._last_stats_line = time.monotonic()
        # host_dispatches total at the last stats line (rate numerator)
        self._last_stats_dispatches = 0.0
        self._chunk_lock = threading.Lock()
        # (sender, xfer id) -> {"n": total, "parts": {i: bytes}, "t": time}
        self._chunk_rx: Dict[Tuple[int, str], Dict] = {}
        self._thread = threading.Thread(
            target=self._run, name=f"paxos-server-{my_id}", daemon=True
        )

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self.transport.start()
        if self.client_transport is not None:
            self.client_transport.start()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()  # wake a sleeping tick loop so the join is quick
        self._thread.join(timeout=10)
        self.transport.stop()
        if self.client_transport is not None:
            self.client_transport.stop()
        self.manager.close()

    # frame kinds a CLIENT-plane connection may deliver: anything else
    # (blobs, payload gossip, forwards, state transfer, chunks, epoch
    # control) is mesh traffic — accepting it from the weaker-auth client
    # listener would let a cert-less client inject consensus state and
    # defeat the MUTUAL_AUTH mesh split
    CLIENT_PLANE_KINDS = frozenset((
        "client_request", "client_request_batch", "rc_client",
        "admin", "fd_ping", "echo",
    ))

    def _on_client_plane_message(
        self, payload: bytes, peer: Tuple[str, int], reply
    ) -> None:
        kind = decode_kind(payload)
        if kind == "R":  # binary request batch (hot path)
            self._on_binary_requests(payload, reply)
            return
        if kind != "J":
            return  # packed consensus blobs never come from clients
        try:
            k, sender, body = decode_json(payload)
        except (ValueError, KeyError):
            return
        if k not in self.CLIENT_PLANE_KINDS:
            return
        self._on_json(k, sender, body, reply)
        if k != "fd_ping":
            self._kick.set()

    def _on_binary_requests(self, payload: bytes, reply) -> None:
        """Ingress for the binary 'R' client frame (net/hot_codec.py):
        decode (native, GIL-released when available) and admit as ONE
        batched manager call.  The connection is marked binary so its
        responses ride 'S' frames."""
        # a frame larger than the transport's stage arrives as a
        # bytearray; the native decoder takes bytes
        payload = bytes(payload)
        try:
            _sender, items = hot_codec.decode_request_batch(payload)
        except ValueError:
            if "R" not in self._schema_skew_warned:
                self._schema_skew_warned.add("R")
                self.log.warning(
                    "dropping malformed binary request frame (codec skew?)"
                )
            return
        self._binary_replies.add(reply)
        self._on_client_items(items, reply, binary=True)
        self._kick.set()

    # ---- message ingress (demultiplexer analog) ------------------------
    def _on_message(self, payload: bytes, peer: Tuple[str, int], reply) -> None:
        kind = decode_kind(payload)
        if kind == "R":  # binary client request batch (hot path)
            self._on_binary_requests(payload, reply)
            return
        if kind not in ("D", "J"):
            # frame from a DIFFERENT schema (pre-tag "B", pre-compact "C",
            # or anything newer): parsing a fixed-layout blob misaligned
            # would feed garbage ballots into consensus, so drop it LOUDLY
            # — once per kind, not per tick (a skewed peer republishes
            # continuously), and for unknown kinds too (an upgraded peer
            # must not be swallowed silently as a JSON decode error)
            if kind not in self._schema_skew_warned:
                self._schema_skew_warned.add(kind)
                self.log.warning(
                    "dropping frame of unrecognized schema %r (this node "
                    "speaks 'D'/'J'; a mixed-version peer must be upgraded)",
                    kind,
                )
            return
        if kind == "D":
            sender, _tick, vec = decode_blob_vec(payload, self.cfg)
            with self._blob_lock:
                self._peer_blobs[sender] = vec
                self._blob_dirty = True
            self.fd.heard_from(sender)
            m = self.manager
            # with idle-skip below, peers only publish blobs when THEY
            # have work — so a new blob is itself a new-work signal and
            # wakes the loop, unless this node has been stalled in flight
            # for a long time (wedged minority: fall back to the timer
            # instead of busy-spinning at the peer's pace)
            if m._tick_no - m.last_progress_tick < self.STALL_TICKS:
                self._kick.set()
            return
        k, sender, body = decode_json(payload)
        if sender >= 0:
            self.fd.heard_from(sender)
        self._on_json(k, sender, body, reply)
        if k != "fd_ping":
            # every non-ping J frame is (or may carry) new work: requests,
            # forwards, payload gossip, epoch-plane control.  Control
            # traffic is low-rate, so the over-approximation is cheap.
            self._kick.set()

    def _on_json(self, k: str, sender: int, body: Dict, reply) -> bool:
        """JSON-frame dispatch; subclasses extend (ReconfigurableNode roles
        layer epoch-plane kinds on the same demux — the reference's
        precedePacketDemultiplexer chaining).  Returns True if handled."""
        if k in ("payloads", "forward", "forward_batch", "need_payloads",
                 "state_request", "state_reply"):
            self.manager.on_host_message(k, body)
        elif k == "chunk":
            self._on_chunk(sender, body, reply)
        elif k == "fd_ping":
            pass  # hearing it is the point (any traffic counts as alive)
        elif k == "client_request":
            # singleton frames only arrive at low rate (the client
            # aggregates under load), so the immediate flush is cheap
            # and keeps shed/cached/local-read answers synchronous; the
            # BATCH paths below buffer and flush once per loop cycle
            self._on_client_request(body, reply)
            self._flush_responses()
        elif k == "client_request_batch":
            # many requests in one frame (client-side coalescing; the
            # nested `batched` RequestPacket array on the wire,
            # RequestPacket.java:189-246) — proposed as ONE batched
            # manager call, not per sub-request
            self._on_client_batch(body.get("reqs", ()), reply)
        elif k == "admin":
            self._on_admin(body, reply)
        elif k == "echo":
            # latency orientation (EchoRequest analog): bounce the
            # sender's timestamp with this node's load summary, so
            # clients seed their redirector — and peers their placement
            # tables — before any real traffic
            reply(encode_json("echo_reply", self.my_id, {
                "ts": body.get("ts"), "round": body.get("round"),
                "from": self.my_id, **self._echo_load(),
            }))
        else:
            return False
        return True

    # ---- large-frame streaming ----------------------------------------
    def send_frame_to_address(self, addr, frame: bytes) -> None:
        """Send a control frame, streaming it as paced chunks when it
        exceeds MAX_LOG_MESSAGE_SIZE (the frame-size cap the reference
        enforces at the NIO payload boundary)."""
        if len(frame) <= self.max_frame_bytes:
            self.transport.send_to_address(addr, frame)
            return
        import base64

        with self._chunk_lock:
            self._xfer_seq += 1
            xfer = f"{self.my_id}:{self._xfer_seq}"
        n = (len(frame) + self.CHUNK_BYTES - 1) // self.CHUNK_BYTES
        for i in range(n):
            part = frame[i * self.CHUNK_BYTES:(i + 1) * self.CHUNK_BYTES]
            chunk = encode_json("chunk", self.my_id, {
                "x": xfer, "i": i, "n": n,
                "d": base64.b64encode(part).decode("ascii"),
            })
            # pace the pieces: frames enqueued between two chunks (blobs,
            # client traffic) interleave instead of waiting out the
            # whole multi-MB transfer
            self.transport.send_to_address(
                addr, chunk, delay=i * self.CHUNK_PACE_S
            )

    def send_frame_to_id(self, node_id: int, frame: bytes) -> None:
        if node_id in self.node_config:
            self.send_frame_to_address(
                self.node_config.get_node_address(node_id), frame
            )

    def _on_chunk(self, sender: int, body: Dict, reply) -> None:
        import base64

        key = (sender, str(body["x"]))
        now = time.time()
        with self._chunk_lock:
            ent = self._chunk_rx.get(key)
            if ent is None:
                ent = self._chunk_rx[key] = {
                    "n": int(body["n"]), "parts": {}, "t": now,
                }
            ent["t"] = now  # refresh: an ACTIVE slow transfer must not GC
            ent["parts"][int(body["i"])] = base64.b64decode(body["d"])
            done = len(ent["parts"]) == ent["n"]
            if done:
                del self._chunk_rx[key]
            # GC abandoned transfers (a crashed sender must not leak RAM)
            if len(self._chunk_rx) > 4 or now - getattr(
                self, "_last_chunk_gc", 0
            ) > 30:
                self._last_chunk_gc = now
                for k in [k for k, e in self._chunk_rx.items()
                          if now - e["t"] > 60]:
                    del self._chunk_rx[k]
        if done:
            frame = b"".join(
                ent["parts"][i] for i in range(ent["n"])
            )
            self._on_message(frame, ("chunk", sender), reply)

    def _buffer_response(self, reply, item: Dict, binary: bool = False) -> None:
        with self._resp_lock:
            key = (id(reply), binary)
            ent = self._resp_buf.get(key)
            if ent is None:
                self._resp_buf[key] = (reply, [item], binary)
            else:
                ent[1].append(item)

    def _flush_responses(self) -> None:
        """Ship buffered client responses, one frame per connection per
        cycle — binary 'S' frames for connections that spoke 'R', JSON
        otherwise.  Ingress handlers only buffer; this runs once per
        loop cycle (across the pipeline boundary, overlapping the device
        step), so one syscall carries all of a peer's completions."""
        with self._resp_lock:
            if not self._resp_buf:
                return
            bufs, self._resp_buf = self._resp_buf, {}
        t0 = time.monotonic()
        tr = self.tracer
        m = self.manager
        mx = m.metrics
        tcm = m.trace_ctx
        for reply, items, binary in bufs.values():
            for item in items:
                rid = item.get("request_id")
                tc = tcm.get(rid) if tcm else None
                if tc is not None:
                    # the context rides the response (S trace tail /
                    # JSON "tc") so the client can close the loop
                    item.setdefault("tc", list(tc))
                if tr.enabled or tc is not None:
                    tr.note(
                        rid, "respond-flush",
                        name=item.get("name"), node=self.my_id,
                        error=item.get("error"),
                        force=tc is not None, **m._tc_detail(tc),
                    )
            mx.observe("flush_batch_size", len(items),
                       bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024))
            # counted before the frame is queued: a client that reads the
            # metrics once its response arrives must find it counted
            mx.count("responses_flushed", len(items))
            mx.count("response_frames_sent")
            if binary and all(
                hot_codec.encodable_response(i) for i in items
            ):
                reply(hot_codec.encode_response_batch(self.my_id, items))
            elif len(items) == 1:
                reply(encode_json("client_response", self.my_id, items[0]))
            else:
                reply(encode_json(
                    "client_response_batch", self.my_id, {"resps": items}
                ))
        dt = time.monotonic() - t0
        DelayProfiler.update_count("t_flush", dt)
        mx.observe("phase_flush_s", dt)

    def _on_client_request(self, body: Dict, reply) -> None:
        t0 = time.monotonic()
        try:
            self._on_client_request_inner(body, reply)
        finally:
            DelayProfiler.update_count(
                "t_ingress", time.monotonic() - t0
            )

    def _maybe_local_read(self, name: str, value: str, request_id,
                          cb) -> bool:
        """Uncoordinated-request fast path (`manager.py:
        execute_uncoordinated`).  Returns False (caller proposes
        normally) when the app doesn't route, the request is coordinated,
        or the name isn't hosted here (the coordinated path owes the
        unknown-name error)."""
        return execute_uncoordinated(
            self.manager.app, self.manager.names, name, value, request_id,
            cb, gate=self.manager.local_read_ok,
        ) is True

    def _on_client_batch(self, reqs, reply) -> None:
        """JSON batched-frame ingress: normalize to item tuples (traced
        items become 5-tuples, like the binary decode's) and take the
        shared path."""
        items = []
        for sub in reqs:
            base = (int(sub["request_id"]), sub["name"],
                    sub.get("value", ""), bool(sub.get("stop")))
            tc = extract_trace(sub)
            items.append(base + (tc,) if tc is not None else base)
        self._on_client_items(items, reply, binary=False)

    def _on_client_items(self, reqs, reply, binary: bool = False) -> None:
        """Batched ingress (both wire formats): one propose_batch call
        for the whole frame (stops, local reads, and overload shedding
        peel off to their own paths; everything else amortizes the
        lock/clock per frame).  ``reqs``: [(request_id, name, value,
        stop)] — traced items are 5-tuples carrying (tid, origin, hop)."""
        t0 = time.monotonic()
        m = self.manager
        tr = self.tracer
        overloaded = m.overloaded()
        items = []
        for item in reqs:
            request_id, name, value, stop = item[:4]
            tc = item[4] if len(item) > 4 else None
            if stop:
                body = {"request_id": request_id, "name": name,
                        "value": value, "stop": True}
                if tc is not None:
                    body["tc"] = list(tc)
                self._on_client_request_inner(body, reply)
                continue
            if tr.enabled or tc is not None:
                tr.note(request_id, "recv", name=name, node=self.my_id,
                        batch=True, force=tc is not None,
                        **m._tc_detail(tc))

            def cb(rid, response, _name=name):
                self._buffer_response(reply, {
                    "request_id": rid, "response": response, "name": _name,
                }, binary)

            if self._maybe_local_read(name, value, request_id, cb):
                continue
            if overloaded and request_id not in m.response_cache:
                self._buffer_response(reply, {
                    "request_id": request_id, "response": None,
                    "name": name, "error": "overload",
                }, binary)
                continue
            items.append((name, value, request_id, cb, None, tc))
        if items:
            results = m.propose_batch(items)
            for (name, _v, _r, _cb, _e, _tc), (rid, outcome, _resp) in zip(
                items, results
            ):
                if outcome == "unknown":
                    self._buffer_response(reply, {
                        "request_id": rid, "response": None,
                        "name": name, "error": "unknown_name",
                    }, binary)
                elif outcome == "exhausted":
                    # vid counter space ran out for THIS item; cached and
                    # in-flight items in the same frame still answer
                    self._buffer_response(reply, {
                        "request_id": rid, "response": None,
                        "name": name, "error": "exhausted",
                    }, binary)
        dt = time.monotonic() - t0
        DelayProfiler.update_count("t_ingress", dt)
        m.metrics.observe("phase_ingress_s", dt)

    def _on_client_request_inner(self, body: Dict, reply) -> None:
        request_id = int(body["request_id"])
        name = body["name"]
        tc = extract_trace(body)
        if self.tracer.enabled or tc is not None:
            self.tracer.note(request_id, "recv", name=name, node=self.my_id,
                             stop=bool(body.get("stop", False)),
                             force=tc is not None,
                             **self.manager._tc_detail(tc))
        if not body.get("stop") and self._maybe_local_read(
            name, body.get("value", ""), request_id,
            lambda rid, response: self._buffer_response(reply, {
                "request_id": rid, "response": response, "name": name,
            }),
        ):
            return
        if self.manager.overloaded() and \
                request_id not in self.manager.response_cache:
            # MAX_OUTSTANDING_REQUESTS back-pressure: shed at the entry
            # (clients back off and retry; retransmits of answered
            # requests still get their cached response below)
            self._buffer_response(reply, {
                "request_id": request_id, "response": None,
                "name": name, "error": "overload",
            })
            return

        def cb(rid, response):
            self._buffer_response(reply, {
                "request_id": rid, "response": response, "name": name,
            })

        vid = self.manager.propose(
            name, body.get("value", ""),
            callback=cb, stop=bool(body.get("stop", False)),
            request_id=request_id, trace_ctx=tc,
        )
        if vid is None and request_id not in self.manager.response_cache \
                and self.manager.names.get(name) is None:
            # None + uncached + hosted here means the original proposal
            # is still in flight (callback re-registered) — only an
            # UNHOSTED name is a real error; erroring the inflight case
            # double-answers the client (batch-path parity)
            self._buffer_response(reply, {
                "request_id": request_id, "response": None,
                "name": name, "error": "unknown_name",
            })

    def _on_admin(self, body: Dict, reply) -> None:
        op = body.get("op")
        if op == "rowfor":
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body["name"],
                "row": self.manager.default_row_for(body["name"]),
            }))
        elif op == "create":
            ok = self.manager.create_paxos_instance(
                body["name"], list(body["members"]),
                initial_state=body.get("initial_state"),
                row=int(body["row"]),
            )
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body["name"], "ok": bool(ok),
            }))
        elif op == "kill":
            ok = self.manager.kill(body["name"])
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body["name"], "ok": bool(ok),
            }))
        elif op == "app_state":
            # one name's replica state on this node: hosted or not, and
            # the app's checkpoint.  Not in the JAX package: a sharded
            # node's members live in worker processes, and this is how a
            # check outside them reads their state (the router sends a
            # named admin op to the name's shard)
            name = body["name"]
            row = self.manager.names.get(name)
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": name, "ok": True,
                "hosted": row is not None, "row": row,
                "checkpoint": (self.manager.app.checkpoint(name)
                               if row is not None else None),
            }))
        elif op in ("hibernate", "restore"):
            # checkpoint-and-sleep / local wake-up (PaxosManager.java:
            # 2209-2252) — node-local ops, like the reference's
            ok = getattr(self.manager, op)(body["name"])
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body["name"], "ok": bool(ok),
            }))
        elif op == "stats":
            # engine counters + DelayProfiler snapshot over the admin
            # plane — the deployed analog of the AR HTTP /stats page,
            # reachable wherever the binary protocol is.  Layered roles
            # (ReconfiguratorServer) ride their own plane stats along
            # (placement loads, probe RTTs) via _layer_stats.
            # refresh the residency gauges FIRST so the metrics snapshot
            # inside the engine block already carries this call's values
            residency = self.manager.residency_stats()
            out = {
                "op": op, "name": body.get("name"), "ok": True,
                "tick": self._tick,
                # recovery plane: `recovering` until the hydration
                # backlog drains, then `serving` — the launcher's
                # readiness wait keys on this to tell "up" from
                # "caught up"
                "phase": self.manager.recovery_phase,
                "recovery": self.manager.recovery_stats(),
                # serving-path configuration: which codec implementation
                # is LIVE (a missing toolchain silently regressing to the
                # Python path must be visible here, not discovered in a
                # perf run) and whether dispatch is pipelined
                "serving": {
                    "pipeline_dispatch": self._pipeline,
                    "codec": hot_codec.status(),
                    "serving_workers": Config.get_int(PC.SERVING_WORKERS),
                },
                # engine counters + the mesh actually backing the state
                # arrays (n_devices/shape/platform): an accidentally
                # unsharded deployment is a stats read away, not an OOM.
                # `compile` is the retrace-sentinel block (obs/device.py)
                # and `heat` the per-group activity skew — the stats op
                # is operator-initiated, so it may pull the device-side
                # heat accumulator (stats cadence, not hot path)
                "engine": {
                    **self.manager.metrics.snapshot(),
                    "mesh": self.manager.mesh_info(),
                    "compile": self.manager.engine_compile_stats(),
                    "heat": self._heat_stats(),
                    # the engine's shape, this process's kernel launches
                    # and card memory: a sharded node's router cannot read
                    # its workers' any other way
                    "shape": list(self.cfg),
                    "launches": dict(LAUNCHES),
                    "device_memory": _device_memory(self.manager.device),
                },
                # residency plane: engine rows vs paused-in-RAM vs
                # paused-on-disk (+ the spill store's segment/compaction
                # internals) — the density campaign's operator view
                "residency": residency,
                "profiler": DelayProfiler.get_snapshot(),
                "profiler_line": DelayProfiler.get_stats(),
            }
            # transaction plane (txn/app.py): live lock/staged/record
            # counts — a stuck in-doubt transaction shows up here long
            # before an audit trips over its lock
            txn_stats = getattr(self.manager.app, "txn_stats", None)
            if txn_stats is not None:
                try:
                    out["txn"] = txn_stats()
                except Exception:
                    pass  # stats must never fail the admin plane
            layer = self._layer_stats()
            if layer:
                out["layer"] = layer
            reply(encode_json("admin_response", self.my_id, out))
        elif op == "trace_dump":
            # stream this node's trace ring (or a slice of it) for the
            # cross-node merge (scripts/gp_trace.py): per-key event
            # lists with WALL-clock stamps, mergeable across nodes
            tr = self.tracer
            keys = None
            if body.get("rid") is not None:
                keys = [int(body["rid"])]
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body.get("name"), "ok": True,
                "node": self.my_id, "enabled": tr.enabled,
                "events": tr.export(
                    keys=keys, name=body.get("name") or None,
                    limit=int(body.get("limit", 256)),
                ),
            }))
        elif op == "profile":
            # on-demand torch.profiler capture of whatever this node is
            # doing right now (tick loop keeps running in its thread),
            # into a bounded dump dir — the device-plane flightdump.
            # Synchronous by design: the capture window is clamped to
            # ENGINE_PROFILE_MAX_S so the transport thread is parked for
            # a bounded, operator-chosen moment
            from .obs.device import ProfileBusy, capture_profile

            out_dir = str(
                body.get("dir")
                or Config.get_str(PC.ENGINE_PROFILE_DIR)
                or "engine_profiles"
            )
            try:
                cap = capture_profile(
                    out_dir,
                    seconds=float(body.get("seconds", 0.25)),
                    max_dumps=Config.get_int(PC.ENGINE_PROFILE_MAX_DUMPS),
                    max_seconds=Config.get_float(PC.ENGINE_PROFILE_MAX_S),
                )
                self.manager.metrics.count("engine_profile_captures")
                reply(encode_json("admin_response", self.my_id, {
                    "op": op, "name": body.get("name"), "ok": True,
                    "node": self.my_id, **cap,
                }))
            except ProfileBusy:
                reply(encode_json("admin_response", self.my_id, {
                    "op": op, "name": body.get("name"), "ok": False,
                    "node": self.my_id, "error": "profile_busy",
                }))
        elif op == "flightdump":
            # the black box, on demand: dump the engine-history rings to
            # disk and answer with the path (plus ring occupancy, so an
            # operator can see at a glance whether history was captured)
            fl = self.manager.flight
            path = fl.dump(reason=str(body.get("reason") or "admin"))
            snap = fl.snapshot()
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body.get("name"), "ok": path is not None,
                "node": self.my_id, "path": path,
                "steps": len(snap["steps"]),
                "decided": len(snap["decided"]),
            }))
        else:
            # an unknown op must still ANSWER: silence leaves the
            # client's admin waiter parked until its timeout
            reply(encode_json("admin_response", self.my_id, {
                "op": op, "name": body.get("name"), "ok": False,
                "error": "unknown_op",
            }))

    # ---- the tick loop -------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                if self._should_tick():
                    self.tick_once()
                    self._last_full_tick = time.monotonic()
                else:
                    self.idle_once()
                self._maybe_stats_line()
            except Exception:
                self.log.exception("tick loop error (loop continues)")
                # black box: a tick-loop exception is exactly the moment
                # the engine's recent history matters — dump once per
                # node (the loop continues; a persistent bug must not
                # write a dump per tick)
                try:
                    path = self.manager.flight.dump(
                        reason="tick-exception", once=True,
                        extra={"where": "server-tick-loop",
                               "node": self.my_id, "tick": self._tick},
                    )
                    if path:
                        self.log.warning("flight recorder dumped to %s",
                                         path)
                except Exception:
                    pass  # the recorder must never take the loop down
            dt = time.perf_counter() - t0
            interval = self.tick_interval
            backlog = self._batching and self.manager.has_backlog()
            if backlog:
                interval = max(
                    self._batch_sleep_s, self.manager.last_engine_step_s
                )
            sleep = interval - dt
            if sleep > 0:
                if backlog:
                    # batch aging is KICK-PROOF under backlog: a kick per
                    # arriving frame would collapse the window back to
                    # continuous ticking, and each tick costs a full
                    # engine dispatch no matter how few requests it
                    # carries — under load, fewer/fatter ticks IS the
                    # capacity (each consensus leg pays +window latency,
                    # well inside the budget)
                    time.sleep(sleep)
                else:
                    self._kick.wait(sleep)
            self._kick.clear()

    def _should_tick(self) -> bool:
        """A full engine tick is warranted only when something can change:
        a fresh peer blob, local backlog/in-flight work, queued outbound
        control traffic, election pressure, or the periodic republish."""
        if self._blob_dirty or self._in_flight:
            return True
        m = self.manager
        if m.has_backlog() or m.forward_out:
            return True
        if time.monotonic() - self._last_full_tick > self.IDLE_REPUBLISH_S:
            return True
        want = self.fd.want_coord(
            m._np("bal"), m._np("member_mask"), self.cfg.n_replicas
        )
        return want is not None and bool(np.asarray(want).any())

    def idle_once(self) -> None:
        """Host housekeeping between engine ticks: FD pings, layered
        protocol-task timers, callback GC.  Runs at the loop cadence so
        liveness machinery never depends on consensus traffic."""
        self._publish_pending()  # a staged tick must never strand idle
        self._drain_self_msgs()
        self._maybe_ping()
        self.manager.outstanding.gc()
        self._layer_tick()
        self._flush_responses()

    def tick_once(self) -> None:
        t0 = time.monotonic()
        try:
            self._tick_once_inner()
        finally:
            DelayProfiler.update_count("t_tick", time.monotonic() - t0)

    def _tick_once_inner(self) -> None:
        R = self.cfg.n_replicas
        # packed exchange: peer frames already ARE the [N] vectors, my
        # previous tick's publish vector is cached, and the [R, N] gather
        # uploads row by row into one device tensor inside the packed
        # step, never stacked on the host (the per-leaf dispatch path
        # cost ~3x the engine step at small G)
        if self._my_blob_state is not self.manager.state:
            # state changed outside the tick (create/kill/resume/recover):
            # the cached publish vector is stale — my own gathered row
            # must reflect the CURRENT state (tags/membership included).
            # The pair is captured atomically under the manager lock, so
            # a concurrent lifecycle op can never mispair them.
            self._my_blob_vec, self._my_blob_state = (
                self.manager.publish_snapshot()
            )
        my_vec = self._my_blob_vec
        with self._blob_lock:
            peer_vecs = dict(self._peer_blobs)
            self._blob_dirty = False
        rows, heard = [], np.zeros(R, bool)
        for r in range(R):
            if r == self.my_id:
                rows.append(my_vec)
                heard[r] = True
            elif r in peer_vecs:
                rows.append(peer_vecs[r])
                heard[r] = True
            else:
                rows.append(my_vec)
        gathered = rows
        want = self.fd.want_coord(
            self.manager._np("bal"),
            self.manager._np("member_mask"),
            R,
        )
        m = self.manager
        if self._pipeline:
            # double-buffered dispatch: fire step N and, while the device
            # computes it, do tick N-1's host-side codec/publish work
            # (blob frame encode, payload delta, forwards, response
            # flush).  Transport threads admit batch N+1 throughout —
            # the manager lock is free for the whole overlap window.
            # NOTHING in the overlap window may call a manager op that
            # waits on step completion (same thread completes the step).
            pend = m.step_dispatch(gathered, heard, want)
            t_overlap = time.monotonic()
            self._publish_pending()
            self._flush_responses()
            overlap_s = time.monotonic() - t_overlap
            blob_vec, blob_state, delta = m.step_complete(pend)
            mx = m.metrics
            mx.observe("pipeline_overlap_s", overlap_s)
            step_s = m.last_engine_step_s
            mx.gauge(
                "pipeline_overlap_ratio",
                min(1.0, overlap_s / step_s) if step_s > 0 else 0.0,
            )
        else:
            blob_vec, blob_state, delta = m.tick_host(gathered, heard, want)
        self._finish_tick(blob_vec, blob_state, delta)
        self._drain_self_msgs()
        if not self._pipeline or not m.has_backlog():
            # serial mode publishes its own tick immediately (the
            # pre-pipeline behavior, exactly); pipelined mode does too
            # when the loop is about to go idle — otherwise this tick's
            # frames ship in the NEXT dispatch's overlap window, which
            # under backlog begins immediately
            self._publish_pending()

        t_layer = time.monotonic()
        self._maybe_ping()
        self._layer_tick()
        DelayProfiler.update_count("t_layer", time.monotonic() - t_layer)
        self._flush_responses()  # callbacks fired by this tick's execution

    def _finish_tick(self, blob_vec, blob_state, delta) -> None:
        """Post-step bookkeeping shared by both modes: stage this tick's
        outbound frames (blob / payload delta / forwards) for
        :meth:`_publish_pending`."""
        self._my_blob_vec = blob_vec
        self._my_blob_state = blob_state
        self._tick += 1
        m = self.manager
        progressed = m.last_progress_tick == m._tick_no
        # refreshed HERE (post-engine): gates blob-kick wakeups and the
        # idle skip until the next tick updates it
        self._in_flight = m.engine_work_in_flight()
        DelayProfiler.update_count("n_ticks")
        if not progressed:
            DelayProfiler.update_count("n_ticks_noprog")
            if self._in_flight:
                DelayProfiler.update_count("n_ticks_inflight_noprog")
        # publish gating decided NOW (at the tick that produced the
        # frames): publishing from a tick that neither progressed nor has
        # work in flight would re-trigger peers' blob-driven ticks and
        # the cluster would ping-pong blobs forever at engine speed (idle
        # must converge to silence; the periodic republish in
        # _should_tick keeps stragglers healing).  In-flight republish
        # doubles as the accept-retransmit poke (pokeLocalCoordinator
        # analog).  The fallback keys on time since the last PUBLISH, not
        # the last tick: a node ticking continuously without progress
        # would otherwise never republish and stragglers could not heal
        publish_blob = progressed or self._in_flight or (
            time.monotonic() - self._last_publish > self.IDLE_REPUBLISH_S
        )
        self._pub = {
            "blob_vec": blob_vec if publish_blob else None,
            "tick": self._tick,
            "delta": delta if (
                delta["arena"] or delta.get("app_exec")
            ) else None,
            "fwd": m.drain_forward_out(),
        }

    def _drain_self_msgs(self) -> None:
        """Deliver self-destined forwards (rare) OUTSIDE the overlap
        window: on_host_message can replace engine state (state_reply),
        which must wait for step completion — waiting in the overlap
        window would deadlock the tick thread on its own step."""
        if not self._self_msgs:
            return
        msgs, self._self_msgs = self._self_msgs, []
        for k, body in msgs:
            self.manager.on_host_message(k, body)

    def _publish_pending(self) -> None:
        """Ship the staged tick outputs (blob to every peer — the
        all_gather stand-in — plus the payload-delta frame and queued
        forwards).  In pipelined mode this runs inside the NEXT tick's
        overlap window, so the frame encode + syscalls overlap the
        device step instead of following it."""
        pub, self._pub = self._pub, None
        if pub is None:
            return
        peers = [r for r in self.node_config.get_node_ids()
                 if r != self.my_id]
        m = self.manager
        t_pub = time.monotonic()
        if pub["blob_vec"] is not None:
            self._last_publish = time.monotonic()
            blob_frame = encode_blob_vec(
                self.my_id, pub["tick"], pub["blob_vec"]
            )
            mx = m.metrics
            mx.gauge("blob_frame_bytes", len(blob_frame))
            mx.count("blob_bytes_sent", len(blob_frame) * len(peers))
            mx.count("blob_frames_sent", len(peers))
            for r in peers:
                # latest-wins: a blob still queued for a slow link is
                # replaced by this newer one (multi-MB frames at large G
                # would otherwise pile up behind each other)
                self.transport.send_latest_to_id(r, "blob", blob_frame)
        if pub["delta"] is not None:
            frame = encode_json("payloads", self.my_id, pub["delta"])
            for r in peers:
                self.transport.send_to_id(r, frame)
        dt_pub = time.monotonic() - t_pub
        DelayProfiler.update_count("t_publish", dt_pub)
        m.metrics.observe("phase_publish_s", dt_pub)
        for dst, k, body in pub["fwd"]:
            frame = encode_json(k, self.my_id, body)
            # send_frame_to_id streams oversize frames (a multi-MB
            # state_reply must not monopolize the link)
            if dst == -1:
                for r in peers:
                    self.send_frame_to_id(r, frame)
            elif dst == self.my_id:
                # deferred: a self-destined host message may replace
                # engine state and must not run in the overlap window
                self._self_msgs.append((k, body))
            else:
                self.send_frame_to_id(dst, frame)

    def _heat_stats(self) -> Dict:
        """Group-heat block for the ``stats`` op — degrades to an empty
        dict rather than failing the admin plane."""
        try:
            self.manager.pull_group_heat()
            return self.manager.group_heat_stats()
        except Exception:
            return {}

    def _maybe_stats_line(self) -> None:
        """Periodic INFO stats line (engine counters + DelayProfiler) —
        one `isEnabledFor` check per period when INFO is off."""
        now = time.monotonic()
        elapsed = now - self._last_stats_line
        if elapsed < self._stats_period_s:
            return
        self._last_stats_line = now
        # per-process resource gauges (RSS / fds / GC / threads) refresh
        # at the stats cadence: slow leaks across a multi-hour soak (or a
        # SERVING_WORKERS parent) become visible on /metrics and the
        # stats op long before the box dies
        collect_process_gauges(self.manager.metrics)
        # the stats-cadence group-heat pull: drains the device-resident
        # [G] activity accumulator into the group_heat* metrics — the
        # ONE sanctioned device sync outside the hot-path _np cache
        # (scripts/check_obs_hygiene.py polices exactly this)
        try:
            self.manager.pull_group_heat()
        except Exception:
            pass
        if self.log.isEnabledFor(logging.INFO):
            # dispatch RATE + compile counts ride the plain-log line so a
            # retrace storm (or a stalled dispatch loop) is visible in a
            # soak's tail -f, not just on /metrics
            mx = self.manager.metrics
            disp = mx.get("host_dispatches")
            rate = (disp - self._last_stats_dispatches) / max(
                elapsed, 1e-9
            )
            self._last_stats_dispatches = disp
            cs = self.manager.engine_compile_stats()
            n_comp = (
                cs["dispatch"]["compiles"] + cs["tick"]["compiles"]
            )
            n_retr = (
                cs["dispatch"]["retraces"] + cs["tick"]["retraces"]
            )
            self.log.info(
                "stats tick=%d dispatch_rate=%.1f/s engine_compiles=%d "
                "engine_retraces=%d %s %s", self._tick, rate, n_comp,
                n_retr, self.manager.metrics.summary_line(),
                DelayProfiler.get_stats(),
            )

    def _maybe_ping(self) -> None:
        """Failure-detection pings at period = timeout/2
        (FailureDetectionPacket wire schema, FailureDetectionPacket.java)."""
        now = time.time()
        if now - self._last_ping > self.fd.ping_period_s:
            self._last_ping = now
            from .packets.paxos_packets import FailureDetectionPacket

            ping = encode_json("fd_ping", self.my_id, FailureDetectionPacket(
                sender=str(self.my_id), send_time=now,
            ).to_json())
            for r in self.node_config.get_node_ids():
                if r != self.my_id:
                    self.transport.send_to_id(r, ping)

    def _layer_tick(self) -> None:
        """Per-tick hook for layered roles (AR/RC protocol tasks)."""

    def _layer_stats(self) -> Optional[Dict]:
        """Layered roles' contribution to the ``stats`` admin op (the RC
        adds its placement-plane snapshot); None = nothing to add."""
        return None

    def _echo_load(self) -> Dict:
        """This node's load summary for echo replies.  The AR role
        overrides with its layer's `load_summary()` so the client-plane
        and epoch-plane echo payloads stay the same shape."""
        return {"names": len(self.manager.names)}
