"""Parent-side shard router: the node's public face when serving is
worker-sharded.

Binds the node's base port(s) — where clients, reconfigurators, and
launchers expect the node — and does accept/route ONLY (no engine, no
journal, no app):

* client request frames (binary ``R`` or JSON) split by
  :func:`..serving.shard_of_name` into per-shard sub-batches, forwarded
  to the owning worker over one persistent loopback link per worker;
* worker responses demultiplex back per ORIGIN client connection (one
  worker frame can carry many clients' completions — the router
  re-buffers per client and re-frames in the client's own dialect,
  binary or JSON);
* ``epoch`` control (RC → AR) routes by the nested name; nameless epoch
  control broadcasts (idempotent layer handlers own dedup);
* admin ops with a name route by name; ``stats`` fans out to every
  worker and aggregates (phase = worst of the workers', so the
  launcher's readiness wait still means "every shard serving");
* consensus-plane frames (packed blobs, payload gossip, forwards)
  arriving at the base port are a MISCONFIGURATION — worker meshes talk
  worker-port-to-worker-port — and drop loudly, like blob schema skew.

The router is deliberately stateless about names: shard assignment is a
pure hash, so a restart loses nothing and replicas never disagree.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..clients.base import AsyncFrameClient
from ..net import hot_codec
from ..net.codec import decode_json, decode_kind, encode_json
from ..net.node_config import NodeConfig
from ..net.transport import MessageTransport
from ..obs import gplog
from ..paxos_config import PC
from ..utils.config import Config
from . import shard_of_name, worker_address

# client-plane waiter TTL: a worker that died before answering must not
# leak reply closures forever (clients retransmit anyway)
WAITER_TTL_S = 30.0


class _WorkerLink(AsyncFrameClient):
    """One shared loop + per-worker connections; inbound worker frames
    hand off to the router's response demux."""

    def __init__(self, on_frame: Callable[[bytes], None]):
        super().__init__(ssl_context=False)  # loopback links: never TLS
        self._ssl_ctx = None
        self.on_frame = on_frame

    def _dispatch(self, payload: bytes) -> None:
        self.on_frame(payload)


class ShardedActiveNode:
    """A sharded active node's parent half: worker supervisor + router,
    presented with the same start/stop surface as a PaxosServer so
    :class:`~gigapaxos_tpu_torch.reconfigurable_node.ReconfigurableNode` can
    hold either interchangeably."""

    def __init__(self, node_name: str, n_workers: Optional[int] = None,
                 device=None):
        from ..ops.engine import resolve_device
        from .supervisor import WorkerSupervisor

        # the workers' engine device: the card unless the caller asks for
        # the CPU; with no card and no device this raises here, before
        # any worker is spawned
        self.device = resolve_device(device)
        self.router = ShardRouter(node_name, n_workers)
        # workers re-derive the parent's EFFECTIVE config from key=value
        # argv (programmatic Config.set tiers don't cross exec)
        self.supervisor = WorkerSupervisor(
            node_name, self.router.n_workers,
            extra_args=[
                f"{k}={v}" for k, v in Config.overrides().items()
            ],
            device=self.device.type,
        )

    def start(self) -> None:
        if self.device.type == "cuda":
            # build (or find) the hashed kernel libraries once, here,
            # so the workers booting together load them instead of each
            # running the same nvcc jobs; this runs no CUDA context
            from ..ops import gp_kernels

            gp_kernels.build()
        self.supervisor.start()
        if not self.supervisor.wait_listening():
            self.supervisor.stop()
            raise RuntimeError(
                f"serving workers for {self.router.node_name!r} failed "
                "to come up (see worker logs)"
            )
        self.router.start()

    def stop(self) -> None:
        self.router.stop()
        self.supervisor.stop()


class ShardRouter:
    """Accept/route process for one sharded active node."""

    def __init__(self, node_name: str, n_workers: Optional[int] = None):
        self.node_name = node_name
        self.n_workers = (
            Config.get_int(PC.SERVING_WORKERS)
            if n_workers is None else int(n_workers)
        )
        self.ar_nodes = NodeConfig.from_properties("active")
        my_id = self.ar_nodes.id_of_name(node_name)
        if my_id is None:
            raise ValueError(f"{node_name!r} is not an active")
        self.my_id = int(my_id)
        self.log = gplog.node_logger("serving", self.my_id)
        base = self.ar_nodes.get_node_address(self.my_id)
        self.worker_addrs = [
            worker_address(base, w) for w in range(self.n_workers)
        ]
        self.transport = MessageTransport(
            self.my_id, self.ar_nodes, self._on_message
        )
        self.link = _WorkerLink(self._on_worker_frame)
        # request_id -> (t, client reply, binary) while a worker owes an
        # answer; admin/echo waiters keyed by their own correlators
        self._lock = threading.Lock()
        self._waiters: Dict[int, Tuple[float, Callable, bool]] = {}
        self._admin_waiters: Dict[Tuple, Tuple[float, Callable]] = {}
        self._last_gc = 0.0
        self._schema_warned: set = set()
        self.n_routed = 0

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self.transport.start()

    def stop(self) -> None:
        self.transport.stop()
        self.link.close()

    # ---- helpers -------------------------------------------------------
    def _send_worker(self, w: int, frame: bytes) -> None:
        self.link.send_frame(self.worker_addrs[w], frame)

    def _broadcast(self, frame: bytes) -> None:
        for w in range(self.n_workers):
            self._send_worker(w, frame)

    def _register(self, rid: int, reply, binary: bool) -> None:
        now = time.time()
        with self._lock:
            self._waiters[int(rid)] = (now, reply, binary)
            if now - self._last_gc > 5.0:
                self._last_gc = now
                cut = now - WAITER_TTL_S
                for k in [k for k, (t, _r, _b) in self._waiters.items()
                          if t < cut]:
                    del self._waiters[k]
                for k in [k for k, (t, _r) in self._admin_waiters.items()
                          if t < cut]:
                    del self._admin_waiters[k]

    def _warn_once(self, key: str, msg: str, *args) -> None:
        if key not in self._schema_warned:
            self._schema_warned.add(key)
            self.log.warning(msg, *args)

    # ---- ingress from clients / RCs (base port) ------------------------
    def _on_message(self, payload: bytes, peer, reply) -> None:
        payload = bytes(payload)  # a large frame arrives as a bytearray
        kind = decode_kind(payload)
        if kind == "R":
            self._route_binary(payload, reply)
            return
        if kind != "J":
            # packed blobs / unknown schemas at the BASE port mean a peer
            # is misconfigured (worker meshes are port-shifted) — loudly
            self._warn_once(
                kind, "dropping %r frame at the router base port (worker "
                "meshes are port-shifted; check SERVING_WORKERS on peers)",
                kind,
            )
            return
        try:
            k, sender, body = decode_json(payload)
        except (ValueError, KeyError):
            return
        if k in ("client_request", "client_request_batch"):
            self._route_json_requests(k, sender, body, reply)
        elif k == "admin":
            self._route_admin(sender, body, reply)
        elif k == "echo":
            # answer at the router: load here is the node's load (names
            # aggregate across shards isn't worth a fan-out per echo —
            # the count converges via the demand plane anyway)
            reply(encode_json("echo_reply", self.my_id, {
                "ts": body.get("ts"), "round": body.get("round"),
                "from": self.my_id, "names": -1, "sharded": self.n_workers,
            }))
        elif k == "epoch":
            nested = body.get("body") or {}
            nm = nested.get("name")
            frame = payload  # forward verbatim; workers see the RC sender
            if nm is None:
                self._broadcast(frame)
            else:
                self._send_worker(
                    shard_of_name(str(nm), self.n_workers), frame
                )
        elif k == "fd_ping":
            pass  # liveness heard; workers run their own FDs
        else:
            self._warn_once(
                f"J:{k}", "dropping %r at the router base port (consensus "
                "/ mesh traffic belongs on the worker ports)", k,
            )

    def _route_binary(self, payload: bytes, reply) -> None:
        try:
            sender, items = hot_codec.decode_request_batch(payload)
        except ValueError:
            self._warn_once("R", "dropping malformed binary request frame")
            return
        by_shard: Dict[int, List] = {}
        for item in items:
            by_shard.setdefault(
                shard_of_name(item[1], self.n_workers), []
            ).append(item)
            self._register(item[0], reply, True)
        for w, sub in by_shard.items():
            self._send_worker(
                w, hot_codec.encode_request_batch(sender, sub)
            )
        self.n_routed += len(items)

    def _route_json_requests(self, k: str, sender, body, reply) -> None:
        reqs = [body] if k == "client_request" else body.get("reqs", ())
        by_shard: Dict[int, List[Dict]] = {}
        for sub in reqs:
            try:
                nm, rid = sub["name"], int(sub["request_id"])
            except (KeyError, TypeError, ValueError):
                continue
            by_shard.setdefault(
                shard_of_name(nm, self.n_workers), []
            ).append(sub)
            self._register(rid, reply, False)
        for w, subs in by_shard.items():
            if len(subs) == 1:
                frame = encode_json("client_request", sender, subs[0])
            else:
                frame = encode_json(
                    "client_request_batch", sender, {"reqs": subs}
                )
            self._send_worker(w, frame)
        self.n_routed += len(reqs)

    def _route_admin(self, sender, body, reply) -> None:
        op = body.get("op")
        name = body.get("name")
        if op == "stats":
            # fan out + aggregate on a side thread (the transport loop
            # must keep routing while workers answer)
            threading.Thread(
                target=self._aggregate_stats, args=(body, reply),
                daemon=True,
            ).start()
            return
        if name is None:
            # nameless non-stats admin op: worker 0 answers (today's ops
            # are all named or stats; this keeps unknown ops answering
            # rather than hanging the client's waiter)
            w = 0
        else:
            w = shard_of_name(str(name), self.n_workers)
        with self._lock:
            self._admin_waiters[(op, name)] = (time.time(), reply)
        self._send_worker(w, encode_json("admin", sender, body))

    def _aggregate_stats(self, body, reply) -> None:
        """One stats round trip per worker, merged: counters sum, phase
        is the worst, per-worker snapshots ride along."""
        per_worker = []
        for w in range(self.n_workers):
            per_worker.append(self._admin_sync_worker(
                w, {"op": "stats", "name": f"_w{w}"}, timeout=5.0
            ))
        phases = [
            (s or {}).get("phase", "unreachable") for s in per_worker
        ]
        phase = "serving"
        for p in phases:
            if p != "serving":
                phase = p if p != "unreachable" else "recovering"
                break
        out = {
            "op": "stats", "name": body.get("name"), "ok": True,
            "phase": phase,
            "serving": {
                "router": True,
                "serving_workers": self.n_workers,
                "codec": hot_codec.status(),
                "requests_routed": self.n_routed,
                "worker_phases": phases,
            },
            "workers": per_worker,
        }
        reply(encode_json("admin_response", self.my_id, out))

    def _admin_sync_worker(self, w: int, body, timeout: float):
        """Blocking admin round trip to one worker (stats fan-out path;
        runs on the aggregator thread, never the transport loop)."""
        ev = threading.Event()
        box: Dict = {}
        key = (body.get("op"), body.get("name"))
        with self._lock:
            self._admin_waiters[key] = (
                time.time(),
                lambda frame: (box.update(frame=frame), ev.set()),
            )
        self._send_worker(w, encode_json("admin", -1, body))
        if not ev.wait(timeout):
            return None
        try:
            _k, _s, resp = decode_json(box["frame"])
            return resp
        except (ValueError, KeyError):
            return None

    # ---- responses coming back from workers ----------------------------
    def _on_worker_frame(self, payload: bytes) -> None:
        kind = decode_kind(payload)
        if kind == "S":
            try:
                _sender, items = hot_codec.decode_response_batch(payload)
            except ValueError:
                return
            self._deliver(items)
            return
        if kind != "J":
            return
        try:
            k, _sender, body = decode_json(payload)
        except (ValueError, KeyError):
            return
        if k == "client_response":
            self._deliver([body])
        elif k == "client_response_batch":
            self._deliver(body.get("resps", ()))
        elif k in ("admin_response", "echo_reply"):
            key = (body.get("op"), body.get("name"))
            with self._lock:
                ent = self._admin_waiters.pop(key, None)
            if ent is not None:
                ent[1](payload)

    def _deliver(self, items) -> None:
        """Demux worker completions back to their origin connections,
        re-framed per client dialect — one frame per client per worker
        flush (the coalescing survives the extra hop)."""
        by_client: Dict[int, Tuple[Callable, List[Dict], bool]] = {}
        for item in items:
            rid = item.get("request_id")
            if rid is None:
                continue
            with self._lock:
                ent = self._waiters.get(int(rid))
                if ent is not None and item.get("error") != "overload":
                    # overload is a transient shed: the client will
                    # retransmit THROUGH this waiter — keep it
                    del self._waiters[int(rid)]
            if ent is None:
                continue
            _t, reply, binary = ent
            key = id(reply)
            got = by_client.get(key)
            if got is None:
                by_client[key] = (reply, [item], binary)
            else:
                got[1].append(item)
        for reply, resp_items, binary in by_client.values():
            if binary and all(
                hot_codec.encodable_response(i) for i in resp_items
            ):
                reply(hot_codec.encode_response_batch(
                    self.my_id, resp_items
                ))
            elif len(resp_items) == 1:
                reply(encode_json(
                    "client_response", self.my_id, resp_items[0]
                ))
            else:
                reply(encode_json(
                    "client_response_batch", self.my_id,
                    {"resps": resp_items},
                ))
