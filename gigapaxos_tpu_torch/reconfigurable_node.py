"""ReconfigurableNode — deployable AR/RC roles over real sockets.

API-parity target: ``ReconfigurableNode`` (``ReconfigurableNode.java:59,
223-300``) — the server entry point that reads ``active.NAME=host:port`` /
``reconfigurator.NAME=host:port`` from the properties config, boots an
:class:`ActiveReplicaServer` and/or :class:`ReconfiguratorServer` for the
roles this node name holds, and wires the epoch plane through the same
transport demux as the paxos plane.

Topology: actives form one engine cluster (the app RSMs), reconfigurators
another (the RC-record RSM, ``RepliconfigurableReconfiguratorDB`` analog);
each role runs the full :class:`~gigapaxos_tpu_torch.server.PaxosServer` stack
(engine + journal + FD + blob exchange) plus its layer object
(:class:`~gigapaxos_tpu_torch.reconfiguration.active_replica.ActiveReplica` /
:class:`~gigapaxos_tpu_torch.reconfiguration.reconfigurator.Reconfigurator`).
Epoch-plane messages ride ``J`` frames of kind ``epoch`` with the layer
kind/body nested, addressed via the (role, id) books.

Client replies: a reconfigurator op's ack can fire long after the request
(on COMPLETE / DELETE_FINAL) and possibly at a different RC than the one
the client spoke to (ops forward to the record's primary).  The client
address is therefore ("CLIENT", rc_id, token): the RC that owns `token`
replies on the client's live connection; any other RC relays the reply to
rc_id first (the reference solves this with client-socket messengers,
``ReconfigurableAppClientAsync.java:75``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .net.codec import encode_json
from .net.node_config import NodeConfig
from .ops.engine import EngineConfig
from .paxos_config import PC
from .reconfiguration.active_replica import ActiveReplica
from .reconfiguration.coordinator import PaxosReplicaCoordinator
from .reconfiguration.rc_app import RCRecordsApp
from .reconfiguration.reconfigurator import RC_GROUP, Reconfigurator
from .server import PaxosServer
from .utils.config import Config

# reconfigurator-plane kinds a client may send to an RC
RC_CLIENT_KINDS = (
    "create_service", "create_service_batch", "delete_service",
    "reconfigure", "request_actives", "add_active", "remove_active",
)


class _EpochSender:
    """Routes layer sends to the (role, id) address books over a transport."""

    def __init__(self, server: PaxosServer, ar_nodes: NodeConfig,
                 rc_nodes: NodeConfig):
        self.server = server
        self.ar_nodes = ar_nodes
        self.rc_nodes = rc_nodes

    def __call__(self, dst: Tuple, kind: str, body: Dict) -> None:
        role = dst[0]
        if role == "CLIENT":
            self.server._reply_client(tuple(dst), kind, body)
            return
        book = self.ar_nodes if role == "AR" else self.rc_nodes
        nid = int(dst[1])
        if nid not in book:
            return
        frame = encode_json(
            "epoch", self.server.my_id, {"kind": kind, "body": body}
        )
        # streams oversize frames (epoch_final_state can carry a multi-MB
        # app checkpoint — LargeCheckpointer territory)
        self.server.send_frame_to_address(book.get_node_address(nid), frame)


class ActiveReplicaServer(PaxosServer):
    """A PaxosServer hosting the app engine + the ActiveReplica epoch layer
    (``ActiveReplica.java:128`` behind ``ReconfigurableNode.java:274-282``)."""

    def __init__(self, my_id: int, ar_nodes: NodeConfig, rc_nodes: NodeConfig,
                 app, cfg: EngineConfig, device=None, **kw):
        super().__init__(my_id, ar_nodes, app, cfg, device=device, **kw)
        self.ar_nodes = ar_nodes
        self.rc_nodes = rc_nodes
        self._layer_lock = threading.RLock()
        self.coordinator = PaxosReplicaCoordinator(app, self.manager)
        self.active_replica = ActiveReplica(
            my_id, self.coordinator,
            _EpochSender(self, ar_nodes, rc_nodes),
            rc_ids=rc_nodes.get_node_ids(),
        )
        # LOCK ORDER: transport threads take layer_lock -> manager lock
        # (handle_message -> coordinate/create), so callbacks fired UNDER
        # the manager lock (stop execution inside manager.tick) must not
        # take the layer lock — they are queued and drained at tick time.
        self._evt_lock = threading.Lock()
        self._stop_events: List[Tuple[str, int, int]] = []

        def deferred_stop(name: str, row: int, epoch: int) -> None:
            with self._evt_lock:
                self._stop_events.append((name, row, epoch))

        self.manager.on_stop_executed = deferred_stop
        # app-request REST (HttpActiveReplica analog) at port + offset
        self._http = None
        try:
            from .http_front import start_ar_http

            self._http = start_ar_http(
                self.transport.listen_host,
                self.transport.listen_port
                + Config.get_int(PC.HTTP_PORT_OFFSET),
                lambda name, value, cb: self.manager.propose(
                    name, value, callback=cb
                ),
                overloaded=self.manager.overloaded,
                metrics=self.manager.metrics.render,
            )
        except OSError:
            pass  # HTTP port taken: binary protocol still fully serves

    def stop(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()  # release the bound listen socket
        super().stop()

    def _reply_client(self, dst, kind, body) -> None:
        pass  # ARs never address clients through the epoch plane

    def _on_json(self, k, sender, body, reply) -> bool:
        if super()._on_json(k, sender, body, reply):
            return True
        if k == "epoch":
            with self._layer_lock:
                self.active_replica.handle_message(body["kind"], body["body"])
            return True
        return False

    def _layer_tick(self) -> None:
        with self._evt_lock:
            events, self._stop_events = self._stop_events, []
        with self._layer_lock:
            for name, row, epoch in events:
                self.active_replica._on_stop_executed(name, row, epoch)
            self.active_replica.tick()

    def _echo_load(self) -> Dict:
        # scalar reads only (no lock): a torn read costs one slightly
        # stale load sample, never a crash
        return self.active_replica.load_summary()


class ReconfiguratorServer(PaxosServer):
    """A PaxosServer whose app is the RC-record RSM, plus the Reconfigurator
    orchestration layer (``Reconfigurator.java:125`` behind
    ``ReconfigurableNode.java:283-296``)."""

    def __init__(self, my_id: int, ar_nodes: NodeConfig, rc_nodes: NodeConfig,
                 rc_cfg: EngineConfig, ar_cfg: EngineConfig, device=None,
                 **kw):
        self.rc_app = RCRecordsApp()
        super().__init__(my_id, rc_nodes, self.rc_app, rc_cfg, device=device,
                         **kw)
        self.ar_nodes = ar_nodes
        self.rc_nodes = rc_nodes
        self._layer_lock = threading.RLock()
        # client-reply registry: token -> (deadline, reply fn)
        self._client_replies: Dict[str, Tuple[float, Callable]] = {}
        self._client_seq = 0
        rc_ids = rc_nodes.get_node_ids()
        ar_ids = ar_nodes.get_node_ids()
        self.reconfigurator = Reconfigurator(
            my_id, self.manager, self.rc_app, ar_ids, rc_ids,
            _EpochSender(self, ar_nodes, rc_nodes),
            ar_n_groups=ar_cfg.n_groups,
            is_node_up=self.fd.is_node_up,
        )
        # LOCK ORDER (see ActiveReplicaServer): on_applied fires inside
        # manager.tick under the manager lock — queue and drain at tick.
        self._evt_lock = threading.Lock()
        self._applied_events: List[Dict] = []
        layer_on_applied = self.rc_app.on_applied  # Reconfigurator._on_applied

        def deferred_applied(op: Dict) -> None:
            with self._evt_lock:
                self._applied_events.append(op)

        self.rc_app.on_applied = deferred_applied
        self._layer_on_applied = layer_on_applied
        # same deferral for restore (checkpoint transfer installs the app
        # state on a transport thread under the manager lock; the ring
        # refresh must run under the layer lock at tick time)
        layer_on_restored = self.rc_app.on_restored
        self._restored_pending = False

        def deferred_restored() -> None:
            with self._evt_lock:
                self._restored_pending = True

        self.rc_app.on_restored = deferred_restored
        self._layer_on_restored = layer_on_restored
        # bootstrap the RC-record RSM (the AR_RC_NODES-style special group,
        # ReconfigurableNode.java:160-181): deterministic row on every RC
        self.manager.create_paxos_instance(RC_GROUP, rc_ids)
        # REST front-end (HttpReconfigurator analog) at port + offset
        self._http = None
        try:
            from .http_front import start_rc_http

            def submit(kind: str, body: Dict, waiter) -> None:
                op = dict(body)
                op["client"] = self._register_client_fn(waiter)
                with self._layer_lock:
                    self.reconfigurator.handle_message(kind, op)

            self._http = start_rc_http(
                self.transport.listen_host,
                self.transport.listen_port
                + Config.get_int(PC.HTTP_PORT_OFFSET),
                submit,
                metrics=self.manager.metrics.render,
                stats=self._layer_stats,
            )
        except OSError:
            pass  # HTTP port taken: binary protocol still fully serves

    def stop(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()  # release the bound listen socket
        super().stop()

    # ---- client replies -------------------------------------------------
    def _register_client(self, reply) -> List:
        """Socket client: replies re-encode as rc_client_reply frames."""
        return self._register_client_fn(
            lambda kind, body: reply(encode_json(
                "rc_client_reply", self.my_id, {"kind": kind, "body": body}
            ))
        )

    def _register_client_fn(self, fn: Callable[[str, Dict], None]) -> List:
        """Register a decoded-reply sink (HTTP workers use this directly)."""
        with self._layer_lock:
            self._client_seq += 1
            token = str(self._client_seq)
            self._client_replies[token] = (
                time.time() + Config.get_float(PC.REQUEST_TIMEOUT_S) * 8,
                fn,
            )
            # opportunistic GC
            if self._client_seq % 64 == 0:
                now = time.time()
                for t in [t for t, (dl, _) in self._client_replies.items()
                          if dl < now]:
                    del self._client_replies[t]
        return ["CLIENT", self.my_id, token]

    def _reply_client(self, dst, kind, body) -> None:
        _role, rc_id, token = dst[0], int(dst[1]), str(dst[2])
        if rc_id != self.my_id:
            # the token lives at the RC the client spoke to — relay
            frame = encode_json("client_reply", self.my_id, {
                "client": list(dst), "kind": kind, "body": body,
            })
            if rc_id in self.rc_nodes:
                self.transport.send_to_address(
                    self.rc_nodes.get_node_address(rc_id), frame
                )
            return
        with self._layer_lock:
            ent = self._client_replies.pop(token, None)
        if ent is not None:
            ent[1](kind, body)

    # ---- demux ----------------------------------------------------------
    def _on_json(self, k, sender, body, reply) -> bool:
        if super()._on_json(k, sender, body, reply):
            return True
        if k == "epoch":
            with self._layer_lock:
                self.reconfigurator.handle_message(body["kind"], body["body"])
            return True
        if k == "rc_client":
            kind = body["kind"]
            if kind not in RC_CLIENT_KINDS:
                return True
            op = dict(body["body"])
            op["client"] = self._register_client(reply)
            with self._layer_lock:
                self.reconfigurator.handle_message(kind, op)
            return True
        if k == "client_reply":
            self._reply_client(tuple(body["client"]), body["kind"], body["body"])
            return True
        return False

    def _layer_tick(self) -> None:
        with self._evt_lock:
            events, self._applied_events = self._applied_events, []
            restored, self._restored_pending = self._restored_pending, False
        with self._layer_lock:
            if restored and self._layer_on_restored is not None:
                self._layer_on_restored()
            for op in events:
                self._layer_on_applied(op)
            self.reconfigurator.tick()

    def _layer_stats(self) -> Dict:
        # PlacementEngine.snapshot is internally locked — safe from admin
        # and HTTP worker threads without the layer lock
        return {"placement": self.reconfigurator.placement.snapshot()}


class ReconfigurableNode:
    """Boot the roles a node name holds (``ReconfigurableNode.java:223-300``).

    ``active.NAME=host:port`` / ``reconfigurator.NAME=host:port`` config
    entries define the cluster; this node starts a server per role its
    NAME appears in.  ``make_app`` builds the Replicable app instance
    (reflection-ctor analog, ``ReconfigurableNode.java:112-130``).
    ``device`` is every role's engine device: the CUDA card by default
    (raising when there is none), ``"cpu"`` for the plain engine.
    """

    def __init__(
        self,
        name: str,
        make_app: Callable[[], Any],
        ar_cfg: Optional[EngineConfig] = None,
        rc_cfg: Optional[EngineConfig] = None,
        log_dir: Optional[str] = None,
        device=None,
        **server_kw,
    ):
        self.name = name
        ar_nodes = NodeConfig.from_properties("active")
        rc_nodes = NodeConfig.from_properties("reconfigurator")
        if ar_cfg is None:
            # ENGINE_ROWS is the allocated row count (RAM/HBM cost), NOT
            # the 2M design ceiling — a default CLI boot must be usable
            ar_cfg = EngineConfig(
                n_groups=min(Config.get_int(PC.ENGINE_ROWS),
                             Config.get_int(PC.PINSTANCES_CAPACITY)),
                window=Config.get_int(PC.SLOT_WINDOW),
                req_lanes=8,
                n_replicas=max(len(ar_nodes), 1),
            )
        if rc_cfg is None:
            rc_cfg = EngineConfig(
                n_groups=64, window=Config.get_int(PC.SLOT_WINDOW),
                req_lanes=8, n_replicas=max(len(rc_nodes), 1),
            )
        self.servers: List[PaxosServer] = []
        ar_id = ar_nodes.id_of_name(name)
        rc_id = rc_nodes.id_of_name(name)
        if ar_id is None and rc_id is None:
            raise ValueError(
                f"{name!r} appears in neither active.* nor reconfigurator.*"
            )
        n_workers = Config.get_int(PC.SERVING_WORKERS)
        if ar_id is not None:
            if n_workers > 1:
                # sharded serving: this process becomes the accept/route
                # parent; worker PROCESSES own the engine/journal per
                # name shard (serving/), on this node's device.  The RC
                # role (if this node holds one) stays unsharded below.
                from .serving.router import ShardedActiveNode

                self.servers.append(
                    ShardedActiveNode(name, n_workers, device=device)
                )
            else:
                self.servers.append(ActiveReplicaServer(
                    ar_id, ar_nodes, rc_nodes, make_app(), ar_cfg,
                    log_dir=(f"{log_dir}/ar{ar_id}" if log_dir else None),
                    device=device, **server_kw,
                ))
        if rc_id is not None:
            rc_ar_cfg = ar_cfg
            if n_workers > 1:
                # the actives' names live in worker shards of
                # ENGINE_ROWS / SERVING_WORKERS rows each: probe rows in
                # that space (a deliberate divergence from the JAX
                # package, which probes ENGINE_ROWS and so can place a
                # name beyond its worker's engine; ROADMAP section C)
                from .serving import worker_rows

                rc_ar_cfg = ar_cfg._replace(n_groups=worker_rows(
                    Config.get_int(PC.ENGINE_ROWS), n_workers))
            self.servers.append(ReconfiguratorServer(
                rc_id, ar_nodes, rc_nodes, rc_cfg, rc_ar_cfg,
                log_dir=(f"{log_dir}/rc{rc_id}" if log_dir else None),
                device=device, **server_kw,
            ))

    def start(self) -> None:
        for s in self.servers:
            s.start()

    def stop(self) -> None:
        for s in self.servers:
            s.stop()


def check_application(path: str) -> None:
    """Refuse an ``APPLICATION`` of the JAX package: loading it would
    import JAX into a node of the port.  Nothing rewrites it silently."""
    if path == "gigapaxos_tpu" or path.startswith("gigapaxos_tpu."):
        raise ValueError(
            f"APPLICATION={path} names the JAX package; a node of the port "
            "loads its apps from gigapaxos_tpu_torch (for example "
            "gigapaxos_tpu_torch.models.apps.NoopPaxosApp)")


def app_class() -> type:
    """The Replicable class the ``APPLICATION`` setting names (a dotted
    path; default: this package's ``NoopPaxosApp``)."""
    import importlib

    path = Config.get("APPLICATION") or \
        "gigapaxos_tpu_torch.models.apps.NoopPaxosApp"
    check_application(path)
    mod, _, cls = path.rpartition(".")
    return getattr(importlib.import_module(mod), cls)


def main(argv: Optional[List[str]] = None) -> None:
    """CLI entry: ``python -m gigapaxos_tpu_torch.reconfigurable_node NAME...``
    with flags/addresses from the properties file (``GIGAPAXOS_CONFIG``)
    and ``key=value`` CLI overrides (``PaxosServer.main`` analog);
    ``DEVICE=cpu`` runs every node's engine on the CPU (default: the
    CUDA card)."""
    import os
    import signal
    import sys

    from .utils.config import load_default_config_file

    argv = sys.argv[1:] if argv is None else argv
    load_default_config_file()
    rest = list(Config.register_args(argv))
    # -c = clean slate (CMD_OPTIONS=-c parity): wipe this node's durable
    # state before booting
    clean_slate = "-c" in rest
    names = [a for a in rest if a != "-c"]
    device = Config.get_str(PC.DEVICE) or None
    app_cls = app_class()
    # the enum default names a relative dir; only an EXPLICIT setting
    # turns on durability for CLI nodes (tests/dev default to memory-only)
    log_root = (
        Config.get_str(PC.PAXOS_LOGS_DIR)
        if Config.is_set(PC.PAXOS_LOGS_DIR) else None
    )
    if clean_slate and log_root:
        import shutil

        # wipe ONLY the booted names' state: other nodes on this machine
        # may share the PAXOS_LOGS_DIR root and be alive right now
        for n in names:
            d = os.path.join(log_root, n)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
    nodes = [
        ReconfigurableNode(
            n, app_cls,
            log_dir=(os.path.join(log_root, n) if log_root else None),
            device=device,
        )
        for n in names
    ]
    for n in nodes:
        n.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    for n in nodes:
        n.stop()


if __name__ == "__main__":
    main()
