"""Serving-worker process entry: ``python -m gigapaxos_tpu_torch.serving.worker
NODE_NAME WORKER_INDEX``.

Boots ONE worker shard of an active replica: the full
:class:`~gigapaxos_tpu_torch.reconfigurable_node.ActiveReplicaServer` stack
(engine + journal + FD + blob exchange + epoch layer) over the worker's
derived view of the cluster (:func:`..serving.apply_worker_view`) —
every ``active.*`` address shifted to this worker index's port, rows cut
to this worker's share, journal under ``.../workerN/``.  Worker ``w``
here and worker ``w`` on the peer replicas form a private consensus
cluster; nothing in this process knows the other shards exist.

The parent (:mod:`.router`) spawns these via :class:`.supervisor.
WorkerSupervisor` and routes client/epoch traffic to them by name hash.
Only the ACTIVE role runs here — a node that is also a reconfigurator
keeps its RC server unsharded in the parent process.  The engine runs on
the device ``DEVICE`` names (the parent passes its own in argv): the CUDA
card when unset, raising when there is none; ``DEVICE=cpu`` runs the
plain engine.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import List, Optional

from ..obs import gplog
from ..paxos_config import PC
from ..utils.config import Config
from . import apply_worker_view


def main(argv: Optional[List[str]] = None) -> None:
    import sys

    from ..net.node_config import NodeConfig
    from ..utils.config import load_default_config_file

    argv = sys.argv[1:] if argv is None else argv
    load_default_config_file()
    rest = list(Config.register_args(argv))
    if len(rest) != 2:
        raise SystemExit("usage: ... serving.worker NODE_NAME WORKER_INDEX")
    node_name, w = rest[0], int(rest[1])
    n_workers = Config.get_int(PC.SERVING_WORKERS)
    apply_worker_view(w, n_workers)
    gplog.configure()
    log = gplog.get_logger("serving")

    from ..ops.engine import EngineConfig
    from ..reconfigurable_node import ActiveReplicaServer, app_class

    # the parent ships its effective device as DEVICE=...; unset means
    # the CUDA card, and with no card the server below raises
    device = Config.get_str(PC.DEVICE) or None

    ar_nodes = NodeConfig.from_properties("active")
    rc_nodes = NodeConfig.from_properties("reconfigurator")
    ar_id = ar_nodes.id_of_name(node_name)
    if ar_id is None:
        raise SystemExit(f"{node_name!r} is not an active")
    app_cls = app_class()
    cfg = EngineConfig(
        n_groups=Config.get_int(PC.ENGINE_ROWS),  # already this worker's share
        window=Config.get_int(PC.SLOT_WINDOW),
        req_lanes=8,
        n_replicas=max(len(ar_nodes), 1),
    )
    log_root = (
        Config.get_str(PC.PAXOS_LOGS_DIR)
        if Config.is_set(PC.PAXOS_LOGS_DIR) else None
    )
    log_dir = (
        os.path.join(log_root, node_name, f"worker{w}") if log_root else None
    )
    server = ActiveReplicaServer(
        ar_id, ar_nodes, rc_nodes, app_cls(), cfg,
        log_dir=(os.path.join(log_dir, f"ar{ar_id}") if log_dir else None),
        device=device,
    )
    server.start()
    log.info("worker %d of %s serving (rows=%d, port=%d)",
             w, node_name, cfg.n_groups, ar_nodes.get_node_address(ar_id)[1])
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
