"""Sharded serving workers — one node's groups split across processes.

With ``SERVING_WORKERS > 1`` a node stops being one GIL-bound process:
its name space is partitioned into that many **worker shards** (the
checkpoint-shard scheme applied to serving), each owned by a worker
PROCESS with its own engine arrays, journal, and tick loop.  Worker
``w`` of every replica listens at ``node_port + SERVING_WORKER_PORT_
OFFSET + w`` and exchanges compact blobs DIRECTLY with worker ``w`` on
the peer replicas — each shard is a full, independent consensus cluster
over its slice of the names.  The parent process does accept/route
only (:mod:`.router`): client frames split by name shard, responses
demultiplex back per client connection, admin ``stats`` aggregates.
The per-node GIL thereby becomes a per-shard one.

Shard assignment must agree across every replica, every process, and
every restart without coordination, so it hashes the NAME (the same
stable crc the row probe uses) — a name's whole lifecycle (create,
traffic, migration, pause, delete) stays inside one shard cluster.

``SERVING_WORKERS = 1`` (default) never imports any of this on the hot
path: the node boots exactly the single-process stack it always has.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

from ..paxos_config import PC
from ..utils.config import Config


def shard_of_name(name: str, n_workers: int) -> int:
    """Deterministic worker shard for ``name`` — identical on every
    replica/process/restart (no probing, no occupancy: the router has no
    manager tables)."""
    if n_workers <= 1:
        return 0
    return zlib.crc32(name.encode("utf-8")) % int(n_workers)


def worker_address(addr: Tuple[str, int], w: int) -> Tuple[str, int]:
    """Worker ``w``'s mesh address derived from a node's base address."""
    off = Config.get_int(PC.SERVING_WORKER_PORT_OFFSET)
    return (addr[0], int(addr[1]) + off + int(w))


def worker_rows(rows: int, n_workers: int) -> int:
    """The engine rows of one worker shard of a node with ``rows``."""
    return max(64, int(rows) // int(n_workers))


def apply_worker_view(w: int, n_workers: int) -> None:
    """Rewrite the ACTIVE config for worker ``w``'s view of the world:

    * every ``active.NAME`` address shifts to that node's worker-``w``
      port (the shard's private 3-replica mesh — worker ``w`` only ever
      talks to worker ``w`` on peers);
    * ``reconfigurator.*`` stays at base addresses (RCs are unsharded;
      their AR-bound control lands on the parent router, which routes it
      by name);
    * ``ENGINE_ROWS`` shrinks to this worker's share;
    * ``SERVING_WORKERS`` resets to 1 (a worker must never recurse).

    Call ONLY inside a worker process, before building any NodeConfig.
    """
    n_workers = int(n_workers)
    for name, (host, port) in Config.node_addresses("active").items():
        _h, wport = worker_address((host, port), w)
        Config.set(f"active.{name}", f"{host}:{wport}")
    rows = Config.get_int(PC.ENGINE_ROWS)
    Config.set("ENGINE_ROWS", str(worker_rows(rows, n_workers)))
    Config.set("SERVING_WORKERS", "1")


def partition_by_shard(
    names: List[str], n_workers: int
) -> Dict[int, List[str]]:
    """Names grouped by owning shard (test/tooling helper)."""
    out: Dict[int, List[str]] = {}
    for nm in names:
        out.setdefault(shard_of_name(nm, n_workers), []).append(nm)
    return out
