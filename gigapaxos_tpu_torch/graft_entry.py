"""Entry points of the port: a one-device step check and a mesh dry run.

The counterpart of the JAX package's root ``__graft_entry__.py``.

``entry()`` returns the flagship step (the batched multi-group consensus
engine, all replicas stacked on one device) with example arguments.

``dryrun_multichip(n)`` builds the ``pick_mesh_shape(n)`` mesh over ``n``
logical devices and drives the mesh faces of ``parallel/spmd.py`` on tiny
shapes: one live step and a fault step (replica R-1 unheard, an election
pulse on replica 0) through the ``(g, r)`` blob exchange, 5 timed steps,
then the group-sharded ``('g',)`` mode over all ``n`` devices with a G
that does not divide (so the padded edge shard runs).  It prints one JSON
line with the reference's keys plus ``physical_devices``, the distinct
devices behind the logical ones, and returns it.

On the card (the default) the logical devices are the visible cards, in
turn, as many times as ``n`` needs; ``device="cpu"`` runs them all on the
CPU.  With no card and no ``device`` it raises.

    python -m gigapaxos_tpu_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from .obs.gplog import emit
from .ops.ballot import NULL, ballot_coord
from .ops.engine import EngineConfig, resolve_device


def entry(device=None):
    """(fn, example_args): one consensus step for all groups and all
    replicas on one device (the stacked face), at G=256, W=8, K=4, R=3."""
    from .parallel.spmd import build_replica_states, make_step

    dev = resolve_device(device)
    cfg = EngineConfig(n_groups=256, window=8, req_lanes=4, n_replicas=3)
    R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes
    states = build_replica_states(cfg, device=dev)
    req = torch.full((R, G, K), NULL, dtype=torch.int32, device=dev)
    want = torch.zeros((R, G), dtype=torch.bool, device=dev)
    # donate=False: the example args survive repeated fn(*args) calls
    return make_step(cfg, None, 1, donate=False, device=dev), (states, req, want)


def logical_devices(n: int, device=None) -> list:
    """``n`` logical devices: the visible cards in turn, or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _sync(devices) -> None:
    for d in {str(d): d for d in devices}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _drive_timed(step_fn, states, R, G, Gp, K, n_steps, devices):
    """Steps with one request per real group at its coordinator's row;
    returns (wall_s, committed, states)."""
    total = 0
    t0 = time.perf_counter()
    for s in range(n_steps):
        req = np.full((R, Gp, K), NULL, np.int32)
        coord = ballot_coord(np.asarray(states.bal)[0, :G])
        for g in range(G):
            req[int(coord[g]), g, 0] = 1000 + s * G + g
        states, out = step_fn(states, req, np.zeros((R, Gp), bool))
        total += int(np.asarray(out.n_committed)[0, :G].sum())
    _sync(devices)
    return time.perf_counter() - t0, total, states


def dryrun_multichip(n_devices: int, device=None) -> Dict:
    """The mesh faces over ``n_devices`` logical devices (module
    docstring); prints and returns the JSON record."""
    from .parallel.mesh import make_group_mesh, make_mesh, pick_mesh_shape
    from .parallel.spmd import (
        build_replica_states,
        group_sharded_step,
        replicate_inputs,
        shard_group_inputs,
        spmd_step,
    )

    devices = logical_devices(n_devices, device)
    n_shards, n_replicas = pick_mesh_shape(n_devices)
    cfg = EngineConfig(n_groups=4 * n_shards, window=4, req_lanes=2,
                       n_replicas=n_replicas)
    mesh = make_mesh(n_replicas=n_replicas, n_group_shards=n_shards, devices=devices)
    R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes
    req = np.full((R, G, K), NULL, np.int32)
    req[0, 0, 0] = 7   # one live request through the exchange
    states, req_s, want_s = replicate_inputs(
        mesh, build_replica_states(cfg, device=devices[0]), req,
        np.zeros((R, G), bool))
    step_fn = spmd_step(cfg, mesh)
    states, _ = step_fn(states, req_s, want_s)

    # fault step: replica R-1 crashed (its row unheard everywhere) while
    # replica 0 runs an election pulse for every group
    heard = np.ones((R, R), bool)
    heard[R - 1, :] = False
    heard[:, R - 1] = False
    want_elect = np.zeros((R, G), bool)
    want_elect[0, :] = True
    states, _ = step_fn(states, np.full((R, G, K), NULL, np.int32), want_elect, heard)
    _sync(devices)

    n_timed = 5
    wall_rg, committed_rg, states = _drive_timed(step_fn, states, R, G, G, K, n_timed,
                                                 devices)

    # the group-sharded mode over all n devices, G not divisible
    gmesh = make_group_mesh(n_devices, devices=devices)
    g_cfg = EngineConfig(n_groups=4 * n_devices + 3, window=4, req_lanes=2,
                         n_replicas=3)
    Gg = g_cfg.n_groups
    g_states, g_req, _w = shard_group_inputs(
        gmesh, g_cfg, build_replica_states(g_cfg, device=devices[0]),
        np.full((3, Gg, 2), NULL, np.int32), np.zeros((3, Gg), bool))
    Gp = g_req.shape[1]
    g_step = group_sharded_step(g_cfg, gmesh)
    _, _, g_states = _drive_timed(g_step, g_states, 3, Gg, Gp, 2, 1, devices)
    wall_gs, committed_gs, g_states = _drive_timed(g_step, g_states, 3, Gg, Gp, 2,
                                                   n_timed, devices)

    rec = {
        "n_devices": n_devices,
        "mesh": {"g": n_shards, "r": n_replicas},
        "n_groups": G,
        "steps": n_timed,
        "step_wall_s": round(wall_rg / n_timed, 6),
        "dec_per_s": round(committed_rg / wall_rg, 1),
        "group_sharded": {
            "mesh": {"g": n_devices},
            "n_groups": Gg,
            "padded_groups": Gp,
            "step_wall_s": round(wall_gs / n_timed, 6),
            "dec_per_s": round(committed_gs / wall_gs, 1),
        },
        "physical_devices": mesh.physical_devices,
    }
    emit(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
