"""The check's control: the reference put in the program's place with the
configuration's guarantee broken, run through a whole cell at its own
size.  It has to come out as not correct.

The configurations state that a slot is decided only when a majority of
its group's replicas (2 of 3) accepted it; in the control a coordinator
takes itself for a quorum and decides each request as it admits it
(``quorum_of_one`` in :mod:`gpbench.reference.paxos`).
:class:`ReferenceSystem` has the methods of :class:`gpbench.system.Port`,
so the cell's load runs it unchanged: same set-up, same traffic, same
window, same readback and the same check.

    python3 -m gpbench.control --workload <name> --seeds <n> [<n> ...] [--seconds S]
        [--sound]

prints one JSON line a seed with the numbers the check compared.  With
``--sound`` the reference runs unbroken in the program's place (the check
must then pass).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .reference import paxos as ref

BLOCK = 1 << 18   # groups the reference steps at once


class Cfg(NamedTuple):
    n_groups: int
    window: int
    req_lanes: int
    n_replicas: int


def pack(leaves) -> torch.Tensor:
    """Leaves in field order, each row-major: the program's packed layout."""
    return torch.cat([x.reshape(-1) for x in leaves])


def unpack(vec, fields, G: int, W: int, window_fields, lead=()):
    out, off = [], 0
    for name in fields:
        n = G * W if name in window_fields else G
        shape = tuple(lead) + ((G, W) if name in window_fields else (G,))
        out.append(vec[..., off:off + n].reshape(shape))
        off += n
    return out


class ReferenceSystem:
    """The reference in the program's place, broken (``quorum_of_one``)
    unless ``sound``."""

    def __init__(self, device, sound: bool = False):
        self.device = torch.device(device)
        self.broken = not sound

    def config(self, G, W, K, R) -> Cfg:
        return Cfg(G, W, K, R)

    # -- the stacked face -------------------------------------------------
    def stacked_states(self, cfg: Cfg) -> ref.State:
        G, R = cfg.n_groups, cfg.n_replicas
        groups = torch.arange(G, dtype=torch.int64, device=self.device).repeat(R)
        my_id = torch.arange(R, dtype=ref.I32, device=self.device).repeat_interleave(G)
        rows = ref.created(groups, my_id, R, cfg.window)
        return ref.State(*(x.reshape((R, G) + tuple(x.shape[1:])) for x in rows))

    def stacked_face(self, cfg: Cfg, N: int):
        R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes

        def face(states, req, want):
            reqs = req if N > 1 else req[None]
            parts_s, outs = [], []
            for g0 in range(0, G, BLOCK):
                g1 = min(G, g0 + BLOCK)
                rep = ref.Replicas(
                    torch.arange(g0, g1, device=self.device), R, cfg.window, K,
                    self.broken, self.device, graph=False,
                    state=ref.State(*(x[:, g0:g1].reshape((R * (g1 - g0),) + tuple(x.shape[2:]))
                                      for x in states)))
                steps = []
                for i in range(N):
                    o = rep.step(reqs[i][:, g0:g1],
                                 want[:, g0:g1] if i == 0 else torch.zeros_like(want[:, g0:g1]))
                    steps.append([rep.per_replica(x) for x in o])
                parts_s.append([rep.per_replica(x) for x in rep.state])
                outs.append(steps)
            st = ref.State(*(torch.cat(xs, dim=1) for xs in zip(*parts_s)))
            per_step = [ref.Out(*(torch.cat(xs, dim=1) for xs in zip(*(p[i] for p in outs))))
                        for i in range(N)]
            out = per_step[0] if N == 1 else ref.Out(*(torch.stack(xs) for xs in zip(*per_step)))
            return st, out

        return face

    # -- the packed face --------------------------------------------------
    def replica_state(self, cfg: Cfg, my_id: int) -> ref.State:
        G = cfg.n_groups
        groups = torch.arange(G, dtype=torch.int64, device=self.device)
        mine = torch.full((G,), my_id, dtype=ref.I32, device=self.device)
        return ref.created(groups, mine, cfg.n_replicas, cfg.window)

    def blob_vec(self, state: ref.State) -> torch.Tensor:
        return pack(ref.make_blob(state))

    def packed_face(self, cfg: Cfg, N: int):
        R, G, W, K = cfg.n_replicas, cfg.n_groups, cfg.window, cfg.req_lanes
        dev = self.device

        def face(state, frames, heard, ring, want, my_id, heat):
            g0 = ref.Blob(*unpack(torch.as_tensor(np.asarray(frames), device=dev),
                                  ref.BLOB_FIELDS, G, W, ref.BLOB_WINDOW_FIELDS, lead=(R,)))
            hr = torch.as_tensor(np.asarray(heard), device=dev).bool()
            hr = hr | (torch.arange(R, device=dev) == my_id)
            hr = hr[:, None].expand(R, G)
            ids = torch.full((G,), my_id, dtype=ref.I32, device=dev)
            ring = torch.as_tensor(np.asarray(ring), device=dev)
            want = torch.as_tensor(np.asarray(want), device=dev)
            st, rows = state, []
            for i in range(N):
                g = g0
                if i:   # later steps refresh my own row only
                    g = ref.Blob(*(torch.cat([x[:my_id], y[None], x[my_id + 1:]])
                                   for x, y in zip(g0, ref.make_blob(st))))
                st, out = ref.step(st, g, hr, ring[i], want if i == 0 else torch.zeros_like(want),
                                   ids, K, self.broken)
                heat = heat + out.n_committed + out.n_admitted
                rows.append(pack(out))
            return st, torch.stack(rows), self.blob_vec(st), heat

        return face

    def to_host(self, t) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def split_out(self, vec, cfg: Cfg):
        return ref.Out(*unpack(np.asarray(vec), ref.OUT_FIELDS, cfg.n_groups,
                               cfg.window, ref.OUT_WINDOW_FIELDS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    from . import harness

    if not torch.cuda.is_available():
        print("gpbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = harness.run(args.workload, seed, args.seconds, False, "cuda:0",
                          time.perf_counter(),
                          system=ReferenceSystem("cuda:0", args.sound))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "sound": args.sound, "correct": res["correct"],
                          "checks": res["checks"], "run": res["run"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
