"""The ``stacked`` load: every replica of every group on the card through
the stacked face.

Each group's coordinator is offered K fresh request values a step
(``base + offset(step)``, the base drawn on the card from the seed), and
``elections`` (optional) re-elects every group every ``every`` steps with
leadership rotating round the replicas.  A call of the face runs
``steps_per_dispatch`` (N) steps, its election pulses at the first; a
chunk is ``steps_per_chunk`` steps (a whole number of calls) and ends in
one device sync.  The end-to-end metric is ``decisions_per_s``: the slots
replica 0 committed over every group, over the window.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from gpbench.load import SAMPLE, VID_SPAN, sample_groups, steps_per_dispatch, sync


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, system, spans):
        self.sys, self.spans, self.seed = system, spans, int(seed)
        self.dev = system.device
        self.G, self.W = int(config["n_groups"]), int(config["window"])
        self.K, self.R = int(config["req_lanes"]), int(config["n_replicas"])
        self.N = steps_per_dispatch(traffic)
        self.chunk_steps = int(traffic["steps_per_chunk"])
        if self.chunk_steps % self.N:
            raise ValueError("steps_per_chunk must be a multiple of steps_per_dispatch")
        self.warm_chunks = int(traffic["warmup_chunks"])
        el = traffic.get("elections")
        self.every = int(el["every"]) if el else 0
        self.t = 0
        self.sample = sample_groups(self.G, SAMPLE, seed, must=(0, self.G - 1))

    # -- inputs ---------------------------------------------------------
    @staticmethod
    def offset(t: int) -> int:
        return (t * 40503) % VID_SPAN

    def want(self, t: int, groups: torch.Tensor, rids: torch.Tensor):
        """[R, len(groups)] election pulses of the call that starts at
        step ``t``: every group re-elects every ``every`` steps, its
        1/every slice staggered by step, the new leader one further round
        the replicas each round."""
        if not self.every:
            return None
        sl = (groups % self.every) == (t % self.every)
        target = (groups % self.R + 1 + t // self.every) % self.R
        return (target[None, :] == rids[:, None]) & sl[None, :]

    # -- run ------------------------------------------------------------
    def setup(self) -> None:
        dev, G, R, K = self.dev, self.G, self.R, self.K
        t0 = time.perf_counter()
        self.cfg = self.sys.config(G, self.W, K, R)
        self.face = self.sys.stacked_face(self.cfg, self.N)
        self.states = self.sys.stacked_states(self.cfg)
        sync(dev)
        t1 = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed % (1 << 63))
        self.base = torch.randint(1, VID_SPAN, (R, G, K), generator=gen,
                                  dtype=torch.int32, device=dev)
        lead = (self.N,) if self.N > 1 else ()
        self.req = torch.empty(lead + (R, G, K), dtype=torch.int32, device=dev)
        self.groups = torch.arange(G, dtype=torch.int64, device=dev)
        self.rids = torch.arange(R, dtype=torch.int64, device=dev)
        self.no_want = torch.zeros((R, G), dtype=torch.bool, device=dev)
        self.committed = torch.zeros((G,), dtype=torch.int32, device=dev)
        sync(dev)
        t2 = time.perf_counter()
        for _ in range(self.warm_chunks):
            self.chunk()
        self.setup_parts = {"states": t1 - t0, "load": t2 - t1,
                            "warmup": time.perf_counter() - t2}

    def chunk(self) -> None:
        span, N = self.spans, self.N
        for _ in range(self.chunk_steps // N):
            with span("load"):
                if N == 1:
                    torch.add(self.base, self.offset(self.t), out=self.req)
                else:
                    for i in range(N):
                        torch.add(self.base, self.offset(self.t + i), out=self.req[i])
                want = self.want(self.t, self.groups, self.rids)
            with span("face"):
                self.states, out = self.face(
                    self.states, self.req, self.no_want if want is None else want)
            with span("count"):
                if N == 1:
                    self.committed += out.n_committed[0]
                else:
                    self.committed += out.n_committed[:, 0].sum(0, dtype=torch.int32)
            self.last_out = out if N == 1 else type(out)(*(x[-1] for x in out))
            self.t += N
        with span("sync"):
            sync(self.dev)

    def count(self) -> int:
        """Slots replica 0 has committed so far, over every group."""
        return int(self.committed.sum(dtype=torch.int64))

    def open_window(self, t: float) -> None:
        self.at_open = self.count()

    def close_window(self, t: float) -> None:
        self.at_close = self.count()

    def diagnostics(self) -> Dict:
        return {}

    def window_metrics(self, window_s: float):
        n = self.at_close - self.at_open
        return {"decisions_per_s": n / window_s}, n

    def finish(self) -> None:
        """Read back what the program made of the sample, then free the
        program's state."""
        idx = torch.as_tensor(self.sample, device=self.dev)
        self.got_state = [x.index_select(1, idx).cpu() for x in self.states]
        self.got_out = [x.index_select(1, idx).cpu() for x in self.last_out]
        self.got_committed = self.committed.index_select(0, idx).cpu()
        self.sample_base = self.base.index_select(1, idx)
        del self.states, self.last_out, self.req, self.base, self.committed
        del self.no_want

    def check(self, reference) -> Dict:
        """Replay every step on the sample with the reference and compare
        every state word of every replica, the last step's out rows and
        replica 0's committed count per group."""
        dev = self.sample_base.device
        S, R = len(self.sample), self.R
        ref = reference(self.sample, R, self.W, self.K, device=dev)
        groups = torch.as_tensor(self.sample, device=dev)
        rids = torch.arange(R, dtype=torch.int64, device=dev)
        no_want = torch.zeros((R, S), dtype=torch.bool, device=dev)
        committed = torch.zeros((S,), dtype=torch.int32, device=dev)
        out = None
        for t in range(self.t):
            want = self.want(t, groups, rids) if t % self.N == 0 else None
            out = ref.step(self.sample_base + self.offset(t),
                           no_want if want is None else want)
            committed += out.n_committed[:S]
        state_diff = sum(
            int((ref.per_replica(a).cpu() != b).sum())
            for a, b in zip(ref.state, self.got_state))
        out_diff = sum(int((ref.per_replica(a).cpu() != b).sum())
                       for a, b in zip(out, self.got_out))
        groups_diff = int((committed.cpu() != self.got_committed).sum())
        bad_groups = set()
        for a, b in zip(ref.state, self.got_state):
            d = (ref.per_replica(a).cpu() != b).reshape(R, S, -1).any(-1).any(0)
            bad_groups.update(np.flatnonzero(d.numpy()).tolist())
        return {
            "checks": {
                "state_words_differ": (state_diff, 0),
                "out_words_differ": (out_diff, 0),
                "committed_groups_differ": (groups_diff, 0),
            },
            "failed": len(bad_groups),
            "steps": self.t,
        }

    def trace_context(self, chunks: int) -> Dict:
        steps = chunks * self.chunk_steps
        return {"face": "stacked", "G": self.G, "W": self.W, "K": self.K,
                "R": self.R, "N": self.N, "heat": False, "steps": steps,
                "calls": steps // self.N}
