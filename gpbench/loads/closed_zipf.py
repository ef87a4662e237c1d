"""The ``closed_zipf`` load: a closed loop of clients over Zipf names, kept
on the card, through the stacked face.

Exactly ``max_outstanding_requests`` requests are outstanding at every
step, one a client.  A request waits at its name until a proposal of the
name carrying it is admitted, and is in flight until replica 0 executes
the slot that decided it; then its client sends the next request, to a
name drawn afresh.  Names are ranked by the configuration's Zipf law
(``zipf_theta``; rank 1 the hottest) and scattered over the rows by a
permutation drawn from the seed.

Each step, every name with waiting requests offers its coordinator
(replica ``g % R``, no elections) one proposal in request lane 0,
carrying ``min(waiting, max_batch_size)`` of them, as the host's request
batcher would.  Its vid is ``(tag << 16) | size``: the size in the low
16 bits, the tag drawn from the seed a name and moved on every step.  A
proposal that the coordinator does not admit stays waiting and is
offered again at the next step.  The requests that decided in a step are
the sizes in replica 0's ``exec_vid``, counted by one sum of its words
(``decided_total``); that many clients redraw a name, from a fixed draw
of ``max_outstanding_requests`` names masked on the card.

Everything runs on the card, with one device sync at the end of a chunk
(``steps_per_chunk`` steps).  The request tensor holds NULL but in lane
0 of each group's coordinator row, which every step rewrites (NULL where
the name waits for nothing); the previous call's out is dropped before
the next call.  The end-to-end metric is ``decisions_per_s``: the slots
replica 0 committed, over every group, over the window.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from gpbench.load import NULL, SAMPLE, rng, sample_groups, steps_per_dispatch, sync

SIZE_BITS = 16                    # a proposal's size, in the vid's low half
SIZE_MASK = (1 << SIZE_BITS) - 1
TAG_MASK = (1 << 14) - 1          # (tag << 16) | size stays below STOP_BIT (1 << 30)
TAG_STEP = 40503
HOT = 8                           # the hottest names, always in the sample

# the load's counters, summed on the card over the run
COUNTERS = ("slots", "requests", "offered", "admitted", "batched", "busy")


def zipf_cdf(G: int, theta: float, device) -> torch.Tensor:
    """``[G]`` float64: the Zipf law's CDF over ranks 1..G, the last 1.0."""
    w = torch.arange(1, G + 1, dtype=torch.float64, device=device).pow_(-theta)
    c = torch.cumsum(w, 0)
    return c / c[-1]


def zipf_ranks(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """0-based ranks for uniform draws ``u`` in [0, 1) (inverse CDF)."""
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.shape[0] - 1)


def decided_requests(exec_vid: torch.Tensor, n_committed: torch.Tensor) -> torch.Tensor:
    """``[S]`` int32: requests each row executed, from its ``[S, W]``
    ``exec_vid`` and ``[S]`` ``n_committed``.  A row's first
    ``n_committed`` lanes hold the decided values, whose low halves are
    their sizes (a no-op's 0); the other lanes hold NULL, whose low half
    reads -1."""
    W = exec_vid.shape[-1]
    low = exec_vid.view(torch.int16)[..., 0::2]
    return low.sum(-1, dtype=torch.int32) + (W - n_committed)


def decided_total(exec_vid: torch.Tensor, n_slots: torch.Tensor) -> torch.Tensor:
    """A device scalar: the requests all rows of ``exec_vid`` executed,
    ``n_slots`` the sum of their ``n_committed``, in one pass over the
    words.  The int32 sum wraps, but modulo 2**16 it is the sum of the
    sizes less one for each NULL lane, and the total it stands for is
    below 2**16 (at most the requests outstanding)."""
    null = exec_vid.numel() - n_slots
    return (exec_vid.sum(dtype=torch.int32) + null) & SIZE_MASK


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, system, spans):
        self.sys, self.spans, self.seed = system, spans, int(seed)
        self.dev = system.device
        self.G, self.W = int(config["n_groups"]), int(config["window"])
        self.K, self.R = int(config["req_lanes"]), int(config["n_replicas"])
        if steps_per_dispatch(traffic) != 1:
            raise ValueError("the closed_zipf load runs one step a call")
        if config.get("key_distribution", "zipfian") != "zipfian":
            raise ValueError("the closed_zipf load draws names from a Zipf law")
        self.theta = float(config["zipf_theta"])
        self.max_out = int(config["max_outstanding_requests"])
        self.max_batch = int(config["max_batch_size"])
        if not 1 <= self.max_batch < 1 << (SIZE_BITS - 1):
            raise ValueError("max_batch_size must fit a vid's low half")
        if not 1 <= self.max_out < 1 << SIZE_BITS:
            raise ValueError("max_outstanding_requests must be below 2**16")
        self.chunk_steps = int(traffic["steps_per_chunk"])
        self.warm_chunks = int(traffic["warmup_chunks"])
        self.perm = rng(seed, 2).permutation(self.G)     # rank -> row
        self.sample = sample_groups(self.G, SAMPLE, seed,
                                    must=tuple(self.perm[:HOT]) + (0, self.G - 1))
        self.t = 0

    # -- run ------------------------------------------------------------
    def setup(self) -> None:
        dev, G, R, K = self.dev, self.G, self.R, self.K
        t0 = time.perf_counter()
        self.cfg = self.sys.config(G, self.W, K, R)
        self.face = self.sys.stacked_face(self.cfg, 1)
        self.states = self.sys.stacked_states(self.cfg)
        sync(dev)
        t1 = time.perf_counter()
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed % (1 << 63))
        self.cdf = zipf_cdf(G, self.theta, dev)
        self.row_of = torch.as_tensor(self.perm, device=dev)
        self.tag = torch.randint(0, TAG_MASK + 1, (G,), generator=self.gen,
                                 dtype=torch.int32, device=dev)
        self.req = torch.full((R, G, K), NULL, dtype=torch.int32, device=dev)
        self.lane0 = self.req[:, :, 0]
        self.coord = (torch.arange(G, device=dev) % R)[None, :]
        self.no_want = torch.zeros((R, G), dtype=torch.bool, device=dev)
        self.waiting = torch.zeros((G,), dtype=torch.int32, device=dev)
        self.draw_at = torch.arange(self.max_out, device=dev)
        self.sidx = torch.as_tensor(self.sample, device=dev)
        S = len(self.sample)
        i64 = dict(dtype=torch.int64, device=dev)
        self.ctr = torch.zeros((len(COUNTERS),), **i64)
        self.batch_max = torch.zeros((), **i64)
        self.out_min = torch.full((), self.max_out, **i64)
        self.out_max = torch.full((), self.max_out, **i64)
        self.inflight = torch.zeros((), **i64)    # admitted, not yet executed
        self.busy_rec = torch.zeros((), **i64)
        self.s_committed = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.s_requests = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.s_total = torch.zeros((), **i64)   # the sample's, as the load counts
        self.rec = []                    # [steps_per_chunk, S] offered vids a chunk
        self._draw(torch.full((), self.max_out, **i64))
        sync(dev)
        t2 = time.perf_counter()
        for _ in range(self.warm_chunks):
            self.chunk()
        self.setup_parts = {"states": t1 - t0, "load": t2 - t1,
                            "warmup": time.perf_counter() - t2}

    def _draw(self, n: torch.Tensor) -> None:
        """``n`` (a device scalar) clients send a request each, to a name
        drawn from the Zipf law: the first ``n`` of a fixed draw."""
        u = torch.rand((self.max_out,), generator=self.gen, dtype=torch.float64,
                       device=self.dev)
        rows = self.row_of[zipf_ranks(self.cdf, u)]
        self.waiting.index_add_(0, rows, (self.draw_at < n).to(torch.int32))

    def _offer(self, rec: torch.Tensor):
        """Write this step's proposals into the coordinators' lane 0 and
        record the sample's in ``rec``."""
        size = self.waiting.clamp(max=self.max_batch)
        offered = self.waiting > 0
        tag = (self.tag + (self.t * TAG_STEP & TAG_MASK)) & TAG_MASK
        vid = torch.where(offered, (tag << SIZE_BITS) | size, NULL)
        self.lane0.scatter_(0, self.coord, vid[None, :])
        torch.index_select(vid, 0, self.sidx, out=rec)
        return size, offered

    def _admitted(self, out) -> torch.Tensor:
        """``[G]`` bool: the group's coordinator admitted its proposal."""
        return out.n_admitted.gather(0, self.coord)[0] > 0

    def _decided(self, exec_vid, n_slots: torch.Tensor) -> torch.Tensor:
        """A device scalar: the requests that the rows of ``exec_vid``
        executed, ``n_slots`` their slots."""
        return decided_total(exec_vid, n_slots)

    def _close(self, out, size, offered) -> None:
        """Account for one step's out: admissions, decisions, the clients
        that redraw, the counters."""
        i32 = torch.int32
        taken = torch.where(self._admitted(out) & offered, size, 0)
        self.waiting -= taken
        committed = out.n_committed[0]
        n_slots = committed.sum(dtype=i32)
        n_done = self._decided(out.exec_vid[0], n_slots)
        self._draw(n_done)
        n_taken = taken.sum(dtype=i32)
        self.inflight += n_taken - n_done
        busy = offered | (out.n_committed.amax(0) > 0)
        self.ctr += torch.stack([n_slots, n_done, offered.sum(dtype=i32),
                                 (taken > 0).sum(dtype=i32), n_taken, busy.sum(dtype=i32)])
        torch.maximum(self.batch_max, taken.max(), out=self.batch_max)
        outstanding = self.waiting.sum(dtype=i32) + self.inflight
        torch.minimum(self.out_min, outstanding, out=self.out_min)
        torch.maximum(self.out_max, outstanding, out=self.out_max)
        # the sample: its requests row by row, and as the load counts them
        s_committed = committed.index_select(0, self.sidx)
        s_exec = out.exec_vid[0].index_select(0, self.sidx)
        self.s_committed += s_committed
        self.s_requests += decided_requests(s_exec, s_committed)
        self.s_total += self._decided(s_exec, s_committed.sum(dtype=i32))

    def _step(self, rec: torch.Tensor, last: bool) -> None:
        span = self.spans
        with span("offer"):
            size, offered = self._offer(rec)
        with span("face"):
            self.states, out = self.face(self.states, self.req, self.no_want)
        with span("close"):
            self._close(out, size, offered)
            if last:   # the sample's rows of the last out, for the check
                self.last_rows = [x.index_select(1, self.sidx) for x in out]
        self.t += 1

    def chunk(self) -> None:
        busy0 = self.ctr[COUNTERS.index("busy")].clone() if self.spans.recording else None
        rec = torch.empty((self.chunk_steps, len(self.sample)), dtype=torch.int32,
                          device=self.dev)
        self.rec.append(rec)
        for i in range(self.chunk_steps):
            self._step(rec[i], i == self.chunk_steps - 1)
        if busy0 is not None:
            self.busy_rec += self.ctr[COUNTERS.index("busy")] - busy0
        with self.spans("sync"):
            sync(self.dev)

    def _counters(self) -> Dict:
        c = dict(zip(COUNTERS, self.ctr.tolist()))
        c.update(steps=self.t, batch_max=int(self.batch_max), out_min=int(self.out_min),
                 out_max=int(self.out_max))
        return c

    def open_window(self, t: float) -> None:
        self.at_open = self._counters()

    def close_window(self, t: float) -> None:
        self.at_close = self._counters()

    def diagnostics(self) -> Dict:
        """The window's counters: requests and slots decided, proposals a
        step, mean and largest batch, outstanding at the least and the
        most (over the run), busy group-steps."""
        a, b = self.at_open, self.at_close
        d = {k: b[k] - a[k] for k in COUNTERS + ("steps",)}
        steps = max(1, d["steps"])
        return {"requests_decided": d["requests"], "slots_decided": d["slots"],
                "proposals_per_step": d["offered"] / steps,
                "batch_mean": d["batched"] / max(1, d["admitted"]),
                "batch_max": b["batch_max"], "outstanding_min": b["out_min"],
                "outstanding_max": b["out_max"], "busy_group_steps": d["busy"],
                "window_steps": d["steps"]}

    def window_metrics(self, window_s: float):
        n = self.at_close["slots"] - self.at_open["slots"]
        return {"decisions_per_s": n / window_s}, n

    def finish(self) -> None:
        """Read back what the program made of the sample, then free the
        program's state."""
        self.got_state = [x.index_select(1, self.sidx).cpu() for x in self.states]
        self.got_out = [x.cpu() for x in self.last_rows]
        self.got_committed = self.s_committed.cpu()
        self.got_requests = self.s_requests.cpu()
        self.got_total = int(self.s_total)
        self.outstanding = (int(self.out_min), int(self.out_max))
        self.offers = torch.cat(self.rec)[:self.t]
        del self.states, self.last_rows, self.req, self.lane0, self.no_want
        del self.waiting, self.cdf, self.row_of, self.tag, self.rec

    def check(self, reference) -> Dict:
        """Replay every step's offers on the sample with the reference and
        compare every state word of every replica, the last step's out
        rows, replica 0's committed slots and decided requests per group
        (and their total as the load counted it); and the requests
        outstanding at every step."""
        dev = self.offers.device
        S, R, K = len(self.sample), self.R, self.K
        ref = reference(self.sample, R, self.W, K, device=dev)
        coord = torch.as_tensor(self.sample % R, device=dev)
        mine = torch.arange(R, device=dev)[:, None] == coord[None, :]
        req = torch.full((R, S, K), NULL, dtype=torch.int32, device=dev)
        no_want = torch.zeros((R, S), dtype=torch.bool, device=dev)
        committed = torch.zeros((S,), dtype=torch.int32, device=dev)
        requests = torch.zeros((S,), dtype=torch.int32, device=dev)
        out = None
        for t in range(self.t):
            req[:, :, 0] = torch.where(mine, self.offers[t][None, :], NULL)
            out = ref.step(req, no_want)
            committed += out.n_committed[:S]
            requests += decided_requests(out.exec_vid[:S], out.n_committed[:S])
        bad = np.zeros(S, dtype=bool)
        state_diff = 0
        for a, b in zip(ref.state, self.got_state):
            d = ref.per_replica(a).cpu() != b
            state_diff += int(d.sum())
            bad |= d.reshape(R, S, -1).any(-1).any(0).numpy()
        out_diff = 0
        for a, b in zip(out, self.got_out):
            d = ref.per_replica(a).cpu() != b
            out_diff += int(d.sum())
            bad |= d.reshape(R, S, -1).any(-1).any(0).numpy()
        c_diff = (committed.cpu() != self.got_committed).numpy()
        r_diff = (requests.cpu() - self.got_requests).abs()
        bad |= c_diff | (r_diff > 0).numpy()
        total_off = abs(int(requests.sum()) - self.got_total)
        lo, hi = self.outstanding
        return {
            "checks": {
                "state_words_differ": (state_diff, 0),
                "out_words_differ": (out_diff, 0),
                "committed_groups_differ": (int(c_diff.sum()), 0),
                "requests_differ": (int(r_diff.sum()) + total_off, 0),
                "outstanding_off": (max(hi - self.max_out, self.max_out - lo), 0),
            },
            "failed": int(bad.sum()),
            "steps": self.t,
        }

    def trace_context(self, chunks: int) -> Dict:
        steps = chunks * self.chunk_steps
        return {"face": "stacked", "G": self.G, "W": self.W, "K": self.K,
                "R": self.R, "N": 1, "heat": False, "steps": steps, "calls": steps,
                "busy_group_steps": int(self.busy_rec)}
