"""The ``packed_host`` load: R actives, each its own state and its own
packed face, ticking in lock step as deployed actives do.

Every tick each active is handed, as host arrays, the blob frames that
all R published the tick before (one row a replica, uploaded as the
manager's tick uploads them) and its request ring; each reads back its
out ring and fresh blob with the program's ``to_host`` and decodes the
ring with ``split_out_vec``.  A call of the face runs
``steps_per_dispatch`` (N) steps, the ring holding N tiles of K lanes.

Requests arrive in an open loop, a Poisson stream at ``rate_per_s``
drawn from the seed, each to a key drawn from the configuration's Zipf
law.  The actives hold at most ``max_outstanding_requests`` undecided
requests, the configuration's back-pressure: a request that arrives
while that many are in flight waits at its client, oldest first, until
decisions make room.  Each tick stages every request due by then that
has room.  A tick's requests for one name form one proposal of at most
``max_batch_size`` requests, and a group's coordinator is offered at most
N x K proposals a tick, oldest first.  A request's latency runs from when
it was due, its wait at the client included, to the tick that reads its
decision back at the coordinator.  The end-to-end metric is
``commit_p95_ms``, the 95th percentile over every request due in the
window.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from gpbench.load import NULL, SAMPLE, VID_SPAN, rng, sample_groups, steps_per_dispatch


def _grown(arr: np.ndarray, n: int) -> np.ndarray:
    """``arr`` with room for at least ``n`` entries."""
    if len(arr) >= n:
        return arr
    out = np.zeros(max(2 * len(arr), n), dtype=arr.dtype)
    out[:len(arr)] = arr
    return out


def _ranks(keys: np.ndarray) -> np.ndarray:
    """Each entry's position among the entries of its key (``keys`` sorted)."""
    if len(keys) == 0:
        return np.zeros(0, dtype=np.int64)
    first = np.r_[True, keys[1:] != keys[:-1]]
    return np.arange(len(keys)) - np.flatnonzero(first)[np.cumsum(first) - 1]


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, system, spans):
        self.sys, self.spans, self.seed = system, spans, int(seed)
        self.dev = system.device
        self.G, self.W = int(config["n_groups"]), int(config["window"])
        self.K, self.R = int(config["req_lanes"]), int(config["n_replicas"])
        self.N = steps_per_dispatch(traffic)
        self.max_batch = int(config["max_batch_size"])
        self.max_out = int(config["max_outstanding_requests"])
        self.theta = float(config["zipf_theta"])
        self.rate = float(traffic["rate_per_s"])
        self.chunk_ticks = int(traffic["ticks_per_chunk"])
        self.warm_chunks = int(traffic["warmup_chunks"])
        self.drain_ticks = int(traffic["drain_ticks"])
        G = self.G
        # Zipf over the names, hottest first, scattered over the rows
        w = 1.0 / np.power(np.arange(1, G + 1, dtype=np.float64), self.theta)
        self.cdf = np.cumsum(w) / w.sum()
        self.perm = rng(seed, 2).permutation(G)
        self.arrivals = rng(seed, 3)
        self.sample = sample_groups(G, SAMPLE, seed, must=self.perm[:8])
        self.vid0 = 1 + int(rng(seed, 4).integers(0, VID_SPAN // 2))
        self.t = 0

    # -- requests -------------------------------------------------------
    def _due(self, now: float):
        """The requests due by ``now``: their due times and keys.  The
        schedule is drawn about a second of arrivals at a time."""
        while self.sched_t[-1] <= now:
            n = max(1024, int(self.rate))
            t = self.sched_t[-1] + np.cumsum(self.arrivals.exponential(1.0 / self.rate, n))
            u = self.arrivals.random(n)
            self.sched_t = np.concatenate([self.sched_t[self.sched_at:], t])
            self.sched_k = np.concatenate([
                self.sched_k[self.sched_at:],
                self.perm[np.searchsorted(self.cdf, u, side="right").clip(0, self.G - 1)]])
            self.sched_at = 0
        end = int(np.searchsorted(self.sched_t, now, side="right"))
        due = self.sched_t[self.sched_at:end], self.sched_k[self.sched_at:end]
        self.sched_at = end
        return due

    def _enqueue(self, dues: np.ndarray, names: np.ndarray) -> None:
        """Requests that arrived join their clients' queue."""
        if len(dues):
            self.cq_t = np.concatenate([self.cq_t, dues])
            self.cq_k = np.concatenate([self.cq_k, names])

    def _admit(self) -> None:
        """The oldest waiting requests, as many as the in-flight limit has
        room for, become proposals."""
        room = max(0, self.max_out - (self.n_req - self.n_decided))
        n = min(room, len(self.cq_t))
        if n < len(self.cq_t) and self.in_window(time.perf_counter()):
            self.capped_ticks += 1
        self._propose(self.cq_t[:n], self.cq_k[:n])
        self.cq_t, self.cq_k = self.cq_t[n:], self.cq_k[n:]

    def _propose(self, dues: np.ndarray, names: np.ndarray) -> None:
        """One proposal a name (cut every ``max_batch_size`` requests)."""
        if len(names) == 0:
            return
        order = np.argsort(names, kind="stable")
        names, dues = names[order], dues[order]
        first = np.r_[True, names[1:] != names[:-1]]
        starts = np.flatnonzero(first | (_ranks(names) % self.max_batch == 0))
        counts = np.diff(np.r_[starts, len(names)])
        n, m = len(starts), len(names)
        for name in ("p_group", "p_start", "p_count", "p_done"):
            setattr(self, name, _grown(getattr(self, name), self.n_props + n))
        self.r_due = _grown(self.r_due, self.n_req + m)
        self.r_prop = _grown(self.r_prop, self.n_req + m)
        ids = np.arange(self.n_props, self.n_props + n)
        self.r_due[self.n_req:self.n_req + m] = dues
        self.r_prop[self.n_req:self.n_req + m] = np.repeat(ids, counts)
        self.p_group[ids] = names[starts]
        self.p_start[ids] = self.n_req + starts
        self.p_count[ids] = counts
        self.n_req += m
        self.n_props += n
        self.new_props = ids

    def in_window(self, when: float) -> bool:
        return self.t_open is not None and self.t_open <= when and (
            self.t_close is None or when < self.t_close)

    def _in_window(self, due: np.ndarray) -> np.ndarray:
        if self.t_open is None:
            return np.zeros(len(due), dtype=bool)
        win = due >= self.t_open
        return win if self.t_close is None else win & (due < self.t_close)

    # -- run ------------------------------------------------------------
    def setup(self) -> None:
        G, R, K, N = self.G, self.R, self.K, self.N
        t0 = time.perf_counter()
        self.cfg = self.sys.config(G, self.W, K, R)
        self.face = self.sys.packed_face(self.cfg, N)
        self.states = [self.sys.replica_state(self.cfg, r) for r in range(R)]
        self.heat = [torch.zeros((G,), dtype=torch.int32, device=self.dev)
                     for _ in range(R)]
        self.frames = [self.sys.to_host(self.sys.blob_vec(s)) for s in self.states]
        t1 = time.perf_counter()
        self.rings = [np.full((N, G, K), NULL, dtype=np.int32) for _ in range(R)]
        self.heard = np.ones((R,), dtype=bool)
        self.no_want = np.zeros((G,), dtype=bool)
        self.coord = (np.arange(G) % R).astype(np.int64)
        self.rows_of = [np.flatnonzero(self.coord == r) for r in range(R)]
        self.p_group = np.zeros(1 << 16, dtype=np.int64)
        self.p_start = np.zeros(1 << 16, dtype=np.int64)
        self.p_count = np.zeros(1 << 16, dtype=np.int64)
        self.p_done = np.zeros(1 << 16, dtype=bool)
        self.r_due = np.zeros(1 << 16, dtype=np.float64)
        self.r_prop = np.zeros(1 << 16, dtype=np.int64)
        self.n_props = self.n_req = self.n_decided = 0
        self.cq_t, self.cq_k = np.zeros(0), np.zeros(0, dtype=np.int64)
        self.pending = np.zeros(0, dtype=np.int64)
        self.new_props = np.zeros(0, dtype=np.int64)
        empty = np.zeros(0, dtype=np.int64)
        self.filled: List = [(empty, empty)] * R
        self.t_open = self.t_close = None
        self.latencies: List[np.ndarray] = []
        self.outstanding: List[int] = []
        self.waiting: List[int] = []
        self.capped_ticks = 0
        self.wrong = 0
        self.rec_rings: List[np.ndarray] = []
        self.rec_outs: List[List[List[np.ndarray]]] = []
        self.arriving = True
        t2 = time.perf_counter()
        self.sched_t, self.sched_k, self.sched_at = np.array([t2]), np.zeros(1, np.int64), 1
        for _ in range(self.warm_chunks):
            self.chunk()
        self.setup_parts = {"states": t1 - t0, "load": t2 - t1,
                            "warmup": time.perf_counter() - t2}

    def _stage(self) -> None:
        """The rings of this tick: every pending proposal, oldest first,
        then the new ones, at most N x K a group, at its coordinator."""
        if self.arriving:
            self._enqueue(*self._due(time.perf_counter()))
        self._admit()
        props = np.concatenate([self.pending, self.new_props])
        self.new_props = np.zeros(0, dtype=np.int64)
        groups = self.p_group[props]
        order = np.argsort(groups, kind="stable")
        props, groups = props[order], groups[order]
        rank = _ranks(groups)
        self.staged, self.staged_rank = props, rank
        self.staged_lane = lane = rank < self.N * self.K
        sub, slot = rank // self.K, rank % self.K
        for r in range(self.R):
            ring = self.rings[r]
            ring[self.filled[r]] = NULL
            mine = lane & (self.coord[groups] == r)
            ring[sub[mine], groups[mine], slot[mine]] = self.vid0 + props[mine]
            self.filled[r] = (sub[mine], groups[mine])
        self.rec_rings.append(np.stack([ring[:, self.sample] for ring in self.rings]))

    def tick(self) -> None:
        span, R = self.spans, self.R
        with span("stage"):
            self._stage()
        outs_dev, blobs_dev = [], []
        for r in range(R):
            with span("face"):
                st, out_rings, blob, heat = self.face(
                    self.states[r], self.frames, self.heard, self.rings[r],
                    self.no_want, r, self.heat[r])
            self.states[r], self.heat[r] = st, heat
            outs_dev.append(out_rings)
            blobs_dev.append(blob)
        with span("readback"):
            out_np = [self.sys.to_host(o) for o in outs_dev]
            self.frames = [self.sys.to_host(b) for b in blobs_dev]
        now = time.perf_counter()
        with span("decode"):
            self._decode([[self.sys.split_out(v, self.cfg) for v in o] for o in out_np], now)
        self.t += 1

    def _decode(self, outs, now: float) -> None:
        """``outs[r][i]``: replica r's out row of step i of this tick."""
        R, N, K = self.R, self.N, self.K
        self.rec_outs.append([
            [np.stack([np.asarray(leaf)[self.sample] for leaf in leaves])
             for leaves in zip(*(outs[r][i] for r in range(R)))]
            for i in range(N)])
        # admission: a coordinator took a prefix of each step's lanes
        staged, lane = self.staged, self.staged_lane
        groups = self.p_group[staged]
        n_adm = np.stack([np.stack([o.n_admitted for o in outs[r]]) for r in range(R)])
        admitted = np.zeros(len(staged), dtype=bool)
        g, rank = groups[lane], self.staged_rank[lane]
        admitted[lane] = rank % K < n_adm[self.coord[g], rank // K, g]
        self.pending = staged[~admitted]
        # decisions at each group's coordinator
        done_props = []
        for r in range(R):
            for o in outs[r]:
                rows = self.rows_of[r]
                rows = rows[o.n_committed[rows] > 0]
                vids = o.exec_vid[rows]
                i, j = np.nonzero(vids > 0)
                dec_group = rows[i]
                props = vids[i, j].astype(np.int64) - self.vid0
                known = (props >= 0) & (props < self.n_props)
                good = known.copy()
                good[known] = self.p_group[props[known]] == dec_group[known]
                good[known] &= ~self.p_done[props[known]]
                self.wrong += int((~good).sum())
                props = props[good]
                uniq = np.unique(props)
                self.wrong += len(props) - len(uniq)
                self.p_done[uniq] = True
                done_props.append(uniq)
        props = np.concatenate(done_props)
        cnt = self.p_count[props]
        total = int(cnt.sum())
        self.n_decided += total
        self.outstanding.append(self.n_req - self.n_decided)
        self.waiting.append(len(self.cq_t))
        if total:
            offs = np.repeat(self.p_start[props] - np.cumsum(np.r_[0, cnt[:-1]]), cnt) \
                + np.arange(total)
            due = self.r_due[offs]
            self.latencies.append(now - due[self._in_window(due)])

    def chunk(self) -> None:
        for _ in range(self.chunk_ticks):
            self.tick()

    def open_window(self, t: float) -> None:
        self.t_open = t
        self.tick_open = len(self.outstanding)

    def close_window(self, t: float) -> None:
        self.t_close = t
        self.tick_close = len(self.outstanding)

    def diagnostics(self) -> Dict:
        """Requests in flight over the window's ticks: the most, and the
        means of its first and last quarters (a backlog that grows shows
        as the second above the first); requests waiting at their clients
        at the most; and the ticks at which the in-flight limit held
        requests back."""
        o = np.asarray(self.outstanding[self.tick_open:self.tick_close], dtype=np.float64)
        w = self.waiting[self.tick_open:self.tick_close]
        q = max(1, len(o) // 4)
        return {"outstanding_max": float(o.max()), "outstanding_first_q": float(o[:q].mean()),
                "outstanding_last_q": float(o[-q:].mean()), "waiting_max": int(max(w)),
                "capped_ticks": self.capped_ticks, "ticks": len(o)} if len(o) else {}

    def window_metrics(self, window_s: float):
        """The 95th percentile latency of every request due in the window
        (after :meth:`finish` has drained them), and how many were due."""
        lat = np.concatenate(self.latencies) if self.latencies else np.zeros(0)
        out = {}
        if len(lat):
            lat = np.sort(lat)
            out["commit_p95_ms"] = float(lat[math.ceil(0.95 * len(lat)) - 1] * 1e3)
        return out, int(self._in_window(self.r_due[:self.n_req]).sum()
                        + self._in_window(self.cq_t).sum())

    def finish(self) -> None:
        """Stop the arrivals, tick until every request due in the window is
        decided (at most ``drain_ticks``), read back what the program made
        of the sample, then free the program's state."""
        self._enqueue(*self._due(self.t_close))
        self.arriving = False
        for _ in range(self.drain_ticks):
            if self._lost_in_window() == 0:
                break
            self.tick()
        self.lost = self._lost_in_window()
        idx = torch.as_tensor(self.sample, device=self.dev)
        self.got_state = [torch.stack([x.index_select(0, idx).cpu() for x in leaf])
                          for leaf in zip(*self.states)]
        self.got_heat = torch.stack([h.index_select(0, idx).cpu() for h in self.heat])
        del self.states, self.heat, self.face

    def _lost_in_window(self) -> int:
        n = self.n_req
        return int((self._in_window(self.r_due[:n]) & ~self.p_done[self.r_prop[:n]]).sum()
                   + self._in_window(self.cq_t).sum())

    def check(self, reference) -> Dict:
        """Replay every tick on the sample with the reference and compare
        every state word and heat count of every replica, and every out
        row the program's ring decoded to, step by step; count decisions
        of values never proposed to their group or decided twice, and
        requests due in the window never decided."""
        S, R, N = len(self.sample), self.R, self.N
        dev = self.dev
        ref = reference(self.sample, R, self.W, self.K, device=dev)
        no_want = torch.zeros((R, S), dtype=torch.bool, device=dev)
        out_diff = 0
        bad = np.zeros(S, dtype=bool)
        for t in range(self.t):
            # the frames of a tick are the blobs published after the last;
            # a tick's later steps refresh only each replica's own row
            frames = ref.blob() if N > 1 else None
            ring = torch.as_tensor(self.rec_rings[t], device=dev)
            for i in range(N):
                out = ref.step(ring[:, i], no_want, frozen=frames if i else None)
                for a, b in zip(out, self.rec_outs[t][i]):
                    d = ref.per_replica(a).cpu().numpy() != b
                    out_diff += int(d.sum())
                    bad |= d.reshape(R, S, -1).any(-1).any(0)
        state_diff = 0
        for a, b in zip(list(ref.state) + [ref.heat], self.got_state + [self.got_heat]):
            d = ref.per_replica(a).cpu() != b
            state_diff += int(d.sum())
            bad |= d.reshape(R, S, -1).any(-1).any(0).numpy()
        return {
            "checks": {
                "state_words_differ": (state_diff, 0),
                "out_words_differ": (out_diff, 0),
                "wrong_decisions": (self.wrong, 0),
                "lost_requests": (self.lost, 0),
            },
            "failed": int(bad.sum()) + self.wrong + self.lost,
            "steps": self.t * N,
        }

    def trace_context(self, chunks: int) -> Dict:
        ticks = chunks * self.chunk_ticks
        return {"face": "packed_host", "G": self.G, "W": self.W, "K": self.K,
                "R": self.R, "N": self.N, "heat": True, "steps": ticks * self.N,
                "calls": ticks * self.R}
