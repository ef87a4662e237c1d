#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gigapaxos_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. build   — compile ``gigapaxos_tpu_torch/csrc/gp_step.cu`` and
             ``csrc/gp_lifecycle.cu`` for sm_90a, one nvcc each, in
             parallel; print the build time, ptxas' resource report and
             the card's name and power limit.
2. parity  — each kernel against its plain PyTorch version on the card,
             bit for bit, on seeded states (simulator steps plus lane fuzz
             with wrap +-15 and ballot-delta saturation) for W in {8, 16,
             32}, R in {3, 5}, K <= W, both make_step faces with N in
             {1, 4} (heat on the packed face, donation on and off).
   lifecycle — every lifecycle kernel (create, kill, jump, restore_paused,
             restore_rows, extract_rows) against its plain version, bit
             for bit, on seeded random states (NULL and negative words,
             full 32-bit masks) at the server shape (G=65,536, W=16; N in
             {1, 7, 4,096, 16,384}) and the headline shape (G=1,048,576, W=32;
             N=4,096); the input state unchanged, untouched leaves the
             input's own tensors, bad row batches refused; then each op's
             launch time, full call time, plain and index_copy times.
3. headline — the stacked face at G=1,048,576, W=32, K=16, R=3 under the
             bench's synthetic load, a steady arm and a failover arm
             (leadership rotation); a few steps of the plain version at
             this width beside the kernel, bit for bit; the RSM invariant
             on the kernel's states; committed decisions/s, ms per
             replica-step against the bandwidth bound, peak memory.
   step shapes — the manager's dispatch step (heat in place and fresh)
             and gp_make_blob against the plain version, bit for bit, for
             every replica id, at the server's shape (G=65,536, W=16, K=8,
             R=3) and the density path's (G=65,536, W=16, K=4, R=1); then
             their times.
4. density — testing/density.py on the card: 1,048,576 names on 65,536
             rows (W=16, K=4, one replica, packed spill in a temporary
             directory): boot by batched create + hibernate, the per-name
             against the batched wake of 4,096 names, 20 rounds of Zipfian
             churn; every request answered, every name accounted for.
5. state transfer — 3 managers (ManagerCluster) at the server shape,
             batching off: replica 2 dies, the others run more than 5W
             slots ahead, replica 2 restarts from its journal and adopts a
             donor's frontier (gp_jump_rows); all three agree.
6. server  — 3 PaxosServers on loopback sockets in this process, on the
             card at G=65,536, W=16, K=8, R=3, with StatefulAdderApp and
             PaxosClientAsync: a few dozen names, a few hundred requests;
             every response is the expected running total, all replicas
             agree, every manager launched gp_step; requests/s, p50/p99.
             Then the admin plane hibernates 8 names on every server and
             restores them, and 64 more requests continue the totals.
7. report  — the kernels line, then the device line (last).

Kernel launch counts are reset to 0 just before each main-path run
(phases 3 to 6) and read just after; parity and timing launches do not
count.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# sizes (the chip run uses these; tests of this script shrink them)
PARITY_G = 1000            # not a multiple of any groups-per-block count
PARITY_SHAPES = [          # (W, R, K)
    (8, 3, 4), (8, 5, 8), (16, 3, 8), (16, 5, 16), (32, 3, 16), (32, 5, 8),
]
HEADLINE = dict(G=1_048_576, W=32, K=16, R=3)
HEADLINE_WARM, HEADLINE_STEPS, HEADLINE_PLAIN_STEPS = 20, 50, 3
SERVER = dict(G=65_536, W=16, K=8, R=3)
SERVER_NAMES, SERVER_REQS_PER_NAME = 32, 10
TIMING_ITERS = 30
WATCHDOG_S = 1140.0
# lifecycle parity and timing: (G, W, batch sizes)
# (16,384 is the density path's boot chunk)
LIFE_SHAPES = {"server": (65_536, 16, (1, 7, 4096, 16_384)),
               "headline": (1_048_576, 32, (4096,))}
LIFE_TIMING_N = 4096
DENSITY = dict(names=1_048_576, rows=65_536, window=16, req_lanes=4,
               boot_chunk=16_384, burst=4096, per_name_burst=None,
               hot_pct=1.0, rounds=20, round_requests=512, zipf_a=1.2,
               seed=0)
# the step's shapes on the server and the density paths (the density
# manager runs one replica)
STEP_SHAPES = {"server": SERVER,
               "density": dict(G=DENSITY["rows"], W=DENSITY["window"],
                               K=DENSITY["req_lanes"], R=1)}
ST_BATCHES, ST_BATCH_REQS = 10, 10   # slots driven past the straggler
SERVER_HIBERNATE, SERVER_POST_REQS_PER_NAME = 8, 2

# the lifecycle kernels: name, function of ops/lifecycle.py, the JAX
# function it replaces, and the path whose launches count ("parity" for
# the row ops only tests use, as in the reference)
LIFE_KERNELS = [
    ("gp_create_groups", "create_groups", "gigapaxos_tpu/ops/lifecycle.py:46", "density"),
    ("gp_kill_groups", "kill_groups", "gigapaxos_tpu/ops/lifecycle.py:95", "density"),
    ("gp_jump_rows", "jump_rows", "gigapaxos_tpu/ops/lifecycle.py:112", "state_transfer"),
    ("gp_restore_paused_rows", "restore_paused_rows",
     "gigapaxos_tpu/ops/lifecycle.py:163", "density"),
    ("gp_restore_rows", "restore_rows", "gigapaxos_tpu/ops/lifecycle.py:207", "parity"),
    ("gp_extract_rows", "extract_rows", "gigapaxos_tpu/ops/lifecycle.py:201", "parity"),
]
def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bandwidth(name: str) -> float:
    """Published device-memory rate (bytes/s) for the card's name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    return 3.35e12  # H100 SXM (80GB HBM3)


def step_bytes(G: int, W: int, K: int, R: int) -> int:
    """Bytes one replica-step must move: state read + written, R gathered
    blob rows, K request words, the out vector and the blob written, the
    want byte per group and R heard bytes."""
    words = 2 * (12 + 7 * W) + R * (4 + 4 * W) + K + (6 + 3 * W) + (4 + 4 * W)
    return G * (4 * words + 1) + R


def stacked_step_bytes(G: int, W: int, K: int, R: int) -> int:
    """Bytes one stacked launch (all R replicas) must move, per replica:
    as :func:`step_bytes`, except that the [R, NB] blob matrix every
    replica gathers from is read once per launch, not once per replica."""
    words = 2 * (12 + 7 * W) + K + (6 + 3 * W) + (4 + 4 * W)
    per_launch = R * G * (4 * words + 1) + R * G * 4 * (4 + 4 * W) + R * R
    return per_launch // R


def blob_bytes(G: int, W: int) -> int:
    """Bytes gp_make_blob moves: the 12 state leaves it reads and the blob."""
    return G * 4 * ((5 + 7 * W) + (4 + 4 * W))


def lifecycle_bytes(name: str, G: int, W: int, N: int) -> int:
    """Bytes one lifecycle op must move: every leaf it touches read once
    and its fresh copy written once, the N row indices and its batch
    inputs read once (all int32; the leaves from gp_kernels.TOUCHED and
    INPUTS).  extract_rows reads N whole rows (12 + 7W words) and writes
    them."""
    from gigapaxos_tpu_torch.ops.gp_kernels import GW_LEAVES, INPUTS, TOUCHED

    words = lambda leaves: sum(W if f in GW_LEAVES else 1 for f in leaves)
    if name == "gp_extract_rows":
        return 4 * (N + 2 * N * (12 + 7 * W))
    return 4 * (2 * G * words(TOUCHED[name]) + N * (1 + words(INPUTS[name])))


def host_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn`` in ms on the host's clock, the card
    synchronized before and after the loop (for calls whose time is
    mostly host work)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


class Diff:
    """Bit-exact comparison bookkeeping across phases."""

    def __init__(self):
        self.max_abs = {"gp_step": 0, "gp_make_blob": 0}
        self.checked = {"gp_step": 0, "gp_make_blob": 0}
        for name, *_ in LIFE_KERNELS:
            self.max_abs[name] = 0
            self.checked[name] = 0

    def same(self, kernel: str, what: str, ok: bool) -> None:
        """A check that is not a word comparison (identity, a refusal)."""
        self.checked[kernel] += 1
        if not ok:
            fail(f"{kernel} {what}")

    def eq(self, kernel: str, what: str, a, b) -> None:
        import torch

        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            fail(f"{kernel} {what}: shape/dtype {tuple(a.shape)} {a.dtype} "
                 f"vs {tuple(b.shape)} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        m = int(d.max()) if d.numel() else 0
        self.max_abs[kernel] = max(self.max_abs[kernel], m)
        self.checked[kernel] += 1
        if m != 0:
            n = int((d != 0).sum())
            fail(f"{kernel} {what}: {n} words differ (max abs {m})")

    def tree(self, kernel: str, what: str, a, b) -> None:
        for f in a._fields:
            self.eq(kernel, f"{what}.{f}", getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# phase 2: seeded states
# ---------------------------------------------------------------------------


def seeded_states(cfg, seed: int, device):
    """R replica states of a CPU simulator after a few loaded steps, then
    lane fuzz: random lanes get slots at wrap deltas up to +-15 (and one
    past), ballots at deltas up to DELTA_MAX (and past), random vids with
    stop bits; some groups get random phases, member masks and tags."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.sim import SimCluster

    G, W, K, R = cfg
    rng = np.random.default_rng(seed)
    sim = SimCluster(cfg, check=False, device="cpu")
    sim.create_all_groups()
    vid = 1
    for t in range(6):
        reqs = {}
        for r in range(R):
            a = np.where(rng.random((G, K)) < 0.5,
                         np.arange(vid, vid + G * K).reshape(G, K), -1)
            vid += G * K
            reqs[r] = a.astype(np.int32)
        want = {int(rng.integers(0, R)): rng.random(G) < 0.05} if t == 2 else {}
        delivery = rng.choice([0, 1, 2], size=(R, R), p=[0.8, 0.1, 0.1])
        sim.step_all(reqs=reqs, want_coord=want, delivery=delivery)
    kb = W.bit_length() - 1
    out = []
    for st in sim.states:
        d = {k: v.numpy().copy() for k, v in st._asdict().items()}
        eb = d["exec_slot"] >> kb
        lanes = np.arange(W)
        for key in ("acc_slot", "dec_slot", "c_prop_slot"):
            eps = rng.integers(-16, 17, size=(G, W))
            fuzz = ((eb[:, None] + eps) << kb) | lanes
            m = rng.random((G, W)) < 0.15
            d[key] = np.where(m, fuzz, d[key]).astype(np.int32)
        m = rng.random((G, W)) < 0.15
        dlt = rng.choice([0, 1, te.DELTA_MAX - 1, te.DELTA_MAX,
                          te.DELTA_MAX + 1, 70000], size=(G, W))
        d["acc_bal"] = np.where(m, d["bal"][:, None] - dlt,
                                d["acc_bal"]).astype(np.int32)
        for key in ("acc_vid", "dec_vid", "c_prop_vid"):
            m = rng.random((G, W)) < 0.1
            v = rng.integers(-1, 10_000, size=(G, W))
            v = np.where(rng.random((G, W)) < 0.1, v | (1 << 30), v)
            d[key] = np.where(m, v, d[key]).astype(np.int32)
        g = rng.random(G) < 0.1
        d["c_phase"] = np.where(g, rng.integers(0, 3, G), d["c_phase"])
        d["member_mask"] = np.where(rng.random(G) < 0.05,
                                    rng.integers(0, 2 ** R, G), d["member_mask"])
        d["tag"] = np.where(rng.random(G) < 0.03, d["tag"] + 1, d["tag"])
        out.append(te.EngineState(**{
            k: torch.as_tensor(np.asarray(v, np.int32), device=device)
            for k, v in d.items()
        }))
    return out


def phase_parity(diff: Diff, device) -> None:
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    t0 = time.perf_counter()
    for i, (W, R, K) in enumerate(PARITY_SHAPES):
        cfg = te.EngineConfig(PARITY_G, W, K, R)
        G = cfg.n_groups
        states = seeded_states(cfg, 100 + i, device)
        rng = np.random.default_rng(200 + i)
        for s in states:
            diff.eq("gp_make_blob", f"W{W}R{R}.blob",
                    gp_kernels.make_blob_vec(s),
                    te.pack_blob(te.make_blob_plain(s)))
        gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in states])
        dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        for my_id in range(R):
            heard = dev(rng.random(R) < 0.85, torch.bool)
            req = rng.integers(1, 10 ** 6, size=(G, K))
            req = np.where(rng.random((G, K)) < 0.3, -1, req)
            req = np.where(rng.random((G, K)) < 0.03, req | (1 << 30), req)
            req = dev(req.astype(np.int32), torch.int32)
            want = dev(rng.random(G) < 0.1, torch.bool)
            heat = dev(rng.integers(0, 100, G).astype(np.int32), torch.int32)
            st = states[my_id]
            k_st, k_out, k_blob, k_heat = gp_kernels.step(
                st, gvec, heard, req, want, my_id, cfg, with_blob=True,
                heat=heat,
            )
            p_st, p_out = te.step_plain(
                st, te.unpack_gathered(gvec, cfg), heard, req, want, my_id, cfg
            )
            tag = f"W{W}R{R}K{K}.r{my_id}"
            diff.tree("gp_step", tag + ".state", k_st, p_st)
            diff.eq("gp_step", tag + ".out", k_out, te.pack_out(p_out))
            diff.eq("gp_step", tag + ".blob", k_blob,
                    te.pack_blob(te.make_blob_plain(p_st)))
            diff.eq("gp_step", tag + ".heat", k_heat,
                    heat + p_out.n_committed + p_out.n_admitted)
        # both faces, N in {1, 4}, heat, donation on and off
        for N in (1, 4):
            ring = rng.integers(1, 10 ** 6, size=(N, G, K))
            ring = np.where(rng.random((N, G, K)) < 0.3, -1, ring)
            ring = dev(ring.astype(np.int32), torch.int32)
            want = dev(rng.random(G) < 0.05, torch.bool)
            heard = dev(np.ones(R, bool), torch.bool)
            heat = torch.zeros(G, dtype=torch.int32, device=device)
            for donate in (False, True):
                fn = make_step(cfg, None, N, donate=donate, io="packed_host",
                               heat=True, device=device)
                p = fn.plain(states[0], gvec, heard, ring, want, 0, heat)
                # a second dispatch on the first one's output
                st0 = te.EngineState(*(x.clone() for x in states[0]))
                k = fn(st0, gvec, heard, ring, want, 0, heat.clone())
                tag = f"packed.W{W}R{R}.N{N}.d{int(donate)}"
                diff.tree("gp_step", tag + ".state", k[0], p[0])
                for j in (1, 2, 3):
                    diff.eq("gp_step", f"{tag}.{j}", k[j], p[j])
                p2 = fn.plain(p[0], gvec, heard, ring, want, 0, p[3])
                k2 = fn(k[0], gvec, heard, ring, want, 0, k[3])
                diff.tree("gp_step", tag + ".again.state", k2[0], p2[0])
                for j in (1, 2, 3):
                    diff.eq("gp_step", f"{tag}.again.{j}", k2[j], p2[j])
            fn = make_step(cfg, None, N, donate=False, io="stacked", device=device)
            stacked = stack_states(states)
            reqs = rng.integers(1, 10 ** 6, size=(N, R, G, K))
            reqs = np.where(rng.random((N, R, G, K)) < 0.3, -1, reqs)
            reqs = dev(reqs.astype(np.int32), torch.int32)
            if N == 1:
                reqs = reqs[0]
            wants = dev(rng.random((R, G)) < 0.05, torch.bool)
            hm = dev(rng.random((R, R)) < 0.8, torch.bool)
            k_st, k_o = fn(stacked, reqs, wants, hm)
            p_st, p_o = fn.plain(stacked, reqs, wants, hm)
            diff.tree("gp_step", f"stacked.W{W}R{R}.N{N}.state", k_st, p_st)
            diff.tree("gp_step", f"stacked.W{W}R{R}.N{N}.out", k_o, p_o)
    torch.cuda.synchronize()
    log(f"parity: {diff.checked} comparisons bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 2b: the lifecycle kernels
# ---------------------------------------------------------------------------


def random_state(G: int, W: int, seed: int, device):
    """A seeded random EngineState: window words in [-1, 400) (NULL = -1
    included), full-range 32-bit app hashes and member masks."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops.gp_kernels import GW_LEAVES

    rng = np.random.default_rng(seed)
    d = {}
    for f in te.EngineState._fields:
        shape = (G, W) if f in GW_LEAVES else (G,)
        d[f] = rng.integers(-1, 400, size=shape, dtype=np.int32)
    for f in ("app_hash", "member_mask"):
        d[f] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G, dtype=np.int32)
    return te.EngineState(**{k: torch.as_tensor(v, device=device)
                             for k, v in d.items()})


def life_args(name: str, rng, G: int, W: int, N: int, other, host_rows=False):
    """Seeded arguments of one lifecycle op (after the state): N unique
    rows and the op's batch inputs, on the host as the manager passes
    them; restore_rows' rows are gathered from ``other`` on the card
    (``host_rows``: copied to the host)."""
    import numpy as np

    from gigapaxos_tpu_torch.ops import lifecycle as tl

    idx = rng.choice(G, size=N, replace=False)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    if name == "gp_create_groups":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[::2] = rng.integers(1, 8, size=masks[::2].shape)
        coord0 = tl.initial_coordinator(idx, masks & 7)
        return (idx, masks, coord0), dict(my_id=1, version=n(0, 4), tag=n(1, 1 << 30))
    if name == "gp_jump_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-2 ** 31, 2 ** 31 - 1),
                n(0, 9), n(0, 2)), {}
    if name == "gp_restore_paused_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-2 ** 31, 2 ** 31 - 1),
                n(0, 9)) + tuple(rng.integers(-1, 500, size=(N, W))
                                 for _ in range(5)), {}
    if name == "gp_restore_rows":
        rows = tl.extract_rows_plain(other, rng.choice(G, size=N, replace=False))
        if host_rows:
            rows = tuple(r.cpu().numpy() for r in rows)
        return (idx, rows), {}
    return (idx,), {}   # kill, extract


def library_fn(name: str, state, want, idx_t):
    """One PyTorch call per leaf computing the same function (timed as
    the yardstick, used nowhere in the port): ``index_copy`` of the
    result rows into every touched leaf, ``index_select`` for the
    gather."""
    from gigapaxos_tpu_torch.ops.gp_kernels import TOUCHED

    if name == "gp_extract_rows":
        return lambda: [leaf.index_select(0, idx_t) for leaf in state]
    rows = [(getattr(state, f), getattr(want, f)[idx_t]) for f in TOUCHED[name]]
    return lambda: [leaf.index_copy(0, idx_t, v) for leaf, v in rows]


def phase_lifecycle(diff: Diff, device, bw: float) -> dict:
    """Every lifecycle kernel against its plain version on the card at
    both shapes (module docstring), then its times at N=4,096."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops import lifecycle as tl

    fields = te.EngineState._fields
    t0 = time.perf_counter()
    times = {name: {"parity_launches": 0} for name, *_ in LIFE_KERNELS}
    for si, (shape, (G, W, Ns)) in enumerate(LIFE_SHAPES.items()):
        te.reset_launch_counts()
        state = random_state(G, W, 400 + si, device)
        other = random_state(G, W, 500 + si, device)
        keep = [x.clone() for x in state]
        rng = np.random.default_rng(600 + si)
        for N in Ns:
            for name, fn, _ref, _path in LIFE_KERNELS:
                variants = [False, True] if name == "gp_restore_rows" and N == 7 else [False]
                for host_rows in variants:
                    args, kw = life_args(name, rng, G, W, N, other, host_rows)
                    got = getattr(tl, fn)(state, *args, **kw)
                    want = getattr(tl, fn + "_plain")(state, *args, **kw)
                    tag = f"{shape}.N{N}" + (".host_rows" if host_rows else "")
                    if name == "gp_extract_rows":
                        for f, a, b in zip(fields, got, want):
                            diff.eq(name, f"{tag}.{f}", a, b)
                    else:
                        diff.tree(name, tag, got, want)
                        ptrs = {x.data_ptr() for x in state}
                        for f in fields:
                            new, old = getattr(got, f), getattr(state, f)
                            if f in gp_kernels.TOUCHED[name]:
                                diff.same(name, f"{tag}.{f}: not a fresh tensor",
                                          new is not old and new.data_ptr() not in ptrs)
                            else:
                                diff.same(name, f"{tag}.{f}: untouched leaf replaced",
                                          new is old)
                    for f, a, b in zip(fields, state, keep):
                        diff.eq(name, f"{tag}.input.{f}", a, b)
                    del got, want
        # a bad row batch is refused before any launch; kill, which
        # writes constants only, takes a repeated row as the plain version
        # does
        for name, fn, _ref, _path in LIFE_KERNELS:
            args, kw = life_args(name, rng, G, W, 4, other)
            for bad in ([1, 2, 1, 3], [0, 1, 2, G]):
                call = lambda f: f(state, np.array(bad), *args[1:], **kw)
                if name == "gp_kill_groups" and bad[-1] < G:
                    diff.tree(name, f"{shape}.repeated_rows", call(tl.kill_groups),
                              call(tl.kill_groups_plain))
                    continue
                try:
                    call(getattr(tl, fn))
                    refused = False
                except ValueError:
                    refused = True
                diff.same(name, f"{shape}: bad rows {bad} not refused", refused)
        torch.cuda.synchronize()
        for name, *_ in LIFE_KERNELS:
            times[name]["parity_launches"] += te.LAUNCHES[name]
        # times at N=4,096: the staged launch alone (copy + row pass, or
        # the gather), the full call (checks, staging upload, outputs,
        # launch), the plain version and the per-leaf library calls
        N = LIFE_TIMING_N
        for name, fn, _ref, _path in LIFE_KERNELS:
            args, kw = life_args(name, rng, G, W, N, other)
            staged = gp_kernels.stage(name, state, *args, **kw)
            ms = cuda_ms(staged.launch, TIMING_ITERS)
            # the call's host side alone (checks, staging upload, outputs)
            # and the whole call, on the host's clock
            ms_stage = host_ms(lambda: gp_kernels.stage(name, state, *args, **kw),
                               TIMING_ITERS)
            ms_call = host_ms(lambda: getattr(tl, fn)(state, *args, **kw), TIMING_ITERS)
            plain = getattr(tl, fn + "_plain")
            want = plain(state, *args, **kw)
            plain_ms = cuda_ms(lambda: plain(state, *args, **kw), 5)
            idx_t = torch.as_tensor(args[0], dtype=torch.long, device=device)
            library_ms = cuda_ms(library_fn(name, state, want, idx_t), TIMING_ITERS)
            nbytes = lifecycle_bytes(name, G, W, N)
            times[name][shape] = {
                "G": G, "W": W, "N": N, "ms": ms, "ms_call": ms_call,
                "ms_stage": ms_stage,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bytes": nbytes, "bound_ms": nbytes / bw * 1e3,
            }
            log(f"lifecycle {shape} {name}: {ms:.6g} ms launch (bound "
                f"{nbytes / bw * 1e3:.6g} ms, {nbytes} B); on the host's clock "
                f"{ms_call:.6g} ms a call, {ms_stage:.6g} ms its staging; plain "
                f"{plain_ms:.6g} ms, index_copy {library_ms:.6g} ms")
            del staged, want
        del state, other, keep
        torch.cuda.empty_cache()
    log(f"lifecycle parity: "
        f"{ {k: diff.checked[k] for k, *_ in LIFE_KERNELS} } checks bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")
    return times


# ---------------------------------------------------------------------------
# phase 4: group density; phase 5: state transfer
# ---------------------------------------------------------------------------


def phase_density(device) -> dict:
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.density import DensityCheckFailed, run_density

    with tempfile.TemporaryDirectory(prefix="gp_density_") as d:
        te.reset_launch_counts()
        try:
            res = run_density(**DENSITY, device=device, log_dir=d,
                              progress=lambda m: log(f"density: {m}"))
        except DensityCheckFailed as e:
            fail(f"density: {e}")
        launches = dict(te.LAUNCHES)
    for name in ("gp_create_groups", "gp_kill_groups", "gp_restore_paused_rows",
                 "gp_step", "gp_make_blob"):
        if launches[name] <= 0:
            fail(f"density: {name} never launched: {launches}")
    res["launches_total"] = launches
    ab, ch, bo = res["ablation"], res["churn"], res["boot"]
    log(f"density: {res['names']} names on {res['rows']} rows: boot "
        f"{bo['names_per_s']:.6g} names/s, host {res['bytes_per_name']['host_rss']:.6g} "
        f"B/name; wake per-name {ab['per_name_us']:.6g} us/name vs batched "
        f"{ab['batched_us_per_name']:.6g} us/name ({ab['speedup_per_name']:.6g}x); "
        f"churn {ch['replies']}/{ch['requests']} answered, {ch['req_per_s']:.6g} "
        f"req/s, wake p50 {ch['wake_p50_s']} s p99 {ch['wake_p99_s']} s; "
        f"residency {res['residency_end']}; launches {res['launches']}")
    return res


def phase_state_transfer(device) -> dict:
    import numpy as np

    from gigapaxos_tpu_torch.manager import PaxosManager
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP, ManagerCluster
    from gigapaxos_tpu_torch.utils.config import Config

    G, W, K, R = (SERVER[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)

    def until_executed(c, vals, entry, delivery=None, max_steps=60):
        done = {}
        for v in vals:
            c.managers[entry].propose(
                name, v, callback=lambda r, resp: done.setdefault(r, resp))
        for _ in range(max_steps):
            if len(done) == len(vals):
                return
            c.step_all(delivery=delivery)
        fail(f"state transfer: {len(done)}/{len(vals)} executed")

    # this scenario drives the frontier by slot COUNT: coalescing would
    # pack each burst into about two slots
    Config.set("BATCHING_ENABLED", "false")
    c = None
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="gp_state_transfer_") as d:
            dirs = [os.path.join(d, f"n{i}") for i in range(R)]
            te.reset_launch_counts()
            c = ManagerCluster(cfg, HashChainApp, log_dirs=dirs, device=device)
            # a stepped cluster's failure detector never fires, so the
            # replica that dies must not coordinate the name: take the
            # first name whose row's initial coordinator is replica 0
            name = next(nm for nm in (f"svc{i}" for i in range(64))
                        if c.managers[0].default_row_for(nm) % R == 0)
            c.create(name, members=list(range(R)))
            row = c.managers[0].names[name]
            until_executed(c, [f"a{i}" for i in range(4)], 0)
            c.managers[2].close()
            dead = np.full((R, R), DELIVER)
            dead[2, :] = DROP
            dead[:, 2] = DROP
            for b in range(ST_BATCHES):
                until_executed(c, [f"b{b}-{i}" for i in range(ST_BATCH_REQS)], 0,
                               delivery=dead)
            live = int(c.managers[0]._np("exec_slot")[row])
            behind = int(c.managers[2]._np("exec_slot")[row])
            if live - behind <= 5 * W:
                fail(f"state transfer: straggler only {live - behind} slots behind")
            c.managers[2] = PaxosManager(2, HashChainApp(), cfg, log_dir=dirs[2],
                                         device=device)
            c.blobs[2] = c.managers[2].blob()
            steps = 0
            for steps in range(1, 81):
                c.step_all()
                if int(c.managers[2]._np("exec_slot")[row]) >= live:
                    break
            until_executed(c, ["post-1", "post-2"], 2)
            for _ in range(5):   # let every replica execute them
                c.step_all()
            launches = dict(te.LAUNCHES)
            hashes = [int(m._np("app_hash")[row]) for m in c.managers]
            states = [m.app.state.get(name) for m in c.managers]
            n_exec = [m.app.n_executed.get(name) for m in c.managers]
            for m in c.managers:
                m.close()
            c = None
    finally:
        Config._cli.pop("BATCHING_ENABLED", None)
        if c is not None:
            for m in c.managers:
                m.close()
    if launches["gp_jump_rows"] < 1:
        fail(f"state transfer: gp_jump_rows never launched: {launches}")
    if len(set(hashes)) != 1 or len(set(states)) != 1 or len(set(n_exec)) != 1:
        fail(f"state transfer: replicas disagree: hashes {hashes}, executed {n_exec}")
    res = {"gap_slots": live - behind, "rejoin_steps": steps, "launches": launches,
           "executed": n_exec[0], "seconds": time.perf_counter() - t0}
    log(f"state transfer: straggler {live - behind} slots behind rejoined in "
        f"{steps} steps; {n_exec[0]} executed on all 3, equal hash chains; "
        f"launches {launches} ({res['seconds']:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# phase 3: the headline engine (stacked face)
# ---------------------------------------------------------------------------


def assert_rsm(states) -> int:
    """Equal app hash wherever frontiers are equal, every replica pair;
    returns the number of (group, pair) cells with equal frontiers."""
    R = states.exec_slot.shape[0]
    cells = 0
    for a in range(R):
        for b in range(a + 1, R):
            same = states.exec_slot[a] == states.exec_slot[b]
            bad = same & (states.app_hash[a] != states.app_hash[b])
            if bool(bad.any()):
                fail(f"RSM divergence between replicas {a} and {b}")
            cells += int(same.sum())
    return cells


def phase_headline(diff: Diff, device, bw: float) -> dict:
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    G, W, K, R = (HEADLINE[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    groups = torch.arange(G, dtype=torch.int32, device=device)
    rids = torch.arange(R, dtype=torch.int32, device=device)
    vids = torch.arange(1, K + 1, dtype=torch.int32, device=device)
    # requests offered at EVERY replica's lanes; only the ACTIVE
    # coordinator admits (clients follow the leader through failover)
    req = vids[None, None, :].expand(R, G, K).contiguous()
    no_want = torch.zeros((R, G), dtype=torch.bool, device=device)
    step_fn = make_step(cfg, None, 1, donate=True, io="stacked", device=device)

    def failover_want(t: int):
        # each group re-elects every 16 steps, leadership rotating around
        # the replica ring, the electing 1/16 slice staggered per step
        sl = (groups & 15) == (t & 15)
        target = (groups % R + 1 + (t >> 4)) % R
        return (target[None, :] == rids[:, None]) & sl[None, :]

    arms = {}
    torch.cuda.reset_peak_memory_stats()
    for arm in ("steady", "failover"):
        states = build_replica_states(cfg, device=device)
        want = (lambda t: failover_want(t)) if arm == "failover" else (lambda t: no_want)
        t = 0
        for _ in range(HEADLINE_WARM):
            states, _ = step_fn(states, req, want(t))
            t += 1
        # full-width parity: the plain version beside the kernel
        plain = step_fn.plain
        snap = te.EngineState(*(x.clone() for x in states))
        for j in range(HEADLINE_PLAIN_STEPS):
            k_st, k_o = step_fn(
                te.EngineState(*(x.clone() for x in snap)), req, want(t + j)
            )
            p_st, p_o = plain(snap, req, want(t + j))
            diff.tree("gp_step", f"headline.{arm}.{j}.state", k_st, p_st)
            diff.tree("gp_step", f"headline.{arm}.{j}.out", k_o, p_o)
            snap = p_st
            del k_st, k_o, p_o
        del snap, p_st
        torch.cuda.synchronize()
        # main path: counts from 0, timed steps, read just after
        te.reset_launch_counts()
        committed = torch.zeros((), dtype=torch.int64, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HEADLINE_STEPS):
            states, out = step_fn(states, req, want(t))
            committed += out.n_committed[0].sum()  # each slot once
            t += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(te.LAUNCHES)
        if launches["gp_step"] < HEADLINE_STEPS or launches["gp_make_blob"] < 1:
            fail(f"headline {arm}: main path launched {launches}")
        rate = int(committed) / dt
        if rate <= 0:
            fail(f"headline {arm}: no decisions committed")
        cells = assert_rsm(states)
        arms[arm] = {
            "dec_per_s": rate, "steps": HEADLINE_STEPS, "seconds": dt,
            "launches": launches, "rsm_equal_frontier_cells": cells,
        }
        log(f"headline {arm}: {rate:.6g} committed decisions/s over "
            f"{HEADLINE_STEPS} steps ({dt:.4f} s), launches {launches}, "
            f"RSM ok on {cells} equal-frontier cells")
        del states, out
    peak = torch.cuda.max_memory_allocated()
    # kernel timing at this shape: one stacked gp_step launch = R
    # replica-steps; one gp_make_blob launch over R replicas
    states = build_replica_states(cfg, device=device)
    for t in range(HEADLINE_WARM):
        states, _ = step_fn(states, req, no_want)
    blobs = gp_kernels.make_blob_rows(states, R)
    hm = torch.ones((R, R), dtype=torch.bool, device=device)
    out_st = te.EngineState(*(torch.empty_like(x) for x in states))
    out_mat = torch.empty((R, te.out_vec_len(cfg)), dtype=torch.int32, device=device)
    out_bl = torch.empty_like(blobs)
    ms_step = cuda_ms(lambda: gp_kernels.step_stacked(
        states, blobs, hm, req, no_want, cfg, out_states=out_st,
        out_mat=out_mat, out_blobs=out_bl), TIMING_ITERS) / R
    # the same launch with the wrapper allocating the new states (what
    # make_step does): the caching allocator's cost per step
    ms_fresh = cuda_ms(lambda: gp_kernels.step_stacked(
        states, blobs, hm, req, no_want, cfg,
        out_mat=out_mat, out_blobs=out_bl), TIMING_ITERS) / R
    ms_blob = cuda_ms(lambda: gp_kernels.make_blob_rows(states, R),
                      TIMING_ITERS) / R
    plain_ms = cuda_ms(lambda: step_fn.plain(states, req, no_want), 2) / R
    nbytes = stacked_step_bytes(G, W, K, R)
    bound = nbytes / bw * 1e3
    log(f"headline gp_step: {ms_step:.6g} ms per replica-step into "
        f"preallocated states, {ms_fresh:.6g} ms into fresh ones; bound "
        f"{bound:.6g} ms ({nbytes} B per replica-step at {bw:.3g} B/s), "
        f"plain {plain_ms:.6g} ms; peak device memory {peak} B")
    return {
        "arms": arms, "ms_per_replica_step": ms_step,
        "ms_per_replica_step_fresh": ms_fresh, "bound_ms": bound,
        "plain_ms": plain_ms, "make_blob_ms": ms_blob,
        "make_blob_bound_ms": blob_bytes(G, W) / bw * 1e3,
        "peak_bytes": peak, "shape": HEADLINE,
    }


# ---------------------------------------------------------------------------
# phase 4: the server path
# ---------------------------------------------------------------------------


def server_diag(servers) -> str:
    """Tick and transport counters of the servers (failure context)."""
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

    per = [
        {"ticks": s._tick, "sent": s.transport.n_sent,
         "rcvd": s.transport.n_rcvd, "dropped": s.transport.n_dropped,
         "coalesced": s.transport.n_coalesced,
         "engine_step_s": s.manager.last_engine_step_s}
        for s in servers
    ]
    return f"servers {per}; profiler {DelayProfiler.get_stats()}"


def phase_server(device) -> dict:
    import numpy as np

    from gigapaxos_tpu_torch.clients import PaxosClientAsync
    from gigapaxos_tpu_torch.models import StatefulAdderApp
    from gigapaxos_tpu_torch.net.node_config import NodeConfig
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.server import PaxosServer
    from gigapaxos_tpu_torch.testing.ports import free_ports

    G, W, K, R = (SERVER[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    te.reset_launch_counts()
    ports = free_ports(R)
    nc = NodeConfig({i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    servers = [
        PaxosServer(i, nc, StatefulAdderApp(), cfg, tick_interval=0.01,
                    fd_timeout_s=30.0, device=device)
        for i in range(R)
    ]
    client = None
    try:
        for s in servers:
            s.start()
        client = PaxosClientAsync([("127.0.0.1", p) for p in ports])
        names = [f"svc{i}" for i in range(SERVER_NAMES)]
        t_create = time.perf_counter()
        for nm in names:
            if not client.create_paxos_instance(nm, list(range(R)), timeout=60):
                fail(f"server: create {nm} failed")
        t_create = time.perf_counter() - t_create
        lat, errors = [], []
        lock = threading.Lock()
        expected: dict = {nm: 0 for nm in names}

        def chain(nm: str, seed: int, n_reqs: int) -> None:
            rng = np.random.default_rng(seed)
            total = expected[nm]
            for _ in range(n_reqs):
                v = int(rng.integers(1, 100))
                t0 = time.perf_counter()
                resp = client.send_request_sync(nm, str(v), timeout=60)
                dt = time.perf_counter() - t0
                total += v
                with lock:
                    lat.append(dt)
                    if resp != str(total):
                        errors.append((nm, resp, total))
            with lock:
                expected[nm] = total

        def run_chains(n_reqs: int, seed0: int) -> float:
            threads = [threading.Thread(target=chain, args=(nm, seed0 + i, n_reqs))
                       for i, nm in enumerate(names)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            if errors:
                fail(f"server: {len(errors)} wrong responses, first {errors[0]}; "
                     f"{server_diag(servers)}")
            return wall

        def converge(what: str) -> None:
            deadline = time.time() + 60
            while time.time() < deadline:
                if all(s.manager.app.totals.get(nm) == expected[nm]
                       for s in servers for nm in names):
                    return
                time.sleep(0.1)
            bad = {nm: [s.manager.app.totals.get(nm) for s in servers]
                   for nm in names
                   if any(s.manager.app.totals.get(nm) != expected[nm]
                          for s in servers)}
            fail(f"server: {what}: replicas' app totals disagree with the "
                 f"responses: {dict(list(bad.items())[:4])} expected "
                 f"{ {nm: expected[nm] for nm in list(bad)[:4]} }; "
                 f"{server_diag(servers)}")

        wall = run_chains(SERVER_REQS_PER_NAME, 0)
        converge("after the first requests")
        n = len(lat)
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        # the admin plane: hibernate some names on every server (a forced
        # pause and a kill, gp_kill_groups), then restore them (a create
        # and a record install, gp_create_groups + gp_restore_paused_rows)
        t_hib = time.perf_counter()
        for op in ("hibernate", "restore"):
            for i in range(R):
                for nm in names[:SERVER_HIBERNATE]:
                    r = client.admin_sync(i, {"op": op, "name": nm}, timeout=60)
                    if not r or not r.get("ok"):
                        fail(f"server: admin {op} {nm} on server {i}: {r}")
        for i, s in enumerate(servers):
            for nm in names[:SERVER_HIBERNATE]:
                if s.manager.app.totals.get(nm) != expected[nm]:
                    fail(f"server: {nm} restored on server {i} with total "
                         f"{s.manager.app.totals.get(nm)}, expected {expected[nm]}")
        t_hib = time.perf_counter() - t_hib
        lat.clear()
        wall_post = run_chains(SERVER_POST_REQS_PER_NAME, 1000)
        converge("after hibernate and restore")
        n_post = len(lat)
        per_mgr = [dict(s.manager.kernel_launches) for s in servers]
        if any(m.get("gp_step", 0) <= 0 for m in per_mgr):
            fail(f"server: a manager never launched gp_step: {per_mgr}")
        launches = dict(te.LAUNCHES)
        for k in ("gp_create_groups", "gp_kill_groups", "gp_restore_paused_rows"):
            if launches[k] <= 0:
                fail(f"server: {k} never launched: {launches}")
        res = {
            "requests": n, "names": len(names), "seconds": wall,
            "req_per_s": n / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "create_seconds": t_create,
            "hibernated": SERVER_HIBERNATE, "hibernate_restore_seconds": t_hib,
            "post_restore_requests": n_post, "post_restore_seconds": wall_post,
            "launches": launches, "per_manager_launches": per_mgr,
            "shape": SERVER,
        }
        log(f"server: {server_diag(servers)}")
        log(f"server: {n} requests over {len(names)} names answered "
            f"correctly in {wall:.4f} s: {res['req_per_s']:.6g} req/s, "
            f"p50 {res['p50_ms']:.6g} ms, p99 {res['p99_ms']:.6g} ms; "
            f"{SERVER_HIBERNATE} names hibernated and restored on all "
            f"{R} servers in {t_hib:.4f} s, then {n_post} more requests "
            f"correct in {wall_post:.4f} s; "
            f"launches {launches}, per manager {per_mgr}")
        return res
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.stop()


def phase_step_shapes(diff: Diff, device, bw: float) -> dict:
    """The step launches of the server and density paths at their shapes
    (``STEP_SHAPES``), held against the plain version: the manager's
    dispatch step (packed face, N=1; heat updated in place, as the
    dispatch does, and into a fresh vector, as the tick does) for every
    replica id, and gp_make_blob of every replica's state, on
    kernel-loaded states and on fuzzed seeded states.  Then the times of
    gp_step, gp_make_blob and the plain versions at each shape."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    res = {}
    for si, (shape, dims) in enumerate(STEP_SHAPES.items()):
        G, W, K, R = (dims[k] for k in ("G", "W", "K", "R"))
        cfg = te.EngineConfig(G, W, K, R)
        fn = make_step(cfg, None, 1, donate=False, io="stacked", device=device)
        req = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        req = req[None, None, :].expand(R, G, K).contiguous()
        want = torch.zeros((R, G), dtype=torch.bool, device=device)
        states = build_replica_states(cfg, device=device)
        for _ in range(10):
            states, _ = fn(states, req, want)

        t0 = time.perf_counter()
        rng = np.random.default_rng(300 + 10 * si)
        dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        cases = {
            "loaded": [te.EngineState(*(x[r].contiguous() for x in states))
                       for r in range(R)],
            "fuzzed": seeded_states(cfg, 301 + 10 * si, device),
        }
        for donate in (True, False):
            dispatch = make_step(cfg, None, 1, donate=donate, io="packed_host",
                                 heat=True, device=device)
            for name, sts in cases.items():
                gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in sts])
                if donate:
                    for r, s in enumerate(sts):
                        diff.eq("gp_make_blob", f"{shape}.{name}.r{r}.blob",
                                gp_kernels.make_blob_vec(s), gvec[r])
                for my_id in range(R):
                    heard = dev(rng.random(R) < 0.85, torch.bool)
                    ring = rng.integers(1, 10 ** 6, size=(1, G, K))
                    ring = np.where(rng.random((1, G, K)) < 0.3, -1, ring)
                    ring = dev(ring.astype(np.int32), torch.int32)
                    want1 = dev(rng.random(G) < 0.05, torch.bool)
                    heat = dev(rng.integers(0, 100, G).astype(np.int32), torch.int32)
                    # my_id as the manager passes it (np.int32): the step's
                    # retrace sentinel, shared with the managers of the
                    # later phases, then sees their signature here first
                    p = dispatch.plain(sts[my_id], gvec, heard, ring, want1,
                                       np.int32(my_id), heat)
                    k = dispatch(sts[my_id], gvec, heard, ring, want1,
                                 np.int32(my_id), heat.clone())
                    tag = f"{shape}.{name}.d{int(donate)}.r{my_id}"
                    diff.tree("gp_step", tag + ".state", k[0], p[0])
                    for j, what in ((1, "out"), (2, "blob"), (3, "heat")):
                        diff.eq("gp_step", f"{tag}.{what}", k[j], p[j])
        torch.cuda.synchronize()
        log(f"{shape} shape parity (G={G}, W={W}, K={K}, R={R}): bit-equal "
            f"({time.perf_counter() - t0:.1f} s)")

        st = te.EngineState(*(x[0].contiguous() for x in states))
        gvec = gp_kernels.make_blob_rows(states, R)
        heard = torch.ones(R, dtype=torch.bool, device=device)
        out_st = te.EngineState(*(torch.empty_like(x) for x in st))
        heat = torch.zeros(G, dtype=torch.int32, device=device)
        ms = cuda_ms(lambda: gp_kernels.step(
            st, gvec, heard, req[0], want[0], 0, cfg, with_blob=True,
            out_state=out_st, heat=heat, heat_out=heat), TIMING_ITERS)
        # the same launch with the wrapper allocating the new state (what
        # make_step does): the caching allocator's cost per step
        ms_fresh = cuda_ms(lambda: gp_kernels.step(
            st, gvec, heard, req[0], want[0], 0, cfg, with_blob=True,
            heat=heat, heat_out=heat), TIMING_ITERS)
        g = te.unpack_gathered(gvec, cfg)

        def plain():
            p_st, p_o = te.step_plain(st, g, heard, req[0], want[0], 0, cfg)
            te.pack_out(p_o)
            te.pack_blob(te.make_blob_plain(p_st))

        plain_ms = cuda_ms(plain, 3)
        blob_ms = cuda_ms(lambda: gp_kernels.make_blob_vec(st), TIMING_ITERS)
        blob_plain_ms = cuda_ms(lambda: te.pack_blob(te.make_blob_plain(st)), 5)
        res[shape] = {
            "shape": dims, "ms": ms, "ms_fresh": ms_fresh, "plain_ms": plain_ms,
            "bound_ms": step_bytes(G, W, K, R) / bw * 1e3,
            "make_blob_ms": blob_ms, "make_blob_plain_ms": blob_plain_ms,
            "make_blob_bound_ms": blob_bytes(G, W) / bw * 1e3,
        }
        r = res[shape]
        log(f"{shape} shape gp_step: {ms:.6g} ms into a preallocated state, "
            f"{ms_fresh:.6g} ms into a fresh one (bound {r['bound_ms']:.6g} ms, "
            f"plain {plain_ms:.6g} ms); gp_make_blob {blob_ms:.6g} ms (bound "
            f"{r['make_blob_bound_ms']:.6g} ms, plain {blob_plain_ms:.6g} ms)")
        del states, cases, st, gvec, out_st, g
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------


def kernels_line(diff: Diff, head: dict, step_t: dict, life: dict, dens: dict,
                 xfer: dict, srv: dict) -> list:
    """The kernels line's entries, from the phases' results."""
    srv_t, den_t = step_t["server"], step_t["density"]
    kernels = [
        {
            "name": "gp_step", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/ops/engine.py:380",
            "launches": srv["launches"]["gp_step"],
            "max_abs_err": diff.max_abs["gp_step"],
            "ms": srv_t["ms"], "plain_ms": srv_t["plain_ms"],
            "bound_ms": srv_t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "ms_fresh_state": srv_t["ms_fresh"],
            "shape": SERVER, "comparisons": diff.checked["gp_step"],
            "headline": {
                "launches_steady": head["arms"]["steady"]["launches"]["gp_step"],
                "launches_failover": head["arms"]["failover"]["launches"]["gp_step"],
                "ms_per_replica_step": head["ms_per_replica_step"],
                "ms_per_replica_step_fresh_state":
                    head["ms_per_replica_step_fresh"],
                "bound_ms": head["bound_ms"], "plain_ms": head["plain_ms"],
            },
            "density_shape": {
                "shape": den_t["shape"],
                "launches": dens["launches_total"]["gp_step"],
                **{k: den_t[k] for k in ("ms", "ms_fresh", "bound_ms", "plain_ms")},
            },
        },
        {
            "name": "gp_make_blob", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/ops/engine.py:277",
            "launches": srv["launches"]["gp_make_blob"],
            "max_abs_err": diff.max_abs["gp_make_blob"],
            "ms": srv_t["make_blob_ms"], "plain_ms": srv_t["make_blob_plain_ms"],
            "bound_ms": srv_t["make_blob_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": SERVER, "comparisons": diff.checked["gp_make_blob"],
            "headline": {
                "launches_steady": head["arms"]["steady"]["launches"]["gp_make_blob"],
                "launches_failover": head["arms"]["failover"]["launches"]["gp_make_blob"],
                "ms_per_replica": head["make_blob_ms"],
                "bound_ms": head["make_blob_bound_ms"],
            },
            "density_shape": {
                "shape": den_t["shape"],
                "launches": dens["launches_total"]["gp_make_blob"],
                "ms": den_t["make_blob_ms"], "plain_ms": den_t["make_blob_plain_ms"],
                "bound_ms": den_t["make_blob_bound_ms"],
            },
        },
    ]
    per_path = {"density": dens["launches_total"], "state_transfer": xfer["launches"],
                "server": srv["launches"]}
    for name, _fn, ref, path in LIFE_KERNELS:
        t_srv, t_head = life[name]["server"], life[name]["headline"]
        on_paths = {p: per_path[p][name] for p in per_path}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_lifecycle.cu",
            "replaces": ref,
            # the count of the path this kernel is checked on; the row ops
            # only tests use count their launches in the parity phase
            "launches": life[name]["parity_launches"] if path == "parity"
            else per_path[path][name],
            "launches_from": path, "launches_by_path": on_paths,
            "max_abs_err": diff.max_abs[name],
            "ms": t_srv["ms"], "plain_ms": t_srv["plain_ms"],
            "bound_ms": t_srv["bound_ms"], "bound_by": "bytes",
            "library_ms": t_srv["library_ms"], "ms_call": t_srv["ms_call"],
            "ms_stage": t_srv["ms_stage"],
            "shape": {"G": t_srv["G"], "W": t_srv["W"], "N": t_srv["N"]},
            "comparisons": diff.checked[name],
            "headline": {k: t_head[k] for k in
                         ("G", "W", "N", "ms", "ms_call", "ms_stage", "plain_ms",
                          "library_ms", "bound_ms")},
        })
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not os.path.isdir(os.path.join(HERE, "gigapaxos_tpu_torch", "csrc")):
        fail("run from a checkout: gigapaxos_tpu_torch/ is missing")
    sys.path.insert(0, HERE)
    # a hang anywhere dumps every thread's stack and exits nonzero before
    # the run's time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from gigapaxos_tpu_torch.ops import gp_kernels

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else f"{kind}, power limit not read"
    bw = peak_bandwidth(kind)
    log(f"device: {kind}; {smi_line}; peak memory rate {bw:.3g} B/s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    libs = gp_kernels.build(force=True)
    gp_kernels.lib()
    log(f"build: {', '.join(os.path.basename(p) for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for src, text in gp_kernels.BUILD_INFO.get("ptxas", {}).items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    diff = Diff()
    t_start = time.perf_counter()
    stamp = lambda name: log(
        f"[{time.perf_counter() - t_start:.1f} s] phase {name}"
    )
    stamp("parity")
    phase_parity(diff, device)
    stamp("lifecycle parity and timing")
    life = phase_lifecycle(diff, device, bw)
    stamp("headline")
    head = phase_headline(diff, device, bw)
    # parity and timings at the server's and the density path's shapes
    # first: they do not count launches
    stamp("step-shape parity and timing")
    step_t = phase_step_shapes(diff, device, bw)
    stamp("density")
    dens = phase_density(device)
    stamp("state transfer")
    xfer = phase_state_transfer(device)
    stamp("server")
    srv = phase_server(device)
    stamp("report")

    # 7. report
    kernels = kernels_line(diff, head, step_t, life, dens, xfer, srv)
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']}: no launch on the "
                 f"{k.get('launches_from', 'server')} path")
    ab, ch = dens["ablation"], dens["churn"]
    log(f"summary: headline steady {head['arms']['steady']['dec_per_s']:.6g} "
        f"dec/s, failover {head['arms']['failover']['dec_per_s']:.6g} dec/s; "
        f"server {srv['req_per_s']:.6g} req/s p50 {srv['p50_ms']:.6g} ms "
        f"p99 {srv['p99_ms']:.6g} ms; density {dens['names']} names: boot "
        f"{dens['boot']['names_per_s']:.6g} names/s, wake {ab['per_name_us']:.6g} "
        f"us/name per-name vs {ab['batched_us_per_name']:.6g} batched, churn "
        f"{ch['req_per_s']:.6g} req/s; state transfer jumped "
        f"{xfer['gap_slots']} slots; on {smi_line}")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
