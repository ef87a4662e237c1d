"""Headline benchmark of the port: committed Paxos decisions/second.

The port's counterpart of the JAX package's root ``bench.py``, with its
modes, shapes, load and JSON line.  All R=3 replica engines advance on one
card through the stacked face (``make_step(..., io="stacked")``: one
``gp_step`` launch over every replica and group tile a step), G groups
committing in lock step, with the client load generated on the device, so
the measurement isolates the consensus engine as the reference's in-JVM
probe (``TESTPaxosClient.probeCapacity``) isolates its JVM path.

Metric: committed decisions/s = slots executed per second by one replica
(each slot is one agreed client request), across all groups.  The north
star (``BASELINE.json``) is >= 10M decisions/s over ~1M groups.

Modes (environment, as the reference's):

* default: the headline, G=1,048,576, W=32, K=16, R=3 (on the CPU:
  G=8,192, W=8, K=4).  K requests at every replica's lanes each step;
  only a group's active coordinator admits them.  Two chunks of 10 steps
  of warm-up, timed apart, then 5 timed chunks; the committed count is
  summed on the device and read once per chunk.
* ``BENCH_MODE=failover``: the same under leadership churn (every group
  re-elects every 16 steps, leadership rotating around the replica ring).
* ``BENCH_G=2097152``: the capacity run (the reference's
  ``PINSTANCES_CAPACITY`` wall): ``no_oom``, dec/s and the card's peak
  memory (``torch.cuda.max_memory_allocated``) beside the footprint
  module's estimate for the shape.  An out-of-memory error is a result.
* ``BENCH_DISPATCH_ABLATION=1``: N=1 against N=8 steps per dispatch
  (G=262,144, W=32, K=16, R=3; on the CPU G=512, W=8, K=4) under
  identical load and 480 substeps, best of 5 interleaved trials; per-step
  parity across N must be bit-exact.  On the card N=8 is 8 ``gp_step``
  launches per dispatch.
* ``BENCH_MULTICHIP=1``: the weak-scaling curve of the group-sharded
  mesh face (``make_group_mesh``, one stacked ``gp_step`` per shard a
  step): n in {1, 2, 4, 8} devices, at most the number of physical cards,
  with groups per device held constant (1,048,576 at W=32, K=16, R=3 on
  the card; the load made on each device), 2 chunks of warm-up and 5
  timed chunks; aggregate and per-device dec/s and each card's peak
  memory.  On one card the curve has one point: it measures no
  multi-card speed.  With ``--device cpu``: 8 logical CPU devices
  (``BENCH_MULTICHIP_DEVICES``) at 8,192 groups each, W=8, K=4, 3 timed
  chunks, under the reference's host-serialized model (one process runs
  the logical devices in turn, so linear scaling is a flat aggregate).
  ``BENCH_G_PER_DEVICE`` and ``BENCH_MULTICHIP_CHUNKS`` override.  It
  writes only to ``--out`` or ``BENCH_MULTICHIP_OUT``.

``BENCH_W``, ``BENCH_K``, ``BENCH_DISPATCH_SUBSTEPS``,
``BENCH_DISPATCH_PARITY_SUBSTEPS`` and ``BENCH_DISPATCH_TRIALS`` override
the shapes and counts.

    python -m gigapaxos_tpu_torch.testing.bench [--device cpu] [--out FILE]

Runs on the card unless ``--device cpu`` is given; with no card it
raises.  Prints ONE JSON line; ``--out`` (or ``BENCH_DISPATCH_OUT`` for
the ablation) also writes it to a file, stamped with the platform and, on
the card, ``nvidia-smi``'s name and power limit.  The JAX package's
artifact names (``BENCH_rNN.json``, ``CAPACITY_rNN.json``,
``MULTICHIP_rNN.json``, ``TPU_EVIDENCE.json``, ``PERF_BASELINE.json``) are
refused.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Callable, Dict, Optional

from ..obs.gplog import emit

NORTH_STAR = 10_000_000.0  # decisions/s, BASELINE.json
CAPACITY_G = 2_097_152     # the reference's PINSTANCES_CAPACITY wall
CHUNK = 10                 # steps per chunk (the reference's scan length)
WARM_CHUNKS, TIMED_CHUNKS = 2, 5
R = 3

REFERENCE_ARTIFACT = re.compile(
    r"(BENCH|CAPACITY|MULTICHIP|DENSITY|RECOVERY|TXN|CHAOS_SWEEP)_r\d+\.json"
    r"|TPU_EVIDENCE\.json|PERF_BASELINE\.json")


def check_out(path: Optional[str]) -> None:
    """Refuse the JAX package's artifact names as an output path."""
    if path and REFERENCE_ARTIFACT.fullmatch(os.path.basename(path)):
        raise ValueError(f"{os.path.basename(path)} is the JAX package's "
                         "artifact; name the port's result otherwise")


def write_out(path: Optional[str], result: Dict) -> None:
    if not path:
        return
    check_out(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def bench_provenance(device, donate: bool = True) -> Dict:
    """Toolchain and device stamp: torch and CUDA versions, the platform
    and, on the card, ``nvidia-smi``'s name and power limit."""
    from ..obs.device import provenance
    from .recovery import card_stamp

    return provenance(donate=donate, extra={"card": card_stamp(device)})


def _platform(device) -> str:
    return "cuda" if device.type == "cuda" else "cpu"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StackedLoad:
    """The bench's on-device load at one shape, and the states it drives
    (``states``): K constant vids offered at every replica's lanes, and
    (``failover``) every group re-electing every 16 steps, the electing
    1/16 slice staggered per step.  Only ``states`` holds the states, so a
    step's input is freed as soon as its output replaces it: the bench
    holds two state sets at a time, as the reference's donated dispatch
    holds one."""

    def __init__(self, cfg, device, failover: bool = False):
        import torch

        from ..parallel.spmd import build_replica_states, make_step

        self.cfg, self.device, self.failover = cfg, device, failover
        G, K, R_ = cfg.n_groups, cfg.req_lanes, cfg.n_replicas
        self.step_fn = make_step(cfg, None, 1, donate=True, io="stacked",
                                 device=device)
        self.groups = torch.arange(G, dtype=torch.int32, device=device)
        self.rids = torch.arange(R_, dtype=torch.int32, device=device)
        vids = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        self.req = vids[None, None, :].expand(R_, G, K).contiguous()
        self.no_want = torch.zeros((R_, G), dtype=torch.bool, device=device)
        self.states = build_replica_states(cfg, device=device)

    def want(self, t: int):
        if not self.failover:
            return self.no_want
        sl = (self.groups & 15) == (t & 15)
        target = (self.groups % self.cfg.n_replicas + 1 + (t >> 4)) % self.cfg.n_replicas
        return (target[None, :] == self.rids[:, None]) & sl[None, :]

    def chunk(self, base: int, n: int = CHUNK):
        """``n`` steps of ``states`` from step ``base``; the committed count
        of replica 0 (each slot once), summed on the device."""
        import torch

        committed = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(n):
            self.states, out = self.step_fn(self.states, self.req, self.want(base + i))
            committed += out.n_committed[0].sum()
            del out
        return committed


def run_headline(G: int, W: int, K: int, device, failover: bool = False,
                 warm_chunks: int = WARM_CHUNKS, n_chunks: int = TIMED_CHUNKS,
                 after_warmup: Optional[Callable] = None) -> Dict:
    """The bench loop at one shape: ``warm_chunks`` chunks of warm-up
    (timed apart), then ``n_chunks`` timed chunks, one sync per chunk.
    ``after_warmup(load, t)`` runs between the two (``load.states`` are
    the warmed states, ``t`` the next step).  Returns the rate, the
    per-chunk committed counts, the seconds and the final states."""
    from ..ops.engine import EngineConfig

    cfg = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    load = StackedLoad(cfg, device, failover)
    tw = time.perf_counter()
    warm = [load.chunk(c * CHUNK) for c in range(warm_chunks)]
    warm = [int(n) for n in warm]
    warmup_s = time.perf_counter() - tw
    t = warm_chunks * CHUNK
    if after_warmup is not None:
        after_warmup(load, t)
    _sync(device)
    t0 = time.perf_counter()
    chunks = []
    for c in range(n_chunks):
        chunks.append(int(load.chunk(t + c * CHUNK)))   # one host touch per chunk
    dt = time.perf_counter() - t0
    total = sum(chunks)
    return {"rate": total / dt, "total": total, "chunks": chunks,
            "warm_chunks": warm, "warmup_s": warmup_s, "steady_s": dt,
            "steps": n_chunks * CHUNK, "states": load.states, "cfg": cfg}


def _is_oom(e: BaseException) -> bool:
    import torch

    s = f"{type(e).__name__}: {e}"
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in s


def capacity(G: int, W: int, K: int, device, failover: bool = False,
             after_warmup: Optional[Callable] = None) -> Dict:
    """The capacity arm: the bench loop at ``G`` with the card's peak
    memory beside the footprint estimate.  Returns (the capacity record,
    :func:`run_headline`'s result); after an out-of-memory error the
    record says ``no_oom: False`` and the result is None.  Any other error
    raises."""
    import torch

    from .footprint import probe

    est = probe(G, W, K, R)
    rec = {"platform": _platform(device), "G": G, "W": W, "K": K,
           "footprint_estimate_bytes": est["single_chip_peak_estimate_bytes"],
           "footprint_state_bytes": R * est["state_bytes_per_replica"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        res = run_headline(G, W, K, device, failover, after_warmup=after_warmup)
    except Exception as e:  # noqa: BLE001 — only an OOM is a result
        if not _is_oom(e):
            raise
        return {**rec, "no_oom": False, "dec_per_s": None,
                "per_device_hbm_bytes": None,
                "error": f"{type(e).__name__}: {e}"[:500]}, None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {**rec, "no_oom": True, "dec_per_s": round(res["rate"], 1),
            "per_device_hbm_bytes": peak}, res


def headline_result(res: Dict, G: int, device, failover: bool) -> Dict:
    """The reference's JSON line for one run of the bench loop."""
    mode = "failover-churn" if failover else "steady-state"
    return {
        "metric": "committed_decisions_per_s",
        "value": round(res["rate"], 1),
        "unit": f"decisions/s ({G} groups, 3 replicas, 1 card, {mode}, "
                f"{_platform(device)})",
        "vs_baseline": round(res["rate"] / NORTH_STAR, 3),
        "warmup_s": round(res["warmup_s"], 2),
        "steady_s": round(res["steady_s"], 2),
        "provenance": bench_provenance(device),
    }


# ---------------------------------------------------------------------------
# the dispatch ablation
# ---------------------------------------------------------------------------


def _ring(cfg, n_steps: int, device):
    import torch

    G, K = cfg.n_groups, cfg.req_lanes
    vids = torch.arange(1, K + 1, dtype=torch.int32, device=device)
    if n_steps == 1:
        return vids[None, None, :].expand(R, G, K).contiguous()
    return vids[None, None, None, :].expand(n_steps, R, G, K).contiguous()


def dispatch_arm(n_steps: int, G: int, W: int, K: int, substeps: int,
                 device) -> Dict:
    """One ablation arm: the stacked step at ``n_steps`` rounds per host
    dispatch over ``substeps`` engine steps of identical load, the host
    touching the outputs once per dispatch (the decided-count reduction)."""
    import torch

    from ..ops.engine import EngineConfig
    from ..parallel.spmd import build_replica_states, make_step

    cfg = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    states = build_replica_states(cfg, device=device)
    step_fn = make_step(cfg, None, n_steps, donate=True, io="stacked", device=device)
    ring = _ring(cfg, n_steps, device)
    want = torch.zeros((R, G), dtype=torch.bool, device=device)
    dispatches = substeps // n_steps
    tw = time.perf_counter()
    for _ in range(2):
        states, out = step_fn(states, ring, want)
    _sync(device)
    warmup_s = time.perf_counter() - tw
    t0 = time.perf_counter()
    decided = 0
    for _ in range(dispatches):
        states, out = step_fn(states, ring, want)
        # ONE host touch per dispatch: the reduction syncs the device
        decided += int(out.n_committed[..., 0, :].sum())
    dt = time.perf_counter() - t0
    return {
        "steps_per_dispatch": n_steps,
        "host_dispatches": dispatches,
        "substeps": dispatches * n_steps,
        "decided": decided,
        "warmup_s": round(warmup_s, 3),
        "wall_s": round(dt, 3),
        "decided_per_s": round(decided / dt, 1),
        "dispatch_amortized_us": round(1e6 * dt / dispatches / n_steps, 1),
    }


def dispatch_parity(G: int, W: int, K: int, substeps: int, device,
                    n: int = 8) -> Dict:
    """Bit-exact check: N=``n`` residency against ``n`` sequential N=1
    calls from the same initial states, every state leaf and every
    StepOutputs field."""
    import torch

    from ..ops.engine import EngineConfig
    from ..parallel.spmd import build_replica_states, make_step

    cfg = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    fn1 = make_step(cfg, None, 1, donate=False, io="stacked", device=device)
    fnn = make_step(cfg, None, n, donate=False, io="stacked", device=device)
    req, ring = _ring(cfg, 1, device), _ring(cfg, n, device)
    want = torch.zeros((R, G), dtype=torch.bool, device=device)
    s1 = build_replica_states(cfg, device=device)
    sn = build_replica_states(cfg, device=device)
    dec1 = decn = 0
    bit_exact = True
    for _ in range(substeps // n):
        outs1 = []
        for _i in range(n):
            s1, o = fn1(s1, req, want)
            outs1.append(o)
        sn, on = fnn(sn, ring, want)
        dec1 += sum(int(o.n_committed[0].sum()) for o in outs1)
        decn += int(on.n_committed[:, 0].sum())
        for i, o in enumerate(outs1):
            for a, b in zip(o, on):
                bit_exact &= torch.equal(a, b[i])
        for a, b in zip(s1, sn):
            bit_exact &= torch.equal(a, b)
    return {"substeps": substeps - substeps % n, "bit_exact": bool(bit_exact),
            "decided_n1": dec1, f"decided_n{n}": decn}


def dispatch_ablation(device, G: Optional[int] = None, W: Optional[int] = None,
                      K: Optional[int] = None, substeps: Optional[int] = None,
                      parity_substeps: Optional[int] = None,
                      trials: Optional[int] = None) -> Dict:
    """N=1 against N=8 (module docstring); the reference's result object."""
    t_start = time.perf_counter()
    env = os.environ.get
    on_cpu = device.type != "cuda"
    G = G or int(env("BENCH_G", 512 if on_cpu else 262_144))
    W = W or int(env("BENCH_W", 8 if on_cpu else 32))
    K = K or int(env("BENCH_K", 4 if on_cpu else 16))
    substeps = substeps or int(env("BENCH_DISPATCH_SUBSTEPS", "480"))
    parity = dispatch_parity(
        G, W, K, parity_substeps or int(env("BENCH_DISPATCH_PARITY_SUBSTEPS", "32")),
        device)
    # best of trials, arms interleaved
    trials = trials or int(env("BENCH_DISPATCH_TRIALS", "5"))
    arm1 = arm8 = None
    for _ in range(trials):
        a1 = dispatch_arm(1, G, W, K, substeps, device)
        a8 = dispatch_arm(8, G, W, K, substeps, device)
        if arm1 is None or a1["wall_s"] < arm1["wall_s"]:
            arm1 = a1
        if arm8 is None or a8["wall_s"] < arm8["wall_s"]:
            arm8 = a8
    return {
        "metric": "dispatch_ablation",
        "platform": _platform(device),
        "shape": {"G": G, "W": W, "K": K, "R": R},
        "arms": {"n1": arm1, "n8": arm8},
        "dispatch_count_ratio": round(
            arm1["host_dispatches"] / arm8["host_dispatches"], 2),
        "throughput_ratio_n8_vs_n1": round(
            arm8["decided_per_s"] / arm1["decided_per_s"], 3),
        "parity": parity,
        "provenance": bench_provenance(device),
        "wall_s": round(time.perf_counter() - t_start, 1),
    }


def ablation_ok(result: Dict) -> bool:
    p = result["parity"]
    return (p["bit_exact"] and p["decided_n1"] == p["decided_n8"]
            and result["dispatch_count_ratio"] >= 7.5)


# ---------------------------------------------------------------------------
# the multichip arm: weak scaling of the group-sharded mesh face
# ---------------------------------------------------------------------------


class ShardedLoad:
    """The bench's load on a ``('g',)`` mesh, made on each device: every
    shard's states created full-membership (coordinators round-robin by
    global group index), K constant vids at every replica's lanes."""

    def __init__(self, cfg, mesh):
        import numpy as np
        import torch

        from ..ops.engine import EngineState
        from ..parallel.mesh import ShardedTensor
        from ..parallel.spmd import build_replica_states, make_step

        n = mesh.size
        G, K, R_ = cfg.n_groups, cfg.req_lanes, cfg.n_replicas
        Gs = G // n
        shard_cfg = cfg._replace(n_groups=Gs)
        grid = lambda: np.empty(mesh.devices.shape, dtype=object)
        leaves = [grid() for _ in EngineState._fields]
        req, want = grid(), grid()
        for i, dev in enumerate(mesh.devices.flat):
            coord0 = ((i * Gs + np.arange(Gs)) % R_).astype(np.int32)
            st = build_replica_states(shard_cfg, coord0, device=dev)
            for leaf, x in zip(leaves, st):
                leaf[i] = x
            vids = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
            req[i] = vids[None, None, :].expand(R_, Gs, K).contiguous()
            want[i] = torch.zeros((R_, Gs), dtype=torch.bool, device=dev)
        spec = (None, "g")
        self.states = EngineState(*(ShardedTensor(mesh, spec, x, G) for x in leaves))
        self.req = ShardedTensor(mesh, spec, req, G)
        self.want = ShardedTensor(mesh, spec, want, G)
        self.mesh = mesh
        self.step_fn = make_step(cfg, mesh, 1, donate=True)

    def chunk(self, n: int = CHUNK) -> int:
        """``n`` steps; replica 0's committed count summed on each device
        and read once."""
        import torch

        committed = [torch.zeros((), dtype=torch.int64, device=d)
                     for d in self.mesh.devices.flat]
        for _ in range(n):
            self.states, out = self.step_fn(self.states, self.req, self.want)
            for c, x in zip(committed, out.n_committed.shards.flat):
                c += x[0].sum()
            del out
        return sum(int(c) for c in committed)


def group_sharded_point(devices, g_per_dev: int, W: int, K: int,
                        n_chunks: int) -> Dict:
    """One weak-scaling point: the group-sharded step over ``devices`` at
    G = g_per_dev x len(devices), warm-up timed apart, then ``n_chunks``
    timed chunks; aggregate and per-device dec/s and peak memory."""
    import torch

    from ..ops.engine import EngineConfig
    from ..parallel.mesh import make_group_mesh

    n = len(devices)
    mesh = make_group_mesh(n, devices=devices)
    cfg = EngineConfig(n_groups=g_per_dev * n, window=W, req_lanes=K, n_replicas=R)
    for d in {str(d): d for d in devices if d.type == "cuda"}.values():
        torch.cuda.reset_peak_memory_stats(d)
    load = ShardedLoad(cfg, mesh)
    tw = time.perf_counter()
    for _ in range(WARM_CHUNKS):
        load.chunk()
    warmup_s = time.perf_counter() - tw
    t0 = time.perf_counter()
    total = sum(load.chunk() for _ in range(n_chunks))
    dt = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else None
             for d in devices]
    known = [p for p in peaks if p is not None]
    rate = total / dt
    del load
    return {
        "n_devices": n,
        "mesh_shape": {"g": n},
        "G": cfg.n_groups,
        "groups_per_device": g_per_dev,
        "aggregate_dec_per_s": round(rate, 1),
        "per_device_dec_per_s": round(rate / n, 1),
        "per_device_hbm_peak_bytes": max(known) if known else None,
        "hbm_peak_bytes_by_device": peaks,
        "steps_timed": n_chunks * CHUNK,
        "warmup_s": round(warmup_s, 2),
        "wall_s": round(dt, 2),
        "physical_devices": mesh.physical_devices,
    }


def multichip(device) -> Dict:
    """The weak-scaling curve (module docstring); the reference's result
    object, with ``physical_devices`` and the card's stamp."""
    import torch

    t_start = time.perf_counter()
    env = os.environ.get
    on_cpu = device.type != "cuda"
    if on_cpu:
        n_avail = int(env("BENCH_MULTICHIP_DEVICES", "8"))
        pool = [device] * n_avail
        physical = 1
    else:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n_avail = physical = len(pool)
    counts = [n for n in (1, 2, 4, 8) if n <= n_avail]
    g_per_dev = int(env("BENCH_G_PER_DEVICE", 8_192 if on_cpu else 1_048_576))
    W = int(env("BENCH_W", 8 if on_cpu else 32))
    K = int(env("BENCH_K", 4 if on_cpu else 16))
    n_chunks = int(env("BENCH_MULTICHIP_CHUNKS", 3 if on_cpu else TIMED_CHUNKS))
    curve = []
    for n in counts:
        pt = group_sharded_point(pool[:n], g_per_dev, W, K, n_chunks)
        emit(f"BENCH multichip point: {json.dumps(pt)}", err=True)
        curve.append(pt)
    base = curve[0]["aggregate_dec_per_s"]
    top = curve[-1]
    n_max = top["n_devices"]
    eff_parallel = top["aggregate_dec_per_s"] / (n_max * base)
    eff_serialized = top["aggregate_dec_per_s"] / base
    host_cores = os.cpu_count() or 1
    # logical devices of one process on the CPU run in turn: linear weak
    # scaling is then a flat aggregate; on distinct cards it is n x n=1
    serialized = on_cpu
    return {
        "metric": "multichip_weak_scaling",
        "platform": _platform(device),
        "host_cores": host_cores,
        "n_devices_available": n_avail,
        "physical_devices": physical,
        "mode": "group-sharded mesh (one process drives every device; no "
                "exchange between devices, all R replica rows device-local)",
        "shape": {"groups_per_device": g_per_dev, "W": W, "K": K, "R": R},
        "curve": curve,
        "scaling": {
            "at_n_devices": n_max,
            "efficiency_vs_linear": round(
                eff_serialized if serialized else eff_parallel, 3),
            "linear_model": (
                f"host-serialized: {n_max} logical devices run in turn in one "
                f"process on {host_cores} core(s); linear = flat aggregate vs n=1"
            ) if serialized else (
                "parallel devices: linear = n x the n=1 aggregate"
            ),
            "efficiency_parallel_model": round(eff_parallel, 3),
            "efficiency_serialized_model": round(eff_serialized, 3),
        },
        "provenance": bench_provenance(device),
        "wall_s": round(time.perf_counter() - t_start, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    env = os.environ.get
    out = args.out
    multi = env("BENCH_MULTICHIP", "") not in ("", "0")
    if env("BENCH_DISPATCH_ABLATION", "") not in ("", "0"):
        out = out or env("BENCH_DISPATCH_OUT")
    if multi:
        out = out or env("BENCH_MULTICHIP_OUT")
    check_out(out)

    from ..ops.engine import resolve_device

    device = resolve_device(args.device)
    if multi:
        result = multichip(device)
        write_out(out, result)
        emit(json.dumps(result))
        return 0
    if env("BENCH_DISPATCH_ABLATION", "") not in ("", "0"):
        result = dispatch_ablation(device)
        write_out(out, result)
        emit(json.dumps(result))
        return 0 if ablation_ok(result) else 1

    on_cpu = device.type != "cuda"
    G = int(env("BENCH_G", 8_192 if on_cpu else 1_048_576))
    W = int(env("BENCH_W", 8 if on_cpu else 32))
    K = int(env("BENCH_K", 4 if on_cpu else 16))
    failover = env("BENCH_MODE", "steady") == "failover"
    if G == CAPACITY_G:
        cap, res = capacity(G, W, K, device, failover)
        if res is None:
            result = {
                "metric": "committed_decisions_per_s", "value": 0.0,
                "unit": f"decisions/s ({G} groups, 3 replicas, 1 card, OOM, "
                        f"{_platform(device)})",
                "vs_baseline": 0.0, "capacity": cap,
                "provenance": bench_provenance(device),
            }
            write_out(out, result)
            emit(json.dumps(result))
            return 1
        result = {**headline_result(res, G, device, failover), "capacity": cap}
    else:
        result = headline_result(run_headline(G, W, K, device, failover), G,
                                 device, failover)
    write_out(out, result)
    emit(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
