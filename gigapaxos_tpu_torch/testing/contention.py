"""Plain steps of several nodes in one process: what they cost each other.

A loopback cluster on the CPU (``ReconfigurableNode`` with
``device="cpu"``, the tests' socket deployments) steps one plain engine
per node, each in its own tick thread.  A plain step is a few hundred
small tensor operations, each of which releases and retakes the
interpreter lock.  This tool runs ``--nodes`` threads, each stepping its
own replica's packed dispatch step (``make_step(io="packed_host")`` at
N=1, as a manager's tick does) ``--steps`` times at once, then one such
thread alone, and reports the thread CPU time and the wall time of a
step in both runs.  ``--no-lock`` replaces the engine's plain-step lock
(``ops/engine.py`` ``_PLAIN_LOCK``) with none for the run, to show what
it saves.

    python -m gigapaxos_tpu_torch.testing.contention [--nodes 7] \
        [--groups 32] [--window 8] [--lanes 4] [--replicas 4] \
        [--steps 50] [--no-lock]

Runs on the CPU only (it measures the plain engine); prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
from typing import Dict

from ..obs.gplog import emit


def _stepper(cfg, steps: int, out: list, start: threading.Barrier) -> None:
    import torch

    from ..ops import engine as te
    from ..parallel.spmd import build_replica_states, make_step

    fn = make_step(cfg, None, 1, io="packed_host", heat=True, device="cpu")
    states = build_replica_states(cfg, device="cpu")
    state = te.EngineState(*(x[0] for x in states))
    gvec = torch.stack([
        te.pack_blob(te.make_blob_plain(te.EngineState(*(x[r] for x in states))))
        for r in range(cfg.n_replicas)])
    heard = torch.ones(cfg.n_replicas, dtype=torch.bool)
    ring = torch.full((1, cfg.n_groups, cfg.req_lanes), te.NULL, dtype=torch.int32)
    ring[0, :, 0] = torch.arange(1, cfg.n_groups + 1, dtype=torch.int32)
    want = torch.zeros(cfg.n_groups, dtype=torch.bool)
    heat = torch.zeros(cfg.n_groups, dtype=torch.int32)
    fn(state, gvec, heard, ring, want, 0, heat)   # warm
    start.wait()
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(steps):
        fn(state, gvec, heard, ring, want, 0, heat)
    out.append((time.perf_counter() - t0, time.thread_time() - c0))


def _run(cfg, n_threads: int, steps: int) -> Dict:
    out: list = []
    start = threading.Barrier(n_threads + 1)
    threads = [threading.Thread(target=_stepper, args=(cfg, steps, out, start))
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0, p0 = time.perf_counter(), time.process_time()
    for t in threads:
        t.join()
    wall, cpu = time.perf_counter() - t0, time.process_time() - p0
    n = n_threads * steps
    return {"threads": n_threads, "steps_each": steps,
            "thread_cpu_ms_per_step": 1e3 * sum(c for _, c in out) / n,
            "wall_ms_per_step": 1e3 * sum(w for w, _ in out) / n,
            "wall_s": wall, "process_cpu_s": cpu}


def measure(nodes: int = 7, groups: int = 32, window: int = 8, lanes: int = 4,
            replicas: int = 4, steps: int = 50, lock: bool = True) -> Dict:
    """The concurrent run and the one-thread run (module docstring)."""
    from ..ops import engine as te

    cfg = te.EngineConfig(groups, window, lanes, replicas)
    saved = te._PLAIN_LOCK
    if not lock:
        te._PLAIN_LOCK = contextlib.nullcontext()
    try:
        together = _run(cfg, nodes, steps)
        alone = _run(cfg, 1, steps)
    finally:
        te._PLAIN_LOCK = saved
    return {"metric": "plain_step_contention", "platform": "cpu",
            "shape": {"G": groups, "W": window, "K": lanes, "R": replicas},
            "plain_step_lock": lock, "together": together, "alone": alone,
            "cpu_ratio": together["thread_cpu_ms_per_step"]
            / alone["thread_cpu_ms_per_step"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=7)
    ap.add_argument("--groups", type=int, default=32)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--no-lock", action="store_true")
    a = ap.parse_args(argv)
    emit(json.dumps(measure(a.nodes, a.groups, a.window, a.lanes, a.replicas,
                            a.steps, not a.no_lock)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
