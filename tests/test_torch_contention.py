"""The plain-step lock (``ops/engine.py`` ``_PLAIN_LOCK``) and the tool
that measures what it saves (``gigapaxos_tpu_torch/testing/contention.py``).

Several threads stepping plain engines at once (the tick threads of a
loopback cluster on the CPU) run their steps one at a time, and a step's
result does not depend on which thread runs it or when; the tool's JSON
line carries the concurrent and the one-thread run.
"""

import json
import threading

import numpy as np
import torch

from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.testing import contention


def test_plain_steps_run_one_at_a_time(monkeypatch):
    active, peak, lock = [0], [0], threading.Lock()
    real = te._step_plain

    def counted(*a):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            return real(*a)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(te, "_step_plain", counted)
    rec = contention.measure(nodes=4, groups=8, replicas=3, steps=3)
    assert peak[0] == 1
    assert rec["together"]["threads"] == 4 and rec["alone"]["threads"] == 1
    assert rec["plain_step_lock"] is True


def test_threaded_steps_equal_the_serial_ones():
    """The same packed step from four threads at once and in turn."""
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    cfg = te.EngineConfig(16, 8, 4, 3)
    fn = make_step(cfg, None, 2, io="packed_host", heat=True, device="cpu")
    states = build_replica_states(cfg, device="cpu")
    rng = np.random.default_rng(4)
    gvec = torch.stack([te.pack_blob(te.make_blob_plain(
        te.EngineState(*(x[r] for x in states)))) for r in range(3)])
    args = [(te.EngineState(*(x[r] for x in states)), gvec, torch.ones(3, dtype=torch.bool),
             torch.as_tensor(rng.integers(-1, 100, (2, 16, 4)).astype(np.int32)),
             torch.as_tensor(rng.random(16) < 0.3), r, torch.zeros(16, dtype=torch.int32))
            for r in range(3)] * 2
    serial = [fn(*a) for a in args]
    threaded = [None] * len(args)

    def run(i):
        threaded[i] = fn(*args[i])

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for s, t in zip(serial, threaded):
        for a, b in zip(s[0], t[0]):
            assert torch.equal(a, b)
        for j in (1, 2, 3):
            assert torch.equal(s[j], t[j])


def test_contention_cli_line(capsys):
    assert contention.main(["--nodes", "2", "--groups", "8", "--replicas", "3",
                            "--steps", "2", "--no-lock"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "plain_step_contention" and line["platform"] == "cpu"
    assert line["plain_step_lock"] is False
    for run in ("together", "alone"):
        assert line[run]["thread_cpu_ms_per_step"] > 0 and line[run]["wall_s"] > 0
    # the lock is back after a --no-lock run
    assert isinstance(te._PLAIN_LOCK, type(threading.Lock()))
