"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter installs a ``sys.meta_path`` finder that refuses
``jax``, ``jaxlib`` and ``gigapaxos_tpu`` (the exact names and their
submodules — a prefix match would also refuse ``gigapaxos_tpu_torch``),
imports every module of ``gigapaxos_tpu_torch``, and checks that
``make_step(cfg)`` with no ``device`` raises when no CUDA card is
present (no silent fallback to the CPU).  With the finder still on, it
then loads what the port's default configuration names by dotted path
(the reconfigurators' demand profile and placement policy, the CLI
node's default app): an ``importlib`` default that named the JAX package
would be refused there, though no module imports it.  The sharded-serving
slice adds to the probe: the serving, HTTP, transaction, trace-merge and
chaos modules by name, the worker module the supervisor spawns (found by
its dotted name, as ``python -m`` finds it) and the worker's default
``APPLICATION``; and with no card, ``run_sharded_soak`` and the sharded
parent refuse to run without a device.  The recovery slice adds the
recovery probe's module and the ``obs`` exports, and with no card
``run_recovery`` refuses to run without a device.  The operating and
measuring slice adds the scripted clock, the footprint probe, the bench,
the capacity probe, the trace collector and the cluster launcher.  The
mesh slice adds the entry points' module (``graft_entry``) and, with no
card, the mesh constructors and the dry run refusing to run without
devices.  The workload slice adds the bank-ledger scenario, the chaos
sweep and the perf-baseline reader by name, each refusing to run
without a device and without a card.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "gigapaxos_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        for b in BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Block())
for b in BLOCKED:
    assert b not in sys.modules, b

import gigapaxos_tpu_torch as pkg

mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for m in mods:
    importlib.import_module(m)
leaked = sorted(
    k for k in sys.modules
    if any(k == b or k.startswith(b + ".") for b in BLOCKED)
)
assert not leaked, leaked

import torch

from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.parallel.spmd import make_step

cfg = EngineConfig(n_groups=4, window=8, req_lanes=4, n_replicas=3)
if not torch.cuda.is_available():
    try:
        make_step(cfg)
    except RuntimeError:
        pass
    else:
        raise AssertionError("make_step(cfg) without a card did not raise")

from gigapaxos_tpu_torch.reconfigurable_node import app_class
from gigapaxos_tpu_torch.reconfiguration.demand import AggregateDemandProfiler
from gigapaxos_tpu_torch.reconfiguration.placement import PlacementEngine

loaded = [AggregateDemandProfiler().profile_cls, type(PlacementEngine().policy),
          app_class()]
for cls in loaded:
    assert cls.__module__.startswith("gigapaxos_tpu_torch."), cls
leaked = sorted(
    k for k in sys.modules
    if any(k == b or k.startswith(b + ".") for b in BLOCKED)
)
assert not leaked, leaked

# the slice's modules, each by name (a rename would drop out of the walk)
for m in ("serving", "serving.router", "serving.supervisor", "serving.worker",
          "http_front", "txn", "txn.app", "txn.driver", "txn.recovery",
          "txn.transactor", "obs.tracemerge", "testing.chaos",
          "testing.recovery", "testing.clock", "testing.footprint",
          "testing.bench", "testing.probe", "testing.gp_trace", "gp_server",
          "graft_entry", "parallel.mesh", "testing.contention",
          "scenarios.bank_ledger", "testing.chaos_sweep", "testing.perf_baseline"):
    assert f"gigapaxos_tpu_torch.{m}" in mods, m
if not torch.cuda.is_available():
    from gigapaxos_tpu_torch.scenarios import bank_ledger
    from gigapaxos_tpu_torch.testing import chaos_sweep, perf_baseline

    for call in (lambda: bank_ledger.main(["--accounts", "10"]),
                 lambda: chaos_sweep.main(["--family", "txn", "--count", "1"]),
                 lambda: perf_baseline.main(["--root", "."])):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("a tool ran without a device and without a card")
if not torch.cuda.is_available():
    from gigapaxos_tpu_torch.graft_entry import dryrun_multichip
    from gigapaxos_tpu_torch.parallel.mesh import make_group_mesh, make_mesh

    for call in (make_group_mesh, lambda: make_mesh(1), lambda: dryrun_multichip(2)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("a mesh was built without devices and without a card")
from gigapaxos_tpu_torch.obs import (all_sentinels, compile_stats,  # noqa: F401
                                     device_memory_stats, step_cost)
from gigapaxos_tpu_torch.testing.recovery import run_recovery

if not torch.cuda.is_available():
    try:
        run_recovery(g=8, names=8, active=1, tail=2)
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("run_recovery ran without a device and without a card")
import importlib.util
import inspect

from gigapaxos_tpu_torch.serving import supervisor, worker

spawned = [x for x in inspect.getsource(supervisor).split('"') if x.endswith(".serving.worker")]
assert spawned == ["gigapaxos_tpu_torch.serving.worker"], spawned
spec = importlib.util.find_spec(spawned[0])
assert spec is not None and spec.origin == worker.__file__, spec
worker_app = [x for x in inspect.getsource(worker).split() if "app_class" in x]
assert worker_app, "the worker no longer loads APPLICATION through app_class"
if not torch.cuda.is_available():
    from gigapaxos_tpu_torch.serving.router import ShardedActiveNode
    from gigapaxos_tpu_torch.testing.chaos import run_sharded_soak
    from gigapaxos_tpu_torch.utils.config import Config

    Config.set("active.AR0", "127.0.0.1:1")
    for call in (lambda: run_sharded_soak(20260804, workers=2, rounds=1),
                 lambda: ShardedActiveNode("AR0", 2)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("ran without a device and without a card")
    Config.clear()
leaked = sorted(
    k for k in sys.modules
    if any(k == b or k.startswith(b + ".") for b in BLOCKED)
)
assert not leaked, leaked
print("DEFAULTS", " ".join(f"{c.__module__}.{c.__name__}" for c in loaded))
print("IMPORTED", len(mods))
"""


def test_port_imports_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=str(REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 92, r.stdout
    assert r.stdout.split("DEFAULTS")[1].split()[:3] == [
        "gigapaxos_tpu_torch.reconfiguration.demand.DemandProfile",
        "gigapaxos_tpu_torch.reconfiguration.placement.ProximateBalancePolicy",
        "gigapaxos_tpu_torch.models.apps.NoopPaxosApp",
    ], r.stdout


def test_port_sources_do_not_name_the_reference():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib
    or the JAX package."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|gigapaxos_tpu)(\s|\.|$)")
    files = sorted((REPO / "gigapaxos_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if pat.match(line):
                bad.append(f"{p.relative_to(REPO)}:{i}: {line.strip()}")
    assert not bad, bad
