"""Nothing the benchmark loads is JAX or the JAX package (top-level
module names compared whole), and the reference loads nothing of the
program."""

import os
import subprocess
import sys

from gpbench import run

from .conftest import ROOT


def _child(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, %r)\n"
        "from gpbench.tests.conftest import add_tiny, checkout\n"
        "import pathlib\n"
        "root = checkout(pathlib.Path(%r)); add_tiny(root)\n"
        "from gpbench import harness, run, control\n"
        "harness.run('tiny_ar.tiny_wire', 3, 0.2, False, 'cpu', time.perf_counter(), root=root)\n"
        "harness.run('tiny_node.failover', 3, 0.2, True, 'cpu', time.perf_counter(), root=root,\n"
        "            trace_path=root + '/t.json')\n"
        "print(json.dumps([run.forbidden_modules(), 'gigapaxos_tpu_torch' in sys.modules]))\n"
    ) % (ROOT, str(tmp_path))
    assert _child(code) == '[[], true]'


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import gpbench.reference.paxos, gpbench.reference.roofline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('gigapaxos')))\n")
    assert _child(code) == "[]"


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gigapaxos_tpu_torch_fake", sys)
    assert "gigapaxos_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "gigapaxos_tpu.ops", sys)
    assert {"jax", "gigapaxos_tpu"} <= set(run.forbidden_modules())


def test_no_result_without_a_card_or_the_program(tmp_path):
    """From a directory that holds only the benchmark's files, and here
    without a card, a run exits nonzero and prints no result."""
    from .conftest import checkout

    root = checkout(tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "node_2m.steady",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
