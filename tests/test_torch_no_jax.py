"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter installs a ``sys.meta_path`` finder that refuses
``jax``, ``jaxlib`` and ``gigapaxos_tpu`` (the exact names and their
submodules — a prefix match would also refuse ``gigapaxos_tpu_torch``),
imports every module of ``gigapaxos_tpu_torch``, and checks that
``make_step(cfg)`` with no ``device`` raises when no CUDA card is
present (no silent fallback to the CPU).
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
print("IMPORTED", len(mods))
"""


def test_port_imports_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=str(REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 45, r.stdout


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
