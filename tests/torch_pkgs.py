"""Both packages side by side, for the parity tests of the host layers.

``JAX`` and ``TORCH`` name the JAX package and the port; a scenario
written once against ``pkg.mod("manager")`` and friends runs on either,
and ``pkg.dev`` is the keyword the port's entry points take to run on the
CPU (the JAX package takes none).  ``boot_cluster(pkg)`` is
``tests/test_server.py``'s loopback cluster on either package.
"""

from __future__ import annotations

import importlib
import time

import numpy as np


class Pkg:
    """One package: its modules by dotted name, and how to put its
    entry points on the CPU."""

    def __init__(self, root: str):
        self.root = root
        self.is_torch = root.endswith("_torch")
        self.dev = {"device": "cpu"} if self.is_torch else {}

    def mod(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def __repr__(self) -> str:
        return self.root


JAX = Pkg("gigapaxos_tpu")
TORCH = Pkg("gigapaxos_tpu_torch")
PKGS = (JAX, TORCH)


def leaves(m) -> dict:
    """Every engine leaf of a manager as a private host array."""
    return {k: np.array(m._np(k), copy=True) for k in m.state._fields}


def assert_leaves_equal(a: dict, b: dict, what) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def wait_until(cond, timeout=20.0, interval=0.05) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def boot_cluster(pkg: Pkg, cfg=None, fd_timeout_s=2.0):
    """3 PaxosServers on loopback sockets with a StatefulAdderApp and a
    PaxosClientAsync (``tests/test_server.py:boot_cluster``)."""
    EngineConfig = pkg.mod("ops.engine").EngineConfig
    cfg = cfg or EngineConfig(n_groups=6, window=8, req_lanes=4, n_replicas=3)
    ports = pkg.mod("testing.ports").free_ports(3)
    nc = pkg.mod("net.node_config").NodeConfig(
        {i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    PaxosServer = pkg.mod("server").PaxosServer
    servers = [
        PaxosServer(i, nc, pkg.mod("models").StatefulAdderApp(), cfg,
                    tick_interval=0.01, fd_timeout_s=fd_timeout_s, **pkg.dev)
        for i in range(3)
    ]
    for s in servers:
        s.start()
    client = pkg.mod("clients").PaxosClientAsync(
        [("127.0.0.1", p) for p in ports])
    return servers, client, ports


def set_leaf(pkg: Pkg, leaf, idx, value):
    """``leaf`` with ``leaf[idx] = value``, as a new array of the package
    (``.at[].set`` on the JAX package, a clone on the port)."""
    if pkg.is_torch:
        out = leaf.clone()
        out[idx] = value
        return out
    return leaf.at[idx].set(value)


def digest(managers) -> str:
    """One hash of every engine leaf and name map of ``managers``."""
    import hashlib

    h = hashlib.sha1()
    for m in managers:
        h.update(repr(sorted(m.names.items())).encode())
        for k in m.state._fields:
            h.update(np.ascontiguousarray(m._np(k), dtype=np.int32).tobytes())
    return h.hexdigest()


def scripted(mp, t0: float = 1_000_000.0):
    """One scripted clock in every loaded module of both packages (the
    lazily imported ones loaded first); returns it.  ``clock.t`` moves
    only where the caller moves it (or a module sleeps)."""
    from gigapaxos_tpu_torch.testing.clock import PRELOAD, ScriptedClock, patch_clocks

    for pkg in PKGS:
        for name in PRELOAD:
            pkg.mod(name)
    clock = ScriptedClock(t0)
    patch_clocks(mp, clock, ("gigapaxos_tpu.", "gigapaxos_tpu_torch."))
    return clock
