"""A scripted clock: the port's soaks as a pure function of their seed.

A soak's protocol timers (task retransmits, READY audits, redrops,
failure detection) and its settle deadlines read ``time.time()``, so on
the wall clock two runs of one seed replay different schedules: a seed
can pass in one run and wedge in the next.  :func:`scripted` replaces the
``time`` module of every loaded module of the port with one
:class:`ScriptedClock`, which advances by :data:`TICK_DT` each time a
manager ticks (``PaxosManager.tick`` and ``tick_host``) and nowhere else,
and seeds the global ``random`` state (node-minted request ids draw from
it).  A soak run inside it replays one schedule for one seed.

The schedule also follows the iteration order of sets of name strings,
which follows Python's per-process string hash.  :func:`run_in_child`
runs a soak in a fresh interpreter with ``PYTHONHASHSEED`` pinned
(:data:`HASH_SEED`), so that a pinned seed replays one schedule on every
run, on the card and on the CPU alike:

    PYTHONHASHSEED=0 python -m gigapaxos_tpu_torch.testing.clock \\
        '{"family": "soak", "seed": 1234, "device": "cpu"}'

prints ``RESULT {...}``: the soak's result dictionary, the kernel
launches, manager ticks and cluster steps it took, and its seconds on the
host's clock.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import subprocess
import sys
import time as _time
from typing import Callable, Dict, Optional, Sequence

from ..obs.gplog import emit

TICK_DT = 0.01      # scripted seconds per manager tick
SEED = 1234         # the global `random` state at the start of a soak
HASH_SEED = "0"     # PYTHONHASHSEED of every child run
PORT = ("gigapaxos_tpu_torch.",)

# modules the soaks import lazily: loaded before the clock is patched in,
# so that it reaches them too
PRELOAD = ("manager", "failure_detection", "obs.tracemerge",
           "reconfiguration.demand", "reconfiguration.placement", "serving",
           "testing.chaos", "testing.cluster", "testing.rc_cluster", "txn")


class ScriptedClock:
    """Stands in for the ``time`` module: ``time``, ``monotonic`` and
    ``perf_counter`` read the scripted instant, ``sleep`` advances it;
    everything else is the real module's."""

    def __init__(self, t0: float = 1_000_000.0):
        self.t = t0

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = time

    def time_ns(self) -> int:
        return int(self.t * 1e9)

    monotonic_ns = perf_counter_ns = time_ns

    def sleep(self, s: float) -> None:
        self.t += max(0.0, float(s))

    def __getattr__(self, name):
        return getattr(_time, name)


_MISSING = object()


class Patches:
    """``setattr`` with ``undo``: the part of pytest's ``MonkeyPatch`` the
    clock needs, for callers without pytest."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name: str, value) -> None:
        old = obj.__dict__.get(name, _MISSING) if isinstance(obj, type) \
            else getattr(obj, name, _MISSING)
        self._saved.append((obj, name, old))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, old = self._saved.pop()
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def patch_clocks(mp, clock: ScriptedClock, prefixes: Sequence[str] = PORT) -> None:
    """``clock`` as the ``time`` module of every loaded module whose name
    starts with one of ``prefixes`` (``mp``: :class:`Patches` or pytest's
    ``MonkeyPatch``)."""
    prefixes = tuple(prefixes)
    for name, mod in list(sys.modules.items()):
        t = getattr(mod, "time", None)
        if name.startswith(prefixes) and (t is _time or isinstance(t, ScriptedClock)):
            mp.setattr(mod, "time", clock)


@contextlib.contextmanager
def scripted(tick_dt: float = TICK_DT, seed: int = SEED,
             prefixes: Sequence[str] = PORT, managers: Sequence[type] = (),
             on_close: Optional[Callable] = None):
    """A fresh :class:`ScriptedClock` in the port's modules (and those of
    ``prefixes``) for the duration, advanced by ``tick_dt`` per tick of
    the port's ``PaxosManager`` and of every class in ``managers``;
    ``on_close(manager)`` runs as each of them closes.  Clears the port's
    ``Config`` on exit."""
    from ..manager import PaxosManager
    from ..utils.config import Config

    for m in PRELOAD:
        importlib.import_module(f"gigapaxos_tpu_torch.{m}")
    mp = Patches()
    clock = ScriptedClock()
    try:
        patch_clocks(mp, clock, tuple(PORT) + tuple(prefixes))
        for mgr in (PaxosManager, *managers):
            for name in ("tick", "tick_host"):
                orig = getattr(mgr, name)

                def advance(self, *a, _orig=orig, **kw):
                    clock.t += tick_dt
                    return _orig(self, *a, **kw)

                mp.setattr(mgr, name, advance)
            if on_close is not None:
                orig_close = mgr.close

                def close(self, *a, _orig=orig_close, **kw):
                    on_close(self)
                    return _orig(self, *a, **kw)

                mp.setattr(mgr, "close", close)
        saved = random.getstate()
        random.seed(seed)
        try:
            yield clock
        finally:
            random.setstate(saved)
    finally:
        mp.undo()
        Config.clear()


@contextlib.contextmanager
def count_steps():
    """Count the stepped clusters' steps and the managers' ticks for the
    duration: yields ``{"cluster_steps": n, "manager_ticks": n}``."""
    from ..manager import PaxosManager
    from .rc_cluster import ReconfigurableCluster

    counts = {"cluster_steps": 0, "manager_ticks": 0}
    mp = Patches()
    try:
        for cls, name, key in ((ReconfigurableCluster, "step", "cluster_steps"),
                               (PaxosManager, "tick", "manager_ticks"),
                               (PaxosManager, "tick_host", "manager_ticks")):
            orig = getattr(cls, name)

            def counted(*a, _orig=orig, _key=key, **k):
                counts[_key] += 1
                return _orig(*a, **k)

            mp.setattr(cls, name, counted)
        yield counts
    finally:
        mp.undo()


def run_scripted(family: str, seed: int, device=None, config=None, **kw) -> Dict:
    """``testing.chaos.run_<family>(seed, device=device, **kw)`` on a fresh
    scripted clock, with the settings ``config`` ({name: value}) set first
    (the clock clears them when it ends): the soak's result, the kernel
    launches (counted from 0), manager ticks and cluster steps it took, and
    its seconds on the host's clock."""
    from ..ops import engine as te
    from ..utils.config import Config
    from . import chaos

    fn = getattr(chaos, f"run_{family}")
    te.reset_launch_counts()
    t0 = _time.perf_counter()
    with scripted() as clock, count_steps() as counts:
        for k, v in (config or {}).items():
            Config.set(k, str(v))
        result = fn(seed, device=device, **kw)
        scripted_s = clock.t - 1_000_000.0
    return {"family": family, "seed": seed, "result": result,
            "launches": dict(te.LAUNCHES), **counts,
            "scripted_s": scripted_s, "seconds": _time.perf_counter() - t0}


def run_in_child(family: str, seed: int, device: str, timeout: float = 900,
                 **kw) -> Dict:
    """:func:`run_scripted` in a fresh interpreter with ``PYTHONHASHSEED``
    pinned; returns its output, raises with the child's output when the
    soak failed (a ``SoakDivergence`` included)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    arg = json.dumps({"family": family, "seed": seed, "device": device, "kw": kw})
    r = subprocess.run([sys.executable, "-m", "gigapaxos_tpu_torch.testing.clock", arg],
                       env=env, capture_output=True, text=True, timeout=timeout)
    lines = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"scripted {family} {seed} on {device}: rc {r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    spec = json.loads((sys.argv[1:] if argv is None else argv)[0])
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        raise SystemExit(f"run with PYTHONHASHSEED={HASH_SEED}: a soak's schedule "
                         "follows the string hash")
    out = run_scripted(spec["family"], int(spec["seed"]), device=spec.get("device"),
                       **spec.get("kw", {}))
    emit("RESULT " + json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
