"""The chaos soaks of both packages on a scripted clock.

A soak's protocol timers (task retransmits, READY audits, redrops,
failure detection) and its settle deadlines read ``time.time()``, so on
the wall clock two runs of one seed replay different schedules: a seed
can pass in one run and fail in the next, and the two packages cannot be
compared.  :func:`scripted` replaces the ``time`` module of every loaded
module of both packages with one :class:`ScriptedClock` (the port's
``testing/clock.py``), which advances
by :data:`TICK_DT` each time any manager ticks (``PaxosManager.tick`` and
``tick_host``) and nowhere else, and seeds the global ``random`` state
(node-minted request ids draw from it).  A soak run inside it is a pure
function of its seed and arguments.

Every manager that closes inside it leaves a snapshot in the clock's
``closed`` list (:func:`manager_snapshot`): the parity tests compare the
two packages' snapshots beside the soaks' result dictionaries.

The schedule also depends on the iteration order of sets of name strings,
which follows Python's per-process string hash.  :func:`in_child` runs a
soak (or a parity pair) in a fresh interpreter with ``PYTHONHASHSEED``
pinned, so a pinned seed replays one schedule on every run.
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

if __name__ == "__main__":
    # a child run: JAX on the CPU before anything imports it
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

# imported before the clock is patched in, so that it reaches them too
# (the soaks import these lazily)
import gigapaxos_tpu.failure_detection  # noqa: F401
import gigapaxos_tpu.manager as j_manager
import gigapaxos_tpu.obs.tracemerge  # noqa: F401
import gigapaxos_tpu.reconfiguration.demand  # noqa: F401
import gigapaxos_tpu.reconfiguration.placement  # noqa: F401
import gigapaxos_tpu.serving  # noqa: F401
import gigapaxos_tpu.testing.chaos as j_chaos
import gigapaxos_tpu.testing.cluster  # noqa: F401
import gigapaxos_tpu.txn  # noqa: F401
import gigapaxos_tpu_torch.manager  # noqa: F401
import gigapaxos_tpu_torch.obs.tracemerge  # noqa: F401
import gigapaxos_tpu_torch.reconfiguration.placement  # noqa: F401
import gigapaxos_tpu_torch.serving  # noqa: F401
import gigapaxos_tpu_torch.testing.chaos as t_chaos
import gigapaxos_tpu_torch.testing.cluster  # noqa: F401
import gigapaxos_tpu_torch.txn  # noqa: F401
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig
from gigapaxos_tpu_torch.testing import clock as clock_mod
from gigapaxos_tpu_torch.testing.clock import HASH_SEED, SEED, TICK_DT  # noqa: F401

# each package's soaks, config and engine shape; the port on the CPU
JAX = {"chaos": j_chaos, "Config": JaxConfig, "EngineConfig": JConfig, "kw": {}}
PORT = {"chaos": t_chaos, "Config": TorchConfig, "EngineConfig": TConfig,
        "kw": {"device": "cpu"}}


@contextlib.contextmanager
def scripted():
    """A fresh scripted clock in both packages for the duration (the
    port's :func:`gigapaxos_tpu_torch.testing.clock.scripted`, reaching
    the JAX package's modules and manager too); every manager that closes
    leaves its snapshot in ``clock.closed``."""
    closed = []
    try:
        with clock_mod.scripted(
            TICK_DT, SEED, prefixes=("gigapaxos_tpu.",),
            managers=(j_manager.PaxosManager,),
            on_close=lambda m: closed.append(manager_snapshot(m)),
        ) as clock:
            clock.closed = closed
            yield clock
    finally:
        JaxConfig.clear()


def manager_snapshot(m) -> dict:
    """A manager's end state: per hosted name its row, the engine's
    (exec_slot, n_execd, app_hash) and the app's checkpoint."""
    out = {}
    for name, row in sorted(m.names.items()):
        out[name] = (row, int(m._np("exec_slot")[row]),
                     int(m._np("n_execd")[row]), int(m._np("app_hash")[row]),
                     m.app.checkpoint(name))
    return {"id": m.my_id, "names": out}


def soak(pkg, family: str, seed: int, config=None, **kw):
    """``run_<family>`` of ``pkg`` (JAX or PORT) at ``seed`` on a fresh
    scripted clock, with the settings ``config`` set first (the soak
    clears them when it ends); engine shapes in ``kw`` are (G, W, K, R)
    tuples."""
    for key in ("ar_cfg", "rc_cfg"):
        if isinstance(kw.get(key), tuple):
            kw[key] = pkg["EngineConfig"](*kw[key])
    fn = getattr(pkg["chaos"], f"run_{family}")
    with scripted() as clock:
        for k, v in (config or {}).items():
            pkg["Config"].set(k, str(v))
        out = fn(seed, **kw, **pkg["kw"])
    return out, clock.closed


def parity(family: str, seed: int, **kw):
    """The soak on both packages (each soak's own end-state audit runs
    inside it): their result dictionaries, and the end states of their
    managers as they closed, must be equal."""
    port, port_end = soak(PORT, family, seed, **dict(kw))
    ref, ref_end = soak(JAX, family, seed, **dict(kw))
    assert port == ref, (port, ref)
    assert len(port_end) == len(ref_end) > 0
    for a, b in zip(port_end, ref_end):
        assert a == b, (a, b)
    return port



def child(spec: dict) -> subprocess.Popen:
    """A fresh interpreter with ``PYTHONHASHSEED`` pinned running
    ``spec`` (:func:`_child`); read it with :func:`child_result`."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), json.dumps(spec)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def child_result(proc: subprocess.Popen, what: str, timeout: float = 900):
    """The ``RESULT`` of a :func:`child`; raises with its output when it
    failed."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(
            f"{what}: rc {proc.returncode}\n{stdout[-3000:]}\n{stderr[-6000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def in_child(mode: str, family: str, seed: int, timeout: float = 900, **kw):
    """``soak(PORT, ...)`` (``mode="port"``) or ``parity(...)``
    (``mode="parity"``) in a fresh interpreter with ``PYTHONHASHSEED``
    pinned; returns the result dictionary, raises with the child's output
    when its soak or comparison failed."""
    proc = child({"mode": mode, "family": family, "seed": seed, "kw": kw})
    return child_result(proc, f"{mode} {family} {seed}", timeout)


def sweep(pkg: str, argv: list) -> dict:
    """One package's chaos sweep (``"port"``: ``testing/chaos_sweep.py``
    on the CPU; ``"jax"``: ``scripts/chaos_sweep.py``, unedited) over
    ``argv`` on a fresh scripted clock: its exit code and its artifact."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "sweep.json")
        if pkg == "port":
            from gigapaxos_tpu_torch.testing import chaos_sweep

            with scripted():
                rc = chaos_sweep.main(argv + ["--device", "cpu", "--out", out])
        else:
            path = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "scripts", "chaos_sweep.py")
            spec = importlib.util.spec_from_file_location("chaos_sweep_ref", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            saved, sys.argv = sys.argv, [path] + argv + ["--out", out]
            rc = 0
            try:
                with scripted():
                    mod.main()
            except SystemExit as e:
                rc = e.code
            finally:
                sys.argv = saved
        with open(out) as f:
            return {"rc": rc, "doc": json.load(f)}


def _child(arg: str) -> None:
    spec = json.loads(arg)
    if spec["mode"] == "sweep":
        print("RESULT " + json.dumps(sweep(spec["pkg"], spec["argv"])), flush=True)
        return
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["kw"].items()}
    if spec["mode"] == "parity":
        out = parity(spec["family"], spec["seed"], **kw)
    else:
        out, _end = soak(PORT, spec["family"], spec["seed"], **kw)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    _child(sys.argv[1])


def fresh(seed: int, repro: str, **kw) -> bool:
    """One discovery soak of the port (``tests/test_chaos.py``'s ``_fresh``
    convention): a hit warns with the reproduce line, or fails under
    ``CHAOS_FRESH_STRICT=1``; returns False when the caller's budgeted
    loop should stop."""
    import warnings

    try:
        # a wedged fresh schedule is a hit too, not a stalled test file
        in_child("port", kw.pop("family", "soak"), seed, timeout=240, **kw)
        return True
    except Exception as e:
        msg = (f"DISCOVERY: fresh-seed soak found a shape at seed={seed} "
               f"(reproduce: {repro}): {str(e)[:400]}")
        if os.environ.get("CHAOS_FRESH_STRICT"):
            raise AssertionError(msg) from e
        warnings.warn(msg)
        return False
