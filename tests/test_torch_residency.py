"""Group lifecycle on the port against the JAX package: residency paths.

Two layers:

* **the kernel path, emulated on the CPU.**  ``gp_lifecycle_launch``
  (``csrc/gp_lifecycle.cu``) is replaced by a host emulation that reads
  the very ``ctypes`` argument block the CUDA launcher would get and
  works on the raw host memory behind its pointers; the dispatch
  predicate is made to treat CPU tensors as on the card.  So the
  dispatcher, the wrapper's checks, its staging upload, its pointer
  table and its launch count all run, and every op is held against its
  plain version bit for bit, with the input state unchanged and the
  untouched leaves the input's own tensors.
* **the manager's lifecycle paths against the JAX manager**: the JAX
  package's scenarios (batched vs per-name unpause, the non-quiescent
  record, hibernate/restore, the checkpoint jump of a straggler and its
  negative, a 512-name wake burst, and the density procedure at a small
  size) re-run on both packages from the same seeds, the port once on
  the plain path and once on the emulated kernel path.  Every engine
  leaf, app state, reply and residency count must be equal (zero
  tolerance).
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from gigapaxos_tpu.manager import PaxosManager as JManager
from gigapaxos_tpu.models import StatefulAdderApp as JAdder
from gigapaxos_tpu.models.apps import HashChainApp as JHashChain
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.testing.cluster import ManagerCluster as JCluster
from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.manager import PaxosManager as TManager
from gigapaxos_tpu_torch.models import StatefulAdderApp as TAdder
from gigapaxos_tpu_torch.models.apps import HashChainApp as THashChain
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels
from gigapaxos_tpu_torch.ops import lifecycle as tl
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.testing import density
from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP
from gigapaxos_tpu_torch.testing.cluster import ManagerCluster as TCluster
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

FIELDS = te.EngineState._fields
GW = gp_kernels.GW_LEAVES
NULL = -1
PATHS = ["plain", "kernel"]


@pytest.fixture(autouse=True)
def _clear_torch_config():
    te.reset_launch_counts()
    yield
    TorchConfig.clear()
    te.reset_launch_counts()


# ---------------------------------------------------------------------------
# the kernel path on the CPU
# ---------------------------------------------------------------------------


def _host(ptr: int, shape) -> np.ndarray:
    """An int32 numpy view of ``shape`` over the host memory at ``ptr``."""
    n = int(np.prod(shape))
    assert ptr, "null pointer where the kernel reads or writes"
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr)).reshape(shape)


def _popcount(x: int) -> int:
    return bin(int(x) & 0xFFFFFFFF).count("1")


def _emulated_launch(a) -> None:
    """``gp_lifecycle_launch`` on host memory: the copy pass over every
    leaf with an output pointer, then the row pass (extract: the gather
    alone), each row as the CUDA kernel writes it."""
    G, W, N, op = int(a.G), int(a.W), int(a.N), int(a.op)
    assert 0 <= op <= gp_kernels.OP_EXTRACT and G >= 1 and W >= 1 and N >= 0
    shape = lambda f, rows: (rows, W) if f in GW else (rows,)
    L = {f: i for i, f in enumerate(FIELDS)}
    s = {f: _host(a.st_in[L[f]], shape(f, G)) for f in FIELDS}
    o = {f: _host(a.st_out[L[f]], shape(f, G)) for f in FIELDS if a.st_out[L[f]]}
    if op != gp_kernels.OP_EXTRACT:
        for f, out in o.items():
            out[...] = s[f]
    elif o:
        raise AssertionError("extract got state outputs")
    if N == 0:
        return
    i = {f: _host(a.inp[L[f]], shape(f, N)) for f in FIELDS if a.inp[L[f]]}
    idx = _host(a.idx, (N,)).astype(np.int64)
    assert len(set(idx.tolist())) == N and idx.min() >= 0 and idx.max() < G
    if op == gp_kernels.OP_EXTRACT:
        for f in FIELDS:
            _host(a.rows_out[L[f]], shape(f, N))[...] = s[f][idx]
        return
    for n, g in enumerate(idx):
        if op == gp_kernels.OP_CREATE:
            coord0 = int(i["bal"][n])
            me = coord0 == int(a.my_id)
            for f in GW:
                o[f][g] = NULL
            row = dict(
                member_mask=i["member_mask"][n],
                majority=_popcount(i["member_mask"][n]) // 2 + 1,
                version=i["version"][n], stopped=0, tag=i["tag"][n],
                bal=coord0, exec_slot=0, app_hash=0, n_execd=0,
                c_phase=te.ACTIVE if me else te.IDLE,
                c_bal=coord0 if me else NULL, c_next_slot=0,
            )
        elif op == gp_kernels.OP_KILL:
            row = dict(member_mask=0, majority=2 ** 30, stopped=0, tag=0,
                       bal=NULL, c_phase=te.IDLE, c_bal=NULL)
        elif op == gp_kernels.OP_JUMP:
            ne = int(i["exec_slot"][n])
            for lane in range(W):
                a_s, d_s = int(s["acc_slot"][g, lane]), int(s["dec_slot"][g, lane])
                keep_a = a_s != NULL and a_s >= ne
                keep_d = d_s != NULL and d_s >= ne
                for f in ("acc_bal", "acc_vid", "acc_slot"):
                    o[f][g, lane] = s[f][g, lane] if keep_a else NULL
                for f in ("dec_vid", "dec_slot"):
                    o[f][g, lane] = s[f][g, lane] if keep_d else NULL
            o["c_prop_vid"][g] = NULL
            o["c_prop_slot"][g] = NULL
            row = dict(
                bal=max(int(s["bal"][g]), int(i["bal"][n])), exec_slot=ne,
                app_hash=i["app_hash"][n], n_execd=i["n_execd"][n],
                stopped=i["stopped"][n], c_phase=te.IDLE, c_bal=NULL,
                c_next_slot=ne,
            )
        elif op == gp_kernels.OP_RESTORE_PAUSED:
            for f in ("acc_bal", "acc_vid", "acc_slot", "dec_vid", "dec_slot"):
                o[f][g] = i[f][n]
            row = dict(exec_slot=i["exec_slot"][n], bal=i["bal"][n],
                       app_hash=i["app_hash"][n], n_execd=i["n_execd"][n],
                       c_next_slot=i["exec_slot"][n])
        else:  # OP_RESTORE_ROWS
            row = {}
            for f in FIELDS:
                if f in GW:
                    o[f][g] = i[f][n]
                else:
                    row[f] = i[f][n]
        for f, v in row.items():
            o[f][g] = np.int32(v)


def _emulate_lifecycle(monkeypatch) -> None:
    """Route CPU tensors down the lifecycle kernel path, with the CUDA
    launch replaced by :func:`_emulated_launch`."""
    monkeypatch.setattr(te, "on_card", lambda t: True)
    monkeypatch.setattr(gp_kernels, "_lifecycle_launch", _emulated_launch)


def _emulate_all(monkeypatch) -> None:
    """The whole kernel path on the CPU: the engine's wrappers as
    ``test_torch_spmd`` emulates them, plus the lifecycle launch."""
    from test_torch_spmd import _emulate_kernels

    _emulate_kernels(monkeypatch)
    monkeypatch.setattr(gp_kernels, "_lifecycle_launch", _emulated_launch)


def _random_state(rng, G, W):
    d = {}
    for f in FIELDS:
        shape = (G, W) if f in GW else (G,)
        d[f] = rng.integers(-1, 400, size=shape).astype(np.int32)
    # NULL lanes, negative words, full 32-bit masks
    d["acc_slot"][rng.random((G, W)) < 0.3] = NULL
    d["dec_slot"][rng.random((G, W)) < 0.3] = NULL
    d["app_hash"] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G).astype(np.int32)
    return te.EngineState(**{k: torch.as_tensor(v) for k, v in d.items()})


def _op_args(op, rng, G, W, N, state):
    idx = rng.choice(G, size=N, replace=False)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    nw = lambda: rng.integers(-1, 500, size=(N, W))
    if op == "create":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[: N // 2] = rng.integers(1, 32, size=N // 2)
        coord0 = tl.initial_coordinator(idx, masks & 31)
        return (idx, masks, coord0), dict(my_id=int(coord0[0]), version=n(0, 4),
                                          tag=n(1, 1000))
    if op == "create_scalars":
        masks = rng.integers(1, 32, size=N)
        return (idx, masks, tl.initial_coordinator(idx, masks)), dict(my_id=1)
    if op == "kill":
        return (idx,), {}
    if op == "jump":
        return (idx, n(0, 500), n(0, 500), n(-5, 5), n(0, 9), n(0, 2)), {}
    if op == "restore_paused":
        return (idx, n(0, 500), n(0, 500), n(-5, 5), n(0, 9)) + tuple(
            nw() for _ in range(5)), {}
    if op == "extract":
        return (idx,), {}
    rows = tl.extract_rows_plain(_random_state(rng, G, W), rng.choice(G, N, replace=False))
    return (idx, rows), {}


_OPS = {
    "create": ("create_groups", "gp_create_groups"),
    "create_scalars": ("create_groups", "gp_create_groups"),
    "kill": ("kill_groups", "gp_kill_groups"),
    "jump": ("jump_rows", "gp_jump_rows"),
    "restore_paused": ("restore_paused_rows", "gp_restore_paused_rows"),
    "restore_rows": ("restore_rows", "gp_restore_rows"),
    "extract": ("extract_rows", "gp_extract_rows"),
}


@pytest.mark.parametrize("N", [1, 7, 40])
@pytest.mark.parametrize("op", sorted(_OPS))
def test_kernel_path_matches_plain(monkeypatch, op, N):
    G, W = 41, 8
    rng = np.random.default_rng(100 * sorted(_OPS).index(op) + N)
    state = _random_state(rng, G, W)
    keep = [x.clone() for x in state]
    args, kw = _op_args(op, rng, G, W, N, state)
    fn, kname = _OPS[op]
    plain = getattr(tl, fn + "_plain")(state, *args, **kw)
    _emulate_lifecycle(monkeypatch)
    te.reset_launch_counts()
    got = getattr(tl, fn)(state, *args, **kw)
    assert te.LAUNCHES[kname] == 1
    assert sum(te.LAUNCHES.values()) == 1
    for a, b in zip(keep, state):  # the input state never changes
        assert torch.equal(a, b)
    for f, g, p in zip(FIELDS, got, plain):
        assert g.dtype == torch.int32 and torch.equal(g, p), f
    if op == "extract":
        return
    touched = set(gp_kernels.TOUCHED[kname])
    for f in FIELDS:
        new, old = getattr(got, f), getattr(state, f)
        if f in touched:  # a fresh tensor, sharing no storage
            assert new is not old and new.data_ptr() not in {x.data_ptr() for x in state}
        else:  # untouched: the input's own tensor
            assert new is old, f
    # every leaf the plain version changes is a leaf the kernel touches
    changed = {f for f, a, b in zip(FIELDS, plain, state) if not torch.equal(a, b)}
    assert changed <= touched


@pytest.mark.parametrize("op", sorted(_OPS))
def test_kernel_path_refuses_bad_rows(monkeypatch, op):
    G, W = 16, 8
    rng = np.random.default_rng(5)
    state = _random_state(rng, G, W)
    args, kw = _op_args(op, rng, G, W, 4, state)
    fn, kname = _OPS[op]
    _emulate_lifecycle(monkeypatch)
    te.reset_launch_counts()
    call = lambda idx: getattr(tl, fn)(state, idx, *args[1:], **kw)
    for bad, err in (([0, 1, 2, G], "outside"), ([0, -1, 2, 3], "outside"),
                     ([[0, 1], [2, 3]], "1-D")):
        with pytest.raises(ValueError, match=err):
            call(np.array(bad))
    with pytest.raises(TypeError):
        call(np.array([0.0, 1.0, 2.0, 3.0]))
    assert te.LAUNCHES[kname] == 0  # nothing launched on a refused batch
    repeated = np.array([3, 5, 3, 1])
    if op != "kill":
        with pytest.raises(ValueError, match="duplicate"):
            call(repeated)
        assert te.LAUNCHES[kname] == 0
        return
    # kill writes constants only: a repeated row gives the plain result
    want = tl.kill_groups_plain(state, repeated)
    for f, a, b in zip(FIELDS, call(repeated), want):
        assert torch.equal(a, b), f
    assert te.LAUNCHES[kname] == 1


def test_kernel_path_empty_batch_and_device_inputs(monkeypatch):
    """N=0 copies the touched leaves and writes no row; inputs that are
    already int32 tensors on the state's device are read in place."""
    G, W = 16, 8
    rng = np.random.default_rng(6)
    state = _random_state(rng, G, W)
    _emulate_lifecycle(monkeypatch)
    empty = tl.kill_groups(state, np.zeros(0, np.int64))
    for f, a, b in zip(FIELDS, empty, state):
        assert torch.equal(a, b), f
    assert empty.bal is not state.bal and empty.exec_slot is state.exec_slot
    idx = np.array([3, 9])
    host = (np.array([40, 41]), np.array([7, 8]), np.array([1, 2]),
            np.array([3, 4]), np.array([0, 1]))
    dev = tuple(torch.as_tensor(x.astype(np.int32)) for x in host)
    want = tl.jump_rows_plain(state, idx, *host)
    for f, a, b in zip(FIELDS, tl.jump_rows(state, idx, *dev), want):
        assert torch.equal(a, b), f
    with pytest.raises(TypeError, match="dtype"):
        tl.jump_rows(state, idx, torch.as_tensor(host[0]), *dev[1:])


def test_plain_and_kernel_dispatch_without_a_card():
    """CPU tensors take the plain version (no launch); a wrapper refuses
    CPU tensors outright."""
    state = _random_state(np.random.default_rng(1), 8, 8)
    te.reset_launch_counts()
    out = tl.kill_groups(state, [1, 2])
    assert sum(te.LAUNCHES.values()) == 0
    assert int(out.bal[1]) == NULL
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernels.kill_groups(state, [1, 2])


# ---------------------------------------------------------------------------
# the manager's lifecycle paths against the JAX manager
# ---------------------------------------------------------------------------


def _path(monkeypatch, path):
    if path == "kernel":
        _emulate_all(monkeypatch)
    te.reset_launch_counts()


def _leaves(m):
    return {f: np.asarray(m._np(f)) for f in m.state._fields}


def _same_manager(mj, mt, what):
    lj, lt = _leaves(mj), _leaves(mt)
    for f in lj:
        np.testing.assert_array_equal(lj[f], lt[f], err_msg=f"{what}: {f}")
    assert mj.names == mt.names, what
    assert getattr(mj.app, "totals", None) == getattr(mt.app, "totals", None), what
    assert getattr(mj.app, "state", None) == getattr(mt.app, "state", None), what
    assert {r: list(q) for r, q in mj.queues.items() if q} == \
           {r: list(q) for r, q in mt.queues.items() if q}, what
    assert mj._needs_state == mt._needs_state, what
    np.testing.assert_array_equal(mj.app_exec_slot, mt.app_exec_slot, err_msg=what)
    rj, rt = mj.residency_stats(), mt.residency_stats()
    for k in ("active_names", "paused_names", "paused_in_memory", "paused_on_disk"):
        assert rj[k] == rt[k], (what, k, rj[k], rt[k])


UNPAUSE_NAMES = [f"par{i}" for i in range(8)]


def _ticks(m, n=3):
    for _ in range(n):
        vec, _st = m.publish_snapshot()
        m.tick_host(np.stack([vec]), np.array([True]))


def _single(pkg, tmp_path, tag, G=64, W=8):
    if pkg == "jax":
        return JManager(0, JAdder(), JConfig(G, W, 4, 1),
                        log_dir=str(tmp_path / f"jax-{tag}"),
                        checkpoint_every=10 ** 9, sync_journal=False)
    return TManager(0, TAdder(), TConfig(G, W, 4, 1),
                    log_dir=str(tmp_path / f"torch-{tag}"),
                    checkpoint_every=10 ** 9, sync_journal=False, device="cpu")


def _drive_and_sleep(m):
    m.create_paxos_batch(UNPAUSE_NAMES, [0])
    for rnd in range(3):
        for i, nm in enumerate(UNPAUSE_NAMES[:6]):
            m.propose(nm, str(10 + rnd + i))
        _ticks(m, 3)
    _ticks(m, 4)
    m.propose(UNPAUSE_NAMES[6], "777")  # in flight at the pause
    m.propose(UNPAUSE_NAMES[7], "888")
    assert m.hibernate_batch(UNPAUSE_NAMES) == len(UNPAUSE_NAMES)
    assert len(m.names) == 0


@pytest.mark.parametrize("path", PATHS)
def test_batched_resume_matches_jax(monkeypatch, tmp_path, path):
    """``tests/test_batched_unpause.py`` (batched resume bit-exact vs the
    per-name loop) on both packages."""
    _path(monkeypatch, path)
    ms = {(pkg, arm): _single(pkg, tmp_path, arm)
          for pkg in ("jax", "torch") for arm in ("seq", "bat")}
    try:
        for m in ms.values():
            _drive_and_sleep(m)
        for arm in ("seq", "bat"):
            _same_manager(ms["jax", arm], ms["torch", arm], f"asleep {arm}")
        for pkg in ("jax", "torch"):
            te.reset_launch_counts()
            for nm in UNPAUSE_NAMES:
                assert ms[pkg, "seq"].restore(nm)
            if pkg == "torch" and path == "kernel":
                assert te.LAUNCHES["gp_create_groups"] == len(UNPAUSE_NAMES)
                assert te.LAUNCHES["gp_restore_paused_rows"] == len(UNPAUSE_NAMES)
            te.reset_launch_counts()
            assert ms[pkg, "bat"].restore_batch(UNPAUSE_NAMES) == len(UNPAUSE_NAMES)
            if pkg == "torch" and path == "kernel":
                assert te.LAUNCHES["gp_create_groups"] == 1
                assert te.LAUNCHES["gp_restore_paused_rows"] == 1
        for arm in ("seq", "bat"):
            _same_manager(ms["jax", arm], ms["torch", arm], f"woken {arm}")
        _same_manager(ms["torch", "seq"], ms["torch", "bat"], "torch seq vs bat")
        for m in ms.values():
            _ticks(m, 6)
        for arm in ("seq", "bat"):
            _same_manager(ms["jax", arm], ms["torch", arm], f"ticked {arm}")
        for nm, want in ((UNPAUSE_NAMES[6], 777), (UNPAUSE_NAMES[7], 888)):
            assert ms["torch", "bat"].app.totals.get(nm) == want
    finally:
        for m in ms.values():
            m.close()


@pytest.mark.parametrize("path", PATHS)
def test_nonquiescent_record_matches_jax(monkeypatch, tmp_path, path):
    """``tests/test_batched_unpause.py``'s forced-pause record whose
    ``app_exec`` lags the frontier: parked in ``_needs_state`` on both
    wake paths, identically on both packages."""
    _path(monkeypatch, path)
    ms = {(pkg, arm): _single(pkg, tmp_path, arm + "23")
          for pkg in ("jax", "torch") for arm in ("seq", "bat")}
    try:
        for m in ms.values():
            m.create_paxos_batch(UNPAUSE_NAMES[:2], [0])
            for _ in range(3):
                m.propose(UNPAUSE_NAMES[0], "5")
                _ticks(m, 3)
            row = m.names[UNPAUSE_NAMES[0]]
            m.app_exec_slot[row] = max(0, int(m.app_exec_slot[row]) - 2)
            assert m.pause_group(UNPAUSE_NAMES[0], 0, force=True) == "ok"
            assert m.pause_group(UNPAUSE_NAMES[1], 0, force=True) == "ok"
        for pkg in ("jax", "torch"):
            assert ms[pkg, "seq"].restore(UNPAUSE_NAMES[0])
            assert ms[pkg, "seq"].restore(UNPAUSE_NAMES[1])
            assert ms[pkg, "bat"].restore_batch(UNPAUSE_NAMES[:2]) == 2
        for arm in ("seq", "bat"):
            _same_manager(ms["jax", arm], ms["torch", arm], arm)
        m = ms["torch", "bat"]
        assert m.names[UNPAUSE_NAMES[0]] in m._needs_state
        assert m.names[UNPAUSE_NAMES[1]] not in m._needs_state
    finally:
        for m in ms.values():
            m.close()


def _cluster(pkg, cfg_args, tmp_path=None, tag=""):
    dirs = None
    if tmp_path is not None:
        dirs = [str(tmp_path / f"{pkg}{tag}{r}") for r in range(cfg_args[3])]
    if pkg == "jax":
        return JCluster(JConfig(*cfg_args), JHashChain, log_dirs=dirs)
    return TCluster(TConfig(*cfg_args), THashChain, log_dirs=dirs, device="cpu")


def _same_cluster(cj, ct, what):
    for i, (mj, mt) in enumerate(zip(cj.managers, ct.managers)):
        _same_manager(mj, mt, f"{what} mgr{i}")
        assert mj.app.n_executed == mt.app.n_executed, (what, i)


def _hibernate_body(c):
    """``tests/test_hibernate.py``'s hibernate/restore scenario; returns
    the app state before and after the sleep."""
    c.create("svc", members=[0, 1, 2])
    for i in range(5):
        c.submit("svc", f"v{i}")
        c.run(4)
    for _ in range(40):
        c.run(1)
        states = {m.app.state.get("svc") for m in c.managers}
        if len(states) == 1 and all(m.app.n_executed.get("svc") == 5
                                    for m in c.managers):
            break
    h0 = c.managers[0].app.state.get("svc")
    for m in c.managers:
        assert m.hibernate("svc")
        assert m.names.get("svc") is None and ("svc", 0) in m.paused
    c.blobs = [m.blob() for m in c.managers]
    c.run(3)
    assert not c.managers[0].hibernate("svc")
    for m in c.managers:
        assert m.restore("svc")
    c.blobs = [m.blob() for m in c.managers]
    c.run(5)
    c.submit("svc", "after")
    for _ in range(60):
        c.run(1)
        if all(m.app.n_executed.get("svc") == 6 for m in c.managers):
            break
    assert c.managers[0].restore("svc") and not c.managers[0].restore("nope")
    return h0, c.managers[0].app.state.get("svc")


@pytest.mark.parametrize("path", PATHS)
def test_hibernate_batch_repeated_name_matches_jax(monkeypatch, tmp_path, path):
    """``hibernate_batch`` given a name twice: the JAX manager puts it to
    sleep with one kill over a repeated row; the port does the same on
    both paths (the kernel's wrapper drops the repeated row), and the
    names wake with their totals."""
    _path(monkeypatch, path)
    ms = {pkg: _single(pkg, tmp_path, "rep") for pkg in ("jax", "torch")}
    names = UNPAUSE_NAMES[:4]
    try:
        for m in ms.values():
            m.create_paxos_batch(names, [0])
            for i, nm in enumerate(names):
                m.propose(nm, str(i + 1))
            _ticks(m, 4)
        te.reset_launch_counts()
        slept = {pkg: m.hibernate_batch(names + names[:2]) for pkg, m in ms.items()}
        assert slept["jax"] == slept["torch"] and len(ms["torch"].names) == 0
        if path == "kernel":
            assert te.LAUNCHES["gp_kill_groups"] == 1
        _same_manager(ms["jax"], ms["torch"], "asleep")
        for m in ms.values():
            assert m.restore_batch(names) == len(names)
            _ticks(m, 3)
        _same_manager(ms["jax"], ms["torch"], "woken")
        assert ms["torch"].app.totals == {nm: i + 1 for i, nm in enumerate(names)}
    finally:
        for m in ms.values():
            m.close()


@pytest.mark.parametrize("path", PATHS)
def test_hibernate_restore_matches_jax(monkeypatch, tmp_path, path):
    """``tests/test_hibernate.py:test_hibernate_restore`` on both packages:
    the same app states before and after the sleep, the same leaves."""
    _path(monkeypatch, path)
    cj = _cluster("jax", (8, 8, 4, 3), tmp_path)
    ct = _cluster("torch", (8, 8, 4, 3), tmp_path)
    try:
        hj = _hibernate_body(cj)
        kills = te.LAUNCHES["gp_kill_groups"]
        ht = _hibernate_body(ct)
        assert hj == ht and hj[0] != hj[1]
        _same_cluster(cj, ct, "after")
        if path == "kernel":
            assert te.LAUNCHES["gp_kill_groups"] - kills == 3
            assert te.LAUNCHES["gp_restore_paused_rows"] == 3
    finally:
        cj.close()
        ct.close()


def _isolate(R, dead):
    d = np.full((R, R), DELIVER)
    d[dead, :] = DROP
    d[:, dead] = DROP
    return d


def _run_until_executed(c, name, vals, entry, delivery=None, max_steps=60):
    done = {}
    for v in vals:
        c.managers[entry].propose(
            name, v, callback=lambda r, resp: done.setdefault(r, resp))
    for _ in range(max_steps):
        if len(done) == len(vals):
            return sorted(done.values())
        c.step_all(delivery=delivery)
    raise AssertionError(f"{len(done)}/{len(vals)} executed")


def _jump_body(pkg, tmp_path):
    """``tests/test_state_transfer.py``'s straggler: node 2 dies, peers
    run far past its ring, node 2 restarts from its journal and adopts a
    donor's frontier.  Returns the cluster and the replies."""
    cfg = (8, 8, 4, 3)
    c = _cluster(pkg, cfg, tmp_path, "st")
    c.create("svc", members=[0, 1, 2])
    row = c.managers[0].names["svc"]
    replies = [_run_until_executed(c, "svc", [f"a{i}" for i in range(4)], 0)]
    c.managers[2].close()
    dead = _isolate(3, 2)
    for batch in range(6):
        replies.append(_run_until_executed(
            c, "svc", [f"b{batch}-{i}" for i in range(10)], 0, delivery=dead))
    live = int(c.managers[0]._np("exec_slot")[row])
    assert live - int(c.managers[2]._np("exec_slot")[row]) > 5 * 8
    log_dir = str(tmp_path / f"{pkg}st2")
    if pkg == "jax":
        c.managers[2] = JManager(2, JHashChain(), JConfig(*cfg), log_dir=log_dir)
    else:
        c.managers[2] = TManager(2, THashChain(), TConfig(*cfg), log_dir=log_dir,
                                 device="cpu")
    c.blobs[2] = c.managers[2].blob()
    for _ in range(80):
        c.step_all()
        if int(c.managers[2]._np("exec_slot")[row]) >= live:
            break
    h = [int(m._np("app_hash")[row]) for m in c.managers]
    assert h[0] == h[1] == h[2], h
    replies.append(_run_until_executed(c, "svc", ["post-1", "post-2"], 2))
    return c, replies


@pytest.mark.parametrize("path", PATHS)
def test_checkpoint_jump_matches_jax(monkeypatch, tmp_path, path):
    """``tests/test_state_transfer.py:test_dead_replica_rejoins_via_checkpoint_jump``
    (batching off) on both packages: the same replies, leaves and app
    states; on the kernel path the jump launched ``gp_jump_rows``."""
    JaxConfig.set("BATCHING_ENABLED", "false")
    TorchConfig.set("BATCHING_ENABLED", "false")
    _path(monkeypatch, path)
    cj = ct = None
    try:
        cj, rj = _jump_body("jax", tmp_path)
        ct, rt = _jump_body("torch", tmp_path)
        assert rj == rt
        _same_cluster(cj, ct, "rejoined")
        apps = [m.app for m in ct.managers]
        assert apps[2].state["svc"] == apps[0].state["svc"]
        if path == "kernel":
            assert te.LAUNCHES["gp_jump_rows"] >= 1
    finally:
        for c in (cj, ct):
            if c is not None:
                for m in c.managers:
                    m.close()


@pytest.mark.parametrize("path", PATHS)
def test_no_jump_within_window_matches_jax(monkeypatch, path):
    """``tests/test_state_transfer.py:test_jump_not_triggered_within_window``
    on both packages: rings close a short gap, no state request, no jump."""
    _path(monkeypatch, path)
    out = {}
    for pkg in ("jax", "torch"):
        c = _cluster(pkg, (4, 16, 4, 3))
        c.create("svc", members=[0, 1, 2])
        r = _run_until_executed(c, "svc", ["x1", "x2", "x3"], 0,
                                delivery=_isolate(3, 2))
        assert c.managers[2]._last_state_req == {}
        for _ in range(20):
            c.step_all()
        assert c.managers[2]._last_state_req == {}
        out[pkg] = (c, r)
    try:
        assert out["jax"][1] == out["torch"][1]
        _same_cluster(out["jax"][0], out["torch"][0], "settled")
        assert te.LAUNCHES["gp_jump_rows"] == 0
    finally:
        for c, _r in out.values():
            c.close()


@pytest.mark.parametrize("path", PATHS)
def test_wake_burst_matches_jax(monkeypatch, tmp_path, path):
    """``tests/test_density_scale.py:test_batched_wake_burst_matches_sequential_at_scale``
    (G=2048, 1,024 names, a 512-name burst) on both packages."""
    JaxConfig.set("PACKED_SPILL", "true")
    TorchConfig.set("PACKED_SPILL", "true")
    _path(monkeypatch, path)
    names = [f"b{i:04d}" for i in range(1024)]
    burst = names[:512]
    ms = {pkg: _single(pkg, tmp_path, "burst", G=2048, W=8)
          for pkg in ("jax", "torch")}
    try:
        for pkg, m in ms.items():
            m.create_paxos_batch(names, [0])
            for i, nm in enumerate(names[:128]):
                m.propose(nm, str(i + 1))
            _ticks(m, 6)
            assert m.hibernate_batch(names) == len(names)
            assert m.restore_batch(burst) == len(burst)
            assert m.hibernate_batch(burst) == len(burst)
            for nm in burst:
                assert m.restore(nm)
            _ticks(m, 4)
            assert set(m.names) == set(burst)
        _same_manager(ms["jax"], ms["torch"], "burst")
        want = {nm: i + 1 for i, nm in enumerate(names[:128])}
        for nm in burst:
            assert ms["torch"].app.totals.get(nm, 0) == want.get(nm, 0)
        if path == "kernel":
            assert te.LAUNCHES["gp_create_groups"] == 1 + 1 + len(burst)
            assert te.LAUNCHES["gp_kill_groups"] == 2
    finally:
        for m in ms.values():
            m.close()


DENSITY_SMALL = dict(names=3000, rows=384, window=8, boot_chunk=256, burst=96,
                     per_name_burst=48, hot_pct=4.0, rounds=4, round_requests=64)


@pytest.mark.parametrize("path", PATHS)
def test_density_procedure_matches_jax(monkeypatch, tmp_path, path):
    """:func:`testing.density.run_density` at a small size: the JAX manager
    (injected) and the port's own manager run the same procedure from
    the same seed to the same residency, replies and spill-store facts;
    every request is answered, and on the kernel path every phase
    launched its lifecycle kernels."""
    JaxConfig.set("PACKED_SPILL", "true")
    jm = JManager(0, JAdder(), JConfig(DENSITY_SMALL["rows"], 8, 4, 1),
                  log_dir=str(tmp_path / "jax-density"),
                  checkpoint_every=10 ** 9, sync_journal=False)
    try:
        rj = density.run_density(**DENSITY_SMALL, manager=jm)
    finally:
        jm.close()
    _path(monkeypatch, path)
    rt = density.run_density(**DENSITY_SMALL, device="cpu",
                             log_dir=str(tmp_path / "torch-density"))
    for key in ("residency_end", "hot_set"):
        assert rj[key] == rt[key], key
    for key in ("requests", "replies", "names_woken"):
        assert rj["churn"][key] == rt["churn"][key], key
    assert rt["churn"]["replies"] == rt["churn"]["requests"] > 0
    for key in ("kind", "live_records", "dead_records", "segments"):
        assert rj["store"][key] == rt["store"][key], key
    res = rt["residency_end"]
    assert res["active_names"] + res["paused_names"] == DENSITY_SMALL["names"]
    assert rt["ablation"]["per_name_names"] == DENSITY_SMALL["per_name_burst"]
    if path == "kernel":
        n_chunks = -(-DENSITY_SMALL["names"] // DENSITY_SMALL["boot_chunk"])
        L = rt["launches"]
        assert L["boot"] == {"gp_create_groups": n_chunks, "gp_kill_groups": n_chunks}
        assert L["wake_per_name"]["gp_create_groups"] == DENSITY_SMALL["per_name_burst"]
        assert L["wake_per_name"]["gp_restore_paused_rows"] == DENSITY_SMALL["per_name_burst"]
        assert L["wake_batched"] == {"gp_create_groups": 1,
                                     "gp_restore_paused_rows": 1}
        assert L["churn"]["gp_step"] > 0 and L["churn"]["gp_kill_groups"] > 0
    else:
        assert all(not v for v in rt["launches"].values())
    assert os.path.isdir(str(tmp_path / "torch-density"))
