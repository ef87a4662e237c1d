"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

Two sources, each with a plain C interface (no PyTorch headers), so each
builds with ``nvcc`` in seconds:

* ``csrc/gp_step.cu``: ``gp_step`` and ``gp_make_blob`` (the engine);
* ``csrc/gp_lifecycle.cu``: the group-lifecycle row ops (create, kill,
  jump, restore_paused, restore_rows, extract_rows).

Both build at first use, in parallel (one ``nvcc`` per source), into
``<checkout>/build/kernels/`` (listed in ``.gitignore``), named by one
hash over both sources and the flags, and load with ``ctypes``.
Arguments travel as one ``ctypes.Structure`` of device pointers, passed
by address.  The kernels launch on PyTorch's current stream and allocate
nothing: the wrappers here allocate every output with ``torch.empty``,
check device, dtype, shape and contiguity, and raise when the C launcher
returns a nonzero ``cudaGetLastError()``.  Nothing here falls back to the
plain version: a failed build or launch raises.

``nvcc`` is found on ``PATH`` or under ``$CUDA_HOME``/``/usr/local/cuda``.
Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import engine as _engine
from .engine import (
    LAUNCHES,
    EngineConfig,
    EngineState,
    blob_vec_len,
    out_vec_len,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "gp_step": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_lifecycle": os.path.join(_PKG, "csrc", "gp_lifecycle.cu"),
}
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_NLEAF = len(EngineState._fields)
_MAX_W = 32

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# filled by the build: seconds (wall, all sources) and, per source,
# ptxas' resource report
BUILD_INFO: dict = {}


class _StepArgs(ctypes.Structure):
    _fields_ = [
        ("st_in", ctypes.c_void_p * _NLEAF),
        ("st_out", ctypes.c_void_p * _NLEAF),
        ("gathered", ctypes.c_void_p),
        ("heard", ctypes.c_void_p),
        ("req", ctypes.c_void_p),
        ("want", ctypes.c_void_p),
        ("out_vec", ctypes.c_void_p),
        ("blob", ctypes.c_void_p),
        ("heat_in", ctypes.c_void_p),
        ("heat_out", ctypes.c_void_p),
        ("G", ctypes.c_int32),
        ("W", ctypes.c_int32),
        ("K", ctypes.c_int32),
        ("R", ctypes.c_int32),
        ("my_id", ctypes.c_int32),
        ("stacked", ctypes.c_int32),
    ]


class _BlobArgs(ctypes.Structure):
    _fields_ = [
        ("st_in", ctypes.c_void_p * _NLEAF),
        ("blob", ctypes.c_void_p),
        ("G", ctypes.c_int32),
        ("W", ctypes.c_int32),
        ("n_rep", ctypes.c_int32),
    ]


class _LifeArgs(ctypes.Structure):
    """``GpLifeArgs`` of ``csrc/gp_lifecycle.cu``."""

    _fields_ = [
        ("st_in", ctypes.c_void_p * _NLEAF),
        ("st_out", ctypes.c_void_p * _NLEAF),
        ("inp", ctypes.c_void_p * _NLEAF),
        ("rows_out", ctypes.c_void_p * _NLEAF),
        ("idx", ctypes.c_void_p),
        ("G", ctypes.c_int32),
        ("W", ctypes.c_int32),
        ("N", ctypes.c_int32),
        ("op", ctypes.c_int32),
        ("my_id", ctypes.c_int32),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the kernels are built from "
        f"{sorted(SOURCES.values())} at first use and need the CUDA toolkit"
    )


def _so_paths() -> Dict[str, str]:
    """One hash over both sources and the flags names every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        with open(SOURCES[name], "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    d = h.hexdigest()[:16]
    return {name: os.path.join(BUILD_DIR, f"lib{name}-{d}.so")
            for name in SOURCES}


def build(force: bool = False) -> Dict[str, str]:
    """Compile every source for sm_90a, one ``nvcc`` each, all started
    together (cached by the hash unless ``force``); returns {source name:
    shared library path}.  Raises on failure."""
    paths = _so_paths()
    todo = {n: p for n, p in paths.items() if force or not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    failed = []
    for name, (tmp, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: nvcc failed ({p.returncode}):\n{out}\n{err}")
            continue
        os.replace(tmp, todo[name])
        BUILD_INFO.setdefault("ptxas", {})[name] = (out + err).strip()
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return paths


def _bind(name: str, cdll: ctypes.CDLL) -> None:
    if name == "gp_step":
        sizes = {"gp_step_args_size": _StepArgs, "gp_blob_args_size": _BlobArgs}
        launchers = ("gp_step_launch", "gp_make_blob_launch")
    else:
        sizes = {"gp_life_args_size": _LifeArgs}
        launchers = ("gp_lifecycle_launch",)
    for fn in launchers:
        getattr(cdll, fn).restype = ctypes.c_int
        getattr(cdll, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for fn, struct in sizes.items():
        getattr(cdll, fn).restype = ctypes.c_int
        getattr(cdll, fn).argtypes = []
        if getattr(cdll, fn)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{SOURCES[name]}: argument layout mismatch")


def lib(name: str = "gp_step") -> ctypes.CDLL:
    """The bound kernel library of source ``name`` (every source is
    built on the first call)."""
    with _lock:
        if not _libs:
            paths = build()
            loaded = {}
            for n, so in paths.items():
                cdll = ctypes.CDLL(so)
                _bind(n, cdll)
                loaded[n] = cdll
            _libs.update(loaded)
        return _libs[name]


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """bool -> the same storage viewed as uint8 (what the kernel reads)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _state_ptrs(state: EngineState, lead, G: int, W: int, device, what: str):
    ptrs = []
    for name, leaf in zip(EngineState._fields, state):
        shape = lead + ((G,) if leaf.dim() == len(lead) + 1 else (G, W))
        ptrs.append(_check(leaf, f"{what}.{name}", shape, torch.int32, device))
    return ptrs


def _empty_state(state: EngineState) -> EngineState:
    return EngineState(*(torch.empty_like(x) for x in state))


def _launch(fn, args) -> None:
    rc = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


def _check_cfg(cfg: EngineConfig) -> None:
    W = cfg.window
    if W <= 0 or W & (W - 1):
        raise ValueError(f"window must be a power of two, got {W}")
    if W > _MAX_W:
        raise NotImplementedError(
            f"gp_step maps one ring to at most one warp: W={W} > {_MAX_W}"
        )
    if cfg.req_lanes > W:
        raise ValueError(
            f"req_lanes ({cfg.req_lanes}) must not exceed window ({W})"
        )
    if not 1 <= cfg.n_replicas <= 32:
        raise ValueError(f"n_replicas must be in [1, 32], got {cfg.n_replicas}")


def step(state: EngineState, gvec: torch.Tensor, heard: torch.Tensor,
         req_vid: torch.Tensor, want_coord: torch.Tensor, my_id: int,
         cfg: EngineConfig, *, with_blob: bool = True,
         out_state: Optional[EngineState] = None,
         heat: Optional[torch.Tensor] = None,
         heat_out: Optional[torch.Tensor] = None,
         out_vec: Optional[torch.Tensor] = None,
         launch_log: Optional[dict] = None):
    """One ``gp_step`` launch for one replica: returns (state', out_vec
    [M], blob_vec [NB] or None).  ``out_state`` (optional) receives
    state' and must share no storage with ``state``; ``heat`` (optional)
    is read and ``heat_out`` (default: a new tensor; may be ``heat``
    itself) gets ``heat + n_committed + n_admitted``.  ``out_vec``
    (optional) is a preallocated out vector.  ``launch_log``
    (optional) is a caller's own launch counter, bumped beside
    :data:`LAUNCHES` (a manager's per-node count)."""
    _check_cfg(cfg)
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    dev = state.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_step needs CUDA tensors, got {dev}")
    if not 0 <= my_id < R:
        raise ValueError(f"my_id {my_id} outside [0, {R})")
    a = _StepArgs()
    a.st_in[:] = _state_ptrs(state, (), G, W, dev, "state")
    if out_state is None:
        out_state = _empty_state(state)
    a.st_out[:] = _state_ptrs(out_state, (), G, W, dev, "out_state")
    if set(a.st_in) & set(a.st_out):
        raise ValueError("out_state aliases the input state")
    a.gathered = _check(gvec, "gathered", (R, blob_vec_len(cfg)), torch.int32, dev)
    heard = _bytes(heard)
    a.heard = _check(heard, "heard", (R,), torch.uint8, dev)
    a.req = _check(req_vid, "req_vid", (G, K), torch.int32, dev)
    want_coord = _bytes(want_coord)
    a.want = _check(want_coord, "want_coord", (G,), torch.uint8, dev)
    M, NB = out_vec_len(cfg), blob_vec_len(cfg)
    if out_vec is None:
        out_vec = torch.empty((M,), dtype=torch.int32, device=dev)
    a.out_vec = _check(out_vec, "out_vec", (M,), torch.int32, dev)
    blob = None
    if with_blob:
        blob = torch.empty((NB,), dtype=torch.int32, device=dev)
        a.blob = blob.data_ptr()
    if heat is not None:
        a.heat_in = _check(heat, "heat", (G,), torch.int32, dev)
        if heat_out is None:
            heat_out = torch.empty_like(heat)
        a.heat_out = _check(heat_out, "heat_out", (G,), torch.int32, dev)
    a.G, a.W, a.K, a.R, a.my_id, a.stacked = G, W, K, R, int(my_id), 0
    _launch(lib().gp_step_launch, a)
    LAUNCHES["gp_step"] += 1
    if launch_log is not None:
        launch_log["gp_step"] = launch_log.get("gp_step", 0) + 1
    return out_state, out_vec, blob, heat_out


def step_stacked(states: EngineState, blobs: torch.Tensor, heard: torch.Tensor,
                 req_vid: torch.Tensor, want_coord: torch.Tensor,
                 cfg: EngineConfig, *, out_states: Optional[EngineState] = None,
                 out_blobs: Optional[torch.Tensor] = None,
                 out_mat: Optional[torch.Tensor] = None):
    """One ``gp_step`` launch for ALL R replicas (grid.y = replica id):
    stacked ``[R, G, ...]`` states, the ``[R, NB]`` blob matrix as the
    gather, ``heard [R, R]``, ``req [R, G, K]``, ``want [R, G]``.
    Returns (states', out matrix [R, M], blobs' [R, NB] or None)."""
    _check_cfg(cfg)
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    dev = states.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_step needs CUDA tensors, got {dev}")
    a = _StepArgs()
    a.st_in[:] = _state_ptrs(states, (R,), G, W, dev, "states")
    if out_states is None:
        out_states = _empty_state(states)
    a.st_out[:] = _state_ptrs(out_states, (R,), G, W, dev, "out_states")
    if set(a.st_in) & set(a.st_out):
        raise ValueError("out_states alias the input states")
    NB = blob_vec_len(cfg)
    a.gathered = _check(blobs, "blobs", (R, NB), torch.int32, dev)
    heard = _bytes(heard)
    a.heard = _check(heard, "heard", (R, R), torch.uint8, dev)
    a.req = _check(req_vid, "req_vid", (R, G, K), torch.int32, dev)
    want_coord = _bytes(want_coord)
    a.want = _check(want_coord, "want_coord", (R, G), torch.uint8, dev)
    M = out_vec_len(cfg)
    if out_mat is None:
        out_mat = torch.empty((R, M), dtype=torch.int32, device=dev)
    a.out_vec = _check(out_mat, "out_mat", (R, M), torch.int32, dev)
    if out_blobs is not None:
        a.blob = _check(out_blobs, "out_blobs", (R, NB), torch.int32, dev)
        if a.blob == a.gathered:
            raise ValueError("out_blobs aliases the gathered blobs")
    a.G, a.W, a.K, a.R, a.my_id, a.stacked = G, W, K, R, 0, 1
    _launch(lib().gp_step_launch, a)
    LAUNCHES["gp_step"] += 1
    return out_states, out_mat, out_blobs


def make_blob_rows(states: EngineState, n_rep: Optional[int] = None,
                   launch_log: Optional[dict] = None) -> torch.Tensor:
    """``gp_make_blob`` over ``n_rep`` stacked replica states (``None``:
    one unstacked state) -> ``[n_rep, NB]`` (or ``[NB]``)."""
    G, W = (int(x) for x in states.acc_bal.shape[-2:])
    if W <= 0 or W & (W - 1):
        raise ValueError(f"window must be a power of two, got {W}")
    dev = states.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_make_blob needs CUDA tensors, got {dev}")
    lead = () if n_rep is None else (n_rep,)
    a = _BlobArgs()
    a.st_in[:] = _state_ptrs(states, lead, G, W, dev, "state")
    NB = 4 * G + 4 * G * W
    out = torch.empty(lead + (NB,), dtype=torch.int32, device=dev)
    a.blob = out.data_ptr()
    a.G, a.W, a.n_rep = G, W, 1 if n_rep is None else int(n_rep)
    _launch(lib().gp_make_blob_launch, a)
    LAUNCHES["gp_make_blob"] += 1
    if launch_log is not None:
        launch_log["gp_make_blob"] = launch_log.get("gp_make_blob", 0) + 1
    return out


def make_blob_vec(state: EngineState,
                  launch_log: Optional[dict] = None) -> torch.Tensor:
    """``gp_make_blob`` for one replica's state -> ``[NB]``."""
    return make_blob_rows(state, None, launch_log)


# ---------------------------------------------------------------------------
# group lifecycle (csrc/gp_lifecycle.cu)
# ---------------------------------------------------------------------------

# op codes of gp_lifecycle.cu
OP_CREATE, OP_KILL, OP_JUMP, OP_RESTORE_PAUSED, OP_RESTORE_ROWS, OP_EXTRACT = range(6)
_LEAF = {f: i for i, f in enumerate(EngineState._fields)}
GW_LEAVES = frozenset((
    "acc_bal", "acc_vid", "acc_slot", "dec_vid", "dec_slot",
    "c_prop_vid", "c_prop_slot",
))
# the leaves each op writes (every other leaf of its result is the input's)
TOUCHED = {
    "gp_create_groups": EngineState._fields,
    "gp_kill_groups": ("member_mask", "majority", "stopped", "tag", "bal",
                       "c_phase", "c_bal"),
    "gp_jump_rows": ("stopped", "bal", "exec_slot", "acc_bal", "acc_vid",
                     "acc_slot", "dec_vid", "dec_slot", "app_hash", "n_execd",
                     "c_phase", "c_bal", "c_next_slot", "c_prop_vid",
                     "c_prop_slot"),
    "gp_restore_paused_rows": ("bal", "exec_slot", "acc_bal", "acc_vid",
                               "acc_slot", "dec_vid", "dec_slot", "app_hash",
                               "n_execd", "c_next_slot"),
    "gp_restore_rows": EngineState._fields,
    "gp_extract_rows": (),
}
# the batch rows each op reads, in its wrapper's argument order: [N] per
# row, [N, W] for the window leaves (create's "bal" carries coord0)
INPUTS = {
    "gp_create_groups": ("member_mask", "bal", "version", "tag"),
    "gp_kill_groups": (),
    "gp_jump_rows": ("exec_slot", "bal", "app_hash", "n_execd", "stopped"),
    "gp_restore_paused_rows": ("exec_slot", "bal", "app_hash", "n_execd",
                               "acc_bal", "acc_vid", "acc_slot", "dec_vid",
                               "dec_slot"),
    "gp_restore_rows": EngineState._fields,
    "gp_extract_rows": (),
}


def _rows(idx, G: int, what: str, dedupe: bool = False) -> np.ndarray:
    """Host copy of a row batch as int32, checked: 1-D, integer, every row
    in [0, G) and no row twice (the reference's ``.at[idx].set`` leaves
    duplicates unordered and drops out-of-range rows; the kernels would
    race or write out of bounds, so both are refused here).  ``dedupe``
    (an op that writes only constants, where a repeated row is written
    the same each time): repeated rows are dropped instead."""
    h = idx.detach().cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if h.ndim != 1:
        raise ValueError(f"{what}: idx must be 1-D, got shape {h.shape}")
    if h.size == 0:
        return np.zeros(0, np.int32)
    if not np.issubdtype(h.dtype, np.integer):
        raise TypeError(f"{what}: idx dtype {h.dtype}, expected integers")
    h = h.astype(np.int64)
    lo, hi = int(h.min()), int(h.max())
    if lo < 0 or hi >= G:
        raise ValueError(f"{what}: rows [{lo}, {hi}] outside [0, {G})")
    if dedupe:
        h = np.unique(h)
    elif np.unique(h).size != h.size:
        raise ValueError(f"{what}: duplicate rows in idx")
    return h.astype(np.int32)


def _host_i32(val, shape, what: str) -> np.ndarray:
    """Host values -> a contiguous int32 array of ``shape`` (broadcast as
    the plain version's row assignment broadcasts; int32 wraparound as
    ``torch.as_tensor(..., dtype=int32)``)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    arr = np.asarray(val).astype(np.int32)
    try:
        return np.ascontiguousarray(np.broadcast_to(arr, shape))
    except ValueError:
        raise ValueError(f"{what}: shape {arr.shape} does not fit {shape}") from None


def _lifecycle_launch(a: _LifeArgs) -> None:
    """The one call into ``gp_lifecycle_launch`` (raises on a nonzero
    ``cudaGetLastError()``)."""
    _launch(lib("gp_lifecycle").gp_lifecycle_launch, a)


class Staged:
    """One lifecycle op staged for launch: its checked argument block, the
    tensors the block points into, and the result the launch fills.

    ``values`` are the op's batch rows, one per leaf of ``INPUTS[name]``
    ([N] or [N, W]): a CUDA int32 tensor of that shape is read in place,
    host values (numpy, python, CPU tensors) go up in ONE staging upload
    with ``idx``.  ``result`` is
    the new state (touched leaves fresh from ``torch.empty``, the rest
    the input's own tensors) or, for ``gp_extract_rows``, the tuple of
    gathered rows."""

    def __init__(self, name: str, op: int, state: EngineState, idx,
                 values: tuple = (), my_id: int = 0):
        dev = state.bal.device
        if not _engine.on_card(state.bal):
            raise ValueError(f"{name} needs CUDA tensors, got {dev}")
        G, W = (int(x) for x in state.acc_bal.shape)
        a = _LifeArgs()
        a.st_in[:] = _state_ptrs(state, (), G, W, dev, "state")
        if len(values) != len(INPUTS[name]):
            raise ValueError(f"{name}: {len(values)} batch inputs, "
                             f"expected {len(INPUTS[name])}")
        inputs = dict(zip(INPUTS[name], values))
        rows = _rows(idx, G, name, dedupe=op == OP_KILL)
        N = int(rows.size)
        shape_of = lambda leaf: (N, W) if leaf in GW_LEAVES else (N,)
        staged, on_dev = [rows], {}
        for leaf, val in inputs.items():
            if isinstance(val, torch.Tensor) and val.device == dev:
                _check(val, f"{name}.{leaf}", shape_of(leaf), torch.int32, dev)
                on_dev[leaf] = val
            else:
                staged.append(_host_i32(val, shape_of(leaf), f"{name}.{leaf}"))
        flat = torch.from_numpy(np.concatenate([x.ravel() for x in staged])).to(dev)
        a.idx = flat.data_ptr()
        off = N
        for leaf in inputs:
            if leaf in on_dev:
                a.inp[_LEAF[leaf]] = on_dev[leaf].data_ptr()
            else:
                a.inp[_LEAF[leaf]] = flat.data_ptr() + 4 * off
                off += int(np.prod(shape_of(leaf)))
        out = {}
        for leaf in TOUCHED[name]:
            out[leaf] = torch.empty_like(getattr(state, leaf))
            a.st_out[_LEAF[leaf]] = out[leaf].data_ptr()
        if op == OP_EXTRACT:
            self.result = tuple(
                torch.empty(shape_of(leaf), dtype=torch.int32, device=dev)
                for leaf in EngineState._fields
            )
            a.rows_out[:] = [t.data_ptr() for t in self.result]
        else:
            self.result = state._replace(**out)
        a.G, a.W, a.N, a.op, a.my_id = G, W, N, op, int(my_id)
        self.name, self.args = name, a
        self._keep = (state, flat, on_dev)

    def launch(self) -> None:
        """Launch the op's kernels on the staged arguments (again: the
        inputs are never written, so every launch writes the same
        result).  Counts nothing: :func:`_run` counts the op's launch."""
        _lifecycle_launch(self.args)


def _run(st: Staged):
    st.launch()
    LAUNCHES[st.name] += 1
    return st.result


def _stage_create(state, idx, member_mask, coord0, my_id, version=0, tag=0):
    return Staged("gp_create_groups", OP_CREATE, state, idx,
                  (member_mask, coord0, version, tag), my_id)


def _stage_kill(state, idx):
    # kill writes constants only, so a repeated row (hibernate_batch given
    # a name twice) has the reference's result: it is dropped, not refused
    return Staged("gp_kill_groups", OP_KILL, state, idx)


def _stage_jump(state, idx, exec_slot, bal, app_hash, n_execd, stopped):
    return Staged("gp_jump_rows", OP_JUMP, state, idx,
                  (exec_slot, bal, app_hash, n_execd, stopped))


def _stage_restore_paused(state, idx, exec_slot, bal, app_hash, n_execd,
                          acc_bal, acc_vid, acc_slot, dec_vid, dec_slot):
    return Staged("gp_restore_paused_rows", OP_RESTORE_PAUSED, state, idx,
                  (exec_slot, bal, app_hash, n_execd, acc_bal, acc_vid,
                   acc_slot, dec_vid, dec_slot))


def _stage_restore_rows(state, idx, rows):
    return Staged("gp_restore_rows", OP_RESTORE_ROWS, state, idx, tuple(rows))


def _stage_extract(state, idx):
    return Staged("gp_extract_rows", OP_EXTRACT, state, idx)


_STAGE = {
    "gp_create_groups": _stage_create,
    "gp_kill_groups": _stage_kill,
    "gp_jump_rows": _stage_jump,
    "gp_restore_paused_rows": _stage_restore_paused,
    "gp_restore_rows": _stage_restore_rows,
    "gp_extract_rows": _stage_extract,
}


def stage(name: str, state: EngineState, *args, **kwargs) -> Staged:
    """Stage one call of lifecycle kernel ``name`` with the public
    wrapper's arguments, without launching it (for timing the launch
    alone: :meth:`Staged.launch`)."""
    return _STAGE[name](state, *args, **kwargs)


def create_groups(state: EngineState, idx, member_mask, coord0, my_id: int,
                  version=0, tag=0) -> EngineState:
    """``gp_create_groups``: fresh rows (every leaf touched)."""
    return _run(_stage_create(state, idx, member_mask, coord0, my_id, version, tag))


def kill_groups(state: EngineState, idx) -> EngineState:
    """``gp_kill_groups``: inert rows."""
    return _run(_stage_kill(state, idx))


def jump_rows(state: EngineState, idx, exec_slot, bal, app_hash, n_execd,
              stopped) -> EngineState:
    """``gp_jump_rows``: adopt donor frontiers."""
    return _run(_stage_jump(state, idx, exec_slot, bal, app_hash, n_execd, stopped))


def restore_paused_rows(state: EngineState, idx, exec_slot, bal, app_hash,
                        n_execd, acc_bal, acc_vid, acc_slot, dec_vid,
                        dec_slot) -> EngineState:
    """``gp_restore_paused_rows``: scatter pause-record remnants."""
    return _run(_stage_restore_paused(
        state, idx, exec_slot, bal, app_hash, n_execd, acc_bal, acc_vid,
        acc_slot, dec_vid, dec_slot,
    ))


def restore_rows(state: EngineState, idx, rows) -> EngineState:
    """``gp_restore_rows``: scatter whole rows (EngineState field order)."""
    return _run(_stage_restore_rows(state, idx, rows))


def extract_rows(state: EngineState, idx) -> tuple:
    """``gp_extract_rows``: gather whole rows (EngineState field order)."""
    return _run(_stage_extract(state, idx))
