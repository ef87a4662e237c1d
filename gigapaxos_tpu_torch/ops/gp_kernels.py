"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

Three sources, each with a plain C interface (no PyTorch headers), so
each builds with ``nvcc`` in seconds:

* ``csrc/gp_step.cu``: ``gp_step`` and ``gp_make_blob`` (the engine).  It
  builds four times, one library a mode (``GP_STEP_MODE``): ``gp_step``
  (one substep, and ``gp_make_blob``), ``gp_step_n`` (the packed face's N
  substeps in one launch), ``gp_step_cluster`` (the stacked face's N
  substeps over clusters of R CTAs), ``gp_step_tile`` (the stacked
  face's one substep, each CTA stepping every replica of its tile) and
  ``gp_step_skip`` (the same, copying through each tile its last launch
  left at a fixed point: :class:`TileFlags`, :func:`tile_counts`);
* ``csrc/gp_lifecycle.cu``: the group-lifecycle row ops (create, kill,
  jump, restore_paused, restore_rows, extract_rows);
* ``csrc/gp_pack_rows.cu``: ``gp_pack_rows``, the gathered blobs' row
  pack of the Blob-exchange tick.

All build at first use, in parallel (one ``nvcc`` per library), into
``<checkout>/build/kernels/`` (listed in ``.gitignore``), named by one
hash over every source and the flags, and load with ``ctypes``.
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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from . import engine as _engine
from .engine import (
    KERNEL_LAUNCHES,
    LAUNCHES,
    Blob,
    EngineConfig,
    EngineState,
    blob_vec_len,
    out_vec_len,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "gp_step": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_step_n": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_step_cluster": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_step_tile": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_step_skip": os.path.join(_PKG, "csrc", "gp_step.cu"),
    "gp_lifecycle": os.path.join(_PKG, "csrc", "gp_lifecycle.cu"),
    "gp_pack_rows": os.path.join(_PKG, "csrc", "gp_pack_rows.cu"),
}
# each library's mode of its source (csrc/gp_step.cu's GP_STEP_MODE)
DEFINES = {"gp_step_n": ["-DGP_STEP_MODE=1"], "gp_step_cluster": ["-DGP_STEP_MODE=2"],
           "gp_step_tile": ["-DGP_STEP_MODE=3"], "gp_step_skip": ["-DGP_STEP_MODE=4"]}
_STEP_LIBS = ("gp_step", "gp_step_n", "gp_step_cluster", "gp_step_tile", "gp_step_skip")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_NLEAF = len(EngineState._fields)
_NBLOB = len(Blob._fields)
_MAX_W = 32
# the portable thread-block cluster size: the most replicas one cluster of
# the stacked N-substep launch holds (csrc/gp_step.cu GP_MAX_CLUSTER), and
# the most the stacked face's one-launch route takes at N = 1
MAX_CLUSTER = 8

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
        ("T", ctypes.c_int32),         # set by the C launcher
        ("aligned", ctypes.c_int32),   # set by the C launcher
        ("n_sub", ctypes.c_int32),     # substeps in the launch
        ("cluster", ctypes.c_int32),   # stacked: clusters of R CTAs
    ]


class _SkipArgs(_StepArgs):
    """``GpStepArgs`` of the skip build (``GP_STEP_MODE == 4``): the
    fields above, then the quiescence flags' (:class:`TileFlags`)."""

    _fields_ = [
        ("quiet", ctypes.c_void_p),        # [4 * tiles] int32, or null
        ("heard_prev", ctypes.c_void_p),   # [R, R] uint8
        ("heard_keep", ctypes.c_void_p),   # [R, R] uint8
        ("tiles", ctypes.c_void_p),        # [2] uint64: skipped, stepped
        ("sums", ctypes.c_void_p),         # [3] uint64, zero between launches
        ("report", ctypes.c_void_p),       # [4] int64 in mapped host memory
        ("quiet_valid", ctypes.c_int32),
        ("quiet_epoch", ctypes.c_int32),
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
        ("pos", ctypes.c_void_p),
        ("cnt", ctypes.c_void_p),
        ("bits", ctypes.c_void_p),
        ("G", ctypes.c_int32),
        ("W", ctypes.c_int32),
        ("N", ctypes.c_int32),
        ("op", ctypes.c_int32),
        ("my_id", ctypes.c_int32),
        ("units", ctypes.c_int32),     # 0: the launcher's rule
        ("kernels", ctypes.c_int32),   # set by the C launcher
    ]


class _PackArgs(ctypes.Structure):
    """``GpPackArgs`` of ``csrc/gp_pack_rows.cu``: one entry per Blob leaf
    (base pointer, words per row, first column in a packed row)."""

    _fields_ = [
        ("leaf", ctypes.c_void_p * _NBLOB),
        ("len", ctypes.c_int64 * _NBLOB),
        ("col", ctypes.c_int64 * _NBLOB),
        ("out", ctypes.c_void_p),
        ("NB", ctypes.c_int64),
        ("R", ctypes.c_int32),
        ("n_leaf", ctypes.c_int32),
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
    """One hash over every source and the flags names every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        with open(SOURCES[name], "rb") as f:
            h.update(name.encode() + b"\0" + " ".join(DEFINES.get(name, [])).encode()
                     + b"\0" + f.read())
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
            [nvcc, *NVCC_FLAGS, *DEFINES.get(name, []), "-o", tmp, SOURCES[name]],
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
        launchers = ("gp_step_launch", "gp_make_blob_launch", "gp_step_launch_info")
    elif name in _STEP_LIBS:
        sizes = {"gp_step_args_size": _SkipArgs if name == "gp_step_skip" else _StepArgs}
        launchers = ("gp_step_launch", "gp_step_launch_info")
    elif name == "gp_lifecycle":
        sizes = {"gp_life_args_size": _LifeArgs}
        launchers = ("gp_lifecycle_launch",)
    else:
        sizes = {"gp_pack_args_size": _PackArgs}
        launchers = ("gp_pack_rows_launch",)
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
    if (t.dtype is not dtype or t.shape != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """bool -> the same storage viewed as uint8 (what the kernel reads)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _state_ptrs(state: EngineState, lead, G: int, W: int, device, what: str):
    g, gw = lead + (G,), lead + (G, W)
    return [_check(leaf, f"{what}.{name}", gw if name in GW_LEAVES else g,
                   torch.int32, device)
            for name, leaf in zip(EngineState._fields, state)]


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


# the C launcher's plan, in gp_step_launch_info's order
STEP_PLAN_KEYS = ("instance", "T", "threads", "smem_bytes", "ctas_per_sm", "grid",
                  "aligned", "n_items")


def step_launch_plan(cfg: EngineConfig, stacked: bool = False, n_sub: int = 1,
                     cluster: bool = False, tile: bool = False) -> dict:
    """The plan ``gp_step_launch`` makes for ``cfg`` on the current card,
    for 16-byte aligned tensors (the caching allocator's): the
    instantiation (R * 100 + W, 0 = generic), the groups per tile, the
    threads and shared memory of a CTA, the CTAs an SM holds, the grid
    (CTAs), bulk copies or plain loads, and the work items.  ``n_sub``
    substeps in one launch (the packed face's :func:`step_n`, or with
    ``cluster`` the stacked face's :func:`step_cluster`); a cluster plan
    also names its ``cluster`` size (R CTAs, one tile a cluster).
    ``tile``: the stacked step with one CTA a tile stepping its R replicas
    (:func:`step_stacked` without a blob matrix)."""
    _check_cfg(cfg)
    a = _StepArgs()
    a.G, a.W, a.K, a.R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    a.stacked = int(stacked or cluster or tile)
    a.n_sub, a.cluster = int(n_sub), int(cluster)
    got = (ctypes.c_longlong * len(STEP_PLAN_KEYS))()
    name = ("gp_step_cluster" if cluster else "gp_step_tile" if tile
            else "gp_step_n" if n_sub > 1 else "gp_step")
    rc = lib(name).gp_step_launch_info(ctypes.addressof(a), ctypes.addressof(got))
    if rc != 0:
        raise RuntimeError(f"gp_step_launch_info failed: cudaError {rc}")
    plan = dict(zip(STEP_PLAN_KEYS, (int(x) for x in got)))
    if cluster:
        plan["cluster"] = cfg.n_replicas
    return plan


def stacked_route(cfg: EngineConfig, n_steps: int) -> str:
    """How the stacked face runs ``n_steps`` substeps on the card, by shape
    alone, for R up to :data:`MAX_CLUSTER`: ``"cluster"`` at N > 1 (one
    :func:`step_cluster` launch, the replicas exchanging blobs in their
    cluster's shared memory), ``"tile"`` at N = 1 (one stacked ``gp_step``
    launch, each CTA stepping the R replicas of its tile from blob rows it
    encodes in its shared memory); for more replicas, ``"launches"`` (a
    ``gp_make_blob`` and N stacked ``gp_step`` launches through a blob
    matrix in device memory).  No route but ``"launches"`` writes a blob
    matrix."""
    if cfg.n_replicas > MAX_CLUSTER:
        return "launches"
    return "cluster" if n_steps > 1 else "tile"


def step(state: EngineState, gvec: torch.Tensor, heard: torch.Tensor,
         req_vid: torch.Tensor, want_coord: torch.Tensor, my_id: int,
         cfg: EngineConfig, *, with_blob: bool = True,
         out_state: Optional[EngineState] = None,
         heat: Optional[torch.Tensor] = None,
         heat_out: Optional[torch.Tensor] = None,
         out_vec: Optional[torch.Tensor] = None,
         out_blob: Optional[torch.Tensor] = None,
         launch_log: Optional[dict] = None):
    """One ``gp_step`` launch for one replica: returns (state', out_vec
    [M], blob_vec [NB] or None).  ``out_state`` (optional) receives
    state' and must share no storage with ``state``; ``heat`` (optional)
    is read and ``heat_out`` (default: a new tensor; may be ``heat``
    itself) gets ``heat + n_committed + n_admitted``.  ``out_vec`` and
    ``out_blob`` (optional) are a preallocated out vector and blob
    vector (the blob must not overlap ``gvec``).  ``launch_log``
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
        if out_blob is None:
            out_blob = torch.empty((NB,), dtype=torch.int32, device=dev)
        a.blob = _check(out_blob, "out_blob", (NB,), torch.int32, dev)
        if a.blob < a.gathered + 4 * gvec.numel() and a.gathered < a.blob + 4 * NB:
            raise ValueError("out_blob overlaps the gathered blobs")
        blob = out_blob
    if heat is not None:
        a.heat_in = _check(heat, "heat", (G,), torch.int32, dev)
        if heat_out is None:
            heat_out = torch.empty_like(heat)
        a.heat_out = _check(heat_out, "heat_out", (G,), torch.int32, dev)
    a.G, a.W, a.K, a.R, a.my_id, a.stacked = G, W, K, R, int(my_id), 0
    a.n_sub, a.cluster = 1, 0
    _launch(lib().gp_step_launch, a)
    _count("gp_step", launch_log)
    return out_state, out_vec, blob, heat_out


def _count(name: str, launch_log: Optional[dict]) -> None:
    LAUNCHES[name] += 1
    if launch_log is not None:
        launch_log[name] = launch_log.get(name, 0) + 1


def step_n(state: EngineState, gvec: torch.Tensor, heard: torch.Tensor,
           req_ring: torch.Tensor, want_coord: torch.Tensor, my_id: int,
           cfg: EngineConfig, *, out_state: Optional[EngineState] = None,
           heat: Optional[torch.Tensor] = None,
           heat_out: Optional[torch.Tensor] = None,
           out_rings: Optional[torch.Tensor] = None,
           out_blob: Optional[torch.Tensor] = None,
           launch_log: Optional[dict] = None):
    """The packed face's N-substep dispatch as ONE launch (``gp_step_n``):
    N = ``req_ring.shape[0]`` rounds of one replica with the state held in
    shared memory, MY row of ``gvec`` replaced by the advancing state's
    blob from substep 1 on, peers' rows as passed, ``want_coord`` at
    substep 0 only.  Returns (state', out_rings [N, M], blob_vec [NB],
    heat_out); ``heat``/``heat_out`` as :func:`step`'s, summed over the N
    substeps; ``out_rings`` and ``out_blob`` (optional) are preallocated
    outputs (the blob must not overlap ``gvec``)."""
    _check_cfg(cfg)
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    dev = state.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_step_n needs CUDA tensors, got {dev}")
    if not 0 <= my_id < R:
        raise ValueError(f"my_id {my_id} outside [0, {R})")
    if req_ring.dim() != 3 or req_ring.shape[0] < 1:
        raise ValueError(f"req_ring: shape {tuple(req_ring.shape)}, expected [N, G, K]")
    N = int(req_ring.shape[0])
    a = _StepArgs()
    a.st_in[:] = _state_ptrs(state, (), G, W, dev, "state")
    if out_state is None:
        out_state = _empty_state(state)
    a.st_out[:] = _state_ptrs(out_state, (), G, W, dev, "out_state")
    if set(a.st_in) & set(a.st_out):
        raise ValueError("out_state aliases the input state")
    NB, M = blob_vec_len(cfg), out_vec_len(cfg)
    a.gathered = _check(gvec, "gathered", (R, NB), torch.int32, dev)
    heard = _bytes(heard)
    a.heard = _check(heard, "heard", (R,), torch.uint8, dev)
    a.req = _check(req_ring, "req_ring", (N, G, K), torch.int32, dev)
    want_coord = _bytes(want_coord)
    a.want = _check(want_coord, "want_coord", (G,), torch.uint8, dev)
    if out_rings is None:
        out_rings = torch.empty((N, M), dtype=torch.int32, device=dev)
    a.out_vec = _check(out_rings, "out_rings", (N, M), torch.int32, dev)
    if out_blob is None:
        out_blob = torch.empty((NB,), dtype=torch.int32, device=dev)
    a.blob = _check(out_blob, "out_blob", (NB,), torch.int32, dev)
    if a.blob < a.gathered + 4 * gvec.numel() and a.gathered < a.blob + 4 * NB:
        raise ValueError("out_blob overlaps the gathered blobs")
    if heat is not None:
        a.heat_in = _check(heat, "heat", (G,), torch.int32, dev)
        if heat_out is None:
            heat_out = torch.empty_like(heat)
        a.heat_out = _check(heat_out, "heat_out", (G,), torch.int32, dev)
    a.G, a.W, a.K, a.R, a.my_id, a.stacked = G, W, K, R, int(my_id), 0
    a.n_sub, a.cluster = N, 0
    _launch(lib("gp_step_n").gp_step_launch, a)
    _count("gp_step_n", launch_log)
    return out_state, out_rings, out_blob, heat_out


def step_cluster(states: EngineState, heard: torch.Tensor, req_vid: torch.Tensor,
                 want_coord: torch.Tensor, cfg: EngineConfig, *,
                 out_states: Optional[EngineState] = None,
                 out_mat: Optional[torch.Tensor] = None,
                 launch_log: Optional[dict] = None):
    """The stacked face's N substeps as ONE launch (``gp_step_cluster``):
    a cluster of R CTAs per group tile, one per replica, each holding its
    replica's state for the whole dispatch and storing its blob rows into
    every peer's shared memory each substep (no blob matrix in device
    memory, no ``gp_make_blob``).  ``req_vid [N, R, G, K]``,
    ``want_coord [R, G]`` (substep 0 only), ``heard [R, R]``.  Returns
    (states', out matrix [N, R, M]).  R must not exceed
    :data:`MAX_CLUSTER` (:func:`stacked_route`)."""
    _check_cfg(cfg)
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    if R > MAX_CLUSTER:
        raise ValueError(f"gp_step_cluster: R={R} replicas, a cluster holds at most "
                         f"{MAX_CLUSTER} CTAs")
    dev = states.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_step_cluster needs CUDA tensors, got {dev}")
    if req_vid.dim() != 4 or req_vid.shape[0] < 1:
        raise ValueError(f"req_vid: shape {tuple(req_vid.shape)}, expected [N, R, G, K]")
    N = int(req_vid.shape[0])
    a = _StepArgs()
    a.st_in[:] = _state_ptrs(states, (R,), G, W, dev, "states")
    if out_states is None:
        out_states = _empty_state(states)
    a.st_out[:] = _state_ptrs(out_states, (R,), G, W, dev, "out_states")
    if set(a.st_in) & set(a.st_out):
        raise ValueError("out_states alias the input states")
    heard = _bytes(heard)
    a.heard = _check(heard, "heard", (R, R), torch.uint8, dev)
    a.req = _check(req_vid, "req_vid", (N, R, G, K), torch.int32, dev)
    want_coord = _bytes(want_coord)
    a.want = _check(want_coord, "want_coord", (R, G), torch.uint8, dev)
    M = out_vec_len(cfg)
    if out_mat is None:
        out_mat = torch.empty((N, R, M), dtype=torch.int32, device=dev)
    a.out_vec = _check(out_mat, "out_mat", (N, R, M), torch.int32, dev)
    a.G, a.W, a.K, a.R, a.my_id, a.stacked = G, W, K, R, 0, 1
    a.n_sub, a.cluster = N, 1
    _launch(lib("gp_step_cluster").gp_step_launch, a)
    _count("gp_step_cluster", launch_log)
    return out_states, out_mat


class TileFlags:
    """The quiescence flags of one stacked face on one stream
    (``csrc/gp_step.cu``'s skip build), the state they describe, and which
    build each launch takes.

    ``flags``: an int32 epoch a group tile, each in a 16-byte slot (a bulk
    copy's unit: it comes with the tile's stage), as many as the smallest
    tile the launcher picks makes; each ``gp_step_skip`` launch stores its
    epoch where it leaves every group of a tile at a fixed point (the
    others keep an older one).  ``heard``: the ``[R, R]`` heard of the
    launch that set them, in one of two buffers (a launch reads one and
    keeps its own in the other).  Filled once with -1, an epoch no launch
    has.

    The flags describe the state the last launch returned, every leaf the
    same tensor at the same address and version (held by weak reference:
    the flags keep no state alive).  A write through PyTorch into a leaf,
    a view's included, moves its version; the kernels never write a state
    they are given (every op writes new tensors), so no write through a
    raw pointer reaches a returned state.  :meth:`launch` and
    :meth:`returned` bracket each launch, under ``lock``.

    The skip build's busy tiles run the check that keeps the flags, which
    the plain tile build (``gp_step_tile``) does not: a launch takes the
    skip build where the newest skip launch to finish flagged a quarter of
    its tiles or more, and every :data:`PROBE` th launch else.  The card
    writes each skip launch's counts to ``report`` (host memory it maps:
    epoch, tiles flagged, skipped, walked) as the launch ends, so the
    choice waits on nothing; a plain launch sets no flag, and the epochs
    tell the next launch that none is fresh."""

    def __init__(self, cfg: EngineConfig, device):
        G, W, R = cfg.n_groups, cfg.window, cfg.n_replicas
        dev = torch.device(device)
        t_min = max(32 // W, 4)   # csrc/gp_step.cu choose_tile's least tile
        self.flags = torch.full((4 * -(-G // t_min),), -1, dtype=torch.int32, device=dev)
        self.epoch = 0   # the last launch's
        hw = 16 * -(-R * R // 16)
        self.buf = torch.empty(2 * hw, dtype=torch.uint8, device=dev)
        self.heard = (self.buf[:R * R], self.buf[hw:hw + R * R])
        self.parity = 0
        self.sums = torch.zeros(4, dtype=torch.int64, device=dev)
        self.report = torch.zeros(4, dtype=torch.int64, pin_memory=dev.type == "cuda")
        self._report = self.report.numpy()
        self._seen = 0          # the epoch of the newest report read
        self._skip = False      # what it said
        self._marks = None
        self.n_tiles = None     # a launch's tiles (the plan's, on the first plain launch)
        self.lock = threading.Lock()

    def holds(self, states: EngineState) -> bool:
        """The flags describe ``states``: the state the last launch
        returned, unchanged since."""
        marks = self._marks
        if marks is None or len(marks) != len(states):
            return False
        try:
            return all(ref() is x and x.data_ptr() == ptr and x._version == ver
                       for (ref, ptr, ver), x in zip(marks, states))
        except RuntimeError:   # an inference tensor has no version
            return False

    def skip_build(self) -> bool:
        """Whether the next launch takes the skip build."""
        epoch, flagged, walked = (int(self._report[i]) for i in (0, 1, 3))
        if epoch != self._seen and walked > 0:
            self._seen = epoch
            self._skip = 4 * flagged >= walked
        return self._skip or self.epoch % PROBE == 0

    def launch(self, states: EngineState) -> bool:
        """Before a launch on ``states``: whether the flags describe them
        (the launch may skip tiles).  They describe nothing more until
        :meth:`returned`."""
        if self.epoch >= _MAX_EPOCH:   # start the epochs again
            self.flags.fill_(-1)
            self.epoch, self._marks = 0, None
        valid = self.holds(states)
        self._marks = None
        return valid

    def returned(self, states: EngineState) -> None:
        """After the launch that returned ``states``: the flags its epoch
        set, under the heard it kept, describe them."""
        self.parity ^= 1
        self.epoch += 1
        try:
            self._marks = [(weakref.ref(x), x.data_ptr(), x._version) for x in states]
        except RuntimeError:
            self._marks = None


# launches between two of the skip build while its newest report flagged
# too few tiles (each costs a busy step what the skip build's check does)
PROBE = 64
_MAX_EPOCH = 1 << 30

# tiles the stacked face's tile launches skipped and stepped, summed on
# each card: a [2] int64 counter a device, which every gp_step_skip launch
# adds to, and the tiles of its gp_step_tile launches, counted here
_TILE_COUNTS: Dict[str, torch.Tensor] = {}
_PLAIN_TILES: Dict[str, int] = {}


def _tile_counter(dev: torch.device) -> Optional[torch.Tensor]:
    """The card's counter; made on a launch outside a CUDA graph's capture
    (a launch under capture before any other counts nothing)."""
    t = _TILE_COUNTS.get(str(dev))
    if t is None and not torch.cuda.is_current_stream_capturing():
        t = _TILE_COUNTS[str(dev)] = torch.zeros(2, dtype=torch.int64, device=dev)
    return t


def tile_counts(device=None) -> dict:
    """The tiles the launches of :func:`step_stacked` with flags on
    ``device`` (default: the current card) skipped and stepped since the
    first launch or :func:`reset_tile_counts`.  Reads the card's counter
    (a sync); nothing on the step's path calls it."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    t = _TILE_COUNTS.get(str(dev))
    skipped, stepped = (0, 0) if t is None else (int(x) for x in t.tolist())
    return {"skipped": skipped, "stepped": stepped + _PLAIN_TILES.get(str(dev), 0)}


def reset_tile_counts() -> None:
    for t in _TILE_COUNTS.values():
        t.zero_()
    _PLAIN_TILES.clear()


def step_stacked(states: EngineState, blobs: Optional[torch.Tensor],
                 heard: torch.Tensor, req_vid: torch.Tensor,
                 want_coord: torch.Tensor, cfg: EngineConfig, *,
                 out_states: Optional[EngineState] = None,
                 out_blobs: Optional[torch.Tensor] = None,
                 out_mat: Optional[torch.Tensor] = None,
                 launch_log: Optional[dict] = None,
                 flags: Optional[TileFlags] = None):
    """One ``gp_step`` launch for ALL R replicas (work items (tile,
    replica), the replica fastest): stacked ``[R, G, ...]`` states, the
    ``[R, NB]`` blob matrix as the gather, ``heard [R, R]``, ``req [R, G,
    K]``, ``want [R, G]``.  ``blobs=None`` (R up to :data:`MAX_CLUSTER`):
    no matrix; one CTA a tile steps its R replicas from blob rows it
    encodes in shared memory, as ``gp_make_blob`` would (``gp_step_tile``),
    and with ``flags`` (:class:`TileFlags`) takes the build they choose:
    ``gp_step_skip`` keeps the quiescence flags and, where they describe
    ``states``, copies through each tile the last launch left at a fixed
    point that gets no input now.
    Returns (states', out matrix [R, M], blobs' [R, NB] or None).
    ``launch_log``: as :func:`step`'s."""
    _check_cfg(cfg)
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    dev = states.bal.device
    if dev.type != "cuda":
        raise ValueError(f"gp_step needs CUDA tensors, got {dev}")
    skip = flags is not None and flags.skip_build()
    a = _SkipArgs() if skip else _StepArgs()
    a.st_in[:] = _state_ptrs(states, (R,), G, W, dev, "states")
    if out_states is None:
        out_states = _empty_state(states)
    a.st_out[:] = _state_ptrs(out_states, (R,), G, W, dev, "out_states")
    if set(a.st_in) & set(a.st_out):
        raise ValueError("out_states alias the input states")
    NB = blob_vec_len(cfg)
    if blobs is None:
        if R > MAX_CLUSTER:
            raise ValueError(f"gp_step_tile: R={R} replicas, at most {MAX_CLUSTER}")
        if skip:
            counter = _tile_counter(dev)
            a.tiles = 0 if counter is None else counter.data_ptr()
            a.quiet = _check(flags.flags, "flags", flags.flags.shape, torch.int32, dev)
            a.sums = _check(flags.sums, "sums", (4,), torch.int64, dev)
            a.report = flags.report.data_ptr()
    else:
        if flags is not None:
            raise ValueError("flags are the tile build's (blobs=None)")
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
    a.n_sub, a.cluster = 1, 0
    if flags is None:
        _launch(lib("gp_step_tile" if blobs is None else "gp_step").gp_step_launch, a)
    else:
        with flags.lock:
            valid = flags.launch(states)
            if skip:
                a.quiet_valid, a.quiet_epoch = int(valid), flags.epoch + 1
                a.heard_prev = flags.heard[flags.parity].data_ptr()
                a.heard_keep = flags.heard[1 - flags.parity].data_ptr()
                _launch(lib("gp_step_skip").gp_step_launch, a)
            else:
                _launch(lib("gp_step_tile").gp_step_launch, a)
                if flags.n_tiles is None:
                    flags.n_tiles = -(-G // step_launch_plan(cfg, tile=True)["T"])
                _PLAIN_TILES[str(dev)] = _PLAIN_TILES.get(str(dev), 0) + flags.n_tiles
            flags.returned(out_states)
    _count("gp_step", launch_log)
    return out_states, out_mat, out_blobs


def make_blob_rows(states: EngineState, n_rep: Optional[int] = None,
                   launch_log: Optional[dict] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gp_make_blob`` over ``n_rep`` stacked replica states (``None``:
    one unstacked state) -> ``[n_rep, NB]`` (or ``[NB]``), into ``out``
    when it is given."""
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
    if out is None:
        out = torch.empty(lead + (NB,), dtype=torch.int32, device=dev)
    a.blob = _check(out, "out", lead + (NB,), torch.int32, dev)
    a.G, a.W, a.n_rep = G, W, 1 if n_rep is None else int(n_rep)
    _launch(lib().gp_make_blob_launch, a)
    _count("gp_make_blob", launch_log)
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


# rows per entry of the batch's chunk counts (csrc/gp_lifecycle.cu CHUNK_SHIFT)
CHUNK_ROWS = 256


def _check_rows(idx, G: int, what: str) -> np.ndarray:
    """Host copy of a row batch as int32, in the caller's order, checked:
    1-D, integer, every row in [0, G) (checked before the cast, so no wide
    value wraps into range)."""
    h = idx.detach().cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if h.ndim != 1:
        raise ValueError(f"{what}: idx must be 1-D, got shape {h.shape}")
    if h.size == 0:
        return np.zeros(0, np.int32)
    if h.dtype.kind not in "iu":
        raise TypeError(f"{what}: idx dtype {h.dtype}, expected integers")
    lo, hi = h.min(), h.max()
    if lo < 0 or hi >= G:
        raise ValueError(f"{what}: rows [{lo}, {hi}] outside [0, {G})")
    return h.astype(np.int32, copy=False)


def _sort_rows(rows: np.ndarray, what: str, dedupe: bool = False):
    """(sorted rows, the caller's position of each): a row twice is refused
    (the reference's ``.at[idx].set`` leaves duplicates unordered; the
    kernels would race), or with ``dedupe`` (an op that writes only
    constants, where a repeated row is written the same each time)
    dropped."""
    order = np.argsort(rows)   # the rows are unique once checked: no tie to order
    srt = rows[order]
    dup = srt[1:] == srt[:-1]
    if dup.any():
        if not dedupe:
            raise ValueError(f"{what}: duplicate rows in idx")
        keep = np.concatenate(([True], ~dup))
        srt, order = srt[keep], order[keep]
    return srt, order


def batch_bitmap(srt: np.ndarray, G: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The batch of sorted rows ``srt`` as the bitmap ``gp_kill_kernel`` and
    ``gp_life_rows_kernel`` read: bit ``g % 32`` of word ``g // 32`` is set
    where row ``g`` is in the batch (int32 words; into ``out`` when
    given)."""
    bits = np.zeros(-(-G // 32), np.int32) if out is None else out
    bits.fill(0)
    # unique rows: their bits are distinct, so a sum is their OR
    np.add.at(bits.view(np.uint32), srt >> 5,
              np.left_shift(np.uint32(1), (srt & 31).astype(np.uint32)))
    return bits


@functools.lru_cache(maxsize=64)
def _chunk_starts(G: int) -> np.ndarray:
    starts = np.arange(-(-G // CHUNK_ROWS) + 1) * CHUNK_ROWS
    starts.flags.writeable = False
    return starts


def _chunk_counts(srt: np.ndarray, G: int, out: np.ndarray) -> None:
    """``out[c]``: the sorted rows ``srt`` below chunk c's first row."""
    out[:] = np.searchsorted(srt, _chunk_starts(G))


def _lap(parts: Optional[dict], part: str, t: float) -> float:
    """Add the seconds since ``t`` to ``parts[part]`` and return the
    clock, when timing a lifecycle call's staging by part (``parts``, a
    dict the caller passes, else None): "args" (the argument block and its
    checks), "checks" (the row batch's), "build" (the host buffer),
    "upload", "alloc" (the fresh leaves)."""
    if parts is None:
        return t
    now = time.perf_counter()
    parts[part] = parts.get(part, 0.0) + now - t
    return now


def _clock(parts: Optional[dict]) -> float:
    return time.perf_counter() if parts is not None else 0.0


def _put(buf: np.ndarray, off: int, val, shape, what: str) -> None:
    """Host values -> ``buf[off:]`` as int32 of ``shape`` (broadcast as the
    plain version's row assignment broadcasts; int32 wraparound as
    ``torch.as_tensor(..., dtype=int32)``)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    arr = np.asarray(val)
    dst = buf[off:off + shape[0] * (shape[1] if len(shape) == 2 else 1)]
    try:
        if arr.ndim == 0:
            dst[...] = arr
        else:
            dst.reshape(shape)[...] = arr
    except ValueError:
        raise ValueError(f"{what}: shape {arr.shape} does not fit {shape}") from None


def _layout(layout) -> tuple:
    """Word offsets of the parts of ``layout`` ((name, words) pairs) in
    one buffer, each starting on a 16-byte boundary, and the buffer's
    words."""
    off, at = {}, 0
    for name, words in layout:
        off[name] = at
        at += -(-int(words) // 4) * 4
    return off, max(at, 4)


def life_batch_host(rows, inputs: dict, G: int, W: int, what: str = "batch",
                    alloc=None, parts: Optional[dict] = None):
    """The staged batch of ``gp_create_groups``, ``gp_jump_rows``,
    ``gp_restore_paused_rows`` and ``gp_restore_rows``
    (``gp_life_rows_kernel``), built on the host: ``(buf, off)``, one
    flat int32 buffer and the word offset of each part in it:

    * ``idx``: the batch's rows sorted ascending;
    * ``pos``: the caller's position of each sorted row;
    * ``cnt``: ``ceil(G / CHUNK_ROWS) + 1`` counts, the batch rows below
      each chunk of :data:`CHUNK_ROWS` rows (the bounds of the kernel's
      binary search);
    * ``bits``: the batch as a bitmap of G bits (:func:`batch_bitmap`);
    * one part per entry of ``inputs`` (leaf -> host values, [N] or
      [N, W] for a window leaf), in the caller's order;

    and ``off["N"]``, the batch's rows.

    ``rows`` is checked as the wrappers check it (1-D, integer, in
    [0, G), no row twice: :func:`_check_rows`, :func:`_sort_rows`) in
    int32.  ``alloc(words)`` (default: a new numpy array) gives the int32
    array to fill; ``parts`` (optional) sums the seconds of the checks and
    the build."""
    t = _clock(parts)
    r = _check_rows(rows, G, what)
    srt, order = _sort_rows(r, what)
    t = _lap(parts, "checks", t)
    N = int(r.size)
    nchunk = -(-G // CHUNK_ROWS)
    layout = [("idx", N), ("pos", N), ("cnt", nchunk + 1), ("bits", -(-G // 32))]
    shape_of = lambda leaf: (N, W) if leaf in GW_LEAVES else (N,)
    layout += [(leaf, N * (W if leaf in GW_LEAVES else 1)) for leaf in inputs]
    off, words = _layout(layout)
    buf = np.empty(words, np.int32) if alloc is None else alloc(words)
    buf[off["idx"]:off["idx"] + N] = srt
    buf[off["pos"]:off["pos"] + N] = order
    _chunk_counts(srt, G, buf[off["cnt"]:off["cnt"] + nchunk + 1])
    batch_bitmap(srt, G, buf[off["bits"]:off["bits"] + -(-G // 32)])
    for leaf, val in inputs.items():
        _put(buf, off[leaf], val, shape_of(leaf), f"{what}.{leaf}")
    off["N"] = N
    _lap(parts, "build", t)
    return buf, off


def rows_batch_host(rows, G: int, what: str = "batch", kill: bool = False,
                    alloc=None, parts: Optional[dict] = None):
    """The staged batch of ``gp_kill_groups`` and ``gp_extract_rows``
    (neither takes batch inputs), as :func:`life_batch_host` returns it:
    ``idx``, the rows in the caller's order (kill: unique and sorted, with
    ``bits``, the bitmap its kernel reads)."""
    t = _clock(parts)
    r = _check_rows(rows, G, what)
    srt, _ = _sort_rows(r, what, dedupe=kill)
    if kill:
        r = srt
    t = _lap(parts, "checks", t)
    N = int(r.size)
    off, words = _layout([("idx", N)] + ([("bits", -(-G // 32))] if kill else []))
    buf = np.empty(words, np.int32) if alloc is None else alloc(words)
    buf[off["idx"]:off["idx"] + N] = r
    if kill:
        batch_bitmap(r, G, buf[off["bits"]:off["bits"] + -(-G // 32)])
    off["N"] = N
    _lap(parts, "build", t)
    return buf, off


class _Pinned:
    """A device's reusable pinned host buffer for the lifecycle uploads,
    and the event after its last upload (the buffer is rewritten only
    once that copy has read it)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.host = torch.empty(0, dtype=torch.int32)
        self.view = self.host.numpy()
        self.done = torch.cuda.Event()

    def words(self, n: int) -> np.ndarray:
        if n > self.view.size:
            self.host = torch.empty(max(n, 2 * self.view.size, 1 << 16),
                                    dtype=torch.int32, pin_memory=True)
            self.view = self.host.numpy()
        return self.view[:n]


_PINNED: Dict[torch.device, _Pinned] = {}
_pin_lock = threading.Lock()


def _upload(dev: torch.device, build, parts: Optional[dict] = None) -> tuple:
    """``build(alloc)`` -> ``(buf, off)`` filled on the host and uploaded
    to ``dev`` in one copy: on a card, from the device's pinned buffer,
    ``non_blocking`` into a fresh device tensor on the current stream;
    returns (device tensor, off)."""
    if dev.type != "cuda":
        buf, off = build(None)
        return torch.from_numpy(buf), off
    with _pin_lock:
        pin = _PINNED.get(dev)
        if pin is None:
            pin = _PINNED[dev] = _Pinned()
    with pin.lock:
        t = _clock(parts)
        pin.done.synchronize()
        _lap(parts, "upload", t)
        buf, off = build(pin.words)
        t = _clock(parts)
        flat = torch.empty(buf.size, dtype=torch.int32, device=dev)
        flat.copy_(pin.host[:buf.size], non_blocking=True)
        pin.done.record(torch.cuda.current_stream(dev))
        _lap(parts, "upload", t)
    return flat, off


def _lifecycle_launch(a: _LifeArgs) -> None:
    """The one call into ``gp_lifecycle_launch`` (raises on a nonzero
    ``cudaGetLastError()``; the launcher sets ``a.kernels``)."""
    _launch(lib("gp_lifecycle").gp_lifecycle_launch, a)


class Staged:
    """One lifecycle op staged for launch: its checked argument block, the
    tensors the block points into, and the result the launch fills.

    ``values`` are the op's batch rows, one per leaf of ``INPUTS[name]``
    ([N] or [N, W]): a CUDA int32 tensor of that shape is read in place,
    host values (numpy, python, CPU tensors) go up in ONE upload with the
    rows (the row ops: :func:`life_batch_host`; kill and extract:
    :func:`rows_batch_host`).  ``result`` is
    the new state (touched leaves fresh from ``torch.empty``, the rest
    the input's own tensors) or, for ``gp_extract_rows``, the tuple of
    gathered rows.  ``parts`` (optional) sums the seconds of the staging's
    parts (``_lap``)."""

    def __init__(self, name: str, op: int, state: EngineState, idx,
                 values: tuple = (), my_id: int = 0, parts: Optional[dict] = None):
        t = _clock(parts)
        dev = state.bal.device
        if not _engine.on_card(state.bal):
            raise ValueError(f"{name} needs CUDA tensors, got {dev}")
        G, W = (int(x) for x in state.acc_bal.shape)
        a = _LifeArgs()
        a.st_in[:] = _state_ptrs(state, (), G, W, dev, "state")
        if len(values) != len(INPUTS[name]):
            raise ValueError(f"{name}: {len(values)} batch inputs, "
                             f"expected {len(INPUTS[name])}")
        host, on_dev = {}, {}
        for leaf, val in zip(INPUTS[name], values):
            if isinstance(val, torch.Tensor) and val.device == dev:
                on_dev[leaf] = val
            else:
                host[leaf] = val
        if on_dev:   # their shapes hang on N: refused before any upload
            idx = _check_rows(idx, G, name)
            for leaf, val in on_dev.items():
                shape = (idx.size, W) if leaf in GW_LEAVES else (idx.size,)
                a.inp[_LEAF[leaf]] = _check(val, f"{name}.{leaf}", shape, torch.int32, dev)
        rows_op = op not in (OP_KILL, OP_EXTRACT)
        if rows_op:
            build = lambda alloc: life_batch_host(idx, host, G, W, name, alloc, parts)
        else:
            build = lambda alloc: rows_batch_host(idx, G, name, op == OP_KILL, alloc, parts)
        _lap(parts, "args", t)
        flat, off = _upload(dev, build, parts)
        t = _clock(parts)
        N = off["N"]
        base = flat.data_ptr()
        a.idx = base + 4 * off["idx"]
        if op == OP_KILL:
            a.inp[0] = base + 4 * off["bits"]
        elif rows_op:
            a.pos = base + 4 * off["pos"]
            a.cnt = base + 4 * off["cnt"]
            a.bits = base + 4 * off["bits"]
        for leaf in host:
            a.inp[_LEAF[leaf]] = base + 4 * off[leaf]
        t = _lap(parts, "args", t)
        out = {}
        for leaf in TOUCHED[name]:
            out[leaf] = torch.empty_like(getattr(state, leaf))
            a.st_out[_LEAF[leaf]] = out[leaf].data_ptr()
        if op == OP_EXTRACT:
            self.result = tuple(
                torch.empty((N, W) if leaf in GW_LEAVES else (N,),
                            dtype=torch.int32, device=dev)
                for leaf in EngineState._fields
            )
            a.rows_out[:] = [x.data_ptr() for x in self.result]
        else:
            self.result = state._replace(**out)
        t = _lap(parts, "alloc", t)
        a.G, a.W, a.N, a.op, a.my_id = G, W, N, op, int(my_id)
        self.name, self.args = name, a
        self._keep = (state, flat, on_dev)
        _lap(parts, "args", t)

    @property
    def kernels(self) -> int:
        """Kernels the last :meth:`launch` launched (the C launcher's
        count: 1 for every op, 0 for an empty extract)."""
        return int(self.args.kernels)

    def launch(self) -> None:
        """Launch the op's kernels on the staged arguments (again: the
        inputs are never written, so every launch writes the same
        result).  Counts nothing: :func:`_run` counts the op's launch."""
        _lifecycle_launch(self.args)


def _run(st: Staged):
    st.launch()
    LAUNCHES[st.name] += 1
    KERNEL_LAUNCHES[st.name] += st.kernels
    return st.result


def _stage_create(state, idx, member_mask, coord0, my_id, version=0, tag=0, parts=None):
    return Staged("gp_create_groups", OP_CREATE, state, idx,
                  (member_mask, coord0, version, tag), my_id, parts)


def _stage_kill(state, idx, parts=None):
    # kill writes constants only, so a repeated row (hibernate_batch given
    # a name twice) has the reference's result: it is dropped, not refused
    return Staged("gp_kill_groups", OP_KILL, state, idx, parts=parts)


def _stage_jump(state, idx, exec_slot, bal, app_hash, n_execd, stopped, parts=None):
    return Staged("gp_jump_rows", OP_JUMP, state, idx,
                  (exec_slot, bal, app_hash, n_execd, stopped), parts=parts)


def _stage_restore_paused(state, idx, exec_slot, bal, app_hash, n_execd,
                          acc_bal, acc_vid, acc_slot, dec_vid, dec_slot, parts=None):
    return Staged("gp_restore_paused_rows", OP_RESTORE_PAUSED, state, idx,
                  (exec_slot, bal, app_hash, n_execd, acc_bal, acc_vid,
                   acc_slot, dec_vid, dec_slot), parts=parts)


def _stage_restore_rows(state, idx, rows, parts=None):
    return Staged("gp_restore_rows", OP_RESTORE_ROWS, state, idx, tuple(rows), parts=parts)


def _stage_extract(state, idx, parts=None):
    return Staged("gp_extract_rows", OP_EXTRACT, state, idx, parts=parts)


_STAGE = {
    "gp_create_groups": _stage_create,
    "gp_kill_groups": _stage_kill,
    "gp_jump_rows": _stage_jump,
    "gp_restore_paused_rows": _stage_restore_paused,
    "gp_restore_rows": _stage_restore_rows,
    "gp_extract_rows": _stage_extract,
}


def stage(name: str, state: EngineState, *args, parts: Optional[dict] = None,
          **kwargs) -> Staged:
    """Stage one call of lifecycle kernel ``name`` with the public
    wrapper's arguments, without launching it (for timing the launch
    alone: :meth:`Staged.launch`; ``parts``: the staging's seconds by
    part summed into it)."""
    return _STAGE[name](state, *args, parts=parts, **kwargs)


def create_groups(state: EngineState, idx, member_mask, coord0, my_id: int,
                  version=0, tag=0) -> EngineState:
    """``gp_create_groups``: fresh rows (every leaf touched), one launch."""
    return _run(_stage_create(state, idx, member_mask, coord0, my_id, version, tag))


def kill_groups(state: EngineState, idx) -> EngineState:
    """``gp_kill_groups``: inert rows."""
    return _run(_stage_kill(state, idx))


def jump_rows(state: EngineState, idx, exec_slot, bal, app_hash, n_execd,
              stopped) -> EngineState:
    """``gp_jump_rows``: adopt donor frontiers, one launch."""
    return _run(_stage_jump(state, idx, exec_slot, bal, app_hash, n_execd, stopped))


def restore_paused_rows(state: EngineState, idx, exec_slot, bal, app_hash,
                        n_execd, acc_bal, acc_vid, acc_slot, dec_vid,
                        dec_slot) -> EngineState:
    """``gp_restore_paused_rows``: scatter pause-record remnants, one
    launch."""
    return _run(_stage_restore_paused(
        state, idx, exec_slot, bal, app_hash, n_execd, acc_bal, acc_vid,
        acc_slot, dec_vid, dec_slot,
    ))


def restore_rows(state: EngineState, idx, rows) -> EngineState:
    """``gp_restore_rows``: scatter whole rows (EngineState field order),
    one launch."""
    return _run(_stage_restore_rows(state, idx, rows))


def extract_rows(state: EngineState, idx) -> tuple:
    """``gp_extract_rows``: gather whole rows (EngineState field order)."""
    return _run(_stage_extract(state, idx))


# ---------------------------------------------------------------------------
# the gathered blobs' row pack (csrc/gp_pack_rows.cu)
# ---------------------------------------------------------------------------


def _pack_launch(a: _PackArgs) -> None:
    """The one call into ``gp_pack_rows_launch`` (raises on a nonzero
    ``cudaGetLastError()``)."""
    _launch(lib("gp_pack_rows").gp_pack_rows_launch, a)


# the [R, G, W] leaves of a gathered Blob (the other four are [R, G])
_GW_BLOB = frozenset(("acc_vid", "dec_vid", "prop_vid", "lane_meta"))


class StagedPack:
    """One ``gp_pack_rows`` call staged for launch: the checked argument
    block, the tensors it points into, and the ``[R, NB]`` result.

    ``blob`` holds ``[R, G]`` leaves (tag, bal, exec_slot, coord) and
    ``[R, G, W]`` leaves (acc_vid, dec_vid, prop_vid, lane_meta).  A
    leaf that is a contiguous int32 tensor on ``device`` is read in
    place; every other leaf (numpy, python, CPU tensors) goes up as it
    is, one upload per leaf with no host-side copy first (filling one
    pinned staging buffer on the host and uploading it once took 9.6 ms
    against 4.4 ms for the per-leaf uploads and ``torch.cat`` at G=65,536,
    W=16, R=3 on an H100 host: the host copy costs more than it saves)."""

    def __init__(self, blob: Blob, device):
        dev = torch.device(device)
        if not _engine.on_card(dev):
            raise ValueError(f"gp_pack_rows needs a CUDA device, got {dev}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if len(blob) != _NBLOB:
            raise ValueError(f"gp_pack_rows: {len(blob)} leaves, expected {_NBLOB}")
        lead = tuple(int(x) for x in blob.lane_meta.shape)
        if len(lead) != 3:
            raise ValueError(f"gp_pack_rows: lane_meta shape {lead}, expected [R, G, W]")
        R, G, W = lead
        if R < 1 or G < 1 or W < 1:
            raise ValueError(f"gp_pack_rows: empty shape {lead}")
        a = _PackArgs()
        leaves, NB = [], 0
        for i, (f, leaf) in enumerate(zip(Blob._fields, blob)):
            shape = (R, G, W) if f in _GW_BLOB else (R, G)
            if not (isinstance(leaf, torch.Tensor) and leaf.device == dev):
                if isinstance(leaf, torch.Tensor):
                    leaf = leaf.detach().cpu().numpy()
                # int32 wraparound as torch.as_tensor(..., dtype=int32)
                arr = np.ascontiguousarray(leaf, dtype=np.int32)
                if arr.shape != shape:
                    raise ValueError(f"blob.{f}: shape {arr.shape}, expected {shape}")
                leaf = torch.from_numpy(arr).to(dev)
            a.leaf[i] = _check(leaf, f"blob.{f}", shape, torch.int32, dev)
            a.len[i] = int(np.prod(shape[1:]))
            a.col[i] = NB
            NB += a.len[i]
            leaves.append(leaf)
        self.result = torch.empty((R, NB), dtype=torch.int32, device=dev)
        a.out = self.result.data_ptr()
        a.NB, a.R, a.n_leaf = NB, R, _NBLOB
        self.args = a
        self._keep = leaves

    def launch(self) -> None:
        """Launch the pack on the staged arguments (again: the inputs are
        never written).  Counts nothing: :func:`pack_rows` counts."""
        _pack_launch(self.args)


def pack_rows(blob: Blob, device, launch_log: Optional[dict] = None) -> torch.Tensor:
    """``gp_pack_rows``: Blob of ``[R, ...]`` leaves -> ``[R, NB]`` packed
    rows on ``device`` (each row equal to ``pack_blob`` of that replica's
    blob).  ``launch_log`` (optional) is a caller's own launch counter."""
    st = StagedPack(blob, device)
    st.launch()
    _count("gp_pack_rows", launch_log)
    return st.result
