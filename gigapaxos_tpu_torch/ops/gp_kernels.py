"""Build, bind and launch the hand-written CUDA kernels of ``csrc/gp_step.cu``.

The source has a plain C interface (no PyTorch headers), so it builds with
``nvcc`` in seconds into ``<checkout>/build/kernels/`` (listed in
``.gitignore``) at first use, and loads with ``ctypes``.  Arguments travel
as one ``ctypes.Structure`` of device pointers, passed by address.  The
kernels launch on PyTorch's current stream and allocate nothing: the
wrappers here allocate every output with ``torch.empty``, check device,
dtype, shape and contiguity, and raise when the C launcher returns a
nonzero ``cudaGetLastError()``.  Nothing here falls back to the plain
version: a failed build or launch raises.

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
from typing import Optional

import torch

from .engine import (
    LAUNCHES,
    EngineConfig,
    EngineState,
    blob_vec_len,
    out_vec_len,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gp_step.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_NLEAF = len(EngineState._fields)
_MAX_W = 32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the build: seconds, the .so path and ptxas' resource report
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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the gp_step kernel is built from "
        f"{SOURCE} at first use and needs the CUDA toolkit"
    )


def build(force: bool = False) -> str:
    """Compile ``csrc/gp_step.cu`` for sm_90a (cached by source hash
    unless ``force``); returns the shared library's path.  Raises on
    failure."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libgp_step-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so) and not force:
        BUILD_INFO.setdefault("so", so)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}"
        )
    os.replace(tmp, so)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, so=so,
        ptxas=(r.stdout + r.stderr).strip(),
    )
    return so


def lib() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            for name in ("gp_step_args_size", "gp_blob_args_size"):
                getattr(cdll, name).restype = ctypes.c_int
                getattr(cdll, name).argtypes = []
            for name in ("gp_step_launch", "gp_make_blob_launch"):
                fn = getattr(cdll, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            if (cdll.gp_step_args_size() != ctypes.sizeof(_StepArgs)
                    or cdll.gp_blob_args_size() != ctypes.sizeof(_BlobArgs)):
                raise RuntimeError("gp_step.cu argument layout mismatch")
            _lib = cdll
        return _lib


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
