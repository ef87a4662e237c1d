"""Native (C++) runtime components, loaded via ctypes with Python
fallbacks.

The compute path is PyTorch/CUDA; the runtime around it goes native where the
reference's equivalents are its own hot paths — the journal's framed
append (header build + CRC32 + write [+fsync] as one C call, ~10x the
Python framing cost per block) and the client-plane wire codec
(``gp_codec.cc``: binary request/response batch frames scanned and packed
with the GIL released).  Shared objects are built on first use with the
system compiler and cached in the checkout's ``build/native/``
directory (never next to the source, never committed); every consumer must keep
working when no compiler is available (the loader returns None and
callers fall back to pure Python — ``GP_NO_NATIVE=1`` forces that path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
# <checkout>/build/native — listed in .gitignore
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_DIR)), "build", "native"
)

_lock = threading.Lock()
# name -> (lib or None, tried)
_libs: Dict[str, Tuple[Optional[ctypes.CDLL], bool]] = {}


def _build(src: str, so: str) -> bool:
    # build under a private name, then rename: concurrent processes
    # sharing the build directory never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    for cxx in ("g++", "c++", "clang++"):
        try:
            r = subprocess.run(
                [cxx, "-O2", "-shared", "-fPIC", "-o", tmp, src],
                capture_output=True, timeout=120,
            )
            if r.returncode == 0:
                os.replace(tmp, so)
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def _load(name: str, declare) -> Optional[ctypes.CDLL]:
    """Build-if-stale + load + declare + self-check one native library.
    ``declare(lib) -> bool`` sets arg/restypes and runs a sanity probe;
    False rejects the library (fallback to pure Python)."""
    with _lock:
        ent = _libs.get(name)
        if ent is not None and ent[1]:
            return ent[0]
        _libs[name] = (None, True)
        if os.environ.get("GP_NO_NATIVE"):
            return None
        src = os.path.join(_DIR, f"{name}.cc")
        so = os.path.join(_BUILD_DIR, f"lib{name}.so")
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            if not os.path.exists(so) or (
                os.path.getmtime(so) < os.path.getmtime(src)
            ):
                if not _build(src, so):
                    return None
            lib = ctypes.CDLL(so)
            if not declare(lib):
                return None
            _libs[name] = (lib, True)
        except OSError:
            return None
        return lib


def _declare_journal(lib: ctypes.CDLL) -> bool:
    lib.gpj_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.gpj_crc32.restype = ctypes.c_uint32
    lib.gpj_append.argtypes = [
        ctypes.c_int, ctypes.c_uint8, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.gpj_append.restype = ctypes.c_int64
    lib.gpj_append_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.c_int,
    ]
    lib.gpj_append_batch.restype = ctypes.c_int64
    # self-check: CRC must match zlib exactly or journals written
    # natively would be unreadable by the Python scanner
    import zlib

    probe = b"gp-journal-crc-selfcheck"
    return lib.gpj_crc32(probe, len(probe)) == zlib.crc32(probe)


def _declare_codec(lib: ctypes.CDLL) -> bool:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    pp = ctypes.POINTER(ctypes.c_char_p)
    lib.gpc_req_index.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
    ]
    lib.gpc_req_index.restype = ctypes.c_int64
    lib.gpc_resp_index.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
    ]
    lib.gpc_resp_index.restype = ctypes.c_int64
    lib.gpc_pack_req.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_uint32,
        u64p, u8p,
        pp, ctypes.POINTER(ctypes.c_uint16),
        pp, ctypes.POINTER(ctypes.c_uint32),
        u64p, i32p, u8p,  # trace context: tids, origins, hops
    ]
    lib.gpc_pack_req.restype = ctypes.c_int64
    lib.gpc_pack_resp.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_uint32,
        u64p, u8p, u8p,
        pp, ctypes.POINTER(ctypes.c_uint16),
        pp, ctypes.POINTER(ctypes.c_uint32),
        u64p, i32p, u8p,  # trace context: tids, origins, hops
    ]
    lib.gpc_pack_resp.restype = ctypes.c_int64
    # self-check: an empty batch must index back to zero items — a
    # mis-built (or STALE pre-trace-ABI) library must never reach the
    # wire.  The second probe indexes a one-item traced frame: an old
    # library rejects the trace tail as trailing garbage and is refused
    # here, forcing the Python fallback instead of wire corruption.
    hdr = b"R" + (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
    out = (ctypes.c_int64 * 9)()
    if lib.gpc_req_index(hdr, len(hdr), out, 1) != 0:
        return False
    traced = (
        b"R" + (0).to_bytes(4, "little") + (1).to_bytes(4, "little")
        + (7).to_bytes(8, "little") + bytes([0x02])
        + (1).to_bytes(2, "little") + (0).to_bytes(4, "little") + b"n"
        + (9).to_bytes(8, "little") + (3).to_bytes(4, "little") + bytes([1])
    )
    out2 = (ctypes.c_int64 * 9)()
    return (
        lib.gpc_req_index(traced, len(traced), out2, 1) == 1
        and out2[6] == 9 and out2[7] == 3 and out2[8] == 1
    )


def journal_lib() -> Optional[ctypes.CDLL]:
    """The native journal library, or None (pure-Python fallback)."""
    return _load("gp_journal", _declare_journal)


def codec_lib() -> Optional[ctypes.CDLL]:
    """The native wire-codec library, or None (pure-Python fallback)."""
    return _load("gp_codec", _declare_codec)
