"""Device-plane observability for the port's engine step.

* :class:`StepSentinel` — wraps every ``make_step`` instance.  The port
  runs eagerly (no trace cache to probe), so the sentinel records each
  first-seen argument signature (shapes and dtypes) as a "compile": the
  first call of each shape is the warmup, and a new signature after
  :meth:`StepSentinel.mark_warm` is a **retrace** — a shape change on the
  hot dispatch, surfaced as the ``engine_retraces`` metric.

* group-heat analysis (:func:`heat_summary`, :data:`HEAT_BOUNDS`) — folds
  the device-side per-group activity accumulator into log-bucket
  histograms, a top-K table and a hot-set estimate.

* :func:`capture_profile` — on-demand ``torch.profiler`` traces into a
  bounded dump directory (the server's ``profile`` admin op).

* :func:`provenance` — the torch/CUDA/device stamp every artifact carries.

torch itself is imported lazily by the functions that need it.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "StepSentinel",
    "arg_fingerprint",
    "HEAT_BOUNDS",
    "heat_summary",
    "provenance",
    "capture_profile",
    "ProfileBusy",
]


# ---------------------------------------------------------------------------
# retrace/compile sentinel
# ---------------------------------------------------------------------------


def arg_fingerprint(args: Sequence[Any], kwargs: Optional[Dict] = None):
    """Hashable (shape, dtype) fingerprint of a call's arguments.

    Arrays collapse to ``(shape, dtype)`` — exactly the part of a call
    signature that selects a compiled program (configs are static, the
    engine is all-int32) — so a new fingerprint after warmup is a
    retrace."""

    def one(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return ("a", tuple(x.shape), str(x.dtype))
        if isinstance(x, (tuple, list)):
            return tuple(one(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, one(v)) for k, v in x.items()))
        return ("p", type(x).__name__, repr(x)[:32])

    fp = tuple(one(a) for a in args)
    if kwargs:
        fp += (tuple(sorted((k, one(v)) for k, v in kwargs.items())),)
    return fp


class StepSentinel:
    """Transparent wrapper around a step: records every new signature.

    Detection is first-sight arg fingerprints (the port's step runs
    eagerly; a wrapped callable exposing ``_cache_size()`` is probed
    instead).

    Semantics:

    * every cache growth is a **compile** (``n_compiles``);
    * a compile for a fingerprint this sentinel has *already seen*, or
      any compile after :meth:`mark_warm`, is additionally a
      **retrace** (``n_retraces``) — the hard invariant for the
      deployed hot dispatch is ``n_retraces == 0`` forever.

    Attribute access falls through to the wrapped function, so
    ``.lower(...)`` / AOT cost attribution keep working.
    """

    def __init__(self, fn: Callable, label: str = "",
                 max_events: int = 64):
        self._fn = fn
        self.label = label or getattr(fn, "__name__", "step")
        self._lock = threading.Lock()
        self._probe = getattr(fn, "_cache_size", None)
        self._seen_cache = self._cache_size()
        self._fingerprints: set = set()
        self._events: deque = deque(maxlen=max_events)
        self.n_compiles = 0
        self.n_retraces = 0
        self.warm = False

    # -- plumbing ---------------------------------------------------------

    def _cache_size(self) -> int:
        if self._probe is None:
            return -1
        try:
            return int(self._probe())
        except Exception:
            return -1

    def __getattr__(self, name):
        # transparent: anything else reaches the wrapped function
        # (note __getattr__ only fires on misses)
        return getattr(self._fn, name)

    @property
    def fn(self) -> Callable:
        """The wrapped function."""
        return self._fn

    # -- the hot path -----------------------------------------------------

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        size = self._cache_size()
        if size >= 0:
            if size > self._seen_cache:
                with self._lock:
                    delta = size - self._seen_cache
                    if delta > 0:
                        self._seen_cache = size
                        self._record(args, kwargs, wall, delta)
        else:
            # a caller's launch counter is bookkeeping, not a signature
            fp = arg_fingerprint(args, {
                k: v for k, v in kwargs.items() if k != "launch_log"
            })
            if fp not in self._fingerprints:
                with self._lock:
                    if fp not in self._fingerprints:
                        self._record(args, kwargs, wall, 1, fp=fp)
        return out

    def _record(self, args, kwargs, wall: float, n: int, fp=None) -> None:
        # lock held.  wall is the triggering call's total time (a first
        # call includes any kernel build)
        fp = arg_fingerprint(args, kwargs) if fp is None else fp
        seen_before = fp in self._fingerprints
        self._fingerprints.add(fp)
        retrace = (self.n_compiles > 0) and (self.warm or seen_before)
        self.n_compiles += n
        if retrace:
            self.n_retraces += n
        self._events.append({
            "label": self.label,
            "kind": "retrace" if retrace else "compile",
            "fingerprint": repr(fp),
            "wall_s": wall,
            "cache_size": self._seen_cache,
            "warm": self.warm,
            "t": time.time(),
        })

    # -- the invariant ----------------------------------------------------

    def mark_warm(self) -> None:
        """Declare warmup over: every compile from here on is a retrace."""
        self.warm = True

    def assert_no_retraces(self) -> None:
        """Raise if any retrace was ever observed (test-side invariant)."""
        if self.n_retraces:
            raise RuntimeError(
                f"{self.label}: {self.n_retraces} retrace(s) observed: "
                f"{list(self._events)}"
            )

    # -- export -----------------------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def stats(self) -> Dict:
        with self._lock:
            last = self._events[-1] if self._events else None
            return {
                "label": self.label,
                "compiles": self.n_compiles,
                "retraces": self.n_retraces,
                "warm": self.warm,
                "cache_size": self._seen_cache,
                "last": dict(last) if last else None,
            }


# ---------------------------------------------------------------------------
# group heat analysis (host side of the on-device [G] accumulator)
# ---------------------------------------------------------------------------

# log-spaced COUNT buckets (decisions+admissions per group per stats
# window) — not the seconds DEFAULT_BOUNDS of latency histograms
HEAT_BOUNDS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
    256.0, 512.0, 1024.0, 4096.0, 16384.0, 65536.0,
)


def heat_summary(heat, topk: int = 8,
                 name_of: Optional[Callable[[int], Optional[str]]] = None,
                 ) -> Dict:
    """Fold a cumulative per-group activity vector into the stats shape.

    Returns ``{"total", "active_groups", "top_groups": [{row, heat,
    name?}], "hot_set": {"rows", "pct_of_groups", "traffic_share"}}``
    where ``hot_set.traffic_share`` is the fraction of all activity
    carried by the top 1% of rows — the machine-readable skew estimate
    the density campaign consumes (a near-1.0 share says row capacity,
    not aggregate throughput, is the binding constraint)."""
    import numpy as np

    heat = np.asarray(heat, np.int64)
    total = int(heat.sum())
    active = int((heat > 0).sum())
    order = np.argsort(heat, kind="stable")[::-1]
    top: List[Dict] = []
    for g in order[: max(0, int(topk))]:
        h = int(heat[g])
        if h <= 0:
            break
        row: Dict = {"row": int(g), "heat": h}
        if name_of is not None:
            nm = name_of(int(g))
            if nm is not None:
                row["name"] = nm
        top.append(row)
    n_hot = max(1, -(-len(heat) // 100))  # ceil(G / 100)
    share = (
        float(heat[order[:n_hot]].sum()) / total if total else 0.0
    )
    return {
        "total": total,
        "active_groups": active,
        "top_groups": top,
        "hot_set": {
            "rows": n_hot,
            "pct_of_groups": 1.0,
            "traffic_share": share,
        },
    }


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------


def provenance(donate: Optional[bool] = None,
               extra: Optional[Dict] = None) -> Dict:
    """The toolchain stamp for artifacts: torch/CUDA versions, the device
    kind and count.  JSON-pure."""
    import platform as _platform

    import torch

    cuda = torch.cuda.is_available()
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "python": _platform.python_version(),
        "donation": donate,
    }
    if extra:
        out.update(extra)
    return out


# ---------------------------------------------------------------------------
# on-demand profiler capture (bounded dump directory)
# ---------------------------------------------------------------------------


class ProfileBusy(RuntimeError):
    """A capture is already running in this process (the profiler is a
    process-global singleton — two concurrent traces corrupt both)."""


_PROFILE_LOCK = threading.Lock()
_PROFILE_SEQ = [0]


def _rotate_dumps(root: str, max_dumps: int) -> int:
    """Keep the newest ``max_dumps`` capture dirs under ``root`` (the
    flight recorder's rotation rule): a soak poking ``profile`` in a
    loop cannot grow the directory unboundedly.  Returns removals."""
    try:
        entries = [
            os.path.join(root, e) for e in os.listdir(root)
            if os.path.isdir(os.path.join(root, e))
        ]
    except OSError:
        return 0
    entries.sort(key=lambda p: os.path.getmtime(p))
    removed = 0
    while len(entries) > max(1, int(max_dumps)):
        victim = entries.pop(0)
        shutil.rmtree(victim, ignore_errors=True)
        removed += 1
    return removed


def capture_profile(out_dir: str, seconds: float = 0.25,
                    max_dumps: int = 8, max_seconds: float = 5.0) -> Dict:
    """Capture a ``torch.profiler`` trace of whatever the process does for
    ``seconds`` (clamped to ``max_seconds``) into a fresh subdirectory of
    ``out_dir`` (a Chrome trace), then rotate the directory down to
    ``max_dumps``.  Raises :class:`ProfileBusy` when a capture is already
    in flight."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seconds = min(max(float(seconds), 0.01), float(max_seconds))
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already running")
    try:
        _PROFILE_SEQ[0] += 1
        stamp = time.strftime("%Y%m%d-%H%M%S")
        dump = os.path.join(
            out_dir, f"profile-{stamp}-{os.getpid()}-{_PROFILE_SEQ[0]}"
        )
        os.makedirs(dump, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            time.sleep(seconds)
        wall = time.perf_counter() - t0
        prof.export_chrome_trace(os.path.join(dump, "trace.json"))
        removed = _rotate_dumps(out_dir, max_dumps)
        return {
            "dir": dump, "seconds": wall, "rotated_out": removed,
        }
    finally:
        _PROFILE_LOCK.release()
