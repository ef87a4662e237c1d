"""The traced window: a ``torch.profiler`` capture of a few chunks, read
back from its Chrome trace into the device timeline the per-layer
metrics are taken from.

The capture runs the load's chunks under a profiler schedule (chunks
that are skipped, then warm the profiler, then are recorded), with the
benchmark's spans annotated (``gpbench.<name>``).  Every chunk ends in a
device sync, so the recorded chunks' host span bounds the device work
they issued: the traced window is that span, from the first recorded
chunk's start to the last one's end.

The timeline keeps, in the trace's microseconds:

* the device operations (kernels, copies, fills), each with the host
  time at which it was launched where the trace links the two;
* the benchmark's spans.

Kernels and copies launched inside a ``gpbench.face`` span are the step
face's own work.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "fill"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CHUNK = "gpbench.chunk"
RECORD = 3   # chunks recorded (after one skipped and one that warms the profiler)


class Op:
    __slots__ = ("kind", "name", "start", "end", "launched")

    def __init__(self, kind, name, start, end, launched):
        self.kind, self.name, self.start, self.end = kind, name, start, end
        self.launched = launched


class Timeline:
    def __init__(self, ops: List[Op], spans: List[Tuple[str, float, float]]):
        self.ops = ops
        self.spans = spans
        chunks = [(s, e) for n, s, e in spans if n == CHUNK]
        self.window = (min(s for s, _ in chunks), max(e for _, e in chunks)) if chunks else None

    @classmethod
    def from_chrome(cls, path: str) -> "Timeline":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        launches: Dict[int, float] = {}
        raw, spans = [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                raw.append((DEVICE_CATS[cat], ev.get("name", ""), ts, ts + dur,
                            args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[int(args["correlation"])] = ts
            elif cat == "user_annotation" and str(ev.get("name", "")).startswith("gpbench."):
                spans.append((ev["name"], ts, ts + dur))
        ops = [Op(k, n, s, e, launches.get(int(c)) if c is not None else None)
               for k, n, s, e, c in raw]
        ops.sort(key=lambda o: o.start)
        spans.sort(key=lambda x: x[1])
        return cls(ops, spans)

    # -- the window ---------------------------------------------------------
    def window_us(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def in_window(self) -> List[Op]:
        if not self.window:
            return []
        lo, hi = self.window
        return [o for o in self.ops if o.end > lo and o.start < hi]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of every device operation's interval, clipped to the
        window."""
        lo, hi = self.window or (0.0, 0.0)
        merged: List[List[float]] = []
        for o in self.in_window():
            s, e = max(o.start, lo), min(o.end, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def launched_in(self, span: str) -> List[Op]:
        """Operations in the window launched from inside a ``span``."""
        iv = [(s, e) for n, s, e in self.spans if n == span]
        starts = [s for s, _ in iv]
        out = []
        for o in self.in_window():
            if o.launched is None:
                continue
            i = bisect.bisect_right(starts, o.launched) - 1
            if i >= 0 and o.launched <= iv[i][1]:
                out.append(o)
        return out

    def face_kernels(self) -> List[Op]:
        """The kernels the step faces launched in the window."""
        return [o for o in self.launched_in("gpbench.face") if o.kind == "kernel"]

    # -- what the next reader of the ledger sees ----------------------------
    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        lo, hi = self.window or (0.0, 0.0)
        for o in self.in_window():
            total[o.name] = total.get(o.name, 0.0) + (min(o.end, hi) - max(o.start, lo))
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], us * 1e-6] for name, us in best]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time in the window, split by the benchmark span the
        host was in meanwhile (``host`` where it was in none but the
        chunk)."""
        if not self.window:
            return []
        lo, hi = self.window
        inner = [(n, s, e) for n, s, e in self.spans if n != CHUNK]
        gaps, at = [], lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        total: Dict[str, float] = {}
        for s, e in gaps:
            covered = 0.0
            for name, a, b in inner:
                if a >= e:
                    break
                part = min(b, e) - max(a, s)
                if part > 0:
                    total[name] = total.get(name, 0.0) + part
                    covered += part
            if e - s > covered:
                total["host"] = total.get("host", 0.0) + (e - s - covered)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us * 1e-6] for name, us in best]


def prime() -> None:
    """Start and stop the profiler once, so that its one-time start (the
    CUPTI set-up, seconds on this card) falls in set-up, not in the
    traced window's load."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu")


def capture(run_chunk: Callable[[], None], spans, path: str, skip: int = 1,
            warm: int = 1, record: int = RECORD) -> Timeline:
    """Run ``skip + warm + record`` chunks under the profiler and return
    the recorded chunks' timeline; the Chrome trace is written to
    ``path`` (overwritten)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    done: List[bool] = []

    def ready(prof) -> None:
        prof.export_chrome_trace(path)
        done.append(True)

    spans.annotate = True
    try:
        with profile(activities=acts, on_trace_ready=ready,
                     schedule=schedule(wait=skip, warmup=warm, active=record,
                                       repeat=1)) as prof:
            for i in range(skip + warm + record):
                spans.recording = i >= skip + warm
                with spans("chunk"):
                    run_chunk()
                prof.step()
    finally:
        spans.annotate = False
        spans.recording = False
    if not done:
        raise RuntimeError("the profiler wrote no trace")
    return Timeline.from_chrome(path)


def summary(tl: Timeline) -> Optional[Dict]:
    """``busy_s`` and ``window_s`` of the traced window, or None if the
    trace holds no window."""
    if not tl.window:
        return None
    return {"busy_s": tl.busy_us() * 1e-6, "window_s": tl.window_us() * 1e-6}
