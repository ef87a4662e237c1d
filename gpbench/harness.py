"""One run of one cell: find its pieces by name, set up, measure, check.

``BENCHMARK.json`` names the cell; its configuration is
``gpbench/configs/<config>.json``, its traffic ``gpbench/traffic/<mix>.json``,
whose ``load`` names the generator ``gpbench/loads/<load>.py`` (its class
``Load``; see :mod:`gpbench.load`), and every per-layer metric ``<name>``
is read by ``gpbench/metrics/<name>.py``, or, for a name ``<base>.<part>``
with no file of its own, by ``gpbench/metrics/<base>.py``.  Nothing here
names a cell, a configuration, a mix, a load or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict, Optional

import torch

from . import load, trace
from .reference.paxos import Replicas

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def pieces(bench: dict, cell: dict, root: str = ROOT):
    """The cell's configuration and traffic mix, read from their files."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(root, "gpbench", "traffic", cell["traffic"] + ".json"))
    return config, traffic


def metrics_for(bench: dict, kind: str, workload: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def _module(path: str, prefix: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, root: str = ROOT) -> str:
    """The file that reads the per-layer metric ``name``."""
    base = os.path.join(root, "gpbench", "metrics")
    own = os.path.join(base, name + ".py")
    return own if os.path.exists(own) else os.path.join(base, name.split(".")[0] + ".py")


def reader(name: str, root: str = ROOT):
    """The per-layer metric ``name``'s ``read(timeline, context)``."""
    return _module(reader_path(name, root), "gpbench_metric_").read


def load_class(name: str, root: str = ROOT):
    """``gpbench/loads/<name>.py``'s ``Load``."""
    return _module(os.path.join(root, "gpbench", "loads", name + ".py"), "gpbench_load_").Load


def card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        started: float, system=None, reference=Replicas, root: str = ROOT,
        trace_path: Optional[str] = None) -> Dict:
    """One run; returns the result line's object.  ``started`` is the
    process's start on the ``time.perf_counter`` clock; ``system`` the
    system under test (default: the program on ``device``)."""
    device = torch.device(device)
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cell = find_cell(bench, workload)
    config, traffic = pieces(bench, cell, root)
    if system is None:
        from .system import Port
        system = Port(device)
    spans = load.Spans()
    gen = load_class(traffic["load"], root)(config, traffic, seed, system, spans)
    t_gen = time.perf_counter()
    if traced:
        trace.prime()
    gen.setup()
    load.sync(device)
    setup_s = time.perf_counter() - started
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    gen.open_window(t0)
    if traced:
        tl = trace.capture(gen.chunk, spans, trace_path or os.path.join(
            root, "build", "gpbench", f"trace-{workload}.json"))
    else:
        spans.recording = True
        while time.perf_counter() - t0 < seconds:
            gen.chunk()
        spans.recording = False
    t1 = time.perf_counter()
    gen.close_window(t1)
    window_peak = _peak(device)
    gen.finish()
    e2e, attempted = gen.window_metrics(t1 - t0)
    e2e.update(device_bytes_per_group=window_peak / gen.G, setup_s=setup_s)

    metrics: Dict[str, Dict] = {}
    dev_info: Dict = {}
    breakdown = None
    if traced:
        ctx = dict(gen.trace_context(trace.RECORD), card=card_name(device),
                   spans=dict(spans.seconds))
        for m in metrics_for(bench, "per_layer", workload):
            value = reader(m["name"], root)(tl, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = trace.summary(tl) or {}
        breakdown = {"device_ops": tl.device_ops(), "idle_gaps": tl.idle_gaps()}
    else:
        for m in metrics_for(bench, "end_to_end", workload):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    load.sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result = gen.check(reference)
    checks = result["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    out = {
        "correct": correct,
        "attempted": int(attempted),
        "failed": int(result["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": card_name(device),
            "count": int(cell["chips"]),
            "memory_peak_bytes": max(setup_peak, window_peak),
            **dev_info,
        },
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["run"] = {"steps": result["steps"], "setup_s": setup_s,
                  "setup_parts": dict(gen.setup_parts, start=t_gen - started),
                  "window_s": t1 - t0, "check_s": time.perf_counter() - t_check,
                  "window_span_s": dict(spans.seconds), **gen.diagnostics()}
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return out
