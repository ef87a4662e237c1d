"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every piece by name: configurations, traffic mixes, a load and a
per-layer metric added as new files, and cells and metrics (the wire
cell's among them) added as new entries, in a copy of the checkout with
no existing file edited, run as cells."""

import hashlib
import json
import os
import re
import time

import pytest

from gpbench import harness

from .conftest import ROOT, add_tiny, checkout

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(TEXT.fullmatch(w) for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and TEXT.fullmatch(c["source"])
        assert TEXT.fullmatch(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith("gpbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and TEXT.fullmatch(w["why"])
        mix = os.path.join(ROOT, "gpbench", "traffic", w["traffic"] + ".json")
        with open(mix) as f:
            load = json.load(f)["load"]
        assert os.path.exists(os.path.join(ROOT, "gpbench", "loads", load + ".py"))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and TEXT.fullmatch(m["layer"])
        assert os.path.exists(harness.reader_path(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names) and len(cells) == len(bench["workloads"])
    assert len(set(metrics)) == len(metrics)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = harness.metrics_for(bench, "end_to_end", w["name"])
        per = harness.metrics_for(bench, "per_layer", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per
        for m in per:   # a per-layer metric's cells report what it moves
            assert m["moves"] in {x["name"] for x in e2e}


def _digests(root):
    out = {}
    for base, _dirs, files in os.walk(os.path.join(root, "gpbench")):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


DUMMY_METRIC = '''"""A dummy per-layer metric: steps in the traced window."""


def read(tl, ctx):
    return float(ctx["steps"])
'''

# the wire cell's per-layer metrics, each read by a file already there
WIRE_METRICS = [("packed_step_roofline", "%", "kernels"),
                ("launches_per_step.wire", "launches/step", "kernels"),
                ("device_idle_pct.wire", "%", "device"),
                ("copy_ms.wire", "ms", "device"),
                ("face_host_ms.wire", "ms", "step faces")]

DUMMY_LOAD = '''"""A dummy load: the stacked load, counting its chunks."""

from gpbench.loads.stacked import Load as Stacked


class Load(Stacked):
    def chunk(self):
        self.chunks = getattr(self, "chunks", 0) + 1
        super().chunk()

    def diagnostics(self):
        return {"dummy_chunks": self.chunks}
'''


def test_new_pieces_are_found_by_name(tmp_path):
    root = checkout(tmp_path)
    before = _digests(root)
    add_tiny(root)    # configuration files, traffic files, their cells
    with open(os.path.join(root, "gpbench", "metrics", "dummy_steps.py"), "w") as f:
        f.write(DUMMY_METRIC)
    with open(os.path.join(root, "gpbench", "loads", "dummy_load.py"), "w") as f:
        f.write(DUMMY_LOAD)
    with open(os.path.join(root, "gpbench", "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"load": "dummy_load", "steps_per_dispatch": 2, "steps_per_chunk": 4,
                   "warmup_chunks": 1}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny_node.dummy", "config": "tiny_node",
                               "traffic": "dummy_mix", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:
        if "tiny_node.steady" in m.get("workloads", ()):
            m["workloads"].append("tiny_node.dummy")
    wire = ["tiny_ar.tiny_wire", "tiny_ar.wire_n3"]
    bench["end_to_end"].append({"name": "commit_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": wire})
    for name, unit, layer in WIRE_METRICS:
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": "device_trace", "layer": layer,
                                   "moves": "commit_p95_ms", "workloads": wire})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step faces",
                               "moves": "commit_p95_ms",
                               "workloads": ["tiny_ar.tiny_wire"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert {k: after[k] for k in before} == before      # nothing edited
    res = harness.run("tiny_ar.tiny_wire", 9, 0.3, True, "cpu", time.perf_counter(),
                      root=root, trace_path=str(tmp_path / "trace.json"))
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_steps"]["value"] > 0
    assert res["metrics"]["face_host_ms.wire"]["value"] > 0
    res = harness.run("tiny_node.steady", 9, 0.3, False, "cpu", time.perf_counter(), root=root)
    assert res["correct"] and set(res["metrics"]) == {
        "decisions_per_s", "device_bytes_per_group", "setup_s"}
    res = harness.run("tiny_ar.tiny_wire", 9, 0.3, False, "cpu", time.perf_counter(), root=root)
    assert res["correct"] and set(res["metrics"]) == {
        "commit_p95_ms", "device_bytes_per_group", "setup_s"}
    assert list(res)[-1] == "checks"
    res = harness.run("tiny_node.dummy", 9, 0.3, False, "cpu", time.perf_counter(), root=root)
    assert res["correct"] and res["run"]["dummy_chunks"] > 1
    assert "decisions_per_s" in res["metrics"]
