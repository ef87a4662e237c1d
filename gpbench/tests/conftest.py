"""The benchmark's own tests: ``python -m pytest gpbench/tests`` (CPU);
``python -m pytest gpbench/tests -m card`` on the card."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


TINY = {
    "configs": {
        "tiny_node": {"n_groups": 64, "n_replicas": 3, "window": 8, "req_lanes": 4},
        "tiny_ar": {"n_groups": 256, "n_replicas": 3, "window": 8, "req_lanes": 4,
                    "max_batch_size": 50, "max_outstanding_requests": 8000,
                    "zipf_theta": 0.99},
        "tiny_capped": {"n_groups": 256, "n_replicas": 3, "window": 8, "req_lanes": 4,
                        "max_batch_size": 50, "max_outstanding_requests": 40,
                        "zipf_theta": 0.99},
    },
    "traffic": {"tiny_wire": ("wire", {"rate_per_s": 1000}),
                "tiny_steady_n2": ("steady", {"steps_per_dispatch": 2}),
                "tiny_failover_n5": ("failover", {"steps_per_dispatch": 5}),
                "tiny_wire_n3": ("wire", {"rate_per_s": 1000, "steps_per_dispatch": 3})},
    # name, configuration, traffic, the cell whose metrics it reports
    "cells": [("tiny_node.steady", "tiny_node", "steady", "node_2m.steady"),
              ("tiny_node.failover", "tiny_node", "failover", "node_2m.failover"),
              ("tiny_ar.tiny_wire", "tiny_ar", "tiny_wire", None),
              ("tiny_node.steady_n2", "tiny_node", "tiny_steady_n2", "node_2m.steady"),
              ("tiny_node.failover_n5", "tiny_node", "tiny_failover_n5", "node_2m.failover"),
              ("tiny_ar.wire_n3", "tiny_ar", "tiny_wire_n3", None)],
}


def add_tiny(root: str) -> None:
    """Add tiny configurations, tiny traffic mixes and their cells to the
    checkout at ``root`` (new files and new entries; no existing file of
    ``gpbench/`` changes)."""
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    for name, conf in TINY["configs"].items():
        with open(os.path.join(root, "gpbench", "configs", name + ".json"), "w") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                                 "file": f"gpbench/configs/{name}.json", "why": "tests"})
    for name, (base, changes) in TINY["traffic"].items():
        with open(os.path.join(root, "gpbench", "traffic", base + ".json")) as f:
            mix = json.load(f)
        mix.update(changes)
        with open(os.path.join(root, "gpbench", "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for name, conf, traffic, _like in TINY["cells"]:
        bench["workloads"].append({"name": name, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "tests"})
    # a tiny node cell reports what the node cell of its load reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [name for name, _c, _t, like in TINY["cells"]
                               if like in m["workloads"]]
    with open(bench_path, "w") as f:
        json.dump(bench, f)


def checkout(tmp_path) -> str:
    """A copy of the benchmark's files (``BENCHMARK.json``, ``gpbench/``)."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "gpbench"), os.path.join(root, "gpbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    root = checkout(tmp_path)
    add_tiny(root)
    return root


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
