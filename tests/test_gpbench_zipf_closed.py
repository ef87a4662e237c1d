"""The ``zipf_2m.closed`` cell's pieces on the CPU: the ``closed_zipf``
load through the program's plain engine at tiny sizes, held against the
benchmark's frozen reference; planted faults and the control each read
not correct; the Zipf sampler, the batch cap, the closed loop's
outstanding requests and the busy group-steps count; and the harness
finding the new cells, ``zipf_2m.closed`` and ``node_2m.n8``, in a copy
of the checkout where nothing existing was edited."""

import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from gpbench import harness
from gpbench.control import ReferenceSystem
from gpbench.load import NULL, Spans
from gpbench.loads import closed_zipf
from gpbench.reference import busy_roofline, roofline
from gpbench.reference.paxos import Replicas
from gpbench.system import Port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [2 ** 31 + 101, 5200000102]


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


ZIPF = _json("gpbench", "configs", "zipf_2m.json")
MIX = _json("gpbench", "traffic", "zipf_closed.json")
SHORT = dict(MIX, steps_per_chunk=5, warmup_chunks=1)   # fewer steps, the same loop
# zipf_2m's shape at a tiny scale: every key but the sizes as the cell's
TINY = dict(ZIPF, n_groups=64, window=8, req_lanes=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drive(seed, config=TINY, load=closed_zipf.Load, system=None, chunks=3, mix=SHORT):
    """Set up, run ``chunks`` chunks as the window and check, as the
    harness does; returns (the load, the check's result, correct)."""
    gen = load(config, mix, seed, system or Port("cpu"), Spans())
    gen.setup()
    gen.open_window(0.0)
    for _ in range(chunks):
        gen.chunk()
    gen.close_window(1.0)
    gen.finish()
    res = gen.check(Replicas)
    return gen, res, all(v <= lim for v, lim in res["checks"].values())


@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_cell_is_correct(seed):
    gen, res, ok = drive(seed, mix=MIX)
    assert ok, res["checks"]
    assert set(res["checks"]) == {"state_words_differ", "out_words_differ",
                                  "committed_groups_differ", "requests_differ",
                                  "outstanding_off"}
    d = gen.diagnostics()
    assert d["slots_decided"] > 0 and d["requests_decided"] >= d["slots_decided"]
    assert d["outstanding_min"] == d["outstanding_max"] == 8000
    assert res["failed"] == 0 and res["steps"] == gen.t


class LostAdmission(closed_zipf.Load):
    """Misses the admission of one group in five: their requests stay
    waiting after they were proposed, and are proposed again."""

    def _admitted(self, out):
        return super()._admitted(out) & (torch.arange(self.G) % 5 != 0)


class UncountedRequest(closed_zipf.Load):
    """Counts one request less in every step that decided any."""

    def _decided(self, exec_vid, n_slots):
        n = super()._decided(exec_vid, n_slots)
        return n - (n > 0).to(n.dtype)


@pytest.mark.parametrize("fault, check", [(LostAdmission, "outstanding_off"),
                                          (UncountedRequest, "requests_differ")])
def test_planted_faults_read_not_correct(fault, check):
    _gen, res, ok = drive(SEEDS[0], load=fault)
    assert not ok
    assert res["checks"][check][0] > 0


@pytest.mark.parametrize("sound", [False, True])
def test_control_and_sound_reference(sound):
    """The reference in the program's place: its coordinator a quorum of
    one (the control) reads not correct; unbroken, correct."""
    _gen, res, ok = drive(SEEDS[1], system=ReferenceSystem("cpu", sound=sound))
    assert ok == sound, res["checks"]
    if not sound:
        assert res["checks"]["state_words_differ"][0] > 0


def test_sampler_matches_zipf():
    """Rank frequencies of 400,000 draws against Zipf(0.99) over 1,000
    names: every one of the 50 hottest ranks within 5 standard deviations
    of its binomial count, and the largest distance between the drawn and
    the law's CDF under 1.63 / sqrt(n) (Kolmogorov-Smirnov at 1%).
    At the cell's 2,000,000 names the hottest name draws 6.18% of the
    requests, the top 8 16.9%, the top 1,000 47.7%."""
    G, n = 1000, 400_000
    cdf = closed_zipf.zipf_cdf(G, 0.99, "cpu")
    gen = torch.Generator().manual_seed(7)
    ranks = closed_zipf.zipf_ranks(cdf, torch.rand(n, generator=gen, dtype=torch.float64))
    assert int(ranks.min()) >= 0 and int(ranks.max()) < G
    freq = np.bincount(ranks.numpy(), minlength=G) / n
    w = 1.0 / np.arange(1, G + 1) ** 0.99
    p = w / w.sum()
    sd = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq[:50] - p[:50]) <= 5 * sd[:50])
    assert np.abs(np.cumsum(freq) - np.cumsum(p)).max() < 1.63 / np.sqrt(n)
    big = closed_zipf.zipf_cdf(2_000_000, 0.99, "cpu")
    assert float(big[-1]) == 1.0
    assert abs(float(big[0]) - 0.0618) < 5e-4
    assert abs(float(big[7]) - 0.169) < 5e-4
    assert abs(float(big[999]) - 0.477) < 5e-4


def test_one_pass_count_of_decided_requests():
    """``decided_total`` (one sum of the words, taken modulo 2**16) equals
    the row-by-row count where the int32 sum wraps many times over: up to
    3 decided lanes a row, a fifth of them no-ops, tags up to 2**14."""
    g = torch.Generator().manual_seed(3)
    G, W = 16384, 32
    n_c = torch.randint(0, 4, (G,), generator=g, dtype=torch.int32)
    tag = torch.randint(0, closed_zipf.TAG_MASK + 1, (G, W), generator=g, dtype=torch.int32)
    size = torch.randint(1, 3, (G, W), generator=g, dtype=torch.int32)
    noop = torch.rand((G, W), generator=g) < 0.2
    lane = torch.arange(W)[None, :] < n_c[:, None]
    vid = torch.where(noop, 0, (tag << closed_zipf.SIZE_BITS) | size)
    ev = torch.where(lane, vid, NULL)
    exact = closed_zipf.decided_requests(ev, n_c)
    assert int(exact.sum()) == int(torch.where(lane & ~noop, size, 0).sum()) < 1 << 16
    assert int(ev.sum(dtype=torch.int64)) > 1 << 40          # the int32 sum wraps
    assert int(closed_zipf.decided_total(ev, n_c.sum(dtype=torch.int32))) == int(exact.sum())


@pytest.mark.parametrize("n_groups, max_batch", [(16, 2000), (64, 50)])
def test_no_proposal_exceeds_the_batch_cap(n_groups, max_batch):
    """Every group is in the sample at these sizes, so every proposal
    offered is recorded: none carries more than ``max_batch_size``, and
    the cap binds (16 names: the hottest draws about 2,300 of the first
    8,000 requests)."""
    conf = dict(TINY, n_groups=n_groups, max_batch_size=max_batch)
    gen, res, ok = drive(SEEDS[0], config=conf)
    assert ok, res["checks"]
    assert len(gen.sample) == n_groups
    offers = gen.offers.numpy()
    sizes = offers[offers != NULL] & closed_zipf.SIZE_MASK
    assert sizes.min() >= 1 and sizes.max() == max_batch
    assert gen.diagnostics()["batch_max"] == max_batch
    assert offers.max() < 1 << 30      # no vid reaches the stop bit


@pytest.mark.parametrize("max_out", [8000, 37])
def test_requests_outstanding_hold_at_every_step(max_out):
    gen, res, ok = drive(SEEDS[1], config=dict(TINY, max_outstanding_requests=max_out))
    assert ok, res["checks"]
    d = gen.diagnostics()
    assert d["outstanding_min"] == d["outstanding_max"] == max_out
    assert res["checks"]["outstanding_off"] == (0, 0)


def test_busy_group_steps_recount():
    """The busy group-steps the load counts on the card equal a recount
    from the offers it recorded and the reference's commits (every group
    sampled at 16 names), and the busy count's bytes are the stacked
    face's per-group bytes times it, never above the whole face's."""
    conf = dict(TINY, n_groups=16)
    gen, _res, ok = drive(SEEDS[0], config=conf)
    assert ok
    G, R, K = gen.G, gen.R, gen.K
    ref = Replicas(gen.sample, R, gen.W, K)
    mine = torch.arange(R)[:, None] == torch.as_tensor(gen.sample % R)[None, :]
    req = torch.full((R, G, K), NULL, dtype=torch.int32)
    busy = 0
    for t in range(gen.t):
        req[:, :, 0] = torch.where(mine, gen.offers[t][None, :], NULL)
        out = ref.step(req, torch.zeros((R, G), dtype=torch.bool))
        committed = ref.per_replica(out.n_committed).amax(0) > 0
        busy += int(((gen.offers[t] != NULL) | committed).sum())
    total = dict(zip(closed_zipf.COUNTERS, gen.ctr.tolist()))["busy"]
    assert total == busy > 0
    per_group = busy_roofline.group_bytes(gen.W, K, R)
    assert per_group * G + R * R == roofline.stacked_bytes(G, gen.W, K, R)
    assert busy_roofline.busy_bytes(busy, gen.W, K, R) == busy * per_group
    assert busy_roofline.busy_bytes(busy, gen.W, K, R) <= gen.t * roofline.stacked_bytes(
        G, gen.W, K, R)


class _Op:
    def __init__(self, us):
        self.start, self.end = 0.0, us


class _Timeline:
    def __init__(self, kernel_us):
        self.kernel_us = kernel_us

    def face_kernels(self):
        return [_Op(u) for u in self.kernel_us]


def test_busy_step_roofline_reader():
    """At zipf_2m's widths: the reader's share is the busy bytes at
    3.35e12 B/s over the face kernels' time, and reads nothing where the
    trace context has no busy count (a load without the counter) or the
    window no face kernel."""
    read = harness.reader("busy_step_roofline")
    ctx = {"W": 32, "K": 16, "R": 3, "card": "NVIDIA H100 80GB HBM3",
           "busy_group_steps": 54_000}
    need_s = 54_000 * busy_roofline.group_bytes(32, 16, 3) / 3.35e12
    assert read(_Timeline([1000.0, 2000.0]), ctx) == pytest.approx(
        100.0 * need_s / 3e-3, rel=1e-12)
    assert read(_Timeline([1000.0]), {k: v for k, v in ctx.items()
                                       if k != "busy_group_steps"}) is None
    assert read(_Timeline([]), ctx) is None


def _digests(root):
    out = {}
    for base, _dirs, files in os.walk(os.path.join(root, "gpbench")):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_harness_finds_the_new_cells(tmp_path):
    """In a copy of the benchmark's files, the harness resolves both new
    cells to their configuration, mix, load and readers; tiny cells of
    their two mixes, added as new files and entries only (no existing
    file changes), run through the harness and read correct."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "gpbench"), os.path.join(root, "gpbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root)
    bench = harness.read_json(os.path.join(root, "BENCHMARK.json"))
    for name, load, n in (("zipf_2m.closed", "closed_zipf", 1), ("node_2m.n8", "stacked", 8)):
        cell = harness.find_cell(bench, name)
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        config, traffic = harness.pieces(bench, cell, root)
        assert config["n_groups"] == 2_000_000 and traffic["load"] == load
        assert traffic.get("steps_per_dispatch", 1) == n
        assert harness.load_class(load, root).__name__ == "Load"
        per = harness.metrics_for(bench, "per_layer", name)
        e2e = {m["name"] for m in harness.metrics_for(bench, "end_to_end", name)}
        assert {"decisions_per_s", "device_bytes_per_group", "setup_s"} <= e2e
        for m in per:
            assert m["moves"] in e2e
            assert os.path.exists(harness.reader_path(m["name"], root))
    names = {m["name"] for m in harness.metrics_for(bench, "per_layer", "zipf_2m.closed")}
    assert "busy_step_roofline" in names and "stacked_step_roofline" not in names
    names = {m["name"] for m in harness.metrics_for(bench, "per_layer", "node_2m.n8")}
    assert "stacked_step_roofline" in names and "busy_step_roofline" not in names

    # tiny cells of both mixes, as new files and entries
    tiny_node = {"n_groups": 64, "n_replicas": 3, "window": 8, "req_lanes": 4}
    for name, conf in (("tiny_zipf", TINY), ("tiny_node", tiny_node)):
        with open(os.path.join(root, "gpbench", "configs", name + ".json"), "w") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                                 "file": f"gpbench/configs/{name}.json", "why": "tests"})
    with open(os.path.join(root, "gpbench", "traffic", "tiny_zipf_closed.json"), "w") as f:
        json.dump(dict(MIX, steps_per_chunk=2, warmup_chunks=1), f)
    like = {"tiny_zipf.closed": "zipf_2m.closed", "tiny_node.n8": "node_2m.n8"}
    for name, mix in (("tiny_zipf.closed", "tiny_zipf_closed"), ("tiny_node.n8", "steady_n8")):
        bench["workloads"].append({"name": name, "config": name.split(".")[0],
                                   "traffic": mix, "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).extend(n for n, c in like.items() if c in m.get("workloads", ()))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert {k: after[k] for k in before} == before

    res = harness.run("tiny_zipf.closed", SEEDS[0], 0.2, True, "cpu", time.perf_counter(),
                      root=root, trace_path=str(tmp_path / "trace.json"))
    assert res["correct"], res["checks"]
    assert res["run"]["outstanding_min"] == res["run"]["outstanding_max"] == 8000
    assert res["run"]["busy_group_steps"] > 0
    assert set(res["run"]["window_span_s"]) >= {"offer", "face", "close", "sync"}
    res = harness.run("tiny_node.n8", SEEDS[1], 0.2, False, "cpu", time.perf_counter(),
                      root=root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"decisions_per_s", "device_bytes_per_group", "setup_s"}
    assert res["run"]["steps"] % 16 == 0
