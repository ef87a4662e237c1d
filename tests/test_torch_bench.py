"""The port's bench (``gigapaxos_tpu_torch/testing/bench.py``) against the
JAX package, on the CPU.

* The steady and failover arms at the bench's CPU shape (G=8,192, W=8,
  K=4, R=3): the same per-chunk committed totals and bit-equal state
  leaves as the JAX package's stacked ``make_step`` driven by the root
  ``bench.py``'s ``run_chunk`` load (constant vids at every replica's
  lanes; every group re-electing every 16 steps in the failover arm).
* The dispatch ablation's parity at its CPU shape (G=512, W=8, K=4):
  bit-exact across N on the port, and the same decided counts as the
  root ``bench.py``'s ``_dispatch_parity`` (loaded with ``runpy``).
* The multichip arm on ``--device cpu`` (8 logical devices): the
  reference's JSON keys, and its load on a ``('g',)`` mesh equal to the
  JAX package's group-sharded step under the root ``bench.py``'s load.
* The CLI: the reference's JSON keys, no card and no ``--device cpu``
  raising, and the JAX package's artifact names refused.
"""

import json
import pathlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.parallel.spmd import build_replica_states as j_build
from gigapaxos_tpu.parallel.spmd import make_step as j_make_step
from gigapaxos_tpu_torch.testing import bench

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
G, W, K, R = 8_192, 8, 4, 3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain engine's many small operations on one thread: beside the
    suite's other workers a shared intra-op pool thrashes (a steady arm
    took 175 s against 14 s on one thread, under load on an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_chunks(failover: bool, n_chunks: int):
    """The root ``bench.py``'s ``run_chunk`` (``bench.py:658-673``) on the
    JAX package: per-chunk committed counts and the final states."""
    cfg = JConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    step_fn = j_make_step(cfg, None, 1)
    rids = jnp.arange(R, dtype=jnp.int32)
    groups = jnp.arange(G, dtype=jnp.int32)
    vids = jnp.arange(1, K + 1, dtype=jnp.int32)
    req = jnp.broadcast_to(vids[None, None, :], (R, G, K))
    want = jnp.zeros((R, G), dtype=bool)

    @jax.jit
    def run_chunk(states, base):
        def body(s, i):
            if failover:
                t = base + i
                sl = (groups & jnp.int32(15)) == (t & jnp.int32(15))
                target = (groups % R + 1 + (t >> 4)) % R
                w = (target[None, :] == rids[:, None]) & sl[None, :]
            else:
                w = want
            s, out = step_fn(s, req, w)
            return s, out.n_committed[0].sum()
        states, committed = jax.lax.scan(
            body, states, jnp.arange(bench.CHUNK, dtype=jnp.int32))
        return states, committed.sum()

    states = j_build(cfg)
    counts = []
    for c in range(n_chunks):
        states, n = run_chunk(states, jnp.int32(c * bench.CHUNK))
        counts.append(int(n))
    return counts, states


@pytest.mark.parametrize("failover", [False, True], ids=["steady", "failover"])
def test_headline_arms_match_the_reference(failover):
    res = bench.run_headline(G, W, K, CPU, failover)
    counts, j_states = _jax_chunks(failover, bench.WARM_CHUNKS + bench.TIMED_CHUNKS)
    assert res["warm_chunks"] + res["chunks"] == counts
    assert res["total"] == sum(counts[bench.WARM_CHUNKS:]) > 0
    for f in j_states._fields:
        a = np.asarray(getattr(j_states, f))
        b = getattr(res["states"], f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    line = bench.headline_result(res, G, CPU, failover)
    assert list(line)[:7] == ["metric", "value", "unit", "vs_baseline", "warmup_s",
                              "steady_s", "provenance"]
    assert line["metric"] == "committed_decisions_per_s" and line["value"] > 0


def test_dispatch_parity_matches_the_reference():
    ref = runpy.run_path(str(REPO / "bench.py"), run_name="reference_bench")
    want = ref["_dispatch_parity"](512, 8, 4, 3, 32)
    got = bench.dispatch_parity(512, 8, 4, 32, CPU)
    assert got == want
    assert got["bit_exact"] and got["decided_n1"] == got["decided_n8"] > 0


def test_dispatch_ablation_result(tmp_path):
    out = bench.dispatch_ablation(CPU, G=64, W=8, K=4, substeps=16,
                                  parity_substeps=16, trials=1)
    assert out["arms"]["n1"]["host_dispatches"] == 16
    assert out["arms"]["n8"]["host_dispatches"] == 2
    # the arms' warm-ups differ (2 dispatches each), so only the parity
    # run holds their decided counts equal
    assert out["arms"]["n1"]["decided"] > 0 and out["arms"]["n8"]["decided"] > 0
    assert bench.ablation_ok(out) and out["platform"] == "cpu"
    path = tmp_path / "ablation.json"
    bench.write_out(str(path), out)
    assert json.loads(path.read_text())["parity"] == out["parity"]


def test_cli_line_has_the_reference_keys(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_G", "256")
    path = tmp_path / "bench_cpu.json"
    assert bench.main(["--device", "cpu", "--out", str(path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "warmup_s",
                         "steady_s", "provenance"}
    assert line["provenance"]["card"]["platform"] == "cpu"
    assert json.loads(path.read_text()) == line


def test_capacity_record_on_the_cpu():
    cap, res = bench.capacity(512, 8, 4, CPU)
    assert cap["no_oom"] and cap["dec_per_s"] > 0 and res["total"] > 0
    assert cap["per_device_hbm_bytes"] is None   # no card memory on the CPU
    assert cap["footprint_estimate_bytes"] > cap["footprint_state_bytes"] > 0


# the keys of the reference's multichip result and of a curve point
# (bench.py:238-250, :508-533)
MULTICHIP_KEYS = {"metric", "platform", "host_cores", "n_devices_available", "mode",
                  "shape", "curve", "scaling", "provenance", "wall_s"}
POINT_KEYS = {"n_devices", "mesh_shape", "G", "groups_per_device",
              "aggregate_dec_per_s", "per_device_dec_per_s",
              "per_device_hbm_peak_bytes", "hbm_peak_bytes_by_device",
              "steps_timed", "warmup_s", "wall_s"}


def test_multichip_raises(monkeypatch, capsys, tmp_path):
    """``BENCH_MULTICHIP=1`` raises with no card and no ``--device cpu``;
    on ``--device cpu`` it runs the curve over 8 logical devices under the
    host-serialized model, with the reference's keys plus
    ``physical_devices``, written only to ``--out``."""
    monkeypatch.setenv("BENCH_MULTICHIP", "1")
    monkeypatch.setenv("BENCH_G_PER_DEVICE", "32")
    monkeypatch.setenv("BENCH_MULTICHIP_CHUNKS", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main([])
    path = tmp_path / "multichip_cpu.json"
    assert bench.main(["--device", "cpu", "--out", str(path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(path.read_text()) == line
    assert set(line) == MULTICHIP_KEYS | {"physical_devices"}
    assert line["platform"] == "cpu" and line["physical_devices"] == 1
    assert line["n_devices_available"] == 8
    assert [p["n_devices"] for p in line["curve"]] == [1, 2, 4, 8]
    for p in line["curve"]:
        assert set(p) == POINT_KEYS | {"physical_devices"}
        assert p["G"] == 32 * p["n_devices"] and p["aggregate_dec_per_s"] > 0
        assert p["hbm_peak_bytes_by_device"] == [None] * p["n_devices"]
    sc = line["scaling"]
    assert sc["at_n_devices"] == 8
    assert sc["linear_model"].startswith("host-serialized")
    assert sc["efficiency_vs_linear"] == sc["efficiency_serialized_model"]


def test_multichip_load_matches_the_reference():
    """The multichip arm's load on a ('g',) mesh of 4 logical devices
    against the JAX package's group-sharded step under the root
    ``bench.py``'s load (``_run_group_sharded_point``): the same committed
    count per chunk and bit-equal states."""
    from gigapaxos_tpu.parallel import mesh as jmesh
    from gigapaxos_tpu.parallel import spmd as jspmd
    from gigapaxos_tpu_torch.ops.engine import EngineConfig
    from gigapaxos_tpu_torch.parallel import mesh as tmesh

    n, gpd, W_, K_ = 4, 64, 8, 4
    G_ = n * gpd
    jcfg = JConfig(n_groups=G_, window=W_, req_lanes=K_, n_replicas=R)
    jm = jmesh.make_group_mesh(n)
    sj, _r, _w = jspmd.shard_group_inputs(
        jm, jcfg, j_build(jcfg), np.full((R, G_, K_), -1, np.int32),
        np.zeros((R, G_), bool))
    j_step = j_make_step(jcfg, jm, 1)
    req = jnp.broadcast_to(jnp.arange(1, K_ + 1, dtype=jnp.int32)[None, None, :],
                           (R, G_, K_))
    want = jnp.zeros((R, G_), bool)
    load = bench.ShardedLoad(EngineConfig(G_, W_, K_, R),
                             tmesh.make_group_mesh(n, devices=["cpu"] * n))
    for c in range(3):
        committed = 0
        for _ in range(bench.CHUNK):
            sj, out = j_step(sj, req, want)
            committed += int(np.asarray(out.n_committed)[0].sum())
        assert load.chunk() == committed > 0, c
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      np.asarray(getattr(load.states, f)), err_msg=f)


def test_no_card_and_no_device_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    monkeypatch.setenv("BENCH_G", "256")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("name", ["BENCH_r07.json", "CAPACITY_r03.json",
                                  "MULTICHIP_r07.json", "TPU_EVIDENCE.json",
                                  "PERF_BASELINE.json"])
def test_reference_artifact_names_refused(name, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_G", "256")
    with pytest.raises(ValueError, match="JAX package's artifact"):
        bench.main(["--device", "cpu", "--out", str(tmp_path / name)])
    assert not (tmp_path / name).exists()
