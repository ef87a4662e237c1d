"""The recovery plane on both packages: ``tests/test_recovery.py`` run on
the JAX package and the port (``device="cpu"``), under the native journal
and ``GP_NO_NATIVE=1``.

Sharded checkpoints (manifest hashes, torn-shard fallback, a kill in the
middle of a shard write), segmented parallel replay and a crash in the
middle of a replay give equal recovered arrays, payloads, decisions,
metadata and ``recovery_stats`` counts on both packages, and each package
recovers the other's sharded checkpoint and multi-file journal.  The lazy
hydration gates of a restarted manager (hot names served, cold names
held, checkpoints deferred, the drain) behave the same on both, with
equal engine leaves and app totals.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH, assert_leaves_equal, leaves


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


@pytest.fixture(params=["native", "python"])
def native_mode(request, monkeypatch):
    """Journal-touching scenarios under both CRC/append paths."""
    if request.param == "python":
        monkeypatch.setenv("GP_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    for pkg in PKGS:
        pkg.mod("native")._libs.clear()
    yield request.param
    for pkg in PKGS:
        pkg.mod("native")._libs.clear()


def _cfg(pkg):
    return pkg.mod("ops.engine").EngineConfig(
        n_groups=8, window=4, req_lanes=2, n_replicas=3)


def _state_arrays(pkg):
    init = pkg.mod("ops.engine").init_state(_cfg(pkg), **pkg.dev)
    return {k: np.array(np.asarray(v), copy=True) for k, v in init._asdict().items()}


def _set(pkg, **kw):
    for k, v in kw.items():
        pkg.mod("utils.config").Config.set(k, str(v))


def _logger(pkg, d, shards=4, **kw):
    _set(pkg, RECOVERY_CHECKPOINT_SHARDS=shards)
    return pkg.mod("storage").PaxosLogger(0, str(d), **kw)


def _seed_groups(lg, n=4):
    lg.log_create(np.arange(n), np.full(n, 0b111), np.zeros(n, np.int64),
                  np.zeros(n, np.int64))


STAT_COUNTS = ("checkpoint_generation", "segments", "blocks")


def _rec(rec):
    """A RecoveryResult as plain comparable values (``recovery_stats``
    counts; no times)."""
    return {
        "arrays": {k: np.asarray(v).tolist() for k, v in rec.arrays.items()},
        "payloads": dict(rec.payloads),
        "decisions": {g: dict(d) for g, d in rec.decisions.items()},
        "app_states": rec.meta.get("app_states"),
        "stats": {k: rec.stats.get(k) for k in STAT_COUNTS},
    }


def _both(scenario, tmp_path, *args):
    got = {pkg.root: scenario(pkg, tmp_path / pkg.root, *args) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    return got[TORCH.root]


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------


def _sharded_vs_legacy(pkg, d):
    out = {}
    for mode, shards in (("sharded", 4), ("legacy", 1)):
        lg = _logger(pkg, d / mode, shards=shards)
        _seed_groups(lg)
        lg.log_accepts(np.array([0, 1]), np.array([0, 0]),
                       np.array([32, 32]), np.array([100, 200]))
        rec = lg.recover(4, seed_arrays=_state_arrays(pkg))
        lg.checkpoint(rec.arrays, {"svc0": "s0", "svc1": "s1"},
                      {"names": {"svc0": 0, "svc1": 1}})
        lg.log_decisions(np.array([0]), np.array([0]), np.array([100]))
        lg.close()
        lg2 = _logger(pkg, d / mode, shards=shards)
        out[mode] = _rec(lg2.recover(4))
        lg2.close()
    return out


def test_sharded_recover_matches_legacy(tmp_path, native_mode):
    r = _both(_sharded_vs_legacy, tmp_path)
    a, b = r["sharded"], r["legacy"]
    for k in ("arrays", "payloads", "decisions", "app_states"):
        assert a[k] == b[k], k


def _tear(d, offset, data):
    with open(os.path.join(str(d), "manifest.json")) as f:
        victim = json.load(f)["shards"][0]["file"]
    with open(os.path.join(str(d), victim), "r+b") as f:
        f.seek(offset)
        f.write(data)


def _torn_shard(pkg, d):
    lg = _logger(pkg, d)
    _seed_groups(lg)
    rec0 = lg.recover(4, seed_arrays=_state_arrays(pkg))
    lg.checkpoint(rec0.arrays, {"svc": "gen1"}, {"names": {"svc": 0}})
    lg.log_decisions(np.array([0, 0]), np.array([0, 1]), np.array([7, 8]))
    lg.log_payloads({7: "p7", 8: "p8"})
    rec1 = lg.recover(4)
    lg.checkpoint(rec1.arrays, {"svc": "gen2"}, {"names": {"svc": 0}})
    lg.close()
    gen = pkg.mod("storage.checkpoint").load_checkpoint_view(str(d)).generation
    _tear(d, 40, b"TORNTORN")
    lg2 = _logger(pkg, d)
    rec2 = _rec(lg2.recover(4))
    lg2.close()
    return {"gen_before": gen, "rec": rec2}


def test_torn_shard_falls_back_to_prev_anchor(tmp_path, native_mode):
    r = _both(_torn_shard, tmp_path)
    assert r["gen_before"] == 2
    assert r["rec"]["stats"]["checkpoint_generation"] == 1
    assert r["rec"]["app_states"] == {"svc": "gen1"}
    assert r["rec"]["decisions"][0] == {0: 7, 1: 8}
    assert r["rec"]["payloads"] == {7: "p7", 8: "p8"}


def _kill_mid_write(pkg, d, monkeypatch):
    lg = _logger(pkg, d)
    _seed_groups(lg)
    rec0 = lg.recover(4, seed_arrays=_state_arrays(pkg))
    lg.checkpoint(rec0.arrays, {"svc": "gen1"}, {"names": {"svc": 0}})
    ck = pkg.mod("storage.checkpoint")
    real_write = ck._fsync_write

    def die_at_manifest(path, data):
        if ck.MANIFEST in path:
            raise OSError("simulated crash mid-checkpoint")
        real_write(path, data)

    monkeypatch.setattr(ck, "_fsync_write", die_at_manifest)
    with pytest.raises(OSError):
        lg.checkpoint(rec0.arrays, {"svc": "gen2"}, {"names": {"svc": 0}})
    monkeypatch.setattr(ck, "_fsync_write", real_write)
    lg.close()
    lg2 = _logger(pkg, d)
    rec = _rec(lg2.recover(4))
    lg2.close()
    return rec


def test_kill_mid_checkpoint_shard_write(tmp_path, native_mode, monkeypatch):
    r = _both(_kill_mid_write, tmp_path, monkeypatch)
    assert r["stats"]["checkpoint_generation"] == 1
    assert r["app_states"] == {"svc": "gen1"}


def _rename_crash(pkg, d):
    ck = pkg.mod("storage.checkpoint")
    d = str(d)
    meta = {"names": {}, "app_states": {}}
    ck.save_checkpoint_sharded(d, {"a": np.arange(8)}, meta, 2)
    ck.save_checkpoint_sharded(d, {"a": np.arange(8) + 1}, meta, 2)
    os.replace(os.path.join(d, ck.MANIFEST), os.path.join(d, ck.PREV_MANIFEST))
    ck.save_checkpoint_sharded(d, {"a": np.arange(8) + 2}, meta, 2)
    gen = ck.load_checkpoint_view(d).generation
    _tear(d, 30, b"XXXX")
    fb = ck.load_checkpoint_view(d)
    return {"gen": gen, "fallback": (fb.generation, fb.arrays["a"].tolist())}


def test_gc_preserves_prev_manifest_shards_after_rename_crash(tmp_path):
    r = _both(_rename_crash, tmp_path)
    assert r == {"gen": 3, "fallback": (2, list(range(1, 9)))}


# ---------------------------------------------------------------------------
# segmented replay
# ---------------------------------------------------------------------------


def _multi_file_history(pkg, d, shards, workers):
    _set(pkg, RECOVERY_REPLAY_WORKERS=workers)
    lg = _logger(pkg, d, shards=shards, max_file_size=512)
    _seed_groups(lg, n=6)
    for i in range(40):
        g = i % 6
        lg.log_accepts(np.array([g]), np.array([i // 6]),
                       np.array([32 + i]), np.array([1000 + i]))
        lg.log_decisions(np.array([g]), np.array([i // 6]), np.array([1000 + i]))
        lg.log_payloads({1000 + i: f"req{i}"})
    return lg


def _segmented(pkg, d):
    out = {}
    for label, workers in (("seq", 1), ("par", 4)):
        lg = _multi_file_history(pkg, d / label, shards=4, workers=workers)
        out["files"] = len(lg.journal.file_indices())
        out[label] = _rec(lg.recover(4, seed_arrays=_state_arrays(pkg)))
        lg.close()
    return out


def test_segmented_replay_parity(tmp_path, native_mode):
    r = _both(_segmented, tmp_path)
    assert r["files"] > 3
    for k in ("arrays", "payloads", "decisions"):
        assert r["seq"][k] == r["par"][k], k
    assert r["par"]["stats"]["segments"] > 3


def _mid_replay(pkg, d):
    lg = _multi_file_history(pkg, d, shards=4, workers=4)
    first = _rec(lg.recover(4, seed_arrays=_state_arrays(pkg)))
    lg.close()
    last = sorted(f for f in os.listdir(d) if f.startswith("journal_"))[-1]
    last = os.path.join(str(d), last)
    with open(last, "r+b") as f:
        f.truncate(os.path.getsize(last) - 3)
    lg2 = _logger(pkg, d)
    again = _rec(lg2.recover(4, seed_arrays=_state_arrays(pkg)))
    third = _rec(lg2.recover(4, seed_arrays=_state_arrays(pkg)))
    lg2.close()
    return {"first": first, "again": again, "third": third}


def test_mid_replay_crash_is_idempotent(tmp_path, native_mode):
    r = _both(_mid_replay, tmp_path)
    assert r["again"] == r["third"]
    assert set(r["again"]["payloads"]) <= set(r["first"]["payloads"])
    assert len(r["first"]["payloads"]) - len(r["again"]["payloads"]) <= 1


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_each_package_recovers_the_others_sharded_directory(
        tmp_path, writer, reader):
    """A sharded checkpoint plus a multi-file journal written by one
    package recovers to the same state through the other."""
    lg = _multi_file_history(writer, tmp_path, shards=4, workers=4)
    rec = lg.recover(4, seed_arrays=_state_arrays(writer))
    lg.checkpoint(rec.arrays, {"svc": "mid"}, {"names": {"svc": 0}})
    for i in range(40, 60):
        lg.log_decisions(np.array([i % 6]), np.array([i // 6]),
                         np.array([1000 + i]))
        lg.log_payloads({1000 + i: f"req{i}"})
    assert len(lg.journal.file_indices()) >= 2
    lg.close()
    got = {}
    for pkg in (writer, reader):
        _set(pkg, RECOVERY_REPLAY_WORKERS=4)
        lg = _logger(pkg, tmp_path)
        got[pkg.root] = _rec(lg.recover(4))
        lg.close()
    a, b = got.values()
    assert a == b
    assert b["app_states"] == {"svc": "mid"}
    assert b["stats"]["checkpoint_generation"] == 1


# ---------------------------------------------------------------------------
# lazy hydration (manager level, deterministic: background worker off)
# ---------------------------------------------------------------------------


def _ticks(m, n=6):
    for _ in range(n):
        vec, _st = m.publish_snapshot()
        m.tick_host(np.stack([vec]), np.array([True]))


@pytest.fixture
def no_background(monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(pkg.mod("recovery.hydration").Hydrator,
                            "start_background", lambda self: None)


def _manager(pkg, d):
    cfg = pkg.mod("ops.engine").EngineConfig(
        n_groups=16, window=8, req_lanes=4, n_replicas=1)
    return pkg.mod("manager").PaxosManager(
        0, pkg.mod("models").StatefulAdderApp(), cfg, log_dir=str(d),
        checkpoint_every=10 ** 9, **pkg.dev)


def _restartable(pkg, d, n_names=10):
    m = _manager(pkg, d)
    names = [f"svc{i}" for i in range(n_names)]
    m.create_paxos_batch(names, [0])
    for i, nm in enumerate(names):
        m.propose(nm, str(i + 1))
        _ticks(m)
    return m, names


def _stats(m):
    st = m.recovery_stats()
    return {k: st.get(k) for k in ("phase", "hydration_backlog", "hydrated",
                                   "hot_hydrated", *STAT_COUNTS)}


def _lazy(pkg, d):
    _set(pkg, RECOVERY_CHECKPOINT_SHARDS=4, RECOVERY_HOT_NAMES=3,
         RECOVERY_HYDRATION_BATCH=2)
    m, names = _restartable(pkg, d)
    m.checkpoint_now()
    m.logger.drain_checkpoints()
    m.propose("svc0", "100")  # post-checkpoint journal tail
    _ticks(m)
    m.close()
    m2 = _manager(pkg, d)
    try:
        out = {"stats": _stats(m2), "leaves": leaves(m2)}
        hot = [n for n in names if m2.names[n] not in m2.hydrating_rows]
        cold = [n for n in names if m2.names[n] in m2.hydrating_rows]
        out.update(hot=hot, cold=cold,
                   hot_totals={n: m2.app.totals.get(n) for n in hot},
                   cold_present=[n for n in cold if n in m2.app.totals])
        got = {}
        m2.propose(cold[0], "1000", callback=lambda r, v: got.update(v=v))
        _ticks(m2, 3)
        epoch = m2.current_epoch(cold[0])
        out["held"] = dict(got)
        out["gates"] = (m2.pause_group(cold[0], epoch), m2.app_caught_up(cold[0]),
                        m2.local_read_ok(cold[0]), m2.local_read_ok(hot[0]))
        m2.checkpoint_now()
        out["deferred"] = m2.metrics.get("recovery_checkpoint_deferred")
        out["promoted"] = (m2.hydrator.hydrate_batch() > 0,
                           m2.names[cold[0]] not in m2.hydrating_rows)
        out["drained"] = m2.hydrate_all(60)
        out["phase"] = m2.recovery_phase
        _ticks(m2)
        out["totals"] = {n: m2.app.totals.get(n) for n in names}
        out["reply"] = got.get("v")
        out["end_leaves"] = leaves(m2)
        return out
    finally:
        m2.close()


def _assert_same(a, b):
    for k in a:
        if k.endswith("leaves"):
            assert_leaves_equal(a[k], b[k], k)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def test_lazy_restart_serves_hot_gates_cold(tmp_path, no_background):
    got = {pkg.root: _lazy(pkg, tmp_path / pkg.root) for pkg in PKGS}
    _assert_same(got[JAX.root], got[TORCH.root])
    r = got[TORCH.root]
    assert r["stats"]["phase"] == "recovering"
    assert r["stats"]["hydration_backlog"] == 7 and r["stats"]["hot_hydrated"] == 3
    assert len(r["hot"]) == 3 and len(r["cold"]) == 7
    for nm, v in r["hot_totals"].items():
        assert v == (101 if nm == "svc0" else int(nm[3:]) + 1), nm
    assert r["cold_present"] == [] and r["held"] == {}
    assert r["gates"] == ("busy", False, False, True)
    assert r["deferred"] == 1 and r["promoted"] == (True, True)
    assert r["drained"] and r["phase"] == "serving"
    for nm, v in r["totals"].items():
        want = 101 if nm == "svc0" else int(nm[3:]) + 1
        assert v == want + (1000 if nm == r["cold"][0] else 0), nm
    assert r["reply"] is not None


def _eager(pkg, d):
    _set(pkg, RECOVERY_CHECKPOINT_SHARDS=4, RECOVERY_LAZY_HYDRATION="false")
    m, names = _restartable(pkg, d, n_names=6)
    m.checkpoint_now()
    m.logger.drain_checkpoints()
    m.close()
    m2 = _manager(pkg, d)
    try:
        return {"phase": m2.recovery_phase, "hydrating": sorted(m2.hydrating_rows),
                "hydrator": m2.hydrator is None, "leaves": leaves(m2),
                "totals": {n: m2.app.totals.get(n) for n in names}}
    finally:
        m2.close()


def test_eager_mode_restores_everything_up_front(tmp_path):
    got = {pkg.root: _eager(pkg, tmp_path / pkg.root) for pkg in PKGS}
    _assert_same(got[JAX.root], got[TORCH.root])
    r = got[TORCH.root]
    assert r["phase"] == "serving" and r["hydrating"] == [] and r["hydrator"]
    assert r["totals"] == {f"svc{i}": i + 1 for i in range(6)}


def _background(pkg, d):
    _set(pkg, RECOVERY_CHECKPOINT_SHARDS=4, RECOVERY_HOT_NAMES=2,
         RECOVERY_HYDRATION_BATCH=1)
    m, names = _restartable(pkg, d)
    m.checkpoint_now()
    m.logger.drain_checkpoints()
    m.close()
    m2 = _manager(pkg, d)
    try:
        deadline = time.time() + 60
        while m2.recovery_phase != "serving" and time.time() < deadline:
            time.sleep(0.02)
        return {"phase": m2.recovery_phase, "leaves": leaves(m2),
                "totals": {n: m2.app.totals.get(n) for n in names}}
    finally:
        m2.close()


def test_background_hydration_drains(tmp_path):
    got = {pkg.root: _background(pkg, tmp_path / pkg.root) for pkg in PKGS}
    _assert_same(got[JAX.root], got[TORCH.root])
    assert got[TORCH.root]["phase"] == "serving"
    assert got[TORCH.root]["totals"] == {f"svc{i}": i + 1 for i in range(10)}


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_each_package_restarts_a_node_the_other_wrote(tmp_path, writer, reader):
    """A manager of one package crashes after a sharded checkpoint and a
    journal tail; a manager of either package restarts from the directory
    with equal engine leaves, and both hydrate to the same totals."""
    for pkg in PKGS:
        _set(pkg, RECOVERY_CHECKPOINT_SHARDS=4, RECOVERY_HOT_NAMES=3)
    m, names = _restartable(writer, tmp_path)
    m.checkpoint_now()
    m.logger.drain_checkpoints()
    m.propose("svc0", "100")
    _ticks(m)
    final = leaves(m)
    m.close()
    got = {}
    for pkg in (writer, reader):
        # each restart reads its own copy: a restart appends to the journal
        d = tmp_path / f"restart-{pkg.root}"
        shutil.copytree(tmp_path, d, ignore=shutil.ignore_patterns("restart-*"))
        m2 = _manager(pkg, d)
        try:
            restarted = leaves(m2)
            assert m2.hydrate_all(60)
            got[pkg.root] = (restarted, {n: m2.app.totals.get(n) for n in names})
        finally:
            m2.close()
    (la, ta), (lb, tb) = got.values()
    assert_leaves_equal(la, lb, "restarted")
    assert_leaves_equal(final, lb, "crashed node against the restart")
    assert ta == tb == {n: (101 if n == "svc0" else int(n[3:]) + 1) for n in names}
