"""Durability on both packages: ``tests/test_storage.py`` run on the JAX
package and the port.

Each scenario writes the same journal blocks and checkpoints through one
package's ``storage`` and returns what recovery reads back; the two
packages must give equal arrays, payloads, decisions, metadata and file
bytes.  Each package also reads the other's journal and checkpoint
directory and recovers the same state.
"""

import os
import threading

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _st(pkg):
    return pkg.mod("storage")


def _cfg(pkg, G=4, W=4):
    return pkg.mod("ops.engine").EngineConfig(
        n_groups=G, window=W, req_lanes=2, n_replicas=3)


def _state_arrays(pkg, cfg):
    init = pkg.mod("ops.engine").init_state(cfg, **pkg.dev)
    return {k: np.array(np.asarray(v), copy=True)
            for k, v in init._asdict().items()}


def _rec(rec):
    """A RecoveryResult as plain comparable values."""
    return {
        "arrays": None if rec.arrays is None else
        {k: np.asarray(v).tolist() for k, v in rec.arrays.items()},
        "payloads": dict(rec.payloads),
        "decisions": {g: dict(d) for g, d in rec.decisions.items()},
        "meta": rec.meta,
    }


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def _both(scenario, tmp_path):
    got = {pkg.root: scenario(pkg, tmp_path / pkg.root) for pkg in PKGS}
    assert got[JAX.root] == got[TORCH.root]
    return got[TORCH.root]


def _journal_roundtrip(pkg, d):
    st = _st(pkg)
    j = st.Journal(str(d))
    j.append_columns(st.BlockType.ACCEPTS, [
        np.array([0, 1, 2]), np.array([5, 6, 7]),
        np.array([10, 10, 10]), np.array([100, 101, 102]),
    ])
    j.append(st.BlockType.PAYLOADS, b'{"1":"hello"}')
    blocks = list(j.scan())
    j.close()
    m = st.Journal.columns(blocks[0][1], blocks[0][2], 4)
    return {"kinds": [int(b[0]) for b in blocks], "col2": m[2].tolist(),
            "payload": blocks[1][1], "bytes": _dir_bytes(str(d))}


def test_journal_roundtrip(tmp_path):
    r = _both(_journal_roundtrip, tmp_path)
    assert r["col2"] == [2, 7, 10, 102] and r["payload"] == b'{"1":"hello"}'


def _torn_tail(pkg, d):
    st = _st(pkg)
    j = st.Journal(str(d))
    j.append(st.BlockType.PAYLOADS, b"good-block")
    j.append(st.BlockType.PAYLOADS, b"second")
    j.close()
    path = os.path.join(str(d), "journal_00000000.bin")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    j2 = st.Journal(str(d))
    first = [b[1] for b in j2.scan()]
    j2.append(st.BlockType.PAYLOADS, b"after-crash")
    after = [b[1] for b in j2.scan()]
    j2.close()
    return {"first": first, "after": after}


def test_journal_torn_tail(tmp_path):
    r = _both(_torn_tail, tmp_path)
    assert r["first"] == [b"good-block"] and r["after"][-1] == b"after-crash"


def _rotation(pkg, d):
    st = _st(pkg)
    j = st.Journal(str(d), max_file_size=64)
    for i in range(5):
        j.append(st.BlockType.PAYLOADS, b"x" * 80, n_rows=i)
    files = len(j.file_indices())
    blocks = list(j.scan())
    mid = blocks[2][3]
    later = [b[2] for b in j.scan(*mid)]
    removed = j.gc_below(mid[0])
    after_gc = [b[2] for b in j.scan(*mid)]
    j.close()
    return {"files": files, "rows": [b[2] for b in blocks], "later": later,
            "removed": removed, "after_gc": after_gc}


def test_journal_rotation_and_gc(tmp_path):
    r = _both(_rotation, tmp_path)
    assert r["files"] >= 4 and r["rows"] == [0, 1, 2, 3, 4]
    assert r["later"] == [3, 4] and r["removed"] >= 2 and r["after_gc"] == [3, 4]


def _prev_fallback(pkg, d):
    st = _st(pkg)
    d = str(d)
    st.save_checkpoint(d, {"a": np.arange(3)}, {"gen": 1})
    st.save_checkpoint(d, {"a": np.arange(4)}, {"gen": 2})
    arrays, meta = st.load_checkpoint(d)
    out = {"cur": (meta["gen"], arrays["a"].tolist())}
    with open(os.path.join(d, "checkpoint.npz"), "wb") as f:
        f.write(b"garbage")
    arrays, meta = st.load_checkpoint(d)
    out["fallback"] = (meta["gen"], arrays["a"].tolist())
    return out


def test_checkpoint_prev_fallback(tmp_path):
    r = _both(_prev_fallback, tmp_path)
    assert r == {"cur": (2, [0, 1, 2, 3]), "fallback": (1, [0, 1, 2])}


def _crash_between_demotes(pkg, d):
    st = _st(pkg)
    d = str(d)
    st.save_checkpoint(d, {"a": np.arange(3)}, {"tag": "g1"})
    st.save_checkpoint(d, {"a": np.arange(4)}, {"tag": "g2"})
    os.replace(os.path.join(d, "checkpoint.npz"),
               os.path.join(d, "prev_checkpoint.npz"))
    arrays, meta = st.load_checkpoint(d)
    out = {"paired": (meta["tag"], len(arrays["a"]))}
    os.remove(os.path.join(d, "checkpoint.meta.json"))
    out["refused"] = st.load_checkpoint(d) is None
    return out


def test_checkpoint_crash_between_demotes(tmp_path):
    r = _both(_crash_between_demotes, tmp_path)
    assert r == {"paired": ("g2", 4), "refused": True}


def _promises(pkg, d):
    st = _st(pkg)
    cfg = _cfg(pkg)
    lg = st.PaxosLogger(0, str(d))
    lg.log_create(np.array([0, 1]), np.array([0b111, 0b111]),
                  np.array([0, 0]), np.array([0, 1]))
    lg.log_promises(np.array([0, 1]), np.array([96, 65]))
    lg.log_promises(np.array([0, 0]), np.array([128, 97]))
    lg.close()
    lg2 = st.PaxosLogger(0, str(d))
    rec = lg2.recover(cfg.window, seed_arrays=_state_arrays(pkg, cfg))
    lg2.close()
    return _rec(rec)


def test_promises_block_rollforward(tmp_path):
    r = _both(_promises, tmp_path)
    assert r["arrays"]["bal"][:2] == [128, 65]


def _ballot_max(pkg, d):
    st = _st(pkg)
    cfg = _cfg(pkg, G=2)
    lg = st.PaxosLogger(0, str(d))
    lg.log_accepts(np.array([0, 0]), np.array([0, 1]),
                   np.array([99, 33]), np.array([7, 8]))
    rec = lg.recover(cfg.window, seed_arrays=_state_arrays(pkg, cfg))
    lg.close()
    return _rec(rec)


def test_accepts_duplicate_group_ballot_max(tmp_path):
    assert _both(_ballot_max, tmp_path)["arrays"]["bal"][0] == 99


def _write_history(pkg, d):
    """CREATE + ACCEPTS + PAYLOADS, a checkpoint, then DECISIONS + KILL."""
    st = _st(pkg)
    cfg = _cfg(pkg)
    lg = st.PaxosLogger(0, str(d))
    lg.log_create(np.array([0, 1]), np.array([0b111, 0b111]),
                  np.array([0, 0]), np.array([0, 1]))
    lg.log_accepts(np.array([0, 0, 1]), np.array([0, 1, 0]),
                   np.array([32, 32, 33]), np.array([100, 101, 200]))
    lg.log_payloads({100: "r100", 101: "r101"})
    rec = lg.recover(cfg.window, seed_arrays=_state_arrays(pkg, cfg))
    pre = _rec(rec)
    lg.checkpoint(rec.arrays, {"svc0": "appstate"}, {"names": {"svc0": 0}})
    lg.log_decisions(np.array([0, 0]), np.array([0, 1]), np.array([100, 101]))
    lg.log_kill(np.array([1]))
    lg.close()
    return pre


def _read_history(pkg, d):
    lg = _st(pkg).PaxosLogger(0, str(d))
    try:
        return _rec(lg.recover(_cfg(pkg).window))
    finally:
        lg.close()


def _rollforward(pkg, d):
    pre = _write_history(pkg, d)
    return {"pre": pre, "post": _read_history(pkg, d)}


def test_logger_recovery_rollforward(tmp_path):
    r = _both(_rollforward, tmp_path)
    a, b = r["pre"]["arrays"], r["post"]["arrays"]
    assert a["member_mask"][0] == 0b111 and a["majority"][1] == 2
    assert a["acc_vid"][0][:2] == [100, 101] and a["bal"][0] == 32
    assert r["pre"]["payloads"] == {100: "r100", 101: "r101"}
    assert r["post"]["meta"]["app_states"] == {"svc0": "appstate"}
    assert b["dec_vid"][0][0] == 100 and b["dec_slot"][0][1] == 1
    assert b["member_mask"][1] == 0 and b["acc_vid"][0][0] == 100


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_each_package_reads_the_others_journal_and_checkpoint(
        tmp_path, writer, reader):
    """A directory one package wrote (checkpoint, then journal blocks)
    recovers to the same state through the other package."""
    _write_history(writer, tmp_path)
    assert _read_history(reader, tmp_path) == _read_history(writer, tmp_path)


def _gc(pkg, d):
    st = _st(pkg)
    cfg = _cfg(pkg, G=2)
    lg = st.PaxosLogger(0, str(d), max_file_size=64)
    for i in range(6):
        lg.log_accepts(np.array([0]), np.array([i]), np.array([1]),
                       np.array([i + 10]))
    n_before = len(lg.journal.file_indices())
    rec = lg.recover(cfg.window, seed_arrays=_state_arrays(pkg, cfg))
    lg.checkpoint(rec.arrays, {}, {})
    n_after = len(lg.journal.file_indices())
    rec2 = lg.recover(cfg.window)
    lg.close()
    return {"before": n_before, "after": n_after, "rec": _rec(rec2)}


def test_checkpoint_gcs_journal(tmp_path):
    r = _both(_gc, tmp_path)
    assert r["after"] < r["before"]
    assert r["rec"]["arrays"]["acc_vid"][0][5 % 4] == 15


def _group_commit(pkg, d, mode, monkeypatch):
    st = _st(pkg)
    BT = st.BlockType
    if mode == "python":
        monkeypatch.setenv("GP_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    pkg.mod("native")._libs.clear()
    try:
        j = st.Journal(str(d))
        native = j._native is not None
        pos = j.append_many([
            (BT.ACCEPTS, np.arange(12, dtype=np.int32).reshape(3, 4).tobytes(), 3),
            (BT.PAYLOADS, b'{"1":"hello"}', 0),
            (BT.NAMES, b'[{"row":2,"name":"x"}]', 0),
        ])
        j.append(BT.KILL, np.array([[7]], dtype=np.int32).tobytes(), 1)
        j.close()
        j2 = st.Journal(str(d))
        scanned = [(int(b[0]), b[1], b[2]) for b in j2.scan()]
        j2.close()
        with open(os.path.join(str(d), "journal_00000000.bin"), "rb") as f:
            return native, (pos, scanned, f.read())
    finally:
        pkg.mod("native")._libs.clear()


def test_native_group_commit_parity(tmp_path, monkeypatch):
    """The native batched append and the Python path of both packages
    write byte-identical journals that scan to the same blocks."""
    got = {(pkg.root, mode): _group_commit(pkg, tmp_path / f"{pkg.root}-{mode}",
                                           mode, monkeypatch)
           for pkg in PKGS for mode in ("native", "python")}
    monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    if not all(got[(p.root, "native")][0] for p in PKGS):
        pytest.skip("no C++ compiler available")
    assert not any(got[(p.root, "python")][0] for p in PKGS)
    want = got[(JAX.root, "native")][1]
    for key, (_n, res) in got.items():
        assert res == want, key


def _storm(pkg, d):
    """The background checkpoint writer against a hot append thread."""
    st = _st(pkg)
    cfg = _cfg(pkg)
    lg = st.PaxosLogger(0, str(d), max_file_size=64 * 1024)
    lg.log_create(np.array([0]), np.array([0b111]), np.array([0]), np.array([0]))
    arrays = _state_arrays(pkg, cfg)
    stop = threading.Event()
    n_appended = [0]

    def hammer():
        i = 0
        while not stop.is_set():
            lg.log_decisions(np.array([0]), np.array([i]), np.array([1000 + i]))
            lg.log_payloads({1000 + i: "x" * 256})
            n_appended[0] = i
            i += 1

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for k in range(30):
            lg.checkpoint_async(dict(arrays), {"svc": f"s{k}"},
                                {"names": {"svc": 0}})
        lg.drain_checkpoints()
    finally:
        stop.set()
        t.join()
    lg.close()
    return n_appended[0]


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)])
def test_async_checkpoint_concurrent_with_appends(tmp_path, writer, reader):
    """After a storm of background checkpoints racing appends, both
    packages recover the same state from the directory, and it reaches
    the append thread's tail (no post-checkpoint block skipped)."""
    n = _storm(writer, tmp_path)
    recs = {}
    for pkg in (writer, reader):
        lg = _st(pkg).PaxosLogger(0, str(tmp_path))
        try:
            recs[pkg.root] = _rec(lg.recover(_cfg(pkg).window))
        finally:
            lg.close()
    a, b = recs.values()
    assert a == b
    assert b["meta"]["app_states"]["svc"].startswith("s")
    top = max((s for g in b["decisions"].values() for s in g), default=-1)
    assert top >= n - 1, (top, n)
