"""The packed spill store on both packages: ``tests/test_spill_store.py``
run on the JAX package and on the port.

Each scenario runs once per package in its own directory and yields its
reads, its stats and the bytes of every segment file it left on disk (by
path under the store); the two must be equal byte for byte, and the
reference's own assertions hold on each.
"""

import os

import pytest

from torch_pkgs import JAX, TORCH


def both(fn, tmp_path):
    ref, port = fn(JAX, tmp_path / "jax"), fn(TORCH, tmp_path / "port")
    assert port == ref
    return port


def _mod(pkg):
    return pkg.mod("utils.packedstore")


def _store(pkg, d, **kw):
    kw.setdefault("capacity", 8)
    return _mod(pkg).PackedSpillStore(str(d / "spill"), **kw)


def _seg_files(store):
    out = []
    for root, _dirs, files in os.walk(store.dir):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".seg"))
    return sorted(out)


def _disk(store):
    """{segment path under the store: its bytes}."""
    return {os.path.relpath(p, store.dir): open(p, "rb").read() for p in _seg_files(store)}


def round_trip(pkg, d):
    st = _store(pkg, d, capacity=8)
    for i in range(20):
        st[("svc%d" % i, 0)] = {"exec": i, "members": [0, 1, 2]}
    assert len(st) == 20
    assert st.n_in_memory <= 8
    assert st.n_on_disk == 20 - st.n_in_memory
    for i in range(20):
        assert st[("svc%d" % i, 0)]["exec"] == i
    assert ("svc3", 0) in st
    assert set(st) == {("svc%d" % i, 0) for i in range(20)}
    out = [st.n_in_memory, st.n_on_disk, st.stats(), _disk(st)]
    st.close()
    return out


def test_round_trip_and_lru_spill(tmp_path):
    both(round_trip, tmp_path)


def delete_overwrite(pkg, d):
    st = _store(pkg, d, capacity=2)
    for i in range(8):
        st[i] = "v%d" % i
    del st[0]
    st[1] = "v1b"
    assert 0 not in st
    assert st[1] == "v1b"
    stats = st.stats()
    assert stats["dead_records"] >= 1
    assert stats["live_records"] == stats["on_disk"]
    with pytest.raises(KeyError):
        del st[0]
    out = [stats, _disk(st)]
    st.close()
    return out


def test_delete_and_overwrite_mark_dead(tmp_path):
    both(delete_overwrite, tmp_path)


def demote_restore(pkg, d):
    st = _store(pkg, d, capacity=64)
    keys = [("n%03d" % i, 0) for i in range(32)]
    for k in keys:
        st[k] = {"k": k[0]}
    assert st.demote_batch(keys) == 32
    assert st.n_in_memory == 0 and st.n_on_disk == 32
    assert st.demote_batch(keys[:4] + [("ghost", 9)]) == 4
    assert st.demote(("ghost", 9)) is False
    got = st.restore_batch(keys + [("ghost", 9)])
    assert set(got) == set(keys)
    assert all(got[k]["k"] == k[0] for k in keys)
    out = [sorted(got.items()), st.stats(), _disk(st)]
    st.close()
    return out


def test_demote_and_restore_batch(tmp_path):
    both(demote_restore, tmp_path)


def peek(pkg, d):
    st = _store(pkg, d, capacity=4)
    for i in range(12):
        st[i] = i * 10
    spilled_before = st.n_on_disk
    items = dict(st.peek_items())
    assert items == {i: i * 10 for i in range(12)}
    assert st.n_on_disk == spilled_before
    out = [sorted(items.items()), spilled_before, _disk(st)]
    st.close()
    return out


def test_peek_items_does_not_promote(tmp_path):
    both(peek, tmp_path)


def torn_tail(pkg, d):
    SpillCorruption = _mod(pkg).SpillCorruption
    st = _store(pkg, d, capacity=2)
    for i in range(6):
        st[i] = {"v": i}
    st.close()
    seg = _seg_files(st)[-1]
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 3)
    torn_key, ok = None, 0
    for key, (s, off, ln) in list(st._index.items()):
        try:
            _k, v = st._read_record(s, off, ln)
            assert v == {"v": key}
            ok += 1
        except SpillCorruption:
            torn_key = key
    assert torn_key is not None and ok == st.n_on_disk - 1
    scanned = list(st._scan_segment(int(os.path.basename(seg)[3:-4])))
    assert all(k != torn_key for k, _v, _off in scanned)
    return [torn_key, ok, scanned, _disk(st)]


def test_torn_tail_truncated_record_is_dropped(tmp_path):
    both(torn_tail, tmp_path)


def compaction(pkg, d):
    st = _store(pkg, d, capacity=2, segment_bytes=4096, compact_ratio=0.3)
    keys = [("g%04d" % i, 0) for i in range(200)]
    for k in keys:
        st[k] = {"pad": "x" * 64, "k": k[0]}
    st.demote_batch(keys)
    n_seg_before = len(_seg_files(st))
    assert n_seg_before > 1
    for k in keys[:160]:
        del st[k]
    assert st.compactions > 0
    stats = st.stats()
    assert stats["live_records"] == 40
    for k in keys[160:]:
        assert st[k]["k"] == k[0]
    assert len(_seg_files(st)) <= n_seg_before
    out = [n_seg_before, st.compactions, stats, _disk(st)]
    st.close()
    return out


def test_compaction_reclaims_dead_segments(tmp_path):
    both(compaction, tmp_path)


def tail_exempt(pkg, d):
    st = _store(pkg, d, capacity=2, segment_bytes=1 << 20)
    for i in range(10):
        st[i] = "v%d" % i
    st.demote_batch(list(range(10)))
    for i in range(9):
        del st[i]
    assert st.compactions == 0
    assert st[9] == "v9"
    out = [st.stats(), _disk(st)]
    st.close()
    return out


def test_tail_segment_never_compacts_in_place(tmp_path):
    both(tail_exempt, tmp_path)


def subdirs(pkg, d):
    st = _store(pkg, d, capacity=2, segment_bytes=4096, subdirs=4)
    for i in range(300):
        st[i] = {"pad": "y" * 64}
    st.demote_batch(list(range(300)))
    dirs = {os.path.basename(os.path.dirname(p)) for p in _seg_files(st)}
    assert len(dirs) > 1
    for x in dirs:
        int(x, 16)
    out = [sorted(dirs), _disk(st)]
    st.close()
    return out


def test_segments_fan_over_subdirs(tmp_path):
    both(subdirs, tmp_path)


def wipes_stale(pkg, d):
    s = d / "spill"
    s.mkdir(parents=True)
    (s / "stale.dm").write_text("old file-per-key spill")
    (s / "0a").mkdir()
    (s / "0a" / "seg00000007.seg").write_text("old segment")
    st = _mod(pkg).PackedSpillStore(str(s), capacity=4)
    assert not (s / "stale.dm").exists()
    assert not (s / "0a").exists()
    assert len(st) == 0
    out = [sorted(os.listdir(s)), _disk(st)]
    st.close()
    return out


def test_wipes_stale_layouts_at_construction(tmp_path):
    both(wipes_stale, tmp_path)


def frame_header(pkg, d):
    st = _store(pkg, d, capacity=2)
    st["k"] = "value"
    st.demote("k")
    seg = _seg_files(st)[0]
    raw = open(seg, "rb").read()
    HDR = _mod(pkg)._HDR
    length, crc = HDR.unpack(raw[:HDR.size])
    assert len(raw) == HDR.size + length
    st.close()
    return [HDR.format, length, crc, raw]


def test_frame_header_is_length_plus_crc(tmp_path):
    both(frame_header, tmp_path)
