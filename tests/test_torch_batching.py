"""Request coalescing on both packages: ``tests/test_batching.py`` run on
the JAX package and the port (``device="cpu"``).

Each scenario drives a ``ManagerCluster`` of each package with the same
submits and steps and returns what a client and an operator see: the
responses handed to callbacks (request ids are random per proposal, so
responses are compared as values), app states and execution counts, the
slots used, and every engine leaf at the end.  The two packages must give
equal results, and each must pass the reference test's own checks.
"""

import pytest

from torch_pkgs import JAX, PKGS, TORCH, assert_leaves_equal, leaves


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _cfg(pkg, G=8, R=3):
    return pkg.mod("ops.engine").EngineConfig(
        n_groups=G, window=8, req_lanes=4, n_replicas=R)


def _cluster(pkg, cfg=None, **kw):
    return pkg.mod("testing.cluster").ManagerCluster(
        cfg or _cfg(pkg), pkg.mod("models.apps").HashChainApp, **kw, **pkg.dev)


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages; require equal
    results and return the port's."""
    got = {pkg.root: scenario(pkg, *args) for pkg in PKGS}
    a, b = got[JAX.root], got[TORCH.root]
    assert a.keys() == b.keys()
    for k in a:
        if k == "leaves":
            for i, (la, lb) in enumerate(zip(a[k], b[k])):
                assert_leaves_equal(la, lb, f"manager {i}")
        else:
            assert a[k] == b[k], (k, a[k], b[k])
    return b


def _end(c, name, done=None):
    out = {
        "states": [m.app.state.get(name) for m in c.managers],
        "counts": [m.app.n_executed.get(name) for m in c.managers],
        "leaves": [leaves(m) for m in c.managers],
    }
    if done is not None:
        out["responses"] = sorted(done.values(), key=str)
    return out


def test_batch_codec_roundtrip():
    subs = [
        (1 << 61, 0, "plain"),
        (12345, 2, ""),
        ((1 << 53) + 7, 1, 'json {"a": [1, 2]} é中'),
    ]
    enc = {pkg.root: pkg.mod("manager").encode_batch(subs) for pkg in PKGS}
    assert enc[JAX.root] == enc[TORCH.root]
    for pkg in PKGS:
        assert pkg.mod("manager").decode_batch(enc[JAX.root]) == subs
        assert pkg.mod("manager").BATCH_BIT == JAX.mod("manager").BATCH_BIT


def _hot_burst(pkg):
    c = _cluster(pkg)
    try:
        c.create("hot", members=[0, 1, 2])
        done = {}
        for i in range(500):
            c.submit("hot", f"v{i}", entry=0,
                     callback=lambda rid, r: done.setdefault(rid, r))
        c.run(20)
        m0 = c.managers[0]
        return {**_end(c, "hot", done),
                "frontier": int(m0._np("exec_slot")[m0.names["hot"]])}
    finally:
        c.close()


def test_hot_group_burst_commits_in_few_ticks():
    """500 requests to one group ride a handful of slots on both packages,
    with the same chain on every replica."""
    r = _both(_hot_burst)
    assert len(r["responses"]) == 500
    assert r["frontier"] <= 40
    assert r["states"][0] is not None and len(set(r["states"])) == 1
    assert r["counts"] == [500, 500, 500]


def _forwarding(pkg):
    c = _cluster(pkg)
    try:
        c.create("fwd", members=[0, 1, 2])
        coord = c.managers[0].coordinator_of_row(c.managers[0].names["fwd"])
        done = {}
        for i in range(100):
            c.submit("fwd", f"v{i}", entry=(coord + 1) % 3,
                     callback=lambda rid, r: done.setdefault(rid, r))
        c.run(25)
        return {**_end(c, "fwd", done), "coord": coord}
    finally:
        c.close()


def test_batched_requests_from_forwarding_entry():
    r = _both(_forwarding)
    assert len(r["responses"]) == 100
    assert len(set(r["states"])) == 1


def _stop(pkg):
    c = _cluster(pkg)
    try:
        c.create("s", members=[0, 1, 2])
        done = {}
        for i in range(40):
            c.submit("s", f"v{i}", entry=0,
                     callback=lambda rid, r: done.setdefault(rid, r))
        c.submit("s", "", entry=0, stop=True)
        c.run(25)
        STOP_BIT = pkg.mod("ops.engine").STOP_BIT
        BATCH_BIT = pkg.mod("manager").BATCH_BIT
        both = [vid for m in c.managers for vid in list(m.arena) + list(m.retained)
                if (vid & STOP_BIT) and (vid & BATCH_BIT)]
        return {**_end(c, "s", done), "stopped": c.managers[0].is_stopped("s"),
                "stop_and_batch": both}
    finally:
        c.close()


def test_stop_never_rides_a_batch():
    r = _both(_stop)
    assert r["stopped"] and len(r["responses"]) == 40
    assert r["stop_and_batch"] == []
    assert len(set(r["counts"])) == 1


def _retransmit(pkg):
    c = _cluster(pkg)
    try:
        c.create("d", members=[0, 1, 2])
        rid = 1 << 55
        responses = []
        for i in range(30):
            c.submit("d", f"n{i}", entry=0)
        for _ in range(2):  # the original, then a retransmit before commit
            c.managers[0].propose("d", "tracked", request_id=rid,
                                  callback=lambda r, resp: responses.append(resp))
        c.run(20)
        c.managers[0].propose("d", "tracked", request_id=rid,
                              callback=lambda r, resp: responses.append(resp))
        c.run(2)
        return {**_end(c, "d"), "responses": responses}
    finally:
        c.close()


def test_retransmit_of_batched_request_dedups():
    r = _both(_retransmit)
    assert len(r["responses"]) >= 2
    assert len(set(x for x in r["responses"] if x is not None)) == 1
    assert r["counts"][0] == 31


def _unbatched(pkg):
    pkg.mod("utils.config").Config.set("BATCHING_ENABLED", "false")
    try:
        c = _cluster(pkg)
        try:
            c.create("u", members=[0, 1, 2])
            done = {}
            for i in range(20):
                c.submit("u", f"v{i}", entry=0,
                         callback=lambda rid, r: done.setdefault(rid, r))
            c.run(15)
            BATCH_BIT = pkg.mod("manager").BATCH_BIT
            batched = [v for m in c.managers for v in m.retained if v & BATCH_BIT]
            return {**_end(c, "u", done), "batched": batched}
        finally:
            c.close()
    finally:
        pkg.mod("utils.config").Config.clear()


def test_unbatched_mode_still_works():
    r = _both(_unbatched)
    assert len(r["responses"]) == 20 and r["batched"] == []


def _crash(pkg, tmp_path):
    dirs = [str(tmp_path / f"{pkg.root}{r}") for r in range(3)]
    cfg = _cfg(pkg)
    c = _cluster(pkg, cfg, log_dirs=dirs)
    c.create("r", members=[0, 1, 2])
    for i in range(60):
        c.submit("r", f"v{i}", entry=0)
    c.run(15)
    out = _end(c, "r")
    c.close()
    m = pkg.mod("manager").PaxosManager(
        0, pkg.mod("models.apps").HashChainApp(), cfg, log_dir=dirs[0], **pkg.dev)
    try:
        out.update(restarted_state=m.app.state.get("r"),
                   restarted_count=m.app.n_executed.get("r"),
                   restarted_leaves=[leaves(m)])
    finally:
        m.close()
    return out


def test_batch_survives_crash_recovery(tmp_path):
    got = {pkg.root: _crash(pkg, tmp_path) for pkg in PKGS}
    a, b = got[JAX.root], got[TORCH.root]
    for k in ("states", "counts", "restarted_state", "restarted_count"):
        assert a[k] == b[k], k
    for key in ("leaves", "restarted_leaves"):
        for i, (la, lb) in enumerate(zip(a[key], b[key])):
            assert_leaves_equal(la, lb, f"{key} {i}")
    assert len(set(b["states"])) == 1 and b["states"][0] is not None
    assert b["restarted_state"] == b["states"][0]
    assert b["restarted_count"] == 60


def _fifo_stop(pkg):
    c = _cluster(pkg)
    try:
        c.create("f", members=[0, 1, 2])
        row = c.managers[0].names["f"]
        entry = (c.managers[0].coordinator_of_row(row) + 1) % 3
        for i in range(5):
            c.submit("f", f"pre{i}", entry=entry)
        c.submit("f", "", entry=entry, stop=True)
        c.run(20)
        return {**_end(c, "f"),
                "stopped": [int(m._np("stopped")[row]) for m in c.managers]}
    finally:
        c.close()


def test_forward_batch_preserves_fifo_around_stop():
    r = _both(_fifo_stop)
    assert all(n >= 5 for n in r["counts"])
    assert r["stopped"] == [1, 1, 1]
    assert len(set(r["states"])) == 1


def _outcomes(pkg):
    c = _cluster(pkg, _cfg(pkg, G=4, R=1))
    m = c.managers[0]
    try:
        c.create("b", members=[0])
        rid = 1 << 56
        got = []
        cb = lambda r, resp: got.append(resp)
        out = {"first": [r[1] for r in m.propose_batch(
            [("b", "v0", rid, cb), ("nope", "v1", rid + 1, None)])]}
        out["again"] = [r[1] for r in m.propose_batch([("b", "v0", rid, cb)])]
        c.run(8)
        out["fired"] = list(got)
        res = m.propose_batch([("b", "v0", rid, cb)])
        out["cached"] = [(r[1], r[2]) for r in res]
        m._next_counter = pkg.mod("manager").VID_COUNTER_MASK + 1
        res = m.propose_batch([("b", "v0", rid, cb), ("b", "fresh", rid + 7, None)])
        out["exhausted"] = [r[1] for r in res]
        out["got"] = got
        out["leaves"] = [leaves(m)]
        return out
    finally:
        c.close()


def test_propose_batch_outcomes():
    r = _both(_outcomes)
    assert r["first"] == ["queued", "unknown"]
    assert r["again"] == ["inflight"]
    assert r["fired"]
    first = r["fired"][-1]
    assert r["cached"] == [("cached", first)]
    assert r["exhausted"] == ["cached", "exhausted"]
    assert r["got"][-1] == first
