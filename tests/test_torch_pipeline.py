"""Pipelined dispatch on both packages: ``tests/test_pipeline.py`` run
on the JAX package and on the port (``device="cpu"``).

The pipelined tick (``step_dispatch`` + ``step_complete``) and the serial
tick (``tick_host``) of three managers exchanging packed blob vectors run
the same recorded request schedule on both packages: after every cluster
step every engine leaf of every replica is equal across the four runs,
and the client responses are equal.  A lifecycle op waits for an
in-flight step on both; the flush metrics and the pipelined loopback
behave the same on both.
"""

import threading

import numpy as np
import pytest

from torch_pkgs import JAX, PKGS, TORCH, assert_leaves_equal, boot_cluster, leaves, wait_until


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def _cfg(pkg):
    return pkg.mod("ops.engine").EngineConfig(
        n_groups=8, window=8, req_lanes=4, n_replicas=3)


class PackedCluster:
    """Three managers exchanging PACKED blob vectors (the socket
    runtime's wire path), steppable in serial or pipelined mode
    (``tests/test_pipeline.py:PackedCluster`` on either package)."""

    def __init__(self, pkg, pipelined: bool):
        self.pipelined = pipelined
        PaxosManager = pkg.mod("manager").PaxosManager
        HashChainApp = pkg.mod("models.apps").HashChainApp
        self.managers = [
            PaxosManager(r, HashChainApp(), _cfg(pkg), **pkg.dev)
            for r in range(3)
        ]
        for m in self.managers:
            m.outstanding.timeout_s = float("inf")
        self.vecs = [m.blob_vec() for m in self.managers]
        self.inboxes = [[] for _ in range(3)]

    def create(self, name):
        row = self.managers[0].default_row_for(name)
        for m in self.managers:
            m.create_paxos_instance(name, [0, 1, 2], row=row)
        self.vecs = [m.blob_vec() for m in self.managers]
        return row

    def step_all(self):
        for i, m in enumerate(self.managers):
            inbox, self.inboxes[i] = self.inboxes[i], []
            for kind, body in inbox:
                m.on_host_message(kind, body)
        heard = np.ones(3, bool)
        new_vecs = list(self.vecs)
        deltas = []
        for i, m in enumerate(self.managers):
            gathered = np.stack([self.vecs[j] for j in range(3)])
            if self.pipelined:
                pend = m.step_dispatch(gathered, heard)
                vec, _state, delta = m.step_complete(pend)
            else:
                vec, _state, delta = m.tick_host(gathered, heard)
            new_vecs[i] = vec
            deltas.append(delta)
        self.vecs = new_vecs
        for i, delta in enumerate(deltas):
            ae = delta.get("app_exec")
            if delta["arena"] or (ae and ae[1]):
                for j in range(3):
                    if j != i:
                        self.inboxes[j].append(("payloads", delta))
            for dst, kind, body in self.managers[i].drain_forward_out():
                if dst == i:
                    self.managers[i].on_host_message(kind, body)
                elif dst == -1:
                    for j in range(3):
                        if j != i:
                            self.inboxes[j].append((kind, body))
                else:
                    self.inboxes[dst].append((kind, body))

    def close(self):
        for m in self.managers:
            m.close()


def test_pipeline_state_parity():
    """One schedule through serial and pipelined dispatch on both
    packages: every leaf of every replica equal after every step, the
    blob vectors equal, and the same client responses."""
    runs = {(pkg.root, piped): PackedCluster(pkg, piped)
            for pkg in PKGS for piped in (False, True)}
    resp = {k: [] for k in runs}
    try:
        names = ["pa", "pb", "pc"]
        for c in runs.values():
            for nm in names:
                c.create(nm)
        rid = 1 << 56
        for step_no in range(40):
            for key, c in runs.items():
                out = resp[key]
                if step_no % 3 == 0:
                    nm = names[step_no % len(names)]
                    c.managers[step_no % 3].propose(
                        nm, f"v{step_no}",
                        callback=lambda r, x, _t=step_no, _o=out: _o.append((_t, r, x)),
                        request_id=rid + step_no,
                    )
                if step_no == 20:
                    c.managers[1].propose(
                        names[0], "v0",
                        callback=lambda r, x, _o=out: _o.append(("dup", r, x)),
                        request_id=rid + 0,
                    )
                c.step_all()
            ref = runs[(JAX.root, False)]
            for key, c in runs.items():
                for i, (mr, mc) in enumerate(zip(ref.managers, c.managers)):
                    assert_leaves_equal(leaves(mr), leaves(mc), (step_no, key, i))
                    np.testing.assert_array_equal(mr.app_exec_slot, mc.app_exec_slot)
                    np.testing.assert_array_equal(ref.vecs[i], c.vecs[i])
        want = sorted(resp[(JAX.root, False)], key=str)
        assert len(want) >= 10  # the schedule actually decided things
        for key in runs:
            assert sorted(resp[key], key=str) == want, key
    finally:
        for c in runs.values():
            c.close()


def _lifecycle_blocked(pkg):
    """(blocked while in flight, resumed after complete, name created)."""
    HashChainApp = pkg.mod("models.apps").HashChainApp
    m = pkg.mod("manager").PaxosManager(0, HashChainApp(), _cfg(pkg), **pkg.dev)
    try:
        m.create_paxos_instance("x", [0])
        vec = m.blob_vec()
        heard = np.array([True, False, False])
        pend = m.step_dispatch(np.stack([vec, vec, vec]), heard)
        done = threading.Event()

        def create_side():
            m.create_paxos_instance("y", [0])
            done.set()

        t = threading.Thread(target=create_side, daemon=True)
        t.start()
        blocked = not done.wait(0.3)
        m.step_complete(pend)
        resumed = done.wait(5.0)
        t.join(5.0)
        return blocked, resumed, "y" in m.names, leaves(m)
    finally:
        m.close()


def test_lifecycle_waits_for_inflight_step():
    """A create arriving while a step is in flight waits for
    ``step_complete`` on both packages, and both end in the same state."""
    got = {pkg.root: _lifecycle_blocked(pkg) for pkg in PKGS}
    for root, (blocked, resumed, created, _) in got.items():
        assert blocked, f"{root}: lifecycle op interleaved with an in-flight step"
        assert resumed and created, root
    assert_leaves_equal(got[JAX.root][3], got[TORCH.root][3], "after the create")


def _flush_run(pkg):
    servers, client, _ = boot_cluster(pkg)
    try:
        assert client.create_paxos_instance("fm", [0, 1, 2], timeout=30)
        resps = [client.send_request_sync("fm", str(i + 1), timeout=30)
                 for i in range(4)]
        mx = [s.manager.metrics for s in servers]
        flushed = sum(m.get("responses_flushed") for m in mx)
        hist = any("flush_batch_size" in m.snapshot()["hists"] for m in mx)
        st = client.admin_sync(0, {"op": "stats"}, timeout=10)
        assert st and st["ok"]
        sv = st["serving"]
        return resps, flushed, hist, {
            "pipeline_dispatch": sv["pipeline_dispatch"],
            "binary_frames": sv["codec"]["binary_frames"],
            "impl": sv["codec"]["impl"],
            "serving_workers": sv["serving_workers"],
        }
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_flush_coalescing_metrics():
    """A loopback round trip populates the flush metrics on both packages,
    and both stats replies report the same live codec and pipeline mode."""
    got = {pkg.root: _flush_run(pkg) for pkg in PKGS}
    for root, (resps, flushed, hist, serving) in got.items():
        assert resps == ["1", "3", "6", "10"], (root, resps)
        assert flushed >= 4 and hist, root
        assert serving["pipeline_dispatch"] is True
        assert serving["binary_frames"] is True
        assert serving["impl"] in ("gp_codec.so", "python-struct")
        assert serving["serving_workers"] == 1
    assert got[JAX.root][3] == got[TORCH.root][3]


def _overlap_run(pkg):
    servers, client, _ = boot_cluster(pkg)
    try:
        assert servers[0]._pipeline is True
        assert client.create_paxos_instance("ov", [0, 1, 2], timeout=30)
        resps = [client.send_request_sync("ov", str(i + 1), timeout=30)
                 for i in range(8)]
        assert wait_until(lambda: all(
            s.manager.app.totals.get("ov") == 36 for s in servers))
        overlap = any(
            "pipeline_overlap_s" in s.manager.metrics.snapshot()["hists"]
            for s in servers)
        return resps, overlap
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_pipelined_loopback_under_overlap():
    """With pipelining on (the default), client load through real sockets
    gets the same running totals on both packages, the replicas converge,
    and the overlap metric is populated."""
    got = {pkg.root: _overlap_run(pkg) for pkg in PKGS}
    want = [str(sum(range(1, i + 2))) for i in range(8)]
    for root, (resps, overlap) in got.items():
        assert resps == want, (root, resps)
        assert overlap, root
