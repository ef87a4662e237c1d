"""Transactions (``txn/``) on the port against the JAX package.

Every test of ``tests/test_txn.py`` runs as one scenario on both
packages' ``ManagerCluster`` (the port on the CPU, its plain engine),
each on a fresh scripted clock (``torch_soak.scripted``: the drivers'
wall-clock latency fields and every timer read the same instants on both)
with the global ``random`` state seeded alike (transaction ids).  The
reference test's assertions run on both; then the two runs must be equal:

* every driver result, decided response and resolver count the scenario
  records, in order;
* every member's participant app state (adder totals, locks, staged ops,
  resolved rings, coordinator records and ended rings);
* every member's engine exec frontiers and app cursors.
"""

import json
from types import SimpleNamespace

import gigapaxos_tpu.txn as jtxn
import gigapaxos_tpu_torch.txn as ttxn
from gigapaxos_tpu.models.apps import StatefulAdderApp as JAdder
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.testing.cluster import ManagerCluster as JCluster
from gigapaxos_tpu_torch.models.apps import StatefulAdderApp as TAdder
from gigapaxos_tpu_torch.ops.engine import EngineConfig as TConfig
from gigapaxos_tpu_torch.testing.cluster import ManagerCluster as TCluster
from torch_soak import JAX as JSOAK
from torch_soak import PORT as TSOAK
from torch_soak import in_child, scripted


def _pkg(txn, cluster, adder, config, soak, kw):
    return SimpleNamespace(
        **{k: getattr(txn, k) for k in (
            "ABORTED", "COMMITTED", "TXN_COORD", "DistTransactor",
            "Transaction", "Transactor", "TxnApp", "TxnDriver",
            "TxnResolver", "tx_op", "txc_op")},
        Cluster=cluster, Adder=adder, CFG=config(8, 8, 4, 3), soak=soak,
        kw=kw)


JAX = _pkg(jtxn, JCluster, JAdder, JConfig, JSOAK, {})
PORT = _pkg(ttxn, TCluster, TAdder, TConfig, TSOAK, {"device": "cpu"})


class Run:
    """One package's scenario: its cluster helpers (those of
    ``tests/test_txn.py``) and the record the two runs are compared on."""

    def __init__(self, pkg):
        self.p = pkg
        self.rid = 1 << 40   # sync_send's request ids, alike on both
        self.log = []
        self.c = None

    def make_cluster(self, **kw):
        p = self.p
        self.c = p.Cluster(p.CFG, lambda: p.TxnApp(p.Adder()), **kw, **p.kw)
        self.c.create(p.TXN_COORD)
        self.c.create("acct_a")
        self.c.create("acct_b")
        return self.c

    def sync_send(self, entry=0):
        c = self.c

        def send(name, value, rid=None, max_steps=600):
            self.rid += 1
            rid_ = self.rid if rid is None else rid
            box = []
            for attempt in range(max_steps):
                if attempt % 40 == 0:
                    c.managers[entry].propose(
                        name, value, request_id=rid_,
                        callback=lambda r, resp: box.append(resp),
                    )
                if box:
                    out = json.loads(box[-1])
                    self.log.append(("send", name, value, out))
                    return out
                c.step_all()
            raise AssertionError(f"no decision for {name}:{value[:40]}")

        return send

    def async_submit(self, entry=0):
        c = self.c

        def submit(name, value, rid, cb):
            c.managers[entry].propose(name, value, request_id=rid, callback=cb)

        return submit

    def transactor(self, **kw):
        return self.p.Transactor(self.async_submit(), lambda: self.c.step_all(), **kw)

    def resolver_for(self, presume_abort_s=5.0):
        steps = [0]
        res = self.p.TxnResolver(
            self.async_submit(), self.p.TXN_COORD, lambda: steps[0] * 0.05,
            resolve_period_s=0.2, presume_abort_s=presume_abort_s,
            retransmit_s=0.2,
        )

        def pump(max_steps=4000):
            for _ in range(max_steps):
                res.poll()
                self.c.step_all()
                steps[0] += 1
                if res.scans >= 3 and res.idle():
                    self.log.append(("resolver", steps[0], res.resolved_count))
                    return
            raise AssertionError(
                f"resolver never drained: live={res.live_records} "
                f"jobs={sorted(res._jobs)}")

        return res, pump

    def end_state(self):
        c = self.c
        apps = [{
            "totals": dict(m.app.totals), "locks": dict(m.app.locks),
            "staged": {k: [v[0], list(v[1])] for k, v in m.app.staged.items()},
            "resolved": {k: dict(v) for k, v in m.app.resolved.items()},
            "records": m.app.records,
            "ended": {k: dict(v) for k, v in m.app.ended.items()},
        } for m in c.managers]
        return json.loads(json.dumps({
            "apps": apps, "frontiers": c.frontiers().tolist(),
            "app_exec": c.app_exec().tolist(),
            "names": [dict(m.names) for m in c.managers],
        }, sort_keys=True, default=str))


def both(scenario, tmp_path=None):
    """``scenario(run, dirs)`` on both packages; the two records and end
    states must be equal."""
    got = []
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        run = Run(pkg)
        dirs = None
        if tmp_path is not None:
            dirs = [str(tmp_path / tag / f"n{r}") for r in range(3)]
        with scripted():
            try:
                scenario(run, dirs)
                got.append((json.loads(json.dumps(run.log, default=str)),
                            run.end_state()))
            finally:
                if run.c is not None:
                    run.c.close()
    (jlog, jend), (plog, pend) = got
    assert plog == jlog
    assert pend == jend


# ---------------------------------------------------------------------------
# the scenarios of tests/test_txn.py
# ---------------------------------------------------------------------------


def _commits_across_groups(run, _dirs):
    p = run.p
    c = run.make_cluster()
    assert p.DistTransactor is p.Transactor
    out = run.transactor().run(p.Transaction([("acct_a", "5"), ("acct_b", "7")]))
    run.log.append(("run", out))
    assert out["committed"] and out["outcome"] == p.COMMITTED, out
    c.run(6)
    for m in c.managers:
        assert m.app.totals.get("acct_a") == 5
        assert m.app.totals.get("acct_b") == 7
        assert m.app.locks == {} and m.app.staged == {}
    r = run.sync_send()(p.TXN_COORD, p.txc_op("outcome", out["txid"]))
    assert r["outcome"] == p.COMMITTED


def test_transaction_commits_across_groups():
    both(_commits_across_groups)


def _locked_group_refuses(run, _dirs):
    p = run.p
    c = run.make_cluster()
    send = run.sync_send()
    txid = "txlockhold"
    r = send("acct_a", p.tx_op("prepare", txid, vals=["1"]))
    assert r["ok"], r
    resp = send("acct_a", "99")
    assert not resp["ok"] and resp["locked_by"] == txid and resp["retry"]
    for m in c.managers:
        assert m.app.totals.get("acct_a", 0) == 0
    assert send("acct_a", p.tx_op("abort", txid))["ok"]
    assert send("acct_a", "3")
    c.run(4)
    assert c.managers[0].app.totals.get("acct_a") == 3


def test_locked_group_refuses_plain_requests_until_release():
    both(_locked_group_refuses)


def _abort_mid_protocol(run, _dirs):
    p = run.p
    c = run.make_cluster()
    send = run.sync_send()
    txid = "txabortarm"
    r = send(p.TXN_COORD, p.txc_op(
        "begin", txid, names=["acct_a", "acct_b"],
        ops=[["acct_a", "5"], ["acct_b", "7"]], t=0.0,
    ))
    assert r["ok"]
    assert send("acct_a", p.tx_op("prepare", txid, vals=["5"]))["ok"]
    c.run(4)
    for m in c.managers:
        assert m.app.locks.get("acct_a") == txid
        assert m.app.staged["acct_a"][0] == txid
        assert m.app.totals.get("acct_a", 0) == 0
    assert send(p.TXN_COORD, p.txc_op(
        "decide", txid, outcome=p.ABORTED))["outcome"] == p.ABORTED
    assert send("acct_a", p.tx_op("abort", txid))["ok"]
    assert send("acct_b", p.tx_op("abort", txid))["ok"]
    assert send(p.TXN_COORD, p.txc_op("end", txid))["outcome"] == p.ABORTED
    c.run(4)
    for m in c.managers:
        assert m.app.totals.get("acct_a", 0) == 0
        assert m.app.totals.get("acct_b", 0) == 0
        assert m.app.locks == {} and m.app.staged == {}
    r = send("acct_b", p.tx_op("prepare", txid, vals=["7"]))
    assert not r["ok"] and r["resolved"] == p.ABORTED
    for m in c.managers:
        assert m.app.locks == {}


def test_abort_mid_protocol_leaves_participants_unmutated():
    both(_abort_mid_protocol)


def _prepare_timeout(run, _dirs):
    p = run.p
    c = run.make_cluster()
    send = run.sync_send()
    rival = "txrival"
    assert send("acct_b", p.tx_op("prepare", rival, vals=["0"]))["ok"]
    out = run.transactor(prepare_timeout_s=1.0).run(
        p.Transaction([("acct_a", "2"), ("acct_b", "4")]))
    run.log.append(("run", out))
    assert not out["committed"] and "timeout" in out["aborted"], out
    c.run(4)
    for m in c.managers:
        assert "acct_a" not in m.app.locks
        assert m.app.totals.get("acct_a", 0) == 0
        assert m.app.totals.get("acct_b", 0) == 0
        assert m.app.locks.get("acct_b") == rival


def test_prepare_timeout_aborts_and_releases_sorted_prefix():
    both(_prepare_timeout)


def _lock_wait_retries(run, _dirs):
    p = run.p
    c = run.make_cluster()
    send = run.sync_send()
    rival = "txslow"
    assert send("acct_a", p.tx_op("prepare", rival, vals=["0"]))["ok"]
    steps = [0]
    d = p.TxnDriver(
        p.Transaction([("acct_a", "3")]), run.async_submit(), p.TXN_COORD,
        lambda: steps[0] * 0.05, prepare_timeout_s=60.0,
    )

    def pump(n):
        for _ in range(n):
            if d.poll() is not None:
                return
            c.step_all()
            steps[0] += 1

    pump(60)
    assert d.poll() is None
    assert send("acct_a", p.tx_op("abort", rival))["ok"]
    pump(800)
    out = d.poll()
    run.log.append(("poll", steps[0], out))
    assert out is not None and out["committed"], out
    c.run(4)
    for m in c.managers:
        assert m.app.totals.get("acct_a") == 3
        assert m.app.locks == {}


def test_lock_wait_retries_until_rival_releases():
    both(_lock_wait_retries)


def _refusal_not_cached(run, _dirs):
    p = run.p
    c = run.make_cluster()
    send = run.sync_send()
    rival = "txholder"
    assert send("acct_a", p.tx_op("prepare", rival, vals=["0"]))["ok"]
    rid = 0x5EED5EED
    r = send("acct_a", "9", rid=rid)
    assert not r["ok"] and r["retry"]
    assert send("acct_a", p.tx_op("abort", rival))["ok"]
    r = send("acct_a", "9", rid=rid)
    assert r == 9, r
    c.run(4)
    assert c.managers[0].app.totals.get("acct_a") == 9
    send("acct_a", "9", rid=rid)
    c.run(4)
    for m in c.managers:
        assert m.app.totals.get("acct_a") == 9


def test_retryable_refusal_is_not_cached():
    both(_refusal_not_cached)


def _commit_arm(run, dirs):
    p = run.p
    c = run.make_cluster(log_dirs=dirs, checkpoint_every=4)
    send = run.sync_send()
    txid = "txcommitarm"
    assert send(p.TXN_COORD, p.txc_op(
        "begin", txid, names=["acct_a", "acct_b"],
        ops=[["acct_a", "5"], ["acct_b", "7"]], t=0.0,
    ))["ok"]
    assert send("acct_a", p.tx_op("prepare", txid, vals=["5"]))["ok"]
    assert send("acct_b", p.tx_op("prepare", txid, vals=["7"]))["ok"]
    assert send(p.TXN_COORD, p.txc_op("prepared", txid))["ok"]
    assert send(p.TXN_COORD, p.txc_op(
        "decide", txid, outcome=p.COMMITTED))["outcome"] == p.COMMITTED
    c.run(4)
    for rid in range(3):
        c.restart(rid)
    for m in c.managers:
        assert m.app.locks.get("acct_a") == txid
        assert m.app.locks.get("acct_b") == txid
        assert m.app.records[p.TXN_COORD][txid]["state"] == p.COMMITTED
        assert m.app.totals.get("acct_a", 0) == 0
    res, pump = run.resolver_for()
    pump()
    assert res.resolved_count == 1
    for m in c.managers:
        assert m.app.totals.get("acct_a") == 5
        assert m.app.totals.get("acct_b") == 7
        assert m.app.locks == {} and m.app.staged == {}
    assert run.sync_send()(
        p.TXN_COORD, p.txc_op("outcome", txid))["outcome"] == p.COMMITTED


def test_coordinator_crash_commit_arm_recovers_from_journal(tmp_path):
    both(_commit_arm, tmp_path)


def _presumed_abort_arm(run, dirs):
    p = run.p
    c = run.make_cluster(log_dirs=dirs, checkpoint_every=4)
    send = run.sync_send()
    txid = "txdoubtarm"
    assert send(p.TXN_COORD, p.txc_op(
        "begin", txid, names=["acct_a", "acct_b"],
        ops=[["acct_a", "5"], ["acct_b", "7"]], t=0.0,
    ))["ok"]
    assert send("acct_a", p.tx_op("prepare", txid, vals=["5"]))["ok"]
    c.run(4)
    for rid in range(3):
        c.restart(rid)
    for m in c.managers:
        assert m.app.locks.get("acct_a") == txid
        assert m.app.records[p.TXN_COORD][txid]["state"] == "begun"
    res, pump = run.resolver_for(presume_abort_s=0.5)
    pump()
    assert res.resolved_count == 1
    for m in c.managers:
        assert m.app.totals.get("acct_a", 0) == 0
        assert m.app.totals.get("acct_b", 0) == 0
        assert m.app.locks == {} and m.app.staged == {}
    send = run.sync_send()
    assert send(p.TXN_COORD, p.txc_op("outcome", txid))["outcome"] == p.ABORTED
    r = send("acct_b", p.tx_op("prepare", txid, vals=["7"]))
    assert not r["ok"] and r["resolved"] == p.ABORTED


def test_coordinator_crash_presumed_abort_arm(tmp_path):
    both(_presumed_abort_arm, tmp_path)


def test_txn_soak_smoke():
    """``run_txn_soak(11, rounds=120)`` on both packages, in one fresh
    interpreter with the string hash pinned: equal result dictionaries
    and equal member end states (``torch_soak.parity``)."""
    r = in_child("parity", "txn_soak", 11, rounds=120, settle_budget_s=300.0)
    assert r["txns"] >= 1 and r["committed"] >= 1, r
