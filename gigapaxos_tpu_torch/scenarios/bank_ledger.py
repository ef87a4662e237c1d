"""Bank-ledger invariant workload: Zipfian-contended transfers across
>= 100k account groups, every transfer a real sorted-2PC transaction
(``gigapaxos_tpu_torch/txn``), ending in a conservation + per-name audit.

The port's counterpart of the JAX package's ``scenarios/bank_ledger.py``,
with its flags, defaults, procedure and JSON document.  The headline the
artifact makes checkable: at 100k+ Paxos groups on one card-resident
engine per replica, multi-group transactions commit atomically — money
moves between hot Zipfian accounts under real lock contention and the
total balance NEVER drifts, every balance equals its committed history,
and all replicas agree.

Usage (also reachable as ``python -m gigapaxos_tpu_torch.testing.probe
--bank-ledger ...``):

    python -m gigapaxos_tpu_torch.scenarios.bank_ledger --accounts 100000 \\
        --txns 400 --inflight 32 [--device cpu] [--out FILE]

Runs on the card unless ``--device cpu`` is given; with no card it
raises.  Prints one JSON document with commit/abort rates, commit-latency
p50/p99 and the audit verdicts, and beside them the port's own fields:
the platform and the card's ``nvidia-smi`` name and power limit
(``card``), the boot seconds (``boot_s``), the milliseconds per cluster
step (``ms_per_step``) and the kernel launches of the boot and of the run
by kernel name (``launches``).  It writes the document to a file only
with ``--out`` (the JAX package's artifact names are refused).  Exit code
1 on any audit failure.
"""

import argparse
import json
import os
import random
import sys
import time

import numpy as np

from ..models.apps import StatefulAdderApp
from ..obs.gplog import emit
from ..ops import engine as te
from ..ops.engine import EngineConfig, resolve_device
from ..paxos_config import PC
from ..testing.bench import check_out
from ..testing.cluster import ManagerCluster
from ..testing.recovery import card_stamp
from ..txn import COMMITTED, TXN_COORD, Transaction, TxnApp, TxnDriver
from ..utils.config import Config

STEP_DT = 0.05  # logical seconds per cluster step (chaos convention)
INITIAL_BALANCE = 100
CREATE_CHUNK = 32768


def _percentile(xs, q):
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def build_cluster(n_accounts: int, n_replicas: int, device=None):
    """Cluster sized for >= 100k groups: small window/lane footprint so
    the per-replica engine stays a few hundred MB of int32 planes."""
    n_groups = 1 << max(10, (n_accounts + 1).bit_length())
    cfg = EngineConfig(n_groups=n_groups, window=4, req_lanes=2,
                       n_replicas=n_replicas)
    c = ManagerCluster(cfg, lambda: TxnApp(StatefulAdderApp()), device=device)
    c.create(TXN_COORD)
    accounts = [f"a{i:07d}" for i in range(n_accounts)]
    members = list(range(n_replicas))
    for lo in range(0, n_accounts, CREATE_CHUNK):
        chunk = accounts[lo:lo + CREATE_CHUNK]
        inits = {nm: str(INITIAL_BALANCE) for nm in chunk}
        # every manager runs the same deterministic row probe over the
        # same name order, so the batch creates align without exchange
        for m in c.managers:
            n = m.create_paxos_batch(chunk, members, initial_states=inits)
            assert n == len(chunk), (n, len(chunk))
    c.blobs = [m.blob() for m in c.managers]
    return c, accounts


def zipf_sampler(n: int, alpha: float, rng: np.random.Generator):
    """Rank-Zipf over account indices: cumulative-weight inversion."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    cdf = np.cumsum(w)
    cdf /= cdf[-1]

    def sample() -> int:
        return int(np.searchsorted(cdf, rng.random()))

    return sample


def _launches_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in te.LAUNCHES.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--txns", type=int, default=1200)
    ap.add_argument(
        "--inflight", type=int,
        default=Config.get_int(PC.TXN_MAX_INFLIGHT),
    )
    ap.add_argument("--zipf", type=float, default=1.05,
                    help="Zipf alpha for account picks (contention knob)")
    ap.add_argument("--amount-max", type=int, default=9)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=400_000,
                    help="liveness budget in cluster steps, not wall time")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the engines' device")
    ap.add_argument("--out", default="",
                    help="artifact path ('' disables the write)")
    args = ap.parse_args(argv)
    check_out(args.out)
    device = resolve_device(args.device)

    t_boot = time.time()
    launches0 = dict(te.LAUNCHES)
    Config.set("RESPONSE_CACHE_TTL_S", "3600")
    c, accounts = build_cluster(args.accounts, args.replicas, device=device)
    boot_s = time.time() - t_boot
    launches_boot = _launches_since(launches0)
    emit(json.dumps({
        "event": "booted", "accounts": args.accounts,
        "n_groups": c.cfg.n_groups, "boot_s": round(boot_s, 1),
    }))

    rng = random.Random(args.seed)
    nrng = np.random.default_rng(args.seed)
    sample = zipf_sampler(args.accounts, args.zipf, nrng)
    steps = [0]

    def clock() -> float:
        return steps[0] * STEP_DT

    def submit(name, value, rid, cb):
        c.managers[rng.randrange(args.replicas)].propose(
            name, value, request_id=rid, callback=cb
        )

    metrics = c.managers[0].metrics

    def spawn() -> TxnDriver:
        a = sample()
        b = a
        while b == a:
            b = sample()
        amt = rng.randint(1, args.amount_max)
        txn = Transaction(
            [(accounts[a], str(-amt)), (accounts[b], str(amt))],
            txid=f"tx{rng.getrandbits(56):014x}",
        )
        return TxnDriver(txn, submit, TXN_COORD, clock,
                         prepare_timeout_s=8.0, retransmit_s=0.5,
                         metrics=metrics, rng=rng)

    t_run = time.time()
    launches0 = dict(te.LAUNCHES)
    pending, spawned, results = [], 0, []
    ledger = {}  # txid -> ops, COMMITTED only
    while (spawned < args.txns or pending) and steps[0] < args.max_steps:
        while len(pending) < args.inflight and spawned < args.txns:
            d = spawn()
            pending.append(d)
            spawned += 1
        for d in list(pending):
            r = d.poll()
            if r is not None:
                results.append(r)
                if r["outcome"] == COMMITTED:
                    ledger[r["txid"]] = list(d.txn.ops)
                pending.remove(d)
        c.step_all()
        steps[0] += 1
        if steps[0] % 500 == 0:
            emit(json.dumps({
                "event": "progress", "step": steps[0],
                "done": len(results), "committed": len(ledger),
            }))
    wall_run = time.time() - t_run
    launches_run = _launches_since(launches0)
    if pending:
        emit(json.dumps({"event": "stalled", "undone": len(pending)}))
        return 1

    # ---- audits -----------------------------------------------------
    failures = []
    # replicas agree on the full ledger (compare totals dicts wholesale)
    views = [m.app.totals for m in c.managers]
    if any(v != views[0] for v in views[1:]):
        bad = [nm for nm in views[0]
               if any(v.get(nm) != views[0][nm] for v in views[1:])]
        failures.append({"audit": "replica-agreement",
                         "disagreeing_names": bad[:20]})
    # no lock or staged op survives
    for m in c.managers:
        if m.app.locks or m.app.staged:
            failures.append({"audit": "lock-leak", "member": m.my_id,
                             "locks": len(m.app.locks),
                             "staged": len(m.app.staged)})
    # conservation: transfers move money, never mint or burn it
    total = sum(views[0].values())
    want_total = INITIAL_BALANCE * args.accounts
    if total != want_total:
        failures.append({"audit": "conservation", "total": total,
                         "want": want_total})
    # per-name linearizability: balance == initial + committed deltas
    expected = {}
    for ops in ledger.values():
        for nm, dv in ops:
            expected[nm] = expected.get(nm, 0) + int(dv)
    mismatch = {
        nm: {"have": views[0].get(nm), "want": INITIAL_BALANCE + delta}
        for nm, delta in expected.items()
        if views[0].get(nm) != INITIAL_BALANCE + delta
    }
    if mismatch:
        failures.append({"audit": "ledger-mismatch",
                         "names": dict(list(mismatch.items())[:20])})

    committed = len(ledger)
    lat = sorted(r["latency_s"] for r in results
                 if r["outcome"] == COMMITTED)
    stamp = card_stamp(device)
    doc = {
        "metric": "bank_ledger_txn",
        "params": {
            "accounts": args.accounts, "txns": args.txns,
            "inflight": args.inflight, "zipf_alpha": args.zipf,
            "amount_max": args.amount_max, "replicas": args.replicas,
            "seed": args.seed, "n_groups": c.cfg.n_groups,
        },
        "committed": committed,
        "aborted": len(results) - committed,
        "commit_rate": round(committed / max(1, len(results)), 4),
        "abort_rate": round(
            (len(results) - committed) / max(1, len(results)), 4),
        "commit_latency_s": {
            "p50": _percentile(lat, 0.50), "p99": _percentile(lat, 0.99),
        },
        "names_touched": len(expected),
        "steps": steps[0],
        "wall_run_s": round(wall_run, 1),
        "txns_per_s": round(len(results) / max(1e-9, wall_run), 2),
        "conservation": {"total": total, "want": want_total,
                         "ok": total == want_total},
        "audit": "pass" if not failures else "FAIL",
        "failures": failures,
        "platform": stamp["platform"],
        "card": stamp,
        "boot_s": boot_s,
        "ms_per_step": wall_run / max(1, steps[0]) * 1e3,
        "launches": {"boot": launches_boot, "run": launches_run},
        "t": time.time(),
    }
    emit(json.dumps(doc))
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, args.out)
    c.close()
    Config.clear()
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
