"""Varied-seed chaos sweep: run the soak over many seeds in ONE process
(so the kernels build once), reporting every failing seed with
diagnostics AND writing a machine-readable sweep artifact so strict-sweep
progress is diffable across runs instead of log-scraped.

The port's counterpart of the JAX package's ``scripts/chaos_sweep.py``,
with its flags, families, stride, budget, stat keys, artifact and exit
code.  The soaks are :mod:`gigapaxos_tpu_torch.testing.chaos`'s, on the
wall clock as there, on the card unless ``--device cpu`` is given (with
no card it raises).

Usage:  python -m gigapaxos_tpu_torch.testing.chaos_sweep --base 1
            --count 100 [--stride 7919] [--family core,txn,density]
            [--device cpu] [--out FILE]

The artifact records every seed run, every breach (exception text +
divergence diagnostics summary), and the per-breach flight-recorder dump
paths (``obs/flight.py`` — attached to each ``SoakDivergence`` by the
soak) so a breach is post-mortemable from the artifact alone.  It is
written only with ``--out`` (the JAX package's artifact names are
refused), stamped with the platform and the card's ``nvidia-smi`` name
and power limit.
"""

import argparse
import json
import os
import sys
import time
import traceback

from ..obs.gplog import emit
from .bench import check_out
from .chaos import SoakDivergence, run_density_soak, run_soak, run_txn_soak

#: stats keys worth carrying into the artifact, per soak flavor
_STAT_KEYS = ("settle_iters", "txns", "committed", "aborted", "killed",
              "in_doubt_resolved", "replies", "compactions", "segments")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=int, default=1)
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--stride", type=int, default=7919)
    ap.add_argument("--budget-s", type=float, default=None,
                    help="stop starting new seeds after this much wall time")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--names", type=int, default=6)
    ap.add_argument("--loss", type=float, default=0.2)
    ap.add_argument("--dup-rate", type=float, default=0.0)
    ap.add_argument("--family", default="core",
                    help="comma list of soak families to run per seed: "
                         "core (reconfiguration-plane run_soak), "
                         "txn (2PC bank-transfer run_txn_soak, its own "
                         "tuned fault rates), and/or density "
                         "(residency-plane run_density_soak: batched "
                         "pause/resume churn over a squeezed spill store)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the soaks' engines")
    ap.add_argument("--out", default="",
                    help="sweep artifact path ('' disables the write)")
    args = ap.parse_args(argv)
    check_out(args.out)

    from ..ops.engine import resolve_device
    from .recovery import card_stamp

    runners = {
        "core": lambda seed: run_soak(
            seed, rounds=args.rounds, n_names=args.names,
            loss=args.loss, dup_rate=args.dup_rate, device=device,
        ),
        "txn": lambda seed: run_txn_soak(seed, device=device),
        "density": lambda seed: run_density_soak(seed, device=device),
    }
    families = [f.strip() for f in args.family.split(",") if f.strip()]
    unknown = [f for f in families if f not in runners]
    if unknown:
        ap.error(f"unknown --family {unknown} (choose from "
                 f"{sorted(runners)})")
    device = resolve_device(args.device)

    fails = []
    results = []
    t0 = time.time()
    done = 0
    for i in range(args.count):
        seed = args.base + i * args.stride
        for family in families:
            t = time.time()
            try:
                stats = runners[family](seed)
                ent = {
                    "family": family, "seed": seed, "ok": True,
                    "elapsed_s": round(time.time() - t, 1),
                }
                ent.update({k: stats[k] for k in _STAT_KEYS
                            if k in stats})
                results.append(ent)
                emit(f"[{i}] {family} seed={seed} OK "
                     f"{time.time() - t:.1f}s")
            except Exception as e:
                emit(f"[{i}] {family} seed={seed} FAIL "
                     f"{time.time() - t:.1f}s: {e}")
                emit(traceback.format_exc(), err=True)
                fails.append({"family": family, "seed": seed})
                ent = {
                    "family": family, "seed": seed, "ok": False,
                    "elapsed_s": round(time.time() - t, 1),
                    "error_type": type(e).__name__,
                    # the first line carries the invariant that broke; the
                    # full diag is in the flight dumps + stdout log
                    "error": str(e)[:2000],
                }
                if isinstance(e, SoakDivergence):
                    ent["flight_dumps"] = e.diag.get("flight_dumps", [])
                    ent["divergent_names"] = sorted(
                        str(v) for k, v in e.diag.items() if k == "name"
                    )
                results.append(ent)
        done += 1
        if args.budget_s is not None and time.time() - t0 > args.budget_s:
            break
    emit(f"DONE ran={done} fails={fails}")
    if args.out:
        stamp = card_stamp(device)
        doc = {
            "metric": "chaos_fresh_seed_sweep",
            "strict": os.environ.get("CHAOS_FRESH_STRICT", "") == "1",
            "params": {
                "base": args.base, "count": args.count,
                "stride": args.stride, "rounds": args.rounds,
                "names": args.names, "loss": args.loss,
                "dup_rate": args.dup_rate,
                "families": families,
            },
            "ran": done,
            "failed_seeds": fails,
            "fail_rate": round(len(fails) / (done * len(families)), 4)
            if done else None,
            "elapsed_s": round(time.time() - t0, 1),
            "seeds": results,
            "platform": stamp["platform"],
            "card": stamp,
        }
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, args.out)
        emit(f"artifact: {args.out}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
