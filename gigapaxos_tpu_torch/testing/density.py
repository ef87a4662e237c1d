"""Group density on one node: many more names than engine rows.

The port's counterpart of the JAX package's ``scripts/density_probe.py``,
as a function.  One :class:`~gigapaxos_tpu_torch.manager.PaxosManager`
(one replica, ``PACKED_SPILL`` on, journal in a temporary directory)
holds ``names`` names on ``rows`` engine rows; paused names hold no row.
Phases, as the probe runs them:

1. **boot**: chunks of ``boot_chunk`` names, each one batched create
   (``create_groups``) and one batched hibernate (``kill_groups``);
2. **ablation**: a ``burst``-name cold set woken by the per-name
   ``restore`` loop (one ``create_groups`` + one ``restore_paused_rows``
   per name) against one ``restore_batch`` (one of each for the burst);
3. **churn**: ``rounds`` rounds of ``round_requests`` Zipf(``zipf_a``)
   requests over a hot window of ``hot_pct`` % of the names whose head
   rotates every round; cold names wake batched, names that leave the
   window hibernate again.

On the card every lifecycle op launches its ``gp_lifecycle.cu`` kernel;
:func:`run_density` reports the launches of each phase.  It writes no
artifact: the caller stores the returned dict, as the CLI does with
``--out`` (its progress goes through ``obs/gplog``).

    python -m gigapaxos_tpu_torch.testing.density --names 65536 --rows 8192 \\
        --out DENSITY_cuda.json
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..obs import gplog

log = gplog.get_logger("density")

# EngineState: 12 [G] + 7 [G, W] int32 leaves
STATE_G_LEAVES = 12
STATE_GW_LEAVES = 7


def rss_bytes() -> int:
    """Resident set of this process (0 where /proc is missing)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def ticks(m, n: int = 4) -> None:
    """``n`` single-replica ticks: publish, then step on my own blob."""
    for _ in range(n):
        vec, _st = m.publish_snapshot()
        m.tick_host(np.stack([vec]), np.array([True]))


def pct(xs, q) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


class DensityCheckFailed(RuntimeError):
    """A phase lost a name or left a request unanswered."""


def _require(ok: bool, what) -> None:
    if not ok:
        raise DensityCheckFailed(what)


def _launch_counts() -> Dict[str, int]:
    from ..ops.engine import LAUNCHES

    return dict(LAUNCHES)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def run_density(
    names: int = 1_048_576,
    rows: int = 65_536,
    window: int = 16,
    req_lanes: int = 4,
    boot_chunk: int = 16_384,
    burst: int = 4096,
    per_name_burst: Optional[int] = None,
    hot_pct: float = 1.0,
    rounds: int = 20,
    round_requests: int = 512,
    zipf_a: float = 1.2,
    seed: int = 0,
    device=None,
    log_dir: Optional[str] = None,
    manager=None,
    progress: Optional[Callable[[str], None]] = None,
) -> dict:
    """Boot, ablation and churn (module docstring) on one manager; returns
    the measurements and the facts they rest on.  Raises
    :class:`DensityCheckFailed` when a phase loses a name or a request
    goes unanswered.

    ``per_name_burst`` (default ``burst``) cuts the per-name ablation arm
    to its first names; the batched arm always wakes all ``burst``.
    ``manager`` (optional) is a manager built by the caller with the same
    methods (``create_paxos_batch``, ``hibernate_batch``, ``restore``,
    ``restore_batch``, ``propose``, ``publish_snapshot``, ``tick_host``,
    ``residency_stats``, ``names``); by default this function builds the
    port's own on ``device`` (the card unless ``"cpu"``) with a journal
    under ``log_dir`` (default: a temporary directory it removes)."""
    import torch

    say = progress or (lambda _msg: None)
    boot_chunk = min(boot_chunk, rows)
    per_name_burst = burst if per_name_burst is None else min(per_name_burst, burst)
    hot_n = max(burst, int(names * hot_pct / 100.0))
    if hot_n > rows:
        raise ValueError(f"hot set {hot_n} exceeds engine rows {rows}")
    if 2 * burst > names:
        raise ValueError(f"two ablation sets of {burst} need more than {names} names")
    rng = np.random.default_rng(seed)
    own_dir = None
    if manager is None and log_dir is None:
        own_dir = log_dir = tempfile.mkdtemp(prefix="gp_density_")
    on_card = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    all_names = [f"svc{i:07d}" for i in range(names)]
    rss0 = rss_bytes()
    try:
        if manager is None:
            from ..manager import PaxosManager
            from ..models import StatefulAdderApp
            from ..ops.engine import EngineConfig, resolve_device
            from ..utils.config import Config

            device = resolve_device(device)
            cfg = EngineConfig(n_groups=rows, window=window,
                               req_lanes=req_lanes, n_replicas=1)
            prev = Config._cli.get("PACKED_SPILL")
            Config.set("PACKED_SPILL", "true")
            try:
                m = PaxosManager(
                    0, StatefulAdderApp(), cfg, log_dir=log_dir,
                    checkpoint_every=10 ** 9, sync_journal=False,
                    device=device,
                )
            finally:
                if prev is None:
                    Config._cli.pop("PACKED_SPILL", None)
                else:
                    Config.set("PACKED_SPILL", prev)
            on_card = torch.device(device).type == "cuda"
        else:
            m = manager
        rss_mgr = rss_bytes()
        launches = {}

        # ---- boot: create + hibernate in chunks ------------------------
        l0 = _launch_counts()
        t_boot = time.monotonic()
        for lo in range(0, names, boot_chunk):
            chunk = all_names[lo:lo + boot_chunk]
            m.create_paxos_batch(chunk, [0])
            n_slept = m.hibernate_batch(chunk)
            _require(n_slept == len(chunk), ("boot", n_slept, len(chunk)))
            if (lo // boot_chunk) % 16 == 0:
                say(f"boot: {lo + len(chunk)}/{names} names asleep, "
                    f"rss {rss_bytes() / 2 ** 20:.0f} MiB")
        sync()
        t_boot = time.monotonic() - t_boot
        rss1 = rss_bytes()
        launches["boot"] = _delta(_launch_counts(), l0)
        res_boot = m.residency_stats()
        _require(res_boot["paused_names"] == names
                 and res_boot["active_names"] == 0, res_boot)

        # ---- ablation: per-name restore loop vs one restore_batch ------
        # both paths warm first (N=1 and N=burst shapes) on a disjoint set
        A = all_names[:burst]
        B = all_names[burst:2 * burst]
        _require(m.restore(A[0]) and m.hibernate(A[0]), ("warm-up", A[0]))
        _require(m.restore_batch(B) == len(B), "warm-up wake")
        _require(m.hibernate_batch(B) == len(B), "warm-up hibernate")
        seq = A[:per_name_burst]
        l0 = _launch_counts()
        sync()
        t_seq = time.monotonic()
        for nm in seq:
            _require(m.restore(nm), ("per-name wake", nm))
        sync()
        t_seq = time.monotonic() - t_seq
        launches["wake_per_name"] = _delta(_launch_counts(), l0)
        _require(m.hibernate_batch(seq) == len(seq), "hibernate after per-name")
        l0 = _launch_counts()
        t_batch = time.monotonic()
        _require(m.restore_batch(A) == len(A), "batched wake")
        sync()
        t_batch = time.monotonic() - t_batch
        launches["wake_batched"] = _delta(_launch_counts(), l0)
        _require(m.hibernate_batch(A) == len(A), "hibernate after batched")
        per_name_us = 1e6 * t_seq / len(seq)
        batched_us = 1e6 * t_batch / len(A)
        speedup = per_name_us / batched_us if batched_us > 0 else float("inf")
        say(f"ablation: per-name {len(seq)} names in {t_seq:.4f} s, batched "
            f"{len(A)} in {t_batch:.4f} s: {speedup:.1f}x per name")

        # ---- churn: Zipfian over a rotating hot window -----------------
        delta = max(1, hot_n // 100)  # head advance per round
        head = 2 * burst  # start past the ablation sets
        replies = [0]
        wake_lat = []
        n_woken = n_proposed = 0

        def on_reply(_rid, _v):
            replies[0] += 1

        l0 = _launch_counts()
        t_churn = time.monotonic()
        for _rnd in range(rounds):
            hot = [all_names[(head + i) % names] for i in range(hot_n)]
            ranks = np.minimum(rng.zipf(zipf_a, round_requests), hot_n) - 1
            sampled = [hot[int(r)] for r in ranks]
            cold = sorted({nm for nm in sampled if nm not in m.names})
            if cold:
                tw = time.monotonic()
                n_ok = m.restore_batch(cold)
                sync()
                dt = time.monotonic() - tw
                _require(n_ok == len(cold), ("churn wake", n_ok, len(cold)))
                wake_lat.extend([dt] * len(cold))  # the whole burst waits
                n_woken += len(cold)
            for nm in sampled:
                m.propose(nm, "1", callback=on_reply)
            n_proposed += len(sampled)
            ticks(m, 3)
            head = (head + delta) % names
            in_window = set(hot[delta:]) | {
                all_names[(head + hot_n - 1 - i) % names] for i in range(delta)
            }
            fell_out = [nm for nm in list(m.names) if nm not in in_window]
            if fell_out:
                m.hibernate_batch(fell_out)
        ticks(m, 8)  # drain in-flight decisions
        sync()
        t_churn = time.monotonic() - t_churn
        launches["churn"] = _delta(_launch_counts(), l0)
        rss2 = rss_bytes()
        res_end = m.residency_stats()
        _require(res_end["active_names"] + res_end["paused_names"] == names, res_end)
        _require(replies[0] == n_proposed, ("replies", replies[0], n_proposed))
        store = res_end.get("store", {})
        engine_state_b = 4 * (STATE_G_LEAVES * rows
                              + STATE_GW_LEAVES * rows * window)
        return {
            "names": names, "rows": rows, "window": window,
            "req_lanes": req_lanes, "hot_set": hot_n, "burst": burst,
            "rounds": rounds, "round_requests": round_requests,
            "zipf_a": zipf_a, "seed": seed,
            "device": str(device) if manager is None else None,
            "boot": {
                "seconds": t_boot, "names_per_s": names / t_boot,
                "boot_chunk": boot_chunk,
            },
            "bytes_per_name": {
                "host_rss": (rss1 - rss0) / names,
                "host_rss_excl_manager": (rss1 - rss_mgr) / names,
                "device_state_model": engine_state_b / names,
                "spill_disk": store.get("bytes_per_record"),
            },
            "ablation": {
                "per_name_names": len(seq), "per_name_s": t_seq,
                "per_name_us": per_name_us,
                "batched_names": len(A), "batched_s": t_batch,
                "batched_us_per_name": batched_us,
                "speedup_per_name": speedup,
            },
            "churn": {
                "seconds": t_churn, "requests": n_proposed,
                "replies": replies[0], "req_per_s": replies[0] / t_churn,
                "names_woken": n_woken,
                "wake_p50_s": pct(wake_lat, 50),
                "wake_p99_s": pct(wake_lat, 99),
                "rss_end_mib": rss2 / 2 ** 20,
            },
            "launches": launches,
            "store": store,
            "residency_end": {
                k: res_end.get(k)
                for k in ("active_names", "paused_names", "paused_in_memory",
                          "paused_on_disk")
            },
        }
    finally:
        if manager is None and "m" in locals():
            m.close()
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--names", type=int, default=1_048_576)
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--boot-chunk", type=int, default=16_384)
    ap.add_argument("--burst", type=int, default=4096)
    ap.add_argument("--per-name-burst", type=int, default=None)
    ap.add_argument("--hot-pct", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--round-requests", type=int, default=512)
    ap.add_argument("--zipf-a", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the result as JSON to this file")
    args = ap.parse_args(argv)
    gplog.configure()
    log.setLevel(logging.INFO)
    res = run_density(
        names=args.names, rows=args.rows, window=args.window,
        boot_chunk=args.boot_chunk, burst=args.burst,
        per_name_burst=args.per_name_burst, hot_pct=args.hot_pct,
        rounds=args.rounds, round_requests=args.round_requests,
        zipf_a=args.zipf_a, seed=args.seed, device=args.device,
        progress=log.info,
    )
    text = json.dumps(res, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        log.info("wrote %s", args.out)
    else:
        log.info("%s", text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
