"""Cold restart of one node from a sharded checkpoint and a multi-file journal.

The port's counterpart of the JAX package's ``scripts/recovery_probe.py``,
as a function with the probe's procedure and defaults.  One
:class:`~gigapaxos_tpu_torch.manager.PaxosManager` (one replica) holds
``names`` names on ``g`` engine rows, each with an app state padded to
``state_bytes``:

1. **build**: batched creates of 32,768 names; one request on each of the
   ``active`` newest names; a sharded checkpoint (``shards`` shards, the
   recently active rows as the manifest's hot hints); then one padded
   request on each of the ``tail`` newest names, so the journal after the
   checkpoint spans files of ``journal_file_mb``.
2. **restart** (lazy): a new manager on the same directory replays the
   journal with ``workers`` segment workers and hydrates the ``hot``
   hottest names before it returns (``restart_to_serving_s``); a request
   on the newest name is answered while the node is still recovering
   (``time_to_first_serve_s``); the background hydrator drains the rest
   (``full_hydrate_s``).
3. **eager baseline** (optional): a restart that restores every app state
   before it returns.

Unlike the probe's 64-name spot check, every name is checked after full
hydration: a never-driven name holds no state, a driven one its whole
history before and after the checkpoint.  ``compare_cpu`` restarts a copy
of the directory (taken before the card's restart) with ``device="cpu"``
and requires every engine leaf to be bit-equal to the card's restart.

On the card, creates launch ``gp_create_groups`` and every tick
``gp_step`` and ``gp_make_blob``; the restarted manager's own launches are
in the result (``restart_launches``).

    python -m gigapaxos_tpu_torch.testing.recovery --eager-baseline \\
        --out RECOVERY_cuda.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..obs import gplog
from .density import ticks

log = gplog.get_logger("recovery")

CREATE_CHUNK = 32_768     # names per batched create (the probe's)
PROPOSE_CHUNK = 4096      # requests queued between tick bursts


class RecoveryCheckFailed(RuntimeError):
    """A name lost its history, or the hot name was not served while the
    node was still recovering, or a leaf differed from the CPU restart."""


def make_app(state_bytes: int):
    """An adder whose checkpoint strings carry ``state_bytes`` of padding:
    what lazy hydration defers is the per-name restore and JSON parse,
    which grows with the app state."""
    from ..models import StatefulAdderApp

    if state_bytes <= 0:
        return StatefulAdderApp()

    class PaddedStateApp(StatefulAdderApp):
        PAD = "x" * state_bytes

        def checkpoint(self, name):
            return json.dumps({"v": super().checkpoint(name), "pad": self.PAD})

        def restore(self, name, state):
            if state and state.startswith("{"):
                state = json.loads(state)["v"]
            return super().restore(name, state)

    return PaddedStateApp()


def leaves(m) -> Dict[str, np.ndarray]:
    """Every engine leaf of ``m`` as a private host array."""
    return {k: m._np(k).copy() for k in m.state._fields}


def dir_bytes(d: str) -> int:
    return sum(
        os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
        if os.path.isfile(os.path.join(d, f))
    )


def card_stamp(device) -> Dict:
    """The device the run took place on: platform, name and, on the card,
    ``nvidia-smi``'s name and power limit."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "nvidia_smi": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    idx = device.index or 0
    return {"platform": "cuda", "device": torch.cuda.get_device_name(idx),
            "nvidia_smi": smi[idx] if len(smi) > idx else None}


def _check(ok: bool, what) -> None:
    if not ok:
        raise RecoveryCheckFailed(what)


def run_recovery(
    g: int = 262_144,
    names: int = 262_144,
    active: int = 2048,
    tail: int = 32_768,
    pad_bytes: int = 256,
    state_bytes: int = 512,
    window: int = 8,
    shards: int = 16,
    workers: int = 4,
    hot: int = 1024,
    journal_file_mb: float = 4.0,
    eager_baseline: bool = False,
    compare_cpu: bool = False,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> dict:
    """Build, crash and restart one node (module docstring) with its
    journal and checkpoint in a temporary directory it removes; returns
    the probe's measurements and the facts the checks rest on.  Raises
    :class:`RecoveryCheckFailed` when a check fails."""
    import torch

    from ..manager import PaxosManager
    from ..ops.engine import EngineConfig, resolve_device
    from ..utils.config import Config

    say = progress or (lambda _msg: None)
    if not (0 < active <= tail <= names <= g):
        raise ValueError(f"need 0 < active {active} <= tail {tail} <= "
                         f"names {names} <= g {g}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    cfg = EngineConfig(n_groups=g, window=window, req_lanes=4, n_replicas=1)
    settings = {
        "RECOVERY_CHECKPOINT_SHARDS": str(shards),
        "RECOVERY_REPLAY_WORKERS": str(workers),
        "RECOVERY_HOT_NAMES": str(hot),
        "MAX_LOG_FILE_SIZE": str(int(journal_file_mb * 1024 * 1024)),
        "RECOVERY_LAZY_HYDRATION": "true",
    }
    saved = {k: Config._cli.get(k) for k in settings}
    log_dir = tempfile.mkdtemp(prefix="gp_recovery_")
    snap_dir = None
    all_names = [f"svc{i:07d}" for i in range(names)]
    act = all_names[-active:]
    tl = all_names[-tail:]

    def manager(dev, d=log_dir):
        return PaxosManager(
            0, make_app(state_bytes), cfg, log_dir=d,
            checkpoint_every=10 ** 9, sync_journal=False, device=dev,
        )

    def sync():
        if on_card:
            torch.cuda.synchronize()

    try:
        for k, v in settings.items():
            Config.set(k, v)
        # ---- build ---------------------------------------------------
        t0 = time.monotonic()
        m = manager(device)
        try:
            for lo in range(0, names, CREATE_CHUNK):
                m.create_paxos_batch(all_names[lo:lo + CREATE_CHUNK], [0])
            sync()
            t_create = time.monotonic() - t0
            say(f"build: {names} groups created in {t_create:.3f} s")
            for lo in range(0, active, PROPOSE_CHUNK):
                for nm in act[lo:lo + PROPOSE_CHUNK]:
                    m.propose(nm, "1")
                ticks(m, 3)
            ticks(m, 6)
            t_ck = time.monotonic()
            m.checkpoint_now()
            m.logger.drain_checkpoints()
            t_ck = time.monotonic() - t_ck
            # the tail after the checkpoint: padded payloads make the
            # journal span files (leading zeros keep the adder's delta 10)
            value = "10".zfill(max(2, pad_bytes))
            for lo in range(0, tail, PROPOSE_CHUNK):
                for nm in tl[lo:lo + PROPOSE_CHUNK]:
                    m.propose(nm, value)
                ticks(m, 3)
            ticks(m, 6)
            journal_files = len(m.logger.journal.file_indices())
            final = leaves(m)
        finally:
            m.close()
        in_active = set(act)
        expected = {nm: (11 if nm in in_active else 10) for nm in tl}
        du = dir_bytes(log_dir)
        say(f"build: checkpoint {t_ck:.3f} s, journal files {journal_files}, "
            f"directory {du} B")
        if compare_cpu:
            snap_dir = tempfile.mkdtemp(prefix="gp_recovery_cpu_")
            shutil.rmtree(snap_dir)
            shutil.copytree(log_dir, snap_dir)

        # ---- restart (lazy) -------------------------------------------
        t_restart = time.monotonic()
        m2 = manager(device)
        try:
            restart_to_serving_s = time.monotonic() - t_restart
            rst = m2.recovery_stats()
            restarted = leaves(m2)
            launches0 = dict(m2.kernel_launches)
            # the hot name answers now; the phase is read inside the
            # callback, the instant the response fires
            hot_name = tl[-1]
            hot_is_hot = m2.names[hot_name] not in m2.hydrating_rows
            got = {}

            def on_reply(_rid, v):
                got["v"] = v
                got["phase"] = m2.recovery_phase
                got["t"] = time.monotonic() - t_restart

            m2.propose(hot_name, "5", callback=on_reply)
            ticks(m2, 8)
            first_serve_s = got.get("t", time.monotonic() - t_restart)
            phase_at_first_serve = got.get("phase", m2.recovery_phase)
            expected[hot_name] += 5
            served_while_recovering = (
                got.get("v") == str(expected[hot_name])
                and phase_at_first_serve == "recovering"
            )
            deadline = time.monotonic() + 3600
            while (m2.recovery_phase != "serving"
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            full_hydrate_s = time.monotonic() - t_restart
            phase_end = m2.recovery_phase
            hydrated = m2.recovery_stats()["hydrated"]
            totals = m2.app.totals
            # every name: never driven -> no state; driven -> its history
            wrong = [nm for nm in all_names
                     if totals.get(nm) != expected.get(nm)
                     and (nm in expected or totals.get(nm))]
            restart_launches = {
                k: v - launches0.get(k, 0)
                for k, v in m2.kernel_launches.items()
            }
        finally:
            m2.close()
        say(f"restart: serving after {restart_to_serving_s:.3f} s, first "
            f"serve {first_serve_s:.3f} s, hydrated after {full_hydrate_s:.3f} s")

        eager_s = None
        if eager_baseline:
            Config.set("RECOVERY_LAZY_HYDRATION", "false")
            t_eager = time.monotonic()
            m3 = manager(device)
            eager_s = time.monotonic() - t_eager
            m3.close()
            Config.set("RECOVERY_LAZY_HYDRATION", "true")
            say(f"eager baseline: {eager_s:.3f} s")

        cpu = None
        if compare_cpu:
            t_cpu = time.monotonic()
            m4 = manager("cpu", snap_dir)
            try:
                cpu_leaves = leaves(m4)
            finally:
                m4.close()
            differ = sorted(k for k in restarted
                            if not np.array_equal(restarted[k], cpu_leaves[k]))
            cpu = {"restart_s": time.monotonic() - t_cpu,
                   "leaves_differ": differ}
            say(f"cpu restart of the same directory: {cpu}")
    finally:
        for k, v in saved.items():
            if v is None:
                Config._cli.pop(k, None)
            else:
                Config.set(k, v)
        for d in (log_dir, snap_dir):
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)

    differ_final = sorted(k for k in final
                          if not np.array_equal(final[k], restarted[k]))
    res = {
        "bench": "recovery",
        **card_stamp(device),
        "g": g, "names": names, "window": window, "shards": shards,
        "replay_workers": workers, "hot_names": hot,
        "active": active, "tail": tail, "pad_bytes": pad_bytes,
        "state_bytes": state_bytes,
        "journal_files": journal_files, "journal_file_mb": journal_file_mb,
        "dir_bytes": du,
        "build": {"create_s": t_create, "checkpoint_s": t_ck},
        "restart": {
            "restart_to_serving_s": restart_to_serving_s,
            "time_to_first_serve_s": first_serve_s,
            "full_hydrate_s": full_hydrate_s,
            "phase_at_serve": rst["phase"],
            "phase_at_first_serve": phase_at_first_serve,
            "phase_end": phase_end,
            "hot_served_before_hydration_done": served_while_recovering,
            "hot_name_is_hot": hot_is_hot,
            "hydration_backlog_at_serve": rst["hydration_backlog"],
            "groups_hydrated_total": hydrated,
            "names_checked": len(all_names),
            "names_wrong": len(wrong),
            "replay_segments": rst.get("segments"),
            "replay_blocks": rst.get("blocks"),
            "replay_s": rst.get("replay_s", 0.0),
            "replay_blocks_per_s": (
                rst["blocks"] / rst["replay_s"] if rst.get("replay_s") else None
            ),
            "checkpoint_generation": rst.get("checkpoint_generation"),
            # the crashed node's last leaves against the restart's (the
            # journal tail rolled forward): the leaves that differ
            "leaves_differ_from_crashed": differ_final,
        },
        "restart_launches": restart_launches,
        "eager_baseline_restart_s": eager_s,
        "cpu_restart": cpu,
    }
    _check(not wrong, ("names without their expected totals", len(wrong),
                       [(nm, totals.get(nm), expected.get(nm)) for nm in wrong[:8]]))
    _check(served_while_recovering,
           ("hot name not answered correctly while recovering",
            got, expected[hot_name]))
    _check(phase_end == "serving", ("hydration never finished", phase_end))
    if cpu is not None:
        _check(not cpu["leaves_differ"],
               ("leaves differ from the CPU restart", cpu["leaves_differ"]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--g", type=int, default=262_144,
                    help="engine rows (>= --names)")
    ap.add_argument("--names", type=int, default=262_144)
    ap.add_argument("--active", type=int, default=2048,
                    help="names that see traffic before the checkpoint")
    ap.add_argument("--tail", type=int, default=32_768,
                    help="names with traffic after the checkpoint")
    ap.add_argument("--pad-bytes", type=int, default=256,
                    help="request payload size in the journal tail")
    ap.add_argument("--state-bytes", type=int, default=512,
                    help="per-name app-state size in the checkpoint")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--hot", type=int, default=1024)
    ap.add_argument("--journal-file-mb", type=float, default=4.0,
                    help="journal rotation size (small: many files)")
    ap.add_argument("--eager-baseline", action="store_true",
                    help="also time a restart that restores every state")
    ap.add_argument("--compare-cpu", action="store_true",
                    help="restart a copy on the CPU; leaves must be equal")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the result as JSON to this file")
    args = ap.parse_args(argv)
    if args.out and re.fullmatch(r"RECOVERY_r\d+\.json",
                                 os.path.basename(args.out)):
        ap.error("RECOVERY_rNN.json is the JAX package's artifact; "
                 "name the port's result otherwise")
    gplog.configure()
    log.setLevel(logging.INFO)
    res = run_recovery(
        g=args.g, names=args.names, active=args.active, tail=args.tail,
        pad_bytes=args.pad_bytes, state_bytes=args.state_bytes,
        window=args.window, shards=args.shards, workers=args.workers,
        hot=args.hot, journal_file_mb=args.journal_file_mb,
        eager_baseline=args.eager_baseline, compare_cpu=args.compare_cpu,
        device=args.device, progress=log.info,
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
    raise SystemExit(main())
