"""Cluster launcher: start, stop and status of the port's ReconfigurableNode
processes.

The port's counterpart of the JAX package's ``scripts/gp_server.py``, and
so of the reference's ``bin/gpServer.sh:1-60`` (``gpServer.sh start all``
boots every node named in the properties file, one process per node;
``stop all`` kills them), driving ``python -m
gigapaxos_tpu_torch.reconfigurable_node``:

    python -m gigapaxos_tpu_torch.gp_server \\
        --config gigapaxos_tpu_torch/scenarios/loopback_3ar_3rc.properties start all
    python -m gigapaxos_tpu_torch.gp_server --config ... status all
    python -m gigapaxos_tpu_torch.gp_server --config ... stop all
    python -m gigapaxos_tpu_torch.gp_server --config ... start AR0 RC1

State lives under ``--run-dir`` (default ``gp_run/`` next to the config):
``<name>.pid`` and ``<name>.log`` per node.  ``start`` waits until every
booted node's listener accepts (or prints the log tail of whichever node
died); ``stop`` sends SIGTERM, waits, then SIGKILL to stragglers.

The nodes run on the card (``DEVICE=cuda``; this process builds the
kernels before it spawns them, so that the nodes booting together load
them) unless ``--device cpu`` is given; with no card and no ``--device``
``start`` raises.  Node processes inherit the environment otherwise
(``GP_TRACE=1`` turns their request tracers on).  A config whose
``APPLICATION`` names the JAX package is refused: a node of the port
would import JAX to load it.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .obs.gplog import emit
from .reconfigurable_node import check_application
from .utils.config import parse_properties


def load_nodes(config: Path) -> Dict[str, Tuple[str, int]]:
    """{node name: (host, port)} from active.* / reconfigurator.* lines.
    A name holding both roles (one process, two servers) appears once."""
    props = parse_properties(config.read_text(encoding="utf-8"))
    nodes: Dict[str, Tuple[str, int]] = {}
    for key, val in props.items():
        for prefix in ("active.", "reconfigurator."):
            if key.startswith(prefix):
                host, _, port = val.partition(":")
                nodes.setdefault(key[len(prefix):], (host, int(port)))
    return nodes


def pid_file(run_dir: Path, name: str) -> Path:
    return run_dir / f"{name}.pid"


def read_pid(run_dir: Path, name: str) -> Optional[int]:
    try:
        return int(pid_file(run_dir, name).read_text().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid: Optional[int]) -> bool:
    """True when ``pid`` is alive AND is one of ours: a stale pidfile whose
    PID the OS recycled for an unrelated process must not make ``stop``
    kill a bystander or ``start`` report 'already running'.  On Linux the
    /proc cmdline must name the node module; without /proc, liveness
    only."""
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return True  # no /proc: best-effort liveness
    return b"reconfigurable_node" in cmdline


def kill_quietly(pid: int, sig: int) -> None:
    """Signal a process that may exit between check and kill."""
    try:
        os.kill(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def port_up(addr: Tuple[str, int], timeout: float = 0.2) -> bool:
    try:
        with socket.create_connection(addr, timeout):
            return True
    except OSError:
        return False


def node_phase(addr: Tuple[str, int], timeout: float = 2.0) -> Optional[str]:
    """The node's recovery phase (``recovering`` | ``serving``) through a
    one-shot ``stats`` admin op, or None when the node does not answer
    (callers fall back to liveness)."""
    from .clients import PaxosClientAsync

    try:
        client = PaxosClientAsync([addr])
    except Exception:  # noqa: BLE001 — no phase is an answer here
        return None
    try:
        resp = client.admin_sync(0, {"op": "stats"}, timeout=timeout)
        return (resp or {}).get("phase")
    except Exception:  # noqa: BLE001
        return None
    finally:
        client.close()


def pick(nodes: Dict[str, Tuple[str, int]], wanted: List[str]) -> List[str]:
    if wanted == ["all"] or not wanted:
        return sorted(nodes)
    unknown = [w for w in wanted if w not in nodes]
    if unknown:
        raise SystemExit(
            f"unknown node(s) {unknown}; config defines {sorted(nodes)}"
        )
    return wanted


def do_start(args, nodes: Dict[str, Tuple[str, int]]) -> int:
    from .ops.engine import resolve_device

    check_application(parse_properties(
        args.config.read_text(encoding="utf-8")).get("APPLICATION", ""))
    device = resolve_device(args.device)
    run_dir: Path = args.run_dir
    run_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, GIGAPAXOS_CONFIG=str(args.config))
    if device.type == "cuda":
        from .ops import gp_kernels

        gp_kernels.build()
    started: List[str] = []
    for name in pick(nodes, args.nodes):
        if pid_alive(read_pid(run_dir, name)):
            emit(f"{name}: already running (pid {read_pid(run_dir, name)})")
            continue
        log = open(run_dir / f"{name}.log", "a")
        cmd = [sys.executable, "-m", "gigapaxos_tpu_torch.reconfigurable_node"]
        if args.clean:
            cmd.append("-c")
        cmd += [name, f"DEVICE={device.type}"]
        proc = subprocess.Popen(
            cmd, env=env, stdout=log, stderr=log,
            start_new_session=True,  # survives this launcher's terminal
        )
        log.close()
        pid_file(run_dir, name).write_text(str(proc.pid))
        started.append(name)
        emit(f"{name}: started pid {proc.pid} -> {nodes[name]}")
    # readiness: every started node's listener accepts AND reports
    # phase=serving (recovery hydration done); a node whose phase cannot
    # be read passes on liveness once its listener accepts
    deadline = time.time() + args.wait_s
    pending = set(started)
    recovering: Dict[str, str] = {}
    while pending and time.time() < deadline:
        for name in sorted(pending):
            if not pid_alive(read_pid(run_dir, name)):
                tail = (run_dir / f"{name}.log").read_text(
                    encoding="utf-8", errors="replace"
                )[-2000:]
                emit(f"{name}: DIED during startup; log tail:\n{tail}")
                return 1
            if not port_up(nodes[name]):
                continue
            phase = node_phase(nodes[name])
            if phase == "recovering":
                recovering[name] = phase
                continue
            if name in recovering:
                emit(f"{name}: serving (hydration done)")
                recovering.pop(name, None)
            pending.discard(name)
        if pending:
            time.sleep(0.3)
    if pending:
        still = {n: ("recovering" if n in recovering else "not listening")
                 for n in sorted(pending)}
        emit(f"timeout after {args.wait_s}s: {still}")
        return 1
    if started:
        emit(f"up: {sorted(started)}")
    return 0


def do_stop(args, nodes: Dict[str, Tuple[str, int]]) -> int:
    run_dir: Path = args.run_dir
    victims = []
    for name in pick(nodes, args.nodes):
        pid = read_pid(run_dir, name)
        if not pid_alive(pid):
            emit(f"{name}: not running")
            pid_file(run_dir, name).unlink(missing_ok=True)
            continue
        kill_quietly(pid, signal.SIGTERM)
        victims.append((name, pid))
    deadline = time.time() + args.wait_s
    for name, pid in victims:
        while pid_alive(pid) and time.time() < deadline:
            time.sleep(0.2)
        if pid_alive(pid):
            emit(f"{name}: SIGKILL after {args.wait_s}s grace")
            kill_quietly(pid, signal.SIGKILL)
        pid_file(run_dir, name).unlink(missing_ok=True)
        emit(f"{name}: stopped")
    return 0


def do_status(args, nodes: Dict[str, Tuple[str, int]]) -> int:
    run_dir: Path = args.run_dir
    all_up = True
    for name in pick(nodes, args.nodes):
        pid = read_pid(run_dir, name)
        alive = pid_alive(pid)
        listening = alive and port_up(nodes[name])
        state = ("up" if listening
                 else "starting" if alive else "down")
        if listening:
            # up != caught up: show the recovery phase
            phase = node_phase(nodes[name])
            if phase:
                state = f"up ({phase})"
        all_up = all_up and listening
        emit(f"{name}: {state}"
              + (f" (pid {pid}, {nodes[name][0]}:{nodes[name][1]})"
                 if alive else ""))
    return 0 if all_up else 3


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="start/stop/status for a ReconfigurableNode cluster of "
                    "the port (bin/gpServer.sh analog)"
    )
    ap.add_argument("--config", type=Path,
                    default=Path("gigapaxos.properties"),
                    help="properties file with active.*/reconfigurator.* "
                         "address book (GIGAPAXOS_CONFIG for the nodes)")
    ap.add_argument("--run-dir", type=Path, default=None,
                    help="pid/log directory (default: gp_run/ next to "
                         "the config)")
    ap.add_argument("--wait-s", type=float, default=60.0,
                    help="start: listener-readiness timeout; stop: "
                         "SIGTERM grace before SIGKILL")
    ap.add_argument("--clean", action="store_true",
                    help="start nodes clean-slate (-c: wipe their "
                         "durable state first)")
    ap.add_argument("--device", default=None,
                    help="start: the nodes' engine device, cuda (default) "
                         "or cpu")
    ap.add_argument("action", choices=("start", "stop", "status"))
    ap.add_argument("nodes", nargs="*", default=["all"],
                    help="'all' (default) or node names from the config")
    args = ap.parse_args(argv)
    if not args.config.exists():
        emit(f"no such config: {args.config}")
        return 2
    if args.run_dir is None:
        args.run_dir = args.config.resolve().parent / "gp_run"
    nodes = load_nodes(args.config)
    if not nodes:
        emit(f"{args.config}: no active.*/reconfigurator.* entries")
        return 2
    return {"start": do_start, "stop": do_stop, "status": do_status}[
        args.action
    ](args, nodes)


if __name__ == "__main__":
    sys.exit(main())
