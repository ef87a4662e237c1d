"""Worker-process supervisor: spawn, monitor, and stop a sharded node's
serving workers.

One :class:`WorkerSupervisor` per sharded active node.  Workers are
plain OS processes (``python -m gigapaxos_tpu_torch.serving.worker NAME w``)
so each owns its own GIL, engine arrays, and journal; crash isolation
falls out for free (a dead worker takes down 1/W of the name space
until restart, not the node).  Configuration travels the same way the
launcher ships it to nodes: the ``GIGAPAXOS_CONFIG`` properties file
plus ``key=value`` argv overrides for anything the parent set
programmatically (tests, probes).  The parent's engine device travels
the same way, as ``DEVICE=...`` (a device given to a constructor sits in
no config tier).  Workers are spawned by exec (``subprocess``), never by
``fork``: a forked child of a process that touched CUDA cannot use it."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..obs import gplog
from ..paxos_config import PC
from ..utils.config import Config


class WorkerSupervisor:
    def __init__(
        self,
        node_name: str,
        n_workers: Optional[int] = None,
        extra_args: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
        log_path: Optional[str] = None,
        device: Optional[str] = None,
    ):
        self.node_name = node_name
        self.n_workers = (
            Config.get_int(PC.SERVING_WORKERS)
            if n_workers is None else int(n_workers)
        )
        self.extra_args = list(extra_args or [])
        if device is not None:
            # last on the line: a DEVICE among the shipped overrides
            # must not beat the parent's effective device
            self.extra_args.append(f"DEVICE={device}")
        self.env = dict(env) if env is not None else dict(os.environ)
        self.log_path = log_path
        self.procs: List[subprocess.Popen] = []
        self.log = gplog.get_logger("serving")
        self._log_file = None

    def start(self) -> None:
        out = None
        if self.log_path:
            self._log_file = open(self.log_path, "a", buffering=1)
            out = self._log_file
        for w in range(self.n_workers):
            self.procs.append(subprocess.Popen(
                [
                    sys.executable, "-m", "gigapaxos_tpu_torch.serving.worker",
                    *self.extra_args, self.node_name, str(w),
                ],
                env=self.env, stdout=out, stderr=out,
            ))
        self.log.info(
            "spawned %d serving workers for %s",
            self.n_workers, self.node_name,
        )

    def alive(self) -> List[bool]:
        return [p.poll() is None for p in self.procs]

    def wait_listening(self, timeout_s: float = 60.0) -> bool:
        """Wait until every worker's mesh port accepts connections (the
        parent's readiness gate before it starts routing)."""
        import socket

        from . import worker_address

        base = Config.node_addresses("active").get(self.node_name)
        if base is None:
            return False
        deadline = time.time() + timeout_s
        for w in range(self.n_workers):
            addr = worker_address(base, w)
            while True:
                if self.procs and self.procs[w].poll() is not None:
                    return False  # worker died during boot
                try:
                    s = socket.create_connection(addr, 0.2)
                    s.close()
                    break
                except OSError:
                    if time.time() > deadline:
                        return False
                    time.sleep(0.2)
        return True

    def stop(self, timeout_s: float = 10.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + timeout_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
