"""Package-wide structured logging — the ``java.util.logging`` analog.

The reference logs through ``java.util.logging`` with lazy parameter
arrays everywhere on the hot path (``PaxosInstanceStateMachine.java:
425-432`` idiom: ``log.log(Level.FINE, "{0} ...", new Object[]{...})``);
the Python analog is stdlib ``logging`` with ``%``-style args, which are
only ever formatted when the record passes the level check.

Layout: one root logger ``"gp"`` (never propagates into an application's
root handlers) with one stderr handler; components are child loggers
(``gp.server``, ``gp.manager``, ``gp.rc``, ``gp.storage``, ``gp.trace``,
...) so levels tune per component.  Nodes share a process in every test
topology, so the node id rides a :class:`logging.LoggerAdapter` prefix
(``[node N]``), not per-node loggers — N nodes x C components would leak
logger objects per cluster in the soak loops.

Env grammar (``GP_LOG``)::

    GP_LOG=INFO                     # package root level
    GP_LOG=server:DEBUG             # one component
    GP_LOG=INFO,server:DEBUG,trace:DEBUG   # root + overrides, any order

Levels are the stdlib names (DEBUG/INFO/WARNING/ERROR/CRITICAL).  An
unknown level or component spec is reported once and skipped — a typo'd
env var must never take a node down.  Default level is WARNING: a
healthy cluster is silent, exactly like the reference's defaults.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional, Set, Tuple

ROOT = "gp"
DEFAULT_LEVEL = logging.WARNING

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "WARN": logging.WARNING,
    "ERROR": logging.ERROR,
    "CRITICAL": logging.CRITICAL,
}

_lock = threading.Lock()
_configured = False
_warned_once: Set[Tuple[str, str]] = set()  # (logger name, key) dedup


def configure(stream=None, force: bool = False) -> logging.Logger:
    """Idempotent package-wide setup; returns the ``gp`` root logger.

    Installs ONE stderr handler on the ``gp`` root (replaced when
    ``force=True`` — tests redirect into a ``StringIO`` this way) and
    applies the ``GP_LOG`` env levels.  Safe to call from every module's
    import path: after the first call it only re-reads ``GP_LOG``."""
    global _configured
    root = logging.getLogger(ROOT)
    with _lock:
        if force:
            for h in list(root.handlers):
                root.removeHandler(h)
        fresh = not _configured or force or not root.handlers
        if fresh:
            root.propagate = False
            if not root.handlers:
                handler = logging.StreamHandler(stream or sys.stderr)
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s.%(msecs)03d %(levelname)-7s %(name)s "
                    "%(message)s",
                    datefmt="%H:%M:%S",
                ))
                root.addHandler(handler)
            if root.level == logging.NOTSET:
                root.setLevel(DEFAULT_LEVEL)
            _configured = True
    # env levels apply only on FRESH setup: get_logger() funnels every
    # component fetch through here, and re-applying GP_LOG each time
    # would both re-parse the spec per fetch and silently clobber a
    # runtime operator override (setLevel during an incident)
    if fresh:
        apply_env_levels()
    return root


def apply_env_levels(spec: Optional[str] = None) -> None:
    """Parse a ``GP_LOG`` spec (the env var when None) into logger levels."""
    if spec is None:
        spec = os.environ.get("GP_LOG", "")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        comp, sep, lvl_name = part.rpartition(":")
        if not sep:
            comp, lvl_name = "", part
        level = _LEVELS.get(lvl_name.strip().upper())
        if level is None:
            warn_once(
                logging.getLogger(ROOT), f"badlevel:{part}",
                "ignoring unparseable GP_LOG fragment %r "
                "(want LEVEL or component:LEVEL)", part,
            )
            continue
        name = f"{ROOT}.{comp.strip()}" if comp.strip() else ROOT
        logging.getLogger(name).setLevel(level)


def get_logger(component: str) -> logging.Logger:
    """Component logger under the ``gp`` root (``gp.<component>``)."""
    configure()
    return logging.getLogger(f"{ROOT}.{component}")


class NodeAdapter(logging.LoggerAdapter):
    """``[node N]`` prefix adapter; keeps lazy ``%`` args lazy (the
    prefix concatenation only runs once the level check has passed)."""

    def process(self, msg, kwargs):
        return f"[node {self.extra['node']}] {msg}", kwargs


def node_logger(component: str, node_id) -> NodeAdapter:
    """A component logger that stamps every record with ``[node N]``."""
    return NodeAdapter(get_logger(component), {"node": node_id})


def warn_once(log, key: str, msg: str, *args) -> None:
    """WARNING-level log deduplicated per (logger, key) for the process
    lifetime — the once-per-kind pattern (a skewed peer republishing a
    bad frame every tick must not flood the log)."""
    logger = getattr(log, "logger", log)  # unwrap adapters for the key
    dedup = (logger.name, key)
    with _lock:
        if dedup in _warned_once:
            return
        _warned_once.add(dedup)
    log.warning(msg, *args)


def reset_for_tests() -> None:
    """Drop handler/level/dedup state so tests get a clean slate."""
    global _configured
    root = logging.getLogger(ROOT)
    with _lock:
        for h in list(root.handlers):
            root.removeHandler(h)
        root.setLevel(logging.NOTSET)
        _warned_once.clear()
        _configured = False
    # child levels linger across Logger instances (logging caches them
    # process-wide); reset any gp.* child a test may have touched
    for name, lg in list(logging.Logger.manager.loggerDict.items()):
        if name.startswith(ROOT + ".") and isinstance(lg, logging.Logger):
            lg.setLevel(logging.NOTSET)


def emit(text: str = "", err: bool = False) -> None:
    """A command-line tool's output for its caller to read (a JSON result
    line, a rendered timeline) on standard output, or on standard error
    with ``err``: the tool's product, not a log record, so it passes no
    level check.  The package's tools (``testing/bench.py``,
    ``testing/probe.py``, ``gp_server.py``, ...) write through here."""
    stream = sys.stderr if err else sys.stdout
    stream.write(f"{text}\n")
    stream.flush()
