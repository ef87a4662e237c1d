"""Observability plane: structured logging, per-request tracing, and the
engine metrics registry.

The reference ships three distinct windows into a running node and this
package recreates all three for the array-world runtime:

* :mod:`.gplog` — package-wide ``logging`` setup (``java.util.logging``
  analog, lazy ``%``-style params throughout, SURVEY §5 /
  ``PaxosInstanceStateMachine.java:425-432``), with per-node ``[node N]``
  prefixes and env-driven per-component levels (``GP_LOG=...``).
* :mod:`.reqtrace` — the ``RequestInstrumenter`` analog
  (``paxosutil/RequestInstrumenter.java:36-80``): a bounded per-node ring
  of per-request event timelines, DEBUG-gated so the hot path pays one
  attribute check when disabled.
* :mod:`.metrics` — a histogram-capable counter/gauge registry for the
  per-step engine aggregates (decisions, preempts, coordinator flips,
  frontier stalls, blob bytes), complementing the EWMA-only
  :class:`~gigapaxos_tpu_torch.utils.profiler.DelayProfiler`.
* :mod:`.device` — the device-plane observatory: the signature sentinel
  every ``make_step`` instance is wrapped in, group-heat analysis for the
  on-device activity accumulator, cost attribution (bytes from shapes,
  allocator statistics), bounded ``torch.profiler`` captures, and the
  provenance stamp artifacts carry.

This package is the ONLY place in ``gigapaxos_tpu_torch`` allowed to write to
stderr directly (enforced by ``scripts/check_obs_hygiene.py``); every
other module routes diagnostics through :func:`gplog.get_logger`.
"""

from .device import (  # noqa: F401
    StepSentinel,
    all_sentinels,
    capture_profile,
    compile_stats,
    device_memory_stats,
    heat_summary,
    provenance,
    step_cost,
)
from .gplog import configure, get_logger, node_logger, warn_once  # noqa: F401
from .metrics import Histogram, MetricsRegistry  # noqa: F401
from .reqtrace import RequestTracer, trace_enabled  # noqa: F401
