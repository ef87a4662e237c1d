"""Cross-node trace merge: per-node ``trace_dump`` rings → one causal
per-request timeline with per-hop latency attribution.

The Dapper post-processing half: each node's :class:`RequestTracer`
records its own hops with wall-clock stamps; this module correlates
events across nodes (by the shared trace id when the request was
sampled, falling back to the request id — globally unique and carried on
every hop), sorts them into one timeline, and attributes the latency
between adjacent hops to a named phase (client wait, ingress, admission,
forward wire, consensus, execute, flush).  Consumers:

* ``scripts/gp_trace.py`` — fans ``trace_dump`` over a live cluster and
  renders merged timelines;
* ``testing/chaos.py`` — embeds the MERGED cross-member timeline into
  every ``SoakDivergence`` (one causal story instead of N per-member
  fragments);
* the tier-1 loopback trace test.

Clock skew: per-hop deltas clamp at 0 (two hosts' wall clocks can
disagree by more than a fast hop takes; a negative latency is always
skew, never causality).  Within one host — the loopback topologies — the
clamp never fires.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# (event_at_t, next_event) -> phase label for the latency between them.
# Unlisted adjacencies render as "a->b" verbatim — a merge must never
# hide a hop just because it has no pretty name.
PHASE_LABELS = {
    ("send", "recv"): "client-wire",
    ("recv", "propose"): "ingress",
    ("recv", "respond-cached"): "cached-answer",
    ("propose", "forward-out"): "admission-queue",
    ("forward-out", "forward-in"): "forward-wire",
    ("forward-in", "propose"): "re-propose",
    ("propose", "decide"): "consensus",
    ("decide", "decide"): "exchange",
    ("decide", "execute"): "execute-gate",
    ("execute", "decide"): "exchange",
    ("execute", "execute"): "execute-fanout",
    ("execute", "respond-flush"): "flush",
    ("respond-flush", "respond-recv"): "client-wire",
}


def merge_node_dumps(dumps: Dict) -> List[Dict]:
    """Merge per-node trace exports into causal per-request timelines.

    ``dumps``: ``{node_id: {key: [[t_wall, event, detail], ...]}}`` —
    the shape ``RequestTracer.export`` / the ``trace_dump`` admin op
    produce.  Returns one dict per request/trace, ordered by first
    event: ``{"trace_id", "keys", "events": [{t, node, event, detail}],
    "hops": [{phase, dt_s, from_node, to_node, from_event, to_event}],
    "total_s"}``.  Per-hop ``dt_s`` is clamped non-negative (clock
    skew)."""
    # pass 1: learn each key's trace id (any node's event may carry it)
    key_tid: Dict[str, int] = {}
    for by_key in dumps.values():
        for key, evs in by_key.items():
            for _t, _ev, detail in evs:
                tid = detail.get("tid")
                if tid:
                    key_tid[key] = tid
                    break
    # pass 2: bucket every event by correlation id (tid, else key)
    buckets: Dict = {}
    bucket_keys: Dict = {}
    for node, by_key in dumps.items():
        for key, evs in by_key.items():
            corr = key_tid.get(key, key)
            bucket_keys.setdefault(corr, set()).add(key)
            dst = buckets.setdefault(corr, [])
            for t, ev, detail in evs:
                dst.append({
                    "t": float(t), "node": node, "event": ev,
                    "detail": detail,
                })
    out: List[Dict] = []
    for corr, evs in buckets.items():
        # sort by (time, hop) — wall clock orders the timeline; the hop
        # counter breaks exact-stamp ties causally (hop 0 = origin side
        # of a process boundary, hop 1 = the far side), and any residual
        # cross-host skew is absorbed by the dt clamp below
        evs.sort(key=lambda e: (e["t"], e["detail"].get("hop", 0)))
        hops = []
        for a, b in zip(evs, evs[1:]):
            pair = (a["event"], b["event"])
            hops.append({
                "phase": PHASE_LABELS.get(
                    pair, f"{a['event']}->{b['event']}"
                ),
                "dt_s": max(0.0, b["t"] - a["t"]),
                "from_node": a["node"], "to_node": b["node"],
                "from_event": a["event"], "to_event": b["event"],
            })
        tid = None
        for e in evs:
            tid = e["detail"].get("tid")
            if tid:
                break
        out.append({
            "trace_id": tid,
            "keys": sorted(bucket_keys.get(corr, ()), key=str),
            "events": evs,
            "hops": hops,
            "total_s": evs[-1]["t"] - evs[0]["t"] if evs else 0.0,
        })
    out.sort(key=lambda tr: tr["events"][0]["t"] if tr["events"] else 0.0)
    return out


def phase_totals(trace: Dict) -> Dict[str, float]:
    """Aggregate per-phase latency for one merged trace (the breakdown
    line: where did this request's wall time go?)."""
    acc: Dict[str, float] = {}
    for hop in trace["hops"]:
        acc[hop["phase"]] = acc.get(hop["phase"], 0.0) + hop["dt_s"]
    return acc


def parse_slo_budgets(spec: str) -> Dict[str, float]:
    """Parse a ``phase=ms`` CSV (the ``SLO_BUDGETS_MS`` flag / the
    ``gp_trace --slo`` argument) into ``{phase: budget_seconds}``.

    Phase names must be merged-trace labels (:data:`PHASE_LABELS`
    values) or the pseudo-phase ``total`` (the trace's end-to-end wall
    time) — an unknown name raises: a typoed budget that silently never
    fires is worse than no budget."""
    known = set(PHASE_LABELS.values()) | {"total"}
    budgets: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        phase, sep, ms = part.partition("=")
        phase = phase.strip()
        if not sep:
            raise ValueError(f"SLO budget {part!r}: expected phase=ms")
        if phase not in known:
            raise ValueError(
                f"SLO budget names unknown phase {phase!r} "
                f"(known: {', '.join(sorted(known))})"
            )
        budgets[phase] = float(ms) / 1e3
    return budgets


def default_slo_budgets(spec: Optional[str] = None) -> Dict[str, float]:
    """Resolve SLO budgets from an explicit spec, falling back to the
    ``SLO_BUDGETS_MS`` flag (so a scenario's properties file sets the
    cluster's budgets and ``gp_trace --slo`` with no argument uses
    them)."""
    if not spec:
        from gigapaxos_tpu_torch.paxos_config import PC
        from gigapaxos_tpu_torch.utils.config import Config

        spec = Config.get_str(PC.SLO_BUDGETS_MS)
    return parse_slo_budgets(spec)


def slo_breaches(trace: Dict, budgets: Dict[str, float]) -> List[Dict]:
    """Evaluate one merged trace against per-phase budgets: every phase
    whose aggregated latency exceeds its budget, plus the ``total``
    pseudo-phase against end-to-end wall time.  Returns
    ``[{phase, dt_s, budget_s}]`` (empty = within SLO)."""
    totals = phase_totals(trace)
    totals["total"] = float(trace.get("total_s", 0.0))
    out: List[Dict] = []
    for phase, budget_s in budgets.items():
        dt = totals.get(phase)
        if dt is not None and dt > budget_s:
            out.append({"phase": phase, "dt_s": dt, "budget_s": budget_s})
    out.sort(key=lambda b: b["budget_s"] - b["dt_s"])
    return out


def render_trace(trace: Dict) -> str:
    """One merged timeline as text: every hop's event with its node and
    relative time, then the per-phase attribution."""
    evs = trace["events"]
    if not evs:
        return "<empty trace>"
    head = f"trace {trace['keys']}"
    if trace.get("trace_id"):
        head += f" tid=0x{trace['trace_id']:x}"
    lines = [f"{head} total={trace['total_s'] * 1e3:.3f}ms"]
    t0 = evs[0]["t"]
    for e in evs:
        tail = " ".join(
            f"{k}={v}" for k, v in e["detail"].items() if k != "tid"
        )
        lines.append(
            f"  +{(e['t'] - t0) * 1e3:9.3f}ms {e['event']:<14}"
            f" @ node {e['node']}" + (f" [{tail}]" if tail else "")
        )
    tot = phase_totals(trace)
    if tot:
        lines.append("  phases: " + " ".join(
            f"{ph}={dt * 1e3:.3f}ms"
            for ph, dt in sorted(tot.items(), key=lambda kv: -kv[1])
        ))
    return "\n".join(lines)


def merge_name_timeline(tracers: Dict, name: str,
                        limit: int = 4) -> Optional[str]:
    """In-process convenience for the chaos soaks: merge the given
    ``{node_id: RequestTracer}`` rings' recent keys for ``name`` into
    rendered cross-member timelines (the ``SoakDivergence`` payload).
    Returns None when no member traced anything for the name."""
    dumps = {}
    for node, tr in tracers.items():
        evs = tr.export(name=name)
        if evs:
            dumps[node] = evs
    if not dumps:
        return None
    traces = merge_node_dumps(dumps)[-limit:]
    return "\n".join(render_trace(t) for t in traces)
