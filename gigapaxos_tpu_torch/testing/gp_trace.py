"""gp_trace: fan ``trace_dump`` over a live cluster of the port and merge
the rings into causal per-request timelines.

The port's counterpart of the JAX package's ``scripts/gp_trace.py``, with
its flags, output and exit codes.  Each node's tracer ring knows only its
own hops; this asks every node for its ring (the ``trace_dump`` admin
op), correlates events by trace id or request id (``obs/tracemerge.py``)
and prints one merged timeline per request with per-hop latency
attribution (ingress, admission, forward wire, consensus, execute,
flush), then the mean and p99 of each hop over the merged requests.

    python -m gigapaxos_tpu_torch.testing.gp_trace \\
        --servers 127.0.0.1:3000,127.0.0.1:3001 \\
        [--rid 123 | --name probe0] [--limit 64] [--json] \\
        [--slo [ingress=50,consensus=500,total=2000]]
    python -m gigapaxos_tpu_torch.testing.gp_trace \\
        --props gigapaxos_tpu_torch/scenarios/loopback_3ar_3rc.properties

With ``--props`` the server list is the scenario's actives.  The cluster
must have traced something: clients with ``GP_TRACE_SAMPLE=1`` (or any
rate), or servers with ``GP_TRACE=1``.  ``--slo`` checks every merged
trace's per-phase totals (and the ``total`` pseudo-phase) against
``phase=ms`` budgets, given inline or from the ``SLO_BUDGETS_MS`` flag;
on any breach it prints the offending phases and exits 3.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from ..obs import tracemerge
from ..obs.gplog import emit


def fetch_dumps(client, n_servers: int, body: Dict, timeout: float = 10.0) -> Dict:
    """One trace_dump round trip per server, one after another (the
    client's admin waiters key by (op, name), so concurrent identical ops
    would take each other's replies): {node_id: events} for the nodes
    that answered."""
    dumps = {}
    for i in range(n_servers):
        r = client.admin_sync(i, dict(body), timeout=timeout)
        if r and r.get("ok"):
            dumps[r.get("node", i)] = r.get("events") or {}
    return dumps


def hop_summary(traces: List[Dict]) -> Dict[str, Dict]:
    """Per hop (phase): the merged requests it appears in, and the mean
    and p99 of its per-request total, in ms."""
    per: Dict[str, List[float]] = {}
    for tr in traces:
        for phase, dt in tracemerge.phase_totals(tr).items():
            per.setdefault(phase, []).append(dt)
        per.setdefault("total", []).append(tr["total_s"])
    out = {}
    for phase, xs in sorted(per.items()):
        xs = sorted(xs)
        out[phase] = {"n": len(xs), "mean_ms": 1e3 * sum(xs) / len(xs),
                      "p99_ms": 1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servers", default=None,
                    help="comma-separated host:port list (one per node)")
    ap.add_argument("--props", default=None,
                    help="properties file: use its active.* entries")
    ap.add_argument("--rid", type=int, default=None,
                    help="merge only this request id's timeline")
    ap.add_argument("--name", default=None,
                    help="merge the recently traced requests of this "
                         "service name")
    ap.add_argument("--limit", type=int, default=64,
                    help="newest keys per node without --rid/--name")
    ap.add_argument("--json", action="store_true",
                    help="emit merged traces as JSON instead of text")
    ap.add_argument("--slo", nargs="?", const="", default=None,
                    metavar="BUDGETS",
                    help="flag traces whose phase totals exceed their "
                         "budgets (phase=ms CSV; bare --slo uses the "
                         "SLO_BUDGETS_MS flag) and exit 3 on any breach")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    from ..clients import PaxosClientAsync
    from ..utils.config import Config

    if args.props:
        Config.load_file(args.props)
        book = Config.node_addresses("active")
        servers = [book[n] for n in sorted(book)]
    elif args.servers:
        servers = []
        for part in args.servers.split(","):
            host, _, port = part.strip().rpartition(":")
            servers.append((host, int(port)))
    else:
        ap.error("need --servers or --props")

    body = {"op": "trace_dump", "limit": args.limit}
    if args.rid is not None:
        body["rid"] = args.rid
    if args.name is not None:
        body["name"] = args.name

    client = PaxosClientAsync(servers)
    try:
        dumps = fetch_dumps(client, len(servers), body, args.timeout)
    finally:
        client.close()
    if not dumps:
        emit("no node answered trace_dump (cluster down, or no "
              "tracing: set GP_TRACE_SAMPLE / GP_TRACE)", err=True)
        return 1
    traces = tracemerge.merge_node_dumps(dumps)

    breached = []
    if args.slo is not None:
        try:
            budgets = tracemerge.default_slo_budgets(args.slo)
        except ValueError as e:
            emit(f"bad --slo budgets: {e}", err=True)
            return 2
        for tr in traces:
            over = tracemerge.slo_breaches(tr, budgets)
            if over:
                breached.append((tr, over))

    if args.json:
        emit(json.dumps({
            "nodes": sorted(dumps),
            "traces": traces,
            "hops": hop_summary(traces),
            **({"slo_breaches": [
                {"keys": tr["keys"], "breaches": over}
                for tr, over in breached
            ]} if args.slo is not None else {}),
        }, indent=1))
    else:
        if not traces:
            emit("nodes answered but no matching trace events "
                  f"(nodes: {sorted(dumps)})")
            return 1
        for tr in traces:
            emit(tracemerge.render_trace(tr))
            emit()
        emit("hops: " + json.dumps(hop_summary(traces)))
        for tr, over in breached:
            emit(f"SLO BREACH {tr['keys']}: " + " ".join(
                f"{b['phase']}={b['dt_s'] * 1e3:.1f}ms"
                f">{b['budget_s'] * 1e3:g}ms" for b in over
            ))
    if breached:
        if not args.json:
            emit(f"{len(breached)}/{len(traces)} trace(s) over SLO "
                  "budget", err=True)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
