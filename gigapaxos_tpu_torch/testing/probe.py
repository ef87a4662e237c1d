"""Capacity prober: the reference's benchmark protocol against the whole
system (sockets, framing, tick loop, engine, app), not just the engine.

The port's counterpart of the JAX package's root ``probe.py``, with its
procedure, knobs, flags and JSON lines.  Protocol
(``TESTPaxosClient.probeCapacity``, ``TESTPaxosClient.java:799-895``, with
the knobs of ``TESTPaxosConfig.java:190-229``): inject load at rate R for
a window; if the response rate stays >= 0.9 and the mean latency <= 1 s,
raise R by the factor 1.1 and repeat; the last sustained R is the
capacity ("capacity >= X/s").

By default it boots one OS process per node (3 actives + 3
reconfigurators from a temporary properties file, ``python -m
gigapaxos_tpu_torch.reconfigurable_node``); ``--in-process`` boots them in
this process; ``--attach PROPS`` probes a cluster already running
(``python -m gigapaxos_tpu_torch.gp_server ... start all``).  It drives
them with the reconfiguration-aware client and prints one JSON line per
round and a final summary line.

    python -m gigapaxos_tpu_torch.testing.probe [--device cpu] [--in-process]
        [--unreplicated] [--durable] [--attach PROPS] [--repeats N]
        [--capacity-out FILE --label L]

The nodes run on the card unless ``--device cpu`` is given (with no card
it raises); on the card the child nodes get ``DEVICE=cuda`` and this
process builds the kernels before it spawns them.  ``--device cpu`` runs
``torch.set_num_threads(1)``: six tick loops on a small host thrash an
intra-op thread pool.  ``--bank-ledger`` runs the bank-ledger
transaction workload (:mod:`gigapaxos_tpu_torch.scenarios.bank_ledger`)
instead, every other argument passed to its ``main``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

from ..obs.gplog import emit
from .bench import check_out
from .ports import free_ports


def _probe_provenance(device) -> dict:
    """Toolchain and device stamp for capacity artifacts."""
    from ..obs.device import provenance
    from .recovery import card_stamp

    return provenance(extra={"card": card_stamp(device)})


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bank-ledger", action="store_true",
                    help="run the Zipfian bank-ledger 2PC transaction "
                         "workload (scenarios/bank_ledger.py) instead of "
                         "the capacity ramp; remaining args are ITS flags "
                         "(--accounts, --txns, --inflight, --device, --out, "
                         "...)")
    ap.add_argument("--init-load", type=float, default=500.0,
                    help="starting request rate/s (PROBE_INIT_LOAD analog)")
    ap.add_argument("--factor", type=float, default=1.1)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--latency-ms", type=float, default=1000.0)
    ap.add_argument("--window-s", type=float, default=3.0,
                    help="measurement window per load step")
    ap.add_argument("--groups", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4,
                    help="injector threads (NUM_CLIENTS analog)")
    ap.add_argument("--max-rounds", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the nodes' engine device")
    ap.add_argument("--steps-per-dispatch", type=int, default=1, metavar="N",
                    help="ENGINE_STEPS_PER_DISPATCH for the booted nodes")
    ap.add_argument("--unreplicated", action="store_true",
                    help="EMULATE_UNREPLICATED attribution mode "
                         "(PaxosManager.java:1731): answer at the entry "
                         "without consensus, isolating app+wire cost")
    ap.add_argument("--durable", action="store_true",
                    help="in-process nodes journal to a temporary directory")
    ap.add_argument("--in-process", action="store_true",
                    help="all nodes in this process (default: one OS "
                         "process per node)")
    ap.add_argument("--attach", metavar="PROPS", default=None,
                    help="probe an already running cluster booted from "
                         "this properties file instead of booting nodes")
    ap.add_argument("--repeats", type=int, default=1,
                    help="independent ramps; >1 reports a noise band")
    ap.add_argument("--pin-cores", default=None, metavar="LIST",
                    help="comma-separated CPU ids to pin this process to")
    ap.add_argument("--capacity-out", default=None, metavar="FILE",
                    help="merge this run's capacity record into FILE")
    ap.add_argument("--label", default=None,
                    help="record key inside --capacity-out (default: "
                         "derived from mode flags)")
    return ap


def _spawn_nodes(ports, node_names, args, device):
    """One OS process per node from a temporary properties file; returns
    (processes, properties path, log file) or raises with the log tail."""
    props = tempfile.NamedTemporaryFile("w", suffix=".properties", delete=False)
    for i in range(3):
        props.write(f"active.AR{i}=127.0.0.1:{ports[i]}\n")
        props.write(f"reconfigurator.RC{i}=127.0.0.1:{ports[3 + i]}\n")
    props.write(f"ENGINE_ROWS={max(64, args.groups * 2)}\n")
    props.write("SLOT_WINDOW=16\n")
    if args.steps_per_dispatch > 1:
        props.write(f"ENGINE_STEPS_PER_DISPATCH={args.steps_per_dispatch}\n")
    # the child reconfigurators use the node's default rc_cfg (64 rows);
    # the in-process mode mirrors that
    props.write("APPLICATION=gigapaxos_tpu_torch.models.apps.NoopPaxosApp\n")
    props.close()
    env = dict(os.environ, GIGAPAXOS_CONFIG=props.name)
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"   # as this process (main)
    else:
        # build (or find) the kernel libraries once, here, so the six
        # nodes booting together load them
        from ..ops import gp_kernels

        gp_kernels.build()
    err_log = tempfile.NamedTemporaryFile("w+", suffix=".nodes.log", delete=False)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gigapaxos_tpu_torch.reconfigurable_node", n,
         f"DEVICE={device.type}"],
        env=env, stdout=err_log, stderr=err_log) for n in node_names]
    deadline = time.time() + 120
    while time.time() < deadline:
        if any(pr.poll() is not None for pr in procs):
            break
        up = 0
        for p in ports:
            try:
                socket.create_connection(("127.0.0.1", p), 0.2).close()
                up += 1
            except OSError:
                pass
        if up == 6:
            return procs, props.name, err_log
        time.sleep(0.5)
    for pr in procs:
        pr.kill()
        pr.wait()
    err_log.flush()
    err_log.seek(0)
    tail = err_log.read()[-2000:]
    err_log.close()
    os.unlink(err_log.name)
    os.unlink(props.name)
    raise RuntimeError(f"node processes failed to start: {tail}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--bank-ledger" in argv:
        # delegate to the bank-ledger transaction workload, passing every
        # OTHER argument through (its own argparse owns the flag set)
        from ..scenarios import bank_ledger

        return bank_ledger.main([a for a in argv if a != "--bank-ledger"])
    args = _parser().parse_args(argv)
    check_out(args.capacity_out)
    if args.pin_cores:
        cores = {int(c) for c in args.pin_cores.split(",") if c != ""}
        try:
            os.sched_setaffinity(0, cores)
        except (AttributeError, OSError) as e:
            emit(json.dumps({"warn": f"pin-cores failed: {e}"}))

    import torch

    from ..clients.reconfigurable_client import ReconfigurableAppClient
    from ..ops.engine import resolve_device
    from ..utils.config import Config

    device = resolve_device(args.device)
    threads = torch.get_num_threads()
    if device.type == "cpu":
        # single-threaded: N tick loops sharing a small host thrash an
        # intra-op thread pool
        torch.set_num_threads(1)

    Config.clear()
    if args.attach:
        # the cluster is already up: build only the client's address book
        Config.load_file(args.attach)
    else:
        ports = free_ports(6)
        for i in range(3):
            Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
            Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[3 + i]}")
    saved_env = os.environ.get("GP_EMULATE_UNREPLICATED")
    if args.unreplicated:
        Config.set("EMULATE_UNREPLICATED", "true")
        os.environ["GP_EMULATE_UNREPLICATED"] = "true"  # child processes
    if args.steps_per_dispatch > 1:
        Config.set("ENGINE_STEPS_PER_DISPATCH", str(args.steps_per_dispatch))
    node_names = [f"{r}{i}" for r in ("AR", "RC") for i in range(3)]
    nodes, procs, props_path, err_log, log_root = [], [], None, None, None
    client = None
    try:
        if args.attach:
            pass  # nothing to boot
        elif args.in_process:
            from ..models.apps import NoopPaxosApp
            from ..ops.engine import EngineConfig
            from ..reconfigurable_node import ReconfigurableNode

            ar_cfg = EngineConfig(n_groups=max(64, args.groups * 2), window=16,
                                  req_lanes=8, n_replicas=3)
            rc_cfg = EngineConfig(n_groups=64, window=16, req_lanes=8,
                                  n_replicas=3)  # the child default
            if args.durable:
                log_root = tempfile.mkdtemp(prefix="gp_probe_journal_")
            nodes = [
                ReconfigurableNode(
                    n, NoopPaxosApp, ar_cfg=ar_cfg, rc_cfg=rc_cfg,
                    log_dir=(f"{log_root}/{n}" if log_root else None),
                    device=device,
                )
                for n in node_names
            ]
            for n in nodes:
                n.start()
        else:
            procs, props_path, err_log = _spawn_nodes(ports, node_names, args, device)
        client = ReconfigurableAppClient.from_properties()
        return _ramp(args, client, device, log_root)
    finally:
        if client is not None:
            client.close()
        for n in nodes:
            n.stop()
        for pr in procs:
            pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        if procs:
            err_log.close()
            for f in (props_path, err_log.name):
                try:
                    os.unlink(f)
                except OSError:
                    pass
        if log_root:
            import shutil

            shutil.rmtree(log_root, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("GP_EMULATE_UNREPLICATED", None)
        else:
            os.environ["GP_EMULATE_UNREPLICATED"] = saved_env
        torch.set_num_threads(threads)
        Config.clear()


def _ramp(args, client, device, log_root) -> int:
    """Create the names, warm the path, run the ramps and print the
    summary (the reference's ``main`` after the boot)."""
    from ..reconfiguration.reconfigurator import row_for
    from ..utils.config import Config

    # echo-probe the actives first: the redirector's estimates are seeded
    # before any real traffic
    seeded = client.probe_actives(wait_s=3.0)
    emit(json.dumps({"echo_probe_seeded_actives": seeded}))
    names = [f"probe{i}" for i in range(args.groups)]
    for nm in names:
        ack = client.create_name(nm, actives=[0, 1, 2], timeout=60)
        if not (ack and ack.get("ok")):
            raise RuntimeError(f"create {nm} failed: {ack}")
    # warm the path, timed apart from the ramp
    t_warm = time.time()
    for nm in names:
        client.send_request_sync(nm, "warm", timeout=30)
    warmup_s = time.time() - t_warm
    emit(json.dumps({"warmup_s": round(warmup_s, 2)}))
    if log_root:
        journals = sum(len(fs) for _d, _s, fs in os.walk(log_root))
        emit(json.dumps({"durable_log_root": log_root, "files": journals}))

    n_injectors = args.clients
    # route each name's traffic at its coordinator (initial coord =
    # members[row % |members|], the create-time rule), with rows emulated
    # by the creator's deterministic probe (the reconfigurators' row_for:
    # crc32 of "name:epoch" % G, the next row on each retry, in creation
    # order), so the injector pays no resolution per request.  The JAX
    # package's probe hashes the bare name, which is not the row its
    # reconfigurators pick, so it sends most requests to a member that
    # forwards them to the coordinator.
    engine_rows = Config.get("ENGINE_ROWS") if args.attach else None
    G_rows = int(engine_rows) if engine_rows else max(64, args.groups * 2)
    occ = set()
    targets = {}
    for nm in names:
        acts = client.request_actives(nm) or [0, 1, 2]
        acts = sorted(int(a) for a in acts if int(a) in client.actives)
        row = row_for(nm, 0, 0, G_rows)
        while row in occ:
            row = (row + 1) % G_rows
        occ.add(row)
        target = acts[row % len(acts)] if acts else 0
        targets[nm] = tuple(client.actives[int(target)])
    # the request path allocates ~30 short-lived objects per request
    import gc

    gc.set_threshold(200000, 100, 100)

    def run_round(rate: float):
        """Fire at ``rate`` for window_s from N injector threads, each
        waking every few ms and firing its accrued quantum through the
        prepared-send path.  Returns (resp_rate, latencies_sorted)."""
        lock = threading.Lock()
        lats = []
        sent_counts = [0] * n_injectors
        QUANTUM_S = 0.004

        def inject(idx: int):
            per_s = rate / n_injectors
            t0 = time.time()
            t_end = t0 + args.window_s
            fired = 0
            i = 0
            while True:
                now = time.time()
                if now >= t_end:
                    break
                due = int((now - t0) * per_s) - fired
                if due <= 0:
                    time.sleep(QUANTUM_S)
                    continue
                t_batch = now

                def cb(rid, resp, error, _t=t_batch):
                    if not error:
                        lat = time.time() - _t
                        with lock:
                            lats.append(lat)

                by_target = {}
                for _ in range(due):
                    nm = names[(i * n_injectors + idx) % len(names)]
                    i += 1
                    by_target.setdefault(targets[nm], []).append((nm, f"p{idx}x{i}"))
                for addr, items in by_target.items():
                    client.send_prepared_batch(addr, items, cb, t0=t_batch)
                fired += due
                sent_counts[idx] += due

        threads = [threading.Thread(target=inject, args=(j,), daemon=True)
                   for j in range(n_injectors)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # grace: late responses within the latency budget still count
        time.sleep(min(1.0, args.latency_ms / 1000.0))
        sent = sum(sent_counts)
        with lock:
            out = sorted(lats)
        return (len(out) / sent if sent else 0.0), out

    def pct(sorted_lats, q):
        if not sorted_lats:
            return float("inf")
        k = min(len(sorted_lats) - 1, int(q * len(sorted_lats)))
        return sorted_lats[k]

    def run_ramp():
        capacity = 0.0
        rate = args.init_load
        curve = []
        for rnd in range(args.max_rounds):
            resp_rate, lats = run_round(rate)
            mean = sum(lats) / len(lats) if lats else float("inf")
            ok = resp_rate >= args.threshold and mean * 1000 <= args.latency_ms
            line = {
                "round": rnd, "load_rps": round(rate, 1),
                "response_rate": round(resp_rate, 3),
                "mean_latency_ms": round(mean * 1000, 1),
                "p50_ms": round(pct(lats, 0.50) * 1000, 1),
                "p99_ms": round(pct(lats, 0.99) * 1000, 1),
                "sustained": ok,
            }
            emit(json.dumps(line))
            curve.append(line)
            if not ok:
                break
            capacity = rate
            rate *= args.factor
        return capacity, curve

    repeats = []
    for rep in range(max(1, args.repeats)):
        if rep:
            time.sleep(1.0)  # settle between ramps
            emit(json.dumps({"ramp": rep}))
        capacity, curve = run_ramp()
        repeats.append({"capacity_rps": capacity, "rounds": curve})
    caps = sorted(r["capacity_rps"] for r in repeats)
    median = caps[len(caps) // 2]
    noise_pct = (caps[-1] - caps[0]) / median * 100.0 if median else 0.0
    mode = "unreplicated (app+wire only)" if args.unreplicated \
        else ("durable full system path" if args.durable else "full system path")
    phases, nodes = _phases(client)
    emit(json.dumps({"phases": phases}))
    platform = "cuda" if device.type == "cuda" else "cpu"
    summary = {
        "metric": "system_capacity_requests_per_s",
        "value": round(median, 1),
        "capacity_min_rps": round(caps[0], 1),
        "capacity_max_rps": round(caps[-1], 1),
        "noise_band_pct": round(noise_pct, 1),
        "repeats": len(caps),
        "unit": f"req/s ({args.groups} groups, 3 actives + 3 RCs, "
                f"loopback sockets, {mode}, {platform})",
        "protocol": f"ramp-only x{args.factor} until "
                    f"resp<{args.threshold} or "
                    f"latency>{args.latency_ms}ms, "
                    f"{max(1, args.repeats)} repeats",
        "warmup_s": round(warmup_s, 2),
        "platform": platform,
        "rounds": [r["rounds"] for r in repeats],
        # each node's kernel launches and card memory (its process's, so
        # in-process nodes all report this process's)
        "nodes": nodes,
        "provenance": _probe_provenance(device),
    }
    emit(json.dumps(summary))
    if args.capacity_out:
        _write_capacity(args, summary, repeats, phases)
    if args.in_process:
        # this process hosts the nodes: the DelayProfiler aggregates all
        # six tick loops
        from ..utils.profiler import DelayProfiler

        emit(f"stats: {DelayProfiler.get_stats()}")
    return 0


def _phases(client):
    """The server-side phase histograms from the stats admin op and this
    client's end-to-end latency histogram (where the budget went), and
    every node's ``engine.launches`` and ``engine.device_memory`` from the
    same op: (phases, {node: {...}})."""
    from ..clients import PaxosClientAsync
    from ..utils.config import Config

    def summary(h):
        return {
            "count": h["count"],
            "avg_ms": round(h["sum"] / h["count"] * 1e3, 3),
            "max_ms": round((h["max"] or 0.0) * 1e3, 3),
        }

    phases = {}
    try:
        stats_cli = PaxosClientAsync([tuple(a) for a in client.actives.values()])
        try:
            st = stats_cli.admin_sync(0, {"op": "stats"}, timeout=5)
        finally:
            stats_cli.close()
        hists = ((st or {}).get("engine") or {}).get("hists") or {}
        for k in ("engine_step_s", "phase_ingress_s", "phase_execute_s",
                  "phase_flush_s", "phase_publish_s", "pipeline_overlap_s"):
            h = hists.get(k)
            if h and h.get("count"):
                phases[k] = summary(h)
    except Exception as e:  # noqa: BLE001 — a stats hiccup must not void the run
        phases["stats_error"] = str(e)
    cl = client.metrics.snapshot()["hists"].get("client_request_latency_s")
    if cl and cl.get("count"):
        phases["client_request_latency_s"] = summary(cl)
    nodes = {}
    book = {**Config.node_addresses("active"), **Config.node_addresses("reconfigurator")}
    for name in sorted(book):
        cli = PaxosClientAsync([book[name]])
        try:
            st = cli.admin_sync(0, {"op": "stats"}, timeout=5)
            eng = (st or {}).get("engine") or {}
            nodes[name] = {"launches": eng.get("launches"),
                           "device_memory": eng.get("device_memory")}
        except Exception as e:  # noqa: BLE001
            nodes[name] = {"stats_error": str(e)}
        finally:
            cli.close()
    return phases, nodes


def _write_capacity(args, summary, repeats, phases) -> None:
    label = args.label or (
        f"steps_n{args.steps_per_dispatch}" if args.steps_per_dispatch > 1
        else "unreplicated" if args.unreplicated
        else ("durable" if args.durable else "in_process")
    )
    try:
        with open(args.capacity_out) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {"metric": "serving_capacity_trajectory", "host": {}}
    doc["host"] = {
        "cpus": os.cpu_count(),
        "pinned_cores": sorted(int(c) for c in (args.pin_cores or "").split(",")
                               if c != ""),
    }
    doc[label] = {
        "steps_per_dispatch": args.steps_per_dispatch,
        "capacity_rps": summary["value"],
        "min_rps": summary["capacity_min_rps"],
        "max_rps": summary["capacity_max_rps"],
        "noise_band_pct": summary["noise_band_pct"],
        "repeats": [r["capacity_rps"] for r in repeats],
        "curves": [r["rounds"] for r in repeats],
        "protocol": summary["protocol"],
        "phases": phases,
        "warmup_s": summary["warmup_s"],
        "platform": summary["platform"],
        "provenance": summary["provenance"],
    }
    with open(args.capacity_out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    emit(json.dumps({"capacity_out": args.capacity_out, "label": label}))


if __name__ == "__main__":
    sys.exit(main())
