"""Reusable chaos soak: the randomized reconfiguration-plane adversarial
run shared by the CI test (:mod:`tests.test_chaos`) and the varied-seed
sweep harness (``scripts/chaos_sweep.py``).

One call = one seeded soak (the reference's randomized
``TESTReconfiguration*`` suites compressed into a single adversarial run:
creates, migrations, pauses, touches, deletes, elastic membership churn,
app traffic — all under 20% control-plane loss), then a lossless settle
and a strict end-state audit:

  * every surviving record settles READY/PAUSED (no wedged WAIT_*);
  * RC record agreement across reconfigurators;
  * deleted names gone everywhere; paused names hold pause records;
  * READY actives host the name at one aligned row;
  * RSM invariant: live members agree on app state, AND on the engine's
    ``(exec_slot, n_execd, app_hash)`` triple — a member with n_execd+1
    at an equal frontier executed something twice (exactly-once breach,
    ref semantics ``PaxosManager.java:318-346``).

Violations raise :class:`SoakDivergence` carrying per-member engine and
dedup diagnostics so a failing seed is actionable, not just red.

Every soak takes ``device``: its engines' torch device, the CUDA card by
default (raising when there is none), ``"cpu"`` for the plain engine.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from ..models.apps import HashChainApp
from ..ops.engine import EngineConfig
from ..reconfiguration import RCState
from ..utils.config import Config
from .rc_cluster import ReconfigurableCluster


class SoakDivergence(AssertionError):
    """End-state invariant violation; .diag holds the evidence."""

    def __init__(self, msg: str, diag: Optional[Dict] = None):
        super().__init__(msg if diag is None else f"{msg}: {diag}")
        self.diag = diag or {}


def _soak_managers(c) -> List:
    """The member managers of either cluster flavor: a
    ReconfigurableCluster (``c.ars.managers``) or a bare ManagerCluster
    (``c.managers`` — the txn soak's harness)."""
    ars = getattr(c, "ars", None)
    return ars.managers if ars is not None else getattr(c, "managers", [])


def _flight_dump_all(c, reason: str,
                     extra: Optional[Dict] = None) -> List[str]:
    """Dump every member's flight recorder (obs/flight.py) for a
    divergence post-mortem; returns the on-disk paths."""
    paths = []
    for m in _soak_managers(c):
        try:
            p = m.flight.dump(reason=reason, extra=extra)
        except Exception:
            p = None
        if p:
            paths.append(p)
    return paths


def _divergence(c, msg: str, diag: Optional[Dict] = None,
                kind: Optional[str] = None) -> SoakDivergence:
    """Build a SoakDivergence WITH the black box attached: every
    member's flight-recorder rings land on disk and the paths ride the
    failure diagnostics — the strict-sweep contract that every residual
    breach is post-mortemable from the artifact alone.

    The dump carries a STRUCTURED reason (``divergence.<kind>``) plus
    the soak's attribution context (family, seed — ``c._soak_ctx``, set
    by every ``run_*soak``) and the offending name/group, so a dump
    found on disk weeks later still says which soak family and seed
    produced it and what invariant broke."""
    diag = dict(diag or {})
    if kind is None:
        kind = "-".join(
            "".join(ch for ch in w.lower() if ch.isalnum())
            for w in msg.split()[:4]
        ).strip("-") or "unknown"
    ctx = dict(getattr(c, "_soak_ctx", None) or {})
    extra = {**ctx, "kind": kind, "msg": msg}
    for key in ("name", "member", "shard", "txid"):
        if key in diag:
            extra[key] = diag[key]
    diag["flight_dumps"] = _flight_dump_all(
        c, reason=f"divergence.{kind}", extra=extra
    )
    return SoakDivergence(msg, diag)


def _name_diag(c: ReconfigurableCluster, nm: str, actives: List[int]) -> Dict:
    """Per-member engine + dedup evidence for one name, plus (when the
    per-request tracer is on — run_soak enables it) the MERGED cross-
    member timeline of the name's recent requests (one causal story per
    request, every member's hops interleaved — obs/tracemerge.py) and
    the RCs' epoch-op timeline, so a divergence message carries the
    requests' actual journeys."""
    out: Dict = {}
    for a in actives:
        m = c.ars.managers[a]
        row = m.names.get(nm)
        ent = {
            "row": row,
            "app_state": m.app.state.get(nm),
            "app_n_executed": getattr(m.app, "n_executed", {}).get(nm),
        }
        if row is not None:
            ent.update(
                exec_slot=int(m._np("exec_slot")[row]),
                n_execd=int(m._np("n_execd")[row]),
                app_hash=int(m._np("app_hash")[row]),
                version=int(m._np("version")[row]),
            )
        ent["dedup"] = sorted(m.dedup_for_name(nm))
        # provenance for handoff forensics: which epoch-final snapshots
        # this member holds for the name, and each snapshot's dedup size
        ar = c.active_replicas[a]
        ent["final_states"] = {
            f"{n}@{e}": len(s.get("dedup") or {})
            for (n, e), s in ar.final_states.items() if n == nm
        }
        ent["old_epochs"] = sorted(
            e for (n, e) in m.old_epochs if n == nm
        )
        out[a] = ent
    # ONE merged cross-member timeline instead of per-member fragments:
    # the same request's recv/propose/forward/decide/execute hops from
    # every member interleave causally with per-hop latencies
    from ..obs.tracemerge import merge_name_timeline

    merged = merge_name_timeline(
        {a: c.ars.managers[a].tracer for a in actives}, nm,
    )
    if merged:
        out["merged_trace"] = merged
    rc_traces = {
        rc.my_id: rc.tracer.dump(f"epoch:{nm}")
        for rc in c.reconfigurators
        if rc.tracer.enabled and f"epoch:{nm}" in rc.tracer
    }
    if rc_traces:
        out["rc_epoch_trace"] = rc_traces
    return out


def probe_exactly_once(c: ReconfigurableCluster, names) -> None:
    """Transient safety probe, safe to run after EVERY step: two members
    fully caught up (app cursor == device frontier, no pending heal) on
    the same (name, epoch) at the SAME frontier executed the same decided
    sequence — their app states must match.  A mismatch is the
    duplicate-execution signature (a dedup entry lost in a handoff) the
    moment it is born, before a later checkpoint-jump adoption can mask
    it."""
    for nm in names:
        groups: Dict = {}
        for a, m in enumerate(c.ars.managers):
            row = m.names.get(nm)
            if row is None or row in m.pending_rows \
                    or row in m._needs_state:
                continue
            exec_now = int(m._np("exec_slot")[row])
            if int(m.app_exec_slot[row]) != exec_now or exec_now == 0:
                continue  # mid-execution / just born: prefix not comparable
            key = (int(m._np("version")[row]), exec_now)
            groups.setdefault(key, []).append((a, m.app.state.get(nm)))
        for (ver, fr), members in groups.items():
            states = {s for _, s in members}
            if len(states) > 1:
                raise _divergence(
                    c,
                    "exactly-once breach (transient): caught-up members at "
                    "one (epoch, frontier) disagree on app state",
                    {"name": nm, "epoch": ver, "frontier": fr,
                     "members": _name_diag(c, nm, [a for a, _ in members])},
                )




def settle_and_audit(c: ReconfigurableCluster, names, step,
                     settle_budget_s: float) -> int:
    """Lossless settle + the strict end-state audit shared by every soak
    flavor (single-node and worker-sharded): records settle READY/PAUSED,
    RC agreement, deletes gone, READY rows aligned, RSM convergence, and
    the exactly-once (exec_slot, n_execd, app_hash) triple.  Raises
    :class:`SoakDivergence`; returns settle iterations."""
    # lossless settle, deadline-bound (cold kernel builds and rare
    # time-gated retransmits burn wall time, not steps)
    c.msg_filter = None
    deadline = time.time() + settle_budget_s
    settled, settle_iters = False, 0
    while not settled:
        if time.time() > deadline:
            break
        for _ in range(8):
            step()
        c.drain_client()
        settle_iters += 1
        recs = {
            nm: c.reconfigurators[0].rc_app.get_record(nm)
            for nm in names
        }
        settled = all(
            r is None or r.deleted
            or r.state in (RCState.READY, RCState.PAUSED)
            for r in recs.values()
        )
    if not settled:
        # the WAIT_* liveness-wedge family lands HERE, so this message
        # must carry the forensics: for each unsettled name, the full
        # per-member diag including request timelines and the RCs'
        # epoch-op timeline (which round is stalled, who never acked)
        stuck = {
            nm: r for nm, r in recs.items()
            if r is not None and not r.deleted
            and r.state not in (RCState.READY, RCState.PAUSED)
        }
        raise _divergence(
            c,
            "records did not settle",
            {
                "records": {
                    nm: (r.to_json() if r else None)
                    for nm, r in recs.items()
                },
                "unsettled": {
                    nm: _name_diag(
                        c, nm,
                        sorted(set(r.actives) | set(r.new_actives or []))
                    )
                    for nm, r in stuck.items()
                },
            },
        )

    # record agreement across RCs — poll-bounded like the READY-align
    # and RSM checks below: settle gates on RC0's records only, and a
    # sibling RC executing its paxos log in dispatch-sized bursts
    # (ENGINE_STEPS_PER_DISPATCH > 1) can be one exchange behind at the
    # instant settle flips.  A real fork never converges and still
    # lands here; a replica mid-catch-up is not end state.
    for nm in names:
        agree_deadline = time.time() + 30
        while True:
            views = [rc.rc_app.get_record(nm) for rc in c.reconfigurators]
            datas = [None if v is None else v.to_json() for v in views]
            if all(d == datas[0] for d in datas):
                break
            if time.time() > agree_deadline:
                raise _divergence(c, "RC record disagreement",
                                  {"name": nm, "views": datas})
            step()

    for nm, rec in recs.items():
        if rec is None or rec.deleted:
            # poll: a straggler that missed the drop (it could not
            # ack while its stop was un-executed) heals through the
            # audit-cadence redrop — give that machinery a window.
            # Deadline-bound like the READY align loop below: the
            # post-budget redrops fire at most once per audit period
            # (wall-timer-gated), so a step-count cap alone can burn
            # through on a fast box before the timers the heal needs
            # have fired
            # floor at 30s: the redrop only fires once per audit period,
            # and a slow process (cold kernel builds, multi-step
            # dispatches) can burn a small multiple of the period on the
            # steps BETWEEN firings; healthy runs exit this poll early
            drop_deadline = time.time() + max(30.0, 6 * max(
                rc.ready_audit_period_s for rc in c.reconfigurators
            ))
            while time.time() < drop_deadline:
                if all(m.names.get(nm) is None for m in c.ars.managers):
                    break
                step()
            for m in c.ars.managers:
                if m.names.get(nm) is not None:
                    raise _divergence(
                        c, "name lingers post-delete",
                        {"name": nm, "member": m.my_id},
                    )
            continue
        if rec.state is RCState.PAUSED:
            held = [m for m in c.ars.managers
                    if (nm, rec.epoch) in m.paused]
            if not held:
                raise _divergence(
                    c, "paused with no pause records anywhere",
                    {"name": nm},
                )
            continue
        # READY: actives host the name at ONE aligned row and agree.
        # Re-read each poll: the deactivation sweep can pause a name
        # mid-poll; commit-round re-drives heal missed starts.
        rows: set = set()
        # deadline-bound like the settle loop: the audit-cadence
        # heals (READY audit re-running the commit round) are
        # wall-timer-gated, so an iteration cap alone can expire
        # before the timers their heals need have fired
        align_deadline = time.time() + 90
        while True:
            rec = c.reconfigurators[0].rc_app.get_record(nm)
            if rec is None or rec.deleted or \
                    rec.state is not RCState.READY:
                break
            rows = {c.ars.managers[a].names.get(nm) for a in rec.actives}
            if rows == {rec.row} or time.time() > align_deadline:
                break
            step()
        if rec is None or rec.deleted or rec.state is not RCState.READY:
            continue
        if rows != {rec.row}:
            raise _divergence(
                c,
                "READY actives not aligned at record row",
                {"name": nm, "want_row": rec.row, "rows": sorted(
                    (a, c.ars.managers[a].names.get(nm))
                    for a in rec.actives),
                 # which start/commit round stranded the outlier —
                 # the 20260803 re-probe hit this shape blind
                 "members": _name_diag(c, nm, list(rec.actives))},
            )
        # RSM convergence: poll app state AND the engine triple (a
        # laggard may need many blocked-pull rounds); then audit
        # exactly-once — equal frontiers must mean equal n_execd and
        # equal app_hash.
        converged = False
        for _ in range(800):
            states = {
                c.ars.managers[a].app.state.get(nm) for a in rec.actives
            }
            fr = {
                int(c.ars.managers[a]._np("exec_slot")[
                    c.ars.managers[a].names[nm]])
                for a in rec.actives
                if c.ars.managers[a].names.get(nm) is not None
            }
            if len(states) == 1 and len(fr) == 1:
                converged = True
                break
            step()
        if not converged:
            raise _divergence(
                c,
                "RSM divergence (app state or frontier never converged)",
                {"name": nm, "members": _name_diag(c, nm, rec.actives)},
            )
        # equal frontiers ⇒ n_execd and app_hash must match exactly
        diag = _name_diag(c, nm, rec.actives)
        trips = {
            (e["exec_slot"], e["n_execd"], e["app_hash"])
            for e in diag.values() if "exec_slot" in e
        }
        if len(trips) != 1:
            raise _divergence(
                c,
                "exactly-once breach: unequal (exec_slot, n_execd, "
                "app_hash) at converged app state",
                {"name": nm, "members": diag},
            )
    return settle_iters


def run_soak(
    seed: int,
    *,
    rounds: int = 60,
    n_names: int = 6,
    ar_cfg: Optional[EngineConfig] = None,
    rc_cfg: Optional[EngineConfig] = None,
    settle_budget_s: float = 420.0,
    loss: float = 0.2,
    dup_rate: float = 0.0,
    device=None,
) -> Dict:
    """Run one seeded soak; raises :class:`SoakDivergence` on violation.

    ``dup_rate``: probability that a traffic round re-proposes a PAST
    request id (same id+value, random entry replica) instead of a fresh
    request — the client-retransmit stressor that hunts lost dedup
    entries across blank-join/resume/state-pull handoffs (a member
    missing the entry re-executes the duplicate and diverges the RSM;
    ref exactly-once semantics ``PaxosManager.java:318-346``).  Default
    0 keeps the historical pinned-seed schedules byte-identical.

    Returns a small stats dict (rounds run, settle iterations) on success.
    """
    from ..reconfiguration import active_replica as ar_mod
    from ..reconfiguration import reconfigurator as rc_mod

    task_classes = (
        rc_mod.StartEpochTask, rc_mod.StopEpochTask, rc_mod.DropEpochTask,
        rc_mod.EpochCommitTask, rc_mod.LateStartTask, rc_mod.PauseEpochTask,
        ar_mod.WaitEpochFinalState,
    )
    saved_periods = [cls.restart_period_s for cls in task_classes]
    c = None
    try:
        # fast retransmits so recovery happens within the soak budget
        # (inside the try: a construction failure below must still restore
        # these process-wide mutations in the finally)
        for cls in task_classes:
            cls.restart_period_s = 0.05
        # exactly-once is only guaranteed within the response-cache TTL; a
        # loaded box can stretch one soak across minutes, and TTL-expired
        # dedup entries re-executing re-proposed duplicates is a documented
        # semantics boundary, not what this probes.  Pin the window wide.
        Config.set("RESPONSE_CACHE_TTL_S", "3600")

        rng = random.Random(seed)
        ar_cfg = ar_cfg or EngineConfig(
            n_groups=24, window=8, req_lanes=4, n_replicas=4
        )
        rc_cfg = rc_cfg or EngineConfig(
            n_groups=8, window=8, req_lanes=4, n_replicas=3
        )
        n_ar = ar_cfg.n_replicas
        c = ReconfigurableCluster(ar_cfg, rc_cfg, HashChainApp,
                                  device=device)
        c._soak_ctx = {"family": "core", "seed": seed}
        # soaks always trace: the whole point of a soak failure is the
        # forensics, and the stepped cluster has no hot-path budget to
        # protect — a SoakDivergence then carries each member's recent
        # request timelines for the offending name (_name_diag)
        for m in c.ars.managers:
            m.tracer.enabled = True
        for rc_l in c.reconfigurators:
            rc_l.tracer.enabled = True
        from ..reconfiguration.placement import MeasureOnlyPlacementPolicy

        for rc in c.reconfigurators:
            rc.REDRIVE_EVERY = 4
            # compress the slow READY-audit cadence to the soak's
            # timescale (like the 0.05s task retransmits): audit-healed
            # shapes must fit inside the settle budget
            rc.ready_audit_period_s = 2.0
            # pin the seeds' message universe: echo probes would consume
            # draws from the SHARED fault rng (re-rolling every recorded
            # shape), and placement-driven migrations would add moves the
            # recorded schedules never contained — the placement plane
            # has its own suite (tests/test_placement.py)
            rc.echo_probe_period_s = 0.0
            rc.placement.policy = MeasureOnlyPlacementPolicy(rc.placement)
        names = [f"n{i}" for i in range(n_names)]

        def step():
            c.step()
            probe_exactly_once(c, names)

        deleted: set = set()
        c.msg_filter = lambda dst, kind, body: rng.random() > loss

        for nm in names:
            c.client_request(
                "create_service",
                {"name": nm, "actives": list(range(min(3, n_ar)))},
            )
        for _ in range(40):
            step()

        history = []  # (name, request_id, value) of every injected request
        rid_base = (1 << 55) + seed % (1 << 20)
        for round_no in range(rounds):
            op = rng.random()
            nm = rng.choice(names)
            if op < 0.35:  # traffic (fresh, or a duplicate retransmit)
                entry = rng.randrange(n_ar)
                if dup_rate and history and rng.random() < dup_rate:
                    dn, rid, val = history[rng.randrange(len(history))]
                    c.ars.managers[entry].propose(dn, val, request_id=rid)
                else:
                    rid = rid_base + round_no
                    val = f"r{round_no}"
                    c.ars.managers[entry].propose(nm, val, request_id=rid)
                    history.append((nm, rid, val))
            elif op < 0.55:  # migrate to a random 3-set
                target = rng.sample(range(n_ar), 3)
                c.client_request(
                    "reconfigure", {"name": nm, "new_actives": target}
                )
            elif op < 0.7:  # pause suggestion
                rec = c.reconfigurators[0].rc_app.get_record(nm)
                if rec is not None and not rec.deleted:
                    c.active_replicas[0].send(
                        ("RC", rng.randrange(rc_cfg.n_replicas)),
                        "suggest_pause",
                        {"name": nm, "epoch": rec.epoch, "from": 0},
                    )
            elif op < 0.85:  # touch (reactivates if paused)
                c.client_request("request_actives", {"name": nm})
            elif op < 0.92:  # elastic membership churn: remove, re-add
                removed = getattr(c, "_chaos_removed", None)
                if removed is None:
                    c.client_request(
                        "remove_active", {"id": rng.randrange(n_ar)}
                    )
                    c._chaos_removed = True
                else:
                    for nid in range(n_ar):
                        c.client_request("add_active", {"id": nid})
                    c._chaos_removed = None
            elif nm not in deleted and len(deleted) < 2:  # delete (max 2)
                c.client_request("delete_service", {"name": nm})
                deleted.add(nm)
            step()
            c.drain_client()

        settle_iters = settle_and_audit(
            c, names, step, settle_budget_s
        )
        return {"seed": seed, "settle_iters": settle_iters}
    finally:
        if c is not None:
            c.close()
        Config.clear()
        for cls, p in zip(task_classes, saved_periods):
            cls.restart_period_s = p


def run_sharded_soak(
    seed: int,
    *,
    workers: int = 2,
    rounds: int = 50,
    n_names: int = 6,
    settle_budget_s: float = 420.0,
    loss: float = 0.2,
    dup_rate: float = 0.25,
    device=None,
) -> Dict:
    """Worker-sharded soak (``SERVING_WORKERS`` analog of the stepped
    harness): the name space splits across ``workers`` independent shard
    clusters exactly as the serving plane splits a node's groups across
    worker processes (``gigapaxos_tpu_torch/serving``: each shard is its own
    consensus universe; the router's ONLY correctness obligations are
    deterministic name→shard assignment and per-shard delivery).

    What crossing the boundary must preserve — and what this audits:

    * routing determinism: every operation (fresh traffic, duplicate
      retransmit through a DIFFERENT entry, migration, pause, delete)
      lands in the same shard its name always had (asserted per route);
    * exactly-once across retransmits: duplicates re-propose into the
      owning shard and dedup there — the end audit's
      ``(exec_slot, n_execd, app_hash)`` triple + app-state agreement
      run per shard;
    * epoch handoffs (migrations/pauses) settle within their shard —
      the full settle_and_audit gauntlet runs on every shard cluster.

    Compressed timers, step-driven, no wall-clock gates (soak
    conventions).  Raises :class:`SoakDivergence` on any violation.
    """
    from ..serving import shard_of_name

    from ..reconfiguration import active_replica as ar_mod
    from ..reconfiguration import reconfigurator as rc_mod

    task_classes = (
        rc_mod.StartEpochTask, rc_mod.StopEpochTask, rc_mod.DropEpochTask,
        rc_mod.EpochCommitTask, rc_mod.LateStartTask, rc_mod.PauseEpochTask,
        ar_mod.WaitEpochFinalState,
    )
    saved_periods = [cls.restart_period_s for cls in task_classes]
    shards: List[ReconfigurableCluster] = []
    try:
        for cls in task_classes:
            cls.restart_period_s = 0.05
        Config.set("RESPONSE_CACHE_TTL_S", "3600")
        rng = random.Random(seed)
        ar_cfg = EngineConfig(n_groups=16, window=8, req_lanes=4,
                              n_replicas=3)
        rc_cfg = EngineConfig(n_groups=8, window=8, req_lanes=4,
                              n_replicas=3)
        n_ar = ar_cfg.n_replicas
        from ..reconfiguration.placement import MeasureOnlyPlacementPolicy

        for _w in range(workers):
            c = ReconfigurableCluster(ar_cfg, rc_cfg, HashChainApp,
                                      device=device)
            c._soak_ctx = {"family": "sharded", "seed": seed,
                           "shard": _w}
            for m in c.ars.managers:
                m.tracer.enabled = True
            for rc in c.reconfigurators:
                rc.REDRIVE_EVERY = 4
                rc.ready_audit_period_s = 2.0
                rc.echo_probe_period_s = 0.0
                rc.placement.policy = MeasureOnlyPlacementPolicy(rc.placement)
            shards.append(c)

        names = [f"wn{i}" for i in range(n_names)]
        owner = {nm: shard_of_name(nm, workers) for nm in names}

        def route(nm: str) -> ReconfigurableCluster:
            w = shard_of_name(nm, workers)
            if w != owner[nm]:
                raise SoakDivergence(
                    "shard routing drifted for a name",
                    {"name": nm, "was": owner[nm], "now": w},
                )
            return shards[w]

        def step_all():
            for c in shards:
                c.step()
            for c in shards:
                probe_exactly_once(
                    c, [nm for nm in names if shards[owner[nm]] is c]
                )

        for c in shards:
            c.msg_filter = lambda dst, kind, body: rng.random() > loss
        for nm in names:
            route(nm).client_request(
                "create_service",
                {"name": nm, "actives": list(range(min(3, n_ar)))},
            )
        for _ in range(40):
            step_all()

        history = []  # (name, request_id, value) for duplicate replays
        rid_base = (1 << 55) + seed % (1 << 20)
        deleted: set = set()
        for round_no in range(rounds):
            op = rng.random()
            nm = rng.choice(names)
            c = route(nm)
            if op < 0.45:  # traffic — fresh, or a duplicate retransmit
                entry = rng.randrange(n_ar)
                if history and rng.random() < dup_rate:
                    # the retransmit goes through a DIFFERENT entry
                    # replica but the SAME shard (route() asserts it)
                    dn, rid, val = history[rng.randrange(len(history))]
                    route(dn).ars.managers[entry].propose(
                        dn, val, request_id=rid
                    )
                else:
                    rid = rid_base + round_no
                    val = f"r{round_no}"
                    c.ars.managers[entry].propose(nm, val, request_id=rid)
                    history.append((nm, rid, val))
            elif op < 0.65:  # migrate within the shard's actives
                target = rng.sample(range(n_ar), 3)
                c.client_request(
                    "reconfigure", {"name": nm, "new_actives": target}
                )
            elif op < 0.8:  # pause suggestion
                rec = c.reconfigurators[0].rc_app.get_record(nm)
                if rec is not None and not rec.deleted:
                    c.active_replicas[0].send(
                        ("RC", rng.randrange(rc_cfg.n_replicas)),
                        "suggest_pause",
                        {"name": nm, "epoch": rec.epoch, "from": 0},
                    )
            elif op < 0.92:  # touch
                c.client_request("request_actives", {"name": nm})
            elif nm not in deleted and len(deleted) < 2:
                c.client_request("delete_service", {"name": nm})
                deleted.add(nm)
            step_all()
            for c2 in shards:
                c2.drain_client()

        # settle + strict audit PER SHARD (each shard is a full
        # consensus universe; the boundary property is that none of
        # them ever saw another shard's names)
        settle_iters = 0
        for w, c in enumerate(shards):
            mine = [nm for nm in names if owner[nm] == w]
            foreign = [
                nm for nm in names
                if owner[nm] != w and any(
                    nm in m.names for m in c.ars.managers
                )
            ]
            if foreign:
                raise SoakDivergence(
                    "foreign names leaked across the worker-shard "
                    "boundary", {"shard": w, "names": foreign},
                )
            def step_one(c=c):
                c.step()
            settle_iters += settle_and_audit(
                c, mine, step_one, settle_budget_s
            )
        return {"seed": seed, "workers": workers,
                "settle_iters": settle_iters}
    finally:
        for c in shards:
            c.close()
        Config.clear()
        for cls, p in zip(task_classes, saved_periods):
            cls.restart_period_s = p


def run_txn_soak(
    seed: int,
    *,
    rounds: int = 400,
    n_accounts: int = 8,
    n_replicas: int = 3,
    max_inflight: int = 4,
    spawn_rate: float = 0.25,
    kill_rate: float = 0.02,
    loss: float = 0.1,
    partition_rate: float = 0.01,
    restart_rate: float = 0.006,
    pause_rate: float = 0.01,
    initial_balance: int = 100,
    amount_max: int = 9,
    zipf_alpha: float = 1.1,
    settle_budget_s: float = 420.0,
    device=None,
) -> Dict:
    """The transaction chaos family: sorted 2PC-over-Paxos under fire.

    A bank of ``n_accounts`` ledger groups (StatefulAdderApp under
    TxnApp, every balance starting at ``initial_balance``) takes Zipfian
    two-account transfers (hot-head contention) from up to
    ``max_inflight`` concurrent :class:`~..txn.TxnDriver`\\ s while the
    cluster suffers message loss, timed single-member partitions,
    crash-restarts from the journal (``ManagerCluster.restart``), and
    per-member hibernate/restore of account groups — and drivers are
    KILLED mid-protocol at ``kill_rate`` per round, leaving in-doubt
    transactions for the :class:`~..txn.TxnResolver` (presumed abort) to
    resolve.

    End-state audit (raises :class:`SoakDivergence`):

    * every driver finishes and the resolver drains (no live coordinator
      records, no re-drives in flight) within the settle budget;
    * no participant lock or staged op survives on ANY replica;
    * every killed driver's transaction has ONE global outcome at the
      coordinator, and the committed ones are folded into the ledger;
    * replicas agree on every balance (RSM convergence);
    * conservation: the balances sum to exactly
      ``n_accounts * initial_balance`` (transfers move money, never mint
      or burn it) — atomicity across groups in one number;
    * per-name linearizability: each balance equals ``initial_balance``
      plus the sum of COMMITTED deltas for that name — an aborted
      transaction that leaked a staged op, or a commit applied twice,
      lands here.

    All protocol pacing runs on the LOGICAL clock (``steps * 0.05``, the
    chaos-compressed convention) — wall time only bounds the settle loop.
    """
    import numpy as np

    from ..models.apps import StatefulAdderApp
    from ..txn import (ABORTED, COMMITTED, TXN_COORD, Transaction, TxnApp,
                       TxnDriver, TxnResolver, txc_op)
    from .cluster import DELIVER, DROP, ManagerCluster

    c = None
    tmp = None
    try:
        # exactly-once within the TTL only; pin it wide (soak convention)
        Config.set("RESPONSE_CACHE_TTL_S", "3600")
        # the soak's concurrency never exceeds the deployed driver cap
        from ..paxos_config import PC
        max_inflight = min(max_inflight, Config.get_int(PC.TXN_MAX_INFLIGHT))
        rng = random.Random(seed)
        cfg = EngineConfig(n_groups=16, window=8, req_lanes=4,
                           n_replicas=n_replicas)
        tmp = tempfile.mkdtemp(prefix=f"txnsoak{seed}_")
        c = ManagerCluster(
            cfg, lambda: TxnApp(StatefulAdderApp()),
            log_dirs=[os.path.join(tmp, f"n{r}")
                      for r in range(n_replicas)],
            checkpoint_every=8, device=device,
        )
        c._soak_ctx = {"family": "txn", "seed": seed}
        for m in c.managers:
            m.tracer.enabled = True
        accounts = [f"acct{i}" for i in range(n_accounts)]
        c.create(TXN_COORD)
        for nm in accounts:
            c.create(nm, initial_state=str(initial_balance))

        STEP_DT = 0.05
        steps = [0]

        def clock() -> float:
            return steps[0] * STEP_DT

        part = {"until": -1, "cut": frozenset()}
        chaos = [True]

        def delivery() -> np.ndarray:
            R = n_replicas
            d = np.full((R, R), DELIVER)
            if not chaos[0]:
                return d
            cut = part["cut"] if steps[0] < part["until"] else frozenset()
            for i in range(R):
                for j in range(R):
                    if i == j:
                        continue
                    if (i in cut) != (j in cut) or rng.random() < loss:
                        d[i, j] = DROP
            return d

        def step() -> None:
            c.step_all(delivery())
            steps[0] += 1

        def submit(name, value, rid, cb) -> None:
            c.managers[rng.randrange(n_replicas)].propose(
                name, value, request_id=rid, callback=cb
            )

        metrics = c.managers[0].metrics
        resolver = TxnResolver(
            submit, TXN_COORD, clock,
            resolve_period_s=1.0, presume_abort_s=8.0,
            retransmit_s=0.4, metrics=metrics, rng=rng,
        )

        zipf_w = [1.0 / (i + 1) ** zipf_alpha for i in range(n_accounts)]

        def spawn() -> TxnDriver:
            a = rng.choices(range(n_accounts), weights=zipf_w)[0]
            b = a
            while b == a:
                b = rng.choices(range(n_accounts), weights=zipf_w)[0]
            amt = rng.randint(1, amount_max)
            txn = Transaction(
                [(accounts[a], str(-amt)), (accounts[b], str(amt))],
                txid=f"tx{rng.getrandbits(48):012x}",
            )
            return TxnDriver(
                txn, submit, TXN_COORD, clock,
                prepare_timeout_s=4.0, retransmit_s=0.4,
                metrics=metrics, rng=rng,
            )

        active: List[TxnDriver] = []
        outcomes: Dict[str, Optional[str]] = {}
        ledger: Dict[str, List] = {}   # txid -> ops, COMMITTED only
        killed: Dict[str, List] = {}
        paused: Dict[str, Tuple] = {}  # name -> (member, resume_step)

        def reap() -> None:
            for d in list(active):
                r = d.poll()
                if r is not None:
                    outcomes[r["txid"]] = r["outcome"]
                    if r["outcome"] == COMMITTED:
                        ledger[r["txid"]] = list(d.txn.ops)
                    active.remove(d)

        for _ in range(20):  # fault-free warmup: groups elect + settle
            step()

        for _ in range(rounds):
            if len(active) < max_inflight and rng.random() < spawn_rate:
                active.append(spawn())
            reap()
            if active and rng.random() < kill_rate:
                d = active.pop(rng.randrange(len(active)))
                killed[d.txn.txid] = list(d.txn.ops)
            resolver.poll()
            roll = rng.random()
            if roll < restart_rate:
                rid = rng.randrange(n_replicas)
                # skip members holding a hibernated account: the wake
                # path is exercised separately from crash replay
                if all(mb != rid for mb, _ in paused.values()):
                    c.restart(rid)
                    c.managers[rid].tracer.enabled = True
            elif roll < restart_rate + partition_rate:
                part["cut"] = frozenset({rng.randrange(n_replicas)})
                part["until"] = steps[0] + rng.randrange(10, 40)
            elif roll < restart_rate + partition_rate + pause_rate:
                nm = rng.choice(accounts)
                mb = rng.randrange(n_replicas)
                # hibernate on ONE member only — the group keeps quorum
                # and the woken member heals as a straggler
                if nm not in paused and c.managers[mb].hibernate(nm):
                    paused[nm] = (mb, steps[0] + rng.randrange(20, 60))
            for nm, (mb, due) in list(paused.items()):
                if steps[0] >= due and c.managers[mb].restore(nm):
                    del paused[nm]
            step()

        # ---- lossless settle until drivers + resolver drain -----------
        chaos[0] = False
        part["until"] = -1
        for nm, (mb, _) in list(paused.items()):
            if c.managers[mb].restore(nm):
                del paused[nm]
        if paused:
            raise _divergence(
                c, "hibernated account failed to wake",
                {"paused": {n: p[0] for n, p in paused.items()}},
                kind="txn-wake-failed",
            )
        deadline = time.time() + settle_budget_s
        settled = False
        drained_scan = None
        while time.time() < deadline:
            reap()
            resolver.poll()
            if not active and drained_scan is None:
                drained_scan = resolver.scans
            # idle must hold on a scan that STARTED after the last
            # driver ended, hence the two-scan margin
            if (not active and drained_scan is not None
                    and resolver.scans >= drained_scan + 2
                    and resolver.idle()):
                settled = True
                break
            step()
        if not settled:
            raise _divergence(
                c, "transactions did not settle",
                {"active": [d.txn.txid for d in active],
                 "live_records": resolver.live_records,
                 "redriving": sorted(resolver._jobs)},
                kind="txn-unsettled",
            )

        # ---- killed drivers: ONE global outcome per transaction -------
        def coordinator_outcome(txid: str) -> Optional[str]:
            box: List = []
            rid = rng.randrange(1 << 48, 1 << 62)
            val = txc_op("outcome", txid)
            sent = -(10 ** 9)
            for _ in range(1200):
                if box:
                    try:
                        return json.loads(box[-1]).get("outcome")
                    except (ValueError, TypeError):
                        return None
                if steps[0] - sent >= 8:
                    sent = steps[0]
                    submit(TXN_COORD, val, rid,
                           lambda r, resp: box.append(resp))
                step()
            raise _divergence(c, "coordinator outcome query wedged",
                              {"txid": txid}, kind="txn-outcome-wedge")

        for txid, ops in killed.items():
            if txid in outcomes:
                continue
            out = coordinator_outcome(txid)
            # no record and no ended entry = the begin never decided:
            # nothing was ever locked or staged, equivalent to abort
            outcomes[txid] = out or ABORTED
            if out == COMMITTED:
                ledger[txid] = ops

        # ---- audits ---------------------------------------------------
        agree_deadline = time.time() + 120
        while True:
            views = {
                nm: [m.app.totals.get(nm) for m in c.managers]
                for nm in accounts
            }
            if all(len(set(v)) == 1 for v in views.values()):
                break
            if time.time() > agree_deadline:
                raise _divergence(
                    c, "txn RSM divergence: replicas disagree on balances",
                    {"views": {nm: v for nm, v in views.items()
                               if len(set(v)) > 1}},
                    kind="txn-balance-divergence",
                )
            step()

        for m in c.managers:
            if m.app.locks or m.app.staged:
                raise _divergence(
                    c, "transaction locks/staged survive settle",
                    {"member": m.my_id, "locks": dict(m.app.locks),
                     "staged": sorted(m.app.staged)},
                    kind="txn-lock-leak",
                )

        balances = {nm: views[nm][0] for nm in accounts}
        expected = {nm: initial_balance for nm in accounts}
        for ops in ledger.values():
            for nm, dv in ops:
                expected[nm] += int(dv)
        total = sum(balances.values())
        if total != initial_balance * n_accounts:
            raise _divergence(
                c, "conservation breach: money created or destroyed",
                {"total": total, "want": initial_balance * n_accounts,
                 "balances": balances},
                kind="txn-conservation",
            )
        bad = {
            nm: {"have": balances[nm], "want": expected[nm]}
            for nm in accounts if balances[nm] != expected[nm]
        }
        if bad:
            raise _divergence(
                c,
                "ledger mismatch: balances disagree with committed history",
                {"names": bad}, kind="txn-ledger-mismatch",
            )

        n_comm = sum(1 for o in outcomes.values() if o == COMMITTED)
        return {
            "seed": seed, "steps": steps[0],
            "txns": len(outcomes), "committed": n_comm,
            "aborted": len(outcomes) - n_comm,
            "killed": len(killed),
            "in_doubt_resolved": resolver.resolved_count,
        }
    finally:
        if c is not None:
            c.close()
        Config.clear()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def run_density_soak(
    seed: int,
    *,
    rounds: int = 120,
    n_names: int = 96,
    rows: int = 48,
    device=None,
) -> Dict:
    """Seeded residency-plane soak: randomized pause/resume churn over a
    name population LARGER than the engine (``n_names > rows``), through
    both the per-name and the batched paths, with the packed spill store
    squeezed hard (tiny RAM capacity + tiny segments, so the LRU spill,
    segment rotation, and dead-ratio compaction all fire mid-soak).

    The invariant is the residency plane's whole contract: a name's app
    state survives ANY interleaving of hibernate/restore (batched or
    per-name, quiescent or with requests still in flight) with no loss
    and no double-execution — at the end every name's adder total must
    equal exactly the sum of everything proposed to it.  Bookkeeping
    must also stay conserved every round (awake + paused == n_names,
    RAM + disk == paused) and eviction candidates must never name a row
    with queued work.  Violations raise :class:`SoakDivergence`.
    """
    import numpy as np

    from ..manager import PaxosManager
    from ..models import StatefulAdderApp

    def ticks(m, n=3):
        for _ in range(n):
            vec, _st = m.publish_snapshot()
            m.tick_host(np.stack([vec]), np.array([True]))

    tmp = tempfile.mkdtemp(prefix="gp_density_soak_")
    m = None
    try:
        # squeeze the store: RAM tier of 8 records, 4 KiB segments, an
        # eager compactor — every mechanism fires inside a 2-minute soak
        Config.set("PACKED_SPILL", "true")
        Config.set("PAUSE_BATCH_SIZE", "2")  # store capacity = 4x this
        Config.set("SPILL_SEGMENT_BYTES", "4096")
        Config.set("SPILL_COMPACT_RATIO", "0.3")
        Config.set("PAUSE_EVICTION_HYSTERESIS_S", "0.0")

        rng = random.Random(seed)
        cfg = EngineConfig(n_groups=rows, window=8, req_lanes=4,
                           n_replicas=1)
        m = PaxosManager(0, StatefulAdderApp(), cfg, log_dir=tmp,
                         checkpoint_every=10 ** 9, sync_journal=False,
                         device=device)
        names = [f"d{i:03d}" for i in range(n_names)]
        # boot: everything created, then the overflow put to sleep so the
        # population exceeds the engine from round 0
        for lo in range(0, n_names, rows):
            chunk = names[lo:lo + rows]
            m.create_paxos_batch(chunk, [0])
            if lo + len(chunk) < n_names:
                m.hibernate_batch(chunk)
        vals: Dict[str, List[int]] = {nm: [] for nm in names}
        replies: List[Tuple[str, str]] = []

        def awake():
            return [nm for nm in names if nm in m.names]

        def asleep():
            return [nm for nm in names if nm not in m.names]

        for rnd in range(rounds):
            op = rng.random()
            if op < 0.40:  # traffic on a random awake name
                pool = awake()
                if pool:
                    nm = rng.choice(pool)
                    v = rng.randrange(1, 100)
                    vals[nm].append(v)
                    m.propose(nm, str(v),
                              callback=lambda _r, rep, nm=nm:
                              replies.append((nm, rep)))
                    if rng.random() < 0.3:
                        # leave it IN FLIGHT: the next hibernate of this
                        # name must carry the request (held vid / window
                        # remnant), not lose it
                        continue
                    ticks(m, 3)
            elif op < 0.60:  # batched sleep of a random awake subset
                pool = awake()
                if pool:
                    k = min(len(pool), rng.randrange(1, 9))
                    m.hibernate_batch(rng.sample(pool, k))
            elif op < 0.80:  # batched wake of a random asleep subset
                pool = asleep()
                free = rows - len(m.names)
                if pool and free > 0:
                    k = min(len(pool), free, rng.randrange(1, 9))
                    m.restore_batch(rng.sample(pool, k))
                    ticks(m, 2)  # re-proposed held vids decide
            elif op < 0.90:  # the N=1 parity path
                pool = asleep()
                if pool and len(m.names) < rows:
                    m.restore(rng.choice(pool))
                pool = awake()
                if pool:
                    m.hibernate(rng.choice(pool))
            else:
                ticks(m, 2)
            if rnd % 10 == 9:
                res = m.residency_stats()
                if res["active_names"] + res["paused_names"] != n_names:
                    raise SoakDivergence(
                        "name conservation breach", {"round": rnd, **{
                            k: res[k] for k in
                            ("active_names", "paused_names")}})
                if (res["paused_in_memory"] + res["paused_on_disk"]
                        != res["paused_names"]):
                    raise SoakDivergence(
                        "paused tier accounting breach",
                        {"round": rnd, **{k: res[k] for k in
                         ("paused_names", "paused_in_memory",
                          "paused_on_disk")}})
                for nm, _e in m.eviction_candidates(idle_s=0.0):
                    row = m.names.get(nm)
                    if row is not None and m.queues.get(row):
                        raise SoakDivergence(
                            "eviction candidate has queued work",
                            {"round": rnd, "name": nm})

        # final audit: wake everyone in waves (population > rows), drain,
        # and demand exact totals
        expected = {nm: sum(vs) for nm, vs in vals.items()}
        unchecked = list(names)
        waves = 0
        while unchecked:
            waves += 1
            if waves > 4 * (n_names // rows + 2):
                raise SoakDivergence(
                    "final audit did not converge",
                    {"unchecked": unchecked[:8]})
            wave = unchecked[:rows]
            m.restore_batch([nm for nm in wave if nm not in m.names])
            for _ in range(30):
                ticks(m, 2)
                if all(m.app.totals.get(nm, 0) == expected[nm]
                       for nm in wave):
                    break
            bad = {nm: {"have": m.app.totals.get(nm, 0),
                        "want": expected[nm]}
                   for nm in wave
                   if m.app.totals.get(nm, 0) != expected[nm]}
            if bad:
                raise SoakDivergence(
                    "adder totals diverged from proposed history "
                    "(lost or double-executed request across a "
                    "pause/resume interleaving)",
                    {"seed": seed, "names": dict(list(bad.items())[:8])})
            m.hibernate_batch(wave)
            unchecked = unchecked[rows:]

        # every reply that did arrive must be a real prefix sum of that
        # name's history (exactly-once visible to the client too)
        for nm, rep in replies:
            cums, s = set(), 0
            for v in vals[nm]:
                s += v
                cums.add(str(s))
            if rep not in cums:
                raise SoakDivergence(
                    "reply is not a prefix sum of the proposed history",
                    {"seed": seed, "name": nm, "reply": rep})

        store = m.residency_stats().get("store", {})
        return {
            "seed": seed, "rounds": rounds,
            "replies": len(replies),
            "compactions": store.get("compactions"),
            "segments": store.get("segments"),
        }
    finally:
        if m is not None:
            m.close()
        Config.clear()
        shutil.rmtree(tmp, ignore_errors=True)
