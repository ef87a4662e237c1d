"""Placement plane: demand-aware, load-balancing replica placement.

API-parity target: ``ProximateBalance``
(``reconfigurationutils/ProximateBalance.java:1-362``) — the reference's
demand-weighted placement heuristics that pick replica sets near the
demand *and* balanced across server load — plus the active orientation
half of ``Reconfigurator.java:2420`` (``EchoRequest`` probing: nodes
measure each other instead of waiting for real traffic to reveal
latency).

Three signals feed every decision, all aggregated at the reconfigurator:

* **per-name demand locality** — the record's
  :class:`~gigapaxos_tpu_torch.reconfiguration.demand.AbstractDemandProfile`
  (request counts per entry active = client locality, since clients
  route to their nearest active);
* **cluster-wide load** — names-hosted and request-rate per active,
  carried by demand reports and echo replies (so a zero-traffic cluster
  still has a load picture), plus a decision-time ``assigned`` counter
  so a burst of placements spreads before the next load report lands;
* **measured latency** — the echo-probe RTT matrix
  (:class:`PlacementEngine` holds the RC's row of it; clients hold
  their own and seed
  :class:`~gigapaxos_tpu_torch.net.rtt.LatencyAwareRedirector` from it).

Policies are pluggable by dotted path (``RC.PLACEMENT_POLICY_TYPE``,
mirroring ``RC.DEMAND_PROFILE_TYPE``); the default
:class:`ProximateBalancePolicy` spreads hot names across the
least-loaded nearby actives with hysteresis + per-name cooldown so
near-equal candidates never flap a name between replica sets.
"""

from __future__ import annotations

import importlib
import threading
import time
import zlib
from typing import Dict, List, Optional

from ..net.rtt import RTTEstimator
from ..utils.config import Config
from .rc_config import RC


class ActiveLoad:
    """One active's load picture at this RC."""

    __slots__ = ("names", "rps", "assigned", "last_seen")

    def __init__(self):
        self.names = 0      # names hosted (the active's own report)
        self.rps = 0.0      # EWMA request rate (reported)
        self.assigned = 0   # names THIS RC placed here since the last report
        self.last_seen = 0.0

    def to_json(self) -> Dict:
        return {
            "names": self.names, "rps": round(self.rps, 3),
            "assigned": self.assigned,
            "age_s": round(time.time() - self.last_seen, 1)
            if self.last_seen else None,
        }


class AbstractPlacementPolicy:
    """Placement SPI (the ``ProximateBalance`` seam): policies see the
    engine's signal tables and return replica sets; the engine owns
    cooldown bookkeeping and metrics."""

    def __init__(self, engine: "PlacementEngine"):
        self.engine = engine

    def place_initial(
        self, name: str, all_actives: List[int], k: int
    ) -> List[int]:
        """Create-time replica set for a brand-new name."""
        raise NotImplementedError

    def rebalance(
        self, name: str, profile, cur_actives: List[int],
        all_actives: List[int],
    ) -> Optional[List[int]]:
        """Post-demand-report replica set, or None to stay put.  Runs
        only when the name's demand profile itself declined to move
        (locality wins over balance, like the reference).  A policy MAY
        set ``self.last_decline_reason`` before returning None (e.g.
        "cold", "hysteresis") — the engine labels its suppression
        counters with it so operators can tell a gated-out name from a
        genuinely damped move."""
        raise NotImplementedError


class MeasureOnlyPlacementPolicy(AbstractPlacementPolicy):
    """Opt-out policy: the signal tables and stats stay live, but nothing
    is ever placed or moved — creates fall back to the consistent-hash
    ring.  For deployments that pin topology explicitly, and for test
    harnesses whose recorded fault schedules must not grow new
    control-plane behavior (the chaos soaks pin their seeds' message
    universe with it)."""

    def place_initial(self, name, all_actives, k):
        return []

    def rebalance(self, name, profile, cur_actives, all_actives):
        return None


class ProximateBalancePolicy(AbstractPlacementPolicy):
    """Default policy: least-loaded-nearby with anti-flap damping.

    Load is bucketed into LOAD_QUANTUM-sized classes so near-equal loads
    compare EQUAL and the tie breaks on proximity (probed RTT), then on
    a per-name stable hash — the ProximateBalance ordering (balance
    first, proximity second) without the reference's exact constants.
    A non-member displaces a current member only when it is lighter by
    more than the hysteresis margin, and the engine enforces a per-name
    cooldown between moves, so two near-equal candidates cannot bounce
    a name back and forth on successive demand reports."""

    # a name must be at least this hot before balance moves it — and
    # STRICTLY hotter than any locality threshold (ProximityDemandProfile
    # fires at 128): the demand profile must get its locality decision in
    # first, or balance races it and strands the name away from its
    # demand region before locality ever triggers
    MIN_REQUESTS = 256
    # load-class width, in request-rate units; 1 hosted name ≈ NAME_RATE
    LOAD_QUANTUM = 4.0
    NAME_RATE = 1.0

    def _score(self, a: int) -> float:
        ld = self.engine.loads.get(a)
        if ld is None:
            return 0.0
        return ld.rps + self.NAME_RATE * (ld.names + ld.assigned)

    def _order_key(self, name: str, a: int):
        """(load class, probed RTT, stable per-name hash): balance beats
        proximity beats the deterministic shuffle."""
        rtt = self.engine.rtt.get(a)
        return (
            int(self._score(a) // self.LOAD_QUANTUM),
            rtt if rtt is not None else float("inf"),
            zlib.crc32(f"{name}:{a}".encode()),
        )

    def place_initial(self, name, all_actives, k):
        ranked = sorted(all_actives, key=lambda a: self._order_key(name, a))
        return ranked[:k]

    def rebalance(self, name, profile, cur_actives, all_actives):
        self.last_decline_reason = "declined"
        hot_rate = float(getattr(profile, "rate", 0.0))
        n_req = int(getattr(profile, "num_requests", 0))
        # BOTH gates: a sustained count (so locality profiles decide
        # first) and a live rate floor (a name whose 256 requests are
        # spread over an hour is not hot, just old)
        if n_req < self.MIN_REQUESTS or \
                hot_rate < self.engine.min_rate_rps:
            self.last_decline_reason = "cold"
            return None
        margin = self.engine.hysteresis
        scores = {a: self._score(a) for a in all_actives}
        target = [a for a in cur_actives if a in all_actives]
        if len(target) < len(cur_actives):
            # a member left the cluster: proposing the filtered set would
            # SHRINK the replica count permanently (the locality profile's
            # never-shrink rule applies here too) — membership loss is the
            # READY re-drive's _rehome_set job; balance waits for a whole
            # set
            self.last_decline_reason = "short_set"
            return None
        # a name must not flee its OWN load: discount each current member
        # by the name's contribution there — its rate share at that entry
        # (the profile's per-active counts) plus its hosted-name slot
        by = dict(getattr(profile, "by_active", None) or {})
        tot = sum(by.values())

        def own(m: int) -> float:
            share = (by.get(m, 0) / tot) if tot else (1.0 / len(target))
            return hot_rate * share + self.NAME_RATE

        # PROXIMATE balance: the name's dominant entry active is where
        # its clients are — never displace it for load.  Without this,
        # balance evicts a loaded anchor that the locality profile then
        # re-adds on the next report, and the two deciders migrate the
        # name back and forth at cooldown cadence forever.
        anchor = max(by, key=by.get) if by else None
        movable = [m for m in target if m != anchor]
        # candidate order is the BUCKETED key (load class, then probed
        # RTT, then stable hash) — ordering by raw score would let a
        # marginally-lighter-but-far active beat the nearest same-class
        # one, defeating the proximity half of the design
        outsiders = sorted(
            (a for a in all_actives if a not in target),
            key=lambda a: self._order_key(name, a),
        )
        moved = False
        for cand in outsiders:
            if not movable:
                break
            # displace the heaviest remaining member, if the candidate
            # beats it by more than the hysteresis margin
            worst = max(
                movable, key=lambda m: (scores[m] - own(m),
                                        self._order_key(name, m)),
            )
            w_eff = scores[worst] - own(worst)
            gap = w_eff - scores[cand]
            if gap <= margin * max(w_eff, 1.0):
                # not this candidate — but a later SAME-CLASS one can be
                # raw-lighter (in-bucket order is by proximity, not
                # score), so keep scanning; the list is cluster-sized
                continue
            target[target.index(worst)] = cand
            movable.remove(worst)
            # the candidate now carries this name's share too, so a
            # second swap must clear the bar against the UPDATED load
            scores[cand] += hot_rate / len(target) + self.NAME_RATE
            moved = True
        if not moved or sorted(target) == sorted(cur_actives):
            self.last_decline_reason = "hysteresis"
            return None
        # anchor the least-loaded member first (the entry the redirector
        # will favor); keep the rest in ranked order for determinism
        target.sort(key=lambda a: (scores[a], self._order_key(name, a)))
        return target


class PlacementEngine:
    """The RC's placement state: per-active loads, the probed RTT row,
    the pluggable policy, cooldown bookkeeping, and stats.

    Thread-safe: the epoch plane mutates it under the RC layer lock
    while HTTP/admin stats readers snapshot from worker threads."""

    def __init__(
        self,
        my_id: int = -1,
        policy_cls=None,
        metrics=None,  # MetricsRegistry (the RC manager's) or None
    ):
        self.my_id = int(my_id)
        if policy_cls is None:
            path = Config.get_str(RC.PLACEMENT_POLICY_TYPE)
            mod, _, cls = path.rpartition(".")
            policy_cls = getattr(importlib.import_module(mod), cls)
        self.policy = policy_cls(self)
        self.metrics = metrics
        self.hysteresis = Config.get_float(RC.PLACEMENT_HYSTERESIS)
        self.cooldown_s = Config.get_float(RC.PLACEMENT_COOLDOWN_S)
        self.min_rate_rps = Config.get_float(RC.PLACEMENT_MIN_RATE_RPS)
        # liveness-by-freshness: an active whose echo replies stopped is
        # not "idle", it is likely DOWN — never-reported-recently actives
        # must not rank as the least-loaded target for every hot name.
        # 4 missed probe rounds = stale; 0 (probing disabled) turns the
        # gate off (no signal to judge by)
        period = Config.get_float(RC.ECHO_PROBE_PERIOD_S)
        self.stale_after_s = 4.0 * period if period > 0 else None
        self.loads: Dict[int, ActiveLoad] = {}
        self.rtt = RTTEstimator()  # my row of the probed RTT matrix
        self._last_move: Dict[str, float] = {}
        self._lock = threading.Lock()

    # ---- signal ingestion ---------------------------------------------
    def _load(self, active: int) -> ActiveLoad:
        ld = self.loads.get(active)
        if ld is None:
            ld = self.loads[active] = ActiveLoad()
        return ld

    def note_load(self, active: int, names: Optional[int],
                  rps: Optional[float]) -> None:
        """Fold one active's self-reported load summary (from an echo
        reply or a demand report ride-along)."""
        with self._lock:
            ld = self._load(int(active))
            if names is not None:
                ld.names = int(names)
            if rps is not None:
                # first sample adopts the reported rate outright (like
                # RTTEstimator.record): halving it would make every
                # newly-seen active look half as busy as it is for
                # several probe rounds — the exact post-failover window
                # where a fresh primary decides placements
                ld.rps = (
                    float(rps) if ld.last_seen == 0.0
                    else 0.5 * ld.rps + 0.5 * float(rps)
                )
            # decay (not reset) the decision-time guess: reports absorb
            # placements that committed before they were generated, but
            # a report racing an in-flight create burst predates those
            # placements — halving keeps residual steering through the
            # race while still converging to the report's truth
            ld.assigned //= 2
            ld.last_seen = time.time()

    def note_echo(self, active: int, rtt_s: float,
                  names: Optional[int] = None,
                  rps: Optional[float] = None) -> None:
        self.rtt.record(int(active), float(rtt_s))
        self.note_load(active, names, rps)
        if self.metrics is not None:
            self.metrics.count("placement_echo_replies")
            self.metrics.gauge(
                f"probe_rtt_ms_active_{int(active)}", float(rtt_s) * 1e3
            )
            if rps is not None:
                self.metrics.gauge(
                    f"placement_rps_active_{int(active)}", float(rps)
                )
            if names is not None:
                self.metrics.gauge(
                    f"placement_names_active_{int(active)}", int(names)
                )

    def note_report(self, body: Dict) -> None:
        """Demand-report ride-along: ``body["load"]`` carries the sending
        active's {names, rps} summary."""
        load = body.get("load")
        src = body.get("from")
        if not isinstance(load, dict) or src is None:
            return
        self.note_load(int(src), load.get("names"), load.get("rps"))

    def forget(self, active: int) -> None:
        """Membership loss: a removed active's stale load/RTT must not
        keep repelling (or attracting) placements, and its per-active
        metric series must stop exporting a live-looking last value."""
        a = int(active)
        with self._lock:
            self.loads.pop(a, None)
            self.rtt.pop(a)
            if self.metrics is not None:
                for g in ("probe_rtt_ms_active_", "placement_rps_active_",
                          "placement_names_active_"):
                    self.metrics.remove(f"{g}{a}")

    # ---- decisions ----------------------------------------------------
    def _fresh(self, actives: List[int], now: float) -> List[int]:
        """Actives whose load report is recent enough to trust.  With no
        reports at all (boot, or probing disabled) there is no signal to
        judge by, so everyone stays eligible rather than no one."""
        if self.stale_after_s is None or not self.loads:
            return list(actives)
        cut = now - self.stale_after_s
        fresh = [
            a for a in actives
            if (ld := self.loads.get(a)) is not None and ld.last_seen >= cut
        ]
        return fresh if fresh else list(actives)

    def place_initial(
        self, name: str, all_actives: List[int], k: int
    ) -> List[int]:
        with self._lock:
            pool = self._fresh(list(all_actives), time.time())
            target = self.policy.place_initial(name, pool, k)
            target = [a for a in (target or []) if a in set(all_actives)]
            # freshness is a PREFERENCE, never a replica-count cut: a
            # short answer (stale-filtered pool, or a thin policy) tops
            # up from the remainder — an under-replicated create would
            # stay under-replicated forever (the rebalance path refuses
            # short sets by design)
            want = min(int(k), len(all_actives))
            if len(target) < want:
                rest = [a for a in all_actives if a not in target]
                extra = self.policy.place_initial(
                    name, rest, want - len(target)
                )
                target += [a for a in (extra or []) if a not in target]
                target = target[:want]
            for a in target:
                self._load(a).assigned += 1
            if self.metrics is not None and target:
                self.metrics.count("placement_initial_placements")
        return target

    def rebalance(
        self, name: str, profile, cur_actives: List[int],
        all_actives: List[int], now: Optional[float] = None,
    ) -> Optional[List[int]]:
        now = time.time() if now is None else now
        with self._lock:
            last = self._last_move.get(name)
            if last is not None and now - last < self.cooldown_s:
                if self.metrics is not None:
                    self.metrics.count("placement_suppressed_cooldown")
                return None
            # stale (likely-dead) actives are not move targets; current
            # members ride along regardless — dropping one here would
            # just trip the policy's never-shrink guard (dead-member
            # rehoming is the READY re-drive's job)
            eligible = set(self._fresh(list(all_actives), now)) \
                | set(cur_actives)
            target = self.policy.rebalance(
                name, profile, list(cur_actives),
                [a for a in all_actives if a in eligible],
            )
            if not target or sorted(target) == sorted(cur_actives):
                if self.metrics is not None:
                    # labeled by the policy's reason: an operator must be
                    # able to tell cold/gated names from genuinely damped
                    # moves before touching the hysteresis knob
                    reason = getattr(
                        self.policy, "last_decline_reason", None
                    ) or "declined"
                    self.metrics.count(f"placement_suppressed_{reason}")
                return None
            self._last_move[name] = now
            for a in target:
                if a not in cur_actives:
                    self._load(a).assigned += 1
            if self.metrics is not None:
                self.metrics.count("placement_moves_proposed")
        return list(target)

    def note_name_gone(self, name: str) -> None:
        with self._lock:
            self._last_move.pop(name, None)

    # ---- stats ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-safe dump for the ``stats`` admin op / RC ``/stats``."""
        with self._lock:
            return {
                "policy": type(self.policy).__name__,
                "hysteresis": self.hysteresis,
                "cooldown_s": self.cooldown_s,
                "loads": {
                    str(a): ld.to_json()
                    for a, ld in sorted(self.loads.items())
                },
                "probe_rtt_ms": {
                    str(a): round(r * 1e3, 3)
                    for a, r in sorted(self.rtt.items())
                },
                "names_in_cooldown": len(self._last_move),
            }
