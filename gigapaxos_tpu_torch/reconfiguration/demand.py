"""Demand-driven reconfiguration: profiles + aggregation.

API-parity target: ``AbstractDemandProfile``
(``reconfigurationutils/AbstractDemandProfile.java:103-149`` —
``shouldReportDemandStats`` / ``getStats`` / ``combine`` / ``reconfigure``
/ ``justReconfigured``), the default ``DemandProfile`` (rate/#requests,
never moves the group), and ``AggregateDemandProfiler`` (per-name
aggregation with clipping).  Actives count arriving requests and ship
:data:`DemandReport`-shaped dicts to the name's primary reconfigurator,
whose profile instance decides whether to migrate
(``Reconfigurator.handleDemandReport``, ``Reconfigurator.java:311``).

Profiles are pluggable by dotted path (``RC.DEMAND_PROFILE_TYPE``,
``DEMAND_PROFILE_TYPE`` analog) so deployments can implement locality
policies (the reference ships a GeoIP example).
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional

from ..utils.config import Config
from .rc_config import RC


class AbstractDemandProfile:
    """Per-name demand state living at the record's primary RC."""

    def __init__(self, name: str):
        self.name = name

    def combine(self, report: Dict) -> None:
        """Fold one active's report into the aggregate."""
        raise NotImplementedError

    def reconfigure(
        self, cur_actives: List[int], all_actives: List[int]
    ) -> Optional[List[int]]:
        """Return a new replica set, or None to stay put."""
        raise NotImplementedError

    def just_reconfigured(self) -> None:
        """Reset after a migration this profile triggered."""
        raise NotImplementedError


class DemandProfile(AbstractDemandProfile):
    """Reference-default behavior (``DemandProfile.java``): track request
    totals and an EWMA arrival rate; never propose a move."""

    RATE_WINDOW_S = 1.0  # EWMA update granularity

    def __init__(self, name: str):
        super().__init__(name)
        self.num_requests = 0
        self.num_total = 0
        self.rate = 0.0          # requests/s EWMA
        self.last_ts = time.time()
        self._win_count = 0      # requests in the open window
        self.by_active: Dict[int, int] = {}

    def combine(self, report: Dict) -> None:
        n = int(report.get("count", 0))
        self.num_requests += n
        self.num_total += n
        src = int(report.get("from", -1))
        self.by_active[src] = self.by_active.get(src, 0) + n
        # windowed EWMA: near-simultaneous reports from several actives
        # accumulate into one window — folding each against the tiny
        # inter-report gap would inflate the rate by orders of magnitude
        self._win_count += n
        now = time.time()
        dt = now - self.last_ts
        if dt >= self.RATE_WINDOW_S:
            self.rate = 0.8 * self.rate + 0.2 * (self._win_count / dt)
            self._win_count = 0
            self.last_ts = now

    def reconfigure(self, cur_actives, all_actives):
        return None  # the default profile only measures

    def just_reconfigured(self) -> None:
        self.num_requests = 0
        self.by_active.clear()


class ProximityDemandProfile(DemandProfile):
    """Locality-driven migration — the GeoIP demand profile analog (the
    reference fork's ``GeoIpDemandProfile.java:1-80`` reconfigures a
    name toward the active nearest its dominant client IPs).

    TPU-native formulation without an IP database: clients already pick
    their NEAREST active via latency-aware redirection
    (:class:`~gigapaxos_tpu_torch.net.rtt.LatencyAwareRedirector`), so the
    per-entry request counts the actives report ARE a client-locality
    signal.  When one entry active sources a dominant share of a name's
    traffic, the profile proposes a replica set drawn from that active's
    REGION — configured as ``REGION.<active_id>=zone`` properties (the
    deployment analog of the GeoIP database).  Without a region map it
    only measures, like the default profile."""

    MIN_REQUESTS = 128   # don't migrate on noise
    DOMINANCE = 0.5      # hot entry must source at least this share
    DECAY_AT = 4096      # halve history past this: locality must track
    #                      SHIFTED traffic in bounded time, not lifetime sums

    def __init__(self, name: str):
        super().__init__(name)
        # anti-flap margin (RC.DEMAND_HYSTERESIS_MARGIN): once this
        # profile has anchored the name somewhere, a DIFFERENT hot entry
        # must lead the standing anchor by margin*total before the set
        # moves again — two near-equal top regions otherwise alternate
        # the replica set on successive demand reports (each report tips
        # the max the other way by a handful of requests)
        self.hysteresis_margin = Config.get_float(RC.DEMAND_HYSTERESIS_MARGIN)
        self._anchor: Optional[int] = None  # hot entry of the last move

    def combine(self, report: Dict) -> None:
        super().combine(report)
        if sum(self.by_active.values()) >= self.DECAY_AT:
            self.by_active = {
                a: n // 2 for a, n in self.by_active.items() if n >= 2
            }

    def reconfigure(self, cur_actives, all_actives):
        # removed actives' stale history must not steer (or, as the
        # standing anchor, VETO) locality decisions for the survivors —
        # prune every departed entry, not just a stale max
        live = set(all_actives)
        if any(a not in live for a in self.by_active):
            self.by_active = {
                a: n for a, n in self.by_active.items() if a in live
            }
        if self._anchor is not None and self._anchor not in live:
            self._anchor = None
        total = sum(self.by_active.values())
        if total < self.MIN_REQUESTS:
            return None
        hot, n = max(self.by_active.items(), key=lambda kv: kv[1])
        if n < total * self.DOMINANCE:
            return None
        anchor = self._anchor if self._anchor is not None else (
            cur_actives[0] if cur_actives else None
        )
        if anchor is not None and hot != anchor and \
                n - self.by_active.get(anchor, 0) < \
                self.hysteresis_margin * total:
            return None  # near-equal top entries: hold the standing anchor
        region = Config.get(f"REGION.{hot}")
        if region is None:
            return None  # no region map configured: measure only
        target = [hot] + [
            a for a in all_actives
            if a != hot and Config.get(f"REGION.{a}") == region
        ][: max(0, len(cur_actives) - 1)]
        # top up to the full replica count when the region is smaller:
        # surviving current members first, then any other live active
        # (availability beats strict locality; dead members add none, and
        # a locality move must NEVER shrink the set)
        target += [
            a for a in cur_actives
            if a not in target and a in all_actives
        ]
        target += [a for a in all_actives if a not in target]
        target = target[: len(cur_actives)]
        if len(target) < len(cur_actives):
            return None  # cluster too small to keep the replica count
        if sorted(target) == sorted(cur_actives):
            self._anchor = hot  # already placed right: remember why
            return None
        self._anchor = hot
        return target


class AggregateDemandProfiler:
    """Per-name profile table with clipping
    (``AggregateDemandProfiler.java`` analog)."""

    MAX_NAMES = 100_000

    def __init__(self, profile_cls=None):
        if profile_cls is None:
            path = Config.get_str(RC.DEMAND_PROFILE_TYPE)
            mod, _, cls = path.rpartition(".")
            profile_cls = getattr(importlib.import_module(mod), cls)
        self.profile_cls = profile_cls
        self._profiles: Dict[str, AbstractDemandProfile] = {}

    def combine(self, name: str, report: Dict) -> AbstractDemandProfile:
        prof = self._profiles.get(name)
        if prof is None:
            if len(self._profiles) >= self.MAX_NAMES:
                # clip: drop an arbitrary cold entry (the reference clips
                # by pushing out aggregated entries)
                self._profiles.pop(next(iter(self._profiles)))
            prof = self.profile_cls(name)
            self._profiles[name] = prof
        prof.combine(report)
        return prof

    def pop(self, name: str) -> None:
        self._profiles.pop(name, None)
