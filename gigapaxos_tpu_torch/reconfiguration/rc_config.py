"""Reconfiguration-layer flags — the ReconfigurationConfig analog.

Re-creation of the reference's ``ReconfigurationConfig.RC`` flag enum
(``reconfiguration/ReconfigurationConfig.java:142-404``), keeping the
reference's names and defaults where the concept survives, plus knobs for
the TPU build's task re-drive machinery.  Register with
:class:`gigapaxos_tpu_torch.utils.Config` and read via ``Config.get(RC.FLAG)``.
"""

from __future__ import annotations

from ..utils.config import Config, FlagEnum


class RC(FlagEnum):
    # ---- placement (ref: ReconfigurationConfig.java DEFAULT_NUM_REPLICAS)
    DEFAULT_NUM_REPLICAS = 3

    # ---- demand-driven reconfiguration (ref: DEMAND_PROFILE_TYPE,
    # AbstractDemandProfile SPI) — the dotted path of the profile class
    DEMAND_PROFILE_TYPE = (
        "gigapaxos_tpu_torch.reconfiguration.demand.DemandProfile"
    )
    # actives report aggregated demand to the RC every this many requests
    DEMAND_REPORT_EVERY = 64
    # ...and at least this often while any demand is unreported
    DEMAND_REPORT_PERIOD_S = 1.0
    # locality anti-flap: the hot entry must lead the current anchor by
    # this fraction of total demand before ProximityDemandProfile moves
    # an already-placed name again (two near-equal regions must not
    # alternate the replica set on successive reports)
    DEMAND_HYSTERESIS_MARGIN = 0.25

    # ---- placement plane (ref: ProximateBalance.java heuristics +
    # EchoRequest probing, Reconfigurator.java:2420) ---------------------
    # dotted path of the placement policy (AbstractPlacementPolicy SPI,
    # mirroring DEMAND_PROFILE_TYPE)
    PLACEMENT_POLICY_TYPE = (
        "gigapaxos_tpu_torch.reconfiguration.placement.ProximateBalancePolicy"
    )
    # a displacing candidate must be lighter than the member it replaces
    # by this fraction of the member's load (near-equal = stay put)
    PLACEMENT_HYSTERESIS = 0.25
    # minimum seconds between placement-driven moves of the same name
    PLACEMENT_COOLDOWN_S = 30.0
    # a name's EWMA request rate must reach this before balance moves it
    # (below it, only its demand profile's locality decision applies)
    PLACEMENT_MIN_RATE_RPS = 8.0
    # reconfigurators echo-probe every active this often (0 disables);
    # replies carry RTT + the active's load summary, so the RC has a
    # latency/load picture before any real traffic
    ECHO_PROBE_PERIOD_S = 5.0

    # ---- task re-drive machinery (TPU-build specific) ------------------
    REDRIVE_EVERY = 32          # reconfigurator ticks between record scans
    MAX_REDROPS = 8             # fast-retry budget for post-delete straggler drops
    # slow-cadence re-verification of settled state: READY records get
    # their (idempotent) commit round re-run, and budget-exhausted
    # post-delete drops retried, once per this period — heals members
    # that lost their row or missed a drop AFTER the fast rounds ended
    READY_AUDIT_PERIOD_S = 120.0

    # ---- delete (ref: ReconfigurationConfig MAX_FINAL_STATE_AGE 3600s;
    # here the explicit drop rounds + redrops subsume the age-out, this
    # caps how long a served final state is retained for laggard fetches)
    MAX_FINAL_STATE_AGE_S = 3600.0

    # ---- client (ref: ReconfigurableAppClientAsync caches) -------------
    ACTIVES_CACHE_TTL_S = 60.0  # client-side name -> actives cache TTL


Config.register(RC)
