"""Loopback reconfiguration cluster: N actives + M reconfigurators in one
process — the analog of the reference's in-JVM reconfiguration testing
(``TESTReconfigurationMain.java:34`` boots actives+RCs in-process and
drives ``TESTReconfigurationClient``).

Two :class:`ManagerCluster`s (the actives' app engine and the
reconfigurators' RC-record engine) tick side by side; reconfiguration
messages (start/stop/drop epoch, create/delete/request-actives, acks)
route through per-address inboxes with controllable delivery.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..ops.engine import EngineConfig
from ..reconfiguration.active_replica import ActiveReplica
from ..reconfiguration.coordinator import PaxosReplicaCoordinator
from ..reconfiguration.rc_app import RCRecordsApp
from ..reconfiguration.reconfigurator import RC_GROUP, Reconfigurator
from .cluster import ManagerCluster

Addr = Tuple[str, int]


class ReconfigurableCluster:
    def __init__(
        self,
        ar_cfg: EngineConfig,
        rc_cfg: EngineConfig,
        make_app: Callable[[], Any],
        ar_log_dirs: Optional[List[str]] = None,
        rc_log_dirs: Optional[List[str]] = None,
        demand_profile_cls=None,
        rc_members: Optional[List[int]] = None,
        placement_policy_cls=None,
        device=None,
    ):
        """``rc_members`` boots the record RSM on a SUBSET of the RC nodes;
        the rest run as standbys addressable for a later runtime
        add_reconfigurator (ref tests 31/32 boot spare RCs the same way).
        ``device`` is both engines' device (default: the CUDA card,
        raising when there is none; ``"cpu"``: the plain engine)."""
        n_ar, n_rc = ar_cfg.n_replicas, rc_cfg.n_replicas
        self.ar_ids = list(range(n_ar))
        self.rc_ids = list(range(n_rc))
        self.rc_members = (
            sorted(int(r) for r in rc_members) if rc_members is not None
            else list(self.rc_ids)
        )
        # reconfiguration-plane message queues (current + next round)
        self._inboxes: Dict[Addr, List[Tuple[str, Dict]]] = {}
        self.client_inbox: List[Tuple[str, Dict]] = []
        # fault injection: return False to drop a control-plane message
        # (client-bound replies are never dropped — tests wait on them)
        self.msg_filter: Optional[Callable[[Addr, str, Dict], bool]] = None

        self.ars = ManagerCluster(ar_cfg, make_app, log_dirs=ar_log_dirs,
                                  device=device)
        self.rcs = ManagerCluster(rc_cfg, RCRecordsApp, log_dirs=rc_log_dirs,
                                  device=device)

        self.active_replicas: List[ActiveReplica] = []
        for i in self.ar_ids:
            mgr = self.ars.managers[i]
            coord = PaxosReplicaCoordinator(mgr.app, mgr)
            self.active_replicas.append(
                ActiveReplica(i, coord, self._sender(), rc_ids=self.rc_ids)
            )
        # fault injection: RCs listed here are treated dead by the layer's
        # primary takeover (and usually also cut off via msg_filter)
        self.dead_rcs: set = set()
        from ..reconfiguration.demand import AggregateDemandProfiler

        self.reconfigurators: List[Reconfigurator] = []
        for j in self.rc_ids:
            mgr = self.rcs.managers[j]
            self.reconfigurators.append(Reconfigurator(
                j, mgr, mgr.app, self.ar_ids, self.rc_members, self._sender(),
                ar_n_groups=ar_cfg.n_groups,
                is_node_up=lambda rc: rc not in self.dead_rcs,
                demand_profiler=(
                    AggregateDemandProfiler(demand_profile_cls)
                    if demand_profile_cls else None
                ),
                placement_policy_cls=placement_policy_cls,
            ))
        # bootstrap the RC-record RSM on every reconfigurator (the
        # AR_RC_NODES-style special group, created deterministically);
        # standby nodes host the row frozen (non-member) until a runtime
        # add_reconfigurator brings them in
        self.rcs.create(RC_GROUP, members=self.rc_members)

    def _sender(self) -> Callable[[Addr, str, Dict], None]:
        def send(dst: Addr, kind: str, body: Dict) -> None:
            dst = tuple(dst)
            if dst[0] == "CLIENT":
                self.client_inbox.append((kind, body))
            else:
                if self.msg_filter is not None and not self.msg_filter(dst, kind, body):
                    return  # injected drop
                self._inboxes.setdefault(dst, []).append((kind, body))
        return send

    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> None:
        """One cluster-wide round: deliver control messages, tick both
        engines (blob exchange within each), run protocol-task timers."""
        # deliver the reconfiguration-plane messages queued last round
        inboxes, self._inboxes = self._inboxes, {}
        for (role, idx), msgs in inboxes.items():
            node = (
                self.active_replicas[idx] if role == "AR"
                else self.reconfigurators[idx]
            )
            for kind, body in msgs:
                node.handle_message(kind, body)
        # consensus ticks (blob exchange + host-channel within each cluster)
        self.ars.step_all()
        self.rcs.step_all()
        # protocol-task timers
        for ar in self.active_replicas:
            ar.tick(now)
        for rc in self.reconfigurators:
            rc.tick(now)

    def run(self, n: int, now: Optional[float] = None) -> None:
        for _ in range(n):
            self.step(now)

    # ---- client-side helpers -------------------------------------------
    def client_request(self, kind: str, body: Dict, rc: int = 0) -> None:
        body = dict(body)
        body.setdefault("client", ("CLIENT", 0))
        self._inboxes.setdefault(("RC", rc), []).append((kind, body))

    def drain_client(self) -> List[Tuple[str, Dict]]:
        out, self.client_inbox = self.client_inbox, []
        return out

    def wait_for(self, kind: str, max_steps: int = 60) -> Optional[Dict]:
        """Step until a client message of `kind` arrives (or give up)."""
        for _ in range(max_steps):
            for k, body in self.drain_client():
                if k == kind:
                    return body
            self.step()
        return None

    def close(self) -> None:
        for m in self.ars.managers + self.rcs.managers:
            m.close()
