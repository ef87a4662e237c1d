"""In-process multi-replica simulator with fault injection.

The reference's integration strategy runs N real nodes inside one JVM with
emulated crashes (drop a node's traffic, ``TESTPaxosConfig.crash``,
``testing/TESTPaxosConfig.java:563-580``) and emulated link delays
(``nio/JSONDelayEmulator.java:36``).  The analog here: R replica
:class:`EngineState`s advanced in lock-step, with a per-link delivery
control — DROP (blob not heard), STALE (re-deliver the last heard blob:
time-skew/delay emulation), or DELIVER — plus a global safety checker that
asserts the Paxos invariants every step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.ballot import NULL
from ..ops.engine import (
    Blob,
    EngineConfig,
    EngineState,
    init_state,
    make_blob,
    resolve_device,
    step,
    to_host,
)
from ..ops.lifecycle import create_groups, initial_coordinator

DELIVER, DROP, STALE = 0, 1, 2


class SafetyChecker:
    """Cross-replica Paxos safety invariants (the assertRSMInvariant analog,
    ``TESTPaxosMain.java:66-77``, plus decision-stability and monotonicity).
    """

    def __init__(self, n_replicas: int, n_groups: int):
        self.R, self.G = n_replicas, n_groups
        # (group, slot) -> vid, the first decision anyone executed
        self.chosen: Dict[Tuple[int, int], int] = {}
        self.exec_logs: List[Dict[Tuple[int, int], int]] = [
            {} for _ in range(n_replicas)
        ]
        self.last_exec = np.zeros((n_replicas, n_groups), np.int64)
        self.last_bal = np.full((n_replicas, n_groups), -(2 ** 31), np.int64)

    def observe(self, rid: int, state: EngineState, out) -> None:
        exec_base = to_host(out.exec_base)
        n_comm = to_host(out.n_committed)
        exec_vid = to_host(out.exec_vid)
        bal = to_host(state.bal)
        exec_slot = to_host(state.exec_slot)
        # monotonicity
        assert (bal >= self.last_bal[rid]).all(), "ballot went backwards"
        assert (exec_slot >= self.last_exec[rid]).all(), "frontier went backwards"
        self.last_bal[rid] = bal
        self.last_exec[rid] = exec_slot
        # agreement: every executed (group, slot) has exactly one value ever
        for g in np.nonzero(n_comm)[0]:
            base = int(exec_base[g])
            for o in range(int(n_comm[g])):
                vid = int(exec_vid[g, o])
                key = (int(g), base + o)
                prev = self.chosen.setdefault(key, vid)
                assert prev == vid, (
                    f"DIVERGENCE at group {g} slot {base + o}: "
                    f"{prev} vs {vid} (replica {rid})"
                )
                self.exec_logs[rid][key] = vid

    def total_committed(self) -> int:
        return len(self.chosen)


@dataclasses.dataclass
class SimCluster:
    """R replicas stepped in lock-step with controllable delivery."""

    cfg: EngineConfig
    check: bool = True
    device: object = None  # None = the CUDA card; "cpu" = plain engine

    def __post_init__(self):
        R = self.cfg.n_replicas
        self.device = resolve_device(self.device)
        self.states: List[EngineState] = [
            init_state(self.cfg, self.device) for _ in range(R)
        ]
        # last blob heard by receiver i from sender j (for STALE delivery)
        self._heard_blobs: List[List[Optional[Blob]]] = [
            [None] * R for _ in range(R)
        ]
        self.checker = SafetyChecker(R, self.cfg.n_groups)
        self.t = 0

    # ---- group management ------------------------------------------------
    def create_group(self, g: int, members: Optional[List[int]] = None) -> None:
        members = list(range(self.cfg.n_replicas)) if members is None else members
        mask = 0
        for m in members:
            mask |= 1 << m
        idx = np.array([g])
        masks = np.array([mask])
        coord0 = initial_coordinator(idx, masks)
        for rid in range(self.cfg.n_replicas):
            self.states[rid] = create_groups(
                self.states[rid], idx, masks, coord0, my_id=rid
            )

    def create_all_groups(self, n: Optional[int] = None) -> None:
        R = self.cfg.n_replicas
        n = self.cfg.n_groups if n is None else n
        idx = np.arange(n)
        masks = np.full(n, (1 << R) - 1)
        coord0 = initial_coordinator(idx, masks)
        for rid in range(R):
            self.states[rid] = create_groups(
                self.states[rid], idx, masks, coord0, my_id=rid
            )

    def coordinator_of(self, g: int) -> int:
        """Current believed coordinator: the max promised ballot's coord over
        the group's *members* (a non-member's frozen row would go stale)."""
        from ..ops.ballot import NULL as BNULL, ballot_coord

        mask = int(self.states[0].member_mask[g])
        members = [r for r in range(self.cfg.n_replicas) if (mask >> r) & 1]
        if not members:
            raise ValueError(f"group {g} has no members")
        bal = max(int(self.states[r].bal[g]) for r in members)
        if bal == BNULL:
            return members[0]
        return int(ballot_coord(bal))

    # ---- stepping --------------------------------------------------------
    def step_all(
        self,
        reqs: Optional[Dict[int, np.ndarray]] = None,   # rid -> [G, K] vids
        want_coord: Optional[Dict[int, np.ndarray]] = None,  # rid -> [G] bool
        delivery: Optional[np.ndarray] = None,          # [R(recv), R(send)] codes
    ) -> List:
        """Advance every replica one step under the given delivery matrix."""
        cfg = self.cfg
        R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes
        reqs = reqs or {}
        want_coord = want_coord or {}
        if delivery is None:
            delivery = np.full((R, R), DELIVER)

        dev = self.device
        fresh = [make_blob(s) for s in self.states]
        outs = []
        no_req = torch.full((G, K), NULL, dtype=torch.int32, device=dev)
        no_want = torch.zeros((G,), dtype=torch.bool, device=dev)
        for i in range(R):
            rows = []
            heard = np.zeros(R, bool)
            for j in range(R):
                code = DELIVER if i == j else delivery[i, j]  # always hear self
                if code == DELIVER:
                    blob = fresh[j]
                    self._heard_blobs[i][j] = blob
                elif code == STALE:
                    blob = self._heard_blobs[i][j]
                else:
                    blob = None
                if blob is None:
                    blob = fresh[i]  # placeholder row, masked out by heard
                    heard[j] = False
                else:
                    heard[j] = True
                rows.append(blob)
            gathered = Blob(*(torch.stack(xs) for xs in zip(*rows)))
            rv = reqs.get(i)
            rv = no_req if rv is None else torch.as_tensor(
                np.asarray(rv), dtype=torch.int32, device=dev
            )
            wc = want_coord.get(i)
            wc = no_want if wc is None else torch.as_tensor(
                np.asarray(wc), dtype=torch.bool, device=dev
            )
            new_state, out = step(
                self.states[i], gathered,
                torch.as_tensor(heard, device=dev), rv, wc, i, cfg,
            )
            self.states[i] = new_state
            outs.append(out)
        if self.check:
            for i, out in enumerate(outs):
                self.checker.observe(i, self.states[i], out)
        self.t += 1
        return outs

    # ---- convenience -----------------------------------------------------
    def run(self, n_steps: int, **kw) -> None:
        for _ in range(n_steps):
            self.step_all(**kw)

    def exec_frontiers(self) -> np.ndarray:
        return np.stack([to_host(s.exec_slot) for s in self.states])

    def app_hashes(self) -> np.ndarray:
        return np.stack([to_host(s.app_hash) for s in self.states])

    def assert_rsm_invariant(self, groups=None) -> None:
        """All replicas at the same frontier must have identical app hashes."""
        fr = self.exec_frontiers()
        hs = self.app_hashes()
        groups = range(self.cfg.n_groups) if groups is None else groups
        for g in groups:
            by_frontier: Dict[int, int] = {}
            for r in range(self.cfg.n_replicas):
                f, h = int(fr[r, g]), int(hs[r, g])
                prev = by_frontier.setdefault(f, h)
                assert prev == h, (
                    f"RSM divergence: group {g} frontier {f}: {prev} vs {h}"
                )
