"""The batched vectorized Paxos engine over PyTorch int32 tensors.

This is the PyTorch counterpart of the JAX package's ``ops/engine.py``:
the same protocol, the same NamedTuples (field order and shapes, which
ARE the wire format and the out-vector layout), and the same int32
arithmetic, so every leaf is bit-identical to the reference for the same
inputs.  It replaces the reference's object-per-group event machines
(``PaxosInstanceStateMachine.java:117``, ``PaxosAcceptor.java:59``,
``PaxosCoordinatorState.java:57``) with one transition over
struct-of-array state for *all* G groups at once:

  * Acceptor state (``PaxosAcceptor.java:82-103``) becomes int32 ``[G]``
    tensors plus fixed ``[G, W]`` slot-ring windows (W = in-flight slot
    cap, the ``SYNC_THRESHOLD``/out-of-order analog).
  * Coordinator state (``PaxosCoordinatorState.java:68-143``) becomes
    ``[G]`` phase/ballot tensors plus a ``[G, W]`` proposal ring.
  * Message passing becomes ONE exchange per step of each replica's
    packed **state blob** (the gathered ``[R, NB]`` matrix, whose rows
    are the ``D`` wire-frame bodies), with a ``heard`` mask for fault
    injection.

Protocol formulation ("state-exchange Paxos"): each replica publishes an
atomic snapshot (promised ballot, accepted window, learned decisions,
coordinator proposals, prepare intent).  Every replica can then
*locally* promise (fold the max gathered prepare/proposal ballot), accept
(adopt the highest-ballot proposal per window lane), learn (a slot is
decided when >= majority of gathered windows show the same (slot,
ballot) accepted), and elect (prepare quorum = gathered promises at my
ballot; carryover = max-ballot accepted pvalue per lane among promisers'
snapshots, the ``handlePrepareReply`` rule,
``PaxosInstanceStateMachine.java:945-975``).

Ring convention: window lane ``j`` always holds slot ``s`` with
``s % W == j``, so windows align lane-for-lane across replicas.

Compact exchange format: the blob ships 4 ``[G]`` + 4 ``[G, W]`` int32
leaves.  A lane's absolute slot is rebuilt from the sender's
``exec_slot`` anchor plus a 5-bit ring-epoch ("wrap") delta, and an
accepted lane's ballot from the sender's ``bal`` minus a 16-bit delta;
all of it bit-packs into one ``lane_meta`` word per lane, and the two
coordinator-intent scalars pack into one ``coord`` word.  A wrap delta
spans +-WRAP_MAX ring epochs around the sender's frontier; lanes outside
it (stale accepted residue below a sender that jumped, far-ahead
decisions a laggard mirrored) and accepted ballots trailing ``bal`` by
more than DELTA_MAX publish as NULL.  Both are liveness aids only: the
election floor rule covers (a) for safety, and a receiver lagging that
far heals via the host sync/checkpoint-jump protocols.

Select-by-masked-max: every row/lane select is a masked max, which is
sound by Paxos value-uniqueness (rows agreeing on (slot, ballot) hold
the same value), and the majority-rank frontier is an O(R^2) rank count.

Two implementations of every device function live here:

* the **plain** version (``step_plain``, ``make_blob_plain``): an
  op-for-op PyTorch transcription of the reference, the CPU path and
  the yardstick the kernel is held against;
* the **kernel** (``csrc/gp_step.cu``, bound in :mod:`.gp_kernels`): a
  hand-written CUDA kernel for Hopper computing step + make_blob +
  pack_blob (+ the optional heat accumulator) in one launch.

The dispatching entry points (:func:`step`, :func:`make_blob`,
:func:`step_host`, :func:`make_blob_vec`) take the plain version ONLY
for tensors that lie on the CPU; on a CUDA tensor they launch the kernel
or raise.  Each kernel launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .ballot import COORD_MASK, NULL, ballot_num, encode_ballot

# Coordinator phases (``PaxosCoordinatorState.java:68-143``).
IDLE = 0
PREPARING = 1
ACTIVE = 2

# Value-id space: NULL (-1) = empty lane; NOOP_VID (0) = hole-filling no-op
# (not folded into app state); real request vids are > 0.  Bit 30 marks an
# epoch-final stop request (``RequestPacket.stop``).
NOOP_VID = 0
STOP_BIT = 1 << 30

_BIG = 2 ** 30
_I32 = torch.int32

# ---- compact lane_meta bit layout (one int32 per lane) --------------------
# [ 0:16) accepted-ballot delta field: 0 = lane empty/unrepresentable,
#         else (sender_bal - acc_bal) + 1  (delta <= DELTA_MAX)
# [16:21) accepted-slot wrap field   \  0 = NULL, else ring-epoch delta
# [21:26) decided-slot wrap field     } vs the sender's exec_slot anchor,
# [26:31) proposal-slot wrap field   /  biased by WRAP_BIAS
# [31]    always 0 (meta stays non-negative)
WRAP_MAX = 15
WRAP_BIAS = 16
_WRAP_MASK = 31
DELTA_MAX = 0xFFFE
_META_DELTA_MASK = 0xFFFF
_ACC_SHIFT = 16
_DEC_SHIFT = 21
_PROP_SHIFT = 26
_INT32_MIN = -(2 ** 31)

# kernel launches per entry point since the last reset (plain integers;
# a wrapper adds one exactly where it launches its kernel)
LAUNCHES = {
    "gp_step": 0, "gp_make_blob": 0,
    # group lifecycle (csrc/gp_lifecycle.cu, ops/lifecycle.py)
    "gp_create_groups": 0, "gp_kill_groups": 0, "gp_jump_rows": 0,
    "gp_restore_paused_rows": 0, "gp_restore_rows": 0, "gp_extract_rows": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class EngineConfig(NamedTuple):
    """Static engine shape (all python ints).

    ``window`` must be a power of two (lane residue is a bitmask);
    ``req_lanes`` must not exceed ``window`` (K consecutive admission
    candidates map to distinct ring lanes only while K <= W)."""

    n_groups: int          # G: group capacity (PINSTANCES_CAPACITY analog)
    window: int = 16       # W: in-flight slots per group (ring size)
    req_lanes: int = 8     # K: new client requests admitted per group per step
    n_replicas: int = 3    # R: replica-axis size (gather width)


class EngineState(NamedTuple):
    """Per-replica engine state; every leaf int32 of shape [G] or [G, W]."""

    # --- group metadata ---
    member_mask: torch.Tensor  # [G] bitmask of replica ids in the group (0 = inert)
    majority: torch.Tensor     # [G] popcount(member_mask)//2 + 1
    version: torch.Tensor      # [G] epoch number (reconfiguration)
    stopped: torch.Tensor      # [G] 1 after an epoch-final stop executed
    tag: torch.Tensor          # [G] instance identity (hash of name:epoch);
    #   rows are reused across instances, the blob ships the tag and
    #   step() ignores peers whose tag differs
    # --- acceptor (ref: PaxosAcceptor.java:82-103) ---
    bal: torch.Tensor          # [G] promised ballot (packed)
    exec_slot: torch.Tensor    # [G] first un-executed slot (frontier)
    acc_bal: torch.Tensor      # [G, W] accepted ballot per lane
    acc_vid: torch.Tensor      # [G, W] accepted value id
    acc_slot: torch.Tensor     # [G, W] absolute slot of the lane (NULL empty)
    # --- learner ---
    dec_vid: torch.Tensor      # [G, W] learned decision value
    dec_slot: torch.Tensor     # [G, W] learned decision slot (NULL empty)
    app_hash: torch.Tensor     # [G] device-side hash-chain of executed vids
    n_execd: torch.Tensor      # [G] total executed
    # --- coordinator (ref: PaxosCoordinatorState.java:68-143) ---
    c_phase: torch.Tensor      # [G] IDLE / PREPARING / ACTIVE
    c_bal: torch.Tensor        # [G] my coordinator ballot
    c_next_slot: torch.Tensor  # [G] next proposal slot to assign
    c_prop_vid: torch.Tensor   # [G, W] my outstanding proposals (value)
    c_prop_slot: torch.Tensor  # [G, W] my outstanding proposals (slot)


class Blob(NamedTuple):
    """What one replica publishes per step — the COMPACT exchange format.
    All leaves int32; the packed wire vector is a plain int32 ravel in
    this field order."""

    tag: torch.Tensor         # [G] sender's instance tag (cross-instance guard)
    bal: torch.Tensor         # [G] promised ballot (also the acc_bal anchor)
    exec_slot: torch.Tensor   # [G] frontier (also the slot-wrap anchor)
    coord: torch.Tensor       # [G] NULL when IDLE, c_bal when PREPARING,
    #   c_bal|INT32_MIN when ACTIVE (valid ballots are non-negative)
    acc_vid: torch.Tensor     # [G, W] accepted value (NULL when lane dropped)
    dec_vid: torch.Tensor     # [G, W] decided value (NULL when lane dropped)
    prop_vid: torch.Tensor    # [G, W] proposal value (NULL unless ACTIVE)
    lane_meta: torch.Tensor   # [G, W] packed wrap deltas + accepted-bal delta


class ExpandedBlob(NamedTuple):
    """A compact blob decoded back to absolute planes (tests/debugging)."""

    tag: torch.Tensor
    bal: torch.Tensor
    exec_slot: torch.Tensor
    acc_bal: torch.Tensor
    acc_vid: torch.Tensor
    acc_slot: torch.Tensor
    dec_vid: torch.Tensor
    dec_slot: torch.Tensor
    prep_bal: torch.Tensor
    prop_bal: torch.Tensor
    prop_vid: torch.Tensor
    prop_slot: torch.Tensor


class StepOutputs(NamedTuple):
    """Per-step results surfaced to the host."""

    n_committed: torch.Tensor   # [G] slots newly executed this step
    exec_base: torch.Tensor     # [G] frontier before this step's advance
    exec_vid: torch.Tensor      # [G, W] executed vids in slot order (NULL pad)
    n_admitted: torch.Tensor    # [G] client reqs consumed from req_vid lanes
    maj_exec: torch.Tensor      # [G] majority-rank execute frontier (GC mark)
    app_hash: torch.Tensor      # [G] post-step app hash (RSM invariant probe)
    acc_new: torch.Tensor       # [G, W] lanes newly accepted this step — the
    #   journal's log-before-send delta (AbstractPaxosLogger.logAndMessage)
    bal_new: torch.Tensor       # [G] 1 where the promised ballot rose this
    #   step — must be durable before the blob is published
    preempted_vid: torch.Tensor  # [G, W] my proposals that lost their slot
    #   to another value (host re-proposes them; NULL elsewhere)


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU.  With no card and no explicit device this raises: there is
    no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch engine on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _check_window(W: int) -> int:
    if W <= 0 or W & (W - 1):
        # hard error: a silent bitmask with a non-power-of-two W would map
        # slots to wrong ring lanes
        raise ValueError(f"window must be a power of two, got {W}")
    return W.bit_length() - 1


def init_state(cfg: EngineConfig, device=None) -> EngineState:
    """All groups inert (member_mask 0) — the MultiArrayMap-of-capacity
    analog.  Every leaf is its own tensor (no two leaves share storage)."""
    device = resolve_device(device)
    G, W = cfg.n_groups, cfg.window
    g = lambda fill: torch.full((G,), fill, dtype=_I32, device=device)
    gw = lambda fill: torch.full((G, W), fill, dtype=_I32, device=device)
    return EngineState(
        member_mask=g(0), majority=g(_BIG), version=g(0), stopped=g(0),
        tag=g(0),
        bal=g(NULL), exec_slot=g(0),
        acc_bal=gw(NULL), acc_vid=gw(NULL), acc_slot=gw(NULL),
        dec_vid=gw(NULL), dec_slot=gw(NULL),
        app_hash=g(0), n_execd=g(0),
        c_phase=g(IDLE), c_bal=g(NULL), c_next_slot=g(0),
        c_prop_vid=gw(NULL), c_prop_slot=gw(NULL),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions (op-for-op transcriptions of the reference)
# ---------------------------------------------------------------------------


def make_blob_plain(state: EngineState) -> Blob:
    """Atomic COMPACT snapshot of what peers need; masked by coordinator
    phase, anchored to this replica's ``exec_slot``/``bal``.  Works on a
    single ``[G, ...]`` state and on stacked ``[R, G, ...]`` states."""
    W = state.acc_bal.shape[-1]
    kbits = _check_window(W)
    ebase = (state.exec_slot >> kbits)[..., None]

    def wrap_enc(slot):
        c = (slot >> kbits) - ebase
        ok = (slot != NULL) & (c >= -WRAP_MAX) & (c <= WRAP_MAX)
        return ok, torch.where(ok, c + WRAP_BIAS, 0)

    acc_in, acc_w = wrap_enc(state.acc_slot)
    delta = state.bal[..., None] - state.acc_bal
    acc_ok = acc_in & (state.acc_bal != NULL) & (delta >= 0) & (delta <= DELTA_MAX)
    acc_w = torch.where(acc_ok, acc_w, 0)
    acc_d = torch.where(acc_ok, delta + 1, 0)
    dec_ok, dec_w = wrap_enc(state.dec_slot)
    preparing = state.c_phase == PREPARING
    active = state.c_phase == ACTIVE
    prop_ok, prop_w = wrap_enc(
        torch.where(active[..., None], state.c_prop_slot, NULL)
    )
    meta = (
        acc_d
        | (acc_w << _ACC_SHIFT)
        | (dec_w << _DEC_SHIFT)
        | (prop_w << _PROP_SHIFT)
    )
    coord = torch.where(
        preparing, state.c_bal,
        torch.where(active, state.c_bal | _INT32_MIN, NULL),
    )
    return Blob(
        tag=state.tag.clone(),
        bal=state.bal.clone(),
        exec_slot=state.exec_slot.clone(),
        coord=coord,
        acc_vid=torch.where(acc_ok, state.acc_vid, NULL),
        dec_vid=torch.where(dec_ok, state.dec_vid, NULL),
        prop_vid=torch.where(prop_ok, state.c_prop_vid, NULL),
        lane_meta=meta,
    )


def _decode_coord(coord):
    """coord word -> (prep_bal, prop_bal), NULL where not applicable."""
    prep_bal = torch.where(coord >= 0, coord, NULL)
    is_active = (coord < 0) & (coord != NULL)
    prop_bal = torch.where(is_active, coord & 0x7FFFFFFF, NULL)
    return prep_bal, prop_bal


def _decode_lanes(meta, bal, exec_slot, lanes, kbits):
    """One sender's lane planes from its meta + [..] anchors.

    Returns (acc_bal, acc_slot, dec_slot, prop_slot), each ``[..., W]``
    with NULL for empty/dropped lanes."""
    d = meta & _META_DELTA_MASK
    aw = (meta >> _ACC_SHIFT) & _WRAP_MASK
    dw = (meta >> _DEC_SHIFT) & _WRAP_MASK
    pw = (meta >> _PROP_SHIFT) & _WRAP_MASK
    ebase = (exec_slot >> kbits)[..., None]

    def wrap_dec(w):
        s = ((ebase + (w - WRAP_BIAS)) << kbits) | lanes
        return torch.where(w != 0, s, NULL)

    acc_bal = torch.where(d != 0, bal[..., None] - (d - 1), NULL)
    return acc_bal, wrap_dec(aw), wrap_dec(dw), wrap_dec(pw)


def expand_blob(blob: Blob) -> ExpandedBlob:
    """Decode a compact blob (single [G, ...] or batched [R, G, ...]) back
    to the absolute-plane view (plain PyTorch on any device)."""
    W = blob.lane_meta.shape[-1]
    kbits = W.bit_length() - 1
    lanes = torch.arange(W, dtype=_I32, device=blob.lane_meta.device)
    acc_bal, acc_slot, dec_slot, prop_slot = _decode_lanes(
        blob.lane_meta, blob.bal, blob.exec_slot, lanes, kbits
    )
    prep_bal, prop_bal = _decode_coord(blob.coord)
    return ExpandedBlob(
        tag=blob.tag, bal=blob.bal, exec_slot=blob.exec_slot,
        acc_bal=acc_bal, acc_vid=blob.acc_vid, acc_slot=acc_slot,
        dec_vid=blob.dec_vid, dec_slot=dec_slot,
        prep_bal=prep_bal, prop_bal=prop_bal,
        prop_vid=blob.prop_vid, prop_slot=prop_slot,
    )


def _mix(h, vid):
    """Deterministic app-hash fold (int32 wraparound)."""
    return (h * 31 + vid) ^ (vid << 7)


def _check_shape(cfg: EngineConfig) -> int:
    kbits = _check_window(cfg.window)
    if cfg.req_lanes > cfg.window:
        # K consecutive admission candidates must map to distinct ring
        # lanes; beyond W they collide and placements would overwrite
        raise ValueError(
            f"req_lanes ({cfg.req_lanes}) must not exceed window "
            f"({cfg.window})"
        )
    return kbits


def step_plain(
    state: EngineState,
    g: Blob,                   # gathered COMPACT blobs, leaves with leading [R]
    heard: torch.Tensor,       # [R] bool — which peers' blobs are live
    req_vid: torch.Tensor,     # [G, K] new request value-ids (left-packed, NULL pad)
    want_coord: torch.Tensor,  # [G] bool — host FD election trigger
    my_id,                     # python int (replica-axis index)
    cfg: EngineConfig,
):
    """One vectorized consensus step for all G groups, op for op as the
    reference's ``ops/engine.py:step``.  Pure: returns a NEW
    (state', StepOutputs) whose tensors are all freshly allocated.

    The caller journals the accepted-window delta of state' *before*
    publishing blob(state') — the reference's log-before-send rule
    (``AbstractPaxosLogger.logAndMessage``, ``AbstractPaxosLogger.java:157``).
    """
    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    kbits = _check_shape(cfg)
    dev = state.bal.device
    my_id = int(my_id)
    heard = heard.to(device=dev, dtype=torch.bool)
    want_coord = want_coord.to(device=dev, dtype=torch.bool)
    req_vid = req_vid.to(device=dev, dtype=_I32)
    rids = torch.arange(R, dtype=_I32, device=dev)
    lanes = torch.arange(W, dtype=_I32, device=dev)
    lane_of = lambda s: s & (W - 1)  # slot -> ring lane (W = 2^k)

    # [R, G] — valid senders per group: heard, a member, same instance
    in_group = ((state.member_mask[None, :] >> rids[:, None]) & 1) == 1
    same_inst = g.tag == state.tag[None, :]
    live = heard[:, None] & in_group & same_inst

    inert = state.member_mask == 0
    maj = state.majority
    i_member = ((state.member_mask >> my_id) & 1) == 1

    # ---- 1. promise update (handlePrepare / acceptAndUpdateBallot) ----
    prep_bal_g, prop_bal_g = _decode_coord(g.coord)       # [R, G]
    in_prep = torch.where(live, prep_bal_g, NULL)
    in_prop = torch.where(live, prop_bal_g, NULL)
    max_prop = in_prop.amax(dim=0)                        # [G]
    new_bal = torch.maximum(
        state.bal, torch.maximum(in_prep.amax(dim=0), max_prop)
    )

    exec2 = state.exec_slot[:, None]

    # ---- 2+3. the peer fold: accept-winner select, learn, decision-ring
    # merge — one sequential pass over the R gathered rows with [G, W]
    # carries, decoding one peer's compact lane planes per iteration.
    win_row = (in_prop == max_prop[None, :]) & (max_prop[None, :] != NULL)

    def _decode_row(r):
        return _decode_lanes(
            g.lane_meta[r], g.bal[r], g.exec_slot[r], lanes, kbits
        )

    nullw = torch.full((G, W), NULL, dtype=_I32, device=dev)
    p_slot = p_vid = s_c = b_c = det_vid = c1_v = nullw
    n_match = torch.zeros((G, W), dtype=_I32, device=dev)
    c1_s = torch.full((G, W), _BIG, dtype=_I32, device=dev)
    for r in range(R):
        a_bal, a_slot, d_slot, pr_slot = _decode_row(r)
        a_vid = g.acc_vid[r]
        d_vid = g.dec_vid[r]
        pr_vid = g.prop_vid[r]
        live_r = live[r][:, None]
        # accept winner: adopt the max-prop row's proposal window
        w_r = win_row[r][:, None]
        p_slot = torch.maximum(p_slot, torch.where(w_r, pr_slot, NULL))
        p_vid = torch.maximum(p_vid, torch.where(w_r, pr_vid, NULL))
        # learn: running lexicographic (slot, ballot) max per lane with a
        # count of rows matching the current max
        ok = live_r & (a_slot != NULL)
        s_r = torch.where(ok, a_slot, NULL)
        b_r = torch.where(ok, a_bal, NULL)
        better = ok & ((s_r > s_c) | ((s_r == s_c) & (b_r > b_c)))
        same = ok & (s_r == s_c) & (b_r == b_c)
        n_match = torch.where(better, 1, n_match + same.to(_I32))
        s_c = torch.where(better, s_r, s_c)
        b_c = torch.where(better, b_r, b_c)
        det_vid = torch.where(better, a_vid, det_vid)
        # decision-ring merge: keep the SMALLEST needed decided slot >= my
        # frontier (rows at the min slot decided the SAME slot => same value)
        okd = live_r & (d_slot != NULL) & (d_slot >= exec2)
        lower = okd & (d_slot < c1_s)
        c1_s = torch.where(lower, d_slot, c1_s)
        c1_v = torch.where(lower, d_vid, c1_v)
    detected = (n_match >= maj[:, None]) & (s_c != NULL)

    # ---- 2. accept (handleAccept, PaxosAcceptor.acceptAndUpdateBallot) ----
    acc_ok = (max_prop == new_bal) & (max_prop != NULL) & (state.stopped == 0)
    in_win = (p_slot >= exec2) & (p_slot < exec2 + W) & (p_vid != NULL)
    do_acc = acc_ok[:, None] & in_win
    acc_bal = torch.where(do_acc, max_prop[:, None], state.acc_bal)
    acc_vid = torch.where(do_acc, p_vid, state.acc_vid)
    acc_slot = torch.where(do_acc, p_slot, state.acc_slot)
    acc_changed = do_acc & (
        (acc_bal != state.acc_bal) | (acc_vid != state.acc_vid)
        | (acc_slot != state.acc_slot)
    )

    # ---- 3. learn (the BatchedAcceptReply->DECISION collapse) ----
    def cand(slot, vid, valid):
        ok = valid & (slot != NULL) & (slot >= exec2)
        return torch.where(ok, slot, _BIG), vid

    c0_s, c0_v = cand(state.dec_slot, state.dec_vid, True)
    c2_s, c2_v = cand(s_c, det_vid, detected)
    best = torch.minimum(torch.minimum(c0_s, c1_s), c2_s)
    have = best < _BIG
    dec_vid = torch.where(
        have,
        torch.where(best == c0_s, c0_v, torch.where(best == c1_s, c1_v, c2_v)),
        state.dec_vid,
    )
    dec_slot = torch.where(have, best, state.dec_slot)

    # ---- 4. execute: advance the in-order frontier (EEC analog,
    # PaxosInstanceStateMachine.extractExecuteAndCheckpoint:1511-1593) ----
    h = state.app_hash
    n_execd = state.n_execd
    stop_seen = torch.zeros((G,), dtype=torch.bool, device=dev)
    run_prev = torch.ones((G,), dtype=torch.bool, device=dev)
    n_adv = torch.zeros((G,), dtype=_I32, device=dev)
    run_cols = []
    vid_cols = []
    for o in range(W):
        slot_o = state.exec_slot + o
        eq = dec_slot == slot_o[:, None]                   # [G, W]
        hit = eq.any(dim=1)
        vid_o = torch.where(eq, dec_vid, NULL).amax(dim=1)  # [G]
        take = run_prev & hit
        real = take & (vid_o > 0)
        h = torch.where(real, _mix(h, vid_o), h)
        n_execd = n_execd + real.to(_I32)
        stop_seen = stop_seen | (take & ((vid_o & STOP_BIT) != 0))
        n_adv = n_adv + take.to(_I32)
        run_cols.append(take)
        vid_cols.append(vid_o)
        run_prev = take
    exec_new = state.exec_slot + n_adv
    run = torch.stack(run_cols, dim=1)                     # [G, W] bool
    d_vid_at = torch.stack(vid_cols, dim=1)                # [G, W]
    stopped = torch.maximum(state.stopped, stop_seen.to(_I32))

    # Majority-rank execute frontier (medianCheckpointedSlot analog):
    # v is the maj-th largest iff #{rows >= v} >= maj.
    ge = torch.where(live, g.exec_slot, NULL)
    rank = (ge[:, None, :] <= ge[None, :, :]).sum(dim=1).to(_I32)  # [R, G]
    maj_exec = torch.where(rank >= maj[None, :], ge, NULL).amax(dim=0)
    maj_exec = torch.clamp(maj_exec, min=0)

    # ---- 5. coordinator ----
    me_coord = state.c_bal
    phase = state.c_phase
    # preempted by a strictly higher ballot (PaxosInstanceStateMachine
    # .java:955-965)
    preempt = (phase != IDLE) & (new_bal > me_coord)
    phase = torch.where(preempt, IDLE, phase)

    # Election start (checkRunForCoordinator, :1962-2072): host FD says
    # go, OR the promise ballot names ME as coordinator while I hold no
    # coordinator state (crash-recovery eligibility clause, :1992-2006).
    orphaned = ((new_bal & COORD_MASK) == my_id) & (new_bal != NULL)
    start = (want_coord | orphaned) & (phase == IDLE) & (~inert) & (stopped == 0)
    start_bal = encode_ballot(ballot_num(new_bal) + 1, my_id)
    c_bal = torch.where(start, start_bal, me_coord)
    phase = torch.where(start, PREPARING, phase)
    new_bal = torch.where(
        phase == PREPARING, torch.maximum(new_bal, c_bal), new_bal
    )

    # Prepare quorum: peers whose published promise equals my ballot, +1 self.
    not_me = rids != my_id
    promised = (g.bal == c_bal[None, :]) & live & not_me[:, None]
    n_promise = promised.sum(dim=0).to(_I32) + 1
    quorum = (phase == PREPARING) & (n_promise >= maj)

    # Carryover: lane-wise lexicographic (slot, ballot) max over
    # promisers' snapshots, then my own post-accept window.
    co_slot = co_bal = co_vid = nullw
    for r in range(R):
        a_bal, a_slot, _d, _p = _decode_row(r)
        a_vid = g.acc_vid[r]
        ok = promised[r][:, None] & (a_slot != NULL) & (a_slot >= exec2)
        better = ok & ((a_slot > co_slot) | ((a_slot == co_slot) & (a_bal > co_bal)))
        co_slot = torch.where(better, a_slot, co_slot)
        co_bal = torch.where(better, a_bal, co_bal)
        co_vid = torch.where(better, a_vid, co_vid)
    my_ok = (acc_slot != NULL) & (acc_slot >= exec2)
    mine = my_ok & ((acc_slot > co_slot) | ((acc_slot == co_slot) & (acc_bal > co_bal)))
    co_slot = torch.where(mine, acc_slot, co_slot)
    co_bal = torch.where(mine, acc_bal, co_bal)
    co_vid = torch.where(mine, acc_vid, co_vid)
    co_has = co_slot != NULL

    won = quorum
    phase = torch.where(won, ACTIVE, phase)
    # Never invent proposals below the promise set's max frontier.
    prom_exec = torch.where(promised, g.exec_slot, NULL).amax(dim=0)
    floor = torch.maximum(exec_new, prom_exec)

    won2 = won[:, None]
    c_prop_vid = torch.where(
        won2, torch.where(co_has, co_vid, NULL), state.c_prop_vid
    )
    c_prop_slot = torch.where(
        won2, torch.where(co_has, co_slot, NULL), state.c_prop_slot
    )
    max_co_slot = co_slot.amax(dim=1)
    next_on_win = torch.maximum(floor, max_co_slot + 1)
    c_next = torch.where(won, next_on_win, state.c_next_slot)

    # Hole-filling no-ops in [floor, next) with no carryover.
    exp_slot = exec_new[:, None] + lane_of(lanes[None, :] - exec_new[:, None])
    hole = (
        won2 & (exp_slot >= floor[:, None]) & (exp_slot < c_next[:, None])
        & (c_prop_slot != exp_slot) & (dec_slot != exp_slot)
    )
    c_prop_vid = torch.where(hole, NOOP_VID, c_prop_vid)
    c_prop_slot = torch.where(hole, exp_slot, c_prop_slot)

    # Retire learned / below-frontier proposals; a retired lane whose
    # decided value differs from my proposal was PREEMPTED.
    is_active = phase == ACTIVE
    dec_at_prop = dec_slot == c_prop_slot
    retire = (c_prop_slot != NULL) & (dec_at_prop | (c_prop_slot < exec2))
    preempted_vid = torch.where(
        retire & (dec_vid != c_prop_vid) & (c_prop_vid > 0), c_prop_vid, NULL
    )
    c_prop_vid = torch.where(retire, NULL, c_prop_vid)
    c_prop_slot = torch.where(retire, NULL, c_prop_slot)

    # Stop-request ordering (proposeStop, PaxosManager.java:1269-1390).
    stopping = ((c_prop_vid != NULL) & ((c_prop_vid & STOP_BIT) != 0)).any(dim=1)
    dec_stop = (
        (dec_slot != NULL) & (dec_slot >= exec2) & ((dec_vid & STOP_BIT) != 0)
    ).any(dim=1)
    may_admit = is_active & (stopped == 0) & (~stopping) & (~dec_stop)
    req_stop = (req_vid != NULL) & ((req_vid & STOP_BIT) != 0)
    no_stop_before = torch.cumprod(1 - req_stop.to(_I32), dim=1).to(_I32)
    no_stop_before = torch.cat(
        [torch.ones((G, 1), dtype=_I32, device=dev), no_stop_before[:, :-1]],
        dim=1,
    )

    # Admit new client requests: consecutive slots from c_next, bounded by
    # the majority window and free lanes (contiguous prefix).
    c_next = torch.where(is_active, torch.maximum(c_next, exec_new), c_next)
    bound = maj_exec + W
    adm_prev = torch.ones((G,), dtype=torch.bool, device=dev)
    n_admit = torch.zeros((G,), dtype=_I32, device=dev)
    for k in range(K):
        cand_slot = c_next + k
        oh = lane_of(cand_slot)[:, None] == lanes[None, :]  # [G, W]
        lane_busy = (oh & (c_prop_slot != NULL)).any(dim=1)
        dec_at_cand = torch.where(oh, dec_slot, NULL).amax(dim=1)
        can = (
            may_admit & (no_stop_before[:, k] > 0)
            & (req_vid[:, k] != NULL) & (cand_slot < bound)
            & (~lane_busy)
            & (dec_at_cand != cand_slot)  # never re-propose a decided slot
        )
        adm = adm_prev & can
        place = oh & adm[:, None]
        c_prop_vid = torch.where(place, req_vid[:, k][:, None], c_prop_vid)
        c_prop_slot = torch.where(place, cand_slot[:, None], c_prop_slot)
        n_admit = n_admit + adm.to(_I32)
        adm_prev = adm
    c_next = c_next + n_admit

    new_state = EngineState(
        member_mask=state.member_mask, majority=state.majority,
        version=state.version, stopped=stopped, tag=state.tag,
        bal=new_bal, exec_slot=exec_new,
        acc_bal=acc_bal, acc_vid=acc_vid, acc_slot=acc_slot,
        dec_vid=dec_vid, dec_slot=dec_slot,
        app_hash=h, n_execd=n_execd,
        c_phase=phase, c_bal=c_bal, c_next_slot=c_next,
        c_prop_vid=c_prop_vid, c_prop_slot=c_prop_slot,
    )
    # Non-member rows stay frozen (and report nothing).  torch.where
    # allocates, so no leaf of state' aliases a leaf of the input.
    m1 = i_member
    m2 = i_member[:, None]
    keep = lambda new, old: torch.where(m1 if new.dim() == 1 else m2, new, old)
    new_state = EngineState(*(keep(n, o) for n, o in zip(new_state, state)))
    outputs = StepOutputs(
        n_committed=torch.where(m1, n_adv, 0),
        exec_base=state.exec_slot.clone(),
        exec_vid=torch.where(m2 & run, d_vid_at, NULL),
        n_admitted=torch.where(m1, n_admit, 0),
        maj_exec=torch.where(m1, maj_exec, 0),
        app_hash=new_state.app_hash.clone(),
        acc_new=(m2 & acc_changed).to(_I32),
        bal_new=(new_state.bal != state.bal).to(_I32),
        preempted_vid=torch.where(m2, preempted_vid, NULL),
    )
    return new_state, outputs


# ---------------------------------------------------------------------------
# Packed host-exchange interface.
#
# Each direction moves as ONE int32 vector: the gathered peer blobs as a
# single [R, NB] matrix, the step's outputs as one [M] vector and the
# fresh publish blob as one [NB] vector.  The blob vector layout equals
# the ``D`` wire frame body (Blob._fields order, C-order ravel), so a
# received frame's payload IS the packed row, byte for byte.
# ---------------------------------------------------------------------------

# [G]-shaped leaves across Blob and StepOutputs (everything else is [G, W])
_G_LEAVES = frozenset((
    "tag", "bal", "exec_slot", "coord",
    "n_committed", "exec_base", "n_admitted", "maj_exec", "app_hash",
    "bal_new",
))


def _leaf_shapes(fields, cfg: EngineConfig):
    G, W = cfg.n_groups, cfg.window
    return [
        (name, (G,) if name in _G_LEAVES else (G, W)) for name in fields
    ]


@functools.lru_cache(maxsize=None)
def blob_vec_len(cfg: EngineConfig) -> int:
    # memoized: the codec consults it on every received frame
    return sum(
        int(np.prod(s)) for _n, s in _leaf_shapes(Blob._fields, cfg)
    )


@functools.lru_cache(maxsize=None)
def out_vec_len(cfg: EngineConfig) -> int:
    return sum(
        int(np.prod(s)) for _n, s in _leaf_shapes(StepOutputs._fields, cfg)
    )


def pack_blob(blob: Blob) -> torch.Tensor:
    """[NB] vector in Blob._fields order (== wire frame body)."""
    return torch.cat([leaf.reshape(-1) for leaf in blob])


def pack_rows(blob: Blob) -> torch.Tensor:
    """Blob of [R, ...] leaves -> [R, NB] packed rows (each row equal to
    pack_blob of that replica's blob)."""
    return torch.cat([x.reshape(x.shape[0], -1) for x in blob], dim=1)


def pack_out(out: StepOutputs) -> torch.Tensor:
    """[M] vector in StepOutputs._fields order."""
    return torch.cat([leaf.reshape(-1) for leaf in out])


def _unpack(vec, fields, cfg: EngineConfig, cls, batched: bool):
    leaves = []
    off = 0
    for name, shape in _leaf_shapes(fields, cfg):
        n = int(np.prod(shape))
        chunk = vec[..., off:off + n]
        off += n
        full = (vec.shape[0],) + shape if batched else shape
        leaves.append(chunk.reshape(full))
    return cls(*leaves)


def unpack_gathered(gvec: torch.Tensor, cfg: EngineConfig) -> Blob:
    """[R, NB] packed peer blobs -> Blob of [R, ...] leaves (views)."""
    return _unpack(gvec, Blob._fields, cfg, Blob, batched=True)


def unpack_out(vec: torch.Tensor, cfg: EngineConfig) -> StepOutputs:
    """[M] (or [R, M]) out vector -> StepOutputs of views."""
    return _unpack(vec, StepOutputs._fields, cfg, StepOutputs,
                   batched=vec.dim() == 2)


def unpack_blob(vec: torch.Tensor, cfg: EngineConfig) -> Blob:
    """[NB] (or [R, NB]) blob vector -> Blob of views."""
    return _unpack(vec, Blob._fields, cfg, Blob, batched=vec.dim() == 2)


def split_out_vec(vec: np.ndarray, cfg: EngineConfig) -> StepOutputs:
    """Host-side: one transferred [M] vector -> StepOutputs of np views."""
    return _unpack(
        np.asarray(vec), StepOutputs._fields, cfg, StepOutputs, batched=False
    )


def split_blob_vec(vec: np.ndarray, cfg: EngineConfig) -> Blob:
    return _unpack(np.asarray(vec), Blob._fields, cfg, Blob, batched=False)


def to_host(t) -> np.ndarray:
    """A PRIVATE host copy of a tensor (or array): never a view sharing
    memory with a tensor that a later step may overwrite in place."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


def _cfg_of(state: EngineState, n_replicas: int, req_lanes: int) -> EngineConfig:
    G, W = state.acc_bal.shape[-2:]
    return EngineConfig(int(G), int(W), int(req_lanes), int(n_replicas))


# ---------------------------------------------------------------------------
# dispatching entry points: plain version on CPU tensors, kernel on CUDA
# ---------------------------------------------------------------------------


def on_card(t: torch.Tensor) -> bool:
    """The one dispatch predicate: kernels for CUDA tensors, the plain
    version for CPU ones."""
    return t.is_cuda


def make_blob(state: EngineState) -> Blob:
    """COMPACT publish snapshot.  CPU tensors: the plain version.  CUDA
    tensors: the ``gp_make_blob`` kernel (leaves are views of its [NB]
    output vector)."""
    if not on_card(state.bal):
        return make_blob_plain(state)
    cfg = _cfg_of(state, 1, 1)
    return unpack_blob(make_blob_vec(state), cfg)


def make_blob_vec(state: EngineState,
                  launch_log: Optional[dict] = None) -> torch.Tensor:
    """[NB] packed publish vector of one replica's state (Blob._fields
    order, == the ``D`` frame body).  CUDA: the ``gp_make_blob`` kernel
    (``launch_log``: an optional per-caller launch counter)."""
    if not on_card(state.bal):
        return pack_blob(make_blob_plain(state))
    from . import gp_kernels

    return gp_kernels.make_blob_vec(state, launch_log)


def step(state: EngineState, g, heard, req_vid, want_coord, my_id,
         cfg: EngineConfig):
    """One consensus step: returns a new (state', StepOutputs).

    ``g`` is the gathered Blob of [R, ...] leaves or the packed [R, NB]
    matrix.  CPU tensors run :func:`step_plain`; CUDA tensors launch the
    ``gp_step`` kernel (or raise)."""
    if not on_card(state.bal):
        if isinstance(g, torch.Tensor):
            g = unpack_gathered(g, cfg)
        return step_plain(state, g, heard, req_vid, want_coord, my_id, cfg)
    from . import gp_kernels

    gvec = g if isinstance(g, torch.Tensor) else pack_rows(g)
    new_state, out_vec, _blob, _heat = gp_kernels.step(
        state, gvec, heard, req_vid, want_coord, int(my_id), cfg,
        with_blob=False,
    )
    return new_state, unpack_out(out_vec, cfg)


def step_host(state: EngineState, gvec, heard, req_vid, want_coord, my_id,
              *, cfg: EngineConfig):
    """One step over packed I/O: returns (state', out_vec [M], blob_vec
    [NB]).  On CUDA this is ONE ``gp_step`` launch (step + make_blob +
    pack_blob fused)."""
    if not on_card(state.bal):
        g = unpack_gathered(gvec, cfg)
        new_state, out = step_plain(
            state, g, heard, req_vid, want_coord, my_id, cfg
        )
        return new_state, pack_out(out), pack_blob(make_blob_plain(new_state))
    from . import gp_kernels

    new_state, out_vec, blob_vec, _heat = gp_kernels.step(
        state, gvec, heard, req_vid, want_coord, int(my_id), cfg,
        with_blob=True,
    )
    return new_state, out_vec, blob_vec
