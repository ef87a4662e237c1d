"""Group lifecycle tensor ops: batched create / kill / jump / pause-extract
/ restore.

The reference creates one ``PaxosInstanceStateMachine`` object per group
(``PaxosManager.createPaxosInstance``, ``PaxosManager.java:611-810``) and
pauses idle ones to disk via ``HotRestoreInfo`` (``paxosutil/
HotRestoreInfo.java:31-60``, ``PaxosManager.java:2264-2392``).  Here a
group is a *row* of the engine tensors, so create/kill/pause are batched
row scatters / gathers on :class:`~gigapaxos_tpu_torch.ops.engine.EngineState`.

Every op is out of place: it returns a NEW state whose touched leaves are
fresh tensors (untouched leaves are shared with the input), so a caller
holding the old state (the manager's host cache keys on state identity)
never sees it change.

Two implementations of every op live here, as in :mod:`.engine`:

* the **plain** version (``*_plain``): PyTorch indexing, the CPU path and
  the yardstick the kernel is held against;
* the **kernel** (``csrc/gp_lifecycle.cu``, bound in :mod:`.gp_kernels`):
  a copy pass over the touched leaves and a row pass over the batch.

The public functions dispatch: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.  On the kernel path the row batch
must be unique and in range (the manager never passes anything else).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ballot import NULL, encode_ballot
from . import engine as _engine
from .engine import ACTIVE, IDLE, EngineState

_I32 = torch.int32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount over the full 32-bit replica-id space (arithmetic >> keeps
    bit 31 correct for int32)."""
    c = torch.zeros_like(x)
    for b in range(32):
        c = c + ((x >> b) & 1)
    return c


def initial_coordinator(idx: np.ndarray, member_mask: np.ndarray) -> np.ndarray:
    """Deterministic initial coordinator: round-robin by group index over
    the member set (the ``roundRobinCoordinator`` rule,
    ``PaxosInstanceStateMachine.java:2123``).  Pure numpy (host side)."""
    idx = np.asarray(idx)
    member_mask = np.asarray(member_mask)
    out = np.zeros_like(idx)
    for row, (g, mask) in enumerate(zip(idx, member_mask)):
        members = [r for r in range(32) if (int(mask) >> r) & 1]
        out[row] = members[int(g) % len(members)] if members else 0
    return out


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """Host or device values -> int32 tensor on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=_I32)
    return torch.as_tensor(np.asarray(x), dtype=_I32, device=like.device)


def _idx(idx, like: torch.Tensor) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=like.device, dtype=torch.long)
    return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                           device=like.device)


def _set(leaf: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``leaf.at[idx].set(val)``: a fresh tensor with rows ``idx`` replaced."""
    out = leaf.clone()
    out[idx] = val
    return out


def create_groups_plain(
    state: EngineState,
    idx,                 # [N] group indices to (re)create
    member_mask,         # [N] replica-id bitmasks
    coord0,              # [N] initial coordinator replica id
    my_id: int,
    version=0,
    tag=0,
) -> EngineState:
    """Batched group creation.  All replicas run this identically, so the
    initial ballot (0, coord0) is implicitly promised everywhere — the
    initial coordinator starts ACTIVE with no prepare phase, matching the
    reference's initial-ballot shortcut."""
    like = state.bal
    idx = _idx(idx, like)
    member_mask = _t(member_mask, like)
    coord0 = _t(coord0, like)
    n = idx.shape[0]
    version = torch.broadcast_to(_t(version, like), (n,))
    tag = torch.broadcast_to(_t(tag, like), (n,))
    bal0 = encode_ballot(torch.zeros((n,), dtype=_I32, device=like.device),
                         coord0)
    i_am_coord = coord0 == int(my_id)
    W = state.acc_bal.shape[1]
    nullw = torch.full((n, W), NULL, dtype=_I32, device=like.device)
    zeros = torch.zeros((n,), dtype=_I32, device=like.device)
    return state._replace(
        member_mask=_set(state.member_mask, idx, member_mask),
        majority=_set(state.majority, idx, _popcount32(member_mask) // 2 + 1),
        version=_set(state.version, idx, version),
        stopped=_set(state.stopped, idx, 0),
        tag=_set(state.tag, idx, tag),
        bal=_set(state.bal, idx, bal0),
        exec_slot=_set(state.exec_slot, idx, 0),
        acc_bal=_set(state.acc_bal, idx, nullw),
        acc_vid=_set(state.acc_vid, idx, nullw),
        acc_slot=_set(state.acc_slot, idx, nullw),
        dec_vid=_set(state.dec_vid, idx, nullw),
        dec_slot=_set(state.dec_slot, idx, nullw),
        app_hash=_set(state.app_hash, idx, 0),
        n_execd=_set(state.n_execd, idx, 0),
        c_phase=_set(
            state.c_phase, idx,
            torch.where(i_am_coord, ACTIVE, IDLE).to(_I32),
        ),
        c_bal=_set(state.c_bal, idx, torch.where(i_am_coord, bal0, NULL)),
        c_next_slot=_set(state.c_next_slot, idx, zeros),
        c_prop_vid=_set(state.c_prop_vid, idx, nullw),
        c_prop_slot=_set(state.c_prop_slot, idx, nullw),
    )


def kill_groups_plain(state: EngineState, idx) -> EngineState:
    """Batched kill: rows become inert (the Cremator analog,
    ``PaxosManager.java:2142-2205``)."""
    idx = _idx(idx, state.bal)
    return state._replace(
        member_mask=_set(state.member_mask, idx, 0),
        majority=_set(state.majority, idx, 2 ** 30),
        stopped=_set(state.stopped, idx, 0),
        tag=_set(state.tag, idx, 0),
        bal=_set(state.bal, idx, NULL),
        c_phase=_set(state.c_phase, idx, IDLE),
        c_bal=_set(state.c_bal, idx, NULL),
    )


def jump_rows_plain(
    state: EngineState,
    idx,        # [N] rows to jump
    exec_slot,  # [N] donor's executed frontier
    bal,        # [N] donor's promised ballot
    app_hash,   # [N] donor's device hash chain at that frontier
    n_execd,    # [N]
    stopped,    # [N]
) -> EngineState:
    """Checkpoint-transfer jump (``PaxosAcceptor.jumpSlot``,
    ``PaxosAcceptor.java:538``): a straggler adopts a donor's frontier.
    Window lanes clear only BELOW the new frontier; lanes at/above it keep
    (they may hold this replica's live accepted votes), which makes the
    jump safe at ANY gap size."""
    like = state.bal
    idx = _idx(idx, like)
    n = idx.shape[0]
    W = state.acc_bal.shape[1]
    nullw = torch.full((n, W), NULL, dtype=_I32, device=like.device)
    new_exec = _t(exec_slot, like)
    acc_keep = (state.acc_slot[idx] != NULL) & (
        state.acc_slot[idx] >= new_exec[:, None]
    )
    dec_keep = (state.dec_slot[idx] != NULL) & (
        state.dec_slot[idx] >= new_exec[:, None]
    )
    keepw = lambda keep, leaf: torch.where(keep, leaf[idx], nullw)
    return state._replace(
        bal=_set(state.bal, idx, torch.maximum(state.bal[idx], _t(bal, like))),
        exec_slot=_set(state.exec_slot, idx, new_exec),
        acc_bal=_set(state.acc_bal, idx, keepw(acc_keep, state.acc_bal)),
        acc_vid=_set(state.acc_vid, idx, keepw(acc_keep, state.acc_vid)),
        acc_slot=_set(state.acc_slot, idx, keepw(acc_keep, state.acc_slot)),
        dec_vid=_set(state.dec_vid, idx, keepw(dec_keep, state.dec_vid)),
        dec_slot=_set(state.dec_slot, idx, keepw(dec_keep, state.dec_slot)),
        app_hash=_set(state.app_hash, idx, _t(app_hash, like)),
        n_execd=_set(state.n_execd, idx, _t(n_execd, like)),
        stopped=_set(state.stopped, idx, _t(stopped, like)),
        c_phase=_set(state.c_phase, idx, IDLE),
        c_bal=_set(state.c_bal, idx, NULL),
        c_next_slot=_set(state.c_next_slot, idx, _t(exec_slot, like)),
        c_prop_vid=_set(state.c_prop_vid, idx, nullw),
        c_prop_slot=_set(state.c_prop_slot, idx, nullw),
    )


def restore_paused_rows_plain(
    state: EngineState,
    idx,        # [N] rows JUST created by create_groups
    exec_slot,  # [N] record frontier
    bal,        # [N] host-computed max(initial ballot, record)
    app_hash,   # [N]
    n_execd,    # [N]
    acc_bal,    # [N, W] window remnants (NULL where empty)
    acc_vid,    # [N, W]
    acc_slot,   # [N, W]
    dec_vid,    # [N, W]
    dec_slot,   # [N, W]
) -> EngineState:
    """Batched unpause: scatter N pause records' consensus remnants over
    freshly created rows — one row scatter per touched leaf.  The rows
    must come straight from :func:`create_groups`; the caller computes
    ``bal`` host-side as ``max(bal0, rec.bal)``."""
    like = state.bal
    idx = _idx(idx, like)
    as32 = lambda a: _t(a, like)
    return state._replace(
        exec_slot=_set(state.exec_slot, idx, as32(exec_slot)),
        bal=_set(state.bal, idx, as32(bal)),
        app_hash=_set(state.app_hash, idx, as32(app_hash)),
        n_execd=_set(state.n_execd, idx, as32(n_execd)),
        c_next_slot=_set(state.c_next_slot, idx, as32(exec_slot)),
        acc_bal=_set(state.acc_bal, idx, as32(acc_bal)),
        acc_vid=_set(state.acc_vid, idx, as32(acc_vid)),
        acc_slot=_set(state.acc_slot, idx, as32(acc_slot)),
        dec_vid=_set(state.dec_vid, idx, as32(dec_vid)),
        dec_slot=_set(state.dec_slot, idx, as32(dec_slot)),
    )


def extract_rows_plain(state: EngineState, idx) -> Tuple:
    """Gather full rows for pause-to-disk (HotRestoreInfo analog)."""
    idx = _idx(idx, state.bal)
    return tuple(leaf[idx] for leaf in state)


def restore_rows_plain(state: EngineState, idx, rows: Tuple) -> EngineState:
    """Scatter previously extracted rows back (unpause)."""
    idx = _idx(idx, state.bal)
    return EngineState(*(
        _set(leaf, idx, _t(row, leaf)) for leaf, row in zip(state, rows)
    ))


# ---------------------------------------------------------------------------
# dispatching entry points: plain version on CPU tensors, kernel on CUDA
# ---------------------------------------------------------------------------


def create_groups(state: EngineState, idx, member_mask, coord0, my_id: int,
                  version=0, tag=0) -> EngineState:
    """Batched group creation (see :func:`create_groups_plain`)."""
    if not _engine.on_card(state.bal):
        return create_groups_plain(state, idx, member_mask, coord0, my_id,
                                   version, tag)
    from . import gp_kernels

    return gp_kernels.create_groups(state, idx, member_mask, coord0, my_id,
                                    version, tag)


def kill_groups(state: EngineState, idx) -> EngineState:
    """Batched kill (see :func:`kill_groups_plain`)."""
    if not _engine.on_card(state.bal):
        return kill_groups_plain(state, idx)
    from . import gp_kernels

    return gp_kernels.kill_groups(state, idx)


def jump_rows(state: EngineState, idx, exec_slot, bal, app_hash, n_execd,
              stopped) -> EngineState:
    """Checkpoint-transfer jump (see :func:`jump_rows_plain`)."""
    if not _engine.on_card(state.bal):
        return jump_rows_plain(state, idx, exec_slot, bal, app_hash, n_execd,
                               stopped)
    from . import gp_kernels

    return gp_kernels.jump_rows(state, idx, exec_slot, bal, app_hash, n_execd,
                                stopped)


def restore_paused_rows(state: EngineState, idx, exec_slot, bal, app_hash,
                        n_execd, acc_bal, acc_vid, acc_slot, dec_vid,
                        dec_slot) -> EngineState:
    """Batched unpause install (see :func:`restore_paused_rows_plain`)."""
    args = (idx, exec_slot, bal, app_hash, n_execd, acc_bal, acc_vid,
            acc_slot, dec_vid, dec_slot)
    if not _engine.on_card(state.bal):
        return restore_paused_rows_plain(state, *args)
    from . import gp_kernels

    return gp_kernels.restore_paused_rows(state, *args)


def extract_rows(state: EngineState, idx) -> Tuple:
    """Gather full rows (see :func:`extract_rows_plain`)."""
    if not _engine.on_card(state.bal):
        return extract_rows_plain(state, idx)
    from . import gp_kernels

    return gp_kernels.extract_rows(state, idx)


def restore_rows(state: EngineState, idx, rows: Tuple) -> EngineState:
    """Scatter extracted rows back (see :func:`restore_rows_plain`)."""
    if not _engine.on_card(state.bal):
        return restore_rows_plain(state, idx, rows)
    from . import gp_kernels

    return gp_kernels.restore_rows(state, idx, rows)
