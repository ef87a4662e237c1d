"""The stacked face's tile route skips a quiescent tile: the ground it
stands on, and the face's bookkeeping of when its flags may be read.

``gp_step_tile`` (``csrc/gp_step.cu``, mode 3) flags a tile where its
launch gave every group of it no input (no request word, no want bit),
left every state word of its R replicas as it came in and wrote the idle
out rows; the next launch copies a flagged tile through, state and idle
rows, when the tile gets no input and heard is unchanged.  The kernel
runs only on a card, so these hold the rule on the plain stacked face,
which is the kernel's yardstick, group by group (a tile is flagged where
all its groups are): a group the rule flags at call t comes out of call
t+1 (no input, the same heard) with the state it went in with and the
out row of call t, which is the idle row the skip writes.  And the face
passes the kernel "flags valid" only for the very state its last tile
launch returned, unchanged (``gp_kernels.TileFlags``), checked here with
the launch emulated on the CPU.
"""

import gc

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels
from gigapaxos_tpu_torch.parallel import spmd as tspmd

NULL = -1
INT32_MIN = -(2 ** 31)


def idle_rows(states: te.EngineState, heard: torch.Tensor) -> te.StepOutputs:
    """The out rows the skip path writes for ``states`` ([R, G, ...]) under
    ``heard`` [R, R]: nothing committed, admitted, accepted or preempted,
    exec_base the exec_slot, app_hash the state's, and maj_exec the
    majority-rank execute frontier of the live replicas (replica x is live
    to r where r hears x, x is in r's member mask and has r's tag)."""
    R, G, W = states.acc_bal.shape
    ex = states.exec_slot.long()
    bit = lambda mask, x: ((mask >> x) & 1) == 1
    maj = torch.empty((R, G), dtype=torch.long)
    for r in range(R):
        mask = states.member_mask[r]
        live = [heard[r, x] & bit(mask, x) & (states.tag[x] == states.tag[r]) for x in range(R)]
        ge = [torch.where(live[x], ex[x], torch.full_like(ex[x], NULL)) for x in range(R)]
        best = torch.full((G,), INT32_MIN, dtype=torch.long)
        for x in range(R):
            rank = sum((ge[x] <= ge[y]).long() for y in range(R))
            best = torch.maximum(best, torch.where(rank >= states.majority[r], ge[x],
                                                   torch.full_like(ge[x], NULL)))
        maj[r] = torch.where(bit(mask, r), best.clamp(min=0), torch.zeros_like(best))
    zero, null = torch.zeros((R, G), dtype=torch.long), torch.full((R, G, W), NULL)
    return te.StepOutputs(
        n_committed=zero, exec_base=ex, exec_vid=null, n_admitted=zero, maj_exec=maj,
        app_hash=states.app_hash.long(), acc_new=torch.zeros((R, G, W), dtype=torch.long),
        bal_new=zero, preempted_vid=null)


def _same_rows(a, b) -> torch.Tensor:
    """[G] bool: every leaf of every replica equal, group by group."""
    G = a[0].shape[1]
    eq = torch.ones(G, dtype=torch.bool)
    for x, y in zip(a, b):
        eq &= (x.long() == y.long()).reshape(x.shape[0], G, -1).all(-1).all(0)
    return eq


def _traffic(rng, states, t, G, K, R, quiet_from, busy=0.12):
    """Call t's inputs: until ``quiet_from``, a proposal of K fresh values
    at each of a seeded share ``busy`` of the groups, offered to the replica that
    coordinates it (a STOP-free vid), a stray request at another replica
    of 5% of the groups (not admitted), and election pulses at 3% of the
    (replica, group) pairs in calls 6-13 and 26-31, whose ballots preempt
    proposals in flight; none after.  heard drops replica R - 1 in calls
    18-29 (a replica always hears itself)."""
    req = np.full((R, G, K), NULL, np.int32)
    want = np.zeros((R, G), bool)
    if t < quiet_from:
        active = states.c_phase.numpy() == te.ACTIVE
        coord = np.where(active.any(0), active.argmax(0), np.arange(G) % R)
        for g in np.flatnonzero(rng.random(G) < busy):
            req[coord[g], g] = rng.integers(1, 1 << 20, size=K)
        for g in np.flatnonzero(rng.random(G) < 0.05):
            req[(coord[g] + 1) % R, g, 0] = 99
        if 6 <= t < 14 or 26 <= t < 32:
            want = rng.random((R, G)) < 0.03
    heard = torch.ones((R, R), dtype=torch.bool)
    if 18 <= t < 30:
        heard[:, R - 1] = False
    heard |= torch.eye(R, dtype=torch.bool)
    return torch.as_tensor(req), torch.as_tensor(want), heard


def _premise(seed, G, W, K, R, busy):
    """Steps seeded traffic (:func:`_traffic`) through the plain stacked
    face and checks the flag rule's premise at every call; returns the
    counts of what it saw."""
    cfg = te.EngineConfig(G, W, K, R)
    face = tspmd.make_step(cfg, None, 1, device="cpu")
    rng = np.random.default_rng(seed)
    states = tspmd.build_replica_states(cfg, device="cpu")
    n_calls, quiet_from = 56, 40
    prev = None   # the last call's (flags, out rows, heard)
    seen = dict(checked=0, preempts=0, elections=0, flagged_busy=0, refused=0)
    for t in range(n_calls):
        req, want, heard = _traffic(rng, states, t, G, K, R, quiet_from, busy)
        new, out = face(states, req, want, heard)
        empty = (req == NULL).all(-1).all(0) & ~want.any(0)
        if prev is not None:
            flags, p_out, p_heard = prev
            again = flags & empty & bool(torch.equal(heard, p_heard))
            seen["flagged_busy"] += int((flags & ~empty).sum())
            assert _same_rows(new, states)[again].all(), t
            assert _same_rows(out, p_out)[again].all(), t
            seen["checked"] += int(again.sum())
        flags = empty & _same_rows(new, states) & _same_rows(out, idle_rows(states, heard))
        prev = (flags, out, heard)
        seen["preempts"] += int((out.preempted_vid != NULL).sum())
        seen["elections"] += int(want.sum())
        # requests offered to a coordinator that admitted fewer of them
        offered = (req != NULL).sum(-1)
        seen["refused"] += int(((offered > out.n_admitted) & (states.c_phase == te.ACTIVE)).sum())
        states = new
    # the quiet tail: every group at a fixed point
    assert bool(prev[0].all()), int((~prev[0]).sum())
    return seen


@pytest.mark.parametrize("seed", [5, 61, 2718])
def test_flagged_group_steps_to_itself_and_its_idle_row(seed):
    """Seeded sparse traffic with elections, preempts, stray requests and
    a dropped link on the plain stacked face: every group the flag rule
    marks at call t (no input, every state word unchanged, the idle out
    row) returns the same state and out row at call t+1 when that call
    gives it no input under the same heard; and once the traffic stops
    every group reaches such a fixed point."""
    seen = _premise(seed, 64, 8, 4, 3, 0.12)
    assert seen["preempts"] > 0 and seen["elections"] > 0 and seen["flagged_busy"] > 0
    assert seen["checked"] > 10 * 64


@pytest.mark.parametrize("seed", [7, 1009])
def test_flagged_group_steps_to_itself_at_full_windows(seed):
    """The premise at the deployed width (W = 32, K = 16) under traffic
    heavy enough that windows fill and coordinators refuse requests."""
    seen = _premise(seed, 64, 32, 16, 3, 0.6)
    assert seen["refused"] > 0 and seen["preempts"] > 0 and seen["flagged_busy"] > 0
    assert seen["checked"] > 10 * 64


def test_idle_rows_match_the_plain_step_on_a_quiet_state():
    """A state left alone reaches a fixed point whose out row, from the
    plain step, is the skip path's idle row, under full and partial
    heard."""
    G, W, K, R = 32, 8, 4, 3
    cfg = te.EngineConfig(G, W, K, R)
    face = tspmd.make_step(cfg, None, 1, device="cpu")
    states = tspmd.build_replica_states(cfg, device="cpu")
    no_req = torch.full((R, G, K), NULL, dtype=torch.int32)
    no_want = torch.zeros((R, G), dtype=torch.bool)
    for heard in (torch.ones((R, R), dtype=torch.bool),
                  torch.eye(R, dtype=torch.bool) | torch.tensor([[1, 1, 0]] * R).bool()):
        for _ in range(6):
            states, out = face(states, no_req, no_want, heard)
        new, out = face(states, no_req, no_want, heard)
        assert bool(_same_rows(new, states).all())
        assert bool(_same_rows(out, idle_rows(states, heard)).all())


# ---- the face's bookkeeping ------------------------------------------------


def test_quiet_book_holds_only_the_recorded_state_unchanged():
    """The flags describe the state the last launch returned, leaves
    unchanged: not another tensor with the same words, not after an
    in-place write, and nothing once a launch has begun."""
    cfg = te.EngineConfig(16, 8, 4, 3)
    st = tspmd.build_replica_states(cfg, device="cpu")
    f = gp_kernels.TileFlags(cfg, "cpu")
    assert not f.holds(st)
    f.returned(st)
    assert f.holds(st)
    assert f.holds(te.EngineState(*st))              # a new tuple, the same leaves
    other = te.EngineState(*(x.clone() for x in st))  # the same words, other tensors
    assert not f.holds(other)
    st.bal[1, 3].fill_(int(st.bal[1, 3]))             # an in-place write through a view
    assert not f.holds(st)
    f.returned(st)
    assert f.launch(st) and not f.holds(st)
    assert not f.launch(st)


def test_quiet_book_keeps_no_state_alive():
    cfg = te.EngineConfig(16, 8, 4, 3)
    f = gp_kernels.TileFlags(cfg, "cpu")
    st = tspmd.build_replica_states(cfg, device="cpu")
    f.returned(st)
    refs = [m[0] for m in f._marks]
    del st
    gc.collect()
    assert all(r() is None for r in refs)
    assert not f.holds(tspmd.build_replica_states(cfg, device="cpu"))


def test_tile_flags_start_the_epochs_again():
    """An epoch near the int32 flags' end: the next launch refills the
    flags with -1 and starts at epoch 1, describing no state."""
    cfg = te.EngineConfig(16, 8, 4, 3)
    f = gp_kernels.TileFlags(cfg, "cpu")
    st = tspmd.build_replica_states(cfg, device="cpu")
    f.flags.fill_(7)
    f.returned(st)
    f.epoch = gp_kernels._MAX_EPOCH
    assert not f.launch(st)
    assert f.epoch == 0 and bool((f.flags == -1).all())
    f.returned(st)
    assert f.epoch == 1 and f.holds(st)


def test_tile_flags_choose_the_skip_build_from_the_newest_report():
    """The skip build on every PROBE-th launch, and while the newest
    report of it (epoch, tiles flagged, skipped, walked) flagged a quarter
    of its tiles or more; a report is read once."""
    f = gp_kernels.TileFlags(te.EngineConfig(64, 8, 4, 3), "cpu")
    assert f.skip_build()                    # epoch 0: a probe
    f.epoch = 1
    assert not f.skip_build()                # no report yet
    f.report[:] = torch.tensor([1, 30, 12, 100])
    assert f.skip_build()
    f.epoch = 2
    assert f.skip_build()                    # the same report, remembered
    f.report[:] = torch.tensor([2, 24, 20, 100])
    assert not f.skip_build()
    f.epoch = gp_kernels.PROBE
    assert f.skip_build()                    # a probe
    f.epoch += 1
    assert not f.skip_build()
    f.report[:] = torch.tensor([65, 25, 0, 100])
    assert f.skip_build()                    # a quarter exactly


def _emulate_tile(monkeypatch, seen):
    """The tile launch emulated on the CPU (the plain substep), recording
    the flags' validity the face passes it."""

    def step_stacked(states, blobs, heard, req_vid, want_coord, cfg, *, out_states=None,
                     out_blobs=None, out_mat=None, launch_log=None, flags=None):
        assert blobs is None and out_states is None and out_blobs is None
        seen.append(None if flags is None else flags.launch(states))
        plain = tspmd._StackedStep(cfg, 1, torch.device("cpu"))
        st, mat = plain._plain_substep(states, req_vid, want_coord, heard)
        out_mat.copy_(mat)
        if flags is not None:
            flags.returned(st)
        return st, out_mat, None

    monkeypatch.setattr(te, "on_card", lambda t: True)
    monkeypatch.setattr(gp_kernels, "step_stacked", step_stacked)


def test_face_passes_valid_flags_only_for_its_last_returned_state(monkeypatch):
    """Valid for the very state the face's last call returned, leaves
    unchanged; invalid for the first call, after an in-place write, for
    another state (the same words in other tensors), and after a call by
    another caller through the same memoized face."""
    G, W, K, R = 24, 8, 4, 3
    cfg = te.EngineConfig(G, W, K, R)
    a0, b0, p0 = (tspmd.build_replica_states(cfg, device="cpu") for _ in range(3))
    seen = []
    _emulate_tile(monkeypatch, seen)
    face = tspmd.make_step(cfg, None, 1, device="cpu")
    assert face is tspmd.make_step(cfg, None, 1, device="cpu") and face.route == "tile"
    req = torch.full((R, G, K), NULL, dtype=torch.int32)
    req[0, 0] = 7
    want = torch.zeros((R, G), dtype=torch.bool)
    a, _ = face(a0, req, want)
    a, _ = face(a, req, want)
    a, _ = face(te.EngineState(*a), req, want)
    b, _ = face(b0, req, want)                         # another caller
    a, _ = face(a, req, want)
    a, _ = face(a, req, want)
    a.c_bal.mul_(1)                                    # in place: the version moves
    a, _ = face(a, req, want)
    a, _ = face(te.EngineState(*(x.clone() for x in a)), req, want)
    b, _ = face(b, req, want)
    assert seen == [False, True, True, False, False, True, False, False, False]
    # the emulated launches stepped as the plain face does
    p_st = p0
    for _ in range(2):
        p_st, _ = face.plain(p_st, req, want)
    k_st, _ = face(p0, req, want)
    k_st, _ = face(k_st, req, want)
    assert seen[-2:] == [False, True]
    for x, y in zip(k_st, p_st):
        assert torch.equal(x, y)


def test_tile_flags_buffers_are_apart():
    """A face's flags: an int32 in a 16-byte slot for each tile of the
    least size the launcher picks (4 groups, or one warp's worth at W <
    8), holding -1 (an epoch no launch has) until a launch stores its own,
    and two [R, R] heard buffers that do not overlap."""
    for G, W, R, tiles in ((24, 8, 3, 6), (1001, 8, 5, 251), (64, 4, 8, 8), (4100, 32, 3, 1025)):
        f = gp_kernels.TileFlags(te.EngineConfig(G, W, 4, R), "cpu")
        assert f.flags.shape == (4 * tiles,) and f.flags.dtype == torch.int32
        assert bool((f.flags == -1).all()) and f.epoch == 0
        assert [x.numel() for x in f.heard] == [R * R, R * R]
        assert f.heard[0].data_ptr() + R * R <= f.heard[1].data_ptr()
        assert f.parity == 0 and not f.holds(tspmd.build_replica_states(
            te.EngineConfig(G, W, 4, R), device="cpu"))
