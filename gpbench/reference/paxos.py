"""The plain reference of the consensus step, frozen in the benchmark.

A straightforward PyTorch transcription of the state-exchange Paxos step
that the system under test implements: the same int32 state leaves, the
same compact blob exchange and the same transition, written once more
here so that the check of every benchmark run holds the program against
code that the program cannot change.  It imports nothing of the program.

Rows, not replicas: every tensor has a leading axis of rows, and each row
is one (replica, group) pair with its own replica id (``my_id``).  The
blob exchange of a step gathers, for every row, the blobs that the R
replicas of its group published; groups never read each other, so a
sample of groups stepped here gives, row for row, what the whole engine
gives for those groups.

``quorum_of_one`` exists for the benchmark's control only: the control
is this reference with the configurations' guarantee that a majority of
a group's replicas accepted every decided slot broken.  Its coordinator
takes itself for a quorum and decides each request the step it admits
it, with no acceptor's answer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NULL = -1
IDLE, PREPARING, ACTIVE = 0, 1, 2
NOOP_VID = 0
STOP_BIT = 1 << 30
COORD_BITS = 5
COORD_MASK = (1 << COORD_BITS) - 1
BIG = 2 ** 30
WRAP_MAX = 15
WRAP_BIAS = 16
WRAP_MASK = 31
DELTA_MAX = 0xFFFE
META_DELTA_MASK = 0xFFFF
ACC_SHIFT, DEC_SHIFT, PROP_SHIFT = 16, 21, 26
INT32_MIN = -(2 ** 31)
I32 = torch.int32



class State(NamedTuple):
    member_mask: torch.Tensor
    majority: torch.Tensor
    version: torch.Tensor
    stopped: torch.Tensor
    tag: torch.Tensor
    bal: torch.Tensor
    exec_slot: torch.Tensor
    acc_bal: torch.Tensor
    acc_vid: torch.Tensor
    acc_slot: torch.Tensor
    dec_vid: torch.Tensor
    dec_slot: torch.Tensor
    app_hash: torch.Tensor
    n_execd: torch.Tensor
    c_phase: torch.Tensor
    c_bal: torch.Tensor
    c_next_slot: torch.Tensor
    c_prop_vid: torch.Tensor
    c_prop_slot: torch.Tensor


class Blob(NamedTuple):
    tag: torch.Tensor
    bal: torch.Tensor
    exec_slot: torch.Tensor
    coord: torch.Tensor
    acc_vid: torch.Tensor
    dec_vid: torch.Tensor
    prop_vid: torch.Tensor
    lane_meta: torch.Tensor


class Out(NamedTuple):
    n_committed: torch.Tensor
    exec_base: torch.Tensor
    exec_vid: torch.Tensor
    n_admitted: torch.Tensor
    maj_exec: torch.Tensor
    app_hash: torch.Tensor
    acc_new: torch.Tensor
    bal_new: torch.Tensor
    preempted_vid: torch.Tensor


# every leaf is int32 and [rows] or, for these, [rows, W]; the packed
# vectors are the leaves in field order, each row-major
STATE_FIELDS, BLOB_FIELDS, OUT_FIELDS = State._fields, Blob._fields, Out._fields
BLOB_WINDOW_FIELDS = frozenset(("acc_vid", "dec_vid", "prop_vid", "lane_meta"))
OUT_WINDOW_FIELDS = frozenset(("exec_vid", "acc_new", "preempted_vid"))


def encode_ballot(num, coord):
    return (num << COORD_BITS) | coord


def popcount(x: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(x)
    for b in range(32):
        n = n + ((x >> b) & 1)
    return n


def created(groups: torch.Tensor, my_id: torch.Tensor, n_replicas: int,
            window: int) -> State:
    """Rows of freshly created groups, every replica a member: the initial
    ballot (0, coordinator) is promised everywhere and the coordinator,
    replica ``group % R``, starts ACTIVE with no prepare phase."""
    n = groups.shape[0]
    dev = groups.device
    g = lambda v: torch.full((n,), v, dtype=I32, device=dev)
    gw = lambda: torch.full((n, window), NULL, dtype=I32, device=dev)
    mask = g((1 << n_replicas) - 1)
    coord0 = (groups % n_replicas).to(I32)
    bal0 = encode_ballot(torch.zeros_like(coord0), coord0)
    mine = coord0 == my_id
    return State(
        member_mask=mask, majority=popcount(mask) // 2 + 1, version=g(0),
        stopped=g(0), tag=g(0), bal=bal0, exec_slot=g(0),
        acc_bal=gw(), acc_vid=gw(), acc_slot=gw(), dec_vid=gw(), dec_slot=gw(),
        app_hash=g(0), n_execd=g(0),
        c_phase=torch.where(mine, ACTIVE, IDLE).to(I32),
        c_bal=torch.where(mine, bal0, NULL).to(I32), c_next_slot=g(0),
        c_prop_vid=gw(), c_prop_slot=gw(),
    )


def kbits_of(W: int) -> int:
    if W <= 0 or W & (W - 1):
        raise ValueError(f"window must be a power of two, got {W}")
    return W.bit_length() - 1


def make_blob(s: State) -> Blob:
    """What each row publishes: the compact snapshot, lanes anchored to
    its frontier (5-bit ring-epoch deltas) and accepted ballots to its
    promise (16-bit deltas); lanes outside either range publish NULL."""
    kbits = kbits_of(s.acc_bal.shape[-1])
    ebase = (s.exec_slot >> kbits)[:, None]

    def wrap_enc(slot):
        c = (slot >> kbits) - ebase
        ok = (slot != NULL) & (c >= -WRAP_MAX) & (c <= WRAP_MAX)
        return ok, torch.where(ok, c + WRAP_BIAS, 0)

    acc_in, acc_w = wrap_enc(s.acc_slot)
    delta = s.bal[:, None] - s.acc_bal
    acc_ok = acc_in & (s.acc_bal != NULL) & (delta >= 0) & (delta <= DELTA_MAX)
    acc_w = torch.where(acc_ok, acc_w, 0)
    acc_d = torch.where(acc_ok, delta + 1, 0)
    dec_ok, dec_w = wrap_enc(s.dec_slot)
    preparing = s.c_phase == PREPARING
    active = s.c_phase == ACTIVE
    prop_ok, prop_w = wrap_enc(torch.where(active[:, None], s.c_prop_slot, NULL))
    meta = acc_d | (acc_w << ACC_SHIFT) | (dec_w << DEC_SHIFT) | (prop_w << PROP_SHIFT)
    coord = torch.where(preparing, s.c_bal,
                        torch.where(active, s.c_bal | INT32_MIN, NULL))
    return Blob(
        tag=s.tag.clone(), bal=s.bal.clone(), exec_slot=s.exec_slot.clone(),
        coord=coord.to(I32),
        acc_vid=torch.where(acc_ok, s.acc_vid, NULL),
        dec_vid=torch.where(dec_ok, s.dec_vid, NULL),
        prop_vid=torch.where(prop_ok, s.c_prop_vid, NULL),
        lane_meta=meta.to(I32),
    )


def _decode_lanes(meta, bal, exec_slot, lanes, kbits):
    d = meta & META_DELTA_MASK
    aw = (meta >> ACC_SHIFT) & WRAP_MASK
    dw = (meta >> DEC_SHIFT) & WRAP_MASK
    pw = (meta >> PROP_SHIFT) & WRAP_MASK
    ebase = (exec_slot >> kbits)[:, None]

    def wrap_dec(w):
        return torch.where(w != 0, ((ebase + (w - WRAP_BIAS)) << kbits) | lanes, NULL)

    acc_bal = torch.where(d != 0, bal[:, None] - (d - 1), NULL)
    return acc_bal, wrap_dec(aw), wrap_dec(dw), wrap_dec(pw)


def mix(h, vid):
    """The app-hash fold of an executed vid (int32 wraparound)."""
    return (h * 31 + vid) ^ (vid << 7)


def step(s: State, g: Blob, heard: torch.Tensor, req: torch.Tensor,
         want: torch.Tensor, my_id: torch.Tensor, K: int,
         quorum_of_one: bool = False, fixed_loops: bool = False):
    """One step of every row.

    ``g``: the gathered blobs, leaves ``[R, rows, ...]`` (peer p's blob of
    the row's group in slot p); ``heard [R, rows]`` bool; ``req [rows, K]``
    request vids (NULL padded); ``want [rows]`` bool (election pulse);
    ``my_id [rows]`` the row's replica id.  ``fixed_loops`` folds the
    hash over all W lanes instead of the longest run (no host sync, for a
    CUDA graph).  Returns (state', Out)."""
    R = g.bal.shape[0]
    rows, W = s.acc_bal.shape
    kbits = kbits_of(W)
    dev = s.bal.device
    rids = torch.arange(R, dtype=I32, device=dev)
    lanes = torch.arange(W, dtype=I32, device=dev)

    in_group = ((s.member_mask[None, :] >> rids[:, None]) & 1) == 1
    same_inst = g.tag == s.tag[None, :]
    live = heard & in_group & same_inst
    inert = s.member_mask == 0
    maj = torch.ones_like(s.majority) if quorum_of_one else s.majority
    i_member = ((s.member_mask >> my_id) & 1) == 1

    # 1. promise: fold the highest prepare and proposal ballots heard
    prep_g = torch.where(g.coord >= 0, g.coord, NULL)
    prop_g = torch.where((g.coord < 0) & (g.coord != NULL), g.coord & 0x7FFFFFFF, NULL)
    in_prep = torch.where(live, prep_g, NULL)
    in_prop = torch.where(live, prop_g, NULL)
    max_prop = in_prop.amax(dim=0)
    new_bal = torch.maximum(s.bal, torch.maximum(in_prep.amax(dim=0), max_prop))
    exec2 = s.exec_slot[:, None]

    # 2-3. fold the peers: the winning proposal window, the learn count
    # of the highest (slot, ballot) accepted per lane, decided lanes
    win_row = (in_prop == max_prop[None, :]) & (max_prop[None, :] != NULL)
    decoded = [_decode_lanes(g.lane_meta[r], g.bal[r], g.exec_slot[r], lanes, kbits)
               for r in range(R)]
    nullw = torch.full((rows, W), NULL, dtype=I32, device=dev)
    p_slot = p_vid = s_c = b_c = det_vid = c1_v = nullw
    n_match = torch.zeros((rows, W), dtype=I32, device=dev)
    c1_s = torch.full((rows, W), BIG, dtype=I32, device=dev)
    for r in range(R):
        a_bal, a_slot, d_slot, pr_slot = decoded[r]
        live_r = live[r][:, None]
        w_r = win_row[r][:, None]
        p_slot = torch.maximum(p_slot, torch.where(w_r, pr_slot, NULL))
        p_vid = torch.maximum(p_vid, torch.where(w_r, g.prop_vid[r], NULL))
        ok = live_r & (a_slot != NULL)
        s_r = torch.where(ok, a_slot, NULL)
        b_r = torch.where(ok, a_bal, NULL)
        better = ok & ((s_r > s_c) | ((s_r == s_c) & (b_r > b_c)))
        same = ok & (s_r == s_c) & (b_r == b_c)
        n_match = torch.where(better, 1, n_match + same.to(I32))
        s_c = torch.where(better, s_r, s_c)
        b_c = torch.where(better, b_r, b_c)
        det_vid = torch.where(better, g.acc_vid[r], det_vid)
        okd = live_r & (d_slot != NULL) & (d_slot >= exec2)
        lower = okd & (d_slot < c1_s)
        c1_s = torch.where(lower, d_slot, c1_s)
        c1_v = torch.where(lower, g.dec_vid[r], c1_v)
    detected = (n_match >= maj[:, None]) & (s_c != NULL)

    # accept the winning window at the promised ballot
    acc_ok = (max_prop == new_bal) & (max_prop != NULL) & (s.stopped == 0)
    in_win = (p_slot >= exec2) & (p_slot < exec2 + W) & (p_vid != NULL)
    do_acc = acc_ok[:, None] & in_win
    acc_bal = torch.where(do_acc, max_prop[:, None], s.acc_bal)
    acc_vid = torch.where(do_acc, p_vid, s.acc_vid)
    acc_slot = torch.where(do_acc, p_slot, s.acc_slot)
    acc_changed = do_acc & ((acc_bal != s.acc_bal) | (acc_vid != s.acc_vid)
                            | (acc_slot != s.acc_slot))

    # learn: the smallest needed slot among my decisions, the peers'
    # decisions and the quorum-detected accepts
    def cand(slot, valid):
        return torch.where(valid & (slot != NULL) & (slot >= exec2), slot, BIG)

    c0_s = cand(s.dec_slot, torch.ones_like(detected))
    c2_s = cand(s_c, detected)
    best = torch.minimum(torch.minimum(c0_s, c1_s), c2_s)
    have = best < BIG
    dec_vid = torch.where(have, torch.where(best == c0_s, s.dec_vid,
                                            torch.where(best == c1_s, c1_v, det_vid)),
                          s.dec_vid)
    dec_slot = torch.where(have, best, s.dec_slot)

    # 4. execute the in-order run of decided slots from the frontier.
    # Slot exec + o lives in lane (exec + o) mod W, so the run is read
    # lane by lane in slot order and the hash folds it in that order.
    offs = torch.arange(W, dtype=I32, device=dev)
    lane_at = (s.exec_slot[:, None] + offs[None, :]) & (W - 1)
    slot_at = torch.gather(dec_slot, 1, lane_at.long())
    vid_run = torch.gather(dec_vid, 1, lane_at.long())
    run = torch.cumprod((slot_at == s.exec_slot[:, None] + offs[None, :]).to(I32),
                        dim=1).bool()
    real = run & (vid_run > 0)
    n_adv = run.sum(dim=1).to(I32)
    h = s.app_hash
    for o in range(W if fixed_loops else (int(n_adv.max()) if rows else 0)):
        h = torch.where(real[:, o], mix(h, vid_run[:, o]), h)
    n_execd = s.n_execd + real.sum(dim=1).to(I32)
    stop_seen = (run & ((vid_run & STOP_BIT) != 0)).any(dim=1)
    d_vid_at = torch.where(run, vid_run, NULL)
    exec_new = s.exec_slot + n_adv
    stopped = torch.maximum(s.stopped, stop_seen.to(I32))

    # the majority-rank execute frontier
    ge = torch.where(live, g.exec_slot, NULL)
    rank = (ge[:, None, :] <= ge[None, :, :]).sum(dim=1).to(I32)
    maj_exec = torch.clamp(torch.where(rank >= maj[None, :], ge, NULL).amax(dim=0), min=0)

    # 5. coordinator: preemption, election start, prepare quorum
    phase = torch.where((s.c_phase != IDLE) & (new_bal > s.c_bal), IDLE, s.c_phase)
    orphaned = ((new_bal & COORD_MASK) == my_id) & (new_bal != NULL)
    start = (want | orphaned) & (phase == IDLE) & (~inert) & (stopped == 0)
    c_bal = torch.where(start, encode_ballot((new_bal >> COORD_BITS) + 1, my_id), s.c_bal)
    phase = torch.where(start, PREPARING, phase)
    new_bal = torch.where(phase == PREPARING, torch.maximum(new_bal, c_bal), new_bal)
    not_me = rids[:, None] != my_id[None, :]
    promised = (g.bal == c_bal[None, :]) & live & not_me
    quorum = (phase == PREPARING) & (promised.sum(dim=0).to(I32) + 1 >= maj)

    # carryover: the highest (slot, ballot) accepted per lane among the
    # promisers' snapshots, then my own window
    co_slot = co_bal = co_vid = nullw
    for r in range(R):
        a_bal, a_slot, _d, _p = decoded[r]
        ok = promised[r][:, None] & (a_slot != NULL) & (a_slot >= exec2)
        better = ok & ((a_slot > co_slot) | ((a_slot == co_slot) & (a_bal > co_bal)))
        co_slot = torch.where(better, a_slot, co_slot)
        co_bal = torch.where(better, a_bal, co_bal)
        co_vid = torch.where(better, g.acc_vid[r], co_vid)
    mine = ((acc_slot != NULL) & (acc_slot >= exec2)
            & ((acc_slot > co_slot) | ((acc_slot == co_slot) & (acc_bal > co_bal))))
    co_slot = torch.where(mine, acc_slot, co_slot)
    co_vid = torch.where(mine, acc_vid, co_vid)
    co_has = co_slot != NULL

    won = quorum
    phase = torch.where(won, ACTIVE, phase)
    prom_exec = torch.where(promised, g.exec_slot, NULL).amax(dim=0)
    floor = torch.maximum(exec_new, prom_exec)
    won2 = won[:, None]
    c_prop_vid = torch.where(won2, torch.where(co_has, co_vid, NULL), s.c_prop_vid)
    c_prop_slot = torch.where(won2, torch.where(co_has, co_slot, NULL), s.c_prop_slot)
    c_next = torch.where(won, torch.maximum(floor, co_slot.amax(dim=1) + 1), s.c_next_slot)

    # no-ops fill the holes in [floor, next) that carry nothing over
    exp_slot = exec_new[:, None] + ((lanes[None, :] - exec_new[:, None]) & (W - 1))
    hole = (won2 & (exp_slot >= floor[:, None]) & (exp_slot < c_next[:, None])
            & (c_prop_slot != exp_slot) & (dec_slot != exp_slot))
    c_prop_vid = torch.where(hole, NOOP_VID, c_prop_vid)
    c_prop_slot = torch.where(hole, exp_slot, c_prop_slot)

    # retire decided or passed proposals; one decided otherwise was preempted
    is_active = phase == ACTIVE
    retire = (c_prop_slot != NULL) & ((dec_slot == c_prop_slot) | (c_prop_slot < exec2))
    preempted_vid = torch.where(retire & (dec_vid != c_prop_vid) & (c_prop_vid > 0),
                                c_prop_vid, NULL)
    c_prop_vid = torch.where(retire, NULL, c_prop_vid)
    c_prop_slot = torch.where(retire, NULL, c_prop_slot)

    # admit new requests into consecutive slots, inside the majority window
    # and on free lanes, never past a stop
    stopping = ((c_prop_vid != NULL) & ((c_prop_vid & STOP_BIT) != 0)).any(dim=1)
    dec_stop = ((dec_slot != NULL) & (dec_slot >= exec2)
                & ((dec_vid & STOP_BIT) != 0)).any(dim=1)
    may_admit = is_active & (stopped == 0) & (~stopping) & (~dec_stop)
    req_stop = (req != NULL) & ((req & STOP_BIT) != 0)
    clear = torch.cumprod(1 - req_stop.to(I32), dim=1).to(I32)
    clear = torch.cat([torch.ones((rows, 1), dtype=I32, device=dev), clear[:, :-1]], dim=1)
    c_next = torch.where(is_active, torch.maximum(c_next, exec_new), c_next)
    bound = maj_exec + W
    # the K candidates c_next + k sit on K distinct lanes (K <= W), so
    # each is judged on its own and the admitted ones are a prefix
    ks = torch.arange(K, dtype=I32, device=dev)
    cand_slot = c_next[:, None] + ks[None, :]
    cand_lane = (cand_slot & (W - 1)).long()
    lane_busy = torch.gather(c_prop_slot, 1, cand_lane) != NULL
    dec_at = torch.gather(dec_slot, 1, cand_lane)
    can = (may_admit[:, None] & (clear > 0) & (req != NULL)
           & (cand_slot < bound[:, None]) & (~lane_busy) & (dec_at != cand_slot))
    adm = torch.cumprod(can.to(I32), dim=1).bool()
    n_admit = adm.sum(dim=1).to(I32)
    c_prop_vid = c_prop_vid.scatter(
        1, cand_lane, torch.where(adm, req, torch.gather(c_prop_vid, 1, cand_lane)))
    c_prop_slot = c_prop_slot.scatter(
        1, cand_lane, torch.where(adm, cand_slot, torch.gather(c_prop_slot, 1, cand_lane)))
    c_next = c_next + n_admit
    if quorum_of_one:
        dec_vid = dec_vid.scatter(
            1, cand_lane, torch.where(adm, req, torch.gather(dec_vid, 1, cand_lane)))
        dec_slot = dec_slot.scatter(
            1, cand_lane, torch.where(adm, cand_slot, torch.gather(dec_slot, 1, cand_lane)))

    new = State(
        member_mask=s.member_mask, majority=s.majority, version=s.version,
        stopped=stopped, tag=s.tag, bal=new_bal, exec_slot=exec_new,
        acc_bal=acc_bal, acc_vid=acc_vid, acc_slot=acc_slot,
        dec_vid=dec_vid, dec_slot=dec_slot, app_hash=h, n_execd=n_execd,
        c_phase=phase, c_bal=c_bal, c_next_slot=c_next,
        c_prop_vid=c_prop_vid, c_prop_slot=c_prop_slot,
    )
    # rows of groups this replica is not a member of stay as they were
    m1, m2 = i_member, i_member[:, None]
    new = State(*(torch.where(m1 if n.dim() == 1 else m2, n, o).to(I32)
                  for n, o in zip(new, s)))
    out = Out(
        n_committed=torch.where(m1, n_adv, 0).to(I32),
        exec_base=s.exec_slot.clone(),
        exec_vid=torch.where(m2 & run, d_vid_at, NULL).to(I32),
        n_admitted=torch.where(m1, n_admit, 0).to(I32),
        maj_exec=torch.where(m1, maj_exec, 0).to(I32),
        app_hash=new.app_hash.clone(),
        acc_new=(m2 & acc_changed).to(I32),
        bal_new=(new.bal != s.bal).to(I32),
        preempted_vid=torch.where(m2, preempted_vid, NULL).to(I32),
    )
    return new, out


class Replicas:
    """R replicas of a sample of groups, stepped in lock step with the
    blob exchange of the benchmark's faces: at every step each replica
    gathers the blobs that all R replicas published after the step
    before (at the first step, those of the created groups).

    Rows are replica-major: row ``r * S + i`` is replica r of the i-th
    sampled group."""

    def __init__(self, groups, n_replicas: int, window: int, req_lanes: int,
                 quorum_of_one: bool = False, device="cpu",
                 state: Optional[State] = None, graph: bool = True):
        """``state`` (optional): the rows to start from instead of the
        created groups.  On a CUDA device the step is replayed from a
        CUDA graph unless ``graph`` is False (the same operations, one
        launch)."""
        self.groups = torch.as_tensor(groups, dtype=torch.int64, device=device)
        self.R, self.W, self.K = int(n_replicas), int(window), int(req_lanes)
        self.S = int(self.groups.shape[0])
        self.quorum_of_one = quorum_of_one
        R, S = self.R, self.S
        self.my_id = torch.arange(R, dtype=I32, device=device).repeat_interleave(S)
        self.state = state if state is not None else created(
            self.groups.repeat(R), self.my_id, R, self.W)
        self.heat = torch.zeros((R * S,), dtype=I32, device=device)
        self.graph = graph and self.groups.device.type == "cuda"
        self._graph = None

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[R, S, ...]`` -> ``[R * S, ...]`` (replica-major rows)."""
        return x.reshape((self.R * self.S,) + tuple(x.shape[2:]))

    def per_replica(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.R, self.S) + tuple(x.shape[1:]))

    def blob(self) -> Blob:
        """The blobs the rows publish now."""
        return make_blob(self.state)

    def gathered(self, frozen: Optional[Blob] = None) -> Blob:
        """What every row gathers: the blobs of its group's R replicas,
        published now; with ``frozen``, its peers' from ``frozen`` and
        its own published now."""
        blob = make_blob(self.state)
        R, S = self.R, self.S

        def spread(leaf):   # [R * S, ...] -> [R (source), R, S, ...]
            per = leaf.reshape((R, 1, S) + tuple(leaf.shape[1:]))
            return per.expand((R, R, S) + tuple(leaf.shape[1:]))

        def rows(x):
            return x.reshape((R, R * S) + tuple(x.shape[3:]))

        if frozen is None:
            return Blob(*(rows(spread(x)) for x in blob))
        own = torch.eye(R, dtype=torch.bool, device=self.groups.device)
        return Blob(*(rows(torch.where(own.reshape((R, R, 1) + (1,) * (x.dim() - 1)),
                                       spread(x), spread(f)))
                      for x, f in zip(blob, frozen)))

    def _step(self, hr, req, want, fixed_loops=False, frozen=None):
        return step(self.state, self.gathered(frozen), hr, req, want, self.my_id,
                    self.K, self.quorum_of_one, fixed_loops)

    def step(self, req: torch.Tensor, want: torch.Tensor,
             heard: Optional[torch.Tensor] = None,
             frozen: Optional[Blob] = None) -> Out:
        """One step: ``req [R, S, K]``, ``want [R, S]`` bool, ``heard [R,
        R]`` bool (me, peer; default all), ``frozen`` (optional) the
        peers' blobs to gather instead of those published now, as a
        packed face's later steps of one call do.  Returns the Out of
        every row (on a graph, tensors the next step overwrites)."""
        R, S = self.R, self.S
        dev = self.state.bal.device
        if heard is None:
            heard = torch.ones((R, R), dtype=torch.bool)
        heard = heard.to(torch.bool).cpu() | torch.eye(R, dtype=torch.bool)
        inputs = (heard.t()[:, :, None].expand(R, R, S).reshape(R, R * S).to(dev),
                  self.rows(req.to(I32)).to(dev), self.rows(want.to(torch.bool)).to(dev))
        if not self.graph or frozen is not None:
            new, out = self._step(*inputs, frozen=frozen)
            if self._graph is None:
                self.state = new
                self.heat = self.heat + out.n_committed + out.n_admitted
            else:   # the graph reads and writes these very tensors
                for dst, src in zip(self.state, new):
                    dst.copy_(src)
                self.heat.add_(out.n_committed + out.n_admitted)
            return out
        if self._graph is None:
            self._inputs = [x.clone() for x in inputs]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step(*self._inputs, fixed_loops=True)
            torch.cuda.current_stream(dev).wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                new, out = self._step(*self._inputs, fixed_loops=True)
                for dst, src in zip(self.state, new):
                    dst.copy_(src)
                self.heat.add_(out.n_committed + out.n_admitted)
            self._out = out
        for dst, src in zip(self._inputs, inputs):
            dst.copy_(src)
        self._graph.replay()
        return self._out
