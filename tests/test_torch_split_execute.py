"""The execute of ``gp_step_tile`` (``csrc/gp_step.cu``, mode 3) as a numpy
model, against the execute loop of ``ops/engine.py``'s ``step_plain``.

The tile build splits the execute in two.  In each replica's step, lane j
of a group's segment holds the value committed at offset j of the window
(j < n_adv), so ``n_execd`` is a ballot and a popc over ``v > 0`` and the
stop test one ballot over ``v & STOP_BIT`` (NULL included); the decided
values go to a row of shared memory.  After the tile's R steps one lane a
(replica, group) folds the app hash over its row's first ``n_committed``
values.  The model here does the same on fuzzed windows: the frontier's
run under the ring convention (the OR of each lane's offset) or the exact
W-round loop where two lanes decide one slot, then the counts from the
run's lanes, then the serial fold; and ``step_plain`` must agree on
``exec_slot``, ``n_execd``, ``stopped`` and ``app_hash`` of the new state
and on ``n_committed``, ``exec_vid`` and ``app_hash`` of its outputs.

``step_plain`` runs with no peer heard, so its learn and accept phases
change no decision and the windows reach the execute as they were made.
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te

NULL = -1
STOP = 1 << 30
M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _mix(h: int, v: int) -> int:
    return _i32(((h * 31 + v) & M32) ^ ((v << 7) & M32))


def split_execute(exec0, dec_slot, dec_vid, W):
    """One group's execute as the tile build runs it: (n_adv, the lanes of
    the run, each lane's value, the count of v > 0, the stop test, the
    row the fold reads)."""
    d_off = dec_slot.astype(np.int64) - int(exec0)
    match = (d_off >= 0) & (d_off < W)
    hits = 0
    for o in d_off[match]:
        hits |= 1 << int(o)
    collide = int(match.sum()) != bin(hits).count("1")
    row = np.zeros(W, np.int64)
    run = np.zeros(W, bool)
    vid_at = np.full(W, NULL, np.int64)
    if not collide:
        for j in np.flatnonzero(match):
            row[d_off[j]] = max(int(dec_vid[j]), NULL)
        n_adv = 0
        while n_adv < W and (hits >> n_adv) & 1:
            n_adv += 1
        run[:n_adv] = True
        vid_at[:n_adv] = row[:n_adv]
    else:
        # the exact loop: offset o is taken while every offset before it was
        n_adv, run_prev = 0, True
        for o in range(W):
            eq = dec_slot.astype(np.int64) == int(exec0) + o
            take = run_prev and bool(eq.any())
            if take:
                v = int(np.where(eq, dec_vid, NULL).max())
                n_adv += 1
                run[o], vid_at[o], row[o] = True, v, v
            run_prev = take
    # the ballots over the run's lanes
    n_real = int((run & (vid_at > 0)).sum())
    stop = bool((run & ((vid_at & STOP) != 0)).any())
    return n_adv, run, vid_at, n_real, stop, row


def fold(h0: int, row, n_comm: int) -> int:
    """The deferred fold of one (replica, group): the hash over the first
    n_comm values of its row."""
    h = int(h0)
    for o in range(n_comm):
        if row[o] > 0:
            h = _mix(h, int(row[o]))
    return h


def _windows(rng, G, W, R, my_id):
    """States whose decided windows mix the ring convention (lane j holds
    slot exec + offset with offset = lane mod W), whole windows decided,
    collisions (two lanes on one slot), NULL slots, no-ops, STOP values,
    NULL values and non-members."""
    kb = W.bit_length() - 1
    exec_slot = rng.integers(4 * W, 5000, size=G)
    lanes = np.arange(W)
    base = exec_slot[:, None] + ((lanes[None, :] - exec_slot[:, None]) & (W - 1))
    kind = rng.integers(0, 4, size=G)
    run_len = rng.integers(0, W + 1, size=G)
    off = (lanes[None, :] - exec_slot[:, None]) & (W - 1)
    # kind 0: a run of run_len offsets decided, the rest of the ring empty
    # or a lap ahead; 1: the whole window decided; 2: kind 0 with a
    # collision; 3: random slots near the window
    dec_slot = np.where(off < run_len[:, None], base,
                        np.where(rng.random((G, W)) < 0.5, NULL, base + W))
    dec_slot = np.where((kind == 1)[:, None], base, dec_slot)
    col = (kind == 2)[:, None] & (rng.random((G, W)) < 0.3)
    dec_slot = np.where(col, exec_slot[:, None] + rng.integers(0, W, size=(G, W)), dec_slot)
    rnd = (kind == 3)[:, None]
    dec_slot = np.where(rnd, np.where(rng.random((G, W)) < 0.2, NULL,
                                      exec_slot[:, None] + rng.integers(-2, 2 * W, (G, W))),
                        dec_slot)
    u = rng.random((G, W))
    dec_vid = np.where(u < 0.15, 0, rng.integers(1, 1 << 20, size=(G, W)))
    dec_vid = np.where((u >= 0.15) & (u < 0.25), dec_vid | STOP, dec_vid)
    dec_vid = np.where((u >= 0.25) & (u < 0.32), NULL, dec_vid)
    dec_vid = np.where((u >= 0.32) & (u < 0.35), -rng.integers(2, 1000, size=(G, W)), dec_vid)
    mm = rng.integers(1, 2 ** R, size=G)
    mm = np.where(rng.random(G) < 0.2, mm & ~(1 << my_id), mm | (1 << my_id))
    zero = lambda: np.zeros(G, np.int64)
    empty = lambda: np.full((G, W), NULL)
    d = dict(
        member_mask=mm,
        majority=np.array([bin(int(m)).count("1") // 2 + 1 for m in mm]),
        version=zero(), stopped=zero(), tag=np.ones(G, np.int64),
        bal=rng.integers(0, 4000, size=G) << 5, exec_slot=exec_slot,
        acc_bal=empty(), acc_vid=empty(), acc_slot=empty(),
        dec_vid=dec_vid, dec_slot=dec_slot,
        app_hash=rng.integers(-2 ** 31, 2 ** 31 - 1, G),
        n_execd=rng.integers(0, 1000, G), c_phase=zero(), c_bal=zero(),
        c_next_slot=exec_slot, c_prop_vid=empty(), c_prop_slot=empty(),
    )
    assert kb >= 1
    return te.EngineState(**{k: torch.as_tensor(np.asarray(v, np.int32))
                             for k, v in d.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("W,R", [(4, 7), (8, 3), (16, 5), (32, 3)])
def test_split_execute_matches_step_plain(W, R, seed):
    G, K, my_id = 400, min(W, 4), R - 1
    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(1000 * W + 10 * R + seed)
    st = _windows(rng, G, W, R, my_id)
    blob = te.make_blob_plain(st)
    g = te.Blob(*(torch.stack([x] * R) for x in blob))
    heard = torch.zeros(R, dtype=torch.bool)
    req = torch.full((G, K), NULL, dtype=torch.int32)
    want = torch.zeros(G, dtype=torch.bool)
    new, out = te.step_plain(st, g, heard, req, want, my_id, cfg)
    # learn changed no decision: the windows reached the execute as made
    assert torch.equal(new.dec_slot[(st.member_mask >> my_id) & 1 == 1],
                       st.dec_slot[(st.member_mask >> my_id) & 1 == 1])

    s = {k: v.numpy().astype(np.int64) for k, v in st._asdict().items()}
    kinds = {"collide": 0, "full": 0, "stop": 0, "nonmember": 0}
    for gi in range(G):
        n_adv, run, vid_at, n_real, stop, row = split_execute(
            s["exec_slot"][gi], s["dec_slot"][gi], s["dec_vid"][gi], W)
        m = (s["member_mask"][gi] >> my_id) & 1 == 1
        n_comm = n_adv if m else 0
        h = fold(s["app_hash"][gi], row, n_comm)
        want_state = {
            "exec_slot": s["exec_slot"][gi] + n_comm,
            "n_execd": s["n_execd"][gi] + (n_real if m else 0),
            "stopped": int(stop) if m else s["stopped"][gi],
            "app_hash": h,
        }
        for k, v in want_state.items():
            assert int(getattr(new, k)[gi]) == v, (gi, k)
        assert int(out.n_committed[gi]) == n_comm, gi
        assert int(out.app_hash[gi]) == h, gi
        assert out.exec_vid[gi].tolist() == np.where(run & m, vid_at, NULL).tolist(), gi
        d_off = s["dec_slot"][gi] - s["exec_slot"][gi]
        ins = d_off[(d_off >= 0) & (d_off < W)]
        kinds["collide"] += len(ins) != len(set(ins.tolist()))
        kinds["full"] += m and n_adv == W
        kinds["stop"] += m and stop
        kinds["nonmember"] += not m
    # the fuzz reached every case the split has to get right
    assert min(kinds.values()) > 0, kinds
