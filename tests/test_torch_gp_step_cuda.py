"""The hand-written CUDA kernels against their plain PyTorch versions.

``gp_step`` (step + make_blob + pack_blob + heat, one launch) and
``gp_make_blob`` on the card, bit for bit against ``step_plain`` /
``make_blob_plain`` on the same CUDA tensors, over random states that
break the ring convention (slots off their lane, several lanes deciding
one slot of the window), at every instantiation of ``csrc/gp_step.cu``
(W in {8, 16, 32} x R in {1..5}, K = W = 32, and the generic one at W=4,
R=7), on both faces (packed with heat, stacked), at G=301 (G % 4 == 1:
unaligned leaf offsets, plain loads) and G=4100 (bulk copies, a ragged
last tile);
the N-substep modes at every shape and G with N in {2, 8}, and at the
server shape's G=65,536 (three tiles and more a CTA): the packed face's
dispatch as one ``gp_step_n`` launch and the stacked face's as one
``gp_step_cluster`` launch, against the plain faces; the stacked face at
N = 1 as one stacked ``gp_step`` launch with a CTA a tile, which encodes
the tile's blob rows in shared memory (``gp_step_tile``), at every shape
(and R=8) and G, against the two-launch route it replaced
(``gp_make_blob`` and a stacked ``gp_step`` through the blob matrix) and
the plain face; the launcher's plan at the paths' shapes, the stacked
route by shape (a cluster for R <= 8, N launches beyond), its refusals,
and one instantiation launched at two tiles from two threads; and a
SimCluster on the card in lock step with one on the CPU.

A CUDA kernel has no CPU mode: every test here skips without a card.
This file imports nothing of JAX, so it also runs where JAX is absent
(the chip machine), without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_gp_step_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.testing.sim import SimCluster

NULL = -1
# 301: G % 4 == 1, so a gathered row's [G] leaves sit off 16-byte
# boundaries and the launch takes plain loads; 4100: bulk copies, and not a
# multiple of the tile at any W
GS = (301, 4100)
G = 301
# every instantiation (W, R) with a K of its own, the shapes held here
# before the instantiations (K below min(W, 4R)), K = W = 32 (admission at
# full width), and the generic one
SHAPES = [(W, R, min(W, 4 * R)) for W in (8, 16, 32) for R in (1, 2, 3, 4, 5)]
SHAPES += [(8, 3, 4), (16, 3, 8), (32, 3, 16), (32, 5, 8), (32, 4, 32), (4, 7, 3)]
# the N-substep modes' cases: every shape at both G, and the server shape's
# (W, R, K) at G=65,536, where each CTA of the persistent grid takes three
# tiles or more, so the ring refills stages that the substeps wrote
SUB_CASES = [(W, R, K, g) for (W, R, K) in SHAPES for g in GS] + [(16, 3, 8, 65_536)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gp_step has no CPU mode")


def _random_state(rng, W, R, near=None, G=G):
    kb = W.bit_length() - 1
    if near is None:
        exec_slot = rng.integers(20 * W, 4000, size=G)
        tag = rng.integers(1, 3, size=G)
        bal = rng.integers(0, 4000, size=G)
    else:
        exec_slot = near["exec_slot"] + rng.integers(-W, W, size=G)
        tag = np.where(rng.random(G) < 0.85, near["tag"], near["tag"] + 1)
        bal = np.where(rng.random(G) < 0.5, near["c_bal"],
                       near["bal"] + rng.integers(-40, 40, size=G))
    eb = exec_slot >> kb
    lanes = np.arange(W)

    def slots():
        eps = rng.integers(-17, 18, size=(G, W))
        s = ((eb[:, None] + eps) << kb) | lanes
        s = np.where(rng.random((G, W)) < 0.05,
                     rng.integers(0, 5000, size=(G, W)), s)
        # inside the window but off the lane: several lanes on one slot
        s = np.where(rng.random((G, W)) < 0.05,
                     exec_slot[:, None] + rng.integers(0, W, size=(G, W)), s)
        return np.where(rng.random((G, W)) < 0.3, NULL, s)

    vids = lambda: np.where(rng.random((G, W)) < 0.1,
                            rng.integers(1, 50, (G, W)) | (1 << 30),
                            rng.integers(-1, 50, (G, W)))
    mm = rng.integers(0, 2 ** R, size=G)
    d = dict(
        member_mask=mm,
        majority=np.array([bin(int(m)).count("1") // 2 + 1 for m in mm]),
        version=rng.integers(0, 3, G), stopped=(rng.random(G) < 0.1),
        tag=tag, bal=bal, exec_slot=exec_slot,
        acc_bal=bal[:, None] - rng.choice([0, 1, 2, 65534, 65535, 70000], (G, W)),
        acc_vid=vids(), acc_slot=slots(), dec_vid=vids(), dec_slot=slots(),
        app_hash=rng.integers(-2 ** 31, 2 ** 31 - 1, G),
        n_execd=rng.integers(0, 100, G), c_phase=rng.integers(0, 3, G),
        c_bal=bal - 32 * rng.integers(0, 3, G),
        c_next_slot=exec_slot + rng.integers(-2, W, G),
        c_prop_vid=vids(), c_prop_slot=slots(),
    )
    return {k: np.asarray(v, np.int32) for k, v in d.items()}


def _dev(d):
    return te.EngineState(**{k: torch.as_tensor(v, device="cuda")
                             for k, v in d.items()})


def _eq(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


def _inputs(rng, G, W, K, R):
    me = _random_state(rng, W, R, G=G)
    peers = [_dev(_random_state(rng, W, R, near=me, G=G)) for _ in range(R)]
    req = np.where(rng.random((G, K)) < 0.6, rng.integers(1, 100, (G, K)), NULL)
    req = np.where(rng.random((G, K)) < 0.05, req | (1 << 30), req)
    return me, peers, torch.as_tensor(req.astype(np.int32), device="cuda")


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("W,R,K", SHAPES)
def test_gp_step_matches_plain(W, R, K, G):
    """The packed face: one replica's step with heat, and gp_make_blob."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(W * 7 + R + G)
    for _ in range(4):
        me, peers, req = _inputs(rng, G, W, K, R)
        st = _dev(me)
        gvec = torch.stack([te.pack_blob(te.make_blob_plain(p)) for p in peers])
        heard = torch.as_tensor(rng.random(R) < 0.85, device="cuda")
        want = torch.as_tensor(rng.random(G) < 0.3, device="cuda")
        heat = torch.as_tensor(rng.integers(0, 9, G).astype(np.int32), device="cuda")
        my_id = int(rng.integers(0, R))
        k_st, k_out, k_blob, k_heat = gp_kernels.step(
            st, gvec, heard, req, want, my_id, cfg, heat=heat)
        p_st, p_out = te.step_plain(st, te.unpack_gathered(gvec, cfg), heard,
                                    req, want, my_id, cfg)
        torch.cuda.synchronize()
        _eq(k_st, p_st, "state'")
        assert torch.equal(k_out, te.pack_out(p_out))
        assert torch.equal(k_blob, te.pack_blob(te.make_blob_plain(p_st)))
        assert torch.equal(k_heat, heat + p_out.n_committed + p_out.n_admitted)
        for p in peers:
            assert torch.equal(gp_kernels.make_blob_vec(p),
                               te.pack_blob(te.make_blob_plain(p)))


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("W,R,K", SHAPES)
def test_gp_step_stacked_matches_plain(W, R, K, G):
    """The stacked face: every replica of the [R, G, ...] state in one
    launch against R plain steps, each with its own heard row, requests
    and want."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import stack_states

    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(W * 11 + R + G)
    for _ in range(2):
        me = _random_state(rng, W, R, G=G)
        reps = [_dev(_random_state(rng, W, R, near=me, G=G)) for _ in range(R)]
        states = stack_states(reps)
        blobs = torch.stack([te.pack_blob(te.make_blob_plain(p)) for p in reps])
        heard = torch.as_tensor(rng.random((R, R)) < 0.85, device="cuda")
        req = np.where(rng.random((R, G, K)) < 0.6, rng.integers(1, 100, (R, G, K)), NULL)
        req = torch.as_tensor(req.astype(np.int32), device="cuda")
        want = torch.as_tensor(rng.random((R, G)) < 0.3, device="cuda")
        out_blobs = torch.empty_like(blobs)
        k_st, k_mat, k_bl = gp_kernels.step_stacked(
            states, blobs, heard, req, want, cfg, out_blobs=out_blobs)
        g = te.unpack_gathered(blobs, cfg)
        for r in range(R):
            p_st, p_out = te.step_plain(reps[r], g, heard[r], req[r], want[r], r, cfg)
            _eq(te.EngineState(*(x[r] for x in k_st)), p_st, f"replica {r}")
            assert torch.equal(k_mat[r], te.pack_out(p_out)), r
            assert torch.equal(k_bl[r], te.pack_blob(te.make_blob_plain(p_st))), r


@pytest.mark.parametrize("N", [2, 8])
@pytest.mark.parametrize("W,R,K,G", SUB_CASES)
def test_gp_step_n_matches_plain_face(W, R, K, G, N):
    """The packed face's N substeps as one gp_step_n launch (heat on, want
    at substep 0, MY row refreshed from the advancing state, peers'
    rows frozen) against the plain face, for MY id 0 and R-1."""
    _need_card()
    from gigapaxos_tpu_torch.parallel.spmd import make_step

    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(W * 13 + R + G + N)
    fn = make_step(cfg, None, N, donate=False, io="packed_host", heat=True,
                   device="cuda")
    me = _random_state(rng, W, R, G=G)
    peers = [_dev(_random_state(rng, W, R, near=me, G=G)) for _ in range(R)]
    gvec = torch.stack([te.pack_blob(te.make_blob_plain(p)) for p in peers])
    ring = np.where(rng.random((N, G, K)) < 0.6, rng.integers(1, 100, (N, G, K)), NULL)
    ring = torch.as_tensor(ring.astype(np.int32), device="cuda")
    heat = torch.as_tensor(rng.integers(0, 9, G).astype(np.int32), device="cuda")
    for my_id in sorted({0, R - 1}):
        st = _dev(me)
        heard = torch.as_tensor(rng.random(R) < 0.85, device="cuda")
        want = torch.as_tensor(rng.random(G) < 0.3, device="cuda")
        te.reset_launch_counts()
        k = fn(st, gvec, heard, ring, want, my_id, heat)
        assert te.LAUNCHES["gp_step_n"] == 1 and te.LAUNCHES["gp_step"] == 0
        p = fn.plain(st, gvec, heard, ring, want, my_id, heat)
        torch.cuda.synchronize()
        _eq(k[0], p[0], f"state' r{my_id}")
        for j in (1, 2, 3):
            assert torch.equal(k[j], p[j]), (my_id, j)


@pytest.mark.parametrize("N", [2, 8])
@pytest.mark.parametrize("W,R,K,G", SUB_CASES)
def test_gp_step_cluster_matches_plain_face(W, R, K, G, N):
    """The stacked face's N substeps as one gp_step_cluster launch (no
    gp_make_blob), each replica with its own heard row, against the plain
    face."""
    _need_card()
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(W * 17 + R + G + N)
    fn = make_step(cfg, None, N, donate=False, io="stacked", device="cuda")
    assert fn.route == "cluster"
    me = _random_state(rng, W, R, G=G)
    states = stack_states([_dev(_random_state(rng, W, R, near=me, G=G))
                           for _ in range(R)])
    req = np.where(rng.random((N, R, G, K)) < 0.6, rng.integers(1, 100, (N, R, G, K)), NULL)
    req = torch.as_tensor(req.astype(np.int32), device="cuda")
    want = torch.as_tensor(rng.random((R, G)) < 0.3, device="cuda")
    heard = torch.as_tensor(rng.random((R, R)) < 0.85, device="cuda")
    te.reset_launch_counts()
    k_st, k_o = fn(states, req, want, heard)
    assert te.LAUNCHES["gp_step_cluster"] == 1
    assert te.LAUNCHES["gp_step"] == te.LAUNCHES["gp_make_blob"] == 0
    p_st, p_o = fn.plain(states, req, want, heard)
    torch.cuda.synchronize()
    _eq(k_st, p_st, "states'")
    _eq(k_o, p_o, "outs")


@pytest.mark.parametrize("R", [3, 7, 8, 9, 16])
def test_stacked_route_picks_a_cluster_up_to_8_replicas(R):
    """The stacked face's route at N > 1 is chosen by shape: a cluster of R
    CTAs (one gp_step_cluster launch, the plan's grid whole clusters) for
    R <= 8, the portable cluster size; a gp_make_blob and N stacked
    gp_step launches beyond, where gp_step_cluster refuses the shape."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    G_, W, K, N = 301, 8, 4, 3
    cfg = te.EngineConfig(G_, W, K, R)
    fn = make_step(cfg, None, N, donate=False, io="stacked", device="cuda")
    rng = np.random.default_rng(R)
    me = _random_state(rng, W, R, G=G_)
    states = stack_states([_dev(_random_state(rng, W, R, near=me, G=G_))
                           for _ in range(R)])
    req = torch.as_tensor(np.where(rng.random((N, R, G_, K)) < 0.6, 7, NULL)
                          .astype(np.int32), device="cuda")
    want = torch.zeros((R, G_), dtype=torch.bool, device="cuda")
    te.reset_launch_counts()
    k_st, k_o = fn(states, req, want)
    got = dict(te.LAUNCHES)
    p_st, p_o = fn.plain(states, req, want)
    _eq(k_st, p_st, "states'")
    _eq(k_o, p_o, "outs")
    if R <= gp_kernels.MAX_CLUSTER:
        assert fn.route == "cluster"
        assert (got["gp_step_cluster"], got["gp_step"], got["gp_make_blob"]) == (1, 0, 0)
        plan = gp_kernels.step_launch_plan(cfg, n_sub=N, cluster=True)
        assert plan["cluster"] == R and plan["grid"] % R == 0, plan
        assert 1 <= plan["grid"] // R <= plan["n_items"] == -(-G_ // plan["T"]), plan
    else:
        assert fn.route == "launches"
        assert (got["gp_step_cluster"], got["gp_step"], got["gp_make_blob"]) == (0, N, 1)
        with pytest.raises(ValueError):
            gp_kernels.step_cluster(states, torch.ones((R, R), dtype=torch.bool,
                                                       device="cuda"), req, want, cfg)


# every shape, and the generic instantiation at the largest cluster (R=8)
N1_SHAPES = SHAPES + [(8, 8, 8)]


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("W,R,K", N1_SHAPES)
def test_stacked_n1_one_launch_matches_two_launch_route(W, R, K, G):
    """The stacked face at N = 1: one stacked gp_step launch, a CTA a tile
    stepping its R replicas from blob rows it encodes in shared memory (no
    gp_make_blob, no blob matrix), with want pulses and stop requests,
    every replica hearing all and then none hearing one replica, bit for
    bit against the two-launch route it replaced (gp_make_blob and a
    stacked gp_step through the [R, NB] matrix) and against the plain
    face."""
    _need_card()
    from gigapaxos_tpu_torch.parallel.spmd import stack_states

    rng = np.random.default_rng(W * 23 + R + G)
    me = _random_state(rng, W, R, G=G)
    states = stack_states([_dev(_random_state(rng, W, R, near=me, G=G))
                           for _ in range(R)])
    _check_n1_tile(te.EngineConfig(G, W, K, R), states, rng)


def _decided_windows(rng, W, R, G):
    """R replicas' states that share each group's decided window, so the
    learn phase keeps it and the execute takes it: per group, the whole
    window decided on the ring convention (n_adv = W), a run of the window
    with two lanes on one slot (the exact loop), or _random_state's
    window, mixed within every tile; values 0 (no-ops), STOP-bit values
    and NULL inside the runs; and a replica outside the member mask in
    about a third of the groups."""
    me = _random_state(rng, W, R, G=G)
    ex = me["exec_slot"].astype(np.int64)
    lanes = np.arange(W)
    ring = ex[:, None] + ((lanes[None, :] - ex[:, None]) & (W - 1))
    kind = rng.integers(0, 3, size=G)
    run = np.where(((lanes[None, :] - ex[:, None]) & (W - 1))
                   < rng.integers(1, W + 1, size=G)[:, None], ring, NULL)
    col = (rng.random((G, W)) < 0.25) & (run != NULL)
    run = np.where(col, ex[:, None] + rng.integers(0, W, size=(G, W)), run)
    dec_slot = np.where((kind == 0)[:, None], ring,
                        np.where((kind == 1)[:, None], run, me["dec_slot"]))
    u = rng.random((G, W))
    vid = rng.integers(1, 1 << 20, size=(G, W))
    vid = np.where(u < 0.15, 0, np.where(u < 0.25, vid | (1 << 30),
                                         np.where(u < 0.32, NULL, vid)))
    mm = np.full(G, (1 << R) - 1)
    out = rng.random(G) < 0.35
    mm = np.where(out, mm & ~(1 << rng.integers(0, R, size=G)), mm)
    shared = dict(exec_slot=ex, dec_slot=dec_slot, dec_vid=vid, member_mask=mm,
                  majority=np.array([bin(int(m)).count("1") // 2 + 1 for m in mm]),
                  tag=me["tag"], stopped=np.zeros(G))
    reps = []
    for _ in range(R):
        d = _random_state(rng, W, R, near=me, G=G)
        d.update({k: np.asarray(v, np.int32) for k, v in shared.items()})
        reps.append(d)
    return reps, kind, mm


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("W,R,K", N1_SHAPES)
def test_stacked_n1_tile_folds_decided_windows(W, R, K, G):
    """The tile route's execute on decided windows: whole windows (the
    fold over W values), collisions beside ring-convention groups in one
    tile, no-op, STOP and NULL values inside the run, and replicas outside
    the member mask (their hash and counts frozen), bit for bit against
    the two-launch route and the plain face."""
    _need_card()
    from gigapaxos_tpu_torch.parallel.spmd import stack_states

    rng = np.random.default_rng(W * 31 + R + G)
    reps, kind, mm = _decided_windows(rng, W, R, G)
    states = stack_states([_dev(d) for d in reps])
    k_o = _check_n1_tile(te.EngineConfig(G, W, K, R), states, rng)
    n_comm = k_o.n_committed.cpu().numpy()
    member = (mm[None, :] >> np.arange(R)[:, None]) & 1 == 1
    assert (n_comm[member] == W).any() and (n_comm[~member] == 0).all()
    assert (kind == 1).any() and (kind != 1).any()


def _check_n1_tile(cfg, states, rng):
    """One stacked launch of the tile route at N = 1 against the two-launch
    route and the plain face, every replica hearing all and then none
    hearing one replica; returns the outputs of the first."""
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step

    G, W, K, R = cfg
    fn = make_step(cfg, None, 1, donate=False, io="stacked", device="cuda")
    assert fn.route == "tile"
    plan = gp_kernels.step_launch_plan(cfg, tile=True)
    assert plan["n_items"] == -(-G // plan["T"]) and 1 <= plan["grid"] <= plan["n_items"], plan
    req = np.where(rng.random((R, G, K)) < 0.6, rng.integers(1, 100, (R, G, K)), NULL)
    req = np.where(rng.random((R, G, K)) < 0.05, req | (1 << 30), req)
    req = torch.as_tensor(req.astype(np.int32), device="cuda")
    want = torch.as_tensor(rng.random((R, G)) < 0.3, device="cuda")
    dropped = torch.ones((R, R), dtype=torch.bool, device="cuda")
    dropped[:, int(rng.integers(0, R))] = False
    dropped |= torch.eye(R, dtype=torch.bool, device="cuda")   # as the face forces
    first = None
    for heard in (None, dropped):
        te.reset_launch_counts()
        k_st, k_o = fn(states, req, want, heard)
        assert (te.LAUNCHES["gp_step_cluster"], te.LAUNCHES["gp_step"],
                te.LAUNCHES["gp_make_blob"]) == (0, 1, 0)
        h = torch.ones((R, R), dtype=torch.bool, device="cuda") if heard is None else heard
        o_st, o_mat, _ = gp_kernels.step_stacked(
            states, gp_kernels.make_blob_rows(states, R), h, req, want, cfg)
        p_st, p_o = fn.plain(states, req, want, heard)
        torch.cuda.synchronize()
        _eq(k_st, o_st, "states' against two launches")
        _eq(k_st, p_st, "states' against plain")
        _eq(k_o, p_o, "outs against plain")
        for r in range(R):
            k_row = te.pack_out(te.StepOutputs(*(x[r] for x in k_o)))
            assert torch.equal(k_row, o_mat[r]), r
        first = k_o if first is None else first
    return first


@pytest.mark.parametrize("field,value", [("n_sub", 2), ("gathered", 256), ("stacked", 0),
                                         ("cluster", 1)])
def test_tile_build_refuses_other_launches(field, value):
    """The tile build (gp_step_tile) plans the stacked face's one substep
    with a CTA a tile, and refuses N > 1, a launch that reads a blob
    matrix, the packed face and clusters."""
    _need_card()
    import ctypes

    from gigapaxos_tpu_torch.ops import gp_kernels

    def info(**kw):
        a = gp_kernels._StepArgs()
        a.G, a.W, a.K, a.R, a.n_sub, a.stacked = 301, 8, 4, 3, 1, 1
        for k, v in kw.items():
            setattr(a, k, v)
        got = (ctypes.c_longlong * len(gp_kernels.STEP_PLAN_KEYS))()
        return gp_kernels.lib("gp_step_tile").gp_step_launch_info(
            ctypes.addressof(a), ctypes.addressof(got))

    assert info() == 0
    assert info(**{field: value}) != 0


# (G, W, K, R, stacked) -> (instantiation, groups per tile)
PATH_PLANS = {
    "headline": ((1_048_576, 32, 16, 3, True), (332, 8)),
    "server": ((65_536, 16, 8, 3, False), (316, 16)),
    "density": ((65_536, 16, 4, 1, False), (116, 16)),
    "actives": ((65_536, 16, 8, 4, False), (416, 16)),
    "reconfigurators": ((64, 16, 8, 3, False), (316, 8)),
    "generic": ((4100, 4, 3, 7, False), (0, 16)),
}


@pytest.mark.parametrize("path", sorted(PATH_PLANS))
def test_gp_step_plan_at_the_paths_shapes(path):
    """The launcher's plan: the instantiation, the tile (256 threads; fewer
    groups where G is small, so the launch spreads over more SMs), bulk
    copies at G % 4 == 0, and a grid of at least one and at most
    the work items."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    (G_, W, K, R, stacked), (inst, T) = PATH_PLANS[path]
    p = gp_kernels.step_launch_plan(te.EngineConfig(G_, W, K, R), stacked)
    assert (p["instance"], p["T"], p["threads"]) == (inst, T, T * W), p
    assert p["n_items"] == -(-G_ // T) * (R if stacked else 1), p
    assert 1 <= p["grid"] <= p["n_items"] and p["ctas_per_sm"] >= 1, p
    assert p["aligned"] == (G_ % 4 == 0), p


@pytest.mark.parametrize("field,value", [("W", 12), ("W", 64), ("K", 17), ("R", 0),
                                         ("R", 33), ("G", 0), ("n_sub", 0),
                                         ("cluster", 1)])
def test_gp_step_refuses_a_bad_plan(field, value):
    """The C launcher refuses arguments it has no plan for (the wrapper
    refuses them first; this holds the launcher on its own)."""
    _need_card()
    import ctypes

    from gigapaxos_tpu_torch.ops import gp_kernels

    a = gp_kernels._StepArgs()
    a.G, a.W, a.K, a.R, a.n_sub = 64, 16, 8, 3, 1
    setattr(a, field, value)
    got = (ctypes.c_longlong * len(gp_kernels.STEP_PLAN_KEYS))()
    assert gp_kernels.lib().gp_step_launch_info(ctypes.addressof(a),
                                               ctypes.addressof(got)) != 0


def test_gp_step_one_instantiation_at_two_tiles_from_two_threads():
    """An active and a reconfigurator with as many replicas run one
    instantiation at two tiles (G=65,536: 16 groups, 47,120 B of shared
    memory; G=64: 8 groups, 23,568 B), each server stepping on a thread of
    its own.  Launches from both threads at once stay bit-equal to
    plain."""
    _need_card()
    import threading

    from gigapaxos_tpu_torch.ops import gp_kernels

    def case(G_, seed):
        cfg = te.EngineConfig(G_, 16, 8, 3)
        rng = np.random.default_rng(seed)
        me, peers, req = _inputs(rng, G_, 16, 8, 3)
        st = _dev(me)
        gvec = torch.stack([te.pack_blob(te.make_blob_plain(p)) for p in peers])
        heard = torch.ones(3, dtype=torch.bool, device="cuda")
        want = torch.as_tensor(rng.random(G_) < 0.3, device="cuda")
        p_st, p_out = te.step_plain(st, te.unpack_gathered(gvec, cfg), heard, req,
                                    want, 1, cfg)
        return cfg, (st, gvec, heard, req, want, 1, cfg), (p_st, te.pack_out(p_out))

    cases = [case(65_536, 1), case(64, 2)]
    torch.cuda.synchronize()
    errors = []
    start = threading.Barrier(len(cases))

    def run(cfg, args, want):
        try:
            start.wait()
            for _ in range(200):
                k_st, k_out, _, _ = gp_kernels.step(*args)
            torch.cuda.synchronize()
            _eq(k_st, want[0], f"G={cfg.n_groups}")
            assert torch.equal(k_out, want[1]), cfg.n_groups
        except BaseException as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_sim_cluster_on_card_matches_cpu():
    _need_card()
    cfg = te.EngineConfig(G, 16, 8, 3)
    on_card = SimCluster(cfg, device="cuda")
    on_cpu = SimCluster(cfg, device="cpu")
    rng = np.random.default_rng(9)
    for c in (on_card, on_cpu):
        c.create_all_groups()
    vid = 1
    for t in range(25):
        reqs = {}
        for r in range(3):
            a = np.where(rng.random((G, 8)) < 0.4,
                         np.arange(vid, vid + G * 8).reshape(G, 8), NULL)
            vid += G * 8
            reqs[r] = a.astype(np.int32)
        delivery = rng.choice([0, 1, 2], size=(3, 3), p=[0.7, 0.2, 0.1])
        want = {int(rng.integers(0, 3)): rng.random(G) < 0.1} if t % 7 == 3 else {}
        on_card.step_all(reqs=reqs, want_coord=want, delivery=delivery)
        on_cpu.step_all(reqs=reqs, want_coord=want, delivery=delivery)
        for r in range(3):
            for f in te.EngineState._fields:
                assert torch.equal(getattr(on_card.states[r], f).cpu(),
                                   getattr(on_cpu.states[r], f)), (t, r, f)
    on_card.assert_rsm_invariant()
    assert on_card.checker.total_committed() > 0


# ---- the tile build's quiescent tiles ---------------------------------------

# (W, R, K, G): W = 32, 16 and 8 at R = 3, an R = 5 shape, the generic
# build, and G % 4 != 0 (plain loads and stores, a ragged last tile)
QUIET_CASES = [(32, 3, 16, 4100), (16, 3, 8, 4100), (8, 3, 4, 4100), (32, 5, 8, 4100),
               (4, 7, 3, 4100), (32, 3, 16, 1001)]
QUIET_CALLS = 220


def _own_stream():
    """A stream of the test's own: the face keeps its quiescence flags, and
    its choice of build, a stream, so there they start afresh (the first
    launch a probe of the skip build) whatever earlier tests stepped
    through the same memoized face."""
    return torch.cuda.stream(torch.cuda.Stream())


def _coordinators(states):
    active = states.c_phase == te.ACTIVE
    R, G = active.shape
    first = torch.arange(G, device=active.device) % R
    return torch.where(active.any(0), active.int().argmax(0), first)


@pytest.mark.parametrize("W,R,K,G_", QUIET_CASES)
def test_tile_skips_quiescent_tiles_word_for_word(W, R, K, G_):
    """The stacked face at N = 1 over 220 calls of sparse seeded traffic
    (a hot run of groups, now and then a cold one, and stray requests at
    replicas that do not coordinate), every state leaf and every out word
    of every group against the plain face at every call; with want pulses
    (calls 50-55), a proposal to the long-quiet last group (call 120),
    heard dropping a replica (calls 100-149), a state the face did not
    return (call 160) and a returned state changed in place (call 180).
    The tile counter reads more than 90% of the tiles skipped: the face
    keeps the skip build, its reports flagging most tiles."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    cfg = te.EngineConfig(G_, W, K, R)
    fn = make_step(cfg, None, 1, donate=False, io="stacked", device="cuda")
    assert fn.route == "tile"
    rng = np.random.default_rng(W * 131 + R * 7 + G_)
    states = build_replica_states(cfg, device="cuda")
    hot = np.arange(16, 40)
    full = torch.ones((R, R), dtype=torch.bool, device="cuda")
    dropped = full.clone()
    dropped[:, R - 1] = False
    dropped |= torch.eye(R, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    gp_kernels.reset_tile_counts()
    with _own_stream():
        _quiet_calls(fn, states, rng, hot, full, dropped, R, K, G_)
    torch.cuda.synchronize()
    got = gp_kernels.tile_counts()
    n_tiles = -(-G_ // gp_kernels.step_launch_plan(cfg, tile=True)["T"])
    assert got["skipped"] + got["stepped"] == QUIET_CALLS * n_tiles, got
    assert got["skipped"] > 0.9 * QUIET_CALLS * n_tiles, got


def _quiet_calls(fn, states, rng, hot, full, dropped, R, K, G_):
    """The calls of :func:`test_tile_skips_quiescent_tiles_word_for_word`."""
    for t in range(QUIET_CALLS):
        req = torch.full((R, G_, K), NULL, dtype=torch.int32, device="cuda")
        want = torch.zeros((R, G_), dtype=torch.bool, device="cuda")
        coord = _coordinators(states).cpu().numpy()
        groups = list(rng.choice(hot, size=4, replace=False))
        if rng.random() < 0.3:
            groups.append(int(rng.integers(hot[-1] + 1, G_ - 1)))
        if t == 120:
            groups.append(G_ - 1)
        if rng.random() < 0.3:   # a request at a replica that does not coordinate
            g = int(rng.integers(0, G_))
            req[(int(coord[g]) + 1) % R, g, 0] = 99
        for g in groups:
            req[int(coord[g]), int(g)] = torch.as_tensor(
                rng.integers(1, 1 << 20, size=K).astype(np.int32), device="cuda")
        if 50 <= t < 56:
            pick = rng.integers(0, G_, size=3)
            want[torch.as_tensor(rng.integers(0, R, size=3), device="cuda"),
                 torch.as_tensor(pick, device="cuda")] = True
        heard = dropped if 100 <= t < 150 else None
        if t == 160:
            states = te.EngineState(*(x.clone() for x in states))
        if t == 180:
            g = int(rng.integers(hot[-1] + 1, G_ - 1))
            states.c_bal[:, g] += 32
            states.bal[:, g] += 32
        k_st, k_o = fn(states, req, want, heard)
        p_st, p_o = fn.plain(states, req, want, heard)
        _eq(k_st, p_st, f"call {t}: states'")
        _eq(k_o, p_o, f"call {t}: outs")
        states = k_st


def test_tile_skips_nothing_under_steady_traffic():
    """Every coordinator offered K fresh values every call (the node
    cells' traffic): no tile is skipped, every call is the plain face's,
    and after the first (a probe of the skip build, whose report flags no
    tile) the face takes the plain tile build."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    W, R, K, G_ = 32, 3, 16, 4100
    cfg = te.EngineConfig(G_, W, K, R)
    fn = make_step(cfg, None, 1, donate=False, io="stacked", device="cuda")
    states = build_replica_states(cfg, device="cuda")
    base = torch.randint(1, 1 << 20, (R, G_, K), dtype=torch.int32, device="cuda")
    want = torch.zeros((R, G_), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    gp_kernels.reset_tile_counts()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for t in range(24):
            req = base + t * 40503
            k_st, k_o = fn(states, req, want)
            p_st, p_o = fn.plain(states, req, want)
            _eq(k_st, p_st, f"call {t}: states'")
            _eq(k_o, p_o, f"call {t}: outs")
            states = k_st
    torch.cuda.synchronize()
    got = gp_kernels.tile_counts()
    n_tiles = -(-G_ // gp_kernels.step_launch_plan(cfg, tile=True)["T"])
    assert got == {"skipped": 0, "stepped": 24 * n_tiles}, got
    # one launch of the skip build, the probe
    assert int(gp_kernels._TILE_COUNTS[str(states.bal.device)][1]) == n_tiles
    assert fn._flags[stream.cuda_stream].report.tolist() == [1, 0, 0, n_tiles]
