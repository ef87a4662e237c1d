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
``gp_step_cluster`` launch, against the plain faces; the launcher's plan
at the paths' shapes, the stacked route by shape (a cluster for R <= 8, N
launches beyond), its refusals, and one instantiation launched at two
tiles from two threads; and a SimCluster on the card in lock step with
one on the CPU.

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
