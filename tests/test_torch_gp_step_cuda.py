"""The hand-written CUDA kernels against their plain PyTorch versions.

``gp_step`` (step + make_blob + pack_blob + heat, one launch) and
``gp_make_blob`` on the card, bit for bit against ``step_plain`` /
``make_blob_plain`` on the same CUDA tensors, over random states that
break the ring convention, for W in {8, 16, 32} and R in {3, 5}; and a
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
G = 301  # not a multiple of any groups-per-block count


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gp_step has no CPU mode")


def _random_state(rng, W, R, near=None):
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


@pytest.mark.parametrize("W,R,K", [(8, 3, 4), (8, 5, 8), (16, 3, 8),
                                   (16, 5, 16), (32, 3, 16), (32, 5, 8)])
def test_gp_step_matches_plain(W, R, K):
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(W * 7 + R)
    for _ in range(4):
        me = _random_state(rng, W, R)
        peers = [_dev(_random_state(rng, W, R, near=me)) for _ in range(R)]
        st = _dev(me)
        gvec = torch.stack([te.pack_blob(te.make_blob_plain(p)) for p in peers])
        heard = torch.as_tensor(rng.random(R) < 0.85, device="cuda")
        req = np.where(rng.random((G, K)) < 0.6, rng.integers(1, 100, (G, K)), NULL)
        req = np.where(rng.random((G, K)) < 0.05, req | (1 << 30), req)
        req = torch.as_tensor(req.astype(np.int32), device="cuda")
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
