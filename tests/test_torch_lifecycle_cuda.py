"""The group-lifecycle CUDA kernels against their plain PyTorch versions.

``gp_create_groups``, ``gp_kill_groups``, ``gp_jump_rows``,
``gp_restore_paused_rows``, ``gp_restore_rows`` and ``gp_extract_rows``
(``csrc/gp_lifecycle.cu``) on the card, bit for bit against the
``*_plain`` functions of ``ops/lifecycle.py`` on the same CUDA tensors,
over random states with NULL and negative words, for W in {8, 16, 32}
and N in {1, 7, 64}: every leaf equal, the input state unchanged, the
untouched leaves the input's own tensors, bad row batches refused.  Then
a manager's hibernate / wake burst / per-name wake on the card in lock
step with the same manager on the CPU.

A CUDA kernel has no CPU mode: every test here skips without a card.
This file imports nothing of JAX, so it also runs where JAX is absent
(the chip machine), without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_lifecycle_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import lifecycle as tl

G = 301
NULL = -1
GW = ("acc_bal", "acc_vid", "acc_slot", "dec_vid", "dec_slot", "c_prop_vid",
      "c_prop_slot")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gp_lifecycle has no CPU mode")


def _random_state(rng, W):
    d = {}
    for f in te.EngineState._fields:
        d[f] = rng.integers(-1, 400, size=(G, W) if f in GW else (G,)).astype(np.int32)
    d["app_hash"] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G).astype(np.int32)
    return te.EngineState(**{k: torch.as_tensor(v, device="cuda")
                             for k, v in d.items()})


def _args(op, rng, W, N, other):
    idx = rng.choice(G, size=N, replace=False)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    if op == "create_groups":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[::2] = rng.integers(1, 8, size=masks[::2].shape)
        return (idx, masks, tl.initial_coordinator(idx, masks & 7)), dict(
            my_id=1, version=n(0, 4), tag=n(1, 1000))
    if op == "jump_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-9, 9), n(0, 9), n(0, 2)), {}
    if op == "restore_paused_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-9, 9), n(0, 9)) + tuple(
            rng.integers(-1, 500, size=(N, W)) for _ in range(5)), {}
    if op == "restore_rows":
        return (idx, tl.extract_rows_plain(other, rng.choice(G, N, replace=False))), {}
    return (idx,), {}


OPS = ["create_groups", "kill_groups", "jump_rows", "restore_paused_rows",
       "restore_rows", "extract_rows"]


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("op", OPS)
def test_lifecycle_kernel_matches_plain(op, W):
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    rng = np.random.default_rng(OPS.index(op) * 64 + W)
    state, other = _random_state(rng, W), _random_state(rng, W)
    keep = [x.clone() for x in state]
    kname = "gp_" + op
    for N in (1, 7, 64):
        args, kw = _args(op, rng, W, N, other)
        te.reset_launch_counts()
        got = getattr(tl, op)(state, *args, **kw)
        want = getattr(tl, op + "_plain")(state, *args, **kw)
        torch.cuda.synchronize()
        assert te.LAUNCHES[kname] == 1
        for f, a, b in zip(te.EngineState._fields, got, want):
            assert torch.equal(a, b), (N, f)
        for a, b in zip(state, keep):
            assert torch.equal(a, b)
        if op != "extract_rows":
            for f in te.EngineState._fields:
                if f in gp_kernels.TOUCHED[kname]:
                    assert getattr(got, f) is not getattr(state, f)
                else:
                    assert getattr(got, f) is getattr(state, f)
    repeated = np.array([2, 2, 3, 4])
    if op == "kill_groups":   # constants only: the plain result
        for a, b in zip(tl.kill_groups(state, repeated),
                        tl.kill_groups_plain(state, repeated)):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError):
            getattr(tl, op)(state, repeated, *args[1:], **kw)
    with pytest.raises(ValueError):
        getattr(tl, op)(state, np.array([0, 1, 2, G]), *args[1:], **kw)


def test_manager_residency_on_card_matches_cpu(tmp_path):
    """One manager on the card and one on the CPU, the same history: a
    batched hibernate, a wake burst, a per-name wake, traffic; every
    leaf equal at every stage."""
    _need_card()
    from gigapaxos_tpu_torch.manager import PaxosManager
    from gigapaxos_tpu_torch.models import StatefulAdderApp

    cfg = te.EngineConfig(256, 16, 4, 1)
    names = [f"n{i:03d}" for i in range(96)]
    ms = {d: PaxosManager(0, StatefulAdderApp(), cfg, log_dir=str(tmp_path / d),
                          checkpoint_every=10 ** 9, sync_journal=False, device=d)
          for d in ("cuda", "cpu")}

    def ticks(m, n):
        for _ in range(n):
            vec, _st = m.publish_snapshot()
            m.tick_host(np.stack([vec]), np.array([True]))

    def same(what):
        for f in te.EngineState._fields:
            assert np.array_equal(ms["cuda"]._np(f), ms["cpu"]._np(f)), (what, f)
        assert ms["cuda"].app.totals == ms["cpu"].app.totals, what

    try:
        te.reset_launch_counts()
        for m in ms.values():
            m.create_paxos_batch(names, [0])
            for i, nm in enumerate(names[:40]):
                m.propose(nm, str(i + 1))
            ticks(m, 4)
            m.propose(names[0], "1000")   # in flight at the pause
            assert m.hibernate_batch(names) == len(names)
        same("asleep")
        for m in ms.values():
            assert m.restore_batch(names[:64]) == 64
            for nm in names[64:72]:
                assert m.restore(nm)
            ticks(m, 6)
        same("woken")
        assert ms["cuda"].app.totals[names[0]] == 1001
        assert te.LAUNCHES["gp_restore_paused_rows"] == 1 + 8
        assert te.LAUNCHES["gp_kill_groups"] == 1
    finally:
        for m in ms.values():
            m.close()
