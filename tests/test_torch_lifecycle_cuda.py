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

Every op is one launch a call.  ``gp_create_groups``, ``gp_jump_rows``,
``gp_restore_paused_rows`` and ``gp_restore_rows`` are one launch of
``gp_life_rows_kernel``: their cases also cover N in {0, 1, 7, 64, G},
unsorted batches, rows on both sides of a bitmap word's edge, batch
inputs given as CUDA int32 tensors in the caller's order, G=301 (word
units), 4,096 and 65,536 (int4 units; four a thread at 65,536's sparse
batches from W=8) at W in {4, 8, 16, 32}, a staged call launched twice
and at either unit count a thread, bad batches refused before any
launch, and misshapen CUDA batch inputs refused before any upload; and
a jump whose batch rows hold kept and cleared lanes, NULL slots and
negative frontiers.

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
        assert te.KERNEL_LAUNCHES[kname] == 1
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


ONE_PASS = ["create_groups", "restore_paused_rows", "jump_rows", "restore_rows"]


def _state_at(rng, G, W):
    d = {f: rng.integers(-1, 400, size=(G, W) if f in GW else (G,)).astype(np.int32)
         for f in te.EngineState._fields}
    d["app_hash"] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G).astype(np.int32)
    return te.EngineState(**{k: torch.as_tensor(v, device="cuda") for k, v in d.items()})


def _one_pass_args(op, rng, G, W, idx, on_card):
    N = len(idx)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    dev = (lambda x: torch.as_tensor(np.asarray(x).astype(np.int32), device="cuda")) \
        if on_card else (lambda x: x)
    if op == "create_groups":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[::2] = rng.integers(1, 8, size=masks[::2].shape)
        coord0 = tl.initial_coordinator(idx, masks & 7)
        return (idx, dev(masks), dev(coord0)), dict(
            my_id=1, version=dev(n(0, 4)), tag=dev(n(1, 1000)))
    if op == "jump_rows":
        return (idx,) + tuple(dev(x) for x in (n(-1, 500), n(-1, 500), n(-9, 9), n(0, 9),
                                               n(0, 2))), {}
    if op == "restore_rows":
        return (idx, tuple(dev(rng.integers(-1, 500, size=(N, W) if f in GW else N))
                           for f in te.EngineState._fields)), {}
    return (idx,) + tuple(dev(x) for x in (n(-1, 500), n(-1, 500), n(-9, 9), n(0, 9))) \
        + tuple(dev(rng.integers(-1, 500, size=(N, W))) for _ in range(5)), {}


@pytest.mark.parametrize("on_card", [False, True], ids=["host_inputs", "card_inputs"])
@pytest.mark.parametrize("W", [4, 8, 16, 32])
@pytest.mark.parametrize("G", [301, 4096, 65536])
@pytest.mark.parametrize("op", ONE_PASS)
def test_one_pass_kernel_matches_plain(op, G, W, on_card):
    """One launch a call, bit-equal to the plain version, at N in {0, 1,
    7, 64, G} and a batch astride bitmap words' edges, unsorted, with the
    batch inputs on the host or as CUDA int32 tensors in the caller's
    order; a staged call launched twice writes the same result."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    rng = np.random.default_rng(ONE_PASS.index(op) * 10_000 + G + W + on_card)
    state = _state_at(rng, G, W)
    keep = [x.clone() for x in state]
    kname = "gp_" + op
    batches = [rng.choice(G, size=n, replace=False) for n in (0, 1, 7, 64, G)]
    batches.append(rng.permutation([31, 32, 0, G - 1, 63, 64, 95, 96]))
    for idx in batches:
        args, kw = _one_pass_args(op, rng, G, W, idx, on_card)
        te.reset_launch_counts()
        got = getattr(tl, op)(state, *args, **kw)
        want = getattr(tl, op + "_plain")(state, *args, **kw)
        torch.cuda.synchronize()
        assert te.LAUNCHES[kname] == 1 and te.KERNEL_LAUNCHES[kname] == 1
        for f, a, b in zip(te.EngineState._fields, got, want):
            assert torch.equal(a, b), (len(idx), f)
        for a, b in zip(state, keep):
            assert torch.equal(a, b)
        for f in te.EngineState._fields:
            fresh = getattr(got, f) is not getattr(state, f)
            assert fresh == (f in gp_kernels.TOUCHED[kname]), f
        staged = gp_kernels.stage(kname, state, *args, **kw)
        staged.launch()
        staged.launch()
        torch.cuda.synchronize()
        assert staged.kernels == 1
        for f, a, b in zip(te.EngineState._fields, staged.result, want):
            assert torch.equal(a, b), ("twice", len(idx), f)
        for units in (1, 4):   # either unit count the launcher may pick
            staged.args.units = units
            staged.launch()
            torch.cuda.synchronize()
            for f, a, b in zip(te.EngineState._fields, staged.result, want):
                assert torch.equal(a, b), (units, len(idx), f)


@pytest.mark.parametrize("op", ONE_PASS)
def test_one_pass_refuses_bad_batches_before_a_launch(op):
    _need_card()
    rng = np.random.default_rng(7)
    G, W = 301, 8
    state = _state_at(rng, G, W)
    args, kw = _one_pass_args(op, rng, G, W, np.arange(4), False)
    te.reset_launch_counts()
    for bad in ([3, 5, 3, 1], [0, 1, 2, G], [0, -1, 2, 3]):
        with pytest.raises(ValueError):
            getattr(tl, op)(state, np.array(bad), *args[1:], **kw)
    assert te.LAUNCHES["gp_" + op] == 0 and te.KERNEL_LAUNCHES["gp_" + op] == 0


@pytest.mark.parametrize("op", ONE_PASS)
def test_one_pass_refuses_misshapen_card_inputs_before_an_upload(op, monkeypatch):
    """A batch input given as a CUDA tensor of the wrong shape or dtype is
    refused before the batch is staged: no upload, no launch."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    rng = np.random.default_rng(8)
    G, W = 301, 8
    state = _state_at(rng, G, W)
    args, kw = _one_pass_args(op, rng, G, W, np.arange(4), True)
    calls = []
    monkeypatch.setattr(gp_kernels, "_upload", lambda *a, **k: calls.append("upload"))
    monkeypatch.setattr(gp_kernels, "_lifecycle_launch", lambda *a: calls.append("launch"))
    # each batch input in turn (restore_rows': each leaf of its rows)
    rows = op == "restore_rows"
    values = list(args[1] if rows else args[1:])
    call = lambda vals: getattr(tl, op)(state, args[0], *((tuple(vals),) if rows else vals),
                                        **kw)
    for i, good in enumerate(values):
        for bad in (good[:-1], good.to(torch.int64)):
            with pytest.raises((ValueError, TypeError)):
                call(values[:i] + [bad] + values[i + 1:])
    assert calls == []


@pytest.mark.parametrize("W", [4, 16, 32])
@pytest.mark.parametrize("G", [301, 65536])
def test_jump_keeps_and_clears_lanes(G, W):
    """A jump whose batch rows' window lanes sit below, at and above the
    new frontier or hold NULL, at frontiers that are negative, NULL, zero
    and large (signed comparisons), with donor ballots below and above the
    row's: bit-equal to ``jump_rows_plain``, with both kept and cleared
    lanes in the batch, under either unit count a thread."""
    _need_card()
    from gigapaxos_tpu_torch.ops import gp_kernels

    rng = np.random.default_rng(G + W)
    state = _state_at(rng, G, W)
    N = min(G, 256)
    idx = rng.choice(G, size=N, replace=False)
    frontier = rng.choice(np.array([-2 ** 31, -7, -1, 0, 5, 300, 2 ** 30], np.int64), size=N)
    slots = {}
    for slot in ("acc_slot", "dec_slot"):
        off = rng.choice(np.array([-2, -1, 0, 1, 2]), size=(N, W))
        near = np.clip(frontier[:, None] + off, -2 ** 31, 2 ** 31 - 1)
        near[rng.random((N, W)) < 0.2] = NULL
        leaf = getattr(state, slot).clone()
        leaf[torch.as_tensor(idx, device="cuda")] = torch.as_tensor(near.astype(np.int32),
                                                                     device="cuda")
        slots[slot] = leaf
    state = state._replace(**slots)
    old_bal = getattr(state, "bal").cpu().numpy()[idx]
    bal = old_bal + rng.choice(np.array([-3, 0, 3]), size=N)
    args = (idx, frontier, bal, rng.integers(-2 ** 31, 2 ** 31 - 1, size=N),
            rng.integers(0, 9, size=N), rng.integers(0, 2, size=N))
    want = tl.jump_rows_plain(state, *args)
    kept = (want.acc_slot[torch.as_tensor(idx, device="cuda")] != NULL).sum().item()
    assert 0 < kept < N * W, kept
    staged = gp_kernels.stage("gp_jump_rows", state, *args)
    for units in (0, 1, 4):
        staged.args.units = units
        staged.launch()
        torch.cuda.synchronize()
        assert staged.kernels == 1
        for f, a, b in zip(te.EngineState._fields, staged.result, want):
            assert torch.equal(a, b), (units, f)


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
