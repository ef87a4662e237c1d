"""Engine parity: the PyTorch port's plain engine against the JAX reference.

The same inputs, built with numpy from a fixed seed, go through
``gigapaxos_tpu.ops.engine`` (JAX on the CPU) and
``gigapaxos_tpu_torch.ops.engine`` (torch on the CPU, the plain version).
Everything is int32, so the tolerance is zero: every leaf of state',
every StepOutputs field, every blob word and every expanded plane must be
equal.  Covers random states that break the ring convention, the wrap and
delta boundary lanes of the compact format, the packed host interface, and
the random DELIVER/STALE/DROP fuzz schedule of the engine suite run in
lock step on both packages, for W in {8, 16, 32} and R in {3, 5}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import engine as je
from gigapaxos_tpu.testing import sim as jsim
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.testing import sim as tsim
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

NULL = -1
SHAPES = [  # (W, R, K)
    (8, 3, 4), (8, 5, 8), (16, 3, 8), (16, 5, 4), (32, 3, 16), (32, 5, 8),
]
G = 6


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def _cfgs(W, R, K):
    return je.EngineConfig(G, W, K, R), te.EngineConfig(G, W, K, R)


def random_state(rng, W, R, near=None):
    """Random 19-leaf state as numpy int32 (ring residues mostly kept, but
    lanes may hold any slot; some far outside the wrap window).  ``near``
    correlates tags, frontiers and ballots with another state so live
    peers, promises and quorums actually occur."""
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

    def slots(p_null, spread=3):
        eps = rng.integers(-spread, spread + 1, size=(G, W))
        s = ((eb[:, None] + eps) << kb) | lanes
        s = np.where(rng.random((G, W)) < 0.05,
                     rng.integers(0, 5000, size=(G, W)), s)  # off-ring
        s = np.where(rng.random((G, W)) < 0.03,
                     ((eb[:, None] + 20) << kb) | lanes, s)  # beyond wrap
        return np.where(rng.random((G, W)) < p_null, NULL, s)

    vids = lambda: np.where(
        rng.random((G, W)) < 0.1,
        rng.integers(1, 50, size=(G, W)) | (1 << 30),
        rng.integers(-1, 50, size=(G, W)),
    )
    mm = rng.integers(0, 2 ** R, size=G)
    mm[0] = 2 ** R - 1
    maj = np.array([bin(int(m)).count("1") // 2 + 1 for m in mm])
    d = dict(
        member_mask=mm, majority=maj, version=rng.integers(0, 3, G),
        stopped=(rng.random(G) < 0.1).astype(int), tag=tag, bal=bal,
        exec_slot=exec_slot,
        acc_bal=bal[:, None] - rng.integers(-2, 70, (G, W)),
        acc_vid=vids(), acc_slot=slots(0.3),
        dec_vid=vids(), dec_slot=slots(0.3),
        app_hash=rng.integers(-2 ** 31, 2 ** 31 - 1, G),
        n_execd=rng.integers(0, 100, G), c_phase=rng.integers(0, 3, G),
        c_bal=bal - 32 * rng.integers(0, 3, G),
        c_next_slot=exec_slot + rng.integers(-2, W, G),
        c_prop_vid=vids(), c_prop_slot=slots(0.3),
    )
    return {k: np.asarray(v, np.int32) for k, v in d.items()}


def jstate(d):
    return je.EngineState(**{k: jnp.asarray(v) for k, v in d.items()})


def tstate(d):
    return te.EngineState(**{k: torch.as_tensor(v) for k, v in d.items()})


def assert_leaves_equal(a, b, what):
    assert a._fields == b._fields
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert y.dtype == np.int32, (what, f, y.dtype)
        np.testing.assert_array_equal(
            x.astype(np.int32), y, err_msg=f"{what}: {f}"
        )


def _inputs(rng, W, R, K):
    me = random_state(rng, W, R)
    peers = [random_state(rng, W, R, near=me) for _ in range(R)]
    heard = rng.random(R) < 0.85
    req = np.where(rng.random((G, K)) < 0.6,
                   rng.integers(1, 100, (G, K)), NULL).astype(np.int32)
    req = np.where(rng.random((G, K)) < 0.05, req | (1 << 30), req)
    want = rng.random(G) < 0.3
    my_id = int(rng.integers(0, R))
    return me, peers, heard, req.astype(np.int32), want, my_id


@pytest.mark.parametrize("W,R,K", SHAPES)
def test_step_random_states(W, R, K):
    cj, ct = _cfgs(W, R, K)
    step_j = jsim._shared_step_jit()
    rng = np.random.default_rng(1000 * W + R)
    activity = 0
    for _trial in range(6):
        me, peers, heard, req, want, my_id = _inputs(rng, W, R, K)
        jb = [je.make_blob(jstate(p)) for p in peers]
        tb = [te.make_blob(tstate(p)) for p in peers]
        for a, b in zip(jb, tb):
            assert_leaves_equal(a, b, "make_blob")
        gj = je.Blob(*(jnp.stack(xs) for xs in zip(*jb)))
        gt = te.Blob(*(torch.stack(xs) for xs in zip(*tb)))
        sj, oj = step_j(jstate(me), gj, jnp.asarray(heard), jnp.asarray(req),
                        jnp.asarray(want), jnp.int32(my_id), cfg=cj)
        st, ot = te.step(tstate(me), gt, torch.as_tensor(heard),
                         torch.as_tensor(req), torch.as_tensor(want), my_id, ct)
        assert_leaves_equal(sj, st, "state'")
        assert_leaves_equal(oj, ot, "outputs")
        activity += int(np.asarray(oj.n_committed).sum())
        activity += int(np.asarray(oj.n_admitted).sum())
        activity += int(np.asarray(oj.acc_new).sum())
    assert activity > 0  # the random inputs really exercise the step


@pytest.mark.parametrize("W,R,K", [SHAPES[0], SHAPES[5]])
def test_step_host_and_packing(W, R, K):
    """step_host (packed gathered matrix in, out/blob vectors out), the
    pack/unpack helpers and the wire-layout constants."""
    cj, ct = _cfgs(W, R, K)
    assert je.blob_vec_len(cj) == te.blob_vec_len(ct)
    assert je.out_vec_len(cj) == te.out_vec_len(ct)
    assert je._leaf_shapes(je.Blob._fields, cj) == te._leaf_shapes(te.Blob._fields, ct)
    rng = np.random.default_rng(7 + W)
    me, peers, heard, req, want, my_id = _inputs(rng, W, R, K)
    gvec_j = jnp.stack([je.pack_blob(je.make_blob(jstate(p))) for p in peers])
    gvec_t = torch.stack([te.pack_blob(te.make_blob(tstate(p))) for p in peers])
    np.testing.assert_array_equal(np.asarray(gvec_j), gvec_t.numpy())
    assert_leaves_equal(je.unpack_gathered(gvec_j, cj),
                        te.unpack_gathered(gvec_t, ct), "unpack_gathered")
    step_host_j = jax.jit(je.step_host, static_argnames=("cfg",))
    sj, out_j, blob_j = step_host_j(
        jstate(me), gvec_j, jnp.asarray(heard), jnp.asarray(req),
        jnp.asarray(want), jnp.int32(my_id), cfg=cj,
    )
    st, out_t, blob_t = te.step_host(
        tstate(me), gvec_t, torch.as_tensor(heard), torch.as_tensor(req),
        torch.as_tensor(want), my_id, cfg=ct,
    )
    assert_leaves_equal(sj, st, "state'")
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
    np.testing.assert_array_equal(np.asarray(blob_j), blob_t.numpy())
    assert_leaves_equal(je.split_out_vec(np.asarray(out_j), cj),
                        te.split_out_vec(out_t.numpy(), ct), "split_out_vec")
    assert_leaves_equal(je.split_blob_vec(np.asarray(blob_j), cj),
                        te.split_blob_vec(blob_t.numpy(), ct), "split_blob_vec")


@pytest.mark.parametrize("W", [8, 16, 32])
def test_expand_blob_random_states(W):
    rng = np.random.default_rng(W)
    for _ in range(4):
        d = random_state(rng, W, 3)
        bj, bt = je.make_blob(jstate(d)), te.make_blob(tstate(d))
        assert_leaves_equal(bj, bt, "make_blob")
        assert_leaves_equal(je.expand_blob(bj), te.expand_blob(bt), "expand")
    # batched [R, G, ...] decode
    bj = je.Blob(*(jnp.stack([x, x]) for x in bj))
    bt = te.Blob(*(torch.stack([x, x]) for x in bt))
    assert_leaves_equal(je.expand_blob(bj), te.expand_blob(bt), "expand[R]")


def test_wrap_and_delta_boundaries():
    """The compact format's exact extremes (tests/test_compact_blob.py):
    representable lanes survive, one past each saturates to NULL — on
    both packages, word for word."""
    W = 8
    kb = W.bit_length() - 1
    WRAP_MAX, DELTA_MAX = te.WRAP_MAX, te.DELTA_MAX
    exec_slot = (WRAP_MAX + 2) * 2 * W
    ebase = exec_slot >> kb
    cases = [
        (0, 0, True), (WRAP_MAX, 0, True), (-WRAP_MAX, 0, True),
        (WRAP_MAX + 1, 0, False), (-(WRAP_MAX + 1), 0, False),
        (0, DELTA_MAX, True), (0, DELTA_MAX + 1, False),
    ]
    bal = DELTA_MAX + 7
    lane = 3
    cj, ct = _cfgs(W, 3, 4)
    for eps, bd, survives in cases:
        slot = ((ebase + eps) << kb) | lane
        d = {k: v.numpy().copy() for k, v in te.init_state(ct, "cpu")._asdict().items()}
        d["tag"][:] = 1
        d["bal"][0] = bal
        d["exec_slot"][0] = exec_slot
        d["acc_slot"][0, lane] = slot
        d["acc_bal"][0, lane] = bal - bd
        d["acc_vid"][0, lane] = 42
        d["dec_slot"][0, lane] = slot
        d["dec_vid"][0, lane] = 43
        bj, bt = je.make_blob(jstate(d)), te.make_blob(tstate(d))
        assert_leaves_equal(bj, bt, f"blob {eps},{bd}")
        ex = te.expand_blob(bt)
        assert_leaves_equal(je.expand_blob(bj), ex, f"expand {eps},{bd}")
        if survives:
            assert int(ex.acc_slot[0, lane]) == slot, (eps, bd)
            assert int(ex.acc_bal[0, lane]) == bal - bd, (eps, bd)
            assert int(ex.acc_vid[0, lane]) == 42, (eps, bd)
            assert int(ex.dec_slot[0, lane]) == slot, (eps, bd)
        else:
            assert int(ex.acc_slot[0, lane]) == NULL, (eps, bd)
            assert int(ex.acc_vid[0, lane]) == NULL, (eps, bd)
            if abs(eps) > WRAP_MAX:
                assert int(ex.dec_slot[0, lane]) == NULL, (eps, bd)


def _lockstep_fuzz(W, R, K, steps, heal, seed):
    """tests/test_engine.py:test_random_schedule_fuzz's schedule, driven
    through both packages' SimCluster in lock step; every leaf of every
    replica is compared after every step."""
    cj, ct = _cfgs(W, R, K)
    cjax = jsim.SimCluster(cj)
    ctor = tsim.SimCluster(ct, device="cpu")
    cjax.create_all_groups()
    ctor.create_all_groups()
    rng = np.random.default_rng(seed)
    vid = 1
    codes = [jsim.DELIVER, jsim.STALE, jsim.DROP]
    assert codes == [tsim.DELIVER, tsim.STALE, tsim.DROP]

    def both(**kw):
        oj = cjax.step_all(**kw)
        ot = ctor.step_all(**kw)
        for r in range(R):
            assert_leaves_equal(cjax.states[r], ctor.states[r], f"state[{r}]")
            assert_leaves_equal(oj[r], ot[r], f"out[{r}]")

    for _t in range(steps):
        delivery = rng.choice(codes, size=(R, R), p=[0.6, 0.2, 0.2])
        inject = {}
        for g in range(G):
            if rng.random() < 0.5:
                rid = int(rng.integers(0, R))
                arr = inject.setdefault(rid, np.full((G, K), NULL, np.int32))
                arr[g, 0] = vid
                vid += 1
        wc = {}
        if rng.random() < 0.1:
            wc[int(rng.integers(0, R))] = rng.random(G) < 0.3
        both(reqs=inject, want_coord=wc, delivery=delivery)
    for t in range(heal):
        both(want_coord={t % R: np.ones(G, bool)} if t % 10 == 0 else {})
    ctor.assert_rsm_invariant()
    assert ctor.checker.chosen == cjax.checker.chosen
    return ctor


def test_random_schedule_fuzz_lockstep():
    """The engine suite's fuzz at its own shape (G=6, W=8, K=4, R=3) and
    length (120 random steps, 30 healing steps)."""
    c = _lockstep_fuzz(8, 3, 4, steps=120, heal=30, seed=42)
    fr = c.exec_frontiers()
    assert (fr == fr[0]).all(), fr
    assert c.checker.total_committed() > 20


@pytest.mark.parametrize("W,R,K", SHAPES[1:])
def test_random_schedule_fuzz_lockstep_shapes(W, R, K):
    c = _lockstep_fuzz(W, R, K, steps=30, heal=10, seed=W * 10 + R)
    assert c.checker.total_committed() > 0


def test_entry_points_raise_without_device():
    """No card and no explicit device: the port raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device path is moot")
    cfg = te.EngineConfig(4, 8, 4, 3)
    with pytest.raises(RuntimeError):
        te.init_state(cfg)
    with pytest.raises(RuntimeError):
        tsim.SimCluster(cfg)
