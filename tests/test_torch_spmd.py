"""make_step parity: the port's two faces against the JAX reference.

Both faces (``packed_host`` with the heat accumulator, ``stacked``) at
N in {1, 4} substeps, including the packed face's frozen-peer semantics
(substeps >= 1 refresh only MY gathered row) as
``tests/test_unified_step.py`` pins them for the reference.  Inputs come
from numpy with a fixed seed; tolerance is zero.

The kernel path's orchestration (heat updated in place, preallocated
out-ring rows, the row refresh between substeps, the stacked face's
double-buffered blob matrices) cannot launch its CUDA kernel here, so
one test runs it with the kernel wrappers replaced by a plain-PyTorch
emulation and requires the same results as the plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import engine as je
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

NULL = -1
G, W, K, R = 8, 8, 4, 3


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def _eq(a, b, what):
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x.astype(np.int32), y, err_msg=f"{what}: {f}")


def _states(cfg_j, cfg_t):
    sj = jspmd.build_replica_states(cfg_j)
    st = tspmd.build_replica_states(cfg_t, device="cpu")
    _eq(sj, st, "build_replica_states")
    return sj, st


def _ring(rng, N, coord, my_id):
    reqs = np.full((N, G, K), NULL, np.int32)
    vid = 1
    for t in range(N):
        for g in range(G):
            if int(coord[g]) == my_id:
                reqs[t, g, 0] = vid
            vid += 1
        reqs[t, :, 1] = np.where(rng.random(G) < 0.5, vid + np.arange(G), NULL)
        vid += G
    return reqs


@pytest.mark.parametrize("n", [1, 4])
def test_packed_face_matches_reference(n):
    """packed_host with heat; peers' rows frozen for the dispatch (the
    self row is deliberately stale in the gathered matrix, and a peer is
    not heard) — every state leaf, every out-ring row, the blob vector
    and the heat accumulator equal the reference's."""
    cfg_j = je.EngineConfig(G, W, K, R)
    cfg_t = te.EngineConfig(G, W, K, R)
    sj, st = _states(cfg_j, cfg_t)
    rng = np.random.default_rng(5 + n)
    my_id = 0
    # one warm stacked step so the gathered rows differ from my state
    req0 = np.full((R, G, K), NULL, np.int32)
    req0[:, :, 0] = np.arange(100, 100 + G)
    want0 = np.zeros((R, G), bool)
    sj, _ = jspmd.make_step(cfg_j, None, 1, donate=False)(sj, jnp.asarray(req0), jnp.asarray(want0))
    st, _ = tspmd.make_step(cfg_t, None, 1, donate=False, device="cpu")(st, req0, want0)
    _eq(sj, st, "warm step")
    per_j = [je.EngineState(*(x[r] for x in sj)) for r in range(R)]
    per_t = [te.EngineState(*(x[r] for x in st)) for r in range(R)]
    gvec = np.stack([np.asarray(je.pack_blob(je.make_blob(s))) for s in per_j])
    np.testing.assert_array_equal(
        gvec, torch.stack([te.pack_blob(te.make_blob(s)) for s in per_t]).numpy()
    )
    coord = np.asarray(sj.bal)[0] & 31
    ring = _ring(rng, n, coord, my_id)
    heard = np.array([True, True, False])
    want = rng.random(G) < 0.25
    heat = rng.integers(0, 50, G).astype(np.int32)
    fj = jspmd.make_step(cfg_j, None, n, donate=False, io="packed_host", heat=True)
    ft = tspmd.make_step(cfg_t, None, n, donate=False, io="packed_host",
                         heat=True, device="cpu")
    # the reference's packed face at N=1 takes the [1, G, K] ring as well
    oj = fj(per_j[my_id], jnp.asarray(gvec), jnp.asarray(heard), jnp.asarray(ring),
            jnp.asarray(want), jnp.int32(my_id), jnp.asarray(heat))
    ot = ft(per_t[my_id], gvec, heard, ring, want, my_id, heat)
    _eq(oj[0], ot[0], "state'")
    for i, name in ((1, "out_rings"), (2, "blob_vec"), (3, "heat")):
        np.testing.assert_array_equal(np.asarray(oj[i]), ot[i].numpy(), err_msg=name)
    assert ot[1].shape == (n, te.out_vec_len(cfg_t))
    rows = ot[1].numpy()
    assert sum(int(te.split_out_vec(r, cfg_t).n_admitted.sum()) for r in rows) > 0


@pytest.mark.parametrize("n", [1, 4])
def test_stacked_face_matches_reference(n):
    cfg_j = je.EngineConfig(G, W, K, R)
    cfg_t = te.EngineConfig(G, W, K, R)
    sj, st = _states(cfg_j, cfg_t)
    rng = np.random.default_rng(11 + n)
    fj = jspmd.make_step(cfg_j, None, n, donate=False)
    ft = tspmd.make_step(cfg_t, None, n, donate=False, device="cpu")
    for t in range(3):
        shape = (n, R, G, K) if n > 1 else (R, G, K)
        req = np.where(rng.random(shape) < 0.5,
                       rng.integers(1, 10 ** 6, shape), NULL).astype(np.int32)
        want = rng.random((R, G)) < (0.3 if t == 1 else 0.0)
        heard = rng.random((R, R)) < 0.8
        sj, oj = fj(sj, jnp.asarray(req), jnp.asarray(want), jnp.asarray(heard))
        st, ot = ft(st, req, want, heard)
        _eq(sj, st, f"state' t={t}")
        _eq(oj, ot, f"outs t={t}")
    assert int(np.asarray(oj.n_committed).sum()) > 0


def _emulate_kernels(monkeypatch):
    """Replace the CUDA kernel wrappers with plain-PyTorch emulations that
    honour the same preallocated-output contract, and make the dispatch
    predicate treat CPU tensors as on the card."""

    def _fill(dst, src):
        if dst is None:
            return src
        dst.copy_(src)
        return dst

    def _fill_state(dst, src):
        if dst is None:
            return src
        for d, s in zip(dst, src):
            d.copy_(s)
        return dst

    def step(state, gvec, heard, req_vid, want_coord, my_id, cfg, *,
             with_blob=True, out_state=None, heat=None, heat_out=None,
             out_vec=None, out_blob=None, launch_log=None):
        if out_state is not None:
            ptrs = lambda st: {x.untyped_storage().data_ptr() for x in st}
            assert not ptrs(out_state) & ptrs(state)
        p_st, p_out = te.step_plain(state, te.unpack_gathered(gvec, cfg),
                                    heard, req_vid, want_coord, my_id, cfg)
        new = _fill_state(out_state, p_st)
        out_vec = _fill(out_vec, te.pack_out(p_out))
        blob = None
        if with_blob:
            blob = _fill(out_blob, te.pack_blob(te.make_blob_plain(new)))
        if heat is not None:
            heat_out = _fill(heat_out, heat + p_out.n_committed + p_out.n_admitted)
        te.LAUNCHES["gp_step"] += 1
        if launch_log is not None:
            launch_log["gp_step"] = launch_log.get("gp_step", 0) + 1
        return new, out_vec, blob, heat_out

    def _stacked_once(states, blobs, heard, req_vid, want_coord, cfg):
        g = te.unpack_gathered(blobs, cfg)
        news, outs = [], []
        for r in range(cfg.n_replicas):
            s = te.EngineState(*(x[r] for x in states))
            ns, o = te.step_plain(s, g, heard[r], req_vid[r], want_coord[r], r, cfg)
            news.append(ns)
            outs.append(te.pack_out(o))
        return tspmd.stack_states(news), torch.stack(outs)

    def step_stacked(states, blobs, heard, req_vid, want_coord, cfg, *,
                     out_states=None, out_blobs=None, out_mat=None,
                     launch_log=None, flags=None):
        # flags (the tile route's quiescence flags) only let a launch skip
        # work whose result it would write all the same: the plain step
        if blobs is None:
            # no matrix: the launch encodes its tiles' rows itself
            assert cfg.n_replicas <= gp_kernels.MAX_CLUSTER
            blobs = _blob_rows(states, cfg.n_replicas)
        new, mat = _stacked_once(states, blobs, heard, req_vid, want_coord, cfg)
        new = _fill_state(out_states, new)
        out_mat = _fill(out_mat, mat)
        if out_blobs is not None:
            out_blobs.copy_(_blob_rows(new, cfg.n_replicas))
        te.LAUNCHES["gp_step"] += 1
        if launch_log is not None:
            launch_log["gp_step"] = launch_log.get("gp_step", 0) + 1
        return new, out_mat, out_blobs

    def step_n(state, gvec, heard, req_ring, want_coord, my_id, cfg, *,
               out_state=None, heat=None, heat_out=None, out_rings=None,
               out_blob=None, launch_log=None):
        # the N substeps of one launch: MY row refreshed from the advancing
        # state, peers' rows as passed, want at substep 0 only
        g0 = te.unpack_gathered(gvec, cfg)
        st, rows, h = state, [], heat
        for i in range(req_ring.shape[0]):
            g = g0
            if i > 0:
                g = type(g0)(*(tspmd._replace_row(gl, my_id, bl)
                               for gl, bl in zip(g0, te.make_blob_plain(st))))
            w = want_coord if i == 0 else torch.zeros_like(want_coord)
            st, o = te.step_plain(st, g, heard, req_ring[i], w, my_id, cfg)
            rows.append(te.pack_out(o))
            if h is not None:
                h = h + o.n_committed + o.n_admitted
        new = _fill_state(out_state, st)
        out_rings = _fill(out_rings, torch.stack(rows))
        blob = _fill(out_blob, te.pack_blob(te.make_blob_plain(new)))
        if heat is not None:
            heat_out = _fill(heat_out, h)
        te.LAUNCHES["gp_step_n"] += 1
        if launch_log is not None:
            launch_log["gp_step_n"] = launch_log.get("gp_step_n", 0) + 1
        return new, out_rings, blob, heat_out

    def step_cluster(states, heard, req_vid, want_coord, cfg, *,
                     out_states=None, out_mat=None, launch_log=None):
        # every replica advancing each substep, the blob rows re-made from
        # the advancing states, want at substep 0 only
        assert cfg.n_replicas <= gp_kernels.MAX_CLUSTER
        st, mats = states, []
        for i in range(req_vid.shape[0]):
            w = want_coord if i == 0 else torch.zeros_like(want_coord)
            st, mat = _stacked_once(st, _blob_rows(st, cfg.n_replicas), heard,
                                    req_vid[i], w, cfg)
            mats.append(mat)
        new = _fill_state(out_states, st)
        out_mat = _fill(out_mat, torch.stack(mats))
        te.LAUNCHES["gp_step_cluster"] += 1
        if launch_log is not None:
            launch_log["gp_step_cluster"] = launch_log.get("gp_step_cluster", 0) + 1
        return new, out_mat

    def _blob_rows(states, n_rep):
        if n_rep is None:
            return te.pack_blob(te.make_blob_plain(states))
        return torch.stack([
            te.pack_blob(te.make_blob_plain(te.EngineState(*(x[r] for x in states))))
            for r in range(n_rep)
        ])

    def make_blob_rows(states, n_rep=None, launch_log=None, out=None):
        te.LAUNCHES["gp_make_blob"] += 1
        if launch_log is not None:
            launch_log["gp_make_blob"] = launch_log.get("gp_make_blob", 0) + 1
        return _fill(out, _blob_rows(states, n_rep))

    def make_blob_vec(state, launch_log=None):
        return make_blob_rows(state, None, launch_log)

    monkeypatch.setattr(te, "on_card", lambda t: True)
    monkeypatch.setattr(gp_kernels, "step", step)
    monkeypatch.setattr(gp_kernels, "step_stacked", step_stacked)
    monkeypatch.setattr(gp_kernels, "step_n", step_n)
    monkeypatch.setattr(gp_kernels, "step_cluster", step_cluster)
    monkeypatch.setattr(gp_kernels, "make_blob_rows", make_blob_rows)
    monkeypatch.setattr(gp_kernels, "make_blob_vec", make_blob_vec)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("donate", [False, True])
def test_kernel_path_orchestration_matches_plain(monkeypatch, n, donate):
    cfg = te.EngineConfig(G, W, K, R)
    rng = np.random.default_rng(3 * n + donate)
    states = tspmd.build_replica_states(cfg, device="cpu")
    req = np.where(rng.random((R, G, K)) < 0.6,
                   rng.integers(1, 10 ** 6, (R, G, K)), NULL).astype(np.int32)
    states, _ = tspmd.make_step(cfg, None, 1, donate=False, device="cpu")(
        states, req, np.zeros((R, G), bool))
    per = [te.EngineState(*(x[r].clone() for x in states)) for r in range(R)]
    gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in per])
    ring = torch.as_tensor(_ring(rng, n, (np.arange(G) % R), 1))
    want = torch.as_tensor(rng.random(G) < 0.2)
    heard = torch.ones(R, dtype=torch.bool)
    heat = torch.zeros(G, dtype=torch.int32)
    packed = tspmd.make_step(cfg, None, n, donate=donate, io="packed_host",
                             heat=True, device="cpu")
    stacked = tspmd.make_step(cfg, None, n, donate=donate, device="cpu")
    sreq = rng.integers(1, 10 ** 6, (n, R, G, K)).astype(np.int32)
    sreq = sreq if n > 1 else sreq[0]
    swant = rng.random((R, G)) < 0.2
    # plain path first (the real dispatch on CPU tensors)
    p1 = packed(per[1], gvec, heard, ring, want, 1, heat)
    p2 = packed(p1[0], gvec, heard, ring, want, 1, p1[3])
    ps1 = stacked(states, sreq, swant)
    ps2 = stacked(ps1[0], sreq, swant)
    _emulate_kernels(monkeypatch)
    te.reset_launch_counts()
    st1 = te.EngineState(*(x.clone() for x in per[1]))
    k1 = packed(st1, gvec, heard, ring, want, 1, heat.clone())
    for a, b in zip(k1[0], p1[0]):
        assert torch.equal(a, b)
    for j in (1, 2, 3):
        assert torch.equal(k1[j], p1[j]), j
    k2 = packed(k1[0], gvec, heard, ring, want, 1, k1[3])
    for a, b in zip(k2[0], p2[0]):
        assert torch.equal(a, b)
    for j in (1, 2, 3):
        assert torch.equal(k2[j], p2[j]), j
    # one launch a packed dispatch at any N
    assert te.LAUNCHES["gp_step" if n == 1 else "gp_step_n"] == 2
    assert te.LAUNCHES["gp_step_n" if n == 1 else "gp_step"] == 0
    sst = te.EngineState(*(x.clone() for x in states))
    ks1 = stacked(sst, sreq, swant)
    _eq(ps1[0], ks1[0], "stacked state 1")
    _eq(ps1[1], ks1[1], "stacked outs 1")
    ks2 = stacked(ks1[0], sreq, swant)
    _eq(ps2[0], ks2[0], "stacked state 2")
    _eq(ps2[1], ks2[1], "stacked outs 2")
    # the stacked face: one launch a dispatch and no blob launch; N > 1 a
    # cluster launch, N = 1 a stacked gp_step (beside the packed face's 2)
    if n == 1:
        assert (te.LAUNCHES["gp_make_blob"], te.LAUNCHES["gp_step"],
                te.LAUNCHES["gp_step_cluster"]) == (0, 2 + 2, 0)
    else:
        assert (te.LAUNCHES["gp_make_blob"], te.LAUNCHES["gp_step"],
                te.LAUNCHES["gp_step_cluster"]) == (0, 0, 2)
    if not donate:
        # donate=False leaves every input untouched
        for a, b in zip(sst, states):
            assert torch.equal(a, b)


def test_make_step_validates_and_memoizes():
    cfg = te.EngineConfig(G, W, K, R)
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, None, 0, device="cpu")
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, None, 1, io="nope", device="cpu")
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, None, 1, io="stacked", heat=True, device="cpu")
    mesh = tmesh.make_group_mesh(2, devices=["cpu"] * 2)
    assert tspmd.make_step(cfg, mesh, 1) is tspmd.make_step(cfg, mesh, 1)
    packed = tspmd.make_step(cfg, mesh, 1, io="packed_host")
    assert packed is tspmd.make_step(cfg, mesh, 1, io="packed_host")
    assert "packed_host" in packed.label and "mesh=g2" in packed.label
    a = tspmd.make_step(cfg, None, 2, device="cpu")
    assert a is tspmd.make_step(cfg, None, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tspmd.make_step(cfg, None, 1)
