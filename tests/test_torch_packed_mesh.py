"""The port's packed face on a mesh against the JAX package's
(``gigapaxos_tpu/parallel/spmd.py:_build_packed`` with a mesh: the state
and the heat accumulator pinned to ``P('g')``).

* Parity: ``make_step(cfg, mesh, N, io="packed_host")`` on the port's
  ``make_group_mesh(4)`` and ``make_mesh(3, 2)`` of logical CPU devices,
  at G=8 (divides over 'g') and G=6 (padded), N=1 and 4, heat on and
  off, donate on and off: two dispatches, the second fed the first's
  sharded state (and heat), with every state leaf, ``out_rings``,
  ``blob_vec`` and the heat bit-equal to the port's own ``mesh=None``
  face in every combination, and to the JAX package's face on its same
  meshes of 8 virtual CPU devices for every (mesh, G, N) with the four
  (heat, donate) pairs in turn.
* The kernel path's orchestration, which cannot launch its CUDA kernels
  here (the wrappers replaced by ``tests/test_torch_spmd.py``'s plain
  emulations): the mesh face gives its plain version's results, with N
  ``gp_step`` launches on every logical device, and the pad rows never
  reach the outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import engine as je
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd
from gigapaxos_tpu_torch.parallel.mesh import ShardedTensor
from test_torch_spmd import _emulate_kernels

NULL = -1
W, K, R = 8, 4, 3
CPU8 = ["cpu"] * 8
MESHES = {
    "g4": (lambda: tmesh.make_group_mesh(4, devices=CPU8),
           lambda: jmesh.make_group_mesh(4)),
    "g2r3": (lambda: tmesh.make_mesh(3, 2, devices=CPU8),
             lambda: jmesh.make_mesh(3, 2)),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq_state(a, b, what):
    for f in te.EngineState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)).astype(np.int32),
                                      _np(getattr(b, f)), err_msg=f"{what}: {f}")


def _inputs(G, N, seed):
    """One replica's warm state (after a stacked step, so the gathered rows
    differ from it), the packed gathered matrix with a stale self row, a
    request ring, an election pulse, a heat accumulator and a deaf peer."""
    cfg = te.EngineConfig(G, W, K, R)
    st = tspmd.build_replica_states(cfg, device="cpu")
    req0 = np.full((R, G, K), NULL, np.int32)
    req0[:, :, 0] = np.arange(100, 100 + G)
    st, _ = tspmd.make_step(cfg, None, 1, donate=False, device="cpu")(
        st, req0, np.zeros((R, G), bool))
    per = [te.EngineState(*(x[r].clone() for x in st)) for r in range(R)]
    gvec = torch.stack([te.pack_blob(te.make_blob(s)) for s in per]).numpy()
    rng = np.random.default_rng(seed)
    coord = np.asarray(st.bal)[0] & 31
    my_id = 1
    rings = []
    vid = 1
    for _ in range(2):
        ring = np.full((N, G, K), NULL, np.int32)
        for t in range(N):
            ring[t, :, 0] = np.where(coord == my_id, vid + np.arange(G), NULL)
            ring[t, :, 1] = np.where(rng.random(G) < 0.5, vid + G + np.arange(G), NULL)
            vid += 2 * G
        rings.append(ring)
    want = rng.random(G) < 0.25
    heat = rng.integers(0, 50, G).astype(np.int32)
    heard = np.array([True, True, False])
    return cfg, {f: x.numpy() for f, x in zip(te.EngineState._fields, per[my_id])}, \
        gvec, heard, rings, want, my_id, heat


def _snap(o):
    """A dispatch's outputs as private host arrays (a donated output is
    gone once it feeds the next dispatch)."""
    return (te.EngineState(*(np.array(x, copy=True) for x in o[0])),) + \
        tuple(np.array(x, copy=True) for x in o[1:])


def _two_dispatches(fn, state, gvec, heard, rings, want, my_id, heat, wrap, heat_on):
    """Two dispatches, the second fed the first's state (and heat);
    returns each one's snapshot and the last one's outputs."""
    snaps = []
    h = wrap(heat) if heat_on else None
    for i, ring in enumerate(rings):
        args = (state, wrap(gvec), wrap(heard), wrap(ring),
                wrap(want if i == 0 else np.zeros_like(want)), my_id)
        o = fn(*args, h) if heat_on else fn(*args)
        snaps.append(_snap(o))
        state = o[0]
        if heat_on:
            h = o[3]
    return snaps, o


def _assert_same(a, b, heat_on, what):
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        _eq_state(x[0], y[0], f"{what} dispatch {i} state")
        for j, name in ((1, "out_rings"), (2, "blob_vec")) + (((3, "heat"),) if heat_on else ()):
            np.testing.assert_array_equal(x[j], y[j], err_msg=f"{what} dispatch {i} {name}")


def _port(cfg, mesh, n, heat_on, donate, inputs):
    state, gvec, heard, rings, want, my_id, heat = inputs
    fn = tspmd.make_step(cfg, mesh, n, donate=donate, io="packed_host", heat=heat_on,
                         **({} if mesh is not None else {"device": "cpu"}))
    return _two_dispatches(fn, te.EngineState(**{k: torch.as_tensor(v.copy())
                                                 for k, v in state.items()}),
                           gvec, heard, rings, want, my_id, heat,
                           lambda x: torch.as_tensor(x.copy()), heat_on)


def _check_sharded(last, tm, G, n, cfg, heat_on):
    st = last[0]
    assert isinstance(st.bal, ShardedTensor) and st.bal.mesh == tm
    assert st.bal.spec == ("g",) and st.bal.n_groups == G
    assert st.bal.shard_groups == -(-G // tm.shape["g"])
    if heat_on:
        assert isinstance(last[3], ShardedTensor) and last[3].spec == ("g",)
    assert last[1].shape == (n, te.out_vec_len(cfg))
    assert last[2].shape == (te.blob_vec_len(cfg),)


@pytest.mark.parametrize("donate", [True, False], ids=["donate", "keep"])
@pytest.mark.parametrize("heat_on", [True, False], ids=["heat", "noheat"])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("G", [8, 6])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_packed_mesh_face_matches_one_device(mesh_key, G, n, heat_on, donate):
    """Every combination on the port: the mesh face equals ``mesh=None``
    over two dispatches, its state and heat come back sharded."""
    cfg, *inputs = _inputs(G, n, seed=G + n)
    tm = MESHES[mesh_key][0]()
    ot = _port(cfg, tm, n, heat_on, donate, inputs)
    o1 = _port(cfg, None, n, heat_on, donate, inputs)
    _assert_same(o1[0], ot[0], heat_on, "vs mesh=None")
    _check_sharded(ot[1], tm, G, n, cfg, heat_on)
    assert sum(int(te.split_out_vec(r, cfg).n_admitted.sum())
               for o in ot[0] for r in o[1]) > 0


# against the JAX package (a compile of its mesh program each): every
# (mesh, G, N), the four (heat, donate) pairs in turn, each pair twice
REFERENCE_CASES = [
    (mesh_key, G, n, *[(True, True), (True, False), (False, True), (False, False)][
        (2 * mi + gi + ni) % 4])
    for mi, mesh_key in enumerate(MESHES) for gi, G in enumerate((8, 6))
    for ni, n in enumerate((1, 4))]


@pytest.mark.parametrize("mesh_key,G,n,heat_on,donate", REFERENCE_CASES,
                         ids=[f"{m}-{g}-{n}-{'heat' if h else 'noheat'}-"
                              f"{'donate' if d else 'keep'}"
                              for m, g, n, h, d in REFERENCE_CASES])
def test_packed_mesh_face_matches_reference(mesh_key, G, n, heat_on, donate):
    """The port's mesh face equals the JAX package's on the same mesh over
    two dispatches: every state leaf, out_rings, blob_vec and the heat."""
    cfg, *inputs = _inputs(G, n, seed=G + n)
    state, gvec, heard, rings, want, my_id, heat = inputs
    tm, jm = (f() for f in MESHES[mesh_key])
    ot = _port(cfg, tm, n, heat_on, donate, inputs)
    fj = jspmd.make_step(je.EngineConfig(G, W, K, R), jm, n, donate=donate,
                         io="packed_host", heat=heat_on)
    oj = _two_dispatches(fj, je.EngineState(**{k: jnp.asarray(v) for k, v in state.items()}),
                         gvec, heard, rings, want, jnp.int32(my_id), heat,
                         jnp.asarray, heat_on)
    _assert_same(oj[0], ot[0], heat_on, "vs reference")
    _check_sharded(ot[1], tm, G, n, cfg, heat_on)


def test_reference_cases_cover_every_setting():
    assert {(m, g, n) for m, g, n, _h, _d in REFERENCE_CASES} == \
        {(m, g, n) for m in MESHES for g in (8, 6) for n in (1, 4)}
    assert {(h, d) for *_x, h, d in REFERENCE_CASES} == \
        {(h, d) for h in (True, False) for d in (True, False)}


@pytest.mark.parametrize("G", [8, 6])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_packed_mesh_kernel_orchestration_matches_plain(monkeypatch, mesh_key, G):
    """The kernel path (wrappers emulated) equals the mesh face's plain
    version, one gp_step_n launch (the N substeps) on every logical
    device; a (g, r) mesh runs each g-shard on every device of its row."""
    n = 4
    cfg, state, gvec, heard, rings, want, my_id, heat = _inputs(G, n, seed=3)
    tm = MESHES[mesh_key][0]()
    fn = tspmd.make_step(cfg, tm, n, donate=False, io="packed_host", heat=True)
    st = te.EngineState(**{k: torch.as_tensor(v) for k, v in state.items()})
    args = (st, gvec, heard, rings[0], want, my_id, heat)
    p = fn.plain(*args)
    _emulate_kernels(monkeypatch)
    fn.reset_launches()
    k = fn(*args)
    _assert_same([_snap(p)], [_snap(k)], True, "kernels vs plain")
    assert {idx: log for idx, log in fn.launches.items()} == \
        {idx: {"gp_step_n": 1} for idx in np.ndindex(*tm.devices.shape)}
    # every device of a g-row holds its own copy of the same shard
    sh = k[0].bal.shards
    if "r" in tm.axis_names:
        for gi in range(tm.shape["g"]):
            ptrs = {sh[gi, r].data_ptr() for r in range(R)}
            assert len(ptrs) == R
            for r in range(1, R):
                assert torch.equal(sh[gi, 0], sh[gi, r])


def test_pad_rows_stay_inert_and_out_of_the_outputs():
    """G=6 over 4 shards: the last shard is all pad.  The pad rows of the
    state stay at their init values after a dispatch, and the outputs
    carry only the real 6 groups."""
    n = 2
    cfg, state, gvec, heard, rings, want, my_id, heat = _inputs(6, n, seed=9)
    tm = MESHES["g4"][0]()
    fn = tspmd.make_step(cfg, tm, n, donate=False, io="packed_host", heat=True)
    st = te.EngineState(**{k: torch.as_tensor(v) for k, v in state.items()})
    o = fn(st, gvec, heard, rings[0], want, my_id, heat)
    fill = tspmd._state_fill()
    for f, x in zip(te.EngineState._fields, o[0]):
        assert x.shard_groups == 2
        assert (x.shards[3] == fill[f]).all(), f
        assert (x.shards[2].narrow(0, 0, 2) == torch.as_tensor(
            np.asarray(x)[4:6])).all(), f
    assert (o[3].shards[3] == 0).all()
    assert o[1].shape == (n, te.out_vec_len(cfg))
