"""The port's ``make_step`` over meshes against the JAX package's.

The golden cases of ``tests/test_unified_step.py``: single device, the
1-D ``('g',)`` group shard over 8 devices and the ``(g, r)`` mesh of 2 x 3,
N in {1, 4}, G in {16, 13} (13 divides over neither mesh, so both pad).  The
JAX side runs on the conftest's 8 virtual CPU devices, the port on meshes
of repeated ``cpu`` devices; the same seeded schedule goes through both,
and every state leaf and every ``StepOutputs`` field must be bit-equal,
after every dispatch.
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

NULL = -1
CPU8 = ["cpu"] * 8
MESHES = {
    "single_device": (lambda: None, lambda: None),
    "gshard8": (lambda: jmesh.make_group_mesh(8),
                lambda: tmesh.make_group_mesh(8, devices=CPU8)),
    "gr_mesh": (lambda: jmesh.make_mesh(n_replicas=3, n_group_shards=2),
                lambda: tmesh.make_mesh(3, 2, devices=CPU8)),
}
G, W, K, R = 13, 8, 4, 3   # the multistep and placement tests' shape
STEPS = 8   # two dispatches at N=4


def _eq(a, b, what):
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = np.asarray(getattr(b, f))
        assert x.shape == y.shape, f"{what}: {f} {x.shape} vs {y.shape}"
        np.testing.assert_array_equal(x.astype(np.int32), y, err_msg=f"{what}: {f}")


def _schedule(rng, coord, G=G):
    """Coordinator-routed requests plus random extra lanes; an election
    pulse at step 0 only (want_coord fires at substep 0 of a dispatch)."""
    reqs, vid = [], 1
    for _ in range(STEPS):
        req = np.full((R, G, K), NULL, np.int32)
        for g in range(G):
            req[int(coord[g]), g, 0] = vid
            vid += 1
        req[:, :, 1] = np.where(rng.random((R, G)) < 0.3, vid + np.arange(G), NULL)
        vid += G
        reqs.append(req)
    wants = [np.zeros((R, G), bool) for _ in range(STEPS)]
    wants[0][0, 0] = True
    wants[0][2, 5] = True
    return reqs, wants


def _dispatches(n, reqs, wants):
    for d in range(STEPS // n):
        sl = slice(d * n, (d + 1) * n)
        yield (reqs[d * n] if n == 1 else np.stack(reqs[sl])), wants[d * n]


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("G", [16, 13])
def test_unified_step_matches_reference(mesh_key, n, G):
    cfg_j = je.EngineConfig(G, W, K, R)
    cfg_t = te.EngineConfig(G, W, K, R)
    jm, tm = (f() for f in MESHES[mesh_key])
    fj = jspmd.make_step(cfg_j, jm, n, donate=False)
    ft = (tspmd.make_step(cfg_t, None, n, donate=False, device="cpu") if tm is None
          else tspmd.make_step(cfg_t, tm, n, donate=False))
    sj = jspmd.build_replica_states(cfg_j)
    st = tspmd.build_replica_states(cfg_t, device="cpu")
    reqs, wants = _schedule(np.random.default_rng(7 + n), np.arange(G) % R, G)
    for d, (req, want) in enumerate(_dispatches(n, reqs, wants)):
        sj, oj = fj(sj, jnp.asarray(req), jnp.asarray(want))
        st, ot = ft(st, req, want)
        _eq(sj, st, f"state[{mesh_key},N={n},d={d}]")
        _eq(oj, ot, f"outs[{mesh_key},N={n},d={d}]")
    if tm is not None:
        assert isinstance(st.bal, tmesh.ShardedTensor)
        assert st.bal.shape == (R, G) and st.bal.mesh == tm
        assert ot.n_committed.shape == ((R, G) if n == 1 else (n, R, G))
    # the schedule did real work (not vacuous parity)
    assert int(np.asarray(st.exec_slot).min()) >= STEPS - 4


@pytest.mark.parametrize("mesh_key", ["gshard8", "gr_mesh"])
def test_mesh_multistep_equals_sequential(mesh_key):
    """N=4 residency on a mesh == 4 sequential N=1 calls, every leaf and
    every per-substep output field."""
    cfg = te.EngineConfig(G, W, K, R)
    tm = MESHES[mesh_key][1]()
    fn1 = tspmd.make_step(cfg, tm, 1, donate=False)
    fn4 = tspmd.make_step(cfg, tm, 4, donate=False)
    reqs, wants = _schedule(np.random.default_rng(3), np.arange(G) % R)
    s1 = s4 = tspmd.build_replica_states(cfg, device="cpu")
    outs1 = []
    for t in range(4):
        s1, o = fn1(s1, reqs[t], wants[0] if t == 0 else np.zeros((R, G), bool))
        outs1.append(o)
    s4, o4 = fn4(s4, np.stack(reqs[:4]), wants[0])
    _eq(s1, s4, "state")
    for i, o in enumerate(outs1):
        _eq(o, te.StepOutputs(*(np.asarray(x)[i] for x in o4)), f"t={i}")


def test_sharded_state_feeds_back_without_a_gather(monkeypatch):
    """A sharded state on the step's own mesh is used as it is: the
    second call splits nothing but the new inputs."""
    cfg = te.EngineConfig(G, W, K, R)
    tm = tmesh.make_mesh(3, 2, devices=CPU8)
    fn = tspmd.make_step(cfg, tm, 1, donate=False)
    st = tspmd.build_replica_states(cfg, device="cpu")
    req = np.full((R, G, K), NULL, np.int32)
    want = np.zeros((R, G), bool)
    st, _ = fn(st, req, want)
    split = []
    real = tspmd._shard
    monkeypatch.setattr(tspmd, "_shard", lambda x, *a: split.append(x.shape) or real(x, *a))
    st2, _ = fn(st, req, want)
    assert split == [(R, G, K), (R, G)]
    assert st2.bal.shard_groups == st.bal.shard_groups == 7
    # each logical device holds its own tensors, even where devices repeat
    ptrs = {x.data_ptr() for x in st2.bal.shards.flat}
    assert len(ptrs) == tm.size


def test_make_step_mesh_validates_and_memoizes():
    cfg = te.EngineConfig(G, W, K, R)
    gm = tmesh.make_group_mesh(2, devices=["cpu"] * 2)
    assert tspmd.make_step(cfg, gm, 2) is tspmd.make_step(cfg, gm, 2)
    assert tspmd.make_step(cfg, gm, 2) is tspmd.make_step(
        cfg, tmesh.make_group_mesh(2, devices=["cpu"] * 2), 2)
    assert "mesh=g2" in tspmd.make_step(cfg, gm, 1).label
    packed = tspmd.make_step(cfg, gm, 1, io="packed_host", heat=True)
    assert packed is tspmd.make_step(cfg, gm, 1, io="packed_host", heat=True)
    assert "packed_host" in packed.label and "mesh=g2" in packed.label
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, gm, 1, device="cpu")
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, tmesh.make_mesh(2, 1, devices=["cpu"] * 2), 1)
    with pytest.raises(TypeError):
        tspmd.make_step(cfg, object(), 1)
    with pytest.raises(ValueError):
        tspmd.make_step(cfg, gm, 0)


def test_make_mesh_matches_the_reference():
    for r, g in ((3, 2), (2, 4), (1, 1)):
        tm, jm = tmesh.make_mesh(r, g, devices=CPU8), jmesh.make_mesh(r, g)
        assert list(tm.shape.items()) == list(jm.shape.items())
        assert tm.axis_names == jm.axis_names
        assert tm.physical_devices == 1 and tm.size == r * g
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tmesh.make_mesh(3, 3, devices=CPU8)


def test_meshes_need_a_card_unless_devices_are_given():
    if torch.cuda.is_available():
        pytest.skip("a card is present: devices=None is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_group_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(1, 1)

