"""The port's ``(g, r)`` acceptor mesh against the JAX package's
(``tests/test_spmd.py``), and the mesh faces' kernel orchestration.

* The counterparts of ``test_spmd.py``: the mesh shape picker, the
  single-device step's commits, the ``(g=2, r=3)`` mesh step (inputs
  placed by ``replicate_inputs``) equal to the single-device step, and
  the 2-replica ``(g=4, r=2)`` mesh; each against the JAX package's on
  its 8 virtual CPU devices, bit-equal.
* The kernel path's orchestration on both meshes, which cannot launch its
  CUDA kernels here: the kernel wrappers replaced by the plain emulations
  of ``tests/test_torch_spmd.py`` (``_emulate_kernels``), the mesh faces
  must give the plain path's results, with each logical device's own
  launch counts: on ``('g',)`` one ``gp_step_cluster`` per shard a call
  at N > 1, one ``gp_make_blob`` and one stacked ``gp_step`` at N = 1; on
  ``(g, r)`` one ``gp_make_blob`` per device, then one ``gp_step`` per
  device per substep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops.ballot import NULL, ballot_coord
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd
from test_torch_spmd import _emulate_kernels

CPU8 = ["cpu"] * 8


def _eq(a, b, what):
    for f in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)).astype(np.int32), np.asarray(getattr(b, f)),
            err_msg=f"{what}: {f}")


def _drive(step_fn, states, cfg, n_steps, to_input, vid0=1):
    """One request per group per step at the coordinator's row."""
    R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes
    vid, total = vid0, 0
    for _ in range(n_steps):
        req = np.full((R, G, K), NULL, np.int32)
        coord = ballot_coord(np.asarray(states.bal)[0])
        for g in range(G):
            req[int(coord[g]), g, 0] = vid
            vid += 1
        states, out = step_fn(states, to_input(req), to_input(np.zeros((R, G), bool)))
        total += int(np.asarray(out.n_committed)[0].sum())
    return states, total


def test_pick_mesh_shape():
    for n, want in ((8, (4, 2)), (6, (2, 3)), (3, (1, 3)), (1, (1, 1))):
        assert tmesh.pick_mesh_shape(n) == jmesh.pick_mesh_shape(n) == want
    assert tmesh.pick_mesh_shape(8, n_replicas=2) == (4, 2)
    with pytest.raises(ValueError):
        tmesh.pick_mesh_shape(8, n_replicas=3)


def test_single_chip_vmap_commits():
    cfg = te.EngineConfig(n_groups=8, window=8, req_lanes=4, n_replicas=3)
    jcfg = JConfig(8, 8, 4, 3)
    st, _ = _drive(tspmd.single_chip_step(cfg, device="cpu"),
                   tspmd.build_replica_states(cfg, device="cpu"), cfg, 12, lambda x: x)
    sj, _ = _drive(jspmd.single_chip_step(jcfg), jspmd.build_replica_states(jcfg),
                   jcfg, 12, jnp.asarray)
    _eq(sj, st, "12 steps")
    fr = np.asarray(st.exec_slot)
    assert (fr == fr[0]).all() and fr.min() >= 8
    h = np.asarray(st.app_hash)
    assert (h == h[0]).all() and (h[0] != 0).all()


def test_spmd_matches_single_chip():
    """The (g=2, r=3) mesh step equals the single-device step on the
    port, and the JAX package's mesh step, for 6 steps."""
    cfg = te.EngineConfig(n_groups=8, window=8, req_lanes=4, n_replicas=3)
    jcfg = JConfig(8, 8, 4, 3)
    tm = tmesh.make_mesh(n_replicas=3, n_group_shards=2, devices=CPU8)
    jm = jmesh.make_mesh(n_replicas=3, n_group_shards=2)
    vm = tspmd.single_chip_step(cfg, device="cpu")
    sm, jsm = tspmd.spmd_step(cfg, tm), jspmd.spmd_step(jcfg, jm)
    req = np.full((3, 8, 4), NULL, np.int32)
    req[0, 0, :2] = [5, 6]
    req[1, 1, 0] = 7
    want = np.zeros((3, 8), bool)
    sv = tspmd.build_replica_states(cfg, device="cpu")
    ss, req_s, want_s = tspmd.replicate_inputs(
        tm, tspmd.build_replica_states(cfg, device="cpu"), req, want)
    assert req_s.spec == ("r", "g") and req_s.shards.shape == (2, 3)
    sj, rj, wj = jspmd.replicate_inputs(jm, jspmd.build_replica_states(jcfg),
                                        jnp.asarray(req), jnp.asarray(want))
    quiet = np.full((3, 8, 4), NULL, np.int32)
    for t in range(6):
        r = req_s if t == 0 else quiet
        sv, ov = vm(sv, req if t == 0 else quiet, want)
        ss, os_ = sm(ss, r, want_s)
        sj, oj = jsm(sj, rj if t == 0 else jnp.asarray(quiet), wj)
        _eq(sv, ss, f"vs single device t={t}")
        _eq(ov, os_, f"outs vs single device t={t}")
        _eq(sj, ss, f"vs reference t={t}")
    fr = np.asarray(ss.exec_slot)
    assert fr[0, 0] == 2 and fr[0, 1] == 1
    with pytest.raises(ValueError, match="divide"):
        tspmd.spmd_step(te.EngineConfig(7, 8, 4, 3), tm)


def test_spmd_8dev_2replica_mesh():
    """8 devices -> (g=4, r=2) mesh: 2-replica groups, majority 2."""
    cfg = te.EngineConfig(n_groups=8, window=8, req_lanes=2, n_replicas=2)
    jcfg = JConfig(8, 8, 2, 2)
    st, total = _drive(tspmd.spmd_step(cfg, tmesh.make_mesh(2, 4, devices=CPU8)),
                       tspmd.build_replica_states(cfg, device="cpu"), cfg, 10,
                       lambda x: x)
    sj, total_j = _drive(jspmd.spmd_step(jcfg, jmesh.make_mesh(2, 4)),
                         jspmd.build_replica_states(jcfg), jcfg, 10, jnp.asarray)
    _eq(sj, st, "10 steps")
    assert total == total_j > 0
    fr = np.asarray(st.exec_slot)
    assert (fr == fr[0]).all() and fr.min() >= 6


MESHES = {"gshard4": lambda: tmesh.make_group_mesh(4, devices=["cpu"] * 4),
          "gr_mesh": lambda: tmesh.make_mesh(3, 2, devices=["cpu"] * 6)}


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("n", [1, 4])
def test_mesh_kernel_orchestration_matches_plain(monkeypatch, mesh_key, n):
    """The mesh faces with the kernels emulated: the plain path's
    results, the inputs untouched, and each device's launch counts."""
    G, W, K, R = 13, 8, 4, 3
    cfg = te.EngineConfig(G, W, K, R)
    mesh = MESHES[mesh_key]()
    fn = tspmd.make_step(cfg, mesh, n, donate=False)
    rng = np.random.default_rng(11 + n)
    shape = (n, R, G, K) if n > 1 else (R, G, K)
    reqs = [np.where(rng.random(shape) < 0.6, rng.integers(1, 10 ** 6, shape),
                     NULL).astype(np.int32) for _ in range(3)]
    wants = [rng.random((R, G)) < p for p in (0.3, 0.0, 0.1)]
    heards = [None, np.array([[1, 1, 0], [1, 1, 0], [1, 1, 1]], bool), None]
    states = tspmd.build_replica_states(cfg, device="cpu")
    plain = []
    st = states
    for req, want, heard in zip(reqs, wants, heards):
        st, out = fn(st, req, want, heard)
        plain.append((st, out))
    _emulate_kernels(monkeypatch)
    te.reset_launch_counts()
    fn.reset_launches()
    st = states
    snap = [x.clone() for x in states]
    for t, (req, want, heard) in enumerate(zip(reqs, wants, heards)):
        st, out = fn(st, req, want, heard)
        _eq(plain[t][0], st, f"state t={t}")
        _eq(plain[t][1], out, f"outs t={t}")
    for a, b in zip(snap, states):
        assert torch.equal(a, b)
    calls, n_dev = 3, mesh.size
    if n > 1 and "r" not in mesh.axis_names:
        # each ('g',) shard runs the stacked face: one cluster launch a call
        per_dev = {"gp_step_cluster": calls}
    else:
        # N = 1, and the (g, r) face, which exchanges between devices
        # every substep: a blob launch and N step launches a device
        per_dev = {"gp_make_blob": calls, "gp_step": calls * n}
    assert fn.launches == {idx: per_dev for idx in np.ndindex(*mesh.devices.shape)}
    for k, v in per_dev.items():
        assert te.LAUNCHES[k] == v * n_dev, k
    assert int(np.asarray(st.exec_slot).max()) > 0


def test_exchange_copies_every_peer_row(monkeypatch):
    """The (g, r) exchange: after it, every device of a g-row holds every
    peer's blob in that peer's row, in buffers of its own."""
    mesh = tmesh.make_mesh(3, 2, devices=["cpu"] * 6)
    cfg = te.EngineConfig(8, 8, 4, 3)
    fn = tspmd.make_step(cfg, mesh, 1).fn
    NB = 5
    bufs = {idx: torch.full((3, NB), -7, dtype=torch.int32)
            for idx in np.ndindex(2, 3)}
    for (gi, ri), b in bufs.items():
        b[ri] = 100 * gi + 10 * ri + torch.arange(NB, dtype=torch.int32)
    fn.exchange(bufs)
    for (gi, ri), b in bufs.items():
        for rj in range(3):
            assert torch.equal(b[rj], 100 * gi + 10 * rj + torch.arange(NB, dtype=torch.int32))
    assert len({b.data_ptr() for b in bufs.values()}) == 6
