"""The port's group-sharded mode against the JAX package's
(``tests/test_group_sharded.py``).

The 4-step schedule of requests, an election pulse under a dropped peer
and more requests runs through the JAX package's ``group_sharded_step``
on its 8 virtual CPU devices and through the port's on a ``('g',)`` mesh
of 8 repeated ``cpu`` devices, from the same inputs, at G=16 and at G=13
(padded to 16): every state leaf and every ``StepOutputs`` field is
bit-equal after every step, and equal to the port's single-device step.
Then the padding helpers, the mesh constructors and the runtime mesh
descriptor behind the ``stats`` admin op (a sharded state, one device,
host data), and through ``manager.mesh_info``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops.ballot import NULL, ballot_coord
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd

CPU8 = ["cpu"] * 8


def _parity_schedule(cfg):
    """``test_group_sharded.py``'s schedule: [(req, want, heard), ...]."""
    R, G, K = cfg.n_replicas, cfg.n_groups, cfg.req_lanes
    steps = []
    req = np.full((R, G, K), NULL, np.int32)
    req[0, 0, :2] = [5, 6]
    req[1, 1 % G, 0] = 7
    steps.append((req, np.zeros((R, G), bool), None))
    steps.append((np.full((R, G, K), NULL, np.int32), np.zeros((R, G), bool), None))
    heard = np.ones((R, R), bool)
    heard[:, R - 1] = False
    want = np.zeros((R, G), bool)
    want[1, :] = True
    steps.append((np.full((R, G, K), NULL, np.int32), want, heard))
    req = np.full((R, G, K), NULL, np.int32)
    req[:, :, 0] = 9
    steps.append((req, np.zeros((R, G), bool), None))
    return steps


def _eq(a, b, what):
    for f in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)).astype(np.int32), np.asarray(getattr(b, f)),
            err_msg=f"{what}: {f}")


def _assert_parity(G, n_devices=8):
    jcfg = JConfig(n_groups=G, window=8, req_lanes=4, n_replicas=3)
    cfg = EngineConfig(n_groups=G, window=8, req_lanes=4, n_replicas=3)
    R, K = 3, 4
    Gp = tspmd.padded_group_count(G, n_devices)
    jm = jmesh.make_group_mesh(n_devices)
    tm = tmesh.make_group_mesh(n_devices, devices=CPU8)
    j_gs = jspmd.group_sharded_step(jcfg, jm)
    t_gs = tspmd.group_sharded_step(cfg, tm)
    t_vm = tspmd.single_chip_step(cfg, device="cpu")
    empty = (np.full((R, G, K), NULL, np.int32), np.zeros((R, G), bool))
    sj, _, _ = jspmd.shard_group_inputs(jm, jcfg, jspmd.build_replica_states(jcfg), *empty)
    st, _, _ = tspmd.shard_group_inputs(
        tm, cfg, tspmd.build_replica_states(cfg, device="cpu"), *empty)
    assert st.bal.shape == (R, Gp) and st.bal.shard_groups == Gp // n_devices
    sv = tspmd.build_replica_states(cfg, device="cpu")
    for t, (req, want, heard) in enumerate(_parity_schedule(cfg)):
        req_p, want_p = (np.asarray(x) for x in tspmd.pad_group_inputs(cfg, n_devices, req, want))
        sj, oj = j_gs(sj, jnp.asarray(req_p), jnp.asarray(want_p),
                      None if heard is None else jnp.asarray(heard))
        st, ot = t_gs(st, req_p, want_p, heard)
        sv, ov = t_vm(sv, req, want, heard)
        _eq(sj, st, f"state @ step {t}")
        _eq(oj, ot, f"outs @ step {t}")
        _eq(sv, tspmd.strip_group_pad(st, G), f"vs single device, state @ step {t}")
        _eq(ov, tspmd.strip_group_pad(ot, G), f"vs single device, outs @ step {t}")
    assert np.asarray(sv.exec_slot).max() >= 1
    return st


def test_group_sharded_parity_8dev():
    st = _assert_parity(16)
    d = tmesh.describe_state_mesh(st.bal)
    assert d["n_devices"] == 8 and d["physical_devices"] == 1


def test_group_sharded_parity_nondivisible_g():
    """G=13 over 8 shards: the padded edge shards perturb no real group,
    and the inert pad tail stays bit-frozen."""
    st = _assert_parity(13)
    assert tspmd.padded_group_count(13, 8) == 16
    assert (np.asarray(st.member_mask)[:, 13:] == 0).all()
    assert (np.asarray(st.exec_slot)[:, 13:] == 0).all()


def test_group_sharded_commits_end_to_end():
    """Coordinator-routed traffic for 10 steps on both packages: commits
    flow on every group, and the two end states are equal."""
    R, G, K = 3, 8, 2
    jcfg, cfg = JConfig(G, 8, K, R), EngineConfig(G, 8, K, R)
    jm, tm = jmesh.make_group_mesh(8), tmesh.make_group_mesh(8, devices=CPU8)
    j_fn, t_fn = jspmd.group_sharded_step(jcfg, jm), tspmd.group_sharded_step(cfg, tm)
    empty = (np.full((R, G, K), NULL, np.int32), np.zeros((R, G), bool))
    sj, _, _ = jspmd.shard_group_inputs(jm, jcfg, jspmd.build_replica_states(jcfg), *empty)
    st, _, _ = tspmd.shard_group_inputs(
        tm, cfg, tspmd.build_replica_states(cfg, device="cpu"), *empty)
    vid = 1
    for _ in range(10):
        req = np.full((R, G, K), NULL, np.int32)
        coord = ballot_coord(np.asarray(st.bal)[0])
        for g in range(G):
            req[int(coord[g]), g, 0] = vid
            vid += 1
        sj, _ = j_fn(sj, jnp.asarray(req), jnp.zeros((R, G), bool))
        st, _ = t_fn(st, req, np.zeros((R, G), bool))
    _eq(sj, st, "end state")
    fr = np.asarray(st.exec_slot)
    assert (fr == fr[0]).all() and fr.min() >= 6
    h = np.asarray(st.app_hash)
    assert (h == h[0]).all() and (h[0] != 0).all()


def test_padding_helpers_match_the_reference():
    for g, n in ((16, 8), (13, 8), (1, 8), (17, 8), (7, 1)):
        assert tspmd.padded_group_count(g, n) == jspmd.padded_group_count(g, n)
    jcfg, cfg = JConfig(5, 8, 2, 3), EngineConfig(5, 8, 2, 3)
    pj = jspmd.pad_group_states(jcfg, jspmd.build_replica_states(jcfg), 4)
    pt = tspmd.pad_group_states(cfg, tspmd.build_replica_states(cfg, device="cpu"), 4)
    assert pt.bal.shape == (3, 8)
    _eq(pj, pt, "pad_group_states")
    assert (pt.member_mask[:, 5:] == 0).all() and (pt.bal[:, 5:] == NULL).all()
    req = np.arange(3 * 5 * 2, dtype=np.int32).reshape(3, 5, 2)
    want = np.ones((3, 5), bool)
    rj, wj = jspmd.pad_group_inputs(jcfg, 4, req, want)
    rt, wt = tspmd.pad_group_inputs(cfg, 4, req, want)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())


def test_sharded_tensor_reads_back_the_global_value():
    """A global tensor split over both mesh kinds (with a pad) reads back
    whole through ``gather`` and ``np.asarray``; every shard is its own
    copy on its logical device."""
    x = torch.arange(3 * 13 * 4, dtype=torch.int32).reshape(3, 13, 4)
    for mesh, spec in ((tmesh.make_group_mesh(8, devices=CPU8), (None, "g")),
                       (tmesh.make_mesh(3, 2, devices=CPU8), ("r", "g"))):
        sh = tspmd._shard(x, mesh, spec, -1)
        assert sh.shape == x.shape and sh.dtype == x.dtype
        assert torch.equal(sh.gather(), x)
        np.testing.assert_array_equal(np.asarray(sh), x.numpy())
        assert all(s.data_ptr() != x.data_ptr() for s in sh.shards.flat)
        last = sh.shards.flat[-1]
        assert (last.narrow(1, last.shape[1] - 1, 1) == -1).all()   # the pad


def test_make_group_mesh_shapes():
    for n in (1, 2, 4, 8):
        assert dict(tmesh.make_group_mesh(n, devices=CPU8).shape) == {"g": n}
    assert dict(tmesh.make_group_mesh(devices=CPU8).shape) == {"g": 8}
    with pytest.raises(ValueError, match="need 9 devices"):
        tmesh.make_group_mesh(9, devices=CPU8)


def test_describe_state_mesh():
    """The stats-op mesh descriptor: a sharded state reports its mesh, a
    tensor one device, host data no device (never raises); on the JAX
    package's keys, plus physical_devices."""
    cfg = EngineConfig(n_groups=8, window=8, req_lanes=2, n_replicas=3)
    tm = tmesh.make_group_mesh(8, devices=CPU8)
    st, _r, _w = tspmd.shard_group_inputs(
        tm, cfg, tspmd.build_replica_states(cfg, device="cpu"),
        np.full((3, 8, 2), NULL, np.int32), np.zeros((3, 8), bool))
    d = tmesh.describe_state_mesh(st.bal)
    assert d == {"n_devices": 8, "shape": {"g": 8}, "platform": "cpu",
                 "physical_devices": 1}
    gr = tspmd.replicate_inputs(tmesh.make_mesh(3, 2, devices=CPU8),
                                tspmd.build_replica_states(cfg, device="cpu"),
                                np.full((3, 8, 2), NULL, np.int32),
                                np.zeros((3, 8), bool))[0]
    assert tmesh.describe_state_mesh(gr.bal)["shape"] == {"g": 2, "r": 3}
    single = tmesh.describe_state_mesh(torch.zeros(4, dtype=torch.int32))
    assert single["n_devices"] == 1 and single["platform"] == "cpu"
    host = tmesh.describe_state_mesh(np.zeros((4,), np.int32))
    assert host["platform"] == "host" and host["n_devices"] == 0
    jd = jmesh.describe_state_mesh(jnp.zeros((4,), jnp.int32))
    assert set(jd) == set(single) - {"physical_devices"}


def test_manager_mesh_info():
    """``manager.mesh_info`` (the ``stats`` admin op's ``engine.mesh``,
    which ``tests/test_torch_device_obs.py`` reads over a socket) reports
    the devices behind the engine state: one CPU device for a manager's
    own state, the mesh for a sharded one."""
    from gigapaxos_tpu_torch.manager import PaxosManager
    from gigapaxos_tpu_torch.models.apps import NoopPaxosApp

    cfg = EngineConfig(n_groups=8, window=8, req_lanes=2, n_replicas=3)
    m = PaxosManager(0, NoopPaxosApp(), cfg, device="cpu")
    assert m.mesh_info() == {"n_devices": 1, "shape": {}, "platform": "cpu",
                             "physical_devices": 1}
    tm = tmesh.make_group_mesh(4, devices=["cpu"] * 4)
    sharded = tspmd.shard_group_inputs(
        tm, cfg, tspmd.build_replica_states(cfg, device="cpu"),
        np.full((3, 8, 2), NULL, np.int32), np.zeros((3, 8), bool))[0]
    m.state = m.state._replace(bal=sharded.bal)
    assert m.mesh_info() == {"n_devices": 4, "shape": {"g": 4}, "platform": "cpu",
                             "physical_devices": 1}
