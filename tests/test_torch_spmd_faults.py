"""Faults through the port's mesh faces (``tests/test_spmd_faults.py``).

The crash / election / carryover / catch-up schedule of the JAX file
drives the port's single-device step and its ``(g=2, r=3)`` mesh step
(on repeated ``cpu`` devices), and both must equal the port's host
simulator (``testing/sim.py``, per-link delivery matrices) and the JAX
package's mesh step on its 8 virtual CPU devices, bit for bit: the dead
peer is masked out of quorums with each device's own row of ``heard``.
Then the 2/1 partition that heals, on both packages.
"""

import jax.numpy as jnp
import numpy as np

from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.ops.lifecycle import initial_coordinator as j_coord0
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops.ballot import NULL, ballot_coord
from gigapaxos_tpu_torch.ops.engine import EngineConfig
from gigapaxos_tpu_torch.ops.lifecycle import initial_coordinator
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd
from gigapaxos_tpu_torch.testing.sim import DELIVER, DROP, SimCluster

R, G, K, W = 3, 8, 4, 8
CFG = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
JCFG = JConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
CPU6 = ["cpu"] * 6


def _coord0():
    return initial_coordinator(np.arange(G), np.full(G, (1 << R) - 1))


def _schedule():
    """``test_spmd_faults.py``'s storyline: traffic (steps 0-3), replica 0
    crashed (4-9) with an election pulse on replica 1 at step 5, rejoin
    and catch-up (10-17)."""
    steps, vid = [], 1
    coord0 = np.asarray(_coord0())
    for t in range(18):
        delivery = np.full((R, R), DELIVER)
        if 4 <= t <= 9:
            delivery[0, :] = DROP
            delivery[:, 0] = DROP
        req = np.full((R, G, K), NULL, np.int32)
        if t <= 3:
            for g in range(G):
                req[int(coord0[g]), g, 0] = vid
                vid += 1
        elif t <= 9:
            for g in range(G):
                req[0, g, 0] = vid
                vid += 1
                req[1, g, 0] = vid
                vid += 1
        want = np.zeros((R, G), bool)
        if t == 5:
            want[1, :] = True
        steps.append((delivery, req, want))
    return steps


def _run_sim(schedule):
    sim = SimCluster(CFG, device="cpu")
    sim.create_all_groups()
    for delivery, req, want in schedule:
        sim.step_all(reqs={i: req[i] for i in range(R)},
                     want_coord={i: want[i] for i in range(R)}, delivery=delivery)
    return sim


def _assert_equals_sim(states, sim):
    for name in states._fields:
        got = np.asarray(getattr(states, name))
        exp = np.stack([getattr(s, name).numpy() for s in sim.states])
        np.testing.assert_array_equal(got, exp, err_msg=name)


def _reference(schedule):
    """The JAX package's (g=2, r=3) mesh step over the schedule."""
    assert np.array_equal(np.asarray(j_coord0(np.arange(G), np.full(G, 7))),
                          np.asarray(_coord0()))
    fn = jspmd.spmd_step(JCFG, jmesh.make_mesh(n_replicas=R, n_group_shards=2))
    st = jspmd.build_replica_states(JCFG, coord0=np.asarray(_coord0()))
    for delivery, req, want in schedule:
        st, _ = fn(st, jnp.asarray(req), jnp.asarray(want),
                   jnp.asarray(delivery == DELIVER))
    return st


def test_single_chip_faults_match_host_sim():
    schedule = _schedule()
    sim = _run_sim(schedule)
    fn = tspmd.single_chip_step(CFG, device="cpu")
    states = tspmd.build_replica_states(CFG, coord0=_coord0(), device="cpu")
    for delivery, req, want in schedule:
        states, _ = fn(states, req, want, delivery == DELIVER)
    _assert_equals_sim(states, sim)
    assert (ballot_coord(np.asarray(states.bal)) == 1).all()
    fr = np.asarray(states.exec_slot)
    assert fr.min() >= 4 and fr.max() >= 10 and (fr == fr[0]).all(), fr


def test_spmd_faults_match_host_sim():
    """The same schedule through the (g, r) mesh: equal to the simulator
    and to the JAX package's mesh step, leaf for leaf (int32)."""
    schedule = _schedule()
    sim = _run_sim(schedule)
    fn = tspmd.spmd_step(CFG, tmesh.make_mesh(n_replicas=R, n_group_shards=2,
                                              devices=CPU6))
    states = tspmd.build_replica_states(CFG, coord0=_coord0(), device="cpu")
    for delivery, req, want in schedule:
        states, _ = fn(states, req, want, delivery == DELIVER)
    _assert_equals_sim(states, sim)
    ref = _reference(schedule)
    for name in states._fields:
        got = np.asarray(getattr(states, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), got, err_msg=name)
    assert (ballot_coord(np.asarray(states.bal)) == 1).all()
    fr = np.asarray(states.exec_slot)
    assert (fr == fr[0]).all() and fr.min() >= 4 and fr.max() >= 10, fr


def test_spmd_partition_heals():
    """Replica 2 isolated for steps 3-8 on the mesh path: the majority
    commits, the minority freezes, and after the heal it catches up
    bit-exactly (simulator and JAX package alike)."""
    sim = SimCluster(CFG, device="cpu")
    sim.create_all_groups()
    mesh = tmesh.make_mesh(n_replicas=R, n_group_shards=2, devices=CPU6)
    fn = tspmd.spmd_step(CFG, mesh)
    jfn = jspmd.spmd_step(JCFG, jmesh.make_mesh(n_replicas=R, n_group_shards=2))
    states = tspmd.build_replica_states(CFG, coord0=_coord0(), device="cpu")
    sj = jspmd.build_replica_states(JCFG, coord0=np.asarray(_coord0()))
    coord0 = np.asarray(_coord0())
    vid = 1
    for t in range(16):
        delivery = np.full((R, R), DELIVER)
        if 3 <= t <= 8:
            delivery[2, :] = DROP
            delivery[:, 2] = DROP
        req = np.full((R, G, K), NULL, np.int32)
        for g in range(G):
            req[int(coord0[g]), g, 0] = vid
            vid += 1
        want = np.zeros((R, G), bool)
        sim.step_all(reqs={i: req[i] for i in range(R)},
                     want_coord={i: want[i] for i in range(R)}, delivery=delivery)
        states, _ = fn(states, req, want, delivery == DELIVER)
        sj, _ = jfn(sj, jnp.asarray(req), jnp.asarray(want),
                    jnp.asarray(delivery == DELIVER))
        if t == 8:
            fr = np.asarray(states.exec_slot)
            assert fr[:2].min() > fr[2].max(), fr
    _assert_equals_sim(states, sim)
    for name in states._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      np.asarray(getattr(states, name)), err_msg=name)
    fr = np.asarray(states.exec_slot)
    assert (fr == fr[0]).all() and fr.min() >= 12
