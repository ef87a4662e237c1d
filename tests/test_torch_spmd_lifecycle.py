"""Lifecycle through the port's ``(g, r)`` mesh (``tests/test_spmd_lifecycle.py``).

The lifecycle ops are host-side by design (a manager applies them between
ticks), so here they apply to the gathered global state, per replica,
between mesh steps; the next step splits the result over the mesh again.
Each scenario runs on the JAX package (its ``(g=2, r=4)`` mesh on the 8
virtual CPU devices) and on the port (the same mesh of repeated ``cpu``
devices) from the same inputs, and every state leaf must be equal after
every phase, beside the reference's own invariants: an epoch upgrade with
a stale holdout kept out by the instance tag, and a pause, an inert
killed row and a resume by jump.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gigapaxos_tpu.ops import lifecycle as jl
from gigapaxos_tpu.ops.engine import EngineConfig as JConfig
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import spmd as jspmd
from gigapaxos_tpu_torch.ops import lifecycle as tl
from gigapaxos_tpu_torch.ops.engine import EngineConfig, EngineState
from gigapaxos_tpu_torch.ops.ballot import NULL
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import spmd as tspmd

R, G, K, W = 4, 8, 4, 8


class _Side:
    """One package's mesh step and lifecycle ops over global states."""

    def __init__(self, torch_side: bool):
        self.t = torch_side
        if torch_side:
            cfg = EngineConfig(G, W, K, R)
            self.step = tspmd.spmd_step(cfg, tmesh.make_mesh(R, 2, devices=["cpu"] * 8))
            self.states = tspmd.build_replica_states(cfg, device="cpu")
            self.ops = tl
        else:
            cfg = JConfig(G, W, K, R)
            self.step = jspmd.spmd_step(cfg, jmesh.make_mesh(n_replicas=R, n_group_shards=2))
            self.states = jspmd.build_replica_states(cfg)
            self.ops = jl

    def leaf(self, name):
        return np.asarray(getattr(self.states, name))

    def drive(self, row, vids, n_steps=8):
        for _ in range(n_steps):
            req = np.full((R, G, K), NULL, np.int32)
            for j, v in enumerate(vids[:K]):
                req[:, row, j] = v
            want = np.zeros((R, G), bool)
            if self.t:
                self.states, _ = self.step(self.states, req, want)
            else:
                self.states, _ = self.step(self.states, jnp.asarray(req), jnp.asarray(want))

    def per_replica(self, fn):
        """Gather, apply ``fn(rid, state)`` per replica, restack."""
        if self.t:
            full = [torch.as_tensor(np.asarray(x)) for x in self.states]
            per = [fn(r, EngineState(*(x[r] for x in full))) for r in range(R)]
            self.states = tspmd.stack_states(per)
        else:
            per = [jax.tree.map(lambda x: x[r], self.states) for r in range(R)]
            per = [fn(r, s) for r, s in enumerate(per)]
            self.states = jax.tree.map(lambda *xs: jnp.stack(xs), *per)

    def arr(self, x):
        return np.asarray(x) if self.t else jnp.asarray(np.asarray(x))


def _both():
    return _Side(False), _Side(True)


def _same(a, b, what):
    for f in EngineState._fields:
        np.testing.assert_array_equal(a.leaf(f), b.leaf(f), err_msg=f"{what}: {f}")


def test_epoch_upgrade_and_tag_guard_through_the_mesh():
    sides = _both()
    row, new_tag = 3, 777
    for s in sides:
        s.drive(row, [11, 12, 13])
    _same(*sides, "epoch 0")
    exec0 = sides[1].leaf("exec_slot")[:, row]
    assert (exec0 > 0).all() and len(set(sides[1].leaf("app_hash")[:, row].tolist())) == 1

    for s in sides:
        def surgery(rid, st, s=s):
            if rid == 3:
                return st
            st = s.ops.kill_groups(st, s.arr([row]))
            return s.ops.create_groups(st, s.arr([row]), s.arr([0b0111]), s.arr([0]),
                                       my_id=rid, version=1, tag=new_tag)
        s.per_replica(surgery)
    _same(*sides, "surgery")
    hold = int(sides[1].leaf("exec_slot")[3, row])
    for s in sides:
        s.drive(row, [21, 22], n_steps=10)
    _same(*sides, "epoch 1")
    t = sides[1]
    exec1, hash1 = t.leaf("exec_slot")[:, row], t.leaf("app_hash")[:, row]
    assert (exec1[:3] >= 2).all() and len(set(hash1[:3].tolist())) == 1
    assert int(exec1[3]) == hold
    assert int(t.leaf("version")[3, row]) == 0 and int(t.leaf("tag")[3, row]) != new_tag
    for s in sides:
        s.drive(5, [31], n_steps=6)
    _same(*sides, "other row")
    assert (t.leaf("exec_slot")[:, 5] > 0).all()


def test_pause_resume_jump_through_the_mesh():
    sides = _both()
    row = 2
    for s in sides:
        s.drive(row, [41, 42, 43])
    _same(*sides, "before pause")
    t = sides[1]
    exec0, hash0 = t.leaf("exec_slot")[:, row], t.leaf("app_hash")[:, row]
    nexec0, bal0 = t.leaf("n_execd")[:, row], t.leaf("bal")[:, row]
    assert (exec0 > 0).all() and len(set(hash0.tolist())) == 1

    for s in sides:
        s.per_replica(lambda rid, st, s=s: s.ops.kill_groups(st, s.arr([row])))
    frozen = t.leaf("exec_slot")[:, row].copy()
    for s in sides:
        s.drive(row, [51], n_steps=4)
    _same(*sides, "paused")
    assert (t.leaf("member_mask")[:, row] == 0).all()
    assert (t.leaf("exec_slot")[:, row] == frozen).all()

    for s in sides:
        def resume(rid, st, s=s):
            st = s.ops.create_groups(st, s.arr([row]), s.arr([(1 << R) - 1]),
                                     s.arr([row % R]), my_id=rid, version=0, tag=0)
            return s.ops.jump_rows(st, np.array([row]), np.array([int(exec0[rid])]),
                                   np.array([int(bal0[rid])]), np.array([int(hash0[rid])]),
                                   np.array([int(nexec0[rid])]), np.array([0]))
        s.per_replica(resume)
    for s in sides:
        s.drive(row, [61, 62], n_steps=10)
    _same(*sides, "resumed")
    exec1, hash1 = t.leaf("exec_slot")[:, row], t.leaf("app_hash")[:, row]
    assert (exec1 >= exec0 + 2).all(), (exec0, exec1)
    assert len(set(hash1.tolist())) == 1
