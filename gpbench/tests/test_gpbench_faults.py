"""A whole run with the timed path broken underneath comes out not
correct, one fault at a time; the control (the reference in the
program's place with its quorum broken) does too, and the reference run
sound in the program's place comes out correct.  Tiny cells on the CPU;
the harness's look for a card is skipped."""

import time

import pytest
import torch

from gpbench import harness
from gpbench.control import ReferenceSystem
from gpbench.system import Port

CELLS = ["tiny_node.steady", "tiny_node.failover", "tiny_ar.tiny_wire",
         "tiny_node.failover_n5", "tiny_ar.wire_n3"]


class Faulty(Port):
    def __init__(self, device, fault):
        super().__init__(device)
        self.fault = fault

    def _break_state(self, new, old, group_axis):
        if self.fault == "unchanged":
            return type(new)(*(o.clone() for o in old))
        if self.fault == "half":
            leaves = []
            for n, o in zip(new, old):
                G = n.shape[group_axis]
                keep = torch.arange(G) >= G // 2
                shape = [1] * n.dim()
                shape[group_axis] = G
                leaves.append(torch.where(keep.view(shape), o, n))
            return type(new)(*leaves)
        if self.fault == "altered":
            return new._replace(dec_vid=torch.where(new.dec_vid > 0, new.dec_vid + 1,
                                                    new.dec_vid))
        return new

    def stacked_face(self, cfg, N):
        face = super().stacked_face(cfg, N)

        def broken(states, req, want):
            heard = None
            if self.fault == "exchange":
                heard = torch.eye(cfg.n_replicas, dtype=torch.bool)
            new, out = face(states, req, want, heard)
            return self._break_state(new, states, 1), out

        return broken

    def packed_face(self, cfg, N):
        face = super().packed_face(cfg, N)
        from gigapaxos_tpu_torch.ops.engine import unpack_out

        def broken(state, gvec, heard, ring, want, my_id, heat):
            if self.fault == "exchange":
                heard = heard.copy()
                heard[:] = False
            st, rings, blob, heat2 = face(state, gvec, heard, ring, want, my_id, heat)
            if self.fault == "altered":
                for row in rings:
                    ev = unpack_out(row, cfg).exec_vid
                    ev[ev > 0] += 1
            return self._break_state(st, state, 0), rings, blob, heat2

        return broken


def _run(root, cell, system, seed=17):
    return harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter(),
                       system=system, root=root)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange", "altered"])
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    res = _run(tiny_root, cell, Faulty("cpu", fault))
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    res = _run(tiny_root, cell, ReferenceSystem("cpu"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_reference_and_the_program_are_correct(tiny_root, cell):
    assert _run(tiny_root, cell, ReferenceSystem("cpu", sound=True))["correct"]
    res = _run(tiny_root, cell, None)
    assert res["correct"] and res["failed"] == 0, res["checks"]
