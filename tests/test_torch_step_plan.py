"""``gp_step``'s launch plan as the wrapper sees it, on the CPU.

The C launcher (``csrc/gp_step.cu:make_plan``) chooses the instantiation,
the tile of groups, the shared memory and the grid; the wrapper checks the
configuration first and reads the launcher's plan back with
``ops/gp_kernels.py:step_launch_plan``.  Held here, through a stand-in for
the built library: every shape the wrapper accepts reaches the launcher
with its fields intact, the shapes it refuses never do, the readout's
keys, and a refused plan or launch raises.  The plan itself is held on the
card (``tests/test_torch_gp_step_cuda.py``).
"""

import ctypes

import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels as gk


class _FakeLib:
    """Stands in for the built library: records the arguments it is
    handed and answers with a plan of its own."""

    def __init__(self, rc=0):
        self.rc, self.seen = rc, []

    def _record(self, addr):
        a = gk._StepArgs.from_address(addr)
        self.seen.append((a.G, a.W, a.K, a.R, a.stacked))
        return a

    def gp_step_launch(self, addr, stream):
        self._record(addr)
        return self.rc

    def gp_step_launch_info(self, addr, out):
        a = self._record(addr)
        vals = (a.R * 100 + a.W, 8, 8 * a.W, 1234, 2, 7, int(a.G % 4 == 0), 99)
        for i, v in enumerate(vals):
            ctypes.c_longlong.from_address(out + 8 * i).value = v
        return self.rc


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gk, "lib", lambda name="gp_step": lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("R", [1, 2, 3, 5, 7, 16, 32])
def test_every_accepted_shape_has_a_plan(fake, W, R):
    """Each shape the wrapper accepts is handed to the C launcher as is,
    on both faces, and its plan comes back under the readout's keys."""
    want = []
    for K in sorted({1, W}):
        for G in (1, 5, 64, 1001, 65_536):
            for stacked in (False, True):
                p = gk.step_launch_plan(te.EngineConfig(G, W, K, R), stacked)
                want.append((G, W, K, R, int(stacked)))
                assert tuple(p) == gk.STEP_PLAN_KEYS
                assert p["instance"] == R * 100 + W and p["threads"] == 8 * W
                assert p["aligned"] == int(G % 4 == 0)
    assert fake.seen == want


@pytest.mark.parametrize("W,K,R,err", [
    (12, 4, 3, ValueError), (64, 8, 3, NotImplementedError),
    (16, 17, 3, ValueError), (16, 8, 0, ValueError), (16, 8, 33, ValueError),
])
def test_plan_refuses_what_the_kernel_cannot_run(fake, W, K, R, err):
    with pytest.raises(err):
        gk.step_launch_plan(te.EngineConfig(1024, W, K, R))
    assert fake.seen == []


@pytest.mark.parametrize("stacked", [False, True])
def test_wrapper_fills_the_plan_and_reads_the_c_plan_back(fake, stacked):
    p = gk.step_launch_plan(te.EngineConfig(65_536, 16, 8, 3), stacked)
    assert fake.seen == [(65_536, 16, 8, 3, int(stacked))]
    assert p == dict(zip(gk.STEP_PLAN_KEYS, (316, 8, 128, 1234, 2, 7, 1, 99)))


def test_wrapper_raises_on_a_refused_launch(fake):
    fake.rc = 1
    with pytest.raises(RuntimeError, match="cudaError 1"):
        gk.step_launch_plan(te.EngineConfig(64, 16, 8, 3))
    def gp_step_launch(addr, stream):
        return fake.gp_step_launch(addr, stream)

    with pytest.raises(RuntimeError, match="gp_step_launch launch failed: cudaError 1"):
        gk._launch(gp_step_launch, gk._StepArgs())


def test_step_wrappers_refuse_cpu_tensors():
    """On the CPU the engine runs the plain version; the kernel wrapper
    itself launches or raises."""
    cfg = te.EngineConfig(8, 8, 4, 3)
    st = te.init_state(cfg, device="cpu")
    gvec = torch.zeros((3, te.blob_vec_len(cfg)), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gk.step(st, gvec, torch.ones(3, dtype=torch.bool),
                torch.full((8, 4), -1, dtype=torch.int32),
                torch.zeros(8, dtype=torch.bool), 0, cfg)
