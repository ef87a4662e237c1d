"""Card-only: ``python -m pytest gpbench/tests -m card`` on the card.

The reference's CUDA-graph step against its eager step, and the control
(the reference in the program's place, its quorum broken) run through
each cell at the cell's own size, which has to come out not correct."""

import json
import os
import time

import numpy as np
import pytest
import torch

from gpbench import harness
from gpbench.control import ReferenceSystem
from gpbench.reference.paxos import OUT_FIELDS, STATE_FIELDS, Replicas

from .conftest import ROOT

pytestmark = pytest.mark.card


def test_reference_graph_matches_eager(card):
    S, R, W, K = 300, 3, 32, 16
    groups = np.arange(S) * 7
    a = Replicas(groups, R, W, K, device=card)
    b = Replicas(groups, R, W, K, device=card, graph=False)
    gen = torch.Generator(device=card).manual_seed(3)
    g = torch.as_tensor(groups, device=card)
    for t in range(80):
        req = torch.randint(1, 1 << 29, (R, S, K), generator=gen, dtype=torch.int32,
                            device=card)
        want = ((g % 16) == (t % 16))[None, :] & (
            ((g % R + 1 + t // 16) % R)[None, :] == torch.arange(R, device=card)[:, None])
        heard = torch.ones(R, R, dtype=torch.bool)
        if t % 9 == 4:
            heard[0, 1] = False
        oa, ob = a.step(req, want, heard), b.step(req, want, heard)
        for name in OUT_FIELDS:
            assert torch.equal(getattr(oa, name), getattr(ob, name)), (t, name)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), name
    assert torch.equal(a.heat, b.heat)


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_control_at_the_cells_size_is_not_correct(card, cell):
    res = harness.run(cell, 2 ** 31 + 99, 0.5, False, card, time.perf_counter(),
                      system=ReferenceSystem(card))
    assert not res["correct"], res["checks"]
    torch.cuda.empty_cache()
