"""The port's entry points (``gigapaxos_tpu_torch/graft_entry.py``)
against the root ``__graft_entry__.py``.

``entry()``'s step and example arguments equal the reference's after a
step (every state leaf and output field), and ``dryrun_multichip(8,
device="cpu")`` prints one JSON line with the reference's keys and
values (the ``(g=4, r=2)`` mesh, 35 groups padded to 40 over the ``('g',)``
mesh) plus ``physical_devices``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from gigapaxos_tpu_torch import graft_entry

# the keys the reference's dryrun_multichip prints (__graft_entry__.py:157-170)
REF_KEYS = {"n_devices", "mesh", "n_groups", "steps", "step_wall_s", "dec_per_s",
            "group_sharded"}
REF_GS_KEYS = {"mesh", "n_groups", "padded_groups", "step_wall_s", "dec_per_s"}


def _eq(x, y, what):
    for f in x._fields:
        np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                      getattr(y, f).numpy(), err_msg=f"{what}: {f}")


def test_entry_matches_the_reference():
    fj, aj = ref.entry()
    ft, at = graft_entry.entry(device="cpu")
    _eq(aj[0], at[0], "example states")
    for a, b in zip(aj[1:], at[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    req = np.full((3, 256, 4), -1, np.int32)
    req[np.arange(256) % 3, np.arange(256), 0] = np.arange(1, 257)
    sj, oj = fj(aj[0], jnp.asarray(req), aj[2])
    st, ot = ft(at[0], req, at[2])
    sj, oj = fj(sj, jnp.asarray(req), aj[2])
    st, ot = ft(st, req, at[2])
    _eq(sj, st, "state")
    _eq(oj, ot, "outs")
    # donate=False: the example arguments are still the initial states
    assert int(at[0].exec_slot.max()) == 0 and int(ot.n_admitted.sum()) > 0


def test_dryrun_multichip_prints_the_reference_record(capsys):
    rec = graft_entry.dryrun_multichip(8, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert set(rec) == REF_KEYS | {"physical_devices"}
    assert set(rec["group_sharded"]) == REF_GS_KEYS
    assert rec["n_devices"] == 8 and rec["mesh"] == {"g": 4, "r": 2}
    assert rec["n_groups"] == 16 and rec["steps"] == 5
    assert rec["step_wall_s"] > 0 and rec["dec_per_s"] > 0
    gs = rec["group_sharded"]
    assert gs["mesh"] == {"g": 8}
    assert gs["n_groups"] == 35 and gs["padded_groups"] == 40
    assert gs["dec_per_s"] > 0
    assert rec["physical_devices"] == 1


def test_dryrun_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    assert [str(d) for d in graft_entry.logical_devices(3, "cpu")] == ["cpu"] * 3
