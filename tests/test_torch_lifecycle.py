"""Lifecycle-op parity: each of the port's row ops against the reference.

``create_groups``, ``kill_groups``, ``jump_rows``, ``restore_paused_rows``,
``extract_rows``/``restore_rows``, ``_popcount32`` and
``initial_coordinator`` on random states and duplicate-free row batches
(as the manager passes them), inputs from numpy with a fixed seed,
every leaf equal.  The port's ops are also checked to be out of place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import engine as je
from gigapaxos_tpu.ops import lifecycle as jl
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import lifecycle as tl
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig

G, W, R = 12, 8, 5
NULL = -1


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TorchConfig.clear()


def _random(rng):
    d = {}
    for f in te.EngineState._fields:
        shape = (G, W) if f in ("acc_bal", "acc_vid", "acc_slot", "dec_vid",
                                "dec_slot", "c_prop_vid", "c_prop_slot") else (G,)
        d[f] = rng.integers(-1, 400, size=shape).astype(np.int32)
    return d


def _pair(d):
    return (je.EngineState(**{k: jnp.asarray(v) for k, v in d.items()}),
            te.EngineState(**{k: torch.as_tensor(v) for k, v in d.items()}))


def _eq(a, b, what):
    for f in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), getattr(b, f).numpy(), err_msg=f"{what}: {f}"
        )


def _untouched(before, after_input):
    for a, b in zip(before, after_input):
        assert torch.equal(a, b)


def test_popcount_and_initial_coordinator():
    rng = np.random.default_rng(0)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=64).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jl._popcount32(jnp.asarray(x))),
        tl._popcount32(torch.as_tensor(x)).numpy(),
    )
    idx = np.arange(40)
    masks = rng.integers(0, 2 ** R, size=40)
    np.testing.assert_array_equal(jl.initial_coordinator(idx, masks),
                                  tl.initial_coordinator(idx, masks))


@pytest.mark.parametrize("seed", [0, 1])
def test_create_kill_jump_restore(seed):
    rng = np.random.default_rng(seed)
    d = _random(rng)
    sj, st = _pair(d)
    keep = [x.clone() for x in st]
    idx = rng.choice(G, size=5, replace=False)
    masks = rng.integers(1, 2 ** R, size=5)
    coord0 = tl.initial_coordinator(idx, masks)
    version = rng.integers(0, 4, size=5)
    tag = rng.integers(1, 1000, size=5)
    for my_id in (0, 3):
        a = jl.create_groups(sj, idx, masks, coord0, my_id=my_id,
                             version=version, tag=tag)
        b = tl.create_groups(st, idx, masks, coord0, my_id=my_id,
                             version=version, tag=tag)
        _eq(a, b, f"create my_id={my_id}")
    # scalar version/tag broadcast
    _eq(jl.create_groups(sj, idx, masks, coord0, my_id=1),
        tl.create_groups(st, idx, masks, coord0, my_id=1), "create scalars")
    _eq(jl.kill_groups(sj, idx[:3]), tl.kill_groups(st, idx[:3]), "kill")
    jargs = (idx, rng.integers(0, 500, 5), rng.integers(0, 500, 5),
             rng.integers(-5, 5, 5), rng.integers(0, 9, 5), rng.integers(0, 2, 5))
    _eq(jl.jump_rows(sj, *jargs), tl.jump_rows(st, *jargs), "jump")
    rargs = (idx, rng.integers(0, 500, 5), rng.integers(0, 500, 5),
             rng.integers(-5, 5, 5), rng.integers(0, 9, 5)) + tuple(
        rng.integers(-1, 500, (5, W)) for _ in range(5))
    _eq(jl.restore_paused_rows(sj, *rargs), tl.restore_paused_rows(st, *rargs),
        "restore_paused")
    rows_j = jl.extract_rows(sj, idx)
    rows_t = tl.extract_rows(st, idx)
    for a, b in zip(rows_j, rows_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    other = rng.choice(G, size=5, replace=False)
    _eq(jl.restore_rows(sj, other, rows_j), tl.restore_rows(st, other, rows_t),
        "restore_rows")
    _untouched(keep, st)  # every op was out of place
