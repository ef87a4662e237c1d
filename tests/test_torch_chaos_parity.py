"""One parity seed each of the transaction and density chaos families:
the soak on both packages (the port on the CPU) in one fresh interpreter
on a scripted clock with the string hash pinned (``torch_soak.parity``).
The result dictionaries and every member's end state as it closed (per
name: row, exec frontier, executions, app hash, app checkpoint) must be
equal, and each soak's own audit passes on both.

``run_density_soak`` runs at its defaults (120 rounds, 96 names on 48
rows); no JAX test drives it, only ``scripts/chaos_sweep.py``.
"""

from torch_soak import in_child


def test_txn_soak_parity_786083501():
    out = in_child("parity", "txn_soak", 786083501)
    assert out["seed"] == 786083501 and out["committed"] >= 1


def test_density_soak_parity_seed_1():
    out = in_child("parity", "density_soak", 1)
    assert out == {**out, "seed": 1, "rounds": 120}
    assert out["replies"] > 0
