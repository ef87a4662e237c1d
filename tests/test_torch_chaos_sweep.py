"""The port's chaos sweep (``gigapaxos_tpu_torch/testing/chaos_sweep.py``)
against the JAX package's ``scripts/chaos_sweep.py`` (unedited) on the
CPU.

Both sweeps run the ``txn`` family over 2 seeds, each in a fresh
interpreter with the string hash pinned and on a fresh scripted clock
(``torch_soak.sweep``), so one seed replays one schedule: their exit
codes, their parameters and, per seed, ``ok`` and the stat keys must be
equal (``elapsed_s`` is the host's clock).  Then the sweep's refusals: an
unknown ``--family``, the JAX package's artifact name as ``--out``, and
no card without ``--device cpu``.
"""

import pytest
import torch

from gigapaxos_tpu_torch.testing import chaos_sweep
from torch_soak import child, child_result

SWEEP = ["--family", "txn", "--base", "786083501", "--count", "2"]


def test_txn_sweep_equals_the_reference():
    procs = {pkg: child({"mode": "sweep", "pkg": pkg, "argv": SWEEP})
             for pkg in ("port", "jax")}
    port, ref = (child_result(procs[p], f"{p} sweep", timeout=600)
                 for p in ("port", "jax"))
    assert port["rc"] == ref["rc"] == 0
    a, b = port["doc"], ref["doc"]
    assert a["metric"] == b["metric"] == "chaos_fresh_seed_sweep"
    assert a["params"] == b["params"] and a["params"]["families"] == ["txn"]
    assert (a["ran"], a["failed_seeds"], a["fail_rate"]) == \
        (b["ran"], b["failed_seeds"], b["fail_rate"]) == (2, [], 0.0)
    strip = lambda seeds: [{k: v for k, v in s.items() if k != "elapsed_s"}
                           for s in seeds]
    assert strip(a["seeds"]) == strip(b["seeds"])
    assert [s["seed"] for s in a["seeds"]] == [786083501, 786083501 + 7919]
    assert all(s["ok"] and s["txns"] >= 1 for s in a["seeds"])
    assert a["platform"] == "cpu" and a["card"]["device"] == "cpu"


def test_unknown_family_is_an_error(capsys):
    with pytest.raises(SystemExit) as e:
        chaos_sweep.main(["--family", "txn,nope", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown --family ['nope']" in capsys.readouterr().err


def test_reference_artifact_name_refused(tmp_path):
    with pytest.raises(ValueError, match="JAX package's artifact"):
        chaos_sweep.main(["--family", "txn", "--count", "1", "--device", "cpu",
                          "--out", str(tmp_path / "CHAOS_SWEEP_r01.json")])
    assert not list(tmp_path.iterdir())


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_sweep.main(["--family", "txn", "--count", "1"])
