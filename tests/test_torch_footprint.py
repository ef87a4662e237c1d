"""The port's footprint probe (``gigapaxos_tpu_torch/testing/footprint.py``)
against the JAX package's ``scripts/footprint_probe.py``, loaded with
``runpy`` and run unedited: the same JSON line at the default shape, at
W=16 and W=8, with ``--sharded 4``, ``--steps-per-dispatch 8`` and
``--paused 1048576``, and the same exit code."""

import json
import pathlib
import runpy
import sys

import pytest

from gigapaxos_tpu_torch.testing import footprint

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "footprint_probe.py"

CASES = [
    [],
    ["--groups", "65536", "--window", "16", "--req-lanes", "8"],
    ["--groups", "4096", "--window", "8", "--req-lanes", "4", "--replicas", "5"],
    ["--sharded", "4"],
    ["--groups", "1000003", "--sharded", "4"],
    ["--steps-per-dispatch", "8"],
    ["--paused", "1048576"],
]


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["footprint_probe.py"] + argv)
    rc = main()
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("argv", CASES, ids=lambda a: " ".join(a) or "default")
def test_footprint_matches_the_reference_script(argv, capsys, monkeypatch):
    ref = runpy.run_path(str(SCRIPT), run_name="footprint_probe")
    rc_ref, want = _run(ref["main"], argv, capsys, monkeypatch)
    rc, got = _run(lambda: footprint.main(argv), argv, capsys, monkeypatch)
    assert (rc, got) == (rc_ref, want)
    assert rc == 0


def test_footprint_function_is_the_cli():
    assert footprint.footprint(65_536, 16, 8, 3, sharded=2) == footprint.footprint(
        groups=65_536, window=16, req_lanes=8, replicas=3, sharded=2)
    out = footprint.footprint()
    assert out["shape"] == {"G": 1_048_576, "W": 32, "K": 16, "R": 3}
    assert out["blob_bytes_per_group"] == 528.0
