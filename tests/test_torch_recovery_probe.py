"""The port's recovery probe (``gigapaxos_tpu_torch/testing/recovery.py``)
against the JAX package's ``scripts/recovery_probe.py``, on the CPU at a
small size.

Both run the same procedure with the same arguments; the counts in their
results must be equal (journal files, replay segments and blocks, the
checkpoint generation, the backlog at serve time, names hydrated, the
phases), and the port's check of every name must pass where the probe
spot-checks 64.  At this size the background hydrator would finish
before the hot name's request is answered, so both packages start it a
little late.  The CLI writes its result to ``--out`` and refuses the
JAX package's artifact name.
"""

import importlib.util
import json
import os
import sys
import threading

import pytest

from torch_pkgs import PKGS, TORCH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = {"g": 2048, "names": 2048, "active": 64, "tail": 512, "shards": 4,
        "workers": 2, "hot": 32, "journal-file-mb": 0.05}
COUNTS = ("journal_files", "shards", "replay_workers", "hot_names", "g", "names",
          "window")
RESTART_COUNTS = ("phase_at_serve", "phase_at_first_serve",
                  "hot_served_before_hydration_done", "hot_name_is_hot",
                  "hydration_backlog_at_serve", "groups_hydrated_total",
                  "replay_segments", "replay_blocks", "checkpoint_generation")


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


@pytest.fixture
def late_hydration(monkeypatch):
    """The background hydrator of both packages starts 2 s late."""
    for pkg in PKGS:
        H = pkg.mod("recovery.hydration").Hydrator
        orig = H.start_background
        monkeypatch.setattr(
            H, "start_background",
            lambda self, _o=orig: threading.Timer(2.0, _o, (self,)).start())


def _argv():
    return [f"--{k}={v}" for k, v in ARGS.items()]


def _reference(tmp_path, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "recovery_probe", os.path.join(REPO, "scripts", "recovery_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    d = tmp_path / "ref"
    d.mkdir()
    with monkeypatch.context() as mp:
        # the probe keeps its journal in a directory it never removes
        mp.setattr(probe.tempfile, "mkdtemp", lambda **kw: str(d))
        mp.setattr(sys, "argv", ["recovery_probe.py", *_argv()])
        capsys.readouterr()
        assert probe.main() == 0
        out = capsys.readouterr().out
    return json.loads(out[out.index("\n{") + 1:])


def test_port_probe_matches_reference_probe(tmp_path, monkeypatch, capsys,
                                            late_hydration):
    ref = _reference(tmp_path, monkeypatch, capsys)
    out = tmp_path / "RECOVERY_cpu.json"
    rec = TORCH.mod("testing.recovery")
    assert rec.main([*_argv(), "--device=cpu", f"--out={out}"]) == 0
    got = json.loads(out.read_text())
    assert got["platform"] == "cpu" and got["bench"] == "recovery"
    for k in COUNTS:
        assert got[k] == ref[k], k
    for k in RESTART_COUNTS:
        assert got["restart"][k] == ref["restart"][k], k
    assert ref["restart"]["cold_tail_converged"]
    assert got["restart"]["names_checked"] == ARGS["names"]
    assert got["restart"]["names_wrong"] == 0
    assert got["restart"]["leaves_differ_from_crashed"] == []
    assert got["restart"]["hot_served_before_hydration_done"]
    assert got["journal_files"] >= 2


def test_cli_refuses_the_reference_artifact(tmp_path):
    rec = TORCH.mod("testing.recovery")
    with pytest.raises(SystemExit):
        rec.main(["--device=cpu", f"--out={tmp_path / 'RECOVERY_r01.json'}"])
    assert not (tmp_path / "RECOVERY_r01.json").exists()


def test_run_recovery_checks_every_name(monkeypatch, late_hydration):
    """A name whose total is off after hydration fails the run (the port
    checks every name, not a sample)."""
    rec = TORCH.mod("testing.recovery")
    App = TORCH.mod("models").StatefulAdderApp
    orig = App.restore

    def restore(self, name, state):
        ok = orig(self, name, state)
        if name == "svc0000500" and name in self.totals:
            self.totals[name] += 1
        return ok

    monkeypatch.setattr(App, "restore", restore)
    with pytest.raises(rec.RecoveryCheckFailed, match="expected totals"):
        rec.run_recovery(g=512, names=512, active=16, tail=400, shards=2,
                         workers=2, hot=8, journal_file_mb=0.05, device="cpu")
