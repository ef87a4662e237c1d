"""Observability hygiene over the port: ``scripts/check_obs_hygiene.py``
run on ``gigapaxos_tpu_torch/``.

No bare ``print`` and no direct stream write outside ``obs/`` (the CLIs
report through ``obs/gplog`` and write their JSON to ``--out``), every
metric the port registers is in ``METRICS.md`` and every documented one
is registered, and the tick's hot path pulls only its allowlisted
leaves.  The script is the JAX package's, run unchanged on the port's
root.
"""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "check_obs_hygiene", os.path.join(REPO, "scripts", "check_obs_hygiene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_obs_hygiene_clean(capsys):
    assert _script().main([os.path.join(REPO, "gigapaxos_tpu_torch")]) == 0
    assert "0 obs-hygiene" not in capsys.readouterr().out


def test_gate_catches_a_bare_print_in_the_port_layout(tmp_path):
    """The gate is live on a tree laid out as the port: a CLI's bare
    print is a violation."""
    mod = _script()
    pkg = tmp_path / "gigapaxos_tpu_torch" / "testing"
    pkg.mkdir(parents=True)
    (pkg / "cli.py").write_text("def main():\n    print('result')\n")
    bad = list(mod.iter_violations(tmp_path / "gigapaxos_tpu_torch"))
    assert [(rel, line) for rel, line, _why in bad] == [
        (os.path.join("testing", "cli.py"), 2)]
