"""The port's cluster launcher end to end on the CPU, the counterpart of
``tests/test_gp_server_smoke.py``: ``gigapaxos_tpu_torch.gp_server``
boots the port's 3-active + 3-reconfigurator scenario (free ports) as six
OS processes with their request tracers on, ``status`` shows 6 up, the
port's probe completes a one-round ramp attached to it, ``gp_trace``
merges at least one timeline from the actives' rings, ``stop`` tears
everything down and ``status`` shows 6 down with no pid file left.  A
scenario naming the JAX package's app is refused before any node starts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gigapaxos_tpu_torch.testing.ports import free_ports

REPO = Path(__file__).resolve().parent.parent
SCENARIO = REPO / "gigapaxos_tpu_torch" / "scenarios" / "loopback_3ar_3rc.properties"


def _run(args, timeout, **env):
    return subprocess.run(
        [sys.executable, "-m"] + args, cwd=REPO, timeout=timeout,
        capture_output=True, text=True, env={**os.environ, **env},
    )


def _scenario(tmp_path, **subs) -> Path:
    """The committed scenario on free ephemeral ports."""
    text = SCENARIO.read_text()
    for old, new in zip(("21000", "21001", "21002", "22000", "22001", "22002"),
                        (str(p) for p in free_ports(6))):
        text = text.replace(f":{old}", f":{new}")
    for old, new in subs.items():
        text = text.replace(old, new)
    cfg = tmp_path / "smoke.properties"
    cfg.write_text(text)
    return cfg


@pytest.mark.timeout(240)
def test_gp_server_start_probe_trace_stop(tmp_path):
    cfg = _scenario(tmp_path)
    run_dir = tmp_path / "run"
    gp = ["gigapaxos_tpu_torch.gp_server", "--config", str(cfg),
          "--run-dir", str(run_dir)]
    try:
        r = _run(gp + ["--device", "cpu", "start", "all"], 180, GP_TRACE="1")
        assert r.returncode == 0, (r.stdout, r.stderr)
        assert "up:" in r.stdout

        r = _run(gp + ["status", "all"], 60)
        assert r.returncode == 0, (r.stdout, r.stderr)
        assert r.stdout.count(": up") == 6, r.stdout

        r = _run(["gigapaxos_tpu_torch.testing.probe", "--attach", str(cfg),
                  "--device", "cpu", "--groups", "2", "--clients", "2",
                  "--max-rounds", "1", "--window-s", "1.0", "--init-load", "20"],
                 300)
        assert r.returncode == 0, (r.stdout, r.stderr)
        lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
        seeded = next(ln for ln in lines if "echo_probe_seeded_actives" in ln)
        assert seeded["echo_probe_seeded_actives"] == 3
        summary = next(ln for ln in lines
                       if ln.get("metric") == "system_capacity_requests_per_s")
        assert summary["value"] > 0, lines

        r = _run(["gigapaxos_tpu_torch.testing.gp_trace", "--props", str(cfg),
                  "--json"], 60)
        assert r.returncode == 0, (r.stdout, r.stderr)
        doc = json.loads(r.stdout)
        assert len(doc["nodes"]) == 3 and doc["traces"], doc["nodes"]
        assert any(h["phase"] == "consensus" for tr in doc["traces"]
                   for h in tr["hops"])
        assert doc["hops"]["total"]["n"] == len(doc["traces"])
    finally:
        r = _run(gp + ["stop", "all"], 120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert not list(run_dir.glob("*.pid")), "pidfiles leaked after stop"
    r = _run(gp + ["status", "all"], 60)
    assert r.returncode == 3 and r.stdout.count(": down") == 6, r.stdout


def test_jax_application_refused(tmp_path):
    cfg = _scenario(tmp_path, **{
        "gigapaxos_tpu_torch.models.apps.NoopPaxosApp":
            "gigapaxos_tpu.models.apps.NoopPaxosApp"})
    run_dir = tmp_path / "run"
    r = _run(["gigapaxos_tpu_torch.gp_server", "--config", str(cfg),
              "--run-dir", str(run_dir), "--device", "cpu", "start", "all"], 60)
    assert r.returncode != 0
    assert "names the JAX package" in r.stderr, r.stderr
    assert not list(run_dir.glob("*.pid"))


def test_app_class_refuses_the_jax_package():
    from gigapaxos_tpu_torch.reconfigurable_node import app_class
    from gigapaxos_tpu_torch.utils.config import Config

    Config.set("APPLICATION", "gigapaxos_tpu.models.apps.NoopPaxosApp")
    try:
        with pytest.raises(ValueError, match="names the JAX package"):
            app_class()
    finally:
        Config.clear()
