"""The port's capacity probe (``gigapaxos_tpu_torch/testing/probe.py``) on
the CPU: the reference's ramp (``probe.py``) over 3 actives + 3
reconfigurators in this process at a low load, its round lines and
summary; the unreplicated and durable modes; ``--bank-ledger`` running
the bank-ledger workload; the JAX package's artifact names refused; no
card and no ``--device cpu`` raising."""

import json
import os

import pytest
import torch

from gigapaxos_tpu_torch.testing import probe

LOW = ["--in-process", "--device", "cpu", "--groups", "2", "--clients", "2",
       "--window-s", "1.0", "--init-load", "20"]


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _summary(lines):
    return next(ln for ln in lines
                if ln.get("metric") == "system_capacity_requests_per_s")


@pytest.mark.timeout(120)
def test_in_process_ramp(capsys, tmp_path):
    out = tmp_path / "capacity_cpu.json"
    assert probe.main(LOW + ["--max-rounds", "2", "--capacity-out", str(out),
                             "--label", "smoke"]) == 0
    lines = _lines(capsys)
    seeded = next(ln for ln in lines if "echo_probe_seeded_actives" in ln)
    assert seeded["echo_probe_seeded_actives"] == 3
    rounds = [ln for ln in lines if "round" in ln]
    assert [r["round"] for r in rounds] == [0, 1][:len(rounds)] and rounds
    assert set(rounds[0]) == {"round", "load_rps", "response_rate",
                              "mean_latency_ms", "p50_ms", "p99_ms", "sustained"}
    s = _summary(lines)
    assert s["value"] > 0 and s["platform"] == "cpu"
    assert s["rounds"] == [rounds]
    doc = json.loads(out.read_text())
    assert doc["smoke"]["capacity_rps"] == s["value"]
    assert doc["smoke"]["provenance"]["card"]["platform"] == "cpu"


@pytest.mark.timeout(120)
def test_unreplicated_mode(capsys):
    assert probe.main(LOW + ["--max-rounds", "1", "--unreplicated"]) == 0
    s = _summary(_lines(capsys))
    assert s["value"] > 0 and "unreplicated" in s["unit"]
    assert "GP_EMULATE_UNREPLICATED" not in os.environ


@pytest.mark.timeout(120)
def test_durable_mode_journals_to_a_temporary_directory(capsys):
    assert probe.main(LOW + ["--max-rounds", "1", "--durable"]) == 0
    lines = _lines(capsys)
    d = next(ln for ln in lines if "durable_log_root" in ln)
    assert d["files"] > 0
    assert not os.path.exists(d["durable_log_root"])   # removed at the end
    assert "durable" in _summary(lines)["unit"]


@pytest.mark.timeout(120)
def test_bank_ledger_is_not_ported_yet(capsys):
    """``--bank-ledger`` hands every other argument to the ledger's main
    (the test keeps the name it had while the probe refused the flag)."""
    from gigapaxos_tpu_torch.utils.config import Config

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert probe.main(["--bank-ledger", "--device", "cpu", "--accounts", "200",
                           "--txns", "6", "--inflight", "3"]) == 0
    finally:
        torch.set_num_threads(threads)
        Config.clear()
    doc = next(ln for ln in _lines(capsys) if ln.get("metric") == "bank_ledger_txn")
    assert doc["audit"] == "pass" and doc["params"]["accounts"] == 200
    assert doc["params"]["n_groups"] == 1024 and doc["committed"] >= 1


def test_reference_artifact_name_refused(tmp_path):
    with pytest.raises(ValueError, match="JAX package's artifact"):
        probe.main(LOW + ["--capacity-out", str(tmp_path / "CAPACITY_r03.json")])


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--in-process"])
