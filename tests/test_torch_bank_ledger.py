"""The port's bank-ledger workload
(``gigapaxos_tpu_torch/scenarios/bank_ledger.py``) against the JAX
package's ``scenarios/bank_ledger.py`` (unedited, loaded from its file)
on the CPU.

Both ``main``s run 2,000 accounts (2,048 rows, W=4, K=2, R=3), 24
transactions at 8 in flight, seed 1, each on a fresh scripted clock of
both packages (``torch_soak.scripted``: the transaction drivers'
latencies and the managers' timers read it): their JSON documents must be
equal, the host's clock (``wall_run_s``, ``txns_per_s``, ``t``) and the
port's own fields aside, and so must every member's balances, locks and
staged operations.  Then the port alone: a balance tampered with after
the boot fails the conservation and per-name ledger audits with exit 1;
the JAX package's artifact name is refused as ``--out``; without a card
and without ``--device cpu`` it raises.
"""

import importlib.util
import json
import os

import pytest
import torch

from gigapaxos_tpu.utils.config import Config as JaxConfig
from gigapaxos_tpu_torch.scenarios import bank_ledger
from gigapaxos_tpu_torch.utils.config import Config as TorchConfig
from torch_soak import scripted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--accounts", "2000", "--txns", "24", "--inflight", "8", "--seed", "1",
        "--out", ""]
# the host's clock, and the port's own fields
NOT_COMPARED = {"wall_run_s", "txns_per_s", "t", "platform", "card", "boot_s",
                "ms_per_step", "launches"}


def _reference():
    spec = importlib.util.spec_from_file_location(
        "bank_ledger_ref", os.path.join(REPO, "scenarios", "bank_ledger.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restored():
    """Both packages' global config as it was, and one intra-op thread
    (the plain engine's small operations thrash a shared pool under the
    suite's workers)."""
    saved = [(C, dict(C._file_props), dict(C._cli)) for C in (TorchConfig, JaxConfig)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        for C, props, cli in saved:
            C.clear()
            C._file_props.update(props)
            C._cli.update(cli)


def _run(mod, argv, capsys, monkeypatch, tamper=None):
    """``mod.main(argv)`` on a fresh scripted clock: (exit code, its JSON
    document, its cluster)."""
    made = []
    build = mod.build_cluster

    def keep(*a, **kw):
        c, accounts = build(*a, **kw)
        if tamper:
            tamper(c, accounts)
        made.append(c)
        return c, accounts

    monkeypatch.setattr(mod, "build_cluster", keep)
    capsys.readouterr()
    with scripted():
        rc = mod.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    doc = next(x for x in lines if x.get("metric") == "bank_ledger_txn")
    assert lines[0]["event"] == "booted"
    return rc, doc, made[0]


def test_ledger_equals_the_reference(restored, capsys, monkeypatch):
    rc, port, pc = _run(bank_ledger, ARGS + ["--device", "cpu"], capsys, monkeypatch)
    ref_rc, ref, rc_ = _run(_reference(), ARGS, capsys, monkeypatch)
    assert rc == ref_rc == 0
    assert {k: v for k, v in port.items() if k not in NOT_COMPARED} == \
        {k: v for k, v in ref.items() if k not in {"wall_run_s", "txns_per_s", "t"}}
    assert port["audit"] == "pass" and port["committed"] >= 1
    assert port["params"]["n_groups"] == 2048 and port["steps"] > 0
    assert port["platform"] == "cpu" and port["card"]["device"] == "cpu"
    assert port["boot_s"] >= 0 and port["ms_per_step"] > 0
    # the plain engine on the CPU launches no kernel
    assert set(port["launches"]) == {"boot", "run"}
    assert not any(port["launches"]["run"].values())
    for a, b in zip(pc.managers, rc_.managers, strict=True):
        assert a.app.totals == b.app.totals
        assert a.app.locks == b.app.locks == {}
        assert a.app.staged == b.app.staged == {}


def test_tampered_balance_fails_the_audits(restored, capsys, monkeypatch):
    def mint(c, accounts):
        # one unit minted on every member: replicas still agree
        for m in c.managers:
            m.app.totals[accounts[0]] += 1

    rc, doc, _c = _run(bank_ledger, ["--accounts", "500", "--txns", "12",
                                     "--inflight", "4", "--device", "cpu"],
                       capsys, monkeypatch, tamper=mint)
    assert rc == 1 and doc["audit"] == "FAIL"
    audits = {f["audit"]: f for f in doc["failures"]}
    assert set(audits) == {"conservation", "ledger-mismatch"}
    assert audits["conservation"]["total"] == audits["conservation"]["want"] + 1
    assert "a0000000" in audits["ledger-mismatch"]["names"]
    assert doc["conservation"]["ok"] is False


def test_reference_artifact_name_refused(restored, tmp_path):
    with pytest.raises(ValueError, match="JAX package's artifact"):
        bank_ledger.main(["--accounts", "10", "--device", "cpu",
                          "--out", str(tmp_path / "TXN_r01.json")])
    assert not list(tmp_path.iterdir())


def test_no_card_and_no_device_raises(restored):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bank_ledger.main(["--accounts", "10"])
