"""The port's perf-baseline reader
(``gigapaxos_tpu_torch/testing/perf_baseline.py``) against the JAX
package's ``scripts/perf_baseline.py`` (unedited, loaded from its file).

On a temporary directory holding copies of the committed ``BENCH_r*``,
``CAPACITY_r*`` and ``MULTICHIP_r*`` files, the port's series and bands
must equal the reference's ``build_baseline(root,
with_state_bytes=False)``, and both packages' engine state bytes per
group must be equal.  Then the port alone: ``validate`` accepts its
document and rejects a gutted one (the counterparts of
``tests/test_device_obs.py``'s two baseline tests), ``--check-only``
reads it back, a card's results fold into bands of their own (keyed by
the card's name), ``--run-fresh`` runs the port's bench and records its
verdict, and ``PERF_BASELINE.json`` is refused as ``--out``.
"""

import glob
import importlib.util
import json
import os
import shutil

import pytest
import torch

from gigapaxos_tpu_torch.testing import perf_baseline as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "perf_baseline_ref", os.path.join(REPO, "scripts", "perf_baseline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def root(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    for pat in ("BENCH_r*.json", "CAPACITY_r*.json", "MULTICHIP_r*.json"):
        for p in glob.glob(os.path.join(REPO, pat)):
            shutil.copy(p, d)
    return d


def _cpu_fresh(value=729432.7):
    return {"metric": "committed_decisions_per_s", "value": value,
            "unit": "decisions/s (8192 groups, 3 replicas, 1 card, steady-state, cpu)",
            "warmup_s": 1.0, "provenance": {"card": {"platform": "cpu"}}}


def _card(doc: dict, name: str = H100) -> dict:
    return {**doc, "provenance": {"card": {"platform": "cuda", "device": name,
                                           "nvidia_smi": f"{name}, 700.00 W"}}}


def test_series_equal_the_reference(ref, root):
    want = ref.build_baseline(str(root), with_state_bytes=False)
    got = pb.build_baseline(str(root), with_state_bytes=False)
    assert got["series"] == want["series"]
    assert set(got["series"]) == set(pb.REQUIRED_SERIES) - {"engine_state_bytes_per_group"}
    assert got["series"]["committed_decisions_per_s"]["tpu"]["rounds"] == ["r04", "r05"]
    assert (pb.MARGIN, pb.REQUIRED_SERIES) == (ref.MARGIN, ref.REQUIRED_SERIES)
    # the stub records (no metric) feed no series
    assert "MULTICHIP_r01.json" not in got["sources"]
    assert "MULTICHIP_r06.json" in got["sources"]


def test_state_bytes_equal_the_reference(ref):
    got = pb._state_bytes_per_group("cpu")
    want = ref._state_bytes_per_group()
    assert {k: got[k] for k in ("shape", "bytes_per_group", "margin_pct")} == \
        {k: want[k] for k in ("shape", "bytes_per_group", "margin_pct")}


def test_validate_accepts_the_port_document_and_rejects_a_gutted_one(root, tmp_path):
    fresh = tmp_path / "fresh.json"
    fresh.write_text(json.dumps(_cpu_fresh()))
    out = tmp_path / "baseline.json"
    assert pb.main(["--root", str(root), "--out", str(out), "--fresh", str(fresh),
                    "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert pb.validate(doc) == []
    assert doc["platform"] == "cpu" and doc["card"]["device"] == "cpu"
    assert doc["fresh_check"]["in_band"] is True
    assert doc["series"]["engine_state_bytes_per_group"]["bytes_per_group"] > 0
    assert pb.main(["--check-only", str(out)]) == 0
    broken = json.loads(json.dumps(doc))
    del broken["series"]["committed_decisions_per_s"]
    assert any("committed_decisions_per_s" in e for e in pb.validate(broken))
    below = json.loads(json.dumps(doc))
    below["fresh_check"]["in_band"] = False
    assert any("out of band" in e for e in pb.validate(below))
    out.write_text(json.dumps(below))
    assert pb.main(["--check-only", str(out)]) == 1
    band = doc["series"]["committed_decisions_per_s"]["cpu"]["band"]
    fc = pb.check_fresh(doc, _cpu_fresh(band["lower"] * 0.5))
    assert fc["in_band"] is False and fc["platform"] == "cpu"
    # a rebuild without a measurement carries the recorded check over
    out.write_text(json.dumps(doc))
    assert pb.main(["--root", str(root), "--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["fresh_check"]["carried_over"] is True


def test_card_results_fold_into_bands_of_their_own(root, ref):
    cpu_only = pb.build_baseline(str(root), with_state_bytes=False)["series"]
    head = _card({"metric": "committed_decisions_per_s", "value": 1.55e9,
                  "unit": "decisions/s (1048576 groups, 3 replicas, 1 card, "
                          "steady-state, cuda)"})
    (root / "headline.json").write_text(json.dumps(head))
    (root / "headline_b.json").write_text(json.dumps({**head, "value": 1.6e9}))
    (root / "other_card.json").write_text(json.dumps(_card(head, "NVIDIA A100")))
    abl = json.load(open(os.path.join(REPO, "BENCH_r06.json")))
    (root / "ablation.json").write_text(json.dumps(_card({**abl, "platform": "cuda"})))
    mc = json.load(open(os.path.join(REPO, "MULTICHIP_r06.json")))
    (root / "multichip.json").write_text(json.dumps(_card({**mc, "platform": "cuda"})))
    doc = pb.build_baseline(str(root), with_state_bytes=False)
    heads = doc["series"]["committed_decisions_per_s"]
    card = heads[f"cuda {H100}"]
    assert card["rounds"] == ["headline.json", "headline_b.json"]
    assert card["values"] == [1.55e9, 1.6e9]
    assert card["band"]["lower"] == round(1.55e9 * (1 - pb.MARGIN["headline_cpu"]), 1)
    assert heads["cuda NVIDIA A100"]["values"] == [1.55e9]
    # the other platforms' series are untouched
    for plat in ("cpu", "tpu"):
        assert heads[plat] == cpu_only["committed_decisions_per_s"][plat]
    for name in ("dispatch_ablation", "multichip_weak_scaling"):
        s = doc["series"][name]
        assert {k: v for k, v in s.items() if k != "cards"} == cpu_only[name]
        assert s["cards"][f"cuda {H100}"]["rounds"] == [
            "ablation.json" if name == "dispatch_ablation" else "multichip.json"]
    fc = pb.check_fresh(doc, {**head, "value": 1.5e9})
    assert fc["platform"] == f"cuda {H100}" and fc["in_band"] is True
    with pytest.raises(ValueError, match="no committed series"):
        pb.check_fresh(doc, _card(head, "NVIDIA L4"))


def test_card_capacity_record_keyed_by_card(root):
    rec = {"capacity_rps": 1426.6, "platform": "cuda",
           "provenance": {"card": {"platform": "cuda", "device": H100}}}
    (root / "probe_capacity.json").write_text(json.dumps(
        {"metric": "serving_capacity_trajectory", "host": {}, "defaults": rec}))
    caps = pb.build_baseline(str(root), with_state_bytes=False)[
        "series"]["system_capacity_requests_per_s"]
    assert caps[f"defaults (cuda {H100})"]["values"] == [1426.6]
    assert "in_process" in caps


@pytest.mark.timeout(300)
def test_run_fresh_records_the_bench(root, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_G", "512")
    out = tmp_path / "baseline.json"
    rc = pb.main(["--root", str(root), "--out", str(out), "--run-fresh",
                  "--device", "cpu"])
    fc = json.loads(out.read_text())["fresh_check"]
    assert fc["platform"] == "cpu" and fc["value"] > 0
    assert "512 groups" in fc["unit"]
    assert rc == (0 if fc["in_band"] else 1)


def test_reference_artifact_refused(root):
    with pytest.raises(ValueError, match="JAX package's artifact"):
        pb.main(["--root", str(root), "--out", str(root / "PERF_BASELINE.json"),
                 "--device", "cpu"])
    assert not (root / "PERF_BASELINE.json").exists()


def test_no_card_and_no_device_raises(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.main(["--root", str(root)])
