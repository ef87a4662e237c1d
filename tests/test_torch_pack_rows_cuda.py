"""``gp_pack_rows`` (``csrc/gp_pack_rows.cu``) on the card.

The kernel against ``pack_rows_plain`` on the same inputs, bit for bit:
seeded Blobs over the full int32 range for R in {1, 3, 4}, W in {8, 16,
32} and G in {64, 1000, 4099} (not a multiple of 4: the word path beside
the vector one), with leaves on the card, in numpy, on the CPU, mixed,
and on the card at an address that is not 16-byte aligned, and at the
paths' own shapes (G=65,536 and G=64, R in {3, 4}); one launch
counted per call, the inputs unchanged, bad inputs refused.  Then the
reconfiguration harness (``ReconfigurableCluster``) on the card in lock
step with the same harness on the CPU through a create -> requests ->
delete script: equal client messages and app states, every engine leaf
equal after every step, and one ``gp_pack_rows`` launch per manager tick.

A CUDA kernel has no CPU mode: every test here skips without a card.
This file imports nothing of JAX, so it also runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_pack_rows_cuda.py -q
"""

import sys
import time as _time

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import engine as te

GW = ("acc_vid", "dec_vid", "prop_vid", "lane_meta")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gp_pack_rows has no CPU mode")


def _blob_np(rng, R, G, W):
    return {
        f: rng.integers(-2 ** 31, 2 ** 31 - 1, size=(R, G, W) if f in GW else (R, G),
                        dtype=np.int64).astype(np.int32)
        for f in te.Blob._fields
    }


def _misaligned(v: np.ndarray) -> torch.Tensor:
    """``v`` on the card, contiguous, one word past a 16-byte boundary."""
    buf = torch.empty(v.size + 1, dtype=torch.int32, device="cuda")
    t = buf[1:].view(v.shape)
    t.copy_(torch.as_tensor(v))
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("G", [64, 1000, 4099])
@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("R", [1, 3, 4])
def test_pack_rows_kernel_matches_plain(R, W, G):
    _need_card()
    rng = np.random.default_rng(R * 100_000 + W * 10_000 + G)
    d = _blob_np(rng, R, G, W)
    want = te.pack_rows_plain(te.Blob(**d), "cuda")
    layouts = {
        "card": {f: torch.as_tensor(v, device="cuda") for f, v in d.items()},
        "numpy": d,
        "cpu": {f: torch.as_tensor(v) for f, v in d.items()},
        "mixed": {f: (torch.as_tensor(v, device="cuda") if i % 3 == 0 else
                      torch.as_tensor(v) if i % 3 == 1 else v)
                  for i, (f, v) in enumerate(d.items())},
        "misaligned": {f: _misaligned(v) if i % 2 else v
                       for i, (f, v) in enumerate(d.items())},
    }
    for name, leaves in layouts.items():
        te.reset_launch_counts()
        got = te.pack_rows(te.Blob(**leaves), "cuda")
        torch.cuda.synchronize()
        assert te.LAUNCHES["gp_pack_rows"] == 1, name
        assert got.is_cuda and torch.equal(got, want), name
        for f, v in d.items():
            leaf = leaves[f]
            host = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
            assert np.array_equal(host, v), (name, f)


@pytest.mark.parametrize("G,W,R", [(65_536, 16, 3), (65_536, 16, 4), (64, 16, 3), (64, 16, 4)])
def test_pack_rows_kernel_at_path_shapes(G, W, R):
    """The shapes the paths pack: the actives' (G=65,536) and the
    reconfigurators' (G=64), with card leaves (16-byte units) and with one
    leaf off a 16-byte boundary (word units)."""
    _need_card()
    rng = np.random.default_rng(G + R)
    d = _blob_np(rng, R, G, W)
    want = te.pack_rows_plain(te.Blob(**d), "cuda")
    card = {f: torch.as_tensor(v, device="cuda") for f, v in d.items()}
    for name, leaves in (("card", card), ("misaligned", dict(card, bal=_misaligned(d["bal"])))):
        got = te.pack_rows(te.Blob(**leaves), "cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


def test_pack_rows_refuses_bad_inputs():
    _need_card()
    rng = np.random.default_rng(1)
    d = {f: torch.as_tensor(v, device="cuda") for f, v in _blob_np(rng, 3, 64, 16).items()}
    te.reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        te.pack_rows(te.Blob(**dict(d, tag=d["tag"].to(torch.int64))), "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        te.pack_rows(te.Blob(**dict(d, acc_vid=d["acc_vid"].transpose(1, 2)
                                    .contiguous().transpose(1, 2))), "cuda")
    with pytest.raises(ValueError, match="shape"):
        te.pack_rows(te.Blob(**dict(d, bal=d["bal"][:2])), "cuda")
    assert te.LAUNCHES["gp_pack_rows"] == 0


class _Clock:
    """A scripted stand-in for the ``time`` module (``time``,
    ``monotonic`` and ``perf_counter`` read ``t``)."""

    def __init__(self):
        self.t = 1_000_000.0

    def time(self):
        return self.t

    monotonic = perf_counter = time

    def __getattr__(self, name):
        return getattr(_time, name)


def test_reconfiguration_on_card_matches_cpu(monkeypatch):
    _need_card()
    import gigapaxos_tpu_torch.failure_detection  # noqa: F401  (clocked below)
    import gigapaxos_tpu_torch.reconfiguration.demand  # noqa: F401
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.testing.rc_cluster import ReconfigurableCluster

    # the same scripted clock for both harnesses (the card's first launch
    # builds the kernels; wall-clock timers would see that as a stall)
    clock = _Clock()
    for name, mod in list(sys.modules.items()):
        if name.startswith("gigapaxos_tpu_torch.") and getattr(mod, "time", None) is _time:
            monkeypatch.setattr(mod, "time", clock)
    gp_kernels.lib()

    ar, rc = te.EngineConfig(64, 16, 8, 4), te.EngineConfig(64, 16, 8, 3)
    cs = {d: ReconfigurableCluster(ar, rc, HashChainApp, device=d)
          for d in ("cpu", "cuda")}
    steps = 0

    def step():
        nonlocal steps
        steps += 1
        clock.t += 0.02
        for c in cs.values():
            c.step(now=clock.t)
        msgs = {d: c.drain_client() for d, c in cs.items()}
        assert msgs["cpu"] == msgs["cuda"], steps
        for a, b in zip(cs["cpu"].ars.managers + cs["cpu"].rcs.managers,
                        cs["cuda"].ars.managers + cs["cuda"].rcs.managers):
            assert a.names == b.names
            for f in a.state._fields:
                assert np.array_equal(a._np(f), b._np(f)), (steps, f)
        for a, b in zip(cs["cpu"].ars.managers, cs["cuda"].ars.managers):
            assert a.app.state == b.app.state
        return msgs["cuda"]

    def wait_for(kind, budget=120):
        for _ in range(budget):
            for k, body in step():
                if k == kind:
                    return body
        return None

    try:
        te.reset_launch_counts()
        for c in cs.values():
            c.client_request("create_service", {"name": "svc", "actives": [0, 1, 2]})
        assert (wait_for("create_ack") or {}).get("ok")
        for c in cs.values():
            for v in ("a", "b", "c"):
                c.ars.managers[0].propose("svc", v)
        for _ in range(20):
            step()
        assert cs["cuda"].ars.managers[1].app.n_executed.get("svc") == 3
        for c in cs.values():
            c.client_request("delete_service", {"name": "svc"})
        assert (wait_for("delete_ack") or {}).get("ok")
        n_mgr = len(cs["cuda"].ars.managers) + len(cs["cuda"].rcs.managers)
        assert te.LAUNCHES["gp_pack_rows"] == steps * n_mgr
    finally:
        for c in cs.values():
            c.close()
