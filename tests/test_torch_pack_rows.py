"""The gathered blobs' row pack (``gp_pack_rows``) without a card.

Three layers:

* **the plain version against the JAX package**: seeded Blobs of
  ``[R, ...]`` int32 leaves (numpy and tensor leaves mixed, as the stepped
  cluster mixes them) go through the JAX manager's ``_pack_rows_jit`` and
  the port's ``pack_rows_plain``/``pack_rows`` on the CPU; every word must
  be equal, and each row equal to ``pack_blob`` of that replica's blob.
* **the kernel path, emulated on the CPU**: ``gp_pack_rows_launch``
  (``csrc/gp_pack_rows.cu``) is replaced by a host emulation that reads
  the very ``ctypes`` argument block the CUDA launcher would get and
  copies through the raw host memory behind its pointers, and the
  dispatch predicate treats the CPU as the card.  The wrapper's checks,
  its uploads, its pointer and offset table and its launch
  count all run, and the result is held against the plain version.  The
  emulation is itself checked: a swapped leaf, a missing leaf or a wrong
  offset in the table must show as a mismatch.
* **the reconfiguration path on the emulated kernels**: a create ->
  requests -> delete script on both packages' ``ReconfigurableCluster``,
  the port's every kernel emulated, compared step by step as
  ``test_torch_reconfiguration.py`` does; every manager's tick packs its
  gathered blobs with one ``gp_pack_rows`` launch.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.manager import _pack_rows_jit
from gigapaxos_tpu.ops import engine as je
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels

SHAPES = [(3, 64, 16), (4, 6, 8), (1, 5, 32), (5, 7, 4)]   # (R, G, W)
GW = ("acc_vid", "dec_vid", "prop_vid", "lane_meta")


def _blob_np(rng, R, G, W):
    """Seeded leaves over the full int32 range (NULL and negative words)."""
    return {
        f: rng.integers(-2 ** 31, 2 ** 31 - 1, size=(R, G, W) if f in GW else (R, G),
                        dtype=np.int64).astype(np.int32)
        for f in te.Blob._fields
    }


def _mixed(d, rng):
    """The cluster's mix: some leaves numpy, some CPU tensors."""
    return te.Blob(**{
        f: torch.as_tensor(v) if rng.random() < 0.5 else v for f, v in d.items()
    })


@pytest.mark.parametrize("R,G,W", SHAPES)
def test_plain_matches_jax_pack_rows(R, G, W):
    rng = np.random.default_rng(R * 1000 + G * 10 + W)
    d = _blob_np(rng, R, G, W)
    want = np.asarray(_pack_rows_jit(je.Blob(**{f: jnp.asarray(v) for f, v in d.items()})))
    assert want.shape == (R, G * (4 + 4 * W))
    for blob in (_mixed(d, rng), te.Blob(**d)):
        got = te.pack_rows_plain(blob)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(te.pack_rows(blob, "cpu").numpy(), want)
    for r in range(R):
        row = te.pack_blob(te.Blob(**{f: torch.as_tensor(v[r]) for f, v in d.items()}))
        assert np.array_equal(row.numpy(), want[r])
        jrow = je.pack_blob(je.Blob(**{f: jnp.asarray(v[r]) for f, v in d.items()}))
        assert np.array_equal(np.asarray(jrow), want[r])


# ---------------------------------------------------------------------------
# the kernel path on the CPU
# ---------------------------------------------------------------------------


def _host(ptr: int, n: int) -> np.ndarray:
    assert ptr, "null pointer where the kernel reads or writes"
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr))


def _emulated_launch(a) -> None:
    """``gp_pack_rows_launch`` on host memory: the launcher's argument
    checks, then every (row, leaf) segment copied as the kernel copies it.
    The output is poisoned first: a column no segment covers must not
    pass because ``torch.empty`` handed back a freed block that already
    held the expected words."""
    R, NB, n_leaf = int(a.R), int(a.NB), int(a.n_leaf)
    assert R >= 1 and 1 <= n_leaf <= len(te.Blob._fields) and NB >= 1
    out = _host(a.out, R * NB).reshape(R, NB)
    out[:] = np.int32(0x5A5A5A5A)
    for l in range(n_leaf):
        n, col = int(a.len[l]), int(a.col[l])
        assert n >= 0 and col >= 0 and col + n <= NB
        src = _host(a.leaf[l], R * n).reshape(R, n)
        out[:, col:col + n] = src


def _emulate(monkeypatch, launch=_emulated_launch):
    monkeypatch.setattr(te, "on_card", lambda t: True)
    monkeypatch.setattr(gp_kernels, "_pack_launch", launch)


@pytest.mark.parametrize("R,G,W", SHAPES)
@pytest.mark.parametrize("leaves", ["numpy", "tensors", "mixed"])
def test_kernel_path_matches_plain(monkeypatch, R, G, W, leaves):
    rng = np.random.default_rng(7 + R + G + W)
    d = _blob_np(rng, R, G, W)
    want = te.pack_rows_plain(te.Blob(**d))
    blob = {"numpy": te.Blob(**d),
            "tensors": te.Blob(**{f: torch.as_tensor(v) for f, v in d.items()}),
            "mixed": _mixed(d, rng)}[leaves]
    keep = {f: np.array(v, copy=True) for f, v in d.items()}
    _emulate(monkeypatch)
    te.reset_launch_counts()
    log = {}
    got = te.pack_rows(blob, "cpu", launch_log=log)
    assert torch.equal(got, want)
    assert te.LAUNCHES["gp_pack_rows"] == 1 and log == {"gp_pack_rows": 1}
    for f in te.Blob._fields:   # the inputs are never written
        assert np.array_equal(np.asarray(getattr(blob, f)), keep[f])


def _tamper(how):
    def launch(a):
        if how == "swapped":
            a.leaf[4], a.leaf[5] = a.leaf[5], a.leaf[4]
        elif how == "missing":
            a.n_leaf = len(te.Blob._fields) - 1
        elif how == "offset":
            a.col[1], a.col[2] = a.col[2], a.col[1]
        elif how == "length":
            a.len[3] = a.len[3] - 1
        _emulated_launch(a)
    return launch


@pytest.mark.parametrize("how", ["swapped", "missing", "offset", "length"])
def test_emulation_catches_a_bad_table(monkeypatch, how):
    """A wrong pointer or offset table reaches the result: the emulation
    holds the table, not only the shape, against the plain version."""
    rng = np.random.default_rng(3)
    d = _blob_np(rng, 3, 6, 8)
    want = te.pack_rows_plain(te.Blob(**d))
    _emulate(monkeypatch, _tamper(how))
    got = te.pack_rows(te.Blob(**d), "cpu")
    assert not torch.equal(got, want)


def test_wrapper_refuses_bad_inputs(monkeypatch):
    rng = np.random.default_rng(5)
    d = _blob_np(rng, 3, 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernels.StagedPack(te.Blob(**d), "cpu")   # the plain version's device
    _emulate(monkeypatch)
    bad = [
        dict(d, tag=d["tag"][:, :5]),                           # a short leaf
        dict(d, lane_meta=d["lane_meta"][:, :, 0]),              # lane_meta not [R, G, W]
        dict(d, acc_vid=d["acc_vid"][:2]),                      # a leaf of 2 rows
    ]
    for b in bad:
        with pytest.raises(ValueError):
            te.pack_rows(te.Blob(**b), "cpu")
    t = {f: torch.as_tensor(v) for f, v in d.items()}
    with pytest.raises(TypeError, match="dtype"):
        te.pack_rows(te.Blob(**dict(t, bal=t["bal"].to(torch.int64))), "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        nc = torch.as_tensor(np.ascontiguousarray(d["dec_vid"].transpose(0, 2, 1)))
        te.pack_rows(te.Blob(**dict(t, dec_vid=nc.transpose(1, 2))), "cpu")


def test_the_launcher_refuses_a_launch_error(monkeypatch):
    """A nonzero cudaGetLastError() from the launcher raises."""

    class Fake:
        @staticmethod
        def gp_pack_rows_launch(args, stream):
            return 700

    monkeypatch.setattr(te, "on_card", lambda t: True)
    monkeypatch.setattr(gp_kernels, "lib", lambda name="gp_step": Fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(9)
    te.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        te.pack_rows(te.Blob(**_blob_np(rng, 3, 6, 8)), "cpu")
    assert te.LAUNCHES["gp_pack_rows"] == 0


# ---------------------------------------------------------------------------
# the reconfiguration path with every kernel emulated
# ---------------------------------------------------------------------------


def test_reconfiguration_on_emulated_kernels(monkeypatch):
    from test_torch_reconfiguration import _twin
    from test_torch_residency import _emulate_all

    _emulate_all(monkeypatch)
    te.reset_launch_counts()
    t = _twin(monkeypatch)
    try:
        t.client_request("create_service", {"name": "em", "actives": [0, 1, 2]})
        ack = t.wait_for("create_ack", max_steps=120)
        assert ack and ack["ok"], ack
        t.run_requests("em", ["a", "b", "c"], entry=0)
        t.client_request("delete_service", {"name": "em"})
        ack = t.wait_for("delete_ack", max_steps=120)
        assert ack and ack["ok"], ack
        managers = t.p.ars.managers + t.p.rcs.managers
        assert te.LAUNCHES["gp_pack_rows"] == t.n_steps * len(managers)
        for m in managers:
            assert m.kernel_launches["gp_pack_rows"] == t.n_steps
        for k in ("gp_step", "gp_create_groups", "gp_kill_groups"):
            assert te.LAUNCHES[k] > 0, (k, te.LAUNCHES)
    finally:
        t.close()
