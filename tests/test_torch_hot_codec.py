"""The binary hot-path codec ('R'/'S' frames, ``net/hot_codec.py``) on
both packages: ``tests/test_hot_codec.py`` run on the JAX package and the
port.

Every frame the port encodes is byte-equal to the JAX package's for the
same items, under the native codec and under ``GP_NO_NATIVE=1``, and each
package decodes the other's frames to the same items.  The goldens,
malformed-frame refusals and the native-toolchain lifecycle (the port
builds its library in the checkout's ``build/native/``) hold on the port.
"""

import os
import struct

import pytest

from torch_pkgs import JAX, PKGS, TORCH

REQ_ITEMS = [
    (123456789012345678, "probe0", "value-äß\x00end", False),
    ((1 << 61) + 7, "n", "", True),
    (1, "a" * 300, "v" * 5000, False),
    (99, "tr", "tv", False, ((1 << 62) + 5, 3, 2)),
    (100, "tr2", "", True, (1, -1, 0)),
]
RESP_ITEMS = [
    {"request_id": 42, "response": "ok:1", "name": "probe0"},
    {"request_id": 43, "response": None, "name": "x", "error": "overload"},
    {"request_id": 44, "response": None, "name": "y", "error": "unknown_name"},
    {"request_id": 45, "response": "", "name": "z", "error": "exhausted"},
    {"request_id": 46, "response": "ok", "name": "t",
     "tc": [(1 << 62) + 5, 3, 2]},
    {"request_id": 47, "response": None, "name": "t2",
     "error": "overload", "tc": [7, -1, 0]},
]
# the wire layout, from the documented format (tests/test_hot_codec.py)
GOLDEN_R = (
    b"R" + struct.pack("<iI", -1, 1)
    + struct.pack("<QBHI", 7, 1, 2, 1) + b"ab" + b"c"
)
GOLDEN_S = (
    b"S" + struct.pack("<iI", 2, 1)
    + struct.pack("<QBBHI", 9, 1, 0, 1, 0) + b"n"
)
TC = (0x1122334455667788, 3, 2)
GOLDEN_R_TRACED = (
    b"R" + struct.pack("<iI", -1, 1)
    + struct.pack("<QBHI", 7, 1 | 2, 2, 1) + b"ab" + b"c"
    + struct.pack("<QiB", *TC)
)
GOLDEN_S_TRACED = (
    b"S" + struct.pack("<iI", 2, 1)
    + struct.pack("<QBBHI", 9, 1, 0 | 2, 1, 0) + b"n"
    + struct.pack("<QiB", *TC)
)


def _hc(pkg):
    return pkg.mod("net.hot_codec")


def _reset_native():
    for pkg in PKGS:
        pkg.mod("native")._libs.clear()


@pytest.fixture(params=["native", "python"])
def codec_mode(request, monkeypatch):
    """Both packages under the native codec, then under the pure-Python
    fallback."""
    if request.param == "python":
        monkeypatch.setenv("GP_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    _reset_native()
    yield request.param
    _reset_native()


def _need_native(mode):
    if mode == "native" and not all(_hc(p).native_active() for p in PKGS):
        pytest.skip("no C++ toolchain in this environment")


def test_request_frames_equal_and_cross_decode(codec_mode):
    frames = {p.root: _hc(p).encode_request_batch(-1, REQ_ITEMS) for p in PKGS}
    _need_native(codec_mode)
    assert frames[JAX.root] == frames[TORCH.root]
    for p in PKGS:
        for f in frames.values():
            assert _hc(p).decode_request_batch(f) == (-1, REQ_ITEMS)


def test_response_frames_equal_and_cross_decode(codec_mode):
    frames = {p.root: _hc(p).encode_response_batch(5, RESP_ITEMS) for p in PKGS}
    assert frames[JAX.root] == frames[TORCH.root]
    for p in PKGS:
        for f in frames.values():
            assert _hc(p).decode_response_batch(f) == (5, RESP_ITEMS)


def test_golden_bytes(codec_mode):
    hc = _hc(TORCH)
    assert hc.encode_request_batch(-1, [(7, "ab", "c", True)]) == GOLDEN_R
    assert hc.encode_response_batch(2, [{
        "request_id": 9, "response": None, "name": "n", "error": "overload",
    }]) == GOLDEN_S


def test_golden_bytes_traced(codec_mode):
    hc = _hc(TORCH)
    frame = hc.encode_request_batch(-1, [(7, "ab", "c", True, TC)])
    assert frame == GOLDEN_R_TRACED
    assert hc.decode_request_batch(frame) == (-1, [(7, "ab", "c", True, TC)])
    sframe = hc.encode_response_batch(2, [{
        "request_id": 9, "response": None, "name": "n",
        "error": "overload", "tc": list(TC),
    }])
    assert sframe == GOLDEN_S_TRACED
    _s, items = hc.decode_response_batch(sframe)
    assert items[0]["tc"] == list(TC)
    assert items[0]["error"] == "overload" and items[0]["response"] is None


def _all_frames():
    out = {}
    for p in PKGS:
        hc = _hc(p)
        r = hc.encode_request_batch(-1, REQ_ITEMS)
        s = hc.encode_response_batch(3, RESP_ITEMS)
        out[p.root] = (hc.native_active(), r, s,
                       hc.decode_request_batch(r), hc.decode_response_batch(s))
    return out


def test_native_python_parity(monkeypatch):
    """Four implementations (two packages, native and Python) give the
    same bytes and the same decoded items."""
    monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    _reset_native()
    native = _all_frames()
    if not all(v[0] for v in native.values()):
        pytest.skip("no C++ toolchain in this environment")
    monkeypatch.setenv("GP_NO_NATIVE", "1")
    _reset_native()
    try:
        python = _all_frames()
    finally:
        _reset_native()
    assert not any(v[0] for v in python.values())
    want = native[JAX.root][1:]
    for got in (native[TORCH.root], python[JAX.root], python[TORCH.root]):
        assert got[1:] == want


def test_malformed_frames_rejected(codec_mode):
    for p in PKGS:
        hc = _hc(p)
        good = hc.encode_request_batch(-1, REQ_ITEMS)
        for bad in (
            b"", b"R", good[:-1], good + b"x",
            b"R" + struct.pack("<iI", -1, 99) + b"\x00" * 10,
            b"J" + good[1:],
        ):
            with pytest.raises(ValueError):
                hc.decode_request_batch(bad)
        goods = hc.encode_response_batch(1, RESP_ITEMS)
        for bad in (b"", goods[:-1], goods + b"y"):
            with pytest.raises(ValueError):
                hc.decode_response_batch(bad)


def test_unknown_error_string_falls_back_to_json():
    item = {"request_id": 1, "response": None, "name": "n",
            "error": "weird_new_error"}
    for p in PKGS:
        assert not _hc(p).encodable_response(item)
        assert _hc(p).encodable_response(RESP_ITEMS[0])


def test_native_builds_from_source_in_build_dir(monkeypatch):
    """The port's codec library builds from its .cc into the checkout's
    ``build/native/`` (never next to the source) and goes live."""
    native = TORCH.mod("native")
    so = os.path.join(native._BUILD_DIR, "libgp_codec.so")
    monkeypatch.delenv("GP_NO_NATIVE", raising=False)
    native._libs.clear()
    if os.path.exists(so):
        os.unlink(so)  # force a rebuild from source
    lib = native.codec_lib()
    if lib is None:
        pytest.skip("no C++ toolchain in this environment")
    assert os.path.exists(so)
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__),
                                           "libgp_codec.so"))
    assert _hc(TORCH).status()["impl"] == "gp_codec.so"
    native._libs.clear()


def test_clean_fallback_when_toolchain_absent(monkeypatch, tmp_path):
    """A host with no compiler: the port's loader returns None, the codec
    still round-trips through Python, and status() says so."""
    native = TORCH.mod("native")
    native._libs.clear()
    monkeypatch.setattr(native, "_build", lambda src, so_: False)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    assert native.codec_lib() is None
    st = _hc(TORCH).status()
    assert st["native"] is False and st["impl"] == "python-struct"
    frame = _hc(TORCH).encode_request_batch(-1, REQ_ITEMS)
    assert frame == _hc(JAX).encode_request_batch(-1, REQ_ITEMS)
    assert _hc(TORCH).decode_request_batch(frame) == (-1, REQ_ITEMS)
    native._libs.clear()
