"""The staged batch of ``gp_create_groups``, ``gp_jump_rows``,
``gp_restore_paused_rows`` and ``gp_restore_rows`` on the CPU.

``gp_life_rows_kernel`` (``csrc/gp_lifecycle.cu``) finds its batch in
the one buffer :func:`gp_kernels.life_batch_host` builds: a thread tests
its row's bit in the bitmap, and a batch row finds its position in the
caller's batch by a binary search of the sorted rows, bounded by the
chunk counts, then the positions table.  :func:`lookup` does the same in
numpy, and :func:`apply_life_rows` writes a state as the kernel writes it
from that lookup.  Held here, from seeded batches at small shapes: the
buffer's parts against what they should hold, the lookup against the
caller's batch, the emulated kernel against the ops' ``*_plain`` versions
(and the JAX package's functions), and the refusals of a bad batch.  No
card needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import lifecycle as jl
from gigapaxos_tpu.ops.engine import EngineState as JState
from gigapaxos_tpu_torch.ops import engine as te
from gigapaxos_tpu_torch.ops import gp_kernels
from gigapaxos_tpu_torch.ops import lifecycle as tl

FIELDS = te.EngineState._fields
GW = gp_kernels.GW_LEAVES
NULL = -1


def lookup(bits, cnt, srt, pos, G: int) -> np.ndarray:
    """Each row's position in the caller's batch (-1 outside it), found as
    the kernel finds it: the row's bit, then a binary search of the sorted
    rows of its chunk (``cnt`` bounds it), then ``pos``."""
    g = np.arange(G)
    hit = ((bits.view(np.uint32)[g >> 5] >> (g & 31).astype(np.uint32)) & 1) == 1
    c = g >> 8
    lo, hi = cnt[c].astype(np.int64), cnt[c + 1].astype(np.int64)
    assert (hi[hit] > lo[hit]).all(), "a batch row's chunk counts no row"
    while True:
        act = hit & (hi - lo > 1)
        if not act.any():
            break
        mid = (lo + hi) >> 1
        le = np.zeros(G, bool)
        le[act] = srt[mid[act]] <= g[act]
        lo = np.where(act & le, mid, lo)
        hi = np.where(act & ~le, mid, hi)
    found = np.full(G, -1, np.int64)
    assert (srt[lo[hit]] == g[hit]).all(), "the search missed a batch row"
    found[hit] = pos[lo[hit]]
    return found


LIFE_NAMES = {gp_kernels.OP_CREATE: "gp_create_groups", gp_kernels.OP_JUMP: "gp_jump_rows",
              gp_kernels.OP_RESTORE_PAUSED: "gp_restore_paused_rows",
              gp_kernels.OP_RESTORE_ROWS: "gp_restore_rows"}


def apply_life_rows(op: int, s: dict, inp: dict, n_of: np.ndarray, my_id: int) -> dict:
    """The new touched leaves of ``gp_life_rows_kernel`` (create, jump,
    restore_paused or restore_rows): a row outside the batch keeps the
    input's words; a batch row's come from its caller's batch row
    ``n_of[g]`` (jump's also from the row's input words: bal's max, the
    window lanes it keeps)."""
    hit = n_of >= 0
    n = n_of[hit]
    name = LIFE_NAMES[op]
    if not hit.any():
        return {f: s[f].copy() for f in gp_kernels.TOUCHED[name]}
    out = {}
    if op == gp_kernels.OP_CREATE:
        mask = inp["member_mask"][n]
        coord0 = inp["bal"][n]
        me = coord0 == my_id
        majority = np.array([bin(int(x) & 0xFFFFFFFF).count("1") // 2 + 1 for x in mask],
                            np.int32)
        rows = dict(member_mask=mask, majority=majority, version=inp["version"][n],
                    stopped=0, tag=inp["tag"][n], bal=coord0, exec_slot=0,
                    app_hash=0, n_execd=0, c_phase=np.where(me, te.ACTIVE, te.IDLE),
                    c_bal=np.where(me, coord0, NULL), c_next_slot=0,
                    **{f: NULL for f in GW})
    elif op == gp_kernels.OP_JUMP:
        ne = inp["exec_slot"][n]
        rows = dict(bal=np.maximum(s["bal"][hit], inp["bal"][n]), exec_slot=ne,
                    app_hash=inp["app_hash"][n], n_execd=inp["n_execd"][n],
                    stopped=inp["stopped"][n], c_phase=te.IDLE, c_bal=NULL,
                    c_next_slot=ne, c_prop_vid=NULL, c_prop_slot=NULL)
        for slot, planes in (("acc_slot", ("acc_bal", "acc_vid", "acc_slot")),
                             ("dec_slot", ("dec_vid", "dec_slot"))):
            old = s[slot][hit]
            keep = (old != NULL) & (old >= ne[:, None])
            for f in planes:
                rows[f] = np.where(keep, s[f][hit], NULL)
    elif op == gp_kernels.OP_RESTORE_ROWS:
        rows = {f: inp[f][n] for f in FIELDS}
    else:
        rows = {f: inp[f][n] for f in ("bal", "exec_slot", "app_hash", "n_execd",
                                       "acc_bal", "acc_vid", "acc_slot", "dec_vid",
                                       "dec_slot")}
        rows["c_next_slot"] = inp["exec_slot"][n]
    for f, v in rows.items():
        o = s[f].copy()
        o[hit] = v
        out[f] = o
    return out


def _state(rng, G, W):
    d = {f: rng.integers(-1, 400, size=(G, W) if f in GW else (G,)).astype(np.int32)
         for f in FIELDS}
    d["app_hash"] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G).astype(np.int32)
    return d


def _args(op, rng, G, W, N):
    idx = rng.choice(G, size=N, replace=False)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    if op == "create":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[::2] = rng.integers(1, 8, size=masks[::2].shape)
        coord0 = tl.initial_coordinator(idx, masks & 7)
        return idx, dict(member_mask=masks, bal=coord0, version=n(0, 4),
                         tag=n(1, 1000))
    if op == "jump":
        # frontiers below, among and above the window's slots, negative too
        return idx, dict(exec_slot=n(-600, 500), bal=n(-1, 500),
                         app_hash=n(-2 ** 31, 2 ** 31 - 1), n_execd=n(0, 9),
                         stopped=n(0, 2))
    if op == "restore_rows":
        return idx, {f: v[rng.choice(G, size=N, replace=False)]
                     for f, v in _state(rng, G, W).items()}
    return idx, dict(exec_slot=n(-1, 500), bal=n(-1, 500),
                     app_hash=n(-2 ** 31, 2 ** 31 - 1), n_execd=n(0, 9),
                     **{f: rng.integers(-1, 500, size=(N, W))
                        for f in ("acc_bal", "acc_vid", "acc_slot", "dec_vid", "dec_slot")})


def _parts(buf, off, G, W, N):
    at = lambda k, n: buf[off[k]:off[k] + n]
    return (at("bits", -(-G // 32)), at("cnt", -(-G // gp_kernels.CHUNK_ROWS) + 1),
            at("idx", N), at("pos", N))


CASES = [(G, W, N) for G, W in ((41, 8), (300, 4), (301, 16), (1024, 8), (96, 32))
         for N in (0, 1, 7, 64) if N <= G] + [(64, 8, 64), (513, 4, 300)]
# the ops on gp_life_rows_kernel: (kernel op, name, seed offset)
ROW_OPS = {"create": (gp_kernels.OP_CREATE, "gp_create_groups", 1),
           "restore_paused": (gp_kernels.OP_RESTORE_PAUSED, "gp_restore_paused_rows", 0),
           "jump": (gp_kernels.OP_JUMP, "gp_jump_rows", 2),
           "restore_rows": (gp_kernels.OP_RESTORE_ROWS, "gp_restore_rows", 3)}


@pytest.mark.parametrize("op", list(ROW_OPS))
@pytest.mark.parametrize("G,W,N", CASES)
def test_staged_batch_lookup_gives_the_plain_result(op, G, W, N):
    kop, name, seed = ROW_OPS[op]
    rng = np.random.default_rng(G * 1000 + W * 10 + N + seed)
    s = _state(rng, G, W)
    idx, inputs = _args(op, rng, G, W, N)
    assert tuple(inputs) == gp_kernels.INPUTS[name]
    buf, off = gp_kernels.life_batch_host(idx, inputs, G, W, name)
    assert buf.dtype == np.int32 and off["N"] == N
    for k in ("idx", "pos", "cnt", "bits", *inputs):   # 16-byte aligned parts
        assert off[k] % 4 == 0, k
    bits, cnt, srt, pos = _parts(buf, off, G, W, N)
    np.testing.assert_array_equal(srt, np.sort(idx))
    np.testing.assert_array_equal(idx[pos], srt)
    np.testing.assert_array_equal(
        cnt, [np.count_nonzero(idx < c * gp_kernels.CHUNK_ROWS) for c in range(len(cnt))])
    inp = {}
    for leaf, v in inputs.items():
        shape = (N, W) if leaf in GW else (N,)
        inp[leaf] = buf[off[leaf]:off[leaf] + int(np.prod(shape))].reshape(shape)
        np.testing.assert_array_equal(inp[leaf], np.asarray(v).astype(np.int32))
    n_of = lookup(bits, cnt, srt, pos, G)
    want_n = np.full(G, -1)
    want_n[idx] = np.arange(N)
    np.testing.assert_array_equal(n_of, want_n)

    my_id = int(inputs["bal"][0]) if op == "create" and N else 1
    got = apply_life_rows(kop, s, inp, n_of, my_id)
    st = te.EngineState(**{k: torch.as_tensor(v) for k, v in s.items()})
    js = JState(**{k: jnp.asarray(v) for k, v in s.items()})
    if op == "create":
        args = (idx, inputs["member_mask"], inputs["bal"])
        kw = dict(my_id=my_id, version=inputs["version"], tag=inputs["tag"])
        plain = tl.create_groups_plain(st, *args, **kw)
        ref = jl.create_groups(js, *args, **kw)
    elif op == "jump":
        args = (idx, *inputs.values())
        plain = tl.jump_rows_plain(st, *args)
        ref = jl.jump_rows(js, *args)
    elif op == "restore_rows":
        plain = tl.restore_rows_plain(st, idx, tuple(inputs.values()))
        ref = jl.restore_rows(js, idx, tuple(jnp.asarray(v) for v in inputs.values()))
    else:
        args = (idx, *inputs.values())
        plain = tl.restore_paused_rows_plain(st, *args)
        ref = jl.restore_paused_rows(js, *args)
    assert set(got) == set(gp_kernels.TOUCHED[name])
    for f in FIELDS:
        want = getattr(plain, f).numpy()
        np.testing.assert_array_equal(got.get(f, s[f]), want, err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), want, err_msg=f)


def test_staged_batch_takes_scalars_and_any_integer_rows():
    """Scalars broadcast as the plain version's assignment does; rows given
    as uint16 arrays, a CPU tensor or a list stage the same parts; values
    wrap to int32."""
    G, W, N = 200, 8, 6
    idx = np.array([199, 3, 64, 65, 31, 32])
    inputs = dict(member_mask=np.array([7, 5, 3, 2 ** 32 + 1, -1, 6]), bal=1,
                  version=0, tag=np.arange(6))
    sizes = dict(idx=N, pos=N, cnt=2, bits=7, member_mask=N, bal=N, version=N, tag=N)
    parts = lambda buf, off: {k: buf[off[k]:off[k] + n].tolist() for k, n in sizes.items()}
    want, off = gp_kernels.life_batch_host(idx, inputs, G, W)
    for rows in (idx.astype(np.uint16), torch.as_tensor(idx), list(idx)):
        got, off2 = gp_kernels.life_batch_host(rows, inputs, G, W)
        assert off2 == off
        assert parts(got, off2) == parts(want, off)
    p = parts(want, off)
    assert p["member_mask"] == [7, 5, 3, 1, -1, 6]
    assert p["bal"] == [1] * N and p["version"] == [0] * N
    words = []
    got, _ = gp_kernels.life_batch_host(idx, inputs, G, W,
                                        alloc=lambda n: words.append(n) or np.empty(n, np.int32))
    assert words == [want.size]
    assert parts(got, off) == p


@pytest.mark.parametrize("name", [name for _op, name, _seed in ROW_OPS.values()])
def test_staged_batch_refuses_bad_rows(name):
    G, W = 16, 8
    good = {leaf: np.zeros((4, W) if leaf in GW else 4, np.int64)
            for leaf in gp_kernels.INPUTS[name]}
    call = lambda idx: gp_kernels.life_batch_host(np.array(idx), good, G, W, name)
    for bad, err in (([0, 1, 2, G], "outside"), ([0, -1, 2, 3], "outside"),
                     ([[0, 1], [2, 3]], "1-D"), ([3, 5, 3, 1], "duplicate"),
                     ([2 ** 32 + 1, 0, 2, 3], "outside")):
        with pytest.raises(ValueError, match=err):
            call(bad)
    with pytest.raises(TypeError):
        call([0.0, 1.0, 2.0, 3.0])
    wrong = dict(good)
    leaf = gp_kernels.INPUTS[name][-1]
    wrong[leaf] = np.zeros((5, W) if leaf in GW else 5)
    with pytest.raises(ValueError, match="does not fit"):
        gp_kernels.life_batch_host(np.arange(4), wrong, G, W, name)


def test_other_ops_stage_rows_in_the_callers_order():
    """Extract reads the rows in the caller's order and nothing else; kill
    reads the bitmap of its unique rows."""
    G = 70
    idx = np.array([5, 69, 0, 33])
    buf, off = gp_kernels.rows_batch_host(idx, G)
    assert set(off) == {"idx", "N"} and off["N"] == 4
    np.testing.assert_array_equal(buf[off["idx"]:off["idx"] + 4], idx)
    buf, off = gp_kernels.rows_batch_host(np.array([5, 69, 5, 0]), G, kill=True)
    assert off["N"] == 3
    bits = buf[off["bits"]:off["bits"] + 3].view(np.uint32)
    assert [g for g in range(G) if (bits[g >> 5] >> (g & 31)) & 1] == [0, 5, 69]
    with pytest.raises(ValueError, match="duplicate"):
        gp_kernels.rows_batch_host(np.array([5, 69, 5, 0]), G)
