"""The frozen reference against the port's plain CPU path at a tiny
shape: every state word and out word, step by step."""

import numpy as np
import pytest
import torch

from gpbench.reference.paxos import OUT_FIELDS, STATE_FIELDS, Replicas


def _want(t, G, R):
    g = torch.arange(G)
    sl = (g % 16) == (t % 16)
    target = (g % R + 1 + t // 16) % R
    return (target[None, :] == torch.arange(R)[:, None]) & sl[None, :]


@pytest.mark.parametrize("W, K", [(8, 4), (16, 8)])
def test_stacked_face(W, K):
    from gigapaxos_tpu_torch.ops.engine import EngineConfig
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    G, R = 37, 3
    cfg = EngineConfig(G, W, K, R)
    face = make_step(cfg, None, 1, io="stacked", device="cpu")
    states = build_replica_states(cfg, device="cpu")
    ref = Replicas(np.arange(G), R, W, K)
    gen = torch.Generator().manual_seed(5)
    for t in range(48):
        req = torch.randint(1, 2 ** 29, (R, G, K), generator=gen, dtype=torch.int32)
        if t % 5 == 0:
            req[:, :, K - 1] = -1
        heard = torch.ones(R, R, dtype=torch.bool)
        if t % 7 == 3:
            heard[1, 2] = False
        want = _want(t, G, R)
        states, out = face(states, req, want, heard)
        got = ref.step(req, want, heard)
        for name in STATE_FIELDS:
            assert torch.equal(getattr(states, name),
                               ref.per_replica(getattr(ref.state, name))), (t, name)
        for name in OUT_FIELDS:
            assert torch.equal(getattr(out, name),
                               ref.per_replica(getattr(got, name))), (t, name)
    assert int(states.n_execd.sum()) > 0


def test_packed_faces():
    """Three packed faces ticking in lock step over each other's blobs."""
    from gigapaxos_tpu_torch.ops.engine import (EngineConfig, init_state, make_blob_vec,
                                                split_out_vec)
    from gigapaxos_tpu_torch.ops.lifecycle import create_groups
    from gigapaxos_tpu_torch.parallel.spmd import make_step

    G, W, K, R = 40, 8, 4, 3
    cfg = EngineConfig(G, W, K, R)
    face = make_step(cfg, None, 1, io="packed_host", heat=True, donate=False, device="cpu")
    idx = np.arange(G)
    st = [create_groups(init_state(cfg, "cpu"), idx, np.full(G, 7), (idx % R).astype(np.int32),
                        my_id=r) for r in range(R)]
    heat = [torch.zeros(G, dtype=torch.int32) for _ in range(R)]
    gvec = np.stack([make_blob_vec(s).numpy() for s in st])
    ref = Replicas(idx, R, W, K)
    rng = np.random.default_rng(3)
    for t in range(30):
        rings = np.full((R, 1, G, K), -1, dtype=np.int32)
        for g in range(G):
            rings[g % R, 0, g, :rng.integers(0, K + 1)] = rng.integers(1, 1 << 29, K)[:1]
        outs, blobs = [], []
        for r in range(R):
            st[r], o, b, heat[r] = face(st[r], gvec, np.ones(R, bool), rings[r],
                                        np.zeros(G, bool), r, heat[r])
            outs.append(split_out_vec(o[0].numpy(), cfg))
            blobs.append(b.numpy())
        gvec = np.stack(blobs)
        got = ref.step(torch.as_tensor(rings[:, 0]), torch.zeros(R, G, dtype=torch.bool))
        for name in OUT_FIELDS:
            want = ref.per_replica(getattr(got, name)).numpy()
            assert np.array_equal(np.stack([getattr(o, name) for o in outs]), want), (t, name)
    for name in STATE_FIELDS:
        assert torch.equal(torch.stack([getattr(s, name) for s in st]),
                           ref.per_replica(getattr(ref.state, name))), name
    assert torch.equal(torch.stack(heat), ref.per_replica(ref.heat))
