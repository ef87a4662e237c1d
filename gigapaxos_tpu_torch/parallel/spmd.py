"""The unified consensus step factory (single device).

ONE factory — :func:`make_step` — builds both execution faces of
:func:`gigapaxos_tpu_torch.ops.engine.step`:

* ``io="stacked"`` — the bench face: states are the stacked
  ``[R, G, ...]`` layout, requests ``[R, G, K]`` (``[N, R, G, K]`` for
  N > 1), outputs :class:`StepOutputs` of ``[R, ...]`` (``[N, R, ...]``)
  leaves.  Every replica advances each substep and the blob exchange is
  re-read from the advancing states, so N stacked substeps are exactly N
  sequential stacked calls.  On the card each substep is ONE ``gp_step``
  launch over an (R x group-tile) grid, exchanging through a
  double-buffered ``[R, NB]`` blob matrix.

* ``io="packed_host"`` — the deployed-runtime face (one replica's state,
  peers' blobs arriving as the packed ``[R, NB]`` gathered matrix == the
  ``D`` wire-frame bodies): returns ``(state', out_rings [N, M],
  blob_vec)``.  Substep 0 consumes the gathered rows exactly as passed;
  substeps >= 1 refresh only MY row from the advancing state while peers'
  rows stay frozen — the semantics of N serial host ticks during which no
  new peer frame lands.  On the card: N ``gp_step`` launches, each
  writing state', its out-ring row and the fresh blob, with the heat
  accumulator fused into the epilogue.

``steps_per_dispatch`` (N >= 1) runs N consensus rounds per host call.

State is never updated in place.  Every call returns a NEW
:class:`EngineState` object in freshly allocated tensors, so nothing the
caller still holds is overwritten (PyTorch's caching allocator hands back
the blocks of states the caller has dropped).  ``donate=True`` only lets
the packed face update the heat accumulator in place.

Multi-device meshes are not part of this port yet (ROADMAP item A10):
a non-``None`` mesh raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..ops import engine as _engine
from ..ops.engine import (
    EngineConfig,
    EngineState,
    StepOutputs,
    make_blob_plain,
    out_vec_len,
    pack_blob,
    pack_out,
    resolve_device,
    step_plain,
    unpack_gathered,
    unpack_out,
)


def stack_states(states: List[EngineState]) -> EngineState:
    """Stack per-replica states into the [R, ...] global layout."""
    return EngineState(*(torch.stack(xs) for xs in zip(*states)))


def build_replica_states(cfg: EngineConfig, coord0=None,
                         device=None) -> EngineState:
    """Stacked [R, ...] states with all groups created full-membership;
    ``coord0`` defaults to round-robin by group index."""
    from ..ops.engine import init_state
    from ..ops.lifecycle import create_groups

    device = resolve_device(device)
    G, R = cfg.n_groups, cfg.n_replicas
    idx = np.arange(G)
    masks = np.full(G, (1 << R) - 1)
    coord0 = (idx % R).astype(np.int32) if coord0 is None else coord0
    return stack_states([
        create_groups(init_state(cfg, device), idx, masks, coord0, my_id=rid)
        for rid in range(R)
    ])


def _as(x, dtype, device) -> torch.Tensor:
    """numpy / python / tensor -> a contiguous tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()


def _heard_matrix(heard, R: int, device) -> torch.Tensor:
    # a replica always hears itself — the diagonal is forced (ref fault
    # model: testing/TESTPaxosConfig.java:563-580)
    eye = torch.eye(R, dtype=torch.bool, device=device)
    if heard is None:
        return torch.ones((R, R), dtype=torch.bool, device=device)
    return (_as(heard, torch.bool, device) | eye).contiguous()


class _StackedStep:
    def __init__(self, cfg: EngineConfig, n_steps: int, device: torch.device):
        self.cfg, self.n_steps, self.device = cfg, n_steps, device

    def _outs(self, mat: torch.Tensor) -> StepOutputs:
        """[..., R, M] out matrix -> StepOutputs of [..., R, ...] leaves."""
        lead = tuple(mat.shape[:-1])
        flat = unpack_out(mat.reshape(-1, mat.shape[-1]), self.cfg)
        return StepOutputs(*(
            x.reshape(lead + tuple(x.shape[1:])) for x in flat
        ))

    def _plain_substep(self, states, req, want, h):
        cfg, R = self.cfg, self.cfg.n_replicas
        per = [EngineState(*(x[r] for x in states)) for r in range(R)]
        gathered = unpack_gathered(
            torch.stack([pack_blob(make_blob_plain(s)) for s in per]), cfg
        )
        news, outs = [], []
        for r, s in enumerate(per):
            ns, o = step_plain(s, gathered, h[r], req[r], want[r], r, cfg)
            news.append(ns)
            outs.append(pack_out(o))
        return stack_states(news), torch.stack(outs)

    def _prep(self, states, req_vid, want_coord, heard):
        R, dev = self.cfg.n_replicas, self.device
        if states.bal.device != dev:
            raise ValueError(f"states on {states.bal.device}, step on {dev}")
        h = _heard_matrix(heard, R, dev)
        req = _as(req_vid, torch.int32, dev)
        want = _as(want_coord, torch.bool, dev)
        if self.n_steps == 1:
            req = req[None]
        return req, want, torch.zeros_like(want), h

    def plain(self, states: EngineState, req_vid, want_coord, heard=None):
        """The plain PyTorch version of this face, on any device (the
        kernel path's yardstick on the card)."""
        req, want, no_want, h = self._prep(states, req_vid, want_coord, heard)
        return self._plain(states, req, want, no_want, h)

    def _plain(self, states, req, want, no_want, h):
        st, mats = states, []
        for i in range(self.n_steps):
            # want_coord fires only at substep 0 (an election pulse is a
            # host decision; replaying it would re-bump ballots N times)
            st, mat = self._plain_substep(
                st, req[i], want if i == 0 else no_want, h
            )
            mats.append(mat)
        mat = torch.stack(mats) if self.n_steps > 1 else mats[0]
        return st, self._outs(mat)

    def __call__(self, states: EngineState, req_vid, want_coord, heard=None):
        cfg, N, dev = self.cfg, self.n_steps, self.device
        R = cfg.n_replicas
        req, want, no_want, h = self._prep(states, req_vid, want_coord, heard)
        if not _engine.on_card(states.bal):
            return self._plain(states, req, want, no_want, h)
        from ..ops import gp_kernels

        mat = torch.empty((N, R, out_vec_len(cfg)), dtype=torch.int32,
                          device=dev)
        blobs = gp_kernels.make_blob_rows(states, R)
        blobs_next = torch.empty_like(blobs) if N > 1 else None
        st = states
        for i in range(N):
            st, _, _ = gp_kernels.step_stacked(
                st, blobs, h, req[i], want if i == 0 else no_want, cfg,
                out_mat=mat[i],
                out_blobs=blobs_next if i < N - 1 else None,
            )
            if i < N - 1:
                blobs, blobs_next = blobs_next, blobs
        return st, self._outs(mat if N > 1 else mat[0])


class _PackedStep:
    def __init__(self, cfg: EngineConfig, n_steps: int, donate: bool,
                 heat: bool, device: torch.device):
        self.cfg, self.n_steps, self.donate = cfg, n_steps, donate
        self.heat, self.device = heat, device

    def _prep(self, state, gvec, heard, req_ring, want_coord, my_id,
              heat_acc):
        dev = self.device
        if state.bal.device != dev:
            raise ValueError(f"state on {state.bal.device}, step on {dev}")
        if self.heat and heat_acc is None:
            raise TypeError("heat=True step needs the heat accumulator")
        want = _as(want_coord, torch.bool, dev)
        return (
            _as(gvec, torch.int32, dev), _as(heard, torch.bool, dev),
            _as(req_ring, torch.int32, dev), want, torch.zeros_like(want),
            int(my_id),
            _as(heat_acc, torch.int32, dev) if self.heat else None,
        )

    def plain(self, state: EngineState, gvec, heard, req_ring, want_coord,
              my_id, heat_acc=None):
        """The plain PyTorch version of this face, on any device (the
        kernel path's yardstick on the card)."""
        return self._plain(state, *self._prep(
            state, gvec, heard, req_ring, want_coord, my_id, heat_acc
        ))

    def __call__(self, state: EngineState, gvec, heard, req_ring,
                 want_coord, my_id, heat_acc=None, *, launch_log=None):
        """``launch_log`` (optional): the caller's own kernel-launch
        counter (see :func:`gigapaxos_tpu_torch.ops.gp_kernels.step`)."""
        cfg, N, dev = self.cfg, self.n_steps, self.device
        gvec, heard, req_ring, want, no_want, my_id, heat_acc = self._prep(
            state, gvec, heard, req_ring, want_coord, my_id, heat_acc
        )
        if not _engine.on_card(state.bal):
            return self._plain(state, gvec, heard, req_ring, want, no_want,
                               my_id, heat_acc)
        from ..ops import gp_kernels

        out_rings = torch.empty((N, out_vec_len(cfg)), dtype=torch.int32,
                                device=dev)
        heat_out = None
        if self.heat:
            heat_out = heat_acc if self.donate else torch.empty_like(heat_acc)
        g = gvec
        st = state
        blob = None
        for i in range(N):
            st, _, blob, _ = gp_kernels.step(
                st, g, heard, req_ring[i], want if i == 0 else no_want,
                my_id, cfg, with_blob=True,
                heat=(heat_acc if i == 0 else heat_out) if self.heat else None,
                heat_out=heat_out, out_vec=out_rings[i],
                launch_log=launch_log,
            )
            if i < N - 1:
                # substeps >= 1 read MY row from the advancing state;
                # peers' rows stay frozen for the whole dispatch
                if g is gvec:
                    g = gvec.clone()
                g[my_id].copy_(blob)
        if self.heat:
            return st, out_rings, blob, heat_out
        return st, out_rings, blob

    def _plain(self, state, gvec, heard, req_ring, want, no_want, my_id,
               heat_acc):
        cfg, N = self.cfg, self.n_steps
        g0 = unpack_gathered(gvec, cfg)
        st = state
        rows = []
        for i in range(N):
            g = g0
            if i > 0:
                mine = make_blob_plain(st)
                g = type(g0)(*(
                    _replace_row(gl, my_id, bl) for gl, bl in zip(g0, mine)
                ))
            st, out = step_plain(
                st, g, heard, req_ring[i], want if i == 0 else no_want,
                my_id, cfg,
            )
            rows.append(pack_out(out))
            if self.heat:
                heat_acc = heat_acc + out.n_committed + out.n_admitted
        blob_vec = pack_blob(make_blob_plain(st))
        out_rings = torch.stack(rows)
        if self.heat:
            return st, out_rings, blob_vec, heat_acc
        return st, out_rings, blob_vec


def _replace_row(leaf: torch.Tensor, r: int, row: torch.Tensor) -> torch.Tensor:
    out = leaf.clone()
    out[r] = row
    return out


@functools.lru_cache(maxsize=None)
def _make_step_cached(cfg, steps_per_dispatch, donate, io, heat, device):
    from ..obs.device import StepSentinel

    if steps_per_dispatch < 1:
        raise ValueError("steps_per_dispatch must be >= 1")
    if io == "stacked":
        if heat:
            raise ValueError(
                "heat accumulation is a packed_host feature (the "
                "stacked face reads StepOutputs directly)"
            )
        fn = _StackedStep(cfg, steps_per_dispatch, device)
    elif io == "packed_host":
        fn = _PackedStep(cfg, steps_per_dispatch, donate, heat, device)
    else:
        raise ValueError(f"unknown io flavor: {io!r}")
    label = (
        f"make_step[{io} N={steps_per_dispatch} donate={donate} "
        f"heat={heat} device={device} G={cfg.n_groups} "
        f"R={cfg.n_replicas} W={cfg.window} K={cfg.req_lanes}]"
    )
    return StepSentinel(fn, label=label)


def make_step(cfg: EngineConfig, mesh=None, steps_per_dispatch: int = 1, *,
              donate: bool = True, io: str = "stacked", heat: bool = False,
              device=None):
    """Build THE consensus step.

    Parameters
    ----------
    cfg : EngineConfig
    mesh : must be ``None`` (one device).  Multi-GPU faces are ROADMAP
        item A10 and raise :class:`NotImplementedError`.
    steps_per_dispatch : N >= 1 consensus rounds per host call
        (``ENGINE_STEPS_PER_DISPATCH``).
    donate : the caller gives up its heat accumulator, which the packed
        face then updates in place.  The state is always written to new
        tensors; ``False`` keeps every input valid.
    io : ``"stacked"`` ([R, ...] bench face) or ``"packed_host"`` (one
        replica + packed [R, NB] gathered vectors — the deployed
        runtime's face).
    heat : (``packed_host`` only) carry a ``[G]`` int32 activity
        accumulator: the step takes it as a trailing argument and returns
        ``heat + n_committed + n_admitted`` over every substep.
    device : ``None`` = the CUDA card (raises when there is none);
        ``"cpu"`` runs the plain PyTorch engine.

    Instances are memoized per (cfg, N, donate, io, heat, device), and
    each is wrapped in a :class:`gigapaxos_tpu_torch.obs.device.StepSentinel`.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device meshes are not ported yet (ROADMAP A10: "
            "multi-GPU faces over NCCL); pass mesh=None"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _make_step_cached(
        cfg, int(steps_per_dispatch), bool(donate), str(io), bool(heat), dev,
    )
