"""The unified consensus step factory.

ONE factory — :func:`make_step` — builds both execution faces of
:func:`gigapaxos_tpu_torch.ops.engine.step`:

* ``io="stacked"`` — the bench face: states are the stacked
  ``[R, G, ...]`` layout, requests ``[R, G, K]`` (``[N, R, G, K]`` for
  N > 1), outputs :class:`StepOutputs` of ``[R, ...]`` (``[N, R, ...]``)
  leaves.  Every replica advances each substep and the blob exchange is
  re-read from the advancing states, so N stacked substeps are exactly N
  sequential stacked calls.  On the card N > 1 substeps are ONE
  ``gp_step_cluster`` launch for R up to 8 (a cluster of R CTAs per
  group tile, the replicas' blobs exchanged in the cluster's shared
  memory); N = 1, and R above the portable cluster size of 8, take a
  ``gp_make_blob`` and one ``gp_step`` launch per substep over an (R x
  group-tile) grid, exchanging through a double-buffered ``[R, NB]`` blob
  matrix (:func:`gigapaxos_tpu_torch.ops.gp_kernels.stacked_route`).

* ``io="packed_host"`` — the deployed-runtime face (one replica's state,
  peers' blobs arriving as the packed ``[R, NB]`` gathered matrix == the
  ``D`` wire-frame bodies): returns ``(state', out_rings [N, M],
  blob_vec)``.  Substep 0 consumes the gathered rows exactly as passed;
  substeps >= 1 refresh only MY row from the advancing state while peers'
  rows stay frozen — the semantics of N serial host ticks during which no
  new peer frame lands.  On the card: ONE launch (``gp_step`` at N = 1,
  ``gp_step_n`` at N > 1) with the state held in shared memory across
  the substeps, writing state', every out-ring row and the fresh blob,
  with the heat accumulator fused into the epilogue.

``steps_per_dispatch`` (N >= 1) runs N consensus rounds per host call.

State is never updated in place.  Every call returns a NEW
:class:`EngineState` object in freshly allocated tensors, so nothing the
caller still holds is overwritten (PyTorch's caching allocator hands back
the blocks of states the caller has dropped).  ``donate=True`` only lets
the packed face update the heat accumulator in place.

The mesh is data (:mod:`.mesh`), and ONE process drives every device of
it.  The stacked face takes a ``mesh``:

* ``None``: one device;
* a ``('g',)`` mesh (``make_group_mesh``): the state is split over G,
  every shard holding all R replica rows, and each shard runs the stacked
  face above on its own device (N > 1 with R <= 8: one
  ``gp_step_cluster``; else one ``gp_make_blob`` and one stacked
  ``gp_step`` per substep); no exchange, no host sync between shards;
* a ``(g, r)`` mesh (``make_mesh``): device (gi, ri) holds replica ri's
  rows of g-shard gi.  Each substep every device's compact blob
  (``gp_make_blob`` at substep 0, then ``gp_step``'s fresh blob, written
  into its own row of its ``[R, NB]`` gather buffer) is copied into the
  same row of the buffer of every other device of its g-row (between
  cards a peer copy; on one card a copy all the same, each logical device
  owning its buffers), and one ``gp_step`` per device folds the buffer
  for its replica with its row of ``heard``.  This copy is the
  reference's GSPMD ``all_gather`` over 'r'.  Its replicas live on
  different devices and exchange between substeps, so this face keeps N
  ``gp_step`` launches a device (no cluster spans devices).

Either way a call takes a global ``EngineState`` (tensors or numpy, split
on entry as the reference's ``_constrain`` does) or one of
:class:`~.mesh.ShardedTensor` leaves on the same mesh, and returns a
sharded state and sharded outputs.  A G that does not divide over 'g' is
padded with inert rows (member mask 0), bit-equal to
:func:`pad_group_states`, and the pad never leaves the shards.  Results
are bit-identical across meshes (all-int32 arithmetic).

The packed face takes a mesh too, as the reference's ``_constrain(mesh,
state, 'g')`` does: one replica's state (and the heat accumulator) split
over 'g', replicated over 'r' on a ``(g, r)`` mesh (every device of a
g-row runs the same shard, as GSPMD runs a ``P('g')`` program).  Each
device takes its rows of the packed ``[R, NB]`` gathered matrix (one
slice per leaf: the layout is leaf-major), runs the one-device packed
face on its shard (one launch, ``gp_step_n`` at N > 1, heat fused, MY row
refreshed from substep 1), and the shards' ``out_rings`` and blobs are reassembled
into the global leaf-major ``[N, M]`` and ``[NB]`` vectors on the mesh's
first device, bit-equal to ``mesh=None``.  Pad rows get the inert blob
in the gathered slices and never reach the outputs.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch

from ..ops import engine as _engine
from ..ops.engine import (
    NULL,
    Blob,
    EngineConfig,
    EngineState,
    StepOutputs,
    blob_vec_len,
    make_blob_plain,
    out_vec_len,
    pack_blob,
    pack_out,
    resolve_device,
    step_plain,
    unpack_gathered,
    unpack_out,
)
from .mesh import GROUP_AXIS, REPLICA_AXIS, Mesh, ShardedTensor


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
        from ..ops import gp_kernels

        self.cfg, self.n_steps, self.device = cfg, n_steps, device
        # the kernel path's route, by shape alone (never because a build or
        # launch failed): a cluster holds the R replicas of a tile for N > 1
        # substeps while R fits the portable cluster size; else N launches
        self.route = gp_kernels.stacked_route(cfg, n_steps)
        if _engine.on_card(device):
            from ..obs.gplog import get_logger

            get_logger("engine").info(
                "stacked face N=%d R=%d on %s: %s", n_steps, cfg.n_replicas,
                device, "one gp_step_cluster launch a dispatch"
                if self.route == "cluster" else
                "gp_make_blob and N gp_step launches a dispatch")

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

    def __call__(self, states: EngineState, req_vid, want_coord, heard=None,
                 *, launch_log=None):
        """``launch_log`` (optional): the caller's own kernel-launch
        counter (see :func:`gigapaxos_tpu_torch.ops.gp_kernels.step`)."""
        cfg, N, dev = self.cfg, self.n_steps, self.device
        R = cfg.n_replicas
        req, want, no_want, h = self._prep(states, req_vid, want_coord, heard)
        if not _engine.on_card(states.bal):
            return self._plain(states, req, want, no_want, h)
        from ..ops import gp_kernels

        mat = torch.empty((N, R, out_vec_len(cfg)), dtype=torch.int32,
                          device=dev)
        if self.route == "cluster":
            st, mat = gp_kernels.step_cluster(states, h, req, want, cfg,
                                              out_mat=mat, launch_log=launch_log)
            return st, self._outs(mat)
        blobs = gp_kernels.make_blob_rows(states, R, launch_log)
        blobs_next = torch.empty_like(blobs) if N > 1 else None
        st = states
        for i in range(N):
            st, _, _ = gp_kernels.step_stacked(
                st, blobs, h, req[i], want if i == 0 else no_want, cfg,
                out_mat=mat[i],
                out_blobs=blobs_next if i < N - 1 else None,
                launch_log=launch_log,
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
        if N == 1:
            st, _, blob, _ = gp_kernels.step(
                state, gvec, heard, req_ring[0], want, my_id, cfg,
                with_blob=True, heat=heat_acc, heat_out=heat_out,
                out_vec=out_rings[0], launch_log=launch_log,
            )
        else:
            # the N substeps in one launch: MY row refreshed from the
            # advancing state, peers' rows frozen, want at substep 0
            st, _, blob, _ = gp_kernels.step_n(
                state, gvec, heard, req_ring, want, my_id, cfg,
                heat=heat_acc, heat_out=heat_out, out_rings=out_rings,
                launch_log=launch_log,
            )
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


# ---------------------------------------------------------------------------
# the mesh faces
# ---------------------------------------------------------------------------


def _mesh_spec(mesh: Mesh, *lead) -> tuple:
    """Spec over the leading dims, keeping only names the mesh has — a
    ``(g, r)`` mesh yields ``('r', 'g')`` where a ``('g',)`` mesh yields
    ``(None, 'g')`` from the same request."""
    return tuple(a if (a is not None and a in mesh.axis_names) else None
                 for a in lead)


@functools.lru_cache(maxsize=None)
def _state_fill() -> dict:
    """Each leaf's value in an inert row (``init_state``'s fills)."""
    from ..ops.engine import init_state

    st = init_state(EngineConfig(1, 2, 1, 1), "cpu")
    return {f: int(x.reshape(-1)[0]) for f, x in zip(EngineState._fields, st)}


def _global(x, dtype=None) -> torch.Tensor:
    """A sharded tensor's global value, a tensor as it is, numpy or
    python data as a CPU tensor."""
    if isinstance(x, ShardedTensor):
        x = x.gather()
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x if dtype is None else x.to(dtype)


def _shard(x: torch.Tensor, mesh: Mesh, spec: tuple, fill) -> ShardedTensor:
    """Split a global tensor over ``mesh`` by ``spec``: each shard a fresh
    copy on its logical device, G padded with ``fill`` to a multiple of
    the 'g' axis."""
    gdim = spec.index(GROUP_AXIS)
    rdim = spec.index(REPLICA_AXIS) if REPLICA_AXIS in spec else None
    G = int(x.shape[gdim])
    Gs = -(-G // mesh.shape[GROUP_AXIS])
    if rdim is not None and x.shape[rdim] != mesh.shape[REPLICA_AXIS]:
        raise ValueError(f"{x.shape[rdim]} replica rows over an 'r' axis "
                         f"of {mesh.shape[REPLICA_AXIS]}")
    shards = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(*mesh.devices.shape):
        pos = dict(zip(mesh.axis_names, idx))
        part = x if rdim is None else x.narrow(rdim, pos[REPLICA_AXIS], 1)
        g0 = pos[GROUP_AXIS] * Gs
        n = max(0, min(G, g0 + Gs) - g0)
        shape = list(part.shape)
        shape[gdim] = Gs
        out = torch.empty(shape, dtype=x.dtype, device=mesh.devices[idx])
        if n:
            out.narrow(gdim, 0, n).copy_(part.narrow(gdim, g0, n))
        if n < Gs:
            out.narrow(gdim, n, Gs - n).fill_(fill)
        shards[idx] = out
    return ShardedTensor(mesh, spec, shards, G)


def _place(x, mesh: Mesh, spec: tuple, dtype, fill) -> ShardedTensor:
    """``x`` as shards of ``mesh`` by ``spec``: a sharded tensor already
    laid out so is used as it is; anything else is split (a sharded one
    after a gather)."""
    if (isinstance(x, ShardedTensor) and x.mesh == mesh and x.spec == spec
            and x.dtype == dtype):
        return x
    return _shard(_global(x, dtype), mesh, spec, fill)


def _place_state(states: EngineState, mesh: Mesh, spec: tuple) -> EngineState:
    fill = _state_fill()
    return EngineState(*(
        _place(x, mesh, spec, torch.int32, fill[f])
        for f, x in zip(EngineState._fields, states)
    ))


def _grid(mesh: Mesh, fields) -> list:
    """One empty object array shaped like the mesh per field."""
    return [np.empty(mesh.devices.shape, dtype=object) for _ in fields]


def _on(dev: torch.device):
    """The device's context: its current stream is the one a kernel
    wrapper launches on."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class _MeshStep:
    """The stacked face over a ``('g',)`` or ``(g, r)`` mesh (module
    docstring).  ``launches`` holds each logical device's own kernel-launch
    counts (keyed by its mesh index), counted where each kernel launches."""

    def __init__(self, cfg: EngineConfig, mesh: Mesh, n_steps: int):
        self.cfg, self.mesh, self.n_steps = cfg, mesh, n_steps
        self.gr = REPLICA_AXIS in mesh.axis_names
        if self.gr and mesh.shape[REPLICA_AXIS] != cfg.n_replicas:
            raise ValueError(
                f"a (g, r) mesh holds one replica per device: 'r' is "
                f"{mesh.shape[REPLICA_AXIS]}, n_replicas {cfg.n_replicas}")
        self.spec = _mesh_spec(mesh, REPLICA_AXIS, GROUP_AXIS)
        self.index = list(np.ndindex(*mesh.devices.shape))
        self.launches = {idx: {} for idx in self.index}
        self._shard_steps = {}

    def reset_launches(self) -> None:
        for log in self.launches.values():
            log.clear()

    def _place_inputs(self, states, req_vid, want_coord):
        lead = (None,) if self.n_steps > 1 else ()
        st = _place_state(states, self.mesh, self.spec)
        req = _place(req_vid, self.mesh, lead + self.spec, torch.int32, NULL)
        want = _place(want_coord, self.mesh, self.spec, torch.bool, False)
        for what, x in (("req_vid", req), ("want_coord", want)):
            if (x.n_groups, x.shard_groups) != (st.bal.n_groups,
                                                st.bal.shard_groups):
                raise ValueError(
                    f"{what}: {x.n_groups} groups in shards of "
                    f"{x.shard_groups}, states {st.bal.n_groups} in "
                    f"{st.bal.shard_groups}")
        return st, req, want

    def __call__(self, states, req_vid, want_coord, heard=None):
        return self._run(states, req_vid, want_coord, heard, kernels=True)

    def plain(self, states, req_vid, want_coord, heard=None):
        """The same orchestration with every device's step and blob by
        the plain PyTorch version (the kernel path's yardstick)."""
        return self._run(states, req_vid, want_coord, heard, kernels=False)

    def _run(self, states, req_vid, want_coord, heard, kernels: bool):
        st, req, want = self._place_inputs(states, req_vid, want_coord)
        h = _heard_matrix(heard, self.cfg.n_replicas, "cpu")
        run = self._run_gr if self.gr else self._run_g
        new, outs, G = run(st, req, want, h, kernels)
        lead = (None,) if self.n_steps > 1 else ()
        wrap = lambda shards, spec: ShardedTensor(self.mesh, spec, shards, G)
        return (
            EngineState(*(wrap(x, self.spec) for x in new)),
            StepOutputs(*(wrap(x, lead + self.spec) for x in outs)),
        )

    def _run_g(self, st, req, want, h, kernels):
        """('g',): the stacked face on every shard, on its own device."""
        cfg, G, Gs = self.cfg, st.bal.n_groups, st.bal.shard_groups
        new = _grid(self.mesh, EngineState._fields)
        outs = _grid(self.mesh, StepOutputs._fields)
        for idx in self.index:
            dev = self.mesh.devices[idx]
            key = (Gs, str(dev))
            if key not in self._shard_steps:
                self._shard_steps[key] = _StackedStep(
                    cfg._replace(n_groups=Gs), self.n_steps, dev)
            fn = self._shard_steps[key]
            shard = EngineState(*(x.shards[idx] for x in st))
            with _on(dev):
                if kernels:
                    ns, o = fn(shard, req.shards[idx], want.shards[idx], h,
                               launch_log=self.launches[idx])
                else:
                    ns, o = fn.plain(shard, req.shards[idx], want.shards[idx], h)
            for grid, x in zip(new, ns):
                grid[idx] = x
            for grid, x in zip(outs, o):
                grid[idx] = x
        return new, outs, G

    def exchange(self, bufs: dict) -> None:
        """The blob exchange over 'r': row ri of device (gi, ri)'s ``[R,
        NB]`` buffer (its own blob) copied into row ri of every other
        device of g-row gi.  Each logical device owns its buffers, so
        every copy is a real one, between cards a peer copy."""
        for gi, ri in self.index:
            src = bufs[gi, ri][ri]
            for rj in range(self.cfg.n_replicas):
                if rj != ri:
                    bufs[gi, rj][ri].copy_(src)

    def blob_into(self, state: EngineState, out: torch.Tensor, idx,
                  kernels: bool = True) -> None:
        """Device ``idx``'s compact blob of ``state`` into ``out`` [NB]."""
        if kernels and _engine.on_card(state.bal):
            from ..ops import gp_kernels

            gp_kernels.make_blob_rows(state, None, self.launches[idx], out=out)
        else:
            out.copy_(pack_blob(make_blob_plain(state)))

    def _replica_step(self, idx, state, gathered, heard_row, req, want, cfg,
                      out_vec, out_blob, kernels):
        my_id = idx[1]
        if kernels and _engine.on_card(state.bal):
            from ..ops import gp_kernels

            st, _, _, _ = gp_kernels.step(
                state, gathered, heard_row, req, want, my_id, cfg,
                with_blob=out_blob is not None, out_vec=out_vec,
                out_blob=out_blob, launch_log=self.launches[idx])
            return st
        st, out = step_plain(state, unpack_gathered(gathered, cfg), heard_row,
                             req, want, my_id, cfg)
        out_vec.copy_(pack_out(out))
        if out_blob is not None:
            out_blob.copy_(pack_blob(make_blob_plain(st)))
        return st

    def _run_gr(self, st, req, want, h, kernels):
        """(g, r): one replica per device, the blob exchange each substep.
        The replicas of a g-row sit on different devices and exchange
        between substeps, so this face keeps N ``gp_step`` launches a
        device (one launch holding the N substeps needs the R replicas in
        one cluster of one card)."""
        cfg, N, R = self.cfg, self.n_steps, self.cfg.n_replicas
        G, Gs = st.bal.n_groups, st.bal.shard_groups
        cfg_s = cfg._replace(n_groups=Gs)
        NB, M = blob_vec_len(cfg_s), out_vec_len(cfg_s)
        dev = {idx: self.mesh.devices[idx] for idx in self.index}
        state = {idx: EngineState(*(x.shards[idx][0] for x in st))
                 for idx in self.index}
        heard_row = {idx: h[idx[1]].to(dev[idx]) for idx in self.index}
        no_want = {idx: torch.zeros((Gs,), dtype=torch.bool, device=dev[idx])
                   for idx in self.index}
        rings = {idx: torch.empty((N, M), dtype=torch.int32, device=dev[idx])
                 for idx in self.index}
        buf = lambda idx: torch.empty((R, NB), dtype=torch.int32, device=dev[idx])
        cur = {idx: buf(idx) for idx in self.index}
        nxt = {idx: buf(idx) for idx in self.index} if N > 1 else None
        for idx in self.index:
            with _on(dev[idx]):
                self.blob_into(state[idx], cur[idx][idx[1]], idx, kernels)
        self.exchange(cur)
        for i in range(N):
            last = i == N - 1
            for idx in self.index:
                r_i = req.shards[idx][i, 0] if N > 1 else req.shards[idx][0]
                with _on(dev[idx]):
                    state[idx] = self._replica_step(
                        idx, state[idx], cur[idx], heard_row[idx], r_i,
                        want.shards[idx][0] if i == 0 else no_want[idx], cfg_s,
                        rings[idx][i], None if last else nxt[idx][idx[1]],
                        kernels)
            if not last:
                self.exchange(nxt)
                cur, nxt = nxt, cur
        new = _grid(self.mesh, EngineState._fields)
        outs = _grid(self.mesh, StepOutputs._fields)
        for idx in self.index:
            for grid, x in zip(new, state[idx]):
                grid[idx] = x.unsqueeze(0)
            o = unpack_out(rings[idx] if N > 1 else rings[idx][0], cfg_s)
            for grid, x in zip(outs, o):
                grid[idx] = x.unsqueeze(1 if N > 1 else 0)
        return new, outs, G


@functools.lru_cache(maxsize=None)
def _blob_fill() -> dict:
    """Each blob leaf's value for an inert row (what a pad row publishes)."""
    from ..ops.engine import init_state

    blob = make_blob_plain(init_state(EngineConfig(1, 2, 1, 1), "cpu"))
    return {f: int(x.reshape(-1)[0]) for f, x in zip(blob._fields, blob)}


def _leaf_spans(fields, cfg: EngineConfig, Gs: int):
    """Per leaf of a leaf-major packed vector: (name, width per group,
    offset in the global vector, offset in a shard's vector of ``Gs``
    groups)."""
    G, W = cfg.n_groups, cfg.window
    off = off_s = 0
    spans = []
    for name in fields:
        w = 1 if name in _engine._G_LEAVES else W
        spans.append((name, w, off, off_s))
        off += G * w
        off_s += Gs * w
    return spans


class _PackedMeshStep:
    """The packed face over a ``('g',)`` or ``(g, r)`` mesh (module
    docstring).  ``launches`` holds each logical device's own kernel-launch
    counts (keyed by its mesh index), counted where each kernel launches."""

    def __init__(self, cfg: EngineConfig, mesh: Mesh, n_steps: int,
                 donate: bool, heat: bool):
        self.cfg, self.mesh, self.n_steps = cfg, mesh, n_steps
        self.donate, self.heat = donate, heat
        self.spec = _mesh_spec(mesh, GROUP_AXIS)
        self.index = list(np.ndindex(*mesh.devices.shape))
        self.launches = {idx: {} for idx in self.index}
        self._shard_steps = {}

    def reset_launches(self) -> None:
        for log in self.launches.values():
            log.clear()

    def __call__(self, state, gvec, heard, req_ring, want_coord, my_id,
                 heat_acc=None):
        return self._run(state, gvec, heard, req_ring, want_coord, my_id,
                         heat_acc, kernels=True)

    def plain(self, state, gvec, heard, req_ring, want_coord, my_id,
              heat_acc=None):
        """The same slicing and reassembly around every shard's plain
        packed face (the kernel path's yardstick)."""
        return self._run(state, gvec, heard, req_ring, want_coord, my_id,
                         heat_acc, kernels=False)

    def slice_gathered(self, gvec: torch.Tensor, g0: int, n: int, Gs: int,
                       out: torch.Tensor) -> None:
        """Rows ``g0 .. g0 + n`` of every leaf of the global ``[R, NB]``
        gathered matrix into ``out`` ``[R, NB_s]`` (a shard of ``Gs``
        groups), its pad rows the inert blob."""
        fill = _blob_fill()
        for name, w, off, off_s in _leaf_spans(Blob._fields, self.cfg, Gs):
            if n:
                out[:, off_s:off_s + n * w].copy_(
                    gvec[:, off + g0 * w:off + (g0 + n) * w])
            if n < Gs:
                out[:, off_s + n * w:off_s + Gs * w].fill_(fill[name])

    def assemble(self, fields, parts: dict, out: torch.Tensor, Gs: int) -> None:
        """Each g-shard's ``[..., V_s]`` packed vector (``parts[gi]``, its
        real rows only) into the global leaf-major ``out`` ``[..., V]``."""
        G = self.cfg.n_groups
        for _name, w, off, off_s in _leaf_spans(fields, self.cfg, Gs):
            for gi, part in parts.items():
                g0 = gi * Gs
                n = max(0, min(G, g0 + Gs) - g0)
                if n:
                    out[..., off + g0 * w:off + (g0 + n) * w].copy_(
                        part[..., off_s:off_s + n * w])

    def _run(self, state, gvec, heard, req_ring, want_coord, my_id, heat_acc,
             kernels: bool):
        cfg, mesh, spec, N = self.cfg, self.mesh, self.spec, self.n_steps
        if self.heat and heat_acc is None:
            raise TypeError("heat=True step needs the heat accumulator")
        st = _place_state(state, mesh, spec)
        G, Gs = st.bal.n_groups, st.bal.shard_groups
        if G != cfg.n_groups:
            raise ValueError(f"state of {G} groups, step of {cfg.n_groups}")
        req = _place(req_ring, mesh, (None,) + spec, torch.int32, NULL)
        want = _place(want_coord, mesh, spec, torch.bool, False)
        ht = _place(heat_acc, mesh, spec, torch.int32, 0) if self.heat else None
        dev0 = mesh.devices.flat[0]
        g_all = _as(gvec, torch.int32, gvec.device if isinstance(
            gvec, torch.Tensor) else dev0)
        h_all = _global(heard, torch.bool)
        cfg_s = cfg._replace(n_groups=Gs)
        NB_s = blob_vec_len(cfg_s)
        new = _grid(mesh, EngineState._fields)
        heat_out = np.empty(mesh.devices.shape, dtype=object)
        rings, blobs = {}, {}
        for idx in self.index:
            dev = mesh.devices[idx]
            key = (Gs, str(dev))
            if key not in self._shard_steps:
                self._shard_steps[key] = _PackedStep(
                    cfg_s, N, self.donate, self.heat, dev)
            fn = self._shard_steps[key]
            g0 = idx[0] * Gs
            n = max(0, min(G, g0 + Gs) - g0)
            with _on(dev):
                g_s = torch.empty((cfg.n_replicas, NB_s), dtype=torch.int32,
                                  device=dev)
                self.slice_gathered(g_all, g0, n, Gs, g_s)
                args = (EngineState(*(x.shards[idx] for x in st)), g_s,
                        h_all.to(dev), req.shards[idx], want.shards[idx],
                        my_id) + ((ht.shards[idx],) if self.heat else ())
                res = (fn(*args, launch_log=self.launches[idx]) if kernels
                       else fn.plain(*args))
            for grid, x in zip(new, res[0]):
                grid[idx] = x
            if self.heat:
                heat_out[idx] = res[3]
            if len(idx) == 1 or idx[1] == 0:
                # every device of a g-row holds the same result
                rings[idx[0]], blobs[idx[0]] = res[1], res[2]
        out_rings = torch.empty((N, out_vec_len(cfg)), dtype=torch.int32,
                                device=dev0)
        blob_vec = torch.empty((blob_vec_len(cfg),), dtype=torch.int32,
                               device=dev0)
        with _on(dev0):
            self.assemble(StepOutputs._fields, rings, out_rings, Gs)
            self.assemble(Blob._fields, blobs, blob_vec, Gs)
        wrap = lambda shards: ShardedTensor(mesh, spec, shards, G)
        res = (EngineState(*(wrap(x) for x in new)), out_rings, blob_vec)
        return res + (wrap(heat_out),) if self.heat else res


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


def _label(io, n, donate, heat, where, cfg) -> str:
    return (f"make_step[{io} N={n} donate={donate} heat={heat} {where} "
            f"G={cfg.n_groups} R={cfg.n_replicas} W={cfg.window} "
            f"K={cfg.req_lanes}]")


def _check_flavor(steps_per_dispatch: int, io: str, heat: bool) -> None:
    if steps_per_dispatch < 1:
        raise ValueError("steps_per_dispatch must be >= 1")
    if io not in ("stacked", "packed_host"):
        raise ValueError(f"unknown io flavor: {io!r}")
    if io == "stacked" and heat:
        raise ValueError(
            "heat accumulation is a packed_host feature (the "
            "stacked face reads StepOutputs directly)"
        )


@functools.lru_cache(maxsize=None)
def _make_step_cached(cfg, steps_per_dispatch, donate, io, heat, device):
    from ..obs.device import StepSentinel

    _check_flavor(steps_per_dispatch, io, heat)
    if io == "stacked":
        fn = _StackedStep(cfg, steps_per_dispatch, device)
    else:
        fn = _PackedStep(cfg, steps_per_dispatch, donate, heat, device)
    return StepSentinel(fn, label=_label(io, steps_per_dispatch, donate, heat,
                                         f"device={device}", cfg))


@functools.lru_cache(maxsize=None)
def _make_mesh_step_cached(cfg, mesh, steps_per_dispatch, donate, io, heat):
    from ..obs.device import StepSentinel

    _check_flavor(steps_per_dispatch, io, heat)
    if io == "stacked":
        fn = _MeshStep(cfg, mesh, steps_per_dispatch)
    else:
        fn = _PackedMeshStep(cfg, mesh, steps_per_dispatch, donate, heat)
    return StepSentinel(fn, label=_label(io, steps_per_dispatch, donate, heat,
                                         f"mesh={mesh.tag}", cfg))


def make_step(cfg: EngineConfig, mesh: Optional[Mesh] = None,
              steps_per_dispatch: int = 1, *, donate: bool = True,
              io: str = "stacked", heat: bool = False, device=None):
    """Build THE consensus step.

    Parameters
    ----------
    cfg : EngineConfig
    mesh : ``None`` for one device; a ``('g',)`` or ``(g, r)``
        :class:`~.mesh.Mesh` for the mesh faces of either face (module
        docstring; results are bit-identical across meshes).
    steps_per_dispatch : N >= 1 consensus rounds per host call
        (``ENGINE_STEPS_PER_DISPATCH``).
    donate : the caller gives up its heat accumulator, which the packed
        face then updates in place.  The state is always written to new
        tensors; ``False`` keeps every input valid.
    io : ``"stacked"`` ([R, ...] bench face) or ``"packed_host"`` (one
        replica + packed [R, NB] gathered vectors — the deployed
        runtime's face; on a mesh the state is split over 'g' and
        ``out_rings``/``blob_vec`` come back global).
    heat : (``packed_host`` only) carry a ``[G]`` int32 activity
        accumulator: the step takes it as a trailing argument and returns
        ``heat + n_committed + n_admitted`` over every substep.
    device : without a mesh, ``None`` = the CUDA card (raises when there
        is none) and ``"cpu"`` runs the plain PyTorch engine.  A mesh
        names its own devices, so ``device`` must be ``None`` with one.

    Instances are memoized per (cfg, N, donate, io, heat, device or mesh),
    and each is wrapped in a
    :class:`gigapaxos_tpu_torch.obs.device.StepSentinel`.
    """
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)}")
        if device is not None:
            raise ValueError("a mesh names its devices; pass device=None")
        return _make_mesh_step_cached(
            cfg, mesh, int(steps_per_dispatch), bool(donate), str(io),
            bool(heat),
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _make_step_cached(
        cfg, int(steps_per_dispatch), bool(donate), str(io), bool(heat), dev,
    )


# ---------------------------------------------------------------------------
# deprecated thin aliases over the factory (pre-factory entry points)
# ---------------------------------------------------------------------------


def single_chip_step(cfg: EngineConfig, donate: bool = True, device=None):
    """Deprecated alias: ``make_step(cfg, None, 1, donate=donate)``: all R
    replica states stacked on one device."""
    return make_step(cfg, None, 1, donate=donate, device=device)


def spmd_step(cfg: EngineConfig, mesh: Mesh):
    """Deprecated alias: ``make_step(cfg, mesh, 1)`` over the (g, r) mesh.

    Keeps the historical divisibility contract: the (g, r) deployment
    pins G/gs groups per device, so a non-divisible G is a config error
    here (the factory itself pads any G)."""
    if cfg.n_groups % mesh.shape[GROUP_AXIS]:
        raise ValueError("n_groups must divide evenly over the group axis")
    return make_step(cfg, mesh, 1)


def group_sharded_step(cfg: EngineConfig, mesh: Mesh, donate: bool = True):
    """Deprecated alias: ``make_step(cfg, mesh, 1, donate=donate)`` over
    the 1-D ('g',) mesh.  Pad G to a mesh multiple first
    (``pad_group_states`` / ``shard_group_inputs``) to keep per-device
    slices even."""
    return make_step(cfg, mesh, 1, donate=donate)


# ---------------------------------------------------------------------------
# input placement helpers (the reference's layouts)
# ---------------------------------------------------------------------------


def replicate_inputs(mesh: Mesh, states: EngineState, req_vid, want_coord):
    """Global inputs split with the canonical (g, r) layout: states and
    want ``('r', 'g')``, requests ``('r', 'g', None)``."""
    spec = _mesh_spec(mesh, REPLICA_AXIS, GROUP_AXIS)
    return (_place_state(states, mesh, spec),
            _place(req_vid, mesh, spec, torch.int32, NULL),
            _place(want_coord, mesh, spec, torch.bool, False))


def padded_group_count(n_groups: int, n_shards: int) -> int:
    """Smallest shard-divisible G' >= n_groups (ceil to a multiple)."""
    return -(-n_groups // n_shards) * n_shards


def pad_group_states(cfg: EngineConfig, states: EngineState,
                     n_shards: int) -> EngineState:
    """Pad stacked [R, G, ...] states to a shard-divisible G with INERT
    rows (member_mask 0): the step freezes non-member rows, so padding
    changes no real group's transition and the padded tail stays at its
    init values bit-for-bit."""
    from ..ops.engine import init_state

    states = EngineState(*(_global(x) for x in states))
    Gp = padded_group_count(cfg.n_groups, n_shards)
    if Gp == cfg.n_groups:
        return states
    pad_cfg = cfg._replace(n_groups=Gp - cfg.n_groups)
    pad = stack_states([init_state(pad_cfg, states.bal.device)
                        for _ in range(cfg.n_replicas)])
    return EngineState(*(torch.cat([a, b], dim=1) for a, b in zip(states, pad)))


def pad_group_inputs(cfg: EngineConfig, n_shards: int, req_vid, want_coord):
    """Pad [R, G, K] requests (NULL) and [R, G] election pulses (False)
    to the shard-divisible G."""
    req, want = _global(req_vid, torch.int32), _global(want_coord, torch.bool)
    Gp = padded_group_count(cfg.n_groups, n_shards)
    G = cfg.n_groups
    if Gp == G:
        return req, want
    R, K = cfg.n_replicas, cfg.req_lanes
    req = torch.cat([req, torch.full((R, Gp - G, K), NULL, dtype=torch.int32,
                                     device=req.device)], dim=1)
    want = torch.cat([want, torch.zeros((R, Gp - G), dtype=torch.bool,
                                        device=want.device)], dim=1)
    return req, want


def strip_group_pad(tree, n_groups: int):
    """Slice the padded G axis (axis 1) back to the real group count —
    global tensors for readback; keep the persistent state padded."""
    return type(tree)(*(_global(x)[:, :n_groups] for x in tree))


def shard_group_inputs(mesh: Mesh, cfg: EngineConfig, states: EngineState,
                       req_vid, want_coord):
    """Pad to the mesh's shard count and split with the group-sharded
    layout: states and want ``(None, 'g')``, requests ``(None, 'g',
    None)``.  Returns (states, req_vid, want_coord) ready for the
    group-sharded step."""
    n_shards = mesh.shape[GROUP_AXIS]
    states = pad_group_states(cfg, states, n_shards)
    req_vid, want_coord = pad_group_inputs(cfg, n_shards, req_vid, want_coord)
    spec = (None, GROUP_AXIS)
    return (_place_state(states, mesh, spec),
            _place(req_vid, mesh, spec, torch.int32, NULL),
            _place(want_coord, mesh, spec, torch.bool, False))
