"""The system under test, as the benchmark's loads see it.

:class:`Port` is the only adapter that imports the program
(``gigapaxos_tpu_torch``): its two step faces at N steps a call, the
set-up calls that build their states, and the host side of the deployed
tick (the manager's upload of host arrays, ``to_host``,
``split_out_vec``).  The loads use nothing else of the program, so the
benchmark's control (:mod:`gpbench.control`) and the fault tests put
another object with the same methods in its place.
"""

from __future__ import annotations

import numpy as np


class Port:
    """``gigapaxos_tpu_torch`` on ``device`` (a CUDA card, or the CPU with
    its plain PyTorch engine in the benchmark's own tests)."""

    def __init__(self, device):
        import torch

        from gigapaxos_tpu_torch import manager
        from gigapaxos_tpu_torch.ops import engine
        from gigapaxos_tpu_torch.parallel import spmd

        self.device = torch.device(device)
        self._engine, self._spmd, self._manager = engine, spmd, manager

    def config(self, G: int, W: int, K: int, R: int):
        return self._engine.EngineConfig(G, W, K, R)

    def stacked_face(self, cfg, N: int):
        """The bench face: all R replicas of every group, N steps a call."""
        return self._spmd.make_step(cfg, None, N, donate=True, io="stacked",
                                    device=self.device)

    def stacked_states(self, cfg):
        """``[R, G, ...]`` states, every group created with all R replicas
        members and replica ``g % R`` its first coordinator."""
        return self._spmd.build_replica_states(cfg, device=self.device)

    def packed_face(self, cfg, N: int):
        """The deployed runtime's face, N steps a call, as a manager's
        tick calls it: one replica's state, the gathered blob frames (a
        list of host rows, one a replica) and the host request ring
        uploaded as the manager uploads them, the heat accumulator
        threaded through."""
        import torch

        face = self._spmd.make_step(cfg, None, N, donate=True, io="packed_host",
                                    heat=True, device=self.device)
        up, dev = self._manager._dev, self.device

        def call(state, frames, heard, ring, want, my_id, heat):
            return face(state, up(frames, torch.int32, dev), up(heard, torch.bool, dev),
                        up(ring, torch.int32, dev), up(want, torch.bool, dev),
                        np.int32(my_id), heat)

        return call

    def replica_state(self, cfg, my_id: int):
        from gigapaxos_tpu_torch.ops.lifecycle import create_groups

        G, R = cfg.n_groups, cfg.n_replicas
        idx = np.arange(G)
        return create_groups(self._engine.init_state(cfg, self.device), idx,
                             np.full(G, (1 << R) - 1),
                             (idx % R).astype(np.int32), my_id=my_id)

    def blob_vec(self, state):
        return self._engine.make_blob_vec(state)

    def to_host(self, t) -> np.ndarray:
        return self._engine.to_host(t)

    def split_out(self, vec, cfg):
        return self._engine.split_out_vec(vec, cfg)
