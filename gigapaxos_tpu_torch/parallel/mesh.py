"""Device meshes for the consensus engine, and the sharded tensor.

The replica axis ('r') stands for the reference's NIO multicast between
group members: under a ``(g, r)`` mesh each device holds ONE replica's
rows of a group shard, and the blob exchange copies each device's compact
blob to every device of its g-row.  The group axis ('g') shards the
million-group state: groups are independent, so 'g' needs no exchange.

Two deployment shapes use these axes:

* ``make_mesh(n_replicas, n_group_shards)``: the 2-D acceptor-per-device
  mesh (``spmd.make_step`` folds the exchanged ``[R, NB]`` blobs with one
  ``gp_step`` per device);
* ``make_group_mesh(n_devices)``: the 1-D group-sharded mesh; every
  device holds all R replica rows of its G/n slice and runs the stacked
  step on it, with no exchange between devices (the weak-scaling shape).

One process drives every device of a mesh.  A mesh's entries are logical
devices: a list in which a device repeats (``[cuda:0] * 6``, ``[cpu] *
8``) gives each entry its own tensors, which is how one card (or the CPU)
runs a mesh.  ``devices=None`` means every visible CUDA card, and raises
when there is none.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

REPLICA_AXIS = "r"
GROUP_AXIS = "g"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass devices=[...] (for example "
            "[torch.device('cpu')] * 8) to build a mesh of logical devices"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An ndarray of logical ``torch.device`` entries with named axes;
    ``shape`` is an ordered dict of axis name -> size, as JAX's."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def physical_devices(self) -> int:
        """How many distinct devices the logical ones are."""
        return len({str(d) for d in self.devices.flat})

    @property
    def tag(self) -> str:
        return "x".join(f"{k}{v}" for k, v in self.shape.items())

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


def pick_mesh_shape(n_devices: int, n_replicas: Optional[int] = None) -> Tuple[int, int]:
    """Choose (group_shards, replicas): replica axis 3 when it divides the
    device count, else 2, else 1."""
    if n_replicas is None:
        for r in (3, 2, 1):
            if n_devices % r == 0:
                n_replicas = r
                break
    if n_devices % n_replicas:
        raise ValueError(f"{n_replicas} replicas don't divide {n_devices} devices")
    return n_devices // n_replicas, n_replicas


def _grid(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.empty(int(np.prod(shape)), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(n_replicas: int, n_group_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The ``(g, r)`` mesh over the first ``n_group_shards * n_replicas``
    of ``devices`` (default: every CUDA card)."""
    devices = _cards() if devices is None else [_device(d) for d in devices]
    need = n_replicas * n_group_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(_grid(devices[:need], (n_group_shards, n_replicas)),
                (GROUP_AXIS, REPLICA_AXIS))


def make_group_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the group axis only: every device hosts all R replica
    rows for its slice of the G axis."""
    devices = _cards() if devices is None else [_device(d) for d in devices]
    n_devices = len(devices) if n_devices is None else n_devices
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    return Mesh(_grid(devices[:n_devices], (n_devices,)), (GROUP_AXIS,))


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else str(dev.type)


class ShardedTensor:
    """A global tensor held as one shard per logical device of a mesh.

    ``spec`` names, per leading dim, the mesh axis that splits it (None:
    not split).  ``shards`` is an ndarray shaped like ``mesh.devices``;
    each shard keeps every dim, a split dim at its per-device size (the
    replica dim of a ``(g, r)`` shard is 1 wide).  The group dim may
    carry inert pad rows past ``n_groups`` (a G that does not divide
    over 'g'); :meth:`gather` drops them.  ``np.asarray`` reads the
    global tensor."""

    def __init__(self, mesh: Mesh, spec: Tuple, shards: np.ndarray,
                 n_groups: int):
        self.mesh, self.spec, self.shards = mesh, tuple(spec), shards
        self.n_groups = int(n_groups)
        self.gdim = self.spec.index(GROUP_AXIS)
        first = shards.flat[0]
        shape = list(first.shape)
        shape[self.gdim] = self.n_groups
        for ax, n in mesh.shape.items():
            if ax != GROUP_AXIS and ax in self.spec:
                shape[self.spec.index(ax)] *= n
        self.shape = torch.Size(shape)
        self.dtype = first.dtype

    @property
    def shard_groups(self) -> int:
        """Groups per shard, pad rows included."""
        return int(self.shards.flat[0].shape[self.gdim])

    @property
    def device(self) -> torch.device:
        return self.shards.flat[0].device

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first shard's)."""
        dev = self.device if device is None else torch.device(device)
        dim_of = {ax: i for i, ax in enumerate(self.spec) if ax is not None}

        def assemble(arr, axes):
            if not axes:   # one shard (indexing the object array yields it)
                return arr.to(dev)
            parts = [assemble(arr[i], axes[1:]) for i in range(arr.shape[0])]
            d = dim_of.get(axes[0])
            return parts[0] if d is None else torch.cat(parts, dim=d)

        full = assemble(self.shards, list(self.mesh.axis_names))
        return full.narrow(self.gdim, 0, self.n_groups)

    def __array__(self, dtype=None, copy=None):
        a = self.gather("cpu").numpy()
        return a if dtype is None else a.astype(dtype)


def describe_state_mesh(leaf) -> Dict:
    """Runtime descriptor of the devices backing one state leaf —
    ``{n_devices, shape, platform, physical_devices}`` for the ``stats``
    admin op, so an accidentally unsharded deployment (one device hosting
    a G meant to be spread over a mesh) is visible at runtime.  A sharded
    leaf reports its mesh (``n_devices`` counts its logical devices,
    ``physical_devices`` the distinct ones); a tensor lives on one device;
    a host array (or anything without a device) reports 0 devices and
    platform ``"host"``."""
    if isinstance(leaf, ShardedTensor):
        return {"n_devices": leaf.mesh.size,
                "shape": {str(k): int(v) for k, v in leaf.mesh.shape.items()},
                "platform": _platform(leaf.device),
                "physical_devices": leaf.mesh.physical_devices}
    dev = getattr(leaf, "device", None)
    if getattr(dev, "type", None) is None:
        return {"n_devices": 0, "shape": {}, "platform": "host",
                "physical_devices": 0}
    return {"n_devices": 1, "shape": {}, "platform": _platform(dev),
            "physical_devices": 1}
