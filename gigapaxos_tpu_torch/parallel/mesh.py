"""Device description for the consensus engine's state.

The JAX package's mesh module builds replica/group meshes for multi-chip
runs.  This port runs on one device so far (multi-GPU faces are ROADMAP
item A10); what the slice reaches is :func:`describe_state_mesh`, which
the manager's ``mesh_info`` (the ``stats`` admin op) calls.
"""

from __future__ import annotations

from typing import Dict

def describe_state_mesh(leaf) -> Dict:
    """Runtime descriptor of the device backing one state tensor —
    ``{n_devices, shape, platform}`` for the ``stats`` admin op.  A
    tensor lives on exactly one device: ``platform`` is ``"gpu"`` for a
    CUDA tensor and ``"cpu"`` for a CPU one; a host numpy array (or
    anything without a device) reports ``{n_devices: 0, platform:
    "host"}``."""
    dev = getattr(leaf, "device", None)
    dev_type = getattr(dev, "type", None)
    if dev_type is None:
        return {"n_devices": 0, "shape": {}, "platform": "host"}
    return {
        "n_devices": 1,
        "shape": {},
        "platform": "gpu" if dev_type == "cuda" else str(dev_type),
    }
