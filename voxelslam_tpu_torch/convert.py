"""Carry a pipeline state across from the JAX package.

The system has no weights; its state is the pipeline carry. The JAX
package's carry, turned into plain nested dicts of numpy arrays keyed by
its dataclass field names (for example `dataclasses.asdict` over
`jax.tree.map(np.asarray, ...)`), becomes the port's tensors here:

    d = {"x": NavState fields, "levels": [VoxelLevel fields, with the
         Cluster fields nested under win / fix / tot], "win": NavState
         fields (W,), "mp": (W,) int, "preints_dev": Preint fields (W-1,)}

`SlamPipeline.load_carry` installs the result. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.cluster import Cluster
from .core.state import NavState
from .imu.preintegration import Preint
from .map.voxel_map import VoxelLevel

_INT_FIELDS = {"keys", "state", "tsl", "mp"}


def _tensor(name, a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=device)
    dtype = torch.int32 if name in _INT_FIELDS else torch.float32
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


def from_numpy(cls, d: dict, device="cpu"):
    """One dataclass (NavState, VoxelLevel, Preint, Cluster) from a dict
    of numpy arrays keyed by its field names (Clusters nested)."""
    device = torch.device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict):
            kw[f.name] = from_numpy(Cluster, v, device)
        else:
            kw[f.name] = _tensor(f.name, v, device)
    return cls(**kw)


def carry_from_numpy(d: dict, device="cpu") -> dict:
    """Nested numpy dicts (JAX field names) -> dict of the port's
    NavState / VoxelLevel / Preint tensors on `device`."""
    device = torch.device(device)
    return {
        "x": from_numpy(NavState, d["x"], device),
        "levels": tuple(from_numpy(VoxelLevel, lv, device) for lv in d["levels"]),
        "win": from_numpy(NavState, d["win"], device),
        "mp": _tensor("mp", d["mp"], device),
        "preints_dev": from_numpy(Preint, d["preints_dev"], device),
    }
