"""Carry a pipeline state across from the JAX package.

The system has no weights; its state is the pipeline carry. The JAX
package's carry, turned into plain nested dicts of numpy arrays keyed by
its dataclass field names (for example `dataclasses.asdict` over
`jax.tree.map(np.asarray, ...)`), becomes the port's tensors here:

    d = {"x": NavState fields, "levels": [VoxelLevel fields, with the
         Cluster fields nested under win / fix / tot], "win": NavState
         fields (W,), "mp": (W,) int, "preints_dev": Preint fields (W-1,)}

`SlamPipeline.load_carry` installs the result.

The loop and global-BA records (`Keyframe`, `LoopEdge`) are host numpy on
both sides; `keyframes_from_numpy`, `edges_from_numpy` and
`load_hba_state` rebuild the port's from the JAX package's records as
field dicts (`dataclasses.asdict`), so a port `HbaRunner` can resume from a
JAX runner's `submaps`, `edges1`, `edges2` and `_pending`. Nothing here
imports JAX.
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


def _records(cls, recs: list[dict]) -> list:
    return [cls(**{f.name: (np.array(r[f.name])
                            if isinstance(r[f.name], np.ndarray)
                            else r[f.name])
                   for f in dataclasses.fields(cls)}) for r in recs]


def keyframes_from_numpy(recs: list[dict]) -> list:
    """Field dicts of the JAX package's Keyframes -> the port's
    `pipeline.loop.Keyframe` list (arrays copied)."""
    from .pipeline.loop import Keyframe
    return _records(Keyframe, recs)


def edges_from_numpy(recs: list[dict]) -> list:
    """Field dicts of the JAX package's LoopEdges -> the port's
    `pipeline.loop.LoopEdge` list (arrays copied)."""
    from .pipeline.loop import LoopEdge
    return _records(LoopEdge, recs)


def load_hba_state(runner, d: dict) -> None:
    """Install a JAX HbaRunner's host state into the port's `runner`:
    d = {"submaps": [Keyframe dicts], "edges1": [LoopEdge dicts],
    "edges2": [...], "_pending": [Keyframe dicts]}. Nothing may be in
    flight on either side (call `drain` on the JAX runner first)."""
    runner.submaps = keyframes_from_numpy(d["submaps"])
    runner.edges1 = edges_from_numpy(d["edges1"])
    runner.edges2 = edges_from_numpy(d["edges2"])
    runner._pending = keyframes_from_numpy(d["_pending"])
    runner._inflight_step = runner._inflight_cond = None
