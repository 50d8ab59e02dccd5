"""Mid-run checkpoint/resume of the live SLAM state (port of
`voxelslam_tpu/utils/checkpoint.py`).

The reference persists sessions only at finish (per-scan PCDs +
alidarState.txt + edge.txt, voxelslam.cpp:166-279 in the reference tree);
there is no mid-run snapshot of live state. Here the full mutable state of
the odometry pipeline, the loop pipeline and the GBA runner is captured to
one file and restored into freshly constructed objects, after which
processing continues bit-for-bit on the same device from the snapshot
point.

Mechanics: each object's __dict__ is filtered (the device, the config and
the constants derived from it are re-created by __init__) and pickled as
it stands, in-flight work included: the odometry's deferred emission and
scan queue, the refill state of `lba.mgsize > 1` and a GBA window
dispatched ahead are saved, not drained, since draining would change what
comes after. Every tensor is written as a host numpy copy, never as a CUDA
tensor, and loaded onto the restoring system's device, so a checkpoint
taken on the card loads on a host without one. Loading goes through an
unpickler that admits only builtins, numpy, torch and this package's
classes: a checkpoint of the JAX package (whose pickle names its classes)
is refused before anything of it is imported.
"""

from __future__ import annotations

import builtins
import collections
import pickle

import torch

FORMAT_VERSION = 1   # the port's own format, numbered apart from the JAX
                     # package's

# attributes re-created by __init__ that must NOT be serialized: the
# device and config, the constants derived from the config, and the
# odometry's dispatch widths
_SKIP_KEYS = {
    "device", "cfg", "btc_cfg", "noise_meas", "noise_walk", "R_ext", "t_ext",
    "collect_clouds", "kf_point_max", "_capacity", "_unique_max",
    "_ring_K", "_batch_K", "_stats_len",
}
# SlamSystem's own state
_SYSTEM_KEYS = ("session_names", "_gba_consumed", "_emitted", "_session",
                "corrections", "savepath")
# plain types only (a defaultdict's factory is pickled as builtins.list)
_SAFE_BUILTINS = {"list", "dict", "set", "frozenset", "tuple", "int",
                  "float", "bool", "str", "bytes", "bytearray", "complex",
                  "slice", "range"}
_SAFE_NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}


def _state_dict(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if k not in _SKIP_KEYS}


class _Pickler(pickle.Pickler):
    """Writes each tensor as a host numpy copy (one per tensor object, so
    a tensor held in two places is restored as one)."""

    def __init__(self, f):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self._ids: dict[int, int] = {}

    def persistent_id(self, obj):
        if not isinstance(obj, torch.Tensor):
            return None
        k = self._ids.get(id(obj))
        if k is not None:
            return ("tensor", k, None)
        k = self._ids[id(obj)] = len(self._ids)
        return ("tensor", k, obj.detach().cpu().numpy())


class _Unpickler(pickle.Unpickler):
    """Admits builtins, numpy, torch dtypes and this package's classes;
    puts every tensor on `device`."""

    def __init__(self, f, device):
        super().__init__(f)
        self._device = device
        self._tensors: dict[int, torch.Tensor] = {}

    def persistent_load(self, pid):
        tag, k, arr = pid
        if tag != "tensor":
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        if arr is None:
            return self._tensors[k]
        t = self._tensors[k] = torch.from_numpy(arr).to(self._device)
        return t

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "voxelslam_tpu":
            raise pickle.UnpicklingError(
                f"this checkpoint was written by the JAX package "
                f"(it names {module}:{name}); the PyTorch port loads only "
                f"checkpoints it wrote itself")
        if root == "voxelslam_tpu_torch":
            obj = super().find_class(module, name)
            if isinstance(obj, type):
                return obj
        elif module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        elif module == "collections" and name in ("defaultdict",
                                                  "OrderedDict"):
            return getattr(collections, name)
        elif root == "numpy" and name in _SAFE_NUMPY:
            return super().find_class(module, name)
        elif module == "torch" and isinstance(getattr(torch, name, None),
                                              torch.dtype):
            return getattr(torch, name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}:{name}, which a checkpoint of this "
            f"package never holds")


def save_system(system, path: str) -> None:
    """Snapshot a `SlamSystem` (odometry + loop + GBA state) to `path`."""
    blob = {
        "version": FORMAT_VERSION,
        "odom": _state_dict(system.odom),
        "loop": _state_dict(system.loop) if system.loop is not None else None,
        "gba": _state_dict(system.gba) if system.gba is not None else None,
        "system": {k: getattr(system, k) for k in _SYSTEM_KEYS},
    }
    with open(path, "wb") as f:
        _Pickler(f).dump(blob)


def load_system(system, path: str) -> None:
    """Restore a snapshot into a freshly constructed `SlamSystem` with the
    SAME config and enable flags it was saved with; every tensor lands on
    `system.device`."""
    with open(path, "rb") as f:
        blob = _Unpickler(f, system.device).load()
    if not isinstance(blob, dict) or blob.get("version") != FORMAT_VERSION:
        got = blob.get("version") if isinstance(blob, dict) else None
        raise ValueError(f"checkpoint version {got} != {FORMAT_VERSION}")
    for part in ("loop", "gba"):
        if (blob[part] is None) != (getattr(system, part) is None):
            flag = "enable_loop" if part == "loop" else "enable_gba"
            raise ValueError(
                f"checkpoint {'has' if blob[part] is not None else 'lacks'} "
                f"{part} state but the system was built with "
                f"{flag}={getattr(system, part) is not None}")
    for part in ("odom", "loop", "gba"):
        if blob[part] is not None:
            vars(getattr(system, part)).update(blob[part])
    vars(system).update(blob["system"])
