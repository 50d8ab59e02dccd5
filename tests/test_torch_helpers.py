"""Shared helpers for the PyTorch-port parity tests, and the tests of the
carry converter (`voxelslam_tpu_torch.convert`) they rely on.

Every parity test makes its inputs with numpy from a seed, feeds the same
arrays to the JAX package (on the CPU) and to the port (device="cpu"),
and compares within a tolerance stated at the comparison."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voxelslam_tpu.core.state import NavState as JNavState
from voxelslam_tpu.map import voxel_map as jvm
from voxelslam_tpu_torch import convert
from voxelslam_tpu_torch.core.state import NavState
from voxelslam_tpu_torch.map import voxel_map as tvm

torch.set_num_threads(1)


def to_np_dict(obj):
    """JAX dataclass tree -> nested dicts of numpy arrays (copies)."""
    return dataclasses.asdict(jax.tree.map(lambda a: np.array(a), obj))


def to_port(obj, cls):
    """A JAX dataclass (NavState, VoxelLevel, Preint, Cluster) as the
    port's dataclass of CPU tensors."""
    return convert.from_numpy(cls, to_np_dict(obj))


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def random_states(rng, W):
    """(W,) random NavStates as numpy fields (shared input of both sides)."""
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rng.normal(0, 0.5, (W, 3))).as_matrix()
    A = rng.normal(0, 1e-2, (W, 15, 15))
    return dict(
        R=R.astype(np.float32), p=rng.normal(0, 2, (W, 3)).astype(np.float32),
        v=rng.normal(0, 1, (W, 3)).astype(np.float32),
        bg=rng.normal(0, 1e-3, (W, 3)).astype(np.float32),
        ba=rng.normal(0, 1e-2, (W, 3)).astype(np.float32),
        g=np.tile([0.0, 0.0, -9.81], (W, 1)).astype(np.float32),
        t=np.arange(W, dtype=np.float32) * 0.1,
        cov=(A @ A.transpose(0, 2, 1) + np.eye(15) * 1e-4).astype(np.float32))


def states_both(d):
    """The same numpy fields as a JAX NavState and a port NavState."""
    import jax.numpy as jnp
    return (JNavState(**{k: jnp.asarray(v) for k, v in d.items()}),
            NavState(**{k: t(v) for k, v in d.items()}))


def planar_world_points(rng, n_pts, noise=0.005):
    """Points on a floor, two walls and a ceiling of a small room."""
    k = rng.integers(0, 4, n_pts)
    u = rng.uniform(-3.5, 3.5, n_pts)
    v = rng.uniform(-3.5, 3.5, n_pts)
    h = rng.uniform(-0.9, 2.4, n_pts)
    pts = np.where(k[:, None] == 0, np.stack([u, v, np.full(n_pts, -1.0)], 1),
          np.where(k[:, None] == 1, np.stack([np.full(n_pts, 4.0), u, h], 1),
          np.where(k[:, None] == 2, np.stack([u, np.full(n_pts, -4.0), h], 1),
                   np.stack([u, v, np.full(n_pts, 2.5)], 1))))
    return (pts + rng.normal(0, noise, pts.shape)).astype(np.float32)


def window_frames(rng, W, n_pts):
    """W frames of (R, p, local points, world points, mask, noise trace)
    seeing the same room from nearby poses."""
    from scipy.spatial.transform import Rotation
    frames = []
    for i in range(W):
        R = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
        p = np.array([0.1 * i, 0.05 * i, 0.0]) + rng.normal(0, 0.01, 3)
        wld = planar_world_points(rng, n_pts)
        loc = ((wld - p) @ R).astype(np.float32)
        mask = (rng.random(n_pts) > 0.05).astype(np.float32)
        tr = np.full((n_pts,), 1e-4, np.float32)
        frames.append((R.astype(np.float32), p.astype(np.float32), loc,
                       mask, tr))
    return frames


def build_maps(cfg, frames, jours=None):
    """Insert every frame at its window slot (frame i stamped with travel
    distance jours[i], default 0) and fully refresh, on both sides.
    Returns (jax levels, port levels, Rs, ps)."""
    import jax.numpy as jnp
    W = cfg.win_size
    tcfg = port_map_config(cfg)
    jl = jvm.empty_map(cfg)
    tl = tvm.empty_map(tcfg)
    for i, (R, p, loc, mask, tr) in enumerate(frames):
        wld = loc @ R.T + p
        jour = 0.0 if jours is None else float(jours[i])
        jl = jvm.insert_scan(jl, cfg, jnp.asarray(wld), jnp.asarray(loc),
                             jnp.asarray(tr), jnp.asarray(mask), i, jour)
        tl = tvm.insert_scan(tl, tcfg, t(wld), t(loc), t(tr), t(mask), i,
                             jour)
    Rs = np.stack([f[0] for f in frames]
                  + [np.eye(3, dtype=np.float32)] * (W - len(frames)))
    ps = np.stack([f[1] for f in frames]
                  + [np.zeros(3, np.float32)] * (W - len(frames)))
    mp = np.arange(W, dtype=np.int32)
    jl = jvm.refresh_planes(jl, cfg, jnp.asarray(Rs), jnp.asarray(ps),
                            jnp.asarray(mp), len(frames))
    tl = tvm.refresh_planes(tl, tcfg, t(Rs), t(ps), t(mp, torch.int32),
                            len(frames))
    return jl, tl, Rs, ps


def assert_level_close(jl, tl, tol_n=1e-5, tol_mu=2e-4, tol_S=2e-3):
    """Keys/occ exact, cluster statistics within the given tolerances."""
    np.testing.assert_array_equal(np.asarray(jl.keys), n(tl.keys))
    np.testing.assert_array_equal(np.asarray(jl.occ), n(tl.occ))
    for a, b in ((jl.win, tl.win), (jl.fix, tl.fix), (jl.tot, tl.tot)):
        np.testing.assert_allclose(np.asarray(a.n), n(b.n), atol=tol_n)
        np.testing.assert_allclose(np.asarray(a.mu), n(b.mu), atol=tol_mu)
        np.testing.assert_allclose(np.asarray(a.S), n(b.S), atol=tol_S)


def small_map_config():
    from voxelslam_tpu.config import MapConfig
    return MapConfig(capacities=(1 << 10, 1 << 11, 1 << 12),
                     unique_max=(512, 1024, 2048), win_size=4)


def port_map_config(jcfg):
    from voxelslam_tpu_torch.config import MapConfig
    return MapConfig(**dataclasses.asdict(jcfg))


# --------------------------------------------------------------------------
# tests of the converter
# --------------------------------------------------------------------------

def test_from_numpy_roundtrip_navstate():
    d = random_states(np.random.default_rng(0), 3)
    js, _ = states_both(d)
    ts = to_port(js, NavState)
    for k, v in d.items():
        np.testing.assert_array_equal(n(getattr(ts, k)), v)
        assert getattr(ts, k).dtype == torch.float32


def test_carry_from_numpy_levels_and_dtypes():
    cfg = small_map_config()
    rng = np.random.default_rng(1)
    jl, _, _, _ = build_maps(cfg, window_frames(rng, 2, 300))
    W = cfg.win_size
    d = {"x": to_np_dict(JNavState.identity()),
         "levels": [to_np_dict(lv) for lv in jl],
         "win": to_np_dict(jax.tree.map(lambda a: np.stack([a] * W),
                                        JNavState.identity())),
         "mp": np.arange(W, dtype=np.int32),
         "preints_dev": {f: np.zeros(s, np.float32) for f, s in (
             ("R_delta", (W - 1, 3, 3)), ("p_delta", (W - 1, 3)),
             ("v_delta", (W - 1, 3)), ("R_bg", (W - 1, 3, 3)),
             ("p_bg", (W - 1, 3, 3)), ("p_ba", (W - 1, 3, 3)),
             ("v_bg", (W - 1, 3, 3)), ("v_ba", (W - 1, 3, 3)),
             ("dtime", (W - 1,)), ("cov", (W - 1, 15, 15)),
             ("bg_lin", (W - 1, 3)), ("ba_lin", (W - 1, 3)))}}
    carry = convert.carry_from_numpy(d)
    for jlv, tlv in zip(jl, carry["levels"]):
        assert tlv.keys.dtype == torch.int32 and tlv.occ.dtype == torch.bool
        assert tlv.state.dtype == torch.int32
        assert_level_close(jlv, tlv, 0, 0, 0)
        np.testing.assert_array_equal(np.asarray(jlv.slab), n(tlv.slab))
    assert carry["mp"].dtype == torch.int32
    assert carry["win"].R.shape == (W, 3, 3)
    assert carry["preints_dev"].cov.shape == (W - 1, 15, 15)
