"""The benchmark's scan and IMU generator: a batched PyTorch copy of the
port's simulator (`slambench/simref.py` is its frozen numpy yardstick).

What a cell's configuration and traffic files give (the sensor's beam
pattern, the scene, the trajectory, the noise) becomes a stream of
packets in the form `SlamSystem.process_scan` takes, as the command
line's decoders hand them over: the blind radius and the 1-in-N
decimation applied, offsets from the scan's start.

The raycast runs on the card: every column of rays of many scans at once,
each column cast from the trajectory's pose at its own timestamp, exactly
as `simref.lidar_scan` casts it column by column. The trajectory's
orientation integral is a prefix product (log-depth, numpy) instead of
`simref`'s loop; the IMU stream is `simref.imu_stream` vectorised. Noise
and dropout draw from a `torch.Generator` on the device seeded by the
run's seed, so the same seed gives the same stream.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import simref

GRAVITY_W = simref.GRAVITY_W


# ---------------------------------------------------------------------------
# scene and trajectory from their JSON descriptions
# ---------------------------------------------------------------------------

def scene_from_spec(spec: dict) -> simref.Scene:
    """A Scene from a traffic file's "scene": optional "clutter" (the
    arguments of `simref.make_cluttered_scene`), "planes" ([nx, ny, nz, d]
    infinite planes), "boxes" ([cx, cy, cz, sx, sy, sz]), "cylinders"
    ([cx, cy, cz, radius, height]), "ramps" ([bx, by, bz, length,
    width, rise, yaw]) and "patches" ([cx, cy, cz, nx, ny, nz, e1x, e1y,
    e1z, half1, half2], bounded planes)."""
    parts = []
    if "clutter" in spec:
        c = dict(spec["clutter"])
        parts.append(simref.make_cluttered_scene(
            half_extent=tuple(c["half_extent"]), center=tuple(c["center"]),
            pillars=c["pillars"], cylinders=c["cylinders"], ramps=c["ramps"],
            seed=c["seed"]))
    if spec.get("planes"):
        pl = np.asarray(spec["planes"], np.float64)
        n = pl[:, :3] / np.linalg.norm(pl[:, :3], axis=1, keepdims=True)
        parts.append(simref.Scene.from_planes(n, pl[:, 3]))
    for b in spec.get("boxes", []):
        parts.append(simref.box_scene(b[:3], b[3:6]))
    for c in spec.get("cylinders", []):
        parts.append(simref.cylinder_scene(c[:3], c[3], c[4]))
    for r in spec.get("ramps", []):
        parts.append(simref.ramp_scene(r[:3], r[3], r[4], r[5], yaw=r[6]))
    for q in spec.get("patches", []):
        parts.append(simref.patch_scene(q[:3], q[3:6], q[6:9], q[9], q[10]))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene + p
    return scene


def _exp_batch(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula over (M, 3), as `simref._exp` row by row."""
    th = np.linalg.norm(w, axis=-1)
    safe = np.where(th < 1e-12, 1.0, th)
    k = w / safe[:, None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    E = (np.eye(3)[None] + np.sin(th)[:, None, None] * K
         + (1 - np.cos(th))[:, None, None] * (K @ K))
    E[th < 1e-12] = np.eye(3)
    return E


def _prefix_product(E: np.ndarray) -> np.ndarray:
    """Inclusive left-to-right products E[0] E[1] ... E[i] (Hillis-Steele
    doubling)."""
    A = E.copy()
    shift = 1
    while shift < len(A):
        A[shift:] = A[:-shift] @ A[shift:]
        shift *= 2
    return A


def waypoint_trajectory(legs, dt=1e-3, speed=1.2, ramp=1.0, still=0.0,
                        wobble=0.0, z_amp=0.0,
                        smooth_s=0.4) -> simref.Trajectory:
    """`simref.make_waypoint_trajectory` with its orientation loop as a
    prefix product: the same path to rounding."""
    total = still + sum(d for d, _ in legs) + ramp
    M = int(total / dt) + 1
    ts = np.arange(M) * dt
    yaw = np.zeros(M)
    t0 = still
    for dur, rate in legs:
        i0, i1 = int(t0 / dt), int((t0 + dur) / dt)
        yaw[i0:i1] = rate
        t0 += dur
    w = max(int(smooth_s / dt), 1)
    yaw = np.convolve(yaw, np.ones(w) / w, mode="same")
    s = np.clip((ts - still) / max(ramp, 1e-6), 0.0, 1.0)
    s = s * s * (3.0 - 2.0 * s)
    omega = np.stack([
        wobble * 0.5 * np.sin(2 * np.pi * 0.3 * ts),
        wobble * 0.8 * np.sin(2 * np.pi * 0.2 * ts + 1.0),
        yaw,
    ], axis=-1) * s[:, None]
    Rs = np.empty((M, 3, 3))
    Rs[0] = np.eye(3)
    Rs[1:] = _prefix_product(_exp_batch(0.5 * (omega[:-1] + omega[1:]) * dt))
    vs = np.einsum("mij,j->mi", Rs, np.array([speed, 0.0, 0.0]))
    vs[:, 2] += z_amp * 2 * np.pi * 0.4 * np.cos(2 * np.pi * 0.4 * ts)
    vs *= s[:, None]
    ps = np.cumsum(vs * dt, axis=0)
    ps -= ps[0]
    accs = np.gradient(vs, dt, axis=0)
    return simref.Trajectory(ts=ts, Rs=Rs, ps=ps, vs=vs, omegas=omega,
                             accs=accs)


def yaw_matrix(yaw: float) -> np.ndarray:
    """The rotation by `yaw` radians about the vertical."""
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def place(traj: simref.Trajectory, start) -> simref.Trajectory:
    """The trajectory moved by one rigid motion about the vertical: turned
    by yaw `start[3]` (radians) about the origin, then moved by
    `start[:3]`, so it begins at `start[:3]` heading `start[3]`. The
    body-frame rates are unchanged, and so are the IMU's samples: gravity
    lies along the axis of the turn. None or all zeros is the trajectory
    itself, the same object."""
    if start is None or not any(start):
        return traj
    Rz = yaw_matrix(float(start[3]))
    return simref.Trajectory(
        ts=traj.ts, Rs=Rz @ traj.Rs, ps=traj.ps @ Rz.T + np.asarray(
            start[:3], np.float64), vs=traj.vs @ Rz.T, omegas=traj.omegas,
        accs=traj.accs @ Rz.T)


def trajectory(spec: dict) -> simref.Trajectory:
    """A traffic file's trajectory: its legs (repeated `repeat` times)
    from its optional `start` [x, y, z, yaw]."""
    legs = [tuple(l) for l in spec["legs"]] * int(spec.get("repeat", 1))
    traj = waypoint_trajectory(legs, dt=spec.get("dt", 1e-3),
                               speed=spec["speed"], ramp=spec["ramp"],
                               still=spec["still"], wobble=spec["wobble"],
                               z_amp=spec["z_amp"])
    return place(traj, spec.get("start"))


def imu_samples(traj: simref.Trajectory, rate, bg, ba, gyr_std, acc_std,
                seed, t0=0.0, t1=None):
    """`simref.imu_stream` vectorised: the same samples, and with noise the
    same draws (numpy's generator, gyro then accelerometer per sample)."""
    t1 = traj.ts[-1] if t1 is None else t1
    ts = np.arange(t0, t1, 1.0 / rate)
    i = traj.index(ts)
    gyr = traj.omegas[i] + np.asarray(bg)
    acc = np.einsum("mji,mj->mi", traj.Rs[i], traj.accs[i] - GRAVITY_W) \
        + np.asarray(ba)
    if gyr_std > 0 or acc_std > 0:
        z = np.random.default_rng(seed).standard_normal((len(ts), 2, 3))
        gyr = gyr + gyr_std * z[:, 0]
        acc = acc + acc_std * z[:, 1]
    return ts, gyr, acc


# ---------------------------------------------------------------------------
# the batched raycast
# ---------------------------------------------------------------------------

def beam_pattern(n_az, n_el, fov_el_deg):
    """`simref.scan_directions` at the sensor's vertical field of view:
    ray directions (n_az * n_el, 3), azimuth-major, and each ray's phase
    of the sweep."""
    lo, hi = (math.radians(a) for a in fov_el_deg)
    return simref.scan_directions(n_az, n_el, (lo, hi))


def _scene_tensors(scene: simref.Scene, device):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    return dict(n=f(scene.normals), d=f(scene.ds), c=f(scene.centers),
                e1=f(scene.e1), e2=f(scene.e2), h1=f(scene.half1),
                h2=f(scene.half2))


def cast_columns(dirs_col, R, p, sc, max_range=80.0, min_range=0.5):
    """Ranges of rays cast in columns: dirs_col (A, E, 3) sensor-frame
    directions of A columns of E rays, each column from world pose
    (R (..., A, 3, 3), p (..., A, 3)); `simref.raycast` for every column
    at once. Returns (points (..., A, E, 3) sensor frame, hit (..., A,
    E))."""
    wd = torch.einsum("...aij,aej->...aei", R, dirs_col)
    denom = wd @ sc["n"].T                                   # (..,A,E,P)
    num = -(p @ sc["n"].T + sc["d"])                        # (..,A,P)
    t = num[..., None, :] / denom
    t = torch.where((denom < -1e-9) | (denom > 1e-9), t, math.inf)
    t = torch.where(t > min_range, t, math.inf)
    finite = torch.isfinite(sc["h1"]) | torch.isfinite(sc["h2"])
    if bool(finite.any()):
        rel0 = p[..., :, None, :] - sc["c"]                  # (..,A,P,3)
        u = (torch.sum(rel0 * sc["e1"], -1)[..., None, :]
             + t * (wd @ sc["e1"].T))
        v = (torch.sum(rel0 * sc["e2"], -1)[..., None, :]
             + t * (wd @ sc["e2"].T))
        inside = (u.abs() <= sc["h1"]) & (v.abs() <= sc["h2"])
        t = torch.where(torch.isfinite(t) & (~finite | inside), t, math.inf)
    thit = t.amin(-1)
    hit = torch.isfinite(thit) & (thit < max_range)
    thit = torch.where(hit, thit, 0.0)
    return dirs_col * thit[..., None], hit


@dataclasses.dataclass
class Stream:
    """Packets on the host: scan k's points are pts[starts[k]:starts[k+1]]."""
    pts: np.ndarray          # (N, 3) float32, sensor frame
    offsets: np.ndarray      # (N,) float32, seconds from the scan's start
    starts: np.ndarray       # (S + 1,)
    rays: np.ndarray         # (S,) rays of each scan with a return, before
                             # the blind radius and the decimation
    t_beg: np.ndarray        # (S,)
    t_end: np.ndarray        # (S,)
    imu_ts: np.ndarray
    imu_gyr: np.ndarray
    imu_acc: np.ndarray
    imu_first: np.ndarray    # (S,) first IMU sample of scan k's packet
    imu_last: np.ndarray     # (S,) one past its last
    gt_R: np.ndarray         # (S, 3, 3) float64, the IMU's true attitude
    gt_p: np.ndarray         # (S, 3) and position at the scan's end

    def __len__(self):
        return len(self.t_beg)

    def packet(self, k: int):
        """process_scan's arguments for scan k."""
        a, b = self.starts[k], self.starts[k + 1]
        i, j = self.imu_first[k], self.imu_last[k]
        return (self.pts[a:b], self.offsets[a:b], self.imu_ts[i:j],
                self.imu_gyr[i:j], self.imu_acc[i:j], float(self.t_beg[k]),
                float(self.t_end[k]))


def lidar_scans(traj, scene, t_beg, t_end, n_az, n_el, fov_el_deg, *,
                device, seed, noise=0.0, dropout_at=None, blind=0.5,
                filter_num=1, max_range=80.0, extrinsic=None,
                chunk_rays=1 << 21):
    """Scans k = 0..S-1 over [t_beg[k], t_end[k]], decoded: returns (pts,
    offsets, counts, rays) with pts/offsets of all scans laid end to end.
    Noise and dropout as `simref.lidar_scan`'s, drawn on the device.

    The trajectory is the IMU's; `extrinsic` (R_ext (3, 3), t_ext (3,)),
    the LiDAR's pose in the IMU frame as the configuration states it,
    puts the beams in the LiDAR's frame and casts them from its origin,
    so the points come out in the LiDAR frame (p_imu = R_ext p + t_ext).
    None is the identity, `simref.lidar_scan`'s case."""
    dirs, phase = beam_pattern(n_az, n_el, fov_el_deg)
    dirs_col = torch.as_tensor(dirs.reshape(n_az, n_el, 3), device=device)
    phase_col = phase.reshape(n_az, n_el)[:, 0]
    sc = _scene_tensors(scene, device)
    ts_dev = torch.as_tensor(traj.ts, device=device)
    Rs_dev = torch.as_tensor(traj.Rs, device=device)
    ps_dev = torch.as_tensor(traj.ps, device=device)
    if extrinsic is not None:
        R_ext = torch.as_tensor(np.asarray(extrinsic[0], np.float64)
                                .reshape(3, 3), device=device)
        t_ext = torch.as_tensor(np.asarray(extrinsic[1], np.float64),
                                device=device)
        ps_dev = ps_dev + Rs_dev @ t_ext
        Rs_dev = Rs_dev @ R_ext
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    per = max(1, chunk_rays // (n_az * n_el * max(len(scene.ds) // 32, 1)))
    phc = torch.as_tensor(phase_col, device=device)
    ph = torch.as_tensor(phase, device=device)
    out_p, out_o, counts, rays = [], [], [], []
    for s0 in range(0, len(t_beg), per):
        tb = torch.as_tensor(t_beg[s0:s0 + per], device=device)
        te = torch.as_tensor(t_end[s0:s0 + per], device=device)
        tc = tb[:, None] + phc[None] * (te - tb)[:, None]           # (S, A)
        idx = torch.clamp(torch.searchsorted(ts_dev, tc), 0,
                          len(traj.ts) - 1)
        pts, hit = cast_columns(dirs_col, Rs_dev[idx], ps_dev[idx], sc,
                                max_range=max_range)
        S = pts.shape[0]
        pts = pts.reshape(S, -1, 3)
        hit = hit.reshape(S, -1)
        if dropout_at is not None:
            r = torch.linalg.vector_norm(pts, dim=-1)
            p_drop = torch.clamp(0.5 * r / dropout_at, max=1.0) ** 2
            u = torch.rand(hit.shape, generator=gen, device=device,
                           dtype=torch.float64)
            hit = hit & (u >= p_drop)
            pts = torch.where(hit[..., None], pts, 0.0)
        if noise > 0:
            r = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
            z = torch.randn(pts.shape, generator=gen, device=device,
                            dtype=torch.float64)
            pts = pts + noise * z * (r > 0)
        offs = (tb[:, None] + ph[None] * (te - tb)[:, None]) - tb[:, None]
        # the decoders' filter: blind radius, finite, then 1 in filter_num
        keep = (torch.sum(pts * pts, -1) > blind * blind) \
            & torch.isfinite(pts).all(-1)
        rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
        keep = keep & (rank % max(1, int(filter_num)) == 0)
        keep = keep & (offs <= simref.MAX_OFFSET_S)
        counts.append(keep.sum(1).cpu())
        rays.append(hit.sum(1).cpu())
        out_p.append(pts[keep].to(torch.float32).cpu())
        out_o.append(offs[keep].to(torch.float32).cpu())
    return (torch.cat(out_p).numpy(), torch.cat(out_o).numpy(),
            torch.cat(counts).numpy(), torch.cat(rays).numpy())


def make_stream(sensor: dict, traffic: dict, seed: int, device,
                n_scans: int | None = None) -> Stream:
    """The stream of a cell: the configuration's `sensor` block and the
    traffic file, scans of `sensor["period_s"]` back to back from the
    trajectory's start plus `traffic["t0_s"]`."""
    traj = trajectory(traffic["trajectory"])
    scene = scene_from_spec(traffic["scene"])
    period = sensor["period_s"]
    t0 = traffic.get("t0_s", 0.1)
    n = int((traj.ts[-1] - t0 - 0.2) / period)
    if n_scans is not None:
        n = min(n, n_scans)
    t_beg = t0 + period * np.arange(n)
    t_end = t_beg + period
    noise = traffic["noise"]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    bg = rng.normal(0.0, noise["gyr_bias"], 3)
    ba = rng.normal(0.0, noise["acc_bias"], 3)
    imu_ts, gyr, acc = imu_samples(
        traj, sensor["imu_hz"], bg, ba, noise["gyr_std"], noise["acc_std"],
        seed=int(seed) % (1 << 63) + 1, t0=0.0, t1=float(t_end[-1]) + 0.05)
    # a packet's IMU: the last sample at or before its start through its end
    first = np.maximum(np.searchsorted(imu_ts, t_beg, side="right") - 1, 0)
    last = np.searchsorted(imu_ts, t_end + 1e-9, side="right")
    pts, offs, counts, rays = lidar_scans(
        traj, scene, t_beg, t_end, sensor["n_az"], sensor["n_el"],
        sensor["fov_el_deg"], device=device, seed=seed,
        noise=noise["range_std"], dropout_at=noise.get("dropout_at"),
        blind=sensor["blind"], filter_num=sensor["point_filter_num"],
        max_range=sensor["max_range"],
        extrinsic=(sensor["extrinsic_R"], sensor["extrinsic_t"]))
    starts = np.concatenate([[0], np.cumsum(counts)])
    gi = np.clip(np.searchsorted(traj.ts, t_end), 0, len(traj.ts) - 1)
    return Stream(pts=pts, offsets=offs, starts=starts, rays=rays,
                  t_beg=t_beg, t_end=t_end, imu_ts=imu_ts, imu_gyr=gyr,
                  imu_acc=acc, imu_first=first, imu_last=last,
                  gt_R=traj.Rs[gi].copy(), gt_p=traj.ps[gi].copy())
