"""Synthetic LiDAR-inertial data generation (host-side, numpy f64).

The reference has no tests and validates on rosbags; we can't ship bags,
so every end-to-end test and benchmark here runs on simulated data: a
smooth 6-DoF trajectory through a planar "room", an IMU stream derived
analytically from it, and LiDAR scans raycast against the room planes
with per-point timestamps (so motion distortion is real and de-skew is
exercised).

Ground truth is exact, which turns the reference's manual RViz
validation (SURVEY.md section 4) into quantitative ATE assertions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY_W = np.array([0.0, 0.0, -9.8])


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _exp(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    K = _hat(w / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@dataclasses.dataclass
class Trajectory:
    """Dense ground-truth trajectory on a fine grid with interpolation."""

    ts: np.ndarray       # (M,)
    Rs: np.ndarray       # (M, 3, 3) body->world
    ps: np.ndarray       # (M, 3)
    vs: np.ndarray       # (M, 3) world velocity
    omegas: np.ndarray   # (M, 3) body angular velocity
    accs: np.ndarray     # (M, 3) world linear acceleration

    def index(self, t):
        return np.clip(np.searchsorted(self.ts, t), 0, len(self.ts) - 1)

    def state_at(self, t):
        i = self.index(t)
        return self.Rs[i], self.ps[i], self.vs[i]

    def imu_at(self, t, bg=None, ba=None, rng=None, gyr_std=0.0, acc_std=0.0):
        """Ideal IMU measurement at time t (gyro body rate, accel specific force)."""
        i = self.index(t)
        gyr = self.omegas[i].copy()
        acc = self.Rs[i].T @ (self.accs[i] - GRAVITY_W)
        if bg is not None:
            gyr = gyr + bg
        if ba is not None:
            acc = acc + ba
        if rng is not None:
            gyr = gyr + rng.normal(0, gyr_std, 3)
            acc = acc + rng.normal(0, acc_std, 3)
        return gyr, acc


def make_trajectory(duration=10.0, dt=1e-3, speed=1.0, yaw_rate=0.25,
                    wobble=0.3, z_amp=0.15, seed=0, ramp=1.0,
                    still=0.0) -> Trajectory:
    """Smooth figure-ish path: forward motion + yaw + sinusoidal roll/pitch/z.

    Angular velocity is analytic; orientation is integrated at dt with the
    exact exponential so (R, omega) stay consistent. Positions follow the
    body x-axis with analytic world acceleration via finite differences of
    an analytic velocity (errors O(dt^2), far below test tolerances).

    The platform is exactly stationary for the first `still` seconds, then
    all motion smoothly ramps from rest over the next `ramp` seconds. The
    reference's static IMU initialization (running mean of acc/gyr,
    ekf_imu.hpp:167-195) assumes such a still period — its README tells
    users to keep the device still at startup.
    """
    M = int(duration / dt) + 1
    ts = np.arange(M) * dt
    s = np.clip((ts - still) / max(ramp, 1e-6), 0.0, 1.0)
    s = s * s * (3.0 - 2.0 * s)  # smoothstep: zero velocity AND accel at onset
    omega = np.stack([
        wobble * 0.6 * np.sin(2 * np.pi * 0.33 * ts),
        wobble * np.sin(2 * np.pi * 0.21 * ts + 1.0),
        yaw_rate + wobble * 0.3 * np.sin(2 * np.pi * 0.11 * ts),
    ], axis=-1) * s[:, None]

    Rs = np.empty((M, 3, 3))
    Rs[0] = np.eye(3)
    for i in range(1, M):
        w_mid = 0.5 * (omega[i - 1] + omega[i])
        Rs[i] = Rs[i - 1] @ _exp(w_mid * dt)

    # world velocity: forward along body x + vertical bob
    vs = np.einsum("mij,j->mi", Rs, np.array([speed, 0.0, 0.0]))
    vs[:, 2] += z_amp * 2 * np.pi * 0.4 * np.cos(2 * np.pi * 0.4 * ts)
    vs *= s[:, None]

    ps = np.cumsum(vs * dt, axis=0)
    ps -= ps[0]
    accs = np.gradient(vs, dt, axis=0)
    return Trajectory(ts=ts, Rs=Rs, ps=ps, vs=vs, omegas=omega, accs=accs)


def make_waypoint_trajectory(legs, dt=1e-3, speed=1.2, ramp=1.0,
                             still=0.0, wobble=0.0, z_amp=0.0,
                             smooth_s=0.4) -> Trajectory:
    """Scripted path: a list of (duration_s, yaw_rate_rad_s) legs driven
    forward along body x at `speed`. Lets tests steer through specific
    scene regions (a corridor, a turn-around, a closed loop) — the
    generic `make_trajectory` cannot. Yaw-rate steps are smoothed with a
    `smooth_s` box filter so the IMU stream stays physically plausible.
    """
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
    for i in range(1, M):
        w_mid = 0.5 * (omega[i - 1] + omega[i])
        Rs[i] = Rs[i - 1] @ _exp(w_mid * dt)
    vs = np.einsum("mij,j->mi", Rs, np.array([speed, 0.0, 0.0]))
    vs[:, 2] += z_amp * 2 * np.pi * 0.4 * np.cos(2 * np.pi * 0.4 * ts)
    vs *= s[:, None]
    ps = np.cumsum(vs * dt, axis=0)
    ps -= ps[0]
    accs = np.gradient(vs, dt, axis=0)
    return Trajectory(ts=ts, Rs=Rs, ps=ps, vs=vs, omegas=omega, accs=accs)


def imu_stream(traj: Trajectory, rate=200.0, bg=(0.0, 0.0, 0.0), ba=(0.0, 0.0, 0.0),
               gyr_std=0.0, acc_std=0.0, seed=1, t0=0.0, t1=None):
    """Sample an IMU stream from the trajectory. Returns (ts, gyr, acc)."""
    t1 = traj.ts[-1] if t1 is None else t1
    ts = np.arange(t0, t1, 1.0 / rate)
    rng = np.random.default_rng(seed)
    bg = np.asarray(bg)
    ba = np.asarray(ba)
    gyr = np.empty((len(ts), 3))
    acc = np.empty((len(ts), 3))
    for k, t in enumerate(ts):
        gyr[k], acc[k] = traj.imu_at(t, bg, ba, rng, gyr_std, acc_std)
    return ts, gyr, acc


# ---------------------------------------------------------------------------
# Planar-room LiDAR simulation
# ---------------------------------------------------------------------------

def box_room(half_extent=(12.0, 10.0, 3.0), center=(0.0, 0.0, 1.0)):
    """6 axis-aligned planes (inward normals) as (normals (6,3), ds (6,))
    with n.x + d = 0 on the plane."""
    hx, hy, hz = half_extent
    cx, cy, cz = center
    normals = np.array([
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
    ], dtype=np.float64)
    # n.x + d = 0 with x on plane: d = -n.o for o a point on the plane
    ds = -np.einsum("ij,ij->i", normals, np.array([
        [cx - hx, 0, 0], [cx + hx, 0, 0],
        [0, cy - hy, 0], [0, cy + hy, 0],
        [0, 0, cz - hz], [0, 0, cz + hz],
    ]))
    return normals, ds


@dataclasses.dataclass
class Scene:
    """Bounded planar patches: n.x + d = 0 within +-half extents along
    in-plane bases (e1, e2) around `centers`. Infinite patches (the room
    shell) use half = inf."""
    normals: np.ndarray   # (P, 3)
    ds: np.ndarray        # (P,)
    centers: np.ndarray   # (P, 3)
    e1: np.ndarray        # (P, 3)
    e2: np.ndarray        # (P, 3)
    half1: np.ndarray     # (P,)
    half2: np.ndarray     # (P,)

    @staticmethod
    def from_planes(normals, ds):
        P = len(normals)
        normals = np.asarray(normals, np.float64)
        e1 = np.cross(normals, np.where(
            np.abs(normals[:, 2:3]) < 0.9, [0, 0, 1.0], [1.0, 0, 0]))
        e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
        e2 = np.cross(normals, e1)
        centers = -normals * np.asarray(ds)[:, None]
        return Scene(normals=normals, ds=np.asarray(ds, np.float64),
                     centers=centers, e1=e1, e2=e2,
                     half1=np.full(P, np.inf), half2=np.full(P, np.inf))

    def __add__(self, other: "Scene") -> "Scene":
        return Scene(*[np.concatenate([getattr(self, f.name),
                                       getattr(other, f.name)])
                       for f in dataclasses.fields(Scene)])


def box_scene(center, size) -> Scene:
    """Axis-aligned box (e.g. a pillar / crate) as 6 bounded faces with
    outward normals."""
    c = np.asarray(center, np.float64)
    h = np.asarray(size, np.float64) / 2.0
    normals, centers, e1s, e2s, h1s, h2s = [], [], [], [], [], []
    for ax in range(3):
        for sgn in (-1.0, 1.0):
            n = np.zeros(3)
            n[ax] = sgn
            a1, a2 = [i for i in range(3) if i != ax]
            e1 = np.zeros(3)
            e1[a1] = 1.0
            e2 = np.zeros(3)
            e2[a2] = 1.0
            normals.append(n)
            centers.append(c + n * h[ax])
            e1s.append(e1)
            e2s.append(e2)
            h1s.append(h[a1])
            h2s.append(h[a2])
    normals = np.stack(normals)
    centers = np.stack(centers)
    ds = -np.einsum("ij,ij->i", normals, centers)
    return Scene(normals=normals, ds=ds, centers=centers,
                 e1=np.stack(e1s), e2=np.stack(e2s),
                 half1=np.array(h1s), half2=np.array(h2s))


def patch_scene(center, normal, e1, half1, half2) -> Scene:
    """One bounded planar patch with an arbitrary orientation — ramps,
    tilted roofs, lean-tos. `e1` (in-plane) is re-orthogonalized against
    `normal`; e2 completes the frame."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    e1 = np.asarray(e1, np.float64)
    e1 = e1 - n * (e1 @ n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    c = np.asarray(center, np.float64)
    return Scene(normals=n[None], ds=np.array([-n @ c]), centers=c[None],
                 e1=e1[None], e2=e2[None],
                 half1=np.array([half1]), half2=np.array([half2]))


def cylinder_scene(center, radius, height, nfaces=12) -> Scene:
    """Vertical cylinder approximated by `nfaces` planar facets (trees,
    columns, tanks — the deliberately NON-planar clutter class: at
    nfaces=12 each facet subtends 30 deg, so voxel-level plane fits see
    curved, partially-planar geometry)."""
    c = np.asarray(center, np.float64)
    half_w = radius * np.tan(np.pi / nfaces)
    parts = []
    for k in range(nfaces):
        a = 2 * np.pi * k / nfaces
        n = np.array([np.cos(a), np.sin(a), 0.0])
        parts.append(patch_scene(c + n * radius, n, [0, 0, 1.0],
                                 height / 2.0, half_w))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def ramp_scene(base_center, length, width, rise, yaw=0.0) -> Scene:
    """Inclined rectangular surface climbing `rise` metres over `length`
    along the yaw direction."""
    d = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    slope = np.array([d[0] * length, d[1] * length, rise])
    slope /= np.linalg.norm(slope)
    lateral = np.cross([0.0, 0.0, 1.0], d)
    n = np.cross(lateral, slope)
    n /= np.linalg.norm(n)
    if n[2] < 0:
        n = -n
    c = np.asarray(base_center, np.float64) + 0.5 * np.array(
        [d[0] * length, d[1] * length, rise])
    diag = 0.5 * np.hypot(length, rise)
    return patch_scene(c, n, slope, diag, width / 2.0)


def make_cluttered_scene(half_extent=(16.0, 13.0, 3.8),
                         center=(4.0, 0.0, 1.2), pillars=6, cylinders=5,
                         ramps=2, seed=11) -> Scene:
    """Room shell + boxes + cylinder facets + ramps: the hardened proxy
    for real-bag geometry (VERDICT r4 weak #6) — curved surfaces break
    the all-planar assumption, ramps tilt the dominant ground plane, and
    bounded patches give real partial occlusion."""
    scene = make_scene(half_extent, center, pillars=pillars, seed=seed)
    rng = np.random.default_rng(seed + 1)
    hx, hy, hz = half_extent
    cx, cy, cz = center
    floor_z = cz - hz
    for _ in range(cylinders):
        px = cx + rng.uniform(-hx + 3, hx - 3)
        py = cy + rng.uniform(-hy + 3, hy - 3)
        if abs(px) < 4 and abs(py) < 4:
            continue
        r = rng.uniform(0.3, 1.2)
        h = rng.uniform(1.5, 2 * hz - 0.3)
        scene = scene + cylinder_scene((px, py, floor_z + h / 2), r, h)
    for _ in range(ramps):
        px = cx + rng.uniform(-hx + 5, hx - 5)
        py = cy + rng.uniform(-hy + 5, hy - 5)
        if abs(px) < 4 and abs(py) < 4:
            continue
        scene = scene + ramp_scene((px, py, floor_z),
                                   rng.uniform(3.0, 6.0),
                                   rng.uniform(1.5, 3.0),
                                   rng.uniform(0.5, 1.5),
                                   yaw=rng.uniform(0, 2 * np.pi))
    return scene


def make_scene(half_extent=(14.0, 12.0, 3.5), center=(4.0, 0.0, 1.0),
               pillars=8, seed=3) -> Scene:
    """Room shell + randomly placed box pillars — enough corner structure
    for place recognition (BTC projection-image corners need occupancy
    discontinuities that bare walls lack)."""
    normals, ds = box_room(half_extent, center)
    scene = Scene.from_planes(normals, ds)
    rng = np.random.default_rng(seed)
    hx, hy, hz = half_extent
    cx, cy, cz = center
    for _ in range(pillars):
        px = cx + rng.uniform(-hx + 3, hx - 3)
        py = cy + rng.uniform(-hy + 3, hy - 3)
        sx, sy = rng.uniform(0.6, 2.5, 2)
        sz = rng.uniform(1.5, 2 * hz - 0.5)
        if abs(px) < 4 and abs(py) < 4:
            continue  # keep the trajectory region clear
        scene = scene + box_scene((px, py, cz - hz + sz / 2), (sx, sy, sz))
    return scene


def sample_scene(scene: Scene, per_m2: float = 8.0, clip: float = 16.0,
                 seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """Area-weighted random surface samples of a Scene (world frame) —
    a stand-in for an accumulated keyframe cloud in loop/GBA tests.
    Infinite shell patches are clipped to +-clip metres."""
    rng = np.random.default_rng(seed)
    pts = []
    h1 = np.minimum(scene.half1, clip)
    h2 = np.minimum(scene.half2, clip)
    for i in range(len(scene.normals)):
        area = 4.0 * h1[i] * h2[i]
        n = max(int(area * per_m2), 4)
        u = rng.uniform(-h1[i], h1[i], n)
        v = rng.uniform(-h2[i], h2[i], n)
        p = (scene.centers[i][None]
             + u[:, None] * scene.e1[i][None]
             + v[:, None] * scene.e2[i][None])
        pts.append(p)
    out = np.concatenate(pts)
    if noise > 0:
        out = out + rng.normal(0, noise, out.shape)
    return out


def scan_directions(n_az=64, n_el=16, fov_el=(-0.4, 0.3)):
    """Unit ray directions in sensor frame, row-major az-sweep (mimics a
    spinning LiDAR so per-point time grows with azimuth)."""
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el = np.linspace(fov_el[0], fov_el[1], n_el)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.cos(ee) * np.sin(aa), np.sin(ee)], -1)
    return d.reshape(-1, 3), (aa.reshape(-1) + np.pi) / (2 * np.pi)  # dirs, phase


def raycast(origin, R, dirs, scene, ds=None, max_range=80.0, min_range=0.5):
    """Cast rays from world pose (R, origin) against a Scene (or legacy
    (normals, ds) infinite planes); returns (points_sensor, hit)."""
    if ds is not None:
        scene = Scene.from_planes(scene, ds)
    wd = dirs @ R.T                                # world directions (N, 3)
    denom = wd @ scene.normals.T                   # (N, P)
    num = -(origin @ scene.normals.T + scene.ds)   # (P,)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = num[None, :] / denom
    t = np.where((denom < -1e-9) | (denom > 1e-9), t, np.inf)
    t = np.where(t > min_range, t, np.inf)
    # bounded patches: hit point must lie within +-half along (e1, e2)
    finite = np.isfinite(scene.half1) | np.isfinite(scene.half2)
    if np.any(finite):
        with np.errstate(invalid="ignore"):
            pt = origin[None, None, :] + t[:, :, None] * wd[:, None, :]
            rel = pt - scene.centers[None]
            u = np.einsum("npi,pi->np", rel, scene.e1)
            v = np.einsum("npi,pi->np", rel, scene.e2)
            inside = ((np.abs(u) <= scene.half1[None])
                      & (np.abs(v) <= scene.half2[None]))
        t = np.where(np.isfinite(t) & (~finite[None] | inside), t, np.inf)
    thit = t.min(axis=1)
    hit = np.isfinite(thit) & (thit < max_range)
    thit = np.where(hit, thit, 0.0)
    return dirs * thit[:, None], hit


def lidar_scan(traj: Trajectory, t_beg, t_end, normals, ds=None, n_az=64,
               n_el=16, noise=0.0, seed=0, max_range=80.0,
               dropout_at=None):
    """One motion-distorted scan: each column of rays is cast from the pose
    at its own timestamp. `normals` may be a Scene (then ds is ignored) or
    legacy (P,3) plane normals with `ds`. Returns dict with points (sensor
    frame AT SAMPLE TIME — i.e. distorted), per-point offsets (s, from
    t_beg), hit mask.

    dropout_at: optional range (m) at which half the returns are lost —
    per-ray drop probability min(1, 0.5 * r / dropout_at)^2, the
    range-dependent return loss real sensors show on distant / grazing
    surfaces (VERDICT r4 weak #6)."""
    scene = normals if isinstance(normals, Scene) \
        else Scene.from_planes(normals, ds)
    dirs, phase = scan_directions(n_az, n_el)
    t_pts = t_beg + phase * (t_end - t_beg)
    rng = np.random.default_rng(seed)
    pts = np.zeros((len(dirs), 3))
    hit = np.zeros(len(dirs), dtype=bool)
    # group by azimuth column (same timestamp) for speed
    order = np.argsort(t_pts, kind="stable")
    dirs_o, t_o = dirs[order], t_pts[order]
    n_per = n_el
    for c in range(0, len(dirs_o), n_per):
        tc = t_o[c]
        R, p, _ = traj.state_at(tc)
        pc, hc = raycast(p, R, dirs_o[c:c + n_per], scene,
                         max_range=max_range)
        pts[order[c:c + n_per]] = pc
        hit[order[c:c + n_per]] = hc
    if dropout_at is not None:
        r = np.linalg.norm(pts, axis=-1)
        p_drop = np.minimum(0.5 * r / dropout_at, 1.0) ** 2
        hit = hit & (rng.uniform(size=len(hit)) >= p_drop)
        pts = np.where(hit[:, None], pts, 0.0)
    if noise > 0:
        r = np.linalg.norm(pts, axis=-1, keepdims=True)
        pts += rng.normal(0, noise, pts.shape) * (r > 0)
    return {
        "points": pts.astype(np.float32),
        "offsets": (t_pts - t_beg).astype(np.float32),
        "hit": hit,
        "t_beg": t_beg,
        "t_end": t_end,
    }
