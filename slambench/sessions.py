"""Prior sessions written from the seed, as earlier runs of the system
would have left them on disk, for a configuration whose `system` block
names them with `previous_maps`.

The traffic file's `prior_sessions` is a list of trajectories through the
cell's own scene (the keys of its `trajectory`, with `start` and the
number of `scans`), one a name in `previous_maps`, in that order. For
each, the writer casts every scan from the pose at its end (`sim`), which
is the de-skewed cloud a saved session holds, takes it into the body
frame with the configuration's extrinsic and downsamples it at
`odom.down_size` with its own voxel grid (the centroid of each voxel's
points). It writes, in the reference's formats and without the program's
writers, so that a fault of the program's reader shows:

    <savepath>/<name>/<i>.pcd          binary PCD, x y z intensity float32
    <savepath>/<name>/alidarState.txt  26 columns a scan: t, p, q_xyzw, v,
                                       bg, ba, g, v6
    <savepath>/edge.txt                name_a name_b ord_a ord_b t q_xyzw

All sessions are written in one gravity-aligned frame F, the position and
yaw of the first session's first scan end: where the multi-session recipe
leaves sessions that were relocalized in turn. Each session's poses carry
a seeded error (`prior_error`: one rigid motion a session, a translation
of `t_m` a metre per axis and a yaw of `yaw_deg` degrees, drawn normal;
none for the first session, which defines F); `prior_v6` is the variance
row every scan carries. The edges are those the recipe's earlier runs
would have saved between prior sessions (`prior_edges`): for each pair of
sessions a < b, the keyframe scans of b (every `win_size`-th, as the
loader groups them) whose nearest keyframe scan of a lies within
`radius_m` and turns by under `yaw_deg` from it, every `every`-th of them,
at the true relative pose.

The truth of every prior scan, in F, stays with the writer for the
check: a loop edge into a prior session is held to it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from . import sim

PCD_HEADER = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
              "COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              "POINTS {n}\nDATA binary\n")


@dataclasses.dataclass
class Priors:
    root: str                # the savepath
    names: list
    frame_R: np.ndarray      # F in the scene's frame: x = frame_R x_F
    frame_p: np.ndarray      #   + frame_p
    gt_R: list               # a session: (S, 3, 3) true attitude in F
    gt_p: list               #   and position, at each scan's end
    saved_R: list            # what alidarState.txt holds
    saved_p: list
    points: list             # a session: the points of each scan's file
    edges: list              # (a, b, ord_a, ord_b) of edge.txt
    bytes: int = 0

    def to_frame(self, R, p):
        """Scene-frame attitudes (..., 3, 3) and positions (..., 3) in F."""
        Rt = self.frame_R.T
        return Rt @ np.asarray(R, np.float64), \
            (np.asarray(p, np.float64) - self.frame_p) @ self.frame_R

    def truth(self, s: int, i: int):
        """Prior session s's scan i: its true (R, p) in F, or None."""
        if s >= len(self.gt_p) or not 0 <= i < len(self.gt_p[s]):
            return None
        return self.gt_R[s][i], self.gt_p[s][i]


def named(cell) -> list:
    """The prior sessions the configuration names (`previous_maps`)."""
    return list(cell.config.get("system", {}).get("previous_maps") or [])


def quat_xyzw(R: np.ndarray) -> np.ndarray:
    """A rotation's unit quaternion (x, y, z, w), w >= 0."""
    m = np.asarray(R, np.float64)
    # the largest of 4w^2, 4x^2, 4y^2, 4z^2 sets the divisor (Shepperd)
    d = np.array([m[0, 0] + m[1, 1] + m[2, 2], m[0, 0], m[1, 1], m[2, 2]])
    j = int(np.argmax(d))
    if j == 0:
        s = 2.0 * math.sqrt(1.0 + d[0])
        q = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                      m[1, 0] - m[0, 1], s * s / 4]) / s
    else:
        a, b, c = j - 1, j % 3, (j + 1) % 3
        s = 2.0 * math.sqrt(1.0 + m[a, a] - m[b, b] - m[c, c])
        q = np.zeros(4)
        q[a] = s / 4
        q[b] = (m[b, a] + m[a, b]) / s
        q[c] = (m[c, a] + m[a, c]) / s
        q[3] = (m[c, b] - m[b, c]) / s
    q = q / np.linalg.norm(q)
    return -q if q[3] < 0 else q


def voxel_centroids(pts: np.ndarray, counts: np.ndarray, size: float):
    """Each scan's points (laid end to end, `counts` a scan) downsampled
    to the centroid of each voxel of edge `size`: (points, counts)."""
    scan = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    k = np.floor(pts / size).astype(np.int64) + (1 << 16)
    key = (scan << 51) | (k[:, 0] << 34) | (k[:, 1] << 17) | k[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    n = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    out = np.stack([np.bincount(inv, pts[:, a], len(uniq))
                    for a in range(3)], axis=1) / n[:, None]
    return out, np.bincount(uniq >> 51, minlength=len(counts))


def write_pcd(path: str, pts: np.ndarray) -> int:
    data = np.zeros((len(pts), 4), "<f4")
    data[:, :3] = pts
    head = PCD_HEADER.format(n=len(pts)).encode()
    with open(path, "wb") as f:
        f.write(head)
        f.write(data.tobytes())
    return len(head) + data.nbytes


def state_rows(t, R, p, v, bg, ba, g, v6) -> str:
    """alidarState.txt's rows: t to 6 decimals, the vectors to 7, v6 to 7
    significant digits (the reference's save_pose)."""
    lines = []
    for k in range(len(t)):
        vals = np.concatenate([p[k], quat_xyzw(R[k]), v[k], bg, ba, g])
        lines.append(" ".join([f"{t[k]:.6f}"] + [f"{x:.7f}" for x in vals]
                              + [f"{x:.7g}" for x in v6]))
    return "\n".join(lines) + "\n"


def _yaw(R) -> float:
    return math.atan2(R[1, 0], R[0, 0])


def _rng(seed: int, *key) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)) % (1 << 63), 0x5E55, *key])


def keyframe_edges(gt_R, gt_p, W: int, rule: dict) -> list:
    """`prior_edges`' rule (module docstring): [(a, b, ord_a, ord_b)]."""
    out = []
    for b in range(len(gt_p)):
        kb = np.arange(W - 1, len(gt_p[b]), W)
        for a in range(b):
            ka = np.arange(W - 1, len(gt_p[a]), W)
            if not len(ka):
                continue
            found = []
            for j in kb:
                d = np.linalg.norm(gt_p[a][ka] - gt_p[b][j], axis=1)
                i = ka[int(np.argmin(d))]
                turn = abs(math.remainder(
                    _yaw(gt_R[a][i]) - _yaw(gt_R[b][j]), 2 * math.pi))
                if d.min() < rule["radius_m"] and \
                        math.degrees(turn) < rule["yaw_deg"]:
                    found.append((a, b, int(i), int(j)))
            out += found[::max(1, int(rule["every"]))]
    return out


def write(cell, cfg, seed: int, device, root: str) -> Priors:
    """Write the cell's prior sessions under `root` (see the module
    docstring)."""
    tr = cell.traffic
    names = named(cell)
    specs = tr.get("prior_sessions", [])
    if len(names) != len(specs):
        raise SystemExit(
            f"the configuration names {len(names)} prior sessions "
            f"(previous_maps), the traffic file has {len(specs)} "
            "(prior_sessions)")
    sensor = cell.sensor(cfg)
    scene = sim.scene_from_spec(tr["scene"])
    period = float(sensor["period_s"])
    t0 = float(tr.get("t0_s", 0.1))
    noise = tr["noise"]
    err = tr["prior_error"]
    v6 = np.asarray(tr["prior_v6"], np.float64)
    R_ext = np.asarray(sensor["extrinsic_R"], np.float64).reshape(3, 3)
    t_ext = np.asarray(sensor["extrinsic_t"], np.float64)
    g = sim.GRAVITY_W
    pri = Priors(root=root, names=names, frame_R=np.eye(3),
                 frame_p=np.zeros(3), gt_R=[], gt_p=[], saved_R=[],
                 saved_p=[], points=[], edges=[])
    for i, (name, spec) in enumerate(zip(names, specs)):
        traj = sim.trajectory(spec)
        n = int(spec["scans"])
        t_end = t0 + period * (1 + np.arange(n))
        if t_end[-1] > traj.ts[-1]:
            raise SystemExit(f"prior session {name}: its trajectory ends "
                             f"before scan {n}")
        gi = np.clip(np.searchsorted(traj.ts, t_end), 0, len(traj.ts) - 1)
        if i == 0:
            pri.frame_R = sim.yaw_matrix(_yaw(traj.Rs[gi[0]]))
            pri.frame_p = traj.ps[gi[0]].copy()
        R_f, p_f = pri.to_frame(traj.Rs[gi], traj.ps[gi])
        v_f = traj.vs[gi] @ pri.frame_R
        pri.gt_R.append(R_f)
        pri.gt_p.append(p_f)
        rng = _rng(seed, i)
        eR, et = np.eye(3), np.zeros(3)
        if i > 0:
            eR = sim.yaw_matrix(math.radians(err["yaw_deg"])
                                * rng.standard_normal())
            et = err["t_m"] * rng.standard_normal(3)
        pri.saved_R.append(eR @ R_f)
        pri.saved_p.append(p_f @ eR.T + et)
        bg = rng.normal(0.0, noise["gyr_bias"], 3)
        ba = rng.normal(0.0, noise["acc_bias"], 3)
        pts, _, counts, _ = sim.lidar_scans(
            traj, scene, t_end, t_end, sensor["n_az"], sensor["n_el"],
            sensor["fov_el_deg"], device=device,
            seed=int(rng.integers(1 << 62)), noise=noise["range_std"],
            dropout_at=noise.get("dropout_at"), blind=sensor["blind"],
            filter_num=sensor["point_filter_num"],
            max_range=sensor["max_range"], extrinsic=(R_ext, t_ext))
        body = pts.astype(np.float64) @ R_ext.T + t_ext
        down, dcounts = voxel_centroids(body, counts, cfg.odom.down_size)
        d = os.path.join(root, name)
        os.makedirs(d)
        starts = np.concatenate([[0], np.cumsum(dcounts)])
        for k in range(n):
            pri.bytes += write_pcd(os.path.join(d, f"{k}.pcd"),
                                   down[starts[k]:starts[k + 1]])
        rows = state_rows(t_end, pri.saved_R[i], pri.saved_p[i],
                          v_f @ eR.T, bg, ba, g, v6)
        with open(os.path.join(d, "alidarState.txt"), "w") as f:
            f.write(rows)
        pri.bytes += len(rows)
        pri.points.append(dcounts)
    pri.edges = keyframe_edges(pri.gt_R, pri.gt_p, cfg.lba.win_size,
                               tr["prior_edges"])
    lines = []
    for a, b, ia, ib in pri.edges:
        Ra, Rb = pri.gt_R[a][ia], pri.gt_R[b][ib]
        t = Ra.T @ (pri.gt_p[b][ib] - pri.gt_p[a][ia])
        q = quat_xyzw(Ra.T @ Rb)
        lines.append(" ".join([names[a], names[b], str(ia), str(ib)]
                              + [f"{x:.7f}" for x in np.concatenate([t, q])]))
    text = "".join(line + "\n" for line in lines)
    with open(os.path.join(root, "edge.txt"), "w") as f:
        f.write(text)
    pri.bytes += len(text)
    return pri
