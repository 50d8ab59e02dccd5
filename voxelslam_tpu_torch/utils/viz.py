"""Visualization export — the reference's RViz observability, headless
(port of `voxelslam_tpu/utils/viz.py`, host numpy, copied: the files are
byte-identical to the JAX package's for the same poses).

The reference publishes its state to RViz topics (`ResultOutput`,
voxelslam.cpp:5-155 in the reference tree: /map_scan current deskewed
scan, /map_cmap current-session local map, /map_pmap previous sessions,
/map_path trajectory, TF camera_init->aft_mapped) through a custom
accumulate-until-empty display plugin (VoxelSLAMPointCloud2). There is
no ROS here, so the equivalent is file export + an observer hook:

  * `write_ply` / `write_ply_colored` — standard ASCII/binary-little
    PLY point clouds any viewer opens (CloudCompare, MeshLab, rerun)
  * `export_trajectory` — TUM-format `t x y z qx qy qz qw` poses
    (the standard input for evo/ATE tooling, matching the data the
    reference dumps via alidarState.txt)
  * `export_map` — merged world-frame cloud from ScanPoses, jump-
    subsampled like the reference's pub_pmap (<= max_points per file,
    voxelslam.cpp:121-141)
  * `SlamRecorder` — an observer that mirrors the reference's topic
    set into a directory: per-scan clouds (optional), the running
    trajectory, keyframe submaps, and a session map snapshot on
    `flush()`; `clear()` mirrors the plugin's accumulate-reset contract
    (an empty publish wipes the accumulated display,
    VoxelSLAMPointCloud2/src/voxelslam_pc2.cpp:155-158)
"""

from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def write_ply(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an (N, 3) float cloud as PLY."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(pts)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def write_ply_colored(path: str, points: np.ndarray,
                      colors: np.ndarray) -> None:
    """(N, 3) points + (N, 3) uint8 colors -> binary PLY."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    col = np.asarray(colors, np.uint8).reshape(-1, 3)
    assert len(pts) == len(col)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rec = np.zeros(len(pts),
                   dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = pts
    rec["rgb"] = col
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# Trajectory / map export
# ---------------------------------------------------------------------------

def _rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def export_trajectory(path: str, scan_poses) -> None:
    """TUM format: `t x y z qx qy qz qw` per ScanPose (evo-compatible)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for sp in scan_poses:
            q = _rot_to_quat_xyzw(np.asarray(sp.R))
            p = np.asarray(sp.p)
            f.write(f"{sp.t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def merged_world_cloud(scan_poses, max_points: int = 5_000_000,
                       stride: int = 1) -> np.ndarray:
    """World-frame merged cloud with the reference's jump subsample:
    when the merged size would exceed max_points, points are taken with
    a stride so the output stays bounded (pub_pmap jump logic,
    voxelslam.cpp:121-141)."""
    total = sum(int(np.sum(sp.cloud_mask)) for sp in scan_poses)
    jump = max(stride, int(np.ceil(total / max(max_points, 1))))
    out = []
    for sp in scan_poses:
        m = np.asarray(sp.cloud_mask) > 0
        pts = np.asarray(sp.cloud)[m][::jump]
        out.append(pts @ np.asarray(sp.R).T + np.asarray(sp.p))
    if not out:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(out, axis=0).astype(np.float32)


def export_map(path: str, scan_poses, max_points: int = 5_000_000) -> None:
    write_ply(path, merged_world_cloud(scan_poses, max_points))


_SESSION_COLORS = np.array([
    [230, 90, 60], [70, 150, 230], [90, 200, 120], [240, 200, 70],
    [180, 110, 220], [100, 220, 220], [240, 140, 190], [160, 160, 160],
], np.uint8)


def export_map_sessions(path: str, scan_poses,
                        max_points: int = 5_000_000) -> None:
    """Merged world map colored per session (the reference distinguishes
    current vs previous sessions via /map_cmap vs /map_pmap)."""
    total = sum(int(np.sum(sp.cloud_mask)) for sp in scan_poses)
    jump = max(1, int(np.ceil(total / max(max_points, 1))))
    pts_all, col_all = [], []
    for sp in scan_poses:
        m = np.asarray(sp.cloud_mask) > 0
        pts = np.asarray(sp.cloud)[m][::jump]
        pts_all.append(pts @ np.asarray(sp.R).T + np.asarray(sp.p))
        col = _SESSION_COLORS[sp.session % len(_SESSION_COLORS)]
        col_all.append(np.broadcast_to(col, (len(pts), 3)))
    if not pts_all:
        pts_all, col_all = [np.zeros((0, 3))], [np.zeros((0, 3), np.uint8)]
    write_ply_colored(path, np.concatenate(pts_all),
                      np.concatenate(col_all))


# ---------------------------------------------------------------------------
# Streaming recorder (observer on SlamSystem)
# ---------------------------------------------------------------------------

class SlamRecorder:
    """Mirrors the reference's RViz topic set into files.

    Usage:
        rec = SlamRecorder(outdir, every=10, save_scans=False)
        ... rec.on_scan(system, out) after each process_scan ...
        rec.flush(system)  # end of run: trajectory + session map
    """

    def __init__(self, outdir: str, every: int = 10,
                 save_scans: bool = False):
        self.outdir = outdir
        self.every = max(1, every)
        self.save_scans = save_scans
        self.count = 0
        os.makedirs(outdir, exist_ok=True)

    def clear(self) -> None:
        """Wipe accumulated exports (the plugin's empty-cloud reset)."""
        for name in os.listdir(self.outdir):
            if name.endswith((".ply", ".txt")):
                os.remove(os.path.join(self.outdir, name))

    def on_scan(self, system, out: dict) -> None:
        """Called after each `process_scan`. It reads only host state: the
        emitted ScanPoses hold numpy arrays (the odometry copies each
        scan's pose and cloud off the device once, when it emits it)."""
        self.count += 1
        if out.get("phase") not in ("odom", "init_done"):
            return
        if self.save_scans and system.scan_poses:
            sp = system.scan_poses[-1]
            m = np.asarray(sp.cloud_mask) > 0
            wld = np.asarray(sp.cloud)[m] @ np.asarray(sp.R).T \
                + np.asarray(sp.p)
            write_ply(os.path.join(self.outdir,
                                   f"scan_{self.count:06d}.ply"), wld)
        if self.count % self.every == 0:
            export_trajectory(os.path.join(self.outdir, "trajectory.txt"),
                              system.scan_poses)

    def flush(self, system) -> None:
        export_trajectory(os.path.join(self.outdir, "trajectory.txt"),
                          system.scan_poses)
        export_map_sessions(os.path.join(self.outdir, "map.ply"),
                            system.scan_poses)
