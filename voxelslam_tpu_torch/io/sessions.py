"""Session persistence (port of `voxelslam_tpu/io/sessions.py`; the
reference's FileReaderWriter, voxelslam.cpp:157-457), byte-compatible with
the reference's files and the JAX package's:

  * per-scan binary PCD `N.pcd` with the scan's downsampled body-frame
    cloud (save_pcd, :166-179)
  * 26-column `alidarState.txt`: t p(3) q_xyzw(4) v(3) bg(3) ba(3) g(3)
    v6(6) (save_pose :181-204, read_lidarstate voxelslam.hpp:268-306)
  * the multi-session loop-edge file `edge.txt`:
    name_a name_b id_a id_b t(3) q_xyzw(4) (pgo_edges_io :207-279)
  * offline multi-session load: scans -> win_size keyframes (merged into
    the last scan's frame, downsampled at voxel_size/10) -> BTC
    descriptors over acsize-keyframe accumulations with stride mgsize,
    near-frame suppression off for prior sessions (previous_map_read
    :310-457).

The files are written and read with numpy on the host; the keyframe
downsample and the descriptor extraction of `load_previous_sessions` run
as torch ops on the loop pipeline's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PCD_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS x y z intensity
SIZE 4 4 4 4
TYPE F F F F
COUNT 1 1 1 1
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA binary
"""


def write_pcd(path: str, points: np.ndarray,
              intensity: np.ndarray | None = None):
    """Binary PCD (x y z intensity float32), the layout the reference
    writes via pcl::io::savePCDFileBinary (voxelslam.cpp:178)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    inten = (np.zeros(len(pts), np.float32) if intensity is None
             else np.asarray(intensity, np.float32))
    data = np.concatenate([pts, inten[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(PCD_HEADER.format(n=len(pts)).encode())
        f.write(data.astype("<f4").tobytes())


def read_pcd(path: str):
    """Reads binary or ascii PCD; returns (points (N,3), intensity (N,))."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.find(b"DATA")
    header = raw[:head_end].decode(errors="replace")
    fields, sizes, types, counts, n = [], [], [], [], 0
    for line in header.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "FIELDS":
            fields = tok[1:]
        elif tok[0] == "SIZE":
            sizes = [int(x) for x in tok[1:]]
        elif tok[0] == "TYPE":
            types = tok[1:]
        elif tok[0] == "COUNT":
            counts = [int(x) for x in tok[1:]]
        elif tok[0] == "POINTS":
            n = int(tok[1])
    data_line_end = raw.find(b"\n", head_end) + 1
    mode = raw[head_end:data_line_end].split()[1].decode()
    tmap = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "<u1",
            ("U", 2): "<u2", ("U", 4): "<u4", ("I", 1): "<i1",
            ("I", 2): "<i2", ("I", 4): "<i4"}
    dt = np.dtype([
        (name, tmap[(types[i], sizes[i])],
         (counts[i],) if counts[i] > 1 else ())
        for i, name in enumerate(fields)])
    if mode == "binary":
        arr = np.frombuffer(raw[data_line_end:data_line_end
                                + n * dt.itemsize], dtype=dt, count=n)
    elif mode == "ascii":
        arr = np.loadtxt(raw[data_line_end:].decode().splitlines(),
                         dtype=np.float64).reshape(n, -1)
        arr = np.rec.fromarrays([arr[:, i] for i in range(len(fields))],
                                names=fields)
    else:
        raise ValueError(f"unsupported PCD data mode {mode}")
    pts = np.stack([np.asarray(arr["x"], np.float64),
                    np.asarray(arr["y"], np.float64),
                    np.asarray(arr["z"], np.float64)], -1)
    inten = (np.asarray(arr["intensity"], np.float64)
             if "intensity" in fields else np.zeros(len(pts)))
    return pts.astype(np.float32), inten.astype(np.float32)


# -- alidarState.txt ---------------------------------------------------------

def _rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion in (x, y, z, w) order, as the
    reference writes Eigen::Quaterniond components."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def _quat_xyzw_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def write_lidarstate(path: str, scan_poses) -> None:
    """26-column state file (reference save_pose, voxelslam.cpp:181-204)."""
    with open(path, "w") as f:
        for sp in scan_poses:
            q = _rot_to_quat_xyzw(np.asarray(sp.R, np.float64))
            row = ([f"{sp.t:.6f}"]
                   + [f"{v:.7f}" for v in np.asarray(sp.p)]
                   + [f"{v:.7f}" for v in q]
                   + [f"{v:.7f}" for v in np.asarray(sp.v)]
                   + [f"{v:.7f}" for v in np.asarray(sp.bg)]
                   + [f"{v:.7f}" for v in np.asarray(sp.ba)]
                   + [f"{v:.7f}" for v in np.asarray(sp.g)]
                   + [f"{v:.7g}" for v in np.asarray(sp.v6)])
            f.write(" ".join(row) + "\n")


def read_lidarstate(path: str) -> list:
    """alidarState.txt rows as ScanPose objects (clouds empty); the
    reference's short 8-column rows are read too (voxelslam.hpp:268-306)."""
    from ..pipeline.odometry import ScanPose
    out = []
    with open(path) as f:
        for line in f:
            nums = [float(x) for x in line.split()]
            if len(nums) < 8:
                continue
            sp = ScanPose(
                t=nums[0], R=_quat_xyzw_to_rot(np.array(nums[4:8])),
                p=np.array(nums[1:4]), v=np.zeros(3),
                v6=np.full(6, 1e-4),
                cloud=np.zeros((0, 3), np.float32),
                cloud_mask=np.zeros((0,), np.float32), session=0)
            if len(nums) >= 20:
                sp.v = np.array(nums[8:11])
                sp.bg = np.array(nums[11:14])
                sp.ba = np.array(nums[14:17])
                sp.g = np.array(nums[17:20])
            if len(nums) >= 26:
                sp.v6 = np.array(nums[20:26])
            out.append(sp)
    return out


# -- session save/load -------------------------------------------------------

def save_session(dirpath: str, scan_poses) -> None:
    """One session directory: alidarState.txt + per-scan N.pcd (the
    reference's is_save_map path, voxelslam.cpp:2007-2011, 2693-2699)."""
    os.makedirs(dirpath, exist_ok=True)
    write_lidarstate(os.path.join(dirpath, "alidarState.txt"), scan_poses)
    for i, sp in enumerate(scan_poses):
        m = np.asarray(sp.cloud_mask) > 0
        write_pcd(os.path.join(dirpath, f"{i}.pcd"),
                  np.asarray(sp.cloud)[m])


def load_session(dirpath: str) -> list:
    """A session directory read back: ScanPoses with body-frame clouds."""
    sps = read_lidarstate(os.path.join(dirpath, "alidarState.txt"))
    for i, sp in enumerate(sps):
        pcd = os.path.join(dirpath, f"{i}.pcd")
        if os.path.exists(pcd):
            pts, _ = read_pcd(pcd)
            sp.cloud = pts
            sp.cloud_mask = np.ones(len(pts), np.float32)
    return sps


# -- edge.txt ----------------------------------------------------------------

def write_edges(path: str, edges, session_names: list[str],
                extra_lines: list[str] = ()) -> None:
    """edge.txt writer (reference pgo_edges_io write branch,
    voxelslam.cpp:259-278). Each line:
    name_a name_b ord_a ord_b tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for line in extra_lines:
            f.write(line.rstrip("\n") + "\n")
        for e in edges:
            q = _rot_to_quat_xyzw(np.asarray(e.R, np.float64))
            t = np.asarray(e.t, np.float64)
            f.write(f"{session_names[e.id_a]} {session_names[e.id_b]} "
                    f"{e.ord_a} {e.ord_b} "
                    f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def read_edges(path: str, session_names: list[str]):
    """edge.txt reader (reference pgo_edges_io read branch,
    voxelslam.cpp:210-255). Returns (edges, absent_lines): the edges whose
    two session names are known (turned so id_a <= id_b, as the reference
    flips them), and the raw lines naming unknown sessions (kept for the
    next write)."""
    from ..pipeline.loop import LoopEdge
    edges, absent = [], []
    if not os.path.exists(path):
        return edges, absent
    name_to_id = {n: i for i, n in enumerate(session_names)}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 11:
                continue
            a, b = name_to_id.get(tok[0]), name_to_id.get(tok[1])
            if a is None or b is None:
                absent.append(line.rstrip("\n"))
                continue
            o1, o2 = int(tok[2]), int(tok[3])
            t = np.array([float(x) for x in tok[4:7]])
            R = _quat_xyzw_to_rot(np.array([float(x) for x in tok[7:11]]))
            if a > b:
                a, b, o1, o2 = b, a, o2, o1
                t = -R.T @ t
                R = R.T
            edges.append(LoopEdge(id_a=a, id_b=b, ord_a=o1, ord_b=o2,
                                  R=R, t=t, v6=np.full(6, 1e-6)))
    return edges, absent


# -- offline multi-session load ---------------------------------------------

def load_previous_sessions(loop_pipeline, savepath: str,
                           names: list[str],
                           juds: list[float] | None = None) -> None:
    """The reference's `previous_map_read` (voxelslam.cpp:310-457): for
    each prior session directory, rebuild its win_size-scan keyframes and
    BTC descriptor database and install them as searchable sessions of
    the loop pipeline (before the live session is opened); then restore
    the cross-session edges of edge.txt."""
    from ..pipeline.loop import Keyframe
    from ..loop.btc import extract as btc_extract
    from ..ops.downsample import voxel_downsample

    cfg = loop_pipeline.cfg
    W = cfg.lba.win_size
    acsize = cfg.loop.acsize
    mgsize = cfg.loop.mgsize
    P = loop_pipeline.kf_point_max
    dev = loop_pipeline.device
    vs = max(cfg.map.voxel_size / 10.0, 0.05)

    def down_np(flat, fmask):
        down, dmask, _ = voxel_downsample(
            torch.as_tensor(flat, device=dev),
            torch.as_tensor(fmask, device=dev), vs, P)
        return down, dmask.to(torch.float32)

    for fn, name in enumerate(names):
        sid = loop_pipeline.new_session(
            jud=None if juds is None else juds[fn])
        sps = load_session(os.path.join(savepath, name))
        for sp in sps:
            sp.session = sid
        loop_pipeline.scan_poses[sid].extend(sps)
        kfs = loop_pipeline.keyframes[sid]

        # scans -> keyframes: each win_size group merged into its last
        # scan's body frame, downsampled at voxel_size/10 (:335-379)
        for base in range(0, len(sps) - W + 1, W):
            xc = sps[base + W - 1]
            pts = []
            for j in range(base, base + W):
                sp = sps[j]
                if len(sp.cloud) == 0:
                    continue
                dR = xc.R.T @ sp.R
                dp = xc.R.T @ (sp.p - xc.p)
                pts.append(sp.cloud @ dR.T + dp)
            if not pts:
                continue
            flat = np.concatenate(pts).astype(np.float32)
            down, dmask = down_np(flat, np.ones(len(flat), np.float32))
            kfs.append(Keyframe(
                kf_index=len(kfs), scan_id=base + W - 1, session=sid,
                R0=np.asarray(xc.R), p0=np.asarray(xc.p),
                cloud=down.cpu().numpy(), mask=dmask.cpu().numpy(),
                jour=0.0))

        # keyframes -> BTC database over acsize-accumulations (:384-410);
        # prior sessions have near-frame suppression off (the search uses
        # skip=-1 for tid != current session)
        db = loop_pipeline.dbs[sid]
        step = max(mgsize, 1)
        for i in range(0, max(len(kfs) - acsize, 0) + 1, step):
            up = min(i + acsize, len(kfs))
            if up - i < 1:
                continue
            xc = kfs[up - 1]
            pts, msk = [], []
            for j in range(i, up):
                kf = kfs[j]
                dR = xc.R0.T @ kf.R0
                dp = xc.R0.T @ (kf.p0 - xc.p0)
                pts.append(kf.cloud @ dR.T + dp)
                msk.append(kf.mask)
            down, dmask = down_np(np.concatenate(pts).astype(np.float32),
                                  np.concatenate(msk).astype(np.float32))
            desc = btc_extract(down, dmask, loop_pipeline.btc_cfg)
            db.add(up - 1, {k: v.cpu().numpy() for k, v in desc.items()})

    # restore the cross-session loop edges
    edges, absent = read_edges(os.path.join(savepath, "edge.txt"), names)
    loop_pipeline.lp_edges.extend(edges)
    loop_pipeline._edge_absent_lines = absent
