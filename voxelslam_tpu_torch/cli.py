"""Command-line entry point — the reference's executable + launch files
(port of `voxelslam_tpu/cli.py`; run as `python -m voxelslam_tpu_torch`).

The reference ships a single ROS node `voxelslam` started through six
launch files (`launch/vxlm_*.launch` reading `config/*.yaml`, reference
voxelslam.cpp:3144-3170 `main`), driven by rosbag playback and finished
with `rosparam set finish true`. This module is the equivalent on a GPU:
a dataset-directory runner around `SlamSystem` with the same six sensor
presets, session persistence, and the finish/GBA phase as an explicit
step instead of a runtime flag. `run` and `demo` take `--device`
(default `cuda`; without a card they exit with `resolve_device`'s error
unless `--device cpu` is given).

Subcommands
-----------
  run     process a recorded dataset directory (scans + imu.txt)
  demo    run the built-in simulator end-to-end (no data needed)
  export  convert a saved session to PLY map / TUM trajectory
  info    list sensor presets or show one preset's full config

Dataset directory layout for `run` (a minimal, ROS-free capture format;
one file per scan keeps host IO overlappable with device compute):

  imu.txt           rows: t gx gy gz ax ay az   (SI units, seconds)
  scans.txt         rows: t_beg t_end filename
  <filename>.npy    either a structured array (vendor point layout, fed
                    through io.decoders.decode with --lidar-type) or a
                    plain (N, 3)/(N, 4) float array of x y z [t_offset]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


# ---------------------------------------------------------------------------
# dataset reading
# ---------------------------------------------------------------------------

def _load_scan_file(path: str, lidar_type: str, blind: float,
                    point_filter_num: int):
    """One scan file -> dict(points, offsets) in the decoders' form."""
    from .io import decoders
    arr = np.load(path, allow_pickle=False)
    if arr.dtype.names:  # vendor structured layout
        return decoders.decode(arr, lidar_type, blind=blind,
                               point_filter_num=point_filter_num)
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2 or arr.shape[1] not in (3, 4):
        raise ValueError(f"{path}: expected (N,3) or (N,4) array, "
                         f"got {arr.shape}")
    offs = arr[:, 3] if arr.shape[1] == 4 else np.zeros(len(arr), np.float32)
    keep = (arr[:, :3] ** 2).sum(-1) > blind * blind
    idx = np.where(keep)[0][::max(1, point_filter_num)]
    order = np.argsort(offs[idx], kind="stable")
    return dict(points=arr[idx][order, :3], offsets=offs[idx][order])


def iter_dataset(dirpath: str, lidar_type: str, blind: float = 0.5,
                 point_filter_num: int = 1, use_native: bool = True,
                 point_notime: bool = False):
    """Yield synchronized packets (scan + covering IMU samples) from a
    dataset directory, pairing with the reference's sync_packages
    semantics (voxelslam.hpp:112-177).

    When the sensor type has a native loader plan (native.LOADER_PLANS),
    scan files are read/decoded ahead by a C++ prefetch thread
    (native.ScanLoader) so host IO overlaps device compute; the other
    types (velodyne) and `use_native=False` load files inline. The
    native library is built with g++ at first use; a failed build
    raises."""
    from . import native
    from .io.decoders import sync_packages
    imu = np.loadtxt(os.path.join(dirpath, "imu.txt"), ndmin=2)
    imu_queue = [(row[0], row[1:4].copy(), row[4:7].copy()) for row in imu]

    scan_rows = []
    with open(os.path.join(dirpath, "scans.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                scan_rows.append((float(parts[0]), float(parts[1]),
                                  parts[2]))
    scan_rows.sort()

    if use_native and lidar_type.lower() in native.LOADER_PLANS:
        scans = native.ScanLoader(
            [(tb, te, os.path.join(dirpath, fn)) for tb, te, fn in scan_rows],
            lidar_type, blind=blind, point_filter_num=point_filter_num)
    else:
        scans = (dict(_load_scan_file(os.path.join(dirpath, fname),
                                      lidar_type, blind, point_filter_num),
                      t_beg=t_beg, t_end=t_end)
                 for t_beg, t_end, fname in scan_rows)

    scan_queue = []
    nt_state: dict = {}
    try:
        for scan in scans:
            scan_queue.append(scan)
            while True:
                pkt = sync_packages(scan_queue, imu_queue,
                                    point_notime=point_notime,
                                    state=nt_state)
                if pkt is None:
                    break
                yield pkt
    finally:
        scans.close()


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _build_config(args):
    from .config import preset, small_test_config, override, SlamConfig
    if getattr(args, "tiny", False):
        cfg = small_test_config()
    elif args.preset == "default":
        cfg = SlamConfig()
    else:
        cfg = preset(args.preset)
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = override(cfg, json.load(f))
    if getattr(args, "lidar_type", None):
        cfg = dataclasses.replace(cfg, lidar_type=args.lidar_type)
    return cfg


def _make_system(cfg, args):
    from .pipeline.system import SlamSystem
    prev = [s for s in (args.previous_maps or "").split(",") if s]
    return SlamSystem(cfg, enable_loop=not args.no_loop,
                      enable_gba=args.gba,
                      previous_maps=prev or None,
                      savepath=args.save_dir, device=args.device)


def _finish_and_export(system, args, log):
    poses = system.finish()
    log(f"finished: {len(poses)} scan poses, "
        f"{system.corrections} loop corrections")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        system.save(args.session_name)
        log(f"session saved under {args.save_dir}")
    from .utils import viz
    if args.export_traj:
        all_poses = _all_session_poses(system)
        viz.export_trajectory(args.export_traj, all_poses)
        log(f"trajectory -> {args.export_traj}")
    if args.export_map:
        all_poses = _all_session_poses(system)
        viz.export_map(args.export_map, all_poses,
                       max_points=args.max_map_points)
        log(f"map -> {args.export_map}")
    return poses


def _all_session_poses(system):
    if system.loop is not None:
        out = []
        for sps in system.loop.scan_poses:
            out.extend(sps)
        if out:
            return out
    return system.odom.scan_poses


def cmd_run(args, log):
    cfg = _build_config(args)
    system = _make_system(cfg, args)
    n = 0
    for pkt in iter_dataset(args.dataset, cfg.lidar_type,
                            blind=args.blind,
                            point_filter_num=args.point_filter_num,
                            point_notime=cfg.odom.point_notime):
        scan = pkt["scan"]
        out = system.process_scan(scan["points"], scan["offsets"],
                                  pkt["imu_ts"], pkt["imu_gyr"],
                                  pkt["imu_acc"], scan["t_beg"],
                                  scan["t_end"])
        n += 1
        if args.verbose and out.get("phase") not in (None, "odom"):
            log(f"scan {n}: {out}")
        if args.max_scans and n >= args.max_scans:
            break
    log(f"processed {n} scans")
    _finish_and_export(system, args, log)
    return 0


def cmd_demo(args, log):
    from .io import simulator as sim
    cfg = _build_config(args)
    system = _make_system(cfg, args)

    scan_hz, imu_hz = 10.0, 200.0
    duration = 0.3 + args.scans / scan_hz
    traj = sim.make_trajectory(duration=duration + 0.5, speed=args.speed,
                               wobble=0.25, yaw_rate=0.3, still=0.45)
    normals, dsp = sim.box_room(half_extent=(14.0, 12.0, 3.5),
                                center=(4.0, 0.0, 1.0))
    t, k = 0.2, 0
    while k < args.scans:
        t_beg, t_end = t, t + 1.0 / scan_hz
        scan = sim.lidar_scan(traj, t_beg, t_end, normals, dsp,
                              n_az=args.n_az, n_el=args.n_el,
                              noise=0.01, seed=k)
        hit = scan["hit"]
        ts = np.arange(t_beg - 0.01, t_end + 1e-6, 1.0 / imu_hz)
        gyr = np.empty((len(ts), 3))
        acc = np.empty((len(ts), 3))
        for i, ti in enumerate(ts):
            gyr[i], acc[i] = traj.imu_at(ti)
        out = system.process_scan(scan["points"][hit],
                                  scan["offsets"][hit],
                                  ts, gyr, acc, t_beg, t_end)
        if args.verbose and out.get("phase") not in (None, "odom"):
            log(f"scan {k}: {out}")
        t = t_end
        k += 1
    poses = _finish_and_export(system, args, log)
    # report ATE against the simulator's exact ground truth
    if poses:
        est = np.stack([sp.p for sp in poses])
        gt = np.stack([traj.state_at(sp.t)[1] for sp in poses])
        from .utils.metrics import ate_rmse
        log(f"ATE RMSE vs ground truth: {ate_rmse(est, gt):.4f} m")
    return 0


def cmd_export(args, log):
    from .io import sessions as ses
    from .utils import viz
    poses = ses.load_session(args.session)
    log(f"loaded {len(poses)} scan poses from {args.session}")
    if args.export_traj:
        viz.export_trajectory(args.export_traj, poses)
        log(f"trajectory -> {args.export_traj}")
    if args.export_map:
        viz.export_map(args.export_map, poses,
                       max_points=args.max_map_points)
        log(f"map -> {args.export_map}")
    return 0


def cmd_info(args, log):
    from .config import _PRESETS
    if not args.preset:
        for name in sorted(_PRESETS):
            log(name)
        return 0
    cfg = _PRESETS[args.preset]
    log(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    return 0


# ---------------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------------

def _add_common(p):
    p.add_argument("--preset", default="hesai",
                   help="sensor preset (see `info`)")
    p.add_argument("--tiny", action="store_true",
                   help="small test config (CI / smoke runs)")
    p.add_argument("--config", default=None,
                   help="JSON file of nested config overrides "
                        "(applied over the preset)")
    p.add_argument("--lidar-type", default=None,
                   help="override the preset's lidar type")
    p.add_argument("--no-loop", action="store_true",
                   help="disable loop closure / multi-session")
    p.add_argument("--gba", action="store_true",
                   help="enable hierarchical global BA")
    p.add_argument("--save-dir", default=None,
                   help="session save directory (enables persistence)")
    p.add_argument("--session-name", default=None)
    p.add_argument("--previous-maps", default=None,
                   help="comma-separated prior session names to load")
    p.add_argument("--export-map", default=None, help="write PLY map")
    p.add_argument("--export-traj", default=None,
                   help="write TUM trajectory")
    p.add_argument("--max-map-points", type=int, default=5_000_000)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="voxelslam-tpu-torch",
        description="LiDAR-inertial SLAM in PyTorch on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="process a dataset directory")
    p.add_argument("dataset", help="dataset directory (see module doc)")
    p.add_argument("--blind", type=float, default=0.5)
    p.add_argument("--point-filter-num", type=int, default=1)
    p.add_argument("--max-scans", type=int, default=0)
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("demo", help="simulated end-to-end run")
    p.add_argument("--scans", type=int, default=40)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--n-az", type=int, default=110)
    p.add_argument("--n-el", type=int, default=12)
    _add_common(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("export", help="export a saved session")
    p.add_argument("session", help="saved session directory")
    p.add_argument("--export-map", default=None)
    p.add_argument("--export-traj", default=None)
    p.add_argument("--max-map-points", type=int, default=5_000_000)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("info", help="list / show sensor presets")
    p.add_argument("preset", nargs="?", default=None)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None, log=print):
    args = build_parser().parse_args(argv)
    return args.fn(args, log)


if __name__ == "__main__":
    sys.exit(main())
