"""Typed configuration tree (a copy of `voxelslam_tpu/config.py`).

Mirrors the reference's five rosparam namespaces (General / Odometry /
LocalBA / Loop / GBA, read at voxelslam.cpp:875-928, 2171-2178, 3020-3026
in the reference tree) as frozen dataclasses, plus static capacities
(table sizes, pad sizes) that fix all tensor shapes. Kept as a copy so
the PyTorch port imports nothing of the JAX package; the comments on
TPU costs below are the JAX package's measurements, kept with the knobs
they explain.

Sensor presets mirroring config/{avia,avia_fly,hesai,ouster,velodyne,
mid360}.yaml are provided by `preset()`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MapConfig:
    voxel_size: float = 1.0
    max_layer: int = 2                      # levels = max_layer + 1
    capacities: Tuple[int, ...] = (1 << 15, 1 << 16, 1 << 17)
    win_size: int = 10
    min_point: Tuple[int, ...] = (5, 5, 5)  # per layer (voxelslam.cpp:917)
    min_eigen_value: float = 0.0025         # Odometry/LocalBA plane gate
    plane_thr: Tuple[float, ...] = (0.25, 0.25, 0.25)  # lam0/lam2 per layer
    max_points: int = 100                   # fixed-point cap per voxel
    # (the reference's LocalBA/min_ba_point rosparam is read but its only
    # use is commented out, voxel_map.hpp:1783 — intentionally absent)
    unique_max: Tuple[int, ...] = (4096, 8192, 16384)  # per-level cap on unique voxels touched per scan
    eig_ratio_ba: float = 0.12              # tras_opt gate (voxel_map.hpp:1615)
    evict_dist: float = 700.0               # jour-distance eviction (voxelslam.cpp:1806)
    evict_check_every: int = 100            # scans between load-factor checks
    evict_load: float = 0.4                 # table load factor triggering eviction
    # touched-slot tracking (sparse marginalize fold). OFF by default:
    # on TPU the flat row-scatters it needs measured ~2x the whole
    # megastep vs the contiguous dense-column path (r04 bench) — keep
    # the machinery for hosts/backends where scatters are cheap
    track_touched: bool = False

    @property
    def levels(self) -> int:
        return self.max_layer + 1

    def level_size(self, l: int) -> float:
        return self.voxel_size / (2.0 ** l)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    max_iter: int = 4
    point_max: int = 8192                  # padded points per scan
    imu_max: int = 64                      # padded IMU samples per scan
    down_size: float = 0.5                 # odometry voxel downsample
    dept_err: float = 0.02                 # range sigma (m)
    beam_err: float = 0.05                 # bearing sigma (rad-ish)
    cov_gyr: float = 0.1
    cov_acc: float = 0.1
    cov_bias_gyr: float = 1e-4
    cov_bias_acc: float = 1e-4
    degrade_eig: float = 14.0              # normal-Gram gate (voxelslam.cpp:1094)
    degrade_bound: int = 10
    blind: float = 0.5                     # min range
    point_filter_num: int = 1
    point_notime: bool = False
    # scans whose packed stats accumulate in an on-device ring before ONE
    # device->host fetch, made after the next scan was dispatched. Used
    # by the step a scan when per-scan clouds are not collected (loop
    # disabled) and batch_scans is 1 or lba.mgsize > 1; bookkeeping (pose
    # emission, divergence hysteresis) then lags <= ring + 1 scans, well
    # under degrade_bound. The K-step call reads its own rows instead.
    stats_ring: int = 4
    # scans fused into ONE device call in the steady phase (the JAX
    # package's lax.scan over the megastep body; here one graph replay):
    # amortizes the host's per-call launch cost. The call reads its K
    # stats rows in one device->host copy, which waits for its replay,
    # and emits them before it returns, so emission/divergence
    # bookkeeping lags <= batch_scans - 1 scans (the queue). 1 = dispatch
    # per scan. Only active in the steady phase with lba.mgsize == 1 and
    # per-scan clouds not collected.
    batch_scans: int = 4


@dataclasses.dataclass(frozen=True)
class LocalBAConfig:
    win_size: int = 10
    mgsize: int = 1                        # frames marginalized per slide
    max_iter: int = 3
    imu_coef: float = 1e-4                 # voxel_map.hpp:500
    noise_gyr: float = 0.1                 # preintegration measurement noise
    noise_acc: float = 0.1
    walk_gyr: float = 1e-4
    walk_acc: float = 1e-4
    factor_max: int = 4096                 # harvested plane factors cap


@dataclasses.dataclass(frozen=True)
class InitConfig:
    min_imu_num: int = 30
    max_rounds: int = 10
    min_eigen_value: float = 0.02          # relaxed init map (voxelslam.cpp:628)
    plane_thr: float = 0.25
    converge_thre: float = 0.05
    gravity_prior_weight: float = 10.0   # soft |g|=9.81 prior in init BA
    degeneracy_eig: float = 15.0           # voxelslam.cpp:746
    gravity_norm_lo: float = 9.6           # voxelslam.cpp:766
    gravity_norm_hi: float = 10.0


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    jud_default: float = 0.4
    icp_eigval: float = 14.0
    ratio_drift: float = 0.05
    curr_halt: int = 10
    prev_halt: int = 20
    acsize: int = 2
    mgsize: int = 1
    is_high_fly: bool = False
    descriptor_near_num: int = 20
    candidate_num: int = 20                # BTC candidate frames verified
                                           # (BTC.cpp:31; fly profile 100)


@dataclasses.dataclass(frozen=True)
class GBAConfig:
    voxel_size: float = 4.0
    min_eigen_value: float = 0.02
    eigen_value_thr: float = 0.25
    total_max_iter: int = 10
    win_size: int = 10
    stride: int = 5


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    map: MapConfig = MapConfig()
    odom: OdometryConfig = OdometryConfig()
    lba: LocalBAConfig = LocalBAConfig()
    init: InitConfig = InitConfig()
    loop: LoopConfig = LoopConfig()
    gba: GBAConfig = GBAConfig()
    lidar_type: str = "livox"
    extrinsic_R: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    extrinsic_t: Tuple[float, ...] = (0.0, 0.0, 0.0)


# Per-sensor presets with numeric parity to the reference YAMLs
# (config/{avia,avia_fly,hesai,mid360,ouster,velodyne}.yaml). The
# reference stores plane_eigen_value_thre as reciprocals
# (voxelslam.cpp:930-931): thre=[4,..] -> ratio gate lam0/lam2 < 1/4.
_PRESETS = {
    # config/avia.yaml — handheld Livox Avia (campus / elevator seq)
    "avia": SlamConfig(
        map=MapConfig(voxel_size=1.0, min_eigen_value=0.0025,
                      plane_thr=(0.25, 0.25, 0.25)),
        odom=OdometryConfig(cov_gyr=0.1, cov_acc=1.0, down_size=0.1,
                            dept_err=0.02, beam_err=0.05,
                            degrade_bound=10, blind=0.5,
                            point_filter_num=3),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=1.0,
                          imu_coef=1e-4),
        loop=LoopConfig(jud_default=0.5, icp_eigval=10.0,
                        ratio_drift=0.01, curr_halt=10, prev_halt=10,
                        acsize=2, mgsize=2),
        gba=GBAConfig(voxel_size=2.0, min_eigen_value=0.1,
                      eigen_value_thr=0.25, total_max_iter=6),
        lidar_type="livox",
        extrinsic_t=(0.04165, 0.02326, -0.0284),
    ),
    # config/mid360.yaml — Livox Mid-360
    "mid360": SlamConfig(
        map=MapConfig(voxel_size=1.0, min_eigen_value=0.0025,
                      plane_thr=(0.25, 0.25, 0.25)),
        odom=OdometryConfig(cov_gyr=0.1, cov_acc=1.0, down_size=0.1,
                            dept_err=0.02, beam_err=0.05,
                            degrade_bound=10, blind=0.5,
                            point_filter_num=3),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=2.0, imu_coef=2e-4),
        loop=LoopConfig(jud_default=0.45, icp_eigval=9.0,
                        ratio_drift=0.01),
        gba=GBAConfig(voxel_size=2.0, min_eigen_value=0.01,
                      eigen_value_thr=0.25, total_max_iter=6),
        lidar_type="livox",
        extrinsic_t=(-0.011, -0.02329, 0.04412),
    ),
    # config/hesai.yaml — HILTI Hesai PandarXT-32 handheld (multi-session)
    "hesai": SlamConfig(
        map=MapConfig(voxel_size=1.0, min_eigen_value=0.0025,
                      plane_thr=(1.0, 1.0, 1.0)),
        odom=OdometryConfig(cov_gyr=0.01, cov_acc=1.0, down_size=0.1,
                            dept_err=0.01, beam_err=0.01,
                            degrade_bound=100, blind=0.7,
                            point_filter_num=1),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=1.0,
                          imu_coef=2.5e-5),
        loop=LoopConfig(jud_default=0.5, icp_eigval=10.0,
                        ratio_drift=0.01, curr_halt=10, prev_halt=10,
                        acsize=10, mgsize=5),
        gba=GBAConfig(voxel_size=1.0, min_eigen_value=0.01,
                      eigen_value_thr=0.5, total_max_iter=3),
        lidar_type="hesai",
        extrinsic_R=(0, -1, 0, -1, 0, 0, 0, 0, -1),
        extrinsic_t=(-0.001, -0.00855, 0.055),
    ),
    # config/ouster.yaml — Newer College OS1 (max_layer 1)
    "ouster": SlamConfig(
        map=MapConfig(voxel_size=2.0, max_layer=1, min_eigen_value=0.01,
                      plane_thr=(0.25, 0.25), min_point=(5, 5),
                      capacities=(1 << 15, 1 << 16),
                      unique_max=(4096, 8192)),
        odom=OdometryConfig(cov_gyr=0.01, cov_acc=1.0, down_size=0.4,
                            dept_err=0.01, beam_err=0.01,
                            degrade_bound=100, blind=1.0,
                            point_filter_num=3),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=1.0, imu_coef=2e-4),
        loop=LoopConfig(jud_default=0.5, icp_eigval=9.0,
                        ratio_drift=0.01, curr_halt=10, prev_halt=10,
                        acsize=2, mgsize=2),
        gba=GBAConfig(voxel_size=2.0, min_eigen_value=0.01,
                      eigen_value_thr=0.25, total_max_iter=6),
        lidar_type="ouster",
        extrinsic_R=(-1, 0, 0, 0, -1, 0, 0, 0, 1),
        extrinsic_t=(0.0, 0.0, 0.0285),
    ),
    # config/velodyne.yaml — UrbanNav VLP-16
    "velodyne": SlamConfig(
        map=MapConfig(voxel_size=2.0, min_eigen_value=0.01,
                      plane_thr=(0.25, 0.25, 0.25)),
        odom=OdometryConfig(cov_gyr=0.01, cov_acc=1.0, down_size=0.25,
                            dept_err=0.01, beam_err=0.01,
                            degrade_bound=100, blind=2.8,
                            point_filter_num=3),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=1.0, imu_coef=1e-4),
        loop=LoopConfig(jud_default=0.45, icp_eigval=15.0,
                        ratio_drift=0.01, curr_halt=10, prev_halt=10,
                        acsize=2, mgsize=2),
        gba=GBAConfig(voxel_size=2.0, min_eigen_value=0.01,
                      eigen_value_thr=1.0 / 9.0, total_max_iter=3),
        lidar_type="velodyne",
        extrinsic_t=(0.0, 0.0, 0.28),
    ),
    # config/avia_fly.yaml — MARS aerial: big voxels, high-fly profile
    "avia_fly": SlamConfig(
        map=MapConfig(voxel_size=4.0, min_eigen_value=0.01,
                      plane_thr=(0.25, 0.25, 0.25)),
        odom=OdometryConfig(cov_gyr=0.01, cov_acc=1.0, down_size=0.5,
                            dept_err=0.01, beam_err=0.01,
                            degrade_bound=100, blind=0.5,
                            point_filter_num=3),
        lba=LocalBAConfig(noise_gyr=0.01, noise_acc=1.0, imu_coef=1e-4),
        # jud 0.5: aerial scenes are horizontal-plane dominated (ground
        # + roofs), so random inter-place transforms reach plane-overlap
        # ~0.46 (bench_btc novel queries) while true revisits score
        # >=0.53 — the accept gate sits between (bench_btc r5 P=1.0)
        loop=LoopConfig(jud_default=0.5, icp_eigval=9.0,
                        ratio_drift=0.01, curr_halt=10, prev_halt=10,
                        acsize=2, mgsize=2, is_high_fly=True,
                        candidate_num=100),   # aerial budget, BTC.cpp:62
        gba=GBAConfig(voxel_size=15.0, min_eigen_value=10.0,
                      eigen_value_thr=0.5, total_max_iter=10),
        lidar_type="livox",
        extrinsic_t=(0.04165, 0.02326, -0.0284),
    ),
}


def preset(name: str) -> SlamConfig:
    return _PRESETS[name]


def override(cfg: SlamConfig, overrides: dict) -> SlamConfig:
    """Apply a nested dict of overrides onto a config tree — the CLI's
    equivalent of the reference's per-run YAML files (its launch files
    load config/*.yaml over the rosparam defaults). Nested dicts recurse
    into sub-dataclasses; tuple-typed fields accept lists."""
    kw = {}
    for key, val in overrides.items():
        cur = getattr(cfg, key)  # raises on unknown key: fail loudly
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kw[key] = override(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            kw[key] = tuple(val)
        else:
            kw[key] = val
    return dataclasses.replace(cfg, **kw)


def small_test_config() -> SlamConfig:
    """Tiny capacities for CPU unit tests."""
    return SlamConfig(
        map=MapConfig(capacities=(1 << 12, 1 << 12, 1 << 13),
                      unique_max=(2048, 2048, 4096)),
        odom=OdometryConfig(point_max=1024, imu_max=48),
        lba=LocalBAConfig(factor_max=512),
    )
