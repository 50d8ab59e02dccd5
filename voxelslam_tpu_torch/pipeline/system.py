"""Full SLAM system: odometry + local BA + loop closure + sessions (port of
`voxelslam_tpu/pipeline/system.py`, without GBA).

The reference runs three threads (voxelslam.cpp:3144-3170); here the same
dataflow is a deterministic pipeline driven scan by scan:

  process_scan -> odometry/local-BA step (SlamPipeline)
               -> the newly emitted ScanPoses into LoopPipeline.push
               -> a returned LoopCorrection is applied between scans
                  (the reference's loop_detect check, voxelslam.cpp:1768)
               -> mid-term association reloads one nearby historical
                  keyframe per scan (keyframe_loading, :1379-1438)

A divergence reset of the odometry opens a new loop session; earlier
sessions stay searchable, so the new one can relocalize into them.

Not ported yet, each raising NotImplementedError: GBA (`enable_gba`,
ROADMAP.md Queue A item 5), `previous_maps` and `save` (`io/sessions`,
item 3), checkpoints (item 6).
"""

from __future__ import annotations

from ..config import SlamConfig
from .loop import LoopPipeline
from .odometry import SlamPipeline, resolve_device


class SlamSystem:
    """The system on `device` (CUDA by default; raises when CUDA is absent
    and no device is named)."""

    def __init__(self, cfg: SlamConfig, enable_loop: bool = True,
                 enable_gba: bool = False,
                 previous_maps: list[str] | None = None,
                 savepath: str | None = None, device=None):
        if enable_gba:
            raise NotImplementedError(
                "GBA is not ported yet (ROADMAP.md Queue A item 5)")
        if previous_maps or savepath is not None:
            raise NotImplementedError(
                "previous_maps and savepath need io/sessions, not ported "
                "yet (ROADMAP.md Queue A item 3)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.odom = SlamPipeline(cfg, collect_clouds=enable_loop,
                                 device=self.device)
        self.loop = (LoopPipeline(cfg, device=self.device) if enable_loop
                     else None)
        if self.loop is not None:
            self.loop.new_session()
        self._emitted = 0
        self._session = 0
        self.corrections = 0

    @property
    def scan_poses(self):
        return self.odom.scan_poses

    def process_scan(self, points, offsets, imu_ts, imu_gyr, imu_acc,
                     t_beg, t_end) -> dict:
        out = self.odom.process_scan(points, offsets, imu_ts, imu_gyr,
                                     imu_acc, t_beg, t_end)
        if self.loop is None:
            return out

        if self.odom.session != self._session:
            # odometry reset -> new session; earlier ones stay searchable
            self._session = self.odom.session
            self.loop.new_session()

        corr = None
        while self._emitted < len(self.odom.scan_poses):
            sp = self.odom.scan_poses[self._emitted]
            self._emitted += 1
            c = self.loop.push(sp)
            if c is not None:
                corr = c
        if corr is not None:
            self.odom.apply_correction(corr.dx_R, corr.dx_p,
                                       corr.g_update, corr.map_keyframes)
            self.corrections += 1
            out = dict(out, loop_correction=True)

        # mid-term association: one nearby historical keyframe per scan
        if out.get("phase") == "odom":
            kf = self.loop.nearby_keyframe(self.odom.x.p.cpu().numpy())
            if kf is not None:
                self.odom.insert_keyframe_fixed(kf)
        return out

    def finish(self, run_gba: bool | None = None):
        """End of run: flush the window and stream the last poses into the
        loop pipeline. Returns all scan poses. (GBA is not ported.)"""
        if run_gba:
            raise NotImplementedError(
                "GBA is not ported yet (ROADMAP.md Queue A item 5)")
        self.odom.flush()
        if self.loop is not None:
            while self._emitted < len(self.odom.scan_poses):
                sp = self.odom.scan_poses[self._emitted]
                self._emitted += 1
                self.loop.push(sp)
        return self.odom.scan_poses

    def save_checkpoint(self, path: str):
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP.md Queue A item 6)")

    def load_checkpoint(self, path: str):
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP.md Queue A item 6)")

    def save(self, name: str | None = None):
        raise NotImplementedError(
            "save needs io/sessions, not ported yet (ROADMAP.md Queue A "
            "item 3)")
