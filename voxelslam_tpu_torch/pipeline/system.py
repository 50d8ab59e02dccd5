"""Full SLAM system: odometry + local BA + loop closure + global BA +
sessions (port of `voxelslam_tpu/pipeline/system.py`).

The reference runs three threads (voxelslam.cpp:3144-3170); here the same
dataflow is a deterministic pipeline driven scan by scan:

  process_scan -> odometry/local-BA step (SlamPipeline)
               -> the newly emitted ScanPoses into LoopPipeline.push
               -> a returned LoopCorrection is applied between scans
                  (the reference's loop_detect check, voxelslam.cpp:1768)
               -> mid-term association reloads one nearby historical
                  keyframe per scan (keyframe_loading, :1379-1438)
               -> with GBA on, the current session's new keyframes stream
                  into the bottom-up global BA (thd_globalmapping,
                  :3066-3096)

`finish()` ends the run: the window flushes and, with GBA on, the total BA
over all submaps and the top-down pose-graph solve write every session back
(topDownProcess, :2687-2812). `save()` writes the live session and the
loop edges under `savepath`; `previous_maps` loads earlier sessions from
there as searchable sessions.

A divergence reset of the odometry opens a new loop session; earlier
sessions stay searchable, so the new one can relocalize into them.

`save_checkpoint`/`load_checkpoint` snapshot the live state mid-run
(`utils/checkpoint.py`). Not ported yet: GBA windows sharded over several
cards (ROADMAP.md Queue A item 7).
"""

from __future__ import annotations

import os

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
        """previous_maps: prior session names under `savepath` to load and
        relocalize against (the reference's General/previous_map param,
        voxelslam.cpp:282-308)."""
        self.cfg = cfg
        self.savepath = savepath
        self.device = resolve_device(device)
        self.odom = SlamPipeline(cfg, collect_clouds=enable_loop,
                                 device=self.device)
        self.loop = (LoopPipeline(cfg, device=self.device) if enable_loop
                     else None)
        self.session_names: list[str] = []
        if self.loop is not None:
            if previous_maps:
                from ..io import sessions as ses
                ses.load_previous_sessions(self.loop, savepath, previous_maps)
                self.session_names.extend(previous_maps)
            self.loop.new_session()
        self.session_names.append(f"live{len(self.session_names)}")
        self.gba = None
        if enable_gba and enable_loop:
            from ..gba.hba import HbaRunner
            self.gba = HbaRunner(cfg, device=self.device)
        self._gba_consumed: dict[int, int] = {}
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
            self.session_names.append(f"live{len(self.session_names)}")

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

        if self.gba is not None:
            self._drain_keyframes_to_gba()
        return out

    def _drain_keyframes_to_gba(self):
        """The current session's new keyframes into the bottom-up GBA (one
        queue across sessions, as in the JAX package)."""
        sid = self.loop.cur_session
        done = self._gba_consumed.get(sid, 0)
        kfs = self.loop.keyframes[sid]
        while done < len(kfs):
            self.gba.add_keyframe(kfs[done])
            done += 1
        self._gba_consumed[sid] = done

    def finish(self, run_gba: bool | None = None):
        """End of run: flush the window, stream the last poses into the
        loop pipeline and, with GBA on, run the total BA over all submaps
        and the top-down pose-graph solve that writes every session back.
        Returns all scan poses."""
        self.odom.flush()
        if self.loop is not None:
            while self._emitted < len(self.odom.scan_poses):
                sp = self.odom.scan_poses[self._emitted]
                self._emitted += 1
                self.loop.push(sp)
        if self.gba is not None and (run_gba is None or run_gba):
            self._drain_keyframes_to_gba()
            self.gba.flush()
            self.gba.total_ba()
            if self.gba.edges1 or self.gba.edges2:
                self.gba.top_down(self.loop)
        return self.odom.scan_poses

    def save_checkpoint(self, path: str):
        """Mid-run snapshot of all live state (odometry + loop + GBA, work
        in flight included); the reference has no equivalent, its sessions
        persist only at finish. Restore with `load_checkpoint` on a freshly
        constructed system with the same config and flags."""
        from ..utils import checkpoint as ckpt
        ckpt.save_system(self, path)

    def load_checkpoint(self, path: str):
        """Restore a `save_checkpoint` file onto this system's device."""
        from ..utils import checkpoint as ckpt
        ckpt.load_system(self, path)

    def save(self, name: str | None = None):
        """Write the live session and the multi-session loop edges under
        `savepath` (reference save_pose + pgo_edges_io write,
        voxelslam.cpp:2693-2699)."""
        assert self.savepath is not None, "savepath not set"
        from ..io import sessions as ses
        if name is not None:
            self.session_names[-1] = name
        sid = self.loop.cur_session if self.loop is not None else 0
        sps = (self.loop.scan_poses[sid] if self.loop is not None
               else self.odom.scan_poses)
        ses.save_session(os.path.join(self.savepath,
                                      self.session_names[-1]), sps)
        if self.loop is not None:
            ses.write_edges(os.path.join(self.savepath, "edge.txt"),
                            self.loop.lp_edges, self.session_names,
                            extra_lines=self.loop._edge_absent_lines)
