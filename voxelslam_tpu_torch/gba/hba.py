"""Hierarchical global bundle adjustment (port of `voxelslam_tpu/gba/hba.py`;
the reference's global-mapping thread and finish path, `thd_globalmapping`
voxelslam.cpp:3018-3141, `HBA_add_edge` :2822-3015, `topDownProcess`
:2717-2812):

  * bottom-up: keyframes in windows of `win_size` (stride `stride`); per
    window a LiDAR-only BA of the keyframe poses with a coarse-to-fine
    voxel schedule, then all-pairs edges with variances from the BA
    Hessian (1/|H_ij|, skipped below 1e-6) and a condensed submap cloud
    (merged into first-frame coordinates, downsampled at voxel_size/8)
  * total BA: the same window BA over all submaps, condensed level by
    level while more than `max_window` remain
  * top-down: every edge joins the loop pipeline's multi-session pose
    graph and one solve writes every session back.

One window step is a host loop of rounds. The JAX package's `while_loop`
exits on data: a round's relative residual decrease below 5% moves the
phase (coarse GBA voxels, then the odometry map's), and the phase sets the
voxel size, hence the hash keys. Here the host reads that decision once a
round, so voxel size and plane gates are plain floats and the loop stops
where the JAX loop stops. A round rebuilds the window's map with the
dense-column insert (`insert_scan_level`, not the fused moments kernel,
as in the JAX package), refits its planes, harvests the factors and runs
a 3-iteration `lm_lidar`.

The dispatch-ahead order of the JAX package is kept: a window's edges
appear when the next window is added, its submap one window later, and
`add_keyframe`/`drain` return the same dicts. Its outputs are read with
one synchronous copy at harvest. Windows sharded over several cards (the
JAX package's `mesh`/`fleet_batch`) are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig, MapConfig
from ..map import voxel_map as vm
from ..ba import optimizers as opt
from ..parallel.dist_gba import all_pairs_edges, condense_window
from ..pipeline.loop import Keyframe, LoopEdge
from ..pipeline.odometry import resolve_device

CONV_THR = 0.05


class HbaRunner:
    """Global BA on `device` (CUDA by default; raises when CUDA is absent
    and no device is named).

    `host_syncs` counts the device-to-host reads; `window_log` holds one
    dict per window step (padded width, rounds, the phase after each
    round, host syncs)."""

    def __init__(self, cfg: SlamConfig, kf_point_max: int = 8192,
                 capacity: int = 1 << 13, unique_max: int = 4096,
                 mesh=None, fleet_batch: int | None = None, device=None):
        if mesh is not None or fleet_batch is not None:
            raise NotImplementedError(
                "GBA windows sharded over several cards are not ported yet "
                "(ROADMAP.md Queue A item 7)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kf_point_max = kf_point_max
        self._capacity = capacity
        self._unique_max = unique_max
        self.edges1: list[LoopEdge] = []
        self.edges2: list[LoopEdge] = []
        self.submaps: list[Keyframe] = []
        self._pending: list[Keyframe] = []
        # dispatch-ahead order: window N's step outputs and condensed
        # submap stay on the device until window N+1 is added
        self._inflight_step = None   # (window, device step outputs)
        self._inflight_cond = None   # (first_kf, down, dmask)
        self.host_syncs = 0
        self.window_log: list[dict] = []

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _fetch(self, *xs):
        """One device-to-host copy of several f32 tensors -> numpy arrays
        of their shapes."""
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs]).cpu()
        self.host_syncs += 1
        out, o = [], 0
        for x in xs:
            out.append(flat[o:o + x.numel()].numpy().reshape(x.shape))
            o += x.numel()
        return out

    # -- window step --------------------------------------------------------

    def _map_cfgs(self, W: int):
        cfg = self.cfg
        g = cfg.gba
        coarse = MapConfig(
            voxel_size=g.voxel_size, max_layer=0,
            capacities=(self._capacity,), win_size=W,
            min_point=(5,), min_eigen_value=g.min_eigen_value,
            plane_thr=(g.eigen_value_thr,), unique_max=(self._unique_max,),
            eig_ratio_ba=cfg.map.eig_ratio_ba)
        fine = dataclasses.replace(
            coarse,
            voxel_size=cfg.map.voxel_size,
            min_eigen_value=cfg.map.min_eigen_value,
            plane_thr=(cfg.map.plane_thr[0],))
        return coarse, fine

    def _build_and_lm(self, coarse_cfg, factor_max, vox, min_eig, thr,
                      clouds, masks, Rs, ps, wmask):
        """One round: the window's map at voxel size `vox`, planes refit at
        the (min_eig, thr) gates, the factors harvested, 3 LM iterations."""
        W, P = clouds.shape[0], clouds.shape[1]
        lv = vm.empty_level(self._capacity, W, device=self.device)
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        tr = clouds.new_zeros((P,))
        for i in range(W):
            wld = clouds[i] @ Rs[i].T + ps[i]
            lv, _, _, _ = vm.insert_scan_level(
                lv, vox, self._unique_max, wld, clouds[i], tr,
                masks[i] * wmask[i], i, 0.0)
        levels = vm.refresh_planes((lv,), coarse_cfg, Rs, ps, mp, W,
                                   min_eigen_value=min_eig, plane_thr=thr)
        factors = vm.harvest_t(levels, coarse_cfg, mp, factor_max)
        return opt.lm_lidar(Rs, ps, factors, wmask, max_iter=3)

    def _window_step(self, clouds, masks, Rs, ps, wmask, factor_max: int):
        """Convergence-driven coarse->fine window BA (reference
        HBA_add_edge, voxelslam.cpp:2871-2917): coarse GBA voxel params
        until the first round with |r0-r1|/r0 < 5%, then the odometry map
        params until the second or `GBAConfig.total_max_iter` rounds.
        Returns the device tensors (Rs, ps, H, r0 of the first round, r1
        of the last)."""
        W = clouds.shape[0]
        coarse_cfg, fine_cfg = self._map_cfgs(W)
        g = self.cfg.gba
        total_iter = max(int(g.total_max_iter), 2)
        syncs0 = self.host_syncs
        it, phase, phases = 0, 0, []
        r0_first = H = r1 = None
        while it < total_iter and phase < 2:
            fine = phase > 0
            vox = fine_cfg.voxel_size if fine else g.voxel_size
            min_eig = (fine_cfg.min_eigen_value if fine
                       else g.min_eigen_value)
            thr = fine_cfg.plane_thr[0] if fine else g.eigen_value_thr
            Rs, ps, H, r0, r1, _ = self._build_and_lm(
                coarse_cfg, factor_max, vox, min_eig, thr, clouds, masks, Rs,
                ps, wmask)
            rel = torch.abs(r0 - r1) / torch.clamp(r0, min=1e-12)
            conv = bool(rel < CONV_THR)          # the round's one host read
            self.host_syncs += 1
            phase += int(conv)
            phases.append(phase)
            if it == 0:
                r0_first = r0
            it += 1
        self.window_log.append(dict(W=W, rounds=it, phases=phases,
                                    syncs=self.host_syncs - syncs0))
        return Rs, ps, H, r0_first, r1

    def _dispatch_window(self, kfs: list[Keyframe], W_pad: int,
                         factor_max: int = 1024):
        """Run one window BA over `kfs` padded with dead frames to W_pad;
        returns its device outputs (Rs, ps, H, r0, r1), not yet read."""
        P = self.kf_point_max
        clouds = np.zeros((W_pad, P, 3), np.float32)
        masks = np.zeros((W_pad, P), np.float32)
        Rs = np.tile(np.eye(3, dtype=np.float32), (W_pad, 1, 1))
        ps = np.zeros((W_pad, 3), np.float32)
        wmask = np.zeros((W_pad,), np.float32)
        for i, kf in enumerate(kfs):
            m = min(kf.cloud.shape[0], P)
            clouds[i, :m] = kf.cloud[:m]
            masks[i, :m] = kf.mask[:m]
            Rs[i] = kf.R0
            ps[i] = kf.p0
            wmask[i] = 1.0
        return self._window_step(self._t(clouds), self._t(masks), self._t(Rs),
                                 self._t(ps), self._t(wmask), factor_max)

    def _fetch_step(self, outs, n: int):
        Rs2, ps2, H, r0, r1 = self._fetch(*outs)
        return (Rs2.astype(np.float64)[:n], ps2.astype(np.float64)[:n],
                H.astype(np.float64), float(r0), float(r1))

    def _run_window(self, kfs: list[Keyframe], W_pad: int,
                    factor_max: int = 1024):
        """One window BA, read at once: (Rs (n,3,3), ps (n,3), H, r0, r1),
        float64."""
        return self._fetch_step(self._dispatch_window(kfs, W_pad, factor_max),
                                len(kfs))

    @staticmethod
    def _extract_edges(kfs, Rs, ps, H, out: list[LoopEdge]):
        """All-pairs edges with v6 = 1/|H_ij| elementwise, pairs with an
        |H_ij| under 1e-6 skipped (`dist_gba.all_pairs_edges`, reference
        :2926-2951), on the host in float64."""
        n = len(kfs)
        rel_R, rel_p, v6, valid = (x.numpy() for x in all_pairs_edges(
            torch.from_numpy(np.asarray(Rs, np.float64)),
            torch.from_numpy(np.asarray(ps, np.float64)),
            torch.from_numpy(np.asarray(H, np.float64)), n))
        for k, (i, j) in enumerate(zip(*np.triu_indices(n, 1))):
            if valid[k]:
                out.append(LoopEdge(
                    id_a=kfs[i].session, id_b=kfs[j].session,
                    ord_a=kfs[i].scan_id, ord_b=kfs[j].scan_id,
                    R=rel_R[k], t=rel_p[k], v6=v6[k]))

    def _dispatch_condense(self, kfs, Rs, ps):
        """The window condense (`dist_gba.condense_window` at
        voxel_size/8); returns the device (down, dmask), not yet read."""
        P = self.kf_point_max
        n = len(kfs)
        clouds = np.zeros((n, P, 3), np.float32)
        masks = np.zeros((n, P), np.float32)
        for i, kf in enumerate(kfs):
            m = min(kf.cloud.shape[0], P)
            clouds[i, :m] = kf.cloud[:m]
            masks[i, :m] = kf.mask[:m]
        return condense_window(
            self._t(clouds), self._t(masks), self._t(np.asarray(Rs[:n])),
            self._t(np.asarray(ps[:n])), self.cfg.map.voxel_size / 8.0, P)

    def _condense(self, kfs, Rs, ps, kf_index: int | None = None) -> Keyframe:
        down, dmask = self._fetch(*self._dispatch_condense(kfs, Rs, ps))
        first = kfs[0]
        return Keyframe(
            kf_index=len(self.submaps) if kf_index is None else kf_index,
            scan_id=first.scan_id, session=first.session, R0=Rs[0], p0=ps[0],
            cloud=down, mask=dmask, jour=first.jour)

    # -- bottom-up ----------------------------------------------------------

    def _harvest_cond(self):
        """Read the in-flight condensed submap and append it in window
        order."""
        if self._inflight_cond is None:
            return
        first, down, dmask = self._inflight_cond
        self._inflight_cond = None
        down, dmask = self._fetch(down, dmask)
        self.submaps.append(Keyframe(
            kf_index=len(self.submaps), scan_id=first.scan_id,
            session=first.session, R0=first.R0, p0=first.p0, cloud=down,
            mask=dmask, jour=first.jour))

    def _harvest_step(self, inflight):
        """Read one in-flight window BA, extract its all-pairs edges and
        start its condense."""
        window, outs = inflight
        Rs, ps, H, r0, r1 = self._fetch_step(outs, len(window))
        self._extract_edges(window, Rs, ps, H, self.edges1)
        first = dataclasses.replace(window[0], R0=Rs[0], p0=ps[0])
        down, dmask = self._dispatch_condense(window, Rs, ps)
        self._inflight_cond = (first, down, dmask)
        return r0, r1

    def drain(self):
        """Read everything still in flight; called by flush, total_ba and
        top_down so the edge and submap lists are complete."""
        out = None
        if self._inflight_step is not None:
            self._harvest_cond()
            step, self._inflight_step = self._inflight_step, None
            r0, r1 = self._harvest_step(step)
            out = dict(r0=r0, r1=r1)
        self._harvest_cond()
        return out

    def add_keyframe(self, kf: Keyframe):
        """Stream one keyframe; a window BA runs whenever `win_size` have
        accumulated (stride `stride`), as thd_globalmapping consumes them
        (:3066-3096). The previous window is harvested after this one
        ran."""
        g = self.cfg.gba
        self._pending.append(kf)
        if len(self._pending) < g.win_size:
            return None
        window = self._pending[:g.win_size]
        self._pending = self._pending[g.stride:]
        outs = self._dispatch_window(window, g.win_size)
        prev, self._inflight_step = self._inflight_step, (window, outs)
        r0 = r1 = None
        if prev is not None:
            self._harvest_cond()
            r0, r1 = self._harvest_step(prev)
        return dict(r0=r0, r1=r1, n_edges=len(self.edges1),
                    n_submaps=len(self.submaps), in_flight=True)

    def flush(self):
        """Read every window still in flight (end of stream)."""
        return self.drain()

    def bottom_up(self, keyframes):
        for kf in keyframes:
            self.add_keyframe(kf)
        self.flush()

    # -- total BA over submaps ----------------------------------------------

    def total_ba(self, max_window: int = 64):
        """Second-level BA over all submaps (reference total_ba burst,
        :3108-3126). While more than `max_window` submaps remain they are
        condensed in non-overlapping `win_size` windows (each window BA'd,
        its edges kept) until one window covers the level."""
        self.drain()
        if len(self.submaps) < 2:
            return None
        g = self.cfg.gba
        level = list(self.submaps)
        rounds = 0
        while len(level) > max_window:
            nxt = []
            for i in range(0, len(level), g.win_size):
                window = level[i:i + g.win_size]
                if len(window) < 2:
                    nxt.extend(window)
                    continue
                Rs, ps, H, _, _ = self._run_window(
                    window, _next_pow2(len(window)), factor_max=2048)
                self._extract_edges(window, Rs, ps, H, self.edges2)
                nxt.append(self._condense(window, Rs, ps, kf_index=-1))
            level = nxt
            rounds += 1
        Rs, ps, H, r0, r1 = self._run_window(level, _next_pow2(len(level)),
                                             factor_max=2048)
        self._extract_edges(level, Rs, ps, H, self.edges2)
        return dict(r0=r0, r1=r1, n_edges=len(self.edges2),
                    hierarchy_rounds=rounds)

    # -- top-down -----------------------------------------------------------

    def top_down(self, loop_pipeline):
        """Merge every GBA edge into the multi-session scan pose graph and
        solve (reference topDownProcess :2717-2812): the loop pipeline's
        solver writes every session's scan poses and keyframes back in
        place. Returns its LoopCorrection."""
        self.drain()
        lp = loop_pipeline
        lp.lp_edges.extend(self.edges1)
        lp.lp_edges.extend(self.edges2)
        lp._rebuild_graph_ids()
        return lp._optimize(g_update=False)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
