"""Odometry + local-mapping pipeline (port of the odometry/local-BA part of
`voxelslam_tpu/pipeline/odometry.py`; the reference's
thd_odometry_localmapping, voxelslam.cpp:1740-2067).

    scan -> EKF propagate + de-skew -> voxel downsample -> iEKF vs map
    (divergence gate) -> window push (insert + preintegration) -> plane
    refresh -> sliding-window LI-BA -> marginalize -> slide

plus the initialization phase (kd-tree LIO accumulation, then the
multi-round dynamic init with gravity alignment, voxelslam.cpp:460-819,
1450-1534) and divergence reset into a new session (:1537-1586).

Host code shuffles numpy buffers and decides phases; the math runs as
PyTorch ops on `device`, with the voxel-moment sum of every steady scan
in one CUDA kernel launch (`ops.moments`). The steady step keeps the JAX
package's interface (carry + imu/scan blobs + scalars) and its deferred
emission: packed per-scan stats gather in a ring that the host reads
once per `stats_ring` scans, and `batch_scans` queued scans run as one
K-step call.

The loop-closure hooks are here too: `apply_correction` (a loop
correction rebuilds the live map from keyframes and the corrected window,
with the gravity-joint `_g_reloc` after a cross-session first contact)
and `insert_keyframe_fixed` (mid-term keyframe reload); with
`collect_clouds=True` every emitted ScanPose carries its scan's cloud.

With `lba.mgsize > 1` a BA burst marginalizes `mgsize` frames, and the
window refills over the next `mgsize - 1` scans through `_mega_accum`
(no BA), as in the JAX package. The JAX package's `_pin_window_layouts`
pins XLA TPU memory layouts and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig
from ..core import so3
from ..core.state import NavState, DIM
from ..core.eig3 import eigvalsh3
from ..core.tensors import stack, tmap
from ..imu import ekf, preintegration as pre
from ..map import voxel_map as vm
from ..ba import optimizers as opt
from ..odom import iekf
from ..ops.downsample import voxel_downsample

# host-side fields a carry snapshot needs besides the device tensors
CARRY_HOST_FIELDS = ("win_count", "init_done", "jour", "session",
                     "scan_count", "last_scan_end", "degrade_cnt", "_last_p",
                     "_gravity", "_bg0", "_scale_gravity")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _set_row(a, i, b):
    a = a.clone()
    a[i] = b
    return a


def _roll(a, mg):
    return torch.cat([a[mg:], a[:mg]], dim=0)


@dataclasses.dataclass
class ScanPose:
    """Output stream element (reference loop_refine.hpp:17-45)."""
    t: float
    R: np.ndarray
    p: np.ndarray
    v: np.ndarray
    v6: np.ndarray          # per-scan variance 6-vector from the BA Hessian
    cloud: np.ndarray       # downsampled body-frame cloud
    cloud_mask: np.ndarray
    session: int
    bg: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    ba: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    g: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81]))


def resolve_device(device) -> torch.device:
    """The pipeline's device: CUDA unless the caller names another one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the pipeline on the CPU")
    return dev


class SlamPipeline:
    """Streaming LiDAR-inertial SLAM front end on `device` (CUDA by
    default; raises when CUDA is absent and no device is named)."""

    def __init__(self, cfg: SlamConfig, collect_clouds: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # when False, skip the per-scan device->host cloud fetch
        self.collect_clouds = collect_clouds
        kw = dict(dtype=torch.float32, device=self.device)
        self.noise_meas = torch.diag(torch.tensor(
            [cfg.lba.noise_gyr] * 3 + [cfg.lba.noise_acc] * 3, **kw))
        self.noise_walk = torch.diag(torch.tensor(
            [cfg.lba.walk_gyr] * 3 + [cfg.lba.walk_acc] * 3, **kw))
        self.R_ext = torch.tensor(cfg.extrinsic_R, **kw).reshape(3, 3)
        self.t_ext = torch.tensor(cfg.extrinsic_t, **kw)
        self.reset(session=0, hard=True)

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset(self, session: int, hard: bool = False):
        """System reset: drop map and window, new session (system_reset,
        voxelslam.cpp:1537-1586). The IMU stays initialized."""
        cfg = self.cfg
        W = cfg.lba.win_size
        P = cfg.odom.point_max
        dev = self.device
        self.levels = vm.empty_map(cfg.map, dev)
        self.x = NavState.identity(device=dev)
        if not hard and getattr(self, "_gravity", None) is not None:
            self.x = dataclasses.replace(
                self.x, g=self._gravity, bg=self._bg0,
                p=torch.tensor([0.0, 0.0, 30.0], device=dev))  # ref :1553
        self.win = NavState.identity((W,), device=dev)
        self.mp = torch.arange(W, dtype=torch.int32, device=dev)
        self.win_count = 0
        self._preint_list = []
        self.scan_buf = np.zeros((W, P, 3), np.float32)
        self.scan_mask = np.zeros((W, P), np.float32)
        self.scan_tr = np.zeros((W, P, vm.NV), np.float32)
        M = cfg.odom.imu_max - 1
        self.imu_buf_g = np.zeros((W, M, 3), np.float32)
        self.imu_buf_a = np.zeros((W, M, 3), np.float32)
        self.imu_buf_dt = np.zeros((W, M), np.float32)
        self.imu_buf_m = np.zeros((W, M), np.float32)
        self.degrade_cnt = 0
        self._last_p = None
        self._pending = None
        self._ring_K = 1 if self.collect_clouds else max(1, cfg.odom.stats_ring)
        # K-scan dispatch only in the plain steady flow: cloud collection
        # and mgsize > 1 decide on the host between scans
        self._batch_K = (1 if self.collect_clouds or cfg.lba.mgsize > 1
                         else max(1, cfg.odom.batch_scans))
        self._scan_queue: list = []
        self._stats_len = 5 + 31 * cfg.lba.mgsize + 1
        self._stats_ring = torch.zeros((self._ring_K, self._stats_len),
                                       device=dev)
        self._ring_fill = 0
        self._pend_t: list[float] = []
        self.session = session
        self.jour = 0.0
        self.init_done = False
        self.scan_count = 0
        self.last_scan_end = None
        self.init_cloud = torch.zeros((4 * P, 3), device=dev)
        self.init_cloud_mask = torch.zeros((4 * P,), device=dev)
        if hard:
            self.scan_poses: list[ScanPose] = []
            self._gravity = None
            self._bg0 = torch.zeros(3, device=dev)
            self._scale_gravity = 1.0
            self._imu_acc = []
            self._imu_gyr = []

    def load_carry(self, carry: dict, **host):
        """Install a pipeline carry (`convert.carry_from_numpy` output:
        x, levels, win, mp, preints_dev) and the host-side bookkeeping
        named in CARRY_HOST_FIELDS. Deferred-emission buffers restart
        empty."""
        self.x = carry["x"]
        self.levels = tuple(carry["levels"])
        self.win = carry["win"]
        self.mp = carry["mp"]
        self.preints_dev = carry["preints_dev"]
        for k, v in host.items():
            if k not in CARRY_HOST_FIELDS:
                raise KeyError(f"unknown carry field {k!r}")
            setattr(self, k, v)
        self._pending = None
        self._scan_queue = []
        self._pend_t = []
        self._ring_fill = 0
        self._stats_ring = torch.zeros((self._ring_K, self._stats_len),
                                       device=self.device)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _prop_deskew(self, state, imu_ts, gyr, acc, imu_mask, scan_beg,
                     scan_end, last_end, pts, offsets, pt_mask):
        cfg = self.cfg.odom
        covd = lambda v: torch.full((3,), v, device=self.device)
        st, poses = ekf.propagate(
            state, imu_ts, gyr, acc, imu_mask, scan_beg, scan_end, last_end,
            covd(cfg.cov_gyr), covd(cfg.cov_acc), covd(cfg.cov_bias_gyr),
            covd(cfg.cov_bias_acc))
        if cfg.point_notime:
            des = pts
        else:
            des = ekf.deskew(pts, offsets, poses, st, self.R_ext, self.t_ext)
        return st, des @ self.R_ext.T + self.t_ext

    def _downsample_var(self, pts_body, mask):
        cfg = self.cfg.odom
        down, dmask, _ = voxel_downsample(pts_body, mask, cfg.down_size,
                                          cfg.point_max)
        var_b = iekf.point_var_body(down, cfg.dept_err, cfg.beam_err)
        nv = vm.point_noise_record(down, cfg.dept_err, cfg.beam_err)
        return down, dmask.to(torch.float32), var_b, nv

    def _kdtree_step(self, state, ref_cloud, ref_mask, pts, mask):
        st = iekf.iekf_update_kdtree(state, ref_cloud, ref_mask, pts, mask)
        wld = pts @ st.R.T + st.p
        buf = torch.cat([ref_cloud, wld], dim=0)
        bmask = torch.cat([ref_mask, mask], dim=0)
        down, dmask, _ = voxel_downsample(buf, bmask, 0.5, ref_cloud.shape[0])
        return st, down, dmask.to(torch.float32)

    def _push_window(self, levels, state, pts, mask, tr, frame_slot, jour):
        wld = pts @ state.R.T + state.p
        return vm.insert_scan(levels, self.cfg.map, wld, pts, tr, mask,
                              frame_slot, jour)

    def _refresh(self, levels, win, mp, win_count):
        return vm.refresh_planes(levels, self.cfg.map, win.R, win.p, mp,
                                 win_count)

    def _integrate_preint(self, gyr, acc, dt, mask, bg, ba):
        return pre.integrate(gyr, acc, dt, mask, bg, ba, self.noise_meas,
                             self.noise_walk)

    def _window_ba_slide(self, levels, win, preints, mp):
        cfg = self.cfg
        W = cfg.lba.win_size
        mg = cfg.lba.mgsize
        factors = vm.harvest_t(levels, cfg.map, mp, cfg.lba.factor_max)
        new_win, H, r0, r1, conv = opt.lm_li(
            win, factors, preints, torch.ones((W,), device=self.device),
            imu_coef=cfg.lba.imu_coef, max_iter=cfg.lba.max_iter)
        d = torch.stack([torch.diagonal(H)[k * DIM:k * DIM + 6]
                         for k in range(mg)])
        v6 = 1.0 / torch.clamp(torch.abs(d), min=1e-6)
        levels = vm.refresh_planes(levels, cfg.map, new_win.R, new_win.p,
                                   mp, W)
        levels = vm.marginalize(levels, cfg.map, new_win.R, new_win.p, mp, W,
                                mg)
        mp_new = _roll(mp, mg)
        win_shift = tmap(lambda a: _roll(a, mg), new_win)
        return levels, new_win, win_shift, mp_new, v6, r0, r1

    def _preint_interval(self, imu_ts, gyr, acc, imask, last_end, scan_end,
                         bg, ba):
        """Preintegration over exactly (last_end, scan_end] (the reference
        rewrites the boundary IMU stamps the same way, ekf_imu.hpp:125-133)."""
        g_mid = 0.5 * (gyr[:-1] + gyr[1:])
        a_mid = 0.5 * (acc[:-1] + acc[1:])
        heads = torch.minimum(torch.maximum(imu_ts[:-1], last_end), scan_end)
        tails = torch.minimum(torch.maximum(imu_ts[1:], last_end), scan_end)
        dt = (tails - heads) * (imask[:-1] * imask[1:])
        return g_mid, a_mid, dt, self._integrate_preint(
            g_mid, a_mid, dt, imask[1:], bg, ba)

    def _steady_megastep(self, state, levels, win, mp, preints, ring,
                         imu_blob, scan_blob, scal):
        """One steady-phase scan: propagate+deskew -> downsample ->
        preintegrate -> iEKF -> window push + fused insert -> touched
        plane refresh -> windowed LI-BA -> marginalize -> slide.

        Window invariant at entry: logical frames 0..W-2 are valid and the
        new scan becomes frame W-1; preints[k] is pair (k, k+1)."""
        cfg = self.cfg
        W = cfg.lba.win_size
        mg = cfg.lba.mgsize
        imu_ts, gyr, acc, imask = (imu_blob[:, 0], imu_blob[:, 1:4],
                                   imu_blob[:, 4:7], imu_blob[:, 7])
        pts, offsets, pmask = scan_blob[:, 0:3], scan_blob[:, 3], scan_blob[:, 4]
        scan_beg, scan_end, last_end, jour = scal[0], scal[1], scal[2], scal[3]
        slot = scal[4].to(torch.int64)

        x_prop, body = self._prop_deskew(state, imu_ts, gyr, acc, imask,
                                         scan_beg, scan_end, last_end, pts,
                                         offsets, pmask)
        down, dmask, var_b, tr = self._downsample_var(body, pmask)
        _, _, _, p_new = self._preint_interval(imu_ts, gyr, acc, imask,
                                               last_end, scan_end,
                                               x_prop.bg, x_prop.ba)
        preints = tmap(lambda a, b: _set_row(a, W - 2, b), preints, p_new)

        st, ok, diag = iekf.iekf_update(
            x_prop, levels, cfg.map, down, var_b, dmask,
            max_iter=cfg.odom.max_iter, degrade_eig=cfg.odom.degrade_eig)

        win = tmap(lambda a, b: _set_row(a, W - 1, b), win, st)
        wld = down @ st.R.T + st.p
        levels, touched = vm.insert_scan_fused(
            levels, cfg.map, wld, down, tr, dmask, mp[W - 1], jour, st.R,
            st.p)
        levels = vm.refresh_planes(levels, cfg.map, win.R, win.p, mp, W,
                                   touched=touched)

        factors = vm.harvest_t(levels, cfg.map, mp, cfg.lba.factor_max)
        new_win, H, r0, r1, conv = opt.lm_li(
            win, factors, preints, torch.ones((W,), device=self.device),
            imu_coef=cfg.lba.imu_coef, max_iter=cfg.lba.max_iter)
        d6 = torch.stack([torch.diagonal(H)[k * DIM:k * DIM + 6]
                          for k in range(mg)])
        v6 = 1.0 / torch.clamp(torch.abs(d6), min=1e-6)

        levels = vm.marginalize(levels, cfg.map, new_win.R, new_win.p, mp, W,
                                mg)
        mp_new = _roll(mp, mg)
        emitted = new_win[0:mg]
        win_next = tmap(lambda a: _roll(a, mg), new_win)
        preints = tmap(lambda a: _roll(a, mg), preints)
        x_out = new_win[W - 1]
        dropped = torch.sum(torch.stack([t[2] for t in touched]))
        f32 = torch.float32
        stats = torch.cat([
            torch.stack([ok.to(f32), diag["matches"].to(f32),
                         diag["nnt_eig"][0], r0, r1]),
            v6.reshape(-1), emitted.t.reshape(-1), emitted.R.reshape(-1),
            emitted.p.reshape(-1), emitted.v.reshape(-1),
            emitted.bg.reshape(-1), emitted.ba.reshape(-1),
            emitted.g.reshape(-1), dropped.to(f32).reshape(1),
        ])
        ring = ring.index_copy(0, slot.reshape(1), stats[None])
        return (x_out, levels, win_next, mp_new, preints, ring, down, dmask,
                tr)

    def _steady_megastep_k(self, state, levels, win, mp, preints, imu_blobs,
                           scan_blobs, scals):
        """K steady scans in one call (the JAX package's `lax.scan` over the
        megastep): row k of the returned (K, S) stats is scan k."""
        K = scals.shape[0]
        ring = torch.zeros((K, self._stats_len), device=self.device)
        downs, dmasks, trs = [], [], []
        for k in range(K):
            (state, levels, win, mp, preints, ring, down, dmask, tr) = \
                self._steady_megastep(state, levels, win, mp, preints, ring,
                                      imu_blobs[k], scan_blobs[k], scals[k])
            downs.append(down)
            dmasks.append(dmask)
            trs.append(tr)
        return (state, levels, win, mp, preints, ring, torch.stack(downs),
                torch.stack(dmasks), torch.stack(trs))

    def _mega_accum(self, state, levels, win, mp, preints, imu_blob,
                    scan_blob, scal, frame_idx: int):
        """Window-refill scan for lba.mgsize > 1: propagate + deskew +
        downsample + preintegrate + iEKF + fused insert into logical slot
        `frame_idx` + touched refresh, with no BA (the reference optimizes
        only once the window is full, voxelslam.cpp:1951)."""
        cfg = self.cfg
        imu_ts, gyr, acc, imask = (imu_blob[:, 0], imu_blob[:, 1:4],
                                   imu_blob[:, 4:7], imu_blob[:, 7])
        pts, offsets, pmask = scan_blob[:, 0:3], scan_blob[:, 3], scan_blob[:, 4]
        scan_beg, scan_end, last_end, jour = scal[0], scal[1], scal[2], scal[3]

        x_prop, body = self._prop_deskew(state, imu_ts, gyr, acc, imask,
                                         scan_beg, scan_end, last_end, pts,
                                         offsets, pmask)
        down, dmask, var_b, tr = self._downsample_var(body, pmask)
        _, _, _, p_new = self._preint_interval(imu_ts, gyr, acc, imask,
                                               last_end, scan_end,
                                               x_prop.bg, x_prop.ba)
        preints = tmap(lambda a, b: _set_row(a, frame_idx - 1, b), preints,
                       p_new)
        st, ok, diag = iekf.iekf_update(
            x_prop, levels, cfg.map, down, var_b, dmask,
            max_iter=cfg.odom.max_iter, degrade_eig=cfg.odom.degrade_eig)
        win = tmap(lambda a, b: _set_row(a, frame_idx, b), win, st)
        wld = down @ st.R.T + st.p
        levels, touched = vm.insert_scan_fused(
            levels, cfg.map, wld, down, tr, dmask, mp[frame_idx], jour, st.R,
            st.p)
        levels = vm.refresh_planes(levels, cfg.map, win.R, win.p, mp,
                                   frame_idx + 1, touched=touched)
        dropped = torch.sum(torch.stack([t[2] for t in touched]))
        f32 = torch.float32
        stats = torch.stack([ok.to(f32), diag["matches"].to(f32),
                             diag["nnt_eig"][0], dropped.to(f32)])
        return st, levels, win, preints, stats, down, dmask, tr

    def _init_round(self, scans, masks, trs, states, imu_g, imu_a, imu_dt,
                    imu_m, min_eig, plane_thr):
        """One dynamic-init round: re-integrate at the current biases,
        rebuild a fresh map from the window scans at the current states,
        then LI-BA with gravity (motion_init, voxelslam.cpp:649-731)."""
        cfg = self.cfg
        W = cfg.lba.win_size
        preints = stack([
            self._integrate_preint(imu_g[i + 1], imu_a[i + 1], imu_dt[i + 1],
                                   imu_m[i + 1], states.bg[i], states.ba[i])
            for i in range(W - 1)])
        icfg = dataclasses.replace(
            cfg.map, capacities=tuple(min(c, 1 << 13)
                                      for c in cfg.map.capacities))
        levels = vm.empty_map(icfg, self.device)
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        for i in range(W):
            wld = scans[i] @ states.R[i].T + states.p[i]
            levels = vm.insert_scan(levels, icfg, wld, scans[i], trs[i],
                                    masks[i], i)
        levels = vm.refresh_planes(levels, icfg, states.R, states.p, mp, W,
                                   min_eigen_value=min_eig,
                                   plane_thr=plane_thr)
        factors = vm.harvest_t(levels, icfg, mp, cfg.lba.factor_max)
        new_states, H, r0, r1, conv = opt.lm_li_gravity(
            states, factors, preints, torch.ones((W,), device=self.device),
            imu_coef=cfg.lba.imu_coef, max_iter=cfg.lba.max_iter,
            g_prior_w=cfg.init.gravity_prior_weight)
        nmat = torch.cat([torch.where((lv.state == vm.STATE_PLANE)[:, None],
                                      lv.normal, 0.0) for lv in levels])
        ev = eigvalsh3(nmat.T @ nmat)
        return new_states, r0, r1, ev[0]

    def _align_gravity(self, states):
        """Rotate the window so gravity is -z (align_gravity,
        voxelslam.cpp:470-496)."""
        g = states.g[0]
        gn = torch.linalg.vector_norm(g)
        target = torch.tensor([0.0, 0.0, -1.0], device=self.device) * gn
        axis = torch.linalg.cross(g, target, dim=-1)
        s = torch.linalg.vector_norm(axis)
        c = torch.dot(g, target)
        ang = torch.atan2(s, torch.maximum(c, -gn * gn))
        axis = axis / torch.clamp(s, min=1e-9)
        R_al = so3.exp(axis * ang)
        p0 = states.p[0]
        return dataclasses.replace(
            states, R=R_al[None] @ states.R, p=(states.p - p0[None]) @ R_al.T,
            v=states.v @ R_al.T, g=target.expand(states.g.shape).clone())

    def _g_reloc(self, levels, win, preints, mp, win_count):
        """Gravity-joint window re-optimization after a g_update loop
        correction (the reference's LI_BA_OptimizerGravity with 5
        iterations, voxelslam.cpp:1366-1367, 1956-1965) on the rebuilt
        map, over the valid window prefix; dead frames and pairs masked."""
        cfg = self.cfg
        W = cfg.lba.win_size
        dev = self.device
        factors = vm.harvest_t(levels, cfg.map, mp, cfg.lba.factor_max)
        wmask = (torch.arange(W, device=dev) < win_count).to(torch.float32)
        pmask = (torch.arange(W - 1, device=dev)
                 < win_count - 1).to(torch.float32)
        new_win, _, r0, r1, _ = opt.lm_li_gravity(
            win, factors, preints, wmask, imu_coef=cfg.lba.imu_coef,
            max_iter=5, pair_mask=pmask)
        return new_win, r0, r1

    def _push_fixed(self, levels, pts_world, mask, jour):
        tr = pts_world.new_zeros((pts_world.shape[0],))
        return vm.insert_fixed(levels, self.cfg.map, pts_world, tr, mask,
                               jour)

    def _push_fixed_refresh(self, levels, pts_world, mask, jour, win, mp,
                            win_count):
        """insert_fixed + plane refresh of the touched voxels (a keyframe
        reloaded in the steady phase must give matchable planes at once)."""
        tr = pts_world.new_zeros((pts_world.shape[0],))
        levels, touched = vm.insert_fixed_touched(
            levels, self.cfg.map, pts_world, tr, mask, jour)
        return vm.refresh_planes(levels, self.cfg.map, win.R, win.p, mp,
                                 win_count, touched=touched)

    def _occ_counts(self, levels):
        return torch.stack([torch.sum(lv.occ) for lv in levels])

    def _evict(self, levels, jour):
        return vm.evict(levels, jour, self.cfg.map.evict_dist)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _pad_points(self, pts, offsets=None):
        P = self.cfg.odom.point_max
        n = min(len(pts), P)
        out = np.zeros((P, 3), np.float32)
        out[:n] = pts[:n]
        msk = np.zeros((P,), np.float32)
        msk[:n] = 1.0
        off = np.zeros((P,), np.float32)
        if offsets is not None:
            off[:n] = offsets[:n]
        return out, off, msk

    def _pad_imu(self, ts, gyr, acc):
        M = self.cfg.odom.imu_max
        n = min(len(ts), M)
        t = np.zeros((M,), np.float32)
        g = np.zeros((M, 3), np.float32)
        a = np.zeros((M, 3), np.float32)
        m = np.zeros((M,), np.float32)
        t[:n], g[:n], a[:n], m[:n] = ts[:n], gyr[:n], acc[:n], 1.0
        if n:
            t[n:] = ts[n - 1]
        return t, g, a, m

    def process_scan(self, points, offsets, imu_ts, imu_gyr, imu_acc,
                     t_beg, t_end):
        """Feed one synchronized packet: points (N, 3) LiDAR frame, offsets
        (N,) seconds from t_beg, IMU samples covering (last_end, t_end].
        Returns a status dict."""
        cfg = self.cfg

        # --- IMU static init (IMUEKF::IMU_init) ---
        if self._gravity is None:
            self._imu_acc.extend(np.asarray(imu_acc))
            self._imu_gyr.extend(np.asarray(imu_gyr))
            if len(self._imu_acc) > cfg.init.min_imu_num:
                acc = self._t(np.stack(self._imu_acc))
                gyr = self._t(np.stack(self._imu_gyr))
                g, _, scale, _ = ekf.static_init(
                    acc, gyr, torch.ones(acc.shape[0], device=self.device),
                    livox_g_normalized=(cfg.lidar_type == "livox"))
                self._gravity = g
                self._scale_gravity = float(scale)
                self.x = dataclasses.replace(self.x, g=g)
            self.last_scan_end = t_end
            return {"phase": "imu_init"}

        # g-normalized Livox IMUs: scale every sample to SI at ingestion
        if self._scale_gravity != 1.0:
            imu_acc = np.asarray(imu_acc, np.float64) * self._scale_gravity

        pts_j, off_j, pmask = self._pad_points(points, offsets)
        ts_j, gyr_j, acc_j, imask = self._pad_imu(imu_ts, imu_gyr, imu_acc)
        last_end = self.last_scan_end if self.last_scan_end is not None else t_beg
        self.last_scan_end = t_end

        if self.init_done:
            return self._process_steady_fused(ts_j, gyr_j, acc_j, imask, t_beg,
                                              t_end, last_end, pts_j, off_j,
                                              pmask)

        # --- init phase: separate steps ---
        pts_t, off_t, pmask_t = self._t(pts_j), self._t(off_j), self._t(pmask)
        ts_t, gyr_t, acc_t, imask_t = (self._t(ts_j), self._t(gyr_j),
                                       self._t(acc_j), self._t(imask))
        t_beg_t, t_end_t, last_t = self._t(t_beg), self._t(t_end), self._t(last_end)
        x_prop, body = self._prop_deskew(self.x, ts_t, gyr_t, acc_t, imask_t,
                                         t_beg_t, t_end_t, last_t, pts_t,
                                         off_t, pmask_t)
        down, dmask, var_b, tr = self._downsample_var(body, pmask_t)
        g_mid, a_mid, dt, p_int = self._preint_interval(
            ts_t, gyr_t, acc_t, imask_t, last_t, t_end_t, x_prop.bg, x_prop.ba)
        self._last_imu_mid = (_np(g_mid), _np(a_mid), _np(dt),
                              _np(imask_t[1:]))
        return self._process_init(x_prop, down, dmask, var_b, tr, p_int, t_end)

    # --- init phase -----------------------------------------------------

    def _process_init(self, x_prop, down, dmask, var_b, tr, p_int, t_end):
        cfg = self.cfg
        W = cfg.lba.win_size
        st, cloud, cmask = self._kdtree_step(
            x_prop, self.init_cloud, self.init_cloud_mask, down, dmask)
        self.x = st
        self.init_cloud, self.init_cloud_mask = cloud, cmask

        i = self.win_count
        self.win = tmap(lambda a, b: _set_row(a, i, b), self.win, st)
        self.scan_buf[i] = _np(down)
        self.scan_mask[i] = _np(dmask)
        self.scan_tr[i] = _np(tr)
        if i > 0:
            self._preint_list.append(p_int)
            g_m, a_m, dt_m, m_m = self._last_imu_mid
            self.imu_buf_g[i] = g_m
            self.imu_buf_a[i] = a_m
            self.imu_buf_dt[i] = dt_m
            self.imu_buf_m[i] = m_m
        self.win_count += 1
        self.scan_count += 1
        if self.win_count < W:
            return {"phase": "init_accum", "win": self.win_count}

        # --- dynamic init (motion_init, two phases, voxelslam.cpp:619-767):
        # relaxed thresholds until the first within-round convergence
        # (round >= 2), then align gravity, restore the production
        # thresholds, tighten the gate to 0.01 and converge again
        states = self.win
        scans = self._t(self.scan_buf)
        masks = self._t(self.scan_mask)
        trs = self._t(self.scan_tr)
        imu_bufs = (self._t(self.imu_buf_g), self._t(self.imu_buf_a),
                    self._t(self.imu_buf_dt), self._t(self.imu_buf_m))
        ev0 = 0.0
        aligned = False
        conv_thr = cfg.init.converge_thre
        for rnd in range(cfg.init.max_rounds):
            if aligned:
                min_eig, thr = cfg.map.min_eigen_value, cfg.map.plane_thr[0]
            else:
                min_eig, thr = cfg.init.min_eigen_value, cfg.init.plane_thr
            states, r0, r1, ev = self._init_round(
                scans, masks, trs, states, *imu_bufs, np.float32(min_eig),
                np.float32(thr))
            r0, r1 = float(r0), float(r1)
            if abs(r0 - r1) / max(r0, 1e-9) < conv_thr and rnd >= 2:
                ev0 = float(ev)
                if not aligned:
                    states = self._align_gravity(states)
                    aligned = True
                    conv_thr = 0.01
                    continue
                break

        if not aligned:   # never converged: align for the gate check only
            states = self._align_gravity(states)
        g_norm = float(torch.linalg.vector_norm(states.g[0]))
        ok = (aligned and float(ev0) >= cfg.init.degeneracy_eig
              and cfg.init.gravity_norm_lo <= g_norm <= cfg.init.gravity_norm_hi)
        if not ok:
            self.reset(session=self.session + 1)
            return {"phase": "init_failed", "ev0": float(ev0),
                    "g_norm": g_norm}

        # success: build the real map from the window at optimized states
        self.win = states
        self.x = dataclasses.replace(
            states[W - 1], cov=NavState.identity(device=self.device).cov)
        self._gravity = states.g[0]
        self.levels = vm.empty_map(cfg.map, self.device)
        for i in range(W):
            self.levels = self._push_window(
                self.levels, states[i], self._t(self.scan_buf[i]),
                self._t(self.scan_mask[i]), self._t(self.scan_tr[i]),
                self.mp[i], self.jour)
        self.levels = self._refresh_now()
        self._preint_list = [
            self._integrate_preint(
                self._t(self.imu_buf_g[i]), self._t(self.imu_buf_a[i]),
                self._t(self.imu_buf_dt[i]), self._t(self.imu_buf_m[i]),
                states.bg[i - 1], states.ba[i - 1])
            for i in range(1, W)]
        self.init_done = True
        r0, r1 = self._do_ba_slide()
        # post-slide preint pairs for the steady path (entry k <-> pair
        # (k, k+1); stale tail entries are overwritten before BA reads them)
        plist = list(self._preint_list)
        while len(plist) < W - 1:
            plist.append(plist[-1])
        self.preints_dev = stack(plist[:W - 1])
        return {"phase": "init_done", "g_norm": g_norm, "ev0": float(ev0),
                "ba_r0": r0, "ba_r1": r1}

    def _refresh_now(self):
        return self._refresh(self.levels, self.win, self.mp, self.win_count)

    def _do_ba_slide(self):
        """Window BA + marginalize + slide (init path; the steady phase
        runs it inside the megastep)."""
        cfg = self.cfg
        W = cfg.lba.win_size
        mg = cfg.lba.mgsize
        preints = stack(self._preint_list[-(W - 1):])
        levels, new_win, win_shift, mp_new, v6, r0, r1 = \
            self._window_ba_slide(self.levels, self.win, preints, self.mp)
        v6 = _np(v6)
        for k in range(mg):
            s = new_win[k]
            self.scan_poses.append(ScanPose(
                t=float(s.t), R=_np(s.R), p=_np(s.p), v=_np(s.v), v6=v6[k],
                cloud=self.scan_buf[k].copy(),
                cloud_mask=self.scan_mask[k].copy(), session=self.session,
                bg=_np(s.bg), ba=_np(s.ba), g=_np(s.g)))
        self.levels = levels
        self.win = win_shift
        self.mp = mp_new
        self.x = new_win[W - 1]
        self.scan_buf = np.roll(self.scan_buf, -mg, axis=0)
        self.scan_mask = np.roll(self.scan_mask, -mg, axis=0)
        self.scan_tr = np.roll(self.scan_tr, -mg, axis=0)
        self._preint_list = self._preint_list[mg:]
        self.win_count = W - mg
        return float(r0), float(r1)

    # --- steady phase ----------------------------------------------------

    def _process_steady_fused(self, ts_j, gyr_j, acc_j, imask, t_beg, t_end,
                              last_end, pts_j, off_j, pmask):
        """Steady phase: one megastep per scan (or per `batch_scans`
        queued scans). Stats are read back once per ring fill, after the
        next scan was dispatched, so emission lags up to ring+1 scans."""
        imu_np = np.concatenate([ts_j[:, None], gyr_j, acc_j, imask[:, None]],
                                axis=1, dtype=np.float32)
        scan_np = np.concatenate([pts_j, off_j[:, None], pmask[:, None]],
                                 axis=1, dtype=np.float32)
        if self._batch_K > 1:
            return self._process_steady_batched(imu_np, scan_np, t_beg, t_end,
                                                last_end)
        imu_blob, scan_blob = self._t(imu_np), self._t(scan_np)
        scal = self._t([t_beg, t_end, last_end, self.jour,
                        float(self._ring_fill)])
        if self.cfg.lba.mgsize > 1:
            # the refill decision needs an up-to-date win_count
            out = self._flush_pending()
            if out is not None and out.get("phase") == "reset":
                return out
            if self.win_count < self.cfg.lba.win_size - 1:
                return self._process_steady_accum(imu_blob, scan_blob, scal,
                                                  t_end)
        (x_out, levels, win_next, mp_new, preints, ring, down, dmask, tr) = \
            self._steady_megastep(self.x, self.levels, self.win, self.mp,
                                  self.preints_dev, self._stats_ring,
                                  imu_blob, scan_blob, scal)
        self.x, self.levels, self.win, self.mp = x_out, levels, win_next, mp_new
        self.preints_dev = preints
        self._stats_ring = ring
        self._ring_fill += 1
        self._pend_t.append(t_end)
        self.scan_count += 1

        out = None
        if self._pending is not None:
            out = self._emit_pending()
        if out is not None and out.get("phase") == "reset":
            return out
        if self._ring_fill >= self._ring_K:
            self._pending = (self._stats_ring, self._ring_fill,
                             list(self._pend_t), down, dmask, tr)
            self._ring_fill = 0
            self._pend_t = []
        return out if out is not None else {"phase": "odom", "pending": True,
                                            "t": t_end}

    def _process_steady_batched(self, imu_np, scan_np, t_beg, t_end,
                                last_end):
        """Queue the scan; every `_batch_K`-th scan runs the K-step call
        over the queue (`jour` read at dispatch for all K)."""
        self._scan_queue.append((imu_np, scan_np, t_beg, t_end, last_end))
        self._pend_t.append(t_end)
        self.scan_count += 1
        if len(self._scan_queue) < self._batch_K:
            return {"phase": "odom", "pending": True, "t": t_end}
        q, self._scan_queue = self._scan_queue, []
        t_ends, self._pend_t = self._pend_t, []
        K = len(q)
        imu_b = self._t(np.stack([e[0] for e in q]))
        scan_b = self._t(np.stack([e[1] for e in q]))
        scals = self._t([[e[2], e[3], e[4], self.jour, float(k)]
                         for k, e in enumerate(q)])
        (x, levels, win, mp, preints, ring, downs, dmasks, trs) = \
            self._steady_megastep_k(self.x, self.levels, self.win, self.mp,
                                    self.preints_dev, imu_b, scan_b, scals)
        self.x, self.levels, self.win, self.mp = x, levels, win, mp
        self.preints_dev = preints
        out = None
        if self._pending is not None:
            out = self._emit_pending()
        if out is not None and out.get("phase") == "reset":
            return out
        cc = self.collect_clouds
        self._pending = (ring, K, t_ends, downs if cc else None,
                         dmasks if cc else None, trs if cc else None)
        return out if out is not None else {"phase": "odom", "pending": True,
                                            "t": t_end}

    def _drain_queue_partial(self):
        """Run a partially filled queue scan by scan; sets `_pending`."""
        q, self._scan_queue = self._scan_queue, []
        t_ends, self._pend_t = self._pend_t, []
        rows = []
        for (imu_np, scan_np, t_beg, t_end, last_end) in q:
            ring1 = torch.zeros((1, self._stats_len), device=self.device)
            scal = self._t([t_beg, t_end, last_end, self.jour, 0.0])
            (x, levels, win, mp, preints, ring1, down, dmask, tr) = \
                self._steady_megastep(self.x, self.levels, self.win, self.mp,
                                      self.preints_dev, ring1,
                                      self._t(imu_np), self._t(scan_np), scal)
            self.x, self.levels, self.win, self.mp = x, levels, win, mp
            self.preints_dev = preints
            rows.append((ring1, down, dmask, tr))
        stats = np.stack([_np(r[0][0]) for r in rows])
        cc = self.collect_clouds
        self._pending = (stats, len(q), t_ends,
                         np.stack([_np(r[1]) for r in rows]) if cc else None,
                         np.stack([_np(r[2]) for r in rows]) if cc else None,
                         np.stack([_np(r[3]) for r in rows]) if cc else None)

    def _process_steady_accum(self, imu_blob, scan_blob, scal, t_end):
        """Window-refill scan (lba.mgsize > 1, win_count < W-1): one
        accumulate step, its stats read at once (no BA, no emission)."""
        cfg = self.cfg
        i = self.win_count
        (x_out, levels, win, preints, stats, down, dmask, tr) = \
            self._mega_accum(self.x, self.levels, self.win, self.mp,
                             self.preints_dev, imu_blob, scan_blob, scal, i)
        self.x, self.levels, self.win = x_out, levels, win
        self.preints_dev = preints
        self.scan_count += 1
        if self.collect_clouds:
            self.scan_buf[i] = _np(down)
            self.scan_mask[i] = _np(dmask)
            self.scan_tr[i] = _np(tr)
        self.win_count = i + 1
        st = _np(stats)
        ok = bool(st[0] > 0)
        self.degrade_cnt = max(0, self.degrade_cnt - 1) if ok \
            else self.degrade_cnt + 1
        if self.degrade_cnt > cfg.odom.degrade_bound:
            self.reset(session=self.session + 1)
            return {"phase": "reset", "session": self.session}
        return {"phase": "odom", "ok": ok, "matches": int(st[1]),
                "nnt_eig0": float(st[2]), "t": t_end, "accum": True,
                "hash_dropped": int(st[3])}

    def _flush_pending(self):
        """Emit all deferred state: the pending batch, queued scans and a
        partially filled ring."""
        out = None
        if self._pending is not None:
            out = self._emit_pending()
            if out is not None and out.get("phase") == "reset":
                return out
        if self._scan_queue:
            self._drain_queue_partial()
            out2 = self._emit_pending()
            if out2 is not None:
                out = out2
            if out is not None and out.get("phase") == "reset":
                return out
        if self._ring_fill > 0:
            self._pending = (self._stats_ring, self._ring_fill,
                             list(self._pend_t), None, None, None)
            self._ring_fill = 0
            self._pend_t = []
            out2 = self._emit_pending()
            out = out2 if out2 is not None else out
        return out

    def _emit_pending(self):
        """Read the pending stats (one device->host copy) and emit every
        deferred scan's poses + bookkeeping in order."""
        cfg = self.cfg
        W = cfg.lba.win_size
        mg = cfg.lba.mgsize
        ring, fill, t_ends, down, dmask, tr = self._pending
        self._pending = None
        rows = _np(ring)
        if down is not None:
            down, dmask, tr = _np(down), _np(dmask), _np(tr)
        out = None
        for r in range(fill):
            st = rows[r]
            ok = bool(st[0] > 0)
            matches, nnt_eig0, r0, r1 = st[1], st[2], st[3], st[4]
            v6_np = st[5:5 + 6 * mg].reshape(mg, 6)
            off = 5 + 6 * mg
            e_t = st[off:off + mg]
            e_R = st[off + mg:off + 10 * mg].reshape(mg, 3, 3)
            e_p = st[off + 10 * mg:off + 13 * mg].reshape(mg, 3)
            e_v = st[off + 13 * mg:off + 16 * mg].reshape(mg, 3)
            e_bg = st[off + 16 * mg:off + 19 * mg].reshape(mg, 3)
            e_ba = st[off + 19 * mg:off + 22 * mg].reshape(mg, 3)
            e_g = st[off + 22 * mg:off + 25 * mg].reshape(mg, 3)
            hash_dropped = int(st[off + 25 * mg])
            self.jour += float(np.linalg.norm(e_p[-1] - self._last_p)) \
                if self._last_p is not None else 0.0
            self._last_p = e_p[-1]

            # divergence bookkeeping (reference :1893-1947)
            self.degrade_cnt = max(0, self.degrade_cnt - 1) if ok \
                else self.degrade_cnt + 1
            if self.degrade_cnt > cfg.odom.degrade_bound:
                self.reset(session=self.session + 1)
                return {"phase": "reset", "session": self.session}

            if self.collect_clouds and down is not None:
                self.scan_buf[W - 1] = down[r] if down.ndim == 3 else down
                self.scan_mask[W - 1] = dmask[r] if dmask.ndim == 2 else dmask
                self.scan_tr[W - 1] = tr[r] if tr.ndim == 3 else tr
            for k in range(mg):
                self.scan_poses.append(ScanPose(
                    t=float(e_t[k]), R=e_R[k], p=e_p[k], v=e_v[k],
                    v6=v6_np[k], cloud=self.scan_buf[k].copy(),
                    cloud_mask=self.scan_mask[k].copy(),
                    session=self.session, bg=e_bg[k], ba=e_ba[k], g=e_g[k]))
            self.scan_buf = np.roll(self.scan_buf, -mg, axis=0)
            self.scan_mask = np.roll(self.scan_mask, -mg, axis=0)
            self.scan_tr = np.roll(self.scan_tr, -mg, axis=0)
            self.win_count = W - mg
            out = {"phase": "odom", "ok": ok, "matches": int(matches),
                   "nnt_eig0": float(nnt_eig0), "t": t_ends[r],
                   "ba_r0": float(r0), "ba_r1": float(r1),
                   "hash_dropped": hash_dropped}

        # periodic memory reclamation (idle-time eviction of far-away
        # octrees, voxelslam.cpp:1786-1833): rebuild any level whose table
        # is too full, dropping voxels > evict_dist of travel behind. The
        # check window covers the emission stride max(ring, batch).
        evicted = False
        evict_dropped = 0
        if (cfg.map.evict_check_every > 0
                and self.scan_count % cfg.map.evict_check_every
                < max(self._ring_K, self._batch_K)):
            occ = _np(self._occ_counts(self.levels))
            load = occ / np.array(cfg.map.capacities, np.float64)
            if float(load.max()) > cfg.map.evict_load:
                self.levels, edrop = self._evict(
                    self.levels, torch.tensor(self.jour, dtype=torch.float32,
                                              device=self.device))
                evicted = True
                evict_dropped = int(_np(edrop).sum())
        if out is not None:
            out["evicted"] = evicted
            out["evict_dropped"] = evict_dropped
        return out

    def apply_correction(self, dx_R: np.ndarray, dx_p: np.ndarray,
                         g_update: bool, map_keyframes) -> None:
        """Apply a loop-closure correction between scans (reference
        loop_update, voxelslam.cpp:1255-1373): left-multiply the window by
        dx, rebuild the live map from the keyframes (fixed points) plus the
        corrected window scans, reset the slot indirection, and after a
        cross-session first contact (g_update) re-optimize the window
        with gravity. The emitted ScanPoses were already moved by the loop
        pipeline (shared objects)."""
        self._flush_pending()   # emit the pre-correction state first
        cfg = self.cfg
        W = cfg.lba.win_size
        dR = self._t(dx_R)
        dp = self._t(dx_p)
        win = self.win
        new_g = dR @ win.g[0] if g_update else win.g[0]
        win = dataclasses.replace(
            win, R=dR[None] @ win.R, p=win.p @ dR.T + dp[None],
            v=win.v @ dR.T, g=new_g.expand(win.g.shape).clone())
        self.win = win
        self.mp = torch.arange(W, dtype=torch.int32, device=self.device)
        nvalid = self.win_count

        self.levels = vm.empty_map(cfg.map, self.device)
        for kf in map_keyframes:
            wld = kf.cloud @ kf.R0.T + kf.p0
            self.levels = self._push_fixed(self.levels, self._t(wld),
                                           self._t(kf.mask), self.jour)
        for i in range(nvalid):
            self.levels = self._push_window(
                self.levels, win[i], self._t(self.scan_buf[i]),
                self._t(self.scan_mask[i]), self._t(self.scan_tr[i]),
                self.mp[i], self.jour)
        self.levels = self._refresh(self.levels, win, self.mp, nvalid)

        if (g_update and self.init_done and nvalid >= 2
                and getattr(self, "preints_dev", None) is not None):
            # preints_dev entry k is pair (k, k+1); stale tail entries
            # (>= nvalid - 1) are masked inside _g_reloc
            new_win, _, _ = self._g_reloc(self.levels, win, self.preints_dev,
                                          self.mp, nvalid)
            sel = torch.arange(W, device=self.device) < nvalid
            win = tmap(lambda a, b: torch.where(
                sel.reshape((-1,) + (1,) * (a.dim() - 1)), a, b), new_win, win)
            win = dataclasses.replace(
                win, g=new_win.g[0].expand(win.g.shape).clone())
            self.win = win
            self._gravity = new_win.g[0]
            self.levels = self._refresh(self.levels, win, self.mp, nvalid)

        self.x = dataclasses.replace(
            win[max(nvalid - 1, 0)], cov=self.x.cov, t=self.x.t,
            bg=self.x.bg, ba=self.x.ba)
        if self._last_p is not None:
            self._last_p = np.asarray(dx_R @ self._last_p + dx_p)

    def insert_keyframe_fixed(self, kf) -> None:
        """Mid-term association: fold one historical keyframe cloud into
        the live map as fixed statistics (reference keyframe_loading,
        voxelslam.cpp:1379-1438), refreshing the touched planes."""
        wld = kf.cloud @ kf.R0.T + kf.p0
        self.levels = self._push_fixed_refresh(
            self.levels, self._t(wld), self._t(kf.mask), self.jour,
            self.win, self.mp, self.win_count)

    def flush(self):
        """Emit the remaining window states as ScanPoses (end of run)."""
        self._flush_pending()
        for k in range(self.win_count):
            s = self.win[k]
            self.scan_poses.append(ScanPose(
                t=float(s.t), R=_np(s.R), p=_np(s.p), v=_np(s.v),
                v6=np.ones(6, np.float32), cloud=self.scan_buf[k].copy(),
                cloud_mask=self.scan_mask[k].copy(), session=self.session,
                bg=_np(s.bg), ba=_np(s.ba), g=_np(s.g)))
        self.win_count = 0
        return self.scan_poses
