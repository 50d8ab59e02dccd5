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
With step graphs the rebuild, the gravity-joint solve, a reload and an
eviction are one replay each ("correction_SxN", "g_reloc",
"keyframe_reload_N", "evict"). The rebuild has one shape whatever the
number of keyframes and of valid window frames: the absent keyframes and
the frames from `win_count` on are inserted all masked, which leaves
every bit of the map as inserting nothing does (the frames' slots are
empty in the new map).

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
from ..core.tensors import put_row, stack, take_row, tmap
from ..imu import ekf, preintegration as pre
from ..map import voxel_map as vm
from ..ba import optimizers as opt
from ..odom import iekf
from ..ops.downsample import voxel_downsample
from ..utils import telemetry
from .graphs import StepGraph, host_arrays

# host-side fields a carry snapshot needs besides the device tensors
CARRY_HOST_FIELDS = ("win_count", "init_done", "jour", "session",
                     "scan_count", "last_scan_end", "degrade_cnt", "_last_p",
                     "_gravity", "_bg0", "_scale_gravity")


def _np(x):
    """A host copy (never a view: on the CPU a step graph's buffers are
    overwritten in place by the next dispatch)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def fetch(*xs):
    """One device-to-host copy of several tensors -> float32 numpy arrays
    of their shapes."""
    return host_arrays(*(x.to(torch.float32) for x in xs))


# keyframe slots of a correction's map rebuild: the loop pipeline hands
# over the current session's last 5 (`LoopPipeline._optimize`)
MAP_KEYFRAMES = 5
# the steady dispatches: one graph each, pools of their own
_STEADY_GRAPHS = ("steady", "steady_k", "accum")


def _roll(a, mg):
    return torch.cat([a[mg:], a[:mg]], dim=0)


def _dropped(touched):
    """(2,) float32: the voxels the hash could not place and the points the
    dedup dropped past `unique_max`, over the levels of a fused insert."""
    return torch.stack([x for t in touched for x in t[2:]]).reshape(
        -1, 2).sum(0).to(torch.float32)


def _tkey(t) -> float:
    """A scan's end time as the steady step keeps it (float32)."""
    return float(np.float32(t))


@dataclasses.dataclass
class InitWindow:
    """The init window on the device, row i the window's scan i: its
    downsampled body-frame cloud, mask and noise records, and the IMU
    mid-point samples of the interval that ends at it (row 0's stay zero:
    the window's first scan has no pair). What the JAX package keeps in
    its host `scan_buf`/`imu_buf_*` during init; the host copies are taken
    once, where first read."""
    scans: torch.Tensor     # (W, P, 3)
    masks: torch.Tensor     # (W, P)
    trs: torch.Tensor       # (W, P, NV)
    imu_g: torch.Tensor     # (W, M, 3), M = imu_max - 1
    imu_a: torch.Tensor     # (W, M, 3)
    imu_dt: torch.Tensor    # (W, M)
    imu_m: torch.Tensor     # (W, M)

    @staticmethod
    def zeros(W: int, P: int, M: int, device) -> "InitWindow":
        def z(*shape):
            return torch.zeros(shape, device=device)
        return InitWindow(z(W, P, 3), z(W, P), z(W, P, vm.NV), z(W, M, 3),
                          z(W, M, 3), z(W, M), z(W, M))

    def inputs(self) -> tuple:
        return (self.scans, self.masks, self.trs, self.imu_g, self.imu_a,
                self.imu_dt, self.imu_m)


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
    default; raises when CUDA is absent and no device is named).

    With `step_graphs` (the default) every steady dispatch
    (`_steady_megastep`, `_steady_megastep_k`, `_mega_accum`, the scans
    of a partial queue drain) runs through a `graphs.StepGraph`: one CUDA
    graph replay a dispatch over static carry buffers updated in place,
    the counterpart of the JAX package's donated jits (on the CPU the same
    buffers, run eagerly). So does the init path, the counterpart of the
    JAX package's init jits: an init-window scan is one replay
    ("init_accum"), a dynamic-init round one replay of its phase's graph
    ("init_round", "init_round_aligned", the phase's gates baked in as
    the eager round's floats) and a successful init's map build, refresh,
    re-integration and first window BA one ("init_map"); the gravity
    alignment between the phases runs eagerly (a few dozen ops, whose
    capture costs more than it saves). The host reads a round's
    residuals and degeneracy in one copy and decides between rounds, as
    both packages' loops do. So do the loop-closure hooks: a correction's
    map rebuild, its gravity-joint window solve, a keyframe reload and an
    eviction (the counterparts of `_jit_push_fixed` + `_jit_push` +
    `_jit_refresh`, `_jit_g_reloc`, `_jit_push_fixed_refresh` and
    `_jit_evict`); the load check before an eviction (`_occ_counts`, three
    sums every `evict_check_every` scans) runs eagerly. The graphs persist
    across `reset`; the init and hook graphs share one memory pool.
    `step_graphs=False` runs the same steps eagerly, each returning a new
    carry, with bitwise the same results."""

    def __init__(self, cfg: SlamConfig, collect_clouds: bool = False,
                 device=None, step_graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        # when False, skip the per-scan device->host cloud fetch
        self.collect_clouds = collect_clouds
        self.step_graphs = step_graphs
        self._graphs: dict[str, StepGraph] = {}
        self._pool = None            # the init graphs' memory pool (CUDA)
        self._eager_inputs: dict[str, tuple] = {}
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

    def _run(self, name, fn, carry, inputs):
        """fn(carry, inputs) -> (carry, extras) for `inputs` numpy arrays,
        tensors on the device, or None (the last call's of `name`): through
        the StepGraph `name` (made at first use: its shapes come from the
        config), or eagerly without step graphs. A caller that keeps an
        extra across the next dispatch clones it (a replay overwrites it)."""
        if not self.step_graphs:
            if inputs is not None:
                self._eager_inputs[name] = tuple(
                    torch.as_tensor(a, device=self.device) for a in inputs)
            return fn(carry, self._eager_inputs[name])
        g = self._graphs.get(name)
        if g is None:
            # the init path's and the hooks' graphs share one pool: they
            # never run at once, and what one hands out is read (a round's
            # residuals, an eviction's drops), copied into the steady
            # step's buffers (the map build's outputs) or is a carry (the
            # hooks' maps, outside the pool) before another replays; the
            # map build is captured before any hook, so no hook's capture
            # takes the blocks of its outputs
            pool = None
            if name not in _STEADY_GRAPHS and self.device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                pool = self._pool
            g = self._graphs[name] = StepGraph(fn, self.device, pool=pool,
                                               name=name)
        return g(carry, inputs)

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
        # the window's clouds on the host for the steady phase's emission
        # (during init they live in init_win, on the device)
        self.scan_buf = np.zeros((W, P, 3), np.float32)
        self.scan_mask = np.zeros((W, P), np.float32)
        self.scan_tr = np.zeros((W, P, vm.NV), np.float32)
        self.init_win = InitWindow.zeros(W, P, cfg.odom.imu_max - 1, dev)
        self.degrade_cnt = 0
        self._last_p = None
        self._pending = None
        self._ring_K = 1 if self.collect_clouds else max(1, cfg.odom.stats_ring)
        # K-scan dispatch only in the plain steady flow: cloud collection
        # and mgsize > 1 decide on the host between scans
        self._batch_K = (1 if self.collect_clouds or cfg.lba.mgsize > 1
                         else max(1, cfg.odom.batch_scans))
        self._scan_queue: list = []
        # ok, matches, nnt eig0, r0, r1, the emitted frames (31 a frame),
        # the hash's and the dedup's dropped counts
        self._stats_len = 5 + 31 * cfg.lba.mgsize + 2
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
            # with telemetry on: a scan's end time (float32, as the step
            # keeps it) -> the scans handed in before it (the emission's
            # hold)
            self._scan_at: dict[float, int] = {}
            self._n_in = 0
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

    def _imu_mids(self, imu_ts, gyr, acc, imask, last_end, scan_end):
        """Mid-point IMU samples over exactly (last_end, scan_end] (the
        reference rewrites the boundary IMU stamps the same way,
        ekf_imu.hpp:125-133): gyr, acc, dt and mask rows."""
        g_mid = 0.5 * (gyr[:-1] + gyr[1:])
        a_mid = 0.5 * (acc[:-1] + acc[1:])
        heads = torch.minimum(torch.maximum(imu_ts[:-1], last_end), scan_end)
        tails = torch.minimum(torch.maximum(imu_ts[1:], last_end), scan_end)
        dt = (tails - heads) * (imask[:-1] * imask[1:])
        return g_mid, a_mid, dt, imask[1:]

    def _preint_interval(self, imu_ts, gyr, acc, imask, last_end, scan_end,
                         bg, ba):
        """Preintegration over exactly (last_end, scan_end]."""
        g_mid, a_mid, dt, m = self._imu_mids(imu_ts, gyr, acc, imask,
                                             last_end, scan_end)
        return g_mid, a_mid, dt, self._integrate_preint(g_mid, a_mid, dt, m,
                                                        bg, ba)

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

        mark = telemetry.mark       # a stage's end, in a captured step
        x_prop, body = self._prop_deskew(state, imu_ts, gyr, acc, imask,
                                         scan_beg, scan_end, last_end, pts,
                                         offsets, pmask)
        mark("prop_deskew")
        down, dmask, var_b, tr = self._downsample_var(body, pmask)
        mark("downsample")
        _, _, _, p_new = self._preint_interval(imu_ts, gyr, acc, imask,
                                               last_end, scan_end,
                                               x_prop.bg, x_prop.ba)
        preints = tmap(lambda a, b: put_row(a, W - 2, b), preints, p_new)
        mark("preint")

        st, ok, diag = iekf.iekf_update(
            x_prop, levels, cfg.map, down, var_b, dmask,
            max_iter=cfg.odom.max_iter, degrade_eig=cfg.odom.degrade_eig)
        mark("iekf")

        win = tmap(lambda a, b: put_row(a, W - 1, b), win, st)
        wld = down @ st.R.T + st.p
        levels, touched = vm.insert_scan_fused(
            levels, cfg.map, wld, down, tr, dmask, mp[W - 1], jour, st.R,
            st.p)
        mark("insert")
        levels = vm.refresh_planes(levels, cfg.map, win.R, win.p, mp, W,
                                   touched=touched)
        mark("refresh")

        factors = vm.harvest_t(levels, cfg.map, mp, cfg.lba.factor_max)
        mark("harvest")
        new_win, H, r0, r1, conv = opt.lm_li(
            win, factors, preints, torch.ones((W,), device=self.device),
            imu_coef=cfg.lba.imu_coef, max_iter=cfg.lba.max_iter)
        mark("window_ba")
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
        f32 = torch.float32
        stats = torch.cat([
            torch.stack([ok.to(f32), diag["matches"].to(f32),
                         diag["nnt_eig"][0], r0, r1]),
            v6.reshape(-1), emitted.t.reshape(-1), emitted.R.reshape(-1),
            emitted.p.reshape(-1), emitted.v.reshape(-1),
            emitted.bg.reshape(-1), emitted.ba.reshape(-1),
            emitted.g.reshape(-1), _dropped(touched),
        ])
        ring = ring.index_copy(0, slot.reshape(1), stats[None])
        mark("marginalize")
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

    def _steady_fn(self, carry, inputs):
        out = self._steady_megastep(*carry, *inputs)
        return out[:6], out[6:]

    def _steady_k_fn(self, carry, inputs):
        out = self._steady_megastep_k(*carry, *inputs)
        return out[:5], out[5:]

    def _accum_fn(self, carry, inputs):
        x, levels, win, mp, preints = carry
        imu_blob, scan_blob, scal, frame_idx = inputs
        st, levels, win, preints, *extras = self._mega_accum(
            x, levels, win, mp, preints, imu_blob, scan_blob, scal,
            frame_idx[0])
        return (st, levels, win, mp, preints), extras

    def _mega_accum(self, state, levels, win, mp, preints, imu_blob,
                    scan_blob, scal, frame_idx):
        """Window-refill scan for lba.mgsize > 1: propagate + deskew +
        downsample + preintegrate + iEKF + fused insert into logical slot
        `frame_idx` (an int or a 0-dim device tensor, so one step graph
        serves every refill slot) + touched refresh, with no BA (the
        reference optimizes only once the window is full,
        voxelslam.cpp:1951)."""
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
        preints = tmap(lambda a, b: put_row(a, frame_idx - 1, b), preints,
                       p_new)
        st, ok, diag = iekf.iekf_update(
            x_prop, levels, cfg.map, down, var_b, dmask,
            max_iter=cfg.odom.max_iter, degrade_eig=cfg.odom.degrade_eig)
        win = tmap(lambda a, b: put_row(a, frame_idx, b), win, st)
        wld = down @ st.R.T + st.p
        levels, touched = vm.insert_scan_fused(
            levels, cfg.map, wld, down, tr, dmask, take_row(mp, frame_idx),
            jour, st.R, st.p)
        levels = vm.refresh_planes(levels, cfg.map, win.R, win.p, mp,
                                   frame_idx + 1, touched=touched)
        f32 = torch.float32
        stats = torch.cat([torch.stack([ok.to(f32), diag["matches"].to(f32),
                                        diag["nnt_eig"][0]]),
                           _dropped(touched)])
        return st, levels, win, preints, stats, down, dmask, tr

    def _init_accum_fn(self, carry, inputs):
        """One scan of the init window, the counterpart of the JAX
        package's `_jit_prop_deskew`, `_jit_downsample`, `_jit_integrate`
        and `_jit_kdtree_step` calls of an init scan: propagate + de-skew,
        downsample, the scan's IMU mid-points, the kd-tree LIO update
        against the accumulated init cloud, and the scan's rows of the
        window at slot scal[3] (the JAX package's preintegration of the
        scan is never read: a successful init integrates the window again
        at the optimized biases). carry (x, init_cloud, init_cloud_mask,
        win, init_win); inputs the steady step's IMU and scan blobs and
        scal [t_beg, t_end, last_end, slot]; no extras."""
        x, cloud, cmask, win, iw = carry
        imu_blob, scan_blob, scal = inputs
        imu_ts, gyr, acc, imask = (imu_blob[:, 0], imu_blob[:, 1:4],
                                   imu_blob[:, 4:7], imu_blob[:, 7])
        pts, offsets, pmask = scan_blob[:, 0:3], scan_blob[:, 3], scan_blob[:, 4]
        scan_beg, scan_end, last_end = scal[0], scal[1], scal[2]
        slot = scal[3].to(torch.int64)
        x_prop, body = self._prop_deskew(x, imu_ts, gyr, acc, imask,
                                         scan_beg, scan_end, last_end, pts,
                                         offsets, pmask)
        down, dmask, _, tr = self._downsample_var(body, pmask)
        st, cloud, cmask = self._kdtree_step(x_prop, cloud, cmask, down,
                                             dmask)
        paired = slot > 0           # the window's first scan has no pair
        imu = [put_row(old, slot, torch.where(paired, new,
                                              take_row(old, slot)))
               for old, new in zip(iw.inputs()[3:], self._imu_mids(
                   imu_ts, gyr, acc, imask, last_end, scan_end))]
        iw = InitWindow(put_row(iw.scans, slot, down),
                        put_row(iw.masks, slot, dmask),
                        put_row(iw.trs, slot, tr), *imu)
        win = tmap(lambda a, b: put_row(a, slot, b), win, st)
        return (st, cloud, cmask, win, iw), ()

    def _init_round_fn(self, aligned: bool):
        """A dynamic-init round at the relaxed (before the gravity
        alignment) or the production plane gates, as the eager loop passes
        them (np.float32), baked in: states, init_win.inputs() ->
        states, ([r0, r1, ev0],). The counterpart of `_jit_init_round`,
        which takes the gates as traced scalars."""
        cfg = self.cfg
        if aligned:
            gates = cfg.map.min_eigen_value, cfg.map.plane_thr[0]
        else:
            gates = cfg.init.min_eigen_value, cfg.init.plane_thr
        min_eig, thr = np.float32(gates[0]), np.float32(gates[1])

        def rnd(states, inputs):
            scans, masks, trs, *imu = inputs
            states, r0, r1, ev = self._init_round(
                scans, masks, trs, states, *imu, min_eig, thr)
            return states, (torch.stack([r0, r1, ev]),)
        return rnd

    def _init_map_fn(self, states, inputs):
        """Once a successful init, the counterpart of the JAX package's W
        `_jit_push`, `_jit_refresh`, W - 1 `_jit_integrate` and
        `_jit_ba_slide` calls: the map from the window's scans at the
        optimized states (at init the slot map is arange(W), so frame i
        is slot i), its planes, the window's preintegrations at the
        optimized biases, and one window BA + marginalize + slide.
        states, init_win.inputs() + (jour (1,),) -> the slid window, (x,
        levels, mp, post-slide preintegration pairs, the emitted frames'
        v6, t, R, p, v, bg, ba, g and the BA's r0, r1 packed in one
        vector)."""
        cfg = self.cfg
        W, mg = cfg.lba.win_size, cfg.lba.mgsize
        scans, masks, trs, imu_g, imu_a, imu_dt, imu_m, jour = inputs
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        levels = vm.empty_map(cfg.map, self.device)
        for i in range(W):
            levels = self._push_window(levels, states[i], scans[i], masks[i],
                                       trs[i], i, jour[0])
        levels = self._refresh(levels, states, mp, W)
        preints = stack([
            self._integrate_preint(imu_g[i], imu_a[i], imu_dt[i], imu_m[i],
                                   states.bg[i - 1], states.ba[i - 1])
            for i in range(1, W)])
        levels, new_win, win_shift, mp_new, v6, r0, r1 = \
            self._window_ba_slide(levels, states, preints, mp)
        # after the slide entry k is pair (k, k+1); the stale tail entries
        # are overwritten before a BA reads them
        preints = tmap(lambda a: torch.cat([a[mg:]] + [a[-1:]] * mg), preints)
        e = new_win[0:mg]
        out = torch.cat([v6.reshape(-1)] + [
            getattr(e, f).reshape(-1)
            for f in ("t", "R", "p", "v", "bg", "ba", "g")]
            + [torch.stack([r0, r1])])
        return win_shift, (new_win[W - 1], levels, mp_new, preints, out)

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
        target = torch.stack([gn * 0.0, gn * 0.0, -gn])    # (0, 0, -1) gn
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

    def _push_fixed_refresh(self, levels, pts_world, mask, jour):
        """insert_fixed + plane refresh of the touched voxels (a keyframe
        reloaded in the steady phase must give matchable planes at once).
        The touched refit reads the running totals alone, no window pose."""
        tr = pts_world.new_zeros((pts_world.shape[0],))
        levels, touched = vm.insert_fixed_touched(
            levels, self.cfg.map, pts_world, tr, mask, jour)
        return vm.refresh_planes(levels, self.cfg.map, None, None, None,
                                 None, touched=touched)

    def _occ_counts(self, levels):
        return torch.stack([torch.sum(lv.occ) for lv in levels])

    def _correction_fn(self, carry, inputs):
        """A loop correction's window and map, the counterpart of the JAX
        package's `_jit_push_fixed`, `_jit_push` and `_jit_refresh` calls of
        `apply_correction`: the window left-multiplied by dx (its gravity
        too where g_update), then a new map of the keyframes' fixed points
        and the corrected window's scans (frame i into slot i: the slot map
        restarts at arange(W)), refreshed over the valid frames. carry
        (levels, win); inputs the keyframes' world clouds (S, N, 3) and
        masks (S, N), the window's scans (W, P, 3), masks (W, P) and noise
        records (W, P, NV), scal [dx_R (9), dx_p (3), g_update, jour] and
        nvalid (1,). Absent keyframes and the frames from nvalid on come
        all masked; no extras."""
        cfg = self.cfg
        W = cfg.lba.win_size
        _, win = carry
        kf_wld, kf_mask, scans, masks, trs, scal, nvalid = inputs
        dR, dp, jour = scal[0:9].reshape(3, 3), scal[9:12], scal[13]
        g0 = win.g[0]
        new_g = torch.where(scal[12] > 0, dR @ g0, g0)
        win = dataclasses.replace(
            win, R=dR[None] @ win.R, p=win.p @ dR.T + dp[None],
            v=win.v @ dR.T, g=new_g.expand(win.g.shape).clone())
        levels = vm.empty_map(cfg.map, self.device)
        for s in range(kf_wld.shape[0]):
            levels = self._push_fixed(levels, kf_wld[s], kf_mask[s], jour)
        for i in range(W):
            levels = self._push_window(levels, win[i], scans[i], masks[i],
                                       trs[i], i, jour)
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        return (self._refresh(levels, win, mp, nvalid[0]), win), ()

    def _g_reloc_fn(self, carry, inputs):
        """After a cross-session correction, the counterpart of the JAX
        package's `_jit_g_reloc` and the `_jit_refresh` after it: the
        gravity-joint window BA on the rebuilt map over the first nvalid
        frames, whose states it keeps (its gravity for every frame), then
        the planes refit. carry (levels, win, preints); inputs nvalid
        (1,); no extras."""
        W = self.cfg.lba.win_size
        levels, win, preints = carry
        nvalid = inputs[0][0]
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        new_win, _, _ = self._g_reloc(levels, win, preints, mp, nvalid)
        sel = torch.arange(W, device=self.device) < nvalid
        win = tmap(lambda a, b: torch.where(
            sel.reshape((-1,) + (1,) * (a.dim() - 1)), a, b), new_win, win)
        win = dataclasses.replace(
            win, g=new_win.g[0].expand(win.g.shape).clone())
        return (self._refresh(levels, win, mp, nvalid), win, preints), ()

    def _keyframe_reload_fn(self, carry, inputs):
        """A keyframe folded into the live map, the counterpart of
        `_jit_push_fixed_refresh`: carry (levels,); inputs the world cloud
        (N, 3), its mask (N,) and jour (1,); no extras."""
        wld, mask, jour = inputs
        return (self._push_fixed_refresh(carry[0], wld, mask, jour[0]),), ()

    def _evict_fn(self, carry, inputs):
        """Distance eviction, the counterpart of `_jit_evict`: carry
        (levels,); inputs jour (1,); extras (voxels dropped a level,)."""
        levels, dropped = vm.evict(carry[0], inputs[0][0],
                                   self.cfg.map.evict_dist)
        return (levels,), (dropped,)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _pad_points(self, pts, offsets=None):
        P = self.cfg.odom.point_max
        n = min(len(pts), P)
        telemetry.count("odom.points_truncated", len(pts) - n)
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
        with telemetry.span("odom"):
            if telemetry.on():
                self._scan_at[_tkey(t_end)] = self._n_in
                self._n_in += 1
            return self._process_scan(points, offsets, imu_ts, imu_gyr,
                                      imu_acc, t_beg, t_end)

    def _process_scan(self, points, offsets, imu_ts, imu_gyr, imu_acc,
                      t_beg, t_end):
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

        with telemetry.span("odom.pack"):
            pts_j, off_j, pmask = self._pad_points(points, offsets)
            ts_j, gyr_j, acc_j, imask = self._pad_imu(imu_ts, imu_gyr,
                                                      imu_acc)
            imu_np = np.concatenate([ts_j[:, None], gyr_j, acc_j,
                                     imask[:, None]], axis=1,
                                    dtype=np.float32)
            scan_np = np.concatenate([pts_j, off_j[:, None], pmask[:, None]],
                                     axis=1, dtype=np.float32)
        last_end = self.last_scan_end if self.last_scan_end is not None else t_beg
        self.last_scan_end = t_end
        if self.init_done:
            return self._process_steady_fused(imu_np, scan_np, t_beg, t_end,
                                              last_end)
        return self._process_init(imu_np, scan_np, t_beg, t_end, last_end)

    # --- init phase -----------------------------------------------------

    def _process_init(self, imu_np, scan_np, t_beg, t_end, last_end):
        """An init-window scan (one "init_accum" dispatch, no host read);
        the scan that fills the window runs the dynamic init."""
        i = self.win_count
        scal = np.array([t_beg, t_end, last_end, i], np.float32)
        carry, _ = self._run(
            "init_accum", self._init_accum_fn,
            (self.x, self.init_cloud, self.init_cloud_mask, self.win,
             self.init_win), (imu_np, scan_np, scal))
        (self.x, self.init_cloud, self.init_cloud_mask, self.win,
         self.init_win) = carry
        self.win_count += 1
        self.scan_count += 1
        if self.win_count < self.cfg.lba.win_size:
            return {"phase": "init_accum", "win": self.win_count}
        return self._dynamic_init()

    def _dynamic_init(self):
        """motion_init, two phases (voxelslam.cpp:619-767): relaxed
        thresholds until the first within-round convergence (round >= 2),
        then align gravity, restore the production thresholds, tighten the
        gate to 0.01 and converge again. A round is one dispatch of its
        phase's graph, the window staged once a phase; the host reads the
        round's r0, r1 and degeneracy in one copy and decides. On success
        `_init_map` builds the map and runs the first window BA; on failure
        the pipeline resets into a new session."""
        cfg = self.cfg
        inputs = self.init_win.inputs()
        states, staged = self.win, set()
        ev0 = 0.0
        aligned = False
        conv_thr = cfg.init.converge_thre
        for rnd in range(cfg.init.max_rounds):
            name = "init_round_aligned" if aligned else "init_round"
            states, (res,) = self._run(name, self._init_round_fn(aligned),
                                       states,
                                       None if name in staged else inputs)
            staged.add(name)
            with telemetry.span("odom.readback"):
                res = _np(res)
            r0, r1, ev = (float(v) for v in res)
            if abs(r0 - r1) / max(r0, 1e-9) < conv_thr and rnd >= 2:
                ev0 = ev
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
        r0, r1 = self._init_map(states)
        return {"phase": "init_done", "g_norm": g_norm, "ev0": float(ev0),
                "ba_r0": r0, "ba_r1": r1}

    def _init_map(self, states):
        """A successful init: one "init_map" dispatch (map, refresh,
        re-integration, window BA + marginalize + slide), then one host
        copy of the emitted frames and the window's clouds. Returns the
        BA's (r0, r1)."""
        cfg = self.cfg
        W, mg = cfg.lba.win_size, cfg.lba.mgsize
        self._gravity = states.g[0].clone()   # a round graph's buffer
        jour = torch.full((1,), self.jour, device=self.device)
        win, (x, levels, mp, preints, out) = self._run(
            "init_map", self._init_map_fn, states,
            self.init_win.inputs() + (jour,))
        iw = self.init_win
        with telemetry.span("odom.readback"):
            out, mp_was, scans, masks, trs = fetch(
                out, self.mp, iw.scans, iw.masks, iw.trs)
        assert np.array_equal(mp_was, np.arange(W)), \
            "the init window's slot map is not arange(W)"
        v6 = out[:6 * mg].reshape(mg, 6)
        o = 6 * mg
        e_t = out[o:o + mg]
        e_R = out[o + mg:o + 10 * mg].reshape(mg, 3, 3)
        e_p, e_v, e_bg, e_ba, e_g = (
            out[o + j * mg:o + (j + 3) * mg].reshape(mg, 3)
            for j in (10, 13, 16, 19, 22))
        for k in range(mg):
            self.scan_poses.append(ScanPose(
                t=float(e_t[k]), R=e_R[k].copy(), p=e_p[k].copy(),
                v=e_v[k].copy(), v6=v6[k].copy(), cloud=scans[k].copy(),
                cloud_mask=masks[k].copy(), session=self.session,
                bg=e_bg[k].copy(), ba=e_ba[k].copy(), g=e_g[k].copy()))
            if telemetry.on():
                self._emitted(float(e_t[k]), self._n_in - 1)
        self.x, self.levels, self.win, self.mp = x, levels, win, mp
        self.preints_dev = preints
        self.scan_buf = np.roll(scans, -mg, axis=0)
        self.scan_mask = np.roll(masks, -mg, axis=0)
        self.scan_tr = np.roll(trs, -mg, axis=0)
        self.win_count = W - mg
        self.init_done = True
        return float(out[-2]), float(out[-1])

    def _host_window(self):
        """During init the window's clouds live on the device: copy its
        first win_count rows to the host buffers (flush, a correction)."""
        if self.init_done or not self.win_count:
            return
        n = self.win_count
        iw = self.init_win
        (self.scan_buf[:n], self.scan_mask[:n],
         self.scan_tr[:n]) = fetch(iw.scans[:n], iw.masks[:n], iw.trs[:n])

    # --- steady phase ----------------------------------------------------

    def _process_steady_fused(self, imu_np, scan_np, t_beg, t_end, last_end):
        """Steady phase: one megastep per scan (or per `batch_scans`
        queued scans). Stats are read back once per ring fill, after the
        next scan was dispatched, so emission lags up to ring+1 scans."""
        if self._batch_K > 1:
            return self._process_steady_batched(imu_np, scan_np, t_beg, t_end,
                                                last_end)
        scal = np.array([t_beg, t_end, last_end, self.jour,
                         float(self._ring_fill)], np.float32)
        if self.cfg.lba.mgsize > 1:
            # the refill decision needs an up-to-date win_count
            out = self._flush_pending()
            if out is not None and out.get("phase") == "reset":
                return out
            if self.win_count < self.cfg.lba.win_size - 1:
                return self._process_steady_accum(imu_np, scan_np, scal,
                                                  t_end)
        ((x_out, levels, win_next, mp_new, preints, ring),
         (down, dmask, tr)) = self._run(
            "steady", self._steady_fn,
            (self.x, self.levels, self.win, self.mp, self.preints_dev,
             self._stats_ring), (imu_np, scan_np, scal))
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
            # the next dispatch overwrites the ring and the clouds in place
            cc = self.collect_clouds
            self._pending = (self._stats_ring.clone(), self._ring_fill,
                             list(self._pend_t), down.clone() if cc else None,
                             dmask.clone() if cc else None,
                             tr.clone() if cc else None)
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
        imu_b = np.stack([e[0] for e in q])
        scan_b = np.stack([e[1] for e in q])
        scals = np.array([[e[2], e[3], e[4], self.jour, float(k)]
                          for k, e in enumerate(q)], np.float32)
        ((x, levels, win, mp, preints), (ring, downs, dmasks, trs)) = \
            self._run("steady_k", self._steady_k_fn,
                      (self.x, self.levels, self.win, self.mp,
                       self.preints_dev), (imu_b, scan_b, scals))
        self.x, self.levels, self.win, self.mp = x, levels, win, mp
        self.preints_dev = preints
        out = None
        if self._pending is not None:
            out = self._emit_pending()
        if out is not None and out.get("phase") == "reset":
            return out
        cc = self.collect_clouds     # the next replay overwrites these
        self._pending = (ring.clone(), K, t_ends,
                         downs.clone() if cc else None,
                         dmasks.clone() if cc else None,
                         trs.clone() if cc else None)
        return out if out is not None else {"phase": "odom", "pending": True,
                                            "t": t_end}

    def _drain_queue_partial(self):
        """Run a partially filled queue scan by scan through the K = 1 step
        graph ("steady", the JAX package's `_jit_megastep`); sets
        `_pending`."""
        q, self._scan_queue = self._scan_queue, []
        t_ends, self._pend_t = self._pend_t, []
        rows = []
        cc = self.collect_clouds
        for (imu_np, scan_np, t_beg, t_end, last_end) in q:
            ring1 = torch.zeros((1, self._stats_len), device=self.device)
            scal = np.array([t_beg, t_end, last_end, self.jour, 0.0],
                            np.float32)
            ((self.x, self.levels, self.win, self.mp, self.preints_dev, ring1),
             clouds) = self._run(
                "steady", self._steady_fn,
                (self.x, self.levels, self.win, self.mp, self.preints_dev,
                 ring1), (imu_np, scan_np, scal))
            # the next replay overwrites the ring and the clouds
            rows.append((ring1.clone(),) + (tuple(c.clone() for c in clouds)
                                            if cc else ()))
        self._pending = (torch.cat([r[0] for r in rows]), len(q), t_ends) + (
            tuple(torch.stack([r[j] for r in rows]) for j in (1, 2, 3))
            if cc else (None, None, None))

    def _process_steady_accum(self, imu_np, scan_np, scal, t_end):
        """Window-refill scan (lba.mgsize > 1, win_count < W-1): one
        accumulate step, its stats read at once (no BA, no emission)."""
        cfg = self.cfg
        i = self.win_count
        ((x_out, levels, win, _, preints), (stats, down, dmask, tr)) = \
            self._run("accum", self._accum_fn,
                      (self.x, self.levels, self.win, self.mp,
                       self.preints_dev),
                      (imu_np, scan_np, scal, np.array([i], np.int64)))
        self.x, self.levels, self.win = x_out, levels, win
        self.preints_dev = preints
        self.scan_count += 1
        if self.collect_clouds:
            with telemetry.span("odom.readback"):
                self.scan_buf[i] = _np(down)
                self.scan_mask[i] = _np(dmask)
                self.scan_tr[i] = _np(tr)
        self.win_count = i + 1
        with telemetry.span("odom.readback"):
            st = _np(stats)
        telemetry.count("map.hash_dropped", int(st[3]))
        telemetry.count("map.unique_dropped", int(st[4]))
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

    def _emitted(self, t, k_ba):
        """Telemetry of one emitted pose of time t, let go by the BA of
        scan k_ba: the scans up to its own are forgotten and, where its
        scan is known, the pose counts with the scans between its own and
        k_ba (the window) and from k_ba to the scan now handed in (the
        hold: the batch queue and the deferred read)."""
        at = self._scan_at
        k = at.get(_tkey(t))
        while at:
            first = next(iter(at))
            if first > _tkey(t):
                break
            del at[first]
        if k is not None:
            telemetry.count("odom.poses_emitted")
            telemetry.count("odom.emit_window_scans", k_ba - k)
            telemetry.count("odom.emit_hold_scans", self._n_in - 1 - k_ba)

    def _emit_pending(self):
        with telemetry.span("odom.emit"):
            return self._emit_pending_rows()

    def _emit_pending_rows(self):
        """Read the pending stats (one device->host copy) and emit every
        deferred scan's poses + bookkeeping in order."""
        cfg = self.cfg
        W = cfg.lba.win_size
        mg = cfg.lba.mgsize
        ring, fill, t_ends, down, dmask, tr = self._pending
        self._pending = None
        with telemetry.span("odom.readback"):
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
            telemetry.count("map.hash_dropped", hash_dropped)
            telemetry.count("map.unique_dropped", int(st[off + 25 * mg + 1]))
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
            k_ba = (self._scan_at.get(_tkey(t_ends[r])) if telemetry.on()
                    else None)
            for k in range(mg):
                self.scan_poses.append(ScanPose(
                    t=float(e_t[k]), R=e_R[k], p=e_p[k], v=e_v[k],
                    v6=v6_np[k], cloud=self.scan_buf[k].copy(),
                    cloud_mask=self.scan_mask[k].copy(),
                    session=self.session, bg=e_bg[k], ba=e_ba[k], g=e_g[k]))
                if k_ba is not None:
                    self._emitted(float(e_t[k]), k_ba)
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
            with telemetry.span("odom.evict_check"):
                occ = _np(self._occ_counts(self.levels))
                load = occ / np.array(cfg.map.capacities, np.float64)
                if float(load.max()) > cfg.map.evict_load:
                    (self.levels,), (edrop,) = self._run(
                        "evict", self._evict_fn, (self.levels,),
                        (np.array([self.jour], np.float32),))
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
        with gravity. The rebuild is one dispatch (`_correction_fn`), the
        gravity-joint solve another (`_g_reloc_fn`). The emitted ScanPoses
        were already moved by the loop pipeline (shared objects)."""
        with telemetry.span("loop.correction"):
            self._apply_correction(dx_R, dx_p, g_update, map_keyframes)

    def _apply_correction(self, dx_R, dx_p, g_update, map_keyframes):
        self._flush_pending()   # emit the pre-correction state first
        self._host_window()
        cfg = self.cfg
        W = cfg.lba.win_size
        nvalid = self.win_count
        f32 = np.float32
        S = max(MAP_KEYFRAMES, len(map_keyframes))
        N = max((len(kf.cloud) for kf in map_keyframes),
                default=cfg.odom.point_max)
        kf_wld = np.zeros((S, N, 3), f32)
        kf_mask = np.zeros((S, N), f32)
        for s, kf in enumerate(map_keyframes):
            n = len(kf.cloud)
            kf_wld[s, :n] = kf.cloud @ kf.R0.T + kf.p0
            kf_mask[s, :n] = kf.mask
        scans = np.zeros_like(self.scan_buf)
        masks = np.zeros_like(self.scan_mask)
        trs = np.zeros_like(self.scan_tr)
        scans[:nvalid] = self.scan_buf[:nvalid]
        masks[:nvalid] = self.scan_mask[:nvalid]
        trs[:nvalid] = self.scan_tr[:nvalid]
        scal = np.concatenate([np.asarray(dx_R, f32).reshape(-1),
                               np.asarray(dx_p, f32),
                               [bool(g_update), self.jour]]).astype(f32)
        nv = np.array([nvalid], np.int64)
        (self.levels, self.win), _ = self._run(
            f"correction_{S}x{N}", self._correction_fn,
            (self.levels, self.win),
            (kf_wld, kf_mask, scans, masks, trs, scal, nv))
        self.mp = torch.arange(W, dtype=torch.int32, device=self.device)

        if (g_update and self.init_done and nvalid >= 2
                and getattr(self, "preints_dev", None) is not None):
            # preints_dev entry k is pair (k, k+1); stale tail entries
            # (>= nvalid - 1) are masked inside _g_reloc
            (self.levels, self.win, _), _ = self._run(
                "g_reloc", self._g_reloc_fn,
                (self.levels, self.win, self.preints_dev), (nv,))
            self._gravity = self.win.g[0].clone()

        self.x = dataclasses.replace(
            self.win[max(nvalid - 1, 0)], cov=self.x.cov, t=self.x.t,
            bg=self.x.bg, ba=self.x.ba)
        if self._last_p is not None:
            self._last_p = np.asarray(dx_R @ self._last_p + dx_p)

    def insert_keyframe_fixed(self, kf) -> None:
        """Mid-term association: fold one historical keyframe cloud into
        the live map as fixed statistics (reference keyframe_loading,
        voxelslam.cpp:1379-1438), refreshing the touched planes; one
        dispatch (`_keyframe_reload_fn`)."""
        with telemetry.span("loop.reload"):
            wld = (kf.cloud @ kf.R0.T + kf.p0).astype(np.float32)
            (self.levels,), _ = self._run(
                f"keyframe_reload_{len(wld)}", self._keyframe_reload_fn,
                (self.levels,), (wld, np.asarray(kf.mask, np.float32),
                                 np.array([self.jour], np.float32)))

    def flush(self):
        """Emit the remaining window states as ScanPoses (end of run)."""
        self._flush_pending()
        self._host_window()
        for k in range(self.win_count):
            s = self.win[k]
            self.scan_poses.append(ScanPose(
                t=float(s.t), R=_np(s.R), p=_np(s.p), v=_np(s.v),
                v6=np.ones(6, np.float32), cloud=self.scan_buf[k].copy(),
                cloud_mask=self.scan_mask[k].copy(), session=self.session,
                bg=_np(s.bg), ba=_np(s.ba), g=_np(s.g)))
        self.win_count = 0
        return self.scan_poses
