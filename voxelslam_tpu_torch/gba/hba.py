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

With `step_graphs` (the default) every round, batched round and window
condense is one CUDA graph replay (`pipeline.graphs.StepGraph`, in one
memory pool a runner), the counterpart of the JAX runner's jit caches
(`_get_step`, `_get_fleet`, `_get_condense`): a window's two rounds, the
coarse and the fine phase's, are a graph each, with the phase's voxel size
and gates as the eager round's Python floats, so a replay is bitwise the
eager round; the window's inputs are staged once for each. A replay
overwrites its outputs, so what a window, batch or condense returns is a
copy. The total BA's windows go through the same graphs, keyed by their
width: a capture costs about one and a half eager rounds of host time and
a replay a tenth of one, so a phase pays for its capture from its third
round on (PERF.md §6). `step_graphs=False` runs the same rounds eagerly.
On the CPU the graphs' buffer logic runs with the steps eager.

The dispatch-ahead order of the JAX package is kept: a window's edges
appear when the next window is added, its submap one window later, and
`add_keyframe`/`drain` return the same dicts. Its outputs are read with
one synchronous copy at harvest.

With a mesh (`parallel.multihost.WinMesh`; `global_win_mesh(min_devices=1)`
for one card) windows queue and run `fleet_batch` at a time through
`parallel.dist_gba.make_window_fleet`: one batched round serves every
window of the batch (a leading window axis on the map, the factors and the
LM), rounds run until every window has stopped, a stopped window's carry
is frozen as the JAX package's vmapped `while_loop` freezes it, and the
host reads every window's phase and round count in one copy a round. A
batch is harvested when the next one is dispatched, so edges and submaps
appear at the same `add_keyframe` calls as in the JAX runner. A mesh of
several ranks splits each batch over them. `total_ba` and the path
without a mesh run one window at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig, MapConfig
from ..map import voxel_map as vm
from ..ba import optimizers as opt
from ..parallel.dist_gba import (all_pairs_edges, condense_window,
                                 make_window_fleet)
from ..pipeline.graphs import StepGraph, graph_name
from ..pipeline.loop import Keyframe, LoopEdge
from ..pipeline.odometry import fetch, resolve_device
from ..utils import telemetry

CONV_THR = 0.05


class HbaRunner:
    """Global BA on `device` (CUDA by default; raises when CUDA is absent
    and no device is named).

    mesh: a `parallel.multihost.WinMesh`; bottom-up windows are then
    batched `fleet_batch` at a time (default: the mesh size) and split over
    its ranks. Without one each window runs as it completes.

    step_graphs: run rounds, batched rounds and condenses as step graphs
    (see the module docstring; `_graphs` holds them by key).

    `host_syncs` counts the device-to-host reads; `window_log` holds one
    dict per window step or batch (padded width, windows `Nw` of a batch,
    rounds, the phase after each round, host syncs)."""

    def __init__(self, cfg: SlamConfig, kf_point_max: int = 8192,
                 capacity: int = 1 << 13, unique_max: int = 4096,
                 mesh=None, fleet_batch: int | None = None, device=None,
                 step_graphs: bool = True):
        if fleet_batch is not None and mesh is None:
            raise ValueError("fleet_batch batches windows over a mesh; for "
                             "one card pass "
                             "mesh=global_win_mesh(min_devices=1)")
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
        self.mesh = mesh
        self._fleet_batch = (fleet_batch if fleet_batch is not None
                             else (mesh.size if mesh is not None else 1))
        self._win_queue: list[list[Keyframe]] = []
        self._fleet_inflight = None  # (queue, fleet outputs)
        self.host_syncs = 0
        self.window_log: list[dict] = []
        self.step_graphs = step_graphs
        self._graphs: dict[tuple, StepGraph] = {}
        self._pool = None            # the graphs' memory pool (CUDA)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _fetch(self, *xs):
        """`odometry.fetch`, counted in host_syncs."""
        self.host_syncs += 1
        return fetch(*xs)

    def _graph(self, key, make):
        """The step function `make()` builds, called as a StepGraph is
        (carry, inputs or None) -> (carry, extras): with step graphs, this
        runner's graph `key`, made at first use (captured at its first
        call on the card) in the runner's memory pool; else eager."""
        if not self.step_graphs:
            return _Eager(make())
        g = self._graphs.get(key)
        if g is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = StepGraph(make(), self.device,
                                              pool=self._pool,
                                              name=graph_name(key))
        return g

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

    def _round_map(self, coarse_cfg, factor_max, vox, min_eig, thr,
                   clouds, masks, Rs, ps, wmask):
        """A round's map: the window's clouds at voxel size `vox`, planes
        refit at the (min_eig, thr) gates, the factors harvested. Returns
        (levels, factors). With a leading window axis on the inputs the
        gates are (Nw,) tensors and every window builds its own map."""
        lead = clouds.shape[:-3]
        W, P = clouds.shape[-3], clouds.shape[-2]
        lv = vm.empty_level(self._capacity, W, device=self.device,
                            nw=lead[0] if lead else None)
        mp = torch.arange(W, dtype=torch.int32, device=self.device)
        tr = clouds.new_zeros((P,))
        for i in range(W):
            wld = (clouds[..., i, :, :] @ Rs[..., i, :, :].transpose(-1, -2)
                   + ps[..., i, None, :])
            lv, _, _, _ = vm.insert_scan_level(
                lv, vox, self._unique_max, wld, clouds[..., i, :, :], tr,
                masks[..., i, :] * wmask[..., i, None], i, 0.0)
        levels = vm.refresh_planes((lv,), coarse_cfg, Rs, ps, mp, W,
                                   min_eigen_value=min_eig, plane_thr=thr)
        return levels, vm.harvest_t(levels, coarse_cfg, mp, factor_max)

    def _build_and_lm(self, coarse_cfg, factor_max, vox, min_eig, thr,
                      clouds, masks, Rs, ps, wmask):
        """One round: the round's map (`_round_map`) and 3 LM iterations."""
        _, factors = self._round_map(coarse_cfg, factor_max, vox, min_eig,
                                     thr, clouds, masks, Rs, ps, wmask)
        return opt.lm_lidar(Rs, ps, factors, wmask, max_iter=3)

    def _round_fn(self, W: int, factor_max: int, fine: bool):
        """One round of the window step at the coarse or the fine phase's
        voxel size and gates (Python floats): (Rs, ps), (clouds, masks,
        wmask) -> (Rs, ps), (H, r0, r1, conv), conv the round's |r0-r1|/r0
        < 5% on the device."""
        coarse_cfg, fine_cfg = self._map_cfgs(W)
        g = self.cfg.gba
        gates = ((fine_cfg.voxel_size, fine_cfg.min_eigen_value,
                  fine_cfg.plane_thr[0]) if fine else
                 (g.voxel_size, g.min_eigen_value, g.eigen_value_thr))

        def rnd(carry, inputs):
            clouds, masks, wmask = inputs
            Rs, ps, H, r0, r1, _ = self._build_and_lm(
                coarse_cfg, factor_max, *gates, clouds, masks, *carry, wmask)
            rel = torch.abs(r0 - r1) / torch.clamp(r0, min=1e-12)
            return (Rs, ps), (H, r0, r1, rel < CONV_THR)
        return rnd

    def _get_step(self, W: int, factor_max: int, fine: bool):
        """The window step's round at width W and the coarse or the fine
        phase (`_graph`): the counterpart of the JAX runner's jitted step,
        whose one while_loop body serves both phases."""
        return self._graph(("step", W, factor_max, fine),
                           lambda: self._round_fn(W, factor_max, fine))

    @telemetry.spanned("gba.window")
    def _window_step(self, clouds, masks, Rs, ps, wmask, factor_max: int):
        """Convergence-driven coarse->fine window BA (reference
        HBA_add_edge, voxelslam.cpp:2871-2917): coarse GBA voxel params
        until the first round with |r0-r1|/r0 < 5%, then the odometry map
        params until the second or `GBAConfig.total_max_iter` rounds.
        Returns device tensors (Rs, ps, H, r0 of the first round, r1 of
        the last) that no later round overwrites."""
        W = clouds.shape[0]
        total_iter = max(int(self.cfg.gba.total_max_iter), 2)
        inputs = (clouds, masks, wmask)
        syncs0 = self.host_syncs
        it, phase, phases = 0, 0, []
        carry, r0_first, rounds = (Rs, ps), None, {}
        while it < total_iter and phase < 2:
            fine = phase > 0
            first = fine not in rounds      # stage the inputs once a phase
            if first:
                rounds[fine] = self._get_step(W, factor_max, fine)
            carry, (H, r0, r1, conv) = rounds[fine](
                carry, inputs if first else None)
            if it == 0:
                r0_first = r0.clone()        # the next round overwrites r0
            conv = bool(conv)                # the round's one host read
            self.host_syncs += 1
            phase += int(conv)
            phases.append(phase)
            it += 1
        self.window_log.append(dict(W=W, rounds=it, phases=phases,
                                    syncs=self.host_syncs - syncs0))
        telemetry.count("gba.windows")
        telemetry.count("gba.rounds", it)
        return tuple(x.clone() for x in carry + (H,)) + (r0_first,
                                                          r1.clone())

    def _batch_round_fn(self, W: int, factor_max: int):
        """One batched round: every window at its own phase's voxel size
        and gates ((Nw,) tensors), a stopped window's carry frozen; carry
        (Rs, ps, H, r0 of the first round, r1, phase, rounds), inputs
        (clouds, masks, wmask); no extras."""
        coarse_cfg, fine_cfg = self._map_cfgs(W)
        g = self.cfg.gba
        total_iter = max(int(g.total_max_iter), 2)

        def rnd(carry, inputs):
            Rs, ps, H, r0_first, r1, phase, it = carry
            clouds, masks, wmask = inputs
            fine = phase > 0
            vox = torch.where(fine, fine_cfg.voxel_size, g.voxel_size)
            min_eig = torch.where(fine, fine_cfg.min_eigen_value,
                                  g.min_eigen_value)
            thr = torch.where(fine, fine_cfg.plane_thr[0], g.eigen_value_thr)
            Rs2, ps2, H2, r0, r1_n, _ = self._build_and_lm(
                coarse_cfg, factor_max, vox, min_eig, thr, clouds, masks, Rs,
                ps, wmask)
            rel = torch.abs(r0 - r1_n) / torch.clamp(r0, min=1e-12)
            run = (it < total_iter) & (phase < 2)
            Rs = torch.where(run[:, None, None, None], Rs2, Rs)
            ps = torch.where(run[:, None, None], ps2, ps)
            H = torch.where(run[:, None, None], H2, H)
            r0_first = torch.where(run & (it == 0), r0, r0_first)
            r1 = torch.where(run, r1_n, r1)
            phase = torch.where(run, phase + (rel < CONV_THR).to(torch.int32),
                                phase)
            it = torch.where(run, it + 1, it)
            return (Rs, ps, H, r0_first, r1, phase, it), ()
        return rnd

    def _batch_step(self, clouds, masks, Rs, ps, wmask, factor_max: int):
        """The window step over a batch with a leading window axis (clouds
        (Nw, W, P, 3), ...): one batched round a trip (`_batch_round_fn`,
        a step graph a (Nw, W, factor_max)), each window at its own phase,
        until every window has stopped (`total_max_iter` rounds or its
        second convergence). The host reads every window's phase and round
        count in one copy a round. Returns the device tensors (Rs, ps, H,
        r0 of the first round, r1 of the last), each (Nw, ...); with step
        graphs they are the graph's carry, which its next batch
        overwrites."""
        Nw, W = clouds.shape[0], clouds.shape[1]
        total_iter = max(int(self.cfg.gba.total_max_iter), 2)
        rnd = self._graph(("batch", Nw, W, factor_max),
                          lambda: self._batch_round_fn(W, factor_max))
        syncs0 = self.host_syncs
        it = torch.zeros((Nw,), dtype=torch.int32, device=self.device)
        carry = (Rs, ps, Rs.new_zeros((Nw, 6 * W, 6 * W)),
                 Rs.new_zeros((Nw,)), Rs.new_zeros((Nw,)),
                 torch.zeros_like(it), it)
        inputs = (clouds, masks, wmask)
        phases, live = [], True          # every window runs its first round
        while live:
            carry, _ = rnd(carry, None if phases else inputs)
            ph, its = self._fetch(*carry[5:])    # the round's one host read
            phases.append(ph.astype(int).tolist())
            live = bool(np.any((its < total_iter) & (ph < 2)))
        self.window_log.append(dict(W=W, Nw=Nw, rounds=len(phases),
                                    phases=phases,
                                    syncs=self.host_syncs - syncs0))
        return carry[:5]

    def _outputs(self, fn, *inputs):
        """A batch's edges and condensed submaps (`make_window_fleet`'s
        `run`): a step graph a (Nw, W), which keeps the `fn` of its first
        call (every fleet of a width computes the same outputs)."""
        key = ("outputs",) + tuple(inputs[0].shape[:2])
        step = self._graph(key, lambda: lambda carry, x: (carry, fn(*x)))
        return step((), inputs)[1]

    def _get_fleet(self, W: int, factor_max: int):
        """The batched window step, its edges and its condensed submaps
        (`make_window_fleet`) over this runner's mesh."""
        return make_window_fleet(
            self.mesh, lambda *a: self._batch_step(*a, factor_max), W,
            condense_vs=self.cfg.map.voxel_size / 8.0,
            point_max=self.kf_point_max, run=self._outputs)

    def _dispatch_window(self, kfs: list[Keyframe], W_pad: int,
                         factor_max: int = 1024):
        """Run one window BA over `kfs` padded with dead frames to W_pad
        (`_window_step`); returns its device outputs (Rs, ps, H, r0, r1),
        not yet read."""
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

    def _get_condense(self, n: int):
        """The window condense of n frames (`dist_gba.condense_window` at
        voxel_size/8, `_graph`): (), (clouds, masks, Rs, ps) -> (),
        (down, dmask)."""
        vs, P = self.cfg.map.voxel_size / 8.0, self.kf_point_max
        return self._graph(("condense", n), lambda: lambda carry, x: (
            carry, condense_window(*x, vs, P)))

    def _dispatch_condense(self, kfs, Rs, ps):
        """The window condense; returns the device (down, dmask), not yet
        read, which no later condense overwrites."""
        P = self.kf_point_max
        n = len(kfs)
        clouds = np.zeros((n, P, 3), np.float32)
        masks = np.zeros((n, P), np.float32)
        for i, kf in enumerate(kfs):
            m = min(kf.cloud.shape[0], P)
            clouds[i, :m] = kf.cloud[:m]
            masks[i, :m] = kf.mask[:m]
        _, out = self._get_condense(n)((), tuple(self._t(a) for a in (
            clouds, masks, np.asarray(Rs[:n]), np.asarray(ps[:n]))))
        return tuple(x.clone() for x in out)

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
        """Read everything still in flight (the window, its condense and
        the fleet's batch); called by flush, total_ba and top_down so the
        edge and submap lists are complete."""
        out = None
        if self._fleet_inflight is not None:
            out = self._harvest_fleet()
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
        ran. With a mesh, windows queue and run `fleet_batch` at a time."""
        g = self.cfg.gba
        self._pending.append(kf)
        if len(self._pending) < g.win_size:
            return None
        window = self._pending[:g.win_size]
        self._pending = self._pending[g.stride:]
        if self.mesh is not None:
            self._win_queue.append(window)
            if len(self._win_queue) >= self._fleet_batch:
                return self._flush_windows()
            return dict(queued=len(self._win_queue))
        outs = self._dispatch_window(window, g.win_size)
        prev, self._inflight_step = self._inflight_step, (window, outs)
        r0 = r1 = None
        if prev is not None:
            self._harvest_cond()
            r0, r1 = self._harvest_step(prev)
        return dict(r0=r0, r1=r1, n_edges=len(self.edges1),
                    n_submaps=len(self.submaps), in_flight=True)

    def _flush_windows(self):
        """Run the queued windows through the fleet (the batch padded to a
        multiple of max(fleet_batch, mesh size) by repeating its first
        window; the padded results are thrown away), then harvest the
        previous batch."""
        if not self._win_queue:
            return self._harvest_fleet()
        g = self.cfg.gba
        W, Pm = g.win_size, self.kf_point_max
        queue, self._win_queue = self._win_queue, []
        n_pad = (-len(queue)) % max(self._fleet_batch, self.mesh.size)
        batch = queue + [queue[0]] * n_pad
        Nb = len(batch)
        clouds = np.zeros((Nb, W, Pm, 3), np.float32)
        masks = np.zeros((Nb, W, Pm), np.float32)
        Rs = np.tile(np.eye(3, dtype=np.float32), (Nb, W, 1, 1))
        ps = np.zeros((Nb, W, 3), np.float32)
        for b, window in enumerate(batch):
            for i, kf in enumerate(window):
                m = min(kf.cloud.shape[0], Pm)
                clouds[b, i, :m] = kf.cloud[:m]
                masks[b, i, :m] = kf.mask[:m]
                Rs[b, i] = kf.R0
                ps[b, i] = kf.p0
        # copies: the next batch's replays overwrite the graphs' outputs
        outs = tuple(x.clone() for x in self._get_fleet(W, 1024)(
            self._t(clouds), self._t(masks), self._t(Rs), self._t(ps),
            self._t(np.ones((Nb, W), np.float32))))
        prev, self._fleet_inflight = self._fleet_inflight, (queue, outs)
        if prev is None:
            return dict(dispatched=len(queue))
        return self._harvest_fleet(prev)

    def _harvest_fleet(self, inflight=None):
        """Read one batch's outputs in one copy (default: the batch in
        flight) and append its edges and submaps in window order."""
        if inflight is None:
            inflight, self._fleet_inflight = self._fleet_inflight, None
        if inflight is None:
            return None
        W = self.cfg.gba.win_size
        queue, outs = inflight
        Rs2, ps2, rel_R, rel_p, v6, evalid, r0, r1, downs, dmasks = (
            self._fetch(*outs))
        pi, pj = np.triu_indices(W, 1)
        for b, window in enumerate(queue):
            for m in range(len(pi)):
                if not evalid[b, m]:
                    continue
                a, c = window[pi[m]], window[pj[m]]
                self.edges1.append(LoopEdge(
                    id_a=a.session, id_b=c.session, ord_a=a.scan_id,
                    ord_b=c.scan_id, R=rel_R[b, m].astype(np.float64),
                    t=rel_p[b, m].astype(np.float64),
                    v6=v6[b, m].astype(np.float64)))
            first = window[0]
            self.submaps.append(Keyframe(
                kf_index=len(self.submaps), scan_id=first.scan_id,
                session=first.session, R0=Rs2[b, 0].astype(np.float64),
                p0=ps2[b, 0].astype(np.float64), cloud=downs[b],
                mask=dmasks[b], jour=first.jour))
        return dict(flushed=len(queue), r0=float(r0[0]), r1=float(r1[0]),
                    n_edges=len(self.edges1), n_submaps=len(self.submaps))

    def flush(self):
        """Run the queued windows and read everything in flight (end of
        stream)."""
        out = self._flush_windows() if self.mesh is not None else None
        out2 = self.drain()
        return out2 if out2 is not None else out

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


class _Eager:
    """A step function called as a StepGraph is, eagerly: inputs=None
    keeps the last call's."""

    def __init__(self, fn):
        self.fn = fn
        self.inputs = None

    def __call__(self, carry, inputs):
        if inputs is not None:
            self.inputs = inputs
        return self.fn(carry, self.inputs)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
