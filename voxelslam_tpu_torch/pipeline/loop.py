"""Loop-closure pipeline (port of `voxelslam_tpu/pipeline/loop.py`; the
reference's thd_loop_closure, voxelslam.cpp:2158-2714, as a
deterministic per-scan-pose step that the system calls between odometry
scans):

  * scan poses accumulate into the multi-session pose graph
  * a keyframe every win_size scans behind a motion gate (>= 5 deg or
    >= 0.1 m, :2336-2345): the window's clouds merged into the last
    scan's body frame and downsampled
  * BTC descriptor extraction + search across ALL sessions (:2406-2421)
  * RANSAC verification of the hits, then ICP over the passing candidates
    (a single candidate alone, otherwise chunks of 4 padded with the
    first), and the drift gates (same session drift/span < ratio_drift,
    :2454; cross session < 0.05, :2491)
  * pose-graph optimization by anchor condensation (`loop.condense`) and
    a dense GN solve (`loop.posegraph`), with write-back of every
    session's poses and keyframes and the correction dx = x3 o x1^-1
    plus the live-map keyframes (last 5) for the odometry's map rebuild
    (:2569-2648).

Cross-session first contact rebuilds the graph over the newly reachable
session set and flags a gravity re-rotation (g_update). Descriptor
extraction, the keyframe merge, ICP and the pose-graph solve run as torch
ops on `device`; search, RANSAC and the condensation are host numpy, as
in the JAX package.

With `step_graphs` (the default) each device program is one
`graphs.StepGraph` replay a call, the counterpart of the JAX package's
jits (`_jit_merge` and `_extract`, `_jit_icp`, `_jit_icp_b`, `_pg_cache`):
"keyframe" (the merge, its downsample and the BTC extraction), ("icp", 1)
and ("icp", 4) (a chunk of candidates; a short chunk is padded with
copies of its first, as the JAX package pads it) and ("pose_graph", K, E)
(one a capacity pair). Inputs are staged from the host's numpy arrays;
the host reads a call's results in one copy (`graphs.host_arrays`). The
graphs share one memory pool: they never run at once, and what one hands
out is copied to the host before another replays. `step_graphs=False`
runs the same functions eagerly, with bitwise the same results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig
from ..loop import condense as cd
from ..loop import posegraph as pg
from ..loop.btc import BtcConfig, DescriptorDB, extract as btc_extract
from ..loop.icp import icp_point_to_plane
from ..ops.downsample import voxel_downsample
from ..utils import telemetry
from .graphs import StepGraph, graph_name, host_arrays
from .odometry import resolve_device

# the descriptor arrays `btc.extract` returns, in the keyframe graph's order
DESC_KEYS = ("sides", "verts", "binary", "tri_valid", "plane_centers",
             "plane_normals", "plane_valid")


@dataclasses.dataclass
class Keyframe:
    """10-scan merged submap (reference Keyframe, voxel_map.hpp:978-1006).
    `cloud` is in the body frame of pose (R0, p0) (the last scan)."""
    kf_index: int          # index in its session's keyframe list
    scan_id: int           # last scan id within the session
    session: int
    R0: np.ndarray
    p0: np.ndarray
    cloud: np.ndarray      # (Kp, 3) downsampled body-frame
    mask: np.ndarray       # (Kp,)
    jour: float
    exist: bool = True


@dataclasses.dataclass
class LoopEdge:
    """Cross/intra-session loop constraint (reference PGO_Edge,
    loop_refine.hpp:163-204)."""
    id_a: int              # session of the matched (older) scan
    id_b: int              # session of the current scan
    ord_a: int             # scan index within session a
    ord_b: int             # scan index within session b
    R: np.ndarray          # relative pose: x_a o T = x_b
    t: np.ndarray
    v6: np.ndarray         # diagonal variance


@dataclasses.dataclass
class LoopCorrection:
    """What the odometry pipeline applies after a PGO burst (reference
    loop_update inputs: dx, map_loop, g_update)."""
    dx_R: np.ndarray
    dx_p: np.ndarray
    g_update: bool
    map_keyframes: list    # last <= 5 keyframes for the map rebuild


class LoopPipeline:
    """Loop closure on `device` (CUDA by default; raises when CUDA is
    absent and no device is named); its device programs as step graphs
    unless `step_graphs` is False (see the module docstring)."""

    # candidates per batched ICP call
    _icp_batch = 4
    # below this many total scan poses every scan is its own anchor (the
    # condensed solve degenerates to the full dense GN)
    dense_anchor_max = 192
    # anchor/edge capacity ladder: x4 growth from 64
    _cap0 = 64

    def __init__(self, cfg: SlamConfig, device=None,
                 step_graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_graphs = step_graphs
        self._graphs: dict = {}
        self._pool = None            # the graphs' memory pool (CUDA)
        self.btc_cfg = BtcConfig.profile(cfg.loop.is_high_fly)
        self.kf_point_max = 8192

        # per-session state (reference multimap_* vectors)
        self.scan_poses: list[list] = []
        self.keyframes: list[list[Keyframe]] = []
        # per-session keyframe positions for the vectorized radius query;
        # row i = keyframes[s][i].p0, rows below _kf_sync[s] in sync
        self._kf_pos: list[np.ndarray] = []
        self._kf_sync: list[int] = []
        self.dbs: list[DescriptorDB] = []
        self.juds: list[float] = []
        self.jours: list[float] = []
        self.relc_counts: list[int] = []
        self.lp_edges: list[LoopEdge] = []
        # edge.txt lines naming sessions not loaded, kept for the next save
        self._edge_absent_lines: list[str] = []
        self.graph_ids: list[int] = []      # sessions in the optimized graph
        self._bl_local: list = []           # pending window for keyframes
        self._x_key = None                  # last keyframe pose (R, p)

    def _run(self, key, fn, inputs):
        """fn((), inputs)'s extras for `inputs` numpy arrays: one replay of
        the StepGraph `key` (made at first use, in the pipeline's pool), or
        eagerly without step graphs. The host copies what it keeps before
        the next call (a replay overwrites the extras)."""
        if not self.step_graphs:
            return fn((), tuple(torch.as_tensor(a, device=self.device)
                                for a in inputs))[1]
        g = self._graphs.get(key)
        if g is None:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = StepGraph(fn, self.device,
                                              pool=self._pool,
                                              name=graph_name(key))
        return g((), inputs)[1]

    def pool_bytes(self) -> int:
        """Device memory the graphs' captures reserved (their shared
        pool's growth), 0 before the first capture or on the CPU."""
        return sum(g.capture_bytes or 0 for g in self._graphs.values())

    # -- session management -------------------------------------------------

    def new_session(self, jud: float | None = None):
        sid = len(self.scan_poses)
        self.scan_poses.append([])
        self.keyframes.append([])
        self._kf_pos.append(np.zeros((64, 3)))
        self._kf_sync.append(0)
        self.dbs.append(DescriptorDB(self.btc_cfg))
        self.juds.append(self.cfg.loop.jud_default if jud is None else jud)
        self.jours.append(0.0)
        self.relc_counts.append(0)
        self._bl_local = []
        self._x_key = None
        # a fresh session is disconnected until BTC relocalizes it
        self.graph_ids = [sid]
        return sid

    @property
    def cur_session(self) -> int:
        return len(self.scan_poses) - 1

    # -- device steps -------------------------------------------------------

    def _merge_keyframe(self, clouds, masks, Rs, ps, Rc, pc):
        """Merge (W, P, 3) body-frame scan clouds into the last scan's body
        frame and downsample at voxel_size/10 (reference :2360-2402)."""
        rel_R = Rc.T[None] @ Rs                              # Rc^T R_i
        rel_p = (ps - pc[None]) @ Rc
        moved = clouds @ rel_R.transpose(-1, -2) + rel_p[:, None]
        vs = max(self.cfg.map.voxel_size / 10.0, 0.05)
        down, dmask, _ = voxel_downsample(moved.reshape(-1, 3),
                                          masks.reshape(-1), vs,
                                          self.kf_point_max)
        return down, dmask.to(torch.float32)

    def _keyframe_fn(self, carry, inputs):
        """The keyframe merge and its BTC descriptors: inputs (clouds (W,
        P, 3), masks (W, P), Rs (W, 3, 3), ps (W, 3), Rc, pc) -> extras
        (down, dmask, the descriptor arrays of DESC_KEYS)."""
        down, dmask = self._merge_keyframe(*inputs)
        desc = btc_extract(down, dmask, self.btc_cfg)
        return carry, (down, dmask) + tuple(desc[k] for k in DESC_KEYS)

    @telemetry.spanned("loop.keyframe")
    def _keyframe(self, group, xc_R, xc_p):
        """Merge the window `group` of ScanPoses into the pose (xc_R, xc_p)
        and extract its descriptors: one dispatch, one host copy. Returns
        (cloud, mask, descriptor dict) as numpy arrays."""
        f32 = np.float32
        out = host_arrays(*self._run("keyframe", self._keyframe_fn, (
            np.stack([g.cloud for g in group]).astype(f32),
            np.stack([g.cloud_mask for g in group]).astype(f32),
            np.stack([g.R for g in group]).astype(f32),
            np.stack([g.p for g in group]).astype(f32),
            np.asarray(xc_R, f32), np.asarray(xc_p, f32))))
        return out[0], out[1], dict(zip(DESC_KEYS, out[2:]))

    def _icp_fn(self, carry, inputs):
        """Point-to-plane ICP of one source against a batch of candidates:
        inputs (src, smask, tgt (B, M, 3), tmask, R0 (B, 3, 3), t0 (B, 3))
        -> extras (ok, R, t)."""
        out = icp_point_to_plane(*inputs, icp_eigval=self.cfg.loop.icp_eigval)
        return carry, (out["ok"], out["R"], out["t"])

    @telemetry.spanned("loop.icp")
    def _icp_chunk(self, kf: Keyframe, chunk, kfs):
        """ICP of keyframe `kf` against the candidate keyframes `kfs` from
        their RANSAC transforms (`chunk`'s verify results): one candidate
        through the ("icp", 1) graph, more through ("icp", _icp_batch),
        a short chunk padded with copies of its first candidate (the JAX
        package's `_jit_icp`/`_jit_icp_b`). Returns (ok, R, t) of the
        chunk's candidates as numpy arrays."""
        n = len(chunk)
        B = 1 if n == 1 else self._icp_batch
        pad = list(range(n)) + [0] * (B - n)
        f32 = np.float32
        ok, R, t = host_arrays(*self._run(("icp", B), self._icp_fn, (
            np.asarray(kf.cloud, f32), np.asarray(kf.mask, f32),
            np.stack([kfs[i].cloud for i in pad]).astype(f32),
            np.stack([kfs[i].mask for i in pad]).astype(f32),
            np.stack([chunk[i][1]["R"] for i in pad]).astype(f32),
            np.stack([chunk[i][1]["t"] for i in pad]).astype(f32))))
        return ok[:n], R[:n], t[:n]

    def _pose_graph_fn(self, carry, inputs):
        """The anchor graph's dense Gauss-Newton (6 iterations): inputs
        (R, p, ii, jj, rel_R, rel_p, W6) -> extras (R, p)."""
        R2, p2, _ = pg.solve_pose_graph_full(*inputs, iters=6)
        return carry, (R2, p2)

    @telemetry.spanned("loop.pose_graph")
    def _solve_pose_graph(self, R, p, ii, jj, rel_R, rel_p, W6):
        """One ("pose_graph", K, E) dispatch over the padded anchor graph
        (the JAX package's `_pg_cache`); float64 (R, p) back."""
        f32 = np.float32
        K, E = len(R), len(ii)
        R2, p2 = host_arrays(*self._run(("pose_graph", K, E),
                                        self._pose_graph_fn, (
            R.astype(f32), p.astype(f32), ii, jj, rel_R.astype(f32),
            rel_p.astype(f32), W6.astype(f32))))
        return R2.astype(np.float64), p2.astype(np.float64)

    # -- main step ----------------------------------------------------------

    @telemetry.spanned("loop.push")
    def push(self, sp) -> LoopCorrection | None:
        """Feed one ScanPose of the odometry stream. Returns a
        LoopCorrection when a PGO burst ran (the odometry pipeline must
        then rebuild its live map), else None."""
        cfg = self.cfg
        W = cfg.lba.win_size
        if not self.scan_poses:
            self.new_session()
        sid = self.cur_session
        self.scan_poses[sid].append(sp)
        self._bl_local.append(sp)
        if self._x_key is None:
            self._x_key = (sp.R, sp.p)
        if len(self._bl_local) < W:
            return None

        xc_R, xc_p = self._bl_local[-1].R, self._bl_local[-1].p
        ang = np.linalg.norm(so3_log_np(self._x_key[0].T @ xc_R)) * 57.3
        length = float(np.linalg.norm(xc_p - self._x_key[1]))
        if ang < 5.0 and length < 0.1 and len(self.scan_poses[sid]) > W:
            self._bl_local.pop(0)
            return None
        for i in range(len(self.jours)):
            self.jours[i] += length
        self._x_key = (xc_R, xc_p)

        # --- keyframe creation ---
        group = self._bl_local[:W]
        self._bl_local = []
        down, dmask, desc_np = self._keyframe(group, xc_R, xc_p)
        kf = Keyframe(
            kf_index=len(self.keyframes[sid]),
            scan_id=len(self.scan_poses[sid]) - 1, session=sid,
            R0=np.asarray(xc_R), p0=np.asarray(xc_p), cloud=down,
            mask=dmask, jour=self.jours[sid])
        self.keyframes[sid].append(kf)

        # --- search across sessions ---
        is_graph = False
        is_opt = False
        n_push = 0
        for tid in range(len(self.dbs)):
            skip = self.cfg.loop.descriptor_near_num if tid == sid else -1
            hit = self._search_session(tid, desc_np, kf, skip)
            if hit is None:
                continue
            m_kf, R_cm, t_cm = hit
            # drift against the matched pose (reference :2440-2445)
            xm = self.scan_poses[tid][m_kf.scan_id]
            drift_p = float(np.linalg.norm(xm.R @ t_cm + xm.p - xc_p))

            push_edge = False
            if tid == sid:
                span = kf.jour - m_kf.jour
                if span > 0 and drift_p / span < cfg.loop.ratio_drift:
                    push_edge = True
                    if self.relc_counts[tid] > cfg.loop.curr_halt \
                            and drift_p > 0.10:
                        is_opt = True
                        self.relc_counts = [0] * len(self.relc_counts)
            else:
                if tid not in self.graph_ids:
                    is_graph = True
                    is_opt = True
                    push_edge = True
                    self.relc_counts[tid] = 0
                    self.jours[tid] = 0.0
                elif self.jours[tid] > 0 and \
                        drift_p / self.jours[tid] < 0.05:
                    self.jours[tid] = 1e-6
                    push_edge = True
                    if self.relc_counts[tid] > cfg.loop.prev_halt \
                            and drift_p > 0.25:
                        is_opt = True
                        self.relc_counts = [0] * len(self.relc_counts)

            if push_edge:
                n_push += 1
                self.lp_edges.append(LoopEdge(
                    id_a=tid, id_b=sid, ord_a=m_kf.scan_id,
                    ord_b=kf.scan_id, R=R_cm, t=t_cm, v6=np.full(6, 1e-6)))

        self.relc_counts = [c + 1 for c in self.relc_counts]
        self.dbs[sid].add(kf.kf_index, desc_np)

        if is_graph:
            self._rebuild_graph_ids()
        if not is_opt or n_push == 0:
            return None
        return self._optimize(g_update=is_graph)

    # -- search + verify ----------------------------------------------------

    def _search_session(self, tid: int, desc_np, kf: Keyframe, skip: int):
        """BTC vote + RANSAC agreement + ICP refinement against session
        `tid`. Returns (matched keyframe, R_cm, t_cm) mapping current-kf
        body -> matched-kf body, or None. Candidates that clear the
        plane-overlap gate are ICP-verified in vote order, in chunks of
        `_icp_batch` (`_icp_chunk`: one dispatch each, the JAX package's
        vmap); the first that passes is the match."""
        db = self.dbs[tid]
        cands = db.search(desc_np, skip_near=skip,
                          current_frame=kf.kf_index if tid == kf.session
                          else 1 << 30)
        passing = []
        for frame_id, _, matches in cands[:self.cfg.loop.candidate_num]:
            ver = db.verify(desc_np, frame_id, matches)
            if ver is None or ver["overlap"] < self.juds[tid]:
                continue
            passing.append((frame_id, ver))
        if not passing:
            return None

        B = self._icp_batch
        for c0 in range(0, len(passing), B):
            chunk = passing[c0:c0 + B]
            kfs = [self.keyframes[tid][f] for f, _ in chunk]
            oks, Rs, ts = self._icp_chunk(kf, chunk, kfs)
            if oks.any():
                i = int(np.argmax(oks))
                return (kfs[i], Rs[i].astype(np.float64),
                        ts[i].astype(np.float64))
        return None

    # -- pose graph ---------------------------------------------------------

    def _rebuild_graph_ids(self):
        """Sessions reachable from the current one through loop edges
        (reference PGO_Edges::connect, loop_refine.hpp:237-265)."""
        adj = {}
        for e in self.lp_edges:
            adj.setdefault(e.id_a, set()).add(e.id_b)
            adj.setdefault(e.id_b, set()).add(e.id_a)
        seen = set()
        stack = [self.cur_session]
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            stack.extend(adj.get(s, ()))
        self.graph_ids = sorted(seen)

    def _capacity(self, n: int) -> int:
        c = self._cap0
        while c < n:
            c *= 4
        return c

    def _optimize(self, g_update: bool) -> LoopCorrection:
        """GN over the multi-session BetweenFactor graph (replaces the
        reference's ISAM2 bursts, :2552-2561) by anchor condensation:
        odometry chains between loop-edge endpoints become composite
        between-factors (loop/condense.py), the anchor graph is solved
        densely on the device, and interior poses follow by covariance-
        weighted interpolation of the anchor corrections."""
        ids = self.graph_ids
        total_n = sum(len(self.scan_poses[s]) for s in ids)
        dense = total_n <= self.dense_anchor_max

        chains: dict[int, cd.CondensedChain] = {}
        anchors: dict[int, list[int]] = {}
        for s in ids:
            sps = self.scan_poses[s]
            chains[s] = cd.CondensedChain(np.stack([sp.R for sp in sps]),
                                          np.stack([sp.p for sp in sps]),
                                          np.stack([sp.v6 for sp in sps]))
            if dense:
                anchors[s] = list(range(len(sps)))
            else:
                a = {0, len(sps) - 1}
                for e in self.lp_edges:
                    if e.id_a == s:
                        a.add(e.ord_a)
                    if e.id_b == s:
                        a.add(e.ord_b)
                anchors[s] = sorted(a)

        aidx: dict[tuple[int, int], int] = {}
        for s in ids:
            for o in anchors[s]:
                aidx[(s, o)] = len(aidx)
        n_anc = len(aidx)

        ii, jj, rel_R, rel_p, W6 = [], [], [], [], []
        for s in ids:
            ch = chains[s]
            anc = anchors[s]
            for a, b in zip(anc[:-1], anc[1:]):
                rR, rp, cov = ch.segment_edge(a, b)
                ii.append(aidx[(s, a)])
                jj.append(aidx[(s, b)])
                rel_R.append(rR)
                rel_p.append(rp)
                W6.append(cd.residual_info(rR, cov))
        for e in self.lp_edges:
            ka, kb = (e.id_a, e.ord_a), (e.id_b, e.ord_b)
            if ka in aidx and kb in aidx:
                ii.append(aidx[ka])
                jj.append(aidx[kb])
                rel_R.append(e.R)
                rel_p.append(e.t)
                W6.append(np.diag(1.0 / np.maximum(e.v6, 1e-8)))
        n_edge = len(ii)

        # fixed-capacity padding, as the JAX package pads for its compiles
        K = self._capacity(max(n_anc, 2))
        E = self._capacity(max(n_edge, 2))
        R = np.tile(np.eye(3), (K, 1, 1))
        p = np.zeros((K, 3))
        for (s, o), k in aidx.items():
            sp = self.scan_poses[s][o]
            R[k] = sp.R
            p[k] = sp.p
        pad = E - n_edge
        ii = np.concatenate([ii, np.zeros(pad)]).astype(np.int32)
        jj = np.concatenate([jj, np.zeros(pad)]).astype(np.int32)
        rel_R = np.concatenate([rel_R, np.tile(np.eye(3), (pad, 1, 1))])
        rel_p = np.concatenate([rel_p, np.zeros((pad, 3))])
        W6 = np.concatenate([W6, np.zeros((pad, 6, 6))])

        x1_R = self.scan_poses[self.cur_session][-1].R.copy()
        x1_p = self.scan_poses[self.cur_session][-1].p.copy()
        R2, p2 = self._solve_pose_graph(R, p, ii, jj, rel_R, rel_p, W6)

        # write back anchors, then interpolate the segment interiors
        for s in ids:
            sps = self.scan_poses[s]
            ch = chains[s]
            anc = anchors[s]
            for o in anc:
                k = aidx[(s, o)]
                sp = sps[o]
                sp.v = R2[k] @ sp.R.T @ sp.v
                sp.R, sp.p = R2[k], p2[k]
            for a, b in zip(anc[:-1], anc[1:]):
                if b - a <= 1:
                    continue
                ka, kb = aidx[(s, a)], aidx[(s, b)]
                La_R = R2[ka] @ ch.R[a].T
                La_p = p2[ka] - La_R @ ch.p[a]
                Lb_R = R2[kb] @ ch.R[b].T
                Lb_p = p2[kb] - Lb_R @ ch.p[b]
                Rn, pn = cd.apply_segment_correction(
                    ch, a, b, La_R, La_p, Lb_R, Lb_p)
                for m, o in enumerate(range(a + 1, b)):
                    sp = sps[o]
                    sp.v = Rn[m] @ sp.R.T @ sp.v
                    sp.R, sp.p = Rn[m], pn[m]
            for kf in self.keyframes[s]:
                src = sps[kf.scan_id]
                kf.R0, kf.p0 = src.R, src.p
            self._kf_sync[s] = 0    # positions moved: re-sync lazily

        x3 = self.scan_poses[self.cur_session][-1]
        dx_R = x3.R @ x1_R.T
        dx_p = x3.p - dx_R @ x1_p

        # live-map keyframes: the last 5 of the current session, consumed
        # one way (the reference never sets exist back, :2611)
        live = self.keyframes[self.cur_session][-5:]
        for kf in live:
            kf.exist = False
        return LoopCorrection(dx_R=dx_R, dx_p=dx_p, g_update=g_update,
                              map_keyframes=list(live))

    # -- mid-term association ----------------------------------------------

    def _kf_positions(self, sid: int) -> np.ndarray:
        """(n, 3) session keyframe positions, lazily synced (a PGO
        write-back invalidates by setting `_kf_sync[sid] = 0`)."""
        kfs = self.keyframes[sid]
        n = len(kfs)
        buf = self._kf_pos[sid]
        while buf.shape[0] < n:
            buf = np.concatenate([buf, np.zeros_like(buf)])
            self._kf_pos[sid] = buf
        m = self._kf_sync[sid]
        if m < n:
            buf[m:n] = np.stack([kf.p0 for kf in kfs[m:]])
            self._kf_sync[sid] = n
        return buf[:n]

    def nearby_keyframe(self, p_curr: np.ndarray, radius: float = 10.0):
        """One reloadable historical keyframe within `radius` of the
        current position (reference keyframe_loading, voxelslam.cpp:
        1379-1438); marks it consumed. Other sessions' keyframes qualify
        only once the current session is in the graph (relocalized)."""
        r2 = radius * radius
        ids = (self.graph_ids if self.cur_session in self.graph_ids
               else [self.cur_session])
        for s in ids:
            kfs = self.keyframes[s]
            if not kfs:
                continue
            d = self._kf_positions(s) - p_curr
            d2 = np.einsum("ni,ni->n", d, d)
            for i in np.nonzero(d2 < r2)[0]:
                kf = kfs[i]
                if kf.exist:
                    kf.exist = False
                    return kf
        return None


def so3_log_np(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-8:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * th / (2.0 * np.sin(th))
