"""The output check: what the window's timed path produced, held to the
plain reference (`slambench/reference/`), each compared number beside its
limit.

A `Recorder` keeps, while the window is open:

  - for the steady dispatches that the seed draws (`check_steady` of the
    first `check_first`): the scans' downsampled body-frame clouds the
    dispatch returned, and, after it, the map's keys and window clusters
    of every level and the window's poses. Copies are queued on the
    stream into pinned buffers allocated before the window, so the window
    waits for no read;
  - for the calls of `DescriptorDB.verify` that the seed draws
    (`check_verify` of the first `check_verify_first`): the descriptors
    and matches it got and the answer it gave.

The recorder also copies each pose as the odometry hands it out (at the
return of `SlamPipeline.process_scan` and `apply_correction`, before the
loop pipeline rewrites the poses of a session it corrects), and notes the
first correction that joins the live session to a prior one (`g_update`):
the poses handed out up to its end are in the live session's own frame,
those after it in F. These copies are the run's emitted poses
(`drive.Run`), the one yardstick of every cell. Each pose is judged in the
frame the odometry computed it in, so the split at the join is clean: the
caller of `SlamSystem.process_scan` reads the poses of a corrected
session once the loop pipeline has moved them, which mixes frames within
the join's call. Where no correction comes, the two are the same poses,
bit for bit. A correction's rewrite of poses already handed out is not
judged here. After the window, with the program's state freed, each is
compared:

  map_total_gap       per sampled scan and level, the window cluster's
                      totals against the scan's own (reference/moments.py)
  map_key_violations  per sampled scan and level, voxels whose count no
                      assignment of the scan's points can give (exact: 0)
  pose_err_m          emitted poses against the ground truth after one
                      rigid fit (reference/poses.py); the configuration
                      states the limit
  reloc_err_m         in a cell with prior sessions (`sessions.py`), the
                      poses emitted once the live session joined a prior
                      one, against the truth in the prior sessions' frame
                      F, with no fit (pose_err_m then covers the poses
                      before, in the live session's own frame; each part
                      is compared where it holds 3 poses or more)
  edge_err_m          loop edges accepted and GBA edges made in the
                      window, against the true relative poses (idem); an
                      end in a prior session is held to the writer's
                      truth
  verify_mismatch     sampled verifications whose answer differs from the
                      plain RANSAC's (reference/ransac.py; exact: 0)
  plan_missed         draws or expected window events the window never
                      reached: a check that saw nothing proves nothing
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import moments as rmo
from .reference import poses as rpo
from .reference import ransac as rra

STEADY = ("steady", "steady_k")
FAULTS = ("stale", "half", "altered", "relocated")
RELOCATED_M = 0.25


class PinnedPool:
    """Pinned host buffers by (shape, dtype), allocated before the window
    so a kept dispatch's copies allocate nothing inside it."""

    def __init__(self):
        self.free = {}

    def reserve(self, tensors, n: int):
        for t in tensors:
            if t.device.type != "cuda":
                continue
            for _ in range(n):
                self.free.setdefault((tuple(t.shape), t.dtype), []).append(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True))

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t.detach().clone()
        bufs = self.free.get((tuple(t.shape), t.dtype))
        buf = bufs.pop() if bufs else torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
        buf.copy_(t.detach(), non_blocking=True)
        return buf


def map_tensors(levels, win, mp) -> list:
    """What a kept dispatch copies after it ran: per level the keys, the
    occupancy and the window clusters (every slot), then the window's
    poses and its slot map."""
    out = []
    for lv in levels:
        out += [lv.keys, lv.occ, lv.win.n, lv.win.mu, lv.win.S]
    return out + [win.R, win.p, mp]


# ---------------------------------------------------------------------------
# faults planted in the program (the CPU tests' proof that `correct` falls)
# ---------------------------------------------------------------------------

def plant(fault: str, mg: int):
    """Break the port's steady step on its class or module: "stale"
    returns the state it got; "half" leaves the second half of each
    scan's downsampled points out of the map insert; "altered" moves the
    emitted position of every third steady scan by 0.25 m where the step
    writes it. ("relocated", in the correction, is the recorder's.)"""
    from voxelslam_tpu_torch.pipeline import odometry
    if fault == "relocated":
        return
    if fault == "half":
        vm = odometry.vm
        ins = vm.insert_scan_fused

        def half(levels, cfg, wld, down, tr, dmask, *a):
            m = dmask.clone()
            valid = torch.nonzero(m > 0).flatten()
            m[valid[len(valid) // 2:]] = 0.0
            return ins(levels, cfg, wld, down, tr, m, *a)
        vm.insert_scan_fused = half
        return
    orig = odometry.SlamPipeline._steady_megastep
    p_off = 5 + 6 * mg + mg + 9 * mg
    calls = [0]

    def step(self, state, levels, win, mp, preints, ring, imu_blob,
             scan_blob, scal):
        out = orig(self, state, levels, win, mp, preints, ring, imu_blob,
                   scan_blob, scal)
        if fault == "stale":
            return (state, levels, win, mp, preints) + tuple(out[5:])
        calls[0] += 1
        if calls[0] % 3:
            return out
        ring = out[5].clone()
        slot = scal[4].to(torch.int64)
        ring[slot, p_off:p_off + 3 * mg] += 0.25
        return tuple(out[:5]) + (ring,) + tuple(out[6:])
    odometry.SlamPipeline._steady_megastep = step


class Recorder:
    """Keeps the window's sampled dispatches and verifications and compares
    them after the window (see the module docstring)."""

    def __init__(self, cell, seed: int, device, fault=None):
        self.cell = cell
        self.device = device
        tr = cell.traffic
        rng = np.random.default_rng([abs(int(seed)) % (1 << 63), 0xC4EC])
        first = int(tr.get("check_first", 12))
        self.steady_plan = {int(i) for i in rng.choice(
            first, size=min(int(tr.get("check_steady", 2)), first),
            replace=False)}
        vfirst = int(tr.get("check_verify_first", 0))
        self.verify_plan = {int(i) for i in rng.choice(
            vfirst, size=min(int(tr.get("check_verify", 0)), vfirst),
            replace=False)} if vfirst else set()
        self.counts = {}
        self.handed = []         # (R, p) of each pose as handed out
        self.joined_at = None    # poses handed out when it joined F
        self.fault = fault
        self.steps = []
        self.verifies = []
        self.active = False
        self.pool = PinnedPool()
        self._saved = []
        if fault is not None:
            if fault not in FAULTS:
                raise SystemExit(f"unknown fault {fault!r}; {FAULTS}")
            plant(fault, cell.slam_config().lba.mgsize)
        self._install()

    # -- recording ----------------------------------------------------------

    def _take(self, kind, plan) -> bool:
        if not self.active:
            return False
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        return n in plan

    def _install(self):
        from voxelslam_tpu_torch.loop import btc
        from voxelslam_tpu_torch.pipeline import odometry
        rec = self
        o_run = odometry.SlamPipeline._run
        verify = btc.DescriptorDB.verify

        def odo_run(self_, name, fn, carry, inputs):
            out = o_run(self_, name, fn, carry, inputs)
            if name in STEADY and rec._take(name, rec.steady_plan):
                (_, levels, win, mp) = out[0][:4]
                if name == "steady":
                    down, dmask = out[1][0][None], out[1][1][None]
                else:
                    down, dmask = out[1][1], out[1][2]
                rec.steps.append(dict(
                    kind=name, K=int(down.shape[0]),
                    at=rec.counts[name] - 1,     # its place in the window
                    data=[rec.pool.copy(t) for t in
                          map_tensors(levels, win, mp) + [down, dmask]]))
            return out

        def verify_call(self_, desc, cand_frame, matches):
            out = verify(self_, desc, cand_frame, matches)
            if rec._take("verify", rec.verify_plan):
                c = self_.cfg
                rec.verifies.append(dict(
                    q=dict(desc), c=self_.frames[cand_frame],
                    matches=np.asarray(matches, np.int64).copy(),
                    cfg=(c.ransac_hyps, c.vertex_tol, c.plane_norm_tol,
                         c.plane_dist_tol),
                    out=None if out is None else {
                        k: np.array(v, copy=True) for k, v in out.items()}))
            return out

        o_scan = odometry.SlamPipeline.process_scan
        o_corr = odometry.SlamPipeline.apply_correction

        def hand_out(poses):
            for sp in poses[len(rec.handed):]:
                rec.handed.append((np.array(sp.R, copy=True),
                                   np.array(sp.p, copy=True)))

        def scan_call(self_, *a, **kw):
            out = o_scan(self_, *a, **kw)
            hand_out(self_.scan_poses)
            return out

        def correction_call(self_, dx_R, dx_p, g_update, map_keyframes):
            join = bool(g_update) and rec.joined_at is None
            if join and rec.fault == "relocated":
                dx_p = np.asarray(dx_p, np.float64) + [RELOCATED_M, 0, 0]
            out = o_corr(self_, dx_R, dx_p, g_update, map_keyframes)
            hand_out(self_.scan_poses)
            if join:
                rec.joined_at = len(rec.handed)
            return out

        for obj, name, fn in ((odometry.SlamPipeline, "_run", odo_run),
                              (btc.DescriptorDB, "verify", verify_call),
                              (odometry.SlamPipeline, "process_scan",
                               scan_call),
                              (odometry.SlamPipeline, "apply_correction",
                               correction_call)):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)

    def open_window(self, sysm):
        """Reserve pinned buffers for the dispatches the plan keeps, then
        start counting."""
        od = sysm.odom
        P = od.cfg.odom.point_max
        K = max(1, od._batch_K)
        shapes = map_tensors(od.levels, od.win, od.mp) + [
            torch.empty((K, P, 3), device=self.device),
            torch.empty((K, P), device=self.device)]
        self.pool.reserve(shapes, len(self.steady_plan))
        self.map_cfg = od.cfg.map
        self.W = od.cfg.lba.win_size
        self.active = True

    def close_window(self, sysm):
        self.active = False

    def uninstall(self):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []

    def plan_missed(self, run) -> list:
        """Draws the window never reached, and window events the traffic
        expects that it lacked."""
        out = []
        kept = {s["kind"] for s in self.steps}
        out += [k for k in STEADY if self.counts.get(k) and k not in kept]
        if not any(self.counts.get(k) for k in STEADY):
            out.append("steady")
        if self.verify_plan and len(self.verifies) < len(self.verify_plan):
            out.append("verify")
        if run.priors is not None and len(self._split(run)[1]) < 3:
            out.append("relocalized")
        for k, n in self.cell.traffic.get("window_expect", {}).items():
            if run.events.get(k, 0) < n:
                out.append(k)
        return out

    # -- comparing ----------------------------------------------------------

    def compare(self, run, stream, sysm_parts) -> dict:
        """The compared numbers: {name: {"value", "limit"}}."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        lim = self.cell.limits
        acc = self.cell.config["accuracy"]
        out = {"points_truncated": {"value": run.points_in - run.points_kept,
                                    "limit": 0}}
        gap, viol = self._map()
        out["map_total_gap"] = {"value": gap, "limit": lim["map_total_gap"]}
        out["map_key_violations"] = {"value": viol, "limit": 0}
        before, after = self._split(run)
        if run.priors is None or len(before) >= 3:
            out["pose_err_m"] = {"value": self._poses(run, stream, before),
                                 "limit": acc["pose_err_m"]}
        if len(after) >= 3:
            out["reloc_err_m"] = {"value": self._reloc(run, stream, after),
                                  "limit": acc["pose_err_m"]}
        if self.cell.traffic["mode"] == "closed":
            out["edge_err_m"] = {"value": self._edges(run, stream,
                                                      sysm_parts),
                                 "limit": acc["pose_err_m"]}
            out["verify_mismatch"] = {"value": self._verify(), "limit": 0}
        return out

    def _map(self):
        """Worst totals gap and the key violations over the kept scans."""
        cfg = self.map_cfg
        L = len(cfg.capacities)
        W = self.W
        worst, bad = 0.0, 0
        self.map_seen = []
        for s in self.steps:
            d = [t.numpy() for t in s["data"]]
            lv = [d[5 * l:5 * l + 5] for l in range(L)]
            wR, wp, mp = d[5 * L:5 * L + 3]
            down, dmask = d[5 * L + 3:]
            K = s["K"]
            for i in range(K):
                li = W - 1 - K + i          # the scan's place in the window
                slot = int(mp[li])
                q, m = down[i], dmask[i]
                rng = np.linalg.norm(q.astype(np.float64), axis=1)
                margin = cfg_margin(self.cell) + 2e-3 * rng
                # the map keeps a point as R^T (w - p) of its world point
                # w = R q + p: R^T R q, which differs from q as far as the
                # step's attitude has drifted from a rotation; the frame's
                # attitude in the window carries the same drift
                Rw = wR[li].astype(np.float64)
                G = Rw.T @ Rw
                ref = rmo.scan_totals(q.astype(np.float64) @ G.T, m)
                for l in range(L):
                    keys, occ, n, mu, S = lv[l]
                    n_s = np.where(occ, n[slot], 0.0)
                    prog = rmo.cluster_totals(n_s, mu[slot], S[slot])
                    gs = rmo.totals_gaps(prog, ref)
                    g = max(gs)
                    nz = n_s > 0
                    v = rmo.key_violations(
                        q, m, wR[li], wp[li], cfg.level_size(l), margin,
                        rmo.pack(keys[nz]), n_s[nz])
                    worst = max(worst, g)
                    bad += v
                    self.map_seen.append(dict(kind=s["kind"],
                                              dispatch=s["at"], level=l,
                                              points=int(ref[0]),
                                              orth=float(np.abs(
                                                  G - np.eye(3)).max()),
                                              gaps=[float(x) for x in gs],
                                              violations=v))
        return worst, bad

    def _split(self, run):
        """The window's emitted scans, split where the live session joined
        a prior one: (before, after); all before where it never did or
        the cell has no prior sessions."""
        js = sorted(run.emitted_pose)
        if run.priors is None or self.joined_at is None:
            return js, []
        return ([j for j in js if run.emit_index[j] < self.joined_at],
                [j for j in js if run.emit_index[j] >= self.joined_at])

    def _poses(self, run, stream, js) -> float:
        if len(js) < 3:
            return 1e30
        p_est = np.stack([run.emitted_pose[j][1] for j in js])
        err = rpo.position_errors(p_est, stream.gt_p[js])
        self.pose_errs = dict(n=len(js), median=float(np.median(err)),
                              max=float(err.max()))
        return float(err.max())

    def _reloc(self, run, stream, js) -> float:
        """Worst distance of a pose emitted after the join from the truth
        in F: no fit, the frame is what the relocalization produced."""
        p_est = np.stack([run.emitted_pose[j][1] for j in js])
        _, p_true = run.priors.to_frame(stream.gt_R[js], stream.gt_p[js])
        d = p_est.astype(np.float64) - p_true
        err = np.linalg.norm(d, axis=1)
        pri = run.priors
        moved = [np.linalg.norm(p - t, axis=1) for p, t in
                 zip(run.prior_final, pri.gt_p)]
        self.reloc_errs = dict(
            n=len(js), first_scan=int(js[0]), median=float(np.median(err)),
            max=float(err.max()), mean_xyz=d.mean(0).tolist(),
            # where the pose graph left the prior sessions' scans
            priors_max=[float(m.max()) for m in moved],
            priors_median=[float(np.median(m)) for m in moved])
        return float(err.max())

    def _edges(self, run, stream, parts) -> float:
        """Worst translation error of the loop and GBA edges made in the
        window."""
        errs = []
        n_prior = 0 if run.priors is None else len(run.priors.names)
        cross = 0
        for e in parts["edges"]:
            a = parts["truth"](e.id_a, e.ord_a)
            b = parts["truth"](e.id_b, e.ord_b)
            cross += int((e.id_a < n_prior) != (e.id_b < n_prior))
            if a is None or b is None:
                errs.append(1e30)
                continue
            errs.append(rpo.edge_error(e.t, *a, *b))
        self.edge_errs = dict(n=len(errs), loops=parts["n_loops"],
                              cross_session=cross,
                              max=max(errs) if errs else None)
        return max(errs) if errs else 0.0

    def _verify(self) -> int:
        bad = 0
        self.verify_seen = []
        for v in self.verifies:
            ref, fragile = rra.verify(v["q"], v["c"], v["matches"],
                                      *v["cfg"])
            miss = (not fragile) and rra.mismatch(v["out"], ref)
            bad += int(miss)
            seen = dict(passed=v["out"] is not None, fragile=fragile,
                        votes=None if v["out"] is None
                        else int(v["out"]["votes"]), mismatch=miss)
            if miss:
                seen["reference"] = None if ref is None else dict(
                    votes=ref["votes"], overlap=ref["overlap"])
                if v["out"] is not None:
                    seen["overlap"] = float(v["out"]["overlap"])
                if ref is not None and v["out"] is not None:
                    seen["dR"] = float(np.abs(v["out"]["R"] - ref["R"]).max())
                    seen["dt"] = float(np.abs(v["out"]["t"] - ref["t"]).max())
            self.verify_seen.append(seen)
        return bad


def cfg_margin(cell) -> float:
    """The fixed part of the key check's margin (metres); the part that
    grows with range is 2 mm a metre."""
    return float(cell.traffic.get("key_margin_m", 0.03))
