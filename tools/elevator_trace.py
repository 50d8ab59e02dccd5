"""The elevator scenario of tests/test_elevator.py at bench.py's widths
(`chip_smoke.py` phase `system`), and a per-scan and per-search trace of a
SlamSystem run over it, shared by `chip_smoke.py`,
`tools/jax_elevator_check.py` (the JAX package) and
`tools/torch_elevator_check.py` (the PyTorch port). Imports neither
package: each caller passes in its own simulator, config module and
classes.

A trace is a JSON object:
  scans    - per scan: phase, odometry session, whether a loop correction
             was applied, the odometry position, its error against ground
             truth, keyframe and loop-edge counts, and the degeneracy
             eigenvalue a dynamic init reports;
  searches - per BTC search of one keyframe against one session: the
             voted candidates (frame, votes), each RANSAC verification's
             plane overlap, each ICP candidate's ok and min eigenvalue,
             and the accepted match.
`compare(a, b)` says where two traces part.
"""
import json
import os

import numpy as np

LEGS = [(2 * np.pi / 0.7, 0.7), (10.0, 0.0), (np.pi / 0.9, 0.9),
        (12.0, 0.0), (10.0, 0.55)]
SCAN_KEYS = ("phase", "session", "corr", "n_kf", "n_edges")


def system_config(cm):
    """bench.py's widths with the loop threshold of tests/test_elevator.py,
    from config module `cm`."""
    return cm.SlamConfig(
        map=cm.MapConfig(capacities=(1 << 13, 1 << 15, 1 << 16),
                         unique_max=(4096, 4096, 8192), evict_load=0.55),
        odom=cm.OdometryConfig(point_max=4096, imu_max=64, batch_scans=4),
        lba=cm.LocalBAConfig(factor_max=1024),
        loop=cm.LoopConfig(jud_default=0.45))


def elevator_trajectory(sim):
    """The scenario's ground-truth trajectory, from simulator module `sim`."""
    return sim.make_waypoint_trajectory(LEGS, speed=1.5, still=0.4,
                                        ramp=1.0, wobble=0.0, z_amp=0.04)


def elevator_packets(sim, n=None):
    """The scenario's packets and mid-scan ground-truth positions (the first
    `n` scans, or all 434), made with simulator module `sim`."""
    scene = (sim.Scene.from_planes(np.array([[0.0, 0.0, 1.0]]),
                                   np.array([1.5]))
             + sim.box_scene((0.0, 0.0, 1.5), (16.0, 16.0, 6.0)))
    rng = np.random.default_rng(4)
    spots = ([(1.2, a) for a in np.linspace(0, 2 * np.pi, 4)[:-1]]
             + [(4.4, a) for a in np.linspace(0.3, 2 * np.pi + 0.3, 8)[:-1]]
             + [(6.3, a) for a in np.linspace(0.7, 2 * np.pi + 0.7, 6)[:-1]])
    for r, a in spots:
        px, py = r * np.cos(a), r * np.sin(a)
        if abs(py) < 1.3 and px > 1.5:
            continue
        sx, sy = rng.uniform(0.5, 1.2, 2)
        sz = rng.uniform(1.2, 4.0)
        scene = scene + sim.box_scene((px, py, -1.5 + sz / 2), (sx, sy, sz))
    traj = elevator_trajectory(sim)
    n_scans = int((sum(d for d, _ in LEGS) - 1.0) / 0.1)
    packets, gt, t = [], [], 0.1
    for k in range(n_scans if n is None else min(n, n_scans)):
        scan = sim.lidar_scan(traj, t, t + 0.1, scene, None, n_az=160,
                              n_el=20, noise=0.012, seed=k, max_range=25.0)
        hit = scan["hit"]
        ts = np.arange(t - 0.01, t + 0.1 + 1e-6, 1.0 / 200.0)
        imu = np.array([np.concatenate(traj.imu_at(ti)) for ti in ts])
        packets.append((scan["points"][hit], scan["offsets"][hit], ts,
                        imu[:, 0:3], imu[:, 3:6], t, t + 0.1))
        gt.append(traj.state_at(t + 0.05)[1])
        t += 0.1
    return packets, np.stack(gt)


def resume(sysm, path, to_dev, perturb=0.0):
    """Put `sysm` where a run stood after the reset saved at `path` (what
    a reset carries: gravity, gyro bias, gravity scale, session), with
    `perturb` added to the carried gravity's x. Earlier sessions come
    back empty. Returns the next scan's index."""
    z = np.load(path)
    od = sysm.odom
    od._gravity = to_dev(z["gravity"] + np.array([perturb, 0.0, 0.0],
                                                 np.float32))
    od._bg0 = to_dev(z["bg0"])
    od._scale_gravity = float(z["scale_gravity"])
    od.reset(int(z["session"]))
    for _ in range(od.session):
        sysm.loop.new_session()
    sysm._session = od.session
    return int(z["k"]) + 1


class Tracer:
    """Records a run through wrappers around the loop pipeline's search,
    the descriptor DB's `search`/`verify` and the ICP entry point. With
    `dump_dir`, every accepted cross-session match also writes an .npz of
    its inputs (both keyframe clouds and descriptors, the matches and the
    verification) for `tools/jax_elevator_check.py --replay`."""

    def __init__(self, to_np, dump_dir=None):
        self.to_np = to_np
        self.dump_dir = dump_dir
        self.scans, self.searches, self.dumps = [], [], []
        self.k = 0
        self._ev = None
        self._undo = []

    def wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def uninstall(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def install(self, loop_cls, db_cls, icp_targets):
        """icp_targets: (owner, name) of every ICP entry point."""
        tr = self

        def search_session(orig):
            def f(lp, tid, desc_np, kf, skip):
                ev = dict(k=tr.k, tid=tid, session=kf.session,
                          kf_index=kf.kf_index, scan_id=kf.scan_id,
                          cands=[], verify=[], icp=[], _ver={}, _m={})
                tr._ev = ev
                hit = orig(lp, tid, desc_np, kf, skip)
                tr._ev = None
                ev["hit"] = (None if hit is None else
                             [hit[0].session, hit[0].kf_index,
                              hit[0].scan_id])
                if hit is not None and tid != kf.session and tr.dump_dir:
                    tr._dump(lp, ev, desc_np, kf, hit)
                del ev["_ver"], ev["_m"]
                tr.searches.append(ev)
                return hit
            return f

        def search(orig):
            def f(db, desc, *a, **kw):
                out = orig(db, desc, *a, **kw)
                if tr._ev is not None:
                    tr._ev["cands"] = [[int(fid), int(v)]
                                       for fid, v, _ in out[:20]]
                    tr._ev["_m"] = {int(fid): m for fid, _, m in out[:20]}
                return out
            return f

        def verify(orig):
            def f(db, desc, frame, matches):
                out = orig(db, desc, frame, matches)
                if tr._ev is not None:
                    tr._ev["verify"].append(
                        [int(frame), None if out is None
                         else float(out["overlap"])])
                    tr._ev["_ver"][int(frame)] = out
                return out
            return f

        def icp(orig):
            def f(*a, **kw):
                out = orig(*a, **kw)
                if tr._ev is not None:
                    ok = tr.to_np(out["ok"]).reshape(-1)
                    e0 = tr.to_np(out["eig0"]).reshape(-1)
                    tr._ev["icp"] += [[bool(o), float(e)]
                                      for o, e in zip(ok, e0)]
                return out
            return f

        self.wrap(loop_cls, "_search_session", search_session)
        self.wrap(db_cls, "search", search)
        self.wrap(db_cls, "verify", verify)
        for owner, name in icp_targets:
            self.wrap(owner, name, icp)

    def _dump(self, lp, ev, desc_np, kf, hit):
        m_kf = hit[0]
        ver = ev["_ver"][m_kf.kf_index]
        cand = lp.dbs[ev["tid"]].frames[m_kf.kf_index]
        path = os.path.join(self.dump_dir, f"match_k{ev['k']}_s{kf.session}"
                            f"kf{kf.kf_index}_s{m_kf.session}"
                            f"kf{m_kf.kf_index}.npz")
        arrs = dict(src=kf.cloud, src_mask=kf.mask, tgt=m_kf.cloud,
                    tgt_mask=m_kf.mask, frame=m_kf.kf_index,
                    votes=dict(ev["cands"])[m_kf.kf_index],
                    matches=np.asarray(ev["_m"][m_kf.kf_index]),
                    ver_R=ver["R"], ver_t=ver["t"],
                    ver_overlap=ver["overlap"], icp_R=hit[1], icp_t=hit[2])
        arrs.update({"q_" + k: np.asarray(v) for k, v in desc_np.items()})
        arrs.update({"c_" + k: np.asarray(v) for k, v in cand.items()})
        np.savez_compressed(path, **arrs)
        self.dumps.append(path)

    def scan(self, sysm, out, gt_p):
        p = np.asarray(self.to_np(sysm.odom.x.p), np.float64)
        self.scans.append(dict(
            k=self.k, phase=out.get("phase"),
            session=int(sysm.odom.session),
            corr=bool(out.get("loop_correction")), p=p.tolist(),
            ev0=None if out.get("ev0") is None else float(out["ev0"]),
            err=float(np.linalg.norm(p - gt_p)),
            n_kf=sum(len(s) for s in sysm.loop.keyframes),
            n_edges=len(sysm.loop.lp_edges)))
        self.k += 1

    def result(self, sysm):
        return dict(
            scans=self.scans, searches=self.searches, dumps=self.dumps,
            edges=[[e.id_a, e.id_b, e.ord_a, e.ord_b]
                   for e in sysm.loop.lp_edges])


def summary(trace):
    """Resets, failed inits, corrections and their errors of one trace."""
    sc = trace["scans"]
    ph = [s["phase"] for s in sc]
    corr = [s for s in sc if s["corr"]]
    return dict(scans=len(sc), resets=ph.count("reset"),
                init_failed=ph.count("init_failed"),
                session=sc[-1]["session"] if sc else None,
                corr_ks=[s["k"] for s in corr],
                err_at_corr=[s["err"] for s in corr], edges=trace["edges"])


def _search_diff(ea, eb, tol):
    """Why two records of the same search differ, or None."""
    if [c[0] for c in ea["cands"]] != [c[0] for c in eb["cands"]]:
        return "candidate frames"
    if ea["cands"] != eb["cands"]:
        return "votes"
    if [v[0] for v in ea["verify"]] != [v[0] for v in eb["verify"]]:
        return "verified frames"
    for (_, oa), (_, ob) in zip(ea["verify"], eb["verify"]):
        if (oa is None) != (ob is None) or (
                oa is not None and abs(oa - ob) > tol):
            return "overlap"
    n = min(len(ea["icp"]), len(eb["icp"]))
    if [i[0] for i in ea["icp"][:n]] != [i[0] for i in eb["icp"][:n]]:
        return "icp ok"
    if ea["hit"] != eb["hit"]:
        return "accepted match"
    return None


def compare(a, b, tol=1e-3, keys=SCAN_KEYS):
    """Where traces a and b part: the first scan whose `keys` (phase,
    session, correction, keyframe and edge count) differ; the position
    difference before it; and the first search (same scan, same keyframe,
    same target session) whose candidates, overlaps (beyond `tol`), ICP
    verdicts or accepted match differ."""
    ib = {s["k"]: s for s in b["scans"]}
    pairs = [(s, ib[s["k"]]) for s in a["scans"] if s["k"] in ib]
    part = next((i for i, (x, y) in enumerate(pairs)
                 if any(x[key] != y[key] for key in keys)), None)
    end = len(pairs) if part is None else part
    dp = [float(np.linalg.norm(np.subtract(x["p"], y["p"])))
          for x, y in pairs[:end]]
    first_dp = {str(t): next((pairs[i][0]["k"] for i, d in enumerate(dp)
                              if d > t), None)
                for t in (1e-4, 1e-3, 1e-2, 1e-1)}
    key = lambda e: (e["k"], e["session"], e["kf_index"], e["tid"])  # noqa
    eb = {key(e): e for e in b["searches"]}
    first_search = None
    n_same = 0
    for e in a["searches"]:
        f = eb.get(key(e))
        if f is None:
            continue
        why = _search_diff(e, f, tol)
        if why is None:
            n_same += 1
            continue
        first_search = dict(k=e["k"], session=e["session"],
                            kf_index=e["kf_index"], tid=e["tid"], why=why,
                            a={x: e[x] for x in ("cands", "verify", "icp",
                                                 "hit")},
                            b={x: f[x] for x in ("cands", "verify", "icp",
                                                 "hit")})
        break
    return dict(
        scans_compared=len(pairs),
        first_parting_scan=None if part is None else pairs[part][0]["k"],
        at_parting=(None if part is None else
                    {side: {x: pairs[part][i].get(x)
                            for x in SCAN_KEYS + ("ev0",)}
                     for i, side in enumerate("ab")}),
        max_dp_before=max(dp) if dp else None, first_scan_dp_over=first_dp,
        searches_equal_before=n_same, first_differing_search=first_search)


def save(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load(path):
    with open(path) as f:
        return json.load(f)
