"""Tensorized multi-resolution voxel plane map (port of the main-path
subset of `voxelslam_tpu/map/voxel_map.py`; see that module for the design:
fixed-capacity hashed levels replacing the reference's OctoTree,
voxelslam voxel_map.hpp:1047-1881).

Per voxel: state 0 (no plane), 1 (plane leaf: match here), 2 (non-planar:
descend). Window-frame statistics are local-frame centered clusters per
(window slot, voxel), window axis major (W, C, ...). Only untracked
levels (MapConfig.track_touched False, the default) are supported: the
touched-slot (tsl) variants and `harvest` belong to later slices and
raise or are absent.

XLA's drop-mode scatters become writes into a spare row at index C
(`core.tensors.drop_set/drop_add`); every gather index is clamped or
masked into range first. Functions return new levels and never modify
their inputs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from ..core import cluster as cl
from ..core.cluster import Cluster
from ..core.eig3 import eigh3
from ..core.tensors import drop_add, drop_set, tmap
from ..ops import voxel_hash as vh
from ..ops import moments as mo

STATE_NONE = 0
STATE_PLANE = 1
STATE_SUBDIV = 2

SLAB = 16
_S_NORMAL = slice(0, 3)
_S_CENTER = slice(3, 6)
_S_RADIUS = 6
_S_CMEAN = 7
_S_CVAR = 8
_S_STATE = 9

NV = 5  # noise-record channels: [sum a*rhat (3), sum a, sum b]


@dataclasses.dataclass
class VoxelLevel:
    keys: torch.Tensor     # (C, 3) int32
    occ: torch.Tensor      # (C,) bool
    win: Cluster           # (W, C, ...) local frame per window slot
    win_nv: torch.Tensor   # (W, C, NV) noise record, local frame
    fix: Cluster           # (C, ...) world-frame marginalized points
    fix_nv: torch.Tensor   # (C, NV)
    tot: Cluster           # (C, ...) world-frame running total
    tot_nv: torch.Tensor   # (C, NV)
    state: torch.Tensor    # (C,) int32
    slab: torch.Tensor     # (C, SLAB) packed match record
    lam: torch.Tensor      # (C, 3) eigenvalues of the normalized cov
    jour: torch.Tensor     # (C,) travel-distance stamp at creation
    tsl: torch.Tensor      # (W, T) touched-slot lists; T = 0 here

    @property
    def normal(self):
        return self.slab[:, _S_NORMAL]

    @property
    def center(self):
        return self.slab[:, _S_CENTER]

    @property
    def radius(self):
        return self.slab[:, _S_RADIUS]


def empty_level(capacity: int, win_size: int, track_max: int = 0,
                device=None) -> VoxelLevel:
    if track_max:
        raise NotImplementedError("touched-slot tracking is not ported")
    keys, occ = vh.empty_table(capacity, device)
    C = capacity
    z = dict(dtype=torch.float32, device=device)
    return VoxelLevel(
        keys=keys, occ=occ,
        win=Cluster.empty((win_size, C), device=device),
        win_nv=torch.zeros((win_size, C, NV), **z),
        fix=Cluster.empty((C,), device=device),
        fix_nv=torch.zeros((C, NV), **z),
        tot=Cluster.empty((C,), device=device),
        tot_nv=torch.zeros((C, NV), **z),
        state=torch.zeros((C,), dtype=torch.int32, device=device),
        slab=torch.zeros((C, SLAB), **z),
        lam=torch.zeros((C, 3), **z),
        jour=torch.zeros((C,), **z),
        tsl=torch.full((win_size, 0), C, dtype=torch.int32, device=device),
    )


def expand_noise(tr_pt: torch.Tensor) -> torch.Tensor:
    """(N,) isotropic trace/3 -> (N, NV) record [0, 0, 0, 0, tr]; an
    (N, NV) record passes through."""
    if tr_pt.dim() == 2 and tr_pt.shape[-1] == NV:
        return tr_pt
    z = tr_pt.new_zeros(tuple(tr_pt.shape) + (4,))
    return torch.cat([z, tr_pt[..., None]], dim=-1)


def point_noise_record(pts_body: torch.Tensor, dept_err: float,
                       beam_err: float) -> torch.Tensor:
    """(N, NV) record of var = a r r^T + b I, a = dept^2 - (beam d)^2,
    b = (beam d)^2 (calcBodyVar, voxelslam.hpp:180-200)."""
    r = torch.linalg.vector_norm(pts_body, dim=-1, keepdim=True)
    rhat = pts_body / torch.clamp(r, min=1e-6)
    b = (beam_err * r) ** 2
    a = dept_err ** 2 - b
    return torch.cat([a * rhat, a, b], dim=-1)


def empty_map(cfg: MapConfig, device=None):
    if cfg.track_touched:
        raise NotImplementedError("touched-slot tracking is not ported")
    return tuple(empty_level(c, cfg.win_size, 0, device)
                 for c in cfg.capacities)


def _set_slot(full, frame_slot, new):
    """Functional `full.at[frame_slot].set(new)` over a cluster or tensor."""
    def one(a, b):
        a = a.clone()
        a[frame_slot] = b
        return a
    return tmap(one, full, new)


def _rot_nv(R, nv):
    """Rotate the direction channels of (.., NV) noise records by R."""
    return torch.cat([nv[:, 0:3] @ R.T, nv[:, 3:5]], dim=-1)


# ---------------------------------------------------------------------------
# Insertion (reference cut_voxel, voxel_map.hpp:1896-2096)
# ---------------------------------------------------------------------------

def insert_scan_level(lv: VoxelLevel, level_size: float, unique_max: int,
                      pts_world, pts_local, tr_pt, mask, frame_slot, jour):
    """Insert one scan's points into a level at window slot `frame_slot`
    (dense-column path). Returns (level, touched_slots (U,),
    touched_valid (U,), dropped)."""
    if lv.tsl.shape[1]:
        raise NotImplementedError("touched-slot tracking is not ported")
    C = lv.keys.shape[0]
    keys = vh.voxel_key(pts_world, level_size)
    unique_max = min(unique_max, pts_world.shape[0])
    uniq, uvalid, inv = vh.dedup_keys(keys, mask > 0, unique_max)
    tkeys, occ, uslots = vh.insert(lv.keys, lv.occ, uniq, uvalid)
    nv_pt = expand_noise(tr_pt)

    inv = inv.long()
    us = uslots.long()
    pslot = torch.where(inv >= 0, us[torch.clamp(inv, min=0)], -1)
    ok = (mask > 0) & (pslot >= 0)
    seg = torch.where(ok, pslot, C)
    w = ok.to(pts_local.dtype)
    n_add = drop_add(pts_local.new_zeros((C,)), seg, w)
    sum_p = drop_add(pts_local.new_zeros((C, 3)), seg, pts_local * w[:, None])
    mu_add = sum_p / torch.clamp(n_add, min=1.0)[:, None]
    d = (pts_local - mu_add[torch.clamp(pslot, min=0)]) * w[:, None]
    S_add = drop_add(pts_local.new_zeros((C, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])
    nv_add = drop_add(pts_local.new_zeros((C, NV)), seg, nv_pt * w[:, None])
    merged = cl.merge(lv.win[frame_slot], Cluster(n=n_add, mu=mu_add, S=S_add))
    win = _set_slot(lv.win, frame_slot, merged)
    win_nv = _set_slot(lv.win_nv, frame_slot, lv.win_nv[frame_slot] + nv_add)

    newly = uvalid & (us >= 0) & ~lv.occ[torch.clamp(us, min=0)]
    jour_arr = drop_set(lv.jour, torch.where(newly, us, C),
                        torch.full_like(us, 0, dtype=lv.jour.dtype) + jour)
    lv = dataclasses.replace(lv, keys=tkeys, occ=occ, win=win,
                             win_nv=win_nv, jour=jour_arr)
    dropped = torch.sum((uvalid & (us < 0)).to(torch.int32))
    return lv, uslots, uvalid & (us >= 0), dropped


def insert_scan(levels, cfg: MapConfig, pts_world, pts_local, tr_pt, mask,
                frame_slot, jour=0.0):
    levels, _ = insert_scan_touched(levels, cfg, pts_world, pts_local,
                                    tr_pt, mask, frame_slot, jour)
    return levels


def insert_scan_touched(levels, cfg: MapConfig, pts_world, pts_local,
                        tr_pt, mask, frame_slot, jour=0.0):
    """insert_scan + per-level (slots, valid, dropped) of touched voxels."""
    out, touched = [], []
    for l, lv in enumerate(levels):
        lv2, s, sv, dropped = insert_scan_level(
            lv, cfg.level_size(l), cfg.unique_max[l], pts_world, pts_local,
            tr_pt, mask, frame_slot, jour)
        out.append(lv2)
        touched.append((s, sv, dropped))
    return tuple(out), touched


def insert_scan_fused(levels, cfg: MapConfig, pts_world, pts_local, tr_pt,
                      mask, frame_slot, jour, R, p):
    """All-level scan insert through ONE moment accumulation
    (`ops.moments.accumulate`: the CUDA kernel on the GPU). Same
    semantics as `insert_scan_touched`: per-point rows are packed
    relative to their voxel centre and re-centred to the scan mean in
    closed form after the sum. (R, p) is the scan pose."""
    P = pts_world.shape[0]
    nv_pt = expand_noise(tr_pt)
    pre, slots_l, upds_l = [], [], []
    for l, lv in enumerate(levels):
        if lv.tsl.shape[1]:
            raise ValueError("insert_scan_fused requires untracked levels")
        C = lv.keys.shape[0]
        size = cfg.level_size(l)
        keys = vh.voxel_key(pts_world, size)
        uniq, uvalid, inv = vh.dedup_keys(keys, mask > 0,
                                          min(cfg.unique_max[l], P))
        tkeys, occ, uslots = vh.insert(lv.keys, lv.occ, uniq, uvalid)
        inv = inv.long()
        us = uslots.long()
        pslot = torch.where(inv >= 0, us[torch.clamp(inv, min=0)], -1)
        ok = (mask > 0) & (pslot >= 0)
        w = ok.to(pts_local.dtype)
        center_w = (keys.to(pts_world.dtype) + 0.5) * size
        q = (pts_world - center_w) @ R                  # R^T (pw - c)
        slots_l.append(torch.clamp(pslot, 0, C - 1).to(torch.int32))
        upds_l.append(mo.pack_updates(q, nv_pt, w))
        newly = uvalid & (us >= 0) & ~lv.occ[torch.clamp(us, min=0)]
        dropped = torch.sum((uvalid & (us < 0)).to(torch.int32))
        pre.append((tkeys, occ, uslots, us, uvalid, newly, dropped))

    accs = mo.accumulate(torch.stack(slots_l).contiguous(),
                         torch.stack(upds_l).contiguous(),
                         tuple(lv.keys.shape[0] for lv in levels))

    out, touched = [], []
    for l, (lv, acc) in enumerate(zip(levels, accs)):
        C = lv.keys.shape[0]
        size = cfg.level_size(l)
        tkeys, occ, uslots, us, uvalid, newly, dropped = pre[l]
        n_add = acc[:, 0]
        has = n_add > 0
        delta = acc[:, 1:4] / torch.clamp(n_add, min=1.0)[:, None]
        nv_add = acc[:, 10:15]
        center_slot = (tkeys.to(acc.dtype) + 0.5) * size
        ref_local = (center_slot - p[None]) @ R
        mu_add = torch.where(has[:, None], ref_local + delta, 0.0)
        S_add = (mo.unpack_sym6(acc[:, 4:10])
                 - n_add[:, None, None] * (delta[:, :, None] * delta[:, None, :]))
        S_add = torch.where(has[:, None, None], S_add, 0.0)
        merged = cl.merge(lv.win[frame_slot], Cluster(n=n_add, mu=mu_add,
                                                      S=S_add))
        win = _set_slot(lv.win, frame_slot, merged)
        win_nv = _set_slot(lv.win_nv, frame_slot,
                           lv.win_nv[frame_slot] + nv_add)
        # running world-frame total: the voxel-relative raw moments
        # rotate as R q, so delta_w = R delta and S_w = R S R^T exactly
        delta_w = delta @ R.T
        mu_add_w = torch.where(has[:, None], center_slot + delta_w, 0.0)
        S_add_w = R @ S_add @ R.T
        tot = cl.merge(lv.tot, Cluster(n=n_add, mu=mu_add_w, S=S_add_w))
        tot_nv = lv.tot_nv + _rot_nv(R, nv_add)
        jour_arr = drop_set(lv.jour, torch.where(newly, us, C),
                            torch.zeros_like(us, dtype=lv.jour.dtype) + jour)
        out.append(dataclasses.replace(
            lv, keys=tkeys, occ=occ, win=win, win_nv=win_nv, tot=tot,
            tot_nv=tot_nv, jour=jour_arr))
        touched.append((uslots, uvalid & (us >= 0), dropped))
    return tuple(out), touched


def insert_fixed_level(lv: VoxelLevel, level_size: float, unique_max: int,
                       pts_world, tr_pt, mask, jour):
    """Insert world-frame points straight into the fixed (marginalized)
    statistics and the running total: the reference's keyframe-reload
    `cut_voxel` variant (voxel_map.hpp:2108-2152), used by loop
    corrections and keyframe loading. Points are summed per unique voxel
    (U rows), then merged into the claimed slots. Returns (level,
    touched_slots (U,), touched_valid (U,), dropped)."""
    C = lv.keys.shape[0]
    keys = vh.voxel_key(pts_world, level_size)
    uniq, uvalid, inv = vh.dedup_keys(keys, mask > 0, unique_max)
    tkeys, occ, uslots = vh.insert(lv.keys, lv.occ, uniq, uvalid)
    U = uslots.shape[0]
    nv_pt = expand_noise(tr_pt)
    inv = inv.long()
    us = uslots.long()
    ok = (mask > 0) & (inv >= 0)
    seg = torch.where(ok, inv, U)
    w = ok.to(pts_world.dtype)
    n_add = drop_add(pts_world.new_zeros((U,)), seg, w)
    sum_p = drop_add(pts_world.new_zeros((U, 3)), seg, pts_world * w[:, None])
    mu_add = sum_p / torch.clamp(n_add, min=1.0)[:, None]
    d = (pts_world - mu_add[torch.clamp(inv, 0, U - 1)]) * w[:, None]
    S_add = drop_add(pts_world.new_zeros((U, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])
    nv_add = drop_add(pts_world.new_zeros((U, NV)), seg, nv_pt * w[:, None])

    row_ok = uvalid & (us >= 0)
    su = torch.clamp(torch.where(row_ok, us, 0), 0, C - 1)
    added = Cluster(n=n_add, mu=mu_add, S=S_add)
    fixed = cl.merge(lv.fix[su], added)
    total = cl.merge(lv.tot[su], added)      # running world total
    tgt = torch.where(row_ok, su, C)
    fix = tmap(lambda full, new: drop_set(full, tgt, new), lv.fix, fixed)
    tot = tmap(lambda full, new: drop_set(full, tgt, new), lv.tot, total)
    fix_nv = drop_set(lv.fix_nv, tgt, lv.fix_nv[su] + nv_add)
    tot_nv = drop_set(lv.tot_nv, tgt, lv.tot_nv[su] + nv_add)

    newly = uvalid & (us >= 0) & ~lv.occ[torch.clamp(us, min=0)]
    jour_arr = drop_set(lv.jour, torch.where(newly, us, C),
                        torch.zeros_like(us, dtype=lv.jour.dtype) + jour)
    lv = dataclasses.replace(lv, keys=tkeys, occ=occ, fix=fix, fix_nv=fix_nv,
                             tot=tot, tot_nv=tot_nv, jour=jour_arr)
    dropped = torch.sum((uvalid & (us < 0)).to(torch.int32))
    return lv, uslots, uvalid & (us >= 0), dropped


def insert_fixed(levels, cfg: MapConfig, pts_world, tr_pt, mask, jour=0.0):
    levels, _ = insert_fixed_touched(levels, cfg, pts_world, tr_pt, mask,
                                     jour)
    return levels


def insert_fixed_touched(levels, cfg: MapConfig, pts_world, tr_pt, mask,
                         jour=0.0):
    """insert_fixed + per-level (slots, valid, dropped) of touched voxels."""
    out, touched = [], []
    for l, lv in enumerate(levels):
        lv2, s, sv, dropped = insert_fixed_level(
            lv, cfg.level_size(l), cfg.unique_max[l], pts_world, tr_pt,
            mask, jour)
        out.append(lv2)
        touched.append((s, sv, dropped))
    return tuple(out), touched


# ---------------------------------------------------------------------------
# Plane refresh (reference recut + plane_update, voxel_map.hpp:1344-1456)
# ---------------------------------------------------------------------------

def _phys_poses(Rs, ps, mp, win_count):
    """Window poses + validity in PHYSICAL slot order."""
    W = mp.shape[0]
    mp = mp.long()
    inv = torch.zeros((W,), dtype=torch.int64, device=mp.device)
    inv[mp] = torch.arange(W, device=mp.device)
    live = (torch.arange(W, device=mp.device) < win_count).to(Rs.dtype)
    fmask = torch.zeros((W,), dtype=Rs.dtype, device=mp.device)
    fmask[mp] = live
    return Rs[inv], ps[inv], fmask


def _total_over_frames(win: Cluster, win_nv, fix: Cluster, fix_nv, Rs_p,
                       ps_p, fmask):
    """fix + sum_w transform(win[w], pose_w) as one anchored reduction."""
    n_w = win.n * fmask[:, None]
    mu_w = torch.einsum("wij,wbj->wbi", Rs_p, win.mu) + ps_p[:, None]
    S_w = Rs_p[:, None] @ win.S @ Rs_p.transpose(-1, -2)[:, None]
    n_t = fix.n + torch.sum(n_w, dim=0)
    inv_n = 1.0 / torch.clamp(n_t, min=1.0)
    mu_t = (fix.n[:, None] * fix.mu
            + torch.einsum("wb,wbi->bi", n_w, mu_w)) * inv_n[:, None]
    d_w = mu_w - mu_t[None]
    d_f = fix.mu - mu_t
    S_t = (fix.S + fix.n[:, None, None] * (d_f[:, :, None] * d_f[:, None, :])
           + torch.einsum("wbij,w->bij", S_w, fmask)
           + torch.einsum("wb,wbi,wbj->bij", n_w, d_w, d_w))
    empty = (n_t == 0)[:, None]
    mu_t = torch.where(empty, 0.0, mu_t)
    S_t = torch.where(empty[..., None], 0.0, S_t)
    s_w = torch.einsum("wij,wbj->wbi", Rs_p, win_nv[..., 0:3])
    nv = fix_nv + torch.cat(
        [torch.einsum("wbi,w->bi", s_w, fmask),
         torch.einsum("wbk,w->bk", win_nv[..., 3:5], fmask)], dim=-1)
    return Cluster(n=n_t, mu=mu_t, S=S_t), nv


def total_cluster_level(lv: VoxelLevel, Rs, ps, mp, win_count):
    Rs_p, ps_p, fmask = _phys_poses(Rs, ps, mp, win_count)
    return _total_over_frames(lv.win, lv.win_nv, lv.fix, lv.fix_nv,
                              Rs_p, ps_p, fmask)


def _plane_fit(total: Cluster, nv_total, occ, layer, cfg: MapConfig,
               min_eig, thr):
    """Plane fit of a batch of total clusters -> (state, slab, lam)."""
    covm = cl.cov(total)
    lam, V = eigh3(covm)
    n = total.n
    enough = n > cfg.min_point[layer]
    is_plane = (occ & enough & (lam[:, 0] < min_eig)
                & (lam[:, 0] < thr * lam[:, 2]))
    can_subdiv = occ & enough & ~is_plane & (layer < cfg.max_layer)
    state = torch.where(is_plane, STATE_PLANE,
                        torch.where(can_subdiv, STATE_SUBDIV,
                                    STATE_NONE)).to(torch.int32)
    u0 = V[:, :, 0]
    us = torch.sum(u0 * nv_total[:, 0:3], dim=-1)
    asum = nv_total[:, 3]
    den = torch.where(torch.abs(asum) > 1e-12, asum, float("inf"))
    vsum_n = torch.clamp(us * us / den + nv_total[:, 4], min=1e-12)
    sigma2 = vsum_n / torch.clamp(n, min=1.0)
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    c_1 = (l0 + l1) / torch.clamp((l1 - l0) ** 2, min=1e-12)
    c_2 = (l0 + l2) / torch.clamp((l2 - l0) ** 2, min=1e-12)
    n_tot = torch.clamp(n, min=1.0)
    cmean = 0.5 * (c_1 + c_2) * sigma2 / n_tot
    cvar = sigma2 / n_tot
    slab = torch.cat([u0, total.mu, l2[:, None], cmean[:, None],
                      cvar[:, None], state.to(covm.dtype)[:, None],
                      covm.new_zeros((state.shape[0], SLAB - 10))], dim=1)
    return state, slab, lam


def refresh_planes_level(lv: VoxelLevel, layer: int, cfg: MapConfig, Rs, ps,
                         mp, win_count, min_eigen_value=None, plane_thr=None,
                         slots=None, svalid=None) -> VoxelLevel:
    """Re-fit planes: the whole table (and resync `tot`), or with `slots`
    only those voxels, straight from the running total."""
    min_eig = cfg.min_eigen_value if min_eigen_value is None else min_eigen_value
    thr = cfg.plane_thr[layer] if plane_thr is None else plane_thr
    if slots is None:
        total, nv_total = total_cluster_level(lv, Rs, ps, mp, win_count)
        state, slab, lam = _plane_fit(total, nv_total, lv.occ, layer, cfg,
                                      min_eig, thr)
        return dataclasses.replace(lv, state=state, slab=slab, lam=lam,
                                   tot=total, tot_nv=nv_total)
    C = lv.keys.shape[0]
    slots = slots.long()
    si = torch.where(svalid, slots, 0)
    occ_u = lv.occ[si] & svalid
    state_u, slab_u, lam_u = _plane_fit(lv.tot[si], lv.tot_nv[si], occ_u,
                                        layer, cfg, min_eig, thr)
    tgt = torch.where(svalid, slots, C)
    return dataclasses.replace(lv, state=drop_set(lv.state, tgt, state_u),
                               slab=drop_set(lv.slab, tgt, slab_u),
                               lam=drop_set(lv.lam, tgt, lam_u))


def refresh_planes(levels, cfg: MapConfig, Rs, ps, mp, win_count,
                   min_eigen_value=None, plane_thr=None, touched=None):
    out = []
    for l, lv in enumerate(levels):
        s, sv = (None, None) if touched is None else touched[l][:2]
        out.append(refresh_planes_level(lv, l, cfg, Rs, ps, mp, win_count,
                                        min_eigen_value, plane_thr, s, sv))
    return tuple(out)


# ---------------------------------------------------------------------------
# Point-to-plane matching (reference OctoTree::match, voxel_map.hpp:1649-1721)
# ---------------------------------------------------------------------------

def match_locate(levels, cfg: MapConfig, pts_world, mask):
    """Resolve each world point to its plane record by the octree descent
    (plane -> use, subdiv -> next level): ((N, SLAB) records, found)."""
    N = pts_world.shape[0]
    rec = pts_world.new_zeros((N, SLAB))
    found = torch.zeros((N,), dtype=torch.bool, device=pts_world.device)
    descend = torch.ones((N,), dtype=torch.bool, device=pts_world.device)
    for l, lv in enumerate(levels):
        keys = vh.voxel_key(pts_world, cfg.level_size(l))
        s = vh.lookup(lv.keys, lv.occ, keys, (mask > 0) & descend).long()
        r = lv.slab[torch.clamp(s, min=0)]
        st = torch.where(s >= 0, r[:, _S_STATE], 0.0)
        use_l = descend & (st == STATE_PLANE)
        descend = descend & (st == STATE_SUBDIV)
        rec = torch.where(use_l[:, None], r, rec)
        found = found | use_l
    return rec, found


def match_eval(rec, found, pts_world, var_world, mask):
    """Match gates at (possibly updated) world points: in-plane radius
    <= 9 * radius and |d| < 3 sqrt(sigma)."""
    normal = rec[:, _S_NORMAL]
    center = rec[:, _S_CENTER]
    radius = rec[:, _S_RADIUS]
    cmean = rec[:, _S_CMEAN]
    cvar = rec[:, _S_CVAR]
    dvec = pts_world - center
    dist = torch.sum(normal * dvec, dim=-1)
    dd = torch.sum(dvec * dvec, dim=-1)
    range_dis = dd - dist * dist
    in_radius = range_dis <= 9.0 * radius
    sigma = (cmean * range_dis + cvar
             + torch.einsum("ni,nij,nj->n", normal, var_world, normal))
    in_gate = torch.abs(dist) < 3.0 * torch.sqrt(torch.clamp(sigma, min=1e-12))
    valid = found & in_radius & in_gate & (mask > 0)
    return dict(valid=valid, normal=normal, center=center, sigma=sigma,
                dist=dist)


def match_points(levels, cfg: MapConfig, pts_world, var_world, mask):
    rec, found = match_locate(levels, cfg, pts_world, mask)
    return match_eval(rec, found, pts_world, var_world, mask)


# ---------------------------------------------------------------------------
# Marginalization (reference OctoTree::margi, voxel_map.hpp:1465-1598)
# ---------------------------------------------------------------------------

def marginalize_level(lv: VoxelLevel, cfg: MapConfig, Rs, ps, mp, win_count,
                      mgsize: int) -> VoxelLevel:
    """Fold the oldest `mgsize` window frames into the fixed statistics
    (voxels under the max_points cap), then clear those window slots."""
    if lv.tsl.shape[1]:
        raise NotImplementedError("touched-slot tracking is not ported")
    C = lv.keys.shape[0]
    moved = Cluster.empty((C,), device=lv.fix.n.device)
    nv_m = torch.zeros_like(lv.fix_nv)
    for i in range(mgsize):
        moved = cl.merge(moved, cl.transform(lv.win[mp[i]], Rs[i], ps[i]))
        nv_m = nv_m + _rot_nv(Rs[i], lv.win_nv[mp[i]])
    take = lv.fix.n < cfg.max_points
    folded = cl.merge(lv.fix, moved)
    fix = Cluster(n=torch.where(take, folded.n, lv.fix.n),
                  mu=torch.where(take[:, None], folded.mu, lv.fix.mu),
                  S=torch.where(take[:, None, None], folded.S, lv.fix.S))
    fix_nv = torch.where(take[:, None], lv.fix_nv + nv_m, lv.fix_nv)
    win, win_nv = lv.win, lv.win_nv
    for i in range(mgsize):
        win = tmap(lambda a: _zero_slot(a, mp[i]), win)
        win_nv = _zero_slot(win_nv, mp[i])
    return dataclasses.replace(lv, fix=fix, fix_nv=fix_nv, win=win,
                               win_nv=win_nv)


def _zero_slot(a, slot):
    a = a.clone()
    a[slot] = 0.0
    return a


def marginalize(levels, cfg: MapConfig, Rs, ps, mp, win_count, mgsize: int):
    return tuple(marginalize_level(lv, cfg, Rs, ps, mp, win_count, mgsize)
                 for lv in levels)


# ---------------------------------------------------------------------------
# Distance-based eviction (reference voxelslam.cpp:1786-1833)
# ---------------------------------------------------------------------------

def evict_level(lv: VoxelLevel, jour_now, max_dist: float):
    """Rebuild the level keeping voxels created within `max_dist` of the
    current journey distance (rehash survivors into a fresh table and
    permute every per-slot array). Returns (level, dropped)."""
    C = lv.keys.shape[0]
    keep = lv.occ & (jour_now - lv.jour <= max_dist)
    nkeys, nocc = vh.empty_table(C, lv.keys.device)
    nkeys, nocc, slots = vh.insert(nkeys, nocc, lv.keys, keep)
    slots = slots.long()
    dropped = torch.sum((keep & (slots < 0)).to(torch.int32))
    tgt = torch.where(keep & (slots >= 0), slots, C)

    def perm(src):
        k = keep.reshape((-1,) + (1,) * (src.dim() - 1))
        return drop_set(torch.zeros_like(src), tgt,
                        torch.where(k, src, torch.zeros_like(src)))

    def perm_w(src):   # (W, C, ...): permute axis 1
        k = keep.reshape((1, -1) + (1,) * (src.dim() - 2))
        return drop_set(torch.zeros_like(src), tgt,
                        torch.where(k, src, 0.0), dim=1)

    return VoxelLevel(
        keys=nkeys, occ=nocc, win=tmap(perm_w, lv.win),
        win_nv=perm_w(lv.win_nv), fix=tmap(perm, lv.fix),
        fix_nv=perm(lv.fix_nv), tot=tmap(perm, lv.tot),
        tot_nv=perm(lv.tot_nv), state=perm(lv.state), slab=perm(lv.slab),
        lam=perm(lv.lam), jour=perm(lv.jour), tsl=lv.tsl), dropped


def evict(levels, jour_now, max_dist: float = 700.0):
    outs = [evict_level(lv, jour_now, max_dist) for lv in levels]
    return tuple(o[0] for o in outs), torch.stack([o[1] for o in outs])


def map_stats(levels):
    out = {}
    for l, lv in enumerate(levels):
        out[f"occ_{l}"] = torch.sum(lv.occ)
        out[f"planes_{l}"] = torch.sum(lv.state == STATE_PLANE)
    return out


# ---------------------------------------------------------------------------
# Factor harvest (reference OctoTree::tras_opt, voxel_map.hpp:1605-1638)
# ---------------------------------------------------------------------------

def compact_indices(flags: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First `size` indices where flags is True, ascending, padded with
    `fill` (cumsum + left binary search, as the JAX package)."""
    C = flags.shape[0]
    cs = torch.cumsum(flags.to(torch.int64), 0)
    want = torch.arange(1, size + 1, dtype=torch.int64, device=flags.device)
    idx = torch.searchsorted(cs, want)
    return torch.where(idx < C, idx, fill)


def harvest_level_t(lv: VoxelLevel, cfg: MapConfig, mp, factor_max: int,
                    eig_ratio: float):
    """Eligible plane voxels (plane leaf, lam0 <= eig_ratio lam1, live
    window points) as factor-minor arrays: (n_l (W,F), mu_l (W,3,F),
    S_l (W,3,3,F), fix_n (F,), fix_mu (3,F), fix_S (3,3,F), vf (F,))."""
    C = lv.keys.shape[0]
    n_win = torch.sum(lv.win.n, dim=0)
    eligible = ((lv.state == STATE_PLANE)
                & (lv.lam[:, 0] <= eig_ratio * torch.clamp(lv.lam[:, 1],
                                                           min=1e-12))
                & (n_win > 0))
    idx = compact_indices(eligible, factor_max, C)
    valid = idx < C
    safe = torch.clamp(idx, max=C - 1)
    vf = valid.to(lv.win.mu.dtype)
    rows, cols = mp.long()[:, None], safe[None, :]
    n_l = lv.win.n[rows, cols] * vf[None]
    mu_l = lv.win.mu[rows, cols].permute(0, 2, 1) * vf[None, None]
    S_l = lv.win.S[rows, cols].permute(0, 2, 3, 1) * vf[None, None, None]
    fix_n = lv.fix.n[safe] * vf
    fix_mu = lv.fix.mu[safe].T * vf[None]
    fix_S = lv.fix.S[safe].permute(1, 2, 0) * vf[None, None]
    return n_l, mu_l, S_l, fix_n, fix_mu, fix_S, vf


def harvest_t(levels, cfg: MapConfig, mp, factor_max: int):
    """Factor-minor harvest across levels (concatenated on the factor
    axis), ready for `ba.optimizers.lm_li`."""
    parts = [harvest_level_t(lv, cfg, mp, factor_max, cfg.eig_ratio_ba)
             for lv in levels]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(7))
