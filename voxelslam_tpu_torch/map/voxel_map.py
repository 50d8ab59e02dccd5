"""Tensorized multi-resolution voxel plane map (port of
`voxelslam_tpu/map/voxel_map.py`; see that module for the design:
fixed-capacity hashed levels replacing the reference's OctoTree,
voxelslam voxel_map.hpp:1047-1881).

Per voxel: state 0 (no plane), 1 (plane leaf: match here), 2 (non-planar:
descend). Window-frame statistics are local-frame centered clusters per
(window slot, voxel), window axis major (W, C, ...).

Touched-slot tracking (`MapConfig.track_touched`, off by default) gives
each level a (W, T) list `tsl` of the slots each window frame's scan
touched (T = the level's unique_max, sentinel C). Insert writes the scan's
U rows and its list, `marginalize` folds only the listed slots (a (T,)
gather instead of whole-table passes), `evict` remaps the lists through
the rehash. As in the JAX package, `insert_scan_fused` (the steady step's
insert) refuses tracked levels with ValueError, so a pipeline with
tracking on fails at its first steady scan.

`harvest` gathers plane factors factor-major (`ba.lidar_factor.FactorBatch`,
the autodiff oracle's layout); `harvest_t` gathers the same factors
factor-minor for the LM loops, and equals `transpose_factors(harvest(...))`.

XLA's drop-mode scatters become writes into a spare row at index C
(`core.tensors.drop_set/drop_add`); every gather index is clamped or
masked into range first. Functions return new levels and never modify
their inputs.

The global BA's path (`empty_level`, `insert_scan_level`, the whole-table
`refresh_planes`, `harvest_t`, `compact_indices`) also takes a leading
window axis: a level of `empty_level(nw=...)` holds Nw windows' tables,
every array with the axis in front, and each window's result is the one
it gets alone (the JAX package vmaps these functions). The voxel size and
plane gates may then be (Nw,) tensors, since the windows of one batch can
be in different phases.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ba.lidar_factor import FactorBatch
from ..config import MapConfig
from ..core import cluster as cl
from ..core.cluster import Cluster
from ..core.eig3 import eigh3_forward
from ..core.tensors import (drop_add, drop_set, put_row, take_row, tmap,
                            window_einsum, window_wsum)
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
    tsl: torch.Tensor      # (W, T) int32 touched-slot list per window
                           # slot (sentinel C; T = 0: tracking off).
                           # Invariant: win[w] is nonzero only at slots
                           # listed in tsl[w]

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
                device=None, nw: int | None = None) -> VoxelLevel:
    """An empty level with a `track_max`-wide touched-slot list (0 turns
    tracking off); with `nw`, nw untracked levels along a leading window
    axis (the global BA's window maps, which never marginalize)."""
    if nw is not None and track_max:
        raise ValueError("levels with a window axis are untracked: "
                         "track_max must be 0")
    b = () if nw is None else (nw,)
    keys, occ = vh.empty_table(capacity, device, b)
    C = capacity
    z = dict(dtype=torch.float32, device=device)
    return VoxelLevel(
        keys=keys, occ=occ,
        win=Cluster.empty(b + (win_size, C), device=device),
        win_nv=torch.zeros(b + (win_size, C, NV), **z),
        fix=Cluster.empty(b + (C,), device=device),
        fix_nv=torch.zeros(b + (C, NV), **z),
        tot=Cluster.empty(b + (C,), device=device),
        tot_nv=torch.zeros(b + (C, NV), **z),
        state=torch.zeros(b + (C,), dtype=torch.int32, device=device),
        slab=torch.zeros(b + (C, SLAB), **z),
        lam=torch.zeros(b + (C, 3), **z),
        jour=torch.zeros(b + (C,), **z),
        tsl=torch.full(b + (win_size, track_max), C, dtype=torch.int32,
                       device=device),
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
    return tuple(
        empty_level(c, cfg.win_size,
                    cfg.unique_max[l] if cfg.track_touched else 0, device)
        for l, c in enumerate(cfg.capacities))


def _set_slot(full, frame_slot, new, axis: int = 0):
    """Functional `full.at[frame_slot].set(new)` along `axis` over a
    cluster or tensor (`frame_slot` an int or a 0-dim tensor)."""
    return tmap(lambda a, b: put_row(a, frame_slot, b, axis), full, new)


def _rot_nv(R, nv):
    """Rotate the direction channels of (.., NV) noise records by R."""
    return torch.cat([nv[:, 0:3] @ R.T, nv[:, 3:5]], dim=-1)


# ---------------------------------------------------------------------------
# Insertion (reference cut_voxel, voxel_map.hpp:1896-2096)
# ---------------------------------------------------------------------------

def insert_scan_level(lv: VoxelLevel, level_size: float, unique_max: int,
                      pts_world, pts_local, tr_pt, mask, frame_slot, jour):
    """Insert one scan's points into a level at window slot `frame_slot`.
    Returns (level, touched_slots (U,), touched_valid (U,), dropped).

    An untracked level takes the dense-column path: per-point sums into
    (C,) columns, one whole-column merge. A tracked level (tsl width T > 0)
    sums per unique voxel (U rows), merges those rows alone and lists
    them in tsl[frame_slot]; U > T raises ValueError.

    With a leading window axis (a level of `empty_level(nw=...)`, points
    (Nw, P, 3), mask (Nw, P), `level_size` a float or an (Nw,) tensor)
    each window's scan goes into its own table at the same frame slot, and
    every output gains the axis. The per-slot sums run over the Nw tables
    laid end to end, each slot's in point order."""
    lead = lv.keys.shape[:-2]
    C = lv.keys.shape[-2]
    if torch.is_tensor(level_size):
        level_size = level_size.reshape(lead + (1, 1))
    keys = vh.voxel_key(pts_world, level_size)
    unique_max = min(unique_max, pts_world.shape[-2])
    uniq, uvalid, inv = vh.dedup_keys(keys, mask > 0, unique_max)
    tkeys, occ, uslots = vh.insert(lv.keys, lv.occ, uniq, uvalid)
    nv_pt = expand_noise(tr_pt).expand(pts_local.shape[:-1] + (NV,))

    inv = inv.long()
    us = uslots.long()
    if lv.tsl.shape[-1]:
        win, win_nv, tsl = _insert_rows(lv, frame_slot, uvalid, us, inv,
                                        pts_local, nv_pt, mask)
    else:
        win, win_nv = _insert_columns(lv, frame_slot, us, inv, pts_local,
                                      nv_pt, mask)
        tsl = lv.tsl

    newly = (uvalid & (us >= 0)
             & ~torch.gather(lv.occ, -1, torch.clamp(us, min=0)))
    jour_arr = drop_set(lv.jour.reshape(-1),
                        vh.flat_index(torch.where(newly, us, -1), C),
                        (torch.full_like(us, 0, dtype=lv.jour.dtype)
                         + jour).reshape(-1)).reshape(lv.jour.shape)
    lv = dataclasses.replace(lv, keys=tkeys, occ=occ, win=win,
                             win_nv=win_nv, jour=jour_arr, tsl=tsl)
    dropped = torch.sum((uvalid & (us < 0)).to(torch.int32), dim=-1)
    return lv, uslots, uvalid & (us >= 0), dropped


def _point_sums(U, seg, w, pts, nv_pt):
    """Per-segment point count, point sum and noise record, (U,), (U, 3)
    and (U, NV), as one drop-mode add of the packed (N, 4 + NV) rows
    [w, w p, w nv] (the scatter matrix needs the mean first: its own add)."""
    acc = drop_add(pts.new_zeros((U, 4 + NV)), seg,
                   torch.cat([w[:, None], pts * w[:, None], nv_pt * w[:, None]],
                             dim=1))
    return acc[:, 0], acc[:, 1:4], acc[:, 4:]


def _insert_columns(lv: VoxelLevel, frame_slot, us, inv, pts_local, nv_pt,
                    mask):
    """Dense-column insert: per-point sums into (C,)-sized columns (of
    every table, with a window axis), merged into win[frame_slot] whole.
    Returns (win, win_nv)."""
    lead = lv.keys.shape[:-2]
    C = lv.keys.shape[-2]
    NC = lv.occ.numel()
    pslot = torch.where(inv >= 0, torch.gather(us, -1, torch.clamp(inv, min=0)),
                        -1)
    ok = ((mask > 0) & (pslot >= 0)).reshape(-1)
    if lead:                        # slots of the tables laid end to end
        pslot = torch.where(pslot >= 0, pslot + vh.block_base(
            pslot.shape[0], C, pslot.device), -1)
    pslot = pslot.reshape(-1)
    pts = pts_local.reshape(-1, 3)
    seg = torch.where(ok, pslot, NC)
    w = ok.to(pts.dtype)
    n_add, sum_p, nv_add = _point_sums(NC, seg, w, pts, nv_pt.reshape(-1, NV))
    mu_add = sum_p / torch.clamp(n_add, min=1.0)[:, None]
    d = (pts - mu_add[torch.clamp(pslot, min=0)]) * w[:, None]
    S_add = drop_add(pts.new_zeros((NC, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])
    added = Cluster(n=n_add.reshape(lead + (C,)),
                    mu=mu_add.reshape(lead + (C, 3)),
                    S=S_add.reshape(lead + (C, 3, 3)))
    at = (slice(None),) * len(lead) + (frame_slot,)
    ax = len(lead)
    win = _set_slot(lv.win, frame_slot, cl.merge(lv.win[at], added), ax)
    win_nv = _set_slot(lv.win_nv, frame_slot,
                       lv.win_nv[at] + nv_add.reshape(lead + (C, NV)), ax)
    return win, win_nv


def _insert_rows(lv: VoxelLevel, frame_slot, uvalid, us, inv, pts_local,
                 nv_pt, mask):
    """Touched-slot insert (one table): per-voxel sums over the U unique
    keys, merged into their rows of win[frame_slot], which tsl[frame_slot]
    then lists. Returns (win, win_nv, tsl)."""
    C = lv.keys.shape[0]
    W = lv.win.n.shape[0]
    U = us.shape[0]
    T = lv.tsl.shape[1]
    if U > T:
        # rows past T would hold window stats the sparse marginalize never
        # sees (dropped at the column clear): refuse, as the JAX package
        raise ValueError(
            f"insert_scan_level: scan unique cap U={U} exceeds the "
            f"touched-slot track width T={T}; size tsl to unique_max or "
            f"disable tracking (T=0) for this level")
    ok = (mask > 0) & (inv >= 0)
    seg = torch.where(ok, inv, U)
    w = ok.to(pts_local.dtype)
    n_add, sum_p, nv_add = _point_sums(U, seg, w, pts_local, nv_pt)
    mu_add = sum_p / torch.clamp(n_add, min=1.0)[:, None]
    d = (pts_local - mu_add[torch.clamp(inv, 0, U - 1)]) * w[:, None]
    S_add = drop_add(pts_local.new_zeros((U, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])

    row_ok = uvalid & (us >= 0)
    flat = frame_slot * C + torch.clamp(torch.where(row_ok, us, 0), 0, C - 1)
    tgt = torch.where(row_ok, flat, W * C)
    win_flat = tmap(lambda a: a.reshape((W * C,) + a.shape[2:]), lv.win)
    merged = cl.merge(win_flat[flat], Cluster(n=n_add, mu=mu_add, S=S_add))
    win = tmap(lambda full, new, like: drop_set(full, tgt, new).reshape(
        like.shape), win_flat, merged, lv.win)
    nvw_flat = lv.win_nv.reshape(W * C, NV)
    win_nv = drop_set(nvw_flat, tgt, nvw_flat[flat] + nv_add).reshape(
        lv.win_nv.shape)
    row = torch.full((T,), C, dtype=lv.tsl.dtype, device=us.device)
    row[:U] = torch.where(row_ok, us, C)
    tsl = lv.tsl.clone()
    tsl[frame_slot] = row
    return win, win_nv, tsl


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
    closed form after the sum. (R, p) is the scan pose. Each level's
    touched entry also counts the valid points the dedup dropped past
    the level's `unique_max`: (slots, valid, dropped, unique_dropped)."""
    P = pts_world.shape[0]
    nv_pt = expand_noise(tr_pt)
    valid = mask > 0
    n_valid = torch.sum(valid, dtype=torch.int32)
    pre, slots_l, upds_l = [], [], []
    for l, lv in enumerate(levels):
        if lv.tsl.shape[1]:
            raise ValueError("insert_scan_fused requires untracked levels")
        C = lv.keys.shape[0]
        size = cfg.level_size(l)
        keys = vh.voxel_key(pts_world, size)
        uniq, uvalid, inv = vh.dedup_keys(keys, valid,
                                          min(cfg.unique_max[l], P))
        tkeys, occ, uslots = vh.insert(lv.keys, lv.occ, uniq, uvalid)
        inv = inv.long()
        kept = inv >= 0                 # valid and within unique_max
        us = uslots.long()
        pslot = torch.where(kept, us[torch.clamp(inv, min=0)], -1)
        ok = valid & (pslot >= 0)
        w = ok.to(pts_local.dtype)
        center_w = (keys.to(pts_world.dtype) + 0.5) * size
        q = (pts_world - center_w) @ R                  # R^T (pw - c)
        slots_l.append(torch.clamp(pslot, 0, C - 1).to(torch.int32))
        upds_l.append(mo.pack_updates(q, nv_pt, w))
        newly = uvalid & (us >= 0) & ~lv.occ[torch.clamp(us, min=0)]
        dropped = torch.sum((uvalid & (us < 0)).to(torch.int32))
        udrop = n_valid - torch.sum(kept, dtype=torch.int32)
        pre.append((tkeys, occ, uslots, us, uvalid, newly, dropped, udrop))

    accs = mo.accumulate(torch.stack(slots_l).contiguous(),
                         torch.stack(upds_l).contiguous(),
                         tuple(lv.keys.shape[0] for lv in levels))

    out, touched = [], []
    for l, (lv, acc) in enumerate(zip(levels, accs)):
        C = lv.keys.shape[0]
        size = cfg.level_size(l)
        tkeys, occ, uslots, us, uvalid, newly, dropped, udrop = pre[l]
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
        merged = cl.merge(tmap(lambda a: take_row(a, frame_slot), lv.win),
                          Cluster(n=n_add, mu=mu_add, S=S_add))
        win = _set_slot(lv.win, frame_slot, merged)
        win_nv = _set_slot(lv.win_nv, frame_slot,
                           take_row(lv.win_nv, frame_slot) + nv_add)
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
        touched.append((uslots, uvalid & (us >= 0), dropped, udrop))
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
    n_add, sum_p, nv_add = _point_sums(U, seg, w, pts_world, nv_pt)
    mu_add = sum_p / torch.clamp(n_add, min=1.0)[:, None]
    d = (pts_world - mu_add[torch.clamp(inv, 0, U - 1)]) * w[:, None]
    S_add = drop_add(pts_world.new_zeros((U, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])

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
    """fix + sum_w transform(win[w], pose_w) as one anchored reduction
    (`window_wsum` and `window_einsum` keep a window's sums under vmap,
    see `core.tensors.per_window`)."""
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
           + window_wsum(S_w, fmask)
           + window_einsum("wb,wbi,wbj->bij", n_w, d_w, d_w))
    empty = (n_t == 0)[:, None]
    mu_t = torch.where(empty, 0.0, mu_t)
    S_t = torch.where(empty[..., None], 0.0, S_t)
    s_w = torch.einsum("wij,wbj->wbi", Rs_p, win_nv[..., 0:3])
    nv = fix_nv + torch.cat(
        [torch.einsum("wbi,w->bi", s_w, fmask),
         torch.einsum("wbk,w->bk", win_nv[..., 3:5], fmask)], dim=-1)
    return Cluster(n=n_t, mu=mu_t, S=S_t), nv


def _total_flat(wn, wmu, wS, wnv, fn, fmu, fS, fnv, Rs, ps, mp, win_count):
    total, nv = _total_over_frames(
        Cluster(n=wn, mu=wmu, S=wS), wnv, Cluster(n=fn, mu=fmu, S=fS), fnv,
        *_phys_poses(Rs, ps, mp, win_count))
    return total.n, total.mu, total.S, nv


def total_cluster_level(lv: VoxelLevel, Rs, ps, mp, win_count):
    """The level's total clusters over its window frames and fixed points;
    a level with a leading window axis (poses (Nw, W, ...), one `mp`)
    through torch.func.vmap, each window's sums in their own order."""
    args = (lv.win.n, lv.win.mu, lv.win.S, lv.win_nv, lv.fix.n, lv.fix.mu,
            lv.fix.S, lv.fix_nv, Rs, ps, mp, win_count)
    if lv.keys.dim() == 2:
        n, mu, S, nv = _total_flat(*args)
    else:
        n, mu, S, nv = torch.func.vmap(
            _total_flat, in_dims=(0,) * 10 + (None, None))(*args)
    return Cluster(n=n, mu=mu, S=S), nv


def _plane_fit(total: Cluster, nv_total, occ, layer, cfg: MapConfig,
               min_eig, thr):
    """Plane fit of a batch of total clusters -> (state, slab, lam)."""
    covm = cl.cov(total)
    lam, V = eigh3_forward(covm)
    n = total.n
    enough = n > cfg.min_point[layer]
    is_plane = (occ & enough & (lam[..., 0] < min_eig)
                & (lam[..., 0] < thr * lam[..., 2]))
    can_subdiv = occ & enough & ~is_plane & (layer < cfg.max_layer)
    state = torch.where(is_plane, STATE_PLANE,
                        torch.where(can_subdiv, STATE_SUBDIV,
                                    STATE_NONE)).to(torch.int32)
    u0 = V[..., :, 0]
    us = torch.sum(u0 * nv_total[..., 0:3], dim=-1)
    asum = nv_total[..., 3]
    den = torch.where(torch.abs(asum) > 1e-12, asum, float("inf"))
    vsum_n = torch.clamp(us * us / den + nv_total[..., 4], min=1e-12)
    sigma2 = vsum_n / torch.clamp(n, min=1.0)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    c_1 = (l0 + l1) / torch.clamp((l1 - l0) ** 2, min=1e-12)
    c_2 = (l0 + l2) / torch.clamp((l2 - l0) ** 2, min=1e-12)
    n_tot = torch.clamp(n, min=1.0)
    cmean = 0.5 * (c_1 + c_2) * sigma2 / n_tot
    cvar = sigma2 / n_tot
    slab = torch.cat([u0, total.mu, l2[..., None], cmean[..., None],
                      cvar[..., None], state.to(covm.dtype)[..., None],
                      covm.new_zeros(state.shape + (SLAB - 10,))], dim=-1)
    return state, slab, lam


def refresh_planes_level(lv: VoxelLevel, layer: int, cfg: MapConfig, Rs, ps,
                         mp, win_count, min_eigen_value=None, plane_thr=None,
                         slots=None, svalid=None) -> VoxelLevel:
    """Re-fit planes: the whole table (and resync `tot`), or with `slots`
    only those voxels, straight from the running total. The whole-table
    path takes a leading window axis (poses (Nw, W, ...), gates floats or
    (Nw,) tensors)."""
    min_eig = cfg.min_eigen_value if min_eigen_value is None else min_eigen_value
    thr = cfg.plane_thr[layer] if plane_thr is None else plane_thr
    if slots is None:
        lead = lv.keys.shape[:-2]
        if torch.is_tensor(min_eig):
            min_eig = min_eig.reshape(lead + (1,))
        if torch.is_tensor(thr):
            thr = thr.reshape(lead + (1,))
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
    (voxels under the max_points cap), then clear those window slots.

    A tracked level folds sparsely: each frame's column is nonzero only at
    the <= T slots its scan listed in tsl, so the transform, merge and cap
    run on a (T,) gather. The cap is checked once, against the counts
    before the fold (reference margi, voxel_map.hpp:1543), on both paths.
    The column clear stays a whole write, which keeps the tsl invariant."""
    C = lv.keys.shape[0]
    if lv.tsl.shape[1]:
        fix, fix_nv = _fold_rows(lv, cfg, Rs, ps, mp, mgsize)
    else:
        moved = Cluster.empty((C,), device=lv.fix.n.device)
        nv_m = torch.zeros_like(lv.fix_nv)
        for i in range(mgsize):
            moved = cl.merge(moved, cl.transform(
                tmap(lambda a: take_row(a, mp[i]), lv.win), Rs[i], ps[i]))
            nv_m = nv_m + _rot_nv(Rs[i], take_row(lv.win_nv, mp[i]))
        take = lv.fix.n < cfg.max_points
        folded = cl.merge(lv.fix, moved)
        fix = Cluster(n=torch.where(take, folded.n, lv.fix.n),
                      mu=torch.where(take[:, None], folded.mu, lv.fix.mu),
                      S=torch.where(take[:, None, None], folded.S, lv.fix.S))
        fix_nv = torch.where(take[:, None], lv.fix_nv + nv_m, lv.fix_nv)
    win, win_nv, tsl = lv.win, lv.win_nv, lv.tsl
    for i in range(mgsize):
        win = tmap(lambda a: put_row(a, mp[i], 0.0), win)
        win_nv = put_row(win_nv, mp[i], 0.0)
        if tsl.shape[1]:
            tsl = put_row(tsl, mp[i], C)
    return dataclasses.replace(lv, fix=fix, fix_nv=fix_nv, win=win,
                               win_nv=win_nv, tsl=tsl)


def _fold_rows(lv: VoxelLevel, cfg: MapConfig, Rs, ps, mp, mgsize: int):
    """The sparse fold of a tracked level: (fix, fix_nv) after folding the
    listed slots of the first `mgsize` frames of mp."""
    C = lv.keys.shape[0]
    W = lv.win.n.shape[0]
    fix, fix_nv = lv.fix, lv.fix_nv
    pre_n = lv.fix.n
    win_flat = tmap(lambda a: a.reshape((W * C,) + a.shape[2:]), lv.win)
    nvw_flat = lv.win_nv.reshape(W * C, NV)
    for i in range(mgsize):
        row = lv.tsl[mp[i]].long()                   # (T,) slot ids
        sv = row < C
        si = torch.where(sv, row, 0)
        svf = sv.to(fix.mu.dtype)
        flat = mp[i].long() * C + si
        c_l = win_flat[flat]
        c_l = Cluster(n=c_l.n * svf, mu=c_l.mu * svf[:, None],
                      S=c_l.S * svf[:, None, None])
        c_w = cl.transform(c_l, Rs[i], ps[i])
        nv_w = _rot_nv(Rs[i], nvw_flat[flat] * svf[:, None])
        f_u, fnv_u = fix[si], fix_nv[si]
        take = pre_n[si] < cfg.max_points
        folded = cl.merge(f_u, c_w)
        new = Cluster(n=torch.where(take, folded.n, f_u.n),
                      mu=torch.where(take[:, None], folded.mu, f_u.mu),
                      S=torch.where(take[:, None, None], folded.S, f_u.S))
        tgt = torch.where(sv, si, C)
        fix = tmap(lambda full, v: drop_set(full, tgt, v), fix, new)
        fix_nv = drop_set(fix_nv, tgt, torch.where(take[:, None],
                                                   fnv_u + nv_w, fnv_u))
    return fix, fix_nv


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

    # touched-slot lists hold old slot ids: remap them through the rehash
    # (evicted and dropped voxels become the sentinel C)
    tsl = lv.tsl
    if tsl.shape[1]:
        remap = torch.cat([tgt, tgt.new_full((1,), C)])
        tsl = remap[torch.clamp(tsl.long(), 0, C)].to(tsl.dtype)

    return VoxelLevel(
        keys=nkeys, occ=nocc, win=tmap(perm_w, lv.win),
        win_nv=perm_w(lv.win_nv), fix=tmap(perm, lv.fix),
        fix_nv=perm(lv.fix_nv), tot=tmap(perm, lv.tot),
        tot_nv=perm(lv.tot_nv), state=perm(lv.state), slab=perm(lv.slab),
        lam=perm(lv.lam), jour=perm(lv.jour), tsl=tsl), dropped


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
    """First `size` indices where flags (..., C) is True, ascending, padded
    with `fill` (cumsum + left binary search, as the JAX package)."""
    C = flags.shape[-1]
    cs = torch.cumsum(flags.to(torch.int64), -1)
    want = torch.arange(1, size + 1, dtype=torch.int64, device=flags.device)
    idx = torch.searchsorted(cs, want.expand(cs.shape[:-1] + (size,))
                             .contiguous())
    return torch.where(idx < C, idx, fill)


def _eligible(lv: VoxelLevel, factor_max: int, eig_ratio: float):
    """The first factor_max eligible plane voxels (plane leaf, lam0 <=
    eig_ratio lam1, live window points; reference tras_opt): (valid (F,),
    slot (F,) clamped into the table)."""
    C = lv.keys.shape[-2]
    n_win = torch.sum(lv.win.n, dim=-2)
    eligible = ((lv.state == STATE_PLANE)
                & (lv.lam[..., 0] <= eig_ratio * torch.clamp(lv.lam[..., 1],
                                                             min=1e-12))
                & (n_win > 0))
    idx = compact_indices(eligible, factor_max, C)
    return idx < C, torch.clamp(idx, max=C - 1)


def harvest_level(lv: VoxelLevel, cfg: MapConfig, mp, factor_max: int,
                  eig_ratio: float):
    """Eligible plane voxels as factor-major clusters: (win (F, W) in
    logical frame order, fix (F,), valid (F,)), zero on invalid rows."""
    valid, safe = _eligible(lv, factor_max, eig_ratio)

    def keep(a):
        return torch.where(valid.reshape((-1,) + (1,) * (a.dim() - 1)), a,
                           torch.zeros_like(a))
    win = tmap(lambda a: keep(a[mp.long()][:, safe].movedim(0, 1)), lv.win)
    return win, tmap(lambda a: keep(a[safe]), lv.fix), valid


def harvest(levels, cfg: MapConfig, mp, factor_max: int) -> FactorBatch:
    """Factor-major harvest across levels (concatenated on the factor
    axis), each factor with coefficient 1."""
    parts = [harvest_level(lv, cfg, mp, factor_max, cfg.eig_ratio_ba)
             for lv in levels]
    win = tmap(lambda *xs: torch.cat(xs), *[p[0] for p in parts])
    fix = tmap(lambda *xs: torch.cat(xs), *[p[1] for p in parts])
    valid = torch.cat([p[2] for p in parts])
    return FactorBatch(win=win, fix=fix, coeff=valid.to(torch.float32),
                       valid=valid)


def harvest_level_t(lv: VoxelLevel, cfg: MapConfig, mp, factor_max: int,
                    eig_ratio: float):
    """`harvest_level`'s factors as factor-minor arrays: (n_l (W,F),
    mu_l (W,3,F), S_l (W,3,3,F), fix_n (F,), fix_mu (3,F), fix_S (3,3,F),
    vf (F,)); a level with a leading window axis gives each array that
    axis."""
    lead = lv.keys.shape[:-2]
    valid, safe = _eligible(lv, factor_max, eig_ratio)
    vf = valid.to(lv.win.mu.dtype)
    b = ((torch.arange(lead[0], device=safe.device)[:, None],) if lead
         else ())                   # each window gathers from its own table
    at_w = (b[0][..., None],) if lead else ()
    rows, cols = mp.long()[:, None], safe[..., None, :]
    n_l = lv.win.n[at_w + (rows, cols)] * vf[..., None, :]
    mu_l = (lv.win.mu[at_w + (rows, cols)].movedim(-1, -2)
            * vf[..., None, None, :])
    S_l = (lv.win.S[at_w + (rows, cols)].movedim(-3, -1)
           * vf[..., None, None, None, :])
    fix_n = lv.fix.n[b + (safe,)] * vf
    fix_mu = lv.fix.mu[b + (safe,)].transpose(-1, -2) * vf[..., None, :]
    fix_S = lv.fix.S[b + (safe,)].movedim(-3, -1) * vf[..., None, None, :]
    return n_l, mu_l, S_l, fix_n, fix_mu, fix_S, vf


def harvest_t(levels, cfg: MapConfig, mp, factor_max: int):
    """Factor-minor harvest across levels (concatenated on the factor
    axis), ready for `ba.optimizers.lm_li`."""
    parts = [harvest_level_t(lv, cfg, mp, factor_max, cfg.eig_ratio_ba)
             for lv in levels]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(7))
