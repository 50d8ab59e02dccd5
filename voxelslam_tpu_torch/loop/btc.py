"""Binary-Triangle-Combined (BTC) place-recognition descriptors (port of
`voxelslam_tpu/loop/btc.py`; the reference's STDescManager, BTC.h:228-274,
BTC.cpp:90-1479):

  keyframe cloud
    -> two-resolution voxel plane detection + EM coplanar merge
    -> corners, by one of two extractors (`BtcConfig.extractor`):
       "projection" (every default profile): band-pass points around each
       dominant plane, rasterize, per-cell occupancy over height slices,
       5x5-block max, greedy NMS, sub-cell two-line refinement, second
       NMS; "structural" (`BtcConfig.profile(extractor="structural")`, the
       measured alternative): intersections of plane triples with points
       of all three planes at the junction, NMS, a local re-fit of the
       three faces, and radial-shell x height-band codes
    -> triangles over each corner's nearest corners, sides sorted
    -> a hash DB keyed by quantized sides, voted with +-1 slack; RANSAC
       over matched triangles plus a plane-overlap score (host numpy).

Extraction runs as torch ops on the cloud's device. Every top-k and sort
of the JAX package becomes a stable sort, so ties go to the lower index
as `jax.lax.top_k` and `jnp.argsort` give them; `argmax` takes the first
maximum as `jnp.argmax` does. The greedy NMS (a `lax.scan` of dependent
steps) is a Python loop of small ops that never waits for the device.

The descriptor DB is backed by the native store (`csrc/btcdb.cpp`, see
`native.py`); building it raises on failure. The dict implementation
(`use_native=False`) is its plain version, which the tests hold it to.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from ..core.eig3 import eigh3_forward
from ..core.tensors import drop_add
from ..ops import voxel_hash as vh


@dataclasses.dataclass(frozen=True)
class BtcConfig:
    voxel_size: float = 2.0          # plane voxelization (BTC.cpp ground
    plane_min_points: int = 10       # profile voxel_size, read_parameters)
    plane_eig_thr: float = 0.01      # lam_min gate (BTC.cpp:110)
    max_planes: int = 24
    height_slices: int = 8
    slice_height: float = 0.5
    max_corners: int = 100           # useful_corner_num (BTC.cpp:7)
    knn_triangles: int = 15          # descriptor_near_num (BTC.cpp:22)
    nms_radius: float = 2.0          # corner suppression radius (m)
    merge_normal_dot: float = 0.9    # coplanar-merge |n_a . n_b| gate
    merge_dist: float = 0.4          # coplanar-merge plane-distance gate
    min_side: float = 2.0
    max_side: float = 50.0           # descriptor_max_len (BTC.cpp:24)
    side_quant: float = 0.2          # side-length hash quantization (m)
    min_votes: int = 5               # candidate gate (BTC.cpp:1227)
    max_matches: int = 2048          # pair cap fed to the verifier
    ransac_hyps: int = 512           # similarity-ranked hypothesis cap
    junction_radius: float = 1.5     # (structural extractor only)
    junction_plane_tol: float = 0.25
    support_radius: float = 1.0
    binary_thr: float = 0.7          # similarity_threshold (BTC.cpp:31)
    vertex_tol: float = 1.0          # agreement threshold (m)
    plane_norm_tol: float = 0.85     # overlap: |n_s . n_t| >=
    plane_dist_tol: float = 0.5      # overlap: |n.(c_s - c_t)| <
    is_high_fly: bool = False
    extractor: str = "projection"
    proj_plane_num: int = 3          # see the JAX package's note
    proj_resolution: float = 0.5     # image cell size (BTC.cpp:14)
    proj_dis_min: float = 0.0        # band-pass |dist to plane| (m)
    proj_dis_max: float = 5.0        # (BTC.cpp:16-17/48-49)
    proj_high_inc: float = 0.1       # occupancy slice width (BTC.cpp:15)
    summary_min: float = 10.0        # block-max gate (summary_min_thre)
    line_filter: bool = False        # see the JAX package's note
    touch_filter: bool = False       # first-4-slices gate (BTC.cpp:20)
    grid_cells: int = 120            # static raster extent (cells/axis)
    refine_iters: int = 2            # sub-cell two-line refinement rounds
    refine_min_column: int = 0

    @property
    def code_bits(self) -> int:
        """Per-corner occupancy-code length: the height slices of the
        projection image (reference cut_num, BTC.cpp:770), or the 3x
        radial-shell bands of the structural extractor."""
        if self.extractor == "projection":
            return int(round((self.proj_dis_max - self.proj_dis_min)
                             / self.proj_high_inc))
        return 3 * self.height_slices

    @classmethod
    def profile(cls, is_high_fly: bool = False,
                extractor: str = "projection") -> "BtcConfig":
        """Ground vs aerial parameter profiles (reference read_parameters,
        BTC.cpp:3-68), the JAX package's values; `extractor="structural"`
        gives the structural extractor's two profiles."""
        if extractor == "structural":
            return cls._structural_profile(is_high_fly)
        if not is_high_fly:
            return cls()
        return cls(
            is_high_fly=True, extractor="projection", voxel_size=4.0,
            plane_eig_thr=0.05, merge_normal_dot=0.7, merge_dist=0.8,
            max_corners=200, nms_radius=3.0, min_side=3.0, binary_thr=0.5,
            proj_plane_num=1, proj_dis_max=10.0, proj_high_inc=0.2,
            summary_min=6.0, line_filter=False, proj_resolution=1.0,
            grid_cells=120, side_quant=0.5, vertex_tol=2.0,
            plane_dist_tol=1.0)

    @classmethod
    def _structural_profile(cls, is_high_fly: bool = False) -> "BtcConfig":
        """The structural extractor's profiles (the JAX package's values;
        the aerial one widens the junction and support balls and the side
        quantization for sparse high-altitude clouds)."""
        if not is_high_fly:
            return cls(extractor="structural", max_corners=64,
                       knn_triangles=10, nms_radius=1.5, binary_thr=0.6)
        return cls(
            is_high_fly=True, extractor="structural", voxel_size=4.0,
            plane_eig_thr=0.05, merge_normal_dot=0.7, merge_dist=0.8,
            max_corners=64, knn_triangles=10, nms_radius=3.0, min_side=3.0,
            binary_thr=0.5, junction_radius=3.5, junction_plane_tol=0.6,
            support_radius=2.5, slice_height=1.0, side_quant=0.6,
            vertex_tol=2.0, plane_dist_tol=1.0)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum x^2) over the last axis, as `jnp.linalg.norm` computes it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _top_idx(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of `jax.lax.top_k(score, k)`: descending, ties to the
    lower index."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _extract_planes(cloud, mask, cfg: BtcConfig):
    """Voxel plane detection at voxel_size and voxel_size/2 + coplanar
    merging by a quantized (normal, offset) key, then 3 EM rounds.
    Returns (centers, normals, valid, count, radius) padded to
    cfg.max_planes, biggest first."""
    f32 = cloud.dtype

    def voxel_planes(size, U):
        keys = vh.voxel_key(cloud, size)
        _, uvalid, inv = vh.dedup_keys(keys, mask > 0, U)
        inv = inv.long()
        seg = torch.where(inv >= 0, inv, U)
        w = ((mask > 0) & (inv >= 0)).to(f32)
        n = drop_add(cloud.new_zeros((U,)), seg, w)
        s = drop_add(cloud.new_zeros((U, 3)), seg, cloud * w[:, None])
        mu = s / torch.clamp(n, min=1.0)[:, None]
        d = (cloud - mu[torch.clamp(inv, min=0)]) * w[:, None]
        S = drop_add(cloud.new_zeros((U, 3, 3)), seg,
                     d[:, :, None] * d[:, None, :])
        lam, V = eigh3_forward(S / torch.clamp(n, min=1.0)[:, None, None])
        is_plane = (uvalid & (n >= cfg.plane_min_points)
                    & (lam[:, 0] < cfg.plane_eig_thr))
        return n, mu, V[:, :, 0], is_plane

    n1, mu1, nrm1, ip1 = voxel_planes(cfg.voxel_size, 4096)
    n2, mu2, nrm2, ip2 = voxel_planes(cfg.voxel_size / 2.0, 8192)
    n = torch.cat([n1, 0.5 * n2])
    mu = torch.cat([mu1, mu2])
    nrm = torch.cat([nrm1, nrm2])
    is_plane = torch.cat([ip1, ip2])

    flip = (nrm[:, 0] + 0.1 * nrm[:, 1] + 0.01 * nrm[:, 2]) < 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    off = torch.sum(nrm * mu, dim=-1)
    qn = torch.round(nrm / 0.25).to(torch.int32)
    qd = torch.round(off / 0.5).to(torch.int32)
    mkeys = torch.stack([qn[:, 0] * 9 + qn[:, 1], qn[:, 2], qd], dim=-1)
    M = cfg.max_planes * 8
    _, muvalid, minv = vh.dedup_keys(mkeys, is_plane, M)
    minv = minv.long()
    mseg = torch.where(minv >= 0, minv, M)
    mw = (is_plane & (minv >= 0)).to(f32) * n

    def clusters(seg, wts):
        mn = drop_add(cloud.new_zeros((M,)), seg, wts)
        mc = drop_add(cloud.new_zeros((M, 3)), seg, mu * wts[:, None])
        mnv = drop_add(cloud.new_zeros((M, 3)), seg, nrm * wts[:, None])
        centers = mc / torch.clamp(mn, min=1.0)[:, None]
        normals = mnv / torch.clamp(torch.sqrt(torch.sum(mnv * mnv, -1,
                                                         keepdim=True)),
                                    min=1e-9)
        return mn, centers, normals

    mn, centers, normals = clusters(mseg, mw)
    valid = muvalid & (mn > 0)

    # EM sharpening: assign each voxel plane to the biggest eligible
    # cluster (aligned normal, centroid on the plane), re-fit
    wvox = is_plane.to(f32) * n
    for _ in range(3):
        ndot = nrm @ normals.T                                 # (U, M)
        pdist = torch.abs(torch.sum((mu[:, None, :] - centers[None])
                                    * normals[None], dim=-1))
        elig = ((ndot > cfg.merge_normal_dot) & (pdist < cfg.merge_dist)
                & valid[None, :])
        gain = torch.where(elig, mn[None, :], -1.0)
        assign = torch.argmax(gain, dim=-1)
        has = (torch.amax(gain, dim=-1) > 0) & is_plane
        aseg = torch.where(has, assign, M)
        mn, centers, normals = clusters(aseg, wvox)
        valid = valid & (mn > 0)

    # observed patch radius per cluster (RMS spread of member centroids)
    spread = torch.sum((mu - centers[torch.clamp(assign, 0, M - 1)]) ** 2,
                       dim=-1)
    mext = drop_add(cloud.new_zeros((M,)), aseg, wvox * spread)
    radius = torch.sqrt(mext / torch.clamp(mn, min=1.0))

    top = _top_idx(torch.where(valid, mn, -1.0), cfg.max_planes)
    return centers[top], normals[top], valid[top], mn[top], radius[top]


def _greedy_nms(pos, score, radius, n_out):
    """n_out rounds of: take the best score, suppress everything within
    `radius` of it (itself included). Returns (picks clamped >= 0,
    picked) like the JAX package's scan."""
    picks = []
    sc = score
    for _ in range(n_out):
        i = torch.argmax(sc, dim=0, keepdim=True)       # (1,): no host sync
        ok = sc[i] > 0
        sc = torch.where(_norm(pos - pos[i]) < radius, -1.0, sc)
        picks.append(torch.where(ok, i, -1))
    picks = torch.cat(picks)
    return torch.clamp(picks, min=0), picks >= 0


def _solve3(A, b):
    """x with A x = b for (T, 3, 3), (T, 3); the rows of a singular A come
    out non-finite instead of raising, as `jnp.linalg.solve` gives them."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _structural_corners(cloud, mask, centers, normals, pvalid,
                        cfg: BtcConfig):
    """Corners = well-conditioned intersections of plane triples where
    every member plane has observed points at the junction; see the JAX
    package's `_structural_corners` for each step's reason. Returns
    (corners (C, 3), support (C,), binary (C, 3S), valid (C,))."""
    M = centers.shape[0]
    C = cfg.max_corners
    S = cfg.height_slices
    f32 = cloud.dtype
    dev = cloud.device
    eye = torch.eye(3, dtype=f32, device=dev)
    inside = mask > 0

    ii, jj, kk = np.meshgrid(np.arange(M), np.arange(M), np.arange(M),
                             indexing="ij")
    keep = (ii < jj) & (jj < kk)
    tri = [torch.as_tensor(a[keep], device=dev) for a in (ii, jj, kk)]
    nrm3 = torch.stack([normals[x] for x in tri], dim=1)          # (T,3,3)
    off3 = torch.stack([torch.sum(normals[x] * centers[x], dim=-1)
                        for x in tri], dim=1)                     # (T, 3)
    ok_cond = torch.abs(torch.linalg.det(nrm3)) > 0.2
    x = _solve3(nrm3 + (~ok_cond)[:, None, None] * eye, off3)
    ok = (ok_cond & pvalid[tri[0]] & pvalid[tri[1]] & pvalid[tri[2]]
          & torch.all(torch.isfinite(x), dim=-1) & (_norm(x) < 100.0))

    # a physical junction: each plane has points within junction_radius
    # of x and junction_plane_tol of its surface (256 triples at a time)
    mins, supp = [], []
    for c0 in range(0, x.shape[0], 256):
        xc, n3, o3 = x[c0:c0 + 256], nrm3[c0:c0 + 256], off3[c0:c0 + 256]
        d2 = torch.sum((cloud[None] - xc[:, None]) ** 2, dim=-1)
        near = (d2 < cfg.junction_radius ** 2) & inside[None]
        pn = torch.einsum("ni,cli->cln", cloud, n3)
        on = torch.abs(pn - o3[:, :, None]) < cfg.junction_plane_tol
        mins.append(torch.amin(torch.sum(near[:, None] & on, dim=-1), dim=-1))
        supp.append(torch.sum((d2 < cfg.support_radius ** 2) & inside[None],
                              dim=-1).to(f32))
    mins, supp = torch.cat(mins), torch.cat(supp)
    ok = ok & (mins >= 3) & (supp >= 5)

    # greedy NMS over the best-supported candidates
    score0 = torch.where(ok, supp, -1.0)
    cidx = _top_idx(score0, min(256, x.shape[0]))
    picks, cvalid = _greedy_nms(x[cidx], score0[cidx], cfg.nms_radius, C)
    sel = cidx[picks]
    corners = x[sel]
    support = supp[sel]
    tri_n = torch.stack([normals[t[sel]] for t in tri], dim=1)    # (C,3,3)

    def refine(corners, tri_n):
        """Re-fit each corner's three faces from its local points (each
        point to its closest face) and intersect the re-fit planes."""
        rel = cloud[None] - corners[:, None]                      # (C,N,3)
        near = (torch.sum(rel * rel, dim=-1) < cfg.junction_radius ** 2) \
            & inside[None]
        pd = torch.abs(torch.einsum("cni,cli->cln", rel, tri_n))  # (C,3,N)
        closest = torch.argmin(pd, dim=1)
        new_n, offs = [], []
        for l in range(3):
            w = (near & (closest == l)
                 & (pd[:, l] < cfg.junction_plane_tol + 0.05)).to(f32)
            cnt = torch.sum(w, dim=-1)
            nl = torch.clamp(cnt, min=1.0)
            cen = (w @ cloud) / nl[:, None]
            d = (cloud[None] - cen[:, None]) * w[..., None]
            _, V = eigh3_forward(torch.einsum("cni,cnj->cij", d, d)
                         / nl[:, None, None])
            nf = V[:, :, 0]
            flip = torch.sum(nf * tri_n[:, l], dim=-1) < 0
            nf = torch.where(flip[:, None], -nf, nf)
            good = (cnt >= 5)[:, None]
            nf = torch.where(good, nf, tri_n[:, l])
            new_n.append(nf)
            offs.append(torch.sum(nf * torch.where(good, cen, corners),
                                  dim=-1))
        A = torch.stack(new_n, dim=1)
        solvable = torch.abs(torch.linalg.det(A)) > 0.1
        xr = _solve3(A + (~solvable)[:, None, None] * eye,
                     torch.stack(offs, dim=1))
        # one gate for the whole set, as the JAX package computes it:
        # `jnp.linalg.norm(xr - corners, -1)` there is the order -1 matrix
        # norm (the smallest column sum of |xr - corners| over all corners),
        # not a norm per corner
        moved = solvable & (torch.linalg.matrix_norm(xr - corners, ord=-1)
                            < cfg.junction_radius)
        return torch.where(moved[:, None], xr, corners), A

    for _ in range(2):
        corners, tri_n = refine(corners, tri_n)

    # yaw-invariant code: radial shells of slice_height x 3 height bands
    d2c = torch.sum((cloud[None] - corners[:, None]) ** 2, dim=-1)
    shell = torch.sqrt(torch.where(inside[None], d2c, float("inf"))) \
        / cfg.slice_height
    zrel = cloud[None, :, 2] - corners[:, 2:3]
    zb = torch.clamp(torch.floor(zrel / (2.0 * cfg.slice_height)) + 1.0,
                     0.0, 2.0).to(torch.int64)
    sid = zb * S + torch.clamp(torch.where(shell < S, shell, 0.0).to(
        torch.int64), 0, S - 1)
    flat = (torch.arange(C, device=dev)[:, None] * (3 * S) + sid).reshape(-1)
    cnt = drop_add(cloud.new_zeros((C * 3 * S,)), flat,
                   (shell < S).to(f32).reshape(-1)).reshape(C, 3 * S)
    return corners, support, (cnt >= 3.0).to(f32), cvalid


def _projection_corners(cloud, mask, centers, normals, pvalid,
                        cfg: BtcConfig):
    """The reference's projection-image binary descriptor as dense 2D
    raster work (extract_binary + non_maxi_suppression, BTC.cpp:613-977);
    see the JAX package's `_projection_corners` for each step's reason.
    Returns (corners (C, 3), summary (C,), binary (C, S), valid (C,))."""
    C = cfg.max_corners
    G = cfg.grid_cells
    S = cfg.code_bits
    B = G // 5
    res = cfg.proj_resolution
    f32 = cloud.dtype
    dev = cloud.device

    # fallback plane: horizontal through the cloud centroid
    msum = torch.clamp(torch.sum(mask), min=1.0)
    c_fall = torch.sum(cloud * mask[:, None], dim=0) / msum
    n_fall = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    pc_list, ps_list, pb_list, pv_list, frames = [], [], [], [], []
    ar = torch.arange(B, device=dev)
    for p in range(cfg.proj_plane_num):
        use_fall = ~pvalid[p] if p == 0 else torch.zeros(
            (), dtype=torch.bool, device=dev)
        n = torch.where(use_fall, n_fall, normals[p])
        c = torch.where(use_fall, c_fall, centers[p])
        plane_on = pvalid[p] | use_fall

        # in-plane axes from the reference's (1,1,0) seed (BTC.cpp:632-644)
        nx, ny, nz = n[0], n[1], n[2]
        bz = torch.abs(nz) > 1e-6
        by = torch.abs(ny) > 1e-6
        e1 = torch.where(
            bz, torch.stack([one, one, -(nx + ny) / torch.where(bz, nz, 1.0)]),
            torch.where(by, torch.stack([one, -nx / torch.where(by, ny, 1.0),
                                         zero]),
                        torch.stack([zero, one, zero])))
        e1 = e1 / torch.clamp(_norm(e1), min=1e-9)
        e2 = torch.linalg.cross(n, e1, dim=-1)
        e2 = e2 / torch.clamp(_norm(e2), min=1e-9)

        rel = cloud - c[None]
        dis = torch.abs(rel @ n)
        band = ((dis > cfg.proj_dis_min) & (dis <= cfg.proj_dis_max)
                & (mask > 0) & plane_on)
        u = rel @ e1
        v = rel @ e2
        bw = band.to(f32)
        bn = torch.clamp(torch.sum(bw), min=1.0)
        uc = torch.sum(u * bw) / bn
        vc = torch.sum(v * bw) / bn
        iu = torch.floor((u - uc) / res).to(torch.int32) + G // 2
        iv = torch.floor((v - vc) / res).to(torch.int32) + G // 2
        inb = band & (iu >= 0) & (iu < G) & (iv >= 0) & (iv < G)
        sl = torch.clamp(((dis - cfg.proj_dis_min)
                          / cfg.proj_high_inc).to(torch.int32), 0, S - 1)

        cell = (iu * G + iv).long()
        w = inb.to(f32)
        occ_idx = torch.where(inb, cell * S + sl, G * G * S)
        cell_idx = torch.where(inb, cell, G * G)
        occ = drop_add(cloud.new_zeros((G * G * S,)), occ_idx, w)
        occ = occ.reshape(G, G, S) >= 1.0
        colh_g = torch.sum(occ, dim=-1).to(f32)                 # (G, G)
        summary = colh_g
        # stored codes are 1-slice dilated (sampling gaps of downsampled
        # clouds); the summary ranks on the raw occupancy
        occd = occ.clone()
        occd[:, :, 1:] |= occ[:, :, :-1]
        occd[:, :, :-1] |= occ[:, :, 1:]
        cnt = drop_add(cloud.new_zeros((G * G,)), cell_idx, w)
        usum = drop_add(cloud.new_zeros((G * G,)), cell_idx, u * w)
        vsum = drop_add(cloud.new_zeros((G * G,)), cell_idx, v * w)

        # 5x5-block max of summary (reference :803-841)
        blk = (summary[:B * 5, :B * 5].reshape(B, 5, B, 5)
               .permute(0, 2, 1, 3).reshape(B, B, 25))
        am = torch.argmax(blk, dim=-1)
        mx = torch.amax(blk, dim=-1)
        bi = ar[:, None] * 5 + am // 5
        bj = ar[None, :] * 5 + am % 5
        keep = mx >= cfg.summary_min
        if cfg.touch_filter:
            keep = keep & torch.any(occ[bi, bj, :4], dim=-1)
        keep = keep & (bi > 0) & (bi < G - 1) & (bj > 0) & (bj < G - 1)
        if cfg.line_filter:
            for di, dj in ((0, 1), (1, 0), (1, 1), (1, -1)):
                s1 = summary[torch.clamp(bi + di, 0, G - 1),
                             torch.clamp(bj + dj, 0, G - 1)]
                s2 = summary[torch.clamp(bi - di, 0, G - 1),
                             torch.clamp(bj - dj, 0, G - 1)]
                thr = mx - 3.0
                bad = (((s1 >= thr) & (s2 >= 0.5 * mx))
                       | ((s2 >= thr) & (s1 >= 0.5 * mx))
                       | ((s1 >= thr) & (s2 >= thr)))
                keep = keep & ~bad

        sel = (bi * G + bj).reshape(-1)
        ccnt = torch.clamp(cnt[sel], min=1.0)
        cu = usum[sel] / ccnt
        cv = vsum[sel] / ccnt
        pc_list.append(c[None] + cu[:, None] * e1[None] + cv[:, None] * e2[None])
        ps_list.append(mx.reshape(-1))
        pb_list.append(occd[bi.reshape(-1), bj.reshape(-1)].to(f32))
        pv_list.append(keep.reshape(-1))
        colh = torch.where(inb, colh_g.reshape(-1)[torch.clamp(
            cell, 0, G * G - 1)], 0.0)
        frames.append((n, c, e1, e2, colh))

    cand = torch.cat(pc_list)
    summ = torch.cat(ps_list)
    code = torch.cat(pb_list)
    cval = torch.cat(pv_list)

    # stage 1: tight-radius NMS before refinement
    score0 = torch.where(cval, summ, -1.0)
    cidx = _top_idx(score0, min(512, cand.shape[0]))
    pre_r = min(cfg.nms_radius, 2.0 * res)
    picks, cvalid = _greedy_nms(cand[cidx], score0[cidx], pre_r, C)
    sel = cidx[picks]
    corners = cand[sel]

    # sub-cell refinement: intersect two local line clusters in the plane
    pid = sel // (B * B)
    nc = torch.stack([f[0] for f in frames])[pid]
    cc = torch.stack([f[1] for f in frames])[pid]
    e1c = torch.stack([f[2] for f in frames])[pid]
    e2c = torch.stack([f[3] for f in frames])[pid]
    dband = torch.abs(nc @ cloud.T - torch.sum(nc * cc, dim=-1)[:, None])
    band_c = ((dband > cfg.proj_dis_min) & (dband <= cfg.proj_dis_max)
              & (mask[None] > 0))
    if cfg.refine_min_column > 0:
        colP = torch.stack([f[4] for f in frames])
        band_c = band_c & (colP[pid] >= cfg.refine_min_column)
    r_ref = 3.0 * res

    def refine_once(corners):
        rel = cloud[None] - corners[:, None]                   # (C, N, 3)
        u = torch.sum(rel * e1c[:, None], dim=-1)
        v = torch.sum(rel * e2c[:, None], dim=-1)
        w = (band_c & (u * u + v * v < r_ref * r_ref)).to(f32)
        nw = torch.clamp(torch.sum(w, -1), min=1.0)
        mu_u = torch.sum(u * w, -1) / nw
        mu_v = torch.sum(v * w, -1) / nw
        du, dv = u - mu_u[:, None], v - mu_v[:, None]
        sxx = torch.sum(du * du * w, -1)
        sxy = torch.sum(du * dv * w, -1)
        syy = torch.sum(dv * dv * w, -1)
        th = 0.5 * torch.atan2(2 * sxy, sxx - syy)
        t1 = torch.stack([torch.cos(th), torch.sin(th)], -1)
        res1 = torch.abs(-du * t1[:, 1:2] + dv * t1[:, 0:1])
        w2 = w * (res1 > 0.2)
        n2 = torch.clamp(torch.sum(w2, -1), min=1.0)
        mu2u = torch.sum(u * w2, -1) / n2
        mu2v = torch.sum(v * w2, -1) / n2
        d2u, d2v = u - mu2u[:, None], v - mu2v[:, None]
        s2xx = torch.sum(d2u * d2u * w2, -1)
        s2xy = torch.sum(d2u * d2v * w2, -1)
        s2yy = torch.sum(d2v * d2v * w2, -1)
        th2 = 0.5 * torch.atan2(2 * s2xy, s2xx - s2yy)
        t2 = torch.stack([torch.cos(th2), torch.sin(th2)], -1)
        det = t1[:, 0] * (-t2[:, 1]) - t1[:, 1] * (-t2[:, 0])
        rhs_u = mu2u - mu_u
        rhs_v = mu2v - mu_v
        a = ((rhs_u * (-t2[:, 1]) - rhs_v * (-t2[:, 0]))
             / torch.where(torch.abs(det) > 1e-6, det, 1.0))
        iu = mu_u + a * t1[:, 0]
        iv = mu_v + a * t1[:, 1]
        okr = ((torch.sum(w2, -1) >= 6) & (torch.abs(det) > 0.3)
               & (iu * iu + iv * iv < r_ref * r_ref))
        moved = corners + iu[:, None] * e1c + iv[:, None] * e2c
        return torch.where(okr[:, None], moved, corners)

    for _ in range(cfg.refine_iters):
        corners = refine_once(corners)

    # stage 2: NMS at the reference radius on the refined positions
    score1 = torch.where(cvalid, summ[sel], -1.0)
    picks2, cvalid2 = _greedy_nms(corners, score1,
                                  min(cfg.nms_radius, 2.0 * res), C)
    return corners[picks2], summ[sel][picks2], code[sel][picks2], cvalid2


def _triangles(corners, summary, binary, cvalid, cfg: BtcConfig):
    """Triangles among each corner's knn_triangles nearest corners
    (generate_std, BTC.cpp:979-1126): sides sorted ascending, vertices
    (and their codes) reordered to stand opposite the sorted sides."""
    C = cfg.max_corners
    K = min(cfg.knn_triangles, C - 1)
    dev = corners.device
    top = _top_idx(torch.where(cvalid, summary, -1.0), C)
    pts = corners[top]
    bins = binary[top]
    val = cvalid[top]

    d = _norm(pts[:, None] - pts[None, :])
    d = torch.where(val[None] & val[:, None], d, float("inf"))
    d = d.clone()
    d.fill_diagonal_(float("inf"))
    nn = torch.sort(d, dim=-1, stable=True).indices[:, :K]

    a_, b_ = np.triu_indices(K, 1)
    a_ = torch.as_tensor(a_, device=dev)
    b_ = torch.as_tensor(b_, device=dev)
    ii = torch.repeat_interleave(torch.arange(C, device=dev), len(a_))
    jj = nn[:, a_].reshape(-1)
    kk = nn[:, b_].reshape(-1)
    nn_ok = (torch.isfinite(d[ii, jj]) & torch.isfinite(d[ii, kk])
             & (jj != kk) & (ii != jj) & (ii != kk))

    sides = torch.stack([d[ii, jj], d[ii, kk], d[jj, kk]], dim=-1)
    sides = torch.where(torch.isfinite(sides), sides, 1e6)
    order = torch.sort(sides, dim=-1, stable=True).indices
    sides = torch.gather(sides, -1, order)
    ok = (nn_ok & val[ii] & val[jj] & val[kk]
          & (sides[:, 0] >= cfg.min_side) & (sides[:, 2] <= cfg.max_side)
          & (torch.abs(sides[:, 2] - (sides[:, 0] + sides[:, 1])) > 0.2))
    opp = torch.stack([pts[kk], pts[jj], pts[ii]], dim=1)
    obin = torch.stack([bins[kk], bins[jj], bins[ii]], dim=1)
    verts = torch.gather(opp, 1, order[:, :, None].expand(opp.shape))
    vbins = torch.gather(obin, 1, order[:, :, None].expand(obin.shape))
    return sides, verts, vbins, ok


def extract(cloud: torch.Tensor, mask: torch.Tensor, cfg: BtcConfig):
    """Full descriptor extraction for one keyframe cloud (N, 3), mask (N,),
    on the cloud's device."""
    centers, normals, pvalid, _, _ = _extract_planes(cloud, mask, cfg)
    corners_of = (_projection_corners if cfg.extractor == "projection"
                  else _structural_corners)
    corners, summary, binary, cvalid = corners_of(cloud, mask, centers,
                                                  normals, pvalid, cfg)
    sides, verts, vbins, tvalid = _triangles(corners, summary, binary,
                                             cvalid, cfg)
    return dict(sides=sides, verts=verts, binary=vbins, tri_valid=tvalid,
                plane_centers=centers, plane_normals=normals,
                plane_valid=pvalid)


def triangle_svd(src_verts: np.ndarray, dst_verts: np.ndarray):
    """Rigid transform aligning (M, 3, 3) source triangle vertices to the
    matched target vertices (reference triangle_solver, BTC.cpp:1398)."""
    src = src_verts.reshape(-1, 3)
    dst = dst_verts.reshape(-1, 3)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


class DescriptorDB:
    """Host-side hash of triangle descriptors (reference data_base_,
    BTC.h:244). `use_native=True` stores and searches in the native
    store (`native.BtcDb`, built with g++ at first use; a failed build
    raises); `use_native=False` is the dict implementation, the plain
    version the native store is tested against."""

    def __init__(self, cfg: BtcConfig, use_native: bool = True):
        self.cfg = cfg
        self.db = defaultdict(list)  # (qa, qb, qc) -> [(frame, tri idx)]
        self.frames = {}             # frame id -> extraction dict (numpy)
        self._nat = None
        if use_native:
            from .. import native
            self._nat = native.BtcDb(cfg.side_quant, 3 * cfg.code_bits)

    # -- pickling (checkpoints): the native store is a ctypes handle; it is
    # rebuilt from the stored frames on restore (a failed build raises) --
    def __getstate__(self):
        d = dict(self.__dict__)
        d["_nat"] = self._nat is not None
        return d

    def __setstate__(self, d):
        had_native = d.pop("_nat")
        self.__dict__.update(d)
        self._nat = None
        if had_native:
            from .. import native
            self._nat = native.BtcDb(self.cfg.side_quant,
                                     3 * self.cfg.code_bits)
            for fid, fr in self.frames.items():
                self._nat.add(fid, fr["sides"], fr["binary"],
                              fr["tri_valid"])

    def _qkey(self, sides):
        return np.round(sides / self.cfg.side_quant).astype(np.int64)

    def add(self, frame_id: int, desc):
        d = {k: np.asarray(v) for k, v in desc.items()}
        self.frames[frame_id] = d
        if self._nat is not None:
            self._nat.add(frame_id, d["sides"], d["binary"], d["tri_valid"])
            return
        ok = d["tri_valid"]
        qs = self._qkey(d["sides"][ok])
        for t_local, q in zip(np.where(ok)[0], qs):
            self.db[tuple(q)].append((frame_id, int(t_local)))

    @staticmethod
    def _binary_sim(b1: np.ndarray, b2: np.ndarray) -> float:
        """Occupancy-code similarity 2|b1&b2|/(|b1|+|b2|) over the 3
        vertices (reference binary_similarity, BTC.cpp:1345-1360)."""
        inter = np.minimum(b1, b2).sum()
        tot = b1.sum() + b2.sum()
        return 2.0 * inter / max(tot, 1e-6)

    def search(self, desc, skip_near: int = 10, current_frame: int = 1 << 30,
               binary_thr: float | None = None):
        """Vote candidate frames for a query keyframe; a side-hash hit only
        votes when the vertex codes agree (similarity >= binary_thr).
        Returns [(frame, votes, matches)] sorted by votes; matches are
        (query tri idx, target tri idx) pairs."""
        if binary_thr is None:
            binary_thr = self.cfg.binary_thr
        d = {k: np.asarray(v) for k, v in desc.items()}
        if self._nat is not None:
            return self._nat.search(
                d["sides"], d["binary"], d["tri_valid"],
                skip_near=skip_near, current_frame=current_frame,
                binary_thr=binary_thr, min_votes=self.cfg.min_votes,
                max_matches=self.cfg.max_matches)
        ok = np.where(d["tri_valid"])[0]
        votes = defaultdict(list)
        qs = self._qkey(d["sides"][ok])
        for t_local, q in zip(ok, qs):
            qb = d["binary"][t_local]
            for da in (-1, 0, 1):
                for db_ in (-1, 0, 1):
                    for dc in (-1, 0, 1):
                        key = (q[0] + da, q[1] + db_, q[2] + dc)
                        for (f, tt) in self.db.get(key, ()):
                            if current_frame - f <= skip_near and \
                                    f <= current_frame:
                                continue
                            tb = self.frames[f]["binary"][tt]
                            if self._binary_sim(qb, tb) < binary_thr:
                                continue
                            votes[f].append((int(t_local), tt))
        cand = sorted(votes.items(), key=lambda kv: -len(kv[1]))
        out = []
        for f, m in cand:
            if len(m) < self.cfg.min_votes:
                continue
            n_votes = len(m)
            # every pair up to max_matches; over the cap keep the pairs of
            # highest code similarity, in insertion order
            if len(m) > self.cfg.max_matches:
                fr = self.frames[f]
                sims = [self._binary_sim(d["binary"][q_t], fr["binary"][t_t])
                        for q_t, t_t in m]
                keep = np.argsort(-np.asarray(sims),
                                  kind="stable")[:self.cfg.max_matches]
                m = [m[k] for k in sorted(keep)]
            out.append((f, n_votes, m))
        return out

    def verify(self, desc, cand_frame: int, matches):
        """Geometric verification: RANSAC over the collision set (each
        matched triangle pair is a rigid-transform hypothesis, the
        `ransac_hyps` most code-similar ones are tried, agreement counts
        distinct query triangles within vertex_tol), then the plane-overlap
        score of the best consensus hypotheses (BTC.cpp:1281-1479)."""
        cfg = self.cfg
        q = {k: np.asarray(v) for k, v in desc.items()}
        t_ = self.frames[cand_frame]
        qi = np.array([m[0] for m in matches])
        ti = np.array([m[1] for m in matches])
        if len(qi) == 0:
            return None
        sv = q["verts"][qi]      # (M, 3, 3)
        dv = t_["verts"][ti]
        M = len(qi)

        qb = q["binary"][qi].reshape(M, -1)
        tb = t_["binary"][ti].reshape(M, -1)
        inter = np.minimum(qb, tb).sum(-1)
        sims = 2.0 * inter / np.maximum(qb.sum(-1) + tb.sum(-1), 1e-6)
        H = min(cfg.ransac_hyps, M)
        hyp = np.argsort(-sims)[:H]

        # batched Kabsch over hypothesis pairs
        src = sv[hyp]
        dst = dv[hyp]
        mu_s = src.mean(1, keepdims=True)
        mu_d = dst.mean(1, keepdims=True)
        Hm = np.einsum("hvi,hvj->hij", src - mu_s, dst - mu_d)
        U, _, Vt = np.linalg.svd(Hm)
        det = np.sign(np.linalg.det(np.einsum("hji,hkj->hik", Vt, U)))
        D = np.tile(np.eye(3), (H, 1, 1))
        D[:, 2, 2] = det
        Rh = np.einsum("hji,hjk,hlk->hil", Vt, D, U)   # V D U^T
        th = mu_d[:, 0] - np.einsum("hij,hj->hi", Rh, mu_s[:, 0])

        scores = np.zeros(H, np.int32)
        masks = np.zeros((H, M), bool)
        for h0 in range(0, H, 64):
            Rc, tc = Rh[h0:h0 + 64], th[h0:h0 + 64]
            moved = np.einsum("hij,mvj->hmvi", Rc, sv) + tc[:, None, None]
            ok = (np.linalg.norm(moved - dv[None], axis=-1).max(-1)
                  < cfg.vertex_tol)
            masks[h0:h0 + ok.shape[0]] = ok
            for hh in range(ok.shape[0]):
                scores[h0 + hh] = len(np.unique(qi[ok[hh]]))
        if scores.max(initial=0) < 4:   # reference: >= 4 votes
            return None

        sc = q["plane_centers"][q["plane_valid"]]
        sn = q["plane_normals"][q["plane_valid"]]
        tcn = t_["plane_centers"][t_["plane_valid"]]
        tn = t_["plane_normals"][t_["plane_valid"]]
        if len(sc) == 0 or len(tcn) == 0:
            return None

        def overlap_of(R, t):
            sc2 = sc @ R.T + t
            sn2 = sn @ R.T
            nn = np.linalg.norm(sc2[:, None] - tcn[None], axis=-1).argmin(1)
            ndot = np.abs(np.einsum("ni,ni->n", sn2, tn[nn]))
            pd = np.abs(np.einsum("ni,ni->n", tn[nn], sc2 - tcn[nn]))
            return float(((ndot > cfg.plane_norm_tol)
                          & (pd < cfg.plane_dist_tol)).mean())

        top = np.argsort(-scores)[:8]
        best = None
        for hbest in top:
            if scores[hbest] < 4:
                break
            agree = masks[hbest]
            R, t = Rh[hbest], th[hbest]
            if agree.sum() >= 2:
                R, t = triangle_svd(sv[agree], dv[agree])
            ov = overlap_of(R, t)
            if best is None or ov > best["overlap"]:
                best = dict(R=R, t=t, votes=int(scores[hbest]), overlap=ov)
        return best
