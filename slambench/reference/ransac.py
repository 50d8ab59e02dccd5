"""Loop closure's geometric verification, recomputed: for a query
keyframe's triangle descriptors, a candidate's, and the matched pairs
(query triangle, candidate triangle) that the search handed over.

  1. Each pair's code similarity 2 |b_q & b_c| / (|b_q| + |b_c|) over the
     three vertices' occupancy codes; the `ransac_hyps` most similar pairs
     (NumPy's default argsort of the negated similarity breaks ties) are
     the hypotheses.
  2. A hypothesis is the rigid motion taking its query triangle onto its
     candidate triangle (Kabsch over the three vertices). Its votes are the
     distinct query triangles of all pairs whose three vertices land
     within `vertex_tol` of their partners.
  3. Under 4 votes at best, or with no valid planes on either side, the
     candidate fails (None).
  4. For the 8 best hypotheses (by votes, ties as in 1) with 4 votes or
     more: the motion refit over all vertices of the agreeing pairs when
     there are two or more, and its plane overlap: the share of the query's
     valid planes whose nearest candidate plane centre (after the motion)
     has normals agreeing past `plane_norm_tol` and lies within
     `plane_dist_tol` along the candidate's normal. The hypothesis of the
     largest overlap (the first, on a tie) is the answer: R, t, votes,
     overlap.

The program computes in float32, this in float64, so a test may go
either way where it lands within `EPS` of its threshold, or where a
hypothesis's motion is ill-conditioned (a thin triangle) and the same
test computed in float32 comes out otherwise. The reference reports a call
whose answer hangs on such a test (in the hypotheses that decide it) as
fragile; only the others are compared.
"""

from __future__ import annotations

import numpy as np

EPS = 2e-5          # metres (and cosines): float32 rounding of ~40 m



def kabsch(src: np.ndarray, dst: np.ndarray):
    """(R, t) taking (N, 3) src onto dst in least squares, in the inputs'
    precision."""
    ms, md = src.mean(0), dst.mean(0)
    C = (dst - md).T @ (src - ms)
    U, _, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    return R, md - R @ ms


def verify(q: dict, c: dict, matches, ransac_hyps: int, vertex_tol: float,
           plane_norm_tol: float, plane_dist_tol: float):
    """(answer, fragile): the answer is None or dict(R, t, votes,
    overlap)."""
    pairs = np.asarray(matches, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return None, False
    qv = np.asarray(q["verts"], np.float64)[pairs[:, 0]]     # (M, 3, 3)
    cv = np.asarray(c["verts"], np.float64)[pairs[:, 1]]
    qv32, cv32 = qv.astype(np.float32), cv.astype(np.float32)
    M = len(pairs)
    qb = np.asarray(q["binary"])[pairs[:, 0]].reshape(M, -1)
    cb = np.asarray(c["binary"])[pairs[:, 1]].reshape(M, -1)
    sims = 2.0 * np.minimum(qb, cb).sum(-1) / np.maximum(
        qb.sum(-1) + cb.sum(-1), 1e-6)
    hyp = np.argsort(-sims)[:min(ransac_hyps, M)]

    motions, votes, hi, agree, near = [], [], [], [], []
    for h in hyp:
        R, t = kabsch(qv[h], cv[h])
        moved = np.einsum("ij,mvj->mvi", R, qv) + t
        d = np.linalg.norm(moved - cv, axis=-1).max(-1)
        ok = d < vertex_tol
        # the same test in float32
        R32, t32 = kabsch(qv[h].astype(np.float32), cv[h].astype(np.float32))
        d32 = np.linalg.norm(np.einsum("ij,mvj->mvi", R32, qv32) + t32
                             - cv32, axis=-1).max(-1)
        nr = (np.abs(d - vertex_tol) < EPS) | ((d32 < vertex_tol) != ok)
        motions.append((R, t))
        agree.append(ok)
        near.append(nr.any())
        votes.append(len(set(pairs[ok, 0].tolist())))
        hi.append(len(set(pairs[ok | nr, 0].tolist())))
    votes = np.asarray(votes, np.int32)
    order = np.argsort(-votes)
    top = order[:8]
    # a hypothesis that could move into the eight, or whose votes could
    # change, makes the answer fragile
    floor = votes[top[-1]] if len(top) else 0
    fragile = any(near[h] and hi[h] >= floor for h in order)
    if votes.max(initial=0) < 4:
        return None, fragile

    qpv = np.asarray(q["plane_valid"], bool)
    cpv = np.asarray(c["plane_valid"], bool)
    qc = np.asarray(q["plane_centers"], np.float64)[qpv]
    qn = np.asarray(q["plane_normals"], np.float64)[qpv]
    cc = np.asarray(c["plane_centers"], np.float64)[cpv]
    cn = np.asarray(c["plane_normals"], np.float64)[cpv]
    if len(qc) == 0 or len(cc) == 0:
        return None, fragile

    best = None
    for h in top:
        if votes[h] < 4:
            break
        R, t = motions[h]
        if agree[h].sum() >= 2:
            R, t = kabsch(qv[agree[h]].reshape(-1, 3),
                          cv[agree[h]].reshape(-1, 3))
        hits = 0
        for i in range(len(qc)):
            ci = R @ qc[i] + t
            ni = R @ qn[i]
            dist = np.linalg.norm(cc - ci, axis=1)
            j = int(np.argmin(dist))
            nd = abs(ni @ cn[j])
            pd = abs(cn[j] @ (ci - cc[j]))
            two = np.partition(dist, 1)[:2] if len(dist) > 1 else dist
            if (abs(nd - plane_norm_tol) < EPS or abs(pd - plane_dist_tol)
                    < EPS or (len(two) > 1 and two[1] - two[0] < EPS)):
                fragile = True
            if nd > plane_norm_tol and pd < plane_dist_tol:
                hits += 1
        overlap = hits / len(qc)
        if best is None or overlap > best["overlap"]:
            best = dict(R=R, t=t, votes=int(votes[h]), overlap=overlap,
                        scale=float(np.linalg.norm(qv, axis=-1).max()))
    return best, fragile


def mismatch(prog, ref, tol: float = 1e-5) -> bool:
    """Whether the program's answer differs from the reference's: pass or
    fail, votes or overlap, or R or t by more than float32 rounding: `tol`
    of R's entries; of t, `tol` times the largest of 1 m, t's length and
    the query vertices' distance from their origin (t = mu_c - R mu_q
    carries R's rounding times that lever)."""
    if (prog is None) != (ref is None):
        return True
    if prog is None:
        return False
    return (int(prog["votes"]) != ref["votes"]
            or abs(float(prog["overlap"]) - ref["overlap"]) > 1e-12
            or float(np.abs(np.asarray(prog["R"]) - ref["R"]).max()) > tol
            or float(np.abs(np.asarray(prog["t"]) - ref["t"]).max())
            > tol * max(1.0, float(np.linalg.norm(ref["t"])),
                        ref.get("scale", 0.0)))
