"""The voxel map's per-voxel moments against a plain accumulation.

A step inserts each scan's downsampled body-frame points q (mask m) into
window slot s of every map level: the point goes to the voxel of its
world position w = R q + p (key floor(w / size)), and the slot's cluster
there gathers the count n, the mean mu and the scatter
S = sum (q - mu)(q - mu)^T of the points it got, in the body frame.

Two comparisons, each in float64:

  totals   over all voxels of the slot, n, sum n mu and
           sum (S + n mu mu^T) must equal the scan's own sum 1, sum q and
           sum q q^T, whatever voxel each point went to. The number is
           the worst relative gap (of n; of sum q over n times the RMS
           range; of the second moments over their norm).
  keys     each point's voxel follows from the pose the step used, which
           the program does not hand out; the frame's pose in the window
           after the step (its BA refinement) is within millimetres of
           it. A point farther than `margin` from every face of its
           voxel under that pose is in that voxel; one nearer may be in
           any voxel whose face it is near. So a voxel's count lies
           between its certain points and its certain plus possible
           ones. The number is how many voxels break that, or hold
           certain points the program does not have (exact: 0).
"""

from __future__ import annotations

import itertools

import numpy as np

_OFF = 1 << 20


def pack(keys: np.ndarray) -> np.ndarray:
    """(N, 3) integer voxel keys -> (N,) int64, one to one for keys in
    [-2^20, 2^20)."""
    k = np.asarray(keys, np.int64) + _OFF
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def scan_totals(q: np.ndarray, m: np.ndarray):
    """(n, sum q, sum q q^T) of the points with m > 0."""
    x = np.asarray(q, np.float64)[np.asarray(m) > 0]
    return float(len(x)), x.sum(0), x.T @ x


def cluster_totals(n, mu, S):
    """The same three sums from per-voxel clusters (n (C,), mu (C, 3),
    S (C, 3, 3))."""
    n = np.asarray(n, np.float64)
    mu = np.asarray(mu, np.float64)
    S = np.asarray(S, np.float64)
    s1 = (n[:, None] * mu).sum(0)
    s2 = S.sum(0) + np.einsum("c,ci,cj->ij", n, mu, mu)
    return float(n.sum()), s1, s2


def totals_gap(prog, ref) -> float:
    return float(max(totals_gaps(prog, ref)))


def totals_gaps(prog, ref) -> tuple:
    """The three relative gaps: of n, of sum q, of the second moments."""
    n_p, s1_p, s2_p = prog
    n_r, s1_r, s2_r = ref
    if n_r == 0:
        return (0.0 if n_p == 0 else 1.0, 0.0, 0.0)
    rms = np.sqrt(np.trace(s2_r) / n_r)
    g = (abs(n_p - n_r) / n_r,
         float(np.linalg.norm(s1_p - s1_r)) / (n_r * max(rms, 1e-9)),
         float(np.linalg.norm(s2_p - s2_r)) / max(
             float(np.linalg.norm(s2_r)), 1e-30))
    return g


def key_violations(q, m, R, p, size: float, margin, prog_keys, prog_n) -> int:
    """Voxels whose program count (prog_n at the packed prog_keys, the
    slot's nonzero voxels) falls outside [certain, certain + possible],
    plus voxels with certain points that the program lacks. `margin` is
    a scalar or one per point (metres)."""
    keep = np.asarray(m) > 0
    x = np.asarray(q, np.float64)[keep]
    w = x @ np.asarray(R, np.float64).T + np.asarray(p, np.float64)
    f = w / size
    k0 = np.floor(f)
    r = (f - k0) * size
    mg = (np.asarray(margin, np.float64)[keep][:, None] if np.ndim(margin)
          else float(margin))
    lo = r < mg
    hi = (size - r) < mg
    k0 = k0.astype(np.int64)
    sure = ~(lo | hi).any(1)
    ks, cs = np.unique(pack(k0[sure]), return_counts=True)
    amb = np.where(~sure)[0]
    may_k = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        o = np.asarray(off)
        ok = np.ones(len(amb), bool)
        for a in range(3):
            if o[a] == -1:
                ok &= lo[amb, a]
            elif o[a] == 1:
                ok &= hi[amb, a]
        if ok.any():
            may_k.append(pack(k0[amb[ok]] + o))
    may = np.concatenate(may_k) if may_k else np.zeros(0, np.int64)
    km, cm = np.unique(may, return_counts=True)

    pk = np.asarray(prog_keys, np.int64)
    pn = np.asarray(prog_n, np.float64)
    order = np.argsort(pk)
    pk, pn = pk[order], pn[order]

    def at(keys, vals, where):
        if len(keys) == 0:
            return np.zeros(len(where))
        i = np.clip(np.searchsorted(keys, where), 0, len(keys) - 1)
        return np.where(keys[i] == where, vals[i], 0)

    sure_at_p = at(ks, cs, pk)
    may_at_p = at(km, cm, pk)
    bad = int(((pn < sure_at_p) | (pn > sure_at_p + may_at_p)).sum())
    # certain points in a voxel the program left empty
    bad += int((at(pk, pn, ks) == 0).sum())
    return bad
