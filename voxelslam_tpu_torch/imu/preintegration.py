"""On-manifold IMU preintegration (port of
`voxelslam_tpu/imu/preintegration.py`; the reference IMU_PRE,
preintegration.hpp:11-331).

`integrate` builds one atomic Preint per sample (batched) and composes
them with `merge` through the same associative-scan recursion as the JAX
package; `integrate_sequential` is the sample-by-sample recursion it is
held to. The factor pieces (`residual`, `jacobian_closed`,
`evaluate_closed`, `cov_inv`, `chi2`) take Preints and NavStates with
any common leading batch dims — the JAX package's `vmap`s over window
pairs become that batch dim. `evaluate` is the autodiff oracle of
`evaluate_closed`: `torch.func.jacfwd` of the boxplus-perturbed residual.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import so3
from ..core.state import NavState, DIM
from ..core.tensors import associative_scan, mv, tmap

_FIELDS = ["R_delta", "p_delta", "v_delta", "R_bg", "p_bg", "p_ba", "v_bg",
           "v_ba", "dtime", "cov", "bg_lin", "ba_lin"]


@dataclasses.dataclass
class Preint:
    """Preintegrated IMU factor between two scans (batchable)."""
    R_delta: torch.Tensor   # (..., 3, 3)
    p_delta: torch.Tensor   # (..., 3)
    v_delta: torch.Tensor   # (..., 3)
    R_bg: torch.Tensor      # (..., 3, 3) dR/dbg
    p_bg: torch.Tensor      # (..., 3, 3)
    p_ba: torch.Tensor      # (..., 3, 3)
    v_bg: torch.Tensor      # (..., 3, 3)
    v_ba: torch.Tensor      # (..., 3, 3)
    dtime: torch.Tensor     # (...,)
    cov: torch.Tensor       # (..., 15, 15)
    bg_lin: torch.Tensor    # (..., 3) biases at linearization
    ba_lin: torch.Tensor    # (..., 3)

    def __getitem__(self, idx) -> "Preint":
        return tmap(lambda x: x[idx], self)

    @staticmethod
    def identity(bg=None, ba=None, dtype=torch.float32,
                 device=None) -> "Preint":
        kw = dict(dtype=dtype, device=device)
        z3 = torch.zeros((3,), **kw)
        z33 = torch.zeros((3, 3), **kw)
        return Preint(R_delta=torch.eye(3, **kw), p_delta=z3, v_delta=z3,
                      R_bg=z33, p_bg=z33, p_ba=z33, v_bg=z33, v_ba=z33,
                      dtime=torch.zeros((), **kw),
                      cov=torch.zeros((DIM, DIM), **kw),
                      bg_lin=z3 if bg is None else bg,
                      ba_lin=z3 if ba is None else ba)


def integrate_sequential(gyr, acc, dt, mask, bg, ba, noise_meas, noise_walk,
                         scale_gravity: float = 1.0) -> Preint:
    """Preintegrate N midpoint samples one after the other (IMU_PRE::add_imu,
    preintegration.hpp:75-135): the ground truth `integrate` is held to.
    gyr/acc (N, 3), dt (N,), mask (N,) (padding-safe)."""
    c = Preint.identity(bg, ba, dtype=gyr.dtype, device=gyr.device)
    I3 = torch.eye(3, dtype=gyr.dtype, device=gyr.device)
    m = mask.to(gyr.dtype)
    for g_i, a_i, dt_i, m_i in zip(gyr, acc, dt, m):
        w = (g_i - bg) * m_i
        a = (a_i * scale_gravity - ba) * m_i
        dt_i = dt_i * m_i
        R_inc = so3.exp(w * dt_i)
        R_jr = so3.jr(w * dt_i)
        R_dt = dt_i * c.R_delta
        R_dt2_2 = 0.5 * dt_i * dt_i * c.R_delta
        a_hat = so3.hat(a)

        # 9x9 error-state transition on (dR, dp, dv); additive bias walk
        A = torch.eye(9, dtype=gyr.dtype, device=gyr.device)
        A[0:3, 0:3] = R_inc.T
        A[3:6, 0:3] = -R_dt2_2 @ a_hat
        A[3:6, 6:9] = I3 * dt_i
        A[6:9, 0:3] = -R_dt @ a_hat
        B = gyr.new_zeros((9, 6))
        B[0:3, 0:3] = R_jr * dt_i
        B[3:6, 3:6] = R_dt2_2
        B[6:9, 3:6] = R_dt
        cov = c.cov.clone()
        cov[0:9, 0:9] = A @ c.cov[0:9, 0:9] @ A.T + B @ noise_meas @ B.T
        cov[9:15, 9:15] += noise_walk * dt_i

        c = Preint(
            R_delta=c.R_delta @ R_inc,
            p_delta=c.p_delta + c.v_delta * dt_i + R_dt2_2 @ a,
            v_delta=c.v_delta + R_dt @ a,
            R_bg=R_inc.T @ c.R_bg - R_jr * dt_i,
            p_bg=c.p_bg + c.v_bg * dt_i - R_dt2_2 @ a_hat @ c.R_bg,
            p_ba=c.p_ba + c.v_ba * dt_i - R_dt2_2,
            v_bg=c.v_bg - R_dt @ a_hat @ c.R_bg,
            v_ba=c.v_ba - R_dt,
            dtime=c.dtime + dt_i, cov=cov,
            bg_lin=c.bg_lin, ba_lin=c.ba_lin)
    return c


def _eye3(like: torch.Tensor, batch=()) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        tuple(batch) + (3, 3))


def _one_step(g, a, dt, m, bg, ba, noise_meas, noise_walk, scale_gravity):
    """Atomic single-interval Preints, batched over the leading dim N."""
    N = g.shape[0]
    w = (g - bg) * m[:, None]
    acc = (a * scale_gravity - ba) * m[:, None]
    dt = dt * m
    dt3 = dt[:, None, None]
    R_inc = so3.exp(w * dt[:, None])
    R_jr = so3.jr(w * dt[:, None])
    I = _eye3(g, (N,))
    R_dt = dt3 * I
    R_dt2_2 = 0.5 * dt3 * dt3 * I
    B = g.new_zeros((N, 9, 6))
    B[:, 0:3, 0:3] = R_jr * dt3
    B[:, 3:6, 3:6] = R_dt2_2
    B[:, 6:9, 3:6] = R_dt
    cov = g.new_zeros((N, DIM, DIM))
    cov[:, 0:9, 0:9] = B @ noise_meas @ B.transpose(-1, -2)
    cov[:, 9:15, 9:15] = noise_walk * dt3
    z33 = g.new_zeros((N, 3, 3))
    # one step from the identity Preint, whose bias Jacobians are zero:
    # R_bg = R_inc^T 0 - R_jr dt, p_bg = v_bg = 0
    return Preint(
        R_delta=R_inc, p_delta=mv(R_dt2_2, acc), v_delta=mv(R_dt, acc),
        R_bg=-R_jr * dt3, p_bg=z33, p_ba=-R_dt2_2, v_bg=z33, v_ba=-R_dt,
        dtime=dt, cov=cov,
        bg_lin=bg.expand(N, 3), ba_lin=ba.expand(N, 3))


def merge(a: Preint, b: Preint) -> Preint:
    """Compose consecutive preintegrations (IMU_PRE::merge,
    preintegration.hpp:305-329), batched over leading dims."""
    bt = b.dtime[..., None, None]
    p_bg = a.p_bg + a.v_bg * bt + a.R_delta @ (b.p_bg - so3.hat(b.p_delta) @ a.R_bg)
    p_ba = a.p_ba + a.v_ba * bt + a.R_delta @ b.p_ba
    v_bg = a.v_bg + a.R_delta @ (b.v_bg - so3.hat(b.v_delta) @ a.R_bg)
    v_ba = a.v_ba + a.R_delta @ b.v_ba
    R_bg = b.R_delta.transpose(-1, -2) @ a.R_bg + b.R_bg

    batch = a.cov.shape[:-2]
    eye = torch.eye(DIM, dtype=a.cov.dtype, device=a.cov.device)
    Ai = eye.expand(batch + (DIM, DIM)).clone()
    Ai[..., 0:3, 0:3] = b.R_delta.transpose(-1, -2)
    Ai[..., 3:6, 0:3] = -a.R_delta @ so3.hat(b.p_delta)
    Ai[..., 3:6, 6:9] = _eye3(a.cov, batch) * bt
    Ai[..., 6:9, 0:3] = -a.R_delta @ so3.hat(b.v_delta)
    Bi = eye.expand(batch + (DIM, DIM)).clone()
    Bi[..., 3:6, 3:6] = a.R_delta
    Bi[..., 6:9, 6:9] = a.R_delta
    cov = (Ai @ a.cov @ Ai.transpose(-1, -2)
           + Bi @ b.cov @ Bi.transpose(-1, -2))
    return Preint(
        R_delta=a.R_delta @ b.R_delta,
        p_delta=a.p_delta + a.v_delta * b.dtime[..., None]
        + mv(a.R_delta, b.p_delta),
        v_delta=a.v_delta + mv(a.R_delta, b.v_delta),
        R_bg=R_bg, p_bg=p_bg, p_ba=p_ba, v_bg=v_bg, v_ba=v_ba,
        dtime=a.dtime + b.dtime, cov=cov, bg_lin=a.bg_lin, ba_lin=a.ba_lin)


def _merge_tuples(a, b):
    out = merge(Preint(*a), Preint(*b))
    return tuple(getattr(out, f) for f in _FIELDS)


def integrate(gyr, acc, dt, mask, bg, ba, noise_meas, noise_walk,
              scale_gravity: float = 1.0) -> Preint:
    """Preintegrate N midpoint samples (IMU_PRE::add_imu,
    preintegration.hpp:75-135): atomic per-sample Preints composed with
    `merge` in log2(N) batched levels. gyr/acc (N, 3), dt (N,),
    mask (N,)."""
    atomic = _one_step(gyr, acc, dt, mask.to(gyr.dtype), bg, ba,
                       noise_meas, noise_walk, scale_gravity)
    pref = associative_scan(_merge_tuples,
                            tuple(getattr(atomic, f) for f in _FIELDS))
    return Preint(*[x[-1] for x in pref])


def residual(pre: Preint, st1: NavState, st2: NavState) -> torch.Tensor:
    """15-dim preintegration residual (give_evaluate,
    preintegration.hpp:137-162); bias re-parameterization from the
    states."""
    dbg = st1.bg - pre.bg_lin
    dba = st1.ba - pre.ba_lin
    R_corr = pre.R_delta @ so3.exp(mv(pre.R_bg, dbg))
    t_corr = pre.p_delta + mv(pre.p_bg, dbg) + mv(pre.p_ba, dba)
    v_corr = pre.v_delta + mv(pre.v_bg, dbg) + mv(pre.v_ba, dba)
    dtime = pre.dtime[..., None]
    R1T = st1.R.transpose(-1, -2)
    res_r = so3.log(R_corr.transpose(-1, -2) @ R1T @ st2.R)
    exp_v = mv(R1T, st2.v - st1.v - dtime * st1.g)
    exp_t = mv(R1T, st2.p - st1.p - st1.v * dtime
               - 0.5 * dtime * dtime * st1.g)
    return torch.cat([res_r, exp_t - t_corr, exp_v - v_corr,
                      st2.bg - st1.bg, st2.ba - st1.ba], dim=-1)


def _perturbed_residual(dx1, dx2, dg, pre, st1, st2):
    st1p = dataclasses.replace(st1.boxplus(dx1), g=st1.g + dg)
    return residual(pre, st1p, st2.boxplus(dx2))


def evaluate(pre: Preint, st1: NavState, st2: NavState,
             with_gravity: bool = False, Winv=None):
    """(chi2, J^T W J, J^T W r) of one IMU factor with the Jacobian by
    `torch.func.jacfwd` of the boxplus-perturbed residual, state layout
    [dx1 (15), dx2 (15)] (+ [dg (3)]; reference give_evaluate_g,
    preintegration.hpp:214-294). The factor goes through as a batch of
    one: under jacfwd an unbatched 0-dim norm plus a Python float gets
    float64 tangents (torch 2.13)."""
    def one(x):
        return tmap(lambda a: a[None], x)

    z15 = pre.p_delta.new_zeros((1, DIM))
    z3 = pre.p_delta.new_zeros((1, 3))
    r = residual(pre, st1, st2)
    J1, J2, Jg = (j[0, :, 0] for j in torch.func.jacfwd(
        _perturbed_residual, argnums=(0, 1, 2))(
            z15, z15, z3, one(pre), one(st1), one(st2)))
    J = torch.cat([J1, J2, Jg] if with_gravity else [J1, J2], dim=1)
    W = cov_inv(pre) if Winv is None else Winv
    JtW = J.T @ W
    return r @ W @ r, JtW @ J, JtW @ r


def _blocks(rows):
    """5x5 grid of (..., 3, 3) blocks -> (..., 15, 15)."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def jacobian_closed(pre: Preint, st1: NavState, st2: NavState,
                    with_gravity: bool = False) -> torch.Tensor:
    """Closed-form Jacobian of `residual` wrt [dx1 (15), dx2 (15)]
    (+ [dg (3)]) — the reference's give_evaluate[_g] blocks; see the JAX
    package's docstring for the derivation."""
    dt = pre.dtime[..., None, None]
    R1T = st1.R.transpose(-1, -2)
    A = R1T @ st2.R
    dbg = st1.bg - pre.bg_lin
    c = mv(pre.R_bg, dbg)
    B = pre.R_delta.transpose(-1, -2) @ A
    e_r = so3.log(so3.exp(c).transpose(-1, -2) @ B)
    jri = so3.jr_inv(e_r)
    dtv = pre.dtime[..., None]
    x_t = st2.p - st1.p - st1.v * dtv - 0.5 * dtv * dtv * st1.g
    x_v = st2.v - st1.v - dtv * st1.g
    y_t = mv(R1T, x_t)
    y_v = mv(R1T, x_v)

    batch = A.shape[:-2]
    Z = A.new_zeros(batch + (3, 3))
    I = _eye3(A, batch)
    J1 = _blocks([
        [-jri @ A.transpose(-1, -2), Z, Z,
         -jri @ B.transpose(-1, -2) @ so3.jr(-c) @ pre.R_bg, Z],
        [so3.hat(y_t), -R1T, -dt * R1T, -pre.p_bg, -pre.p_ba],
        [so3.hat(y_v), Z, -R1T, -pre.v_bg, -pre.v_ba],
        [Z, Z, Z, -I, Z],
        [Z, Z, Z, Z, -I],
    ])
    J2 = _blocks([
        [jri, Z, Z, Z, Z],
        [Z, R1T, Z, Z, Z],
        [Z, Z, R1T, Z, Z],
        [Z, Z, Z, I, Z],
        [Z, Z, Z, Z, I],
    ])
    if not with_gravity:
        return torch.cat([J1, J2], dim=-1)
    Jg = torch.cat([Z, -0.5 * dt * dt * R1T, -dt * R1T, Z, Z], dim=-2)
    return torch.cat([J1, J2, Jg], dim=-1)


def cov_inv(pre: Preint) -> torch.Tensor:
    """Inverse of the preintegration covariance (+1e-12 I), f32 LU as in
    the JAX package; hoisted out of LM loops by the callers. `inv_ex`
    without its error check: `inv` reads the LU's info back to the host."""
    eye = torch.eye(DIM, dtype=pre.cov.dtype, device=pre.cov.device)
    return torch.linalg.inv_ex(pre.cov + eye * 1e-12)[0]


def evaluate_closed(pre: Preint, st1: NavState, st2: NavState,
                    with_gravity: bool = False, Winv=None):
    """(chi2, J^T W J, J^T W r) of the IMU factor with the closed-form
    Jacobian."""
    r = residual(pre, st1, st2)
    J = jacobian_closed(pre, st1, st2, with_gravity)
    W = cov_inv(pre) if Winv is None else Winv
    JtW = J.transpose(-1, -2) @ W
    return torch.sum(r * mv(W, r), dim=-1), JtW @ J, mv(JtW, r)


def chi2(pre: Preint, st1: NavState, st2: NavState, Winv=None):
    r = residual(pre, st1, st2)
    W = cov_inv(pre) if Winv is None else Winv
    return torch.sum(r * mv(W, r), dim=-1)
