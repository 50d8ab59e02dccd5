"""The port's factor-major LiDAR factor (`cost`, `cost_at`, `grad`,
`hess_grad`, `hess_grad_ct`, `hess_grad_analytic`) and the derivative of
`eigh3` against the JAX package.

Factors are tests/test_ba.py's: random planes seen from W frames, with
non-empty fixed clusters, invalid rows and a masked frame. Tolerances are
tests/test_ba.py's (gradient 2e-4 and Hessian 2e-3 of the largest entry)
unless a comparison states its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelslam_tpu.ba import lidar_factor as jlf
from voxelslam_tpu.core import cluster as jcl
from voxelslam_tpu.core import eig3 as jeig
from voxelslam_tpu_torch.ba import lidar_factor as lf
from voxelslam_tpu_torch.core import eig3

from test_ba import _make_factors
from test_torch_helpers import n, t, to_port

torch.set_num_threads(1)

G_TOL, H_TOL = 2e-4, 2e-3        # of max |g|, max |H| (tests/test_ba.py)


@pytest.fixture(scope="module")
def factors():
    """tests/test_ba.py's mixed factors: W = 4, F = 9, fixed clusters,
    about a third of the rows invalid, frame 1 masked."""
    rng = np.random.default_rng(0)
    fb, Rs, ps = _make_factors(rng, W=4, F=9, n_per=25, noise=0.02)
    fixpts = jnp.array(rng.normal(0, 2, (9, 12, 3)), jnp.float32)
    fb = dataclasses.replace(fb, fix=jcl.from_points(fixpts),
                             valid=jnp.array(rng.random(9) > 0.3))
    mask = jnp.ones(4).at[1].set(0.0)
    return (fb, Rs, ps, mask), (to_port(fb, lf.FactorBatch), t(Rs), t(ps),
                                t(mask))


def _close_hg(Hg, ref, what):
    (H, g), (H0, g0) = (tuple(n(x) for x in Hg), tuple(np.asarray(x)
                                                       for x in ref))
    sH = np.abs(H0).max() + 1e-6
    sg = np.abs(g0).max() + 1e-6
    np.testing.assert_allclose(g, g0, atol=G_TOL * sg, err_msg=what)
    np.testing.assert_allclose(H, H0, atol=H_TOL * sH, err_msg=what)


def test_total_clusters_and_cost_match_jax(factors):
    (jfb, jR, jp, jm), (tfb, tR, tp, tm) = factors
    a = jlf.total_clusters(jfb, jR, jp, jm)
    b = lf.total_clusters(tfb, tR, tp, tm)
    np.testing.assert_allclose(n(b.n), np.asarray(a.n), atol=0)
    np.testing.assert_allclose(n(b.mu), np.asarray(a.mu), atol=1e-5)
    np.testing.assert_allclose(n(b.S), np.asarray(a.S), atol=1e-3)
    dx = np.random.default_rng(1).normal(0, 0.01, (4, 6)).astype(np.float32)
    for cj, ct in ((jlf.cost(jfb, jR, jp, jm), lf.cost(tfb, tR, tp, tm)),
                   (jlf.cost_at(jfb, jR, jp, jnp.asarray(dx), jm),
                    lf.cost_at(tfb, tR, tp, t(dx), tm))):
        # the smallest eigenvalue of each covariance, to f32 eigensolve
        # accuracy relative to its largest (tests/test_torch_core.py)
        assert abs(float(ct) - float(cj)) < 1e-4 * max(abs(float(cj)), 1e-3)


def test_grad_matches_jax(factors):
    (jfb, jR, jp, jm), (tfb, tR, tp, tm) = factors
    g0 = np.asarray(jlf.grad(jfb, jR, jp, jm))
    g = n(lf.grad(tfb, tR, tp, tm))
    assert g.shape == (4, 6) and np.all(g[1] == 0.0)   # masked frame
    np.testing.assert_allclose(g, g0, atol=G_TOL * np.abs(g0).max())


@pytest.mark.parametrize("name", ["hess_grad", "hess_grad_ct",
                                  "hess_grad_analytic"])
def test_newton_system_matches_jax(factors, name):
    """Each Newton-system function against its JAX counterpart."""
    (jfb, jR, jp, jm), (tfb, tR, tp, tm) = factors
    ref = jax.jit(getattr(jlf, name))(jfb, jR, jp, jm)
    _close_hg(getattr(lf, name)(tfb, tR, tp, tm), ref, name)


@pytest.mark.parametrize("name", ["hess_grad_ct", "hess_grad_analytic",
                                  "hess_grad_ct_t"])
def test_closed_forms_match_port_autodiff(factors, name):
    """The port's own autodiff Hessian holds every closed form, the
    production `hess_grad_ct_t` (on the transposed batch) included."""
    _, (tfb, tR, tp, tm) = factors
    ref = lf.hess_grad(tfb, tR, tp, tm)
    if name == "hess_grad_ct_t":
        got = lf.hess_grad_ct_t(lf.transpose_factors(tfb), tR, tp, tm)
    else:
        got = getattr(lf, name)(tfb, tR, tp, tm)
    _close_hg(got, ref, name)


# --------------------------------------------------------------------------
# the derivative of eigh3
# --------------------------------------------------------------------------

def _sym_cases(rng, k=12):
    """Generic SPD matrices, planar clusters and two near-repeated ones:
    a plane whose in-plane pair is 3e-8 apart (within 1e-7) and an exactly
    repeated pair."""
    A = rng.normal(0, 1, (k, 3, 3))
    generic = A @ A.transpose(0, 2, 1)
    U = np.linalg.qr(rng.normal(0, 1, (k, 3, 3)))[0]
    lam = np.stack([rng.uniform(1e-4, 1e-3, k), rng.uniform(0.3, 0.6, k),
                    rng.uniform(0.8, 1.5, k)], 1)
    plane = U @ (lam[:, :, None] * U.transpose(0, 2, 1))
    near = U[0] @ np.diag([2e-4, 0.5, 0.5 + 3e-8]) @ U[0].T
    rep = np.diag([0.25, 1.0, 1.0])
    return np.concatenate([generic, plane, near[None], rep[None]]).astype(
        np.float32)


def _well_defined(a):
    """lambda_0, u_0 and lambda_1 + lambda_2: what a near-repeated pair
    leaves defined (the pair's own vectors turn freely in their plane,
    faster than a finite difference can follow)."""
    w, V = eig3.eigh3(a)
    return w[..., 0], V[..., 0], w[..., 1] + w[..., 2]


def test_eigh3_autograd_checks_float64():
    """gradcheck (reverse and forward mode) and gradgradcheck in float64,
    on generic matrices (every output) and on a near-repeated pair 3e-8
    apart (the outputs it leaves defined)."""
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (4, 3, 3))
    A = A @ A.transpose(0, 2, 1)
    U = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    near = U @ np.diag([1e-3, 0.5, 0.5 + 3e-8]) @ U.T
    for M, fn in ((A, eig3.eigh3), (near[None], _well_defined)):
        x = torch.tensor(M, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(fn, (x,), check_forward_ad=True)
        assert torch.autograd.gradgradcheck(lambda a: fn(a)[0], (x,))


def test_eigh3_forward_ad_matches_formula():
    """torch.autograd.forward_ad gives the perturbation formulas: dw_k =
    u_k^T dA u_k, and V^T dV has zero diagonal (unit vectors)."""
    M = torch.tensor(_sym_cases(np.random.default_rng(6))[:12],
                     dtype=torch.float64)
    dA = torch.randn(M.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    dA = dA + dA.transpose(-1, -2)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        w, V = eig3.eigh3(fwAD.make_dual(M, dA))
        dw, dV = fwAD.unpack_dual(w).tangent, fwAD.unpack_dual(V).tangent
    V = V.detach()
    want = torch.einsum("...ik,...ij,...jk->...k", V, dA, V)
    torch.testing.assert_close(dw, want, rtol=1e-10, atol=1e-10)
    VtdV = V.transpose(-1, -2) @ dV
    torch.testing.assert_close(torch.diagonal(VtdV, dim1=-2, dim2=-1),
                               torch.zeros_like(dw), atol=1e-9, rtol=0)


def test_eigh3_jvp_and_grad_match_jax():
    """jvp and grad of the port's eigh3 against jax.jvp / jax.grad of the
    JAX custom_jvp, f32. Everything that is well defined is compared: all
    of w and V on generic and planar matrices and on the exactly repeated
    pair (whose gap both drop); on the near-repeated pair, lambda_0, u_0
    and the pair's summed eigenvalue derivative (the pair's own vectors
    are any rotation in their plane, and the JAX package and the port
    round them differently). Tolerance 1e-3 of each output's largest
    tangent."""
    M = _sym_cases(np.random.default_rng(7))
    rng = np.random.default_rng(8)
    dA = rng.normal(0, 1, M.shape).astype(np.float32)
    cw = rng.normal(0, 1, M.shape[:2]).astype(np.float32)
    cV = rng.normal(0, 1, M.shape).astype(np.float32)
    (wj, Vj), (dwj, dVj) = jax.jvp(jeig.eigh3, (jnp.asarray(M),),
                                   (jnp.asarray(dA),))
    (wt, Vt), (dwt, dVt) = torch.func.jvp(eig3.eigh3, (t(M),), (t(dA),))
    near = len(M) - 2
    full = np.ones(len(M), bool)
    full[near] = False

    def close(a, b, rows):
        a, b = n(a)[rows], np.asarray(b)[rows]
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max())

    close(dwt, dwj, full)
    close(dVt, dVj, full)
    close(dwt[:, 0], dwj[:, 0], slice(None))
    close(dVt[..., 0], dVj[..., 0], slice(None))
    close(dwt[:, 1] + dwt[:, 2], dwj[:, 1] + dwj[:, 2], slice(None))
    assert np.all(np.isfinite(n(dVt)))

    def loss_j(A):
        w, V = jeig.eigh3(A)
        return jnp.sum(cw[:, 0] * w[:, 0]) + jnp.sum(cV[..., 0] * V[..., 0])

    def loss_t(A):
        w, V = eig3.eigh3(A)
        return (torch.sum(t(cw[:, 0]) * w[:, 0])
                + torch.sum(t(cV[..., 0]) * V[..., 0]))

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(M)))
    gt = n(torch.func.grad(loss_t)(t(M)))
    np.testing.assert_allclose(gt, gj, atol=1e-3 * np.abs(gj).max())

    def loss_all_j(A):
        w, V = jeig.eigh3(A)
        return jnp.sum(cw * w) + jnp.sum(cV * V)

    def loss_all_t(A):
        w, V = eig3.eigh3(A)
        return torch.sum(t(cw) * w) + torch.sum(t(cV) * V)

    gj = np.asarray(jax.grad(loss_all_j)(jnp.asarray(M)))[full]
    gt = n(torch.func.grad(loss_all_t)(t(M)))[full]
    np.testing.assert_allclose(gt, gj, atol=1e-3 * np.abs(gj).max())


def test_eigh3_forward_unchanged():
    """The Function's forward is `eigh3_forward`, bit for bit."""
    M = t(_sym_cases(np.random.default_rng(9)))
    w, V = eig3.eigh3(M)
    w0, V0 = eig3.eigh3_forward(M)
    assert torch.equal(w, w0) and torch.equal(V, V0)
