"""Matrix-free Krylov solvers: preconditioned CG and BiCGStab, batched.

Port of deepflame_tpu/ops/linsolve.py. The JAX package solves a batch of
fields (species, velocity components) by mapping one `lax.while_loop` over
the batch with vmap; each lane then iterates until its own test passes and
counts its own iterations. Here the batch is an explicit leading dimension:
fields are (..., nx, ny, nz), every dot product and norm reduces over the
last three dimensions only, and each lane carries an active flag, frozen once
converged (or after a breakdown), and its own iteration count.

The loop is Python and reads "any lane active" back to the host every
`CHECK_EVERY` trips; trips after a lane stopped are exact no-ops for it, so
results and counts match the JAX loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .kernels import stencil7_apply

__all__ = ["SolverResult", "cg", "bicgstab", "solve_fvmatrix"]

_DIMS = (-3, -2, -1)
# trips between host reads of "any lane active"
CHECK_EVERY = 4


class SolverResult(NamedTuple):
    x: torch.Tensor
    initial_residual: torch.Tensor   # OpenFOAM-style normalised, per lane
    final_residual: torch.Tensor
    iterations: torch.Tensor         # per lane


def _vsum(x):
    return x.sum(dim=_DIMS)


def _dot(a, b):
    return _vsum(a * b)


def _b(s):
    """Per-lane scalar -> broadcastable against fields."""
    return s[..., None, None, None]


def _safe_div(a, b):
    """a / b with zero denominators replaced by +-tiny of the dtype."""
    tiny = torch.finfo(b.dtype).tiny
    safe = torch.where(b.abs() > tiny, b,
                       torch.where(b >= 0, torch.full_like(b, tiny),
                                   torch.full_like(b, -tiny)))
    return a / safe


def _norm_factor(A, b, x):
    """OpenFOAM lduMatrix normFactor: ||A xref - b|| with xref = mean(x)."""
    xbar = _b(x.mean(dim=_DIMS)) * torch.ones_like(x)
    Axbar = A(xbar)
    norm = _vsum((A(x) - Axbar).abs()) + _vsum((b - Axbar).abs())
    return torch.clamp(norm, min=torch.finfo(b.dtype).tiny)


def cg(A: Callable, b, x0, M_inv: Callable | None = None, tol: float = 1e-6,
       rel_tol: float = 0.0, max_iter: int = 1000) -> SolverResult:
    """Preconditioned conjugate gradient for SPD A (the pressure equation)."""
    if M_inv is None:
        M_inv = lambda r: r
    norm = _norm_factor(A, b, x0)
    x = x0
    r = b - A(x0)
    res0 = _vsum(r.abs()) / norm
    z = M_inv(r)
    p = z
    rz = _dot(r, z)
    res = res0
    it = torch.zeros(res0.shape, dtype=torch.long, device=b.device)

    def active():
        return (it < max_iter) & (res > tol) & (res > rel_tol * res0)

    trips = 0
    while trips < max_iter and bool(active().any()):
        for _ in range(min(CHECK_EVERY, max_iter - trips)):
            act = active()
            Ap = A(p)
            alpha = _safe_div(rz, _dot(p, Ap))
            x_n = x + _b(alpha) * p
            r_n = r - _b(alpha) * Ap
            z = M_inv(r_n)
            rz_new = _dot(r_n, z)
            beta = _safe_div(rz_new, rz)
            p_n = z + _b(beta) * p
            res_n = _vsum(r_n.abs()) / norm
            # breakdown guard: a non-finite step keeps the last good x and
            # stops the lane (res = -1)
            ok = torch.isfinite(res_n)
            upd = _b(act & ok)
            x = torch.where(upd, x_n, x)
            r = torch.where(upd, r_n, r)
            p = torch.where(upd, p_n, p)
            rz = torch.where(act & ok, rz_new, rz)
            res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
            it = it + act.long()
            trips += 1
    return SolverResult(x, res0, res, it)


def bicgstab(A: Callable, b, x0, M_inv: Callable | None = None,
             tol: float = 1e-6, rel_tol: float = 0.0,
             max_iter: int = 1000) -> SolverResult:
    """Preconditioned BiCGStab for nonsymmetric A (convection-diffusion)."""
    if M_inv is None:
        M_inv = lambda r: r
    norm = _norm_factor(A, b, x0)
    x = x0
    r = b - A(x0)
    res0 = _vsum(r.abs()) / norm
    r_hat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = torch.ones_like(res0)
    alpha = torch.ones_like(res0)
    omega = torch.ones_like(res0)
    res = res0
    it = torch.zeros(res0.shape, dtype=torch.long, device=b.device)

    def active():
        return (it < max_iter) & (res > tol) & (res > rel_tol * res0)

    trips = 0
    while trips < max_iter and bool(active().any()):
        for _ in range(min(CHECK_EVERY, max_iter - trips)):
            act = active()
            rho_new = _dot(r_hat, r)
            beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
            p_n = r + _b(beta) * (p - _b(omega) * v)
            p_hat = M_inv(p_n)
            v_n = A(p_hat)
            alpha_n = _safe_div(rho_new, _dot(r_hat, v_n))
            s = r - _b(alpha_n) * v_n
            s_hat = M_inv(s)
            t = A(s_hat)
            omega_n = _safe_div(_dot(t, s), _dot(t, t))
            x_n = x + _b(alpha_n) * p_hat + _b(omega_n) * s_hat
            r_n = s - _b(omega_n) * t
            res_n = _vsum(r_n.abs()) / norm
            ok = torch.isfinite(res_n)
            up = act & ok
            x = torch.where(_b(up), x_n, x)
            r = torch.where(_b(up), r_n, r)
            p = torch.where(_b(up), p_n, p)
            v = torch.where(_b(up), v_n, v)
            rho = torch.where(up, rho_new, rho)
            alpha = torch.where(up, alpha_n, alpha)
            omega = torch.where(up, omega_n, omega)
            res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
            it = it + act.long()
            trips += 1
    return SolverResult(x, res0, res, it)


def solve_fvmatrix(eqn, x0, symmetric: bool = False, tol: float = 1e-7,
                   rel_tol: float = 0.0, max_iter: int = 1000,
                   stencil=None) -> SolverResult:
    """Solve an FvMatrix (or a batch of them) with Jacobi preconditioning;
    the matvec is the stencil kernel on the folded coefficients and
    diag(A) = D is exact. `stencil`: eqn.stencil() when the caller has it."""
    st = eqn.stencil() if stencil is None else stencil
    if st is None:
        raise NotImplementedError("solve_fvmatrix needs 7-point stencil "
                                  "coefficients for every term")
    D, lo, hi = st
    b = eqn.rhs()
    apply = lambda x: stencil7_apply(x, D, lo, hi)
    d_inv = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
    M_inv = lambda r: d_inv * r
    x0 = torch.broadcast_to(x0, D.shape).contiguous()
    b = torch.broadcast_to(b, D.shape)
    solver = cg if symmetric else bicgstab
    return solver(apply, b, x0, M_inv, tol, rel_tol, max_iter)
