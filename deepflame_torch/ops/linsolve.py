"""Matrix-free Krylov solvers: preconditioned CG and BiCGStab, batched.

Port of deepflame_tpu/ops/linsolve.py. The JAX package solves a batch of
fields (species, velocity components) by mapping one `lax.while_loop` over
the batch with vmap; each lane then iterates until its own test passes and
counts its own iterations. Here the batch is an explicit leading dimension:
fields are (..., nx, ny, nz) on a structured mesh or (..., n_cells) on a
face-list mesh (`nd`, the number of trailing field dimensions, is 3 or 1),
every dot product and norm reduces over the field dimensions only, and each
lane carries an active flag, frozen once converged (or after a breakdown),
and its own iteration count.

The loop is Python and reads "any lane active" back to the host every
`CHECK_EVERY` trips; trips after a lane stopped are exact no-ops for it, so
results and counts match the JAX loop. Each solve is a tracer span
(`krylov.cg`, `krylov.bicgstab`; `runtime.timers`) counting its trips
(`krylov.trips`), trips x lanes (`krylov.lane_trips`), the lanes' summed
iterations (`krylov.lane_iters`, a device tensor) and its host reads
(`krylov.host_reads`). Inside `parallel.context.compensated()`
the per-lane reductions are compensated sums (`ops.compensated.sum2`), as the
JAX package's gsum is there.

Under an active shard group (`parallel.context.shard_axis`) each per-lane
reduction is the local one followed by one `all_reduce` of the lane vector,
and a mean counts the cells of every shard (the owned cells only where a
`cell_weight` is active): every rank sees the same residuals, so every rank
runs the same trips and reads the same "any lane active".
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..parallel.context import (compensated_on, current_axis,
                                current_cell_weight)
from ..runtime.timers import count, span
from .compensated import sum2
from .kernels import stencil7_apply

__all__ = ["SolverResult", "cg", "bicgstab", "solve_fvmatrix"]

# trips between host reads of "any lane active"
CHECK_EVERY = 4


class SolverResult(NamedTuple):
    x: torch.Tensor
    initial_residual: torch.Tensor   # OpenFOAM-style normalised, per lane
    final_residual: torch.Tensor
    iterations: torch.Tensor         # per lane


def _vsum(x, nd):
    if compensated_on():
        s = sum2(x, nd=nd)
    else:
        s = x.sum(dim=tuple(range(-nd, 0)))
    g = current_axis()
    return g.all_reduce(s) if g is not None else s


def _vmean(x, nd):
    g = current_axis()
    if g is None:
        if compensated_on():
            return sum2(x, nd=nd) / math.prod(x.shape[x.dim() - nd:])
        return x.mean(dim=tuple(range(-nd, 0)))
    w = current_cell_weight()
    if w is not None and nd == 1 and x.shape[-1] == w.shape[0]:
        # a shard-local face-list field: average the owned cells
        num = _vsum(torch.where(w > 0, x, torch.zeros_like(x)), nd)
        return num / g.all_reduce(w.sum())
    return _vsum(x, nd) / (math.prod(x.shape[x.dim() - nd:]) * g.size)


def _dot(a, b, nd):
    return _vsum(a * b, nd)


def _b(s, nd):
    """Per-lane scalar -> broadcastable against fields."""
    return s.reshape(s.shape + (1,) * nd)


def _safe_div(a, b):
    """a / b with zero denominators replaced by +-tiny of the dtype."""
    tiny = torch.finfo(b.dtype).tiny
    safe = torch.where(b.abs() > tiny, b,
                       torch.where(b >= 0, torch.full_like(b, tiny),
                                   torch.full_like(b, -tiny)))
    return a / safe


def _norm_factor(A, b, x, nd):
    """OpenFOAM lduMatrix normFactor: ||A xref - b|| with xref = mean(x)."""
    xbar = _b(_vmean(x, nd), nd) * torch.ones_like(x)
    Axbar = A(xbar)
    norm = _vsum((A(x) - Axbar).abs(), nd) + _vsum((b - Axbar).abs(), nd)
    return torch.clamp(norm, min=torch.finfo(b.dtype).tiny)


def _any_active(act) -> bool:
    """The loop's host read of "any lane active"."""
    count("krylov.host_reads")
    return bool(act.any())


def _count_trips(trips: int, it) -> None:
    count("krylov.trips", trips)
    count("krylov.lane_trips", trips * it.numel())
    count("krylov.lane_iters", it)


def cg(A: Callable, b, x0, M_inv: Callable | None = None, tol: float = 1e-6,
       rel_tol: float = 0.0, max_iter: int = 1000, nd: int = 3) -> SolverResult:
    """Preconditioned conjugate gradient for SPD A (the pressure equation).
    `nd`: trailing field dimensions (3 structured, 1 face-list)."""
    with span("krylov.cg"):
        return _cg(A, b, x0, M_inv, tol, rel_tol, max_iter, nd)


def _cg(A, b, x0, M_inv, tol, rel_tol, max_iter, nd):
    if M_inv is None:
        M_inv = lambda r: r
    norm = _norm_factor(A, b, x0, nd)
    x = x0
    r = b - A(x0)
    res0 = _vsum(r.abs(), nd) / norm
    z = M_inv(r)
    p = z
    rz = _dot(r, z, nd)
    res = res0
    it = torch.zeros(res0.shape, dtype=torch.long, device=b.device)

    def active():
        return (it < max_iter) & (res > tol) & (res > rel_tol * res0)

    trips = 0
    while trips < max_iter and _any_active(active()):
        for _ in range(min(CHECK_EVERY, max_iter - trips)):
            act = active()
            Ap = A(p)
            alpha = _safe_div(rz, _dot(p, Ap, nd))
            x_n = x + _b(alpha, nd) * p
            r_n = r - _b(alpha, nd) * Ap
            z = M_inv(r_n)
            rz_new = _dot(r_n, z, nd)
            beta = _safe_div(rz_new, rz)
            p_n = z + _b(beta, nd) * p
            res_n = _vsum(r_n.abs(), nd) / norm
            # breakdown guard: a non-finite step keeps the last good x and
            # stops the lane (res = -1)
            ok = torch.isfinite(res_n)
            upd = _b(act & ok, nd)
            x = torch.where(upd, x_n, x)
            r = torch.where(upd, r_n, r)
            p = torch.where(upd, p_n, p)
            rz = torch.where(act & ok, rz_new, rz)
            res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
            it = it + act.long()
            trips += 1
    _count_trips(trips, it)
    return SolverResult(x, res0, res, it)


def bicgstab(A: Callable, b, x0, M_inv: Callable | None = None,
             tol: float = 1e-6, rel_tol: float = 0.0,
             max_iter: int = 1000, nd: int = 3) -> SolverResult:
    """Preconditioned BiCGStab for nonsymmetric A (convection-diffusion).
    `nd`: trailing field dimensions (3 structured, 1 face-list)."""
    with span("krylov.bicgstab"):
        return _bicgstab(A, b, x0, M_inv, tol, rel_tol, max_iter, nd)


def _bicgstab(A, b, x0, M_inv, tol, rel_tol, max_iter, nd):
    if M_inv is None:
        M_inv = lambda r: r
    norm = _norm_factor(A, b, x0, nd)
    x = x0
    r = b - A(x0)
    res0 = _vsum(r.abs(), nd) / norm
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
    while trips < max_iter and _any_active(active()):
        for _ in range(min(CHECK_EVERY, max_iter - trips)):
            act = active()
            rho_new = _dot(r_hat, r, nd)
            beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
            p_n = r + _b(beta, nd) * (p - _b(omega, nd) * v)
            p_hat = M_inv(p_n)
            v_n = A(p_hat)
            alpha_n = _safe_div(rho_new, _dot(r_hat, v_n, nd))
            s = r - _b(alpha_n, nd) * v_n
            s_hat = M_inv(s)
            t = A(s_hat)
            omega_n = _safe_div(_dot(t, s, nd), _dot(t, t, nd))
            x_n = x + _b(alpha_n, nd) * p_hat + _b(omega_n, nd) * s_hat
            r_n = s - _b(omega_n, nd) * t
            res_n = _vsum(r_n.abs(), nd) / norm
            ok = torch.isfinite(res_n)
            up = act & ok
            x = torch.where(_b(up, nd), x_n, x)
            r = torch.where(_b(up, nd), r_n, r)
            p = torch.where(_b(up, nd), p_n, p)
            v = torch.where(_b(up, nd), v_n, v)
            rho = torch.where(up, rho_new, rho)
            alpha = torch.where(up, alpha_n, alpha)
            omega = torch.where(up, omega_n, omega)
            res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
            it = it + act.long()
            trips += 1
    _count_trips(trips, it)
    return SolverResult(x, res0, res, it)


def solve_fvmatrix(eqn, x0, symmetric: bool = False, tol: float = 1e-7,
                   rel_tol: float = 0.0, max_iter: int = 1000,
                   stencil=None) -> SolverResult:
    """Solve an FvMatrix (or a batch of them) with Jacobi preconditioning.
    Structured: the matvec is the stencil kernel on the folded coefficients
    and diag(A) = D is exact; `stencil`: eqn.stencil() when the caller has
    it. Face-list (FvMatrixFL, batched over leading dimensions of its
    coefficients): the matvec is eqn.apply and the diagonal eqn.diag(), the
    JAX package's branch for meshes without a shift plan. Face-list meshes
    with a shift plan run the whole Krylov loop on the (..., nx, ny, nz)
    lattice: the stencil coefficients (eqn.plan_stencil) are prepared once
    per solve and every matvec is the stencil kernel."""
    plan = getattr(getattr(eqn, "mesh", None), "plan", None)
    if plan is not None:
        from .fv_facelist import _stencil_shape, lattice_operands
        diag_lat, terms = eqn.plan_stencil()
        b = eqn.rhs()
        batch = torch.broadcast_shapes(b.shape[:-1], x0.shape[:-1])
        full = _stencil_shape(batch + plan.shape, diag_lat, terms)
        batch, n = full[:-3], math.prod(plan.shape)
        D, lo, hi = lattice_operands(full, diag_lat, terms)
        d_inv = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
        lat = lambda v: v.expand(batch + (n,)).reshape(D.shape)
        solver = cg if symmetric else bicgstab
        res = solver(lambda X: stencil7_apply(X, D, lo, hi), lat(b),
                     lat(x0).contiguous(), lambda r: d_inv * r, tol, rel_tol,
                     max_iter)
        per_lane = lambda t: t.reshape(batch)
        return SolverResult(res.x.reshape(batch + (n,)),
                            per_lane(res.initial_residual),
                            per_lane(res.final_residual),
                            per_lane(res.iterations))
    if not hasattr(eqn, "stencil"):
        d = eqn.diag()
        shape = torch.broadcast_shapes(d.shape, eqn.rhs().shape, x0.shape)
        d = torch.broadcast_to(d, shape)
        d_inv = 1.0 / torch.where(d.abs() > 1e-300, d, torch.ones_like(d))
        solver = cg if symmetric else bicgstab
        b, apply = torch.broadcast_to(eqn.rhs(), shape), eqn.apply
        m = eqn.mesh
        if m.w_own is not None:
            # a shard-local mesh: halo and pad rows are not this shard's
            # equations, so every reduction sums the owned rows only
            b = m.restrict(b, dim=-1)
            apply = lambda x: m.restrict(eqn.apply(x), dim=-1)
        return solver(apply, b, torch.broadcast_to(x0, shape).contiguous(),
                      lambda r: d_inv * r, tol, rel_tol, max_iter, nd=1)
    st = eqn.stencil() if stencil is None else stencil
    if st is None:
        if not any(bc.kind == "processor" for pair in eqn.bcs for bc in pair):
            raise NotImplementedError("solve_fvmatrix needs 7-point stencil "
                                      "coefficients for every term")
        # a processor boundary: the padded matvec and the coloring
        # diagonal, as the JAX package
        d = eqn.diag()
        d_inv = 1.0 / torch.where(d.abs() > 1e-300, d, torch.ones_like(d))
        solver = cg if symmetric else bicgstab
        return solver(eqn.apply, torch.broadcast_to(eqn.rhs(), d.shape),
                      torch.broadcast_to(x0, d.shape).contiguous(),
                      lambda r: d_inv * r, tol, rel_tol, max_iter)
    D, lo, hi = st
    b = eqn.rhs()
    apply = lambda x: stencil7_apply(x, D, lo, hi)
    d_inv = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
    M_inv = lambda r: d_inv * r
    x0 = torch.broadcast_to(x0, D.shape).contiguous()
    b = torch.broadcast_to(b, D.shape)
    solver = cg if symmetric else bicgstab
    return solver(apply, b, x0, M_inv, tol, rel_tol, max_iter)
