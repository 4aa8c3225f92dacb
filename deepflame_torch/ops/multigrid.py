"""Geometric multigrid preconditioner for the pressure equation.

Port of deepflame_tpu/ops/multigrid.py. On a structured block the
aggregation is exact factor-2 coarsening: restriction averages the 2^d
children, prolongation injects the parent, and each level's operator is the
re-discretised diag + variable-coefficient Laplacian with coarsened face
coefficients. One V(nu_pre, nu_post) cycle with damped-Jacobi smoothing is
the preconditioner of the pressure CG (`LowMachConfig.p_precond="mg"`).

Every level's matvec is the Helmholtz kernel on the iterate, its ghosts
computed inside the kernel from the pressure BCs (`ops.kernels.
helmholtz_operator`, built once per level at set-up; the plain version on
the CPU), as the pressure CG's own matvec is. The kernel skips an axis of one
cell, where the JAX level operator adds that axis's ghost difference: the
two agree unless a coarse level halves an axis of two cells onto a
fixedValue side.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..mesh.structured import StructuredMesh
from .kernels import helmholtz_operator

__all__ = ["make_mg_preconditioner", "mg_levels"]


def _coarsen_cell(f):
    """2^d-child average along even axes longer than 1 (the last three)."""
    for ax in range(3):
        i = f.dim() - 3 + ax
        n = f.shape[i]
        if n > 1 and n % 2 == 0:
            sh = list(f.shape)
            sh[i:i + 1] = [n // 2, 2]
            f = f.reshape(sh).mean(dim=i + 1)
    return f


def _refine_cell(f, target_shape):
    for ax in range(3):
        if f.shape[ax] != target_shape[ax]:
            f = torch.repeat_interleave(f, 2, dim=ax)
    return f


def _coarsen_faces(gamma, mesh: StructuredMesh):
    """Per-axis face coefficients of the coarse level: every second face
    along the normal, the 2 x 2 transverse children averaged."""
    out = []
    for ax in range(3):
        g = gamma[ax]
        if mesh.shape[ax] > 1 and mesh.shape[ax] % 2 == 0:
            g = g[tuple(slice(None, None, 2) if a == ax else slice(None)
                        for a in range(3))]
        for t in range(3):
            if t != ax and mesh.shape[t] > 1 and mesh.shape[t] % 2 == 0:
                sh = list(g.shape)
                sh[t:t + 1] = [g.shape[t] // 2, 2]
                g = g.reshape(sh).mean(dim=t + 1)
        out.append(g.contiguous())
    return tuple(out)


def _can_coarsen(mesh: StructuredMesh, min_cells: int = 4) -> bool:
    return any(n > min_cells and n % 2 == 0 for n in mesh.shape)


def _coarse_mesh(mesh: StructuredMesh) -> StructuredMesh:
    f = [2 if (n > 1 and n % 2 == 0) else 1 for n in mesh.shape]
    return dataclasses.replace(
        mesh, nx=mesh.nx // f[0], ny=mesh.ny // f[1], nz=mesh.nz // f[2],
        dx=mesh.dx * f[0], dy=mesh.dy * f[1], dz=mesh.dz * f[2])


def mg_levels(mesh: StructuredMesh, diag_coeff, gamma_faces,
              n_levels: int = 10):
    """The hierarchy: per level (mesh, gamma faces, diag coefficient,
    inverse of the analytic interior diagonal). The diagonal d + sum_ax
    (gamma_lo + gamma_hi)/h^2 ignores the BCs' corrections, as the JAX
    package's does: damped Jacobi needs no more."""
    levels = []
    m, d, g = mesh, diag_coeff, tuple(t.contiguous() for t in gamma_faces)
    for _ in range(n_levels):
        diag = d
        for ax, h in enumerate(m.spacing):
            if m.shape[ax] == 1:
                continue
            n_f = g[ax].shape[ax]
            diag = diag + (g[ax].narrow(ax, 0, n_f - 1)
                           + g[ax].narrow(ax, 1, n_f - 1)) / (h * h)
        inv_diag = 1.0 / torch.where(diag.abs() > 1e-300, diag,
                                     torch.ones_like(diag))
        levels.append((m, g, d.contiguous(), inv_diag))
        if not _can_coarsen(m):
            break
        g = _coarsen_faces(g, m)
        d = _coarsen_cell(d)
        m = _coarse_mesh(m)
    return levels


def make_mg_preconditioner(mesh: StructuredMesh, bcs, diag_coeff, gamma_faces,
                           dtype=None, n_levels: int = 10, nu_pre: int = 2,
                           nu_post: int = 2, n_coarse_iters: int = 20,
                           omega: float = 0.8) -> Callable:
    """M_inv(r): one V-cycle for A = Sp(diag_coeff) - laplacian(gamma_faces).

    diag_coeff: cell field (psi/dt); gamma_faces: per-axis face arrays (rho
    rAU on faces); bcs: the pressure BCs, homogeneous on every level.
    `dtype` is the fields' and is kept for the JAX package's signature."""
    levels = mg_levels(mesh, diag_coeff, gamma_faces, n_levels)
    matvecs = [helmholtz_operator(bcs, m) for m, *_ in levels]

    def apply(lvl, x):
        _, g, d, _ = levels[lvl]
        return matvecs[lvl](x, g, d)

    def smooth(lvl, x, b, n_iters):
        inv_diag = levels[lvl][3]
        for _ in range(n_iters):
            x = x + omega * inv_diag * (b - apply(lvl, x))
        return x

    def v_cycle(lvl, b):
        x = torch.zeros_like(b)
        if lvl == len(levels) - 1:
            return smooth(lvl, x, b, n_coarse_iters)
        x = smooth(lvl, x, b, nu_pre)
        r_c = _coarsen_cell(b - apply(lvl, x))
        x = x + _refine_cell(v_cycle(lvl + 1, r_c), levels[lvl][0].shape)
        return smooth(lvl, x, b, nu_post)

    return lambda r: v_cycle(0, r)
