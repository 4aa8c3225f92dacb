"""RAS turbulence: k-epsilon (standard and RNG) and k-omega SST.

Port of deepflame_tpu/turbulence/ras.py (OpenFOAM's RAS family as the
reference's TurbulenceModels use it). Each model carries two transported
fields in the solver state's `turb` slot and advances them at the end of the
step with the FV machinery of the species equations: each of its two
equations is one FvMatrix solved by `solve_fvmatrix`, so every RAS solve is a
`stencil7_apply` matvec. kEpsilon: (k, eps), mu_t = rho Cmu k^2/eps.
kOmegaSST: (k, omega), mu_t = rho a1 k / max(a1 omega, S F2) with Menter's
F1/F2 wall-distance blending.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..mesh.structured import StructuredMesh, pad_field
from ..ops.fv import (fvm_ddt, fvm_div, fvm_laplacian, fvm_source_implicit,
                      grad, interpolate)
from ..ops.linsolve import solve_fvmatrix

__all__ = ["KEpsilon", "KOmegaSST", "wall_distance"]


def wall_distance(mesh: StructuredMesh, walls, dtype=torch.float64):
    """Distance to the nearest of the (axis, side) boundary planes treated as
    no-slip walls, on the mesh's device; 1e10 without walls (the SST model's
    free-shear branch)."""
    C = mesh.cell_centers(dtype)
    lo = (mesh.x0, mesh.y0, mesh.z0)
    ext = (mesh.nx * mesh.dx, mesh.ny * mesh.dy, mesh.nz * mesh.dz)
    d = torch.full(mesh.shape, 1e10, dtype=dtype, device=mesh.device)
    for (ax, side) in walls:
        plane = lo[ax] if side == 0 else lo[ax] + ext[ax]
        d = torch.minimum(d, (C[ax] - plane).abs())
    return d


def _strain_sq(U, bcs_U, mesh):
    """S:S of the velocity gradient, summed in the JAX package's order."""
    gU = [grad(U[c], bcs_U[c], mesh) for c in range(3)]
    SS = 0.0
    for i in range(3):
        for j in range(3):
            Sij = 0.5 * (gU[i][j] + gU[j][i])
            SS = SS + Sij * Sij
    return SS


def _diff_face(gamma, bcs_scalar, mesh):
    return tuple(interpolate(pad_field(gamma, bcs_scalar, mesh), ax)
                 for ax in range(3))


def _transport(rho, rho_old, q, phi, D_f, sp, src, mesh, bcs, dt, tol,
               max_iter):
    """ddt(rho q) + div(phi q) - laplacian(D q) + Sp(sp) q = src, solved."""
    dtype = q.dtype
    eqn = (fvm_ddt(rho, q, dt, mesh, bcs, coeff_old=rho_old)
           + fvm_div(phi, q, mesh, bcs, "upwind")
           + fvm_laplacian(D_f, mesh, bcs, dtype=dtype, sign=-1.0)
           + fvm_source_implicit(sp, mesh, bcs, dtype=dtype))
    return solve_fvmatrix(eqn.with_source(src), q, tol=tol,
                          max_iter=max_iter).x


@dataclasses.dataclass(frozen=True)
class KEpsilon:
    """k-epsilon: standard (Launder-Spalding) or RNG (Yakhot et al.,
    OpenFOAM RNGkEpsilon constants with the strain-dependent C1*)."""
    kind: str = "kEpsilon"
    is_ras: bool = True
    variant: str = "standard"   # standard | RNG
    Cmu: float = 0.09
    C1: float = 1.44
    C2: float = 1.92
    sigma_k: float = 1.0
    sigma_eps: float = 1.3
    eta0: float = 4.38          # RNG
    beta_rng: float = 0.012     # RNG
    Pr_t: float = 0.85
    Sc_t: float = 0.7
    k_min: float = 1e-10
    eps_min: float = 1e-12
    wall_fns: Any = None        # WallFunctions

    @staticmethod
    def rng(**kw):
        """RNG k-epsilon with its published constants."""
        return KEpsilon(variant="RNG", Cmu=0.0845, C1=1.42, C2=1.68,
                        sigma_k=0.71942, sigma_eps=0.71942, **kw)

    def mu_t_from(self, rho, k, eps):
        return rho * self.Cmu * k * k / torch.clamp(eps, min=self.eps_min)

    def k_eps(self, turb):
        """(k, epsilon) of the transported pair."""
        return turb[0], turb[1]

    def initial_fields(self, shape, dtype, k0: float = 1e-3,
                       eps0: float = 1e-2, device=None):
        return (torch.full(shape, k0, dtype=dtype, device=device),
                torch.full(shape, eps0, dtype=dtype, device=device))

    def advance(self, k, eps, rho, rho_old, phi, U, mu, bcs_U, bcs_scalar,
                mesh: StructuredMesh, dt, tol: float = 1e-8,
                max_iter: int = 100):
        """One implicit update of (k, eps): (k, eps, mu_t)."""
        mu_t = self.mu_t_from(rho, k, eps)
        SS = _strain_sq(U, bcs_U, mesh)
        # production mu_t 2 S:S, limited to 10 rho eps (Menter clip)
        P = mu_t * 2.0 * SS
        P = torch.minimum(P, 10.0 * rho * torch.clamp(eps, min=self.eps_min))
        wf = self.wall_fns
        if wf is not None:
            # wall-layer production and log-layer eddy viscosity
            mut_w = rho * wf.nut(rho, k, mu)
            G_w = wf.production(rho, k, mu, mut_w, U, bcs_U, mesh)
            P = wf.apply_mask(G_w, P)
            mu_t = wf.apply_mask(mut_w, mu_t)

        # k: ddt + div - lap = P - rho eps, the sink implicit as Sp(rho eps/k)
        sp_k = rho * eps / torch.clamp(k, min=self.k_min)
        k_new = torch.clamp(_transport(
            rho, rho_old, k, phi,
            _diff_face(mu + mu_t / self.sigma_k, bcs_scalar, mesh), sp_k, P,
            mesh, bcs_scalar, dt, tol, max_iter), min=self.k_min)

        inv_tau = eps / torch.clamp(k_new, min=self.k_min)
        C1_eff = self.C1
        if self.variant == "RNG":
            # C1* = C1 - eta (1 - eta/eta0)/(1 + beta eta^3)
            S_mag = torch.sqrt(2.0 * SS)
            eta = S_mag * k_new / torch.clamp(eps, min=self.eps_min)
            C1_eff = self.C1 - eta * (1.0 - eta / self.eta0) \
                / (1.0 + self.beta_rng * eta**3)
        eps_new = torch.clamp(_transport(
            rho, rho_old, eps, phi,
            _diff_face(mu + mu_t / self.sigma_eps, bcs_scalar, mesh),
            self.C2 * rho * inv_tau, C1_eff * P * inv_tau, mesh, bcs_scalar,
            dt, tol, max_iter), min=self.eps_min)
        mu_t_new = self.mu_t_from(rho, k_new, eps_new)
        if wf is not None:
            # epsilonWallFunction fixed value, nutk eddy viscosity
            eps_new = wf.apply_mask(wf.epsilon(k_new), eps_new)
            mu_t_new = wf.apply_mask(rho * wf.nut(rho, k_new, mu), mu_t_new)
        return k_new, eps_new, mu_t_new


@dataclasses.dataclass(frozen=True)
class KOmegaSST:
    """Menter k-omega SST (2003 form, OpenFOAM kOmegaSST constants) on the
    transported pair (k, omega). `y`: the wall distance (wall_distance on
    the solver's device); None gives the free-shear branch everywhere."""
    kind: str = "kOmegaSST"
    is_ras: bool = True
    y: Any = None
    alpha_k1: float = 0.85
    alpha_k2: float = 1.0
    alpha_w1: float = 0.5
    alpha_w2: float = 0.856
    beta1: float = 0.075
    beta2: float = 0.0828
    beta_star: float = 0.09
    gamma1: float = 5.0 / 9.0
    gamma2: float = 0.44
    a1: float = 0.31
    Pr_t: float = 0.85
    Sc_t: float = 0.7
    k_min: float = 1e-10
    w_min: float = 1e-6
    wall_fns: Any = None        # WallFunctions

    def k_eps(self, turb):
        k, w = turb
        return k, self.beta_star * k * torch.clamp(w, min=self.w_min)

    def initial_fields(self, shape, dtype, k0: float = 1e-3,
                       eps0: float = 1e-2, device=None):
        # omega = eps / (beta* k)
        w0 = eps0 / (self.beta_star * max(k0, 1e-12))
        return (torch.full(shape, k0, dtype=dtype, device=device),
                torch.full(shape, w0, dtype=dtype, device=device))

    def mu_t_from(self, rho, k, w, S_mag=None, F2=None):
        w = torch.clamp(w, min=self.w_min)
        if S_mag is None or F2 is None:
            return rho * k / w
        return rho * self.a1 * k / torch.maximum(self.a1 * w, S_mag * F2)

    def _blend(self, c1, c2, F1):
        return F1 * c1 + (1.0 - F1) * c2

    def advance(self, k, w, rho, rho_old, phi, U, mu, bcs_U, bcs_scalar,
                mesh: StructuredMesh, dt, tol: float = 1e-8,
                max_iter: int = 100):
        """One implicit update of (k, omega): (k, omega, mu_t)."""
        dtype = k.dtype
        w = torch.clamp(w, min=self.w_min)
        nu = mu / rho
        y = self.y if self.y is not None \
            else torch.full(mesh.shape, 1e10, dtype=dtype, device=k.device)
        y2 = torch.clamp(y, min=1e-10) ** 2

        SS = _strain_sq(U, bcs_U, mesh)
        S_mag = torch.sqrt(2.0 * SS)

        gk = grad(k, bcs_scalar, mesh)
        gw = grad(w, bcs_scalar, mesh)
        gkgw = sum(gk[a] * gw[a] for a in range(3))
        CDkw = torch.clamp(2.0 * rho * self.alpha_w2 / w * gkgw, min=1e-10)
        sqrt_k = torch.sqrt(torch.clamp(k, min=self.k_min))
        arg1 = torch.minimum(
            torch.maximum(sqrt_k / (self.beta_star * w * torch.sqrt(y2)),
                          500.0 * nu / (torch.sqrt(y2) ** 2 * w)),
            4.0 * rho * self.alpha_w2 * k / (CDkw * y2))
        F1 = torch.tanh(torch.clamp(arg1, max=20.0) ** 4)
        arg2 = torch.maximum(
            2.0 * sqrt_k / (self.beta_star * w * torch.sqrt(y2)),
            500.0 * nu / (y2 * w))
        F2 = torch.tanh(torch.clamp(arg2, max=20.0) ** 2)

        mu_t = self.mu_t_from(rho, k, w, S_mag, F2)
        # production, limited to 10 beta* rho k omega (Menter limiter)
        Pk = torch.minimum(mu_t * 2.0 * SS,
                           10.0 * self.beta_star * rho * k * w)
        wf = self.wall_fns
        if wf is not None:
            mut_w = rho * wf.nut(rho, k, mu)
            Pk = wf.apply_mask(wf.production(rho, k, mu, mut_w, U, bcs_U,
                                             mesh), Pk)
            mu_t = wf.apply_mask(mut_w, mu_t)

        k_new = torch.clamp(_transport(
            rho, rho_old, k, phi,
            _diff_face(mu + self._blend(self.alpha_k1, self.alpha_k2, F1)
                       * mu_t, bcs_scalar, mesh),
            self.beta_star * rho * w, Pk, mesh, bcs_scalar, dt, tol,
            max_iter), min=self.k_min)

        gamma = self._blend(self.gamma1, self.gamma2, F1)
        beta = self._blend(self.beta1, self.beta2, F1)
        # production gamma rho 2 S:S (high-Re form), limited
        Pw = gamma * rho * torch.minimum(
            2.0 * SS, 10.0 * self.beta_star * w * w / max(self.a1, 1e-3))
        cross = 2.0 * (1.0 - F1) * rho * self.alpha_w2 / w * gkgw
        w_new = torch.clamp(_transport(
            rho, rho_old, w, phi,
            _diff_face(mu + self._blend(self.alpha_w1, self.alpha_w2, F1)
                       * mu_t, bcs_scalar, mesh),
            beta * rho * w, Pw + cross, mesh, bcs_scalar, dt, tol, max_iter),
            min=self.w_min)
        if wf is not None:
            # omegaWallFunction blended fixed value
            w_new = wf.apply_mask(wf.omega(rho, k_new, mu, self.beta1), w_new)
        mu_t_new = self.mu_t_from(rho, k_new, w_new, S_mag, F2)
        if wf is not None:
            mu_t_new = wf.apply_mask(rho * wf.nut(rho, k_new, mu), mu_t_new)
        return k_new, w_new, mu_t_new
