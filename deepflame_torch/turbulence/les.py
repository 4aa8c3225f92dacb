"""LES subgrid-scale turbulence models: Smagorinsky, WALE, Sigma and dynamic
Smagorinsky.

Port of deepflame_tpu/turbulence/les.py, on structured and face-list meshes
(dynamic Smagorinsky needs the structured 27-point test filter, so it runs on
structured meshes only, as in the JAX package). All models are local
tensor algebra on the velocity gradient, with the cube-root cell volume as
filter width; the solver consumes mu_t through the effective coefficients mu + mu_t, alpha + mu_t/Pr_t and
rhoD + mu_t/Sc_t. The Sigma model's singular values come from the analytic
eigenvalues of the symmetric 3x3 field g^T g, evaluated elementwise.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..mesh.structured import StructuredMesh, pad_field
from ..ops.fv import grad

__all__ = ["LESModel", "smagorinsky", "wale", "sigma_model",
           "dynamic_smagorinsky"]


@dataclasses.dataclass(frozen=True)
class LESModel:
    """SGS model selector. kind: Smagorinsky | WALE | Sigma |
    dynamicSmagorinsky. Filter width: cube-root cell volume."""
    kind: str = "Smagorinsky"
    Cs: float = 0.167
    Cw: float = 0.325
    Csigma: float = 1.5
    Pr_t: float = 0.85
    Sc_t: float = 0.7

    def sgs_k_epsilon(self, mu_t, rho, mesh: StructuredMesh):
        """SGS kinetic energy and dissipation from equilibrium scaling,
        k = (nu_t/(Ck delta))^2, eps = Ce k^1.5/delta (Ck = 0.094, Ce =
        1.048), what EDC and PaSR read as k and epsilon."""
        return _sgs_k_epsilon(mu_t, rho,
                              (mesh.dx * mesh.dy * mesh.dz) ** (1.0 / 3.0))

    def mu_t(self, rho, U, bcs_U, mesh: StructuredMesh):
        delta = (mesh.dx * mesh.dy * mesh.dz) ** (1.0 / 3.0)
        g = _grad_U(U, bcs_U, mesh)
        if self.kind == "dynamicSmagorinsky":
            return rho * _dyn_smag_nut(g, U, bcs_U, mesh, delta)
        return rho * self._nut_from_grad(g, delta)

    def _nut_from_grad(self, g, delta):
        """SGS viscosity from a velocity gradient g (3, 3, ...), g[i, j] =
        dU_i/dx_j; delta a number or a per-cell tensor."""
        if self.kind == "Smagorinsky":
            return _smag_nut(g, self.Cs, delta)
        if self.kind == "WALE":
            return _wale_nut(g, self.Cw, delta)
        if self.kind == "Sigma":
            return _sigma_nut(g, self.Csigma, delta)
        raise ValueError(self.kind)

    # ------------------------------------------------- face-list backend
    def mu_t_fl(self, rho, U, m_U, volumes):
        """SGS viscosity on a FaceListMesh: the Gauss cell gradient of the
        velocity components (grad_multi_fl with their BC meshes m_U) and
        delta = V^(1/3) per cell. U (n, 3) -> (n,)."""
        from ..ops.fv_facelist import grad_multi_fl
        if self.kind == "dynamicSmagorinsky":
            raise ValueError("dynamicSmagorinsky needs a structured test "
                             "filter; use Smagorinsky, WALE or Sigma on "
                             "face-list meshes")
        gU = grad_multi_fl(m_U, U)              # (n, 3, 3): [n, i, j]
        g = torch.movedim(gU, 0, -1)            # (3, 3, n)
        return rho * self._nut_from_grad(g, volumes ** (1.0 / 3.0))

    def sgs_k_epsilon_fl(self, mu_t, rho, volumes):
        """sgs_k_epsilon with the per-cell delta of a face-list mesh."""
        return _sgs_k_epsilon(mu_t, rho, volumes ** (1.0 / 3.0))


def _sgs_k_epsilon(mu_t, rho, delta):
    Ck, Ce = 0.094, 1.048
    k = (mu_t / rho / (Ck * delta)) ** 2
    return k, Ce * k ** 1.5 / delta


def smagorinsky(**kw) -> LESModel:
    return LESModel(kind="Smagorinsky", **kw)


def wale(**kw) -> LESModel:
    return LESModel(kind="WALE", **kw)


def sigma_model(**kw) -> LESModel:
    return LESModel(kind="Sigma", **kw)


def dynamic_smagorinsky(**kw) -> LESModel:
    return LESModel(kind="dynamicSmagorinsky", **kw)


def _grad_U(U, bcs_U, mesh):
    """g[i, j] = dU_i/dx_j, (3, 3, nx, ny, nz)."""
    return torch.stack([grad(U[c], bcs_U[c], mesh) for c in range(3)])


def _strain(g):
    return 0.5 * (g + g.transpose(0, 1))


def _smag_nut(g, Cs, delta):
    S = _strain(g)
    magS = torch.sqrt(2.0 * (S * S).sum((0, 1)))
    return (Cs * delta) ** 2 * magS


def _wale_nut(g, Cw, delta):
    S = _strain(g)
    g2 = torch.einsum("ik...,kj...->ij...", g, g)
    tr = g2[0, 0] + g2[1, 1] + g2[2, 2]
    eye = torch.eye(3, dtype=g.dtype, device=g.device).reshape(
        3, 3, *([1] * (g.dim() - 2)))
    Sd = 0.5 * (g2 + g2.transpose(0, 1)) - eye * tr / 3.0
    SS = (S * S).sum((0, 1))
    SdSd = (Sd * Sd).sum((0, 1))
    return (Cw * delta) ** 2 * SdSd ** 1.5 / (SS ** 2.5 + SdSd ** 1.25 + 1e-30)


def _sigma_nut(g, Csig, delta):
    """Sigma model (Nicoud et al. 2011): D = s3 (s1 - s2)(s2 - s3) / s1^2,
    s_i the singular values of grad U = sqrt(eigenvalues of g^T g)."""
    def comp(i, j):
        return g[0, i] * g[0, j] + g[1, i] * g[1, j] + g[2, i] * g[2, j]

    l1, l2, l3 = _eig3_sym_comps(comp(0, 0), comp(1, 1), comp(2, 2),
                                 comp(0, 1), comp(0, 2), comp(1, 2))
    s1 = torch.sqrt(torch.clamp(l1, min=0.0))
    s2 = torch.sqrt(torch.clamp(l2, min=0.0))
    s3 = torch.sqrt(torch.clamp(l3, min=0.0))
    D = s3 * (s1 - s2) * (s2 - s3) / torch.clamp(s1 * s1, min=1e-30)
    return (Csig * delta) ** 2 * torch.clamp(D, min=0.0)


def _eig3_sym(A):
    """Analytic eigenvalues of a symmetric 3x3 field A (3, 3, ...),
    descending."""
    return _eig3_sym_comps(A[0, 0], A[1, 1], A[2, 2], A[0, 1], A[0, 2], A[1, 2])


def _eig3_sym_comps(a00, a11, a22, a01, a02, a12):
    """Eigenvalues from the 6 unique symmetric components (trigonometric
    method, elementwise)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    # a floor representable in the dtype: A = q I gives p2 = 0
    floor = 1e-60 if a00.dtype == torch.float64 else 1e-30
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=floor))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return e1, e2, e3


def _box_filter(f, bcs, mesh):
    """Top-hat test filter: the 27-point trapezoidal local average (weight
    1/2 per off-centre offset along each axis)."""
    P = pad_field(f, bcs, mesh)
    out, w_tot = 0.0, 0.0
    nx, ny, nz = f.shape[-3:]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                w = ((0.5 if di else 1.0) * (0.5 if dj else 1.0)
                     * (0.5 if dk else 1.0))
                out = out + w * P[..., 1 + di:nx + 1 + di, 1 + dj:ny + 1 + dj,
                                  1 + dk:nz + 1 + dk]
                w_tot += w
    return out / w_tot


def _dyn_smag_nut(g, U, bcs_U, mesh, delta):
    """Dynamic Smagorinsky (Germano-Lilly): Cs^2 = <L:M> / <M:M> with the
    test filter's local average, clipped to [0, 0.09]; every field is
    filtered with velocity component 0's BCs, as in the JAX package."""
    S = _strain(g)
    magS = torch.sqrt(2.0 * (S * S).sum((0, 1)))
    filt = lambda f: _box_filter(f, bcs_U[0], mesh)
    U_f = torch.stack([filt(U[c]) for c in range(3)])
    S_f = _strain(_grad_U(U_f, bcs_U, mesh))
    magS_f = torch.sqrt(2.0 * (S_f * S_f).sum((0, 1)))
    alpha = 2.0   # test-to-grid filter width ratio
    L = torch.stack([torch.stack([filt(U[i] * U[j]) - U_f[i] * U_f[j]
                                  for j in range(3)]) for i in range(3)])
    M = torch.stack([torch.stack([
        filt(magS * S[i, j]) - alpha ** 2 * magS_f * S_f[i, j]
        for j in range(3)]) for i in range(3)])
    M = 2.0 * delta ** 2 * M
    LM = filt((L * M).sum((0, 1)))
    MM = filt((M * M).sum((0, 1)))
    Cs2 = torch.clamp(LM / torch.clamp(MM, min=1e-30), 0.0, 0.09)
    return Cs2 * delta ** 2 * magS
