"""Derived-field function objects (Q, vorticity, MachNo, yPlus, ...).

Port of deepflame_tpu/runtime/derived.py: tensor math on the device, built
on `ops.fv.grad`, evaluated at write time. The storage objects live in
function_objects.py; `DerivedFields` merges derived fields into the field
dict that they read.
"""
from __future__ import annotations

import math

import torch

from ..constants import GAS_CONSTANT
from ..mesh.structured import StructuredMesh
from ..ops.fv import grad

__all__ = ["vorticity", "q_criterion", "enstrophy", "mach_number",
           "y_plus", "wall_heat_flux", "DerivedFields",
           "courant_no", "peclet_no", "lambda2", "wall_shear_stress",
           "turbulence_intensity", "flow_type", "stream_function_2d",
           "wall_heat_transfer_coeff"]


def _grad_U(U, bcs_U, mesh):
    """g[c][ax] = dU_c/dx_ax."""
    return [grad(U[c], bcs_U[c], mesh) for c in range(3)]


def _sym_skew_sq(g):
    """(|S|^2, |Omega|^2) of the velocity gradient g."""
    SS = 0.0
    WW = 0.0
    for i in range(3):
        for j in range(3):
            s = 0.5 * (g[i][j] + g[j][i])
            w = 0.5 * (g[i][j] - g[j][i])
            SS = SS + s * s
            WW = WW + w * w
    return SS, WW


def _wall_layer(mesh: StructuredMesh, wall):
    """Index of the cell layer next to the wall plane (axis, side)."""
    ax, side = wall
    sl = [slice(None)] * 3
    sl[ax] = 0 if side == 0 else mesh.shape[ax] - 1
    return tuple(sl)


def vorticity(U, bcs_U, mesh: StructuredMesh):
    """curl(U) (3, ...): the `vorticity` function object."""
    g = _grad_U(U, bcs_U, mesh)
    return torch.stack([g[2][1] - g[1][2], g[0][2] - g[2][0],
                        g[1][0] - g[0][1]])


def enstrophy(U, bcs_U, mesh: StructuredMesh):
    w = vorticity(U, bcs_U, mesh)
    return 0.5 * (w * w).sum(0)


def q_criterion(U, bcs_U, mesh: StructuredMesh):
    """Q = 0.5 (|Omega|^2 - |S|^2): the `Q` function object."""
    SS, WW = _sym_skew_sq(_grad_U(U, bcs_U, mesh))
    return 0.5 * (WW - SS)


def mach_number(U, T, Y_t, thermo):
    """|U| / c with c = sqrt(gamma R T / W): the `MachNo` function object.
    Y_t species last (..., ns)."""
    cp = thermo.cp_mass(T, Y_t)
    R = GAS_CONSTANT / thermo.W_mix(Y_t)
    gamma = cp / (cp - R)
    c = torch.sqrt(gamma * R * T)
    return torch.sqrt((U * U).sum(0)) / c


def y_plus(U, rho, mu, mesh: StructuredMesh, wall):
    """y+ of the wall-adjacent cell layer of the no-slip wall plane
    `wall=(axis, side)`: the `yPlus` function object (a 2D layer field),
    tau_w from the one-sided tangential-velocity gradient."""
    ax = wall[0]
    h = mesh.spacing[ax]
    sl = _wall_layer(mesh, wall)
    ut2 = 0.0
    for c in range(3):
        if c != ax:
            ut2 = ut2 + U[c][sl] ** 2
    ut = torch.sqrt(ut2)
    mu_w, rho_w = mu[sl], rho[sl]
    tau_w = mu_w * ut / (0.5 * h)
    u_tau = torch.sqrt(tau_w / rho_w)
    return rho_w * u_tau * (0.5 * h) / mu_w


def wall_heat_flux(T, alpha_rho_cp, mesh: StructuredMesh, wall, T_wall):
    """q_w = kappa dT/dn at the wall plane (wallHeatFlux); alpha_rho_cp:
    the thermal conductivity kappa [W/m/K]."""
    h = mesh.spacing[wall[0]]
    sl = _wall_layer(mesh, wall)
    return alpha_rho_cp[sl] * (T[sl] - T_wall) / (0.5 * h)


def courant_no(U, dt, mesh: StructuredMesh):
    """Per-cell Courant number (CourantNo)."""
    co = 0.0
    for ax, h in enumerate(mesh.spacing):
        if mesh.shape[ax] > 1:
            co = co + U[ax].abs() / h
    return co * dt


def peclet_no(U, rho, gamma, mesh: StructuredMesh):
    """Per-cell Peclet number |U| h rho / gamma (PecletNo; gamma the
    diffusivity, for example mu_eff)."""
    h = min(hh for ax, hh in enumerate(mesh.spacing) if mesh.shape[ax] > 1)
    return torch.sqrt((U * U).sum(0)) * h * rho / torch.clamp(gamma, min=1e-300)


def lambda2(U, bcs_U, mesh: StructuredMesh):
    """Lambda2 vortex criterion: the middle eigenvalue of S^2 + Omega^2,
    from the closed-form trigonometric eigenvalues of a symmetric 3x3.
    Where S^2 + Omega^2 has no deviatoric part (p^3 is 0, for example a
    uniform velocity in float32) its eigenvalues are all q: the JAX
    function divides 0 by 0 there and returns NaN, the port returns q."""
    g = _grad_U(U, bcs_U, mesh)
    S = [[0.5 * (g[i][j] + g[j][i]) for j in range(3)] for i in range(3)]
    W = [[0.5 * (g[i][j] - g[j][i]) for j in range(3)] for i in range(3)]
    A = [[sum(S[i][k] * S[k][j] + W[i][k] * W[k][j] for k in range(3))
          for j in range(3)] for i in range(3)]
    q = (A[0][0] + A[1][1] + A[2][2]) / 3.0
    B = [[A[i][j] - (q if i == j else 0.0) for j in range(3)]
         for i in range(3)]
    p2 = sum(B[i][j] ** 2 for i in range(3) for j in range(3)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-300))
    detB = (B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1])
            - B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0])
            + B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]))
    p3 = 2.0 * p ** 3
    r = torch.clamp(torch.where(p3 > 0.0, detB, torch.zeros_like(detB))
                    / torch.where(p3 > 0.0, p3, torch.ones_like(p3)),
                    -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # on [0, pi/3] the middle eigenvalue is the phi + 4 pi/3 branch
    return q + 2.0 * p * torch.cos(phi + 4.0 * math.pi / 3.0)


def wall_shear_stress(U, rho, mu, mesh: StructuredMesh, wall):
    """tau_w (the two tangential components) on the wall plane `(axis,
    side)` (wallShearStress) from the one-sided gradient, no-slip wall."""
    ax = wall[0]
    h = mesh.spacing[ax]
    sl = _wall_layer(mesh, wall)
    return torch.stack([mu[sl] * U[c][sl] / (0.5 * h)
                        for c in range(3) if c != ax])


def wall_heat_transfer_coeff(T, kappa, mesh: StructuredMesh, wall, T_wall,
                             T_ref):
    """h = q_w / (T_wall - T_ref) (wallHeatTransferCoeff)."""
    q_w = wall_heat_flux(T, kappa, mesh, wall, T_wall)
    d = torch.as_tensor(T_wall - T_ref, dtype=q_w.dtype, device=q_w.device)
    return q_w / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))


def turbulence_intensity(U, k):
    """I = sqrt(2k/3) / |U| (turbulenceIntensity)."""
    umag = torch.sqrt((U * U).sum(0))
    return torch.sqrt(torch.clamp(2.0 * k / 3.0, min=0.0)) \
        / torch.clamp(umag, min=1e-300)


def flow_type(U, bcs_U, mesh: StructuredMesh):
    """flowType: (|D| - |Omega|)/(|D| + |Omega|) + 1 in [0, 2]; 0
    rotational, 1 simple shear, 2 planar extensional."""
    DD, WW = _sym_skew_sq(_grad_U(U, bcs_U, mesh))
    magD = torch.sqrt(DD)
    magW = torch.sqrt(WW)
    return (magD - magW) / torch.clamp(magD + magW, min=1e-300) + 1.0


def stream_function_2d(phi_x, phi_y, mesh: StructuredMesh):
    """2D stream function on the cell corners (nx + 1, ny + 1) from the face
    fluxes of a single-layer z mesh (streamFunction): integrated up the
    left edge with the x-flux of column 0, then along +x with minus the
    y-flux. phi_x (nx + 1, ny, 1), phi_y (nx, ny + 1, 1)."""
    fx = phi_x[..., 0]
    fy = phi_y[..., 0]
    left = torch.cat([torch.zeros((1,), dtype=fx.dtype, device=fx.device),
                      torch.cumsum(fx[0, :], 0)])
    rows = torch.cat([torch.zeros((1, fy.shape[1]), dtype=fy.dtype,
                                  device=fy.device),
                      torch.cumsum(-fy, 0)], 0)
    return left[None, :] + rows


class DerivedFields:
    """Function-object adapter: computes named derived fields from the
    solver's field dict and merges them in, so that storage objects
    (Probes, FieldMinMax, ...) read "Q", "Ma", ... like any field.
    specs: dict name -> callable(fields dict) -> tensor."""

    def __init__(self, specs: dict, inner):
        self.specs = dict(specs)
        self.inner = inner

    def __call__(self, time: float, fields: dict):
        ext = dict(fields)
        for name, fn in self.specs.items():
            ext[name] = fn(ext)
        self.inner(time, ext)

    def write(self):
        if hasattr(self.inner, "write"):
            return self.inner.write()
