"""Local time stepping (LTS): the per-cell pseudo-time-step field.

Port of deepflame_tpu/ops/lts.py (the reference's setRDeltaT): rDeltaT from
the local convective or acoustic Courant number, spatially smoothed
(fvcSmooth) and, for the convective form, rate-damped against the previous
field. The fvm_ddt operators take a per-cell dt, so LTS is dt = 1/rDeltaT.
Structured and face-list halves; the face-list sums over a cell's faces are
index_add_ scatters (`ops.fv_facelist._segment_sum`).

Two faults of the JAX module are reproduced as they are: the face-list
acoustic boundary term omits |un| (its patch faces carry c alone), and the
structured acoustic form divides the per-axis sum by 2 maxCo where the
face-list one divides the sum over all faces, which counts each axis twice:
on a uniform interior cell the face-list rDeltaT is twice the structured.
"""
from __future__ import annotations

import torch

from ..mesh.structured import StructuredMesh, pad_field
from .fv_facelist import _segment_sum

__all__ = ["smooth_field", "set_r_delta_t", "set_r_delta_t_acoustic",
           "smooth_field_fl", "set_r_delta_t_fl",
           "set_r_delta_t_acoustic_fl"]


def _shifted(P, ax: int, start: int):
    """The interior of a padded field shifted by start - 1 along axis ax."""
    idx = [slice(1, -1)] * 3
    idx[ax] = slice(start, P.shape[ax - 3] - 2 + start)
    return P[(Ellipsis, *idx)]


def smooth_field(f, bcs, mesh: StructuredMesh, n_sweeps: int = 3):
    """fvcSmooth: neighbour-averaging sweeps keeping the cell maximum."""
    for _ in range(n_sweeps):
        P = pad_field(f, bcs, mesh)
        acc = f
        cnt = 1.0
        for ax in range(3):
            if mesh.shape[ax] == 1:
                continue
            acc = acc + _shifted(P, ax, 0) + _shifted(P, ax, 2)
            cnt += 2.0
        f = torch.maximum(f, acc / cnt)
    return f


def set_r_delta_t(phi, rho, bcs_p, mesh: StructuredMesh,
                  max_co: float = 0.5, max_dt: float = 1.0,
                  r_delta_t_old=None, damping: float = 0.2,
                  n_smooth: int = 3):
    """rDeltaT [1/s] from the local convective Courant number. phi: per-axis
    face mass-flux densities [kg/m^2/s]; rho the cell density. Smoothing
    spreads small time steps into the neighbours; damping limits the rate of
    increase against the previous field (rDeltaT <= old (1 + damping))."""
    co_sum = 0.0
    for ax, h in enumerate(mesh.spacing):
        if mesh.shape[ax] == 1:
            continue
        n = phi[ax].shape[ax - 3]
        lo = phi[ax].narrow(ax - 3, 0, n - 1)
        hi = phi[ax].narrow(ax - 3, 1, n - 1)
        u_face = 0.5 * (lo.abs() + hi.abs()) / rho
        co_sum = co_sum + u_face / h
    r_dt = torch.clamp(co_sum / max_co, min=1.0 / max_dt)
    r_dt = smooth_field(r_dt, bcs_p, mesh, n_smooth)
    if r_delta_t_old is not None:
        r_dt = torch.minimum(r_dt, r_delta_t_old * (1.0 + damping))
    return r_dt


def set_r_delta_t_acoustic(U, c, bcs_p, mesh: StructuredMesh,
                           max_co: float = 0.5, max_dt: float = 1.0,
                           n_smooth: int = 3):
    """rDeltaT [1/s] from the local acoustic Courant number (the
    density-based solver's LTS): max(1/maxDeltaT, sum_ax (|u_ax| + c)/h_ax
    / (2 maxCo)). U (3, ...) velocity; c the cell sound speed."""
    r_dt = 0.0
    for ax, h in enumerate(mesh.spacing):
        if mesh.shape[ax] == 1:
            continue
        r_dt = r_dt + (U[ax].abs() + c) / h
    r_dt = torch.clamp(r_dt / (2.0 * max_co), min=1.0 / max_dt)
    return smooth_field(r_dt, bcs_p, mesh, n_smooth)


# ------------------------------------------------------- face-list backend

def _surface_sum_fl(m, face_vals, patch_vals=None):
    """Sum over each cell's faces of a per-face scalar (fvc::surfaceSum):
    interior faces into owner and neighbour, patch faces into their
    owners."""
    acc = _segment_sum(face_vals, m.owner, m.n_cells)
    acc.index_add_(0, m.neighbour, face_vals)
    if patch_vals is not None:
        for p, v in zip(m.patches, patch_vals):
            acc.index_add_(0, p.owner, v)
    return acc


def smooth_field_fl(f, m, n_sweeps: int = 3):
    """fvcSmooth on face-list connectivity: neighbour-averaging sweeps
    keeping the cell maximum."""
    deg = _surface_sum_fl(m, torch.ones_like(m.mag_sf))
    for _ in range(n_sweeps):
        nb = _segment_sum(f[m.neighbour], m.owner, m.n_cells)
        nb.index_add_(0, m.neighbour, f[m.owner])
        f = torch.maximum(f, (f + nb) / (1.0 + deg))
    return f


def set_r_delta_t_fl(m, phi, rho, phi_b=None, max_co: float = 0.5,
                     max_dt: float = 1.0, r_delta_t_old=None,
                     damping: float = 0.2, n_smooth: int = 3):
    """rDeltaT [1/s] on a FaceListMesh from the convective Courant number:
    max(1/maxDeltaT, surfaceSum(|phi| magSf)/(2 maxCo V rho)), phi the
    interior face-normal mass-flux density [kg/m^2/s], phi_b the optional
    per-patch boundary flux densities."""
    face_vals = phi.abs() * m.mag_sf
    patch_vals = None
    if phi_b is not None:
        patch_vals = [v.abs() * p.mag_sf for p, v in zip(m.patches, phi_b)]
    ssum = _surface_sum_fl(m, face_vals, patch_vals)
    r_dt = torch.clamp(ssum / (2.0 * max_co * m.volumes * rho),
                       min=1.0 / max_dt)
    r_dt = smooth_field_fl(r_dt, m, n_smooth)
    if r_delta_t_old is not None:
        r_dt = torch.minimum(r_dt, r_delta_t_old * (1.0 + damping))
    return r_dt


def set_r_delta_t_acoustic_fl(m, un, c, max_co: float = 0.5,
                              max_dt: float = 1.0, n_smooth: int = 3):
    """Acoustic-Courant rDeltaT on a FaceListMesh: amaxSf = (|un_f| + c_f)
    magSf with un the interior face-normal velocity [m/s] and c the cell
    sound speed interpolated to faces; rDeltaT = max(1/maxDeltaT,
    surfaceSum(amaxSf)/(2 maxCo V)). Patch faces carry the owner's c alone
    (no |un|, as in the JAX package)."""
    c_f = 0.5 * (c[m.owner] + c[m.neighbour])
    amax = (un.abs() + c_f) * m.mag_sf
    patch_vals = [c[p.owner] * p.mag_sf for p in m.patches]
    ssum = _surface_sum_fl(m, amax, patch_vals)
    r_dt = torch.clamp(ssum / (2.0 * max_co * m.volumes), min=1.0 / max_dt)
    return smooth_field_fl(r_dt, m, n_smooth)
