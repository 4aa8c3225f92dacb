"""Finite-volume operators over face-list connectivity.

Port of deepflame_tpu/ops/fv_facelist.py: the discrete operators of
ops/fv.py as gathers over owner/neighbour and ELL row sums on general meshes
(mesh/blockmesh.py, mesh/polymesh.py), and as lattice slices on meshes with
a shift plan (mesh.facelist.from_structured, graded_box), where interp,
flux and gradient run per face family and every implicit matrix is a
7-point stencil on the (nx, ny, nz) lattice (`FvMatrixFL.plan_stencil`,
applied by `apply_stencil_lattice`: the `stencil7_apply` kernel on the
card, its plain roll form on the CPU). Equations are kept per unit volume
(row_c = (1/V_c) sum_f ...), as on the structured backend.

Layouts. Explicit operators take fields cell-index first with any trailing
batch, x (n_cells, ...) -> (nf, ...) or (n_cells, ..., 3), as the JAX
package does. The implicit matrix FvMatrixFL is batched over LEADING
dimensions: diag_c and source (..., n_cells), lower and upper (..., nf); its
builders take per-field inputs (x_now, x_old, gamma_f, per-patch gamma_b) of
that shape, so one batched Krylov solve covers a group of species or the
three velocity components (the JAX package vmaps the scalar solve).
Boundary patch terms are segment sums over the patch owners, an index_add
into zeros added afterwards, as the JAX package's segment_sum.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..mesh.facelist import (FaceListMesh, _fam_slice, _lat_index,
                             _lattice_shape, _plan_segments)
from .kernels import ell_matvec, stencil7_apply

__all__ = ["FvMatrixFL", "apply_stencil_lattice", "lattice_operands",
           "interpolate_fl", "flux_normal_fl", "sngrad_fl",
           "grad_fl", "grad_multi_fl", "div_flux_fl", "flux_of_fl",
           "fvm_ddt_fl", "fvm_div_fl", "fvm_laplacian_fl",
           "fvm_laplacian_corrected_fl", "fvm_source_implicit_fl",
           "laplacian_explicit_fl", "face_grad_fl",
           "laplacian_nonortho_corr_fl", "interpolate_skew_fl"]


# ------------------------------------------------------------- explicit ops

def _fcol(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-face (nf,) coefficient against batched (nf, ...)."""
    return a.reshape(a.shape + (1,) * (x.dim() - 1))


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int,
                 dim: int = 0) -> torch.Tensor:
    """Sum of `vals` into n slots by `idx` along `dim` (0: index first;
    -1: batch-leading)."""
    shape = list(vals.shape)
    shape[dim] = n
    return torch.zeros(shape, dtype=vals.dtype,
                       device=vals.device).index_add_(dim, idx, vals)


def interpolate_fl(m: FaceListMesh, x: torch.Tensor) -> torch.Tensor:
    """Linear owner/neighbour face interpolation on interior faces:
    x (n_cells, ...) -> (nf, ...); per face family on plan meshes."""
    x = m.exchange(x)
    if m.plan is not None:
        return m.plan_interp(x)
    w = _fcol(m.weights, x)
    return w * m.gather_own(x) + (1.0 - w) * m.gather_nei(x)


def flux_normal_fl(m: FaceListMesh, q: torch.Tensor) -> torch.Tensor:
    """Interior face-normal component (q_f . n_f) of a cell vector field
    q (n, 3): on plan meshes the axis component per family (normals are
    +e_ax)."""
    q = m.exchange(q)
    if m.plan is not None:
        return m.plan_flux_normal(q)
    uf = interpolate_fl(m, q)
    return (uf * m.normal).sum(1)


def sngrad_fl(m: FaceListMesh, x: torch.Tensor) -> torch.Tensor:
    """Face-normal gradient (x_nei - x_own)/|d| on interior faces."""
    x = m.exchange(x)
    return (m.gather_nei(x) - m.gather_own(x)) / _fcol(m.delta, x)


def _boundary_face_value(p, x):
    """Face value on a boundary patch: (owner + ghost)/2 with the affine
    ghost, x (n_cells, ...) -> (nb, ...)."""
    xo = x[p.owner]
    ghost = _fcol(p.a, xo) * xo + _fcol(p.b, xo)
    return 0.5 * (xo + ghost)


def _boundary_sngrad(p, x):
    xo = x[p.owner]
    ghost = _fcol(p.a, xo) * xo + _fcol(p.b, xo)
    return (ghost - xo) / _fcol(p.delta, xo)


def flux_of_fl(m: FaceListMesh, u_cell: torch.Tensor,
               patches_u=None) -> tuple[torch.Tensor, list]:
    """Face-normal flux density phi_f = (u_f . n_f) of a cell vector field
    u_cell (n, 3): (interior phi (nf,), per-patch phi list). patches_u:
    optional per-component patch lists of the vector BCs; without them the
    boundary takes the owner value (zeroGradient)."""
    phi = (interpolate_fl(m, u_cell) * m.normal).sum(1)
    phi_b = []
    for ip, p in enumerate(m.patches):
        if p.kind in ("symmetry", "wedge", "empty"):
            # exact reflection: the face value u - (u.n)n has zero normal flux
            phi_b.append(torch.zeros_like(p.mag_sf))
            continue
        if patches_u is not None:
            ub = torch.stack([_boundary_face_value(patches_u[c][ip],
                                                   u_cell[:, c])
                              for c in range(3)], dim=1)
        else:
            ub = u_cell[p.owner]
        phi_b.append((ub * p.normal).sum(1))
    return phi, phi_b


def div_flux_fl(m: FaceListMesh, phi: torch.Tensor, phi_b=None) -> torch.Tensor:
    """(1/V) sum_f phi_f magSf with outward orientation per cell."""
    out = m.scatter_faces(phi * m.mag_sf)
    if phi_b is not None:
        for p, fb in zip(m.patches, phi_b):
            out = out + _segment_sum(fb * p.mag_sf, p.owner, m.n_cells)
    return m.exchange(out / m.volumes)


def _grad_interior(m: FaceListMesh, x: torch.Tensor) -> torch.Tensor:
    if m.plan is not None:
        return m.plan_grad_interior(m.exchange(x))           # (n, ..., 3)
    xf = interpolate_fl(m, x)                                # (nf, ...)
    sf_vec = m.mag_sf[:, None] * m.normal                    # (nf, 3)
    face_vec = xf[..., None] * sf_vec.reshape(
        (sf_vec.shape[0],) + (1,) * (xf.dim() - 1) + (3,))
    return m.scatter_faces(face_vec)                         # (n, ..., 3)


def grad_fl(m: FaceListMesh, x: torch.Tensor) -> torch.Tensor:
    """Gauss-linear cell gradient: x (n_cells,) -> (n_cells, 3), or batched
    x (n_cells, k) -> (n_cells, k, 3) through one gather and scatter."""
    out = _grad_interior(m, x)
    for p in m.patches:
        fb = _boundary_face_value(p, x) * _fcol(p.mag_sf, x[p.owner])
        fbv = fb[..., None] * p.normal.reshape(
            (p.normal.shape[0],) + (1,) * (fb.dim() - 1) + (3,))
        out = out + _segment_sum(fbv, p.owner, m.n_cells)
    return m.exchange(out / m.volumes.reshape(
        (m.volumes.shape[0],) + (1,) * (out.dim() - 1)))


def grad_multi_fl(meshes, X: torch.Tensor) -> torch.Tensor:
    """Gauss-linear gradient of k fields X (n_cells, k) that share interior
    geometry but carry different boundary coefficients (one FaceListMesh per
    column, e.g. the velocity components'): (n, k, 3). The interior work is
    one batched gather and scatter (per face family on plan meshes); the
    patch a/b are stacked by column."""
    m = meshes[0]
    Xe = m.exchange(X)
    if m.plan is not None:
        out = m.plan_grad_interior(Xe)                       # (n, k, 3)
    else:
        w = m.weights[:, None]
        xf = w * m.gather_own(Xe) + (1.0 - w) * m.gather_nei(Xe)  # (nf, k)
        sf_vec = m.mag_sf[:, None] * m.normal                # (nf, 3)
        face_vec = xf[:, :, None] * sf_vec[:, None, :]       # (nf, k, 3)
        out = m.scatter_faces(face_vec)                      # (n, k, 3)
    for ip in range(len(m.patches)):
        ps = [mm.patches[ip] for mm in meshes]
        p0 = ps[0]
        xo = X[p0.owner]                                     # (nb, k)
        a = torch.stack([p.a for p in ps], dim=1)
        b = torch.stack([p.b for p in ps], dim=1)
        fb = (0.5 * (xo + a * xo + b)) * p0.mag_sf[:, None]  # (nb, k)
        fbv = fb[:, :, None] * p0.normal[:, None, :]
        out = out + _segment_sum(fbv, p0.owner, m.n_cells)
    return m.exchange(out / m.volumes[:, None, None])


def laplacian_explicit_fl(m: FaceListMesh, gamma_f: torch.Tensor,
                          x: torch.Tensor, gamma_b=None) -> torch.Tensor:
    """(1/V) sum_f gamma_f magSf snGrad(x), explicit."""
    x = m.exchange(x)
    sng = (m.gather_nei(x) - m.gather_own(x)) / m.delta
    out = m.scatter_faces(gamma_f * sng * m.mag_sf)
    for ip, p in enumerate(m.patches):
        gb = gamma_b[ip] if gamma_b is not None else 1.0
        out = out + _segment_sum(gb * _boundary_sngrad(p, x) * p.mag_sf,
                                 p.owner, m.n_cells)
    return out / m.volumes


def face_grad_fl(m: FaceListMesh, x: torch.Tensor,
                 grad: torch.Tensor | None = None) -> torch.Tensor:
    """Face-interpolated cell gradient (nf, ..., 3). Pass a grad_fl result to
    share one Gauss gradient across several corrections."""
    if grad is None:
        grad = grad_fl(m, x)
    g, gn = m.gather_own(grad), m.gather_nei(grad)
    w = _fcol(m.weights, g)
    return w * g + (1.0 - w) * gn


def _has_nonortho(m: FaceListMesh) -> bool:
    return m.k_no is not None or any(p.k_no is not None for p in m.patches)


def laplacian_nonortho_corr_fl(m: FaceListMesh, gamma_f: torch.Tensor,
                               x: torch.Tensor,
                               grad: torch.Tensor | None = None,
                               gamma_b=None) -> torch.Tensor:
    """Explicit cross-diffusion correction of laplacian(gamma, x) on
    non-orthogonal meshes (OpenFOAM `Gauss linear corrected`): k_no .
    grad_f(x) per face with the deferred field, plus the patches' own k_no
    on value-type BCs; per unit volume, to add to a source. Zero and free on
    orthogonal meshes.

    x (n,) with gamma_f (nf,), or batch-leading x (..., n) with gamma_f
    (..., nf) and per-patch gamma_b (..., nb); `grad` then is grad_fl of x
    moved index-first, (n, ..., 3)."""
    if not _has_nonortho(m):
        return torch.zeros_like(x)
    xt = x.movedim(-1, 0)
    if grad is None:
        grad = grad_fl(m, xt)
    out = torch.zeros_like(x)
    if m.k_no is not None:
        gf = face_grad_fl(m, xt, grad)                       # (nf, ..., 3)
        k = m.k_no.reshape((m.n_faces,) + (1,) * (gf.dim() - 2) + (3,))
        corr = gamma_f * (k * gf).sum(-1).movedim(0, -1)     # (..., nf)
        out = out + m.scatter_faces(corr, lead=True)
    for ip, p in enumerate(m.patches):
        if p.k_no is None:
            continue
        gb = gamma_b[ip] if gamma_b is not None else 1.0
        go = grad[p.owner]
        k = p.k_no.reshape((p.k_no.shape[0],) + (1,) * (go.dim() - 2) + (3,))
        corr_b = gb * (k * go).sum(-1).movedim(0, -1)        # (..., nb)
        out = out + _segment_sum(corr_b, p.owner, m.n_cells, dim=-1)
    return out / m.volumes


def interpolate_skew_fl(m: FaceListMesh, x: torch.Tensor,
                        grad: torch.Tensor | None = None) -> torch.Tensor:
    """skewCorrected linear face interpolation: the linear blend plus
    skew . grad_f(x), which moves the value to the face centroid. Plain
    linear on skew-free meshes."""
    xf = interpolate_fl(m, x)
    if m.skew is None:
        return xf
    return xf + (m.skew * face_grad_fl(m, x, grad)).sum(1)


# ------------------------------------------------------- lattice stencils

def _stencil_shape(shape, diag_lat, terms) -> tuple:
    return torch.broadcast_shapes(tuple(shape), diag_lat.shape,
                                  *(t.shape for _, U, L in terms
                                    for t in (U, L)))


def lattice_operands(shape, diag_lat, terms):
    """(D, lo, hi) of `stencil7_apply` for fields of `shape` (..., nx, ny,
    nz) from a plan stencil (diag_lat, ((ax, U, L), ...)): each operand
    broadcast to the field shape with the batch flattened to one dimension,
    contiguous, and one shared zero tensor for the axes without faces (an
    empty axis of a 2D mesh). Build them once per solve."""
    full = _stencil_shape(shape, diag_lat, terms)
    flat = full if len(full) <= 4 else (math.prod(full[:-3]),) + full[-3:]
    ex = lambda t: t.expand(full).reshape(flat).contiguous()
    zero = torch.zeros(flat, dtype=diag_lat.dtype, device=diag_lat.device)
    lo, hi = [zero] * 3, [zero] * 3
    for ax, U, L in terms:
        hi[ax] = ex(U)          # U multiplies x at +ax (roll by -1)
        lo[ax] = ex(L)
    return ex(diag_lat), lo, hi


def apply_stencil_lattice(X: torch.Tensor, diag_lat: torch.Tensor,
                          terms) -> torch.Tensor:
    """Variable-coefficient stencil matvec on the cell lattice (the
    FvMatrixFL.plan_stencil form):

        out = diag_lat X + sum_ax U_ax roll(X, -1, ax) + L_ax roll(X, +1, ax)

    The wrapped read on a non-cyclic axis meets a zero coefficient; on an
    n = 1 cyclic axis it is the cell itself, (U + L) X, as the roll gives.
    On the card this is the `stencil7_apply` kernel, whose neighbour indices
    wrap on every axis; on the CPU its plain roll form."""
    full = _stencil_shape(X.shape, diag_lat, terms)
    D, lo, hi = lattice_operands(full, diag_lat, terms)
    out = stencil7_apply(X.expand(full).reshape(D.shape).contiguous(),
                         D, lo, hi)
    return out.reshape(full)


# ----------------------------------------------------- implicit (FvMatrixFL)

@dataclasses.dataclass(frozen=True)
class FvMatrixFL:
    """LDU-coefficient implicit FV equation over a FaceListMesh, batched
    over leading dimensions:

    A(x)[c] = diag[c] x[c] + (1/V_c)(sum_{f: own=c} upper[f] x[nei_f]
                                     + sum_{f: nei=c} lower[f] x[own_f])

    Boundary (affine-ghost) contributions are folded into diag and source.
    lower/upper are raw face coefficients times face area (OpenFOAM's
    lduMatrix layout); the 1/V row scaling happens at apply time."""
    mesh: FaceListMesh
    diag_c: torch.Tensor    # (..., n_cells) includes V-scaled cell terms
    lower: torch.Tensor     # (..., nf) coefficient of x[owner] in nei row
    upper: torch.Tensor     # (..., nf) coefficient of x[nei] in owner row
    source: torch.Tensor    # (..., n_cells) explicit RHS, per unit volume

    def __add__(self, other: "FvMatrixFL") -> "FvMatrixFL":
        return FvMatrixFL(self.mesh, self.diag_c + other.diag_c,
                          self.lower + other.lower,
                          self.upper + other.upper,
                          self.source + other.source)

    def with_source(self, s) -> "FvMatrixFL":
        return FvMatrixFL(self.mesh, self.diag_c, self.lower, self.upper,
                          self.source + s)

    @staticmethod
    def stack(eqns) -> "FvMatrixFL":
        """One batch of equations on one mesh's interior (e.g. the velocity
        components, whose BCs differ only in the folded diag and source)."""
        def st(ts):
            shape = torch.broadcast_shapes(*(t.shape for t in ts))
            return torch.stack([t.expand(shape) for t in ts])
        return FvMatrixFL(eqns[0].mesh, st([e.diag_c for e in eqns]),
                          st([e.lower for e in eqns]),
                          st([e.upper for e in eqns]),
                          st([e.source for e in eqns]))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mesh
        if m.plan is not None:
            return self._apply_plan(x)
        x = m.exchange(x, dim=-1)
        # owner rows accumulate upper*x[nei]; neighbour rows lower*x[own]
        off = m.scatter_both(self.upper * x[..., m.neighbour],
                             self.lower * x[..., m.owner], lead=True)
        return self.diag_c * x + off / m.volumes

    def _apply_plan(self, x: torch.Tensor) -> torch.Tensor:
        """Matvec on a plan mesh through the lattice stencil form."""
        return self.operator(x.shape)(x)

    def operator(self, shape):
        """x -> A(x) for fields of `shape` (..., n_cells), with the
        coefficient preparation done once here: on plan meshes the lattice
        operands of the stencil kernel, otherwise `apply` itself."""
        m = self.mesh
        if m.plan is None:
            return self.apply
        diag_lat, terms = self.plan_stencil()
        full = _stencil_shape(tuple(shape)[:-1] + m.plan.shape, diag_lat,
                              terms)
        batch = full[:-3]
        D, lo, hi = lattice_operands(full, diag_lat, terms)

        def A(x):
            X = x.expand(batch + (m.n_cells,)).reshape(D.shape)
            return stencil7_apply(X.contiguous(), D, lo, hi).reshape(
                batch + (m.n_cells,))
        return A

    def plan_stencil(self, scale: torch.Tensor | None = None):
        """Lattice stencil coefficients (plan meshes): (diag_lat, ((ax, U,
        L), ...)) with the 1/V row scaling folded in, so that
        A(x) = apply_stencil_lattice(X, diag_lat, terms) on the lattice view
        X of x. U_ax[c] is the coefficient of the +ax neighbour in row c
        (zero on the last plane of a non-cyclic axis, the wrap face's on a
        cyclic one), L_ax that of the -ax neighbour. Leading batch
        dimensions of the coefficients carry through. `scale`: a per-cell
        row scaling (the pressure equation's V/V_mean), folded into every
        coefficient."""
        m = self.mesh
        shape = m.plan.shape
        row = (1.0 / m.volumes).reshape(shape)
        if scale is not None:
            row = row * scale.reshape(shape)
        diag_lat = self.diag_c.reshape(self.diag_c.shape[:-1] + shape)
        if scale is not None:
            diag_lat = diag_lat * scale.reshape(shape)
        acc: dict[int, tuple] = {}
        for ax, is_wrap, start, count in _plan_segments(m.plan):
            lat = _lattice_shape(shape, ax, is_wrap)
            up = self.upper[..., start:start + count]
            lo = self.lower[..., start:start + count]
            up = up.reshape(up.shape[:-1] + lat)
            lo = lo.reshape(lo.shape[:-1] + lat)
            if ax not in acc:
                batch = torch.broadcast_shapes(self.upper.shape[:-1],
                                               self.lower.shape[:-1])
                acc[ax] = tuple(torch.zeros(batch + shape,
                                            dtype=self.upper.dtype,
                                            device=self.upper.device)
                                for _ in range(2))
            U, L = acc[ax]
            U[_lat_index(ax, _fam_slice(shape[ax], is_wrap, True), True)] += up
            L[_lat_index(ax, _fam_slice(shape[ax], is_wrap, False),
                         True)] += lo
        terms = tuple((ax, U * row, L * row)
                      for ax, (U, L) in sorted(acc.items()))
        return diag_lat, terms

    def rhs(self) -> torch.Tensor:
        return self.source

    def diag(self) -> torch.Tensor:
        return self.diag_c

    def H(self, x: torch.Tensor) -> torch.Tensor:
        """OpenFOAM H operator: b - (A(x) - diag*x)."""
        return self.rhs() - (self.apply(x) - self.diag_c * x)

    def ell(self, width: int = 6, conn=None):
        """(nbr (n, w) int32, coef (n, w)) ELLPACK form of the off-diagonal:
        A(x) = diag_c*x + sum_w coef[:, w] * x[nbr[:, w]], the 1/V folded into
        coef. `conn`: a precomputed mesh.ell_connectivity() triple."""
        m = self.mesh
        face_ids, side, nbr = (conn if conn is not None
                               else m.ell_connectivity(width))
        f_safe = torch.clamp(face_ids, min=0).long()
        zero = torch.zeros((), dtype=self.upper.dtype, device=side.device)
        coef = torch.where(side > 0, self.upper[f_safe],
                           torch.where(side < 0, self.lower[f_safe], zero))
        return nbr, coef / m.volumes[:, None]

    def apply_ell(self, x: torch.Tensor, nbr: torch.Tensor,
                  coef: torch.Tensor) -> torch.Tensor:
        """Matvec through the ELL layout, equal to apply(): the ell_matvec
        kernel on the card, its plain version on the CPU."""
        return ell_matvec(self.mesh.exchange(x, dim=-1), self.diag_c, nbr,
                          coef)


def _empty_matrix(m: FaceListMesh, like: torch.Tensor) -> FvMatrixFL:
    z_c = torch.zeros((m.n_cells,), dtype=like.dtype, device=like.device)
    z_f = torch.zeros((m.n_faces,), dtype=like.dtype, device=like.device)
    return FvMatrixFL(m, z_c, z_f, z_f, z_c)


def fvm_source_implicit_fl(m: FaceListMesh, coeff: torch.Tensor) -> FvMatrixFL:
    """coeff * x as an implicit diagonal term."""
    e = _empty_matrix(m, coeff)
    return dataclasses.replace(e, diag_c=e.diag_c + coeff)


def fvm_ddt_fl(m: FaceListMesh, rho: torch.Tensor, rho_old: torch.Tensor,
               x_old: torch.Tensor, dt) -> FvMatrixFL:
    """d(rho x)/dt, Euler: (rho/dt) x - (rho_old/dt) x_old."""
    e = _empty_matrix(m, rho)
    return FvMatrixFL(m, e.diag_c + rho / dt, e.lower, e.upper,
                      e.source + rho_old * x_old / dt)


def _tvd_limiter(scheme: str, r: torch.Tensor, k: float = 1.0) -> torch.Tensor:
    """Flux limiter psi(r), the structured backend's scheme table."""
    if scheme == "limitedLinear":
        return torch.clamp(2.0 * r / k, 0.0, 1.0)
    if scheme == "vanLeer":
        return (r + r.abs()) / (1.0 + r.abs())
    if scheme == "minmod":
        return torch.clamp(r, 0.0, 1.0)
    if scheme == "MUSCL":
        return torch.clamp(torch.minimum(2.0 * r, 0.5 * (r + 1.0)), 0.0, 2.0)
    if scheme == "superBee":
        return torch.maximum(torch.clamp(2.0 * r, 0.0, 1.0),
                             torch.clamp(r, max=2.0))
    if scheme == "QUICK":
        return torch.clamp(torch.minimum(2.0 * r, 0.25 * (3.0 + r)), 0.0, 2.0)
    if scheme == "vanAlbada":
        return torch.clamp((r * r + r) / (r * r + 1.0), min=0.0)
    if scheme == "OSPRE":
        return torch.clamp(1.5 * (r * r + r) / (r * r + r + 1.0), min=0.0)
    raise ValueError(f"unknown convection scheme {scheme}")


def fvm_div_fl(m: FaceListMesh, phi: torch.Tensor, bcs_phi_b,
               scheme: str = "upwind", x_now: torch.Tensor | None = None,
               limiter_k: float = 1.0) -> FvMatrixFL:
    """Implicit div(phi, x). phi: interior face-normal flux density, outward
    from the owner; bcs_phi_b: per-patch boundary flux.

    upwind and linear set the matrix coefficients; the TVD schemes
    (limitedLinear, vanLeer, minmod, MUSCL, superBee, QUICK, vanAlbada,
    OSPRE) are implicit upwind plus a deferred limited anti-diffusion from
    the current iterate `x_now` (..., n), with the unstructured ratio
    r = 2 (grad_up . d)/(x_nei - x_own) - 1. Boundary faces: outflow takes
    the owner value, inflow the ghost (a-part implicit, b-part explicit)."""
    F = phi * m.mag_sf
    tvd_src = None
    if scheme == "upwind":
        w_own_F = torch.clamp(F, min=0.0)        # coefficient of x_own
        w_nei_F = torch.clamp(F, max=0.0)        # coefficient of x_nei
    elif scheme == "linear":
        w = m.weights
        w_own_F = w * F
        w_nei_F = (1.0 - w) * F
    else:
        if x_now is None:
            raise ValueError(f"scheme '{scheme}' needs the current iterate "
                             "x_now for the deferred limiter")
        w_own_F = torch.clamp(F, min=0.0)
        w_nei_F = torch.clamp(F, max=0.0)
        xt = m.exchange(x_now.movedim(-1, 0))                # (n, ...)
        g = grad_fl(m, xt)                                   # (n, ..., 3)
        d_vec = m.gather_nei(m.centers) - m.gather_own(m.centers)
        xo, xn = m.gather_own(xt), m.gather_nei(xt)          # (nf, ...)
        Fc = _fcol(F, xo)
        g_own = m.gather_own(g)                              # (nf, ..., 3)
        g_up = torch.where(_fcol(F >= 0, g_own), g_own, m.gather_nei(g))
        g_up_d = (g_up * d_vec.reshape((m.n_faces,) + (1,) * (g.dim() - 2)
                                       + (3,))).sum(-1)
        dx = xn - xo
        eps = torch.finfo(xt.dtype).eps
        safe = torch.where(dx.abs() > eps, dx, torch.full_like(dx, eps))
        r = 2.0 * g_up_d / safe - 1.0
        lim = _tvd_limiter(scheme, r, limiter_k)
        up = torch.where(Fc >= 0, xo, xn)
        wc = _fcol(m.weights, xo)
        central = wc * xo + (1.0 - wc) * xn
        tvd_src = (m.scatter_faces(Fc * lim * (central - up))
                   / _fcol(m.volumes, xt)).movedim(0, -1)
    inv_v = 1.0 / m.volumes
    diag = m.scatter_both(w_own_F, -w_nei_F)
    upper = w_nei_F               # owner row, x_nei coefficient
    lower = -w_own_F              # neighbour row, x_own coefficient
    src = torch.zeros_like(m.volumes)
    for p, phi_b in zip(m.patches, bcs_phi_b):
        Fb = phi_b * p.mag_sf
        if scheme != "linear":        # upwind + TVD: first-order boundary
            out_mask = Fb >= 0.0
            coeff_own = torch.where(out_mask, Fb, Fb * p.a)
            src_b = torch.where(out_mask, 0.0, Fb * p.b)
        else:
            coeff_own = Fb * 0.5 * (1.0 + p.a)
            src_b = Fb * 0.5 * p.b
        diag = diag + _segment_sum(coeff_own, p.owner, m.n_cells)
        src = src - _segment_sum(src_b, p.owner, m.n_cells)
    out = FvMatrixFL(m, diag * inv_v, lower, upper, src * inv_v)
    if tvd_src is not None:
        out = out.with_source(-tvd_src)
    return out


def fvm_laplacian_fl(m: FaceListMesh, gamma_f: torch.Tensor, gamma_b,
                     sign: float = 1.0) -> FvMatrixFL:
    """sign * laplacian(gamma, x) = sign (1/V) sum_f gamma_f magSf
    (x_nei - x_own)/delta. gamma_f: interior-face diffusivity (..., nf);
    gamma_b: per-patch boundary diffusivities (..., nb) or scalars, or None
    for 1."""
    g = sign * gamma_f * m.mag_sf / m.delta
    inv_v = 1.0 / m.volumes
    diag = -m.scatter_both(g, g, lead=True)
    src = torch.zeros_like(diag)
    for ip, p in enumerate(m.patches):
        gb = gamma_b[ip] if gamma_b is not None else 1.0
        gb = sign * gb * p.mag_sf / p.delta
        # flux into the owner = gb (ghost - x_own) = gb ((a-1) x_own + b)
        diag = diag + _segment_sum(gb * (p.a - 1.0), p.owner, m.n_cells, -1)
        src = src - _segment_sum(gb * p.b, p.owner, m.n_cells, -1)
    return FvMatrixFL(m, diag * inv_v, g, g, src * inv_v)


def fvm_laplacian_corrected_fl(m: FaceListMesh, gamma_f: torch.Tensor, gamma_b,
                               x_curr: torch.Tensor,
                               sign: float = 1.0) -> FvMatrixFL:
    """sign * laplacian(gamma, x) with the non-orthogonal cross-diffusion
    deferred against the current field (OpenFOAM `Gauss linear corrected`):
    the over-relaxed orthogonal operator implicit, -sign*corr(x_curr) as a
    source. fvm_laplacian_fl on orthogonal meshes."""
    eqn = fvm_laplacian_fl(m, gamma_f, gamma_b, sign=sign)
    if _has_nonortho(m):
        eqn = eqn.with_source(
            -sign * laplacian_nonortho_corr_fl(m, gamma_f, x_curr,
                                               gamma_b=gamma_b))
    return eqn
