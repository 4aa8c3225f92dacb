"""Finite-volume operators, matrix-free, on structured blocks.

Port of deepflame_tpu/ops/fv.py. Stencils are slices of ghost-padded tensors;
implicit equations are matrix-free `FvMatrix` operators whose 7-point
coefficients are also kept analytically (`StencilPart`), so that
`FvMatrix.stencil()` gives (D, lo, hi) cell coefficients with the boundary
ghosts folded into D. The Krylov matvec is then one call of the stencil
kernel (`ops.kernels.stencil7_apply`) and diag(A) = D is exact; `diag()`
reads it there, and takes the JAX package's coloring probes only where a
term has no stencil or a side is a processor boundary: there, as in the JAX
package, `stencil()` gives None and the matrix applies through `pad_field`
(the neighbour shard's ghost planes) and its terms.

Fields are (..., nx, ny, nz): operators act on the last three dimensions, so
one FvMatrix can carry a leading batch of species or velocity components
(the JAX package maps the same code over that axis with vmap).

Convection schemes: 'upwind' (implicit), 'linear' (implicit central), and
the TVD family (implicit upwind + explicit deferred limited correction).
"""
from __future__ import annotations

import dataclasses

import torch

from ..mesh.structured import (FieldBCs, StructuredMesh, bcs_batch_shape,
                               extend_padded, pad_field)
from .kernels import stencil7_apply

__all__ = [
    "FvMatrix", "StencilPart", "face_pair", "interpolate", "interpolate_cubic",
    "grad", "flux_of", "div_flux", "div_explicit", "laplacian_explicit",
    "snGrad_boundary", "limited_face_values", "nvd_limiter",
    "multivariate_limiter", "fvm_ddt", "fvm_div", "fvm_laplacian",
    "fvm_source_implicit",
]

_TVD = ("limitedLinear", "limitedLinear01", "vanLeer", "minmod", "MUSCL",
        "superBee", "QUICK", "vanAlbada", "OSPRE")
# BC kinds whose ghost has no inhomogeneous part: b = 0, so the boundary
# source of an FvMatrix is exactly zero
_HOMOGENEOUS_KINDS = ("cyclic", "empty", "zeroGradient", "symmetry",
                      "symmetryNegate", "extrapolated")


def _homogeneous(bc) -> bool:
    """Whether the BC's ghost has no inhomogeneous part (b = 0)."""
    if bc.kind == "processor":
        return bc.value[1].kind in _HOMOGENEOUS_KINDS
    return bc.kind in _HOMOGENEOUS_KINDS


def _sl(f, axis: int, start: int, stop: int):
    return f.narrow(axis - 3, start, stop - start)


def _interior(P):
    return P[..., 1:-1, 1:-1, 1:-1]


def _trim(f, axis: int):
    """Trim ghost layers on the two spatial axes other than `axis`."""
    for ax in range(3):
        if ax != axis:
            f = _sl(f, ax, 1, f.shape[ax - 3] - 1)
    return f


def face_pair(P, axis: int):
    """Owner/neighbour cell values of all faces along `axis` from a padded
    field: (n_axis + 1) on `axis`, interior extent on the others."""
    t = _trim(P, axis)
    n = t.shape[axis - 3]
    return _sl(t, axis, 0, n - 1), _sl(t, axis, 1, n)


def _face_diff(F, axis: int):
    """(F_hi - F_lo) per cell along axis: n+1 faces -> n cells."""
    n = F.shape[axis - 3]
    return _sl(F, axis, 1, n) - _sl(F, axis, 0, n - 1)


# ---------------------------------------------------------------- explicit ops

def interpolate(P, axis: int):
    """Linear face interpolation along axis from a padded field."""
    own, nei = face_pair(P, axis)
    return 0.5 * (own + nei)


def interpolate_cubic(P, axis: int, bcs: FieldBCs):
    """4-point cubic face interpolation ((9(P+N) - (W+E))/16 on a uniform
    mesh), replicated ghost at physical boundaries."""
    own, nei = face_pair(P, axis)
    Pm, Pp = extend_padded(P, axis, bcs)
    t = _trim(Pm, axis)
    nfull = t.shape[axis - 3]
    far_own = _sl(t, axis, 0, nfull - 2)
    far_nei = _sl(_trim(Pp, axis), axis, 2, nfull)
    return (9.0 * (own + nei) - (far_own + far_nei)) / 16.0


def grad(f, bcs: FieldBCs, mesh: StructuredMesh):
    """Gauss-linear cell gradient: (3, ..., nx, ny, nz)."""
    P = pad_field(f, bcs, mesh)
    return torch.stack([_face_diff(interpolate(P, ax), ax) / h
                        for ax, h in enumerate(mesh.spacing)])


def flux_of(rho_u, bcs_u, mesh: StructuredMesh):
    """Face-normal flux density per axis from a cell vector field rho_u
    (3, nx, ny, nz) with per-component BCs: (nx+1, ny, nz), (nx, ny+1, nz),
    (nx, ny, nz+1)."""
    return tuple(interpolate(pad_field(rho_u[ax], bcs_u[ax], mesh), ax)
                 for ax in range(3))


def div_flux(phi, mesh: StructuredMesh):
    """Cell divergence of face fluxes: sum_ax (phi_hi - phi_lo)/h."""
    out = 0.0
    for ax, h in enumerate(mesh.spacing):
        out = out + _face_diff(phi[ax], ax) / h
    return out


def div_explicit(phi, psi, bcs: FieldBCs, mesh: StructuredMesh,
                 scheme: str = "linear", limiter_k: float = 1.0):
    """fvc::div(phi, psi): explicit convection divergence."""
    P = pad_field(psi, bcs, mesh)
    out = 0.0
    for ax, h in enumerate(mesh.spacing):
        fv = limited_face_values(P, phi[ax], ax, scheme, limiter_k, bcs)
        out = out + _face_diff(phi[ax] * fv, ax) / h
    return out


def _gamma_ax(gamma_f, ax: int):
    """Per-axis diffusivity: a scalar or a per-axis tuple of face arrays."""
    return gamma_f[ax] if isinstance(gamma_f, (tuple, list)) else gamma_f


def laplacian_explicit(gamma_f, f, bcs: FieldBCs, mesh: StructuredMesh):
    """fvc::laplacian(gamma, f); gamma_f: per-axis face arrays or a scalar."""
    P = pad_field(f, bcs, mesh)
    out = 0.0
    for ax, h in enumerate(mesh.spacing):
        own, nei = face_pair(P, ax)
        out = out + _face_diff(_gamma_ax(gamma_f, ax) * (nei - own) / h, ax) / h
    return out


def snGrad_boundary(f, bcs: FieldBCs, mesh: StructuredMesh):
    """Surface-normal gradients on the six boundary patches, keyed (axis,
    side), each the one face layer of that side."""
    P = pad_field(f, bcs, mesh)
    grads = {}
    for ax, h in enumerate(mesh.spacing):
        own, nei = face_pair(P, ax)
        g = (nei - own) / h
        n = g.shape[ax - 3]
        grads[(ax, 0)] = _sl(g, ax, 0, 1)
        grads[(ax, 1)] = _sl(g, ax, n - 1, n)
    return grads


# ------------------------------------------------------------ face-value schemes

def limited_face_values(P, phi_ax, axis: int, scheme: str, k: float = 1.0,
                        bcs: FieldBCs | None = None):
    """Face values of psi for convection along `axis` given the face flux
    sign: upwind, linear, or upwind + limiter * (central - upwind)."""
    own, nei = face_pair(P, axis)
    up = torch.where(phi_ax >= 0, own, nei)
    if scheme == "upwind":
        return up
    central = 0.5 * (own + nei)
    if scheme == "linear":
        return central
    lim = nvd_limiter(P, phi_ax, axis, scheme, k, bcs)
    return up + lim * (central - up)


def nvd_limiter(P, phi_ax, axis: int, scheme: str, k: float = 1.0,
                bcs: FieldBCs | None = None):
    """Per-face TVD limiter lim in psi_f = up + lim*(central - up)."""
    own, nei = face_pair(P, axis)
    central = 0.5 * (own + nei)
    up = torch.where(phi_ax >= 0, own, nei)
    if bcs is not None:
        Pm, Pp = extend_padded(P, axis, bcs)
    else:
        n = P.shape[axis - 3]
        Pm = torch.cat([_sl(P, axis, 0, 1), P], dim=axis - 3)
        Pp = torch.cat([P, _sl(P, axis, n - 1, n)], dim=axis - 3)
    t = _trim(Pm, axis)
    nfull = t.shape[axis - 3]
    far_own = _sl(t, axis, 0, nfull - 2)                 # own - 1
    far_nei = _sl(_trim(Pp, axis), axis, 2, nfull)       # nei + 1
    d = nei - own
    eps = torch.finfo(P.dtype).eps
    safe_d = torch.where(d.abs() > eps, d, torch.full_like(d, eps))
    r_pos = (own - far_own) / safe_d
    r_neg = (nei - far_nei) / (-safe_d)
    r = torch.where(phi_ax >= 0, r_pos, r_neg)
    if scheme in ("limitedLinear", "limitedLinear01"):
        lim = torch.clamp(2.0 * r / k, 0.0, 1.0)
        if scheme == "limitedLinear01":
            # keep the face value in [0, 1] (OpenFOAM Limited01)
            delta = central - up
            big = torch.full_like(delta, 1e30)
            lim_hi = torch.where(delta > eps,
                                 (1.0 - up) / torch.clamp(delta, min=eps), big)
            lim_lo = torch.where(delta < -eps,
                                 up / torch.clamp(-delta, min=eps), big)
            lim = torch.clamp(torch.minimum(lim, torch.minimum(lim_hi, lim_lo)),
                              min=0.0)
    elif scheme == "vanLeer":
        lim = (r + r.abs()) / (1.0 + r.abs())
    elif scheme == "minmod":
        lim = torch.clamp(r, 0.0, 1.0)
    elif scheme == "MUSCL":
        lim = torch.clamp(torch.minimum(torch.minimum(2.0 * r, 0.5 * (r + 1.0)),
                                        torch.full_like(r, 2.0)), min=0.0)
    elif scheme == "superBee":
        lim = torch.maximum(torch.clamp(torch.clamp(2.0 * r, max=1.0), min=0.0),
                            torch.clamp(r, max=2.0))
    elif scheme == "QUICK":
        lim = torch.clamp(torch.minimum(torch.minimum(2.0 * r, 0.25 * (3.0 + r)),
                                        torch.full_like(r, 2.0)), min=0.0)
    elif scheme == "vanAlbada":
        lim = torch.clamp((r * r + r) / (r * r + 1.0), min=0.0)
    elif scheme == "OSPRE":
        lim = torch.clamp(1.5 * (r * r + r) / (r * r + r + 1.0), min=0.0)
    else:
        raise ValueError(f"unknown convection scheme {scheme}")
    return lim


def multivariate_limiter(fields_padded, phi, mesh: StructuredMesh, bcs_list,
                         scheme: str = "limitedLinear", limiter_k: float = 1.0,
                         bounded01: tuple | None = None):
    """Shared per-face limiter of a group of convected fields: the field-wise
    min of each member's TVD limiter (OpenFOAM multivariateScheme)."""
    out = []
    for ax in range(3):
        lim = None
        for i, P in enumerate(fields_padded):
            sch = scheme
            if bounded01 is not None and bounded01[i]:
                sch = "limitedLinear01" if scheme == "limitedLinear" else sch
            li = nvd_limiter(P, phi[ax], ax, sch, limiter_k, bcs_list[i])
            lim = li if lim is None else torch.minimum(lim, li)
        out.append(torch.clamp(lim, max=1.0))
    return tuple(out)


# ------------------------------------------------------------------ FvMatrix

@dataclasses.dataclass
class StencilPart:
    """Analytic 7-point coefficients of one fvm term over interior faces:
    d the diagonal, lo[ax]/hi[ax] the coefficients of x_{i-1}/x_{i+1}
    (boundary entries still hold the raw face coefficient; stencil() folds
    them into d through the BC ghost relation)."""
    d: torch.Tensor | float = 0.0
    lo: tuple = (0.0, 0.0, 0.0)
    hi: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class FvMatrix:
    """Matrix-free implicit FV equation A(x) = b over a (batch of) cell
    field(s). terms: L(P_padded) -> cell functions, linear in the padded
    field; source: explicit RHS; parts: per-term StencilPart (None disables
    the stencil)."""
    mesh: StructuredMesh
    bcs: FieldBCs
    terms: list
    source: torch.Tensor
    parts: list | None = None

    def __add__(self, other: "FvMatrix") -> "FvMatrix":
        assert self.bcs is other.bcs or self.bcs == other.bcs
        parts = None
        if self.parts is not None and other.parts is not None:
            parts = self.parts + other.parts
        return FvMatrix(self.mesh, self.bcs, self.terms + other.terms,
                        self.source + other.source, parts)

    def __sub__(self, other: "FvMatrix") -> "FvMatrix":
        assert self.bcs is other.bcs or self.bcs == other.bcs
        neg = [(lambda P, L=L: -L(P)) for L in other.terms]
        parts = None
        if self.parts is not None and other.parts is not None:
            parts = self.parts + [
                None if p is None else
                StencilPart(d=-p.d, lo=tuple(-c for c in p.lo),
                            hi=tuple(-c for c in p.hi))
                for p in other.parts]
        return FvMatrix(self.mesh, self.bcs, self.terms + neg,
                        self.source - other.source, parts)

    def with_source(self, s) -> "FvMatrix":
        return FvMatrix(self.mesh, self.bcs, self.terms, self.source + s,
                        self.parts)

    def _shape(self) -> tuple:
        """Shape of the equation: the lanes of its source and of its BCs,
        then the mesh."""
        batch = torch.broadcast_shapes(tuple(self.source.shape[:-3]),
                                       bcs_batch_shape(self.bcs))
        return tuple(batch) + self.mesh.shape

    def stencil(self):
        """(D, lo, hi) cell coefficients with BCs folded into D, all of one
        shape (the batch shape of the equation), or None when a term has no
        stencil or a side is a processor boundary. Cyclic axes stay in
        lo/hi: the stencil wraps them exactly. A BC's ghost coefficient a
        may differ per lane (stacked BCs)."""
        if self.parts is None or any(p is None for p in self.parts):
            return None
        if any(bc.kind == "processor" for pair in self.bcs for bc in pair):
            return None
        zeros = torch.zeros(self._shape(), dtype=self.source.dtype,
                            device=self.source.device)
        D = zeros
        lo = [zeros for _ in range(3)]
        hi = [zeros for _ in range(3)]
        for p in self.parts:
            D = D + p.d
            for ax in range(3):
                lo[ax] = lo[ax] + p.lo[ax]
                hi[ax] = hi[ax] + p.hi[ax]
        D, *rest = torch.broadcast_tensors(D, *lo, *hi)
        D = D.contiguous()
        lo = [t.contiguous() for t in rest[:3]]
        hi = [t.contiguous() for t in rest[3:]]
        for ax in range(3):
            bc_lo, bc_hi = self.bcs[ax]
            if bc_lo.kind == "cyclic":
                continue
            n = self.mesh.shape[ax]
            h = self.mesh.spacing[ax]
            a_lo = bc_lo.coeffs(h, -1)[0]
            a_hi = bc_hi.coeffs(h, +1)[0]
            _sl(D, ax, 0, 1).add_(_sl(lo[ax], ax, 0, 1) * a_lo)
            _sl(D, ax, n - 1, n).add_(_sl(hi[ax], ax, n - 1, n) * a_hi)
            _sl(lo[ax], ax, 0, 1).zero_()
            _sl(hi[ax], ax, n - 1, n).zero_()
        return D, tuple(lo), tuple(hi)

    @staticmethod
    def stencil_apply(x, D, lo, hi):
        """A(x) for folded stencil coefficients (the stencil kernel)."""
        return stencil7_apply(x, D, lo, hi)

    def apply(self, x):
        P = pad_field(x, self.bcs, self.mesh, homogeneous=True)
        out = 0.0
        for L in self.terms:
            out = out + L(P)
        return out

    def rhs(self):
        """b = source - A(boundary part). With only homogeneous BC kinds the
        boundary part is exactly zero and b is the source (a processor side
        counts by its domain-edge BC: its ghost planes are zero there)."""
        if all(_homogeneous(bc) for pair in self.bcs for bc in pair):
            return self.source
        Pb = pad_field(torch.zeros(self._shape(), dtype=self.source.dtype,
                                   device=self.source.device),
                       self.bcs, self.mesh, bc_only=True)
        out = self.source
        for L in self.terms:
            out = out - L(Pb)
        return out

    def diag(self):
        """Exact diagonal of A: D of the folded stencil where every term has
        one, else the JAX package's coloring probes (cells of one color
        along every axis are never neighbours, so masked matvecs recover
        diag(A); period 2 per axis, 3 or n on an odd cyclic axis, 2 on a
        processor axis, whose local extent must then be even: the global
        parity of a cell is then its local parity on every shard)."""
        st = self.stencil()
        if st is not None:
            return st[0]
        shape = self._shape()
        periods = []
        for ax, n in enumerate(self.mesh.shape):
            if self.bcs[ax][0].kind == "processor":
                if n % 2 != 0:
                    raise ValueError("processor-split axis needs an even "
                                     f"local extent for the diagonal "
                                     f"coloring (got {n})")
                periods.append(2)
            elif self.bcs[ax][0].kind != "cyclic" or n % 2 == 0 or n == 1:
                periods.append(2 if n > 1 else 1)
            else:
                periods.append(3 if n % 3 == 0 else n)
        dev, dtype = self.source.device, self.source.dtype
        idx = torch.meshgrid(*(torch.arange(n, device=dev)
                               for n in self.mesh.shape), indexing="ij")
        d = torch.zeros(shape, dtype=dtype, device=dev)
        for ci in range(periods[0]):
            for cj in range(periods[1]):
                for ck in range(periods[2]):
                    chi = ((idx[0] % periods[0] == ci)
                           & (idx[1] % periods[1] == cj)
                           & (idx[2] % periods[2] == ck)).to(dtype)
                    d = d + self.apply(chi.expand(shape)) * chi
        return d

    def _matvec(self, x):
        """A(x): the stencil kernel where every term has a stencil."""
        st = self.stencil()
        if st is None:
            return self.apply(x)
        D, lo, hi = st
        return stencil7_apply(torch.broadcast_to(x, D.shape).contiguous(),
                              D, lo, hi)

    def H(self, x):
        """OpenFOAM's H operator: b - (A(x) - diag(A) x)."""
        return self.rhs() - (self._matvec(x) - self.diag() * x)

    def residual(self, x):
        """b - A(x)."""
        return self.rhs() - self._matvec(x)


# ----------------------------------------------------------------- fvm builders

def fvm_ddt(coeff, x_old, dt, mesh: StructuredMesh, bcs: FieldBCs,
            coeff_old=None) -> FvMatrix:
    """fvm::ddt(coeff, psi): (coeff psi - coeff_old psi_old)/dt."""
    if coeff_old is None:
        coeff_old = coeff
    c = coeff

    def L(P):
        return c * _interior(P) / dt

    src = coeff_old * x_old / dt
    return FvMatrix(mesh, bcs, [L], src, [StencilPart(d=c / dt)])


def fvm_div(phi, psi_now, mesh: StructuredMesh, bcs: FieldBCs,
            scheme: str = "upwind", limiter_k: float = 1.0,
            limiter_override=None, weight_flux=None) -> FvMatrix:
    """fvm::div(phi, psi). TVD schemes: implicit upwind plus the limited
    anti-diffusive part deferred-corrected explicitly from psi_now.
    limiter_override: shared per-axis face limiters (multivariate
    convection). weight_flux: flux whose sign selects the upwind weights when
    it differs from the convecting flux."""
    implicit_scheme = "linear" if scheme == "linear" else "upwind"
    wf = phi if weight_flux is None else weight_flux

    def L(P):
        out = 0.0
        for ax, h in enumerate(mesh.spacing):
            fv = limited_face_values(P, wf[ax], ax, implicit_scheme)
            out = out + _face_diff(phi[ax] * fv, ax) / h
        return out

    src = torch.zeros(mesh.shape, dtype=psi_now.dtype, device=psi_now.device)
    if limiter_override is not None:
        Pn = pad_field(psi_now, bcs, mesh)
        corr = 0.0
        for ax, h in enumerate(mesh.spacing):
            own, nei = face_pair(Pn, ax)
            up = torch.where(wf[ax] >= 0, own, nei)
            central = 0.5 * (own + nei)
            hi = up + limiter_override[ax] * (central - up)
            corr = corr + _face_diff(phi[ax] * (hi - up), ax) / h
        src = src - corr
    elif scheme in _TVD:
        Pn = pad_field(psi_now, bcs, mesh)
        corr = 0.0
        for ax, h in enumerate(mesh.spacing):
            hi = limited_face_values(Pn, wf[ax], ax, scheme, limiter_k, bcs)
            lo = limited_face_values(Pn, wf[ax], ax, "upwind")
            corr = corr + _face_diff(phi[ax] * (hi - lo), ax) / h
        src = src - corr
    elif scheme not in ("upwind", "linear"):
        raise ValueError(f"unknown scheme {scheme}")

    # analytic stencil of the implicit part: at cell i the contribution is
    # (phi_hi fv_hi - phi_lo fv_lo)/h with fv chosen by wf's sign
    d_s = 0.0
    lo_s, hi_s = [], []
    dtype = psi_now.dtype
    for ax, h in enumerate(mesh.spacing):
        p_f = phi[ax]
        n_f = p_f.shape[ax - 3]
        p_lo = _sl(p_f, ax, 0, n_f - 1)
        p_hi = _sl(p_f, ax, 1, n_f)
        if implicit_scheme == "linear":
            d_s = d_s + (p_hi - p_lo) / (2.0 * h)
            hi_s.append(p_hi / (2.0 * h))
            lo_s.append(-p_lo / (2.0 * h))
        else:
            w_f = wf[ax] if weight_flux is not None else p_f
            w_lo = (_sl(w_f, ax, 0, n_f - 1) >= 0).to(dtype)
            w_hi = (_sl(w_f, ax, 1, n_f) >= 0).to(dtype)
            d_s = d_s + (p_hi * w_hi - p_lo * (1.0 - w_lo)) / h
            hi_s.append(p_hi * (1.0 - w_hi) / h)
            lo_s.append(-p_lo * w_lo / h)
    part = StencilPart(d=d_s, lo=tuple(lo_s), hi=tuple(hi_s))
    return FvMatrix(mesh, bcs, [L], src, [part])


def fvm_laplacian(gamma_f, mesh: StructuredMesh, bcs: FieldBCs,
                  dtype=torch.float64, sign: float = 1.0) -> FvMatrix:
    """fvm::laplacian(gamma, psi). gamma_f: per-axis face arrays or a scalar.
    sign=-1 for '- fvm::laplacian(...)'."""
    per_axis = isinstance(gamma_f, (tuple, list))

    def L(P):
        out = 0.0
        for ax, h in enumerate(mesh.spacing):
            g = gamma_f[ax] if per_axis else gamma_f
            own, nei = face_pair(P, ax)
            out = out + _face_diff(g * (nei - own) / h, ax) / h
        return sign * out

    part = None
    if per_axis:
        d_s = 0.0
        lo_s, hi_s = [], []
        for ax, h in enumerate(mesh.spacing):
            g = gamma_f[ax]
            n_f = g.shape[ax - 3]
            g_lo = _sl(g, ax, 0, n_f - 1)
            g_hi = _sl(g, ax, 1, n_f)
            inv_h2 = sign / (h * h)
            d_s = d_s - (g_lo + g_hi) * inv_h2
            lo_s.append(g_lo * inv_h2)
            hi_s.append(g_hi * inv_h2)
        part = StencilPart(d=d_s, lo=tuple(lo_s), hi=tuple(hi_s))
    return FvMatrix(mesh, bcs, [L],
                    torch.zeros(mesh.shape, dtype=dtype, device=mesh.device),
                    [part])


def fvm_source_implicit(coeff, mesh: StructuredMesh, bcs: FieldBCs,
                        dtype=torch.float64) -> FvMatrix:
    """fvm::Sp(coeff, psi): implicit source coeff*psi (diagonal only)."""

    def L(P):
        return coeff * _interior(P)

    return FvMatrix(mesh, bcs, [L],
                    torch.zeros(mesh.shape, dtype=dtype, device=mesh.device),
                    [StencilPart(d=coeff)])
