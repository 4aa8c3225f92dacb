"""General polygonal-face mesh geometry and the GeneralMesh container.

Port of deepflame_tpu/mesh/geometry.py. OpenFOAM's primitiveMesh geometry:
face centres and area vectors by fan triangulation about the vertex mean,
cell centres and volumes by signed pyramid decomposition, interpolation
weights and over-relaxed non-orthogonal deltas, all as numpy on the host.

GeneralMesh carries connectivity, geometry and named boundary patches
without field boundary conditions; `with_bcs` / `with_vector_bcs` attach a
field's BCs and give the FaceListMesh (tensors on a device) that the
face-list operators and solver take. blockMeshDict (mesh/blockmesh.py) and
OpenFOAM polyMesh (mesh/polymesh.py) both build it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .facelist import BoundaryPatch, FaceListMesh, ell_arrays
from .structured import BC

__all__ = ["GeneralMesh", "face_geometry", "cell_geometry",
           "build_general_mesh", "pad_faces"]


def pad_faces(faces: Sequence[Sequence[int]]) -> np.ndarray:
    """List of per-face vertex-id lists -> (nf, maxv) int64 array, padded by
    repeating the first vertex (a zero-length edge adds nothing to the fan
    sums)."""
    nf = len(faces)
    maxv = max((len(f) for f in faces), default=3)
    out = np.empty((nf, maxv), np.int64)
    for i, f in enumerate(faces):
        k = len(f)
        out[i, :k] = f
        out[i, k:] = f[0]
    return out


def face_geometry(points: np.ndarray, faces: np.ndarray):
    """(centres (nf, 3), area vectors Sf (nf, 3)) of padded polygon faces:
    fan triangles (v_i, v_{i+1}, vertex mean), area-weighted centroids.
    Degenerate (zero-area) faces get centre = vertex mean and Sf = 0."""
    P = points[faces]                                  # (nf, maxv, 3)
    c_est = P.mean(axis=1)
    nxt = np.roll(P, -1, axis=1)
    n_tri = np.cross(nxt - P, c_est[:, None, :] - P)   # 2x area vectors
    a_tri = np.linalg.norm(n_tri, axis=2)
    c_tri = P + nxt + c_est[:, None, :]                # 3x centroid
    sum_n = n_tri.sum(axis=1)
    sum_a = a_tri.sum(axis=1)
    sum_ac = (a_tri[..., None] * c_tri).sum(axis=1)
    ok = sum_a > 1e-300
    ctr = np.where(ok[:, None], sum_ac / np.maximum(3.0 * sum_a, 1e-300)[:, None],
                   c_est)
    return ctr, 0.5 * sum_n


def cell_geometry(n_cells: int, owner: np.ndarray, neighbour: np.ndarray,
                  f_ctr: np.ndarray, f_sf: np.ndarray,
                  f_ctr_nei: np.ndarray | None = None):
    """(cell centres (nc, 3), volumes (nc,)) by signed pyramid decomposition.

    neighbour < 0 marks boundary faces. f_ctr_nei: optional per-face centres
    as the neighbour cell sees them (cyclic faces sit at the periodic image
    on that side)."""
    interior = neighbour >= 0
    fc_nei = f_ctr[interior] if f_ctr_nei is None else f_ctr_nei[interior]
    c_est = np.zeros((n_cells, 3))
    cnt = np.zeros(n_cells)
    np.add.at(c_est, owner, f_ctr)
    np.add.at(cnt, owner, 1.0)
    np.add.at(c_est, neighbour[interior], fc_nei)
    np.add.at(cnt, neighbour[interior], 1.0)
    c_est /= np.maximum(cnt, 1.0)[:, None]

    ctr = np.zeros((n_cells, 3))
    vol = np.zeros(n_cells)

    def accumulate(cells, sign, fc, sf):
        pyr3 = sign * np.einsum("fi,fi->f", sf, fc - c_est[cells])
        pc = 0.75 * fc + 0.25 * c_est[cells]
        np.add.at(vol, cells, pyr3)
        np.add.at(ctr, cells, pyr3[:, None] * pc)

    accumulate(owner, +1.0, f_ctr, f_sf)
    accumulate(neighbour[interior], -1.0, fc_nei, f_sf[interior])
    ctr /= np.maximum(vol, 1e-300)[:, None]
    vol /= 3.0
    return ctr, vol


@dataclasses.dataclass(frozen=True)
class _PatchGeom:
    name: str
    ftype: str               # declared patch type (patch/wall/empty/wedge/..)
    owner: np.ndarray        # (nb,)
    mag_sf: np.ndarray
    normal: np.ndarray       # (nb, 3) outward unit
    f_ctr: np.ndarray        # (nb, 3)
    delta: np.ndarray        # (nb,) ghost spacing = 2 * n.(Cf - Co)


def _host_value(v):
    """A BC value as host data: tensors and arrays (per-face profiles) become
    numpy, the (a, b) pair of an affine BC elementwise."""
    if isinstance(v, tuple):
        return tuple(_host_value(x) for x in v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


@dataclasses.dataclass(frozen=True)
class GeneralMesh:
    """Connectivity + geometry with named patches; no field BCs.

    Interior faces are sorted by owner. `with_bcs` attaches a scalar field's
    per-patch BCs; `with_vector_bcs` gives the component triple of a vector
    field (symmetry/wedge reflected per component through the diagonal of
    the reflection tensor)."""
    n_cells: int
    owner: np.ndarray
    neighbour: np.ndarray
    mag_sf: np.ndarray
    delta: np.ndarray        # over-relaxed 1/nonOrthDeltaCoeffs
    weights: np.ndarray
    normal: np.ndarray
    volumes: np.ndarray
    centers: np.ndarray
    f_ctr: np.ndarray        # interior face centres
    patches: tuple           # tuple[_PatchGeom, ...]
    non_ortho_deg: np.ndarray  # per-interior-face non-orthogonality angle
    # interior tensors per (dtype, device), shared by every field's mesh
    _interior: dict = dataclasses.field(default_factory=dict, compare=False,
                                        repr=False)

    @property
    def patch_names(self):
        return tuple(p.name for p in self.patches)

    def _bc_for(self, spec, p: _PatchGeom, component: int | None):
        """The BC of one patch from a user spec dict."""
        if p.ftype == "empty":
            return BC("empty")
        if p.ftype == "wedge":
            # geometric whatever the spec says: the patch kind must stay
            # "wedge" so the solver's exact zero-flux rules apply
            return BC("wedge")
        if spec is None or p.name not in spec:
            raise KeyError(f"no BC given for patch '{p.name}'")
        bc = spec[p.name]
        if isinstance(bc, (tuple, list)):
            if component is None:
                raise ValueError(f"patch '{p.name}': per-component BC tuple "
                                 "given for a scalar field")
            bc = bc[component]
        return bc

    def _patch_block(self, p: _PatchGeom, bc: BC, dtype, device,
                     component: int | None) -> BoundaryPatch:
        delta = p.delta.astype(np.float64)
        if bc.kind in ("symmetry", "wedge") and component is not None:
            # ghost_c = (1 - 2 n_c^2) u_c : diagonal of I - 2 n n^T
            a = 1.0 - 2.0 * p.normal[:, component] ** 2
            b = np.zeros_like(a)
            kind = "symmetry"
        elif bc.kind in ("symmetry", "wedge"):
            a = np.ones_like(delta)
            b = np.zeros_like(delta)
            kind = bc.kind
        else:
            a, b = BC(bc.kind, _host_value(bc.value)).coeffs(delta, +1)
            a = np.broadcast_to(np.asarray(a, np.float64), delta.shape)
            b = np.broadcast_to(np.asarray(b, np.float64), delta.shape)
            kind = bc.kind
        # boundary non-orthogonality: Sf = (magSf/(n.df)) df + k_b against
        # df = f_ctr - C_own, for value-type BCs on walls not normal to the
        # owner-to-face line (gradient-type BCs prescribe the normal flux)
        k_b_t = None
        if kind == "fixedValue":
            df = p.f_ctr - self.centers[p.owner]
            ndf = np.einsum("fi,fi->f", p.normal, df)
            k_b = p.mag_sf[:, None] * (
                p.normal - df / np.maximum(ndf, 1e-300)[:, None])
            k_b = np.where((p.mag_sf > 1e-300)[:, None], k_b, 0.0)
            if np.abs(k_b).max() > 1e-9 * max(p.mag_sf.max(), 1e-300):
                k_b_t = torch.as_tensor(k_b, dtype=dtype, device=device)
        f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
        n_axis = (int(np.argmax(np.abs(p.normal[0])))
                  if p.owner.shape[0] > 0 else None)
        return BoundaryPatch(
            name=p.name,
            owner=torch.as_tensor(p.owner, dtype=torch.long, device=device),
            mag_sf=f(p.mag_sf), delta=f(delta), a=f(a), b=f(b),
            normal=f(p.normal), kind=kind, n_axis=n_axis, k_no=k_b_t)

    def _interior_tensors(self, dtype, device) -> dict:
        """Interior connectivity, geometry, non-orthogonal and skew vectors
        and the ELL incidence as tensors, built once per dtype and device."""
        key = (dtype, device)
        if key in self._interior:
            return self._interior[key]
        # non-orthogonal / skew correction vectors (OpenFOAM corrected
        # snGrad + skewCorrected interpolation), over-relaxed split
        # Sf = (magSf/delta) d + k_no; dropped (None) when negligible
        d = self.centers[self.neighbour] - self.centers[self.owner]
        sf = self.mag_sf[:, None] * self.normal
        k_no = sf - (self.mag_sf / self.delta)[:, None] * d
        sfd = np.einsum("fi,fi->f", sf, d)
        lam = np.einsum("fi,fi->f", sf, self.f_ctr
                        - self.centers[self.owner]) / np.maximum(sfd, 1e-300)
        skew = self.f_ctr - (self.centers[self.owner] + lam[:, None] * d)
        scale = np.maximum(self.mag_sf.max(), 1e-300)
        d_scale = np.maximum(np.linalg.norm(d, axis=1).max(), 1e-300)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        ix = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
        out = dict(
            owner=ix(self.owner), neighbour=ix(self.neighbour),
            mag_sf=f(self.mag_sf), delta=f(self.delta),
            weights=f(self.weights), normal=f(self.normal),
            volumes=f(self.volumes), centers=f(self.centers),
            k_no=f(k_no) if np.abs(k_no).max() > 1e-9 * scale else None,
            skew=f(skew) if np.abs(skew).max() > 1e-9 * d_scale else None)
        if self.owner.shape[0] > 0:
            face_idx, sgn = ell_arrays(self.owner, self.neighbour,
                                       self.n_cells)
            out["ell_face"] = torch.as_tensor(face_idx, device=device)
            out["ell_sign"] = torch.as_tensor(sgn, device=device)
        self._interior[key] = out
        return out

    def with_bcs(self, spec: Dict[str, BC] | None, dtype=torch.float64,
                 component: int | None = None, device=None) -> FaceListMesh:
        """FaceListMesh on `device` (default: the CUDA card) with this scalar
        field's boundary conditions. spec: {patch_name: BC}; empty and wedge
        patches take their geometric BC. A BC value may be a per-face array
        or tensor in the patch's face order."""
        device = resolve_device(device)
        blocks = tuple(
            self._patch_block(p, self._bc_for(spec, p, component), dtype,
                              device, component)
            for p in self.patches)
        return FaceListMesh(n_cells=self.n_cells, patches=blocks,
                            **self._interior_tensors(dtype, device))

    def with_vector_bcs(self, spec, dtype=torch.float64, device=None):
        """(m_x, m_y, m_z) FaceListMesh triple for a vector field. spec maps
        patch name -> BC (shared across components) or (BC, BC, BC)."""
        return tuple(self.with_bcs(spec, dtype, component=c, device=device)
                     for c in range(3))


def build_general_mesh(points: np.ndarray,
                       faces: Sequence[Sequence[int]] | np.ndarray,
                       owner: np.ndarray, neighbour: np.ndarray,
                       patch_defs: Sequence[tuple],
                       nei_offset: np.ndarray | None = None) -> GeneralMesh:
    """GeneralMesh from polyMesh-style arrays.

    faces: per-face vertex id lists (or a padded array); owner (nf_total,);
    neighbour (n_interior,): faces [0, n_interior) are interior, the rest
    boundary. patch_defs: (name, type, startFace, nFaces) each. nei_offset:
    optional (n_interior, 3) translation of the neighbour centre across
    cyclic faces."""
    faces = faces if isinstance(faces, np.ndarray) else pad_faces(faces)
    owner = np.asarray(owner, np.int64)
    neighbour = np.asarray(neighbour, np.int64)
    n_int = neighbour.shape[0]
    n_cells = int(max(owner.max(initial=-1),
                      neighbour.max(initial=-1))) + 1

    f_ctr, f_sf = face_geometry(points, faces)
    full_nei = np.concatenate([neighbour,
                               -np.ones(owner.shape[0] - n_int, np.int64)])
    fc_nei_full = None
    if nei_offset is not None:
        # the neighbour side of a wrap face sits at the periodic image
        fc_nei_full = f_ctr.copy()
        fc_nei_full[:n_int] = f_ctr[:n_int] - np.asarray(nei_offset)
    c_ctr, c_vol = cell_geometry(n_cells, owner, full_nei, f_ctr, f_sf,
                                 f_ctr_nei=fc_nei_full)
    if (c_vol <= 0).any():
        bad = np.where(c_vol <= 0)[0]
        raise ValueError(f"non-positive cell volumes at cells {bad[:8]}"
                         f" (min {c_vol.min():.3e})")

    mag = np.linalg.norm(f_sf, axis=1)
    ok = mag > 1e-300
    unit = np.where(ok[:, None], f_sf / np.maximum(mag, 1e-300)[:, None],
                    np.array([1.0, 0.0, 0.0]))

    # interior: weights, deltas, non-orthogonality
    o_i, n_i = owner[:n_int], neighbour[:n_int]
    nei_ctr = c_ctr[n_i]
    if nei_offset is not None:
        nei_ctr = nei_ctr + np.asarray(nei_offset)
    d = nei_ctr - c_ctr[o_i]
    mag_d = np.linalg.norm(d, axis=1)
    nd = np.einsum("fi,fi->f", unit[:n_int], d)
    if (nd <= 0).any():
        raise ValueError("face normal points owner<-neighbour somewhere "
                         "(mesh orientation error)")
    # over-relaxed non-orthogonal delta: 1/max(n.d, 0.05|d|)
    delta_i = np.maximum(nd, 0.05 * mag_d)
    cosang = np.clip(nd / np.maximum(mag_d, 1e-300), -1.0, 1.0)
    non_ortho = np.degrees(np.arccos(cosang))
    # weights: |Sf.(Cn-Cf)| / (|Sf.(Cf-Co)| + |Sf.(Cn-Cf)|)
    sfd_own = np.abs(np.einsum("fi,fi->f", f_sf[:n_int],
                               f_ctr[:n_int] - c_ctr[o_i]))
    sfd_nei = np.abs(np.einsum("fi,fi->f", f_sf[:n_int],
                               nei_ctr - f_ctr[:n_int]))
    w = sfd_nei / np.maximum(sfd_own + sfd_nei, 1e-300)
    w = np.where(sfd_own + sfd_nei > 1e-300, w, 0.5)

    order = np.argsort(o_i, kind="stable")       # interior faces by owner

    patches = []
    for (name, ftype, start, nfp) in patch_defs:
        sl = slice(start, start + nfp)
        po = owner[sl]
        pn = unit[sl]
        # ghost spacing: 2 x owner-to-face projection
        dn = 2.0 * np.einsum("fi,fi->f", pn, f_ctr[sl] - c_ctr[po])
        dn = np.maximum(dn, 0.05 * 2.0 *
                        np.linalg.norm(f_ctr[sl] - c_ctr[po], axis=1))
        zero = mag[sl] <= 1e-300
        dn = np.where(zero, 1.0, dn)       # degenerate faces: inert spacing
        patches.append(_PatchGeom(
            name=name, ftype=ftype, owner=po.astype(np.int64),
            mag_sf=mag[sl].copy(), normal=pn.copy(),
            f_ctr=f_ctr[sl].copy(), delta=dn))

    return GeneralMesh(
        n_cells=n_cells,
        owner=o_i[order], neighbour=n_i[order],
        mag_sf=mag[:n_int][order], delta=delta_i[order],
        weights=w[order], normal=unit[:n_int][order],
        volumes=c_vol, centers=c_ctr, f_ctr=f_ctr[:n_int][order],
        patches=tuple(patches),
        non_ortho_deg=non_ortho[order])
