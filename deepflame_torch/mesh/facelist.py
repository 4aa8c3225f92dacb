"""Face-list (unstructured) mesh backend: connectivity, boundary patches and
cell geometry as tensors on one device.

Port of the plan-less part of deepflame_tpu/mesh/facelist.py. Interior faces
are sorted by owner; boundary faces live in per-patch blocks with affine
ghost coefficients (ghost = a * x_owner + b, the structured backend's
`BC.coeffs`). Every face -> cell reduction runs in the ELLPACK incidence
form: a (n_cells, w) gather of face values and a row sum, so it is
deterministic on the card (no atomics) and sums each row in the order the
JAX package does. Operators take fields face- or cell-index first, with any
trailing batch dimensions, as in the JAX package.

Left for a later slice: the ShiftPlan layout of tensor-product meshes
(`from_structured`, `graded_box`) and the shard-local (halo) meshes;
`restrict` and `exchange` are the identity here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FaceListMesh", "BoundaryPatch", "ell_arrays"]


def ell_arrays(own: np.ndarray, nei: np.ndarray, n_cells: int,
               width: int | None = None, exclude: np.ndarray | None = None):
    """Host-side ELLPACK cell->face incidence: (face_idx (n, w) int32 padded
    with nf, sign (n, w) float32 {+1 owner, -1 neighbour, 0 pad}).

    A face appears twice (owner side +1, neighbour side -1), self-faces
    (own == nei) included. `exclude` masks faces to drop."""
    own = np.asarray(own).astype(np.int64)
    nei = np.asarray(nei).astype(np.int64)
    nf = own.shape[0]
    n = n_cells
    keep = (np.nonzero(~np.asarray(exclude))[0] if exclude is not None
            else np.arange(nf))
    ids = np.concatenate([own[keep], nei[keep]])
    faces = np.concatenate([keep, keep])
    side = np.concatenate([np.ones(keep.shape[0], np.float32),
                           -np.ones(keep.shape[0], np.float32)])
    order = np.argsort(ids, kind="stable")
    ids_s, faces_s, side_s = ids[order], faces[order], side[order]
    counts = np.bincount(ids, minlength=n)
    w = int(counts.max()) if width is None else int(width)
    if counts.max() > w:
        raise ValueError(f"cell with {counts.max()} faces > width {w}")
    starts = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(ids.shape[0]) - starts[ids_s]
    face_idx = np.full((n, w), nf, np.int32)
    sgn = np.zeros((n, w), np.float32)
    face_idx[ids_s, pos] = faces_s
    sgn[ids_s, pos] = side_s
    return face_idx, sgn


@dataclasses.dataclass(frozen=True)
class BoundaryPatch:
    """One boundary patch: nb faces, each owned by an interior cell.

    ghost = a * x_owner + b, as the structured backend's `BC.coeffs`.
    `n_axis`, the dominant axis of the normal, is set from the host normals
    when the patch is built, so no step reads a normal back from the card.
    `k_no`: the boundary non-orthogonal correction vector (nb, 3), Sf split
    against df = f_ctr - C_own as Sf = (magSf/(n.df)) df + k_no."""
    name: str
    owner: torch.Tensor     # (nb,) int64 cell index
    mag_sf: torch.Tensor    # (nb,) face area
    delta: torch.Tensor     # (nb,) owner-centre to ghost-centre distance
    a: torch.Tensor         # (nb,) ghost = a*x_own + b
    b: torch.Tensor         # (nb,)
    normal: torch.Tensor    # (nb, 3) outward unit normal
    kind: str = "generic"   # BC kind (upwind/inletOutlet need it)
    n_axis: int | None = None
    k_no: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class FaceListMesh:
    """Interior-face connectivity + boundary patches + cell geometry.

    `k_no` (nf, 3): explicit part of the over-relaxed split of Sf against
    d = C_nei - C_own; `skew` (nf, 3): face centroid minus the own->nei
    line's intersection with the face plane. Both None on orthogonal meshes.
    `ell_face` (n, w) int32 (pad = nf) and `ell_sign` (n, w) float32
    {+1 owner, -1 neighbour, 0 pad}: the ELL cell->face incidence."""
    n_cells: int
    owner: torch.Tensor     # (nf,) int64, sorted ascending
    neighbour: torch.Tensor  # (nf,) int64
    mag_sf: torch.Tensor    # (nf,) face area magnitude
    delta: torch.Tensor     # (nf,) owner-to-neighbour centre distance
    weights: torch.Tensor   # (nf,) owner interpolation weight
    normal: torch.Tensor    # (nf, 3) unit normal owner->neighbour
    volumes: torch.Tensor   # (n_cells,)
    centers: torch.Tensor   # (n_cells, 3)
    patches: tuple          # tuple[BoundaryPatch, ...]
    k_no: torch.Tensor | None = None
    skew: torch.Tensor | None = None
    ell_face: torch.Tensor | None = None
    ell_sign: torch.Tensor | None = None
    # ell_face clamped to a valid face, int64: the gather index
    _ell_idx: torch.Tensor | None = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.n_faces == 0:
            return
        if self.ell_face is None:
            face_idx, sgn = self._ell_host()
            object.__setattr__(self, "ell_face", face_idx)
            object.__setattr__(self, "ell_sign", sgn)
        object.__setattr__(self, "_ell_idx", torch.clamp(
            self.ell_face.long(), max=self.n_faces - 1))

    def _ell_host(self, width: int | None = None):
        """ELL incidence from the host copies of owner and neighbour."""
        face_idx, sgn = ell_arrays(self.owner.cpu().numpy(),
                                   self.neighbour.cpu().numpy(),
                                   self.n_cells, width)
        return (torch.as_tensor(face_idx, device=self.device),
                torch.as_tensor(sgn, device=self.device))

    def with_ell(self, width: int | None = None) -> "FaceListMesh":
        """A copy with the ELL incidence padded to `width` (default: the
        most faces of any cell). Built at construction when not given."""
        if self.n_faces == 0:
            return self
        face_idx, sgn = self._ell_host(width)
        return dataclasses.replace(self, ell_face=face_idx, ell_sign=sgn)

    @property
    def n_faces(self) -> int:
        return int(self.owner.shape[0])

    @property
    def device(self) -> torch.device:
        return self.volumes.device

    @property
    def vol_local(self) -> torch.Tensor:
        """Cell volumes for row scaling."""
        return self.volumes

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        """Zero non-owned rows: the identity on a one-device mesh."""
        return x

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Refresh halo rows: the identity on a one-device mesh."""
        return x

    def ell_connectivity(self, width: int = 6):
        """ELLPACK cell->face adjacency, the SpMV layout of `FvMatrixFL.ell`:
        (face_ids (n, w) int32, -1 padding; side (n, w) float64 {+1 owner,
        -1 neighbour, 0 pad}; nbr_ids (n, w) int32, the cell across each
        face, padded with the row's own index), on the mesh's device."""
        own = self.owner.cpu().numpy()
        nei = self.neighbour.cpu().numpy()
        n = self.n_cells
        nf = own.shape[0]
        fidx, sgn = ell_arrays(own, nei, n, width)
        f_safe = np.minimum(fidx, max(nf - 1, 0))
        self_col = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                                   fidx.shape)
        nbr = np.where(sgn > 0, nei[f_safe],
                       np.where(sgn < 0, own[f_safe], self_col))
        face_ids = np.where(sgn != 0, fidx, -1).astype(np.int32)
        dev = self.device
        return (torch.as_tensor(face_ids, device=dev),
                torch.as_tensor(sgn.astype(np.float64), device=dev),
                torch.as_tensor(nbr.astype(np.int32), device=dev))

    # ------------------------------------------------ gathers and scatters

    def gather_own(self, x: torch.Tensor) -> torch.Tensor:
        """x (n_cells, ...) -> per-face owner values (nf, ...)."""
        return x[self.owner]

    def gather_nei(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.neighbour]

    def scatter_faces(self, face_vals: torch.Tensor,
                      lead: bool = False) -> torch.Tensor:
        """sum_f s_f per cell, owner +, neighbour -: the divergence sum.
        face_vals (nf, ...) -> (n_cells, ...); with `lead`, (..., nf) ->
        (..., n_cells). `where`, not a multiply, on pad slots, so a
        non-finite value gathered into one cannot spread."""
        idx, sgn = self._ell_idx, self.ell_sign
        if lead:
            fv = face_vals[..., idx]                       # (..., n, w)
            return torch.where(sgn != 0, fv * sgn, 0.0).sum(-1)
        fv = face_vals[idx]                                # (n, w, ...)
        sgn = sgn.reshape(sgn.shape + (1,) * (face_vals.dim() - 1))
        return torch.where(sgn != 0, fv * sgn, 0.0).sum(1)

    def scatter_both(self, to_owner: torch.Tensor, to_neighbour: torch.Tensor,
                     lead: bool = False) -> torch.Tensor:
        """Owner and neighbour accumulations kept apart (matrix assembly):
        per cell, the sum of `to_owner` over the faces it owns plus
        `to_neighbour` over the faces it neighbours. Layout as
        `scatter_faces`."""
        idx, sgn = self._ell_idx, self.ell_sign
        zero = torch.zeros((), dtype=to_owner.dtype, device=to_owner.device)
        if lead:
            return (torch.where(sgn > 0, to_owner[..., idx], zero)
                    + torch.where(sgn < 0, to_neighbour[..., idx], zero)
                    ).sum(-1)
        ext = sgn.shape + (1,) * (to_owner.dim() - 1)
        own_m, nei_m = (sgn > 0).reshape(ext), (sgn < 0).reshape(ext)
        return (torch.where(own_m, to_owner[idx], zero)
                + torch.where(nei_m, to_neighbour[idx], zero)).sum(1)
