"""Face-list (unstructured) mesh backend: connectivity, boundary patches and
cell geometry as tensors on one device.

Port of deepflame_tpu/mesh/facelist.py. Boundary faces live in per-patch
blocks with affine ghost coefficients (ghost = a * x_owner + b, the
structured backend's `BC.coeffs`). On a general mesh (interior faces sorted
by owner) every face -> cell reduction runs in the ELLPACK incidence form: a
(n_cells, w) gather of face values and a row sum, deterministic on the card
(no atomics). Operators take fields face- or cell-index first, with any
trailing batch dimensions, as in the JAX package.

Tensor-product meshes (`from_structured`, `graded_box`) carry a ShiftPlan:
their faces are stored family-major (per active axis the interior slabs in
C order, then the cyclic wrap slab), so every face gather is a reshape and
a slice of the (nx, ny, nz) cell lattice and every scatter a slice add, and
the implicit matrices become 7-point lattice stencils (ops/fv_facelist.py
`plan_stencil`, run by the `stencil7_apply` kernel on the card). The
constructors build their arrays in host numpy, face for face as the JAX
package does.

Shard-local meshes (parallel.distributed_fl.FLDecomp): cells [0, n_own_max)
are the shard's own (and pads), the rest halo copies of other shards' cells
one face away; crossing faces exist on both shards. `w_own` marks the owned
cells, `restrict` zeroes the other rows, and `exchange` refreshes the halo
rows from their owners, point to point over the active shard group: the
buffer of ring offset d goes to shard (r - d) % P and comes from (r + d) %
P (`halo`). On one-device meshes both are the identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["FaceListMesh", "BoundaryPatch", "ShiftPlan", "from_structured",
           "graded_box", "structured_face_maps", "ell_arrays"]


@dataclasses.dataclass(frozen=True, eq=True)
class ShiftPlan:
    """Static shift-execution plan of tensor-product connectivity: the
    interior faces are the axis families of an (nx, ny, nz) cell lattice,
    stored family-major in construction order (for each active axis its
    n_ax - 1 interior slabs in C order, then on a cyclic axis the wrap
    slab). `families`: per active axis (axis, wrap, n_main, n_wrap)."""
    shape: tuple
    families: tuple


def _plan_segments(plan: ShiftPlan):
    """[(axis, is_wrap, start, count)] face segments in storage order."""
    segs = []
    off = 0
    for ax, wrap, n_main, n_wrap in plan.families:
        segs.append((ax, False, off, n_main))
        off += n_main
        if wrap:
            segs.append((ax, True, off, n_wrap))
            off += n_wrap
    return segs


def _lattice_shape(shape, ax, is_wrap):
    s = list(shape)
    s[ax] = 1 if is_wrap else shape[ax] - 1
    return tuple(s)


def _fam_slice(n_ax: int, is_wrap: bool, own: bool) -> slice:
    """The owner (own) or neighbour cells of a face segment along its axis."""
    if is_wrap:
        return slice(n_ax - 1, n_ax) if own else slice(0, 1)
    return slice(0, n_ax - 1) if own else slice(1, n_ax)


def _lat_index(ax: int, sl: slice, lead: bool) -> tuple:
    """Index of a lattice slab: cell axes first (trailing batch) or last
    (leading batch, `lead`)."""
    idx = [slice(None)] * 3
    idx[ax] = sl
    return (Ellipsis, *idx) if lead else tuple(idx)


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
    {+1 owner, -1 neighbour, 0 pad}: the ELL cell->face incidence.
    `plan`: the ShiftPlan of a tensor-product mesh, whose gathers and
    scatters then run as lattice slices (their values equal the index
    forms'; scatter sums are taken in the plan's order)."""
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
    # tensor-product meshes: the shift plan of their face layout
    plan: ShiftPlan | None = None
    # shard-local meshes: (n_cells,) 1.0 on owned cells, else 0; and
    # {ring offset d: (send_idx (B_d,), recv_slot (B_d,))}: this shard
    # sends x[send_idx] to shard (r - d) % P and scatters the buffer from
    # (r + d) % P into recv_slot (pad slots = n_cells, dropped)
    w_own: torch.Tensor | None = None
    halo: dict | None = None
    # ell_face clamped to a valid face, int64: the gather index
    _ell_idx: torch.Tensor | None = dataclasses.field(
        init=False, default=None, repr=False, compare=False)
    # the halo plan as exchange runs it: (d, send_idx, positions in the
    # buffer of the real slots, those slots), int64 on the mesh's device
    _halo_ops: tuple = dataclasses.field(
        init=False, default=(), repr=False, compare=False)

    def __post_init__(self):
        if self.halo is not None:
            ops = []
            for d in sorted(self.halo):
                send, recv = (torch.as_tensor(t).cpu().long()
                              for t in self.halo[d])
                pos = torch.nonzero(recv < self.n_cells).reshape(-1)
                ops.append(tuple([d] + [t.to(self.device)
                                        for t in (send, pos, recv[pos])]))
            object.__setattr__(self, "_halo_ops", tuple(ops))
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

    def restrict(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Zero the rows this shard does not own (halo and pad cells; `dim`
        is x's cell dimension): their scatter sums are partial, and the
        owning shard has them whole. `where`, not a multiply, so that a
        non-finite value in a dropped row cannot leak. The identity on a
        one-device mesh."""
        if self.w_own is None:
            return x
        dim = dim % x.dim()
        own = (self.w_own > 0).reshape((-1,) + (1,) * (x.dim() - dim - 1))
        return torch.where(own, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))

    def exchange(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Refresh the halo rows of x (cell dimension `dim`) from the
        shards that own them: one point-to-point message each way per ring
        offset, all in one batch (the reference's processor-patch exchange,
        the JAX package's ppermute). The identity on a one-device mesh or
        with no shard group active."""
        if self.halo is None:
            return x
        from ..parallel.context import current_axis
        g = current_axis()
        if g is None:
            return x
        dim = dim % x.dim()
        P, r = g.size, g.rank
        bufs = g.sendrecv([(x.index_select(dim, send), (r - d) % P,
                            (r + d) % P, 16 + d)
                           for d, send, _, _ in self._halo_ops])
        for (_, _, pos, slot), buf in zip(self._halo_ops, bufs):
            x = x.index_copy(dim, slot, buf.index_select(dim, pos))
        return x

    def ell_connectivity(self, width: int = 6, exclude=None):
        """ELLPACK cell->face adjacency, the SpMV layout of `FvMatrixFL.ell`:
        (face_ids (n, w) int32, -1 padding; side (n, w) float64 {+1 owner,
        -1 neighbour, 0 pad}; nbr_ids (n, w) int32, the cell across each
        face, padded with the row's own index), on the mesh's device.
        `exclude`: a (nf,) mask of faces to leave out (a shard-local mesh's
        pad faces)."""
        own = self.owner.cpu().numpy()
        nei = self.neighbour.cpu().numpy()
        n = self.n_cells
        nf = own.shape[0]
        fidx, sgn = ell_arrays(own, nei, n, width, exclude)
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

    # ------------------------------------------------ shift-plan path

    def _gather_plan(self, x: torch.Tensor, own_side: bool) -> torch.Tensor:
        pl = self.plan
        rest = x.shape[1:]
        X = x.reshape(pl.shape + rest)
        outs = [X[_lat_index(ax, _fam_slice(pl.shape[ax], w, own_side),
                             False)].reshape((-1,) + rest)
                for ax, w, _, _ in _plan_segments(pl)]
        if not outs:
            return x.new_zeros((0,) + rest)
        return torch.cat(outs)

    def plan_interp(self, x: torch.Tensor) -> torch.Tensor:
        """Linear face interpolation on the shift plan, x (n, ...) ->
        (nf, ...): per family slab arithmetic, one concatenation."""
        pl = self.plan
        rest = x.shape[1:]
        X = x.reshape(pl.shape + rest)
        outs = []
        for ax, is_wrap, start, count in _plan_segments(pl):
            lat = _lattice_shape(pl.shape, ax, is_wrap)
            w = self.weights[start:start + count].reshape(
                lat + (1,) * len(rest))
            xo = X[_lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, True),
                              False)]
            xn = X[_lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, False),
                              False)]
            outs.append((w * xo + (1.0 - w) * xn).reshape((-1,) + rest))
        if not outs:
            return x.new_zeros((0,) + rest)
        return torch.cat(outs)

    def plan_grad_interior(self, x: torch.Tensor) -> torch.Tensor:
        """Interior part of the Gauss gradient on the shift plan, x (n, ...)
        -> (n, ..., 3). Family normals are +e_ax, so each family adds to one
        component only."""
        pl = self.plan
        rest = x.shape[1:]
        X = x.reshape(pl.shape + rest)
        comps = {}
        for ax, is_wrap, start, count in _plan_segments(pl):
            lat = _lattice_shape(pl.shape, ax, is_wrap)
            col = lat + (1,) * len(rest)
            w = self.weights[start:start + count].reshape(col)
            ms = self.mag_sf[start:start + count].reshape(col)
            i_o = _lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, True),
                             False)
            i_n = _lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, False),
                             False)
            fv = (w * X[i_o] + (1.0 - w) * X[i_n]) * ms
            acc = comps.get(ax)
            if acc is None:
                acc = torch.zeros(pl.shape + rest, dtype=x.dtype,
                                  device=x.device)
            acc[i_o] += fv
            acc[i_n] -= fv
            comps[ax] = acc
        z = torch.zeros(pl.shape + rest, dtype=x.dtype, device=x.device)
        return torch.stack([comps.get(ax, z).reshape((-1,) + rest)
                            for ax in range(3)], dim=-1)

    def plan_flux_normal(self, q: torch.Tensor) -> torch.Tensor:
        """(u . n)_f of a cell vector field q (n, 3) on the shift plan: per
        family the axis component's interpolation."""
        pl = self.plan
        outs = []
        for ax, is_wrap, start, count in _plan_segments(pl):
            lat = _lattice_shape(pl.shape, ax, is_wrap)
            X = q[:, ax].reshape(pl.shape)
            w = self.weights[start:start + count].reshape(lat)
            xo = X[_lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, True),
                              False)]
            xn = X[_lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, False),
                              False)]
            outs.append((w * xo + (1.0 - w) * xn).reshape(-1))
        if not outs:
            return q.new_zeros((0,))
        return torch.cat(outs)

    def _plan_scatter(self, to_owner: torch.Tensor, to_neighbour: torch.Tensor,
                      lead: bool = False) -> torch.Tensor:
        """Sum of per-face contributions into owner (to_owner) and neighbour
        (to_neighbour) cells by slab adds, family by family. (nf, ...) ->
        (n, ...); with `lead`, (..., nf) -> (..., n)."""
        pl = self.plan
        dtype = torch.promote_types(to_owner.dtype, to_neighbour.dtype)
        if lead:
            batch = torch.broadcast_shapes(to_owner.shape[:-1],
                                           to_neighbour.shape[:-1])
            out = torch.zeros(batch + pl.shape, dtype=dtype,
                              device=to_owner.device)
        else:
            rest = torch.broadcast_shapes(to_owner.shape[1:],
                                          to_neighbour.shape[1:])
            out = torch.zeros(pl.shape + rest, dtype=dtype,
                              device=to_owner.device)
        for ax, is_wrap, start, count in _plan_segments(pl):
            lat = _lattice_shape(pl.shape, ax, is_wrap)
            for vals, own in ((to_owner, True), (to_neighbour, False)):
                if lead:
                    seg = vals[..., start:start + count]
                    seg = seg.reshape(seg.shape[:-1] + lat)
                else:
                    seg = vals[start:start + count]
                    seg = seg.reshape(lat + seg.shape[1:])
                out[_lat_index(ax, _fam_slice(pl.shape[ax], is_wrap, own),
                               lead)] += seg
        if lead:
            return out.reshape(out.shape[:-3] + (self.n_cells,))
        return out.reshape((self.n_cells,) + out.shape[3:])

    # ------------------------------------------------ gathers and scatters

    def gather_own(self, x: torch.Tensor) -> torch.Tensor:
        """x (n_cells, ...) -> per-face owner values (nf, ...): lattice
        slices on a plan mesh, a row gather otherwise."""
        if self.plan is not None:
            return self._gather_plan(x, True)
        return x[self.owner]

    def gather_nei(self, x: torch.Tensor) -> torch.Tensor:
        if self.plan is not None:
            return self._gather_plan(x, False)
        return x[self.neighbour]

    def scatter_faces(self, face_vals: torch.Tensor,
                      lead: bool = False) -> torch.Tensor:
        """sum_f s_f per cell, owner +, neighbour -: the divergence sum.
        face_vals (nf, ...) -> (n_cells, ...); with `lead`, (..., nf) ->
        (..., n_cells). `where`, not a multiply, on pad slots, so a
        non-finite value gathered into one cannot spread."""
        if self.plan is not None:
            return self._plan_scatter(face_vals, -face_vals, lead)
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
        if self.plan is not None:
            return self._plan_scatter(to_owner, to_neighbour, lead)
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


# ------------------------------------------------ tensor-product constructors

def _box_plan(shape, bcs) -> ShiftPlan:
    """ShiftPlan of a tensor-product box with per-axis BCs. On an n = 1
    cyclic axis the wrap faces are self-faces: owner and neighbour slices
    coincide."""
    n_all = int(np.prod(shape))
    fams = []
    for ax in range(3):
        lo_bc, _ = bcs[ax]
        if lo_bc.kind == "empty":
            continue
        n_ax = shape[ax]
        per_slab = n_all // n_ax
        fams.append((ax, lo_bc.kind == "cyclic", per_slab * (n_ax - 1),
                     per_slab if lo_bc.kind == "cyclic" else 0))
    return ShiftPlan(shape=tuple(int(s) for s in shape), families=tuple(fams))


def structured_face_maps(mesh, bcs):
    """(axis_ids, flat_ids) mapping each face-list interior face (in the
    from_structured order) to its slot in the structured per-axis face
    arrays ((nx+1, ny, nz), (nx, ny+1, nz), (nx, ny, nz+1)):
        phi_fl = concat_per_axis(phi[ax].ravel()[axis_ids[ax]])
    axis_ids[ax] is None on an empty axis; flat_ids is the identity (faces
    are stored family-major). Boundary patch faces map by construction
    (patch order and C order over each patch slab)."""
    nx, ny, nz = mesh.shape
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    per_axis = []
    for ax in range(3):
        lo_bc, _ = bcs[ax]
        if lo_bc.kind == "empty":
            per_axis.append(None)
            continue
        fsh = shapes[ax]
        fidx = np.arange(int(np.prod(fsh))).reshape(fsh)
        n_ax = mesh.shape[ax]
        sl = [slice(None)] * 3
        sl[ax] = slice(1, n_ax)            # interior faces 1..n_ax-1
        ids = fidx[tuple(sl)].ravel()
        if lo_bc.kind == "cyclic":
            sl_w = [slice(None)] * 3
            sl_w[ax] = slice(n_ax, n_ax + 1)   # the wrap face, stored on top
            ids = np.concatenate([ids, fidx[tuple(sl_w)].ravel()])
        per_axis.append(ids)
    n_total = sum(ids.shape[0] for ids in per_axis if ids is not None)
    return per_axis, np.arange(n_total)


def _host_coeff(v, slab_shape) -> np.ndarray:
    """An affine ghost coefficient (number, array or tensor broadcastable to
    the patch slab) as host float64 values in C order over the slab."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(v, np.float64), slab_shape).reshape(-1)


def _patch(name, ob, area, h, bc, side, ax, slab_shape, dtype, device):
    """BoundaryPatch of one box side: owners ob, face areas, ghost spacing
    h and the BC's affine coefficients per face."""
    a_c, b_c = bc.coeffs(h, -1 if side == 0 else +1)
    nb = ob.shape[0]
    f = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                  device=device)
    normal = np.zeros((nb, 3))
    normal[:, ax] = -1.0 if side == 0 else 1.0
    return BoundaryPatch(
        name=name, owner=torch.as_tensor(ob, dtype=torch.long, device=device),
        mag_sf=f(np.broadcast_to(area, (nb,))),
        delta=f(np.full(nb, h)), a=f(_host_coeff(a_c, slab_shape)),
        b=f(_host_coeff(b_c, slab_shape)), normal=f(normal), kind=bc.kind,
        n_axis=ax)


def from_structured(mesh, bcs, dtype=torch.float64,
                    device=None) -> FaceListMesh:
    """The face-list form of a uniform structured block and one field's BCs
    (FieldBCs, per axis (lo, hi)), on `device` (default: the CUDA card).
    Cyclic axes become wrap interior faces, 'empty' axes contribute no
    faces, the other BCs become BoundaryPatch blocks ax{axis}_{lo,hi} with
    the affine ghost coefficients of the structured padder; a BC value may
    be a per-face array or tensor broadcastable to its patch slab (e.g.
    (1, ny, nz) on an x side). Faces family-major with a ShiftPlan, face
    for face as the JAX package orders them."""
    device = resolve_device(device)
    nx, ny, nz = mesh.shape
    hs = mesh.spacing
    areas = (mesh.dy * mesh.dz, mesh.dx * mesh.dz, mesh.dx * mesh.dy)
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    own, nei, msf, dlt, nrm = [], [], [], [], []
    patches = []
    eye = np.eye(3)
    for ax, (n_ax, h, A) in enumerate(zip(mesh.shape, hs, areas)):
        lo_bc, hi_bc = bcs[ax]
        if lo_bc.kind == "empty":
            continue
        o = idx[_lat_index(ax, slice(0, n_ax - 1), False)].ravel()
        m = idx[_lat_index(ax, slice(1, n_ax), False)].ravel()
        if lo_bc.kind == "cyclic":
            o = np.concatenate([o, idx[_lat_index(
                ax, slice(n_ax - 1, n_ax), False)].ravel()])
            m = np.concatenate([m, idx[_lat_index(ax, slice(0, 1),
                                                  False)].ravel()])
        own.append(o)
        nei.append(m)
        msf.append(np.full(o.shape, A))
        dlt.append(np.full(o.shape, h))
        nrm.append(np.broadcast_to(eye[ax], (o.shape[0], 3)))
        if lo_bc.kind != "cyclic":
            slab = list(mesh.shape)
            slab[ax] = 1
            for side, bc in ((0, lo_bc), (1, hi_bc)):
                sl = slice(0, 1) if side == 0 else slice(n_ax - 1, n_ax)
                ob = idx[_lat_index(ax, sl, False)].ravel()
                patches.append(_patch(f"ax{ax}_{'lo' if side == 0 else 'hi'}",
                                      ob, A, h, bc, side, ax, tuple(slab),
                                      dtype, device))
    cat = lambda xs, empty: np.concatenate(xs) if xs else empty
    own_np = cat(own, np.zeros(0, np.int64))
    X, Y, Z = (c.cpu().numpy() for c in mesh.cell_centers(torch.float64))
    centers = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    f = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                  device=device)
    ix = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    return FaceListMesh(
        n_cells=mesh.n_cells, owner=ix(own_np),
        neighbour=ix(cat(nei, np.zeros(0, np.int64))),
        mag_sf=f(cat(msf, np.zeros(0))), delta=f(cat(dlt, np.zeros(0))),
        weights=f(np.full(own_np.shape, 0.5)),
        normal=f(cat(nrm, np.zeros((0, 3)))),
        volumes=f(np.full((mesh.n_cells,), mesh.volume)),
        centers=f(centers), patches=tuple(patches),
        plan=_box_plan(mesh.shape, bcs))


def graded_box(x_edges, y_edges, z_edges, bcs, dtype=torch.float64,
               device=None) -> FaceListMesh:
    """Non-uniform tensor-product box from explicit edge coordinates (the
    shape of blockMesh's simpleGrading output), on `device` (default: the
    CUDA card). Face weights and owner-neighbour distances follow the cell
    centres (w = d_nei_face / d_own_nei); cyclic axes need matching end
    spacings. A ShiftPlan as from_structured's."""
    device = resolve_device(device)
    edges = [np.asarray(e, np.float64) for e in (x_edges, y_edges, z_edges)]
    ncell = [max(e.shape[0] - 1, 1) for e in edges]
    nx, ny, nz = ncell
    centers_1d = [0.5 * (e[1:] + e[:-1]) if e.shape[0] > 1
                  else np.asarray([0.0]) for e in edges]
    widths_1d = [np.diff(e) if e.shape[0] > 1 else np.asarray([1.0])
                 for e in edges]
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    WX, WY, WZ = np.meshgrid(*widths_1d, indexing="ij")
    vols = (WX * WY * WZ).ravel()
    CX, CY, CZ = np.meshgrid(*centers_1d, indexing="ij")
    centers = np.stack([CX.ravel(), CY.ravel(), CZ.ravel()], axis=1)

    own, nei, msf, dlt, wgt, nrm = [], [], [], [], [], []
    patches = []
    eye = np.eye(3)
    for ax in range(3):
        lo_bc, hi_bc = bcs[ax]
        n_ax = ncell[ax]
        if lo_bc.kind == "empty":
            continue
        c1, w1 = centers_1d[ax], widths_1d[ax]
        tr = [a for a in range(3) if a != ax]
        A2 = np.meshgrid(*(widths_1d[a] for a in tr), indexing="ij")
        area_tr = A2[0] * A2[1]                     # (n_t1, n_t2)
        shp_tr = [1, 1, 1]
        for t, a in enumerate(tr):
            shp_tr[a] = area_tr.shape[t]

        def axis_lattice(per_ax):
            """A per-slab array broadcast over the family lattice, C order."""
            shp = [1, 1, 1]
            shp[ax] = len(per_ax)
            lat = [nx, ny, nz]
            lat[ax] = len(per_ax)
            return np.broadcast_to(np.asarray(per_ax).reshape(shp),
                                   tuple(lat)).ravel()

        def face_block(sl_o_ax, sl_n_ax, deltas, w_owns):
            o = idx[_lat_index(ax, sl_o_ax, False)].reshape(-1)
            m = idx[_lat_index(ax, sl_n_ax, False)].reshape(-1)
            own.append(o)
            nei.append(m)
            lat = [nx, ny, nz]
            lat[ax] = len(deltas)
            msf.append(np.broadcast_to(area_tr.reshape(tuple(shp_tr)),
                                       tuple(lat)).ravel().copy())
            dlt.append(axis_lattice(deltas))
            wgt.append(axis_lattice(w_owns))
            nrm.append(np.broadcast_to(eye[ax], (o.shape[0], 3)))

        d_in = c1[1:] - c1[:-1]
        w_in = (c1[1:] - edges[ax][1:n_ax]) / d_in
        if n_ax > 1:
            face_block(slice(0, n_ax - 1), slice(1, n_ax), d_in, w_in)
        if lo_bc.kind == "cyclic":
            if abs(w1[0] - w1[-1]) > 1e-12 * max(w1[0], w1[-1]):
                raise ValueError("cyclic axis needs matching end spacings")
            face_block(slice(n_ax - 1, n_ax), slice(0, 1),
                       [0.5 * (w1[0] + w1[-1])], [0.5])
        else:
            slab = [nx, ny, nz]
            slab[ax] = 1
            for side, bc in ((0, lo_bc), (1, hi_bc)):
                i_b = 0 if side == 0 else n_ax - 1
                ob = idx[_lat_index(ax, slice(i_b, i_b + 1), False)].reshape(-1)
                # the ghost sits one cell width out
                patches.append(_patch(f"ax{ax}_{'lo' if side == 0 else 'hi'}",
                                      ob, area_tr.ravel(), w1[i_b], bc, side,
                                      ax, tuple(slab), dtype, device))
    cat = lambda xs, empty: np.concatenate(xs) if xs else empty
    f = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                  device=device)
    ix = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    return FaceListMesh(
        n_cells=nx * ny * nz, owner=ix(cat(own, np.zeros(0, np.int64))),
        neighbour=ix(cat(nei, np.zeros(0, np.int64))),
        mag_sf=f(cat(msf, np.zeros(0))), delta=f(cat(dlt, np.zeros(0))),
        weights=f(cat(wgt, np.zeros(0))),
        normal=f(cat(nrm, np.zeros((0, 3)))), volumes=f(vols),
        centers=f(centers), patches=tuple(patches),
        plan=_box_plan((nx, ny, nz), bcs))
