"""Moving-patch local refinement for the density-based solver.

Port of deepflame_tpu/mesh/patch_amr.py (the role of the reference's
dfDynamicRefineFvMesh refining around the detonation front with refCri =
max|grad rho|, dfHighSpeedFoam.C:113-138): fixed-size fine patches whose
integer offsets track the front, so refinement and unrefinement are data
movement and every shape stays static.

- `MovingPatchAMR`: the coarse solver advances the whole domain; one fine
  patch (ratio r along x, full extent in y and z) takes r substeps of dt/r;
  its outer `buffer_c` coarse cells are re-seeded from the coarse state
  every step; the coarse cells under the fine interior take its block mean;
  with `reflux`, the coarse cells beside the two interface planes take the
  substep-averaged fine flux in place of the coarse one (Berger-Colella),
  so mass and energy telescope. The patch recentres on max|d rho/dx|.
- `FrontPatchAMR2D`: one such patch per band of y rows, each with its own
  offset, so the refined region follows a curved front. All rows advance as
  one batch (the solver's batch axis: rho (R, ...), rhoU (3, R, ...), rhoY
  (ns, R, ...)), one flux evaluation per RK stage and one chemistry drain
  per substep for every row's hot cells, where JAX steps the rows under
  `jax.vmap`.
- `NestedPatchAMR`: a recursive 2:1 cascade of moving patches, x-only or
  isotropic, optionally targeted by `mesh.amr.RefinementCriteria`, with
  refluxing at every level.

Offsets live on the device (int32 tensors, as JAX's): windows are gathers
at computed indices, a start index taken as `jax.lax.dynamic_slice` and
`dynamic_update_slice` take theirs (a negative start wraps once, then it
is clamped into range: `dynamic_slice`, `dynamic_update_slice` here), so a
step reads nothing back to the host for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..solvers.high_speed import HighSpeedSolver, HighSpeedState
from .structured import StructuredMesh, zero_gradient

__all__ = ["MovingPatchAMR", "FrontPatchAMR2D", "NestedPatchAMR", "PatchState"]

_KEYS = ("rho", "rhoU", "rhoE", "rhoY")


class PatchState(NamedTuple):
    coarse: HighSpeedState
    fine: Any               # HighSpeedState, or the next level's PatchState
    offset: torch.Tensor    # int32: coarse-cell index of the patch left edge


def _start(start, size: int, n: int, device):
    """A start index as jax.lax.dynamic_slice and dynamic_update_slice take
    theirs: a negative start counts once from the end (their default
    allow_negative_indices), then it is clamped into [0, size - n]. A Python
    int, or an int64 tensor on `device` for a tensor start."""
    if isinstance(start, int):
        start = start + size if start < 0 else start
        return min(max(start, 0), size - n)
    s = torch.as_tensor(start, device=device).long()
    return torch.clamp(torch.where(s < 0, s + size, s), 0, size - n)


def dynamic_slice(q: torch.Tensor, start, n: int, dim: int) -> torch.Tensor:
    """n entries of q along dim from `start` (int or tensor), the start
    taken as jax.lax.dynamic_slice takes it (`_start`)."""
    s = _start(start, q.shape[dim], n, q.device)
    if isinstance(s, int):
        return q.narrow(dim, s, n)
    return q.index_select(dim, s + torch.arange(n, device=q.device))


def dynamic_update_slice(q: torch.Tensor, patch: torch.Tensor, start,
                         dim: int) -> torch.Tensor:
    """q with `patch` written along dim from `start` (int or tensor), the
    start taken as jax.lax.dynamic_update_slice takes it (`_start`)."""
    n = patch.shape[dim]
    s = _start(start, q.shape[dim], n, q.device)
    if isinstance(s, int):
        out = q.clone()
        out.narrow(dim, s, n).copy_(patch)
        return out
    return q.index_copy(dim, s + torch.arange(n, device=q.device), patch)


def _roll_x(q, shift):
    """jnp.roll(q, -shift, axis=-3) for a tensor shift: out[i] = q[(i +
    shift) mod nx]."""
    nx = q.shape[-3]
    idx = torch.remainder(torch.arange(nx, device=q.device) + shift.long(),
                          nx)
    return q.index_select(-3, idx)


def _x_mask(m):
    """A mask over x (nx,) shaped to broadcast on a (..., nx, ny, nz)
    field."""
    return m.reshape(m.shape + (1, 1))


def _repeat_x(q, r):
    """Piecewise-constant prolongation along axis -3 (x)."""
    return torch.repeat_interleave(q, r, dim=-3)


def _mean_x(q, r):
    """Conservative restriction along axis -3."""
    sh = q.shape
    return q.reshape(sh[:-3] + (sh[-3] // r, r) + sh[-2:]).mean(dim=-3)


def _cons(s: HighSpeedState):
    return (s.rho, s.rhoU, s.rhoE, s.rhoY, s.T)


def _with(s: HighSpeedState, vals) -> HighSpeedState:
    rho, rhoU, rhoE, rhoY, T = vals
    return s._replace(rho=rho, rhoU=rhoU, rhoE=rhoE, rhoY=rhoY, T=T)


def _offset(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _flux_planes(fx, iL: int, iR: int):
    """The x-face planes iL and iR of every conserved flux (static
    indices)."""
    return {k: (fx[k].narrow(-3, iL, 1), fx[k].narrow(-3, iR, 1))
            for k in _KEYS}


def _accumulate(acc, planes):
    if acc is None:
        return planes
    return {k: (acc[k][0] + planes[k][0], acc[k][1] + planes[k][1])
            for k in _KEYS}


def _reflux(sc2: HighSpeedState, fx_c, ff, off, b: int, pc: int, dt,
            hx: float) -> HighSpeedState:
    """Replace the coarse flux at the two interface planes (coarse faces off
    + b and off + pc - b) by the substep-averaged fine flux ff in the
    adjacent outside cells."""
    fixed = []
    for k, qc in zip(_KEYS, _cons(sc2)[:4]):
        fcL = dynamic_slice(fx_c[k], off + b, 1, -3)
        fcR = dynamic_slice(fx_c[k], off + pc - b, 1, -3)
        cL = dynamic_slice(qc, off + b - 1, 1, -3)
        cR = dynamic_slice(qc, off + pc - b, 1, -3)
        cL = cL - (dt / hx) * (ff[k][0] - fcL)
        cR = cR + (dt / hx) * (ff[k][1] - fcR)
        qc = dynamic_update_slice(qc, cL, off + b - 1, -3)
        qc = dynamic_update_slice(qc, cR, off + pc - b, -3)
        fixed.append(qc)
    return _with(sc2, tuple(fixed) + (sc2.T,))


def _with_T(solver: HighSpeedSolver, s: HighSpeedState) -> HighSpeedState:
    """T re-derived from the conserved variables."""
    return s._replace(T=solver.primitives(s)[3])


def _max_grad_x(rho):
    """argmax over x-faces of max |d rho| across the face (first maximum,
    as JAX's argmax)."""
    g = torch.diff(rho, dim=0).abs()
    return g.reshape(g.shape[0], -1).amax(dim=1).argmax()


@dataclasses.dataclass(frozen=True)
class MovingPatchAMR:
    """One fine moving patch over a coarse HighSpeedSolver domain."""
    coarse: HighSpeedSolver
    fine: HighSpeedSolver            # mesh: (pc * r, ny, nz), dx/r spacing
    ratio: int
    pc: int                          # patch extent in coarse cells
    buffer_c: int = 4                # buffer width in coarse cells (per side)
    # Berger-Colella refluxing at the two coarse-fine interface planes; one
    # more flux evaluation per RK stage (step_with_flux_x)
    reflux: bool = False

    @staticmethod
    def build(coarse: HighSpeedSolver, pc: int, ratio: int = 4,
              buffer_c: int = 4, reflux: bool = False) -> "MovingPatchAMR":
        m = coarse.mesh
        fine_mesh = StructuredMesh(pc * ratio, m.ny, m.nz, m.dx / ratio, m.dy,
                                   m.dz, m.x0, m.y0, m.z0, device=m.device)
        fine = dataclasses.replace(coarse, mesh=fine_mesh)
        return MovingPatchAMR(coarse=coarse, fine=fine, ratio=ratio, pc=pc,
                              buffer_c=buffer_c, reflux=reflux)

    def _slice_c(self, q, off, n):
        """x-window [off, off + n) of a coarse field (any leading dims)."""
        return dynamic_slice(q, off, n, -3)

    def _insert_c(self, q, patch, off):
        return dynamic_update_slice(q, patch, off, -3)

    def prolong(self, sc: HighSpeedState, off) -> HighSpeedState:
        """Fine-patch state from the coarse window (p.w. constant)."""
        vals = tuple(_repeat_x(self._slice_c(q, off, self.pc), self.ratio)
                     for q in _cons(sc))
        return HighSpeedState(*vals, time=sc.time)

    def initial_state(self, p, T, Y, U=None, time=0.0,
                      offset: int = 0) -> PatchState:
        sc = self.coarse.initial_state(p, T, Y, U, time)
        off = _offset(offset, self.coarse.device)
        return PatchState(coarse=sc, fine=self.prolong(sc, off), offset=off)

    def step(self, ps: PatchState, dt) -> tuple[PatchState, dict]:
        r, b, pc = self.ratio, self.buffer_c, self.pc
        sc, sf, off = ps
        dev = sc.rho.device

        # 1. coarse step over the whole domain
        if self.reflux:
            sc2, diag_c, fx_c = self.coarse.step_with_flux_x(sc, dt)
        else:
            sc2, diag_c = self.coarse.step(sc, dt)

        # 2. re-seed the fine buffer zones from the start-of-step coarse
        nxf = pc * r
        ix = torch.arange(nxf, device=dev)
        in_buf = (ix < b * r) | (ix >= nxf - b * r)
        seeded = [torch.where(_x_mask(in_buf),
                              _repeat_x(self._slice_c(qc, off, pc), r), qf)
                  for qf, qc in zip(_cons(sf), _cons(sc))]
        sf = _with(sf, seeded)

        # 3. fine substeps (dx/r at dt/r); with reflux, the fine fluxes at
        #    the interface planes (static fine faces b r and (pc - b) r)
        #    summed over the substeps
        acc = None
        fine_diags = []
        for _ in range(r):
            if self.reflux:
                sf, d, fx = self.fine.step_with_flux_x(sf, dt / r)
                acc = _accumulate(acc, _flux_planes(fx, b * r, (pc - b) * r))
            else:
                sf, d = self.fine.step(sf, dt / r)
            fine_diags.append(d)
        sf2 = sf

        # 4. conservative restriction of the fine interior onto the coarse
        restricted = []
        for qf, qc in zip(_cons(sf2), _cons(sc2)):
            qr = _mean_x(qf, r)
            inner = self._slice_c(qr, b, pc - 2 * b) if b > 0 else qr
            restricted.append(self._insert_c(qc, inner, off + b))
        sc2 = _with(sc2, restricted)

        # 4b. refluxing: the substep-averaged fine flux replaces the coarse
        #     one in the outside cells beside the interfaces
        if self.reflux:
            ff = {k: (acc[k][0] / r, acc[k][1] / r) for k in _KEYS}
            sc2 = _reflux(sc2, fx_c, ff, off, b, pc, dt, self.coarse.mesh.dx)
        sc2 = _with_T(self.coarse, sc2)

        # 5. recentre on the front: refCri = max|grad rho| on the coarse
        nxc = self.coarse.mesh.nx
        i_front = _max_grad_x(sc2.rho).to(torch.int32)
        off_new = torch.clamp(i_front - pc // 2, 0, nxc - pc).to(torch.int32)
        # shift the fine data; newly exposed cells, and cells whose source
        # lies in the old buffer zones (seeded and advanced but never
        # restricted), take the coarse prolongation
        shift_f = (off_new - off) * r
        fresh = self.prolong(sc2, off_new)
        src = ix + shift_f
        valid = (src >= b * r) & (src < nxf - b * r)
        shifted = [torch.where(_x_mask(valid), _roll_x(qf, shift_f), qp)
                   for qf, qp in zip(_cons(sf2), _cons(fresh))]
        sf2 = _with(fresh, shifted)._replace(time=sc2.time)

        diag = dict(diag_c)
        diag["patch_offset"] = off_new
        diag["T_max"] = torch.maximum(diag_c["T_max"], sf2.T.max())
        _fine_chem(diag, fine_diags)
        return PatchState(coarse=sc2, fine=sf2, offset=off_new), diag


def _fine_chem(diag: dict, fine_diags) -> None:
    """The fine substeps' chemistry drains in the diagnostics: active lanes
    and trips per substep (of the level below, in a nest)."""
    if fine_diags and "chem_lanes" in fine_diags[0]:
        diag["fine_chem_lanes"] = [d["chem_lanes"] for d in fine_diags]
        diag["fine_chem_trips"] = [d["chem_trips"] for d in fine_diags]


class RowPatchState(NamedTuple):
    coarse: HighSpeedState
    fine: HighSpeedState     # batch axis of rows: rho (R, ...), rhoU (3, R,
                             # ...), rhoY (ns, R, ...), time (R,)
    offsets: torch.Tensor    # (R,) int32 per-row patch x-offsets


def _zg_bcs_y(bcs):
    """The y-axis BC pair replaced by zeroGradient (patch-interior edges are
    buffer-seeded from the coarse state, never real boundaries)."""
    zg = zero_gradient()
    return (bcs[0], (zg, zg), bcs[2])


@dataclasses.dataclass(frozen=True)
class FrontPatchAMR2D:
    """Front-shaped moving refinement: one fine x-patch per band of y rows,
    each with its own x-offset tracking the local front.

    Each row patch covers (pc coarse cells in x) x (nyb + 2 buffer_y in y),
    refined `ratio`x along x. Row patches overlap their neighbours by
    buffer_y rows; the x- and y-buffers are re-seeded from the coarse state
    every coarse step and left out of the restriction. The y BCs of the
    patch solver are zeroGradient under the seeded buffers."""
    coarse: HighSpeedSolver
    fine: HighSpeedSolver            # mesh: (pc r, nyb + 2 by, nz)
    ratio: int
    pc: int
    n_rows: int
    buffer_c: int = 4                # x-buffer width [coarse cells, per side]
    buffer_y: int = 4                # y-buffer width [cells, per side]

    @staticmethod
    def build(coarse: HighSpeedSolver, pc: int, n_rows: int, ratio: int = 4,
              buffer_c: int = 4, buffer_y: int = 4) -> "FrontPatchAMR2D":
        m = coarse.mesh
        if m.ny % n_rows:
            raise ValueError(f"ny = {m.ny} is not a multiple of n_rows = "
                             f"{n_rows}")
        nyb = m.ny // n_rows
        fine_mesh = StructuredMesh(pc * ratio, nyb + 2 * buffer_y, m.nz,
                                   m.dx / ratio, m.dy, m.dz, m.x0, m.y0, m.z0,
                                   device=m.device)
        fine = dataclasses.replace(
            coarse, mesh=fine_mesh, bcs_rho=_zg_bcs_y(coarse.bcs_rho),
            bcs_U=tuple(_zg_bcs_y(b) for b in coarse.bcs_U),
            bcs_p=_zg_bcs_y(coarse.bcs_p), bcs_Y=_zg_bcs_y(coarse.bcs_Y))
        return FrontPatchAMR2D(coarse=coarse, fine=fine, ratio=ratio, pc=pc,
                               n_rows=n_rows, buffer_c=buffer_c,
                               buffer_y=buffer_y)

    @property
    def nyb(self):
        return self.coarse.mesh.ny // self.n_rows

    def _pad_y(self, q):
        """Edge-replicated pad by buffer_y along y, so that every row window
        gathers without clamping."""
        by = self.buffer_y
        n = q.shape[-2]
        idx = torch.clamp(torch.arange(-by, n + by, device=q.device), 0,
                          n - 1)
        return q.index_select(-2, idx)

    def _window(self, q_pady, offs, y0, nx: int, ny: int):
        """Per-row windows (..., R, nx, ny, nz) of a field (..., NX, NY, nz):
        row j from x offs[j] and y y0[j], each start taken as
        jax.lax.dynamic_slice takes it."""
        dev = q_pady.device
        xs = _start(offs, q_pady.shape[-3], nx, dev)
        ys = _start(y0, q_pady.shape[-2], ny, dev)
        xi = xs[:, None, None] + torch.arange(nx, device=dev)[None, :, None]
        yi = ys[:, None, None] + torch.arange(ny, device=dev)[None, None, :]
        return q_pady[..., xi, yi, :]

    def _row_y0(self, dev):
        return torch.arange(self.n_rows, device=dev) * self.nyb

    def _project(self, q, offs):
        """Row windows of a coarse field, prolonged along x."""
        nyf = self.nyb + 2 * self.buffer_y
        return _repeat_x(self._window(self._pad_y(q), offs,
                                      self._row_y0(q.device), self.pc, nyf),
                         self.ratio)

    def prolong_rows(self, sc: HighSpeedState, offs) -> HighSpeedState:
        """Per-row fine states from coarse windows (p.w. constant in x)."""
        vals = tuple(self._project(q, offs) for q in _cons(sc))
        t = sc.time.expand(self.n_rows)
        return HighSpeedState(*vals, time=t)

    def _fronts(self, rho):
        """Per-row front x-index from max |d rho/dx| within the row."""
        g = torch.diff(rho, dim=0).abs().amax(dim=2)          # (nx-1, ny)
        gr = g.reshape(g.shape[0], self.n_rows, self.nyb).amax(dim=2)
        return gr.argmax(dim=0).to(torch.int32)               # (n_rows,)

    def initial_state(self, p, T, Y, U=None, time=0.0) -> RowPatchState:
        sc = self.coarse.initial_state(p, T, Y, U, time)
        nxc = self.coarse.mesh.nx
        offs = torch.clamp(self._fronts(sc.rho) - self.pc // 2, 0,
                           nxc - self.pc).to(torch.int32)
        return RowPatchState(coarse=sc, fine=self.prolong_rows(sc, offs),
                             offsets=offs)

    def step(self, ps: RowPatchState, dt) -> tuple[RowPatchState, dict]:
        r, b, by = self.ratio, self.buffer_c, self.buffer_y
        pc, nyb = self.pc, self.nyb
        sc, sf, offs = ps
        dev = sc.rho.device

        # 1. coarse step over the whole domain
        sc2, diag_c = self.coarse.step(sc, dt)

        # 2. re-seed the x- and y-buffers of every row patch from the
        #    start-of-step coarse state
        nxf, nyf = pc * r, nyb + 2 * by
        ix = torch.arange(nxf, device=dev)
        iy = torch.arange(nyf, device=dev)
        in_buf = ((ix[:, None] < b * r) | (ix[:, None] >= nxf - b * r)
                  | (iy[None, :] < by) | (iy[None, :] >= nyf - by))[..., None]
        sf = _with(sf, [torch.where(in_buf, self._project(qc, offs), qf)
                        for qf, qc in zip(_cons(sf), _cons(sc))])

        # 3. fine substeps, every row in one batched step
        fine_diags = []
        for _ in range(r):
            sf, d = self.fine.step(sf, dt / r)
            fine_diags.append(d)
        sf2 = sf

        # 4. conservative restriction of each row interior onto the coarse
        #    (the rows' y ranges are disjoint, so one scatter does what
        #    JAX's scan of dynamic_update_slice does)
        nxc, nyc = self.coarse.mesh.nx, self.coarse.mesh.ny
        xs = _start(offs + b, nxc, pc - 2 * b, dev)
        ys = _start(self._row_y0(dev), nyc, nyb, dev)
        xi = xs[:, None, None] + torch.arange(pc - 2 * b,
                                              device=dev)[None, :, None]
        yi = ys[:, None, None] + torch.arange(nyb, device=dev)[None, None, :]
        restricted = []
        for qf, qc in zip(_cons(sf2), _cons(sc2)):
            inner = _mean_x(qf, r)[..., b:pc - b, by:by + nyb, :]
            out = qc.clone()
            out[..., xi, yi, :] = inner
            restricted.append(out)
        sc2 = _with_T(self.coarse, _with(sc2, restricted))

        # 5. recentre each row on its local front
        offs_new = torch.clamp(self._fronts(sc2.rho) - pc // 2, 0,
                               nxc - pc).to(torch.int32)

        # 6. shift the fine data per row; newly exposed cells take the
        #    coarse prolongation. Cells whose source lies in the old buffer
        #    zones keep the rolled buffer data (JAX does not exclude them,
        #    unlike MovingPatchAMR)
        fresh = self.prolong_rows(sc2, offs_new)
        shift_f = (offs_new - offs).long() * r                # (R,)
        src = ix[None, :] + shift_f[:, None]                  # (R, nxf)
        valid = ((src >= 0) & (src < nxf))[..., None, None]
        rows = torch.arange(self.n_rows, device=dev)[:, None]
        roll_idx = torch.remainder(src, nxf)
        shifted = [torch.where(valid, qf[..., rows, roll_idx, :, :], qp)
                   for qf, qp in zip(_cons(sf2), _cons(fresh))]
        sf2 = _with(fresh, shifted)._replace(
            time=sc2.time.expand(self.n_rows))

        diag = dict(diag_c)
        diag["patch_offsets"] = offs_new
        diag["T_max"] = torch.maximum(diag_c["T_max"], sf2.T.max())
        _fine_chem(diag, fine_diags)
        return RowPatchState(coarse=sc2, fine=sf2, offsets=offs_new), diag


# ===================================================================== nested

def _repeat_axes(q, r, axes):
    """Piecewise-constant prolongation along the given spatial axes (0 = x,
    1 = y, 2 = z; the trailing three dims of the field)."""
    for ax in axes:
        q = torch.repeat_interleave(q, r, dim=ax - 3)
    return q


def _mean_axes(q, r, axes):
    """Conservative restriction (block mean) along the given spatial
    axes."""
    for ax in axes:
        d = q.ndim + ax - 3
        n = q.shape[d]
        q = q.reshape(q.shape[:d] + (n // r, r) + q.shape[d + 1:]).mean(
            dim=d + 1)
    return q


@dataclasses.dataclass(frozen=True)
class NestedPatchAMR:
    """Multi-level 2:1 moving-patch refinement (dfDynamicRefineFvMesh's
    maxRefinement cascade; hexRef8-style cube split when isotropic).

    Each level is a fixed-shape fine patch refined `ratio`x along x and, if
    isotropic, along every non-degenerate transverse axis. Level l+1's patch
    lives inside level l's fine array with its own x-offset, each level
    substepping `ratio`x in time. Unrefinement is the moving window itself.
    The state is a recursive PatchState (fine = the next level's
    PatchState); on a window shift the child's offset is re-anchored so
    that deeper data stays fixed in space."""
    coarse: HighSpeedSolver
    fine: HighSpeedSolver
    child: "NestedPatchAMR | None"
    ratio: int
    pc: int
    buffer_c: int = 2
    axes: tuple = (0,)
    # RefinementCriteria (mesh/amr.py): the window targets the lead edge of
    # the marked cells in place of max|grad rho|
    criteria: "object | None" = None
    # Berger-Colella refluxing at every level's x-interfaces
    reflux: bool = False
    # window clamp in this level's coarse x-cells: a child window stays out
    # of its parent's seeded buffer zone (set by the parent at build time)
    x_margin: int = 0

    @staticmethod
    def build(coarse: HighSpeedSolver, pcs, ratio: int = 2,
              buffer_c: int = 2, isotropic: bool = True,
              criteria=None, reflux: bool = False) -> "NestedPatchAMR":
        """pcs: per-level patch extents, each in the parent level's x-cells
        (e.g. (16, 8) = two levels). isotropic refines every
        non-degenerate axis; False refines x only. criteria: an optional
        RefinementCriteria driving the window target."""
        m = coarse.mesh
        axes = tuple(ax for ax in range(3)
                     if ax == 0 or (isotropic and m.shape[ax] > 1))
        pc = pcs[0]
        dims = [pc * ratio if 0 in axes else pc,
                m.ny * ratio if 1 in axes else m.ny,
                m.nz * ratio if 2 in axes else m.nz]
        sp = [m.dx / ratio if 0 in axes else m.dx,
              m.dy / ratio if 1 in axes else m.dy,
              m.dz / ratio if 2 in axes else m.dz]
        fine_mesh = StructuredMesh(dims[0], dims[1], dims[2], sp[0], sp[1],
                                   sp[2], m.x0, m.y0, m.z0, device=m.device)
        fine = dataclasses.replace(coarse, mesh=fine_mesh)
        child = (NestedPatchAMR.build(fine, pcs[1:], ratio, buffer_c,
                                      isotropic, criteria, reflux)
                 if len(pcs) > 1 else None)
        if child is not None:
            rx = ratio if 0 in axes else 1
            child = dataclasses.replace(child, x_margin=buffer_c * rx)
        return NestedPatchAMR(coarse=coarse, fine=fine, child=child,
                              ratio=ratio, pc=pc, buffer_c=buffer_c,
                              axes=axes, criteria=criteria, reflux=reflux)

    def _slice_c(self, q, off, n):
        return dynamic_slice(q, off, n, -3)

    def _insert_c(self, q, patch, off):
        return dynamic_update_slice(q, patch, off, -3)

    def prolong(self, sc, off):
        vals = tuple(_repeat_axes(self._slice_c(q, off, self.pc), self.ratio,
                                  self.axes) for q in _cons(sc))
        return HighSpeedState(*vals, time=sc.time)

    def initial_fine(self, sc, offset: int = 0) -> PatchState:
        off = _offset(offset, sc.rho.device)
        sf = self.prolong(sc, off)
        fine = (self.child.initial_fine(
            sf, (self.fine.mesh.nx - self.child.pc) // 2)
            if self.child is not None else sf)
        return PatchState(coarse=sc, fine=fine, offset=off)

    def initial_state(self, p, T, Y, U=None, time=0.0,
                      offset: int = 0) -> PatchState:
        sc = self.coarse.initial_state(p, T, Y, U, time)
        return self.initial_fine(sc, offset)

    def _base(self, fine):
        """The fine solver's HighSpeedState inside a (nested) fine."""
        return fine.coarse if isinstance(fine, PatchState) else fine

    def _set_base(self, fine, base):
        return (fine._replace(coarse=base) if isinstance(fine, PatchState)
                else base)

    def _fine_step(self, fine, dt_f, want_flux: bool):
        """One substep of the fine level (recursive through deeper levels):
        (fine, diag[, x-fluxes of the fine solver])."""
        if self.child is None:
            if want_flux:
                return self.fine.step_with_flux_x(fine, dt_f)
            return self.fine.step(fine, dt_f)
        return self.child.step(fine, dt_f, want_flux_x=want_flux)

    def step(self, ps: PatchState, dt, want_flux_x: bool = False):
        r, b, pc = self.ratio, self.buffer_c, self.pc
        sc, fine, off = ps
        sf = self._base(fine)
        dev = sc.rho.device

        # 1. this level's coarse step over its whole extent
        fx_c = None
        if self.reflux or want_flux_x:
            sc2, diag_c, fx_c = self.coarse.step_with_flux_x(sc, dt)
        else:
            sc2, diag_c = self.coarse.step(sc, dt)

        # 2. seed the fine x-buffer zones from the start-of-step coarse
        rx = r if 0 in self.axes else 1
        nxf = pc * rx
        ix = torch.arange(nxf, device=dev)
        in_buf = (ix < b * rx) | (ix >= nxf - b * rx)
        seeded = [torch.where(_x_mask(in_buf),
                              _repeat_axes(self._slice_c(qc, off, pc), r,
                                           self.axes), qf)
                  for qf, qc in zip(_cons(sf), _cons(sc))]
        fine = self._set_base(fine, _with(sf, seeded))

        # 3. fine substeps; with reflux, this level's fine fluxes at its two
        #    x-interface planes (static fine faces), summed over the
        #    substeps (deeper levels reflux themselves)
        acc = None
        fine_diags = []
        for _ in range(r):
            out = self._fine_step(fine, dt / r, self.reflux)
            fine = out[0]
            fine_diags.append(out[1])
            if self.reflux:
                acc = _accumulate(acc, _flux_planes(out[2], b * rx,
                                                    (pc - b) * rx))
        fine2 = fine
        sf2 = self._base(fine2)

        # 4. conservative restriction of the fine interior onto the coarse
        restricted = []
        for qf, qc in zip(_cons(sf2), _cons(sc2)):
            qr = _mean_axes(qf, r, self.axes)
            inner = self._slice_c(qr, b, pc - 2 * b) if b > 0 else qr
            restricted.append(self._insert_c(qc, inner, off + b))
        sc2 = _with(sc2, restricted)

        # 4b. refluxing with the substep-averaged, transverse-restricted
        #     fine fluxes
        if self.reflux:
            t_ax = [a for a in self.axes if a != 0]
            ff = {k: (_mean_axes(acc[k][0] / r, r, t_ax),
                      _mean_axes(acc[k][1] / r, r, t_ax)) for k in _KEYS}
            sc2 = _reflux(sc2, fx_c, ff, off, b, pc, dt, self.coarse.mesh.dx)
        sc2 = _with_T(self.coarse, sc2)

        # 5. recentre: on the lead edge of the marked cells with criteria,
        #    else on max|grad rho|
        nxc = self.coarse.mesh.nx
        if self.criteria is not None:
            from .amr import mark_cells
            rhoI, U, p_f, T_f, Y_f = self.coarse.primitives(sc2)
            fields = {"rho": sc2.rho, "T": T_f, "p": p_f, "U": U}
            for k, i_sp in getattr(self.criteria, "species", ()):
                fields[k] = Y_f[i_sp]
            mark = mark_cells(self.criteria, fields, self.coarse.bcs_rho,
                              self.coarse.mesh)
            m_x = mark.sum(dim=(1, 2)) > 0
            tot = m_x.sum()
            ixc = torch.arange(nxc, device=dev)
            # lead edge of the marked set, at 3/4 of the window: a front's
            # wake can mark a span far longer than the window
            i_lead = torch.where(m_x, ixc, torch.full_like(ixc, -1)).max()
            tgt = i_lead - (3 * pc) // 4 + pc // 2
            i_front = torch.where(tot > 0, tgt, off.long() + pc // 2)
        else:
            i_front = _max_grad_x(sc2.rho)
        # lo > hi gives hi, as jnp.clip does
        off_new = torch.clamp(i_front.to(torch.int32) - pc // 2,
                              self.x_margin,
                              nxc - pc - self.x_margin).to(torch.int32)
        fine2 = self._reframe(fine2, sc2, off, off_new)

        diag = dict(diag_c)
        diag["patch_offset"] = off_new
        diag["T_max"] = torch.maximum(diag_c["T_max"], sf2.T.max())
        _fine_chem(diag, fine_diags)
        ps2 = PatchState(coarse=sc2, fine=fine2, offset=off_new)
        if want_flux_x:
            return ps2, diag, fx_c
        return ps2, diag

    def _reframe(self, fine, base_new, off_data, off_new):
        """Re-anchor this level's fine structure from window position
        off_data to off_new over the updated parent state base_new: roll the
        retained data, fill newly exposed cells by prolongation, and
        re-anchor deeper windows so that their data stays fixed in space."""
        rx = self.ratio if 0 in self.axes else 1
        sf = self._base(fine)
        shift_f = (off_new.long() - torch.as_tensor(off_data).long()) * rx
        fresh = self.prolong(base_new, off_new)
        nxf = self.pc * rx
        ix = torch.arange(nxf, device=sf.rho.device)
        # roll sources in the old buffer zones (never restricted) take the
        # prolongation
        src = ix + shift_f
        valid = (src >= self.buffer_c * rx) & (src < nxf
                                               - self.buffer_c * rx)
        shifted = [torch.where(_x_mask(valid), _roll_x(qf, shift_f),
                               qp)
                   for qf, qp in zip(_cons(sf), _cons(fresh))]
        sf_new = _with(fresh, shifted)._replace(time=base_new.time)
        if self.child is None:
            return sf_new
        # the child's data anchor in this level's new frame
        a_child = fine.offset.long() - shift_f
        c_new = torch.clamp(a_child, self.child.x_margin,
                            nxf - self.child.pc
                            - self.child.x_margin).to(torch.int32)
        child_fine = self.child._reframe(fine.fine, sf_new, a_child, c_new)
        return PatchState(coarse=sf_new, fine=child_fine, offset=c_new)
