"""Domain decomposition of the face-list (general mesh) low-Mach solver.

Port of deepflame_tpu/parallel/distributed_fl.py (the reference's
decomposePar of any polyMesh, processor patches and the GPU port's
processor halos over the CSR path). `FLDecomp` is host numpy, line for line
the JAX package's, so that its arrays are the JAX package's integer for
integer:

- cells go to P contiguous slabs of an ordering (default: by the cell
  centre along the mesh's longest extent; `block_order` makes the slabs
  (gx, gy, gz) blocks), sized by `native.partition_slabs`;
- shard r's cell array is [owned (padded to the largest shard) | halo]:
  halo slots hold copies of other shards' cells one face away;
- a face touching an owned cell lives on the shard (a crossing face on
  both), so every operator runs locally; scatters into halo rows are
  dropped by `FaceListMesh.restrict` and the halo rows refreshed by
  `FaceListMesh.exchange`, one point-to-point message per ring offset.

`DistributedLowMachFL` runs a LowMachSolverFL on shard r = the rank in its
process group: the rank's row of the decomposition (the JAX package's
`_take0` of its shard_map block), Krylov and diagnostic reductions by
`all_reduce`, means over the owned cells (`cell_weight`). A shard-local mesh
has no shift plan: its pressure CG runs `ell_matvec` where the solver has
`p_ell` (the shard's own connectivity, pad faces left out) and Jacobi in
place of AMG. The caller starts the ranks and the process group:

    dist = DistributedLowMachFL(solver)       # every rank, same solver
    ds = dist.shard_state(state)
    ds, diag = dist.step(ds, dt)
    s = dist.gather_state(ds)                 # on every rank
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.facelist import FaceListMesh, ell_arrays
from ..native import partition_slabs
from ..solvers.low_mach_fl import LowMachFLState, LowMachSolverFL
from .context import ShardGroup, cell_weight, shard_axis

__all__ = ["FLDecomp", "DistributedLowMachFL", "block_order"]


def block_order(centers, grid) -> np.ndarray:
    """Recursive-coordinate-bisection ordering of the cells for a
    multi-axis decomposition: sort by x, split into grid[0] groups, sort
    each by y, split into grid[1], then z, so that FLDecomp's contiguous
    slabs of this order are (gx, gy, gz) blocks. The leaf groups take the
    sizes of `partition_slabs(n, prod(grid))`' slabs, so n need not divide
    (every slab balanced to within one cell)."""
    centers = np.asarray(centers)
    n = centers.shape[0]
    Pn = int(np.prod(grid))
    sizes = np.diff(partition_slabs(n, Pn))
    # each group: its cells and the half-open range of leaf slabs it covers
    groups = [(np.arange(n), 0, Pn)]
    stride = Pn
    for ax, g in enumerate(grid):
        g = int(g)
        stride //= g
        if g == 1:
            continue
        nxt = []
        for ids, lo, hi in groups:
            o = ids[np.argsort(centers[ids, ax], kind="stable")]
            off = 0
            for j in range(g):
                a, b = lo + j * stride, lo + (j + 1) * stride
                cnt = int(sizes[a:b].sum())
                nxt.append((o[off:off + cnt], a, b))
                off += cnt
            assert off == len(o), (off, len(o))
        groups = nxt
    assert all(len(ids) == sizes[lo] for ids, lo, hi in groups
               if hi - lo == 1)
    return np.concatenate([g[0] for g in groups])


def _patch_axis(normal: np.ndarray) -> int | None:
    """Dominant normal axis of a patch from its first face's normal (None
    for an empty patch)."""
    if normal.shape[0] == 0:
        return None
    return int(np.argmax(np.abs(normal[0])))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class FLDecomp:
    """Host decomposition of one face-list connectivity into n_shards.

    Every field mesh of a solver shares the connectivity (its own boundary
    coefficients), so one decomposition localizes them all. Arrays are
    stacked over the shards, (P, ...), as the JAX package's."""

    def __init__(self, mesh: FaceListMesh, n_shards: int,
                 order: np.ndarray | None = None):
        self.n_shards = int(n_shards)
        Pn = self.n_shards
        own = _host(mesh.owner).astype(np.int64)
        nei = _host(mesh.neighbour).astype(np.int64)
        n = mesh.n_cells
        centers = _host(mesh.centers)
        if order is None:
            ext = centers.max(axis=0) - centers.min(axis=0)
            order = np.argsort(centers[:, int(np.argmax(ext))], kind="stable")
        order = np.asarray(order, np.int64)
        starts = partition_slabs(n, Pn)
        shard_of = np.empty(n, np.int32)
        pos_in = np.empty(n, np.int64)
        owned = []
        for r in range(Pn):
            ids = order[starts[r]:starts[r + 1]]
            owned.append(ids)
            shard_of[ids] = r
            pos_in[ids] = np.arange(ids.shape[0])
        self._owned = owned
        self._shard_of = shard_of
        n_own_max = max(len(o) for o in owned)

        # halo sets and local face lists per shard
        halos, loc_faces = [], []
        for r in range(Pn):
            fsel = np.where((shard_of[own] == r) | (shard_of[nei] == r))[0]
            loc_faces.append(fsel)
            cells = np.concatenate([own[fsel], nei[fsel]])
            halos.append(np.unique(cells[shard_of[cells] != r]))
        n_halo_max = max((len(h) for h in halos), default=0)
        self.n_own_max = n_own_max
        self.n_loc = n_own_max + n_halo_max
        self.nf_loc = max((len(f) for f in loc_faces), default=1)
        self._halos = halos

        # local index of a global cell per shard (-1: absent)
        lidx = -np.ones((Pn, n), np.int64)
        for r in range(Pn):
            lidx[r, owned[r]] = pos_in[owned[r]]
            lidx[r, halos[r]] = n_own_max + np.arange(len(halos[r]))
        self._lidx = lidx

        # cell slot -> global id (pads repeat the shard's first owned cell)
        cell_gid = np.empty((Pn, self.n_loc), np.int64)
        w_own = np.zeros((Pn, self.n_loc))
        for r in range(Pn):
            cell_gid[r, :] = owned[r][0]
            cell_gid[r, :len(owned[r])] = owned[r]
            cell_gid[r, n_own_max:n_own_max + len(halos[r])] = halos[r]
            w_own[r, :len(owned[r])] = 1.0
        self.cell_gid = cell_gid
        self._w_own = w_own

        # local faces sorted by local owner; pads point at the last slot
        # with zero area
        self.face_gid = -np.ones((Pn, self.nf_loc), np.int64)
        self._f_own = np.full((Pn, self.nf_loc), self.n_loc - 1, np.int64)
        self._f_nei = np.full((Pn, self.nf_loc), self.n_loc - 1, np.int64)
        self._f_perm = []
        for r in range(Pn):
            f = loc_faces[r]
            lo = lidx[r, own[f]]
            ln = lidx[r, nei[f]]
            srt = np.argsort(lo, kind="stable")
            self._f_perm.append(srt)
            k = len(f)
            self.face_gid[r, :k] = f[srt]
            self._f_own[r, :k] = lo[srt]
            self._f_nei[r, :k] = ln[srt]

        # the shard and slot each global face is gathered back from (a
        # crossing face is on two shards with one value; the last wins)
        self._face_src = np.empty((own.shape[0], 2), np.int64)
        for r in range(Pn):
            valid = self.face_gid[r] >= 0
            self._face_src[self.face_gid[r, valid], 0] = r
            self._face_src[self.face_gid[r, valid], 1] = np.where(valid)[0]

        # halo maps per ring offset d: shard t receives its offset-d halos
        # from shard (t + d) % P
        offsets = sorted({int((shard_of[g] - r) % Pn)
                          for r in range(Pn) for g in halos[r]})
        self.halo_offsets = offsets
        self._halo_maps = {}
        for d in offsets:
            per_t = []
            for t in range(Pn):
                s = (t + d) % Pn
                cells = [g for g in halos[t] if shard_of[g] == s]
                per_t.append(np.asarray(cells, np.int64))
            B = max((len(c) for c in per_t), default=0)
            send = np.zeros((Pn, max(B, 1)), np.int64)
            recv = np.full((Pn, max(B, 1)), self.n_loc, np.int64)  # drop
            for t in range(Pn):
                s = (t + d) % Pn
                cells = per_t[t]
                if len(cells):
                    send[s, :len(cells)] = pos_in[cells]
                    recv[t, :len(cells)] = lidx[t, cells]
            self._halo_maps[d] = (send, recv)

        # per-patch local face selections (the owner's shard)
        self._patch_sel = []
        for p in mesh.patches:
            pown = _host(p.owner).astype(np.int64)
            sels, counts = [], []
            for r in range(Pn):
                ids = np.where(shard_of[pown] == r)[0]
                sels.append(ids)
                counts.append(len(ids))
            nb_loc = max(counts) if counts else 0
            sel = np.zeros((Pn, max(nb_loc, 0)), np.int64)
            for r in range(Pn):
                sel[r, :counts[r]] = sels[r]
            self._patch_sel.append((sel, np.asarray(counts), nb_loc))

        # the ELL incidence of each shard, pad faces left out, one width
        # (the largest) for every shard
        pads = self.face_gid < 0
        w_ell = max(int(np.bincount(np.concatenate(
            [self._f_own[r][~pads[r]], self._f_nei[r][~pads[r]]]),
            minlength=self.n_loc).max()) for r in range(Pn))
        self._w_ell = w_ell
        self._mesh0 = mesh

    # ------------------------------------------------------------ localize
    def pad_faces(self, r: int) -> np.ndarray:
        """(nf_loc,) mask of shard r's pad faces."""
        return self.face_gid[r] < 0

    def _faces(self, x, r: int, pad=0.0) -> np.ndarray:
        x = _host(x)
        out = np.full((self.nf_loc,) + x.shape[1:], pad, x.dtype)
        valid = self.face_gid[r] >= 0
        out[valid] = x[self.face_gid[r, valid]]
        return out

    def localize_mesh(self, mesh: FaceListMesh, r: int) -> FaceListMesh:
        """Shard r's FaceListMesh of a field mesh over this decomposition's
        connectivity, on the mesh's device in its dtype: the JAX package's
        stacked localize_mesh, row r."""
        assert mesh.n_cells == self._mesh0.n_cells
        assert np.array_equal(_host(mesh.owner), _host(self._mesh0.owner))
        dev = mesh.device
        dt = mesh.mag_sf.dtype
        f = lambda a, dtype=dt: torch.as_tensor(a, dtype=dtype, device=dev)
        patches = []
        for ip, p in enumerate(mesh.patches):
            sel, counts, nb_loc = self._patch_sel[ip]
            n_axis = (p.n_axis if p.n_axis is not None
                      else _patch_axis(_host(p.normal)))
            if nb_loc == 0:
                # present but empty on every shard: kept, so that patch
                # indices line up with the global mesh's
                patches.append(dataclasses.replace(
                    p, owner=f(np.zeros(0), torch.int64),
                    mag_sf=f(np.zeros(0)), delta=f(np.ones(0)),
                    a=f(np.ones(0)), b=f(np.zeros(0)),
                    normal=f(np.zeros((0, 3))), n_axis=n_axis,
                    k_no=None if p.k_no is None else f(np.zeros((0, 3)))))
                continue
            pown = _host(p.owner).astype(np.int64)
            k = counts[r]

            def pf(x, pad):
                x = _host(x)
                out = np.full((nb_loc,) + x.shape[1:], pad, x.dtype)
                out[:k] = x[sel[r, :k]]
                return out

            owner_loc = np.full(nb_loc, self.n_loc - 1, np.int64)
            owner_loc[:k] = self._lidx[r, pown[sel[r, :k]]]
            nrm = pf(p.normal, 0.0)
            nrm[k:, 0] = 1.0                     # pad normal = e_x
            patches.append(dataclasses.replace(
                p, owner=f(owner_loc, torch.int64),
                mag_sf=f(pf(p.mag_sf, 0.0)), delta=f(pf(p.delta, 1.0)),
                a=f(pf(p.a, 1.0)), b=f(pf(p.b, 0.0)), normal=f(nrm),
                n_axis=n_axis,
                k_no=None if p.k_no is None else f(pf(p.k_no, 0.0))))
        pads = self.pad_faces(r)
        ell_f, ell_s = ell_arrays(self._f_own[r], self._f_nei[r], self.n_loc,
                                  self._w_ell, exclude=pads)
        halo = {d: (f(send[r], torch.int32), f(recv[r], torch.int32))
                for d, (send, recv) in self._halo_maps.items()}
        gid = self.cell_gid[r]
        return FaceListMesh(
            n_cells=self.n_loc,
            owner=f(self._f_own[r], torch.int64),
            neighbour=f(self._f_nei[r], torch.int64),
            mag_sf=f(self._faces(mesh.mag_sf, r)),
            delta=f(self._faces(mesh.delta, r) + pads),
            weights=f(self._faces(mesh.weights, r)),
            normal=f(self._faces(mesh.normal, r)),
            volumes=f(_host(mesh.volumes)[gid]),
            centers=f(_host(mesh.centers)[gid]),
            patches=tuple(patches),
            k_no=None if mesh.k_no is None else f(self._faces(mesh.k_no, r)),
            skew=None if mesh.skew is None else f(self._faces(mesh.skew, r)),
            ell_face=f(ell_f, torch.int32), ell_sign=f(ell_s, torch.float32),
            w_own=f(self._w_own[r]), halo=halo)

    def localize_cell(self, x, r: int):
        """Global cell field (n, ...) -> shard r's (n_loc, ...)."""
        return x[torch.as_tensor(self.cell_gid[r], device=x.device)]

    def gather_cell(self, xs):
        """[shard r's (n_loc, ...) for every r] -> global (n, ...)."""
        x0 = xs[0]
        out = x0.new_empty((self._mesh0.n_cells,) + tuple(x0.shape[1:]))
        for r in range(self.n_shards):
            o = self._owned[r]
            out[torch.as_tensor(o, device=x0.device)] = xs[r][:len(o)]
        return out

    def localize_face(self, phi, r: int):
        """Global interior-face field (nf, ...) -> shard r's (nf_loc,
        ...), zero on pad faces."""
        out = phi.new_zeros((self.nf_loc,) + tuple(phi.shape[1:]))
        valid = np.nonzero(self.face_gid[r] >= 0)[0]
        idx = lambda a: torch.as_tensor(a, device=phi.device)
        out[idx(valid)] = phi[idx(self.face_gid[r, valid])]
        return out

    def gather_face(self, phis):
        src = self._face_src
        stacked = torch.stack(list(phis))
        idx = lambda a: torch.as_tensor(a, device=stacked.device)
        return stacked[idx(src[:, 0]), idx(src[:, 1])]

    def localize_patchfield(self, ip: int, xb, r: int):
        """Global per-patch face field (nb, ...) -> shard r's (nb_loc,
        ...)."""
        sel, counts, nb_loc = self._patch_sel[ip]
        k = int(counts[r])
        out = xb.new_zeros((nb_loc,) + tuple(xb.shape[1:]))
        out[:k] = xb[torch.as_tensor(sel[r, :k], device=xb.device)]
        return out

    def gather_patchfield(self, ip: int, xbs):
        sel, counts, nb_loc = self._patch_sel[ip]
        x0 = xbs[0]
        out = x0.new_zeros((int(sum(counts)),) + tuple(x0.shape[1:]))
        for r in range(self.n_shards):
            k = int(counts[r])
            out[torch.as_tensor(sel[r, :k], device=x0.device)] = xbs[r][:k]
        return out


class DistributedLowMachFL:
    """A LowMachSolverFL decomposed over the ranks of a process group, one
    cell slab a rank (order: a cell ordering, e.g. `block_order`'s).
    group: the process group (None: the default one), of n_shards ranks,
    initialized by the caller; device: the rank's device, which must be the
    solver's (default: the solver's)."""

    def __init__(self, solver: LowMachSolverFL, n_shards: int | None = None,
                 group=None, device=None, order: np.ndarray | None = None):
        import torch.distributed as dist
        from .distributed import _same_device
        if n_shards is None:
            n_shards = dist.get_world_size(group)
        self.n_shards = int(n_shards)
        dev = solver.device if device is None else torch.device(device)
        if not _same_device(dev, solver.device):
            raise ValueError(f"device {dev}: the solver is on "
                             f"{solver.device}; build it on the rank's "
                             "device")
        self.device = dev
        self.shard = ShardGroup((self.n_shards,), ("cells",), group)
        r = self.shard.rank
        self.solver = solver
        self.decomp = d = FLDecomp(solver.m_p, self.n_shards, order)
        lm = dict(m_p=d.localize_mesh(solver.m_p, r),
                  m_h=d.localize_mesh(solver.m_h, r),
                  m_Y=d.localize_mesh(solver.m_Y, r),
                  m_rho=d.localize_mesh(solver.m_rho, r),
                  m_U=tuple(d.localize_mesh(m, r) for m in solver.m_U))
        if solver.m_k is not None:
            lm["m_k"] = d.localize_mesh(solver.m_k, r)
            lm["m_eps"] = d.localize_mesh(solver.m_eps, r)
        if solver.m_Y_groups is not None:
            lm["m_Y_groups"] = tuple((d.localize_mesh(m, r), idx)
                                     for m, idx in solver.m_Y_groups)
        if solver.wall_fns is not None:
            wf = solver.wall_fns
            lm["wall_fns"] = dataclasses.replace(
                wf, mask=d.localize_cell(wf.mask, r),
                y=d.localize_cell(wf.y, r),
                n_wall=d.localize_cell(wf.n_wall, r))
        if solver.p_ell is not None:
            lm["p_ell"] = lm["m_p"].ell_connectivity(
                exclude=d.pad_faces(r))
        self.local_solver = dataclasses.replace(solver, **lm)
        self.w_own = lm["m_p"].w_own

    # ------------------------------------------------------------- layout
    def shard_state(self, s: LowMachFLState) -> LowMachFLState:
        """This rank's shard of the global state s. A chemistry step
        without a warm-start array gets one (the integrator's cold start,
        so the first step is unchanged)."""
        d, r = self.decomp, self.shard.rank
        sol = self.solver
        if (s.chem_dt is None and sol.config.chemistry
                and getattr(sol.combustion, "ode_opts", None) is not None):
            s = s._replace(chem_dt=torch.full_like(
                s.T, sol.combustion.ode_opts.dt_init))
        cell = lambda x: d.localize_cell(x, r)
        return LowMachFLState(
            rho=cell(s.rho), U=cell(s.U), p=cell(s.p), ha=cell(s.ha),
            Y=cell(s.Y), T=cell(s.T), phi=d.localize_face(s.phi, r),
            phi_b=tuple(d.localize_patchfield(ip, pb, r)
                        for ip, pb in enumerate(s.phi_b)),
            dpdt=cell(s.dpdt), time=s.time,
            chem_dt=cell(s.chem_dt) if s.chem_dt is not None else None,
            turb=tuple(cell(t) for t in s.turb))

    def _all(self, x):
        """Every rank's x (all_gather), in rank order."""
        if x.numel() == 0:
            return [x] * self.n_shards
        return self.shard.all_gather(x)

    def gather_state(self, ds: LowMachFLState) -> LowMachFLState:
        """The global state, on every rank."""
        d = self.decomp
        cell = lambda x: d.gather_cell(self._all(x))
        return LowMachFLState(
            rho=cell(ds.rho), U=cell(ds.U), p=cell(ds.p), ha=cell(ds.ha),
            Y=cell(ds.Y), T=cell(ds.T), phi=d.gather_face(self._all(ds.phi)),
            phi_b=tuple(d.gather_patchfield(ip, self._all(pb))
                        for ip, pb in enumerate(ds.phi_b)),
            dpdt=cell(ds.dpdt), time=ds.time,
            chem_dt=cell(ds.chem_dt) if ds.chem_dt is not None else None,
            turb=tuple(cell(t) for t in ds.turb))

    # --------------------------------------------------------------- step
    def step(self, ds: LowMachFLState, dt, sources=None):
        """One step of every shard: (new shard state, diagnostics, equal on
        every rank: all_reduce(MAX)). sources: this shard's spray sources,
        or None."""
        g = self.shard
        with shard_axis(g), cell_weight(self.w_own):
            s2, diag = self.local_solver.step(ds, dt, sources=sources)
            diag = {k: g.all_reduce(torch.as_tensor(v, device=self.device)
                                    .clone(), "max")
                    for k, v in diag.items()}
        return s2, diag
