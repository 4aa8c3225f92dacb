"""Flamelet-generated-manifold table: FlaRe table IO and multilinear lookup.

Port of deepflame_tpu/combustion/fgm/table.py (the reference's
flameletTableSolver/tableSolver.C): the FlaRe `.tbl` text format (header
`NH NZ NC NGZ NGC NZC NS NYomega NY NZL`, the species-name lines, the six
axes h/z/c/gz/gc/gzc, `Hfu Hox`, the NH*NZL laminar flame rows (z, sl, th,
tau, kctau), then the 6-D tables omgc/cOc/ZOc/cp/mwt/hiyi/Tf/nu (+Ycmax
unless the progress variable is scaled, + per-species omega and Y tables)),
and the lookup1d..lookup6d multilinear interpolation.

JAX interpolates with `map_coordinates(order=1, mode="nearest")` over all
six axes: 64 corners, of which every corner on an inactive axis (a None
coordinate, or an axis of length 1) has weight exactly 0. Here the corners
of the active axes only are gathered (16 on the 4-D tables), in the same
order, from one set of indices and weights shared by every table a lookup
reads (`lookup_many`); the dropped terms are exact zeros, so the sum is the
same. Physical coordinates become fractional indices as `jnp.interp` makes
them: searchsorted(side="right") on the axis cast to the coordinate's dtype.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Sequence

import numpy as np
import torch

from ...device import resolve_device

__all__ = ["FlameletTable", "read_flare_table", "write_flare_table",
           "lookup", "lookup_many", "make_synthetic_table"]

BASE_TABLES = ("omgc", "cOc", "ZOc", "cp", "mwt", "hiyi", "Tf", "nu")
_LAMINAR = ("z", "sl", "th", "tau", "kctau")
_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class FlameletTable:
    """Axes are host numpy arrays; tables are tensors on one device."""
    axes: tuple                      # 6 arrays (may have length 1)
    tables: Dict[str, torch.Tensor]  # name -> (NH, NZ, NC, NGZ, NGC, NZC)
    scaled_pv: bool
    H_fuel: float
    H_ox: float
    omega_species: tuple             # names with source tables ("omega_<sp>")
    species: tuple                   # names with Y tables
    laminar: Dict[str, np.ndarray]   # z/sl/th/tau/kctau, shape (NH, NZL)

    @property
    def shape(self):
        return tuple(len(a) for a in self.axes)

    @property
    def device(self) -> torch.device:
        return next(iter(self.tables.values())).device

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.tables.values())).dtype

    @functools.cached_property
    def _axis_cache(self) -> dict:
        return {}

    def axis(self, ax: int, dtype) -> torch.Tensor:
        """Axis `ax` as a tensor of `dtype` on the tables' device (cached)."""
        key = (ax, dtype)
        if key not in self._axis_cache:
            self._axis_cache[key] = torch.as_tensor(
                np.asarray(self.axes[ax]), dtype=dtype, device=self.device)
        return self._axis_cache[key]

    @functools.cached_property
    def flat(self) -> dict:
        """Each table flattened, for the corner gathers."""
        return {k: v.reshape(-1) for k, v in self.tables.items()}


def _frac_index(x, xp):
    """Physical coordinate -> fractional index on an axis of length > 1
    (xp in x's dtype), clamped to the table: jnp.interp(x, xp, arange(n))."""
    n = xp.shape[0]
    fp = torch.arange(n, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1).contiguous(),
                                       right=True), 1, n - 1).reshape(x.shape)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(_NP[x.dtype](torch.finfo(x.dtype).eps))
    dx0 = dx.abs() <= float(eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return torch.clamp(f, 0.0, n - 1.0)


def _corners(table: FlameletTable, coords: Sequence):
    """(shape, [(flat index, weight) per corner]) of the multilinear
    interpolation at coords (h, z, c, gz, gc, gzc), corners of the active
    axes in map_coordinates' order (the last axis fastest)."""
    shape = ()
    for c in coords:
        if c is not None:
            shape = torch.broadcast_shapes(
                shape, tuple(c.shape) if torch.is_tensor(c) else np.shape(c))
    dims = table.shape
    strides = [int(np.prod(dims[ax + 1:])) for ax in range(6)]
    per_axis = []
    for ax, c in enumerate(coords):
        if c is None or dims[ax] == 1:
            continue
        if not torch.is_tensor(c):
            c = torch.as_tensor(np.asarray(c, dtype=np.float64),
                                device=table.device)
        f = torch.broadcast_to(_frac_index(c, table.axis(ax, c.dtype)), shape)
        lower = torch.floor(f)
        w_hi = f - lower
        lo = lower.to(torch.int64)
        hi = torch.clamp(lo + 1, max=dims[ax] - 1)
        per_axis.append(((lo * strides[ax], 1 - w_hi),
                         (hi * strides[ax], w_hi)))
    corners = []
    for items in itertools.product(*per_axis):
        idx = items[0][0]
        w = items[0][1]
        for i, wi in items[1:]:
            idx = idx + i
            w = w * wi
        corners.append((idx, w))
    return shape, corners


def lookup_many(table: FlameletTable, names: Sequence[str], coords: Sequence):
    """{name: multilinear interpolation of table `name` at coords}: one set
    of corner indices and weights for all the names."""
    shape, corners = _corners(table, coords)
    out = {}
    for name in names:
        tab = table.flat[name]
        if not corners:                       # every axis inactive
            out[name] = tab[0].expand(shape)
            continue
        acc = None
        for idx, w in corners:
            term = w * tab[idx]
            acc = term if acc is None else acc + term
        out[name] = acc.to(tab.dtype)
    return out


def lookup(table: FlameletTable, name: str, coords: Sequence):
    """Multilinear interpolation of `name` at physical coords (h, z, c, gz,
    gc, gzc), each a number or a broadcastable tensor; None for an axis to
    take at its first entry (lookup1d..lookup6d parity)."""
    return lookup_many(table, (name,), coords)[name]


def _table_names(scaled_pv, omega_species, species):
    names = list(BASE_TABLES)
    if not scaled_pv:
        names.append("Ycmax")
    return names + [f"omega_{s}" for s in omega_species] + list(species)


def read_flare_table(path: str, dtype=torch.float32, use_native: bool = True,
                     device=None) -> FlameletTable:
    """Parse the FlaRe .tbl text format onto `device` (default: the CUDA
    card). use_native: the C++ parser (`native.flare_table_native`, built
    with g++ at first use; raises if it cannot be built); else numpy."""
    device = resolve_device(device)
    if use_native:
        from ...native import flare_table_native
        (dims, (omega_species, species), axes, (hfu, hox), lam_rows,
         flat) = flare_table_native(path)
        NH, NZ, NC, NGZ, NGC, NZC, NS, NYomega, NY, NZL = dims
        lam = {k: lam_rows[:, :, i] for i, k in enumerate(_LAMINAR)}
    else:
        with open(path) as f:
            NH, NZ, NC, NGZ, NGC, NZC, NS, NYomega, NY, NZL = (
                int(t) for t in f.readline().split()[:10])
            # name lines are always present (possibly empty)
            omega_species = tuple(f.readline().split()[:NYomega])
            species = tuple(f.readline().split()[:NY])

            def read_n(n):
                return np.asarray([float(f.readline().split()[0])
                                   for _ in range(n)])

            axes = tuple(read_n(n) for n in (NH, NZ, NC, NGZ, NGC, NZC))
            hfu, hox = (float(t) for t in f.readline().split()[:2])
            lam = {k: np.zeros((NH, NZL)) for k in _LAMINAR}
            for i in range(NH):
                for j in range(NZL):
                    row = [float(t) for t in f.readline().split()[:5]]
                    for k, key in enumerate(_LAMINAR):
                        lam[key][i, j] = row[k]
            flat = np.loadtxt(f).reshape(-1)
    scaled_pv = NS == 8 + NYomega
    size = NH * NZ * NC * NGZ * NGC * NZC
    tables = {name: torch.as_tensor(
        flat[k * size:(k + 1) * size].reshape(NH, NZ, NC, NGZ, NGC, NZC),
        dtype=dtype, device=device)
        for k, name in enumerate(_table_names(scaled_pv, omega_species,
                                              species))}
    return FlameletTable(axes=tuple(np.asarray(a) for a in axes),
                         tables=tables, scaled_pv=scaled_pv, H_fuel=hfu,
                         H_ox=hox, omega_species=omega_species,
                         species=species, laminar=lam)


def write_flare_table(path: str, table: FlameletTable) -> None:
    """Write the FlaRe text format."""
    NH, NZ, NC, NGZ, NGC, NZC = table.shape
    NYomega, NY = len(table.omega_species), len(table.species)
    NS = (8 if table.scaled_pv else 9) + NYomega
    NZL = table.laminar["z"].shape[1]
    with open(path, "w") as f:
        f.write(f"{NH} {NZ} {NC} {NGZ} {NGC} {NZC} {NS} {NYomega} {NY} {NZL}\n")
        f.write(" ".join(table.omega_species) + "\n")
        f.write(" ".join(table.species) + "\n")
        for a in table.axes:
            for v in np.asarray(a).ravel():
                f.write(f"{v:.10g}\n")
        f.write(f"{table.H_fuel:.10g} {table.H_ox:.10g}\n")
        for i in range(NH):
            for j in range(NZL):
                f.write(" ".join(f"{table.laminar[k][i, j]:.10g}"
                                 for k in _LAMINAR) + "\n")
        for name in _table_names(table.scaled_pv, table.omega_species,
                                 table.species):
            np.savetxt(f, table.tables[name].detach().cpu().numpy()
                       .reshape(-1, 1), fmt="%.10g")


def make_synthetic_table(NH=1, NZ=21, NC=11, NGZ=5, NGC=3, NZC=1,
                         dtype=torch.float32, device=None) -> FlameletTable:
    """Small analytic table for tests: smooth functions of (z, c, gz, gc)
    and, when NH > 1, of the enthalpy-loss coordinate (temperature and
    source term drop as heat is lost)."""
    device = resolve_device(device)
    h_max = 5e5 if NH > 1 else 1.0
    axes = (np.linspace(0.0, h_max, NH), np.linspace(0.0, 1.0, NZ),
            np.linspace(0.0, 1.0, NC), np.linspace(0.0, 0.25, NGZ),
            np.linspace(0.0, 0.25, NGC), np.linspace(0.0, 1.0, NZC))
    H, Z, C, GZ, GC, GZC = np.meshgrid(*axes, indexing="ij")
    flam = np.exp(-((Z - 0.3) / 0.15) ** 2)
    hfac = 1.0 - 0.3 * (H / h_max) if NH > 1 else np.ones_like(H)
    tables = {
        "omgc": 50.0 * flam * C * (1.0 - C) * (1.0 - 2.0 * GZ) * (1.0 - GC)
                * hfac,
        "cOc": 10.0 * flam * C * hfac,
        "ZOc": 5.0 * flam * Z * C * hfac,
        "cp": 1200.0 + 300.0 * C * flam,
        "mwt": 28.0 - 8.0 * C * flam,
        "hiyi": -1e5 * C * flam,
        "Tf": 300.0 + 1800.0 * C * flam * hfac,
        "nu": 1.5e-5 * (1.0 + 4.0 * C * flam),
    }
    lam = {k: np.zeros((NH, 5)) for k in _LAMINAR}
    lam["z"][:] = np.linspace(0, 1, 5)
    lam["sl"][:] = 0.4
    lam["th"][:] = 5e-4
    lam["tau"][:] = 5.0
    lam["kctau"][:] = 1.0
    return FlameletTable(
        axes=axes, tables={k: torch.as_tensor(v, dtype=dtype, device=device)
                           for k, v in tables.items()},
        scaled_pv=True, H_fuel=0.0, H_ox=0.0, omega_species=(), species=(),
        laminar=lam)
