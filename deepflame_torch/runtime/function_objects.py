"""Runtime post-processing function objects.

Port of deepflame_tpu/runtime/function_objects.py: the OpenFOAM
function-object set results are read from (fieldMinMax with locations,
probes and sample lines, fieldAverage, volume and surface field values,
histograms, ...), on the structured and the face-list mesh. Output files
have the JAX package's format and paths (columnar text under
postProcessing/<name>/).

On the card the work stays there: each object reduces its fields on the
device (min/max with their locations, probe and line gathers, volume and
area reductions, histogram counts, running averages) and brings its row to
the host in one transfer per call (`_host`, counted in `transfers`).
FieldAverage keeps its means on the device. StreamLine (a host RK2 trace
of one copy of U), region_size_distribution (scipy's labelling), randomise
(numpy's generator, draw for draw the JAX package's) and ReadFields (npz)
work on the host by design.

Probe and line indices come from the points on the host in float64, as the
JAX package computes them. Ties in a min/max take the first cell in both
packages.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..mesh.structured import StructuredMesh, zero_gradient
from ..ops.fv import grad as _grad

__all__ = ["FieldMinMax", "Probes", "LineSample", "FieldAverage",
           "FunctionObjectSet", "Histogram", "FieldCalculus",
           "VolFieldValue", "SurfaceFieldValue", "FieldValueDelta",
           "PatchFieldValue",
           "total_pressure", "pressure_coefficient",
           "write_cell_centres", "write_cell_volumes"]

# device-to-host transfers made by the function objects: count and bytes
transfers = {"count": 0, "bytes": 0}


def reset_transfers() -> None:
    transfers.update(count=0, bytes=0)


def _host(t) -> np.ndarray:
    """One device-to-host transfer of a tensor (counted)."""
    a = t.detach().cpu().numpy()
    transfers["count"] += 1
    transfers["bytes"] += a.nbytes
    return a


def _row(vals) -> np.ndarray:
    """0-d tensors (any float type) brought to the host as one float64
    array in one transfer."""
    return _host(torch.stack([v.reshape(()).to(torch.float64) for v in vals]))


# --- mesh-backend dispatch -------------------------------------------------
# StructuredMesh has cell_centers(); FaceListMesh carries flat centers (n, 3)
# and per-cell volumes. Fields are (nx, ny, nz) on the former, (n_cells,) on
# the latter; every reduction below works on the flattened field.

def _is_facelist(mesh) -> bool:
    return hasattr(mesh, "owner") and not hasattr(mesh, "cell_centers")


def _cell_xyz(mesh):
    """(X, Y, Z) cell-centre tensors in the backend's field shape."""
    if _is_facelist(mesh):
        c = mesh.centers
        return c[:, 0], c[:, 1], c[:, 2]
    return mesh.cell_centers()


def _cell_volumes(mesh):
    """Per-cell volumes (a number on the uniform structured mesh)."""
    if _is_facelist(mesh):
        return mesh.volumes
    return mesh.volume


def _nearest_cell(mesh, point, centers=None):
    """Index of the cell whose centre is nearest `point`, on the host in
    float64: structured (i, j, k), truncating (point - x0)/dx after a clip;
    face-list a flat int (`centers`: the host copy of mesh.centers)."""
    if _is_facelist(mesh):
        c = _host(mesh.centers) if centers is None else centers
        d = c - np.asarray(point, c.dtype)[None, :]
        return int(np.argmin(np.einsum("ij,ij->i", d, d)))
    i = int(np.clip((point[0] - mesh.x0) / mesh.dx, 0, mesh.nx - 1))
    j = int(np.clip((point[1] - mesh.y0) / mesh.dy, 0, mesh.ny - 1))
    k = int(np.clip((point[2] - mesh.z0) / mesh.dz, 0, mesh.nz - 1))
    return (i, j, k)


def _flat_index(mesh, idx) -> int:
    """Flat (C-order) cell index of a _nearest_cell result."""
    if isinstance(idx, tuple):
        i, j, k = idx
        return (i * mesh.ny + j) * mesh.nz + k
    return idx


class FieldMinMax:
    """Min/max time series of named fields with the location of each
    (fieldMinMax, with the location output the detonation anchor reads)."""

    def __init__(self, mesh, fields: Sequence[str],
                 out_dir: str = "postProcessing/fieldMinMax"):
        self.mesh = mesh
        self.fields = tuple(fields)
        self.out_dir = out_dir
        self.rows: list[tuple] = []
        self._xyz = None

    def __call__(self, time: float, fields: dict):
        if self._xyz is None:
            self._xyz = [c.reshape(-1) for c in _cell_xyz(self.mesh)]
        X, Y, Z = self._xyz
        vals = []
        for name in self.fields:
            f = fields[name].reshape(-1)
            for i in (torch.argmin(f), torch.argmax(f)):
                vals += [f[i], X[i], Y[i], Z[i]]
        self.rows.append((time,) + tuple(_row(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        hdr = ["time"]
        for name in self.fields:
            hdr += [f"min({name})", "x_min", "y_min", "z_min",
                    f"max({name})", "x_max", "y_max", "z_max"]
        path = os.path.join(self.out_dir, "fieldMinMax.dat")
        np.savetxt(path, np.asarray(self.rows), header=" ".join(hdr))
        return path


class Probes:
    """Point probes of scalar fields (nearest cell), the probes function
    object."""

    def __init__(self, mesh, points: Sequence[tuple], fields: Sequence[str],
                 out_dir: str = "postProcessing/probes"):
        self.mesh = mesh
        self.fields = tuple(fields)
        self.out_dir = out_dir
        c = _host(mesh.centers) if _is_facelist(mesh) else None
        self.idx = [_nearest_cell(mesh, p, c) for p in points]
        self._flat = torch.tensor([_flat_index(mesh, i) for i in self.idx],
                                  device=mesh.device)
        self.rows: list[tuple] = []

    def __call__(self, time: float, fields: dict):
        vals = torch.cat([
            fields[name].reshape(-1)[self._flat]
            .to(torch.float64) for name in self.fields])
        self.rows.append((time,) + tuple(_host(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "probes.dat")
        np.savetxt(path, np.asarray(self.rows))
        return path


class LineSample:
    """Axis-aligned line sample (the `sample`/`sets` function object):
    structured, the cells of the line through `through` along `axis`;
    face-list, the cells whose centres lie within `tol` (default half the
    local cell size) of that line, in order along it."""

    def __init__(self, mesh, axis: int, through: tuple,
                 fields: Sequence[str], out_dir: str = "postProcessing/sample",
                 tol: float | None = None):
        self.mesh = mesh
        self.axis = axis
        self.fields = tuple(fields)
        self.out_dir = out_dir
        self.snapshots: dict[float, np.ndarray] = {}
        if _is_facelist(mesh):
            c = _host(mesh.centers)
            if tol is None:
                tol_arr = 0.51 * _host(mesh.volumes) ** (1.0 / 3.0)
            else:
                tol_arr = np.full(c.shape[0], tol)
            mask = np.ones(c.shape[0], bool)
            for a in (a for a in range(3) if a != axis):
                mask &= np.abs(c[:, a] - through[a]) <= tol_arr
            sel = np.nonzero(mask)[0]
            if sel.size == 0:       # fall back to the single nearest cell
                sel = np.asarray([_nearest_cell(mesh, through, c)])
            self.sel = sel[np.argsort(c[sel, axis])]
            self.coord = c[self.sel, axis]
            self.fixed = None
            flat = self.sel
        else:
            j = int(np.clip((through[1] - mesh.y0) / mesh.dy, 0, mesh.ny - 1))
            k = int(np.clip((through[2] - mesh.z0) / mesh.dz, 0, mesh.nz - 1))
            i = int(np.clip((through[0] - mesh.x0) / mesh.dx, 0, mesh.nx - 1))
            self.fixed = (i, j, k)
            n = mesh.shape[axis]
            o, h = ((mesh.x0, mesh.dx), (mesh.y0, mesh.dy),
                    (mesh.z0, mesh.dz))[axis]
            self.coord = o + (np.arange(n) + 0.5) * h
            ijk = [np.full(n, i), np.full(n, j), np.full(n, k)]
            ijk[axis] = np.arange(n)
            flat = (ijk[0] * mesh.ny + ijk[1]) * mesh.nz + ijk[2]
        self._flat = torch.as_tensor(np.asarray(flat, np.int64),
                                     device=mesh.device)

    def __call__(self, time: float, fields: dict):
        cols = torch.stack([
            fields[name].reshape(-1)[self._flat]
            .to(torch.float64) for name in self.fields])
        self.snapshots[time] = np.concatenate(
            [self.coord[:, None], _host(cols).T], axis=1)

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        paths = []
        for t, arr in self.snapshots.items():
            p = os.path.join(self.out_dir, f"line_{t:.9g}.xy")
            np.savetxt(p, arr)
            paths.append(p)
        return paths


class FieldAverage:
    """Running time average of fields (fieldAverage), kept on the device in
    each field's type."""

    def __init__(self, fields: Sequence[str]):
        self.fields = tuple(fields)
        self.mean: dict[str, torch.Tensor] = {}
        self.n = 0

    def __call__(self, time: float, fields: dict):
        self.n += 1
        w = 1.0 / self.n
        for name in self.fields:
            f = fields[name]
            if name not in self.mean:
                self.mean[name] = f.clone()
            else:
                self.mean[name] = (1 - w) * self.mean[name] + w * f


class Histogram:
    """Histogram of a field (the histogram function object): per write
    time, bin counts over [lo, hi] (default the field's min and max).

    The bins follow numpy.histogram's rule exactly: edges from np.linspace
    in the field's type, the bin of a value from its scaled offset and then
    moved down or up where it falls below its bin's lower edge or at or
    above its upper one, the last bin closed on the right."""

    def __init__(self, field: str, n_bins: int = 50, lo=None, hi=None,
                 out_dir: str = "postProcessing/histogram"):
        self.field = field
        self.n_bins = n_bins
        self.lo, self.hi = lo, hi
        self.out_dir = out_dir
        self.snapshots: dict[float, tuple] = {}

    def _counts(self, f: torch.Tensor):
        """(counts int64 (n,), edges float64 (n + 1,)) on the device."""
        n = self.n_bins
        f64 = lambda v: torch.as_tensor(v, dtype=torch.float64,
                                        device=f.device)
        lo = f.min().to(torch.float64) if self.lo is None else f64(self.lo)
        hi = f.max().to(torch.float64) if self.hi is None else f64(self.hi)
        same = lo == hi
        first = torch.where(same, lo - 0.5, lo)
        last = torch.where(same, hi + 0.5, hi)
        # np.linspace(first, last, n + 1): arange * step + start, exact end
        edges = torch.arange(n + 1, dtype=torch.float64, device=f.device) \
            * ((last - first) / n) + first
        edges[n] = last
        edges = edges.to(f.dtype)
        norm = n / (last - first)
        keep = (f >= first) & (f <= last)
        idx = ((f - first) * norm).to(torch.int64).clamp(0, n)
        idx = torch.where(idx == n, n - 1, idx)
        idx = idx - (f < edges[idx]).to(torch.int64)
        idx = idx + ((f >= edges[(idx + 1).clamp(max=n)])
                     & (idx != n - 1)).to(torch.int64)
        idx = torch.where(keep, idx.clamp(0, n - 1), n)
        counts = torch.bincount(idx, minlength=n + 1)[:n]
        return counts, edges.to(torch.float64)

    def __call__(self, time: float, fields: dict):
        f = fields[self.field].reshape(-1)
        counts, edges = self._counts(f)
        both = _host(torch.cat([counts.to(torch.float64), edges]))
        np_type = torch.empty((), dtype=f.dtype).numpy().dtype
        self.snapshots[time] = (both[:self.n_bins].astype(np.int64),
                                both[self.n_bins:].astype(np_type))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        paths = []
        for t, (counts, edges) in self.snapshots.items():
            mid = 0.5 * (edges[:-1] + edges[1:])
            p = os.path.join(self.out_dir, f"{self.field}_{t:.9g}.dat")
            np.savetxt(p, np.stack([mid, counts], axis=1))
            paths.append(p)
        return paths


class FieldCalculus:
    """The field-expression family (mag, magSqr, components, add,
    subtract, scale, log, grad, div, ddt) as DerivedFields specs: each
    returns a callable(fields dict) -> tensor."""

    @staticmethod
    def mag(name):
        def _f(f):
            a = f[name]
            return torch.sqrt((a ** 2).sum(0)) if a.dim() == 4 else a.abs()
        return _f

    @staticmethod
    def mag_sqr(name):
        def _f(f):
            a = f[name]
            return (a * a).sum(0) if a.dim() == 4 else a * a
        return _f

    @staticmethod
    def component(name, c):
        return lambda f: f[name][c]

    @staticmethod
    def add(a, b):
        return lambda f: f[a] + f[b]

    @staticmethod
    def subtract(a, b):
        return lambda f: f[a] - f[b]

    @staticmethod
    def scale(name, factor):
        return lambda f: factor * f[name]

    @staticmethod
    def log(name, floor=1e-300):
        return lambda f: torch.log(torch.clamp(f[name], min=floor))

    @staticmethod
    def grad(name, bcs, mesh):
        return lambda f: _grad(f[name], bcs, mesh)

    @staticmethod
    def div(name, bcs, mesh):
        def _f(f):
            v = f[name]
            return sum(_grad(v[c], bcs[c], mesh)[c] for c in range(3))
        return _f

    @staticmethod
    def ddt(name, dt):
        prev = {}

        def _f(f):
            cur = f[name]
            out = (cur - prev.get("v", cur)) / dt
            prev["v"] = cur
            return out
        return _f


class VolFieldValue:
    """Volume-region reductions (volFieldValue): per write, ops of named
    fields over an axis-aligned box (the whole domain by default).

    ops: any of "sum", "volIntegrate", "average", "volAverage", "min",
    "max", "CoV" (the population standard deviation over the mean)."""

    def __init__(self, mesh, fields: Sequence[str],
                 ops: Sequence[str] = ("volAverage",), box=None,
                 out_dir: str = "postProcessing/volFieldValue"):
        self.mesh = mesh
        self.fields = tuple(fields)
        self.ops = tuple(ops)
        self.out_dir = out_dir
        self.rows: list[tuple] = []
        self.sel = None
        if box is not None:
            (x0, x1), (y0, y1), (z0, z1) = box
            X, Y, Z = (c.reshape(-1) for c in _cell_xyz(mesh))
            mask = ((X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
                    & (Z >= z0) & (Z <= z1))
            self.sel = torch.nonzero(mask).reshape(-1)

    @staticmethod
    def _reduce(op: str, f, v):
        if op == "sum":
            return f.sum()
        if op == "volIntegrate":
            return (f * v).sum()
        if op == "average":
            return f.mean()
        if op == "volAverage":
            return (f * v).sum() / (v * torch.ones_like(f)).sum()
        if op == "min":
            return f.min()
        if op == "max":
            return f.max()
        if op == "CoV":
            m = f.mean()
            d = f - m
            std = torch.sqrt((d * d).sum() / f.numel())
            return torch.where(m != 0.0, std / m, torch.zeros_like(m))
        raise ValueError(op)

    def __call__(self, time: float, fields: dict):
        vols = _cell_volumes(self.mesh)
        vals = []
        for name in self.fields:
            f = fields[name].reshape(-1)
            v = vols
            if self.sel is not None:
                f = f[self.sel]
                if isinstance(vols, torch.Tensor):
                    v = vols[self.sel]
            vals += [self._reduce(op, f, v) for op in self.ops]
        self.rows.append((time,) + tuple(_row(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        hdr = ["time"] + [f"{op}({name})" for name in self.fields
                          for op in self.ops]
        path = os.path.join(self.out_dir, "volFieldValue.dat")
        np.savetxt(path, np.asarray(self.rows), header=" ".join(hdr))
        return path


class SurfaceFieldValue:
    """Face-plane reductions (surfaceFieldValue): areaAverage /
    areaIntegrate / sum / min / max of a face field on one constant-index
    plane (for example the outlet mass flow, the sum of phi A on the last
    x plane). axis: the face-normal axis; index: the plane of the (n + 1)
    face planes (0 the low boundary, n the high one)."""

    def __init__(self, mesh: StructuredMesh, fields: Sequence[str],
                 axis: int = 0, index: int = 0,
                 ops: Sequence[str] = ("areaAverage",),
                 out_dir: str = "postProcessing/surfaceFieldValue"):
        self.mesh = mesh
        self.fields = tuple(fields)
        self.axis = axis
        self.index = index
        self.ops = tuple(ops)
        self.out_dir = out_dir
        self.rows: list[tuple] = []
        spac = [mesh.dx, mesh.dy, mesh.dz]
        spac.pop(axis)
        self.face_area = spac[0] * spac[1]

    def _reduce(self, op: str, f):
        if op == "areaAverage":
            return f.mean()
        if op == "areaIntegrate":
            return f.sum() * self.face_area
        if op == "sum":
            return f.sum()
        if op == "min":
            return f.min()
        if op == "max":
            return f.max()
        raise ValueError(op)

    def __call__(self, time: float, fields: dict):
        vals = []
        for name in self.fields:
            f = fields[name]
            plane = f.select(self.axis - 3, self.index)
            vals += [self._reduce(op, plane) for op in self.ops]
        self.rows.append((time,) + tuple(_row(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        hdr = ["time"] + [f"{op}({name})" for name in self.fields
                          for op in self.ops]
        path = os.path.join(self.out_dir, "surfaceFieldValue.dat")
        np.savetxt(path, np.asarray(self.rows), header=" ".join(hdr))
        return path


class PatchFieldValue:
    """surfaceFieldValue on a named boundary patch of a FaceListMesh: the
    owner-cell values of named fields reduced over the patch (areaAverage /
    areaIntegrate / sum / min / max); a weight field (for example the
    boundary mass flux) turns areaIntegrate into the flux integral
    sum(w f A)."""

    def __init__(self, mesh, patch: str, fields: Sequence[str],
                 ops: Sequence[str] = ("areaAverage",),
                 weight_field: str | None = None,
                 out_dir: str = "postProcessing/patchFieldValue"):
        names = [p.name for p in mesh.patches]
        self.patch = mesh.patches[names.index(patch)]
        self.fields = tuple(fields)
        self.ops = tuple(ops)
        self.weight_field = weight_field
        self.out_dir = out_dir
        self.rows: list[tuple] = []

    @staticmethod
    def _reduce(op: str, f, a, w):
        if op == "areaAverage":
            return (f * a).sum() / a.sum()
        if op == "areaIntegrate":
            return (w * f * a).sum()
        if op == "sum":
            return f.sum()
        if op == "min":
            return f.min()
        if op == "max":
            return f.max()
        raise ValueError(op)

    def __call__(self, time: float, fields: dict):
        own = self.patch.owner
        a = self.patch.mag_sf
        w = (fields[self.weight_field][own]
             if self.weight_field is not None else torch.ones_like(a))
        vals = []
        for name in self.fields:
            f = fields[name][own]
            vals += [self._reduce(op, f, a, w) for op in self.ops]
        self.rows.append((time,) + tuple(_row(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        hdr = ["time"] + [f"{op}({name})" for name in self.fields
                          for op in self.ops]
        path = os.path.join(self.out_dir, "patchFieldValue.dat")
        np.savetxt(path, np.asarray(self.rows), header=" ".join(hdr))
        return path


def write_cell_centres(mesh: StructuredMesh,
                       out_dir: str = "postProcessing/mesh"):
    """writeCellCentres."""
    os.makedirs(out_dir, exist_ok=True)
    xyz = _host(torch.stack([c.reshape(-1) for c in mesh.cell_centers()], 1))
    path = os.path.join(out_dir, "cellCentres.dat")
    np.savetxt(path, xyz)
    return path


def write_cell_volumes(mesh: StructuredMesh,
                       out_dir: str = "postProcessing/mesh"):
    """writeCellVolumes (uniform on the structured block)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cellVolumes.dat")
    np.savetxt(path, np.full((mesh.n_cells,), mesh.volume))
    return path


@dataclasses.dataclass
class FunctionObjectSet:
    """The objects called each write interval (controlDict functions)."""
    objects: list

    def __call__(self, time: float, fields: dict):
        for obj in self.objects:
            obj(time, fields)

    def write(self):
        return [obj.write() for obj in self.objects if hasattr(obj, "write")]


def total_pressure(p, rho, U):
    """p0 = p + 0.5 rho |U|^2 (the pressure function object, mode
    'total')."""
    return p + 0.5 * rho * (U ** 2).sum(0)


def pressure_coefficient(p, rho, U, p_inf, U_inf, rho_inf=None):
    """Cp = (p - p_inf) / (0.5 rho_inf U_inf^2) (mode 'staticCoeff'; rho_inf
    defaults to the mean density)."""
    r = rho_inf if rho_inf is not None else rho.mean()
    return (p - p_inf) / (0.5 * r * U_inf ** 2)


class FieldValueDelta:
    """Difference, sum, min or max of two single-value fieldValue objects
    per write (fieldValueDelta: a pressure drop, a mass imbalance). The two
    operands are called by this object; do not register them as well."""

    def __init__(self, a, b, op: str = "subtract",
                 out_dir: str = "postProcessing/fieldValueDelta"):
        self.a = a
        self.b = b
        self.op = op
        self.out_dir = out_dir
        self.rows: list[tuple] = []

    def __call__(self, time: float, fields: dict):
        self.a(time, fields)
        self.b(time, fields)
        va = self.a.rows[-1][1]
        vb = self.b.rows[-1][1]
        if self.op == "subtract":
            d = va - vb
        elif self.op == "add":
            d = va + vb
        elif self.op == "min":
            d = min(va, vb)
        elif self.op == "max":
            d = max(va, vb)
        else:
            raise ValueError(self.op)
        self.rows.append((time, d))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "fieldValueDelta.dat")
        np.savetxt(path, np.asarray(self.rows),
                   header=f"time {self.op}(a,b)")
        return path


def randomise(field, magnitude: float, seed: int = 0):
    """randomise: field + a uniform perturbation in [-magnitude, magnitude]
    per cell, float64. The draws come from numpy's default_rng(seed) on the
    host, so they are the JAX package's draw for draw."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(-magnitude, magnitude, tuple(field.shape))
    return field.to(torch.float64) + torch.as_tensor(noise,
                                                     device=field.device)


def surface_interpolate(field, mesh: StructuredMesh):
    """surfaceInterpolate: linear cell-to-face interpolation on interior
    faces, one tensor per axis (n_a - 1 faces along axis a)."""
    out = []
    for a in range(3):
        n = field.shape[a - 3]
        out.append(0.5 * (field.narrow(a - 3, 0, n - 1)
                          + field.narrow(a - 3, 1, n - 1)))
    return tuple(out)


class NearWallFields:
    """nearWallFields: min, max and mean of named fields over the cell
    layer next to a wall plane (axis, side; side 0 the low one)."""

    def __init__(self, fields: Sequence[str], axis: int, side: int,
                 out_dir: str = "postProcessing/nearWallFields"):
        self.fields = tuple(fields)
        self.axis = axis
        self.side = side
        self.out_dir = out_dir
        self.rows: list[tuple] = []

    def _layer(self, f):
        return f.select(self.axis - 3, 0 if self.side == 0 else -1)

    def __call__(self, time: float, fields: dict):
        vals = []
        for name in self.fields:
            lay = self._layer(fields[name])
            vals += [lay.min(), lay.max(), lay.mean()]
        self.rows.append((time,) + tuple(_row(vals)))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        hdr = ["time"]
        for n in self.fields:
            hdr += [f"min({n})", f"max({n})", f"mean({n})"]
        path = os.path.join(self.out_dir, "nearWallFields.dat")
        np.savetxt(path, np.asarray(self.rows), header=" ".join(hdr))
        return path


def processor_field(mesh: StructuredMesh, n_shards: int = 1, axis: int = 0):
    """processorField: per-cell owning shard, cells block-partitioned along
    `axis` into n_shards equal slabs (int32, on the mesh's device)."""
    n = mesh.shape[axis]
    ids = torch.clamp(torch.arange(n, device=mesh.device) * n_shards // n,
                      max=n_shards - 1)
    shape = [1, 1, 1]
    shape[axis] = n
    return ids.reshape(shape).expand(mesh.shape).to(torch.int32)


class ReadFields:
    """readFields: adds the fields of an .npz snapshot to the field dict on
    every call, as tensors on `device` (default: the CUDA card)."""

    def __init__(self, path: str, names: Sequence[str] | None = None,
                 device=None):
        from ..device import resolve_device
        data = np.load(path)
        dev = resolve_device(device)
        self.loaded = {k: torch.as_tensor(data[k], device=dev)
                       for k in (names or data.files)}

    def __call__(self, time: float, fields: dict):
        fields.update(self.loaded)


def field_coordinate_system_transform(U, origin, e1, e3):
    """fieldCoordinateSystemTransform of a vector field: U (3, ...) in the
    local Cartesian system (e1, e2 = e3 x e1, e3), float64; origin matters
    for positions, not vectors."""
    e1 = np.asarray(e1, np.float64)
    e3 = np.asarray(e3, np.float64)
    e1 = e1 / np.linalg.norm(e1)
    e3 = e3 - e1 * (e3 @ e1)
    e3 = e3 / np.linalg.norm(e3)
    R = torch.as_tensor(np.stack([e1, np.cross(e3, e1), e3]),
                        device=U.device)
    return torch.einsum("ab,b...->a...", R, U.to(torch.float64))


class StreamLine:
    """streamLine: streamlines through a frozen velocity snapshot by
    midpoint (RK2) integration on the structured block, one polyline per
    seed. One transfer of U per call, then the trace on the host."""

    def __init__(self, mesh: StructuredMesh, seeds, step_frac: float = 0.5,
                 max_steps: int = 2000,
                 out_dir: str = "postProcessing/streamLine"):
        self.mesh = mesh
        self.seeds = np.asarray(seeds, np.float64)
        self.h = step_frac * float(min(mesh.dx, mesh.dy, mesh.dz))
        self.max_steps = max_steps
        self.out_dir = out_dir
        self.lines: list[np.ndarray] = []

    def _sample(self, U, x):
        # nearest cell (the tracer's first-order lookup)
        d = (self.mesh.dx, self.mesh.dy, self.mesh.dz)
        idx = tuple(int(np.clip(x[a] / d[a] - 0.5, 0, self.mesh.shape[a] - 1))
                    for a in range(3))
        return np.array([U[c][idx] for c in range(3)])

    def __call__(self, time: float, fields: dict):
        U = _host(fields["U"])
        ext = np.array([self.mesh.shape[a]
                        * (self.mesh.dx, self.mesh.dy, self.mesh.dz)[a]
                        for a in range(3)])
        self.lines = []
        for seed in self.seeds:
            x = np.asarray(seed, np.float64).copy()
            pts = [x.copy()]
            for _ in range(self.max_steps):
                u1 = self._sample(U, x)
                sp = np.linalg.norm(u1)
                if sp < 1e-12:
                    break
                xm = x + 0.5 * self.h * u1 / sp
                u2 = self._sample(U, xm)
                sp2 = np.linalg.norm(u2)
                if sp2 < 1e-12:
                    break
                x = x + self.h * u2 / sp2
                if np.any(x < 0) or np.any(x >= ext):
                    break
                pts.append(x.copy())
            self.lines.append(np.asarray(pts))

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        paths = []
        for i, line in enumerate(self.lines):
            p = os.path.join(self.out_dir, f"track{i}.xy")
            np.savetxt(p, line, header="x y z")
            paths.append(p)
        return paths


def region_size_distribution(field, threshold: float, cell_volume: float,
                             above: bool = True):
    """regionSizeDistribution: the connected regions where the field is
    above (or below) threshold, labelled by scipy on the host (6-connected),
    their volumes [m^3] in descending order."""
    from scipy import ndimage
    f = _host(field)
    mask = f > threshold if above else f < threshold
    labels, n = ndimage.label(mask)
    if n == 0:
        return np.zeros((0,))
    sizes = ndimage.sum_labels(np.ones_like(f), labels,
                               index=np.arange(1, n + 1))
    return np.sort(sizes)[::-1] * cell_volume


def blending_factor(field, mesh: StructuredMesh, axis: int = 0):
    """blendingFactor: the limitedLinear weight on each cell's face along
    `axis` (1 central, 0 upwind) for positive flow, wrap-around neighbours,
    float64."""
    f = field.to(torch.float64)
    num = f - torch.roll(f, 1, axis - 3)
    den = torch.roll(f, -1, axis - 3) - f
    r = num / torch.where(den.abs() > 1e-300, den,
                          torch.full_like(den, 1e-300))
    return torch.clamp(torch.clamp(2.0 * r, max=1.0), 0.0, 1.0)


def _upwind_neighbour(tau, a: int, shift: int):
    """tau rolled by `shift` along axis a with the wrapped layer zeroed
    (zero outside the domain: the inlet value)."""
    t = torch.roll(tau, shift, a)
    t.select(a, 0 if shift == 1 else -1).zero_()
    return t


def age(phi, mesh: StructuredMesh, rho=None, n_sweeps: int | None = None,
        tol: float = 1e-10):
    """age: steady age of fluid tau, div(phi tau) = rho, by first-order
    upwind Jacobi sweeps on the device in float64 (information moves one
    cell a sweep; the default count covers the sum of the extents plus
    slack). Stops once a sweep's largest change is at most `tol` of the
    largest |tau|, tested every sweep. phi: the per-axis face fluxes;
    inflow boundaries hold tau = 0; cells without outflow keep their
    value."""
    if n_sweeps is None:
        n_sweeps = 2 * int(sum(mesh.shape)) + 10
    dev = phi[0].device
    rho_arr = (torch.ones(mesh.shape, dtype=torch.float64, device=dev)
               if rho is None else rho.to(torch.float64))
    tau = torch.zeros(mesh.shape, dtype=torch.float64, device=dev)
    vol = mesh.volume
    phis = [p.to(torch.float64) for p in phi]
    for _ in range(n_sweeps):
        diag = torch.zeros_like(tau)
        off = torch.zeros_like(tau)
        for a in range(3):
            f = phis[a]
            n = f.shape[a]
            f_lo, f_hi = f.narrow(a, 0, n - 1), f.narrow(a, 1, n - 1)
            # outflow faces feed the diagonal; inflow faces pull the upwind
            # neighbour's tau
            diag += torch.clamp(f_hi, min=0.0) + torch.clamp(-f_lo, min=0.0)
            off += torch.clamp(f_lo, min=0.0) * _upwind_neighbour(tau, a, 1) \
                + torch.clamp(-f_hi, min=0.0) * _upwind_neighbour(tau, a, -1)
        pos = diag > 0.0
        tau_new = torch.where(pos, (rho_arr * vol + off)
                              / torch.where(pos, diag, torch.ones_like(diag)),
                              tau)
        delta = float((tau_new - tau).abs().max())
        tau = tau_new
        if delta <= tol * max(float(tau.abs().max()), 1e-300):
            break
    return tau


def interface_height(alpha, mesh: StructuredMesh, locations, axis: int = 2):
    """interfaceHeight: for each location in the plane normal to `axis`,
    the height of the phase interface along `axis`, the integral of the
    phase fraction up the column (hIntegral), in the mesh frame. Column
    indices on the host in float64; the sums on the device, one transfer."""
    d = (mesh.dx, mesh.dy, mesh.dz)[axis]
    dims = [i for i in range(3) if i != axis]
    sums = []
    for loc in locations:
        sl = [0, 0, 0]
        for li, dim in enumerate(dims):
            spac = (mesh.dx, mesh.dy, mesh.dz)[dim]
            org = (mesh.x0, mesh.y0, mesh.z0)[dim]
            sl[dim] = int(np.clip((loc[li] - org) / spac, 0,
                                  mesh.shape[dim] - 1))
        sl[axis] = slice(None)
        sums.append(alpha[tuple(sl)].sum() * d)
    org_ax = (mesh.x0, mesh.y0, mesh.z0)[axis]
    return np.asarray([float(s) + org_ax for s in _host(torch.stack(sums))])


def xi_reaction_rate(b, Xi, Su, rho_u, mesh: StructuredMesh, bcs=None):
    """XiReactionRate: the turbulent flame speed St = Xi Su and the rate
    wdot = rho_u St |grad b| of a b-Xi premixed model (b the regress
    variable). Returns (St, wdot)."""
    if bcs is None:
        zg = (zero_gradient(), zero_gradient())
        bcs = (zg, zg, zg)
    g = _grad(b, bcs, mesh)
    mag_gb = torch.sqrt((g ** 2).sum(0))
    St = Xi * Su
    return St, rho_u * St * mag_gb


__all__ += ["randomise", "surface_interpolate", "NearWallFields",
            "processor_field", "ReadFields",
            "field_coordinate_system_transform", "StreamLine",
            "region_size_distribution", "blending_factor",
            "age", "interface_height", "xi_reaction_rate"]
