"""OpenFOAM field-file import: run reference cases on their exact data.

Port of deepflame_tpu/runtime/openfoam_io.py (the package's own copy of the
parsing, which is host numpy). Reads ascii volScalarField/volVectorField
internalField entries, uniform or nonuniform List<scalar|vector>, plain or
.gz; cell order as blockMesh writes it, x fastest, then y, then z. The
readers return tensors on `device` (default: the CUDA card) in `dtype`
(default float64).
"""
from __future__ import annotations

import gzip
import os
import re

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["read_openfoam_field_flat", "read_openfoam_field",
           "read_case_fields"]

_NONUNIFORM = re.compile(r"internalField\s+nonuniform\s+List<(scalar|vector)>"
                         r"\s*\n?\s*(\d+)\s*\n?\s*\(")
_UNIFORM_VEC = re.compile(r"internalField\s+uniform\s+\(([^)]*)\)\s*;")
_UNIFORM = re.compile(r"internalField\s+uniform\s+([-\d.eE+]+)\s*;")


def _read_text(path: str) -> str:
    if os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _list_body(text: str, start: int) -> np.ndarray:
    """The numbers of the parenthesised list that opens just before
    `start`, nested parentheses (vectors) flattened."""
    depth = 1
    i = start
    while depth > 0:
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        i += 1
    body = text[start:i - 1]
    return np.array(body.replace("(", " ").replace(")", " ").split(),
                    dtype=np.float64)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=resolve_device(device))


def read_openfoam_field_flat(path: str, dtype=torch.float64,
                             device=None) -> torch.Tensor:
    """internalField in the file's own cell order: (n,) scalar or (n, 3)
    vector; a uniform field gives its one value, (1,) or (3,)."""
    text = _read_text(path)
    m = _NONUNIFORM.search(text)
    if not m:
        mu = _UNIFORM_VEC.search(text)
        if mu:
            return _tensor(np.array([float(t) for t in mu.group(1).split()]),
                           dtype, device)
        mu = _UNIFORM.search(text)
        if mu:
            return _tensor(np.array([float(mu.group(1))]), dtype, device)
        raise ValueError(f"cannot parse internalField in {path}")
    kind, count = m.group(1), int(m.group(2))
    nums = _list_body(text, m.end())
    if kind == "scalar":
        if nums.size != count:
            raise ValueError(f"{path}: {nums.size} values, header {count}")
        return _tensor(nums, dtype, device)
    if nums.size != 3 * count:
        raise ValueError(f"{path}: {nums.size} values, header 3 x {count}")
    return _tensor(nums.reshape(count, 3), dtype, device)


def read_openfoam_field(path: str, shape, dtype=torch.float64,
                        device=None) -> torch.Tensor:
    """internalField as (nx, ny, nz) (scalar) or (3, nx, ny, nz) (vector);
    `shape` = (nx, ny, nz) of the blockMesh."""
    nx, ny, nz = shape
    n = nx * ny * nz
    text = _read_text(path)
    m = _UNIFORM_VEC.search(text)
    if m:
        vals = np.array([float(t) for t in m.group(1).split()])
        return _tensor(_reshape_vec(np.broadcast_to(vals[:, None], (3, n)),
                                    shape), dtype, device)
    m = _UNIFORM.search(text)
    if m:
        return _tensor(np.full(shape, float(m.group(1))), dtype, device)
    m = _NONUNIFORM.search(text)
    if not m:
        raise ValueError(f"cannot parse internalField in {path}")
    kind, count = m.group(1), int(m.group(2))
    if count != n:
        raise ValueError(f"{path}: field has {count} cells, mesh has {n}")
    nums = _list_body(text, m.end())
    if kind == "scalar":
        if nums.size != n:
            raise ValueError(f"{path}: {nums.size} values for {n} cells")
        return _tensor(nums.reshape(nz, ny, nx).transpose(2, 1, 0), dtype,
                       device)
    if nums.size != 3 * n:
        raise ValueError(f"{path}: {nums.size} values for 3 x {n}")
    return _tensor(_reshape_vec(nums.reshape(n, 3).T, shape), dtype, device)


def _reshape_vec(vec_flat: np.ndarray, shape) -> np.ndarray:
    nx, ny, nz = shape
    return vec_flat.reshape(3, nz, ny, nx).transpose(0, 3, 2, 1)


def read_case_fields(case_dir: str, time: str, names, shape,
                     dtype=torch.float64, device=None) -> dict:
    """Several fields from <case>/<time>/<name>."""
    return {name: read_openfoam_field(os.path.join(case_dir, time, name),
                                      shape, dtype, device)
            for name in names}
