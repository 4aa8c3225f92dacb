"""OpenFOAM polyMesh ASCII reader and writer -> GeneralMesh.

Port of deepflame_tpu/mesh/polymesh.py: points/faces/owner/neighbour/
boundary under constant/polyMesh, the format every OpenFOAM user has, so an
externally generated unstructured mesh (snappyHexMesh, gmsh ->
foamMeshConvert, ...) enters the face-list solver. ASCII only (binary
raises); geometry is recomputed by mesh/geometry.py, as polyMesh stores
topology only.
"""
from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from .geometry import GeneralMesh, build_general_mesh

__all__ = ["read_polymesh", "write_polymesh"]


def _read_foam_file(path: str) -> str:
    with open(path) as f:
        text = f.read()
    m = re.search(r"FoamFile\s*\{(.*?)\}", text, re.S)
    if m and re.search(r"format\s+binary", m.group(1)):
        raise NotImplementedError(f"{path}: binary polyMesh unsupported")
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    text = re.sub(r"FoamFile\s*\{[^}]*\}", " ", text)
    return text


def _read_points(path: str) -> np.ndarray:
    text = _read_foam_file(path)
    body = text[text.index("("):]
    nums = re.findall(r"[-+0-9.eE]+", body)
    arr = np.asarray([float(x) for x in nums], np.float64)
    return arr.reshape(-1, 3)


def _read_labels(path: str) -> np.ndarray:
    text = _read_foam_file(path)
    body = text[text.index("("):text.rindex(")")]
    return np.asarray([int(x) for x in re.findall(r"-?\d+", body)], np.int64)


def _read_faces(path: str) -> List[List[int]]:
    text = _read_foam_file(path)
    body = text[text.index("("):]
    out = []
    for m in re.finditer(r"(\d+)\s*\(([^)]*)\)", body):
        n = int(m.group(1))
        verts = [int(x) for x in m.group(2).split()]
        if len(verts) != n:
            raise ValueError("faces file: count/vertex mismatch")
        out.append(verts)
    return out


def _read_boundary(path: str):
    text = _read_foam_file(path)
    out = []
    for m in re.finditer(r"(\w+)\s*\{([^}]*)\}", text):
        name, body = m.group(1), m.group(2)
        def grab(key, default=None):
            g = re.search(rf"{key}\s+([^;\s]+)\s*;", body)
            return g.group(1) if g else default
        ftype = grab("type", "patch")
        n = grab("nFaces")
        s = grab("startFace")
        if n is None or s is None:
            continue
        out.append((name, ftype, int(s), int(n)))
    return out


def read_polymesh(directory: str) -> GeneralMesh:
    """Read constant/polyMesh-layout ASCII files from `directory`."""
    pts = _read_points(os.path.join(directory, "points"))
    faces = _read_faces(os.path.join(directory, "faces"))
    owner = _read_labels(os.path.join(directory, "owner"))
    neighbour = _read_labels(os.path.join(directory, "neighbour"))
    patch_defs = _read_boundary(os.path.join(directory, "boundary"))
    n_claimed = sum(n for (_, _, _, n) in patch_defs)
    if len(neighbour) + n_claimed != len(faces):
        raise ValueError(
            f"faces ({len(faces)}) != interior ({len(neighbour)}) + "
            f"boundary ({n_claimed})")
    return build_general_mesh(pts, faces, owner, neighbour, patch_defs)


_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "constant/polyMesh";
    object      {obj};
}}
"""


def write_polymesh(directory: str, points: np.ndarray,
                   faces: List[List[int]], owner: np.ndarray,
                   neighbour: np.ndarray, patch_defs) -> None:
    """Write ASCII polyMesh files (the inverse of read_polymesh's inputs).

    patch_defs: sequence of (name, type, startFace, nFaces).
    """
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "points"), "w") as f:
        f.write(_HEADER.format(cls="vectorField", obj="points"))
        f.write(f"{len(points)}\n(\n")
        for p in points:
            f.write(f"({p[0]:.16g} {p[1]:.16g} {p[2]:.16g})\n")
        f.write(")\n")
    with open(os.path.join(directory, "faces"), "w") as f:
        f.write(_HEADER.format(cls="faceList", obj="faces"))
        f.write(f"{len(faces)}\n(\n")
        for fc in faces:
            f.write(f"{len(fc)}(" + " ".join(str(v) for v in fc) + ")\n")
        f.write(")\n")
    for name, arr in (("owner", owner), ("neighbour", neighbour)):
        with open(os.path.join(directory, name), "w") as f:
            f.write(_HEADER.format(cls="labelList", obj=name))
            f.write(f"{len(arr)}\n(\n")
            f.write("\n".join(str(int(v)) for v in arr))
            f.write("\n)\n")
    with open(os.path.join(directory, "boundary"), "w") as f:
        f.write(_HEADER.format(cls="polyBoundaryMesh", obj="boundary"))
        f.write(f"{len(patch_defs)}\n(\n")
        for (name, ftype, start, n) in patch_defs:
            f.write(f"    {name}\n    {{\n        type            {ftype};\n"
                    f"        nFaces          {n};\n"
                    f"        startFace       {start};\n    }}\n")
        f.write(")\n")
