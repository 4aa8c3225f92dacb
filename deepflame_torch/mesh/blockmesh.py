"""blockMesh hex-block mesh generator -> GeneralMesh.

Port of deepflame_tpu/mesh/blockmesh.py (numpy on the host, the same loops
in the same order, so faces and cells come out in the JAX package's order
and fields compare index for index). OpenFOAM's blockMesh for the dict subset
the reference cases use: multi-block hex lattices with simpleGrading (plain
ratios and multi-section lists), collapsed-vertex hexes for axisymmetric
wedges, point-merged block interfaces, named patches from block-face quads,
and cyclic patch pairs. Curved `edges` and mergePatchPairs raise.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from .geometry import GeneralMesh, build_general_mesh

__all__ = ["parse_blockmesh_dict", "build_blockmesh", "build_blockmesh_raw",
           "read_blockmesh", "openfoam_cell_order"]

# hex local faces, outward orientation (OpenFOAM cellModel hex):
# corners 0-3 bottom (w=0) CCW seen from below, 4-7 top
_HEX_FACES = (
    (0, 3, 2, 1),    # w- bottom
    (4, 5, 6, 7),    # w+ top
    (0, 4, 7, 3),    # u- left
    (1, 2, 6, 5),    # u+ right
    (0, 1, 5, 4),    # v- front
    (3, 7, 6, 2),    # v+ back
)
# block-side -> the 4 block corner ids bounding that side (same order)
_SIDE_CORNERS = _HEX_FACES


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


def _tokenize(text: str) -> List[str]:
    return re.findall(r"[(){};]|[^\s(){};]+", text)


class _Tok:
    def __init__(self, toks):
        self.t = toks
        self.i = 0

    def peek(self):
        return self.t[self.i] if self.i < len(self.t) else None

    def next(self):
        v = self.t[self.i]
        self.i += 1
        return v

    def expect(self, s):
        v = self.next()
        if v != s:
            raise ValueError(f"blockMeshDict parse: expected '{s}' got '{v}'")

    def skip_foamfile(self):
        # FoamFile { ... }
        while self.i < len(self.t):
            if self.t[self.i] == "FoamFile":
                depth = 0
                self.i += 1
                while True:
                    v = self.next()
                    if v == "{":
                        depth += 1
                    elif v == "}":
                        depth -= 1
                        if depth == 0:
                            return
            else:
                return


def _read_vector_list(tk: _Tok):
    """( (a b c) (d e f) ... ) -> list of float triples."""
    tk.expect("(")
    out = []
    while tk.peek() != ")":
        tk.expect("(")
        v = []
        while tk.peek() != ")":
            v.append(float(tk.next()))
        tk.next()
        out.append(v)
    tk.next()
    return out


def _read_plain_list(tk: _Tok, cast=float):
    tk.expect("(")
    out = []
    while tk.peek() != ")":
        out.append(cast(tk.next()))
    tk.next()
    return out


def _read_grading(tk: _Tok):
    """simpleGrading spec: 3 per-axis entries, each a ratio or a
    multi-section list ((lenFrac cellFrac ratio) ...)."""
    tk.expect("(")
    out = []
    while tk.peek() != ")":
        if tk.peek() == "(":
            out.append([tuple(seg) for seg in _read_vector_list(tk)])
        else:
            out.append(float(tk.next()))
    tk.next()
    return out


def _expand_codestream_vertices(text: str) -> str:
    """Rewrite the reference's `vertices #codeStream {...}` idiom into a
    plain vertex list. The cases using it (twoD_tripleFlame,
    twoD_temporally_evolving_jet) share one generator pattern: N point()
    literals followed by a loop appending z-mirrored copies
    (points[i+sz] = point(x, y, -z)). General codeStream (arbitrary C++)
    is out of scope and still raises at the '#codeStream' token."""
    m = re.search(r"vertices\s+#codeStream\s*\{", text)
    if not m:
        return text
    # find the matching closing brace of the codeStream block
    depth = 1
    i = m.end()
    while depth > 0:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    block = text[m.end():i - 1]
    end = i
    while end < len(text) and text[end] in " \t\n;":
        end += 1
    pts = [tuple(float(x) for x in g.split(","))
           for g in re.findall(
               r"point\s*\(\s*([-\d.eE+]+\s*,\s*[-\d.eE+]+\s*,\s*"
               r"[-\d.eE+]+)\s*\)\s*;", block)]
    if not pts:
        return text                      # let the tokenizer raise
    if re.search(r"point\s*\(\s*pt\.x\(\)\s*,\s*pt\.y\(\)\s*,\s*"
                 r"-\s*pt\.z\(\)\s*\)", block):
        pts = pts + [(x, y, -z) for (x, y, z) in pts]
    verts = "vertices\n(\n" + "\n".join(
        f"    ({x} {y} {z})" for (x, y, z) in pts) + "\n);\n"
    return text[:m.start()] + verts + text[end:]


def parse_blockmesh_dict(text: str) -> dict:
    """Parse a blockMeshDict into {scale, vertices, blocks, boundary}."""
    text = _expand_codestream_vertices(_strip_comments(text))
    toks = _tokenize(_strip_comments(text))
    tk = _Tok(toks)
    tk.skip_foamfile()
    scale = 1.0
    vertices: List[List[float]] = []
    blocks: List[dict] = []
    boundary: List[dict] = []
    while tk.peek() is not None:
        t = tk.next()
        if t in ("convertToMeters", "scale"):
            scale = float(tk.next())
            tk.expect(";")
        elif t == "vertices":
            vertices = _read_vector_list(tk)
            tk.expect(";")
        elif t == "edges":
            lst = _read_plain_list(tk, cast=str)
            tk.expect(";")
            if lst:
                raise NotImplementedError("curved block edges unsupported")
        elif t == "mergePatchPairs":
            lst = _read_plain_list(tk, cast=str)
            tk.expect(";")
            if lst:
                raise NotImplementedError("mergePatchPairs unsupported")
        elif t == "blocks":
            tk.expect("(")
            while tk.peek() != ")":
                kw = tk.next()
                if kw != "hex":
                    raise NotImplementedError(f"block shape '{kw}'")
                corners = _read_plain_list(tk, cast=int)
                if tk.peek() not in ("(",):       # optional zone name
                    tk.next()
                counts = _read_plain_list(tk, cast=int)
                gkind = tk.next()                 # simpleGrading/edgeGrading
                grading = _read_grading(tk)
                if gkind == "edgeGrading":
                    if len(grading) != 12:
                        raise ValueError("edgeGrading needs 12 ratios")
                    gx = grading[0:4]
                    gy = grading[4:8]
                    gz = grading[8:12]
                    if (len(set(gx)) > 1 or len(set(gy)) > 1
                            or len(set(gz)) > 1):
                        raise NotImplementedError(
                            "per-edge distinct grading unsupported")
                    grading = [gx[0], gy[0], gz[0]]
                elif gkind != "simpleGrading":
                    raise NotImplementedError(f"grading kind '{gkind}'")
                blocks.append({"corners": corners, "counts": counts,
                               "grading": grading})
            tk.next()
            tk.expect(";")
        elif t == "boundary":
            tk.expect("(")
            while tk.peek() != ")":
                name = tk.next()
                tk.expect("{")
                ftype = "patch"
                nbr_patch = None
                faces: List[List[int]] = []
                while tk.peek() != "}":
                    k = tk.next()
                    if k == "type":
                        ftype = tk.next()
                        tk.expect(";")
                    elif k == "neighbourPatch":
                        nbr_patch = tk.next()
                        tk.expect(";")
                    elif k == "faces":
                        faces = [[int(x) for x in q]
                                 for q in _read_vector_list(tk)]
                        tk.expect(";")
                    else:
                        while tk.next() != ";":
                            pass
                tk.next()
                boundary.append({"name": name, "type": ftype,
                                 "faces": faces,
                                 "neighbourPatch": nbr_patch})
            tk.next()
            tk.expect(";")
        elif t in (";", "}", "{"):
            continue
        else:                                      # unknown entry: skip stmt
            depth = 0
            while tk.peek() is not None:
                v = tk.next()
                if v in ("(", "{"):
                    depth += 1
                elif v in (")", "}"):
                    depth -= 1
                elif v == ";" and depth == 0:
                    break
    return {"scale": scale, "vertices": np.asarray(vertices, np.float64),
            "blocks": blocks, "boundary": boundary}


def _grading_points(n: int, ratio) -> np.ndarray:
    """n+1 unit-interval coordinates. ratio: last/first cell size
    (blockMesh simpleGrading; negative = 1/|ratio|), or a multi-section
    list of (lengthFraction, cellFraction, ratio) — fractions normalized
    as blockMesh does."""
    if isinstance(ratio, (list, tuple)):
        segs = [(float(a_), float(b_), float(r_)) for (a_, b_, r_) in ratio]
        len_tot = sum(a_ for a_, _, _ in segs)
        cell_tot = sum(b_ for _, b_, _ in segs)
        pts = [0.0]
        n_used = 0
        for si, (lf, cf, r_) in enumerate(segs):
            n_i = ((n - n_used) if si == len(segs) - 1
                   else int(round(n * cf / cell_tot)))
            n_i = max(n_i, 1)
            n_used += n_i
            seg = _grading_points(n_i, r_) * (lf / len_tot)
            pts.extend((pts[-1] + seg[1:]).tolist())
        out = np.asarray(pts)
        if len(out) != n + 1:
            raise ValueError("multi-grading cell fractions do not tile the "
                             f"block ({len(out) - 1} != {n} cells)")
        return out / out[-1]
    if ratio < 0:
        ratio = 1.0 / -ratio
    if n == 1 or abs(ratio - 1.0) < 1e-12:
        return np.linspace(0.0, 1.0, n + 1)
    k = ratio ** (1.0 / (n - 1))
    first = (1.0 - k) / (1.0 - k ** n)
    sizes = first * k ** np.arange(n)
    return np.concatenate([[0.0], np.cumsum(sizes)])


def _trilinear(c: np.ndarray, u, v, w):
    """Map unit-cube lattices (u,v,w each (nu+1,nv+1,nw+1)) through the 8
    block corners c (8,3) with blockMesh corner numbering."""
    um, vm, wm = 1.0 - u, 1.0 - v, 1.0 - w
    sh = [um * vm * wm, u * vm * wm, u * v * wm, um * v * wm,
          um * vm * w, u * vm * w, u * v * w, um * v * w]
    return sum(s[..., None] * c[i] for i, s in enumerate(sh))


def build_blockmesh(d: dict) -> GeneralMesh:
    """Build the merged multi-block mesh from a parsed dict. Cyclic patch
    pairs (type cyclic + neighbourPatch) become wrap interior faces with a
    translation offset on the neighbour centre (geometry.build_general_mesh
    nei_offset), exactly as the structured backend's cyclic axes."""
    pts, faces, owner, neighbour, patch_defs = build_blockmesh_raw(d)
    nbr_of = {bd["name"]: bd.get("neighbourPatch")
              for bd in d["boundary"]}
    types = {name: t for (name, t, _, _) in patch_defs}
    cyc_pairs = []
    done = set()
    for (name, t, start, n) in patch_defs:
        if t == "cyclic" and name not in done:
            other = nbr_of.get(name)
            if other is None or types.get(other) != "cyclic":
                raise ValueError(f"cyclic patch '{name}' has no cyclic "
                                 f"neighbourPatch")
            cyc_pairs.append((name, other))
            done.add(name)
            done.add(other)
    if not cyc_pairs:
        return build_general_mesh(pts, faces, owner, neighbour, patch_defs)

    from .geometry import face_geometry, pad_faces
    f_ctr, _ = face_geometry(pts, pad_faces(faces))
    spans = {name: (start, n) for (name, t, start, n) in patch_defs}
    n_int = len(neighbour)
    bbox = np.ptp(pts, axis=0)
    tol = 1e-6 * max(float(np.linalg.norm(bbox)), 1e-30)

    add_faces, add_own, add_nei, add_off = [], [], [], []
    drop = set()
    for a_name, b_name in cyc_pairs:
        sa, na = spans[a_name]
        sb, nb = spans[b_name]
        if na != nb:
            raise ValueError(f"cyclic pair {a_name}/{b_name}: "
                             f"{na} vs {nb} faces")
        ca = f_ctr[sa:sa + na]
        cb = f_ctr[sb:sb + nb]
        t_vec = cb.mean(axis=0) - ca.mean(axis=0)
        lut = {tuple(np.round((cb[j]) / tol).astype(np.int64)): j
               for j in range(nb)}
        for i in range(na):
            key = tuple(np.round((ca[i] + t_vec) / tol).astype(np.int64))
            j = lut.get(key)
            if j is None:
                raise ValueError(f"cyclic pair {a_name}/{b_name}: face {i} "
                                 "has no translated partner")
            add_faces.append(faces[sa + i])
            add_own.append(owner[sa + i])
            add_nei.append(owner[sb + j])
            add_off.append(-t_vec)
        drop.add(a_name)
        drop.add(b_name)

    new_faces = [faces[k] for k in range(n_int)] + add_faces
    new_owner = list(owner[:n_int]) + add_own
    new_nei = list(neighbour) + add_nei
    offsets = np.zeros((len(new_nei), 3))
    offsets[n_int:] = np.asarray(add_off)
    new_defs = []
    for (name, t, start, n) in patch_defs:
        if name in drop:
            continue
        new_defs.append((name, t, len(new_faces), n))
        for k in range(start, start + n):
            new_faces.append(faces[k])
            new_owner.append(owner[k])
    return build_general_mesh(pts, new_faces, np.asarray(new_owner),
                              np.asarray(new_nei), new_defs,
                              nei_offset=offsets)


def build_blockmesh_raw(d: dict):
    """(points, faces, owner, neighbour, patch_defs) in polyMesh order —
    the writable form (mesh/polymesh.py write_polymesh) and the input to
    build_general_mesh."""
    verts = d["vertices"] * d["scale"]
    bbox = np.ptp(verts, axis=0)
    tol = 1e-8 * max(float(np.linalg.norm(bbox)), 1e-30)

    # 1. per-block lattices -> merged global points
    points: List[np.ndarray] = []
    key2id: Dict[tuple, int] = {}
    block_ids = []           # per block: (nu+1, nv+1, nw+1) global point ids

    def canon(p):
        return tuple(np.round(p / tol).astype(np.int64))

    for blk in d["blocks"]:
        c = verts[blk["corners"]]
        nu, nv, nw = blk["counts"]
        gu, gv, gw = blk["grading"]
        U, V, W = np.meshgrid(_grading_points(nu, gu),
                              _grading_points(nv, gv),
                              _grading_points(nw, gw), indexing="ij")
        P = _trilinear(c, U, V, W)                  # (nu+1, nv+1, nw+1, 3)
        ids = np.empty(P.shape[:3], np.int64)
        flat = P.reshape(-1, 3)
        fids = np.empty(flat.shape[0], np.int64)
        for n, p in enumerate(flat):
            k = canon(p)
            j = key2id.get(k)
            if j is None:
                j = len(points)
                key2id[k] = j
                points.append(p)
            fids[n] = j
        block_ids.append(fids.reshape(ids.shape))
    pts = np.asarray(points)

    # 2. cells (global ids per corner) and cell id offsets per block
    cells: List[tuple] = []
    cell_offset = []
    for ids, blk in zip(block_ids, d["blocks"]):
        nu, nv, nw = blk["counts"]
        cell_offset.append(len(cells))
        for i in range(nu):
            for j in range(nv):
                for k in range(nw):
                    cells.append((
                        ids[i, j, k], ids[i + 1, j, k],
                        ids[i + 1, j + 1, k], ids[i, j + 1, k],
                        ids[i, j, k + 1], ids[i + 1, j, k + 1],
                        ids[i + 1, j + 1, k + 1], ids[i, j + 1, k + 1]))

    # 3. faces by canonical vertex-set matching
    face_map: Dict[tuple, tuple] = {}   # key -> (ordered verts, owner cell)
    interior: List[tuple] = []          # (verts, owner, neighbour)
    for ci, cv in enumerate(cells):
        for lf in _HEX_FACES:
            quad = tuple(cv[x] for x in lf)
            uniq = tuple(sorted(set(quad)))
            if len(uniq) < 3:
                continue                            # collapsed face
            if uniq in face_map:
                verts0, own = face_map.pop(uniq)
                interior.append((verts0, own, ci))
            else:
                face_map[uniq] = (quad, ci)

    # 4. boundary patches from block-face quads
    # candidate (block, side) for each patch quad by corner-set match
    side_sets = []
    for bi, blk in enumerate(d["blocks"]):
        corners = blk["corners"]
        for si, sc in enumerate(_SIDE_CORNERS):
            s = frozenset(corners[x] for x in sc)
            side_sets.append((s, bi, si))

    def side_subfaces(bi, si):
        ids = block_ids[bi]
        nu, nv, nw = d["blocks"][bi]["counts"]
        ax = {0: 2, 1: 2, 2: 0, 3: 0, 4: 1, 5: 1}[si]
        top = si in (1, 3, 5)
        sl = [slice(None)] * 3
        sl[ax] = -1 if top else 0
        g = ids[tuple(sl)]                          # 2D id grid on the side
        out = []
        for a in range(g.shape[0] - 1):
            for b in range(g.shape[1] - 1):
                out.append((g[a, b], g[a + 1, b], g[a + 1, b + 1],
                            g[a, b + 1]))
        return out

    patch_faces: Dict[str, list] = {}
    patch_types: Dict[str, str] = {}
    claimed = set()
    for bd in d["boundary"]:
        patch_types[bd["name"]] = bd["type"]
        plist = patch_faces.setdefault(bd["name"], [])
        for quad in bd["faces"]:
            qset = frozenset(quad)
            hits = [(bi, si) for (s, bi, si) in side_sets if s == qset]
            if not hits:
                raise ValueError(f"patch quad {quad} matches no block side")
            for bi, si in hits:
                for sub in side_subfaces(bi, si):
                    uniq = tuple(sorted(set(sub)))
                    if len(uniq) < 3 or uniq in claimed:
                        continue
                    if uniq in face_map:            # still unmatched => bdry
                        verts0, own = face_map.pop(uniq)
                        plist.append((verts0, own))
                        claimed.add(uniq)

    if face_map:
        # blockMesh semantics: unassigned boundary faces go to the
        # defaultFaces patch (type empty) — 2D cases rely on this
        plist = patch_faces.setdefault("defaultFaces", [])
        patch_types.setdefault("defaultFaces", "empty")
        for uniq in list(face_map):
            verts0, own = face_map.pop(uniq)
            plist.append((verts0, own))
        if "defaultFaces" not in [bd["name"] for bd in d["boundary"]]:
            d = dict(d)
            d["boundary"] = list(d["boundary"]) + [
                {"name": "defaultFaces", "type": "empty", "faces": [],
                 "neighbourPatch": None}]

    # 5. assemble polyMesh-ordered arrays: interior, then patches
    faces_all: List[tuple] = []
    owner: List[int] = []
    neighbour: List[int] = []
    for verts0, own, nei in interior:
        # orient outward from the lower-numbered cell (owner)
        if own <= nei:
            faces_all.append(verts0)
            owner.append(own)
            neighbour.append(nei)
        else:
            faces_all.append(tuple(reversed(verts0)))
            owner.append(nei)
            neighbour.append(own)
    patch_defs = []
    for bd in d["boundary"]:
        name = bd["name"]
        plist = patch_faces.get(name, [])
        patch_defs.append((name, patch_types[name], len(faces_all),
                           len(plist)))
        for verts0, own in plist:
            faces_all.append(verts0)
            owner.append(own)

    return (pts, faces_all, np.asarray(owner), np.asarray(neighbour),
            patch_defs)


def openfoam_cell_order(d: dict) -> np.ndarray:
    """Permutation mapping THIS builder's cell ids to OpenFOAM blockMesh
    cell ids: `field_here = field_openfoam[openfoam_cell_order(d)]`.

    Both order cells block-by-block, but within a block this builder runs
    k fastest (aligned with the structured backend's C-order raveling)
    while OpenFOAM blockMesh runs i fastest (cellid = i + j*ni + k*ni*nj)
    — needed to import the reference's shipped nonuniform 0/* fields onto
    blockmesh-built meshes."""
    out = []
    offset = 0
    for blk in d["blocks"]:
        nu, nv, nw = blk["counts"]
        for i in range(nu):
            for j in range(nv):
                for k in range(nw):
                    out.append(offset + i + j * nu + k * nu * nv)
        offset += nu * nv * nw
    return np.asarray(out, np.int64)


def read_blockmesh(path: str) -> GeneralMesh:
    """Parse + build an OpenFOAM blockMeshDict file."""
    with open(path) as f:
        return build_blockmesh(parse_blockmesh_dict(f.read()))
