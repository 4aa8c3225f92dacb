"""Aggregation AMG preconditioner for FvMatrixFL (the face-list backend).

Port of deepflame_tpu/ops/amg_fl.py: the reference's AmgX AGGREGATION
V-cycle role for the pressure equation on general meshes.

- Host, once per mesh connectivity (`make_amg_fl`): greedy pairwise
  aggregation over the geometric face weights magSf/delta, giving static
  per-level maps (cell -> aggregate, fine face -> coarse face and its
  flip). The same stable argsort and the same greedy sweeps as the JAX
  package, in host numpy and Python, so the aggregates are equal.
- Device, once per solve (`AMGSetupFL.preconditioner`): Galerkin coarse
  operators P^T A P of piecewise-constant P, summed over the static maps
  with index_add_ (atomic on the card, so sums may round in another order
  from run to run), then a damped-Jacobi V(2,2)-cycle as M_inv of the
  pressure CG. PCG is invariant to a positive scaling of M, so the
  volume-scaled hierarchy preconditions the Vn-scaled system as it is.

The hierarchy works on the volume-scaled symmetric form Av = diag(V) A:
Av[c,c] = V_c diag_c[c], Av[own_f, nei_f] = upper[f], Av[nei_f, own_f] =
lower[f].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["AMGSetupFL", "make_amg_fl"]


class _Level(NamedTuple):
    agg: torch.Tensor            # (n_fine,) fine cell -> coarse cell
    n_fine: int
    n_coarse: int
    f2c: torch.Tensor            # (nf_fine,) fine face -> coarse face (pad nf_c)
    flip: torch.Tensor           # (nf_fine,) fine orientation opposite coarse
    internal: torch.Tensor       # (nf_fine,) face inside one aggregate
    internal_cell: torch.Tensor  # (nf_fine,) its aggregate (pad n_coarse)
    c_own: torch.Tensor          # (nf_coarse,)
    c_nei: torch.Tensor          # (nf_coarse,)
    nf_coarse: int


def _pairwise_aggregate(own: np.ndarray, nei: np.ndarray, w: np.ndarray,
                        n: int) -> tuple[np.ndarray, int]:
    """Greedy heavy-edge matching: visit faces by descending weight, pair
    both cells if still unmatched (pairGAMGAgglomeration's strategy). A
    second sweep absorbs unmatched cells into the aggregate across their
    heaviest face (aggregates of at most 3); isolated leftovers stay
    singletons. Returns (cell -> aggregate id, count). The sweeps run over
    Python lists (the JAX package's loops, element for element)."""
    order = np.argsort(-w, kind="stable").tolist()
    own_l, nei_l = own.tolist(), nei.tolist()
    mate = [-1] * n
    for f in order:
        a, b = own_l[f], nei_l[f]
        if mate[a] < 0 and mate[b] < 0:
            mate[a] = b
            mate[b] = a
    agg = [-1] * n
    nxt = 0
    for c in range(n):
        if agg[c] >= 0:
            continue
        agg[c] = nxt
        if mate[c] >= 0:
            agg[mate[c]] = nxt
        nxt += 1
    size = np.bincount(np.asarray(agg, np.int64), minlength=nxt).tolist()
    heaviest = {}
    for f in order:
        a, b = own_l[f], nei_l[f]
        if mate[a] < 0 and a not in heaviest:
            heaviest[a] = b
        if mate[b] < 0 and b not in heaviest:
            heaviest[b] = a
    for c, nb in heaviest.items():
        tgt = agg[nb]
        if size[tgt] < 3:
            size[agg[c]] -= 1
            agg[c] = tgt
            size[tgt] += 1
    agg = np.asarray(agg, np.int64)
    used = np.unique(agg)
    remap = np.zeros(nxt, np.int64)
    remap[used] = np.arange(len(used))
    return remap[agg], len(used)


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


@dataclasses.dataclass(frozen=True)
class AMGSetupFL:
    """Static aggregation hierarchy of one FaceListMesh connectivity."""
    levels: tuple            # tuple[_Level, ...]
    n_coarsest: int

    def preconditioner(self, eqn, volumes: torch.Tensor, nu_pre: int = 2,
                       nu_post: int = 2, n_coarse_iters: int = 20,
                       omega: float = 0.8) -> Callable:
        """M_inv(r) = one V-cycle of the volume-scaled operator of `eqn` (an
        FvMatrixFL; r flat (n,)). The coarse operators are built here from
        the current coefficients; the finest level's matvec is eqn's own
        (the lattice stencil kernel on plan meshes), prepared once."""
        D = eqn.diag() * volumes
        up, lo = eqn.upper, eqn.lower
        ops = []                       # per level: (D, up, lo, inv_diag)
        for lv in self.levels:
            inv_d = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
            ops.append((D, up, lo, inv_d))
            # Galerkin P^T Av P: fine diagonals and intra-aggregate faces
            # fold into the coarse diagonal; the other faces sum into coarse
            # faces (flip swaps upper and lower where the fine orientation
            # is reversed)
            D_c = _segment_sum(D, lv.agg, lv.n_coarse)
            both = torch.where(lv.internal, up + lo, torch.zeros_like(up))
            D_c = D_c + _segment_sum(both, lv.internal_cell,
                                     lv.n_coarse + 1)[:-1]
            up_c = _segment_sum(torch.where(lv.flip, lo, up), lv.f2c,
                                lv.nf_coarse + 1)[:-1]
            lo_c = _segment_sum(torch.where(lv.flip, up, lo), lv.f2c,
                                lv.nf_coarse + 1)[:-1]
            D, up, lo = D_c, up_c, lo_c
        inv_d = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
        ops.append((D, up, lo, inv_d))
        n_levels = len(ops)
        fine = eqn.operator(volumes.shape)

        def apply_level(i, x):
            if i == 0:
                return volumes * fine(x)
            D_l, up_l, lo_l, _ = ops[i]
            lv = self.levels[i - 1]
            off = (_segment_sum(up_l * x[lv.c_nei], lv.c_own, lv.n_coarse)
                   + _segment_sum(lo_l * x[lv.c_own], lv.c_nei, lv.n_coarse))
            return D_l * x + off

        def smooth(i, x, b, n_iters):
            inv_d = ops[i][3]
            for _ in range(n_iters):
                x = x + omega * inv_d * (b - apply_level(i, x))
            return x

        def v_cycle(i, b):
            x = torch.zeros_like(b)
            if i == n_levels - 1:
                return smooth(i, x, b, n_coarse_iters)
            x = smooth(i, x, b, nu_pre)
            r = b - apply_level(i, x)
            lv = self.levels[i]
            e_c = v_cycle(i + 1, _segment_sum(r, lv.agg, lv.n_coarse))
            return smooth(i, x + e_c[lv.agg], b, nu_post)

        return lambda r: v_cycle(0, r)


def make_amg_fl(mesh, max_levels: int = 25,
                min_coarse: int = 48) -> AMGSetupFL:
    """Host-side setup of the aggregation hierarchy of a FaceListMesh from
    its geometric face weights magSf/delta (once per connectivity: only the
    coefficients change between solves). The level maps are tensors on the
    mesh's device."""
    dev = mesh.device
    own = mesh.owner.cpu().numpy().astype(np.int64)
    nei = mesh.neighbour.cpu().numpy().astype(np.int64)
    w = (mesh.mag_sf.cpu().numpy().astype(np.float64)
         / mesh.delta.cpu().numpy().astype(np.float64))
    n = int(mesh.n_cells)
    ix = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)
    bl = lambda a: torch.as_tensor(a, dtype=torch.bool, device=dev)
    levels = []
    while n > min_coarse and len(levels) < max_levels:
        agg, n_c = _pairwise_aggregate(own, nei, w, n)
        if n_c >= n:                   # no progress (disconnected leftovers)
            break
        co, cn = agg[own], agg[nei]
        internal = co == cn
        ext = ~internal
        a = np.minimum(co[ext], cn[ext])
        b = np.maximum(co[ext], cn[ext])
        uniq, inv = np.unique(a * n_c + b, return_inverse=True)
        nf_c = len(uniq)
        f2c = np.full(own.shape[0], nf_c, np.int64)      # pad slot: dropped
        f2c[ext] = inv
        levels.append(_Level(
            agg=ix(agg), n_fine=n, n_coarse=n_c, f2c=ix(f2c),
            flip=bl(co > cn), internal=bl(internal),
            internal_cell=ix(np.where(internal, co, n_c)),
            c_own=ix(uniq // n_c), c_nei=ix(uniq % n_c), nf_coarse=nf_c))
        w_next = np.zeros(nf_c)
        np.add.at(w_next, inv, w[ext])
        own, nei = (uniq // n_c).astype(np.int64), (uniq % n_c).astype(np.int64)
        w, n = w_next, n_c
    return AMGSetupFL(levels=tuple(levels), n_coarsest=n)
