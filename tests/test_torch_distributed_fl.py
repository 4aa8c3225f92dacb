"""The port's face-list domain decomposition (parallel.distributed_fl) and
partition planners, float64 on the CPU.

Against the JAX package: FLDecomp's arrays (cell and face maps, halo maps,
patch selections) and every shard's localized mesh equal the JAX
package's integer for integer (floats bit for bit) on a box, on the n = 8
blockMesh jet and on a (4, 2) block_order of a 16 x 16 box; block_order of
an uneven cell count; partition_balance and partition_slabs on the native
and the numpy path. Against the port's single-device step on 4 gloo ranks
(tests/torch_dist_ranks.py): the periodic reacting box (2 steps) and the
kEpsilon duct with wall functions (4 steps), every field within 1e-11 of its
largest value (dp/dt through the pressure change it implies: |d(dp/dt)| dt
<= 1e-11 max|p|), the same Krylov iteration counts and extreme values of T
and k, the diagnostics equal on every rank, and shard_state/gather_state an exact round trip. And two
reproductions of JAX package faults: its DistributedLowMachFL keeps the
solver's global `p_ell` on every shard, and its localize_mesh drops the
non-orthogonal corrections (the port builds each shard's own p_ell and
localizes k_no with the faces).
"""
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh.blockmesh as jbm
import deepflame_tpu.mesh.facelist as jfl
import deepflame_tpu.native as jnative
from deepflame_tpu.mesh.structured import (StructuredMesh as JMesh,
                                           cyclic as jcyc, empty as jempty,
                                           fixed_value as jfix,
                                           zero_gradient as jzg)
from deepflame_tpu.parallel.distributed_fl import (FLDecomp as JFLDecomp,
                                                   block_order as j_order)

import deepflame_torch.mesh.blockmesh as tbm
import deepflame_torch.mesh.facelist as tfl
import deepflame_torch.native as tnative
from deepflame_torch.cases import jet_blockmesh_dict
from deepflame_torch.mesh.structured import (StructuredMesh as TMesh,
                                             cyclic as tcyc, empty as tempty,
                                             fixed_value as tfix,
                                             zero_gradient as tzg)
from deepflame_torch.parallel import FLDecomp, block_order

import torch_dist_ranks as R


def _meshes(case):
    """(JAX FaceListMesh, port FaceListMesh, order) of one connectivity."""
    if case == "jet":
        text = jet_blockmesh_dict(8)
        names = jbm.build_blockmesh(jbm.parse_blockmesh_dict(text)).patch_names
        jspec = {k: jzg() for k in names}
        jspec["outlet"] = jfix(101325.0)
        tspec = {k: tzg() for k in names}
        tspec["outlet"] = tfix(101325.0)
        jm = jbm.build_blockmesh(jbm.parse_blockmesh_dict(text)).with_bcs(
            jspec)
        tm = tbm.build_blockmesh(tbm.parse_blockmesh_dict(text)).with_bcs(
            tspec, device="cpu")
        return jm, tm, None
    if case == "box":
        cells = (10, 6, 2)
        jb = ((jzg(), jfix(2.0)), (jzg(), jzg()), (jzg(), jzg()))
        tb = ((tzg(), tfix(2.0)), (tzg(), tzg()), (tzg(), tzg()))
    else:                                   # a (4, 2) block order
        cells = (16, 16, 1)
        jb = ((jcyc(), jcyc()), (jcyc(), jcyc()), (jempty(), jempty()))
        tb = ((tcyc(), tcyc()), (tcyc(), tcyc()), (tempty(), tempty()))
    jm = jfl.from_structured(JMesh.box([0.1, 0.05, 0.01], cells), jb)
    tm = tfl.from_structured(TMesh.box([0.1, 0.05, 0.01], cells,
                                       device="cpu"), tb, device="cpu")
    order = None
    if case == "blocks":
        order = j_order(np.asarray(jm.centers), (4, 2, 1))
        assert np.array_equal(order, block_order(tm.centers.numpy(),
                                                 (4, 2, 1)))
    return jm, tm, order


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("case", ["box", "jet", "blocks"])
def test_fldecomp_matches_jax(case):
    jm, tm, order = _meshes(case)
    P = 8 if case == "blocks" else 4
    jd, td = JFLDecomp(jm, P, order), FLDecomp(tm, P, order)
    for k in ("cell_gid", "face_gid", "_f_own", "_f_nei", "_w_own",
              "_face_src", "_lidx"):
        _eq(getattr(td, k), getattr(jd, k), k)
    assert (td.n_loc, td.nf_loc, td.halo_offsets) == \
        (jd.n_loc, jd.nf_loc, jd.halo_offsets)
    assert td._halo_maps.keys() == jd._halo_maps.keys()
    for d in jd._halo_maps:
        for a, b in zip(td._halo_maps[d], jd._halo_maps[d]):
            _eq(a, b, f"halo {d}")
    for (s1, c1, n1), (s2, c2, n2) in zip(td._patch_sel, jd._patch_sel):
        _eq(s1, s2, "patch sel")
        _eq(c1, c2, "patch counts")
        assert n1 == n2
    jl = jd.localize_mesh(jm)
    for r in range(P):
        tl = td.localize_mesh(tm, r)
        assert tl.n_cells == jl.n_cells
        for k in ("owner", "neighbour", "mag_sf", "delta", "weights",
                  "normal", "volumes", "centers", "w_own", "ell_face",
                  "ell_sign"):
            _eq(getattr(tl, k), np.asarray(getattr(jl, k))[r], k)
        for d, (send, recv) in jl.halo.items():
            _eq(tl.halo[d][0], np.asarray(send)[r], "send")
            _eq(tl.halo[d][1], np.asarray(recv)[r], "recv")
        for tp, jp in zip(tl.patches, jl.patches):
            assert tp.n_axis == jp.n_axis
            for k in ("owner", "mag_sf", "delta", "a", "b", "normal"):
                _eq(getattr(tp, k), np.asarray(getattr(jp, k))[r], k)


def test_fldecomp_round_trip():
    """localize/gather are exact inverses for cell, face and patch fields;
    the owned slots cover every cell once."""
    _, tm, _ = _meshes("box")
    d = FLDecomp(tm, 4)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(tm.n_cells, 3)))
    assert torch.equal(d.gather_cell([d.localize_cell(x, r)
                                      for r in range(4)]), x)
    phi = torch.as_tensor(rng.normal(size=tm.n_faces))
    assert torch.equal(d.gather_face([d.localize_face(phi, r)
                                      for r in range(4)]), phi)
    for ip, p in enumerate(tm.patches):
        xb = torch.as_tensor(rng.normal(size=p.owner.shape[0]))
        assert torch.equal(d.gather_patchfield(
            ip, [d.localize_patchfield(ip, xb, r) for r in range(4)]), xb)
    counts = np.zeros(tm.n_cells, int)
    for r in range(4):
        counts[d.cell_gid[r][d._w_own[r] > 0]] += 1
    assert (counts == 1).all()


def test_block_order_uneven_matches_jax():
    """block_order of 5,170 cells (the Sandia wedge's count) in (2, 2, 1)
    blocks: the JAX package's permutation, leaf sizes those of
    partition_slabs."""
    centers = np.random.default_rng(3).normal(size=(5170, 3))
    order = block_order(centers, (2, 2, 1))
    assert np.array_equal(order, j_order(centers, (2, 2, 1)))
    assert sorted(order.tolist()) == list(range(5170))
    starts = tnative.partition_slabs(5170, 4)
    assert np.diff(starts).max() - np.diff(starts).min() <= 1


@pytest.mark.parametrize("use_native", [True, False])
def test_partition_planners_match_jax(use_native):
    for dims, n in [((96, 96, 96), 8), ((128, 64, 64), 4), ((7, 5, 3), 6),
                    ((16, 8, 1), 4), ((100, 2, 1), 12), ((1, 1, 1), 3)]:
        assert tnative.partition_balance(*dims, n, use_native=use_native) \
            == jnative.partition_balance(*dims, n)
    for n, p in [(10, 4), (5170, 8), (3, 5), (524288, 4), (0, 2)]:
        got = tnative.partition_slabs(n, p, use_native=use_native)
        want = jnative.partition_slabs(n, p)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def fl_runs(tmp_path_factory):
    return {case: R.run_ranks(R.fl_both, 4, tmp_path_factory.mktemp(case),
                              case, steps, dt, timeout=240)
            for case, steps, dt in (("box", 2, 5e-7), ("duct", 4, 2e-5))}


FL_FIELDS = ("rho", "U", "p", "ha", "Y", "T", "phi")
DT = {"box": 5e-7, "duct": 2e-5}


@pytest.mark.parametrize("case", ["box", "duct"])
def test_fl_distributed_matches_single_device(fl_runs, case):
    (fields, diags, _), (single, sdiags) = fl_runs[case][0]
    for k in FL_FIELDS:
        assert R_rel(fields[k], single[k]) <= 1e-11, k
    for a, b in zip(fields["phi_b"] + fields["turb"],
                    single["phi_b"] + single["turb"]):
        assert R_rel(a, b) <= 1e-11
    assert (np.abs(fields["dpdt"] - single["dpdt"]).max() * DT[case]
            <= 1e-11 * np.abs(single["p"]).max())
    for d, sd in zip(diags, sdiags):
        assert d.keys() == sd.keys()
        for k in d:
            if k.startswith("iters"):
                assert np.array_equal(d[k], sd[k]), k
            elif k in ("T_min", "T_max", "k_max"):
                # over the owned cells only (halo and pad slots left out),
                # so the single-device values
                assert R_rel(d[k], sd[k]) <= 1e-11, k


@pytest.mark.parametrize("case", ["box", "duct"])
def test_fl_distributed_equal_on_every_rank(fl_runs, case):
    runs = fl_runs[case]
    for (fields, diags, same), _ in runs:
        assert same
        for d, d0 in zip(diags, runs[0][0][1]):
            for k in d:
                assert np.array_equal(d[k], d0[k]), k
        for k in FL_FIELDS:
            assert np.array_equal(fields[k], runs[0][0][0][k]), k


def R_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_jax_distributed_fl_keeps_the_global_p_ell():
    """Watch-list reproduction (JAX package): DistributedLowMachFL
    localizes the solver's meshes, wall functions and species-group meshes
    and swaps them in (`dataclasses.replace(solver, **meshes)` in its shard
    body), but not `p_ell`: a shard keeps the ELL connectivity of the
    global mesh, whose cell indices address the global cells, so its
    pressure matvec would gather the wrong rows. The port builds each
    shard's own (the shard's cells, pad faces left out)."""
    from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                         make_thermo, make_transport)
    from deepflame_tpu.combustion import NoCombustion
    from deepflame_tpu.parallel.distributed_fl import DistributedLowMachFL
    from deepflame_tpu.solvers.low_mach import LowMachConfig
    from deepflame_tpu.solvers.low_mach_fl import LowMachSolverFL
    jm, tm, _ = _meshes("box")
    mech = load_mechanism(R.AIR)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    sol = LowMachSolverFL(m_p=jm, m_h=jm, m_Y=jm, m_rho=jm, m_U=(jm,) * 3,
                          thermo=th, transport=tr,
                          combustion=NoCombustion(th, kin),
                          config=LowMachConfig(chemistry=False),
                          p_ell=jm.ell_connectivity())
    dist = DistributedLowMachFL(sol, n_shards=4)
    assert "p_ell" not in dist._lm
    assert dist._lm["m_p"].n_cells == dist.decomp.n_loc
    assert np.asarray(dist.solver.p_ell[0]).shape[0] == jm.n_cells
    assert jm.n_cells != dist.decomp.n_loc
    d = FLDecomp(tm, 4)
    for r in range(4):
        lm = d.localize_mesh(tm, r)
        face_ids, _, nbr = lm.ell_connectivity(exclude=d.pad_faces(r))
        assert face_ids.shape[0] == nbr.shape[0] == d.n_loc
        assert int(face_ids.max()) < lm.n_faces
        assert int(nbr.max()) < d.n_loc


def _sheared(builder):
    """tests/test_nonortho.py's sheared 8 x 8 box (non-orthogonal) built
    by `builder` (the JAX package's or the port's build_general_mesh)."""
    import test_nonortho
    keep = test_nonortho.build_general_mesh
    test_nonortho.build_general_mesh = builder
    try:
        return test_nonortho.sheared_box(8, 0.5)
    finally:
        test_nonortho.build_general_mesh = keep


def test_jax_localize_mesh_drops_the_nonorthogonal_correction():
    """Watch-list reproduction (JAX package): FLDecomp.localize_mesh builds
    the shard meshes without the mesh's k_no and skew (and keeps each
    patch's global k_no), so a distributed step on a non-orthogonal mesh
    drops its corrections. The port localizes them with the faces."""
    from deepflame_tpu.mesh.geometry import build_general_mesh as jbuild
    from deepflame_torch.mesh.geometry import build_general_mesh as tbuild
    names = ("x_lo", "x_hi", "y_lo", "y_hi")
    jm = _sheared(jbuild).with_bcs({k: jzg() for k in names})
    tm = _sheared(tbuild).with_bcs({k: tzg() for k in names}, device="cpu")
    assert jm.k_no is not None and tm.k_no is not None
    assert JFLDecomp(jm, 2).localize_mesh(jm).k_no is None
    d = FLDecomp(tm, 2)
    for r in range(2):
        lm = d.localize_mesh(tm, r)
        valid = d.face_gid[r] >= 0
        _eq(lm.k_no[torch.as_tensor(valid)],
            tm.k_no[torch.as_tensor(d.face_gid[r, valid])], "k_no")
        assert (lm.k_no[torch.as_tensor(~valid)] == 0).all()
