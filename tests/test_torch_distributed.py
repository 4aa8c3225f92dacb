"""The port's structured domain decomposition (parallel.distributed) on gloo
ranks of the CPU, float64.

Ranks are spawned processes (tests/torch_dist_ranks.py: a file store, a
process-group timeout of 60 s and a join deadline that kills the ranks), so
a deadlock fails one test. Against the JAX package's shard_map on 2 and 4
of the virtual devices: pad_field (every mode), pad_n and extend_padded
with processor BCs, and a convection-diffusion FvMatrix's A(x), rhs() and
diag() on processor axes, each shard's arrays equal to round-off (1e-14 of
the largest value); one DistributedLowMach step of the walls case with
chemistry on 2 ranks against the JAX package's single-device step (1e-9).
Against the port's own single-device step: two steps of the stiff TGV at
n = 8 split (2, 1, 1) and (2, 2, 1), and of the walls case (2, 1, 1), every
field within 1e-11 of its largest value (dp/dt through the pressure change
it implies: |d(dp/dt)| dt <= 1e-11 max|p|), the same Krylov iteration
counts, the diagnostics equal on every rank, and shard_state/gather_state an
exact round trip. Without ranks: solve_fvmatrix raises on a matrix
without a stencil and without a processor side; localize_solver gives the
block solver its own cached lane-stacked BCs, and raises on a BC array
spanning a split axis, which the JAX package's keeps (a watch-list
reproduction).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from deepflame_tpu.mesh.structured import (BC as JBC, StructuredMesh as JMesh,
                                           cyclic as jcyclic,
                                           empty as jempty,
                                           extend_padded as j_extend,
                                           pad_field as j_pad, pad_n as j_pad_n,
                                           zero_gradient as jzg)
from deepflame_tpu.ops.fv import fvm_div as j_div, \
    fvm_laplacian as j_lap
from deepflame_tpu.parallel import localize_bcs as j_localize, \
    shard_axis as j_shard_axis

import torch_dist_ranks as R

DT_TGV, DT_WALLS = 2.5e-7, 1e-7
FIELDS = ("rho", "U", "p", "ha", "Y", "T")

# BC pairs on x: (kind, value) as the port's and the JAX package's BC take
PAIRS = {"cyclic": (("cyclic", 0.0), ("cyclic", 0.0)),
         "zg": (("zeroGradient", 0.0), ("zeroGradient", 0.0)),
         "fixed-zg": (("fixedValue", 3.5), ("zeroGradient", 0.0)),
         "sym-fixed": (("symmetry", 0.0), ("fixedValue", -1.25))}
PAD_CASES = ([(pair, mode) for pair in PAIRS
              for mode in ("plain", "homogeneous", "bc_only")]
             + [(pair, op) for pair in ("cyclic", "fixed-zg")
                for op in ("pad_n", "extend0")])
NX, NY, NZ = 16, 4, 2
SPACING = (1.0 / NX, 0.25, 0.5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _field():
    return np.random.default_rng(0).normal(size=(NX, NY, NZ))


def _bcs_spec(pair):
    return (PAIRS[pair], (("zeroGradient", 0.0),) * 2,
            (("fixedValue", 0.75), ("zeroGradient", 0.0)))


def _jax_shards(n, body, *args, n_out=1):
    dev = Mesh(np.array(jax.devices()[:n]), ("x",))
    out = jax.jit(jax.shard_map(
        body, mesh=dev, in_specs=(P("x"),) * len(args),
        out_specs=(P("x"),) * n_out if n_out > 1 else P("x"),
        check_vma=False))(*args)
    outs = out if n_out > 1 else (out,)
    return [np.split(np.asarray(o), n, axis=0) for o in outs]


def _jax_pad(n, pair, op):
    bcs = tuple(tuple(JBC(*b) for b in side) for side in _bcs_spec(pair))
    mesh_l = JMesh(NX // n, NY, NZ, *SPACING)
    lb = j_localize(bcs, "x")

    def body(fl):
        with j_shard_axis("x"):
            if op in ("plain", "homogeneous", "bc_only"):
                return j_pad(fl, lb, mesh_l, homogeneous=op == "homogeneous",
                             bc_only=op == "bc_only")
            if op == "pad_n":
                return j_pad_n(fl, lb, mesh_l, 3)
            return j_extend(j_pad(fl, lb, mesh_l), 0, lb)

    return _jax_shards(n, body, jnp.asarray(_field()),
                       n_out=2 if op == "extend0" else 1)


@pytest.fixture(scope="module")
def port_pads(tmp_path_factory):
    """Every PAD_CASES case on 2 and 4 ranks, one spawn per rank count."""
    out = {}
    for n in (2, 4):
        cases = {f"{pair}/{op}": (_field(), SPACING, _bcs_spec(pair), op)
                 for pair, op in PAD_CASES}
        out[n] = R.run_ranks(R.pad_cases, n, tmp_path_factory.mktemp("pad"),
                             cases)
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pair,op", PAD_CASES)
def test_processor_padding_matches_jax_shard_map(port_pads, n, pair, op):
    """Each rank's padded block (pad_field, pad_n with 3 layers, or
    extend_padded's (Pm, Pp) along the split axis) equals the JAX shard's:
    halo planes from the neighbour ranks, the domain-edge BC on the first
    and last."""
    want = _jax_pad(n, pair, op)
    for r in range(n):
        got = port_pads[n][r][f"{pair}/{op}"]
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w[r].shape
            assert _rel(g, w[r]) <= 1e-14, (r, pair, op)


def _fvm_operands():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(NX, NY, 1))
    phi = [rng.normal(size=(NX + 1, NY, 1)), rng.normal(size=(NX, NY + 1, 1)),
           np.zeros((NX, NY, 2))]
    phi[0][-1] = phi[0][0]                 # the cyclic seam's wrap face
    gam = [np.abs(p) + 0.1 for p in phi]
    return x, phi, gam


SCHEMES = ("limitedLinear", "upwind")
FVM_SPACING = (1.0 / NX, 0.5 / NY, 1.0)


@pytest.fixture(scope="module")
def port_fvm(tmp_path_factory):
    """Both schemes' A(x), rhs(), diag() on 2 and 4 ranks, one spawn per
    rank count."""
    x, phi, gam = _fvm_operands()
    return {n: R.run_ranks(R.fvm_cases, n, tmp_path_factory.mktemp("fvm"),
                           x, phi, gam, FVM_SPACING, SCHEMES)
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fvm_processor_matches_jax_shard_map(port_fvm, n, scheme):
    """A(x), rhs() and diag() (coloring, period 2 on the split axis) of a
    convection-diffusion FvMatrix on processor axes equal the JAX shards';
    stencil() gives way (None) there, as the JAX package's."""
    x, phi, gam = _fvm_operands()
    mesh_l = JMesh(NX // n, NY, 1, *FVM_SPACING)
    bcs = j_localize(((jcyclic(), jcyclic()), (jzg(), jzg()),
                      (jempty(), jempty())), "x")

    def body(xl, phix, phiy, phiz, gx, gy, gz):
        with j_shard_axis("x"):
            bwd = [(i, (i - 1) % n) for i in range(n)]
            topp = jax.lax.ppermute(phix[:1], "x", bwd)
            topg = jax.lax.ppermute(gx[:1], "x", bwd)
            e = (j_div((jnp.concatenate([phix, topp]), phiy, phiz), xl,
                       mesh_l, bcs, scheme)
                 + j_lap((jnp.concatenate([gx, topg]), gy, gz), mesh_l, bcs,
                         dtype=xl.dtype, sign=-1.0))
            return e.apply(xl), e.rhs(), e.diag()

    j = jnp.asarray
    want = _jax_shards(n, body, j(x), j(phi[0][:-1]), j(phi[1]), j(phi[2]),
                       j(gam[0][:-1]), j(gam[1]), j(gam[2]), n_out=3)
    for r in range(n):
        Ax, b, d, no_stencil = port_fvm[n][r][scheme]
        assert no_stencil
        for g, w in zip((Ax, b, d), want):
            assert _rel(g, w[r]) <= 1e-13, r


def test_solve_without_stencil_raises_off_processor_sides():
    """solve_fvmatrix takes the padded matvec only for a matrix with a
    processor side: a single-device matrix without a stencil raises, so no
    such term runs its plain matvec on the card unnoticed."""
    import torch
    import deepflame_torch.mesh as tm
    from deepflame_torch.ops.fv import fvm_laplacian
    from deepflame_torch.ops.linsolve import solve_fvmatrix
    mesh = tm.StructuredMesh.box((1.0, 1.0, 1.0), (4, 4, 2), device="cpu")
    zg = tm.zero_gradient()
    bcs = ((tm.fixed_value(1.0), zg), (zg, zg), (zg, zg))
    faces = tuple(torch.ones(tuple(n + (a == ax) for a, n in
                                   enumerate(mesh.shape)), dtype=torch.float64)
                  for ax in range(3))
    x0 = torch.zeros(mesh.shape, dtype=torch.float64)
    eqn = fvm_laplacian(faces, mesh, bcs, sign=-1.0)
    assert eqn.stencil() is not None
    assert solve_fvmatrix(eqn, x0, symmetric=True).x.shape == mesh.shape
    scalar = fvm_laplacian(1.0, mesh, bcs, sign=-1.0)   # no stencil part
    assert scalar.stencil() is None
    with pytest.raises(NotImplementedError):
        solve_fvmatrix(scalar, x0, symmetric=True)


def test_localized_jet_rebuilds_its_cached_bcs():
    """localize_solver (dataclasses.replace) gives the block solver its own
    lane-stacked BCs: the jet's per-species inlet BCs stacked for the block
    mesh under processor BCs on the split axis, not the global solver's
    cached ones."""
    from deepflame_torch.parallel import localize_solver
    solver, _ = R.build_structured("sjet")
    glob = solver.bcs_Y_lanes                       # fills the cache
    loc = localize_solver(solver, mesh_shape=(2, 1, 1))
    assert loc.mesh.shape == (4, 4, 4) and loc.mesh.x0 == solver.mesh.x0
    assert loc.bcs_Y_lanes is not glob
    lo, hi = loc.bcs_Y_lanes[0]
    assert lo.kind == hi.kind == "processor"
    inner = lo.value[1]
    assert inner.kind == "affine"
    assert tuple(inner.value[1].shape) == (9, 1, 4, 4)
    assert loc.bcs_U_lanes[0][0].kind == "processor"
    assert loc.bcs_coeff[0][0].kind == "processor"
    assert loc.bcs_coeff[0][0].value[1].kind == "zeroGradient"


# ----------------------------------------------------------------- steps

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Two distributed steps (and the port's single-device ones) of each
    case and split, on gloo ranks."""
    runs = {("tgv", (2, 1, 1)): DT_TGV, ("tgv", (2, 2, 1)): DT_TGV,
            ("walls", (2, 1, 1)): DT_WALLS}
    out = {}
    for (case, shape), dt in runs.items():
        n = int(np.prod(shape))
        out[(case, shape)] = R.run_ranks(
            R.low_mach_both, n, tmp_path_factory.mktemp(case), case, shape,
            2, dt)
    return out


STEP_CASES = [("tgv", (2, 1, 1)), ("tgv", (2, 2, 1)), ("walls", (2, 1, 1))]


@pytest.mark.parametrize("case,shape", STEP_CASES)
def test_distributed_step_matches_single_device(steps, case, shape):
    ranks = steps[(case, shape)]
    (fields, diags, _), (single, single_diags) = ranks[0]
    dt = DT_TGV if case == "tgv" else DT_WALLS
    for k in FIELDS:
        assert _rel(fields[k], single[k]) <= 1e-11, k
    for a, b in zip(fields["phi"], single["phi"]):
        if np.abs(b).max() > 0:
            assert _rel(a, b) <= 1e-11
    assert (np.abs(fields["dpdt"] - single["dpdt"]).max() * dt
            <= 1e-11 * np.abs(single["p"]).max())
    for d, sd in zip(diags, single_diags):
        for k in d:
            if k.startswith("iters"):
                assert np.array_equal(d[k], sd[k]), k


@pytest.mark.parametrize("case,shape", STEP_CASES)
def test_distributed_diagnostics_equal_on_every_rank(steps, case, shape):
    ranks = steps[(case, shape)]
    ref = ranks[0][0][1]
    for (fields, diags, _), _ in ranks[1:]:
        for d, d0 in zip(diags, ref):
            assert d.keys() == d0.keys()
            for k in d:
                assert np.array_equal(d[k], d0[k]), k
        for k in FIELDS:
            assert np.array_equal(fields[k], ranks[0][0][0][k]), k


@pytest.mark.parametrize("case,shape", STEP_CASES)
def test_shard_gather_round_trip(steps, case, shape):
    assert all(r[0][2] for r in steps[(case, shape)])


def test_distributed_step_matches_jax_single_device(tmp_path):
    """One DistributedLowMach step of the walls case (16 x 8, chemistry on)
    on 2 ranks against the JAX package's single-device step from the same
    state: every field within 1e-9 of its largest value."""
    from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                         make_thermo, make_transport)
    from deepflame_tpu.chemistry.integrator import RosenbrockOptions
    from deepflame_tpu.combustion import Laminar
    from deepflame_tpu.mesh.structured import fixed_value
    from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
    nx, ny, L = 16, 8, 2e-3
    mech = load_mechanism(R.MECH)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    mesh = JMesh.box([L, L * ny / nx, L / nx], [nx, ny, 1])
    bx, bx_u = (jzg(), jzg()), (fixed_value(0.0), fixed_value(0.0))
    by, bz = (jcyclic(), jcyclic()), (jempty(), jempty())
    bcs_s = (bx, by, bz)
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr,
        combustion=Laminar(th, kin, ode_opts=RosenbrockOptions(
            rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)),
        bcs_U=((bx_u, by, bz),) * 3, bcs_p=bcs_s, bcs_h=bcs_s, bcs_Y=bcs_s,
        bcs_rho=bcs_s,
        config=LowMachConfig(chemistry=True,
                             inert_index=int(mech.species_index("N2"))))
    p, T, Y, U = (jnp.asarray(a) for a in R.walls_state_for_jax())
    s = jax.jit(lambda s: solver.step(s, DT_WALLS)[0])(
        solver.initial_state(p, T, Y, U))
    got = R.run_ranks(R.low_mach_steps, 2, tmp_path, "walls", (2, 1, 1), 1,
                      DT_WALLS)[0][0]
    for k in FIELDS:
        assert _rel(got[k], getattr(s, k)) <= 1e-9, k


def test_jax_localize_solver_keeps_global_bc_arrays():
    """Watch-list reproduction (JAX package): localize_solver keeps a BC
    value that is an array over a split axis as it is, so the block's BC
    spans the global mesh (a y wall's per-face value over x, x split in
    two). The port's localize_solver raises there."""
    from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                         make_thermo, make_transport)
    from deepflame_tpu.combustion import NoCombustion
    from deepflame_tpu.mesh.structured import fixed_value
    from deepflame_tpu.parallel import localize_solver as j_localize_solver
    from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
    import torch
    from deepflame_torch.chemistry import load_mechanism as t_load
    from deepflame_torch.chemistry import (make_kinetics as t_kin,
                                           make_thermo as t_thermo,
                                           make_transport as t_tran)
    from deepflame_torch.combustion import NoCombustion as TNoComb
    from deepflame_torch.mesh.structured import (StructuredMesh as TMesh,
                                                 cyclic as tcyc,
                                                 empty as tempty,
                                                 fixed_value as tfix,
                                                 zero_gradient as tzg)
    from deepflame_torch.parallel import localize_solver
    from deepflame_torch.solvers.low_mach import (LowMachConfig as TConfig,
                                                  LowMachSolver as TSolver)
    wall = np.linspace(300.0, 400.0, 16).reshape(16, 1, 1)
    mech = load_mechanism(R.AIR)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    b = ((jcyclic(), jcyclic()), (fixed_value(jnp.asarray(wall)), jzg()),
         (jempty(), jempty()))
    sol = LowMachSolver(mesh=JMesh.box([1.0, 0.5, 0.1], [16, 8, 1]),
                        thermo=th, transport=tr,
                        combustion=NoCombustion(th, kin), bcs_U=(b, b, b),
                        bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
                        config=LowMachConfig(chemistry=False))
    loc = j_localize_solver(sol, n_shards=2)
    assert loc.mesh.nx == 8
    assert loc.bcs_p[1][0].value.shape == (16, 1, 1)
    mt = t_load(R.AIR, device="cpu")
    f64 = torch.float64
    tht, trt, kint = t_thermo(mt, f64), t_tran(mt, f64), t_kin(mt, f64)
    bt = ((tcyc(), tcyc()), (tfix(torch.as_tensor(wall)), tzg()),
          (tempty(), tempty()))
    solt = TSolver(mesh=TMesh.box([1.0, 0.5, 0.1], [16, 8, 1], device="cpu"),
                   thermo=tht, transport=trt, combustion=TNoComb(tht, kint),
                   bcs_U=(bt, bt, bt), bcs_p=bt, bcs_h=bt, bcs_Y=bt,
                   bcs_rho=bt, config=TConfig(chemistry=False))
    with pytest.raises(ValueError, match="spans mesh axis 0"):
        localize_solver(solt, n_shards=2)
