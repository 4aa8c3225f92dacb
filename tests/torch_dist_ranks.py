"""Rank launcher and rank bodies of the port's distributed CPU tests.

`run_ranks(body, n, tmp_path, *args)` spawns n processes (the `spawn`
context: nothing of the test process, JAX included, is inherited), each of
which joins a gloo process group through a file store under tmp_path (no
TCP port to collide across test workers), calls `body(rank, n, *args)` and
pickles what it returns; the launcher joins them with a deadline, kills
every rank left at the deadline, and returns the results in rank order or
raises with the failing ranks' tracebacks. This module imports no JAX: the
spawned ranks import it.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MECH = os.path.join(HERE, "data", "h2_air_9sp.json")
AIR = os.path.join(HERE, "data", "air.yaml")
# seconds a collective may wait before the process group gives up
PG_TIMEOUT = 60


def _rank_main(body, rank: int, n: int, store: str, out: str, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    path = os.path.join(out, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT))
        result = ("ok", body(rank, n, *args))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(path, "wb") as f:
        pickle.dump(result, f)
    if result[0] == "error":
        sys.exit(1)


def run_ranks(body, n: int, tmp_path, *args, timeout: float = 150.0):
    """[body(rank, n, *args) of each rank], from n gloo ranks."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    tmp = str(tmp_path)
    store = os.path.join(tmp, f"store-{time.monotonic_ns()}")
    out = os.path.join(tmp, f"out-{time.monotonic_ns()}")
    os.makedirs(out)
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, n, store, out, args), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(n):
        path = os.path.join(out, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            kind, val = pickle.load(f)
        if kind == "error":
            errors.append(f"rank {r}:\n{val}")
        results.append(val)
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s "
                           "(killed)\n" + "\n".join(errors))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


# ------------------------------------------------------- processor BCs

def _bc(spec):
    """BC from a (kind, value) pair."""
    from deepflame_torch.mesh.structured import BC
    return BC(*spec)


def pad_cases(rank: int, n: int, cases):
    """pad_field / pad_n / extend_padded of this rank's x slab of each
    case's global field under localized BCs: {name: padded arrays}."""
    import torch
    from deepflame_torch.mesh.structured import (StructuredMesh,
                                                 extend_padded, pad_field,
                                                 pad_n)
    from deepflame_torch.parallel import ShardGroup, localize_bcs, shard_axis
    g = ShardGroup((n, 1, 1), ("x", "y", "z"))
    out = {}
    for name, (f, spacing, bcs_spec, op) in cases.items():
        bcs = tuple(tuple(_bc(b) for b in pair) for pair in bcs_spec)
        nl = f.shape[-3] // n
        mesh = StructuredMesh(nl, f.shape[-2], f.shape[-1], *spacing)
        x = torch.as_tensor(f)[..., rank * nl:(rank + 1) * nl, :, :]
        lb = localize_bcs(bcs, "x")
        with shard_axis(g):
            if op in ("plain", "homogeneous", "bc_only"):
                r = pad_field(x, lb, mesh, homogeneous=op == "homogeneous",
                              bc_only=op == "bc_only")
            elif op == "pad_n":
                r = pad_n(x, lb, mesh, 3)
            else:
                r = extend_padded(pad_field(x, lb, mesh), int(op[-1]), lb)
        out[name] = _np(r)
    return out


def fvm_cases(rank: int, n: int, x, phi, gam, spacing, schemes):
    """{scheme: fvm_case(...)} for each convection scheme."""
    return {sc: fvm_case(rank, n, x, phi, gam, spacing, sc)
            for sc in schemes}


def fvm_case(rank: int, n: int, x, phi, gam, spacing, scheme):
    """A(x), rhs() and diag() of a convection-diffusion FvMatrix on this
    rank's x slab (cyclic x split over the ranks, zeroGradient y, empty
    z), its face arrays built as DistributedLowMach builds them: the low
    faces of the block and the next rank's first face."""
    import torch
    from deepflame_torch.mesh.structured import (StructuredMesh, cyclic,
                                                 empty, zero_gradient)
    from deepflame_torch.ops.fv import fvm_div, fvm_laplacian
    from deepflame_torch.parallel import ShardGroup, localize_bcs, shard_axis
    g = ShardGroup((n, 1, 1), ("x", "y", "z"))
    nx = x.shape[0]
    nl = nx // n
    sl = slice(rank * nl, (rank + 1) * nl)
    mesh = StructuredMesh(nl, x.shape[1], x.shape[2], *spacing)
    bcs = localize_bcs(((cyclic(), cyclic()),
                        (zero_gradient(), zero_gradient()),
                        (empty(), empty())), "x")
    t = torch.as_tensor
    hi = (rank + 1) % n * nl
    loc_x = lambda a: torch.cat([t(a[sl]), t(a[hi:hi + 1])], 0)
    phi_l = (loc_x(phi[0]), t(phi[1][sl]), t(phi[2][sl]))
    gam_l = (loc_x(gam[0]), t(gam[1][sl]), t(gam[2][sl]))
    xl = t(x[sl])
    with shard_axis(g):
        e = (fvm_div(phi_l, xl, mesh, bcs, scheme)
             + fvm_laplacian(gam_l, mesh, bcs, dtype=xl.dtype, sign=-1.0))
        return _np((e.apply(xl), e.rhs(), e.diag(), e.stencil() is None))


# ------------------------------------------------------------ low-Mach

def build_tgv(n: int = 8, dtype_name: str = "float64", device: str = "cpu"):
    import torch
    sys.path.insert(0, ROOT)
    from deepflame_torch.cases import reacting_tgv_3d_les
    return reacting_tgv_3d_les(MECH, n=n, dtype=getattr(torch, dtype_name),
                               device=device)


def build_walls(nx: int = 16, ny: int = 8, chemistry: bool = True):
    """The JAX package's test_distributed walls case on the test mechanism:
    a 2D H2-air hot spot, walls on x (zeroGradient scalars, fixed zero
    velocity), cyclic y, empty z; float64 on the CPU."""
    import torch
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo, make_transport)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.combustion import Laminar
    from deepflame_torch.mesh.structured import (StructuredMesh, cyclic,
                                                 empty, fixed_value,
                                                 zero_gradient)
    from deepflame_torch.solvers.low_mach import LowMachConfig, LowMachSolver
    mech = load_mechanism(MECH, device="cpu")
    dt = torch.float64
    th, tr, kin = (make_thermo(mech, dt), make_transport(mech, dt),
                   make_kinetics(mech, dt))
    L = 2e-3
    mesh = StructuredMesh.box([L, L * ny / nx, L / nx], [nx, ny, 1],
                              device="cpu")
    bx = (zero_gradient(), zero_gradient())
    bx_u = (fixed_value(0.0), fixed_value(0.0))
    by, bz = (cyclic(), cyclic()), (empty(), empty())
    bcs_s = (bx, by, bz)
    bcs_u = ((bx_u, by, bz), (bx_u, by, bz), (bx_u, by, bz))
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0))
    iN2 = mech.species_index("N2")
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb, bcs_U=bcs_u,
        bcs_p=bcs_s, bcs_h=bcs_s, bcs_Y=bcs_s, bcs_rho=bcs_s,
        config=LowMachConfig(chemistry=chemistry, inert_index=iN2))
    return solver, walls_fields(mech.n_species, mech.species_index, nx, ny)


def walls_fields(ns, species_index, nx: int = 16, ny: int = 8):
    """(p, T, Y, U) of the walls case, numpy float64."""
    L = 2e-3
    dx = L / nx
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dx
    X, Yg = np.meshgrid(x, y, indexing="ij")
    X, Yg = X[..., None], Yg[..., None]
    r2 = (X - L / 2) ** 2 + (Yg - L * ny / nx / 2) ** 2
    T = np.where(r2 < (L / 4) ** 2, 1500.0, 800.0)
    p = np.full(T.shape, 101325.0)
    Yf = np.zeros(ns)
    Yf[species_index("H2")], Yf[species_index("O2")] = 0.0285, 0.2264
    Yf[species_index("N2")] = 0.7451
    Y = np.tile(Yf[:, None, None, None], (1,) + T.shape)
    U = np.zeros((3,) + T.shape)
    return p, T, Y, U


def _fields(s, names=("rho", "U", "p", "ha", "Y", "T", "dpdt")):
    out = {k: _np(getattr(s, k)) for k in names}
    out["phi"] = _np(s.phi)
    return out


def _diag(d):
    return {k: _np(v) for k, v in d.items()}


def build_structured(case: str):
    """(solver, initial state), float64 on the CPU: 'tgv', the stiff TGV
    at n = 8; 'walls', build_walls; 'sjet', the structured jet at n = 4
    (8 x 4 x 4)."""
    import torch
    if case == "tgv":
        return build_tgv()
    if case == "sjet":
        sys.path.insert(0, ROOT)
        from deepflame_torch.cases import jet_flame_3d_les
        return jet_flame_3d_les(MECH, n=4, dtype=torch.float64, device="cpu")
    solver, (p, T, Y, U) = build_walls()
    return solver, solver.initial_state(p, T, Y, U)


def low_mach_steps(rank: int, n: int, case: str, mesh_shape, steps: int,
                   dt: float):
    """`steps` DistributedLowMach steps of a case from its initial state:
    (gathered fields, [diag per step], shard/gather round trip equal)."""
    import torch
    from deepflame_torch.parallel import DistributedLowMach
    solver, s0 = build_structured(case)
    dist = DistributedLowMach(solver, mesh_shape=mesh_shape)
    ds = dist.shard_state(s0)
    back = dist.gather_state(ds)
    same = all(torch.equal(getattr(back, k), getattr(s0, k))
               for k in ("rho", "U", "p", "ha", "Y", "T", "dpdt"))
    same = same and all(torch.equal(a, b) for a, b in zip(back.phi, s0.phi))
    diags = []
    for _ in range(steps):
        ds, d = dist.step(ds, dt)
        diags.append(_diag(d))
    return _fields(dist.gather_state(ds)), diags, same


def single_steps(case: str, steps: int, dt: float):
    """The port's single-device steps of the same case (run in a rank, so
    that the test process imports no solver state twice)."""
    solver, s = build_structured(case)
    diags = []
    for _ in range(steps):
        s, d = solver.step(s, dt)
        diags.append(_diag(d))
    return _fields(s), diags


def low_mach_both(rank: int, n: int, case: str, mesh_shape, steps: int,
                  dt: float):
    """The distributed steps, and on rank 0 also the single-device ones
    (after the distributed run, which every rank takes part in)."""
    dist_out = low_mach_steps(rank, n, case, mesh_shape, steps, dt)
    single = single_steps(case, steps, dt) if rank == 0 else None
    return dist_out, single


def walls_state_for_jax():
    """(p, T, Y, U) of the walls case on the test mechanism, numpy."""
    sys.path.insert(0, ROOT)
    from deepflame_torch.chemistry import load_mechanism
    mech = load_mechanism(MECH, device="cpu")
    return walls_fields(mech.n_species, mech.species_index)


# ----------------------------------------------------------- face-list

def build_fl(case: str):
    """(solver, initial state) of a face-list case, float64 on the CPU:
    'box', a periodic reacting H2 hot spot on a 12 x 12 x 1 shift-plan box
    (the JAX package's test_fl_distributed_box_chemistry on the test
    mechanism); 'duct', the inlet/outlet duct with walls, standard
    k-epsilon and wall functions on air (test_fl_distributed_duct_keps_
    wallfns); 'jet', the blockMesh jet at n = 4 (8 x 4 x 4)."""
    import math
    import torch
    sys.path.insert(0, ROOT)
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo, make_transport)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.combustion import Laminar, NoCombustion
    from deepflame_torch.mesh.facelist import from_structured
    from deepflame_torch.mesh.structured import (StructuredMesh, cyclic,
                                                 empty, fixed_value,
                                                 zero_gradient)
    from deepflame_torch.solvers.low_mach import LowMachConfig
    from deepflame_torch.solvers.low_mach_fl import LowMachSolverFL
    f64 = torch.float64
    if case == "jet":
        from deepflame_torch.cases import jet_flame_3d_les_fl
        return jet_flame_3d_les_fl(MECH, n=4, dtype=f64, device="cpu")
    fl = lambda mesh, b: from_structured(mesh, b, device="cpu")
    if case == "box":
        mech = load_mechanism(MECH, device="cpu")
        th, tr, kin = (make_thermo(mech, f64), make_transport(mech, f64),
                       make_kinetics(mech, f64))
        n, L = 12, 2e-3
        mesh = StructuredMesh.box([L, L, L / n], [n, n, 1], device="cpu")
        b = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
        cfg = LowMachConfig(chemistry=True, div_scheme="upwind",
                            inert_index=mech.species_index("N2"))
        comb = Laminar(th, kin, ode_opts=RosenbrockOptions(rtol=1e-8,
                                                           atol=1e-13))
        sol = LowMachSolverFL(m_p=fl(mesh, b), m_h=fl(mesh, b),
                              m_Y=fl(mesh, b), m_rho=fl(mesh, b),
                              m_U=(fl(mesh, b),) * 3, thermo=th,
                              transport=tr, combustion=comb, config=cfg)
        ns = mech.n_species
        Yv = np.zeros(ns)
        for s_, v in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
            Yv[mech.species_index(s_)] = v
        X, Yg, _ = (c.reshape(-1).numpy() for c in mesh.cell_centers())
        r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2
        nc = mesh.n_cells
        T0 = np.where(r2 < (L / 4) ** 2, 1600.0, 800.0)
        U0 = np.stack([2.0 * np.sin(2 * math.pi * Yg / L), np.zeros(nc),
                       np.zeros(nc)], 1)
        return sol, sol.initial_state(np.full(nc, 101325.0), T0,
                                      np.tile(Yv[None], (nc, 1)), U0)
    from deepflame_torch.turbulence.wall_functions_fl import WallFunctionsFL
    mech = load_mechanism(AIR, device="cpu")
    th, tr, kin = (make_thermo(mech, f64), make_transport(mech, f64),
                   make_kinetics(mech, f64))
    n, L, u_in = 16, 0.1, 6.0
    mesh = StructuredMesh.box([L, L / 4, L / n], [n, 4, 1], device="cpu")
    e = (empty(), empty())
    zg = zero_gradient()
    bU = ((fixed_value(u_in), zg), (fixed_value(0.0), fixed_value(0.0)), e)
    bU0 = ((fixed_value(0.0), zg), (fixed_value(0.0), fixed_value(0.0)), e)
    bp = ((zg, fixed_value(101325.0)), (zg, zg), e)
    bs = ((zg, zg), (zg, zg), e)
    bk = ((fixed_value(0.05), zg), (zg, zg), e)
    beps = ((fixed_value(5.0), zg), (zg, zg), e)
    cfg = LowMachConfig(chemistry=False, div_scheme="upwind")
    m_p = fl(mesh, bp)
    nc = mesh.n_cells
    mask, y, n_wall = np.zeros(nc), np.full(nc, 1e10), np.zeros((nc, 3))
    for p in m_p.patches:
        if p.name not in ("ax1_lo", "ax1_hi"):
            continue
        own, dhalf = p.owner.numpy(), 0.5 * p.delta.numpy()
        for i, c in enumerate(own):
            if dhalf[i] < y[c]:
                y[c] = dhalf[i]
                n_wall[c] = p.normal.numpy()[i]
            mask[c] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=f64)
    wf = WallFunctionsFL(mask=t(mask), y=t(y), n_wall=t(n_wall))
    sol = LowMachSolverFL(m_p=m_p, m_h=fl(mesh, bs), m_Y=fl(mesh, bs),
                          m_rho=fl(mesh, bs),
                          m_U=(fl(mesh, bU), fl(mesh, bU0), fl(mesh, bU0)),
                          thermo=th, transport=tr,
                          combustion=NoCombustion(th, kin), config=cfg,
                          m_k=fl(mesh, bk), m_eps=fl(mesh, beps),
                          wall_fns=wf)
    U0 = np.stack([np.full(nc, u_in), np.zeros(nc), np.zeros(nc)], 1)
    return sol, sol.initial_state(np.full(nc, 101325.0), np.full(nc, 300.0),
                                  np.ones((nc, 1)), U0, k0=0.05, eps0=5.0)


def _fl_fields(s):
    out = {k: _np(getattr(s, k)) for k in ("rho", "U", "p", "ha", "Y", "T",
                                          "phi", "dpdt")}
    out["phi_b"] = _np(s.phi_b)
    out["turb"] = _np(s.turb)
    return out


def fl_both(rank: int, n: int, case: str, steps: int, dt: float,
            grid=None):
    """`steps` DistributedLowMachFL steps of a face-list case on n ranks
    (cells in `block_order(grid)` when grid is given): (gathered fields,
    [diag per step], round trip exact, the single-device steps on rank 0)."""
    import torch
    from deepflame_torch.parallel import DistributedLowMachFL, block_order
    solver, s0 = build_fl(case)
    order = (block_order(solver.m_p.centers.numpy(), grid)
             if grid is not None else None)
    dist = DistributedLowMachFL(solver, order=order)
    ds = dist.shard_state(s0)
    back = dist.gather_state(ds)
    same = all(torch.equal(getattr(back, k), getattr(s0, k))
               for k in ("rho", "U", "p", "T", "Y", "phi"))
    same = same and all(torch.equal(a, b)
                        for a, b in zip(back.phi_b, s0.phi_b))
    diags = []
    for _ in range(steps):
        ds, d = dist.step(ds, dt)
        diags.append(_diag(d))
    out = (_fl_fields(dist.gather_state(ds)), diags, same)
    single = None
    if rank == 0:
        s, sd = s0, []
        for _ in range(steps):
            s, d = solver.step(s, dt)
            sd.append(_diag(d))
        single = (_fl_fields(s), sd)
    return out, single


# ----------------------------------------------------------- chemistry

def chem_front(n_total: int, n_shards: int):
    """(T, p, Y) numpy: cold everywhere but a hot front in the first
    shard's slab (the JAX package's test_chem_dlb _front_state)."""
    sys.path.insert(0, ROOT)
    from deepflame_torch.chemistry import load_mechanism
    mech = load_mechanism(MECH, device="cpu")
    rng = np.random.default_rng(7)
    T = np.full(n_total, 320.0)
    n_shard = n_total // n_shards
    T[: n_shard // 2] = rng.uniform(1400.0, 2200.0, n_shard // 2)
    Yf = np.zeros(mech.n_species)
    for s_, v in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Yf[mech.species_index(s_)] = v
    return T, np.full(n_total, 101325.0), np.tile(Yf, (n_total, 1))


def dlb_roundtrip(rank: int, n: int, x, x2, key):
    """_stratified_cross_shard on this rank's slab of x, x2 and key with a
    run that returns its inputs, the count of hot lanes (key > 100) it
    received and a signature of the x lanes it received in their order
    (sum of x_i (i + 1)): (x back, x2 back, per lane the hot count and the
    signature of the rank that integrated it)."""
    import torch
    from deepflame_torch.chemistry.reactor import _stratified_cross_shard
    from deepflame_torch.parallel import ShardGroup
    g = ShardGroup((n,), ("x",))
    L = x.shape[0] // n
    sl = slice(rank * L, (rank + 1) * L)
    t = lambda a: torch.as_tensor(a[sl])

    def run(a, b, k):
        sig = (a * torch.arange(1, a.shape[0] + 1, dtype=a.dtype)).sum()
        return (a, b, torch.full_like(k, float((k > 100.0).sum())),
                torch.full_like(k, float(sig)))

    return _np(_stratified_cross_shard(run, t(key),
                                       (t(x), t(x2), t(key)), 4, g))


def chem_solve(rank: int, n: int, T, p, Y, dt, cross_shard: bool):
    """solve_chemistry of this rank's slab under the shard group, and on
    rank 0 the global solve of all cells: ((T, Y, RR), global or None)."""
    import torch
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.chemistry.reactor import solve_chemistry
    from deepflame_torch.parallel import ShardGroup, shard_axis
    mech = load_mechanism(MECH, device="cpu")
    th = make_thermo(mech, torch.float64)
    kin = make_kinetics(mech, torch.float64)
    opts = RosenbrockOptions(rtol=1e-6, atol=1e-10, max_steps=2000)
    L = T.shape[0] // n
    sl = slice(rank * L, (rank + 1) * L)
    t = lambda a: torch.as_tensor(a)
    with shard_axis(ShardGroup((n,), ("x",))):
        r = solve_chemistry(th, kin, t(T[sl]), t(p[sl]), t(Y[sl]), dt, opts,
                            n_bins=4, cross_shard=cross_shard)
    ref = None
    if rank == 0:
        g = solve_chemistry(th, kin, t(T), t(p), t(Y), dt, opts, n_bins=8)
        ref = _np((g.T, g.Y, g.RR))
    return _np((r.T, r.Y, r.RR)), ref


def tgv_dlb(rank: int, n: int, steps: int, dt: float):
    """The stiff TGV at n = 8 with Laminar(dlb_cross_shard=True) over
    (n, 1, 1) ranks: (gathered fields, [diag per step], the all_to_all
    count), and on rank 0 the single-device steps."""
    import dataclasses
    from deepflame_torch.parallel import DistributedLowMach
    from deepflame_torch.parallel.context import comm_stats
    solver, s0 = build_tgv()
    solver = dataclasses.replace(solver, combustion=dataclasses.replace(
        solver.combustion, dlb_cross_shard=True))
    dist = DistributedLowMach(solver, mesh_shape=(n, 1, 1))
    ds = dist.shard_state(s0)
    diags = []
    a2a = comm_stats["all_to_all"]
    for _ in range(steps):
        ds, d = dist.step(ds, dt)
        diags.append(_diag(d))
    a2a = comm_stats["all_to_all"] - a2a
    out = (_fields(dist.gather_state(ds)), diags, a2a)
    single = None
    if rank == 0:
        s, sd = s0, []
        for _ in range(steps):
            s, d = solver.step(s, dt)
            sd.append(_diag(d))
        single = (_fields(s), sd)
    return out, single
