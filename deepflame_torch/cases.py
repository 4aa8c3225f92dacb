"""Case builders of the port: the reacting Taylor-Green configurations that
`__graft_entry__._build` and `_build_3d_les` build for the JAX package, the
DNN-chemistry variant of the 3D one that `tools/bench_dnn.py` builds, and
the 3D LES jet flame of `__graft_entry__._build_3d_jet`, on its structured
box (`jet_flame_3d_les`, the case `bench.py` times) and on a blockMesh mesh
(`jet_flame_3d_les_fl`, the face-list path); the density-based solver's
2D H2-air detonation channel (`detonation_2d_h2`, examples/detonation_2d.py)
with front-shaped row-patch AMR (`detonation_2d_h2_amr`, its --amr), the 1D
detonation tube with moving or nested patches (`detonation_1d_amr`,
examples/detonation_1d_amr.py) and Sod shock tube (`sod_shock_tube`, tests/test_high_speed.py); and the
flareFGM solver's 2D Sandia D jet (`sandia_d_fgm_2d`,
examples/sandia_d_fgm_2d.py); the spray solvers' 3D aachenBomb chamber
(`aachen_bomb_3d`, examples/aachen_bomb_3d.py, kEpsilon RAS) and the 1D
water-mist detonation (`watermist_detonation_1d`,
examples/detonation_1d_watermist.py); and the face-list forms of four of
them: the structured jet on its shift-plan mesh
(`jet_flame_3d_les_plan`), the detonation channel and the Sandia D jet on
theirs (`detonation_2d_h2_fl`, `sandia_d_fgm_2d_fl`, the latter with RNG
k-epsilon), and the aachenBomb chamber as a blockMesh hex block with the
cloud on an overlay grid (`aachen_bomb_3d_fl`, kEpsilon with wall
functions); and the inlet-anchored 1D premixed flame
(`flame_1d_anchored`, examples/flame_1d_anchored.py) with its readings
(`flame_1d_diagnostics`), and the reference's Tu500K-Phi1 closed loop of a
DF-ODENet against Laminar chemistry (`dnn_closed_loop_flame`,
`closed_loop_compare`, `harvest_states`; examples/flame_dnn_closed_loop.
py); and the examples' own families, each at its example's argparse
defaults: the freely propagating 1D flame (`flame_1d`, `flame_1d_speed`;
examples/flame_1d.py), the 2D reacting Taylor-Green vortex with its
function objects (`reacting_tgv_2d`, `tgv_fields`), the 2D k-epsilon jet
flame with EDC, PaSR or Laminar chemistry (`jet_flame_2d`), the 1D
detonation (`detonation_1d`, `detonation_front`, `front_speed`), the inert
shock through a water mist (`shock_watermist_1d`, `shock_front`) and one
droplet's drag relaxation against its reference integration
(`single_droplet_motion`, `droplet_relaxation`, `droplet_reference`).

Each returns (solver, state) on `device` (default: the CUDA card); the Sod
tube also its run plan; the AMR cases (amr, state); the 1D flames, the 2D
jet, the 1D detonation and the shock also their dt and an info dict; the
2D TGV its function objects and control; the droplet its cloud, state,
gas, dt and step count.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os

import numpy as np
import torch

from .chemistry import load_mechanism, make_kinetics, make_thermo, make_transport
from .chemistry.integrator import RosenbrockOptions
from .chemistry.dnn import LAYERS, DFODENet, init_params, load_npz_checkpoint
from .chemistry.kinetics import production_rates
from .chemistry.reactor import ignite
from .combustion import DNNChemistry, Laminar
from .constants import GAS_CONSTANT
from .lagrangian.cloud import ConeInjector, ManualInjector, SprayCloud
from .lagrangian.liquids import water
from .lagrangian.overlay import OverlaySprayCloud
from .mesh import (StructuredMesh, build_blockmesh, cyclic, empty, fixed_value,
                   parse_blockmesh_dict, symmetry, zero_gradient)
from .mesh.facelist import from_structured
from .ops.amg_fl import make_amg_fl
from .solvers import LowMachConfig, LowMachSolver, LowMachSolverFL
from .solvers.low_mach import LowMachState
from .solvers.high_speed import HighSpeedConfig, HighSpeedSolver
from .solvers.high_speed_fl import HighSpeedFLState, HighSpeedSolverFL
from .solvers.low_mach_fl import rng_keps_kwargs
from .solvers.spray import HighSpeedSpraySolver, SprayFLSolver, SpraySolver
from .turbulence import KEpsilon, sigma_model
from .turbulence.wall_functions_fl import make_wall_functions_fl
from .utils.flame_speed import flame_position, flame_thickness

__all__ = ["reacting_tgv_3d_les", "reacting_tgv_3d_les_dnn",
           "reacting_hot_spot_2d", "jet_blockmesh_dict", "jet_inlet_profiles",
           "jet_initial_fields", "jet_flame_3d_les", "jet_flame_3d_les_fl",
           "jet_with_combustion", "jet_function_objects", "jet_fields",
           "detonation_2d_h2", "detonation_2d_h2_amr", "detonation_1d_amr",
           "detonation_dt", "sod_shock_tube",
           "sandia_d_fgm_2d", "AACHEN_FLOW_PROFILE", "AACHEN_DT",
           "aachen_bomb_3d", "watermist_detonation_1d",
           "jet_flame_3d_les_plan", "detonation_2d_h2_fl",
           "sandia_d_fgm_2d_fl", "aachen_blockmesh_dict", "aachen_bomb_3d_fl",
           "flame_1d_anchored", "flame_1d_diagnostics",
           "dnn_closed_loop_flame", "closed_loop_compare", "harvest_states",
           "flame_1d", "flame_1d_speed", "reacting_tgv_2d", "tgv_fields",
           "JET2D_MODELS", "jet_flame_2d", "detonation_1d",
           "detonation_front", "front_speed", "shock_watermist_1d",
           "shock_front", "DROPLET_GAS", "DROPLET_RUNS",
           "single_droplet_motion", "droplet_relaxation",
           "droplet_reference"]


def _fresh_mixture(mech):
    """phi ~ 1 H2/air mass fractions (ns,)."""
    Y = np.zeros(mech.n_species)
    for name, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[mech.species_index(name)] = y
    return Y


def _dtype_opts(dtype, max_steps: int, grow=None) -> RosenbrockOptions:
    """The examples' stiff options: rtol 1e-6 and atol 1e-12 in float64,
    else 1e-4 and 1e-8."""
    f64 = dtype == torch.float64
    kw = {} if grow is None else dict(grow=grow)
    return RosenbrockOptions(rtol=1e-6 if f64 else 1e-4,
                             atol=1e-12 if f64 else 1e-8,
                             max_steps=max_steps, **kw)


def reacting_tgv_3d_les(mech_path: str, n: int = 48, dtype=torch.float32,
                        rtol: float = 1e-4, atol: float = 1e-8, sort=None,
                        n_bins=None, device=None):
    """3D reacting LES Taylor-Green vortex: periodic box of side 2 pi mm,
    n^3 cells, a 2000 K sphere of radius L/6 in a 700 K phi ~ 1 H2/air
    mixture, 10 m/s TGV velocity, Laminar stiff chemistry and the Sigma
    model (the flagship configuration)."""
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    L = 2.0 * math.pi * 1e-3
    mesh = StructuredMesh.box([L, L, L], [n, n, n], device=mech.device)
    bcs = ((cyclic(), cyclic()),) * 3
    if sort is None:
        sort = "dt" if rtol <= 1e-5 else "T"
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=rtol, atol=atol, max_steps=2000, grow=10.0), sort=sort,
        n_bins=n_bins if n_bins is not None else (128 if n >= 96 else 32))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(bcs, bcs, bcs), bcs_p=bcs, bcs_h=bcs, bcs_Y=bcs, bcs_rho=bcs,
        config=LowMachConfig(chemistry=True,
                             inert_index=mech.species_index("N2")),
        turbulence=sigma_model())
    X, Yg, Z = mesh.cell_centers(dtype)
    k = 2.0 * math.pi / L
    U = torch.stack([10.0 * torch.sin(k * X) * torch.cos(k * Yg) * torch.cos(k * Z),
                     -10.0 * torch.cos(k * X) * torch.sin(k * Yg) * torch.cos(k * Z),
                     torch.zeros_like(X)])
    r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2 + (Z - L / 2) ** 2
    T = torch.where(r2 < (L / 6) ** 2, 2000.0, 700.0).to(dtype)
    p = torch.full(mesh.shape, 101325.0, dtype=dtype, device=mesh.device)
    Y = torch.as_tensor(_fresh_mixture(mech), dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    return solver, solver.initial_state(p, T, Y.contiguous(), U)


def reacting_tgv_3d_les_dnn(mech_path: str, n: int = 48, dtype=torch.float32,
                            compute_dtype=torch.bfloat16, y_std: float = 1e-6,
                            seed: int = 0, hidden=LAYERS, device=None):
    """`reacting_tgv_3d_les` with the stiff chemistry replaced by DF-ODENet
    DNN chemistry: per-species GELU MLPs [ns+2, *hidden, 1] with random
    weights from `torch.Generator().manual_seed(seed)`, identity input
    normalization, target scale `y_std`, a trained step of 2.5e-7 s (the
    case's dt) and frozen temperature 700 K (only the hot sphere reacts). The default y_std keeps
    the random nets' rates non-zero and the step physical: with 1e-3 the
    hot cells' composition jumps so far in one step that T falls to the
    200 K floor of T_from_h; 1e-12 (tools/bench_dnn.py) makes RR vanish."""
    solver, state = reacting_tgv_3d_les(mech_path, n=n, dtype=dtype,
                                        device=device)
    ns = state.Y.shape[0]
    dev = solver.device
    net = DFODENet(
        nets=init_params(torch.Generator().manual_seed(seed), ns, hidden,
                         dtype=dtype, device=dev),
        x_mean=torch.zeros(ns + 2, dtype=dtype, device=dev),
        x_std=torch.ones(ns + 2, dtype=dtype, device=dev),
        y_mean=torch.zeros(ns - 1, dtype=dtype, device=dev),
        y_std=torch.full((ns - 1,), y_std, dtype=dtype, device=dev),
        delta_t=2.5e-7, frozen_T=700.0, compute_dtype=compute_dtype)
    comb = DNNChemistry(solver.combustion.thermo, solver.combustion.kinetics,
                        net=net)
    return dataclasses.replace(solver, combustion=comb), state


def reacting_hot_spot_2d(mech_path: str, n: int = 32, dtype=torch.float32,
                         chemistry: bool = True, device=None):
    """2D reacting hot spot: periodic 2 mm square, n x n cells, a 2000 K disc
    of radius L/4 in an 800 K phi ~ 1 H2/air mixture at rest."""
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    L = 2e-3
    mesh = StructuredMesh.box([L, L, L / n], [n, n, 1], device=mech.device)
    bcs = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(bcs, bcs, bcs), bcs_p=bcs, bcs_h=bcs, bcs_Y=bcs, bcs_rho=bcs,
        config=LowMachConfig(chemistry=chemistry,
                             inert_index=mech.species_index("N2")))
    X, Yg, _ = mesh.cell_centers(dtype)
    r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2
    T = torch.where(r2 < (L / 4) ** 2, 2000.0, 800.0).to(dtype)
    p = torch.full(mesh.shape, 101325.0, dtype=dtype, device=mesh.device)
    Y = torch.as_tensor(_fresh_mixture(mech), dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    return solver, solver.initial_state(p, T, Y.contiguous())


# Sandia-flame-family jet (__graft_entry__._build_3d_jet): a D = 7.2 mm H2/N2
# fuel jet at 50 m/s with a hot pilot annulus into a 0.9 m/s air coflow,
# over x in [0, 60] mm (streamwise), y, z in [-15, 15] mm
JET_D = 7.2e-3
JET_FUEL_H2 = 0.30            # H2 mass fraction of the fuel stream
_JET_BLOCKMESH = """
convertToMeters 0.001;
vertices
(
    (0 -15 -15) (60 -15 -15) (60 15 -15) (0 15 -15)
    (0 -15 15) (60 -15 15) (60 15 15) (0 15 15)
);
blocks
(
    hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading ({gx} {gy} {gz})
);
boundary
(
    inlet {{ type patch; faces ((0 4 7 3)); }}
    outlet {{ type patch; faces ((1 2 6 5)); }}
    ylo {{ type patch; faces ((0 1 5 4)); }}
    yhi {{ type patch; faces ((3 7 6 2)); }}
    zlo {{ type patch; faces ((0 3 2 1)); }}
    zhi {{ type patch; faces ((4 5 6 7)); }}
);
"""


def _grading_text(g) -> str:
    """A simpleGrading entry: a ratio, or a multi-section list of
    (length fraction, cell fraction, ratio)."""
    if isinstance(g, (list, tuple)):
        return "(" + " ".join(f"({a} {b} {r})" for a, b, r in g) + ")"
    return str(g)


def jet_blockmesh_dict(n: int = 64, grading=(1, 1, 1)) -> str:
    """blockMeshDict of the jet: one hex block of (2n, n, n) cells, one patch
    per side (inlet x-, outlet x+, ylo, yhi, zlo, zhi)."""
    return _JET_BLOCKMESH.format(nx=2 * n, ny=n, nz=n,
                                 **{k: _grading_text(g) for k, g in
                                    zip(("gx", "gy", "gz"), grading)})


def jet_inlet_profiles(yz: np.ndarray, ns: int, species_index) -> dict:
    """Inlet zones per face from its (y, z) centre: fuel jet r < D/2 (30 %
    H2 / 70 % N2 by mass, 50 m/s, 300 K), pilot D/2 <= r < D (0.5 % H2,
    half the air's O2, 10 m/s, 1900 K), coflow (air, 0.9 m/s, 750 K).
    Returns u, T (nb,) and Y (nb, ns) as numpy."""
    iH2, iO2 = species_index("H2"), species_index("O2")
    iN2 = species_index("N2")
    r = np.sqrt(yz[:, 0] ** 2 + yz[:, 1] ** 2)
    in_jet = r < JET_D / 2
    in_pilot = (r >= JET_D / 2) & (r < JET_D)
    Y = np.zeros((r.shape[0], ns))
    Y[:, iH2] = np.where(in_jet, JET_FUEL_H2, np.where(in_pilot, 0.005, 0.0))
    Y[:, iO2] = np.where(in_jet, 0.0, 0.233 * (1.0 - in_pilot * 0.5))
    Y[:, iN2] = 1.0 - Y[:, iH2] - Y[:, iO2]
    return dict(u=np.where(in_jet, 50.0, np.where(in_pilot, 10.0, 0.9)),
                T=np.where(in_jet, 300.0, np.where(in_pilot, 1900.0, 750.0)),
                Y=Y)


def jet_initial_fields(centers: np.ndarray, ns: int, species_index) -> dict:
    """The jet's initial interior on cell centres (n, 3): coflow air with a
    developing jet core and a 1900 K kernel just downstream of the pilot.
    Returns p, T (n,), U (n, 3) and Y (n, ns) as numpy."""
    iH2, iO2 = species_index("H2"), species_index("O2")
    iN2 = species_index("N2")
    X, Yg, Z = centers[:, 0], centers[:, 1], centers[:, 2]
    D = JET_D
    rr = np.sqrt(Yg ** 2 + Z ** 2)
    wjet = np.exp(-(rr / (D / 2)) ** 2) * np.exp(-X / (4 * D))
    U = np.zeros((X.shape[0], 3))
    U[:, 0] = 0.9 + (50.0 - 0.9) * wjet
    Y = np.zeros((X.shape[0], ns))
    Y[:, iH2] = JET_FUEL_H2 * wjet
    Y[:, iO2] = 0.233 * (1.0 - wjet)
    Y[:, iN2] = 1.0 - Y[:, iH2] - Y[:, iO2]
    hot = (rr < D) & (X < 2.5 * D)
    return dict(p=np.full(X.shape[0], 101325.0), U=U, Y=Y,
                T=np.where(hot, 1900.0, 750.0))


def jet_flame_3d_les(mech_path: str, n: int = 64, dtype=torch.float32,
                     rtol: float = 1e-4, atol: float = 1e-8, device=None):
    """The 3D LES jet flame of `__graft_entry__._build_3d_jet` (BASELINE
    config 5, `bench.py`'s jet line) on the structured box: (2n, n, n) cells
    over 60 x 30 x 30 mm with origin (0, -15, -15) mm. Per-cell inlet
    profiles on U_x, h, rho and each species (one FieldBCs per species; the
    transverse velocity components fixed at 0 there), p fixed at the outlet,
    zeroGradient elsewhere; Laminar stiff chemistry (rtol, atol, 2000 steps,
    growth 10, 128 bins at n >= 48, else 32), the Sigma model, N2 closed as
    1 - sum(others)."""
    mech = load_mechanism(mech_path, device=device)
    dev = mech.device
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    ns = mech.n_species
    si = mech.species_index
    Lx, Ly, Lz = 0.06, 0.03, 0.03
    mesh = StructuredMesh.box([Lx, Ly, Lz], [2 * n, n, n],
                              origin=(0.0, -Ly / 2, -Lz / 2), device=dev)
    centers = np.stack([c.cpu().numpy().ravel()
                        for c in mesh.cell_centers()], axis=1)
    plane = (1, n, n)
    inlet = centers[: n * n, 1:]                # the first x layer's (y, z)
    prof = jet_inlet_profiles(inlet, ns, si)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    u_in = f(prof["u"].reshape(plane))
    T_in = f(prof["T"].reshape(plane))
    Yt_in = f(prof["Y"].reshape(plane + (ns,)))
    h_in = th.h_mass(T_in, Yt_in)
    rho_in = th.rho(f(101325.0), T_in, Yt_in)

    zg = zero_gradient()
    zgp = (zg, zg)
    inlet_bcs = lambda v: ((fixed_value(v), zg), zgp, zgp)
    bcs_Y = [inlet_bcs(Yt_in[..., i]) for i in range(ns)]
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=rtol, atol=atol, max_steps=2000, grow=10.0),
        n_bins=128 if n >= 48 else 32)
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(inlet_bcs(u_in), inlet_bcs(torch.zeros_like(u_in)),
               inlet_bcs(torch.zeros_like(u_in))),
        bcs_p=((zg, fixed_value(101325.0)), zgp, zgp),
        bcs_h=inlet_bcs(h_in), bcs_Y=bcs_Y, bcs_rho=inlet_bcs(rho_in),
        config=LowMachConfig(chemistry=True, inert_index=si("N2")),
        turbulence=sigma_model())
    init = jet_initial_fields(centers, ns, si)
    cells = mesh.shape
    return solver, solver.initial_state(
        init["p"].reshape(cells), init["T"].reshape(cells),
        np.moveaxis(init["Y"], 1, 0).reshape((ns,) + cells),
        np.moveaxis(init["U"], 1, 0).reshape((3,) + cells))


def jet_flame_3d_les_fl(mech_path: str, n: int = 64, dtype=torch.float32,
                        grading=(1, 1, 1), device=None, mesh=None):
    """The 3D LES jet flame (BASELINE config 5, `_build_3d_jet`) on the
    face-list path: the blockMeshDict of `jet_blockmesh_dict(n, grading)`
    -> GeneralMesh -> per-field FaceListMeshes -> LowMachSolverFL with the
    species in BC groups (H2), (O2), (N2) and the six zero-inlet species,
    Laminar stiff chemistry (rtol 1e-4, atol 1e-8), the Sigma model and the
    pressure matvec through ell_matvec. Inlet profiles per face from the
    inlet's face centres; p fixed at the outlet; zeroGradient elsewhere.
    `mesh`: the GeneralMesh of that blockMeshDict, when the caller has
    built it (blockMesh takes most of the set-up at n = 64)."""
    mech = load_mechanism(mech_path, device=device)
    dev = mech.device
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    ns = mech.n_species
    gm = mesh if mesh is not None else build_blockmesh(
        parse_blockmesh_dict(jet_blockmesh_dict(n, grading)))
    inlet = gm.patches[gm.patch_names.index("inlet")]
    prof = jet_inlet_profiles(inlet.f_ctr[:, 1:], ns, mech.species_index)
    Y_in = prof["Y"]
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    T_in, Yt_in = f(prof["T"]), f(Y_in)
    h_in = th.h_mass(T_in, Yt_in)
    rho_in = th.rho(f(101325.0), T_in, Yt_in)

    zg = zero_gradient()
    walls = {k: zg for k in ("outlet", "ylo", "yhi", "zlo", "zhi")}
    mk = lambda inlet_bc, **kw: gm.with_bcs(
        {**walls, "inlet": inlet_bc, **kw}, dtype, device=dev)
    m_U = (mk(fixed_value(prof["u"])), mk(fixed_value(0.0)),
           mk(fixed_value(0.0)))
    groups = [(iH2,), (iO2,), (iN2,),
              tuple(i for i in range(ns) if i not in (iH2, iO2, iN2))]
    m_Y_groups = tuple((mk(fixed_value(Y_in[:, g[0]])), g) for g in groups)
    m_p = mk(zg, outlet=fixed_value(101325.0))
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0),
        n_bins=128 if n >= 48 else 32)
    solver = LowMachSolverFL(
        m_p=m_p, m_h=mk(fixed_value(h_in)), m_Y=m_Y_groups[-1][0],
        m_rho=mk(fixed_value(rho_in)), m_U=m_U, thermo=th, transport=tr,
        combustion=comb,
        config=LowMachConfig(chemistry=True, inert_index=iN2),
        m_Y_groups=m_Y_groups, p_ell=m_p.ell_connectivity(),
        les=sigma_model())
    init = jet_initial_fields(gm.centers, ns, mech.species_index)
    return solver, solver.initial_state(init["p"], init["T"], init["Y"],
                                        init["U"])


def jet_with_combustion(solver, state, combustion, h2_index: int):
    """The structured jet (`jet_flame_3d_les`) with another combustion
    model, and its initial state made anew. A model with transported
    scalars (PaSR dynamicScale) gets the jet's mixture fraction Z = Y_H2 /
    JET_FUEL_H2: fixed at the inlet to the inlet profile's, zeroGradient
    elsewhere (`bcs_Z`), and Z0 from the initial Y (the jet's core shape
    wjet)."""
    zg = zero_gradient()
    zgp = (zg, zg)
    Z_in = solver.bcs_Y[h2_index][0][0].value / JET_FUEL_H2
    solver = dataclasses.replace(solver, combustion=combustion,
                                 bcs_Z=((fixed_value(Z_in), zg), zgp, zgp))
    return solver, solver.initial_state(
        state.p, state.T, state.Y, state.U, time=float(state.time),
        Z0=state.Y[h2_index] / JET_FUEL_H2)


def jet_fields(state) -> dict:
    """The field dict function objects read from a structured jet state:
    T, p, U, Y, rho, the x-face mass-flux density phi_x and, with
    transported scalars, the mixture fraction Z."""
    out = dict(T=state.T, p=state.p, U=state.U, Y=state.Y, rho=state.rho,
               phi_x=state.phi[0])
    if state.cscalars:
        out["Z"] = state.cscalars[0]
    return out


def jet_function_objects(solver, out_dir: str, dt: float,
                         with_z: bool = True):
    """The function-object set of the structured jet, writing under
    out_dir: derived |vorticity|, Q, lambda2, Ma and the Courant number;
    FieldMinMax of T, p, Q (and Z); Probes of T (and Z) at x = 5, 15, 30,
    45 and 55 mm on the axis; LineSamples along x on the axis and along y
    at x = 30 mm; FieldAverage of T and U; VolFieldValue of T (volAverage,
    max, CoV) and of Z (volIntegrate); SurfaceFieldValue of the outlet mass
    flux (areaIntegrate of phi_x on the last x plane); a 50-bin Histogram
    of T; VolFieldValue max of the Courant number, |vorticity| and
    lambda2 (their minima sit at round-off, near zero). with_z: whether the fields hold Z (a model with transported
    scalars)."""
    from .runtime import derived as D
    from .runtime import function_objects as F
    mesh, bcs_U = solver.mesh, solver.bcs_U
    sub = lambda name: os.path.join(out_dir, name)
    z = ("Z",) if with_z else ()
    specs = {
        "magVorticity": lambda f: torch.sqrt(
            (D.vorticity(f["U"], bcs_U, mesh) ** 2).sum(0)),
        "Q": lambda f: D.q_criterion(f["U"], bcs_U, mesh),
        "lambda2": lambda f: D.lambda2(f["U"], bcs_U, mesh),
        "Ma": lambda f: D.mach_number(f["U"], f["T"],
                                      torch.movedim(f["Y"], 0, -1),
                                      solver.thermo),
        "Co": lambda f: D.courant_no(f["U"], dt, mesh),
    }
    axis_x = [(x, 0.0, 0.0) for x in (0.005, 0.015, 0.030, 0.045, 0.055)]
    objs = [
        F.FieldMinMax(mesh, ("T", "p", "Q") + z, sub("fieldMinMax")),
        F.Probes(mesh, axis_x, ("T",) + z, sub("probes")),
        F.LineSample(mesh, 0, (0.0, 0.0, 0.0), ("T", "Ma") + z,
                     sub("sample_axis")),
        F.LineSample(mesh, 1, (0.030, 0.0, 0.0), ("T", "Q") + z,
                     sub("sample_y30")),
        F.FieldAverage(("T", "U")),
        F.VolFieldValue(mesh, ("T",), ("volAverage", "max", "CoV"),
                        out_dir=sub("volFieldValue_T")),
        F.SurfaceFieldValue(mesh, ("phi_x",), axis=0, index=mesh.nx,
                            ops=("areaIntegrate",),
                            out_dir=sub("surfaceFieldValue")),
        F.Histogram("T", 50, out_dir=sub("histogram")),
        F.VolFieldValue(mesh, ("Co", "magVorticity", "lambda2"),
                        ("max",), out_dir=sub("volFieldValue_flow")),
    ]
    if with_z:
        objs.insert(6, F.VolFieldValue(mesh, ("Z",), ("volIntegrate",),
                                       out_dir=sub("volFieldValue_Z")))
    return D.DerivedFields(specs, F.FunctionObjectSet(objs))


# the reference's twoD_detonationH2: three staggered 100 atm / 2000 K igniter
# boxes at the left wall (system/setFieldsDict), y bands [m]
DETONATION_IGNITERS = ((0.001, 0.003), (0.004, 0.006), (0.007, 0.009))


def detonation_2d_h2(mech_path: str, nx: int = 2000, ny: int = 100,
                     dtype=torch.float32, device=None, case=None,
                     igniters=DETONATION_IGNITERS):
    """2D H2-air detonation channel (dfHighSpeedFoam twoD_detonationH2,
    examples/detonation_2d.py; `detonation_2d_h2_amr` adds its AMR): 2 m x
    0.1 m, nx x ny cells,
    Y_H2/O2/N2 = 0.01724/0.13793/0.84483 at 1 atm and 300 K, the igniter
    boxes (y bands `igniters`, x below max(2 mm, 2.5 dx)) at 100 atm and
    2000 K. Reflecting left wall, transmissive right, slip walls. HLLC,
    RK2, vanLeer, split ODE chemistry (rtol 1e-4, atol 1e-8, 5000 steps,
    T_threshold 500 K); with `case` (a CaseConfig) the solver is the
    factory's (`build_high_speed_solver`) instead. Step: `detonation_dt`."""
    mech = load_mechanism(mech_path, device=device)
    Lx, Ly = 2.0, 0.1
    mesh = StructuredMesh.box([Lx, Ly, Ly / ny], [nx, ny, 1],
                              device=mech.device)
    e = (empty(), empty())
    zg = (zero_gradient(), zero_gradient())
    wall_n = (symmetry(negate=True), symmetry(negate=True))
    b_scalar = (zg, zg, e)
    bcs_U = (((symmetry(negate=True), zero_gradient()), zg, e),
             (zg, wall_n, e), b_scalar)
    if case is not None:
        from .runtime.factory import build_high_speed_solver
        solver, mech = build_high_speed_solver(case, mesh, b_scalar, bcs_U,
                                               b_scalar, b_scalar)
    else:
        cfg = HighSpeedConfig(
            flux="HLLC", rk_order=2, limiter="vanLeer", chemistry="ode",
            ode_opts=RosenbrockOptions(rtol=1e-4, atol=1e-8, max_steps=5000),
            T_threshold=500.0)
        solver = HighSpeedSolver(mesh=mesh, thermo=make_thermo(mech, dtype),
                                 kinetics=make_kinetics(mech, dtype),
                                 bcs_rho=b_scalar, bcs_U=bcs_U,
                                 bcs_p=b_scalar, bcs_Y=b_scalar, config=cfg)
    return solver, solver.initial_state(
        *_detonation_2d_fields(mech, mesh, solver.dtype, igniters))


def _detonation_2d_fields(mech, mesh, dtype, igniters):
    """p, T, Y of the 2D detonation channel (see detonation_2d_h2)."""
    Yv = np.zeros(mech.n_species)
    for name, y in (("H2", 0.01724), ("O2", 0.13793), ("N2", 0.84483)):
        Yv[mech.species_index(name)] = y
    Yv /= Yv.sum()
    X, Yg, _ = mesh.cell_centers(dtype)
    wx = max(0.002, 2.5 * mesh.dx)
    hot = torch.zeros(mesh.shape, dtype=torch.bool, device=mesh.device)
    for y0, y1 in igniters:
        hot = hot | ((X < wx) & (Yg >= y0) & (Yg < y1))
    p0, T0 = 101325.0, 300.0
    T = torch.where(hot, 2000.0, T0).to(dtype)
    p = torch.where(hot, 100.0 * p0, p0).to(dtype)
    Y = torch.as_tensor(Yv, dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    return p, T, Y.contiguous()


def detonation_2d_h2_amr(mech_path: str, nx: int = 2000, ny: int = 100,
                         pc: int = 24, n_rows: int = 5, ratio: int = 4,
                         buffer_c: int = 4, buffer_y: int = 3,
                         dtype=torch.float32, device=None, case=None,
                         igniters=DETONATION_IGNITERS):
    """The 2D detonation channel (`detonation_2d_h2`, the same solver and
    initial fields) with front-shaped AMR, as `examples/detonation_2d.py
    --amr` builds it: FrontPatchAMR2D over the channel's solver, `n_rows`
    row patches of pc coarse cells refined `ratio`x along x, buffer_c
    coarse cells and buffer_y rows of buffer (at 2000 x 100: 5 patches of
    96 x 26 fine cells). Step: `detonation_dt(amr.coarse)`; the patches
    take `ratio` substeps of dt / ratio. Returns (amr, RowPatchState)."""
    from .mesh.patch_amr import FrontPatchAMR2D
    solver, _ = detonation_2d_h2(mech_path, nx=nx, ny=ny, dtype=dtype,
                                 device=device, case=case, igniters=())
    amr = FrontPatchAMR2D.build(solver, pc=pc, n_rows=n_rows, ratio=ratio,
                                buffer_c=buffer_c, buffer_y=buffer_y)
    mech = load_mechanism(mech_path, device="cpu")
    return amr, amr.initial_state(*_detonation_2d_fields(
        mech, solver.mesh, solver.dtype, igniters))


def _h2_tube(mech, n: int, length: float, dtype, flux: str = "HLLC"):
    """The 1D H2-air tube of the detonation examples: n cells over
    `length`, a reflecting left wall (symmetry(negate=True) on U_x),
    zeroGradient elsewhere; `flux`, RK2, vanLeer, split ODE chemistry above
    500 K (the examples' options per dtype, 5000 steps). Returns its
    HighSpeedSolver."""
    mesh = StructuredMesh.box([length, length / n, length / n], [n, 1, 1],
                              device=mech.device)
    e = (empty(), empty())
    b_scalar = ((zero_gradient(), zero_gradient()), e, e)
    b_un = ((symmetry(negate=True), zero_gradient()), e, e)
    cfg = HighSpeedConfig(flux=flux, rk_order=2, limiter="vanLeer",
                          chemistry="ode", ode_opts=_dtype_opts(dtype, 5000),
                          T_threshold=500.0)
    return HighSpeedSolver(mesh=mesh, thermo=make_thermo(mech, dtype),
                           kinetics=make_kinetics(mech, dtype),
                           bcs_rho=b_scalar, bcs_U=(b_un, b_scalar, b_scalar),
                           bcs_p=b_scalar, bcs_Y=b_scalar, config=cfg)


def _h2_tube_fields(mech, mesh, dtype, drv_len: float, T_drv: float = 2000.0,
                    p_ratio: float = 90.0):
    """p, T, Y of the tube: stoichiometric H2/O2/N2 0.02851/0.226/0.745
    (normalised) at 1 atm and 300 K, a driver at T_drv and p_ratio atm for
    x < drv_len."""
    Yv = np.zeros(mech.n_species)
    for name, y in (("H2", 0.02851), ("O2", 0.226), ("N2", 0.745)):
        Yv[mech.species_index(name)] = y
    Yv /= Yv.sum()
    drv = mesh.cell_centers(dtype)[0] < drv_len
    p0, T0 = 101325.0, 300.0
    T = torch.where(drv, T_drv, T0).to(dtype)
    p = torch.where(drv, p_ratio * p0, p0).to(dtype)
    Y = torch.as_tensor(Yv, dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    return p, T, Y.contiguous()


# examples/detonation_1d_amr.py's patch: pc coarse cells, refined RATIO x
# by one level (two levels: 2 x each), BUFFER coarse cells of buffer
DET1D_PC, DET1D_RATIO, DET1D_BUFFER = 40, 4, 6


def detonation_1d_amr(mech_path: str, n: int = 300, levels: int = 1,
                      reflux: bool = False, dtype=torch.float32, device=None):
    """The 1D H2-air detonation tube with moving-patch AMR
    (`examples/detonation_1d_amr.py`): n coarse cells over 2 m, H2/O2/N2
    0.02851/0.226/0.745 at 1 atm and 300 K, a 2000 K, 90 atm driver at the
    reflecting left wall (x below max(4 mm, 1.5 dx / r), r the effective
    ratio: 4 mm at 300 cells); HLLC, RK2, vanLeer, split ODE chemistry above
    500 K (rtol 1e-6, atol 1e-12 in float64, else 1e-4 and 1e-8, 5000
    steps). levels = 1: MovingPatchAMR, a patch of DET1D_PC coarse cells
    refined DET1D_RATIO x with DET1D_BUFFER of buffer; levels >= 2:
    NestedPatchAMR, ratio 2 a level, x only, DET1D_PC cells at every level,
    targeted by the example's RefinementCriteria (|grad rho| dx >= 0.03 or
    p in [3e5, 1e9] Pa, 2 buffer layers). `reflux` couples the levels
    conservatively. The patch starts at the wall. Step:
    `detonation_dt(amr.coarse, a_bound=3500.0)`. Returns (amr,
    PatchState)."""
    from .mesh.amr import RefinementCriteria
    from .mesh.patch_amr import MovingPatchAMR, NestedPatchAMR
    mech = load_mechanism(mech_path, device=device)
    length = 2.0
    coarse = _h2_tube(mech, n, length, dtype)
    mesh = coarse.mesh
    if levels >= 2:
        crit = RefinementCriteria(gradients=(("rho", 0.03),),
                                  fields=(("p", 3e5, 1e9),), n_buffer=2)
        amr = NestedPatchAMR.build(coarse, pcs=(DET1D_PC,) * levels, ratio=2,
                                   buffer_c=DET1D_BUFFER, isotropic=False,
                                   criteria=crit, reflux=reflux)
        r = 2 ** levels
    else:
        amr = MovingPatchAMR.build(coarse, pc=DET1D_PC, ratio=DET1D_RATIO,
                                   buffer_c=DET1D_BUFFER, reflux=reflux)
        r = DET1D_RATIO
    p, T, Y = _h2_tube_fields(mech, mesh, dtype,
                              max(0.002 * length, 1.5 * mesh.dx / r))
    return amr, amr.initial_state(p, T, Y, offset=0)


def detonation_dt(solver, cfl: float = 0.3, a_bound: float = 3200.0) -> float:
    """The detonation's step: cfl dx / a_bound (examples/detonation_2d.py).
    On the face-list channel dx is the first x face's spacing."""
    m = solver.mesh
    dx = m.dx if hasattr(m, "dx") else float(m.delta[0])
    return cfl * dx / a_bound


def sod_shock_tube(mech_path: str, n: int = 400, flux: str = "HLLC",
                   limiter: str = "vanLeer", rk: int = 2,
                   dtype=torch.float64, device=None):
    """Dimensional Sod problem in a one-species gas (tests/data/air.yaml,
    gamma ~ 1.4) on a 1 m tube of n cells, transmissive ends
    (tests/test_high_speed.py): p 1e5 / 1e4 Pa, rho 1 / 0.125 kg/m^3.
    Returns (solver, state, plan): plan holds dt, n_steps (the shock
    travels about 0.3 of the tube), the exact star pressure and velocity
    p_star, u_star, and the plateau window (0.55, 0.65) m."""
    mech = load_mechanism(mech_path, device=device)
    th, kin = make_thermo(mech, dtype), make_kinetics(mech, dtype)
    mesh = StructuredMesh.box([1.0, 1e-2, 1e-2], [n, 1, 1], device=mech.device)
    bx = ((zero_gradient(), zero_gradient()), (empty(), empty()),
          (empty(), empty()))
    solver = HighSpeedSolver(
        mesh=mesh, thermo=th, kinetics=kin, bcs_rho=bx, bcs_U=(bx, bx, bx),
        bcs_p=bx, bcs_Y=bx, config=HighSpeedConfig(
            flux=flux, rk_order=rk, limiter=limiter, chemistry="none"))
    X, _, _ = mesh.cell_centers(dtype)
    pL, pR, rhoL, rhoR = 1e5, 1e4, 1.0, 0.125
    W = float(mech.molecular_weights[0])
    T = torch.where(X < 0.5, pL * W / (rhoL * GAS_CONSTANT),
                    pR * W / (rhoR * GAS_CONSTANT))
    p = torch.where(X < 0.5, pL, pR).to(dtype)
    state = solver.initial_state(p, T, torch.ones((1,) + mesh.shape))
    a0 = math.sqrt(1.4 * pL / rhoL)
    dt = 0.4 * mesh.dx / (a0 * 1.8)
    plan = dict(dt=dt, n_steps=int(0.25 / a0 * 1.0 / dt), p_star=0.30313 * pL,
                u_star=0.92745 * math.sqrt(pL / rhoL), window=(0.55, 0.65))
    return solver, state, plan


def sandia_d_fgm_2d(table_path: str, nx: int = 96, ny: int = 48,
                    dtype=torch.float32, device=None, deepfgm=None,
                    use_native: bool = True, table=None):
    """2D Sandia-flame-D-family jet on the flareFGM solver
    (examples/sandia_d_fgm_2d.py; the reference's twoD_SandiaD_flareFGM) on
    a FlaRe table (data/flare_CH4_drm19_SandiaD_4D.tbl and its .json with
    Z_st): a 0.12 m x 0.06 m slab of nx x ny cells; the inlet at x = 0
    carries the main jet (y < 3.6 mm, Z = 1, 12 m/s), the pilot annulus
    (to 9.1 mm, burnt stoichiometric products: Z = Z_st, c = 1, 2 m/s) and
    the air coflow (0.9 m/s); the outlet at 1 atm. Z and c start from the
    inlet profiles decaying in x. Upwind convection, cvar transported, no
    species chemistry. `deepfgm`: a DeepFGM for the state lookups (the
    table still gives cOc and the enthalpy). The example's step is 4e-6 s
    at 96 x 48. `table`: the FlameletTable when the caller has read it."""
    import json
    from .combustion.fgm import read_flare_table
    from .solvers.fgm import FGMConfig, FGMSolver
    if table is None:
        table = read_flare_table(table_path, dtype=dtype,
                                 use_native=use_native, device=device)
    with open(table_path + ".json") as f:
        Z_st = json.load(f)["Z_st"]
    Lx, Ly = 0.12, 0.06
    mesh = StructuredMesh.box([Lx, Ly, Ly / ny], [nx, ny, 1],
                              device=table.device)
    yb = (np.arange(ny) + 0.5) * mesh.dy
    r_jet, r_pilot = 0.0036, 0.0091
    pilot = (yb >= r_jet) & (yb < r_pilot)
    u_in = np.where(yb < r_jet, 12.0, np.where(yb < r_pilot, 2.0, 0.9))
    c_in = np.where(pilot, 1.0, 0.0)
    Zp_in = np.where(pilot, Z_st, np.where(yb < r_jet, 1.0, 0.0))
    prof = lambda a: torch.as_tensor(a.reshape(1, ny, 1), dtype=dtype,
                                     device=mesh.device)
    zg, e = zero_gradient(), (empty(), empty())
    bU = ((fixed_value(prof(u_in)), zg), (zg, zg), e)
    bU0 = ((fixed_value(0.0), zg), (zg, zg), e)
    bp = ((zg, fixed_value(101325.0)), (zg, zg), e)
    bZ = ((fixed_value(prof(Zp_in)), zg), (zg, zg), e)
    bc = ((fixed_value(prof(c_in)), zg), (zg, zg), e)
    bs = ((zg, zg), (zg, zg), e)
    solver = FGMSolver(
        mesh=mesh, thermo=None, transport=None, combustion=None,
        bcs_U=(bU, bU0, bU0), bcs_p=bp, bcs_h=bs, bcs_Y=bc, bcs_rho=bs,
        bcs_Z=bZ, table=table, deepfgm=deepfgm,
        config=FGMConfig(solve_cvar=True, div_scheme="upwind",
                         chemistry=False))
    X, _, _ = mesh.cell_centers(dtype)
    Z0 = prof(Zp_in).expand(mesh.shape) * torch.exp(-X / (0.25 * Lx))
    c0 = prof(c_in).expand(mesh.shape) * torch.exp(-X / (0.5 * Lx))
    U0 = torch.stack([prof(u_in).expand(mesh.shape), torch.zeros_like(X),
                      torch.zeros_like(X)])
    p0 = torch.full(mesh.shape, 101325.0, dtype=dtype, device=mesh.device)
    return solver, solver.fgm_initial_state(p0, Z0, c0, U0)


# the aachenBomb injector's flowRateProfile (t [s], relative rate), as
# examples/aachen_bomb_2d.py tabulates it
AACHEN_FLOW_PROFILE = (
    (0.0, 0.1272), (4.16667e-05, 6.1634), (8.33333e-05, 9.4778),
    (0.000125, 9.5806), (0.000166667, 9.4184), (0.000208333, 9.0926),
    (0.00025, 8.7011), (0.000291667, 8.2239), (0.000333333, 8.0401),
    (0.000375, 8.8450), (0.000416667, 8.9174), (0.000458333, 8.8688),
    (0.0005, 8.8882), (0.000541667, 8.6923), (0.000583333, 8.0014),
    (0.000625, 7.2582), (0.000666667, 7.2757), (0.000708333, 6.9680),
    (0.00075, 6.7608), (0.000791667, 6.6502), (0.000833333, 6.7695),
    (0.000875, 5.5774), (0.000916667, 4.8649), (0.000958333, 5.0805),
    (0.001, 4.9547), (0.00104167, 4.5613), (0.00108333, 4.4536),
    (0.001125, 5.2651), (0.00116667, 5.2560), (0.00120833, 5.1737),
    (0.00125, 3.9213), (0.001251, 0.0),
)
AACHEN_DT = 2.5e-6            # the case's deltaT [s]


def aachen_bomb_3d(mech_path: str, n_xz: int = 41, n_y: int = 100,
                   liquid: str = "water", dtype=torch.float32, device=None):
    """The reference's threeD_aachenBomb (examples/aachen_bomb_3d.py): a
    20 x 100 x 20 mm chamber of n_xz x n_y x n_xz cells, walls all round,
    800 K and 5 MPa air (Y_O2 0.23, Y_N2 0.77), U = 0, kEpsilon RAS (k0 1,
    eps0 90), Laminar stiff chemistry (rtol 1e-4, atol 1e-8, 20,000 steps,
    grow 10, N2 inert). A cone injector at (0, 99.5 mm, 0) pointing down
    (20 degree cone, the flowRateProfile table with 6e-6 kg over 1.25 ms,
    Rosin-Rammler sizes, flow-rate-and-discharge speed with Cd 0.9 and a
    0.19 mm orifice, 320 K) sprays 50 parcels a step into a cloud of 32,768
    slots with Spalding evaporation, ReitzDiwakar breakup and rebound on all
    six walls. `liquid`: "water" only, whose vapour H2O is a species of
    the test mechanism (the reference's n-heptane needs C7_oneStep, which
    the repository lacks). Step AACHEN_DT. (SpraySolver, SprayState) on
    `device`; the cloud draws from SprayCloud.init's default generator
    (seed 0)."""
    if liquid != "water":
        raise ValueError(f"aachen_bomb_3d sprays water only, not {liquid!r}: "
                         "the n-heptane chamber needs C7_oneStep")
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    mesh = StructuredMesh.box([0.02, 0.1, 0.02], [n_xz, n_y, n_xz],
                              origin=(-0.01, 0.0, -0.01), device=mech.device)
    wall_s = (zero_gradient(), zero_gradient())
    wall_u = (fixed_value(0.0), fixed_value(0.0))
    b_s = (wall_s, wall_s, wall_s)
    b_u = (wall_u, wall_u, wall_u)
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=20000, grow=10.0))
    gas = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b_u, b_u, b_u), bcs_p=b_s, bcs_h=b_s, bcs_Y=b_s, bcs_rho=b_s,
        config=LowMachConfig(chemistry=True,
                             inert_index=mech.species_index("N2")),
        turbulence=KEpsilon())
    liq = water()
    inj = ConeInjector(
        position=(0.0, 0.0995, 0.0), direction=(0.0, -1.0, 0.0),
        cone_angle_deg=20.0, t_start=0.0, t_end=1.25e-3, T_inject=320.0,
        mdot_profile=AACHEN_FLOW_PROFILE, mass_total=6e-6,
        size_dist="RosinRammler", rr_d=1.5e-4, rr_n=3.0, rr_min=1e-6,
        rr_max=1.5e-4, u_from_flow=True, Cd=0.9, d_outer=1.9e-4,
        rho_liquid=float(liq.rho(320.0)), parcels_per_step=50)
    rebound = tuple((ax, side, "rebound") for ax in (0, 1, 2)
                    for side in (0, 1))
    cloud = SprayCloud(mesh=mesh, liquid=liq, injector=inj,
                       max_parcels=32768, evaporation="Spalding",
                       breakup="ReitzDiwakar", wall_interaction=rebound)
    solver = SpraySolver(gas_solver=gas, cloud=cloud,
                         fuel_index=mech.species_index(liq.name))
    Y = np.zeros((mech.n_species,) + mesh.shape)
    Y[mech.species_index("O2")] = 0.23
    Y[mech.species_index("N2")] = 0.77
    full = lambda v: torch.full(mesh.shape, v, dtype=dtype,
                                device=mesh.device)
    state = solver.initial_state(full(5e6), full(800.0), Y, k0=1.0,
                                 eps0=90.0)
    return solver, state


def watermist_detonation_1d(mech_path: str, n: int = 700,
                            n_parcels: int = 80_000, n_particle: float = 275.0,
                            soi: float = 3.73e-4, dtype=torch.float32,
                            device=None):
    """The reference's oneD_detH2WaterMist (examples/
    detonation_1d_watermist.py at its --full geometry): a 1.4 m tube of n
    cells, H2-air (Y_H2/O2/N2 0.02851/0.226/0.745) at 1 atm and 300 K with
    a 2000 K, 90 atm driver at the reflecting left wall; HLLC, RK2,
    vanLeer, split ODE chemistry above 500 K. `n_parcels` 5 um water
    parcels of `n_particle` droplets each (the reference's manualInjection:
    80,000 x 275), evenly over [0.6, 1.4) m, released in the step holding
    `soi`; Spalding evaporation, no breakup. Step:
    detonation_dt(solver.gas_solver, a_bound=3500.0), 0.3 dx / 3500 m/s.
    (HighSpeedSpraySolver,
    HighSpeedSprayState) on `device`."""
    mech = load_mechanism(mech_path, device=device)
    Lx = 1.4
    gas = _h2_tube(mech, n, Lx, dtype)
    mesh = gas.mesh
    x0 = 3.0 / 7.0 * Lx
    xs = np.linspace(x0, Lx * 0.999, n_parcels)
    half = 0.5 * Lx / n
    positions = np.stack([xs, np.full_like(xs, half), np.full_like(xs, half)],
                         axis=1)
    inj = ManualInjector(positions=positions, soi=soi, d0=5e-6,
                         n_particle=n_particle, T_inject=300.0,
                         rho_liquid=997.0)
    cloud = SprayCloud(mesh=mesh, liquid=water(), injector=inj,
                       max_parcels=n_parcels, evaporation="Spalding",
                       breakup="none", wall_interaction=())
    solver = HighSpeedSpraySolver(gas_solver=gas, cloud=cloud,
                                  transport=make_transport(mech, dtype),
                                  vapor_index=mech.species_index("H2O"))
    return solver, solver.initial_state(*_h2_tube_fields(
        mech, mesh, dtype, max(0.002 * Lx, 1.5 * mesh.dx)))


# ------------------------------------------------- face-list forms

def _flat_cells(x):
    """A structured (..., nx, ny, nz) field as flat cells, components last:
    (n,) or (n, k)."""
    if x.dim() == 3:
        return x.reshape(-1)
    return x.reshape(x.shape[0], -1).T.contiguous()


def jet_flame_3d_les_plan(mech_path: str, n: int = 64, dtype=torch.float32,
                          device=None, p_mg: bool = False):
    """The structured jet (`jet_flame_3d_les`, (2n, n, n) cells) on the
    face-list backend with a shift plan: from_structured over its box and
    its per-field BCs (the inlet profiles per face), the species in BC
    groups (H2), (O2), (N2) and the six zero-inlet species, the same
    thermo, Laminar stiff chemistry and Sigma model, and its initial state
    as flat cells. Every Krylov matvec is the lattice stencil; `p_mg`
    preconditions the pressure CG with the aggregation AMG
    (ops.amg_fl.make_amg_fl) in place of Jacobi."""
    st, s0 = jet_flame_3d_les(mech_path, n=n, dtype=dtype, device=device)
    mesh, dev = st.mesh, st.mesh.device
    fl = lambda bcs: from_structured(mesh, bcs, dtype, device=dev)
    mech = load_mechanism(mech_path, device="cpu")
    si = mech.species_index
    ns = mech.n_species
    iH2, iO2, iN2 = si("H2"), si("O2"), si("N2")
    groups = [(iH2,), (iO2,), (iN2,),
              tuple(i for i in range(ns) if i not in (iH2, iO2, iN2))]
    m_Y_groups = tuple((fl(st.bcs_Y[g[0]]), g) for g in groups)
    m_p = fl(st.bcs_p)
    solver = LowMachSolverFL(
        m_p=m_p, m_h=fl(st.bcs_h), m_Y=m_Y_groups[-1][0],
        m_rho=fl(st.bcs_rho), m_U=tuple(fl(b) for b in st.bcs_U),
        thermo=st.thermo, transport=st.transport, combustion=st.combustion,
        config=st.config, m_Y_groups=m_Y_groups,
        p_mg=make_amg_fl(m_p) if p_mg else None, les=st.turbulence)
    return solver, solver.initial_state(
        _flat_cells(s0.p), _flat_cells(s0.T), _flat_cells(s0.Y),
        _flat_cells(s0.U))


def detonation_2d_h2_fl(mech_path: str, nx: int = 2000, ny: int = 100,
                        dtype=torch.float32, device=None,
                        igniters=DETONATION_IGNITERS):
    """The 2D H2-air detonation channel (`detonation_2d_h2`) on the
    face-list backend: from_structured over its box and per-field BCs (a
    shift plan), HighSpeedSolverFL with the same configuration (HLLC, RK2,
    vanLeer, split ODE chemistry), its initial state as flat cells. Step:
    `detonation_dt(solver)` (the mesh spacing is the structured box's, 2 m
    / nx)."""
    st, s0 = detonation_2d_h2(mech_path, nx=nx, ny=ny, dtype=dtype,
                              device=device, igniters=igniters)
    mesh = st.mesh
    fl = lambda bcs: from_structured(mesh, bcs, dtype, device=mesh.device)
    solver = HighSpeedSolverFL(
        m_rho=fl(st.bcs_rho), m_p=fl(st.bcs_p), m_Y=fl(st.bcs_Y),
        m_U=tuple(fl(b) for b in st.bcs_U), thermo=st.thermo,
        kinetics=st.kinetics, config=st.config)
    return solver, HighSpeedFLState(
        rho=_flat_cells(s0.rho), rhoU=_flat_cells(s0.rhoU),
        rhoE=_flat_cells(s0.rhoE), rhoY=_flat_cells(s0.rhoY),
        T=_flat_cells(s0.T), time=s0.time)


def sandia_d_fgm_2d_fl(table_path: str, nx: int = 96, ny: int = 48,
                       dtype=torch.float32, device=None, ras: bool = True,
                       deepfgm=None, use_native: bool = True, table=None):
    """The Sandia D jet (`sandia_d_fgm_2d`) on the face-list backend:
    from_structured over its slab and per-field BCs (a shift plan),
    FGMSolverFL with the same table (or `deepfgm`) and configuration (every
    control scalar with Z's BCs, as the structured solver has them), and
    with `ras` RNG k-epsilon (rng_keps_kwargs(C1=1.52), the reference
    case's setting; k, eps zeroGradient, starting at 1e-3 and 1e-2). Its
    initial state as flat cells. `table`: the FlameletTable when the caller
    has read it."""
    from .solvers.fgm_fl import FGMSolverFL
    st, s0 = sandia_d_fgm_2d(table_path, nx=nx, ny=ny, dtype=dtype,
                             device=device, deepfgm=deepfgm,
                             use_native=use_native, table=table)
    mesh = st.mesh
    fl = lambda bcs: from_structured(mesh, bcs, dtype, device=mesh.device)
    # every control scalar (and He) with the BCs of Z, as the structured
    # solver transports them
    m_Z = fl(st.bcs_Z)
    ras_kw = {}
    if ras:
        m_ke = fl(st.bcs_h)                # zeroGradient all round
        ras_kw = dict(m_k=m_ke, m_eps=m_ke, **rng_keps_kwargs(C1=1.52))
    solver = FGMSolverFL(
        m_p=fl(st.bcs_p), m_h=m_Z, m_Y=m_Z, m_rho=fl(st.bcs_rho),
        m_U=tuple(fl(b) for b in st.bcs_U), thermo=None, transport=None,
        combustion=None, config=st.config, table=st.table, m_c=m_Z,
        m_var=m_Z, deepfgm=deepfgm, **ras_kw)
    return solver, solver.fgm_initial_state(
        _flat_cells(s0.p), _flat_cells(s0.Z), _flat_cells(s0.c),
        _flat_cells(s0.U))


_AACHEN_BLOCKMESH = """
convertToMeters 0.001;
vertices
(
    (-10 0 -10) (10 0 -10) (10 100 -10) (-10 100 -10)
    (-10 0 10) (10 0 10) (10 100 10) (-10 100 10)
);
blocks
(
    hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1)
);
boundary
(
    xlo {{ type wall; faces ((0 4 7 3)); }}
    xhi {{ type wall; faces ((1 2 6 5)); }}
    ylo {{ type wall; faces ((0 1 5 4)); }}
    yhi {{ type wall; faces ((3 7 6 2)); }}
    zlo {{ type wall; faces ((0 3 2 1)); }}
    zhi {{ type wall; faces ((4 5 6 7)); }}
);
"""
AACHEN_WALLS = ("xlo", "xhi", "ylo", "yhi", "zlo", "zhi")


def aachen_blockmesh_dict(n_xz: int = 41, n_y: int = 100) -> str:
    """blockMeshDict of the aachenBomb chamber: one hex block of 20 x 100 x
    20 mm, n_xz x n_y x n_xz cells, six wall patches."""
    return _AACHEN_BLOCKMESH.format(nx=n_xz, ny=n_y, nz=n_xz)


def aachen_bomb_3d_fl(mech_path: str, n_xz: int = 41, n_y: int = 100,
                      liquid: str = "water", dtype=torch.float32, device=None,
                      mesh=None):
    """The aachenBomb chamber (`aachen_bomb_3d`) on a general mesh: the
    blockMeshDict of `aachen_blockmesh_dict` (no shift plan: its pressure
    CG runs through ell_matvec), LowMachSolverFL with kEpsilon and
    face-list wall functions on the six walls, and the same cone injector
    and cloud on an overlay grid at the chamber's own resolution and
    bounds (so the cloud sees the structured grid). SprayFLSolver and its
    initial state (k0 1, eps0 90, the cloud's draws from a generator
    seeded with 0). Step AACHEN_DT. `mesh`: the GeneralMesh of that dict,
    when the caller has built it."""
    st, _ = aachen_bomb_3d(mech_path, n_xz=n_xz, n_y=n_y, liquid=liquid,
                           dtype=dtype, device=device)
    gas = st.gas_solver
    dev = gas.mesh.device
    gm = mesh if mesh is not None else build_blockmesh(
        parse_blockmesh_dict(aachen_blockmesh_dict(n_xz, n_y)))
    zg, u0 = zero_gradient(), fixed_value(0.0)
    mk = lambda bc: gm.with_bcs({w: bc for w in AACHEN_WALLS}, dtype,
                                device=dev)
    m_s = mk(zg)
    m_u = mk(u0)
    gas_fl = LowMachSolverFL(
        m_p=m_s, m_h=m_s, m_Y=m_s, m_rho=m_s, m_U=(m_u, m_u, m_u),
        thermo=gas.thermo, transport=gas.transport,
        combustion=gas.combustion, config=gas.config, m_k=m_s, m_eps=m_s,
        wall_fns=make_wall_functions_fl(gm, AACHEN_WALLS, dtype, device=dev),
        p_ell=m_s.ell_connectivity())
    c = st.cloud
    cloud = OverlaySprayCloud.build(
        gm.centers, gm.volumes, dict(
            liquid=c.liquid, injector=c.injector, max_parcels=c.max_parcels,
            evaporation=c.evaporation, breakup=c.breakup,
            wall_interaction=c.wall_interaction),
        resolution=(n_xz, n_y, n_xz),
        bounds=((-0.01, 0.0, -0.01), (0.01, 0.1, 0.01)), device=dev)
    solver = SprayFLSolver(gas_solver=gas_fl, cloud=cloud,
                           fuel_index=st.fuel_index)
    mech = load_mechanism(mech_path, device="cpu")
    Y = np.zeros((gm.n_cells, mech.n_species))
    Y[:, mech.species_index("O2")] = 0.23
    Y[:, mech.species_index("N2")] = 0.77
    n = gm.n_cells
    return solver, solver.initial_state(
        np.full(n, 5e6), np.full(n, 800.0), Y, k0=1.0, eps0=90.0)


# 1D premixed flames anchored at an inlet: the mixture flows in at u_in,
# products leave through a pressure outlet, and the front settles where
# consumption balances inflow (examples/flame_1d_anchored.py; the reference's
# Tu500K-Phi1 DNN-chemistry case as examples/flame_dnn_closed_loop.py runs it)
FLAME_P0 = 101325.0
FLAME_IGNITION_TIME = 5e-3     # the 0D run that gives the burnt composition


def _premixed(mech, fuel: str, phi: float) -> np.ndarray:
    """Fuel/air mass fractions at equivalence ratio phi (H2 + 0.5 O2, or
    CH4 + 2 O2; 3.76 N2 a O2)."""
    nu_O2 = 0.5 if fuel == "H2" else 2.0
    X = np.zeros(mech.n_species)
    X[mech.species_index(fuel)] = phi
    X[mech.species_index("O2")] = nu_O2
    X[mech.species_index("N2")] = nu_O2 * 3.76
    W = np.asarray(mech.molecular_weights)
    return X * W / (X * W).sum()


def _anchored_flame(mech_path, n, length, u_in, T_u, phi, fuel, dtype,
                    device, T_ignite, ignite_opts, T_guess, models, Y_burnt):
    """The examples' shared construction: the burnt side from a 0D ignition
    at T_ignite (or Y_burnt), at the temperature of the unburnt enthalpy;
    the [n, 1, 1] box with empty sides; fixedValue U, h, rho and Y at the
    inlet, fixedValue p at the outlet; a tanh profile at 0.45 L, 6 cells
    wide, and the mass-flux-consistent velocity. `models`: {name:
    make(thermo, kinetics, ode_opts)}, one LowMachSolver each. Returns
    ({name: solver}, state, info)."""
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    dev = mech.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    ns = mech.n_species
    iF, iN2 = mech.species_index(fuel), mech.species_index("N2")
    Yu = _premixed(mech, fuel, phi)
    if Y_burnt is None:
        _, _, Yb_t = ignite(th, kin, T_ignite, FLAME_P0, t(Yu),
                            FLAME_IGNITION_TIME, opts=ignite_opts)
        Yb = Yb_t[-1]
    else:
        Yb = (Y_burnt if isinstance(Y_burnt, torch.Tensor)
              else torch.as_tensor(np.array(Y_burnt))).to(dtype=dtype,
                                                          device=dev)
    h_u = th.h_mass(t(T_u), t(Yu))
    T_b = float(th.T_from_h(h_u, Yb, t(T_guess)))
    mesh = StructuredMesh.box([length, length / n, length / n], [n, 1, 1],
                              device=dev)
    e = (empty(), empty())
    bU = ((fixed_value(u_in), zero_gradient()), e, e)
    bU0 = ((fixed_value(0.0), zero_gradient()), e, e)
    bp = ((zero_gradient(), fixed_value(FLAME_P0)), e, e)
    bh = ((fixed_value(float(h_u)), zero_gradient()), e, e)
    rho_u = float(th.rho(t(FLAME_P0), t(T_u), t(Yu)))
    brho = ((fixed_value(rho_u), zero_gradient()), e, e)
    bY = [((fixed_value(float(Yu[k])), zero_gradient()), e, e)
          for k in range(ns)]
    ode_opts = _dtype_opts(dtype, 20000, grow=10.0)
    solvers = {name: LowMachSolver(
        mesh=mesh, thermo=th, transport=tr,
        combustion=make(th, kin, ode_opts), bcs_U=(bU, bU0, bU0), bcs_p=bp,
        bcs_h=bh, bcs_Y=bY, bcs_rho=brho,
        config=LowMachConfig(chemistry=True, inert_index=iN2))
        for name, make in models.items()}
    Xc = mesh.cell_centers(dtype)[0]
    prof = 0.5 * (1.0 + torch.tanh((Xc - 0.45 * length) / (6.0 * mesh.dx)))
    T0 = T_u + (T_b - T_u) * prof
    Y0 = (t(Yu)[:, None, None, None] * (1 - prof)
          + Yb[:, None, None, None] * prof)
    p = torch.full(mesh.shape, FLAME_P0, dtype=dtype, device=dev)
    rho0 = th.rho(p, T0, torch.movedim(Y0, 0, -1))
    U0 = torch.stack([rho_u * u_in / rho0, torch.zeros_like(T0),
                      torch.zeros_like(T0)])
    state = next(iter(solvers.values())).initial_state(p, T0, Y0, U0)
    info = dict(x=Xc.reshape(-1).cpu().numpy(), dx=mesh.dx, length=length,
                u_in=u_in, T_u=T_u, T_b=T_b, rho_u=rho_u, Y_u=Yu,
                Y_b=Yb.cpu().numpy(), fuel_index=iF,
                W_fuel=float(mech.molecular_weights[iF]),
                species_names=mech.species_names)
    return solvers, state, info


def flame_1d_anchored(mech_path: str, n: int = 512, length: float = 0.008,
                      u_in: float = 2.2, T_u: float = 300.0,
                      phi: float = 1.0, fuel: str = "H2", combustion=None,
                      dtype=torch.float64, device=None, Y_burnt=None):
    """The inlet-anchored 1D premixed flame of examples/flame_1d_anchored.py
    (:60-131): fuel/air at phi and T_u enters at u_in through the x-low
    face of an n-cell channel of `length`, the products leave at 1 atm. The
    burnt side is the last state of a 5 ms constant-pressure ignition from
    1200 K (rtol 1e-6, atol 1e-10) at the temperature that keeps the
    unburnt enthalpy (Newton from 2200 K); Y_burnt (ns,) replaces that
    ignition (200 reads: 1,600 to 2,300 integrator trips on one lane) when
    the caller already has it. Laminar chemistry (rtol 1e-6 and atol 1e-12 in float64,
    else 1e-4 and 1e-8), or `combustion(thermo, kinetics, ode_opts)`'s
    model. Returns (solver, state, dt = 5 dx / 1200, info): info holds the
    cell centres x, dx, u_in, T_u, the burnt T_b, rho_u, Y_u, Y_b, the
    fuel's index and molecular weight and the species names, which
    flame_1d_diagnostics reads."""
    make = combustion or (lambda th, kin, opts: Laminar(th, kin,
                                                        ode_opts=opts))
    solvers, state, info = _anchored_flame(
        mech_path, n, length, u_in, T_u, phi, fuel, dtype, device, 1200.0,
        RosenbrockOptions(rtol=1e-6, atol=1e-10, max_steps=20000), 2200.0,
        {"flame": make}, Y_burnt)
    return solvers["flame"], state, 5.0 * info["dx"] / 1200.0, info


def flame_1d_diagnostics(solver, states, info) -> dict:
    """examples/flame_1d_anchored.py's readings (:136-173) of a state or of
    a run's states in order: per state its time, flame position (the
    largest |dT/dx|), T_max and consumption speed S_c = -(1/(rho_u
    Y_u,fuel)) sum(wdot_fuel) W_fuel dx; of the last state the thermal
    thickness; over the last third of the states (when it holds two or
    more) the front's drift dx_f/dt from a linear fit, the displacement
    speed S_L = u_in - drift and the mean S_c (else None)."""
    if isinstance(states, LowMachState):
        states = [states]
    th, kin = solver.thermo, solver.combustion.kinetics
    x, iF = info["x"], info["fuel_index"]
    out = {k: [] for k in ("time", "x_f", "T_max", "S_c")}
    for s in states:
        Yt = torch.movedim(s.Y, 0, -1)
        wdot = production_rates(kin, th, s.T, th.rho(s.p, s.T, Yt), Yt)
        mdot = -wdot[..., iF].sum() * info["W_fuel"] * solver.mesh.dx
        T = s.T.reshape(-1).cpu().numpy()
        out["time"].append(float(s.time))
        out["x_f"].append(flame_position(x, T))
        out["T_max"].append(float(T.max()))
        out["S_c"].append(float(mdot / (info["rho_u"]
                                        * info["Y_u"][iF])))
    out["thickness"] = flame_thickness(x, T)
    sel = slice(len(states) * 2 // 3, None)
    drift = (float(np.polyfit(np.asarray(out["time"])[sel],
                              np.asarray(out["x_f"])[sel], 1)[0])
             if len(out["time"][sel]) >= 2 else None)
    out["drift"] = drift
    out["S_L_displacement"] = None if drift is None else info["u_in"] - drift
    out["S_c_avg"] = (float(np.mean(np.asarray(out["S_c"])[sel]))
                      if drift is not None else None)
    return out


def dnn_closed_loop_flame(mech_path: str, net, n: int = 512,
                          length: float = 0.012, u_in: float = 5.0,
                          T_u: float = 500.0, frozen_T: float = 600.0,
                          dtype=torch.float32, device=None, Y_burnt=None):
    """The reference's Tu500K-Phi1 case as examples/flame_dnn_closed_loop.py
    (:62-127) runs it: the anchored H2/air flame at phi = 1, T_u, u_in over
    `length`, its burnt side from a 5 ms ignition from 1400 K (rtol 1e-4,
    atol 1e-8; Newton from 2400 K), or Y_burnt. One initial state, two
    solvers: "ode" with Laminar stiff chemistry and "dnn" with
    DNNChemistry(net) (the same ode_opts as flame_1d_anchored). `net`: a
    DFODENet, served with frozen temperature `frozen_T` (a shallow copy
    carries it; the caller's net is left as it is), or the path of an npz
    checkpoint, loaded in `dtype`. Returns ({"ode": solver, "dnn": solver},
    state, dt = 5 dx / 1500, info as flame_1d_anchored's)."""
    if isinstance(net, (str, os.PathLike)):
        net = load_npz_checkpoint(net, frozen_T=frozen_T, dtype=dtype,
                                  device=device)
    else:
        net = copy.copy(net)
        net.frozen_T = float(frozen_T)
    models = {"ode": lambda th, kin, opts: Laminar(th, kin, ode_opts=opts),
              "dnn": lambda th, kin, opts: DNNChemistry(
                  th, kin, ode_opts=opts, net=net)}
    solvers, state, info = _anchored_flame(
        mech_path, n, length, u_in, T_u, 1.0, "H2", dtype, device, 1400.0,
        RosenbrockOptions(rtol=1e-4, atol=1e-8, max_steps=20000), 2400.0,
        models, Y_burnt)
    return solvers, state, 5.0 * info["dx"] / 1500.0, info


def closed_loop_compare(states, info, ms_per_step=None) -> dict:
    """examples/flame_dnn_closed_loop.py's metrics (:160-178) of the DNN
    run against the stiff one, states {"ode": state, "dnn": state}: T's L2
    and L-infinity deviation relative to the stiff run's, each front's
    position and their offset (m and cells), and the L-infinity deviation
    of Y_H2, Y_OH and Y_H2O over the stiff run's largest value; with
    ms_per_step {"ode": ms, "dnn": ms}, the stiff over the DNN step
    time."""
    x = info["x"]
    T = {k: s.T.reshape(-1).cpu().numpy() for k, s in states.items()}
    Y = {k: s.Y.reshape(s.Y.shape[0], -1).cpu().numpy()
         for k, s in states.items()}
    To, Td = T["ode"], T["dnn"]
    xf = {k: flame_position(x, v) for k, v in T.items()}
    dxf = xf["dnn"] - xf["ode"]
    names = info["species_names"]
    out = dict(
        T_L2=float(np.linalg.norm(Td - To) / np.linalg.norm(To)),
        T_Linf=float(np.abs(Td - To).max() / To.max()), x_f=xf,
        dx_f=dxf, dx_f_cells=dxf / info["dx"],
        Y_Linf={sp: float(np.abs(Y["dnn"][k] - Y["ode"][k]).max()
                          / max(Y["ode"][k].max(), 1e-12))
                for sp, k in ((sp, names.index(sp))
                              for sp in ("H2", "OH", "H2O"))})
    if ms_per_step is not None:
        out["speedup"] = ms_per_step["ode"] / ms_per_step["dnn"]
    return out


def harvest_states(solver, state, dt: float, steps: int):
    """examples/flame_dnn_closed_loop.py's --dump-states (:129-155): one
    step, then steps - 1 more, taking every cell's (T, p, Y) after each
    max(steps // 40, 1)-th of those. Returns (the last state, {"T": (m,),
    "p": (m,), "Y": (m, ns)} as numpy), what make_dfodenet_dataset takes as
    its manifold."""
    state, _ = solver.step(state, dt)
    every = max(steps // 40, 1)
    taken = []
    for i in range(steps - 1):
        state, _ = solver.step(state, dt)
        if (i + 1) % every == 0:
            taken.append((state.T.reshape(-1).cpu().numpy(),
                          state.p.reshape(-1).cpu().numpy(),
                          state.Y.reshape(state.Y.shape[0], -1).T
                          .cpu().numpy()))
    if not taken:
        return state, dict(T=np.zeros(0), p=np.zeros(0),
                           Y=np.zeros((0, state.Y.shape[0])))
    return state, {k: np.concatenate([h[i] for h in taken])
                   for i, k in enumerate(("T", "p", "Y"))}


# ------------------------------------------ the examples' own families
# (examples/flame_1d.py, reacting_tgv_2d.py, jet_flame_2d.py,
# detonation_1d.py, shock_watermist_1d.py, single_droplet_motion.py); each
# builder's defaults are its example's argparse defaults

def flame_1d(mech_path: str, n: int = 256, length: float = 0.012,
             T_u: float = 300.0, steps: int = 400, dt=None,
             dtype=torch.float64, device=None):
    """The freely propagating 1D premixed flame of examples/flame_1d.py
    (:44-91): n cells over `length`, zeroGradient at both ends for every
    field (the pressure included: no Dirichlet face), empty y and z; the
    phi ~ 1 H2/air mixture at T_u and 1 atm with a 2400 K burnt pocket on
    the left, T_u + (2400 - T_u) (1 - tanh((x - L/4) / 8 dx)) / 2, at rest;
    Laminar chemistry (rtol 1e-6 and atol 1e-12 in float64, else 1e-4 and
    1e-8; 20000 steps, growth 10). Returns (solver, state, dt, info): dt
    the given one or min(2e-7, 0.35 dx / 1200); info holds the cell centres
    x, dx, `steps` and the example's read interval every = max(steps //
    40, 1), which flame_1d_speed's series take."""
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    mesh = StructuredMesh.box([length, length / n, length / n], [n, 1, 1],
                              device=mech.device)
    e = (empty(), empty())
    b = ((zero_gradient(), zero_gradient()), e, e)
    comb = Laminar(th, kin, ode_opts=_dtype_opts(dtype, 20000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
        config=LowMachConfig(chemistry=True,
                             inert_index=mech.species_index("N2")))
    X = mesh.cell_centers(dtype)[0]
    prof = 0.5 * (1.0 - torch.tanh((X - 0.25 * length) / (8.0 * mesh.dx)))
    T = (T_u + (2400.0 - T_u) * prof).to(dtype)
    p = torch.full(mesh.shape, 101325.0, dtype=dtype, device=mesh.device)
    Y = torch.as_tensor(_fresh_mixture(mech), dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    dt = dt if dt is not None else min(2e-7, 0.35 * mesh.dx / 1200.0)
    info = dict(x=X.reshape(-1).cpu().numpy(), dx=mesh.dx, length=length,
                steps=steps, every=max(steps // 40, 1))
    return solver, solver.initial_state(p, T, Y.contiguous()), dt, info


def flame_1d_speed(times, fronts, x, T, U, dx=None) -> dict:
    """examples/flame_1d.py's readings (:100-114) of a run's front series
    (times, front positions) and its last state's T and U_x along the
    line: the displacement speed from a linear fit over the second half of
    the series, the unburnt velocity u_ahead at the cell max(3, int(1 mm /
    dx // 2)) cells past the last front (at most the last but one), the
    flame speed S_L = displacement - u_ahead, and the thermal thickness.
    dx: the cell size (default x[1] - x[0])."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    T = np.asarray(T.cpu() if isinstance(T, torch.Tensor) else T).reshape(-1)
    U = np.asarray(U.cpu() if isinstance(U, torch.Tensor) else U).reshape(-1)
    dx = float(x[1] - x[0]) if dx is None else dx
    sel = slice(len(times) // 2, None)
    disp = float(np.polyfit(np.asarray(times)[sel],
                            np.asarray(fronts)[sel], 1)[0])
    i_f = int(np.argmin(np.abs(x - fronts[-1])))
    i_ahead = min(i_f + max(3, int(1e-3 / dx // 2)), len(x) - 2)
    u_ahead = float(U[i_ahead])
    return dict(displacement=disp, u_ahead=u_ahead, i_ahead=i_ahead,
                S_L=disp - u_ahead, thickness=flame_thickness(x, T))


def reacting_tgv_2d(mech_path: str, n: int = 64, t_end: float = 5e-4,
                    dt: float = 2.5e-7, dtype=torch.float64,
                    out_dir: str = "postProcessing_tgv", device=None):
    """The 2D reacting Taylor-Green vortex of examples/reacting_tgv_2d.py
    (:47-92): a periodic square of 2 pi mm, n x n x 1 cells, the phi ~ 1
    H2/air mixture at 300 K and 1 atm with an 1800 K disc of radius L/6 at
    the centre, the TGV velocity of amplitude 5 m/s; Laminar chemistry (the
    examples' options per dtype, 20000 steps, growth 10). Its function
    objects write under out_dir: FieldMinMax of T and p
    (out_dir/fieldMinMax) and a LineSample of T along x through y = L/2
    (out_dir/sample). Returns (solver, state, function objects, control):
    run it with `run_case(solver, state, control, function_objects=...,
    fields_fn=tgv_fields)`; control ends at t_end with step dt and writes
    every 1e-4 s, as the example's (dataclasses.replace sets another
    write_interval)."""
    from .runtime import ControlDict, FieldMinMax, FunctionObjectSet, LineSample
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    L = 2.0 * math.pi * 1e-3
    mesh = StructuredMesh.box([L, L, L / n], [n, n, 1], device=mech.device)
    b = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    comb = Laminar(th, kin, ode_opts=_dtype_opts(dtype, 20000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
        config=LowMachConfig(chemistry=True,
                             inert_index=mech.species_index("N2")))
    X, Yg, _ = mesh.cell_centers(dtype)
    k = 2.0 * math.pi / L
    U = torch.stack([5.0 * torch.sin(k * X) * torch.cos(k * Yg),
                     -5.0 * torch.cos(k * X) * torch.sin(k * Yg),
                     torch.zeros_like(X)])
    r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2
    T = torch.where(r2 < (L / 6) ** 2, 1800.0, 300.0).to(dtype)
    p = torch.full(mesh.shape, 101325.0, dtype=dtype, device=mesh.device)
    Y = torch.as_tensor(_fresh_mixture(mech), dtype=dtype, device=mesh.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    fos = FunctionObjectSet([
        FieldMinMax(mesh, ["T", "p"], out_dir=f"{out_dir}/fieldMinMax"),
        LineSample(mesh, 0, (0.0, L / 2, 0.0), ["T"],
                   out_dir=f"{out_dir}/sample")])
    control = ControlDict(end_time=t_end, delta_t=dt, write_interval=1e-4)
    return (solver, solver.initial_state(p, T, Y.contiguous(), U), fos,
            control)


def tgv_fields(state) -> dict:
    """The fields reacting_tgv_2d's function objects read: T and p."""
    return {"T": state.T, "p": state.p}


JET2D_MODELS = ("EDC", "PaSR", "laminar")


def jet_flame_2d(mech_path: str, model: str = "EDC", n: int = 24,
                 steps: int = 300, dt: float = 2e-6, dtype=torch.float64,
                 device=None):
    """The 2D RAS jet flame of examples/jet_flame_2d.py (:45-109; the
    example runs float64): 4n x n x 1 cells over 80 x 20 mm centred on y =
    0; at the x-low face a 30 % H2 / 70 % N2 (by mass) jet of 40 m/s and
    400 K for |y| < 2 mm into a 1 m/s, 1400 K air coflow, one fixedValue
    profile per species, U_x, h and rho (h and rho from the thermo at the
    inlet), the transverse velocity fixed at 0 there; p fixed at the
    outlet, zeroGradient elsewhere, empty z. k-epsilon RAS (k0 = 0.01
    u_jet^2, eps0 = 0.1 u_jet^3 / r_jet), upwind convection, N2 inert; the
    model (`model` one of JET2D_MODELS, as --model) on rtol 1e-6, atol
    1e-12, 20000 steps, growth 10. Initial state: hot coflow air at rest.
    Returns (solver, state, dt, info): info holds `steps` and the index of
    H2."""
    from .combustion import EDC, PaSR
    from .turbulence import KEpsilon
    makers = dict(zip(JET2D_MODELS, (EDC, PaSR, Laminar)))
    if model not in makers:
        raise ValueError(f"model {model!r}: one of {JET2D_MODELS}")
    mech = load_mechanism(mech_path, device=device)
    dev = mech.device
    th = make_thermo(mech, dtype)
    tr = make_transport(mech, dtype)
    kin = make_kinetics(mech, dtype)
    ns = mech.n_species
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    nx, ny = 4 * n, n
    Lx, Ly = 0.08, 0.02
    mesh = StructuredMesh.box([Lx, Ly, Ly / ny], [nx, ny, 1],
                              origin=(0.0, -Ly / 2, 0.0), device=dev)
    jet_r, u_jet, u_co = 0.002, 40.0, 1.0
    y = mesh.cell_centers()[1][0, :, 0].cpu().numpy()
    in_jet = np.abs(y) < jet_r
    Y_in = np.zeros((ns, ny))
    Y_in[iH2] = np.where(in_jet, 0.30, 0.0)
    Y_in[iN2] = np.where(in_jet, 0.70, 0.767)
    Y_in[iO2] = np.where(in_jet, 0.0, 0.233)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    zg = zero_gradient()
    zgp, e = (zg, zg), (empty(), empty())
    inlet = lambda v: ((fixed_value(v), zg), zgp, e)
    bcs_Y = [inlet(f(Y_in[i][None, :, None])) for i in range(ns)]
    T_in = f(np.where(in_jet, 400.0, 1400.0)[None, :, None])
    Yt_in = f(Y_in.T[None, :, None, :])
    comb = makers[model](th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-6, atol=1e-12, max_steps=20000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(inlet(f(np.where(in_jet, u_jet, u_co)[None, :, None])),
               inlet(0.0), inlet(0.0)),
        bcs_p=((zg, fixed_value(101325.0)), zgp, e),
        bcs_h=inlet(th.h_mass(T_in, Yt_in)), bcs_Y=bcs_Y,
        bcs_rho=inlet(th.rho(f(101325.0), T_in, Yt_in)),
        config=LowMachConfig(chemistry=True, div_scheme="upwind",
                             inert_index=iN2),
        turbulence=KEpsilon())
    Y0 = np.zeros((ns,) + mesh.shape)
    Y0[iN2], Y0[iO2] = 0.767, 0.233
    state = solver.initial_state(np.full(mesh.shape, 101325.0),
                                 np.full(mesh.shape, 1400.0), Y0,
                                 k0=u_jet ** 2 * 0.01,
                                 eps0=u_jet ** 3 * 0.1 / jet_r)
    return solver, state, dt, dict(steps=steps, h2_index=iH2)


def detonation_1d(mech_path: str, n: int = 625, length: float = 5.0,
                  t_end: float = 2.2e-3, dtype=torch.float64,
                  flux: str = "HLLC", cfl: float = 0.3,
                  driver_frac: float = 0.002, driver_pratio: float = 90.0,
                  driver_T: float = 2000.0, device=None):
    """The 1D H2-air detonation of examples/detonation_1d.py (:56-100; the
    reference's oneD_detonationH2): n cells over `length`, stoichiometric
    H2/O2/N2 0.02851/0.226/0.745 (normalised) at 1 atm and 300 K, a driver
    of driver_pratio atm and driver_T over x < max(driver_frac L, 1.5 dx),
    a reflecting left wall (symmetry(negate=True) on U_x), zeroGradient
    elsewhere; `flux`, RK2, vanLeer, split ODE chemistry above 500 K
    (the examples' options per dtype, 5000 steps). Returns (solver, state,
    dt, info): dt = cfl dx / 3500 m/s; info holds the cell centres x, the
    example's n_steps = int(t_end / dt), its read interval
    every = max(n_steps // 60, 1) and the index of H2."""
    mech = load_mechanism(mech_path, device=device)
    solver = _h2_tube(mech, n, length, dtype, flux)
    mesh = solver.mesh
    dt = cfl * mesh.dx / 3500.0
    n_steps = int(t_end / dt)
    info = dict(x=mesh.cell_centers(dtype)[0].reshape(-1).cpu().numpy(),
                n_steps=n_steps, every=max(n_steps // 60, 1),
                h2_index=mech.species_index("H2"))
    return solver, solver.initial_state(*_h2_tube_fields(
        mech, mesh, dtype, max(driver_frac * length, 1.5 * mesh.dx),
        driver_T, driver_pratio)), dt, info


def detonation_front(solver, state, x, h2_index: int) -> dict:
    """examples/detonation_1d.py's reading of a state (:109-118): the front
    at the largest pressure (x and cell), p_max, T_max and the largest Y_H2
    more than 20 mm behind the front (NaN with 2 cells or fewer there)."""
    _, _, p, T, Y = solver.primitives(state)
    p = p.reshape(-1).cpu().numpy()
    ix = int(np.argmax(p))
    behind = np.asarray(x) < (x[ix] - 0.02)
    y_h2 = Y[h2_index].reshape(-1).cpu().numpy()
    return dict(x_front=float(x[ix]), i_front=ix, p_max=float(p.max()),
                T_max=float(T.max()),
                Y_H2_behind=(float(y_h2[behind].max()) if behind.sum() > 2
                             else float("nan")))


def front_speed(times, fronts, lo: float, hi: float):
    """The examples' speed fit: the slope of a linear fit of the front
    positions in (lo, hi) against time, or None with fewer than 4 there
    (detonation_1d.py: (0.3 L, 0.95 L); shock_watermist_1d.py: (0.1,
    1.0) m)."""
    t, x = np.asarray(times), np.asarray(fronts)
    sel = (x > lo) & (x < hi)
    return float(np.polyfit(t[sel], x[sel], 1)[0]) if sel.sum() >= 4 else None


def shock_watermist_1d(mech_path: str, n: int = 240, t_end: float = 2.0e-3,
                       dry: bool = False, dtype=torch.float32,
                       cfl: float = 0.3, device=None):
    """The inert shock through a water mist of examples/
    shock_watermist_1d.py (:57-117; the reference's oneD_shockWaterMist):
    x in [-0.1, 1.1] m on n cells (the mesh frame shifted by +0.1 m); air
    (O2/N2 0.23149482/0.76204518, normalised) at 66 kPa and 275 K behind a
    driver of 109312.5 Pa, 318 K and 125.076 m/s at x < 0; zeroGradient
    ends; HLLC, RK2, vanLeer, no chemistry. With the fog (dry=False): 220
    parcels of 2.4 um water, one every 5 mm from x = 2.5 mm, 2.2e5 droplets
    each at 275 K, released in the first step; Spalding evaporation, no
    breakup, the vapour into H2O. Returns (solver, state, dt, info): the
    HighSpeedSpraySolver, or with dry=True the bare HighSpeedSolver; dt =
    cfl dx / 900 m/s; info holds the physical cell centres x, the
    example's n_steps = int(t_end / dt), its read interval every =
    max(n_steps // 40, 1), the gas solver and `prims`, the primitives of a
    state of either solver."""
    mech = load_mechanism(mech_path, device=device)
    th = make_thermo(mech, dtype)
    kin = make_kinetics(mech, dtype)
    x_lo, x_hi = -0.1, 1.1
    Lx = x_hi - x_lo
    w = Lx / n
    mesh = StructuredMesh.box([Lx, w, w], [n, 1, 1], device=mech.device)
    e = (empty(), empty())
    b_scalar = ((zero_gradient(), zero_gradient()), e, e)
    gas = HighSpeedSolver(mesh=mesh, thermo=th, kinetics=kin,
                          bcs_rho=b_scalar, bcs_U=(b_scalar,) * 3,
                          bcs_p=b_scalar, bcs_Y=b_scalar,
                          config=HighSpeedConfig(flux="HLLC", rk_order=2,
                                                 limiter="vanLeer",
                                                 chemistry="none"))
    Yv = np.zeros(mech.n_species)
    Yv[mech.species_index("O2")] = 0.23149482
    Yv[mech.species_index("N2")] = 0.76204518
    Yv /= Yv.sum()
    X = mesh.cell_centers(dtype)[0]
    Xphys = X - 0.1
    drv = (Xphys < 0.0).cpu().numpy()
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=mesh.device)
    T = t(np.where(drv, 318.0, 275.0))
    p = t(np.where(drv, 109312.5, 66000.0))
    u0 = t(np.where(drv, 125.076, 0.0))
    U = torch.stack([u0, torch.zeros_like(u0), torch.zeros_like(u0)])
    Y = t(Yv)[:, None, None, None].expand((mech.n_species,) + mesh.shape)
    dt = cfl * mesh.dx / 900.0
    n_steps = int(t_end / dt)
    info = dict(x=Xphys.reshape(-1).cpu().numpy(), n_steps=n_steps,
                every=max(n_steps // 40, 1), gas_solver=gas)
    if dry:
        info["prims"] = gas.primitives
        return gas, gas.initial_state(p, T, Y.contiguous(), U=U), dt, info
    n_parcels = 220
    xs = 0.1 + 0.0025 + 0.005 * np.arange(n_parcels)
    half = 0.5 * w
    inj = ManualInjector(positions=np.stack(
        [xs, np.full_like(xs, half), np.full_like(xs, half)], axis=1),
        soi=0.0, d0=2.4e-6, n_particle=2.2e5, T_inject=275.0,
        rho_liquid=997.0)
    cloud = SprayCloud(mesh=mesh, liquid=water(), injector=inj,
                       max_parcels=n_parcels, evaporation="Spalding",
                       breakup="none", wall_interaction=())
    solver = HighSpeedSpraySolver(gas_solver=gas, cloud=cloud,
                                  transport=make_transport(mech, dtype),
                                  vapor_index=mech.species_index("H2O"))
    info["prims"] = lambda s: gas.primitives(s.gas)
    return solver, solver.initial_state(p, T, Y.contiguous(), U=U), dt, info


def shock_front(p, x) -> float:
    """examples/shock_watermist_1d.py's shock position: x at the steepest
    pressure drop, argmin of diff(p) along the line."""
    p = p.reshape(-1).cpu().numpy() if isinstance(p, torch.Tensor) \
        else np.asarray(p).reshape(-1)
    return float(np.asarray(x).reshape(-1)[int(np.argmin(np.diff(p)))])


# examples/single_droplet_motion.py's gas and droplet (:28-34) and its
# three runs, (diameter [um], t_end [s])
DROPLET_GAS = dict(U_GAS=67.056, U_DROP=30.48, RHO_L=1000.0, T_GAS=293.0,
                   P_GAS=101325.0, MU_G=1.8e-5)
DROPLET_RUNS = ((25, 2e-3), (100, 2e-2), (1000, 0.1))


def _rho_gas() -> float:
    return DROPLET_GAS["P_GAS"] / (287.0 * DROPLET_GAS["T_GAS"])


def single_droplet_motion(d0: float, t_end: float, dtype=torch.float64,
                          device=None):
    """One droplet's drag relaxation as examples/single_droplet_motion.py
    runs it (:80-106; the reference's oneD_singleDropletMotion): a frozen
    uniform air stream (DROPLET_GAS: 67.056 m/s, 293 K, 1 atm, rho = p /
    (287 T), mu 1.8e-5) on a 100-cell duct of 10 m, one parcel of diameter
    d0 and density 1000 kg/m^3 at 30.48 m/s from x = 0.05 m; sphereDrag,
    no evaporation, breakup or walls. Returns (cloud, state, gas fields,
    dt, n_steps): dt = min(tau / 20, t_end / 200) with tau = rho_l d0^2 /
    (18 mu), n_steps = round(t_end / dt)."""
    from .device import resolve_device
    g = DROPLET_GAS
    dev = resolve_device(device)
    mesh = StructuredMesh.box([10.0, 0.01, 0.01], [100, 1, 1], device=dev)
    full = lambda v: torch.full(mesh.shape, v, dtype=dtype, device=dev)
    gas = dict(rho=full(_rho_gas()),
               U=torch.stack([full(g["U_GAS"]), full(0.0), full(0.0)]),
               T=full(g["T_GAS"]), p=full(g["P_GAS"]), mu=full(g["MU_G"]))
    inj = ManualInjector(positions=np.array([[0.05, 0.005, 0.005]]), soi=0.0,
                         d0=d0, n_particle=1.0, T_inject=g["T_GAS"],
                         rho_liquid=g["RHO_L"], U0=(g["U_DROP"], 0.0, 0.0))
    cloud = SprayCloud(mesh=mesh, liquid=water(), injector=inj,
                       max_parcels=1, evaporation="none", drag="sphereDrag",
                       breakup="none", wall_interaction=())
    tau = g["RHO_L"] * d0 ** 2 / (18.0 * g["MU_G"])
    dt = min(tau / 20.0, t_end / 200.0)
    return cloud, cloud.init(dtype=dtype), gas, dt, int(round(t_end / dt))


def droplet_relaxation(d0: float, t_end: float, dtype=torch.float64,
                       device=None, steps=None):
    """u_p(t) of single_droplet_motion: the parcel's x velocity after each
    of the run's steps (the step k at time (k + 1) dt), `steps` of them
    (default: all n_steps, to t_end), as one tensor on the device (the
    example's lax.scan is a loop of cloud.evolve here). Returns (u_p,
    the last cloud state)."""
    cloud, c, gas, dt, n_steps = single_droplet_motion(d0, t_end, dtype,
                                                       device)
    t = torch.zeros((), dtype=dtype, device=c.d.device)
    u = []
    for _ in range(n_steps if steps is None else steps):
        c, _ = cloud.evolve(c, gas, dt, t)
        t = t + dt
        u.append(c.vel[0, 0])
    return torch.stack(u), c


def droplet_reference(d0: float, t_end: float, n: int = 400):
    """The reference integration of examples/single_droplet_motion.py
    (:37-52): du_p/dt = (3/4) (rho_g / (rho_l d0)) C_D |u_g - u_p| (u_g -
    u_p) with sphereDrag's C_D = 24/Re (1 + Re^(2/3)/6) below Re = 1000,
    else 0.424, by scipy's RK45 at rtol 1e-10, atol 1e-12. Returns (t,
    u_p) as numpy at n times over [0, t_end]."""
    from scipy.integrate import solve_ivp
    g = DROPLET_GAS
    rho_g = _rho_gas()

    def rhs(t, y):
        rel = g["U_GAS"] - y[0]
        Re = rho_g * abs(rel) * d0 / g["MU_G"]
        Cd = np.where(Re < 1000.0,
                      24.0 / max(Re, 1e-12) * (1.0 + Re ** (2.0 / 3.0) / 6.0),
                      0.424)
        return [0.75 * rho_g / (g["RHO_L"] * d0) * Cd * abs(rel) * rel]

    ts = np.linspace(0.0, t_end, n)
    sol = solve_ivp(rhs, (0.0, t_end), [g["U_DROP"]], t_eval=ts, rtol=1e-10,
                    atol=1e-12)
    return ts, sol.y[0]
