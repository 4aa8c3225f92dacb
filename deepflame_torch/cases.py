"""Case builders of the port: the reacting Taylor-Green configurations that
`__graft_entry__._build` and `_build_3d_les` build for the JAX package, and
the DNN-chemistry variant of the 3D one that `tools/bench_dnn.py` builds.

Each returns (solver, state) on `device` (default: the CUDA card).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .chemistry import load_mechanism, make_kinetics, make_thermo, make_transport
from .chemistry.integrator import RosenbrockOptions
from .chemistry.dnn import LAYERS, DFODENet, init_params
from .combustion import DNNChemistry, Laminar
from .mesh import StructuredMesh, cyclic, empty
from .solvers import LowMachConfig, LowMachSolver
from .turbulence import sigma_model

__all__ = ["reacting_tgv_3d_les", "reacting_tgv_3d_les_dnn",
           "reacting_hot_spot_2d"]


def _fresh_mixture(mech):
    """phi ~ 1 H2/air mass fractions (ns,)."""
    Y = np.zeros(mech.n_species)
    for name, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[mech.species_index(name)] = y
    return Y


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
