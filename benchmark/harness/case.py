"""The system under test, built from a configuration file and a traffic mix:
`deepflame_torch`'s low-Mach solver on the periodic box with Sigma LES and
DF-ODENet chemistry (the lines of `cases.reacting_tgv_3d_les_dnn`, with the
configuration's settings passed explicitly), and the traffic's initial field.

The nets are one model: drawn on the run's device from the configuration's
`base_seed` (one call, in the type the nets are served in; He-normal,
zero biases). `--seed` gives every run the same work in another order: a
generator seeded with it permutes each net's hidden units (the same
functions, other weight arrays and sums), then draws an offset in whole
cells along each axis by which the whole initial field moves (the same
sphere in the same vortex, elsewhere in the periodic box), then the step
whose input and output the check compares.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""
    weights: list          # per species net: [(W (in, out), b (out,)), ...]
    shift: tuple           # the initial field's offset in cells, per axis
    capture_step: int      # the step of a segment whose result is compared
    p: torch.Tensor
    T: torch.Tensor
    Y: torch.Tensor        # (ns, n, n, n)
    U: torch.Tensor        # (3, n, n, n)


def mech_path(config: dict) -> str:
    return os.path.join(config["_dir"], config["mechanism"])


def make_inputs(config: dict, traffic: dict, seed: int, species: list,
                device) -> Inputs:
    net = config["dfodenet"]
    wdt = DTYPES[net["precision"]]
    ns = len(species)
    sizes = [ns + 2] + list(net["hidden"]) + [1]
    layer = [(a, b) for a, b in zip(sizes[:-1], sizes[1:])]
    per_net = sum(a * b for a, b in layer)
    base = torch.Generator(device=device).manual_seed(int(net["base_seed"]))
    flat = torch.randn((ns - 1) * per_net, generator=base, device=device,
                       dtype=wdt)
    g = torch.Generator(device=device).manual_seed(int(seed))
    weights, at = [], 0
    for _ in range(ns - 1):
        net_w, prev = [], None
        for a, b in layer:
            W = (flat[at:at + a * b].view(a, b) * math.sqrt(2.0 / a)).to(torch.float32)
            bias = torch.zeros(b, dtype=torch.float32, device=device)
            at += a * b
            if prev is not None:            # the rows follow the units before
                W = W[prev]
            prev = None
            if b > 1:                       # a hidden layer: permute its units
                prev = torch.randperm(b, generator=g, device=device)
                W, bias = W[:, prev], bias[prev]
            net_w.append((W.contiguous(), bias))
        weights.append(net_w)
    n = config["n"]
    shift = tuple(int(v) for v in torch.randint(
        0, n, (3,), generator=g, device=device).tolist())
    K = traffic["segment_steps"]
    capture = int(torch.randint(1, K, (1,), generator=g, device=device))

    fdt = DTYPES[config["fields_dtype"]]
    L = config["box_side_m"]
    h = L / n
    c = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) * h
    X, Yg, Z = torch.meshgrid(c, c, c, indexing="ij")
    r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2 + (Z - L / 2) ** 2
    hot = torch.roll(r2 < (traffic["hot_radius_box"] * L) ** 2, shift,
                     dims=(0, 1, 2))
    T = torch.where(hot, traffic["hot_T_K"], config["T_unburnt_K"]).to(fdt)
    k = 2.0 * math.pi / L
    u0 = config["U0_m_s"]
    U = torch.stack([u0 * torch.sin(k * X) * torch.cos(k * Yg) * torch.cos(k * Z),
                     -u0 * torch.cos(k * X) * torch.sin(k * Yg) * torch.cos(k * Z),
                     torch.zeros_like(X)])
    U = torch.roll(U, shift, dims=(1, 2, 3)).to(fdt)
    p = torch.full((n, n, n), config["p_Pa"], dtype=fdt, device=device)
    mix = lambda Ys: torch.tensor([Ys.get(s, 0.0) for s in species],
                                  dtype=fdt, device=device)[:, None, None, None]
    Y = torch.where(hot, mix(traffic["hot_Y"]), mix(config["Y_fresh"]))
    return Inputs(weights, shift, capture, p, T, Y, U)


def build_solver(config: dict, device):
    """The program's solver for the configuration, on `device`."""
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo, make_transport)
    from deepflame_torch.combustion import DNNChemistry
    from deepflame_torch.mesh import StructuredMesh, cyclic
    from deepflame_torch.solvers import LowMachConfig, LowMachSolver
    from deepflame_torch.turbulence.les import LESModel

    mech = load_mechanism(mech_path(config), device=device)
    fdt = DTYPES[config["fields_dtype"]]
    th, tr, kin = (f(mech, fdt) for f in (make_thermo, make_transport,
                                          make_kinetics))
    n, L = config["n"], config["box_side_m"]
    mesh = StructuredMesh.box([L, L, L], [n, n, n], device=mech.device)
    bcs = ((cyclic(), cyclic()),) * 3
    les = config["les"]
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr,
        combustion=DNNChemistry(th, kin),
        bcs_U=(bcs, bcs, bcs), bcs_p=bcs, bcs_h=bcs, bcs_Y=bcs, bcs_rho=bcs,
        config=LowMachConfig(chemistry=True,
                             inert_index=mech.species_index(config["inert"]),
                             **config["solver"]),
        turbulence=LESModel(kind=les["model"], Csigma=les["Csigma"],
                            Pr_t=les["Pr_t"], Sc_t=les["Sc_t"]))
    return solver, list(mech.species_names)


def with_nets(solver, config: dict, weights: list):
    """The solver with the seeded DF-ODENet (identity input normalisation,
    the configuration's output scale) in its chemistry slot."""
    from deepflame_torch.chemistry.dnn import DFODENet
    from deepflame_torch.combustion import DNNChemistry

    net = config["dfodenet"]
    fdt = DTYPES[config["fields_dtype"]]
    dev = solver.device
    ns = len(weights) + 1
    full = lambda m, v: torch.full((m,), v, dtype=fdt, device=dev)
    dfo = DFODENet(
        nets=[[(W.to(fdt), b.to(fdt)) for W, b in w] for w in weights],
        x_mean=full(ns + 2, 0.0), x_std=full(ns + 2, 1.0),
        y_mean=full(ns - 1, 0.0), y_std=full(ns - 1, net["y_std"]),
        delta_t=net["delta_t"], frozen_T=net["frozen_T"], lam=net["lam"],
        compute_dtype=DTYPES[net["precision"]])
    comb = DNNChemistry(solver.thermo, solver.combustion.kinetics, net=dfo)
    return dataclasses.replace(solver, combustion=comb)
