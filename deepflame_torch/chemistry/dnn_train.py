"""DF-ODENet training: the data set from 0D reactor runs, Adam on the
per-species GELU MLPs, and the npz checkpoint.

The port's counterpart of examples/train_dfodenet.py (the JAX package keeps
its training in that script): random flammable H2/air states are pre-burnt
for a random time and advanced by delta_t through `solve_chemistry` (the
batched stiff integrator, so `gj_inverse` inverts every Rosenbrock W), and
the nets learn the Box-Cox (lambda = 0.1) increment of every species but the
inert one. The draws come from one numpy generator in the script's order,
so one seed gives the script's data set and batches.

Training runs the plain `mlp_apply` (`torch.matmul` and exact GELU, in the
nets' type) under autograd: the fused kernel `mlp_fused` has no backward
pass, and the JAX script trains through XLA matmuls too. In float32 the
matmuls stay exact float32 (PyTorch's default leaves TF32 off).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .dnn import bct, mlp_apply
from .integrator import RosenbrockOptions
from .reactor import solve_chemistry

__all__ = ["DFODENetData", "make_dfodenet_dataset", "DFODENetParams",
           "train_dfodenet", "save_npz_checkpoint"]

LAMBDA = 0.1                     # Box-Cox exponent of inputs and targets


class DFODENetData(NamedTuple):
    """A DF-ODENet data set. X (n, ns + 2): the input states (after the
    pre-burn) as [T, p, BCT(Y)]; D (n, ns - 1): BCT(Y_out) - BCT(Y), Y_out
    the states advanced by delta_t, without the inert (last) species;
    x_mean, x_std, y_mean, y_std: their float64 column means and population
    standard deviations (+ 1e-10); Xn, Dn: the normalized features and
    targets in float32. All on the data set's device. rng: the numpy
    generator that drew it, in its state after the draws (train_dfodenet
    continues it, as the script's one generator does)."""
    X: torch.Tensor
    D: torch.Tensor
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor
    Xn: torch.Tensor
    Dn: torch.Tensor
    delta_t: float
    rng: np.random.Generator


def _manifold_states(manifold, t_lo: float, rng: np.random.Generator):
    """The script's --manifold augmentation: the harvested (T, p, Y) states
    hotter than min(t_lo, 500 K) and two copies perturbed off the manifold
    (T by 1 % and 3 % normal noise, Y by log-normal noise, renormalized).
    `manifold`: a mapping with T, p, Y (n,), (n,), (n, ns), or the path of
    an npz holding them."""
    if isinstance(manifold, (str, os.PathLike)):
        manifold = np.load(manifold)
    Tm, pm, Ym = (np.asarray(manifold[k], np.float64) for k in ("T", "p", "Y"))
    keep = Tm > min(t_lo, 500.0)
    Tm, pm, Ym = Tm[keep], pm[keep], Ym[keep]
    reps = [(Tm, pm, Ym)]
    for scale in (0.01, 0.03):
        rT = Tm * (1.0 + scale * rng.standard_normal(Tm.shape))
        rY = Ym * np.exp(scale * rng.standard_normal(Ym.shape))
        rY = rY / rY.sum(axis=1, keepdims=True)
        reps.append((rT, pm, rY))
    return tuple(np.concatenate([r[i] for r in reps]) for i in range(3))


def make_dfodenet_dataset(mech, thermo, kin, n: int, *, seed: int = 0,
                          delta_t: float = 1e-6, t_lo: float = 800.0,
                          t_hi: float = 2600.0, pre_burn_max: float = 1e-4,
                          rtol: float = 1e-7, atol: float = 1e-13,
                          manifold=None, device=None) -> DFODENetData:
    """The script's data set (examples/train_dfodenet.py:70-127) in the
    tables' type on `device` (default: the CUDA card; the tables must live
    there). `mech` names the species (fuel H2, or species 0 without it; O2;
    N2, or the last species) and gives their molecular weights.

    Draws, in order, from np.random.default_rng(seed): phi in [0.4, 2],
    T0 in [t_lo, t_hi], p0 in [0.5, 3] atm, the pre-burn time in [0,
    pre_burn_max]; then, with `manifold`, the perturbations of
    _manifold_states. Every state is burnt for its pre-burn time, then
    advanced by delta_t, both through solve_chemistry (max_steps 100,000)
    with every lane in one drain: the script's 32 bins change no lane's
    result (a finished lane is frozen), and a trip of this eager loop costs
    about the same at 64 lanes as at 2,048, so one drain as long as the
    stiffest lane's beats 17 drains. In float32 the script's rule holds:
    rtol at least 1e-5 and atol 1e-9."""
    device = torch.empty(0, device=resolve_device(device)).device  # cuda:0
    dtype = thermo.W.dtype
    if thermo.W.device != device:
        raise ValueError(f"the tables live on {thermo.W.device}, the data "
                         f"set was asked for on {device}")
    if dtype == torch.float32:
        rtol, atol = max(rtol, 1e-5), 1e-9
    names = mech.species_names
    ns = len(names)
    iH2 = names.index("H2") if "H2" in names else 0
    iO2 = names.index("O2")
    iN2 = names.index("N2") if "N2" in names else ns - 1
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.4, 2.0, n)
    T0 = rng.uniform(t_lo, t_hi, n)
    p0 = rng.uniform(0.5, 3.0, n) * 101325.0
    W = np.asarray(mech.molecular_weights)
    Y = np.zeros((n, ns))
    mH2, mO2, mN2 = 2.0 * phi * W[iH2], 1.0 * W[iO2], 3.76 * W[iN2]
    tot = mH2 + mO2 + mN2
    Y[:, iH2], Y[:, iO2], Y[:, iN2] = mH2 / tot, mO2 / tot, mN2 / tot
    pre_t = rng.uniform(0.0, pre_burn_max, n)
    opts = RosenbrockOptions(rtol=rtol, atol=atol, max_steps=100000)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    pre = solve_chemistry(thermo, kin, f(T0), f(p0), f(Y), f(pre_t),
                          opts=opts, n_bins=1)
    T_in, p_in, Y_in = pre.T, f(p0), pre.Y
    if manifold is not None:
        Tm, pm, Ym = _manifold_states(manifold, t_lo, rng)
        T_in = torch.cat([T_in, f(Tm)])
        p_in = torch.cat([p_in, f(pm)])
        Y_in = torch.cat([Y_in, f(Ym)])
    Y_out = solve_chemistry(thermo, kin, T_in, p_in, Y_in, delta_t,
                            opts=opts, n_bins=1).Y
    X = torch.cat([T_in[:, None], p_in[:, None], bct(Y_in, LAMBDA)], dim=1)
    D = (bct(Y_out, LAMBDA) - bct(Y_in, LAMBDA))[:, :-1]
    stats = []
    for A in (X, D):
        A64 = A.double()
        stats += [A64.mean(0), A64.std(0, correction=0) + 1e-10]
    x_mean, x_std, y_mean, y_std = stats
    return DFODENetData(
        X=X, D=D, x_mean=x_mean, x_std=x_std, y_mean=y_mean, y_std=y_std,
        Xn=((X.double() - x_mean) / x_std).float(),
        Dn=((D.double() - y_mean) / y_std).float(),
        delta_t=float(delta_t), rng=rng)


class DFODENetParams(nn.Module):
    """The per-species nets [[(W (in, out), b (out,)), ...], ...] as
    parameters of one module; forward(x) (B, F) -> (B, S), the nets'
    outputs side by side."""

    def __init__(self, nets):
        super().__init__()
        self.depth = len(nets[0])
        self.params = nn.ParameterList(
            [nn.Parameter(t.detach().clone()) for net in nets
             for layer in net for t in layer])

    def nets(self) -> list:
        """The current weights as detached [[(W, b), ...], ...]."""
        flat = [p.detach() for p in self.params]
        per = 2 * self.depth
        return [[(flat[i + 2 * j], flat[i + 2 * j + 1])
                 for j in range(self.depth)]
                for i in range(0, len(flat), per)]

    def forward(self, x):
        per = 2 * self.depth
        p = list(self.params)
        return torch.cat([mlp_apply([(p[i + 2 * j], p[i + 2 * j + 1])
                                     for j in range(self.depth)], x)
                          for i in range(0, len(p), per)], dim=-1)


def train_dfodenet(nets, Xn, Dn, *, epochs: int, batch: int,
                   lr: float = 1e-3, seed=0):
    """The script's training loop (examples/train_dfodenet.py:130-150):
    Adam (lr, betas (0.9, 0.999), eps 1e-8: optax.adam's defaults) on the
    mean square error of the concatenated per-species predictions; each
    epoch takes the n // batch whole batches of rng.permutation(n), where
    rng is `seed` if it is a numpy Generator (the data set's, continued)
    and np.random.default_rng(seed) otherwise. Xn (n, F) and Dn (n, S) lie
    on the nets' device. Returns (trained nets [[(W, b), ...], ...], the
    mean loss of each epoch as floats)."""
    rng = seed if isinstance(seed, np.random.Generator) \
        else np.random.default_rng(seed)
    model = DFODENetParams(nets)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    n = Xn.shape[0]
    nb = n // batch
    losses = []
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=Xn.device)
        tot = torch.zeros((), dtype=torch.float64, device=Xn.device)
        for b in range(nb):
            idx = perm[b * batch:(b + 1) * batch]
            loss = torch.mean((model(Xn[idx]) - Dn[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot = tot + loss.detach().double()
        losses.append(float(tot) / nb)
    return model.nets(), losses


def save_npz_checkpoint(path, nets, x_mean, x_std, y_mean, y_std,
                        delta_t: float) -> None:
    """Write the script's npz layout (examples/train_dfodenet.py:150-160):
    net{i}_W{j}, net{i}_b{j}, x_mean, x_std, y_mean, y_std, delta_t,
    n_species (nets + 1) and n_layers. Tensors or arrays; the JAX package's
    load_npz_checkpoint and the port's read it."""
    a = lambda t: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t))
    flat = {}
    for i, net in enumerate(nets):
        for j, (W, b) in enumerate(net):
            flat[f"net{i}_W{j}"] = a(W)
            flat[f"net{i}_b{j}"] = a(b)
    np.savez(path, x_mean=a(x_mean), x_std=a(x_std), y_mean=a(y_mean),
             y_std=a(y_std), delta_t=float(delta_t), n_species=len(nets) + 1,
             n_layers=len(nets[0]), **flat)
