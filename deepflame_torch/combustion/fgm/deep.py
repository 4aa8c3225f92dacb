"""DeePFGM: a neural-network flamelet manifold in place of the table lookup.

Port of deepflame_tpu/combustion/fgm/deep.py (the reference's
FGM/DeePFGM): one MLP maps the normalised control variables (z, c, gz, gc)
to the table outputs (omgc, cOc, ZOc, cp, mwt, hiyi, Tf, nu). As in JAX,
the network runs `chemistry.dnn.mlp_apply` (plain GEMMs), not the fused
DF-ODENet kernel. `train_deep_fgm` distils a network from a FlameletTable
on the table's device: the samples and the batch order come from numpy's
default_rng(seed), as in JAX; torch.optim.Adam takes the place of
optax.adam (both b1 0.9, b2 0.999, eps 1e-8); the initial weights come
from `init_params` (an explicit torch.Generator; JAX draws its own from a
PRNGKey).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ...chemistry.dnn import mlp_apply
from .table import BASE_TABLES, FlameletTable, lookup

__all__ = ["DeepFGM", "train_deep_fgm"]

_OUTPUTS = BASE_TABLES  # ("omgc", "cOc", "ZOc", "cp", "mwt", "hiyi", "Tf", "nu")
_FLOORS = {"cp": 100.0, "mwt": 1.0, "Tf": 200.0, "nu": 1e-7}


@dataclasses.dataclass(frozen=True)
class DeepFGM:
    params: Any             # MLP params [(W (in, out), b (out,)), ...]
    x_mean: torch.Tensor    # (4,) over [z, c, gz, gc]
    x_std: torch.Tensor
    y_mean: torch.Tensor    # (8,)
    y_std: torch.Tensor

    def query(self, Z, c, gz, gc) -> dict:
        """All manifold outputs at once: {name: field}, with the physical
        floors (cp, mwt, Tf, nu positive; omgc >= 0)."""
        x = torch.stack([Z, c, gz, gc], dim=-1)
        y = mlp_apply(self.params, (x - self.x_mean) / self.x_std) \
            * self.y_std + self.y_mean
        out = {name: y[..., i] for i, name in enumerate(_OUTPUTS)}
        for k, floor in _FLOORS.items():
            out[k] = torch.clamp(out[k], min=floor)
        out["omgc"] = torch.clamp(out["omgc"], min=0.0)
        return out


def init_params(sizes, seed: int, dtype=torch.float32, device=None):
    """He-scaled normal weights and zero biases of an MLP of layer `sizes`,
    drawn from a CPU torch.Generator seeded with `seed` (one seed, the same
    weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    params = []
    for i in range(len(sizes) - 1):
        W = torch.randn((sizes[i], sizes[i + 1]), generator=g,
                        dtype=torch.float64) * (2.0 / sizes[i]) ** 0.5
        params.append((W.to(dtype=dtype, device=device),
                       torch.zeros(sizes[i + 1], dtype=dtype, device=device)))
    return params


def train_deep_fgm(table: FlameletTable, hidden=(64, 64, 32),
                   n_samples: int = 20000, epochs: int = 200,
                   batch: int = 2048, lr: float = 2e-3, seed: int = 0,
                   dtype=torch.float32, verbose: bool = False) -> DeepFGM:
    """Distil a FlameletTable into a DeepFGM network on the table's device:
    n_samples uniform (z, c, gz, gc) points over the table's axes, the
    eight manifold outputs looked up there, normalised inputs and outputs,
    then `epochs` passes of Adam (learning rate lr) over minibatches of
    `batch` in a seeded random order, on the mean squared error."""
    dev = table.device
    rng = np.random.default_rng(seed)
    z_ax, c_ax = np.asarray(table.axes[1]), np.asarray(table.axes[2])
    gz_ax, gc_ax = np.asarray(table.axes[3]), np.asarray(table.axes[4])
    Z = rng.uniform(z_ax.min(), z_ax.max(), n_samples)
    C = rng.uniform(c_ax.min(), c_ax.max(), n_samples)
    GZ = rng.uniform(gz_ax.min(), gz_ax.max(), n_samples)
    GC = rng.uniform(gc_ax.min(), gc_ax.max(), n_samples)
    tdt = next(iter(table.tables.values())).dtype
    f = lambda a: torch.as_tensor(a, dtype=tdt, device=dev)
    coords = (None, f(Z), f(C), f(GZ), f(GC), None)
    Y = np.stack([lookup(table, name, coords).cpu().numpy().astype(np.float64)
                  for name in _OUTPUTS], axis=-1)
    X = np.stack([Z, C, GZ, GC], axis=-1)
    x_mean, x_std = X.mean(0), X.std(0) + 1e-12
    y_mean, y_std = Y.mean(0), Y.std(0) + 1e-12
    Xn = torch.as_tensor(((X - x_mean) / x_std).astype(np.float32),
                         device=dev)
    Yn = torch.as_tensor(((Y - y_mean) / y_std).astype(np.float32),
                         device=dev)

    sizes = (4,) + tuple(hidden) + (len(_OUTPUTS),)
    params = [(W.clone().requires_grad_(), b.clone().requires_grad_())
              for W, b in init_params(sizes, seed, dtype, dev)]
    opt = torch.optim.Adam([t for layer in params for t in layer], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    nb = max(n_samples // batch, 1)
    for ep in range(epochs):
        perm = rng.permutation(n_samples)
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        for b_ in range(nb):
            idx = torch.as_tensor(perm[b_ * batch:(b_ + 1) * batch],
                                  device=dev)
            opt.zero_grad(set_to_none=True)
            loss = ((mlp_apply(params, Xn[idx]) - Yn[idx]) ** 2).mean()
            loss.backward()
            opt.step()
            tot += loss.detach()
        if verbose and (ep + 1) % max(epochs // 10, 1) == 0:
            print(f"DeepFGM epoch {ep + 1}: mse={float(tot) / nb:.5f}",
                  flush=True)
    g = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return DeepFGM(params=[(W.detach(), b.detach()) for W, b in params],
                   x_mean=g(x_mean), x_std=g(x_std), y_mean=g(y_mean),
                   y_std=g(y_std))
