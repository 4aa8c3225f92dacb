"""DF-ODENet: DNN chemistry surrogate (per-species GELU MLPs + Box-Cox
transform).

Port of deepflame_tpu/chemistry/dnn.py: the reference's DNN chemistry path
(per-species GELU MLP [ns+2, 1600, 800, 400, 1], Box-Cox transform
lambda = 0.1, frozen-temperature mask, RR = (Ynew - Y) rho / delta_t with the
inert species held fixed and the rest renormalized).

The (ns - 1) per-species nets of equal shape run fused: their weights are
stacked (S, in, out) once, when the `DFODENet` is built, with the first
layer's input dimension padded with zero rows to a multiple of 16 (the
tensor cores' depth). A four-layer fused net goes through
`ops.kernels.mlp_fused` (one launch on the card, its plain version on the
CPU); nets of another depth take the plain version, and `fuse=False` the
per-species loop, as in the JAX package. With bf16 compute, both round where
the TPU kernel does (operands and each hidden activation in bf16, sums, bias
and GELU in f32).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.kernels import mlp_fused, mlp_fused_plain

__all__ = ["DFODENet", "MultiRangeDFODENet", "init_params", "mlp_apply",
           "load_torch_checkpoint", "load_npz_checkpoint", "bct", "inv_bct",
           "LAYERS"]

LAYERS = (1600, 800, 400)
_K_ALIGN = 16                    # first-layer input padding (tensor-core depth)


def bct(y, lam=0.1):
    """Box-Cox transform."""
    return (torch.clamp(y, min=0.0) ** lam - 1.0) / lam


def inv_bct(z, lam=0.1):
    return torch.clamp(lam * z + 1.0, min=0.0) ** (1.0 / lam)


def mlp_apply(params: Sequence[tuple], x):
    """GELU MLP forward: params = [(W, b), ...]; exact (erf) GELU between
    layers, linear output. Mixed types promote as in JAX."""
    h = x
    for i, (W, b) in enumerate(params):
        dt = torch.promote_types(h.dtype, W.dtype)
        h = h.to(dt) @ W.to(dt) + b
        if i < len(params) - 1:
            h = F.gelu(h)
    return h


def init_params(generator: torch.Generator, n_species: int, hidden=LAYERS,
                dtype=torch.float32, device=None):
    """Random params for (n_species - 1) per-species MLPs [ns+2, *hidden, 1]:
    He-scaled normal weights, zero biases. The numbers come from `generator`
    (a CPU generator) in float64, so one seed gives the same weights on every
    device."""
    device = resolve_device(device)
    sizes = (n_species + 2,) + tuple(hidden) + (1,)
    nets = []
    for _ in range(n_species - 1):
        layers = []
        for i in range(len(sizes) - 1):
            scale = (2.0 / sizes[i]) ** 0.5
            W = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                            dtype=torch.float64) * scale
            layers.append((W.to(dtype=dtype, device=device),
                           torch.zeros(sizes[i + 1], dtype=dtype,
                                       device=device)))
        nets.append(layers)
    return nets


class DFODENet(nn.Module):
    """DNN chemistry surrogate. `nets` is a list of per-species MLP params
    [(W (in, out), b (out,)), ...] for species 0..ns-2; the last (inert)
    species is closed by renormalization.

    Knobs as in the JAX package: `fuse` runs the per-species nets as stacked
    matmuls; `compute_dtype=torch.bfloat16` rounds the matmul operands to
    bf16 with f32 sums (None computes in the input's type); `chunk` bounds
    the lanes of one plain-version pass on the CPU."""

    def __init__(self, nets, x_mean, x_std, y_mean, y_std, delta_t: float,
                 frozen_T: float = 700.0, lam: float = 0.1, fuse: bool = True,
                 compute_dtype=None, chunk: int | None = 131072):
        super().__init__()
        self.nets = [list(net) for net in nets]
        for name, t in (("x_mean", x_mean), ("x_std", x_std),
                        ("y_mean", y_mean), ("y_std", y_std)):
            self.register_buffer(name, t)
        self.delta_t = float(delta_t)
        self.frozen_T = float(frozen_T)
        self.lam = float(lam)
        self.fuse = fuse
        self.compute_dtype = compute_dtype
        self.chunk = chunk
        self.n_layers = len(self.nets[0])
        shapes = {tuple(tuple(W.shape) for W, _ in net) for net in self.nets}
        self.fused = fuse and len(shapes) == 1
        self._cast = {}
        if self.fused:
            n_in = self.nets[0][0][0].shape[0]
            pad = (-n_in) % _K_ALIGN
            for l in range(self.n_layers):
                W = torch.stack([net[l][0] for net in self.nets])
                if l == 0 and pad:
                    W = F.pad(W, (0, 0, 0, pad))
                self.register_buffer(f"W{l}", W.contiguous())
                self.register_buffer(
                    f"b{l}", torch.stack([net[l][1] for net in self.nets]))
            if compute_dtype is not None:
                self._weights(compute_dtype)

    def _weights(self, cd: torch.dtype):
        """Stacked weights in `cd` and biases in the matching input type
        (float32 beside bf16 weights), made once per type."""
        if cd not in self._cast:
            bdt = torch.float32 if cd == torch.bfloat16 else cd
            self._cast[cd] = (
                [getattr(self, f"W{l}").to(cd).contiguous()
                 for l in range(self.n_layers)],
                [getattr(self, f"b{l}").to(bdt).contiguous()
                 for l in range(self.n_layers)])
        return self._cast[cd]

    def _fused_mlp(self, x):
        """(..., F) -> (..., S) through the stacked weights. Four-layer nets
        go through `mlp_fused` (one kernel launch on the card); other depths
        through its plain version, which takes any depth. Both compute in
        compute_dtype, or in x's type when it is None, `chunk` lanes at a
        time on the CPU."""
        lead = x.shape[:-1]
        cd = self.compute_dtype if self.compute_dtype is not None else x.dtype
        Ws, bs = self._weights(cd)
        xf = x.reshape(-1, x.shape[-1]).to(bs[0].dtype).contiguous()
        fn = mlp_fused if self.n_layers == 4 else mlp_fused_plain
        out = fn(xf, Ws, bs, chunk=self.chunk)
        return out.to(x.dtype).reshape(lead + (-1,))

    def rates(self, T, p, Y, rho):
        """RR [kg/m^3/s] for a batch: T, p, rho (...,), Y (..., ns). BCT +
        normalize -> per-species MLP -> delta BCT -> inverse BCT ->
        inert-preserving renormalization -> RR = (Ynew - Y) rho / delta_t,
        zero where T <= frozen_T."""
        x_bct = torch.cat([T[..., None], p[..., None], bct(Y, self.lam)],
                          dim=-1)
        x = (x_bct - self.x_mean) / self.x_std
        if self.fused:
            out = self._fused_mlp(x)                      # (..., ns-1)
        else:
            out = torch.cat([mlp_apply(net, x) for net in self.nets], dim=-1)
        new_bct = out * self.y_std + self.y_mean + x_bct[..., 2:-1]
        Y_new_active = inv_bct(new_bct, self.lam)
        Y_inert = Y[..., -1:]
        Y_new_active = Y_new_active / torch.clamp(
            Y_new_active.sum(-1, keepdim=True), min=1e-30) * (1.0 - Y_inert)
        Y_new = torch.cat([Y_new_active, Y_inert], dim=-1)
        RR = (Y_new - Y) * rho[..., None] / self.delta_t
        mask = (T > self.frozen_T)[..., None]
        return torch.where(mask, RR, 0.0)


class MultiRangeDFODENet:
    """Up to 3 temperature-range models with per-cell dispatch: cells with
    T >= T_bounds[i-1] take model i."""

    def __init__(self, nets: Sequence[DFODENet], T_bounds: Sequence[float]):
        self.nets = tuple(nets)
        self.T_bounds = tuple(T_bounds)

    def rates(self, T, p, Y, rho):
        rr = self.nets[0].rates(T, p, Y, rho)
        for i in range(1, len(self.nets)):
            mask = (T >= self.T_bounds[i - 1])[..., None]
            rr = torch.where(mask, self.nets[i].rates(T, p, Y, rho), rr)
        return rr


def load_npz_checkpoint(path: str, frozen_T: float = 700.0,
                        dtype=torch.float32, device=None) -> DFODENet:
    """Load a checkpoint in the npz layout examples/train_dfodenet.py writes
    (n_species, n_layers, net{i}_W{j}, net{i}_b{j}, x/y mean and std,
    delta_t)."""
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    d = np.load(path)
    ns = int(d["n_species"])
    n_layers = int(d["n_layers"])
    nets = [[(f(d[f"net{i}_W{j}"]), f(d[f"net{i}_b{j}"]))
             for j in range(n_layers)] for i in range(ns - 1)]
    return DFODENet(nets=nets, x_mean=f(d["x_mean"]), x_std=f(d["x_std"]),
                    y_mean=f(d["y_mean"]), y_std=f(d["y_std"]),
                    delta_t=float(d["delta_t"]), frozen_T=frozen_T)


def load_torch_checkpoint(path: str, n_species: int, delta_t: float,
                          frozen_T: float = 700.0, dtype=torch.float32,
                          device=None) -> DFODENet:
    """Import a published DF-ODENet torch state dict: net{i} submodules with
    `*_j.weight` (out, in) and `*_j.bias`, plus data_in_mean/std and
    data_target_mean/std."""
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    nets = []
    for i in range(n_species - 1):
        net_sd = sd[f"net{i}"]
        keys = sorted(
            {k.rsplit(".", 1)[0] for k in net_sd if k.endswith(".weight")},
            key=lambda s: int(s.rsplit("_", 1)[-1]))
        nets.append([(f(np.asarray(net_sd[k + ".weight"]).T),
                      f(net_sd[k + ".bias"])) for k in keys])
    return DFODENet(nets=nets, x_mean=f(sd["data_in_mean"]),
                    x_std=f(sd["data_in_std"]),
                    y_mean=f(sd["data_target_mean"]),
                    y_std=f(sd["data_target_std"]), delta_t=delta_t,
                    frozen_T=frozen_T)
