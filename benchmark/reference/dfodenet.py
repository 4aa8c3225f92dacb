"""Plain reference of DF-ODENet's reaction rates (DeepFlame's DNN chemistry:
per-species GELU MLPs on [T, p, BCT(Y)], Box-Cox lambda 0.1, inert species
held, the others renormalised, RR = (Y_new - Y) rho / delta_t, zero at or
below the frozen temperature).

`mlp` picks the arithmetic of the nets' products:
- "exact": float64 throughout (the reference of nets served in float32);
- "bf16": the nets as bf16 nets compute, the reference of nets served in
  bf16: inputs and weights rounded to bf16, products summed in float32,
  bias and GELU in float32, each hidden activation rounded to bf16, the
  output float32;
- "fp8": operands rounded to float8 e4m3 with one scale per tensor (a
  layer's input over a block of `block` cells, a species' weight matrix),
  products summed in float32, as a plain fp8 GEMM over a batch of cells
  does (the control of nets served in bf16);
- "tf32": operands rounded to TF32's 10-bit mantissa, products summed in
  float32 (the control of nets served in float32).
Everything around the nets is float64. Cells at or below the frozen
temperature get 0 without a pass through the nets, as the rates' mask
gives them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def bct(y, lam=0.1):
    return (torch.clamp(y, min=0.0) ** lam - 1.0) / lam


def inv_bct(z, lam=0.1):
    return torch.clamp(lam * z + 1.0, min=0.0) ** (1.0 / lam)


def _fp8(x, dim):
    """Round to e4m3 with one scale per slice of the leading dimension
    (amax to 448) over the dimensions in `dim`."""
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _tf32(x):
    """Round float32 to a 10-bit mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    i = (i + (1 << 12)) & ~((1 << 13) - 1)
    return i.view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _layer(h, W, b, mlp):
    """h (S, B, in) @ W (S, in, out) + b (S, out)."""
    if mlp == "exact":
        return torch.matmul(h, W) + b[:, None, :]
    h32, W32 = h.to(torch.float32), W.to(torch.float32)
    if mlp == "bf16":
        h32, W32 = _bf16(h32), _bf16(W32)
    elif mlp == "fp8":
        h32, W32 = _fp8(h32, (-2, -1)), _fp8(W32, (-2, -1))
    elif mlp == "tf32":
        h32, W32 = _tf32(h32), _tf32(W32)
    else:
        raise ValueError(f"mlp arithmetic {mlp!r}")
    return (torch.matmul(h32, W32) + b[:, None, :].to(torch.float32)).to(h.dtype)


def mlp(x, Ws, bs, mode="exact"):
    """Stacked per-species nets: x (B, F) -> (B, S), one species at a time."""
    out = []
    for s in range(Ws[0].shape[0]):
        h = x[None]
        for i, (W, b) in enumerate(zip(Ws, bs)):
            h = _layer(h, W[s:s + 1], b[s:s + 1], mode)
            if i < len(Ws) - 1:
                h = F.gelu(h.to(torch.float32) if mode == "bf16" else h)
                if mode == "bf16":
                    h = _bf16(h).to(x.dtype)
        out.append(h[0, :, 0])
    return torch.stack(out, dim=-1)


def rates(T, p, Y, rho, net: dict, mode="exact", block=65536):
    """RR (N, ns) for T, p, rho (N,) and Y (N, ns), all float64. `net`:
    Ws/bs (stacked float64 weights (S, in, out), biases (S, out)), x_mean,
    x_std, y_mean, y_std, delta_t, frozen_T, lam."""
    lam = net["lam"]
    RR = torch.zeros_like(Y)
    hot = torch.nonzero(T > net["frozen_T"]).squeeze(1)
    for i in range(0, hot.numel(), block):
        c = hot[i:i + block]
        Tc, pc, Yc, rc = T[c], p[c], Y[c], rho[c]
        x_bct = torch.cat([Tc[:, None], pc[:, None], bct(Yc, lam)], dim=-1)
        x = (x_bct - net["x_mean"]) / net["x_std"]
        out = mlp(x, net["Ws"], net["bs"], mode)
        new = inv_bct(out * net["y_std"] + net["y_mean"] + x_bct[:, 2:-1], lam)
        inert = Yc[:, -1:]
        new = new / torch.clamp(new.sum(-1, keepdim=True), min=1e-30) * (1.0 - inert)
        Y_new = torch.cat([new, inert], dim=-1)
        RR[c] = (Y_new - Yc) * rc[:, None] / net["delta_t"]
    return RR
