"""Hand-written Hopper kernels of the solver path, their plain versions, and
their build.

Five CUDA C++ kernels (sources in `deepflame_torch/csrc/`) replace the five
Pallas TPU kernels of the low-Mach steps:

=====================  =====================================================
wrapper                replaces (deepflame_tpu/ops/pallas_kernels.py)
=====================  =====================================================
`stencil7_apply`       `stencil_apply_tiled`: Krylov matvec of the species,
                       momentum and energy solves
`helmholtz7_apply`     `helmholtz_apply` and `helmholtz_apply_tiled`: the
                       pressure-CG matvec
`gj_inverse`           `gj_inverse_lanes`: Rosenbrock W inverse of the stiff
                       chemistry
`mlp_fused`            `mlp_fused_lanes`: the DF-ODENet MLPs of the DNN
                       chemistry (bf16 tensor cores, or f32/f64 FMA)
`ell_matvec`           `ell_matvec`: the pressure-CG matvec of the face-list
                       step on a general (blockMesh, polyMesh) mesh
=====================  =====================================================

Each wrapper takes the plain PyTorch version beside it for tensors on the CPU
(the tests) and launches its kernel for CUDA tensors, raising on anything the
kernel does not take; it never falls back from kernel to plain on the card.
Each launch adds one to `launches[name]`.

Build: at first use, `build()` runs one `nvcc` per source, all at once,
into a plain-C-ABI shared library under `<repo>/build/kernels/`, named by a
hash of the source and flags so that an edited source is rebuilt. The
libraries are loaded with ctypes; every C entry point launches on the current
PyTorch stream and returns `cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F_nn

__all__ = ["stencil7_apply", "helmholtz7_apply", "gj_inverse", "mlp_fused",
           "stencil_apply_plain", "helmholtz_apply_plain", "gj_inverse_plain",
           "mlp_fused_plain", "ell_matvec", "ell_matvec_plain", "launches", "reset_launches", "build",
           "find_nvcc", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# source file and C argument types (the stream pointer last) of each kernel
_KERNELS = {
    "stencil7_apply": ("stencil7.cu", [_P] * 9 + [_L, _I, _I, _I, _P]),
    "helmholtz7_apply": ("helmholtz7.cu", [_P] * 6 + [_I] * 3 + [_D] * 3 + [_P]),
    "gj_inverse": ("gj_inverse.cu", [_P, _P, _I, _L, _P]),
    "mlp_fused": ("mlp_fused.cu", [_P] * 10 + [_I] * 7 + [_P]),
    "ell_matvec": ("ell_matvec.cu", [_P] * 5 + [_L, _I, _P]),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

launches = {name: 0 for name in _KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _so_path(name: str) -> Path:
    src = CSRC / _KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def find_nvcc() -> str | None:
    """nvcc on PATH or in the CUDA toolkit's default location, else None."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def _nvcc() -> str:
    path = find_nvcc()
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return path


def build() -> dict[str, str]:
    """Compile every kernel that has no library yet, one nvcc per source, all
    started together. Returns nvcc's output (ptxas register and shared-memory
    report) per kernel built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (src, _) in _KERNELS.items():
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _function(name: str, dtype: torch.dtype):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _so_path(name).exists():
                build()
            lib = _libs[name] = ctypes.CDLL(str(_so_path(name)))
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    fn.argtypes = _KERNELS[name][1]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, tensors, dtypes=None) -> None:
    """All operands on one CUDA device and contiguous; each of the type in
    `dtypes`, or all of the first operand's type, float32 or float64."""
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {ref.device}")
    if dtypes is None:
        if ref.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: takes float32 or float64, got {ref.dtype}")
        dtypes = [ref.dtype] * len(tensors)
    for t, dt in zip(tensors, dtypes, strict=True):
        if t.device != ref.device or t.dtype != dt:
            raise ValueError(f"{name}: operand on {t.device}/{t.dtype}, "
                             f"expected {ref.device}/{dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(name: str, dtype: torch.dtype, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _function(name, dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1


# ------------------------------------------------------------ 7-point stencil

def stencil_apply_plain(x, D, lo, hi):
    """Plain version: D x + sum_ax (lo_ax roll(x, +1) + hi_ax roll(x, -1)) over
    the last three axes (FvMatrix.stencil_apply's roll form)."""
    out = D * x
    for ax in range(3):
        out = out + lo[ax] * torch.roll(x, 1, dims=ax - 3) \
                  + hi[ax] * torch.roll(x, -1, dims=ax - 3)
    return out


def stencil7_apply(x, D, lo, hi):
    """7-point stencil matvec with wrapped neighbours on the last three axes.

    x, D, lo[ax], hi[ax]: (nx, ny, nz) or (S, nx, ny, nz), all one shape; one
    launch covers the whole batch."""
    if x.device.type == "cpu":
        return stencil_apply_plain(x, D, lo, hi)
    ops = [x, D, lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]]
    _check("stencil7_apply", ops)
    if x.dim() not in (3, 4) or any(t.shape != x.shape for t in ops):
        raise ValueError("stencil7_apply: x, D, lo, hi must share one shape "
                         "(nx, ny, nz) or (S, nx, ny, nz)")
    nx, ny, nz = x.shape[-3:]
    batch = x.numel() // (nx * ny * nz) if x.numel() else 0
    out = torch.empty_like(x)
    _launch("stencil7_apply", x.dtype, x.device,
            *[t.data_ptr() for t in ops], out.data_ptr(), batch, nx, ny, nz)
    return out


# --------------------------------------------------------- Helmholtz operator

def _inv_h2(shape, spacing):
    """1/h^2 per axis, 0 for an axis with one cell (skipped)."""
    return tuple((1.0 / spacing[ax] ** 2) if n > 1 else 0.0
                 for ax, n in enumerate(shape))


def helmholtz_apply_plain(x_padded, gamma, diag, spacing):
    """Plain version: the slice form of the TPU kernel body."""
    ihx, ihy, ihz = _inv_h2(tuple(diag.shape), spacing)
    xp = x_padded
    x = xp[1:-1, 1:-1, 1:-1]
    out = diag * x
    if ihx != 0.0:
        g = gamma[0]
        out = out - (g[1:] * (xp[2:, 1:-1, 1:-1] - x)
                     - g[:-1] * (x - xp[:-2, 1:-1, 1:-1])) * ihx
    if ihy != 0.0:
        g = gamma[1]
        out = out - (g[:, 1:] * (xp[1:-1, 2:, 1:-1] - x)
                     - g[:, :-1] * (x - xp[1:-1, :-2, 1:-1])) * ihy
    if ihz != 0.0:
        g = gamma[2]
        out = out - (g[:, :, 1:] * (xp[1:-1, 1:-1, 2:] - x)
                     - g[:, :, :-1] * (x - xp[1:-1, 1:-1, :-2])) * ihz
    return out


def helmholtz7_apply(x_padded, gamma, diag, spacing):
    """out = diag x - sum_ax d/dx_ax(gamma_ax dx/dx_ax) on a uniform grid.

    x_padded: (nx+2, ny+2, nz+2) ghost-padded field; gamma: per-axis face
    arrays (nx+1, ny, nz), (nx, ny+1, nz), (nx, ny, nz+1); diag: (nx, ny, nz);
    spacing: (dx, dy, dz). Axes with one cell are skipped."""
    if x_padded.device.type == "cpu":
        return helmholtz_apply_plain(x_padded, gamma, diag, spacing)
    ops = [x_padded, gamma[0], gamma[1], gamma[2], diag]
    _check("helmholtz7_apply", ops)
    nx, ny, nz = diag.shape
    want = [(nx + 2, ny + 2, nz + 2), (nx + 1, ny, nz), (nx, ny + 1, nz),
            (nx, ny, nz + 1), (nx, ny, nz)]
    if [tuple(t.shape) for t in ops] != want:
        raise ValueError(f"helmholtz7_apply: shapes {[tuple(t.shape) for t in ops]}"
                         f", expected {want}")
    out = torch.empty_like(diag)
    _launch("helmholtz7_apply", diag.dtype, diag.device,
            *[t.data_ptr() for t in ops], out.data_ptr(), nx, ny, nz,
            *_inv_h2((nx, ny, nz), spacing))
    return out


# ------------------------------------------------------ Gauss-Jordan inverse

# largest n whose (n^2 + n)-value tableaux of one 32-lane block fit the
# 227 KB of shared memory a block may use on sm_90 (csrc/gj_inverse.cu)
_GJ_MAX_N = {torch.float32: 42, torch.float64: 29}

def gj_inverse_plain(W_t):
    """Plain version (integrator._gj_inverse_batched on the lanes-last
    layout): W_t (n, n, L) -> (n, n, L) inverses."""
    n, _, L = W_t.shape
    dtype = W_t.dtype
    tiny = torch.tensor(1e-30, dtype=dtype, device=W_t.device)
    s = 1.0 / torch.maximum(W_t.abs().amax(dim=1), tiny)          # (n, L)
    A = W_t * s[:, None, :]
    eye = torch.eye(n, dtype=dtype, device=W_t.device)[:, :, None].expand(
        n, n, L)
    M = torch.cat([A, eye], dim=1)                                # (n, 2n, L)
    for k in range(n):
        row_k = M[k]
        pv = row_k[k]
        row_k = row_k / torch.where(pv.abs() > 1e-30, pv, tiny)[None, :]
        col_k = M[:, k, :]
        onehot = torch.zeros(n, dtype=dtype, device=W_t.device)
        onehot[k] = 1.0
        M = M - col_k[:, None, :] * row_k[None, :, :] \
            + onehot[:, None, None] * row_k[None, :, :]
    return M[:, n:, :] * s[None, :, :]


def gj_inverse(W_t):
    """Batched row-equilibrated unpivoted Gauss-Jordan inverse, lanes last:
    W_t (n, n, L) -> (n, n, L), float32 or float64, any L."""
    if W_t.device.type == "cpu":
        return gj_inverse_plain(W_t)
    _check("gj_inverse", [W_t])
    if W_t.dim() != 3 or W_t.shape[0] != W_t.shape[1]:
        raise ValueError(f"gj_inverse: expected (n, n, L), got {tuple(W_t.shape)}")
    n, _, L = W_t.shape
    if n > _GJ_MAX_N[W_t.dtype]:
        raise ValueError(f"gj_inverse: n = {n} exceeds {_GJ_MAX_N[W_t.dtype]}, "
                         f"the largest whose tableaux fit shared memory in "
                         f"{W_t.dtype}")
    out = torch.empty_like(W_t)
    _launch("gj_inverse", W_t.dtype, W_t.device, W_t.data_ptr(),
            out.data_ptr(), n, L)
    return out


# ------------------------------------------------------- fused DF-ODENet MLP

# lanes per block of each mode (csrc/mlp_fused.cu), keyed by the weights' type
_MLP_LANES = {torch.bfloat16: 32, torch.float32: 16, torch.float64: 8}
_SMEM_LIMIT = 232_448            # bytes of shared memory a block may use, sm_90


def _mlp_smem(wdt, F, K1, H1, H2, H3) -> int:
    """Shared-memory bytes of one block (csrc/mlp_fused.cu)."""
    lanes = _MLP_LANES[wdt]
    if wdt == torch.bfloat16:
        return lanes * (max(H1, H3) + max(H2, K1) + 16) * 2 + 8 * 256 * 4
    return lanes * (max(H1, H3) + max(H2, F)) * wdt.itemsize


def mlp_fused_plain(x, Ws, bs, chunk: int | None = None):
    """Plain version: x (B, F) through S stacked nets -> (B, S).

    Ws[0] (S, K1, H1) may carry zero rows past F (K padding); they are not
    used. With bf16 weights it rounds where the kernel does: x and W to bf16,
    products summed in f32, bias and GELU in f32, each hidden activation
    rounded to bf16; x and the result are f32. Otherwise everything is in x's
    type. `chunk` lanes go through at a time, bounding the (S, chunk, H1)
    activations."""
    B, F = x.shape
    if chunk is not None and B > chunk:
        return torch.cat([mlp_fused_plain(x[i:i + chunk], Ws, bs)
                          for i in range(0, B, chunk)])
    bf16 = Ws[0].dtype == torch.bfloat16
    cd = torch.float32 if bf16 else x.dtype
    h = x.to(torch.bfloat16).to(cd) if bf16 else x
    for i, (W, b) in enumerate(zip(Ws, bs)):
        W = W[:, :F] if i == 0 else W
        h = torch.matmul(h, W.to(cd)) + b.to(cd)[:, None, :]
        if i < len(Ws) - 1:
            h = F_nn.gelu(h)
            if bf16:
                h = h.to(torch.bfloat16).to(cd)
    return h[..., 0].transpose(0, 1).contiguous()


def mlp_fused(x, Ws, bs, chunk: int | None = None):
    """S stacked four-layer GELU MLPs F -> H1 -> H2 -> H3 -> 1, all in one
    launch with the hidden activations on chip: x (B, F) -> (B, S).

    Ws: [(S, K1, H1), (S, H1, H2), (S, H2, H3), (S, H3, 1)], K1 >= F (rows
    past F are zero padding); bs: [(S, H1), (S, H2), (S, H3), (S, 1)]. The
    weights' type picks the mode: bfloat16 (tensor cores; x and biases
    float32, K1 and the hidden widths multiples of 16), float32 or float64
    (x, biases and weights all of that type). `chunk` only bounds the plain
    version's activations on the CPU."""
    if x.device.type == "cpu":
        return mlp_fused_plain(x, Ws, bs, chunk)
    wdt = Ws[0].dtype
    if wdt not in _MLP_LANES:
        raise TypeError(f"mlp_fused: weights must be bfloat16, float32 or "
                        f"float64, got {wdt}")
    xdt = torch.float32 if wdt == torch.bfloat16 else wdt
    if len(Ws) != 4 or len(bs) != 4:
        raise ValueError("mlp_fused: takes exactly four layers")
    ops = [x] + [t for Wb in zip(Ws, bs) for t in Wb]
    _check("mlp_fused", ops, [xdt] + [wdt, xdt] * 4)
    if x.dim() != 2 or any(W.dim() != 3 for W in Ws):
        raise ValueError("mlp_fused: x must be (B, F) and each W (S, in, out)")
    B, F = x.shape
    S, K1, H1 = Ws[0].shape
    H2, H3 = Ws[1].shape[2], Ws[2].shape[2]
    want = [(S, K1, H1), (S, H1, H2), (S, H2, H3), (S, H3, 1)]
    if [tuple(W.shape) for W in Ws] != want or K1 < F or any(
            tuple(b.shape) != (S, W.shape[2]) for W, b in zip(Ws, bs)):
        raise ValueError(f"mlp_fused: shapes x {tuple(x.shape)}, W "
                         f"{[tuple(W.shape) for W in Ws]}, b "
                         f"{[tuple(b.shape) for b in bs]} do not chain")
    if wdt == torch.bfloat16 and any(d % 16 for d in (K1, H1, H2, H3)):
        raise ValueError(f"mlp_fused: bf16 needs K1 and the hidden widths in "
                         f"multiples of 16, got {(K1, H1, H2, H3)}")
    smem = _mlp_smem(wdt, F, K1, H1, H2, H3)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"mlp_fused: widths {(F, H1, H2, H3)} need {smem} "
                         f"bytes of shared memory in {wdt}, over {_SMEM_LIMIT}")
    out = torch.empty((B, S), dtype=xdt, device=x.device)
    if B == 0:
        return out
    _launch("mlp_fused", wdt, x.device, *[t.data_ptr() for t in ops],
            out.data_ptr(), B, F, K1, H1, H2, H3, S)
    return out


# ------------------------------------------------------------ ELLPACK SpMV

def ell_matvec_plain(x, diag, nbr, coef):
    """Plain version: diag x + sum_w coef[:, w] x[nbr[:, w]] (the JAX
    package's non-Pallas expression, FvMatrixFL.apply_ell)."""
    return diag * x + (coef * x[nbr.long()]).sum(1)


def ell_matvec(x, diag, nbr, coef):
    """ELLPACK SpMV out[c] = diag[c] x[c] + sum_w coef[c, w] x[nbr[c, w]].

    x, diag: (n,); nbr: (n, w) int32, pad slots pointing at any valid row
    (the face-list mesh pads with the row's own index) with coefficient 0;
    coef: (n, w). float32 or float64."""
    if x.device.type == "cpu":
        return ell_matvec_plain(x, diag, nbr, coef)
    _check("ell_matvec", [x, diag, nbr, coef],
           [x.dtype, x.dtype, torch.int32, x.dtype])
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_matvec: takes float32 or float64, got {x.dtype}")
    n = x.shape[0]
    if (x.dim() != 1 or diag.shape != (n,) or nbr.dim() != 2
            or nbr.shape[0] != n or coef.shape != nbr.shape):
        raise ValueError(f"ell_matvec: shapes x {tuple(x.shape)}, diag "
                         f"{tuple(diag.shape)}, nbr {tuple(nbr.shape)}, coef "
                         f"{tuple(coef.shape)}; expected (n,), (n,), (n, w), "
                         f"(n, w)")
    out = torch.empty_like(x)
    if n == 0:
        return out
    _launch("ell_matvec", x.dtype, x.device, x.data_ptr(), diag.data_ptr(),
            nbr.data_ptr(), coef.data_ptr(), out.data_ptr(), n, nbr.shape[1])
    return out
