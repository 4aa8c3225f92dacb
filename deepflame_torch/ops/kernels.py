"""Hand-written Hopper kernels of the solver path, their plain versions, and
their build.

Five CUDA C++ kernels (sources in `deepflame_torch/csrc/`) replace the five
Pallas TPU kernels of the low-Mach steps, and a sixth replaces eager PyTorch
on the solver path:

=====================  =====================================================
wrapper                replaces (deepflame_tpu/ops/pallas_kernels.py)
=====================  =====================================================
`stencil7_apply`       `stencil_apply_tiled`: Krylov matvec of the species,
                       momentum and energy solves
`helmholtz7_apply`     `helmholtz_apply` and `helmholtz_apply_tiled`: the
                       pressure-CG and multigrid matvec, on a padded x;
                       `helmholtz7_apply_bc` is the same kernel on the
                       unpadded x with the ghosts computed inside it from a
                       `ghost_rule`; `helmholtz_operator` picks the form
                       for a field's BCs
`gj_inverse`           `gj_inverse_lanes`: Rosenbrock W inverse of the stiff
                       chemistry (one launch: a register kernel with n
                       fixed at compile time for small n, above it a
                       kernel that spreads each lane's tableau over
                       threads in register tiles, up to the limit
                       `gj_limits` reads)
`mlp_fused`            `mlp_fused_lanes`: the DF-ODENet MLPs of the DNN
                       chemistry, layer by layer through scratch, four
                       kernels per chunk of lanes in every mode (bf16:
                       layer 1 on mma.sync, layers 2 and 3 in a persistent
                       TMA-fed wgmma GEMM whose epilogue warps apply
                       bias+GELU; f32: tiled GEMMs on the CUDA cores; f64:
                       tiled GEMMs on the FP64 tensor cores)
`ell_matvec`           `ell_matvec`: the pressure-CG matvec of the face-list
                       step on a general (blockMesh, polyMesh) mesh
`thermo7`              no TPU kernel (XLA fuses `ThermoData.T_from_h`):
                       correctThermo, the clamped NASA-7 Newton inversion
                       T(h, Y) or T(e, Y) and psi, a thread per cell; its
                       plain version is ThermoData's `T_from_h_plain` /
                       `T_from_e_plain`, and ThermoData picks the kernel
                       for CUDA tensors
=====================  =====================================================

Each wrapper takes the plain PyTorch version beside it for tensors on the CPU
(the tests) and launches its kernel for CUDA tensors, raising on anything the
kernel does not take; it never falls back from kernel to plain on the card.
Each wrapper call that launches adds one to `launches[name]` (an
`mlp_fused` call makes four CUDA launches per chunk of lanes in one C call;
`mlp_plan` asks the library for its chunks, launches and scratch; both
Helmholtz forms count under `helmholtz7_apply`).

Build: at first use, `build()` runs one `nvcc` per source, all at once,
into a plain-C-ABI shared library under `<repo>/build/kernels/`, named by a
hash of the source and flags so that an edited source is rebuilt. The
libraries are loaded with ctypes, and each C entry point is looked up and
typed once; every one launches on the current PyTorch stream and returns
`cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import numbers
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F_nn

from ..mesh.structured import pad_field

__all__ = ["stencil7_apply", "helmholtz7_apply", "helmholtz7_apply_bc",
           "gj_inverse", "mlp_fused", "stencil_apply_plain",
           "helmholtz_apply_plain", "helmholtz_apply_bc_plain", "GhostRule",
           "ghost_rule", "helmholtz_operator", "gj_inverse_plain",
           "mlp_fused_plain", "mlp_pack", "mlp_plan", "gj_limits",
           "ell_matvec", "ell_matvec_plain", "thermo7", "THERMO7_MAX_NS",
           "launches", "reset_launches",
           "build", "ptxas_report", "find_nvcc", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# source file and C argument types (the stream pointer last) of each kernel,
# per entry point `<name>_<suffix>` where a source has several (a mode each;
# the MLP's plan and the Gauss-Jordan limits queries, which take no stream;
# the Gauss-Jordan library's empty kernel)
_KERNELS = {
    "stencil7_apply": ("stencil7.cu", [_P] * 9 + [_L, _I, _I, _I, _P]),
    "helmholtz7_apply": ("helmholtz7.cu", {
        **{dt: [_P] * 6 + [_I] * 3 + [_D] * 3 + [_P] for dt in ("f32", "f64")},
        **{f"bc_{dt}": [_P] * 6 + [_I] * 3 + [_D] * 3 + [_I] + [_D] * 6 + [_P]
           for dt in ("f32", "f64")}}),
    "gj_inverse": ("gj_inverse.cu", {
        "f32": [_P, _P, _I, _L, _P], "f64": [_P, _P, _I, _L, _P],
        "limits": [_I, _P, _P], "empty": [_P]}),
    "mlp_fused": ("mlp_fused.cu", {
        **{mode: [_P] * 11 + [_L] + [_I] * 7 + [_P]
           for mode in ("bf16", "f32", "f64")},
        "plan": [_I, _L] + [_I] * 5 + [_P] * 3}),
    "ell_matvec": ("ell_matvec.cu", [_P] * 5 + [_L, _I, _P]),
    "thermo7": ("thermo7.cu", [_P, _P, _L, _L] + [_P] * 4 + [_L] + [_I] * 3
                + [_D] * 3 + [_P]),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

launches = {name: 0 for name in _KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
# typed entry points by (kernel, suffix), each beside the library it came from
_fns: dict[tuple[str, str], tuple[ctypes.CDLL, object]] = {}
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


def ptxas_report(log: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, bytes of stack frame, bytes of spill stores,
    bytes of spill loads) of each entry function in nvcc's `-Xptxas -v`
    output, kernel names as ptxas prints them (mangled). A stack frame
    without spills is an array the kernel indexes at run time."""
    out, fn, spills = [], None, (0, 0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn, spills = m.group(1), (0, 0, 0)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            spills = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out.append((fn, int(m.group(1)), *spills))
            fn = None
    return out


def _function(name: str, suffix: str):
    """The C entry point `<name>_<suffix>` of a kernel's library, typed at
    its first call and cached (again after `_libs[name]` is replaced)."""
    hit = _fns.get((name, suffix))
    if hit is not None and hit[0] is _libs.get(name):
        return hit[1]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _so_path(name).exists():
                build()
            lib = _libs[name] = ctypes.CDLL(str(_so_path(name)))
        fn = getattr(lib, f"{name}_{suffix}")
        argtypes = _KERNELS[name][1]
        fn.argtypes = (argtypes[suffix] if isinstance(argtypes, dict)
                       else argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, suffix)] = (lib, fn)
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


def _launch(name: str, dtype: torch.dtype, device, *args,
            form: str = "") -> None:
    """Launch entry point `<name>_<form><type suffix>` and count it."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _function(name, form + _SUFFIX[dtype])(*args, stream)
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


@dataclasses.dataclass(frozen=True)
class GhostRule:
    """The homogeneous ghost relation of each axis of a field's BCs:
    `cyclic[ax]` (the neighbour wraps), else ghost = a[ax][0] * owner on the
    low side and a[ax][1] * owner on the high side."""
    cyclic: tuple[bool, bool, bool]
    a: tuple[tuple[float, float], ...]


def ghost_rule(bcs, mesh) -> GhostRule | None:
    """The GhostRule of a FieldBCs ((x_lo, x_hi), (y_lo, y_hi), (z_lo,
    z_hi)): pad_field's homogeneous relations (BC.coeffs(h, side)[0]). None
    where a side's factor is a tensor (an affine BC with a per-face a): that
    field takes the padded form. Processor boundaries raise: the kernel
    cannot see a neighbour shard's plane (helmholtz_operator pads them)."""
    cyclic, a = [], []
    for axis in range(3):
        lo, hi = bcs[axis]
        if lo.kind == "processor" or hi.kind == "processor":
            raise NotImplementedError("processor boundaries take the padded "
                                      "form (helmholtz_operator)")
        if lo.kind == "cyclic" or hi.kind == "cyclic":
            if lo.kind != hi.kind:
                raise ValueError("cyclic BC must be paired on both sides")
            cyclic.append(True)
            a.append((1.0, 1.0))
            continue
        h = mesh.spacing[axis]
        pair = (lo.coeffs(h, -1)[0], hi.coeffs(h, +1)[0])
        if not all(isinstance(v, numbers.Real) for v in pair):
            return None
        cyclic.append(False)
        a.append(tuple(float(v) for v in pair))
    return GhostRule(tuple(cyclic), tuple(a))


def helmholtz_apply_bc_plain(x, gamma, diag, spacing, rule: GhostRule):
    """Plain version of the BC form: each active axis's neighbours from x
    and the rule's ghosts, then the TPU kernel's body."""
    ih = _inv_h2(tuple(diag.shape), spacing)
    out = diag * x
    for ax in range(3):
        if ih[ax] == 0.0:
            continue
        n = x.shape[ax]
        first, last = x.narrow(ax, 0, 1), x.narrow(ax, n - 1, 1)
        if rule.cyclic[ax]:
            g_lo, g_hi = last, first
        else:
            g_lo, g_hi = rule.a[ax][0] * first, rule.a[ax][1] * last
        x_lo = torch.cat([g_lo, x.narrow(ax, 0, n - 1)], dim=ax)
        x_hi = torch.cat([x.narrow(ax, 1, n - 1), g_hi], dim=ax)
        g = gamma[ax]
        out = out - (g.narrow(ax, 1, n) * (x_hi - x)
                     - g.narrow(ax, 0, n) * (x - x_lo)) * ih[ax]
    return out


def helmholtz7_apply_bc(x, gamma, diag, spacing, rule: GhostRule):
    """helmholtz7_apply on the unpadded x (nx, ny, nz), the ghosts computed
    inside the kernel from `rule` (`ghost_rule` of the field's BCs): the
    same result as helmholtz7_apply(pad_field(x, bcs, mesh,
    homogeneous=True), gamma, diag, spacing) with no padded copy. Counts
    under launches["helmholtz7_apply"]."""
    if x.device.type == "cpu":
        return helmholtz_apply_bc_plain(x, gamma, diag, spacing, rule)
    ops = [x, gamma[0], gamma[1], gamma[2], diag]
    _check("helmholtz7_apply", ops)
    nx, ny, nz = diag.shape
    want = [(nx, ny, nz), (nx + 1, ny, nz), (nx, ny + 1, nz),
            (nx, ny, nz + 1), (nx, ny, nz)]
    if [tuple(t.shape) for t in ops] != want:
        raise ValueError(f"helmholtz7_apply_bc: shapes "
                         f"{[tuple(t.shape) for t in ops]}, expected {want}")
    out = torch.empty_like(diag)
    cyc_mask = sum(1 << ax for ax in range(3) if rule.cyclic[ax])
    _launch("helmholtz7_apply", diag.dtype, diag.device,
            *[t.data_ptr() for t in ops], out.data_ptr(), nx, ny, nz,
            *_inv_h2((nx, ny, nz), spacing), cyc_mask,
            *(v for pair in rule.a for v in pair), form="bc_")
    return out


def helmholtz_operator(bcs, mesh):
    """The Helmholtz matvec of a field with BCs `bcs` on `mesh`,
    homogeneous ghosts: (x, gamma, diag) -> out. The BC form with the BCs'
    ghost rule, built here once; where a side is a processor boundary (its
    ghosts are the neighbour shard's plane) or a BC's ghost factor is per
    face (no rule), pad_field and the padded form."""
    proc = any(bc.kind == "processor" for pair in bcs for bc in pair)
    rule = None if proc else ghost_rule(bcs, mesh)
    if rule is None:
        return lambda x, gamma, diag: helmholtz7_apply(
            pad_field(x, bcs, mesh, homogeneous=True), gamma, diag,
            mesh.spacing)
    return lambda x, gamma, diag: helmholtz7_apply_bc(x, gamma, diag,
                                                      mesh.spacing, rule)


# ------------------------------------------------------ Gauss-Jordan inverse

def gj_limits(dtype: torch.dtype) -> tuple[int, int]:
    """(largest n of the register kernel, largest n the library takes) for
    float32 or float64, as csrc/gj_inverse.cu decides them. Needs the built
    library (nvcc), so only where the kernels run."""
    reg, top = ctypes.c_int(), ctypes.c_int()
    err = _function("gj_inverse", "limits")(dtype.itemsize, ctypes.byref(reg),
                                            ctypes.byref(top))
    if err != 0:
        raise TypeError(f"gj_inverse: takes float32 or float64, got {dtype}")
    return reg.value, top.value


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
    W_t (n, n, L) -> (n, n, L), float32 or float64, any L, any n up to the
    library's limit (`gj_limits`). One launch: a register kernel for small
    n, above it a kernel with each lane's tableau spread over threads in
    register tiles (csrc/gj_inverse.cu)."""
    if W_t.device.type == "cpu":
        return gj_inverse_plain(W_t)
    _check("gj_inverse", [W_t])
    if W_t.dim() != 3 or W_t.shape[0] != W_t.shape[1]:
        raise ValueError(f"gj_inverse: expected (n, n, L), got {tuple(W_t.shape)}")
    n, _, L = W_t.shape
    top = gj_limits(W_t.dtype)[1]
    if n > top:
        raise ValueError(f"gj_inverse: n = {n} exceeds {top}, the largest n "
                         f"the library takes in {W_t.dtype}")
    out = torch.empty_like(W_t)
    if n == 0 or L == 0:
        return out
    _launch("gj_inverse", W_t.dtype, W_t.device, W_t.data_ptr(),
            out.data_ptr(), n, L)
    return out


# ------------------------------------------------------- fused DF-ODENet MLP

def mlp_plan(wdt: torch.dtype, B: int, S: int, K1: int, H1: int, H2: int,
             H3: int) -> tuple[int, int, int]:
    """The kernel's walk over B lanes in the mode of weight type `wdt`, as
    the kernel's library decides it: (lanes per chunk, CUDA launches per
    call, bytes of scratch). Raises ValueError for widths the mode does not
    take. Needs the built library (nvcc), so only where the kernels run."""
    chunk, n, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = _function("mlp_fused", "plan")(
        wdt.itemsize, B, S, K1, H1, H2, H3, ctypes.byref(chunk),
        ctypes.byref(n), ctypes.byref(nbytes))
    if err != 0:
        raise ValueError(f"mlp_fused: the {wdt} kernel does not take K1, "
                         f"H1, H2, H3 = {(K1, H1, H2, H3)} (S = {S}, B = {B}; "
                         f"see make_plan in csrc/mlp_fused.cu)")
    return chunk.value, n.value, nbytes.value


def mlp_pack(Ws):
    """The weights in the layout the kernel of their type reads, made once by
    the caller: bf16 keeps the logical shapes (S, in, out) but stores layers
    1 to 3 K-major (each W[s].T contiguous; the tensors are transposed views
    of that storage), the tensor cores' B operands; other types are made
    contiguous."""
    if Ws[0].dtype != torch.bfloat16 or len(Ws) != 4:
        return [W.contiguous() for W in Ws]
    return [*(W.transpose(1, 2).contiguous().transpose(1, 2) for W in Ws[:3]),
            Ws[3].contiguous()]


def _k_major(W) -> bool:
    return W.dim() == 3 and W.transpose(1, 2).is_contiguous()


def mlp_fused_plain(x, Ws, bs, chunk: int | None = None):
    """Plain version: x (B, F) through S stacked nets -> (B, S).

    Ws[0] (S, K1, H1) may carry zero rows past F (K padding); they are not
    used. With bf16 weights it rounds where the kernel does: x and W to bf16,
    products summed in f32, bias and GELU in f32, each hidden activation
    rounded to bf16; x and the result are f32. Otherwise everything is in x's
    type. Any strides (`mlp_pack`'s layout too). `chunk` lanes go through at
    a time, bounding the (S, chunk, H1) activations."""
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
    """S stacked four-layer GELU MLPs F -> H1 -> H2 -> H3 -> 1: x (B, F) ->
    (B, S), one wrapper call.

    Ws: [(S, K1, H1), (S, H1, H2), (S, H2, H3), (S, H3, 1)], K1 >= F (rows
    past F are zero padding), in `mlp_pack`'s layout; bs: [(S, H1), (S, H2),
    (S, H3), (S, 1)]. The weights' type picks the mode. Every mode takes the
    lanes in `mlp_plan`'s chunks, four launches each, and passes the hidden
    activations layer by layer through scratch in device memory of the
    plan's bytes, allocated here:
    - bfloat16: x and biases float32; layers 1 to 3 on the tensor cores,
      bf16 activations. Widths: K1, H1, H2 and H3 multiples of 16.
    - float32: x, biases and weights float32; tiled GEMMs on the CUDA cores,
      f32 activations. Any widths.
    - float64: the same in float64, the products of layers 2 and 3 on the
      FP64 tensor cores. Any widths.
    `chunk` only bounds the plain version's activations on the CPU."""
    if x.device.type == "cpu":
        return mlp_fused_plain(x, Ws, bs, chunk)
    wdt = Ws[0].dtype
    bf16 = wdt == torch.bfloat16
    if wdt not in _SUFFIX:
        raise TypeError(f"mlp_fused: weights must be bfloat16, float32 or "
                        f"float64, got {wdt}")
    xdt = torch.float32 if bf16 else wdt
    if len(Ws) != 4 or len(bs) != 4:
        raise ValueError("mlp_fused: takes exactly four layers")
    if bf16 and not all(_k_major(W) for W in Ws[:3]):
        raise ValueError("mlp_fused: bf16 layers 1 to 3 must be stored "
                         "K-major (pack the weights with mlp_pack)")
    ops = [x] + [t for Wb in zip(Ws, bs) for t in Wb]
    # the K-major layers are contiguous as their transposes
    storage = [W.transpose(1, 2) if bf16 and i < 3 else W
               for i, W in enumerate(Ws)]
    _check("mlp_fused", [x] + [t for Wb in zip(storage, bs) for t in Wb],
           [xdt] + [wdt, xdt] * 4)
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
    _, _, n_scratch = mlp_plan(wdt, B, S, K1, H1, H2, H3)
    out = torch.empty((B, S), dtype=xdt, device=x.device)
    if B == 0:
        return out
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=x.device)
    _launch("mlp_fused", wdt, x.device, *[t.data_ptr() for t in ops],
            out.data_ptr(), scratch.data_ptr(), n_scratch, B, F, K1, H1, H2,
            H3, S)
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


# ------------------------------------------------- NASA-7 Newton inversion

THERMO7_MAX_NS = 256      # csrc/thermo7.cu's kMaxNs: the table in shared memory


def thermo7(value, Y, T_guess, table, T_min: float, T_max: float, R: float,
            iters: int = 8, energy: bool = False, psi: bool = False):
    """T from the mixture's absolute enthalpy (or, with `energy`, internal
    energy) `value` and mass fractions Y: T_guess clamped to [T_min,
    T_max], then `iters` clamped Newton steps on the NASA-7 table `table`
    (`ThermoData.kernel_table`, (ns, 20)) with gas constant R; with `psi`
    also psi = W_mix / (R T). One launch, CUDA tensors only (ThermoData's
    `T_from_h` / `T_from_e` take the plain version on the CPU).

    value, T_guess: one batch shape; Y: that shape + (ns,), any strides,
    read in place where the batch axes collapse to one (the low-Mach
    solver's `movedim` view, a (cells, ns) block, a row expanded over
    cells). All of one type, float32 or float64. Returns T, or (T, psi)."""
    ns = table.shape[0]
    shape = value.shape
    if (T_guess.shape != shape or Y.shape != (*shape, ns)
            or table.shape != (ns, 20)):
        raise ValueError(f"thermo7: shapes value {tuple(shape)}, T_guess "
                         f"{tuple(T_guess.shape)}, Y {tuple(Y.shape)}, table "
                         f"{tuple(table.shape)}; expected (...), (...), "
                         f"(..., ns), (ns, 20)")
    if ns > THERMO7_MAX_NS:
        raise ValueError(f"thermo7: {ns} species exceed {THERMO7_MAX_NS}")
    v, tg = value.contiguous().reshape(-1), T_guess.contiguous().reshape(-1)
    y = Y.reshape(-1, ns)
    _check("thermo7", [v, tg, table])
    if y.device != v.device or y.dtype != v.dtype:
        raise ValueError(f"thermo7: Y on {y.device}/{y.dtype}, expected "
                         f"{v.device}/{v.dtype}")
    T = torch.empty_like(v)
    P = torch.empty_like(v) if psi else None
    if v.numel():
        _launch("thermo7", v.dtype, v.device, v.data_ptr(), y.data_ptr(),
                y.stride(0), y.stride(1), tg.data_ptr(), table.data_ptr(),
                T.data_ptr(), P.data_ptr() if psi else None, v.numel(), ns,
                iters, int(energy), T_min, T_max, R)
    return (T.reshape(shape), P.reshape(shape)) if psi else T.reshape(shape)
