"""The port's kernels: plain versions against the JAX Pallas kernels in
interpret mode (CPU, as tests/test_pallas_kernels.py runs them), and, on a
CUDA card only, the CUDA kernels against their plain versions.

JAX is imported inside the JAX tests only, so that the card's tests run on a
machine without JAX:
    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""
import ctypes

import numpy as np
import pytest
import torch

from deepflame_torch.ops import kernels as K

t = lambda a: torch.as_tensor(np.asarray(a))


def test_stencil_plain_matches_pallas():
    """Batched over S species via vmap on the JAX side, one call on the port
    side. float64: the same 13 operations per cell; 1e-13 of the largest
    output allows the summation order of the two implementations."""
    import jax
    from deepflame_tpu.ops.pallas_kernels import stencil_apply_tiled
    rng = np.random.default_rng(5)
    S, shape = 3, (16, 12, 8)
    x, D = (rng.normal(size=(S,) + shape) for _ in range(2))
    lo = tuple(rng.normal(size=(S,) + shape) for _ in range(3))
    hi = tuple(rng.normal(size=(S,) + shape) for _ in range(3))
    ref = jax.vmap(lambda x_, d_, l0, l1, l2, h0, h1, h2: stencil_apply_tiled(
        x_, d_, (l0, l1, l2), (h0, h1, h2), tx=4, interpret=True))(
        x, D, *lo, *hi)
    before = dict(K.launches)
    out = K.stencil7_apply(t(x), t(D), tuple(map(t, lo)), tuple(map(t, hi)))
    assert K.launches == before          # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13 * np.abs(np.asarray(ref)).max())


def _helmholtz_case(seed, n, bcs, lengths):
    import jax.numpy as jnp
    from deepflame_tpu.mesh import StructuredMesh, pad_field
    rng = np.random.default_rng(seed)
    mesh = StructuredMesh.box(lengths, [n, n, n])
    gamma = (rng.uniform(0.5, 2.0, (n + 1, n, n)),
             rng.uniform(0.5, 2.0, (n, n + 1, n)),
             rng.uniform(0.5, 2.0, (n, n, n + 1)))
    d = rng.uniform(0.1, 1.0, mesh.shape)
    xp = pad_field(jnp.asarray(rng.normal(size=mesh.shape)), bcs, mesh,
                   homogeneous=True)
    return mesh, xp, gamma, d


@pytest.mark.parametrize("variant", ["whole", "tiled"])
def test_helmholtz_plain_matches_pallas(variant):
    """One port kernel serves both TPU variants. float64, 1e-12 relative
    (the Pallas test's own tolerance against the FvMatrix reference)."""
    import jax.numpy as jnp
    from deepflame_tpu.mesh import cyclic, fixed_value, zero_gradient
    from deepflame_tpu.ops.pallas_kernels import (helmholtz_apply,
                                                  helmholtz_apply_tiled)
    bcs = ((fixed_value(0.3), zero_gradient()), (cyclic(), cyclic()),
           (zero_gradient(), fixed_value(1.2)))
    mesh, xp, gamma, d = _helmholtz_case(2, 16, bcs, [1.0, 0.5, 0.25])
    if variant == "whole":
        ref = helmholtz_apply(xp, tuple(map(jnp.asarray, gamma)),
                              jnp.asarray(d), mesh.spacing, interpret=True)
    else:
        ref = helmholtz_apply_tiled(xp, tuple(map(jnp.asarray, gamma)),
                                    jnp.asarray(d), mesh.spacing, tx=4,
                                    interpret=True)
    out = K.helmholtz7_apply(t(xp), tuple(map(t, gamma)), t(d), mesh.spacing)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_helmholtz_plain_skips_size_one_axis():
    """2D field (nz = 1, empty z): the z term is skipped as in the TPU
    kernel."""
    import jax.numpy as jnp
    from deepflame_tpu.mesh import StructuredMesh, cyclic, empty, pad_field
    from deepflame_tpu.ops.pallas_kernels import helmholtz_apply
    rng = np.random.default_rng(1)
    n = 12
    mesh = StructuredMesh.box([1.0, 1.0, 1.0 / n], [n, n, 1])
    bcs = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    gamma = (rng.uniform(0.5, 2.0, (n + 1, n, 1)),
             rng.uniform(0.5, 2.0, (n, n + 1, 1)), np.ones((n, n, 2)))
    d = rng.uniform(0.1, 1.0, mesh.shape)
    xp = pad_field(jnp.asarray(rng.normal(size=mesh.shape)), bcs, mesh,
                   homogeneous=True)
    ref = helmholtz_apply(xp, tuple(map(jnp.asarray, gamma)), jnp.asarray(d),
                          mesh.spacing, interpret=True)
    out = K.helmholtz7_apply(t(xp), tuple(map(t, gamma)), t(d), mesh.spacing)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_entry_points_are_typed_once(monkeypatch):
    """kernels._function looks an entry point up and types it once per
    (kernel, suffix), and again after the library is replaced (as the
    ablation tools replace it). A stand-in library counts the lookups."""
    class Lib:
        def __init__(self):
            self.lookups = 0

        def __getattr__(self, name):
            if not name.startswith("helmholtz7_apply_"):
                raise AttributeError(name)
            self.lookups += 1
            return type("Fn", (), {})()

    lib = Lib()
    monkeypatch.setitem(K._libs, "helmholtz7_apply", lib)
    monkeypatch.setattr(K, "_fns", {})
    fn = K._function("helmholtz7_apply", "bc_f32")
    assert K._function("helmholtz7_apply", "bc_f32") is fn
    assert lib.lookups == 1
    assert len(fn.argtypes) == 20 and fn.restype is ctypes.c_int
    assert K._function("helmholtz7_apply", "f64") is not fn
    assert len(K._function("helmholtz7_apply", "f64").argtypes) == 13
    assert lib.lookups == 2
    other = Lib()
    monkeypatch.setitem(K._libs, "helmholtz7_apply", other)
    assert K._function("helmholtz7_apply", "bc_f32") is not fn
    assert other.lookups == 1


def test_ell_plain_matches_pallas():
    """ell_matvec's plain version (what CPU tensors take) against the Pallas
    kernel in interpret mode, on random operands with pad slots, float64,
    1e-13 of the largest |out| (the order of the six-term row sums)."""
    from deepflame_tpu.ops.pallas_kernels import ell_matvec
    x, diag, nbr, coef = _ell_operands("cpu", torch.float64, n=3000)
    ref = ell_matvec(x.numpy(), diag.numpy(), nbr.numpy(), coef.numpy(),
                     block=256, interpret=True)
    before = dict(K.launches)
    out = K.ell_matvec(x, diag, nbr, coef)
    assert K.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("dtype,tol,n", [
    pytest.param(dtype, tol, n, id=f"{dtype.__name__}-{tol:g}"
                 + ("" if n == 10 else f"-n{n}"))       # n = 10: the old ids
    for dtype, tol in ((np.float32, 2e-5), (np.float64, 1e-12))
    for n in (2, 10, 54)])
def test_gj_plain_matches_pallas(dtype, tol, n):
    """Lanes-last Gauss-Jordan inverse; float32 at the Pallas test's 2e-5,
    float64 at 1e-12 (the f64 path the TPU never compiled). n = 10 is the
    test mechanism's W, n = 54 gri30's. The random part of W is scaled by
    sqrt(10 / n), so W = 5 I + N stays as well conditioned at every n: the
    unpivoted elimination is meant for matrices near I, like I - gamma dt J."""
    import jax.numpy as jnp
    from deepflame_tpu.ops.pallas_kernels import gj_inverse_lanes
    rng = np.random.default_rng(3)
    L = 512
    W = (np.sqrt(10.0 / n) * rng.normal(size=(n, n, L))
         + 5.0 * np.eye(n)[:, :, None]).astype(dtype)
    ref = gj_inverse_lanes(jnp.asarray(W), block=256, interpret=True)
    out = K.gj_inverse(torch.as_tensor(W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    # and it inverts
    eye = np.einsum("ijl,jkl->ikl", W.astype(np.float64),
                    out.numpy().astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(n)[:, :, None],
                                                    (n, n, L)),
                               atol=5e-3 if dtype == np.float32 else 1e-10)


# ------------------------------------------------- CUDA kernels (card only)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stencil_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (9, 24, 20, 16)
    x, D, *c = (torch.randn(shape, generator=g, device=cuda, dtype=dtype)
                for _ in range(8))
    before = K.launches["stencil7_apply"]
    out = K.stencil7_apply(x, D, tuple(c[:3]), tuple(c[3:]))
    torch.cuda.synchronize()
    assert K.launches["stencil7_apply"] == before + 1
    ref = K.stencil_apply_plain(x, D, tuple(c[:3]), tuple(c[3:]))
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_helmholtz_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    nx, ny, nz = 24, 20, 16
    r = lambda *s: torch.rand(s, generator=g, device=cuda, dtype=dtype)
    xp = r(nx + 2, ny + 2, nz + 2)
    gam = (r(nx + 1, ny, nz), r(nx, ny + 1, nz), r(nx, ny, nz + 1))
    d = r(nx, ny, nz)
    sp = (1e-3, 2e-3, 3e-3)
    out = K.helmholtz7_apply(xp, gam, d, sp)
    ref = K.helmholtz_apply_plain(xp, gam, d, sp)
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.helmholtz7_apply(xp, gam, d[:, :, :-1], sp)


# ghost rules of the BC form: cyclic axes, and ghost = a * owner per side
_RULES = {
    "jet": K.GhostRule((False, False, False),
                       ((1.0, -1.0), (1.0, 1.0), (1.0, 1.0))),
    "mixed": K.GhostRule((False, True, False),
                         ((-1.0, 1.0), (1.0, 1.0), (1.0, -1.0))),
    "cyclic": K.GhostRule((True, True, True), ((1.0, 1.0),) * 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("rule", list(_RULES))
@pytest.mark.parametrize("shape", [(24, 20, 16), (7, 5, 3), (33, 17, 1),
                                   (9, 1, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_helmholtz_bc_matches_plain(cuda, dtype, shape, rule):
    """The BC form against its plain version at odd sizes, a 2D grid and a
    grid with an axis of one cell, f32 within 1e-5 and f64 within 1e-13 of
    the largest |out|; one launch, counted under helmholtz7_apply."""
    g = torch.Generator(device=cuda).manual_seed(2)
    nx, ny, nz = shape
    r = lambda *s: torch.rand(s, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    gam = (r(nx + 1, ny, nz), r(nx, ny + 1, nz), r(nx, ny, nz + 1))
    d = r(nx, ny, nz)
    sp = (1e-3, 2e-3, 3e-3)
    before = K.launches["helmholtz7_apply"]
    out = K.helmholtz7_apply_bc(x, gam, d, sp, _RULES[rule])
    torch.cuda.synchronize()
    assert K.launches["helmholtz7_apply"] == before + 1
    ref = K.helmholtz_apply_bc_plain(x, gam, d, sp, _RULES[rule])
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.helmholtz7_apply_bc(x, gam, d[:, :, :-1], sp, _RULES[rule])


def _near_identity(n, L, dtype, device, seed):
    """W = I + 0.1 sqrt(10 / n) N(0, 1): conditioned alike at every n, like
    I - gamma dt J at the step sizes the controller accepts."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.eye(n, device=device, dtype=torch.float64)[:, :, None]
            + (0.1 * (10.0 / n) ** 0.5) * torch.randn(
                (n, n, L), generator=g, device=device,
                dtype=torch.float64)).to(dtype)


# (n, L): "reg" is the register kernel's largest n, "reg+1" the register-
# tile kernel's smallest, "limit" the largest the library takes (read from
# the library)
_GJ_CASES = ([(n, L) for n in (1, 2, 10, "reg", "reg+1", 43, 54)
              for L in (1, 1000, 4096)]
             + [(128, 1), (128, 256), ("limit", 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("n,L", _GJ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gj_matches_plain(cuda, dtype, n, L):
    """The Gauss-Jordan kernels against the plain version at every size
    class, L = 1 and L not a multiple of any block; tolerance relative to
    the largest entry, f32 1e-4 and f64 1e-10 (sums in another order)."""
    reg, top = K.gj_limits(dtype)
    n = {"reg": reg, "reg+1": reg + 1, "limit": top}.get(n, n)
    W = _near_identity(n, L, dtype, cuda, seed=2)
    out = K.gj_inverse(W)
    ref = K.gj_inverse_plain(W)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gj_launches_and_limit(cuda, dtype):
    """One launch per call in either kernel; a raise only past the
    library's limit (at least 128), and on operands the kernel does not
    take; L = 0 launches nothing."""
    reg, top = K.gj_limits(dtype)
    assert 1 <= reg < top and top >= 128
    for n in (reg, reg + 1, top):
        W = _near_identity(n, 33, dtype, cuda, seed=3)
        before = K.launches["gj_inverse"]
        K.gj_inverse(W)
        torch.cuda.synchronize()
        assert K.launches["gj_inverse"] == before + 1
    before = K.launches["gj_inverse"]
    assert K.gj_inverse(torch.zeros((10, 10, 0), device=cuda,
                                    dtype=dtype)).shape == (10, 10, 0)
    assert K.launches["gj_inverse"] == before
    with pytest.raises(ValueError, match=str(top)):
        K.gj_inverse(torch.zeros((top + 1, top + 1, 4), device=cuda,
                                 dtype=dtype))
    with pytest.raises(ValueError):
        K.gj_inverse(W.transpose(0, 1))      # not contiguous


@pytest.mark.gpu
@pytest.mark.parametrize("n", ["reg", 54])
def test_cuda_gj_zero_row_f64(cuda, n):
    """float64, one lane's W with a zero row: its row scale and its pivot
    both reach the 1e-30 guards. Kernel and plain version agree to 1e-10
    of the largest entry, and the values stay finite, near 1e60."""
    n = K.gj_limits(torch.float64)[0] if n == "reg" else n
    W = _near_identity(n, 100, torch.float64, cuda, seed=4)
    W[3, :, 7] = 0.0
    out = K.gj_inverse(W)
    ref = K.gj_inverse_plain(W)
    assert bool(torch.isfinite(out).all())
    big = float(ref.abs().max())
    assert 1e59 <= big <= 1e62
    assert float((out - ref).abs().max()) <= 1e-10 * big


def _ell_operands(device, dtype, n=50_000, seed=4):
    """A random 3D-like ELL matrix: 6 slots per row, every fifth slot a pad
    pointing at the row itself with coefficient 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    nbr = torch.randint(0, n, (n, 6), generator=g, device=device,
                        dtype=torch.int32)
    coef = torch.randn((n, 6), generator=g, device=device, dtype=dtype)
    pad = torch.rand((n, 6), generator=g, device=device) < 0.2
    rows = torch.arange(n, device=device, dtype=torch.int32)[:, None]
    nbr = torch.where(pad, rows.expand(n, 6), nbr).contiguous()
    coef = torch.where(pad, torch.zeros_like(coef), coef)
    x, diag = (torch.randn(n, generator=g, device=device, dtype=dtype)
               for _ in range(2))
    return x, diag, nbr, coef


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-14)])
def test_cuda_ell_matvec_matches_plain(cuda, dtype, tol):
    """The ELL SpMV kernel against its plain version, relative to the
    largest |out|; it launches once per call and raises on operands it does
    not take."""
    x, diag, nbr, coef = _ell_operands(cuda, dtype)
    before = K.launches["ell_matvec"]
    out = K.ell_matvec(x, diag, nbr, coef)
    torch.cuda.synchronize()
    assert K.launches["ell_matvec"] == before + 1
    ref = K.ell_matvec_plain(x, diag, nbr, coef)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.ell_matvec(x, diag, nbr.long(), coef)          # int64 indices
    with pytest.raises(ValueError):
        K.ell_matvec(x, diag, nbr.t(), coef)             # not contiguous
    with pytest.raises(ValueError):
        K.ell_matvec(x[:-1], diag, nbr, coef)            # shapes


def _mlp_operands(device, wdt, S=8, F=11, hidden=(1600, 800, 400), B=3000,
                  seed=3):
    """Seeded operands of mlp_fused at the DNN path's widths: He-scaled
    weights (first layer padded with zero rows to 16), small biases, x of
    unit scale; B not a multiple of any block. A width may be 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    xdt = torch.float32 if wdt == torch.bfloat16 else wdt
    sizes = (F,) + tuple(hidden) + (1,)
    Ws, bs = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        W = torch.randn((S, a, b), generator=g, device=device,
                        dtype=torch.float64) * (2.0 / max(a, 1)) ** 0.5
        if i == 0:
            W = torch.nn.functional.pad(W, (0, 0, 0, (-a) % 16))
        Ws.append(W.to(wdt).contiguous())
        bs.append((0.1 * torch.randn((S, b), generator=g, device=device,
                                     dtype=torch.float64)).to(xdt))
    x = torch.randn((B, F), generator=g, device=device, dtype=torch.float64)
    return x.to(xdt), Ws, bs


# lanes of one wrapper chunk at S = 8, per mode (test_cuda_mlp_plan checks
# them)
_CHUNK8 = 65536
_CHUNK8_F32, _CHUNK8_F64 = 32768, 16384


@pytest.mark.gpu
def test_cuda_mlp_plan_chunks_and_scratch(cuda):
    """The kernel's walk over the lanes, as its library plans it: chunks of
    2^20 / (bytes of a value) lanes x species cut to the 128-lane tile,
    fewer when B is small; four launches a chunk; one chunk's h1 and h2 in
    the mode's type (f32 and f64 rows padded to 4 values) and layer 4's
    partials (bf16: f32, one per 40 columns; f32: one per 128; f64: one per
    32; a ragged last one included). bf16 widths that are not multiples of
    16 raise, and in every mode a width below 1."""
    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    per_lane = 2400 * 2 + 10 * 4
    args = (8, 16, 1600, 800, 400)
    assert K.mlp_plan(bf, 1 << 30, *args)[0] == _CHUNK8
    assert K.mlp_plan(bf, 884_736, *args) == (65536, 4 * 14,
                                              8 * 65536 * per_lane)
    assert K.mlp_plan(bf, _CHUNK8 + 37, *args)[:2] == (65536, 8)
    chunk, n, scratch = K.mlp_plan(bf, 10 ** 6, 20, 32, 1600, 800, 400)
    assert (chunk, n) == (26112, 4 * 39) and chunk % 128 == 0
    assert scratch == 20 * 26112 * per_lane <= 2.6e9
    assert K.mlp_plan(bf, 5, *args) == (128, 4, 8 * 128 * per_lane)
    assert K.mlp_plan(bf, 0, *args)[1] == 0
    # H3 = 48: two partial sums a lane, the second over 8 columns
    assert K.mlp_plan(bf, 5, 1, 16, 64, 32, 48) == (128, 4,
                                                     128 * (96 * 2 + 2 * 4))
    for widths in ((16, 1600, 800, 420), (8, 1600, 800, 400)):
        with pytest.raises(ValueError):
            K.mlp_plan(bf, 5, 8, *widths)
    # f32: 9.6 KB of activations and 4 partials a lane, 2.52 GB a chunk
    per_lane = 2400 * 4 + 4 * 4
    assert K.mlp_plan(f32, 1 << 30, *args)[0] == _CHUNK8_F32
    assert K.mlp_plan(f32, 884_736, *args) == (
        32768, 4 * 27, 8 * 32768 * per_lane)
    assert K.mlp_plan(f32, _CHUNK8_F32 + 37, *args)[:2] == (32768, 8)
    assert K.mlp_plan(f32, 10 ** 6, 20, 32, 1600, 800, 400)[:2] == (
        13056, 4 * 77)
    assert K.mlp_plan(f32, 5, *args) == (128, 4, 8 * 128 * per_lane)
    assert K.mlp_plan(f32, 0, *args)[1] == 0
    # f64: 19.2 KB and 13 partials a lane
    per_lane = 2400 * 8 + 13 * 8
    assert K.mlp_plan(f64, 1 << 30, *args)[0] == _CHUNK8_F64
    assert K.mlp_plan(f64, 1 << 12, *args) == (4096, 4, 8 * 4096 * per_lane)
    assert K.mlp_plan(f64, 884_736, *args)[:2] == (16384, 4 * 54)
    # any width: rows of 5 and 3 values padded to 8 and 4 (256-byte aligned
    # blocks of 128 lanes), one partial of 2 columns
    assert K.mlp_plan(f32, 5, 1, 11, 5, 3, 2) == (128, 4,
                                                   128 * (8 + 4 + 1) * 4)
    assert K.mlp_plan(f64, 5, 1, 11, 5, 3, 2) == (128, 4,
                                                   128 * (8 + 4 + 1) * 8)
    for wdt in (f32, f64):
        with pytest.raises(ValueError):
            K.mlp_plan(wdt, 5, 8, 16, 1600, 800, 0)


def test_mlp_pack_layout():
    """bf16 layers 1 to 3 keep their (S, in, out) shapes and values over
    K-major storage; float32 weights stay row-major."""
    g = torch.Generator().manual_seed(0)
    Ws = [torch.randn(s, generator=g).to(torch.bfloat16)
          for s in ((3, 16, 32), (3, 32, 48), (3, 48, 8), (3, 8, 1))]
    packed = K.mlp_pack(Ws)
    for i, (W, P) in enumerate(zip(Ws, packed)):
        assert P.shape == W.shape and torch.equal(P, W)
        assert P.is_contiguous() == (i == 3)
        assert i == 3 or P.transpose(1, 2).is_contiguous()
    assert all(P.is_contiguous() for P in K.mlp_pack([W.float() for W in Ws]))


_FULL = (1600, 800, 400)


@pytest.mark.gpu
@pytest.mark.parametrize("wdt,tol,S,F,hidden,B", [
    (torch.bfloat16, 2e-3, 8, 11, _FULL, 3000),
    (torch.bfloat16, 2e-3, 8, 11, _FULL, 5),            # under one lane tile
    (torch.bfloat16, 2e-3, 8, 11, _FULL, _CHUNK8 + 37),  # two chunks, ragged
    (torch.bfloat16, 2e-3, 20, 23, _FULL, 3000),        # drm19's species count
    (torch.bfloat16, 2e-3, 8, 11, _FULL, 0),
    (torch.bfloat16, 2e-3, 8, 11, (64, 32, 16), 3000),  # the CPU tests' widths
    (torch.bfloat16, 2e-3, 4, 67, _FULL, 3000),         # 65 species: K1 = 80
    # ragged tiles: H1 % 32 = 16, a second 200-column tile of 8 columns, a
    # last layer-4 partial of 8 columns
    (torch.bfloat16, 2e-3, 3, 23, (240, 208, 48), 1000),
    (torch.float32, 1e-5, 8, 11, _FULL, 3000),
    (torch.float64, 1e-12, 8, 11, _FULL, 3000),
    # the f32 and f64 modes at the bf16 cases' shapes
    *((wdt, tol, S, F, hidden, B)
      for wdt, tol, chunk in ((torch.float32, 1e-5, _CHUNK8_F32),
                              (torch.float64, 1e-12, _CHUNK8_F64))
      for S, F, hidden, B in (
          (8, 11, _FULL, 5), (8, 11, _FULL, chunk + 37),
          (20, 23, _FULL, 3000), (8, 11, _FULL, 0),
          (8, 11, (64, 32, 16), 3000), (4, 67, _FULL, 3000),
          (3, 23, (240, 208, 48), 1000),
          # wider than blocks that kept a lane's activations in shared
          # memory could take
          (2, 11, (4096, 1024, 16), 300),
          # widths that are no multiple of 4 (rows of h1 and h2 padded,
          # weights read a value at a time), a last 128-column tile of 1
          (3, 11, (129, 37, 5), 700)))])
def test_cuda_mlp_fused_matches_plain(cuda, wdt, tol, S, F, hidden, B):
    """The fused MLP kernel against its plain version on the card, relative
    to the largest |out|: bf16 2e-3 (a sum in another order can move one
    bf16 rounding of an activation), f32 1e-5, f64 1e-12. One count per call
    that launches; B = 0 gives an empty result. Widths a mode does not take
    raise: bf16 no multiple of 16, any mode a layer of width 0."""
    x, Ws, bs = _mlp_operands(cuda, wdt, S=S, F=F, hidden=hidden, B=B)
    Ws = K.mlp_pack(Ws)
    before = K.launches["mlp_fused"]
    out = K.mlp_fused(x, Ws, bs)
    torch.cuda.synchronize()
    assert K.launches["mlp_fused"] == before + (B > 0)
    ref = K.mlp_fused_plain(x, Ws, bs, chunk=1 << 15)
    assert out.shape == (B, S) and out.dtype == ref.dtype
    if B:
        assert bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.mlp_fused(x, Ws[:3], bs[:3])               # not four layers
    with pytest.raises(ValueError):
        K.mlp_fused(x.double() if wdt != torch.float64 else x.float(), Ws, bs)
    with pytest.raises(ValueError):                  # widths it does not take
        K.mlp_fused(*_mlp_operands(cuda, wdt, B=4, hidden=(
            (1600, 800, 420) if wdt == torch.bfloat16 else (1600, 800, 0))))
    if wdt == torch.bfloat16:
        with pytest.raises(ValueError):              # not packed K-major
            K.mlp_fused(x, [W.contiguous() for W in Ws], bs)
