"""The port's kernels: plain versions against the JAX Pallas kernels in
interpret mode (CPU, as tests/test_pallas_kernels.py runs them), and, on a
CUDA card only, the CUDA kernels against their plain versions.

JAX is imported inside the JAX tests only, so that the card's tests run on a
machine without JAX:
    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""
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


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), (np.float64, 1e-12)])
def test_gj_plain_matches_pallas(dtype, tol):
    """Lanes-last Gauss-Jordan inverse; float32 at the Pallas test's 2e-5,
    float64 at 1e-12 (the f64 path the TPU never compiled)."""
    import jax.numpy as jnp
    from deepflame_tpu.ops.pallas_kernels import gj_inverse_lanes
    rng = np.random.default_rng(3)
    L, n = 512, 10
    W = (rng.normal(size=(n, n, L)) + 5.0 * np.eye(n)[:, :, None]).astype(dtype)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gj_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    n, L = 10, 1000                        # L not a multiple of the block
    W = (torch.eye(n, device=cuda, dtype=dtype)[:, :, None]
         + 0.1 * torch.randn((n, n, L), generator=g, device=cuda, dtype=dtype))
    out = K.gj_inverse(W)
    ref = K.gj_inverse_plain(W)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.gj_inverse(W.transpose(0, 1))      # not contiguous
    too_big = 43 if dtype == torch.float32 else 30
    with pytest.raises(ValueError):
        K.gj_inverse(torch.zeros((too_big, too_big, 4), device=cuda,
                                 dtype=dtype))


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
    unit scale; B not a multiple of any block."""
    g = torch.Generator(device=device).manual_seed(seed)
    xdt = torch.float32 if wdt == torch.bfloat16 else wdt
    sizes = (F,) + tuple(hidden) + (1,)
    Ws, bs = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        W = torch.randn((S, a, b), generator=g, device=device,
                        dtype=torch.float64) * (2.0 / a) ** 0.5
        if i == 0:
            W = torch.nn.functional.pad(W, (0, 0, 0, (-a) % 16))
        Ws.append(W.to(wdt).contiguous())
        bs.append((0.1 * torch.randn((S, b), generator=g, device=device,
                                     dtype=torch.float64)).to(xdt))
    x = torch.randn((B, F), generator=g, device=device, dtype=torch.float64)
    return x.to(xdt), Ws, bs


@pytest.mark.gpu
@pytest.mark.parametrize("wdt,tol", [(torch.bfloat16, 2e-3),
                                     (torch.float32, 1e-5),
                                     (torch.float64, 1e-12)])
def test_cuda_mlp_fused_matches_plain(cuda, wdt, tol):
    """The fused MLP kernel at full widths against its plain version on the
    card, relative to the largest |out|: bf16 2e-3 (a sum in another order
    can move one bf16 rounding of an activation), f32 1e-5, f64 1e-12."""
    x, Ws, bs = _mlp_operands(cuda, wdt)
    before = K.launches["mlp_fused"]
    out = K.mlp_fused(x, Ws, bs)
    torch.cuda.synchronize()
    assert K.launches["mlp_fused"] == before + 1
    ref = K.mlp_fused_plain(x, Ws, bs)
    assert out.shape == (3000, 8) and out.dtype == ref.dtype
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError):
        K.mlp_fused(x, Ws[:3], bs[:3])               # not four layers
    with pytest.raises(ValueError):
        K.mlp_fused(x.double() if wdt != torch.float64 else x.float(), Ws, bs)
    with pytest.raises(ValueError):                  # too wide for one block
        K.mlp_fused(*_mlp_operands(cuda, wdt, hidden=(4096, 1024, 16), B=4))
