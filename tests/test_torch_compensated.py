"""The port's compensated float32 reductions (ops/compensated.py) and the
`compensated()` context (parallel/context.py) against float64 references
and the JAX package, with tests/test_compensated.py's bounds: 1e-7 of the
sum of magnitudes at 2^20 (sum2) and 2^19 (dot2) float32 values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.ops.compensated import sum2 as j_sum2
from deepflame_tpu.ops.linsolve import cg as j_cg
from deepflame_tpu.parallel.context import compensated as j_compensated

from deepflame_torch.ops import linsolve
from deepflame_torch.ops.compensated import dot2, sum2, two_sum
from deepflame_torch.parallel.context import compensated, gmean, gsum


def _ill_conditioned(n, seed=0):
    rng = np.random.default_rng(seed)
    x64 = rng.normal(size=n // 2) * np.exp(rng.uniform(0, 10, size=n // 2))
    x64 = np.concatenate([x64, -x64 * (1 + 1e-9)])   # heavy cancellation
    rng.shuffle(x64)
    return x64


@pytest.mark.parametrize("lanes", [1, 3])
def test_sum2_matches_f64_on_ill_conditioned_data(lanes):
    """2^20 float32 values per lane with heavy cancellation: within 1e-7 of
    the sum of magnitudes of the float64 sum of the same float32 values,
    per lane (nd=1) as for the whole array, as the JAX package's sum2 is."""
    n = 1 << 20
    x32 = np.stack([_ill_conditioned(n, s) for s in range(lanes)]
                   ).astype(np.float32)
    ref = x32.astype(np.float64).sum(1)
    scale = np.abs(x32.astype(np.float64)).sum(1)
    comp = sum2(torch.as_tensor(x32), nd=1).double().numpy()
    assert np.all(np.abs(comp - ref) / scale < 1e-7)
    whole = float(sum2(torch.as_tensor(x32[0])))
    assert abs(whole - ref[0]) / scale[0] < 1e-7
    assert abs(float(jax.jit(j_sum2)(jnp.asarray(x32[0]))) - ref[0]) \
        / scale[0] < 1e-7


def test_sum2_recovers_what_float32_loses():
    """Block sums that cancel around small ones: 4,096 values of 1e10, then
    254 blocks of ones, then 4,096 of -1e10. A float32 sum loses the ones
    to the large partial sums; the compensated combination keeps them
    exactly."""
    x = np.concatenate([np.full(4096, 1e10), np.ones(254 * 4096),
                        np.full(4096, -1e10)]).astype(np.float32)
    ref = x.astype(np.float64).sum()
    assert ref == 254 * 4096
    assert float(sum2(torch.as_tensor(x))) == ref
    assert abs(float(torch.as_tensor(x).sum()) - ref) > 1e3


def test_dot2_krylov_style():
    rng = np.random.default_rng(1)
    n = 1 << 19
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    ref = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    comp = float(dot2(torch.as_tensor(a), torch.as_tensor(b)))
    scale = float(np.dot(np.abs(a.astype(np.float64)),
                         np.abs(b.astype(np.float64))))
    assert abs(comp - ref) / scale < 1e-7


def test_two_sum_recovers_error():
    s, err = two_sum(torch.tensor(1.0, dtype=torch.float32),
                     torch.tensor(1e-8, dtype=torch.float32))
    assert float(s.double() + err.double()) == pytest.approx(
        1.0 + 1e-8, abs=1e-18)


def test_context_routes_gsum_and_the_krylov_reductions():
    """gsum and gmean take sum2 inside `compensated()` and the plain sums
    outside it; the CG on a float32 Poisson problem then takes the JAX
    package's compensated iteration count and solution (the same per-lane
    sums as JAX's whole-array ones on one lane)."""
    x = torch.as_tensor(np.random.default_rng(2).normal(size=4096),
                        dtype=torch.float32)
    calls = []
    orig = linsolve.sum2
    with compensated():
        comp, mean = float(gsum(x)), float(gmean(x))
        linsolve.sum2 = lambda *a, **k: calls.append(1) or orig(*a, **k)
        try:
            n = 32
            rng = np.random.default_rng(3)
            b = rng.normal(size=(n, n, n)).astype(np.float32)
            lap = lambda u, roll: 6.5 * u - sum(
                roll(u, s, a) for a in range(3) for s in (1, -1))
            rt = linsolve.cg(lambda u: lap(u, lambda v, s, a: torch.roll(
                v, s, a)), torch.as_tensor(b), torch.zeros(n, n, n),
                tol=0.0, rel_tol=1e-5, max_iter=100)
        finally:
            linsolve.sum2 = orig
    assert calls
    with j_compensated():
        rj = jax.jit(lambda b_: j_cg(
            lambda u: lap(u, lambda v, s, a: jnp.roll(v, s, a)), b_,
            jnp.zeros_like(b_), tol=0.0, rel_tol=1e-5, max_iter=100))(
                jnp.asarray(b))
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(rj.x)).max())
    plain = float(gsum(x))
    assert np.isfinite(plain) and np.isfinite(comp)
    assert abs(plain - comp) / (abs(plain) + 1e-30) < 1e-4
    assert mean == pytest.approx(comp / 4096, rel=1e-6)
