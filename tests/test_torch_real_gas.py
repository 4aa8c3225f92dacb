"""The port's Peng-Robinson real-gas thermo (chemistry/real_gas.py) against
the JAX package's (float64, CPU).

rho, psi with and without p, Z and h_departure on the 9-species test
mechanism (H2, O2, N2 and H2O have critical data; the radicals stay ideal)
and on inert air, from 1 to 20 MPa and 150 to 2500 K: within 1e-11 of each
value (h_departure, which changes sign, of the largest). Where the
discriminant is near zero the Cardano sum u + w cancels and amplifies the
last-place differences of the two cube roots (sign(x) |x|^(1/3) against
jnp.cbrt, whose XLA code has differed between a fresh and a cached
compile) to about 1e-12; most values agree to 1e-15. The cube root (PyTorch
has none; sign(x) |x|^(1/3)) is held to jnp.cbrt within 1e-13 relative;
both branches of the Cardano solve are reached. The float32 floor of p,
-1e-300, rounds to -0.0 in both packages; a triple root gives NaN in both.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
from deepflame_tpu.chemistry import real_gas as jrg

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry import real_gas as trg

DATA = os.path.join(os.path.dirname(__file__), "data")


def _rel_each(a, b):
    a = np.asarray(a)
    return (np.abs(a - b.numpy()) / np.maximum(np.abs(a), 1e-300)).max()


@pytest.mark.parametrize("mech_file", ["h2_air_9sp.json", "air.yaml"])
def test_real_gas_matches_jax(mech_file):
    mj = jc.load_mechanism(os.path.join(DATA, mech_file))
    mt = tc.load_mechanism(os.path.join(DATA, mech_file), device="cpu")
    rj = jrg.make_real_gas(mj, jc.make_thermo(mj))
    rt = trg.make_real_gas(mt, tc.make_thermo(mt))
    for k in ("a_c", "b_i", "kappa", "Tc"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, k)),
                                      getattr(rt, k).numpy())
    rng = np.random.default_rng(5)
    n, ns = 400, mt.n_species
    T = rng.uniform(150.0, 2500.0, n)
    p = rng.uniform(1e6, 2e7, n)
    Y = rng.uniform(0.0, 1.0, (n, ns))
    Y /= Y.sum(1, keepdims=True)
    J = [jnp.asarray(x) for x in (p, T, Y)]
    P = [torch.as_tensor(x) for x in (p, T, Y)]
    for name in ("rho", "Z"):
        assert _rel_each(getattr(rj, name)(*J), getattr(rt, name)(*P)) \
            <= 1e-11, name
    # the departure changes sign across the states: held to its largest
    a, b = rj.h_departure(*J), rt.h_departure(*P).numpy()
    assert np.abs(np.asarray(a) - b).max() <= 1e-11 * np.abs(b).max()
    assert _rel_each(rj.psi(J[1], J[2], p=J[0]),
                     rt.psi(P[1], P[2], p=P[0])) <= 1e-11
    assert _rel_each(rj.psi(J[1], J[2]), rt.psi(P[1], P[2])) <= 1e-14
    # caloric properties delegate to the ideal tables
    assert torch.equal(rt.h_mass(P[1], P[2]), rt.ideal.h_mass(P[1], P[2]))
    assert float((rt.Z(*P) - 1.0).abs().max()) > 1e-2   # non-ideal here


def test_cubic_roots_both_branches():
    """The largest real root of random cubics with one and three real
    roots, against the JAX package and numpy.roots. Cubics with a double
    root at 0 below a simple negative root are held to the JAX package
    only: there the discriminant is round-off, and both packages return
    for some of them another value than the double root (the Cardano
    branch's simple root where it comes out positive): a fault of the JAX
    function that the port reproduces."""
    rng = np.random.default_rng(8)
    r = rng.uniform(-2.0, 2.0, (3, 300))
    r[1:, 150:] = 0.0                                  # a double root at 0
    three = (-(r[0] + r[1] + r[2]), r[0] * r[1] + r[1] * r[2] + r[0] * r[2],
             -r[0] * r[1] * r[2])
    c = [np.concatenate([x, rng.normal(size=300)]) for x in three]
    c[1][300:] = np.abs(c[1][300:]) + 1.0             # one real root
    a = jrg._largest_real_cubic_root(*(jnp.asarray(x) for x in c))
    b = trg._largest_real_cubic_root(*(torch.as_tensor(x) for x in c))
    # 1e-9: the double roots sit at a round-off discriminant (see above)
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-9
    simple = [i for i in range(600) if not 150 <= i < 300]
    ref = [max(z.real for z in np.roots([1.0, c[0][i], c[1][i], c[2][i]])
               if abs(z.imag) < 1e-7) for i in simple]
    assert np.abs(b.numpy()[simple] - ref).max() <= 1e-6
    assert (np.abs(b.numpy()[150:300]) > 1e-3).any()   # not the root 0
    x = torch.as_tensor(rng.normal(size=1000) * 10.0 ** rng.integers(
        -30, 30, 1000))
    assert _rel_each(jnp.cbrt(jnp.asarray(x.numpy())), trg._cbrt(x)) <= 1e-13


def test_float32_floor_rounds_to_minus_zero():
    """jnp.minimum(p, -1e-300) in float32 takes -0.0 as its floor, and the
    port reproduces the function as it is. At the triple root of (x - 1)^3
    (p = q = 0) the floor does not help in either type (safe_p m underflows
    to -0.0): NaN in both packages; x^3 - 1 takes the Cardano branch."""
    assert float(torch.tensor(1e-300, dtype=torch.float32)) == 0.0
    for dt in (torch.float32, torch.float64):
        c = [torch.tensor([0.0, -3.0], dtype=dt),
             torch.tensor([0.0, 3.0], dtype=dt),
             torch.tensor([-1.0, -1.0], dtype=dt)]
        a = jrg._largest_real_cubic_root(*(jnp.asarray(x.numpy()) for x in c))
        b = trg._largest_real_cubic_root(*c)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), [1.0, np.nan], rtol=1e-6)
