"""Public members of JAX modules that the PyTorch port carries besides its
modules' __all__ names: LowMachSolver.courant, TransportData.binary_diff,
rosenbrock_attempt and CombustionModel.kappa, each against the JAX package
in float64 on the CPU, on the 9-species test mechanism."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry import make_transport
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.chemistry.integrator import rosenbrock_attempt as j_attempt
from deepflame_tpu.chemistry.reactor import constant_pressure_rhs
from deepflame_tpu.combustion import Laminar as JLaminar

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry.integrator import RosenbrockOptions as TOpts
from deepflame_torch.chemistry.integrator import rosenbrock_attempt
from deepflame_torch.chemistry.reactor import constant_pressure_rhs_batched
from deepflame_torch.combustion import EDC, Laminar, PaSR

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


def _mechs():
    return load_mechanism(MECH), tc.load_mechanism(MECH, device="cpu")


def test_binary_diff_matches_jax():
    """(..., ns, ns) binary diffusion coefficients at 24 states of T in
    [300, 2600] K and p in [0.5, 3] atm, batch shape (4, 6): 1e-13
    relative, entry by entry."""
    mj, mt = _mechs()
    rng = np.random.default_rng(1)
    T = rng.uniform(300.0, 2600.0, (4, 6))
    p = rng.uniform(0.5, 3.0, (4, 6)) * 101325.0
    ref = np.asarray(make_transport(mj).binary_diff(jnp.asarray(T),
                                                    jnp.asarray(p)))
    got = tc.make_transport(mt).binary_diff(torch.as_tensor(T),
                                            torch.as_tensor(p)).numpy()
    assert got.shape == (4, 6, 9, 9)
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)


def test_rosenbrock_attempt_matches_vmapped_jax():
    """One ode23s attempt per lane: 8 H2/air states at 1100-2400 K and 1
    atm with steps from 0 to 1e-5 s, so that some lanes fail the error
    test; against jax.vmap of the JAX package's single-cell attempt. y_new
    within 1e-10 of each lane's largest value, the same lanes accepted, the
    suggested step within 1e-8 relative (a power of the error estimate)."""
    mj, mt = _mechs()
    thj, kj = make_thermo(mj), make_kinetics(mj)
    tht, kt = tc.make_thermo(mt), tc.make_kinetics(mt)
    rng = np.random.default_rng(4)
    L, ns = 8, mj.n_species
    Y = np.zeros((L, ns))
    for s, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[:, mj.species_index(s)] = y
    y0 = np.concatenate([rng.uniform(1100.0, 2400.0, (L, 1)), Y], axis=1)
    dt = np.array([0.0, 1e-9, 1e-8, 1e-7, 1e-6, 3e-6, 1e-5, 1e-5])
    opts = dict(rtol=1e-6, atol=1e-12)
    p = 101325.0
    yj, accj, dj = jax.vmap(
        lambda y, h: j_attempt(constant_pressure_rhs(thj, kj, p), y, h,
                               RosenbrockOptions(**opts)))(
        jnp.asarray(y0), jnp.asarray(dt))
    yt, acct, dtt = rosenbrock_attempt(
        constant_pressure_rhs_batched(tht, kt, torch.full((L,), p,
                                                          dtype=torch.float64)),
        torch.as_tensor(y0), torch.as_tensor(dt), TOpts(**opts))
    yj = np.asarray(yj)
    assert np.array_equal(acct.numpy(), np.asarray(accj))
    assert acct.any() and not acct.all() and bool(acct[0])
    assert np.array_equal(yt[0].numpy(), y0[0])          # dt = 0: unchanged
    scale = np.abs(yj).max(axis=1, keepdims=True)
    assert (np.abs(yt.numpy() - yj) <= 1e-10 * scale).all()
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dj), rtol=1e-8)


def test_courant_matches_jax():
    """The largest Courant number of the 3D reacting TGV's initial state
    at n = 8 (10 m/s on a 0.785 mm grid) for two steps: equal to the JAX
    solver's within 1e-14 relative, a 0-d tensor."""
    from __graft_entry__ import _build_3d_les
    from deepflame_torch.cases import reacting_tgv_3d_les
    solver_j, state_j = _build_3d_les(n=8, dtype=jnp.float64, mech_path=MECH)
    solver_t, state_t = reacting_tgv_3d_les(MECH, n=8, dtype=torch.float64,
                                            device="cpu")
    for dt in (2.5e-7, 1e-5):
        co_j = float(solver_j.courant(state_j, dt))
        co_t = solver_t.courant(state_t, dt)
        assert co_t.dim() == 0 and co_t.dtype == torch.float64
        assert co_j > 0.0
        assert abs(float(co_t) - co_j) <= 1e-14 * co_j


@pytest.mark.parametrize("model", [Laminar, EDC, PaSR])
def test_kappa_is_one_as_in_jax(model):
    """CombustionModel.kappa: 1.0 whatever `turb`, as the JAX base class
    returns and no JAX model overrides; the port's mixing models scale
    their rates inside correct() and keep the base's kappa too."""
    mj, mt = _mechs()
    jl = JLaminar(make_thermo(mj), make_kinetics(mj))
    m = model(tc.make_thermo(mt), tc.make_kinetics(mt))
    turb = tuple(torch.ones(2) for _ in range(3))
    assert m.kappa(turb) == m.kappa(None) == jl.kappa(None) == 1.0
