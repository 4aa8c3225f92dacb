"""PyTorch port of the stiff chemistry (0D reactor and the cell-batch solve)
against the JAX package, float64 on the CPU, on the 9-species test
mechanism."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.chemistry.reactor import ignite, solve_chemistry

import deepflame_torch.chemistry as tc
import deepflame_torch.chemistry.reactor as treactor
from deepflame_torch.chemistry.integrator import RosenbrockOptions as TOpts

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


def _tables():
    mj, mt = load_mechanism(MECH), tc.load_mechanism(MECH, device="cpu")
    return (make_thermo(mj), make_kinetics(mj), tc.make_thermo(mt),
            tc.make_kinetics(mt), mj)


def _fresh(mech, n):
    Y = np.zeros((n, mech.n_species))
    for s, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[:, mech.species_index(s)] = y
    return Y


def test_ignite_trajectory_matches_jax():
    """Constant-pressure ignition at 1200 K through the first 0.2 ms (past
    the ignition), 10 outputs. The port runs the same ode23s controller with
    a forward-mode Jacobian; tolerance 1e-9 of T and 1e-10 absolute in Y
    (round-off through a few hundred adaptive steps)."""
    thj, kj, tht, kt, mech = _tables()
    Y0 = _fresh(mech, 1)[0]
    _, Tj, Yj = ignite(thj, kj, 1200.0, 101325.0, Y0, 2e-4, n_out=10,
                       opts=RosenbrockOptions(rtol=1e-5, atol=1e-10))
    _, Tt, Yt = treactor.ignite(tht, kt, 1200.0, 101325.0, Y0, 2e-4, n_out=10,
                                opts=TOpts(rtol=1e-5, atol=1e-10))
    assert float(Tt[-1]) > 2500.0
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-9)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-10)


def _compare(rj, rt):
    """Per-lane results of the two packages: T 1e-10 relative, Y 1e-12
    absolute, RR 1e-9 of its largest value (adaptive Rosenbrock through
    round-off-different Jacobians); the controller's next step 1e-8
    relative, since it is a power of the embedded error estimate, a
    difference of nearly equal stage sums (ROS4's most of all)."""
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), rtol=1e-10)
    np.testing.assert_allclose(rt.Y.numpy(), np.asarray(rj.Y), rtol=0,
                               atol=1e-12)
    RR = np.asarray(rj.RR)
    np.testing.assert_allclose(rt.RR.numpy(), RR, rtol=0,
                               atol=1e-9 * np.abs(RR).max())
    np.testing.assert_allclose(rt.dt_next.numpy(), np.asarray(rj.dt_next),
                               rtol=1e-8)


@pytest.mark.parametrize("sort", ["T", "dt"])
def test_solve_chemistry_compact_path_matches_jax(monkeypatch, sort):
    """A mixed batch like tests/test_chem_compact.py::_mix (24 hot lanes in
    2048 cold ones), 16 bins, sorted by T or by a warm-start step: the
    reject count stays within the compact capacity, so only the K stiffest
    lanes are binned (the full sorted path is patched to fail)."""
    thj, kj, tht, kt, mech = _tables()
    n, n_hot = 2048, 24
    rng = np.random.default_rng(0)
    T = np.full(n, 700.0)
    T[rng.choice(n, n_hot, replace=False)] = rng.uniform(1500.0, 2100.0, n_hot)
    Y, p = _fresh(mech, n), np.full(n, 101325.0)
    d0 = np.full(n, 1e-8) if sort == "dt" else None
    kw = dict(rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)
    dt = 2.5e-7
    rj = solve_chemistry(thj, kj, jnp.asarray(T), jnp.asarray(p),
                         jnp.asarray(Y), dt, opts=RosenbrockOptions(**kw),
                         n_bins=16, sort=sort,
                         dt_start=None if d0 is None else jnp.asarray(d0))

    def no_full_path(*a, **k):
        raise AssertionError("full sorted-binned path taken")

    monkeypatch.setattr(treactor, "_sorted_binned", no_full_path)
    rt = treactor.solve_chemistry(tht, kt, torch.as_tensor(T),
                                  torch.as_tensor(p), torch.as_tensor(Y), dt,
                                  opts=TOpts(**kw), n_bins=16, sort=sort,
                                  dt_start=None if d0 is None
                                  else torch.as_tensor(d0))
    _compare(rj, rt)
    assert float(np.abs(rt.RR.numpy()).max()) > 0.0


@pytest.mark.parametrize("sort,order", [("T", 2), ("dt", 2), ("dt", 4)])
def test_solve_chemistry_full_path_matches_jax(sort, order):
    """All lanes hot: the reject count exceeds the compact capacity and the
    full sorted-binned path runs (warm-started, both sort keys, ode23s and
    ROS4)."""
    thj, kj, tht, kt, mech = _tables()
    n = 256
    rng = np.random.default_rng(3)
    T = rng.uniform(1400.0, 2200.0, n)
    Y, p = _fresh(mech, n), np.full(n, 101325.0)
    d0 = rng.uniform(1e-9, 1e-7, n)
    kw = dict(rtol=1e-5, atol=1e-9, max_steps=2000, grow=10.0, order=order)
    dt = 1e-7
    rj = solve_chemistry(thj, kj, jnp.asarray(T), jnp.asarray(p),
                         jnp.asarray(Y), dt, opts=RosenbrockOptions(**kw),
                         n_bins=16, dt_start=jnp.asarray(d0), sort=sort)
    rt = treactor.solve_chemistry(tht, kt, torch.as_tensor(T),
                                  torch.as_tensor(p), torch.as_tensor(Y), dt,
                                  opts=TOpts(**kw), n_bins=16,
                                  dt_start=torch.as_tensor(d0), sort=sort)
    _compare(rj, rt)


def test_integrate_batched_trip_count_matches_jax():
    """return_nstep: the trips at whose start some lane was still running,
    JAX's while-loop count, from the port's loop that checks the host only
    every CHECK_EVERY trips; 48 lanes from 1100 to 2100 K over 2 us, float64,
    y to the tolerances of the reactor tests (T 1e-10 relative, Y 1e-12)."""
    from deepflame_tpu.chemistry.integrator import rosenbrock_integrate_batched
    from deepflame_tpu.chemistry.reactor import constant_pressure_rhs_batched

    from deepflame_torch.chemistry.integrator import (
        CHECK_EVERY, rosenbrock_integrate_batched as t_integrate)
    thj, kj, tht, kt, mech = _tables()
    n = 48
    rng = np.random.default_rng(7)
    s0 = np.concatenate([rng.uniform(1100.0, 2100.0, (n, 1)),
                         _fresh(mech, n)], axis=1)
    p, t_end = np.full(n, 101325.0), np.full(n, 2e-6)
    kw = dict(rtol=1e-5, atol=1e-9, max_steps=2000)
    yj, dtj, nj = rosenbrock_integrate_batched(
        constant_pressure_rhs_batched(thj, kj, jnp.asarray(p)),
        jnp.asarray(s0), jnp.asarray(t_end), RosenbrockOptions(**kw),
        return_nstep=True)
    rhs_t = treactor.constant_pressure_rhs_batched(tht, kt, torch.as_tensor(p))
    yt, dtt, nt = t_integrate(rhs_t, torch.as_tensor(s0),
                              torch.as_tensor(t_end), TOpts(**kw),
                              return_nstep=True)
    assert nt.dtype == torch.int64 and nt.dim() == 0
    assert int(nt) == int(nj)
    assert int(nj) > CHECK_EVERY and int(nj) % CHECK_EVERY != 0
    np.testing.assert_allclose(yt[:, 0].numpy(), np.asarray(yj)[:, 0],
                               rtol=1e-10)
    np.testing.assert_allclose(yt[:, 1:].numpy(), np.asarray(yj)[:, 1:],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), rtol=1e-8)
    # the default call returns (y, dt) as before
    y2, dt2 = t_integrate(rhs_t, torch.as_tensor(s0), torch.as_tensor(t_end),
                          TOpts(**kw))
    assert torch.equal(y2, yt) and torch.equal(dt2, dtt)
