"""PyTorch port of the chemistry core against the JAX package (float64, CPU),
and the 9-species H2/air test mechanism itself."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.chemistry.kinetics import (heat_release_rate,
                                              mass_production_rates,
                                              production_rates)
from deepflame_tpu.chemistry.reactor import ignite

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry.mechanism import MECHANISM_ARRAYS
from deepflame_torch.convert import mechanism_from_numpy

DATA = os.path.join(os.path.dirname(__file__), "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
MECHS = ["air.yaml", "h2_air_9sp.json"]


def test_test_mechanism_reads_the_same_as_yaml_and_json():
    """The JSON file is also valid YAML with identical values (every float
    has a dot and a signed exponent), and the JAX parser takes it."""
    text = open(MECH).read()
    assert yaml.safe_load(text) == json.loads(text)
    mech = load_mechanism(MECH)
    assert mech.species_names == ("H2", "H", "O", "O2", "OH", "H2O", "HO2",
                                  "H2O2", "N2")
    assert mech.n_reactions >= 10
    assert mech.is_three_body.sum() >= 1
    assert (mech.has_troe * mech.is_falloff).sum() >= 1
    assert np.all(mech.reversible == 1.0)


def test_test_mechanism_ignites():
    """JAX 0D constant-pressure reactor at 1200 K, 1 atm, phi ~ 1: the
    temperature rises by more than 1000 K within 1 ms."""
    mech = load_mechanism(MECH)
    Y = np.zeros(mech.n_species)
    Y[[mech.species_index(s) for s in ("H2", "O2", "N2")]] = (0.0285, 0.2264,
                                                              0.7451)
    _, T, _ = ignite(make_thermo(mech), make_kinetics(mech), 1200.0,
                     101325.0, Y, 1e-3, n_out=20,
                     opts=RosenbrockOptions(rtol=1e-6, atol=1e-12))
    assert float(np.max(T)) > 2200.0


@pytest.mark.parametrize("name", MECHS)
def test_mechanism_arrays_match_jax(name):
    path = os.path.join(DATA, name)
    mj = load_mechanism(path)
    mt = tc.load_mechanism(path, device="cpu")
    assert mt.species_names == mj.species_names
    assert mt.element_names == mj.element_names
    for k in MECHANISM_ARRAYS:
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k), err_msg=k)


def test_mechanism_from_numpy_matches_parse():
    mj = load_mechanism(MECH)
    d = {f.name: getattr(mj, f.name) for f in dataclasses.fields(mj)}
    mt = mechanism_from_numpy(d, device="cpu")
    ref = tc.load_mechanism(MECH, device="cpu")
    for k in MECHANISM_ARRAYS:
        np.testing.assert_array_equal(getattr(mt, k), getattr(ref, k), err_msg=k)


def _state(mech, n=64, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.uniform(300.0, 2800.0, n)
    Y = rng.dirichlet(np.ones(mech.n_species), n)
    p = rng.uniform(5e4, 2e5, n)
    return T, p, Y


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("inversion", ["T_from_h", "T_psi_from_h"])
@pytest.mark.parametrize("name", MECHS)
def test_thermo_matches_jax(name, inversion):
    """float64, <= 1e-12 of each property's largest value (the same NASA-7
    Horner forms; only summation orders differ). The Newton inversion alone
    (`T_from_h`) and with psi in one call (`T_psi_from_h`, which on the CPU
    is T_from_h then psi, bit for bit)."""
    path = os.path.join(DATA, name)
    mj, mt = load_mechanism(path), tc.load_mechanism(path, device="cpu")
    thj, tht = make_thermo(mj), tc.make_thermo(mt)
    T, p, Y = _state(mj)
    Tt, pt, Yt = map(torch.as_tensor, (T, p, Y))
    for f in ("cp_R", "h_RT", "s_R", "g_RT", "h_species"):
        assert _rel(getattr(thj, f)(T), getattr(tht, f)(Tt)) <= 1e-12, f
    for f in ("cp_mass", "h_mass", "psi"):
        assert _rel(getattr(thj, f)(T, Y), getattr(tht, f)(Tt, Yt)) <= 1e-12, f
    assert _rel(thj.rho(p, T, Y), tht.rho(pt, Tt, Yt)) <= 1e-12
    h = np.asarray(thj.h_mass(T, Y))
    T_j = thj.T_from_h(h, Y, T * 0.9)
    T_t = tht.T_from_h(torch.as_tensor(h), Yt, Tt * 0.9)
    if inversion == "T_psi_from_h":
        T_p, psi_t = tht.T_psi_from_h(torch.as_tensor(h), Yt, Tt * 0.9)
        assert torch.equal(T_p, T_t)
        assert torch.equal(psi_t, tht.psi(T_t, Yt))
        assert _rel(thj.psi(T_j, Y), psi_t) <= 1e-12
        T_t = T_p
    assert _rel(T_j, T_t) <= 1e-12
    assert _rel(thj.h_formation, tht.h_formation) <= 1e-15


@pytest.mark.parametrize("name", MECHS)
def test_thermo_energy_functions_match_jax(name):
    """cv, internal and sensible enthalpy, gamma, sound speed and the Newton
    T(e), float64, <= 1e-12 of each property's largest value."""
    path = os.path.join(DATA, name)
    mj, mt = load_mechanism(path), tc.load_mechanism(path, device="cpu")
    thj, tht = make_thermo(mj), tc.make_thermo(mt)
    T, _, Y = _state(mj)
    Tt, Yt = torch.as_tensor(T), torch.as_tensor(Y)
    for f in ("cv_mass", "e_mass", "hs_mass", "gamma", "sound_speed"):
        assert _rel(getattr(thj, f)(T, Y), getattr(tht, f)(Tt, Yt)) <= 1e-12, f
    e = np.asarray(thj.e_mass(T, Y))
    Te = tht.T_from_e(torch.as_tensor(e), Yt, Tt * 0.9)
    assert _rel(thj.T_from_e(e, Y, T * 0.9), Te) <= 1e-12
    assert _rel(T, Te) <= 1e-12


def test_kinetics_helpers_match_jax():
    """mass_production_rates and heat_release_rate, float64, <= 1e-12 of
    their largest values; the mass rates sum to zero per cell."""
    mj, mt = load_mechanism(MECH), tc.load_mechanism(MECH, device="cpu")
    thj, tht = make_thermo(mj), tc.make_thermo(mt)
    kj, kt = make_kinetics(mj), tc.make_kinetics(mt)
    T, p, Y = _state(mj, n=256, seed=2)
    rho = np.asarray(thj.rho(p, T, Y))
    args = tuple(map(torch.as_tensor, (T, rho, Y)))
    RR = tc.kinetics.mass_production_rates(kt, tht, *args)
    assert _rel(mass_production_rates(kj, thj, T, rho, Y), RR) <= 1e-12
    assert float(RR.sum(-1).abs().max() / RR.abs().max()) <= 1e-12
    Q = tc.kinetics.heat_release_rate(kt, tht, *args)
    assert _rel(heat_release_rate(kj, thj, T, rho, Y), Q) <= 1e-12
    assert float(Q.abs().max()) > 0.0


@pytest.mark.parametrize("name", MECHS)
def test_transport_matches_jax(name):
    """float64, <= 1e-12 relative: the fits are the same numpy code, the
    mixture rules the same forms."""
    path = os.path.join(DATA, name)
    mj, mt = load_mechanism(path), tc.load_mechanism(path, device="cpu")
    trj, trt = make_transport(mj), tc.make_transport(mt)
    thj = make_thermo(mj)
    np.testing.assert_array_equal(trt.diff_coeffs.numpy(),
                                  np.asarray(trj.diff_coeffs))
    T, p, Y = _state(mj)
    X = np.asarray(thj.mole_fractions(Y))
    Tt, pt, Xt, Yt = map(torch.as_tensor, (T, p, X, Y))
    assert _rel(trj.mu_mix(T, X), trt.mu_mix(Tt, Xt)) <= 1e-12
    assert _rel(trj.lambda_mix(T, X), trt.lambda_mix(Tt, Xt)) <= 1e-12
    assert _rel(trj.mix_diff_coeffs(T, p, X, Y),
                trt.mix_diff_coeffs(Tt, pt, Xt, Yt)) <= 1e-12


def test_production_rates_match_jax():
    """float64, <= 1e-12 of the largest |wdot| (exp of sums taken in another
    order)."""
    mj, mt = load_mechanism(MECH), tc.load_mechanism(MECH, device="cpu")
    thj, tht = make_thermo(mj), tc.make_thermo(mt)
    T, p, Y = _state(mj, n=256, seed=1)
    Y[:32, 1:5] = 0.0                       # radicals exactly absent
    Y /= Y.sum(1, keepdims=True)
    rho = np.asarray(thj.rho(p, T, Y))
    wj = production_rates(make_kinetics(mj), thj, T, rho, Y)
    wt = tc.production_rates(tc.make_kinetics(mt), tht, torch.as_tensor(T),
                             torch.as_tensor(rho), torch.as_tensor(Y))
    assert _rel(wj, wt) <= 1e-12
    # mass conservation of the port's rates
    mass = (wt * tht.W).sum(-1).abs().max() / (wt * tht.W).abs().max()
    assert float(mass) <= 1e-12
