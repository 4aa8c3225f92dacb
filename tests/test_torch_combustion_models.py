"""The port's EDC and PaSR models against the JAX package's (float64, CPU).

`correct()` of every EDC version and of every PaSR mixing and chemistry
time scale on 32 cells of the 9-species test mechanism (a premixed H2/air
state from 1000 to 2200 K with seeded turbulence fields): RR and Qdot within
1e-8 of their largest |value|. PaSR's dynamicScale transport
(`aux_advance`) on an 8 x 6 x 4 box for each Chi closure: Z, Zvar and Chi
within 1e-10 of their largest values (the JAX function reports no
iteration counts; the port's are read from its `stats`). The stiff integrator's own parity is tests/test_torch_reactor.py's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.combustion as jcomb
import deepflame_tpu.mesh as jm
from deepflame_tpu.chemistry.integrator import RosenbrockOptions as JOpts

import deepflame_torch.chemistry as tc
import deepflame_torch.combustion as tcomb
import deepflame_torch.mesh as tm
from deepflame_torch.chemistry.integrator import RosenbrockOptions

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
N = 32
DT = 1e-6


@pytest.fixture(scope="module")
def tables():
    mj = jc.load_mechanism(MECH)
    mt = tc.load_mechanism(MECH, device="cpu")
    return ((jc.make_thermo(mj), jc.make_kinetics(mj)),
            (tc.make_thermo(mt), tc.make_kinetics(mt)), mt)


@pytest.fixture(scope="module")
def cells(tables):
    """T, p, Y (N, ns) and k, epsilon, nu, Zvar, Chi of N cells, numpy."""
    mech = tables[2]
    rng = np.random.default_rng(9)
    Y = np.zeros((N, mech.n_species))
    for s, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[:, mech.species_index(s)] = y
    Y[:, mech.species_index("H2O")] = rng.uniform(0.0, 0.05, N)
    Y /= Y.sum(1, keepdims=True)
    return dict(T=np.linspace(1000.0, 2200.0, N), p=np.full(N, 101325.0), Y=Y,
                k=rng.uniform(0.5, 20.0, N), epsilon=rng.uniform(1e5, 1e7, N),
                nu=rng.uniform(1.5e-5, 2e-4, N), Zvar=rng.uniform(0.0, 0.2, N),
                Chi=rng.uniform(1.0, 500.0, N))


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-300)


def _correct_both(tables, cells, make):
    """correct() of the model `make(pkg module, thermo, kinetics, opts)`
    builds in each package, on the same cells."""
    (thj, kj), (tht, kt), mech = tables
    kw = dict(rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)
    mj = make(jcomb, thj, kj, JOpts(**kw))
    mt = make(tcomb, tht, kt, RosenbrockOptions(**kw))
    turb_keys = ("k", "epsilon", "nu", "Zvar", "Chi")
    rj = mj.correct(jnp.asarray(cells["T"]), jnp.asarray(cells["p"]),
                    jnp.asarray(cells["Y"]), DT,
                    {k: jnp.asarray(cells[k]) for k in turb_keys})
    f = lambda x: torch.as_tensor(x, dtype=torch.float64)
    rt = mt.correct(f(cells["T"]), f(cells["p"]), f(cells["Y"]), DT,
                    {k: f(cells[k]) for k in turb_keys})
    assert _rel(rj.RR, rt.RR) <= 1e-8
    assert _rel(rj.Qdot, rt.Qdot) <= 1e-8
    assert np.abs(np.asarray(rj.RR)).max() > 0.0
    return rj, rt


@pytest.mark.parametrize("version", ["v1981", "v1996", "v2005", "v2016"])
def test_edc_correct_matches_jax(tables, cells, version):
    _correct_both(tables, cells, lambda m, th, kin, o: m.EDC(
        th, kin, ode_opts=o, version=version))


@pytest.mark.parametrize("mixing,chem", [
    ("globalScale", "formationRate"),
    ("kolmogorovScale", "formationRate"),
    ("geometriMeanScale", "formationRate"),
    ("dynamicScale", "formationRate"),
    ("globalScale", "globalConvertion"),
])
def test_pasr_correct_matches_jax(tables, cells, mixing, chem):
    mech = tables[2]
    idx = {} if chem == "formationRate" else dict(
        fuel_index=mech.species_index("H2"),
        oxidizer_index=mech.species_index("O2"))
    _correct_both(tables, cells, lambda m, th, kin, o: m.PaSR(
        th, kin, ode_opts=o, mixing_scale=mixing, chemistry_scale=chem,
        **idx))


def test_models_need_turbulence(tables):
    (_, _), (tht, kt), _ = tables
    z = torch.zeros(2, dtype=torch.float64)
    for model in (tcomb.EDC(tht, kt), tcomb.PaSR(tht, kt)):
        with pytest.raises(ValueError, match="turbulence"):
            model.correct(z + 1000.0, z + 1e5, torch.ones(2, 9) / 9, DT)
        assert model.reads_turb
    assert not tcomb.Laminar(tht, kt).reads_turb
    assert tcomb.PaSR(tht, kt, mixing_scale="dynamicScale").n_aux == 3
    assert tcomb.PaSR(tht, kt).n_aux == 0


# ------------------------------------------------------- dynamicScale

SHAPE = (8, 6, 4)


def _box_inputs():
    """Seeded fields of an 8 x 6 x 4 box (numpy): rho, rho_old, phi (three
    face arrays), U, T, p, mu_eff, mu_t, k, eps and (Z, Zvar, Chi)."""
    rng = np.random.default_rng(4)
    cell = lambda lo, hi: rng.uniform(lo, hi, SHAPE)
    faces = [SHAPE[:a] + (SHAPE[a] + 1,) + SHAPE[a + 1:] for a in range(3)]
    mu_t = cell(1e-5, 1e-4)
    return dict(
        rho=cell(0.3, 1.2), rho_old=cell(0.3, 1.2),
        phi=[rng.uniform(-5.0, 20.0, s) for s in faces],
        U=rng.uniform(-5.0, 20.0, (3,) + SHAPE), T=cell(700.0, 2000.0),
        p=cell(1.0e5, 1.02e5), mu_eff=cell(2e-5, 8e-5) + mu_t, mu_t=mu_t,
        k=cell(0.1, 10.0), eps=cell(1e2, 1e5),
        aux=(cell(0.0, 1.0), cell(0.0, 0.2), cell(1e-3, 50.0)))


def _box_bcs(pkg):
    """Z fixed at 1 on the low x face, zeroGradient on the high one; y
    cyclic; z zeroGradient; the coefficients zeroGradient but on y."""
    zg = (pkg.zero_gradient(), pkg.zero_gradient())
    cy = (pkg.cyclic(), pkg.cyclic())
    bz = ((pkg.fixed_value(1.0), pkg.zero_gradient()), cy, zg)
    bu = ((pkg.fixed_value(10.0), pkg.zero_gradient()), cy, zg)
    return bz, (bu, bz, bz), (zg, cy, zg)


@pytest.mark.parametrize("chi_type", ["constAlgebraic", "dynAlgebraic",
                                      "transport"])
def test_aux_advance_matches_jax(tables, chi_type):
    (thj, kj), (tht, kt), _ = tables
    d = _box_inputs()
    L = (0.008, 0.006, 0.004)
    out = {}
    for pkg, comb, th, kin in ((jm, jcomb, thj, kj), (tm, tcomb, tht, kt)):
        if pkg is jm:
            mesh = jm.StructuredMesh.box(L, SHAPE)
            f = jnp.asarray
        else:
            mesh = tm.StructuredMesh.box(L, SHAPE, device="cpu")
            f = lambda x: torch.as_tensor(x, dtype=torch.float64)
        model = comb.PaSR(th, kin, mixing_scale="dynamicScale",
                          chi_type=chi_type)
        bz, bu, bc = _box_bcs(pkg)
        stats = {}
        kw = {} if pkg is jm else dict(stats=stats)
        aux = model.aux_advance(
            tuple(f(a) for a in d["aux"]), f(d["rho"]), f(d["rho_old"]),
            tuple(f(x) for x in d["phi"]), f(d["U"]), f(d["T"]), f(d["p"]),
            f(d["mu_eff"]), f(d["mu_t"]), f(d["k"]), f(d["eps"]), 2e-6,
            mesh, bz, bu, bc, "limitedLinear", **kw)
        out[pkg.__name__] = (aux, stats)
    (aj, _), (at, stats) = out["deepflame_tpu.mesh"], out["deepflame_torch.mesh"]
    for name, a, b in zip(("Z", "Zvar", "Chi"), aj, at):
        assert _rel(a, b) <= 1e-10, name
    assert int(stats["iters_Z"]) > 0 and int(stats["iters_Zvar"]) > 0
    assert ("iters_Chi" in stats) == (chi_type == "transport")
    assert float(at[1].max()) <= 0.25 and float(at[0].min()) >= 0.0
