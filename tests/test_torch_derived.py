"""The port's derived fields (runtime/derived.py) against the JAX package's
(float64, CPU): each field within 1e-12 of its largest value, on an 8 x 6 x
4 box with a fixed-value inlet, a cyclic axis and zeroGradient walls, from
seeded fields; the DerivedFields adapter feeding a storage object."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.mesh as jm
from deepflame_tpu.runtime import derived as JD
from deepflame_tpu.runtime import function_objects as JF

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tm
from deepflame_torch.runtime import derived as TD
from deepflame_torch.runtime import function_objects as TF

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
SHAPE = (8, 6, 4)


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-300)


def _bcs(pkg):
    zg = (pkg.zero_gradient(), pkg.zero_gradient())
    cy = (pkg.cyclic(), pkg.cyclic())
    inlet = lambda v: ((pkg.fixed_value(v), pkg.zero_gradient()), cy, zg)
    return (inlet(10.0), inlet(0.0), inlet(0.0))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(17)
    mj = jm.StructuredMesh.box((8e-3, 6e-3, 4e-3), SHAPE, (0.0, -3e-3, 0.0))
    mt = tm.StructuredMesh.box((8e-3, 6e-3, 4e-3), SHAPE, (0.0, -3e-3, 0.0),
                               device="cpu")
    mech = tc.load_mechanism(MECH, device="cpu")
    Y = rng.uniform(0.0, 1.0, SHAPE + (mech.n_species,))
    Y /= Y.sum(-1, keepdims=True)
    d = dict(U=rng.uniform(-5.0, 20.0, (3,) + SHAPE),
             T=rng.uniform(300.0, 2200.0, SHAPE), Y=Y,
             rho=rng.uniform(0.2, 1.2, SHAPE),
             mu=rng.uniform(1e-5, 1e-4, SHAPE),
             k=rng.uniform(-0.1, 5.0, SHAPE))
    return mj, mt, d, jc.make_thermo(jc.load_mechanism(MECH)), \
        tc.make_thermo(mech)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", ["vorticity", "enstrophy", "q_criterion",
                                  "lambda2", "flow_type"])
def test_velocity_gradient_fields(case, name):
    mj, mt, d, _, _ = case
    a = getattr(JD, name)(jnp.asarray(d["U"]), _bcs(jm), mj)
    b = getattr(TD, name)(_t(d["U"]), _bcs(tm), mt)
    assert a.shape == tuple(b.shape) and _rel(a, b) <= 1e-12


def test_lambda2_is_the_middle_eigenvalue(case):
    """Against numpy's eigvalsh of S^2 + Omega^2 cell by cell."""
    _, mt, d, _, _ = case
    U = _t(d["U"])
    from deepflame_torch.ops.fv import grad
    g = torch.stack([grad(U[c], _bcs(tm)[c], mt) for c in range(3)])
    G = np.moveaxis(g.numpy(), (0, 1), (-2, -1))
    S, W = 0.5 * (G + np.swapaxes(G, -1, -2)), 0.5 * (G - np.swapaxes(G, -1, -2))
    mid = np.linalg.eigvalsh(S @ S + W @ W)[..., 1]
    assert np.abs(TD.lambda2(U, _bcs(tm), mt).numpy() - mid).max() \
        <= 1e-9 * np.abs(mid).max()


def test_lambda2_of_a_uniform_velocity():
    """Where the velocity gradient vanishes, S^2 + Omega^2 is 0 and its
    eigenvalues are all 0: the JAX function divides 0 by 0 and returns
    NaN there (in float32, where the floor of p^2 underflows, and in
    float64, where p^3 does); the port returns q = 0 (to the floor).
    Elsewhere they agree (above)."""
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        mj = jm.StructuredMesh.box((1e-3, 1e-3, 1e-3), (4, 4, 4))
        mt = tm.StructuredMesh.box((1e-3, 1e-3, 1e-3), (4, 4, 4), device="cpu")
        zg = lambda pkg: ((pkg.zero_gradient(), pkg.zero_gradient()),) * 3
        a = JD.lambda2(jnp.full((3, 4, 4, 4), 0.9, dt), (zg(jm),) * 3, mj)
        b = TD.lambda2(torch.full((3, 4, 4, 4), 0.9, dtype=tdt),
                       (zg(tm),) * 3, mt)
        assert np.isnan(np.asarray(a)).all()
        # q + 2 p cos(...) with p the floor's square root (1e-150 in
        # float64, 0 in float32)
        assert b.dtype == tdt and float(b.abs().max()) <= 1e-140


def test_pointwise_and_wall_fields(case):
    mj, mt, d, thj, tht = case
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T_ = {k: _t(v) for k, v in d.items()}
    pairs = [
        (JD.mach_number(J["U"], J["T"], J["Y"], thj),
         TD.mach_number(T_["U"], T_["T"], T_["Y"], tht)),
        (JD.courant_no(J["U"], 1e-6, mj), TD.courant_no(T_["U"], 1e-6, mt)),
        (JD.peclet_no(J["U"], J["rho"], J["mu"], mj),
         TD.peclet_no(T_["U"], T_["rho"], T_["mu"], mt)),
        (JD.turbulence_intensity(J["U"], J["k"]),
         TD.turbulence_intensity(T_["U"], T_["k"])),
    ]
    for wall in ((0, 0), (1, 1), (2, 0)):
        pairs += [
            (JD.y_plus(J["U"], J["rho"], J["mu"], mj, wall),
             TD.y_plus(T_["U"], T_["rho"], T_["mu"], mt, wall)),
            (JD.wall_heat_flux(J["T"], J["mu"], mj, wall, 300.0),
             TD.wall_heat_flux(T_["T"], T_["mu"], mt, wall, 300.0)),
            (JD.wall_shear_stress(J["U"], J["rho"], J["mu"], mj, wall),
             TD.wall_shear_stress(T_["U"], T_["rho"], T_["mu"], mt, wall)),
        ]
        for T_ref in (1000.0, 300.0):          # 300: the floored difference
            pairs.append((
                JD.wall_heat_transfer_coeff(J["T"], J["mu"], mj, wall, 300.0,
                                            T_ref),
                TD.wall_heat_transfer_coeff(T_["T"], T_["mu"], mt, wall,
                                            300.0, T_ref)))
    for a, b in pairs:
        assert a.shape == tuple(b.shape) and _rel(a, b) <= 1e-12


def test_stream_function_2d():
    rng = np.random.default_rng(3)
    m = (jm.StructuredMesh.box((1.0, 1.0, 0.1), (5, 4, 1)),
         tm.StructuredMesh.box((1.0, 1.0, 0.1), (5, 4, 1), device="cpu"))
    fx, fy = rng.normal(size=(6, 4, 1)), rng.normal(size=(5, 5, 1))
    a = JD.stream_function_2d(jnp.asarray(fx), jnp.asarray(fy), m[0])
    b = TD.stream_function_2d(_t(fx), _t(fy), m[1])
    assert b.shape == (6, 5) and _rel(a, b) <= 1e-12


def test_derived_fields_feed_storage(case, tmp_path):
    """DerivedFields adds Q to the field dict a FieldMinMax reads; both
    packages write the same file."""
    mj, mt, d, _, _ = case
    out = {}
    for D, F, m, pkg, f in ((JD, JF, mj, jm, jnp.asarray),
                            (TD, TF, mt, tm, _t)):
        b = _bcs(pkg)
        fo = D.DerivedFields({"Q": lambda x: D.q_criterion(x["U"], b, m)},
                             F.FieldMinMax(m, ("Q", "T"),
                                           str(tmp_path / pkg.__name__)))
        fo(1e-6, {"U": f(d["U"]), "T": f(d["T"])})
        out[pkg] = np.loadtxt(fo.write())
    np.testing.assert_allclose(out[tm], out[jm], rtol=1e-12, atol=0)
