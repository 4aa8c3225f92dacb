"""The port's face-list FGM solver (solvers/fgm_fl.py) and DeepFGM
distillation (combustion/fgm/deep.py train_deep_fgm) against the JAX
package, on the CPU.

FGMSolverFL on a shift-plan box, laminar (tests/test_fgm_fl.py's periodic
kernel) and with RNG k-epsilon (a sheared channel with walls), 2 steps
against JAX's jitted make_step_fl in float64: every field within 1e-8 of
its largest value (velocity and fluxes 1e-6), as the low-Mach face-list
tests. train_deep_fgm in float32 with JAX's PRNGKey initial weights
replayed into the port (its module-level init_params replaced): the
samples, normalisation and batch order come from numpy on both sides, so
after 3 epochs of Adam every parameter is within 1e-5 of JAX's (float32
GEMMs and Adam updates rounding apart). And JAX's own accuracy bound on
the port (tests/test_fgm.py): Tf within 5 % RMS of the synthetic table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jmesh
from deepflame_tpu.combustion.fgm.table import make_synthetic_table
from deepflame_tpu.combustion.fgm import deep as jdeep
from deepflame_tpu.mesh.facelist import from_structured as j_from_structured
from deepflame_tpu.solvers.fgm import FGMConfig as JConfig
from deepflame_tpu.solvers.fgm_fl import FGMSolverFL as JSolver
from deepflame_tpu.solvers.low_mach_fl import make_step_fl
from deepflame_tpu.solvers.low_mach_fl import rng_keps_kwargs as j_rng

import deepflame_torch.mesh as tmesh
from deepflame_torch.combustion.fgm import deep as tdeep
from deepflame_torch.combustion.fgm.table import lookup as t_lookup
from deepflame_torch.convert import fgm_fl_state_from_numpy
from deepflame_torch.mesh.facelist import from_structured
from deepflame_torch.solvers.fgm import FGMConfig
from deepflame_torch.solvers.fgm_fl import FGMSolverFL
from deepflame_torch.solvers.low_mach_fl import rng_keps_kwargs
from test_torch_fgm import _port_table, _rel
from test_torch_low_mach import RTOL_FLOW

SCALARS = ("rho", "p", "Z", "Zvar", "c", "cvar", "Zcvar", "T", "He", "k",
           "eps", "dpdt")


@pytest.fixture(scope="module")
def tables():
    tb = make_synthetic_table(dtype=jnp.float64)
    return tb, _port_table(tb)


def _pair(tables, ras: bool):
    """(JAX, port) FGMSolverFL on a 12 x 8 box with shift plans: laminar
    and periodic, or with RNG k-epsilon in a channel (walls on y)."""
    tb_j, tb_t = tables
    n, L = (12, 8), 1e-2
    sols = []
    for pkg, port in ((jmesh, False), (tmesh, True)):
        c, e, zg, fv = pkg.cyclic(), pkg.empty(), pkg.zero_gradient(), \
            pkg.fixed_value
        if ras:
            b = ((c, c), (zg, zg), (e, e))
            bU = ((c, c), (fv(0.0), fv(0.0)), (e, e))
        else:
            b = bU = ((c, c), (c, c), (e, e))
        if port:
            mesh = pkg.StructuredMesh.box([L, L, L / 12], [*n, 1],
                                          device="cpu")
            fl = lambda bc: from_structured(mesh, bc, device="cpu")
            S, cfg, tb = FGMSolverFL, FGMConfig(chemistry=False), tb_t
            kw = rng_keps_kwargs(C1=1.52)
        else:
            mesh = pkg.StructuredMesh.box([L, L, L / 12], [*n, 1])
            fl = lambda bc: j_from_structured(mesh, bc)
            S, tb = JSolver, tb_j
            cfg = JConfig(chemistry=False, use_pallas="never")
            kw = j_rng(C1=1.52)
        m, mU = fl(b), fl(bU)
        ras_kw = dict(m_k=m, m_eps=m, **kw) if ras else {}
        sols.append(S(m_p=m, m_h=m, m_Y=m, m_rho=m, m_U=(mU, mU, mU), m_c=m,
                      m_var=m, thermo=None, transport=None, combustion=None,
                      config=cfg, table=tb, **ras_kw))
    return sols, n, L


def _to_port(s):
    d = {k: np.asarray(getattr(s, k)) for k in s._fields if k != "phi_b"}
    d["phi_b"] = [np.asarray(x) for x in s.phi_b]
    return fgm_fl_state_from_numpy(d, device="cpu")


@pytest.mark.parametrize("ras", [False, True], ids=["laminar", "rng_keps"])
def test_fgm_fl_matches_jax(tables, ras):
    (sj, st), n, L = _pair(tables, ras)
    x = (np.arange(n[0]) + 0.5) / n[0] * L
    y = (np.arange(n[1]) + 0.5) / n[1] * L
    X, Y = [a.ravel() for a in np.meshgrid(x, y, indexing="ij")]
    r2 = (X - L / 2) ** 2 + (Y - L / 2) ** 2
    c0 = np.where(r2 < (L / 4) ** 2, 0.5, 0.0)
    Z0 = 0.3 + 0.1 * np.sin(2 * np.pi * X / L)
    U0 = np.zeros((X.shape[0], 3))
    U0[:, 0] = 2.0 + (8.0 * np.sin(np.pi * Y / L) if ras else 0.0)
    s_j = sj.fgm_initial_state(jnp.full(X.shape, 101325.0), jnp.asarray(Z0),
                               jnp.asarray(c0), jnp.asarray(U0), k0=0.5,
                               eps0=50.0)
    s_t = _to_port(s_j)
    step = make_step_fl(sj)
    for _ in range(2):
        s_j, dj = step(s_j, 1e-5)
        s_t, dt_ = st.step(s_t, 1e-5)
        for k in SCALARS:
            assert _rel(getattr(s_j, k), getattr(s_t, k)) <= 1e-8, k
        assert _rel(s_j.U, s_t.U) <= RTOL_FLOW
        assert _rel(s_j.phi, s_t.phi) <= RTOL_FLOW
        assert int(dj["iters_p"]) == int(dt_["iters_p"])
    if ras:
        assert float(s_t.k.min()) > 0.0 and float(dt_["k_max"]) > 0.5


def _jax_init(sizes, seed, dtype=torch.float32, device=None):
    """train_deep_fgm's initial weights as JAX draws them from
    PRNGKey(seed), as the port's init_params returns them."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i in range(len(sizes) - 1):
        key, k = jax.random.split(key)
        W = jax.random.normal(k, (sizes[i], sizes[i + 1]), jnp.float32) \
            * (2.0 / sizes[i]) ** 0.5
        out.append((torch.as_tensor(np.array(W), device=device),
                    torch.zeros(sizes[i + 1], dtype=dtype, device=device)))
    return out


@pytest.fixture
def one_thread():
    """Train on one CPU thread: the small GEMMs gain nothing from more,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_deep_fgm_matches_jax_weights(tables, monkeypatch, one_thread):
    tb_j, tb_t = tables
    kw = dict(hidden=(16, 16), n_samples=1024, epochs=3, batch=256,
              lr=3e-3, seed=4)
    net_j = jdeep.train_deep_fgm(tb_j, dtype=jnp.float32, **kw)
    monkeypatch.setattr(tdeep, "init_params", _jax_init)
    net_t = tdeep.train_deep_fgm(tb_t, dtype=torch.float32, **kw)
    for (Wj, bj), (Wt, bt) in zip(net_j.params, net_t.params):
        for a, b in ((Wj, Wt), (bj, bt)):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5
    for k in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_allclose(np.asarray(getattr(net_j, k)),
                                   getattr(net_t, k).numpy(), rtol=1e-6)


def test_deepfgm_distillation_accuracy(tables, one_thread):
    """tests/test_fgm.py's bound on the port's own distillation (its
    torch.Generator weights): Tf within 5 % RMS of the synthetic table over
    the manifold, omega_c >= 0."""
    _, tb = tables
    net = tdeep.train_deep_fgm(tb, hidden=(64, 64, 32), n_samples=8000,
                               epochs=400, batch=1024, lr=3e-3, seed=0)
    rng = np.random.default_rng(3)
    cols = [torch.as_tensor(rng.uniform(lo, hi, 200), dtype=torch.float32)
            for lo, hi in ((0.05, 0.95), (0.05, 0.95), (0.0, 0.2),
                           (0.0, 0.2))]
    out = net.query(*cols)
    T_ref = t_lookup(tb, "Tf", (None, *(c.double() for c in cols), None))
    rms = float(torch.sqrt(((out["Tf"].double() - T_ref) ** 2).mean())
                / T_ref.mean())
    assert rms < 0.05, rms
    assert float(out["omgc"].min()) >= 0.0
