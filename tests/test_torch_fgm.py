"""PyTorch port of the flareFGM and DeePFGM serving path against the JAX
package (float64, CPU): the FlaRe parsers (native and Python), the table
lookup on the three in-repo tables and on a synthetic table with the
enthalpy-loss and correlation axes, DeepFGM's query and the FGM step on a 24 x 16 Sandia-type jet.

Tolerances: parsers exact; lookups 1e-12 of the largest value (the same
multilinear sum, searchsorted on the same axis); DeepFGM 1e-12; FGM steps
1e-8 of each field's largest value and 1e-6 for the velocity and face
fluxes (the pressure CG's round-off, as in the low-Mach parity tests).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.combustion.fgm.deep import DeepFGM as JDeepFGM
from deepflame_tpu.combustion.fgm.table import (lookup as j_lookup,
                                                make_synthetic_table as
                                                j_synthetic,
                                                read_flare_table as j_read)
from deepflame_tpu.mesh import StructuredMesh
from deepflame_tpu.solvers.fgm import FGMConfig as JConfig
from deepflame_tpu.solvers.fgm import FGMSolver as JSolver
from deepflame_tpu.solvers.fgm import FGMState as JState

import deepflame_torch.native as tnative
from deepflame_torch.cases import sandia_d_fgm_2d
from deepflame_torch.combustion.fgm.table import (lookup as t_lookup,
                                                  read_flare_table as t_read,
                                                  write_flare_table)
from deepflame_torch.convert import deep_fgm_from_numpy, flamelet_table_from_numpy
from deepflame_torch.solvers.fgm import FGMState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = {name: os.path.join(ROOT, "data", name) for name in (
    "flare_CH4_drm19_SandiaD_4D.tbl", "flare_CH4_drm19_SandiaD_4D_nc41.tbl",
    "flare_H2_Li_4D.tbl")}
H2_TABLE = TABLES["flare_H2_Li_4D.tbl"]
FIELDS = ("rho", "p", "Z", "Zvar", "c", "cvar", "Zcvar", "T", "He")


def _rel(a, b):
    a, b = np.asarray(a), b.detach().cpu().numpy()
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _port_table(tb):
    """The port's copy of a JAX FlameletTable."""
    d = {f.name: getattr(tb, f.name) for f in dataclasses.fields(tb)}
    d["tables"] = {k: np.asarray(v) for k, v in tb.tables.items()}
    return flamelet_table_from_numpy(d, device="cpu")


def _coords(rng, tb, n):
    """Random coordinates over each axis' range and 10 % beyond it."""
    out = []
    for a in tb.axes:
        a = np.asarray(a)
        lo, hi = a.min(), a.max()
        span = max(hi - lo, 1e-3)
        out.append(rng.uniform(lo - 0.1 * span, hi + 0.1 * span, n))
    return out


@pytest.mark.parametrize("name", sorted(TABLES))
def test_lookup_matches_jax(name):
    tj = j_read(TABLES[name], dtype=jnp.float64)
    tt = _port_table(tj)
    rng = np.random.default_rng(11)
    h, Z, c, gz, gc, gzc = _coords(rng, tj, 500)
    # points on the axis nodes, and at both ends
    Z[:11] = np.asarray(tj.axes[1])
    c[:2] = (0.0, 1.0)
    for tab in ("Tf", "omgc", "cOc", "mwt", "cp", "nu"):
        for co in ((None, Z, c, gz, gc, None), (h, Z, c, gz, gc, gzc)):
            ref = j_lookup(tj, tab, tuple(None if x is None else jnp.asarray(x)
                                          for x in co))
            got = t_lookup(tt, tab, tuple(None if x is None
                                          else torch.as_tensor(x) for x in co))
            assert _rel(ref, got) <= 1e-12, (tab, name)


def test_lookup_enthalpy_and_correlation_axes_match_jax():
    """A synthetic table with 4 enthalpy-loss and 3 correlation nodes: every
    axis active (64 corners), and None on an axis of length > 1."""
    tj = j_synthetic(NH=4, NZC=3, dtype=jnp.float64)
    tt = _port_table(tj)
    rng = np.random.default_rng(5)
    co = _coords(rng, tj, 300)
    for tab in ("Tf", "omgc"):
        for c in (co, [None] + co[1:5] + [None]):
            ref = j_lookup(tj, tab, tuple(None if x is None else jnp.asarray(x)
                                          for x in c))
            got = t_lookup(tt, tab, tuple(None if x is None
                                          else torch.as_tensor(x) for x in c))
            assert _rel(ref, got) <= 1e-12


def _same_table(tj, tt):
    assert tt.shape == tj.shape and tt.scaled_pv == tj.scaled_pv
    assert (tt.H_fuel, tt.H_ox) == (tj.H_fuel, tj.H_ox)
    assert tt.omega_species == tj.omega_species and tt.species == tj.species
    assert set(tt.tables) == set(tj.tables)
    for k in tj.tables:
        np.testing.assert_array_equal(np.asarray(tj.tables[k]),
                                      tt.tables[k].numpy())
    for ax in range(6):
        np.testing.assert_array_equal(np.asarray(tj.axes[ax]), tt.axes[ax])
    for k in tj.laminar:
        np.testing.assert_array_equal(tj.laminar[k], tt.laminar[k])


def test_parsers_match_jax_python_parser(tmp_path):
    """The port's native (g++-built) and Python parsers read the H2 table
    and a table the port wrote exactly as JAX's Python parser does."""
    ref = j_read(H2_TABLE, dtype=jnp.float64, use_native=False)
    for native in (True, False):
        _same_table(ref, t_read(H2_TABLE, dtype=torch.float64,
                                use_native=native, device="cpu"))
    path = str(tmp_path / "synthetic.tbl")
    write_flare_table(path, _port_table(j_synthetic(NH=2, NZ=9, NC=5, NGZ=3,
                                                    NGC=2,
                                                    dtype=jnp.float64)))
    ref = j_read(path, dtype=jnp.float64, use_native=False)
    for native in (True, False):
        _same_table(ref, t_read(path, dtype=torch.float64, use_native=native,
                                device="cpu"))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """Asked for the native parser that cannot be built, read_flare_table
    raises; it does not parse in Python instead."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        t_read(H2_TABLE, use_native=True, device="cpu")
    assert not (tmp_path / "native").exists()


def test_native_available(tmp_path, monkeypatch):
    """native_available: True where g++ builds the library, False where it
    cannot be built; it never raises."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library with")
    assert tnative.native_available()
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert tnative.native_available() is False


def _deep_params(seed, hidden=(64, 64, 32)):
    """Seeded weights and normalisations whose outputs stay near a burnt
    manifold's (T about 1200 K, W 25), so that the jet stays physical."""
    rng = np.random.default_rng(seed)
    sizes = (4,) + hidden + (8,)
    params = [(rng.normal(0, (2.0 / sizes[i]) ** 0.5, (sizes[i], sizes[i + 1])),
               rng.normal(0, 0.1, sizes[i + 1])) for i in range(len(sizes) - 1)]
    norm = (np.array([0.3, 0.5, 0.1, 0.1]), np.array([0.3, 0.3, 0.1, 0.1]),
            np.array([50.0, 5.0, 1.0, 1500.0, 25.0, -1e4, 1200.0, 5e-5]),
            np.array([5.0, 0.5, 0.1, 10.0, 0.2, 1e3, 20.0, 1e-6]))
    return params, norm


def test_deepfgm_query_matches_jax():
    params, norm = _deep_params(0)
    jnet = JDeepFGM([(jnp.asarray(W), jnp.asarray(b)) for W, b in params],
                    *(jnp.asarray(v) for v in norm))
    tnet = deep_fgm_from_numpy(params, *norm, device="cpu")
    rng = np.random.default_rng(1)
    x = [rng.uniform(0.0, 1.0, (40, 3)) for _ in range(2)] + \
        [rng.uniform(0.0, 0.3, (40, 3)) for _ in range(2)]
    ref = jnet.query(*(jnp.asarray(v) for v in x))
    got = tnet.query(*(torch.as_tensor(v) for v in x))
    assert set(ref) == set(got)
    for k in ref:
        assert _rel(ref[k], got[k]) <= 1e-12, k
    assert float(got["omgc"].min()) >= 0.0 and float(got["Tf"].min()) >= 200.0


def _bc_j(bc):
    """A port BC as the JAX package's."""
    from deepflame_tpu.mesh.structured import BC
    v = bc.value
    return BC(bc.kind, jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)


def _bcs_j(bcs):
    return tuple(tuple(_bc_j(b) for b in pair) for pair in bcs)


def _jax_twin(st_solver, table_j, deep_j=None):
    m = st_solver.mesh
    return JSolver(
        mesh=StructuredMesh(m.nx, m.ny, m.nz, m.dx, m.dy, m.dz),
        thermo=None, transport=None, combustion=None,
        bcs_U=tuple(_bcs_j(b) for b in st_solver.bcs_U),
        bcs_p=_bcs_j(st_solver.bcs_p), bcs_h=_bcs_j(st_solver.bcs_h),
        bcs_Y=_bcs_j(st_solver.bcs_Y), bcs_rho=_bcs_j(st_solver.bcs_rho),
        bcs_Z=_bcs_j(st_solver.bcs_Z), table=table_j, deepfgm=deep_j,
        config=JConfig(**{f.name: getattr(st_solver.config, f.name)
                          for f in dataclasses.fields(JConfig)
                          if hasattr(st_solver.config, f.name)}))


def _state_j(st):
    return JState(*(tuple(jnp.asarray(x.numpy()) for x in v)
                    if isinstance(v, tuple) else jnp.asarray(v.numpy())
                    for v in st))


FGM_CONFIGS = {
    "cvar": {},
    "zcvar-enthalpy": dict(solve_cvar=False, solve_zcvar=True,
                           solve_enthalpy=True),
}


@pytest.mark.parametrize("cfg", sorted(FGM_CONFIGS))
def test_fgm_step_matches_jax(cfg):
    """Three steps of the Sandia-type jet at 24 x 16 on the H2 table, the
    example's Courant number (dt 4e-6 s x 96/24), with the cvar equation,
    and with the Zcvar and enthalpy equations in its place."""
    solver, st = sandia_d_fgm_2d(H2_TABLE, nx=24, ny=16, dtype=torch.float64,
                                 device="cpu")
    solver = dataclasses.replace(solver, config=dataclasses.replace(
        solver.config, **FGM_CONFIGS[cfg]))
    tj = j_read(H2_TABLE, dtype=jnp.float64)
    _run(solver, st, _jax_twin(solver, tj), 4e-6 * 96 / 24, 3)


def test_fgm_step_deepfgm_matches_jax():
    """The same jet with a DeepFGM of seeded weights (hidden 64, 64, 32)
    for the state lookups: two steps."""
    params, norm = _deep_params(2)
    solver, st = sandia_d_fgm_2d(H2_TABLE, nx=24, ny=16, dtype=torch.float64,
                                 device="cpu",
                                 deepfgm=deep_fgm_from_numpy(params, *norm,
                                                             device="cpu"))
    tj = j_read(H2_TABLE, dtype=jnp.float64)
    jnet = JDeepFGM([(jnp.asarray(W), jnp.asarray(b)) for W, b in params],
                    *(jnp.asarray(v) for v in norm))
    _run(solver, st, _jax_twin(solver, tj, jnet), 4e-6 * 96 / 24, 2)


def _run(solver, st, solver_j, dt, n):
    sj = _state_j(st)
    step = jax.jit(lambda s: solver_j.step(s, dt))
    for _ in range(n):
        sj, dj = step(sj)
        st, dt_ = solver.step(st, dt)
    assert isinstance(st, FGMState)
    for k in FIELDS:
        assert _rel(getattr(sj, k), getattr(st, k)) <= 1e-8, k
    assert _rel(sj.U, st.U) <= 1e-6
    for ax in range(3):
        assert _rel(sj.phi[ax], st.phi[ax]) <= 1e-6
    for k in ("T_max", "c_max"):
        assert abs(float(dj[k]) - float(dt_[k])) <= 1e-8 * abs(float(dj[k]))
    assert float(st.c.max()) <= 1.0 and bool(torch.isfinite(st.T).all())
    assert int(dt_["iters_Z"]) > 0 and int(dt_["iters_p"]) > 0
