"""Two of the examples' low-Mach families in the PyTorch port
(cases.flame_1d, reacting_tgv_2d) against the same cases built with the
JAX package's functions exactly as examples/flame_1d.py and
reacting_tgv_2d.py build them, float64 on the CPU on the 9-species test
mechanism (the examples load H2_Li, which the repository lacks). Both
packages take 2 steps from the same initial state. The third,
jet_flame_2d, is in test_torch_examples_jet.py (three JAX compiles of
its step, one a model).

Tolerances: the initial states within 1e-14 of each field's largest value
(the same arithmetic); after the steps every field within TOL of its
largest value and every Krylov iteration count equal; the written
function-object files within TOL of each column's largest value. The face
flux is one field over the three axes: each axis's deviation is taken over
the largest |phi| of all faces (the jet's transverse flux peaks at 2e-6
of the axial one, so its own largest value is round-off's scale)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.combustion import Laminar
from deepflame_tpu.mesh import StructuredMesh, cyclic, empty, zero_gradient
from deepflame_tpu.runtime import (ControlDict, FieldMinMax, FunctionObjectSet,
                                   LineSample)
from deepflame_tpu.runtime.driver import run_case
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
from deepflame_tpu.utils.flame_speed import flame_position, flame_thickness

from deepflame_torch import cases
from deepflame_torch.ops import kernels as K
from deepflame_torch.runtime.driver import run_case as t_run_case

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
FIELDS = ("p", "T", "U", "Y", "rho", "ha", "dpdt")
TOL = 1e-10
ITERS = ("iters_U", "iters_Y", "iters_h", "iters_p")


def _rel(a, b):
    """Largest deviation of the port's b from JAX's a over a's largest."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _check_state(sj, st, tol, fields=FIELDS):
    devs = {k: _rel(getattr(sj, k), getattr(st, k)) for k in fields}
    phi_max = max(float(np.abs(np.asarray(f)).max()) for f in sj.phi)
    devs.update({f"phi{ax}": np.abs(np.asarray(sj.phi[ax])
                                    - st.phi[ax].numpy()).max()
                 / max(phi_max, 1e-300) for ax in range(3)})
    devs.update({f"turb{i}": _rel(a, b)
                 for i, (a, b) in enumerate(zip(sj.turb, st.turb))})
    bad = {k: v for k, v in devs.items() if not v <= tol}
    assert not bad, bad


def _mixture(mech):
    ns = mech.n_species
    Yu = np.zeros(ns)
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    Yu[iH2], Yu[iO2], Yu[iN2] = 0.0285, 0.2264, 0.7451
    return Yu


def _strong(s):
    """The JAX state with every leaf strongly typed (the examples' jnp.full
    without a dtype gives weak-typed p and T, and the step's output is
    strong, so a jitted step would compile twice); values unchanged."""
    return jax.tree_util.tree_map(lambda a: jnp.array(a, dtype=a.dtype), s)


def _steps(solver_j, sj, solver_t, st, dt, n):
    """n steps of both; every field within TOL and the iterations equal
    after each. Returns the JAX states and the port's, in order."""
    step = jax.jit(lambda s: solver_j.step(s, dt))
    sj = _strong(sj)
    K.reset_launches()
    out_j, out_t = [], []
    for _ in range(n):
        sj, dj = step(sj)
        st, dt_ = solver_t.step(st, dt)
        assert {k: int(dj[k]) for k in ITERS if k in dj} == \
            {k: int(dt_[k]) for k in ITERS if k in dj}
        _check_state(sj, st, TOL)
        out_j.append(sj)
        out_t.append(st)
    assert all(v == 0 for v in K.launches.values())
    return out_j, out_t


# ------------------------------------------------------- A16 flame_1d.py

def _jax_flame_1d(n):
    """examples/flame_1d.py:44-91 in float64 at n cells."""
    dtype = jnp.float64
    mech = load_mechanism(MECH)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    L = 0.012
    mesh = StructuredMesh.box([L, L / n, L / n], [n, 1, 1])
    e = (empty(), empty())
    b = ((zero_gradient(), zero_gradient()), e, e)
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-6, atol=1e-12, max_steps=20000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
        config=LowMachConfig(chemistry=True,
                             inert_index=int(mech.species_index("N2"))))
    Yu = _mixture(mech)
    X, _, _ = mesh.cell_centers(dtype)
    w = 8.0 * mesh.dx
    prof = 0.5 * (1.0 - jnp.tanh((X - 0.25 * L) / w))
    T = (300.0 + (2400.0 - 300.0) * prof).astype(dtype)
    p = jnp.full(mesh.shape, 101325.0, dtype)
    Y = jnp.asarray(np.tile(Yu[:, None, None, None], (1,) + mesh.shape), dtype)
    s = solver.initial_state(p, T, Y)
    return solver, s, min(2e-7, 0.35 * mesh.dx / 1200.0), mesh


def test_flame_1d_matches_the_example():
    """flame_1d at 32 cells: dt and the initial state as the example's,
    then 2 steps within TOL with equal iterations. Every side is
    zeroGradient, the pressure's too, so the pressure CG pins the level
    as JAX's does; its iterations are compared with the rest."""
    solver_j, sj, dt_j, mesh = _jax_flame_1d(32)
    solver_t, st, dt, info = cases.flame_1d(MECH, n=32, device="cpu")
    assert dt == dt_j and info["every"] == 10 and info["steps"] == 400
    np.testing.assert_array_equal(info["x"],
                                  np.asarray(mesh.cell_centers()[0]).ravel())
    _check_state(sj, st, 1e-14)
    assert [bc.kind for bc in solver_t.bcs_p[0]] == ["zeroGradient"] * 2
    _steps(solver_j, sj, solver_t, st, dt, 2)


def test_flame_1d_speed_reads_like_the_example():
    """flame_1d_speed on a synthetic run of 40 reads (a tanh front moving
    at 3 m/s into gas at 0.8 m/s) against examples/flame_1d.py:100-114:
    displacement speed, u_ahead, S_L and the thickness within 1e-12."""
    n, L = 256, 0.012
    dx = L / n
    x = (np.arange(n) + 0.5) * dx
    times = np.arange(1, 41) * 2e-6
    fronts = []
    for t in times:
        T = 300.0 + 2100.0 * 0.5 * (1.0 - np.tanh((x - 0.003 - 3.0 * t)
                                                  / (8 * dx)))
        fronts.append(flame_position(x, T))
    U = 0.8 + 0.1 * np.sin(x / L * 7.0)
    got = cases.flame_1d_speed(list(times), fronts, x, T, U, dx=dx)
    sel = slice(len(times) // 2, None)
    disp = np.polyfit(times[sel], np.asarray(fronts)[sel], 1)[0]
    i_f = int(np.argmin(np.abs(x - fronts[-1])))
    i_ahead = min(i_f + max(3, int(1e-3 / dx // 2)), len(x) - 2)
    assert got["i_ahead"] == i_ahead == i_f + 10
    assert got["displacement"] == pytest.approx(disp, rel=1e-12)
    assert got["u_ahead"] == U[i_ahead]
    assert got["S_L"] == pytest.approx(disp - U[i_ahead], rel=1e-12)
    assert got["thickness"] == pytest.approx(flame_thickness(x, T), rel=1e-12)
    assert 2.5 < disp < 3.5
    # the default dx is the centres' spacing; the last front near the end
    # takes the last cell but one
    late = cases.flame_1d_speed(list(times), fronts[:-1] + [x[-3]], x, T, U)
    assert late["i_ahead"] == n - 2


# ------------------------------------------------ A17 reacting_tgv_2d.py

def _jax_tgv_2d(n, out):
    """examples/reacting_tgv_2d.py:47-85 in float64 at n x n cells, its
    function objects writing under out."""
    dtype = jnp.float64
    mech = load_mechanism(MECH)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    L = 2.0 * np.pi * 1e-3
    mesh = StructuredMesh.box([L, L, L / n], [n, n, 1])
    b = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    comb = Laminar(th, kin, ode_opts=RosenbrockOptions(
        rtol=1e-6, atol=1e-12, max_steps=20000, grow=10.0))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
        config=LowMachConfig(chemistry=True,
                             inert_index=int(mech.species_index("N2"))))
    Yu = _mixture(mech)
    X, Yg, _ = mesh.cell_centers(dtype)
    k = 2.0 * np.pi / L
    U0 = 5.0
    U = jnp.stack([U0 * jnp.sin(k * X) * jnp.cos(k * Yg),
                   -U0 * jnp.cos(k * X) * jnp.sin(k * Yg),
                   jnp.zeros(mesh.shape)])
    r2 = (X - L / 2) ** 2 + (Yg - L / 2) ** 2
    T = jnp.where(r2 < (L / 6) ** 2, 1800.0, 300.0).astype(dtype)
    p = jnp.full(mesh.shape, 101325.0, dtype)
    Y = jnp.asarray(np.tile(Yu[:, None, None, None], (1,) + mesh.shape), dtype)
    s = solver.initial_state(p, T, Y, U)
    fos = FunctionObjectSet([
        FieldMinMax(mesh, ["T", "p"], out_dir=f"{out}/fieldMinMax"),
        LineSample(mesh, 0, (0.0, L / 2, 0.0), ["T"],
                   out_dir=f"{out}/sample"),
    ])
    return solver, s, fos, mesh


def _written(d):
    """{relative path: array} of every file under d."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = np.loadtxt(p, ndmin=2)
    return out


def test_reacting_tgv_2d_run_case_matches_the_example(tmp_path):
    """reacting_tgv_2d at 8 x 8 through run_case to 2 dt with a write each
    step, against the example's run_case in JAX: the final fields within
    TOL; the fieldMinMax file's values and the line sample's columns
    within TOL of each column's largest value, the line's coordinates the
    cell centres at y = L/2 and every min/max location a cell whose value
    lies within TOL of the extremum in the port's own fields."""
    dt = 2.5e-7
    solver_j, sj0, fos_j, mesh = _jax_tgv_2d(8, str(tmp_path / "jax"))
    solver_t, st0, fos_t, control = cases.reacting_tgv_2d(
        MECH, n=8, out_dir=str(tmp_path / "port"), device="cpu")
    assert (control.end_time, control.delta_t, control.write_interval) == \
        (5e-4, dt, 1e-4)
    _check_state(sj0, st0, 1e-14)
    ctrl = ControlDict(end_time=2 * dt, delta_t=dt, write_interval=dt)
    sj = run_case(solver_j, sj0, ctrl, function_objects=fos_j,
                  fields_fn=lambda st: {"T": st.T, "p": st.p}, log_every=100)
    K.reset_launches()
    mine = []                      # the port's fields at each write

    def fields(s):
        out = cases.tgv_fields(s)
        mine.append({k: v.numpy().ravel() for k, v in out.items()})
        return out

    st = t_run_case(solver_t, st0, dataclasses.replace(
        control, end_time=2 * dt, write_interval=dt),
        function_objects=fos_t, fields_fn=fields, log_every=100)
    assert all(v == 0 for v in K.launches.values())
    _check_state(sj, st, TOL)
    ref, got = _written(str(tmp_path / "jax")), _written(str(tmp_path /
                                                             "port"))
    assert set(ref) == set(got) and len(ref) == 3
    centres = np.stack([np.asarray(c).ravel() for c in mesh.cell_centers()],
                       1)
    for path, a in ref.items():
        b = got[path]
        assert a.shape == b.shape, path
        scale = np.maximum(np.abs(a).max(0), 1e-300)
        if "line_" in path:
            L = 2.0 * np.pi * 1e-3
            np.testing.assert_allclose(b[:, 0], (np.arange(8) + 0.5) * L / 8,
                                       rtol=1e-15)
            assert (np.abs(a - b).max(0) <= TOL * scale).all(), path
            continue
        assert a.shape == (2, 17)
        for i in range(2):
            for k, name in enumerate(("T", "p")):
                f = mine[i][name]
                for off, ext in ((1, f.min()), (5, f.max())):
                    c = 8 * k + off
                    assert abs(a[i, c] - b[i, c]) <= TOL * scale[c]
                    ties = np.abs(f - ext) <= TOL * np.abs(f).max()
                    for row in (a[i], b[i]):
                        cell = np.argmin(((centres - row[c + 1:c + 4]) ** 2)
                                         .sum(1))
                        assert ties[cell], (path, name, i)
