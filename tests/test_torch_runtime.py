"""The port's case runtime (config, factory, driver, checkpoint, timers)
against the JAX package's, on the CPU in float64.

Solver steps are held to the tolerances of tests/test_torch_low_mach.py
(1e-8 of each field, 1e-6 of velocity and fluxes); configurations and
checkpoint contents must be equal.
"""
import dataclasses
import glob
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import dnn as jdnn
from deepflame_tpu.mesh import StructuredMesh, cyclic, empty
from deepflame_tpu.runtime import checkpoint as jckpt
from deepflame_tpu.runtime import config as jconfig
from deepflame_tpu.runtime import driver as jdriver
from deepflame_tpu.runtime import factory as jfactory

import deepflame_torch.mesh as tmesh
from deepflame_torch.ops import kernels as K
from deepflame_torch.runtime import (checkpoint as tckpt, config as tconfig,
                                     driver as tdriver, factory as tfactory,
                                     timers as ttimers)
from test_torch_low_mach import FIELDS, RTOL_FLOW, _rel, _to_port, run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MECH = os.path.join(ROOT, "tests", "data", "h2_air_9sp.json")
CASES = sorted(glob.glob(os.path.join(ROOT, "examples", "cases", "*.yaml")))


@pytest.mark.parametrize("path", CASES, ids=os.path.basename)
def test_load_case_matches_jax(path):
    """Every example case file loads to the same configuration, or, where
    the JAX package rejects it (sandia_d_wedge_fgm.yaml carries FGM keys
    that CombustionProperties does not have), is rejected alike."""
    try:
        ref = dataclasses.asdict(jconfig.load_case(path))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.load_case(path)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tconfig.load_case(path)) == ref


def test_load_case_rejects_unknown_keys(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("control:\n  end_tme: 1.0\n")
    with pytest.raises(ValueError, match="end_tme"):
        tconfig.load_case(str(bad))


def _hot_spot(mesh, mech):
    """The 2D hot spot of __graft_entry__._build: a 2000 K disc of radius
    L/4 in an 800 K phi ~ 1 H2/air mixture at rest."""
    Y = np.zeros(mech.n_species)
    for s, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[mech.species_index(s)] = y
    L = 2e-3
    X, Yg, _ = mesh.cell_centers(jnp.float64)
    T = jnp.where((X - L / 2) ** 2 + (Yg - L / 2) ** 2 < (L / 4) ** 2,
                  2000.0, 800.0)
    p = jnp.full(mesh.shape, 101325.0)
    return p, T, jnp.asarray(np.tile(Y[:, None, None, None],
                                     (1,) + mesh.shape))


def _both_from_case(case, n=8):
    """The 2D periodic hot-spot case built by each package's factory."""
    L = 2e-3
    bj = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    bt = ((tmesh.cyclic(), tmesh.cyclic()), (tmesh.cyclic(), tmesh.cyclic()),
          (tmesh.empty(), tmesh.empty()))
    mesh_j = StructuredMesh.box([L, L, L / n], [n, n, 1])
    mesh_t = tmesh.StructuredMesh.box([L, L, L / n], [n, n, 1], device="cpu")
    solver_j, mech_j = jfactory.build_low_mach_solver(
        case, mesh_j, (bj, bj, bj), bj, bj, bj, bj)
    solver_t, mech_t = tfactory.build_low_mach_solver(
        case, mesh_t, (bt, bt, bt), bt, bt, bt, bt)
    assert mech_t.species_names == mech_j.species_names
    state_j = solver_j.initial_state(*_hot_spot(mesh_j, mech_j))
    return solver_j, state_j, solver_t


def test_factory_solver_from_yaml_steps_like_jax():
    """build_low_mach_solver from examples/cases/reacting_tgv.yaml (laminar
    stiff chemistry, 2 outer correctors, float64) with the test mechanism,
    2 steps of 1 us on the 2D hot spot.

    The pressure iterations may differ by 3 over a step: this file stops the
    pressure CG at 1e-3 of its initial residual (the default is 1e-2), where
    the normalized L1 residual creeps along the stop, and round-off
    differences of the two residuals (1e-10 relative) move the stop by two
    or three iterations, while p agrees to 2e-12 and every field to 2e-11 of
    its largest value. The other solves' counts are equal."""
    case = jconfig.load_case(os.path.join(ROOT, "examples", "cases",
                                          "reacting_tgv.yaml"))
    case = dataclasses.replace(case, chemistry=dataclasses.replace(
        case.chemistry, mechanism_file=MECH))
    tcase = tconfig.load_case(os.path.join(ROOT, "examples", "cases",
                                           "reacting_tgv.yaml"))
    tcase = dataclasses.replace(tcase, chemistry=dataclasses.replace(
        tcase.chemistry, mechanism_file=MECH))
    solver_j, state_j = _both_from_case(case)[:2]
    solver_t = _both_from_case(tcase)[2]
    assert solver_t.config.n_outer == 2 and solver_t.dtype == torch.float64
    assert solver_t.combustion.ode_opts.rtol == 1e-6
    run_both(solver_j, state_j, solver_t, 1e-6, 2, iters_p_slack=3)


def _dnn_case(tmp_path, hidden=(64, 32, 16)):
    """A float64 DNN case whose checkpoint is an npz of seeded weights in
    examples/train_dfodenet.py's layout."""
    rng = np.random.default_rng(21)
    ns = 9
    sizes = (ns + 2,) + hidden + (1,)
    flat = {}
    for i in range(ns - 1):
        for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            flat[f"net{i}_W{j}"] = rng.normal(size=(a, b)) * (2.0 / a) ** 0.5
            flat[f"net{i}_b{j}"] = np.zeros(b)
    path = str(tmp_path / "net.npz")
    np.savez(path, x_mean=np.zeros(ns + 2), x_std=np.ones(ns + 2),
             y_mean=np.zeros(ns - 1), y_std=np.full(ns - 1, 1e-6),
             delta_t=1e-6, n_species=ns, n_layers=len(hidden) + 1, **flat)
    kw = dict(chemistry=dict(mechanism_file=MECH, torch_on=True,
                             torch_model=path, frozen_temperature=700.0),
              combustion=dict(model="DNN"), control=dict(
                  end_time=4e-6, delta_t=1e-6, write_interval=2e-6),
              dtype="float64")

    def make(mod):
        return mod.CaseConfig(
            chemistry=mod.ChemistryProperties(**kw["chemistry"]),
            combustion=mod.CombustionProperties(**kw["combustion"]),
            control=mod.ControlDict(**kw["control"]), dtype=kw["dtype"])
    return make(jconfig), make(tconfig)


def test_run_case_splitting_matches_jax_and_restarts(tmp_path):
    """run_case with splitting (chemistry every second step at twice dt) on
    the 2D hot spot with DNN chemistry from an npz checkpoint, 4 steps of
    1 us with a checkpoint every 2: the port's final state and checkpoints
    match JAX's. Then the JAX-written checkpoint restarts the port, which
    continues as a run from the port's own state does."""
    case_j, case_t = _dnn_case(tmp_path)
    solver_j, state_j0, solver_t = _both_from_case(case_j)
    _, _, solver_t = _both_from_case(case_t)
    assert type(solver_t.combustion).__name__ == "DNNChemistry"
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    state_j = jdriver.run_case(solver_j, state_j0, case_j.control,
                               checkpoint_dir=jdir, splitting=True)
    K.reset_launches()
    state_t = tdriver.run_case(solver_t, _to_port(state_j0), case_t.control,
                               checkpoint_dir=tdir, splitting=True)
    assert all(v == 0 for v in K.launches.values())
    for k in FIELDS:
        tol = RTOL_FLOW if k == "U" else 1e-8
        assert _rel(getattr(state_j, k), getattr(state_t, k)) <= tol, k
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["2e-06", "4e-06"]
    assert tckpt.load_meta(tdir)["n_leaves"] == \
        jckpt.load_meta(jdir)["n_leaves"] == 12

    # the JAX checkpoint, read by the port, is the JAX state bit for bit
    back = tckpt.load_state(jdir, like=state_t)
    for k in FIELDS + ("dpdt", "time", "chem_dt"):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(state_j, k)))
    for ax in range(3):
        np.testing.assert_array_equal(back.phi[ax].numpy(),
                                      np.asarray(state_j.phi[ax]))

    # restart from it and run to 6 us, against the port's own continuation
    rdir = str(tmp_path / "restart")
    shutil.copytree(jdir, rdir)
    longer = dataclasses.replace(case_t.control, end_time=6e-6)
    restarted = tdriver.run_case(solver_t, _to_port(state_j0), longer,
                                 checkpoint_dir=rdir, splitting=True,
                                 restart=True)
    own = tdriver.run_case(solver_t, state_t, longer, splitting=True)
    assert float(restarted.time) == pytest.approx(6e-6, rel=1e-12)
    for k in FIELDS:
        tol = RTOL_FLOW if k == "U" else 1e-8
        assert _rel(getattr(own, k).numpy(), getattr(restarted, k)) <= tol, k
    assert sorted(os.listdir(rdir)) == ["2e-06", "4e-06", "6e-06"]


def test_port_checkpoint_round_trip(tmp_path):
    """save_state then load_state restores every tensor bit for bit, a None
    chem_dt included."""
    from deepflame_torch.cases import reacting_hot_spot_2d
    _, state = reacting_hot_spot_2d(MECH, n=4, dtype=torch.float64,
                                    chemistry=False, device="cpu")
    assert state.chem_dt is None
    tckpt.save_state(str(tmp_path), state, 1.5e-6, meta={"dt": 1e-7})
    assert tckpt.latest_time(str(tmp_path)) == 1.5e-6
    assert tckpt.load_meta(str(tmp_path))["n_leaves"] == 11
    back = tckpt.load_state(str(tmp_path), like=state)
    for a, b in zip(tckpt._leaves(back), tckpt._leaves(state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(str(tmp_path), like=state._replace(
            chem_dt=torch.zeros(())))


def test_factory_selection():
    """Unported models raise NotImplementedError naming their ROADMAP item;
    the LES models the port has are built."""
    C = tconfig
    for model in ("EDC", "PaSR"):
        case = C.CaseConfig(combustion=C.CombustionProperties(model=model))
        with pytest.raises(NotImplementedError, match="A11"):
            tfactory.build_combustion(case, None, None)
    for les in ("Smagorinsky", "WALE", "Sigma", "dynamicSmagorinsky"):
        turb = tfactory.build_turbulence(C.CaseConfig(
            turbulence=C.TurbulenceProperties(simulation_type="LES",
                                              les_model=les, Pr_t=0.9)))
        assert turb.Pr_t == 0.9 and turb.kind == les
    with pytest.raises(NotImplementedError, match="A12"):
        tfactory.build_turbulence(C.CaseConfig(
            turbulence=C.TurbulenceProperties(simulation_type="RAS")))
    with pytest.raises(NotImplementedError, match="A10"):
        tfactory.build_high_speed_solver()
    assert tfactory.build_turbulence(C.CaseConfig()) is None


def test_phase_timers_and_trace(tmp_path):
    timers = ttimers.PhaseTimers()
    for _ in range(2):
        with timers.phase("solve"):
            torch.ones(8).sum()
    assert timers.counts["solve"] == 2
    assert "solve" in timers.report()
    with ttimers.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_run_case_restart_keeps_the_float32_clock(tmp_path):
    """A float32 state's time is off by its rounding (1e-6 s is stored as
    9.99999997e-07 s). The port's run_case resumes from the clock it wrote
    into meta.json, so a restart ends at end_time and keeps the write
    schedule; resuming from state.time (as the JAX driver does) would take
    one step more and write at 1.25e-6 s."""
    from deepflame_torch.cases import reacting_hot_spot_2d
    _, state0 = reacting_hot_spot_2d(MECH, n=4, dtype=torch.float32,
                                     chemistry=False, device="cpu")

    class Clock:
        """A solver whose step only advances the state's float32 time."""
        steps = 0

        def step(self, s, dt):
            Clock.steps += 1
            return s._replace(time=s.time + dt), {}

    ctl = tconfig.ControlDict(end_time=1e-6, delta_t=2.5e-7,
                              write_interval=5e-7)
    d = str(tmp_path)
    tdriver.run_case(Clock(), state0, ctl, checkpoint_dir=d)
    assert float(tckpt.load_state(d, like=state0).time) != 1e-6
    Clock.steps = 0
    out = tdriver.run_case(Clock(), state0, dataclasses.replace(
        ctl, end_time=1.5e-6), checkpoint_dir=d, restart=True)
    assert Clock.steps == 2
    assert sorted(os.listdir(d)) == ["1.5e-06", "1e-06", "5e-07"]
    assert float(out.time) == pytest.approx(1.5e-6, rel=1e-6)
