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

import deepflame_tpu.chemistry as jc_chem
from deepflame_tpu.chemistry import dnn as jdnn
from deepflame_tpu.mesh import StructuredMesh, cyclic, empty
from deepflame_tpu.mesh import zero_gradient as jzg
from deepflame_tpu.runtime import checkpoint as jckpt
from deepflame_tpu.runtime import config as jconfig
from deepflame_tpu.runtime import driver as jdriver
from deepflame_tpu.runtime import factory as jfactory

import deepflame_torch.chemistry as tc_chem
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
    """EDC and PaSR are built from CombustionProperties as the JAX factory
    builds them; the LES models are built; the three RAS models equal the
    JAX factory's field by field and an unknown one raises ValueError; the
    density-based
    solver's config is the JAX factory's for two case dictionaries."""
    C = tconfig
    mech = tc_chem.load_mechanism(MECH, device="cpu")
    th, kin = tc_chem.make_thermo(mech), tc_chem.make_kinetics(mech)
    mj = jc_chem.load_mechanism(MECH)
    thj, kinj = jc_chem.make_thermo(mj), jc_chem.make_kinetics(mj)
    for comb in (dict(model="EDC", edc_version="v2016"),
                 dict(model="PaSR", pasr_mixing_scale="dynamicScale",
                      pasr_chemistry_scale="globalConvertion",
                      pasr_Cmix=0.2)):
        got = tfactory.build_combustion(C.CaseConfig(
            combustion=C.CombustionProperties(**comb)), th, kin)
        ref = jfactory.build_combustion(jconfig.CaseConfig(
            combustion=jconfig.CombustionProperties(**comb)), thj, kinj)
        assert type(got).__name__ == type(ref).__name__ == comb["model"]
        for f in dataclasses.fields(ref):
            if f.name not in ("thermo", "kinetics", "dlb_cross_shard"):
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
    for les in ("Smagorinsky", "WALE", "Sigma", "dynamicSmagorinsky"):
        turb = tfactory.build_turbulence(C.CaseConfig(
            turbulence=C.TurbulenceProperties(simulation_type="LES",
                                              les_model=les, Pr_t=0.9)))
        assert turb.Pr_t == 0.9 and turb.kind == les
    # the RAS models: JAX's model, field by field (the SST model's y is
    # None from the factory in both)
    for ras in ("kEpsilon", "RNGkEpsilon", "kOmegaSST"):
        kw = dict(simulation_type="RAS", ras_model=ras, Pr_t=0.9, Sc_t=0.8)
        got = tfactory.build_turbulence(C.CaseConfig(
            turbulence=C.TurbulenceProperties(**kw)))
        ref = jfactory.build_turbulence(jconfig.CaseConfig(
            turbulence=jconfig.TurbulenceProperties(**kw)))
        assert type(got).__name__ == type(ref).__name__
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(ref)]
        for f in dataclasses.fields(ref):
            assert getattr(got, f.name) == getattr(ref, f.name), (ras, f.name)
    with pytest.raises(ValueError, match="kOmega"):
        tfactory.build_turbulence(C.CaseConfig(
            turbulence=C.TurbulenceProperties(simulation_type="RAS",
                                              ras_model="kOmega")))
    # the density-based solver: the JAX factory's config, field by field
    b = ((tmesh.zero_gradient(), tmesh.zero_gradient()),) * 3
    bj = ((jzg(), jzg()),) * 3
    for chem, schemes in (
            (dict(), dict()),
            (dict(chemistry=False, ode_rtol=1e-5, ode_atol=1e-9),
             dict(flux_scheme="AUSMDV", rk_order=3, limiter="WENO5"))):
        kw = dict(chemistry=C.ChemistryProperties(mechanism_file=MECH, **chem),
                  schemes=C.Schemes(**schemes), dtype="float64")
        got, mech_t = tfactory.build_high_speed_solver(
            C.CaseConfig(**kw), tmesh.StructuredMesh.box(
                [1.0, 1.0, 1.0], [4, 4, 4], device="cpu"), b, (b, b, b), b, b)
        ref, _ = jfactory.build_high_speed_solver(
            jconfig.CaseConfig(
                chemistry=jconfig.ChemistryProperties(mechanism_file=MECH,
                                                      **chem),
                schemes=jconfig.Schemes(**schemes), dtype="float64"),
            StructuredMesh.box([1.0, 1.0, 1.0], [4, 4, 4]), bj, (bj,) * 3,
            bj, bj)
        assert mech_t.n_species == 9 and got.thermo.W.dtype == torch.float64
        for f in dataclasses.fields(ref.config):
            a, r = getattr(got.config, f.name), getattr(ref.config, f.name)
            assert (tuple(a) == tuple(r)) if f.name == "ode_opts" else a == r, \
                f.name
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


# ------------------------------------------- PaSR jet with function objects

JET_DT = 5e-7


def _jax_jet_function_objects(solver, out_dir, dt):
    """The JAX package's classes in the set of cases.jet_function_objects
    (with Z)."""
    from deepflame_tpu.runtime import derived as D
    from deepflame_tpu.runtime import function_objects as F
    mesh, bcs_U = solver.mesh, solver.bcs_U
    sub = lambda name: os.path.join(out_dir, name)
    specs = {
        "magVorticity": lambda f: jnp.sqrt(
            (D.vorticity(f["U"], bcs_U, mesh) ** 2).sum(0)),
        "Q": lambda f: D.q_criterion(f["U"], bcs_U, mesh),
        "lambda2": lambda f: D.lambda2(f["U"], bcs_U, mesh),
        "Ma": lambda f: D.mach_number(f["U"], f["T"],
                                      jnp.moveaxis(f["Y"], 0, -1),
                                      solver.thermo),
        "Co": lambda f: D.courant_no(f["U"], dt, mesh),
    }
    axis_x = [(x, 0.0, 0.0) for x in (0.005, 0.015, 0.030, 0.045, 0.055)]
    objs = [
        F.FieldMinMax(mesh, ("T", "p", "Q", "Z"), sub("fieldMinMax")),
        F.Probes(mesh, axis_x, ("T", "Z"), sub("probes")),
        F.LineSample(mesh, 0, (0.0, 0.0, 0.0), ("T", "Ma", "Z"),
                     sub("sample_axis")),
        F.LineSample(mesh, 1, (0.030, 0.0, 0.0), ("T", "Q", "Z"),
                     sub("sample_y30")),
        F.FieldAverage(("T", "U")),
        F.VolFieldValue(mesh, ("T",), ("volAverage", "max", "CoV"),
                        out_dir=sub("volFieldValue_T")),
        F.VolFieldValue(mesh, ("Z",), ("volIntegrate",),
                        out_dir=sub("volFieldValue_Z")),
        F.SurfaceFieldValue(mesh, ("phi_x",), axis=0, index=mesh.nx,
                            ops=("areaIntegrate",),
                            out_dir=sub("surfaceFieldValue")),
        F.Histogram("T", 50, out_dir=sub("histogram")),
        F.VolFieldValue(mesh, ("Co", "magVorticity", "lambda2"),
                        ("max",), out_dir=sub("volFieldValue_flow")),
    ]
    return D.DerivedFields(specs, F.FunctionObjectSet(objs)), objs[4]


def _jax_fields(s):
    return dict(T=s.T, p=s.p, U=s.U, Y=s.Y, rho=s.rho, phi_x=s.phi[0],
                Z=s.cscalars[0])


def _pasr_case(mod):
    """PaSR dynamicScale from the factory, with the jet's own stiff
    tolerances."""
    return mod.CaseConfig(
        chemistry=mod.ChemistryProperties(mechanism_file=MECH, ode_rtol=1e-4,
                                          ode_atol=1e-8),
        combustion=mod.CombustionProperties(
            model="PaSR", pasr_mixing_scale="dynamicScale"),
        control=mod.ControlDict(end_time=2 * JET_DT, delta_t=JET_DT,
                                write_interval=JET_DT),
        dtype="float64")


@pytest.fixture(scope="module")
def pasr_jet(tmp_path_factory):
    """The 16 x 8 x 8 structured jet with PaSR dynamicScale (Z fixed at the
    inlet to Y_H2 / 0.30) through each package's run_case, 2 steps with a
    write every step: JAX in one run; the port to the first write, then
    restarted from its checkpoint to the second, each run with its own
    function-object set."""
    from deepflame_torch.cases import jet_flame_3d_les, jet_with_combustion
    from deepflame_torch.cases import jet_fields, jet_function_objects
    from deepflame_tpu.mesh import fixed_value, zero_gradient
    from test_torch_low_mach_jet import jax_jet

    root = tmp_path_factory.mktemp("pasr_jet")
    solver_j, s0 = jax_jet(8)
    iH2 = jc_chem.load_mechanism(MECH).species_index("H2")
    zg = zero_gradient()
    comb_j = jfactory.build_combustion(_pasr_case(jconfig),
                                       solver_j.thermo,
                                       solver_j.combustion.kinetics)
    solver_j = dataclasses.replace(
        solver_j, combustion=comb_j, bcs_Z=(
            (fixed_value(solver_j.bcs_Y[iH2][0][0].value / 0.30), zg),
            (zg, zg), (zg, zg)))
    state_j0 = solver_j.initial_state(s0.p, s0.T, s0.Y, s0.U,
                                      Z0=s0.Y[iH2] / 0.30)
    fo_j, avg_j = _jax_jet_function_objects(solver_j, str(root / "jax"),
                                            JET_DT)
    jdir = str(root / "jax_ckpt")
    state_j = jdriver.run_case(solver_j, state_j0, _pasr_case(jconfig).control,
                               function_objects=fo_j, fields_fn=_jax_fields,
                               checkpoint_dir=jdir)

    case_t = _pasr_case(tconfig)
    solver_t, st0 = jet_flame_3d_les(MECH, n=8, dtype=torch.float64,
                                     device="cpu")
    comb_t = tfactory.build_combustion(case_t, solver_t.thermo,
                                       solver_t.combustion.kinetics)
    solver_t, _ = jet_with_combustion(solver_t, st0, comb_t, iH2)
    tdir = str(root / "port_ckpt")
    fos = [jet_function_objects(solver_t, str(root / f"port{i}"), JET_DT)
           for i in (1, 2)]
    K.reset_launches()
    first = dataclasses.replace(case_t.control, end_time=JET_DT)
    tdriver.run_case(solver_t, _to_port(state_j0), first,
                     function_objects=fos[0], fields_fn=jet_fields,
                     checkpoint_dir=tdir)
    state_t = tdriver.run_case(solver_t, _to_port(state_j0), case_t.control,
                               function_objects=fos[1], fields_fn=jet_fields,
                               checkpoint_dir=tdir, restart=True)
    assert all(v == 0 for v in K.launches.values())
    return dict(root=root, jdir=jdir, tdir=tdir, state_j=state_j,
                solver_j=solver_j,
                state_t=state_t, avg_j=avg_j, fos=fos)


def test_run_case_pasr_jet_matches_jax(pasr_jet):
    """The final fields and the transported Z, Zvar and Chi against JAX's
    (1e-8 of each field's largest value, velocity and fluxes 1e-6)."""
    sj, st = pasr_jet["state_j"], pasr_jet["state_t"]
    for k in FIELDS:
        tol = RTOL_FLOW if k == "U" else 1e-8
        assert _rel(getattr(sj, k), getattr(st, k)) <= tol, k
    assert len(st.cscalars) == 3
    for name, a, b in zip(("Z", "Zvar", "Chi"), sj.cscalars, st.cscalars):
        assert _rel(a, b) <= 1e-8, name
    assert float(st.cscalars[0].max()) > 0.5       # the inlet's fuel stream
    assert float(st.cscalars[1].max()) > 0.0
    assert float(st.time) == pytest.approx(2 * JET_DT, rel=1e-12)
    # FieldAverage's means stay on the device, and agree
    avg_t = pasr_jet["fos"][1].inner.objects[4]
    assert isinstance(avg_t.mean["T"], torch.Tensor) and avg_t.n == 1
    assert sorted(os.listdir(pasr_jet["tdir"])) == ["1e-06", "5e-07"]


def _written(d):
    """{relative path: array} of every file under d."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = np.loadtxt(p, ndmin=2)
    return out


# columns that carry velocity (Q, lambda2, Ma, the outlet flux) take the
# velocity's tolerance; the rest the fields'
_FLOW_FILES = ("sample_axis", "sample_y30", "surfaceFieldValue",
               "volFieldValue_flow")


def test_run_case_pasr_jet_files_match_jax(pasr_jet):
    """Each function-object file of the JAX run against the port's (its
    first write from the first run, the second from the restarted one),
    read with np.loadtxt: probe and line coordinates and histogram counts
    equal; values within 1e-8 of each column's largest (1e-6 where the
    column derives from the velocity); FieldMinMax locations equal where
    the JAX file's min or max cell is the port's."""
    root = pasr_jet["root"]
    ref = _written(str(root / "jax"))
    got = [_written(str(root / f"port{i}")) for i in (1, 2)]
    assert len(ref) == 12 and set(ref) == set(got[0]) | set(got[1])
    for path, a in ref.items():
        parts = [g[path] for g in got if path in g]
        b = np.concatenate(parts, 0) if "line_" not in path \
            and "histogram" not in path else parts[-1]
        assert a.shape == b.shape, path
        tol = 1e-6 if path.split(os.sep)[0] in _FLOW_FILES \
            or "fieldMinMax" in path else 1e-8
        if "fieldMinMax" in path:
            _check_min_max(pasr_jet, a, b, ("T", "p", "Q", "Z"), tol)
            continue
        if "histogram" in path:
            np.testing.assert_array_equal(a[:, 1], b[:, 1])
        if "line_" in path:
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.maximum(np.abs(a).max(0), 1e-300)
        assert (np.abs(a - b).max(0) <= tol * scale).all(), path


def _check_min_max(pasr_jet, a, b, names, tol):
    """FieldMinMax rows a (JAX) and b (port): values within tol of each
    column's largest; each location the JAX one where the JAX field's
    extremum is alone by more than tol of the field's largest |value|,
    else a cell whose JAX value lies within that of the extremum (a tie)."""
    from deepflame_tpu.runtime.derived import q_criterion
    state_j = pasr_jet["state_j"]
    mesh = pasr_jet["solver_j"].mesh
    X = np.stack([np.asarray(c).ravel() for c in mesh.cell_centers()], 1)
    scale = np.maximum(np.abs(a).max(0), 1e-300)
    for i, t in enumerate(a[:, 0]):
        s = jckpt.load_state(pasr_jet["jdir"], like=state_j, time=t)
        fj = dict(T=s.T, p=s.p, Z=s.cscalars[0], Q=q_criterion(
            s.U, pasr_jet["solver_j"].bcs_U, mesh))
        for k, name in enumerate(names):
            f = np.asarray(fj[name]).ravel()
            fs = np.abs(f).max()
            for off, ext in ((1, f.min()), (5, f.max())):
                c = 8 * k + off
                assert abs(a[i, c] - b[i, c]) <= tol * scale[c], (name, t)
                ties = np.nonzero(np.abs(f - ext) <= tol * fs)[0]
                loc = [int(np.argmin(((X - r[c + 1:c + 4]) ** 2).sum(1)))
                       for r in (a[i], b[i])]
                if ties.size == 1:
                    assert loc[0] == loc[1], (name, t)
                else:
                    assert loc[1] in ties, (name, t)


def test_jax_pasr_checkpoint_restores_in_the_port(pasr_jet):
    """The JAX run's last checkpoint (15 leaves: the state's fields, phi's
    three faces, the three transported scalars and chem_dt) read by the
    port is the JAX state bit for bit, cscalars included."""
    sj, st = pasr_jet["state_j"], pasr_jet["state_t"]
    assert jckpt.load_meta(pasr_jet["jdir"])["n_leaves"] == 15
    back = tckpt.load_state(pasr_jet["jdir"], like=st)
    for k in FIELDS + ("dpdt", "time", "chem_dt"):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(sj, k)))
    for a, b in zip(back.phi + back.cscalars, sj.phi + sj.cscalars):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert back.turb == ()


@pytest.mark.parametrize("table", ["thermo", "transport", "kinetics"])
def test_low_mach_post_init_checks_the_tables_present(table):
    """LowMachSolver.__post_init__ holds each table that is present to the
    mesh's device and skips one that is None (the FGM solver has none).
    The structured steps themselves are held to JAX's by
    test_torch_low_mach.py (Laminar) and test_run_case_pasr_jet_matches_jax
    (PaSR)."""
    import types
    from deepflame_torch.cases import jet_flame_3d_les
    solver, _ = jet_flame_3d_les(MECH, n=2, dtype=torch.float64,
                                 device="cpu")
    field = "combustion" if table == "kinetics" else table
    moved = types.SimpleNamespace(W=torch.empty(1, device="meta"))
    if table == "kinetics":
        moved = types.SimpleNamespace(kinetics=moved)
    with pytest.raises(ValueError, match=f"{table} tables are on meta"):
        dataclasses.replace(solver, **{field: moved})
    assert getattr(dataclasses.replace(solver, **{field: None}), field) is None
