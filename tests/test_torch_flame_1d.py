"""The inlet-anchored 1D flame and the closed-loop DNN flame of the PyTorch
port (cases.flame_1d_anchored, dnn_closed_loop_flame, flame_1d_diagnostics,
closed_loop_compare, harvest_states) against examples/flame_1d_anchored.py
and examples/flame_dnn_closed_loop.py written with the JAX package's
functions, float64 on the CPU, at n = 32 on the 9-species test mechanism.
The burnt composition comes from the JAX package's ignition and reaches
the port through Y_burnt (the port's ignition is held to JAX's in
tests/test_torch_reactor.py; here a spy checks the call the cases make).
Tolerances are stated per test."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry import dnn as jdnn
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.chemistry.kinetics import production_rates
from deepflame_tpu.chemistry.reactor import ignite
from deepflame_tpu.combustion import Laminar
from deepflame_tpu.combustion.dnn_chemistry import DNNChemistry
from deepflame_tpu.mesh import StructuredMesh, empty, fixed_value, zero_gradient
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
from deepflame_tpu.utils.flame_speed import flame_position, flame_thickness

from deepflame_torch import cases
from deepflame_torch.convert import dfodenet_from_numpy
from deepflame_torch.ops import kernels as K

from test_torch_low_mach import _to_port

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
N, NS = 32, 9
HIDDEN = (32, 16, 8)
FIELDS = ("p", "T", "U", "Y", "rho", "ha")
# the closed loop's DF-ODENet: the JAX package's PRNGKey(1) weights, inputs
# scaled to the flame's range, targets small enough that two steps stay
# physical
STATS = dict(x_mean=np.r_[1500.0, 101325.0, np.full(NS, -5.0)],
             x_std=np.r_[700.0, 1e3, np.full(NS, 3.0)],
             y_mean=np.zeros(NS - 1), y_std=np.full(NS - 1, 1e-4))
# (example, T_ignite, ignition rtol, atol, Newton's T guess, length, u_in,
# T_u, dt's speed)
CASES = {"anchored": (1200.0, 1e-6, 1e-10, 2200.0, 0.008, 2.2, 300.0, 1200.0),
         "closed": (1400.0, 1e-4, 1e-8, 2400.0, 0.012, 5.0, 500.0, 1500.0)}


def _rel(a, b):
    """Largest deviation of the port's b from JAX's a over a's largest."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _nets():
    nets = jdnn.init_params(jax.random.PRNGKey(1), NS, HIDDEN, jnp.float64)
    return [[(np.asarray(W), np.asarray(b)) for W, b in net] for net in nets]


def _jax_flame(which: str, net=None):
    """The example's construction in float64 with the JAX package: its
    solvers ({"ode": Laminar} and, with `net`, {"dnn": DNNChemistry}),
    initial state, dt and what the readings need."""
    T_ign, rtol, atol, T_guess, L, u_in, T_u, speed = CASES[which]
    dtype = jnp.float64
    mech = load_mechanism(MECH)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    ns = mech.n_species
    iF, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    W = np.asarray(mech.molecular_weights)
    X = np.zeros(ns)
    X[iF], X[iO2], X[iN2] = 1.0, 0.5, 0.5 * 3.76
    Yu = X * W / (X * W).sum()
    p0 = 101325.0
    _, _, Yb_t = ignite(th, kin, jnp.asarray(T_ign, dtype), p0,
                        jnp.asarray(Yu, dtype), 5e-3,
                        opts=RosenbrockOptions(rtol=rtol, atol=atol,
                                               max_steps=20000))
    Yb = np.asarray(Yb_t[-1])
    h_u = th.h_mass(jnp.asarray(T_u, dtype), jnp.asarray(Yu, dtype))
    T_b = float(th.T_from_h(h_u, jnp.asarray(Yb, dtype),
                            jnp.asarray(T_guess, dtype)))
    mesh = StructuredMesh.box([L, L / N, L / N], [N, 1, 1])
    e = (empty(), empty())
    bU = ((fixed_value(u_in), zero_gradient()), e, e)
    bU0 = ((fixed_value(0.0), zero_gradient()), e, e)
    bp = ((zero_gradient(), fixed_value(p0)), e, e)
    bh = ((fixed_value(float(h_u)), zero_gradient()), e, e)
    rho_u = float(th.rho(jnp.asarray(p0, dtype), jnp.asarray(T_u, dtype),
                         jnp.asarray(Yu, dtype)))
    brho = ((fixed_value(rho_u), zero_gradient()), e, e)
    bY = [((fixed_value(float(Yu[k])), zero_gradient()), e, e)
          for k in range(ns)]
    ode_opts = RosenbrockOptions(rtol=1e-6, atol=1e-12, max_steps=20000,
                                 grow=10.0)
    models = {"ode": Laminar(th, kin, ode_opts=ode_opts)}
    if net is not None:
        models["dnn"] = DNNChemistry(th, kin, ode_opts=ode_opts, net=net)
    solvers = {name: LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(bU, bU0, bU0), bcs_p=bp, bcs_h=bh, bcs_Y=bY, bcs_rho=brho,
        config=LowMachConfig(chemistry=True, inert_index=int(iN2)))
        for name, comb in models.items()}
    Xc, _, _ = mesh.cell_centers(dtype)
    prof = 0.5 * (1.0 + jnp.tanh((Xc - 0.45 * L) / (6.0 * mesh.dx)))
    T0 = (T_u + (T_b - T_u) * prof).astype(dtype)
    Y0 = (jnp.asarray(Yu, dtype)[:, None, None, None] * (1 - prof)
          + jnp.asarray(Yb, dtype)[:, None, None, None] * prof)
    rho0 = th.rho(jnp.full(mesh.shape, p0, dtype), T0,
                  jnp.moveaxis(Y0, 0, -1))
    U0 = jnp.stack([rho_u * u_in / rho0, jnp.zeros_like(T0),
                    jnp.zeros_like(T0)])
    s = solvers["ode"].initial_state(jnp.full(mesh.shape, p0, dtype), T0, Y0,
                                     U0)
    info = dict(Yb=Yb, Yb_t=np.asarray(Yb_t), T_b=T_b, Yu=Yu, rho_u=rho_u,
                x=np.asarray(Xc).squeeze(), mesh=mesh, th=th, kin=kin, iF=iF,
                WF=float(W[iF]), mech=mech)
    return solvers, s, 5.0 * mesh.dx / speed, info


@pytest.fixture(scope="module")
def closed():
    """The closed loop in JAX: its solvers and state, 3 Laminar and 2 DNN
    steps (jitted once each), and the port's net."""
    nets = _nets()
    f = lambda a: jnp.asarray(a, jnp.float64)
    net_j = jdnn.DFODENet(nets=[[(f(W), f(b)) for W, b in net]
                                for net in nets],
                          **{k: f(v) for k, v in STATS.items()},
                          delta_t=1e-6, frozen_T=600.0)
    solvers, s0, dt, info = _jax_flame("closed", net_j)
    runs = {}
    for name, steps in (("ode", 3), ("dnn", 2)):
        step = jax.jit(lambda s, sv=solvers[name]: sv.step(s, dt))
        states, diags, s = [s0], [], s0
        for _ in range(steps):
            s, d = step(s)
            states.append(s)
            diags.append(d)
        runs[name] = (states, diags)
    net_t = dfodenet_from_numpy(nets, **STATS, delta_t=1e-6, frozen_T=700.0,
                                device="cpu")
    return solvers, s0, dt, info, runs, net_t


def _check_state(sj, st, tol):
    for k in FIELDS:
        assert _rel(getattr(sj, k), getattr(st, k)) <= tol, k
    for ax in range(3):
        assert _rel(sj.phi[ax], st.phi[ax]) <= tol, ("phi", ax)


def test_anchored_initial_state_matches_the_example():
    """flame_1d_anchored at n = 32 against examples/flame_1d_anchored.py
    :60-131 in JAX, given JAX's burnt composition: every field and face
    flux, T_b and the inflow density within 1e-12; dt 5 dx / 1200."""
    _, sj, dtj, info = _jax_flame("anchored")
    solver, st, dt, tinfo = cases.flame_1d_anchored(
        MECH, n=N, dtype=torch.float64, device="cpu", Y_burnt=info["Yb"])
    _check_state(sj, st, 1e-12)
    assert abs(tinfo["T_b"] - info["T_b"]) <= 1e-12 * info["T_b"]
    assert abs(tinfo["rho_u"] - info["rho_u"]) <= 1e-12 * info["rho_u"]
    assert dt == pytest.approx(dtj, rel=1e-15)
    assert solver.mesh.shape == (N, 1, 1)
    assert isinstance(solver.combustion, cases.Laminar)
    np.testing.assert_allclose(tinfo["x"], info["x"], rtol=1e-15)


@pytest.mark.parametrize("which", ["anchored", "closed"])
def test_the_ignition_is_the_examples(monkeypatch, which):
    """Without Y_burnt each case runs its example's 0D ignition: a spy on
    cases.ignite sees the example's start temperature, 5 ms, the unburnt
    mixture and its options, and the case takes the last state."""
    T_ign, rtol, atol = CASES[which][:3]
    mech = load_mechanism(MECH)
    X = np.zeros(NS)
    X[mech.species_index("H2")] = 1.0
    X[mech.species_index("O2")] = 0.5
    X[mech.species_index("N2")] = 0.5 * 3.76
    W = np.asarray(mech.molecular_weights)
    Yu = X * W / (X * W).sum()
    Yb = np.linspace(1.0, 2.0, NS) / np.linspace(1.0, 2.0, NS).sum()
    seen = []

    def spy(th, kin, T0, p0, Y0, t_end, opts):
        seen.append((T0, p0, Y0.numpy(), t_end, opts))
        traj = torch.as_tensor(np.stack([np.full(NS, 1.0 / NS), Yb]))
        return None, None, traj

    monkeypatch.setattr(cases, "ignite", spy)
    if which == "anchored":
        _, st, _, info = cases.flame_1d_anchored(MECH, n=8,
                                                 dtype=torch.float64,
                                                 device="cpu")
    else:
        _, st, _, info = cases.dnn_closed_loop_flame(
            MECH, dfodenet_from_numpy(_nets(), **STATS, delta_t=1e-6,
                                      device="cpu"),
            n=8, dtype=torch.float64, device="cpu")
    (T0, p0, Y0, t_end, opts), = seen
    assert (T0, p0, t_end) == (T_ign, 101325.0, 5e-3)
    assert (opts.rtol, opts.atol, opts.max_steps) == (rtol, atol, 20000)
    np.testing.assert_allclose(Y0, Yu, rtol=1e-15)
    np.testing.assert_array_equal(info["Y_b"], Yb)


def test_closed_loop_steps_match_the_example(closed):
    """dnn_closed_loop_flame at n = 32 against examples/flame_dnn_closed_
    loop.py:62-127 in JAX: the initial state within 1e-12; 2 steps with
    Laminar and 2 with DNNChemistry (the JAX package's PRNGKey(1) nets at
    (32, 16, 8), served at frozen_T 600 K), every field and face flux
    within 1e-8 of its largest value and the Krylov iterations equal. On
    the CPU no kernel launch is counted; the caller's net keeps its own
    frozen_T."""
    solvers_j, s0, dt, info, runs, net_t = closed
    solvers, st0, dt_t, tinfo = cases.dnn_closed_loop_flame(
        MECH, net_t, n=N, dtype=torch.float64, device="cpu",
        Y_burnt=info["Yb"])
    assert dt_t == pytest.approx(dt, rel=1e-15)
    assert net_t.frozen_T == 700.0
    assert solvers["dnn"].combustion.net.frozen_T == 600.0
    _check_state(s0, st0, 1e-12)
    K.reset_launches()
    for name in ("ode", "dnn"):
        states, diags = runs[name]
        st = st0
        for sj, dj in zip(states[1:3], diags[:2]):
            st, dt_ = solvers[name].step(st, dt)
            for k in ("iters_U", "iters_Y", "iters_h", "iters_p"):
                if k in dj:
                    assert int(dj[k]) == int(dt_[k]), (name, k)
            _check_state(sj, st, 1e-8)
    assert all(v == 0 for v in K.launches.values())
    # the two models part: the DNN's rates are not the stiff integrator's
    assert _rel(runs["ode"][0][2].Y, np.asarray(runs["dnn"][0][2].Y)) > 1e-8


def test_closed_loop_compare_matches_the_example(closed):
    """closed_loop_compare on the JAX runs' states after 2 steps, carried
    into the port, against examples/flame_dnn_closed_loop.py:160-178
    computed in JAX's arrays: every metric within 1e-10."""
    _, _, _, info, runs, net_t = closed
    _, _, _, tinfo = cases.dnn_closed_loop_flame(
        MECH, net_t, n=N, dtype=torch.float64, device="cpu",
        Y_burnt=info["Yb"])
    sj = {k: runs[k][0][2] for k in ("ode", "dnn")}
    got = cases.closed_loop_compare({k: _to_port(v) for k, v in sj.items()},
                                    tinfo, ms_per_step={"ode": 4.0,
                                                        "dnn": 1.0})
    x, mech = info["x"], info["mech"]
    T = {k: np.asarray(v.T).squeeze() for k, v in sj.items()}
    Y = {k: np.asarray(v.Y).squeeze() for k, v in sj.items()}
    To, Td = T["ode"], T["dnn"]
    dxf = flame_position(x, Td) - flame_position(x, To)
    ref = dict(T_L2=np.linalg.norm(Td - To) / np.linalg.norm(To),
               T_Linf=np.abs(Td - To).max() / To.max(),
               dx_f_cells=dxf / info["mesh"].dx)
    for sp in ("H2", "OH", "H2O"):
        k = mech.species_index(sp)
        ref[sp] = np.abs(Y["dnn"][k] - Y["ode"][k]).max() / max(
            Y["ode"][k].max(), 1e-12)
    assert ref["T_L2"] > 0.0
    for k in ("T_L2", "T_Linf", "dx_f_cells"):
        assert got[k] == pytest.approx(ref[k], rel=1e-10, abs=1e-12), k
    for sp in ("H2", "OH", "H2O"):
        assert got["Y_Linf"][sp] == pytest.approx(ref[sp], rel=1e-10), sp
    assert got["speedup"] == 4.0


def test_flame_diagnostics_match_the_example(closed):
    """flame_1d_diagnostics over the JAX Laminar run's 4 states (start and
    3 steps), carried into the port, against examples/flame_1d_anchored.py
    :136-173 in JAX: the consumption speed through JAX's production_rates,
    front positions, T_max, the thickness and the fit over the last third
    (2 states) within 1e-10."""
    solvers_j, _, _, info, runs, net_t = closed
    solvers, _, _, tinfo = cases.dnn_closed_loop_flame(
        MECH, net_t, n=N, dtype=torch.float64, device="cpu",
        Y_burnt=info["Yb"])
    states = runs["ode"][0]
    got = cases.flame_1d_diagnostics(solvers["ode"],
                                     [_to_port(s) for s in states], tinfo)
    th, kin, x, iF = info["th"], info["kin"], info["x"], info["iF"]
    ref = {k: [] for k in ("time", "x_f", "T_max", "S_c")}
    for s in states:
        Yt = jnp.moveaxis(s.Y, 0, -1)
        wdot = production_rates(kin, th, s.T, th.rho(s.p, s.T, Yt), Yt)
        mdot_f = -jnp.sum(wdot[..., iF]) * info["WF"] * info["mesh"].dx
        ref["S_c"].append(float(mdot_f / (info["rho_u"] * info["Yu"][iF])))
        T = np.asarray(s.T).squeeze()
        ref["time"].append(float(s.time))
        ref["x_f"].append(flame_position(x, T))
        ref["T_max"].append(float(T.max()))
    sel = slice(len(states) * 2 // 3, None)
    drift = np.polyfit(np.asarray(ref["time"])[sel],
                       np.asarray(ref["x_f"])[sel], 1)[0]
    assert min(ref["S_c"]) > 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=0, err_msg=k)
    assert got["thickness"] == pytest.approx(flame_thickness(x, T), rel=1e-10)
    assert got["drift"] == pytest.approx(drift, rel=1e-10, abs=1e-12)
    assert got["S_L_displacement"] == pytest.approx(5.0 - drift, rel=1e-10)
    assert got["S_c_avg"] == pytest.approx(np.mean(ref["S_c"][sel]),
                                           rel=1e-10)
    one = cases.flame_1d_diagnostics(solvers["ode"], _to_port(states[0]),
                                     tinfo)
    assert one["drift"] is None and one["S_c"] == got["S_c"][:1]


def test_harvest_states_takes_the_examples_samples(closed):
    """harvest_states with 3 steps of the DNN solver (every max(3 // 40, 1)
    = 1st step after the first): the cells' (T, p, Y) after steps 2 and 3,
    in order, the layout make_dfodenet_dataset's manifold reads."""
    _, _, _, info, _, net_t = closed
    solvers, s0, dt, _ = cases.dnn_closed_loop_flame(
        MECH, net_t, n=N, dtype=torch.float64, device="cpu",
        Y_burnt=info["Yb"])
    last, man = cases.harvest_states(solvers["dnn"], s0, dt, 3)
    s, seen = s0, []
    for _ in range(3):
        s, _ = solvers["dnn"].step(s, dt)
        seen.append(s)
    assert man["T"].shape == (2 * N,) and man["Y"].shape == (2 * N, NS)
    np.testing.assert_array_equal(man["T"][N:], seen[2].T.reshape(-1).numpy())
    np.testing.assert_array_equal(man["T"][:N], seen[1].T.reshape(-1).numpy())
    np.testing.assert_array_equal(man["Y"][:N],
                                  seen[1].Y.reshape(NS, -1).T.numpy())
    np.testing.assert_array_equal(man["p"][N:], seen[2].p.reshape(-1).numpy())
    assert torch.equal(last.T, seen[2].T)
