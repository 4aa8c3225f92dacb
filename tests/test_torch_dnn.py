"""PyTorch port of the DF-ODENet DNN chemistry against the JAX package (CPU).

Inputs come from numpy seeds and go to both packages as numpy arrays. The
fused-MLP kernel's plain version is held against the Pallas kernel in
interpret mode, as tests/test_pallas_kernels.py runs it; the rest against
the JAX functions in float64. Tolerances are stated per test.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry import dnn as jdnn
from deepflame_tpu.combustion.dnn_chemistry import DNNChemistry as JDNNChemistry
from deepflame_tpu.ops.pallas_kernels import mlp_fused_lanes

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry import dnn as tdnn
from deepflame_torch.combustion import DNNChemistry
from deepflame_torch.convert import dfodenet_from_numpy
from deepflame_torch.ops import kernels as K

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
NS = 9                                         # species of the test mechanism
HIDDEN = (64, 32, 16)


def _nets(seed, n_species=NS, hidden=HIDDEN):
    """Per-species params [[(W, b), ...], ...] as numpy, He-scaled weights
    and small non-zero biases."""
    rng = np.random.default_rng(seed)
    sizes = (n_species + 2,) + tuple(hidden) + (1,)
    return [[(rng.normal(size=(a, b)) * (2.0 / a) ** 0.5,
              rng.normal(scale=0.1, size=b))
             for a, b in zip(sizes[:-1], sizes[1:])]
            for _ in range(n_species - 1)]


def _stats(n_species=NS, y_std=1e-3):
    return dict(x_mean=np.zeros(n_species + 2),
                x_std=np.ones(n_species + 2) * 100.0,
                y_mean=np.zeros(n_species - 1),
                y_std=np.full(n_species - 1, y_std))


def _jax_net(nets, delta_t=1e-6, frozen_T=700.0, **kw):
    f = lambda a: jnp.asarray(a, jnp.float64)
    return jdnn.DFODENet(nets=[[(f(W), f(b)) for W, b in net] for net in nets],
                         **{k: f(v) for k, v in _stats().items()},
                         delta_t=delta_t, frozen_T=frozen_T, **kw)


def _port_net(nets, delta_t=1e-6, frozen_T=700.0, fuse=True, **kw):
    if not fuse:
        f = lambda a: torch.as_tensor(np.asarray(a))
        return tdnn.DFODENet(nets=[[(f(W), f(b)) for W, b in net]
                                   for net in nets],
                             **{k: f(v) for k, v in _stats().items()},
                             delta_t=delta_t, frozen_T=frozen_T, fuse=False)
    return dfodenet_from_numpy(nets, **_stats(), delta_t=delta_t,
                               frozen_T=frozen_T, device="cpu", **kw)


def _batch(seed, n=64):
    """T across the frozen threshold, p, Y on the simplex, rho."""
    rng = np.random.default_rng(seed)
    T = np.concatenate([np.full(n // 4, 300.0), np.full(n // 4, 700.0),
                        rng.uniform(900.0, 2400.0, n - n // 2)])
    p = rng.uniform(0.9e5, 1.1e5, n)
    Y = rng.dirichlet(np.ones(NS), n)
    rho = rng.uniform(0.2, 1.2, n)
    return T, p, Y, rho


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ------------------------------------------------------- the fused kernel

@pytest.mark.parametrize("mode,S,F,hidden,B", [
    ("f32", 8, 11, HIDDEN, 512), ("f32", 20, 23, HIDDEN, 512),
    ("f32", 4, 67, HIDDEN, 512), ("bf16", 8, 11, HIDDEN, 512),
    ("bf16", 20, 23, HIDDEN, 512), ("bf16", 4, 67, HIDDEN, 512),
    ("f32", 8, 11, (1600, 800, 400), 256)],
    ids=["f32-8-11", "f32-20-23", "f32-4-67", "bf16-8-11", "bf16-20-23",
         "bf16-4-67", "f32-8-11-full"])
def test_mlp_fused_plain_matches_pallas(mode, S, F, hidden, B):
    """mlp_fused (CPU: its plain version) against mlp_fused_lanes in
    interpret mode, at H2_Li's shape (S = 8, F = 11), drm19's (S = 20,
    F = 23) and a 65-species mechanism's input width (F = 67, padded to
    K1 = 80; 4 of its nets), hidden (64, 32, 16), and in f32 once at the DNN
    path's full widths (1600, 800, 400), He-scaled there so that the
    activations stay of unit scale. f32: 2e-5, the Pallas test's own
    tolerance (the Pallas erf polynomial is within 1.5e-7). bf16: 2e-3 of
    the largest |out|; both round x, W and each activation to bf16 at the
    same places, and a sum taken in another order can move a rounding by one
    bf16 step (2^-8). The port's weights go in through `mlp_pack`, the
    layout DFODENet hands the kernel (bf16 layers 1 to 3 K-major)."""
    rng = np.random.default_rng(11)
    sizes = (F,) + hidden + (1,)
    full = hidden != HIDDEN
    Ws = [rng.normal(scale=(2.0 / a) ** 0.5 if full else 0.3,
                     size=(S, a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(S, b)).astype(np.float32)
          for b in sizes[1:]]
    x = rng.normal(size=(B, F)).astype(np.float32)
    cd = jnp.bfloat16 if mode == "bf16" else jnp.float32
    ref = np.asarray(mlp_fused_lanes(jnp.asarray(x), list(map(jnp.asarray, Ws)),
                                     list(map(jnp.asarray, bs)),
                                     compute_dtype=cd, interpret=True))
    wdt = torch.bfloat16 if mode == "bf16" else torch.float32
    # the port's stacked first layer carries zero rows up to a multiple of 16
    pad = (-F) % 16
    Wt = K.mlp_pack([torch.as_tensor(np.pad(W, ((0, 0), (0, pad), (0, 0)))
                                     if i == 0 else W).to(wdt)
                     for i, W in enumerate(Ws)])
    assert all(Wt[i].transpose(1, 2).is_contiguous() == (mode == "bf16")
               for i in range(3))
    K.reset_launches()
    out = K.mlp_fused(torch.as_tensor(x), Wt, list(map(torch.as_tensor, bs)))
    assert all(v == 0 for v in K.launches.values())
    assert out.shape == (B, S) and out.dtype == torch.float32
    if mode == "f32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(out.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()


def test_mlp_fused_plain_chunks_and_float64():
    """`chunk` only bounds the plain version's activations: the chunked
    result equals the whole one (1e-13 relative, float64)."""
    rng = np.random.default_rng(3)
    S, F, B = 4, 11, 300
    sizes = (F,) + HIDDEN + (1,)
    Ws = [torch.as_tensor(rng.normal(scale=0.3, size=(S, a, b)))
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.as_tensor(rng.normal(scale=0.1, size=(S, b)))
          for b in sizes[1:]]
    x = torch.as_tensor(rng.normal(size=(B, F)))
    whole = K.mlp_fused(x, Ws, bs)
    assert _rel(K.mlp_fused(x, Ws, bs, chunk=64), whole) <= 1e-13
    # against the per-species reference of the JAX package
    ref = np.stack([np.asarray(jdnn.mlp_apply(
        [(jnp.asarray(W[s].numpy()), jnp.asarray(b[s].numpy()))
         for W, b in zip(Ws, bs)], jnp.asarray(x.numpy())))[:, 0]
        for s in range(S)], axis=1)
    assert _rel(whole, ref) <= 1e-12


# ---------------------------------------------------------------- DFODENet

@pytest.mark.parametrize("fuse,hidden", [(True, HIDDEN), (False, HIDDEN),
                                         (True, (32, 16))])
def test_dfodenet_rates_match_jax(fuse, hidden):
    """RR of the port against JAX in float64, 1e-12 of the largest |RR|:
    the fused four-layer route (mlp_fused on the CPU), the per-species
    route (fuse=False) and a fused three-layer net (mlp_fused_plain)."""
    nets = _nets(1, hidden=hidden)
    T, p, Y, rho = _batch(2)
    ref = np.asarray(_jax_net(nets, fuse=fuse).rates(
        *map(jnp.asarray, (T, p, Y, rho))))
    K.reset_launches()
    net = _port_net(nets, fuse=fuse)
    out = net.rates(*map(torch.as_tensor, (T, p, Y, rho)))
    assert K.launches["mlp_fused"] == 0
    assert net.fused == fuse
    assert _rel(out, ref) <= 1e-12
    RR = out.numpy()
    assert np.abs(RR[:32]).max() == 0.0          # T <= frozen_T: frozen
    assert np.abs(RR[32:]).max() > 0.0
    assert np.abs(RR[:, -1]).max() == 0.0        # the inert species
    assert np.abs(RR.sum(-1)).max() <= 1e-9 * np.abs(RR).max()


def test_dfodenet_stacks_weights_once():
    """The fused net holds stacked, K-padded weights as buffers, and the
    compute-type copy, in the kernel's layout (bf16 layers 1 to 3 K-major),
    is made when the net is built."""
    nets = _nets(4)
    net = _port_net(nets, compute_dtype=torch.bfloat16)
    names = dict(net.named_buffers())
    assert names["W0"].shape == (NS - 1, 16, HIDDEN[0])
    assert float(names["W0"][:, NS + 2:].abs().max()) == 0.0
    assert names["W3"].shape == (NS - 1, HIDDEN[2], 1)
    Ws, bs = net._weights(torch.bfloat16)
    assert Ws[0].dtype == torch.bfloat16 and bs[0].dtype == torch.float32
    assert net._weights(torch.bfloat16)[0][1] is Ws[1]
    assert all(Ws[i].transpose(1, 2).is_contiguous()
               and torch.equal(Ws[i], names[f"W{i}"].to(torch.bfloat16))
               for i in range(3))


def test_multi_range_matches_jax():
    """Two temperature bands split at 1500 K (T >= bound takes model 1);
    float64, 1e-12 of the largest |RR|."""
    nets_a, nets_b = _nets(5), _nets(6)
    T, p, Y, rho = _batch(7)
    T[-8:] = 1500.0                              # on the band edge
    ref = jdnn.MultiRangeDFODENet(
        nets=(_jax_net(nets_a), _jax_net(nets_b)), T_bounds=(1500.0,)).rates(
        *map(jnp.asarray, (T, p, Y, rho)))
    out = tdnn.MultiRangeDFODENet((_port_net(nets_a), _port_net(nets_b)),
                                  (1500.0,)).rates(
        *map(torch.as_tensor, (T, p, Y, rho)))
    assert _rel(out, ref) <= 1e-12
    single = _port_net(nets_b).rates(*map(torch.as_tensor, (T, p, Y, rho)))
    assert torch.equal(out[-8:], single[-8:])


def test_init_params_shapes_and_seed():
    """He-scaled normal weights, zero biases; one seed, one set of weights."""
    a = tdnn.init_params(torch.Generator().manual_seed(3), NS, HIDDEN,
                         device="cpu")
    b = tdnn.init_params(torch.Generator().manual_seed(3), NS, HIDDEN,
                         device="cpu")
    assert len(a) == NS - 1 and len(a[0]) == 4
    assert [tuple(W.shape) for W, _ in a[0]] == [(11, 64), (64, 32), (32, 16),
                                                 (16, 1)]
    assert all(torch.equal(Wa, Wb) for na, nb in zip(a, b)
               for (Wa, _), (Wb, _) in zip(na, nb))
    assert all(float(bias.abs().max()) == 0.0 for net in a for _, bias in net)
    W = torch.cat([net[1][0].reshape(-1) for net in a])
    assert abs(float(W.std()) - (2.0 / 64) ** 0.5) < 0.02


# ------------------------------------------------------------ checkpoints

def _write_npz(path, nets, delta_t):
    flat = {}
    for i, net in enumerate(nets):
        for j, (W, b) in enumerate(net):
            flat[f"net{i}_W{j}"] = W
            flat[f"net{i}_b{j}"] = b
    np.savez(path, **_stats(), delta_t=delta_t, n_species=NS,
             n_layers=len(nets[0]), **flat)


def test_load_npz_checkpoint_matches_jax(tmp_path):
    """One npz in examples/train_dfodenet.py's layout, loaded by both
    packages in float64: equal rates to 1e-12."""
    path = str(tmp_path / "net.npz")
    _write_npz(path, _nets(8), 2e-6)
    jnet = jdnn.load_npz_checkpoint(path, frozen_T=650.0, dtype=jnp.float64)
    tnet = tdnn.load_npz_checkpoint(path, frozen_T=650.0, dtype=torch.float64,
                                    device="cpu")
    assert tnet.delta_t == jnet.delta_t == 2e-6
    T, p, Y, rho = _batch(9)
    ref = jnet.rates(*map(jnp.asarray, (T, p, Y, rho)))
    assert _rel(tnet.rates(*map(torch.as_tensor, (T, p, Y, rho))), ref) <= 1e-12


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """One state dict in the published DF-ODENet layout (net{i} with
    linear_layer_j weights (out, in)), loaded by both packages in float64."""
    nets = _nets(10)
    st = _stats()
    sd = {"data_in_mean": torch.as_tensor(st["x_mean"]),
          "data_in_std": torch.as_tensor(st["x_std"]),
          "data_target_mean": torch.as_tensor(st["y_mean"]),
          "data_target_std": torch.as_tensor(st["y_std"])}
    for i, net in enumerate(nets):
        sd[f"net{i}"] = {}
        for j, (W, b) in enumerate(net):
            sd[f"net{i}"][f"linear_layer_{j}.weight"] = torch.as_tensor(W.T)
            sd[f"net{i}"][f"linear_layer_{j}.bias"] = torch.as_tensor(b)
    path = str(tmp_path / "net.pt")
    torch.save(sd, path)
    jnet = jdnn.load_torch_checkpoint(path, NS, 1e-6, dtype=jnp.float64)
    tnet = tdnn.load_torch_checkpoint(path, NS, 1e-6, dtype=torch.float64,
                                      device="cpu")
    T, p, Y, rho = _batch(11)
    ref = jnet.rates(*map(jnp.asarray, (T, p, Y, rho)))
    assert _rel(tnet.rates(*map(torch.as_tensor, (T, p, Y, rho))), ref) <= 1e-12


# --------------------------------------------------------- DNNChemistry

@pytest.mark.parametrize("hybrid", [False, True])
def test_dnn_chemistry_correct_matches_jax(hybrid):
    """DNNChemistry.correct against JAX, float64. Without hybrid: RR, Y and
    Qdot to 1e-12 of their largest values, and no dt_next. With hybrid, the
    stiff integrator's cells (outside [900, 1800] K) carry its tolerance of
    RR (tests/test_torch_reactor.py: 1e-9 of the largest). dt_next: 1e-7
    relative. It is a power of the embedded error estimate, a difference of
    nearly equal stage sums, and these random compositions (radicals at
    mass fractions near 0.1) cancel deeper than the fresh mixtures of
    tests/test_torch_reactor.py, where 1e-8 holds; the largest deviation
    here is 6e-8."""
    mech_j = load_mechanism(MECH)
    mech_t = tc.load_mechanism(MECH, device="cpu")
    nets = _nets(12)
    T, p, Y, _ = _batch(13, n=48)
    kw = dict(hybrid=hybrid, T_valid_min=900.0, T_valid_max=1800.0)
    comb_j = JDNNChemistry(make_thermo(mech_j), make_kinetics(mech_j),
                           net=_jax_net(nets), **kw)
    comb_t = DNNChemistry(tc.make_thermo(mech_t), tc.make_kinetics(mech_t),
                          net=_port_net(nets), **kw)
    rj = comb_j.correct(*map(jnp.asarray, (T, p, Y)), 1e-6)
    K.reset_launches()
    rt = comb_t.correct(*map(torch.as_tensor, (T, p, Y)), 1e-6)
    assert all(v == 0 for v in K.launches.values())
    tol = 1e-9 if hybrid else 1e-12
    assert _rel(rt.RR, rj.RR) <= tol
    assert _rel(rt.Qdot, rj.Qdot) <= tol
    assert np.abs(rt.Y.numpy() - np.asarray(rj.Y)).max() <= 1e-12
    if hybrid:
        np.testing.assert_allclose(rt.dt_next.numpy(), np.asarray(rj.dt_next),
                                   rtol=1e-7)
    else:
        assert rt.dt_next is None and rj.dt_next is None
    np.testing.assert_allclose(rt.Y.sum(-1).numpy(), 1.0, rtol=1e-14)


# ------------------------------------------------------- the whole slice

def test_reacting_tgv_3d_les_dnn_matches_jax():
    """The slice as a whole: the 3D reacting LES TGV with DNN chemistry at
    n = 8 in float64, hidden (64, 32, 16), 2 steps of 0.25 us, against the
    JAX step with the same weights (carried across as numpy). Tolerances of
    tests/test_torch_low_mach.py: 1e-8 of each field, 1e-6 of velocity and
    fluxes, equal Krylov iteration counts."""
    from __graft_entry__ import _build_3d_les
    from deepflame_torch.cases import reacting_tgv_3d_les_dnn
    from test_torch_low_mach import FIELDS, _rel as rel, run_both

    dt = 2.5e-7
    solver_t, state_t0 = reacting_tgv_3d_les_dnn(
        MECH, n=8, dtype=torch.float64, compute_dtype=None, hidden=HIDDEN,
        device="cpu")
    net_t = solver_t.combustion.net
    nets = [[(W.numpy(), b.numpy()) for W, b in net] for net in net_t.nets]
    solver_j, state_j = _build_3d_les(n=8, dtype=jnp.float64, mech_path=MECH)
    f = lambda t: jnp.asarray(t.numpy())
    net_j = jdnn.DFODENet(
        nets=[[(jnp.asarray(W), jnp.asarray(b)) for W, b in net]
              for net in nets],
        x_mean=f(net_t.x_mean), x_std=f(net_t.x_std), y_mean=f(net_t.y_mean),
        y_std=f(net_t.y_std), delta_t=dt, frozen_T=700.0)
    comb = solver_j.combustion
    solver_j = dataclasses.replace(
        solver_j, combustion=JDNNChemistry(comb.thermo, comb.kinetics,
                                           net=net_j))
    for k in FIELDS:
        assert rel(getattr(state_j, k), getattr(state_t0, k)) <= 1e-14, k
    K.reset_launches()
    state_j, state_t = run_both(solver_j, state_j, solver_t, dt, 2)
    assert all(v == 0 for v in K.launches.values())
    # the hot sphere reacted: its composition moved
    hot = state_t0.T > 700.0
    dY = (state_t.Y - state_t0.Y).abs().amax(0)
    assert float(dY[hot].max()) > 1e-6


@pytest.mark.parametrize("y_std", [1e-3, 1e-6])
def test_dnn_case_target_scale(y_std):
    """Why reacting_tgv_3d_les_dnn defaults to y_std = 1e-6 (full widths,
    float32, n = 8, 2 steps on the CPU): with 1e-3 the random nets move the
    hot cells' composition so far in one step that T falls to the thermo
    table's lower bound (T_min, 200 K); with 1e-6 the rates stay non-zero and
    T stays between 690 K and 2200 K."""
    from deepflame_torch.cases import reacting_tgv_3d_les_dnn
    solver, state = reacting_tgv_3d_les_dnn(MECH, n=8, dtype=torch.float32,
                                            y_std=y_std, device="cpu")
    for _ in range(2):
        state, _ = solver.step(state, 2.5e-7)
    comb = solver.combustion
    RR = comb.correct(state.T, state.p, torch.movedim(state.Y, 0, -1),
                      2.5e-7).RR
    T_lo = float(state.T.min())
    if y_std == 1e-3:
        assert T_lo == float(comb.thermo.T_min) == 200.0
    else:
        assert 690.0 < T_lo and float(state.T.max()) < 2200.0
        assert float(RR.abs().max()) > 100.0


def test_dnn_step_float32_species_solve_hits_its_cap_in_both():
    """With the DNN rates in float32 (full widths, the seeded weights of
    reacting_tgv_3d_les_dnn, n = 8), the species BiCGStab of one step stops
    at its 100-iteration cap in the JAX step and in the port's alike; the
    same step with stiff chemistry converges well before it."""
    import jax
    from __graft_entry__ import _build_3d_les
    from deepflame_torch.cases import reacting_tgv_3d_les_dnn

    solver_t, state_t = reacting_tgv_3d_les_dnn(
        MECH, n=8, dtype=torch.float32, compute_dtype=None, device="cpu")
    net_t = solver_t.combustion.net
    f = lambda t: jnp.asarray(t.numpy(), jnp.float32)
    net_j = jdnn.DFODENet(
        nets=[[(f(W), f(b)) for W, b in net] for net in net_t.nets],
        x_mean=f(net_t.x_mean), x_std=f(net_t.x_std), y_mean=f(net_t.y_mean),
        y_std=f(net_t.y_std), delta_t=2.5e-7)
    solver_j, state_j = _build_3d_les(n=8, dtype=jnp.float32, mech_path=MECH)
    stiff_j = solver_j
    comb = solver_j.combustion
    solver_j = dataclasses.replace(
        solver_j, combustion=JDNNChemistry(comb.thermo, comb.kinetics,
                                           net=net_j))
    _, dj = jax.jit(lambda s: solver_j.step(s, 2.5e-7))(state_j)
    _, dt_ = solver_t.step(state_t, 2.5e-7)
    cap = solver_t.config.max_iter_u
    assert int(dj["iters_Y"]) == int(dt_["iters_Y"]) == cap == 100
    _, ds = jax.jit(lambda s: stiff_j.step(s, 2.5e-7))(state_j)
    assert int(ds["iters_Y"]) < cap
