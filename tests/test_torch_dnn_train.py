"""DF-ODENet training in the PyTorch port (deepflame_torch.chemistry.
dnn_train) against examples/train_dfodenet.py's pipeline written with the
JAX package's functions, float64 on the CPU, on the 9-species test
mechanism: the data set, Adam against optax, the npz checkpoint both ways.
Tolerances are stated per test."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry import dnn as jdnn
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.chemistry.reactor import solve_chemistry

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry import dnn as tdnn
from deepflame_torch.chemistry import dnn_train
from deepflame_torch.chemistry.reactor import ChemistryResult
from deepflame_torch.convert import dfodenet_from_numpy, dfodenet_to_numpy

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
NS = 9
HIDDEN = (32, 16, 8)
# the data set's options: the script's draws, ranges and delta_t, looser
# tolerances and a shorter pre-burn than its defaults (1e-7, 1e-13, 100 us),
# so that the stiffest lane's drains stay within about 200 trips on the CPU
DATA = dict(rtol=1e-4, atol=1e-8, pre_burn_max=1e-6, delta_t=1e-6)


def _rel(a, b):
    """Largest deviation over the largest magnitude of b."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_dataset(n, seed, manifold, delta_t, t_lo, t_hi, pre_burn_max, rtol,
                 atol):
    """examples/train_dfodenet.py:70-127 in float64 with the JAX package's
    functions, every lane in one drain as the port takes them (the script's
    32 bins change no lane's result: a finished lane is frozen; one bin
    compiles one loop): (features, targets, x_mean, x_std, y_mean, y_std,
    Xn, Dn)."""
    mech = load_mechanism(MECH)
    th, kin = make_thermo(mech), make_kinetics(mech)
    ns = mech.n_species
    rng = np.random.default_rng(seed)
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    phi = rng.uniform(0.4, 2.0, n)
    T0 = rng.uniform(t_lo, t_hi, n)
    p0 = rng.uniform(0.5, 3.0, n) * 101325.0
    W = mech.molecular_weights
    Y = np.zeros((n, ns))
    nH2 = 2.0 * phi
    mH2, mO2, mN2 = nH2 * W[iH2], 1.0 * W[iO2], 3.76 * W[iN2]
    tot = mH2 + mO2 + mN2
    Y[:, iH2], Y[:, iO2], Y[:, iN2] = mH2 / tot, mO2 / tot, mN2 / tot
    pre_t = rng.uniform(0.0, pre_burn_max, n)
    opts = RosenbrockOptions(rtol=rtol, atol=atol, max_steps=100000)
    pre = solve_chemistry(th, kin, jnp.asarray(T0), jnp.asarray(p0),
                          jnp.asarray(Y), jnp.asarray(pre_t), opts=opts,
                          n_bins=1)
    T_in, Y_in = np.asarray(pre.T), np.asarray(pre.Y)
    Tm, pm, Ym = (np.asarray(manifold[k], np.float64) for k in ("T", "p", "Y"))
    keep = Tm > min(t_lo, 500.0)
    Tm, pm, Ym = Tm[keep], pm[keep], Ym[keep]
    reps = [(Tm, pm, Ym)]
    for scale in (0.01, 0.03):
        rT = Tm * (1.0 + scale * rng.standard_normal(Tm.shape))
        rY = Ym * np.exp(scale * rng.standard_normal(Ym.shape))
        rY = rY / rY.sum(axis=1, keepdims=True)
        reps.append((rT, pm, rY))
    T_in = np.concatenate([T_in] + [r[0] for r in reps])
    p0 = np.concatenate([p0] + [r[1] for r in reps])
    Y_in = np.concatenate([Y_in] + [r[2] for r in reps])
    tgt = solve_chemistry(th, kin, jnp.asarray(T_in), jnp.asarray(p0),
                          jnp.asarray(Y_in), delta_t, opts=opts, n_bins=1)
    Y_out = np.asarray(tgt.Y)
    X = np.concatenate([T_in[:, None], p0[:, None],
                        np.asarray(jdnn.bct(jnp.asarray(Y_in), 0.1))], axis=1)
    D = np.asarray(jdnn.bct(jnp.asarray(Y_out), 0.1)
                   - jdnn.bct(jnp.asarray(Y_in), 0.1))[:, :-1]
    x_mean, x_std = X.mean(0), X.std(0) + 1e-10
    y_mean, y_std = D.mean(0), D.std(0) + 1e-10
    return (X, D, x_mean, x_std, y_mean, y_std,
            ((X - x_mean) / x_std).astype(np.float32),
            ((D - y_mean) / y_std).astype(np.float32))


def test_dataset_matches_the_script():
    """64 random states, 6 harvested flame states (one too cold to keep)
    as the manifold: every array of the port's data set within 1e-10 of
    its largest value of the script's (the normalized ones in float32,
    within 1e-6)."""
    rng = np.random.default_rng(7)
    Ym = rng.dirichlet(np.ones(NS), 6)
    manifold = dict(T=np.array([450.0, 1500.0, 1700.0, 1900.0, 2100.0,
                                2300.0]),
                    p=np.full(6, 101325.0), Y=Ym)
    ref = _jax_dataset(64, 3, manifold, t_lo=800.0, t_hi=2600.0, **DATA)
    mech = tc.load_mechanism(MECH, device="cpu")
    data = dnn_train.make_dfodenet_dataset(
        mech, tc.make_thermo(mech), tc.make_kinetics(mech), 64, seed=3,
        manifold=manifold, device="cpu", **DATA)
    assert data.X.shape == (64 + 15, NS + 2) and data.D.shape == (79, NS - 1)
    names = ("X", "D", "x_mean", "x_std", "y_mean", "y_std")
    for name, r in zip(names, ref):
        assert _rel(getattr(data, name).numpy(), r) <= 1e-10, name
    for name, r in zip(("Xn", "Dn"), ref[6:]):
        got = getattr(data, name)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), r) <= 1e-6, name
    # the states moved: the targets are not all zero
    assert float(data.D.abs().max()) > 1e-3


def test_float32_dataset_keeps_the_script_tolerance_rule(monkeypatch):
    """In float32 the data set takes rtol at least 1e-5 and atol 1e-9, as
    the script does, whatever is asked; in float64 what is asked."""
    seen = []

    def spy(thermo, kin, T, p, Y, dt, opts, n_bins):
        seen.append((opts.rtol, opts.atol, n_bins))
        return ChemistryResult(T=T, Y=Y, RR=Y, Qdot=T, dt_next=T)

    monkeypatch.setattr(dnn_train, "solve_chemistry", spy)
    mech = tc.load_mechanism(MECH, device="cpu")
    for dtype in (torch.float32, torch.float64):
        dnn_train.make_dfodenet_dataset(
            mech, tc.make_thermo(mech, dtype), tc.make_kinetics(mech, dtype),
            8, rtol=1e-7, atol=1e-13, device="cpu")
    assert seen == [(1e-5, 1e-9, 1)] * 2 + [(1e-7, 1e-13, 1)] * 2


def test_training_matches_optax():
    """3 epochs at hidden widths (32, 16, 8), batch 16, lr 1e-3, from the
    JAX package's PRNGKey(0) weights carried over as numpy, on 72 seeded
    samples whose batches follow one numpy generator in both: the port's
    Adam against optax.adam with jax.value_and_grad on JAX's mlp_apply,
    float64. Every weight within 1e-9 of its tensor's largest |W|, each
    epoch's mean loss within 1e-10 relative."""
    rng = np.random.default_rng(5)
    n, epochs, batch = 72, 3, 16
    Xn = rng.normal(size=(n, NS + 2))
    Dn = rng.normal(size=(n, NS - 1))
    nets = jdnn.init_params(jax.random.PRNGKey(0), NS, HIDDEN, jnp.float64)
    rng_t = copy.deepcopy(rng)

    opt = optax.adam(1e-3)

    def loss_fn(nets, xb, db):
        preds = jnp.concatenate([jdnn.mlp_apply(net, xb) for net in nets],
                                axis=-1)
        return jnp.mean((preds - db) ** 2)

    @jax.jit
    def train_step(nets, opt_state, xb, db):
        l, g = jax.value_and_grad(loss_fn)(nets, xb, db)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(nets, updates), opt_state, l

    start = [[(torch.as_tensor(np.asarray(W)), torch.as_tensor(np.asarray(b)))
              for W, b in net] for net in nets]
    opt_state = opt.init(nets)
    losses_j = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        tot = 0.0
        for b in range(n // batch):
            idx = perm[b * batch:(b + 1) * batch]
            nets, opt_state, l = train_step(nets, opt_state,
                                            jnp.asarray(Xn[idx]),
                                            jnp.asarray(Dn[idx]))
            tot += float(l)
        losses_j.append(tot / (n // batch))

    first = start[0][0][0].clone()
    trained, losses_t = dnn_train.train_dfodenet(
        start, torch.as_tensor(Xn), torch.as_tensor(Dn), epochs=epochs,
        batch=batch, seed=rng_t)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-10)
    assert losses_t[-1] < losses_t[0]
    for net_j, net_t in zip(nets, trained):
        for (Wj, bj), (Wt, bt) in zip(net_j, net_t):
            assert _rel(Wt.numpy(), Wj) <= 1e-9
            assert np.abs(bt.numpy() - np.asarray(bj)).max() \
                <= 1e-9 * np.abs(np.asarray(Wj)).max()
    # the start weights were copied, not trained in place
    assert torch.equal(start[0][0][0], first)


def _batch(seed, n=48):
    rng = np.random.default_rng(seed)
    T = np.concatenate([np.full(8, 500.0), rng.uniform(900.0, 2400.0, n - 8)])
    return (T, rng.uniform(0.9e5, 1.1e5, n), rng.dirichlet(np.ones(NS), n),
            rng.uniform(0.2, 1.2, n))


def test_npz_checkpoint_round_trips_both_ways(tmp_path):
    """A checkpoint the port writes loads in JAX's load_npz_checkpoint, and
    one written by the script's lines (examples/train_dfodenet.py:150-160)
    loads in the port's; either way the rates of the two packages agree
    within 1e-12 of the largest (float64). dfodenet_to_numpy gives back
    what dfodenet_from_numpy took."""
    rng = np.random.default_rng(9)
    sizes = (NS + 2,) + HIDDEN + (1,)
    nets = [[(rng.normal(size=(a, b)) * (2.0 / a) ** 0.5,
              rng.normal(scale=0.1, size=b))
             for a, b in zip(sizes[:-1], sizes[1:])] for _ in range(NS - 1)]
    stats = dict(x_mean=np.r_[1500.0, 1e5, np.full(NS, -5.0)]
                 + rng.normal(size=NS + 2),
                 x_std=np.r_[500.0, 1e4, np.full(NS, 2.0)]
                 * rng.uniform(1.0, 2.0, NS + 2),
                 y_mean=rng.normal(size=NS - 1) * 1e-4,
                 y_std=rng.uniform(1e-4, 1e-3, NS - 1))
    T, p, Y, rho = _batch(2)
    f = lambda a: torch.as_tensor(a)

    port_path = str(tmp_path / "port.npz")
    dnn_train.save_npz_checkpoint(
        port_path, [[(f(W), f(b)) for W, b in net] for net in nets],
        delta_t=1e-6, **{k: f(v) for k, v in stats.items()})
    script_path = str(tmp_path / "script.npz")
    flat = {}
    for i, net in enumerate(nets):
        for j, (Wm, bm) in enumerate(net):
            flat[f"net{i}_W{j}"] = np.asarray(Wm)
            flat[f"net{i}_b{j}"] = np.asarray(bm)
    np.savez(script_path, delta_t=1e-6, n_species=NS, n_layers=len(nets[0]),
             **stats, **flat)
    for path in (port_path, script_path):
        nj = jdnn.load_npz_checkpoint(path, frozen_T=700.0,
                                      dtype=jnp.float64)
        nt = tdnn.load_npz_checkpoint(path, frozen_T=700.0,
                                      dtype=torch.float64, device="cpu")
        rj = np.asarray(nj.rates(*map(jnp.asarray, (T, p, Y, rho))))
        rt = nt.rates(*map(f, (T, p, Y, rho))).numpy()
        assert np.abs(rj).max() > 0.0
        assert _rel(rt, rj) <= 1e-12, path
        assert nt.delta_t == nj.delta_t == 1e-6
    back = dfodenet_to_numpy(dfodenet_from_numpy(
        nets, delta_t=1e-6, frozen_T=650.0, device="cpu", **stats))
    assert back["delta_t"] == 1e-6 and back["frozen_T"] == 650.0
    for k, v in stats.items():
        assert np.array_equal(back[k], v), k
    for net_b, net in zip(back["nets"], nets):
        for (Wb, bb), (W, b) in zip(net_b, net):
            assert np.array_equal(Wb, W) and np.array_equal(bb, b)
