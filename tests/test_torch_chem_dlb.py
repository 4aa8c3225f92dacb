"""Cross-shard chemistry load balance of the port (the reference's DLB cell
migration; chemistry.reactor._stratified_cross_shard), float64 on 4 gloo
ranks of the CPU (tests/torch_dist_ranks.py).

- The lane exchange against the JAX package's on 4 virtual devices: every
  lane back in place bit for bit, and every lane integrated on the shard
  the JAX package's exchange sends it to, in the same place (the hot-lane
  count and an order-sensitive signature of the lanes each shard receives
  equal, 1e-13); a front inside the first shard's slab spread to within
  one lane per shard.
- solve_chemistry(cross_shard=True) on the 4 ranks against the global
  solve of all cells: T and Y within 1e-12, RR within 1e-9 of their
  largest values (the JAX package's own test's bounds).
- A DistributedLowMach step of the stiff TGV at n = 8 with
  Laminar(dlb_cross_shard=True) on 2 ranks: two all_to_alls a step, and
  every field within 1e-11 of the single-device step's.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from deepflame_tpu.chemistry.reactor import \
    _stratified_cross_shard as j_cross

import torch_dist_ranks as R

N_RANKS, N_LANES = 4, 256


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs():
    rng = np.random.default_rng(1)
    x, x2 = rng.normal(size=N_LANES), rng.normal(size=(N_LANES, 3))
    # the hot lanes all in the first shard's slab
    key = np.where(np.arange(N_LANES) < N_LANES // N_RANKS // 2, 1000.0, 1.0)
    return x, x2, key


def test_exchange_matches_jax_round_trip_and_balance(tmp_path):
    x, x2, key = _inputs()

    def body(xl, x2l, kl):
        def run(a, b, k):
            sig = jnp.sum(a * jnp.arange(1, a.shape[0] + 1, dtype=a.dtype))
            return (a, b, jnp.broadcast_to(jnp.sum(k > 100.0), k.shape)
                    .astype(a.dtype), jnp.broadcast_to(sig, k.shape))
        return j_cross(run, kl, (xl, x2l, kl), 4, "x")

    dev = Mesh(np.array(jax.devices()[:N_RANKS]), ("x",))
    want = jax.jit(jax.shard_map(body, mesh=dev, in_specs=(P("x"),) * 3,
                                 out_specs=(P("x"),) * 4, check_vma=False))(
        jnp.asarray(x), jnp.asarray(x2), jnp.asarray(key))
    want = [np.asarray(w) for w in want]
    got = R.run_ranks(R.dlb_roundtrip, N_RANKS, tmp_path, x, x2, key)
    got = [np.concatenate([g[i] for g in got]) for i in range(4)]
    assert np.array_equal(got[0], x) and np.array_equal(got[1], x2)
    assert np.array_equal(got[2], want[2])
    assert _rel(got[3], want[3]) <= 1e-13
    hot = got[2].reshape(N_RANKS, -1)[:, 0]
    assert hot.sum() == N_LANES // N_RANKS // 2
    assert hot.max() - hot.min() <= 1, hot


def test_cross_shard_solve_matches_global(tmp_path):
    T, p, Y = R.chem_front(128, N_RANKS)
    res = R.run_ranks(R.chem_solve, N_RANKS, tmp_path, T, p, Y, 1e-6, True)
    ref = res[0][1]
    got = [np.concatenate([r[0][i] for r in res]) for i in range(3)]
    assert _rel(got[0], ref[0]) <= 1e-12
    assert _rel(got[1], ref[1]) <= 1e-12
    assert _rel(got[2], ref[2]) <= 1e-9


def test_distributed_step_with_dlb_matches_single_device(tmp_path):
    dt = 2.5e-7
    (fields, diags, a2a), (single, sdiags) = R.run_ranks(
        R.tgv_dlb, 2, tmp_path, 1, dt)[0]
    assert a2a == 2
    for k in ("rho", "U", "p", "ha", "Y", "T"):
        assert _rel(fields[k], single[k]) <= 1e-11, k
    for k in diags[0]:
        if k.startswith("iters"):
            assert np.array_equal(diags[0][k], sdiags[0][k]), k
