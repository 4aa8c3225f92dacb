"""PyTorch port of the Lagrangian cloud, film and liquids against the JAX
package (float64, CPU, seeded numpy gas fields).

The JAX cloud draws from threefry keys; the port from a torch.Generator
through `deepflame_torch.lagrangian.cloud.draw`. Here `draw` is replaced by
a replay of JAX's draws: for each step, the JAX key of the state is split in
the JAX cloud's order (k1, k2, k3 for the injector, then O'Rourke's and the
dispersion's) and the same samplers are called, so both packages see the
same numbers; the replay checks that the port asks for the same draws, and
the split chain ends at the key JAX's state carries.

Tolerances: the liquid correlations within 1e-14 of the largest value
(pow and exp of the two libraries may differ by an ulp); after every step
each state array and each of the four sources within 1e-10 of its largest
value (the scatter-adds sum in another order, the cell gathers are exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.lagrangian import cloud as jcloud
from deepflame_tpu.lagrangian import film as jfilm
from deepflame_tpu.lagrangian import liquids as jliq
from deepflame_tpu.mesh import StructuredMesh

import deepflame_torch.mesh as tmesh
from deepflame_torch.lagrangian import cloud as tcloud
from deepflame_torch.lagrangian import film as tfilm
from deepflame_torch.lagrangian import liquids as tliq

LIQUIDS = ("n_heptane", "n_dodecane", "ethanol", "water")


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().cpu().double().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("name", LIQUIDS)
def test_liquid_correlations_match_jax(name):
    lj, lt = getattr(jliq, name)(), getattr(tliq, name)()
    assert dataclasses.asdict(lj) == dataclasses.asdict(lt)
    rng = np.random.default_rng(0)
    T = rng.uniform(150.0, 2100.0, 400)
    p = 10.0 ** rng.uniform(-1.0, 7.5, 400)
    Tt, pt = torch.as_tensor(T), torch.as_tensor(p)
    for f in ("rho", "mu", "cp", "p_sat", "cp_vap", "latent_heat"):
        assert _rel(getattr(lj, f)(jnp.asarray(T)),
                    getattr(lt, f)(Tt)) <= 1e-14, f
    assert _rel(lj.T_boil_at(jnp.asarray(p)), lt.T_boil_at(pt)) <= 1e-14
    assert _rel(lj.D_vap(jnp.asarray(T), jnp.asarray(p)),
                lt.D_vap(Tt, pt)) <= 1e-14
    # a number: what the injection's density takes
    assert lt.rho(320.0) == lj.rho(320.0)


# ------------------------------------------------------------ the replay

def _jax_draws(cj, key, dtype, gas):
    """JAX's draws of one evolve from its state's key, in its split order:
    [(dist, array), ...] and the key its next state carries."""
    key, k1, k2, k3 = jax.random.split(key, 4)
    inj = cj.injector
    out = []
    K = inj.parcels_per_step

    def size(k):
        if inj.size_dist == "RosinRammler":
            out.append(("uniform", jax.random.uniform(k, (K,), dtype)))
        else:
            out.append(("normal", jax.random.normal(k, (K,), dtype)))

    if isinstance(inj, jcloud.ConeInjector):
        size(k1)
        out.append(("uniform", jax.random.uniform(k2, (K,), dtype, 0.0,
                                                  2.0 * jnp.pi)))
        out.append(("uniform", jax.random.uniform(k3, (K,), dtype)))
    elif isinstance(inj, jcloud.PatchFuncInjector):
        size(k1)
        out.append(("uniform", jax.random.uniform(k2, (3, K), dtype)))
    if cj.collision == "ORourke":
        key, kc = jax.random.split(key)
        out.append(("uniform", jax.random.uniform(kc, (cj.max_parcels,),
                                                  dtype)))
    if cj.dispersion and "k_turb" in gas:
        key, kd = jax.random.split(key)
        out.append(("normal", jax.random.normal(kd, (3, cj.max_parcels),
                                                dtype)))
    return out, key


class Replay:
    """Stands in for tcloud.draw: hands out queued JAX draws, checking that
    the port asks for the same distribution and shape."""

    def __init__(self):
        self.queue = []

    def __call__(self, generator, dist, shape, dtype, low=0.0, high=1.0):
        want, arr = self.queue.pop(0)
        assert want == dist and tuple(arr.shape) == tuple(shape), \
            (want, dist, arr.shape, shape)
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=generator.device)


def _gas(mesh_shape, seed, T=800.0, p=5e6, rho=6.0, extra=()):
    """Seeded gas fields about the given state (numpy)."""
    rng = np.random.default_rng(seed)
    sh = mesh_shape
    g = dict(rho=rho * rng.uniform(0.9, 1.1, sh),
             U=rng.normal(0.0, 2.0, (3,) + sh),
             T=T + rng.uniform(-40.0, 40.0, sh),
             mu=2.5e-5 * rng.uniform(0.9, 1.1, sh),
             p=p * rng.uniform(0.98, 1.02, sh),
             Yv=rng.uniform(0.0, 0.02, sh))
    if "cp" in extra:
        g["cp"] = rng.uniform(1000.0, 1300.0, sh)
        g["kappa"] = rng.uniform(0.03, 0.08, sh)
    if "k_turb" in extra:
        g["k_turb"] = rng.uniform(5.0, 20.0, sh)
    return g


STATE = ("pos", "vel", "d", "T", "n_part", "active", "m_injected", "m_vol")


def _compare(cj, ct, sj, st, label):
    for f in STATE:
        a = np.asarray(getattr(cj, f))
        if a.size:
            assert _rel(a, getattr(ct, f)) <= 1e-10, (label, f)
    assert int(cj.inject_ptr) == int(ct.inject_ptr), label
    for fj, ft in zip(cj.films, ct.films):
        for f in ("m", "mom", "T", "m_evap"):
            assert _rel(getattr(fj, f), getattr(ft, f)) <= 1e-10, (label, f)
    for f in ("Srho", "SU", "Sh", "SY"):
        assert _rel(getattr(sj, f), getattr(st, f)) <= 1e-10, (label, f)


def run_both(cloud_j, cloud_t, gas_np, dt, steps, monkeypatch, seed=0,
             t0=0.0, prepare=None):
    """Evolve both clouds `steps` times from empty states (JAX key `seed`),
    JAX's draws replayed into the port; compare after every step. prepare:
    (state_j, state_t) -> (state_j, state_t) before the first step.
    Returns the final states."""
    replay = Replay()
    monkeypatch.setattr(tcloud, "draw", replay)
    gj = {k: jnp.asarray(v) for k, v in gas_np.items()}
    gt = {k: torch.as_tensor(v) for k, v in gas_np.items()}
    cj = cloud_j.init(jax.random.PRNGKey(seed))
    ct = cloud_t.init(torch.Generator().manual_seed(seed), torch.float64)
    if prepare is not None:
        cj, ct = prepare(cj, ct)
    step_j = jax.jit(lambda c, t: cloud_j.evolve(c, gj, dt, t))
    for i in range(steps):
        t = t0 + i * dt
        replay.queue, key_next = _jax_draws(cloud_j, cj.key, jnp.float64, gj)
        cj, sj = step_j(cj, jnp.asarray(t))
        ct, st = cloud_t.evolve(ct, gt, dt, torch.as_tensor(
            t, dtype=torch.float64))
        assert not replay.queue, "the port skipped a draw"
        np.testing.assert_array_equal(np.asarray(cj.key),
                                      np.asarray(key_next))
        _compare(cj, ct, sj, st, f"step {i}")
    return cj, ct


def _pair(cls_j, cls_t, **kw):
    return cls_j(**kw), cls_t(**kw)


BOX = dict(lengths=[0.02, 0.1, 0.02], cells=[8, 24, 8],
           origin=(-0.01, -0.1, -0.01))


def _meshes(lengths, cells, origin):
    return (StructuredMesh.box(lengths, cells, origin=origin),
            tmesh.StructuredMesh.box(lengths, cells, origin=origin,
                                     device="cpu"))


def _clouds(inj_kw, inj="cone", box=BOX, liquid="n_heptane", films=(),
            **cloud_kw):
    mj, mt = _meshes(**box)
    if inj == "cone":
        ij, it = _pair(jcloud.ConeInjector, tcloud.ConeInjector, **inj_kw)
    elif inj == "patch":
        ij, it = _pair(jcloud.PatchFuncInjector, tcloud.PatchFuncInjector,
                       **inj_kw)
    else:
        ij, it = _pair(jcloud.ManualInjector, tcloud.ManualInjector,
                       **inj_kw)
    fj = tuple(jfilm.WallFilm(**f) for f in films)
    ft = tuple(tfilm.WallFilm(**f) for f in films)
    lj, lt = getattr(jliq, liquid)(), getattr(tliq, liquid)()
    return (jcloud.SprayCloud(mesh=mj, liquid=lj, injector=ij, films=fj,
                              **cloud_kw),
            tcloud.SprayCloud(mesh=mt, liquid=lt, injector=it, films=ft,
                              **cloud_kw))


# the injector of tests/test_spray.py's make_cloud
CONE = dict(position=(0.0, -0.001, 0.0), direction=(0, -1, 0), u_mag=50.0,
            mdot=1e-3, t_start=0.0, t_end=1e-3, d_mean=5e-5,
            parcels_per_step=16)
FLOW = ((0.0, 0.1), (0.2e-3, 1.0), (0.6e-3, 1.0), (1.0e-3, 0.2),
        (1.25e-3, 0.0))

CASES = {
    # each injector
    "cone-lognormal": dict(inj_kw=CONE, gas=dict(T=900.0), dt=2e-5,
                           cloud=dict(max_parcels=2048)),
    "cone-rosin-rammler-flow": dict(
        inj_kw=dict(position=(0.0, -0.0005, 0.0), cone_angle_deg=20.0,
                    t_start=0.0, t_end=1.25e-3, T_inject=320.0,
                    mdot_profile=FLOW, mass_total=6e-6,
                    size_dist="RosinRammler", u_from_flow=True, Cd=0.9,
                    d_outer=1.9e-4, rho_liquid=700.0, parcels_per_step=20),
        gas=dict(T=800.0, extra=("cp",)), dt=2.5e-6, t0=1e-4,
        cloud=dict(max_parcels=256)),
    "manual-sphere-drag": dict(
        inj="manual", inj_kw=dict(
            positions=np.stack([np.linspace(-0.009, 0.009, 40),
                                np.linspace(-0.09, -0.01, 40),
                                np.zeros(40)], axis=1), soi=1e-5, d0=5e-6,
            n_particle=275.0, T_inject=300.0, U0=(0.0, 5.0, 0.0)),
        liquid="water", gas=dict(T=1500.0, p=1e5, rho=0.3), dt=1e-5,
        cloud=dict(max_parcels=40, drag="sphereDrag")),
    "patch-func": dict(
        inj="patch", inj_kw=dict(
            lo=(-0.008, -1e-4, -0.008), hi=(0.008, -1e-4, 0.008),
            mdot=1e-3, t_start=0.0, t_end=1e-3, d_mean=4e-5,
            parcels_per_step=16, size_dist="RosinRammler", radial_axis=0),
        gas=dict(T=400.0), dt=1e-5, cloud=dict(max_parcels=1024,
                                               evaporation="none")),
    # evaporation models
    "d2law": dict(inj_kw=dict(CONE, d_mean=3e-5), gas=dict(T=900.0),
                  dt=2e-5, cloud=dict(max_parcels=512, evaporation="D2law")),
    "mass-first": dict(inj_kw=dict(CONE, d_mean=3e-5),
                       gas=dict(T=900.0, extra=("cp",)), dt=2e-5,
                       cloud=dict(max_parcels=512, mass_first=True)),
    # breakup
    "reitz-diwakar": dict(inj_kw=dict(CONE, u_mag=250.0, d_mean=1.5e-4,
                                      t_end=0.9e-5),
                          gas=dict(T=500.0), dt=1e-5,
                          cloud=dict(max_parcels=2048, evaporation="none",
                                     breakup="ReitzDiwakar")),
    "khrt": dict(inj_kw=dict(CONE, u_mag=250.0, d_mean=1e-4, t_end=1.5e-6),
                 gas=dict(T=400.0), dt=2e-6,
                 cloud=dict(max_parcels=2048, evaporation="none",
                            breakup="KHRT")),
    # collision and dispersion
    "orourke": dict(inj_kw=dict(CONE, mdot=5e-2, cone_angle_deg=40.0,
                                u_mag=10.0, d_mean=3e-5,
                                parcels_per_step=64),
                    gas=dict(T=400.0), dt=1e-5, steps=4,
                    cloud=dict(max_parcels=2048, evaporation="none",
                               collision="ORourke")),
    "dispersion": dict(inj_kw=dict(CONE, u_mag=20.0, d_mean=3e-5,
                                   t_end=1.5e-5, cone_angle_deg=0.1),
                       gas=dict(T=400.0, extra=("k_turb",)), dt=1e-5,
                       cloud=dict(max_parcels=2048, evaporation="none",
                                  dispersion=True)),
    # walls
    "rebound-stick-escape": dict(
        inj_kw=dict(position=(0.0, -0.002, 0.0), direction=(0.3, -1, 0.2),
                    u_mag=30.0, mdot=1e-4, t_start=0.0, t_end=1.5e-5,
                    d_mean=5e-5, parcels_per_step=16, cone_angle_deg=60.0),
        box=dict(lengths=[0.02, 0.05, 0.02], cells=[8, 10, 8],
                 origin=(-0.01, -0.05, -0.01)),
        gas=dict(T=400.0, rho=30.0), dt=5e-4, steps=5,
        cloud=dict(max_parcels=256, evaporation="none",
                   wall_interaction=((1, 0, "rebound"), (0, 1, "stick"),
                                     (2, 1, "rebound")))),
    "film-absorb": dict(
        inj_kw=dict(position=(0.0, -0.006, 0.0), direction=(0, -1, 0),
                    cone_angle_deg=4.0, u_mag=20.0, mdot=1e-4, t_start=0.0,
                    t_end=1e-2, d_mean=4e-5, parcels_per_step=8),
        box=dict(lengths=[0.02, 0.02, 0.02], cells=[8, 8, 8],
                 origin=(-0.01, -0.01, -0.01)),
        films=(dict(axis=1, side=0),), gas=dict(T=350.0), dt=5e-5, steps=6,
        cloud=dict(max_parcels=1024, evaporation="none",
                   wall_interaction=((1, 0, "film"),))),
    "film-evaporation": dict(
        inj_kw=dict(position=(0.0, 0.008, 0.0), direction=(0, -1, 0),
                    mdot=0.0, t_start=1.0, t_end=2.0, parcels_per_step=4),
        box=dict(lengths=[0.02, 0.02, 0.02], cells=[8, 8, 8],
                 origin=(-0.01, -0.01, -0.01)),
        films=(dict(axis=1, side=0),), gas=dict(T=900.0), dt=1e-5,
        preload=True,
        cloud=dict(max_parcels=64, evaporation="none",
                   wall_interaction=((1, 0, "film"),))),
    # devolatilisation and gravity
    "devolatilisation": dict(
        inj_kw=dict(position=(0.0, -0.001, 0.0), direction=(0, -1, 0),
                    u_mag=5.0, mdot=1e-4, t_start=0.0, t_end=2.5e-5,
                    d_mean=5e-5, parcels_per_step=8),
        gas=dict(T=1200.0), dt=1e-5,
        cloud=dict(max_parcels=256, evaporation="none",
                   devolatilisation=((2e4, 5e7, 0.4), (5e3, 3e7, 0.1)))),
    "gravity": dict(
        inj_kw=dict(position=(0.0, -0.01, 0.0), direction=(0, -1, 0),
                    u_mag=1e-3, mdot=1e-4, t_start=0.0, t_end=1.2e-5,
                    d_mean=5e-5, d_spread=0.0, cone_angle_deg=0.0,
                    parcels_per_step=4),
        box=dict(lengths=[0.1, 0.4, 0.1], cells=[4, 16, 4],
                 origin=(-0.05, -0.4, -0.05)),
        gas=dict(T=300.0, p=101325.0, rho=1.2), dt=1e-4,
        cloud=dict(max_parcels=64, evaporation="none",
                   gravity=(0.0, -9.81, 0.0))),
}


def _patch_u_fn_j(x, y, z, t):
    return jnp.stack([jnp.zeros_like(x), -(20.0 + 1000.0 * jnp.abs(x)),
                      jnp.zeros_like(x)])


def _patch_u_fn_t(x, y, z, t):
    return torch.stack([torch.zeros_like(x), -(20.0 + 1000.0 * x.abs()),
                        torch.zeros_like(x)])


@pytest.mark.parametrize("case", list(CASES))
def test_evolve_matches_jax(case, monkeypatch):
    """A few evolve steps of each sub-model, JAX's draws replayed: state,
    films and the four sources within 1e-10 after every step."""
    c = dict(CASES[case])
    cloud_j, cloud_t = _clouds(c["inj_kw"], c.get("inj", "cone"),
                               c.get("box", BOX), c.get("liquid",
                                                        "n_heptane"),
                               c.get("films", ()), **c["cloud"])
    if case == "patch-func":
        # the velocity and flow-rate functions, each package's own
        cloud_j = dataclasses.replace(cloud_j, injector=dataclasses.replace(
            cloud_j.injector, u_fn=_patch_u_fn_j,
            mdot_fn=lambda t: 1e-3 * (1.0 + t / 1e-3)))
        cloud_t = dataclasses.replace(cloud_t, injector=dataclasses.replace(
            cloud_t.injector, u_fn=_patch_u_fn_t,
            mdot_fn=lambda t: 1e-3 * (1.0 + t / 1e-3)))
    g = c.get("gas", {})
    gas = _gas(cloud_j.mesh.shape, seed=len(case), **g)
    prepare = None
    if c.get("preload"):
        def prepare(cj, ct):
            # 10 g/m^2 of film at 400 K on the wall
            fj, ft = cj.films[0], ct.films[0]
            fj = fj._replace(m=fj.m + 1e-2, T=fj.T + 100.0)
            ft = ft._replace(m=ft.m + 1e-2, T=ft.T + 100.0)
            return cj._replace(films=(fj,)), ct._replace(films=(ft,))
    cj, ct = run_both(cloud_j, cloud_t, gas, c["dt"], c.get("steps", 3),
                      monkeypatch, seed=3, t0=c.get("t0", 0.0),
                      prepare=prepare)
    # the case did what it is there for
    stats = cloud_t.stats(ct)
    if c.get("films") and not c.get("preload"):
        assert float(stats["film_mass"]) > 0.0
    elif c.get("preload"):
        assert float(stats["film_evaporated"]) > 0.0
    else:
        assert float(stats["n_active"]) > 0
    for k, v in cloud_j.stats(cj).items():
        assert _rel(v, stats[k]) <= 1e-10, k
