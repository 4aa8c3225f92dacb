"""PyTorch port of the Chapman-Jouguet calculator against the JAX package
(float64, CPU) on the 9-species test mechanism: three Hugoniot points as
lanes of one batched relaxation against JAX's sequential loop, with looser
integrator options than the default so that the test stays short. D within
1e-6 relative, T_CJ and p_CJ too."""
import os

import numpy as np
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.utils.cj import cj_speed

import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry.integrator import RosenbrockOptions as TOpts
from deepflame_torch.utils.cj import cj_speed as t_cj_speed

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


def _mixture(mech):
    """Stoichiometric H2-air and its complete-combustion composition."""
    ns = mech.n_species
    iH2, iO2, iN2, iH2O = (mech.species_index(s)
                           for s in ("H2", "O2", "N2", "H2O"))
    Y0 = np.zeros(ns)
    Y0[iH2], Y0[iO2], Y0[iN2] = 0.02851, 0.226, 0.745
    Y0 /= Y0.sum()
    Yb = Y0.copy()
    wO2 = Y0[iH2] / 2.016 * 0.5 * 31.998
    Yb[iH2O] = Y0[iH2] + wO2
    Yb[iO2] -= wO2
    Yb[iH2] = 0.0
    return Y0, Yb


def test_cj_speed_matches_jax():
    mj = load_mechanism(MECH)
    Y0, Yb = _mixture(mj)
    kw = dict(x_range=(0.52, 0.60), n_x=3, relax_time=3e-6)
    ref = cj_speed(make_thermo(mj), make_kinetics(mj), Y0, Yb, 101325.0,
                   300.0, opts=RosenbrockOptions(rtol=1e-4, atol=1e-8,
                                                 max_steps=20000), **kw)
    mt = tc.load_mechanism(MECH, device="cpu")
    got = t_cj_speed(tc.make_thermo(mt, torch.float64),
                     tc.make_kinetics(mt, torch.float64), Y0, Yb, 101325.0,
                     300.0, opts=TOpts(rtol=1e-4, atol=1e-8,
                                       max_steps=20000), **kw)
    assert 1500.0 < ref[0] < 2500.0
    for a, b in zip(ref, got):
        assert abs(a - b) <= 1e-6 * abs(a), (ref, got)
