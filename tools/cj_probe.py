"""Size a default-argument cj_speed run on the card.

    python3 tools/cj_probe.py CAP

One relaxation of cj_speed's first fixed-point iteration with its default
options (rtol 1e-8, atol 1e-14, relax time 2 ms) over its 9 default
Hugoniot points of stoichiometric H2-air at 1 atm and 300 K (the test
mechanism), at most CAP trips of the lane-batched integrator: prints the
trips run, the wall seconds and each point's trip count.
"""
import sys, time, os
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import deepflame_torch.chemistry as tc
from deepflame_torch.chemistry.integrator import RosenbrockOptions, rosenbrock_integrate
from deepflame_torch.chemistry.reactor import constant_volume_rhs_batched
from deepflame_torch.ops import kernels as K
mech = tc.load_mechanism("tests/data/h2_air_9sp.json", device="cuda")
th, kin = tc.make_thermo(mech), tc.make_kinetics(mech)
ns = mech.n_species
Y0 = np.zeros(ns); iH2, iO2, iN2, iH2O = (mech.species_index(s) for s in ("H2", "O2", "N2", "H2O"))
Y0[iH2], Y0[iO2], Y0[iN2] = 0.02851, 0.226, 0.745; Y0 /= Y0.sum()
Yb = Y0.copy(); wO2 = Y0[iH2] / 2.016 * 0.5 * 31.998; Yb[iH2O] = Y0[iH2] + wO2; Yb[iO2] -= wO2; Yb[iH2] = 0.0
f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device="cuda")
rho0 = float(th.rho(f(101325.0), f(300.0), f(Y0))); e0 = float(th.e_mass(f(300.0), f(Y0))); v0 = 1 / rho0
xs = np.linspace(0.48, 0.64, 9); v1 = xs * v0; p1 = np.full(9, 18 * 101325.0)
e1 = e0 + 0.5 * (p1 + 101325.0) * (v0 - v1)
Yb_t = f(Yb).expand(9, -1)
T0 = th.T_from_e(f(e1), Yb_t, torch.full((9,), 2500.0, dtype=torch.float64, device="cuda"), iters=50)
rhs = constant_volume_rhs_batched(th, kin, f(1 / v1))
for cap in (int(sys.argv[1]),):
    torch.cuda.synchronize(); t0 = time.perf_counter(); n0 = K.launches["gj_inverse"]
    y, n = rosenbrock_integrate(rhs, torch.cat([T0[:, None], Yb_t], 1), f(np.full(9, 2e-3)), RosenbrockOptions(rtol=1e-8, atol=1e-14, max_steps=cap), return_nstep=True)
    torch.cuda.synchronize(); w = time.perf_counter() - t0
    print(f"cj probe: default options, cap {cap}: {K.launches['gj_inverse'] - n0} trips in {w:.2f} s ({w / max(1, K.launches['gj_inverse'] - n0) * 1e3:.2f} ms a trip); per-lane trips {n.tolist()}")
