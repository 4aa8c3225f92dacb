"""Plain reference: species data, NASA-7 thermodynamics and mixture-averaged
transport of a Cantera-schema mechanism file (JSON syntax).

A frozen copy of the arithmetic of `deepflame_torch/chemistry/{mechanism,
thermo,transport}.py` (species part only: the DNN chemistry needs no
reaction data), in plain NumPy and PyTorch. It reads the mechanism file
itself and fits the transport curves itself, so nothing the program made
enters the reference.
"""
from __future__ import annotations

import json

import numpy as np
import torch

GAS_CONSTANT = 8314.462618      # J / (kmol K)
AVOGADRO = 6.02214076e26        # 1 / kmol
BOLTZMANN = 1.380649e-23        # J / K
DEBYE = 3.33564e-30             # C m
T_STD = 298.15
ATOMIC_WEIGHTS = {"H": 1.008, "O": 15.999, "N": 14.007, "C": 12.011,
                  "Ar": 39.948, "He": 4.002602}
GEOMETRY = {"atom": 0, "linear": 1, "nonlinear": 2}
N_FIT, DEGREE = 50, 4


def read_species(path: str) -> dict:
    """Species arrays (numpy float64) of the file's first phase."""
    with open(path) as f:
        doc = json.load(f)
    sel = doc["phases"][0].get("species", "all")
    by_name = {s["name"]: s for s in doc["species"]}
    names = list(by_name) if sel in ("all", None) else list(sel)
    ns = len(names)
    out = {k: np.zeros(ns) for k in (
        "W", "T_low", "T_mid", "T_high", "geometry", "well_depth",
        "diameter", "dipole", "rot_relax")}
    out["low"], out["high"] = np.zeros((ns, 7)), np.zeros((ns, 7))
    for i, name in enumerate(names):
        s = by_name[name]
        out["W"][i] = sum(float(c) * ATOMIC_WEIGHTS[e]
                          for e, c in s["composition"].items())
        tr_ = s["thermo"]["temperature-ranges"]
        data = s["thermo"]["data"]
        if len(tr_) == 3:
            out["T_low"][i], out["T_mid"][i], out["T_high"][i] = tr_
            out["low"][i], out["high"][i] = data[0], data[1]
        else:
            out["T_low"][i], out["T_high"][i] = tr_
            out["T_mid"][i] = tr_[1]
            out["low"][i] = out["high"][i] = data[0]
        t = s["transport"]
        out["geometry"][i] = GEOMETRY[t["geometry"]]
        out["well_depth"][i] = float(t["well-depth"])
        out["diameter"][i] = float(t["diameter"]) * 1e-10
        out["dipole"][i] = float(t.get("dipole", 0.0)) * DEBYE
        out["rot_relax"][i] = float(t.get("rotational-relaxation", 0.0))
    out["names"] = names
    return out


class Props:
    """Thermo and transport of one mechanism, as tensors of `dtype` on
    `device`. Fields are (..., ns) for species and (...,) otherwise."""

    def __init__(self, mech_path: str, dtype=torch.float64, device="cpu"):
        sp = read_species(mech_path)
        self.names = sp["names"]
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=device)
        self.W, self.inv_W = f(sp["W"]), f(1.0 / sp["W"])
        self.T_mid = f(sp["T_mid"])
        self.low, self.high = f(sp["low"]), f(sp["high"])
        self.T_min = float(max(np.min(sp["T_low"]), 100.0))
        self.T_max = float(np.max(sp["T_high"]))
        a = np.where((T_STD < sp["T_mid"])[:, None], sp["low"], sp["high"])
        h_rt = (a[:, 0] + T_STD * (a[:, 1] / 2 + T_STD * (
            a[:, 2] / 3 + T_STD * (a[:, 3] / 4 + T_STD * a[:, 4] / 5)))
            + a[:, 5] / T_STD)
        self.h_formation = f(h_rt * GAS_CONSTANT * T_STD / sp["W"])
        mu_c, lam_c, d_c = fit_transport(sp)
        self.mu_c, self.lam_c, self.d_c = f(mu_c), f(lam_c), f(d_c)

    # ---- thermo
    def _coeffs(self, T):
        return torch.where(T[..., None, None] < self.T_mid[:, None],
                           self.low, self.high)

    def h_species(self, T):
        a, t = self._coeffs(T), T[..., None]
        h_rt = (a[..., 0] + t * (a[..., 1] / 2 + t * (a[..., 2] / 3 + t * (
            a[..., 3] / 4 + t * a[..., 4] / 5))) + a[..., 5] / t)
        return h_rt * GAS_CONSTANT * t * self.inv_W

    def cp_species(self, T):
        a, t = self._coeffs(T), T[..., None]
        return (a[..., 0] + t * (a[..., 1] + t * (a[..., 2] + t * (
            a[..., 3] + t * a[..., 4])))) * GAS_CONSTANT * self.inv_W

    def h_mass(self, T, Y):
        return (Y * self.h_species(T)).sum(-1)

    def cp_mass(self, T, Y):
        return (Y * self.cp_species(T)).sum(-1)

    def psi(self, T, Y):
        return 1.0 / (Y * self.inv_W).sum(-1) / (GAS_CONSTANT * T)

    def rho(self, p, T, Y):
        return p * self.psi(T, Y)

    def mole_fractions(self, Y):
        x = Y * self.inv_W
        return x / x.sum(-1, keepdim=True)

    def T_from_h(self, h, Y, T_guess, iters: int = 8):
        """Newton on h(T) from the previous temperature, clamped to the
        fits' range."""
        T = torch.clamp(T_guess, self.T_min, self.T_max)
        for _ in range(iters):
            T = torch.clamp(T - (self.h_mass(T, Y) - h) / self.cp_mass(T, Y),
                            self.T_min, self.T_max)
        return T

    # ---- transport
    def mu_mix(self, T, X):
        """Wilke's rule in its separable form."""
        mu = torch.exp(_polyval(self.mu_c, torch.log(T)[..., None]))
        rw4 = self.W ** 0.25
        u, v = torch.sqrt(mu) / rw4, rw4 / torch.sqrt(mu)
        A = (1.0 / torch.sqrt(8.0 * (1.0 + self.W[:, None] / self.W[None, :]))).T
        den = X @ A + 2.0 * u * ((X * v) @ A) + (u * u) * ((X * v * v) @ A)
        return (X * mu / den).sum(-1)

    def lambda_mix(self, T, X):
        """Mathur-Saxena average."""
        lam = torch.exp(_polyval(self.lam_c, torch.log(T)[..., None]))
        return 0.5 * ((X * lam).sum(-1) + 1.0 / (X / lam).sum(-1))

    def mix_diff(self, T, p, X, Y):
        """Mixture-averaged D_km = (1 - Y_k) / sum_{j != k} X_j / D_jk."""
        lnT = torch.log(T)
        inv = torch.exp(-_polyval(self.d_c, lnT[..., None, None]))
        ns = inv.shape[-1]
        mask = 1.0 - torch.eye(ns, dtype=X.dtype, device=X.device)
        den = torch.einsum("...j,...kj->...k", X, inv * mask) * p[..., None]
        tiny = torch.finfo(X.dtype).eps
        diag_c = torch.diagonal(self.d_c, dim1=0, dim2=1).movedim(0, -1)
        Dkk = torch.exp(_polyval(diag_c, lnT[..., None])) / p[..., None]
        return torch.where(den > tiny, (1.0 - Y) / torch.clamp(den, min=tiny),
                           Dkk)


def _polyval(c, x):
    out = c[..., 0]
    for k in range(1, c.shape[-1]):
        out = out * x + c[..., k]
    return out


def _omega22(ts, ds):
    return (1.16145 * ts ** -0.14874 + 0.52487 * np.exp(-0.7732 * ts)
            + 2.16178 * np.exp(-2.43787 * ts) + 0.2 * ds ** 2 / ts)


def _omega11(ts, ds):
    return (1.06036 * ts ** -0.15610 + 0.19300 * np.exp(-0.47635 * ts)
            + 1.03587 * np.exp(-1.52996 * ts) + 1.76474 * np.exp(-3.89411 * ts)
            + 0.19 * ds ** 2 / ts)


def fit_transport(sp: dict, T_range=(250.0, 3500.0)):
    """Kinetic-theory species viscosity, conductivity (Warnatz-style modes)
    and binary diffusivities on 50 log-spaced temperatures, fitted as
    degree-4 polynomials in ln T of ln(mu), ln(lambda) and ln(D_jk p)."""
    W, eps, sigma = sp["W"], sp["well_depth"], sp["diameter"]
    ns, kB, R = len(W), BOLTZMANN, GAS_CONSTANT
    m = W / AVOGADRO
    delta = np.where(eps > 0, sp["dipole"] ** 2 / (
        2.0 * eps * kB * sigma ** 3 + 1e-300), 0.0)
    Ts = np.exp(np.linspace(np.log(T_range[0]), np.log(T_range[1]), N_FIT))
    lnTs = np.log(Ts)
    a = np.where((Ts[:, None] < sp["T_mid"][None, :])[..., None],
                 sp["low"][None], sp["high"][None])
    t = Ts[:, None]
    cp_R = a[..., 0] + t * (a[..., 1] + t * (a[..., 2] + t * (
        a[..., 3] + t * a[..., 4])))
    mu_k = (5.0 / 16.0) * np.sqrt(np.pi * m * kB * t) / (
        np.pi * sigma ** 2 * _omega22(t / eps[None, :], delta[None, :]))
    sig_jk = 0.5 * (sigma[:, None] + sigma[None, :])
    eps_jk = np.sqrt(eps[:, None] * eps[None, :])
    m_jk = m[:, None] * m[None, :] / (m[:, None] + m[None, :])
    delta_jk = np.sqrt(delta[:, None] * delta[None, :])
    Dp = np.stack([(3.0 / 16.0) * np.sqrt(2.0 * np.pi * kB ** 3 * T ** 3 / m_jk)
                   / (np.pi * sig_jk ** 2 * _omega11(T / eps_jk, delta_jk))
                   for T in Ts])
    geom = sp["geometry"]
    cv_rot = np.where(geom == 0, 0.0, np.where(geom == 1, 1.0, 1.5))[None, :]
    cv_tr = 1.5
    cv_vib = np.maximum(cp_R - 1.0 - cv_tr - cv_rot, 0.0)
    Dkk_p = np.stack([np.diag(Dp[i]) for i in range(N_FIT)])
    rD_mu = Dkk_p * (W[None, :] / (R * t)) / mu_k

    def parker(x):
        x = 1.0 / np.maximum(x, 1e-12)
        return (1.0 + 0.5 * np.pi ** 1.5 * np.sqrt(x)
                + (0.25 * np.pi ** 2 + 2.0) * x + np.pi ** 1.5 * x ** 1.5)

    z_rot = (np.maximum(sp["rot_relax"][None, :], 1.0)
             * parker(298.0 / np.maximum(eps, 1e-12))[None, :]
             / parker(t / np.maximum(eps, 1e-12)[None, :]))
    A = 2.5 - rD_mu
    B = z_rot + (2.0 / np.pi) * ((5.0 / 3.0) * cv_rot + rD_mu)
    f_tr = 2.5 * (1.0 - (2.0 / np.pi) * (cv_rot / cv_tr) * (A / B))
    f_rot = rD_mu * (1.0 + 2.0 * A / (np.pi * B))
    lam_k = (mu_k / W[None, :]) * R * (
        f_tr * cv_tr + np.where(geom[None, :] == 0, 0.0, f_rot * cv_rot)
        + rD_mu * cv_vib)
    mu_fit = np.stack([np.polyfit(lnTs, np.log(mu_k[:, k]), DEGREE)
                       for k in range(ns)])
    lam_fit = np.stack([np.polyfit(lnTs, np.log(np.maximum(lam_k[:, k], 1e-10)),
                                   DEGREE) for k in range(ns)])
    d_fit = np.empty((ns, ns, DEGREE + 1))
    for j in range(ns):
        for k in range(ns):
            d_fit[j, k] = np.polyfit(lnTs, np.log(Dp[:, j, k]), DEGREE)
    return mu_fit, lam_fit, d_fit
