"""Mixture-averaged transport: kinetic-theory property fits, torch evaluation.

Port of deepflame_tpu/chemistry/transport.py. Per-species curves are fitted
once, host-side in numpy float64 (the same code, so both packages get the same
coefficients), as degree-4 polynomials in ln T of ln(mu), ln(lambda) and
ln(D_jk p); at run time the polynomials are evaluated on tensors and combined
with the mixture rules (Wilke viscosity in its separable form, Mathur-Saxena
conductivity, mixture-averaged Fickian diffusion).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import AVOGADRO, BOLTZMANN, GAS_CONSTANT
from ..device import resolve_device
from .mechanism import Mechanism

__all__ = ["TransportData", "make_transport"]

_N_FIT = 50
_DEGREE = 4


def _omega22(t_star, delta_star):
    o = (1.16145 * t_star**-0.14874 + 0.52487 * np.exp(-0.7732 * t_star)
         + 2.16178 * np.exp(-2.43787 * t_star))
    return o + 0.2 * delta_star**2 / t_star


def _omega11(t_star, delta_star):
    o = (1.06036 * t_star**-0.15610 + 0.19300 * np.exp(-0.47635 * t_star)
         + 1.03587 * np.exp(-1.52996 * t_star) + 1.76474 * np.exp(-3.89411 * t_star))
    return o + 0.19 * delta_star**2 / t_star


def _cp_R_np(mech: Mechanism, T: np.ndarray) -> np.ndarray:
    a = np.where((T[:, None] < mech.nasa_T_mid[None, :])[..., None],
                 mech.nasa_low[None], mech.nasa_high[None])
    t = T[:, None]
    return a[..., 0] + t * (a[..., 1] + t * (a[..., 2] + t * (a[..., 3] + t * a[..., 4])))


def _polyval(coeffs, lnT):
    """Horner evaluation, highest power first; lnT carries trailing singleton
    dims so it broadcasts against the coefficient dims."""
    out = coeffs[..., 0]
    for k in range(1, coeffs.shape[-1]):
        out = out * lnT + coeffs[..., k]
    return out


@dataclasses.dataclass(frozen=True)
class TransportData:
    mu_coeffs: torch.Tensor    # (ns, deg+1) fit of ln(mu) in ln(T)
    lam_coeffs: torch.Tensor   # (ns, deg+1) fit of ln(lambda) in ln(T)
    diff_coeffs: torch.Tensor  # (ns, ns, deg+1) fit of ln(D_jk p) in ln(T)
    W: torch.Tensor            # (ns,)
    inv_W: torch.Tensor

    def mu_species(self, T):
        return torch.exp(_polyval(self.mu_coeffs, torch.log(T)[..., None]))

    def lambda_species(self, T):
        return torch.exp(_polyval(self.lam_coeffs, torch.log(T)[..., None]))

    def binary_diff(self, T, p):
        """(..., ns, ns) binary diffusion coefficients [m^2/s]."""
        lnT = torch.log(T)[..., None, None]
        return torch.exp(_polyval(self.diff_coeffs, lnT)) / p[..., None, None]

    def mu_mix(self, T, X):
        """Wilke mixture viscosity, separable form: three (cells, ns) @ (ns, ns)
        products with constant matrices, no (cells, ns, ns) intermediate."""
        mu = self.mu_species(T)
        rW4 = self.W ** 0.25
        u = torch.sqrt(mu) / rW4
        v = rW4 / torch.sqrt(mu)
        inv_d = 1.0 / torch.sqrt(8.0 * (1.0 + self.W[:, None] / self.W[None, :]))
        A = inv_d.T
        denom = X @ A + 2.0 * u * ((X * v) @ A) + (u * u) * ((X * v * v) @ A)
        return (X * mu / denom).sum(-1)

    def lambda_mix(self, T, X):
        """Mathur-Saxena average: 0.5 (sum x l + 1/sum(x/l))."""
        lam = self.lambda_species(T)
        return 0.5 * ((X * lam).sum(-1) + 1.0 / (X / lam).sum(-1))

    def mix_diff_coeffs(self, T, p, X, Y):
        """(..., ns) mixture-averaged D_km = (1 - Y_k) / sum_{j != k} X_j/D_jk."""
        lnT = torch.log(T)[..., None, None]
        inv_no_p = torch.exp(-_polyval(self.diff_coeffs, lnT))       # 1/(D p)
        ns = inv_no_p.shape[-1]
        mask = 1.0 - torch.eye(ns, dtype=X.dtype, device=X.device)
        denom = torch.einsum("...j,...kj->...k", X, inv_no_p * mask) * p[..., None]
        tiny = torch.finfo(X.dtype).eps
        # pure-species limit: D_km -> D_kk from the diagonal fits
        diag_c = torch.diagonal(self.diff_coeffs, dim1=0, dim2=1)      # (deg+1, ns)
        Dkk = torch.exp(_polyval(diag_c.movedim(0, -1),
                                 torch.log(T)[..., None])) / p[..., None]
        return torch.where(denom > tiny, (1.0 - Y) / torch.clamp(denom, min=tiny),
                           Dkk)


def make_transport(mech: Mechanism, dtype=torch.float64, device=None,
                   T_range=(250.0, 3500.0)) -> TransportData:
    """Transport fits on `device` (default: the mechanism's device)."""
    device = resolve_device(mech.device if device is None else device)
    ns = mech.n_species
    W = mech.molecular_weights                      # kg/kmol
    m = W / AVOGADRO                                # kg/molecule
    eps = mech.well_depth                           # K (eps/kB)
    sigma = mech.diameter                           # m
    mu_dip = mech.dipole                            # C m
    kB = BOLTZMANN

    delta = mu_dip**2 / (2.0 * eps * kB * sigma**3 + 1e-300)
    delta = np.where(eps > 0, delta, 0.0)

    Ts = np.exp(np.linspace(np.log(T_range[0]), np.log(T_range[1]), _N_FIT))
    lnTs = np.log(Ts)
    cp_R = _cp_R_np(mech, Ts)

    t_star = Ts[:, None] / eps[None, :]
    om22 = _omega22(t_star, delta[None, :])
    mu_k = (5.0 / 16.0) * np.sqrt(np.pi * m * kB * Ts[:, None]) / (np.pi * sigma**2 * om22)

    sig_jk = 0.5 * (sigma[:, None] + sigma[None, :])
    eps_jk = np.sqrt(eps[:, None] * eps[None, :])
    m_jk = m[:, None] * m[None, :] / (m[:, None] + m[None, :])
    delta_jk = np.sqrt(delta[:, None] * delta[None, :])
    Dp = np.empty((_N_FIT, ns, ns))
    for it, T in enumerate(Ts):
        ts = T / eps_jk
        om11 = _omega11(ts, delta_jk)
        Dp[it] = (3.0 / 16.0) * np.sqrt(2.0 * np.pi * kB**3 * T**3 / m_jk) / (
            np.pi * sig_jk**2 * om11)

    R = GAS_CONSTANT
    cv_R = cp_R - 1.0
    geom = mech.geometry
    cv_rot_R = np.where(geom == 0, 0.0, np.where(geom == 1, 1.0, 1.5))[None, :]
    cv_tr_R = 1.5
    cv_vib_R = np.maximum(cv_R - cv_tr_R - cv_rot_R, 0.0)
    Dkk_p = np.stack([np.diag(Dp[it]) for it in range(_N_FIT)])
    rhoD_over_mu = Dkk_p * (W[None, :] / (R * Ts[:, None])) / mu_k

    def parker(Teps):
        x = 1.0 / np.maximum(Teps, 1e-12)
        return (1.0 + 0.5 * np.pi**1.5 * np.sqrt(x) + (0.25 * np.pi**2 + 2.0) * x
                + np.pi**1.5 * x**1.5)

    F298 = parker(298.0 / np.maximum(eps, 1e-12))[None, :]
    FT = parker(Ts[:, None] / np.maximum(eps, 1e-12)[None, :])
    z_rot = np.maximum(mech.rot_relax[None, :], 1.0) * F298 / FT

    A = 2.5 - rhoD_over_mu
    B = z_rot + (2.0 / np.pi) * ((5.0 / 3.0) * cv_rot_R + rhoD_over_mu)
    f_tr = 2.5 * (1.0 - (2.0 / np.pi) * (cv_rot_R / cv_tr_R) * (A / B))
    f_rot = rhoD_over_mu * (1.0 + 2.0 * A / (np.pi * B))
    f_vib = rhoD_over_mu
    lam_k = (mu_k / (W[None, :] / 1.0)) * R * (
        f_tr * cv_tr_R + np.where(geom[None, :] == 0, 0.0, f_rot * cv_rot_R)
        + f_vib * cv_vib_R)

    mu_fit = np.stack([np.polyfit(lnTs, np.log(mu_k[:, k]), _DEGREE) for k in range(ns)])
    lam_fit = np.stack([np.polyfit(lnTs, np.log(np.maximum(lam_k[:, k], 1e-10)), _DEGREE)
                        for k in range(ns)])
    d_fit = np.empty((ns, ns, _DEGREE + 1))
    for j in range(ns):
        for k in range(ns):
            d_fit[j, k] = np.polyfit(lnTs, np.log(Dp[:, j, k]), _DEGREE)

    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                  device=device)
    return TransportData(mu_coeffs=f(mu_fit), lam_coeffs=f(lam_fit),
                         diff_coeffs=f(d_fit), W=f(W), inv_W=f(1.0 / W))
