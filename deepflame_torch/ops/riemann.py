"""Riemann flux schemes of the density-based solver, over whole face arrays.

Port of deepflame_tpu/ops/riemann.py: HLLC (Roe-averaged wave speeds), HLLCP
(HLLC with the low-Mach pressure fix), AUSMDV, and the central-upwind pair
Kurganov (Kurganov-Noelle-Petrova) and Tadmor (Kurganov-Tadmor). Each scheme
is plain elementwise tensor code over all faces of one axis at once, as the
JAX package computes it in XLA outside any kernel.

States are dicts of primitives reconstructed to the two sides of each face:
rho, u (normal), v, w (tangential), p, E (total energy per unit mass,
absolute internal plus kinetic), a (sound speed) and Y (species, trailing
axis). Each scheme returns the fluxes (mass, mom_n, mom_t1, mom_t2, energy,
species) per face.

The JAX guards `where(|den| > 1e-300, den, 1e-300)` and `maximum(ap - am,
1e-300)` are kept in the field's dtype: in float32 their floor is 0, in both
packages.
"""
from __future__ import annotations

import torch

__all__ = ["hllc_flux", "hllcp_flux", "ausmdv_flux", "kurganov_flux",
           "tadmor_flux", "FLUX_SCHEMES"]


def _tiny(x):
    """1e-300 in x's dtype (0 in float32)."""
    return torch.tensor(1e-300, dtype=x.dtype, device=x.device)


def _star_flux(rho, u, v, w, p, E, Y, S, S_star):
    """HLLC star-region flux F* = F + S (U* - U) of one side."""
    coef = rho * (S - u) / (S - S_star)
    r_s = coef
    ru_s = coef * S_star
    rv_s = coef * v
    rw_s = coef * w
    E_s = coef * (E + (S_star - u) * (S_star + p / (rho * (S - u))))
    r, ru, rv, rw = rho, rho * u, rho * v, rho * w
    rE = rho * E
    F_r = rho * u
    mass = F_r + S * (r_s - r)
    momn = rho * u * u + p + S * (ru_s - ru)
    momt1 = rho * u * v + S * (rv_s - rv)
    momt2 = rho * u * w + S * (rw_s - rw)
    ener = u * (rE + p) + S * (E_s - rE)
    Yflux = Y * (F_r + S * (r_s - r))[..., None]
    return mass, momn, momt1, momt2, ener, Yflux


def _physical_flux(rho, u, v, w, p, E, Y):
    mass = rho * u
    return (mass, rho * u * u + p, rho * u * v, rho * u * w,
            u * (rho * E + p), Y * mass[..., None])


def hllc_flux(L, R, pressure_fix: bool = False):
    """HLLC approximate Riemann solver (Toro), Roe-averaged wave speeds.
    pressure_fix=True gives HLLCP: the pressure jump in the contact speed
    scaled by the face Mach number (capped at 1)."""
    rhoL, uL, pL, EL, aL, YL = L["rho"], L["u"], L["p"], L["E"], L["a"], L["Y"]
    rhoR, uR, pR, ER, aR, YR = R["rho"], R["u"], R["p"], R["E"], R["a"], R["Y"]
    vL, wL, vR, wR = L["v"], L["w"], R["v"], R["w"]

    sL = torch.sqrt(rhoL)
    sR = torch.sqrt(rhoR)
    inv = 1.0 / (sL + sR)
    u_roe = (sL * uL + sR * uR) * inv
    a_roe = torch.sqrt((sL * aL**2 + sR * aR**2) * inv
                       + 0.5 * sL * sR * inv * inv * (uR - uL) ** 2)
    S_L = torch.minimum(uL - aL, u_roe - a_roe)
    S_R = torch.maximum(uR + aR, u_roe + a_roe)

    dp = pR - pL
    if pressure_fix:
        mach = torch.maximum(uL.abs() / aL, uR.abs() / aR)
        dp = dp * torch.clamp(mach, max=1.0)

    num = dp + rhoL * uL * (S_L - uL) - rhoR * uR * (S_R - uR)
    den = rhoL * (S_L - uL) - rhoR * (S_R - uR)
    tiny = _tiny(den)
    S_star = num / torch.where(den.abs() > tiny, den, tiny)

    FL = _physical_flux(rhoL, uL, vL, wL, pL, EL, YL)
    FR = _physical_flux(rhoR, uR, vR, wR, pR, ER, YR)
    FsL = _star_flux(rhoL, uL, vL, wL, pL, EL, YL, S_L, S_star)
    FsR = _star_flux(rhoR, uR, vR, wR, pR, ER, YR, S_R, S_star)

    def select(fl, fsl, fsr, fr):
        ex = (lambda a: a[..., None]) if fl.dim() > S_L.dim() else (lambda a: a)
        return torch.where(ex(S_L) >= 0, fl,
                           torch.where(ex(S_star) >= 0, fsl,
                                       torch.where(ex(S_R) >= 0, fsr, fr)))

    return tuple(select(*f) for f in zip(FL, FsL, FsR, FR))


def hllcp_flux(L, R):
    return hllc_flux(L, R, pressure_fix=True)


def ausmdv_flux(L, R):
    """AUSMDV flux-vector/difference splitting (Wada and Liou's blend)."""
    rhoL, uL, pL, EL, YL = L["rho"], L["u"], L["p"], L["E"], L["Y"]
    rhoR, uR, pR, ER, YR = R["rho"], R["u"], R["p"], R["E"], R["Y"]
    vL, wL, vR, wR = L["v"], L["w"], R["v"], R["w"]
    am = torch.maximum(L["a"], R["a"])

    alphaL = 2.0 * (pL / rhoL) / (pL / rhoL + pR / rhoR)
    alphaR = 2.0 * (pR / rhoR) / (pL / rhoL + pR / rhoR)

    def u_plus(u, alpha):
        sub = alpha * ((u + am) ** 2 / (4 * am) - 0.5 * (u + u.abs())) \
            + 0.5 * (u + u.abs())
        return torch.where(u.abs() <= am, sub, 0.5 * (u + u.abs()))

    def u_minus(u, alpha):
        sub = -alpha * ((u - am) ** 2 / (4 * am) + 0.5 * (u - u.abs())) \
            + 0.5 * (u - u.abs())
        return torch.where(u.abs() <= am, sub, 0.5 * (u - u.abs()))

    # sign(0) = 0, as jnp.sign
    def p_plus(u, p):
        sub = p * (u + am) ** 2 * (2.0 - u / am) / (4 * am**2)
        return torch.where(u.abs() <= am, sub, p * 0.5 * (1.0 + torch.sign(u)))

    def p_minus(u, p):
        sub = p * (u - am) ** 2 * (2.0 + u / am) / (4 * am**2)
        return torch.where(u.abs() <= am, sub, p * 0.5 * (1.0 - torch.sign(u)))

    up = u_plus(uL, alphaL)
    um = u_minus(uR, alphaR)
    p_half = p_plus(uL, pL) + p_minus(uR, pR)
    mass = up * rhoL + um * rhoR

    # AUSMV / AUSMD momentum blend switched on the pressure jump
    s = torch.clamp(10.0 * (pR - pL).abs() / torch.minimum(pL, pR),
                    0.0, 1.0) * 0.5
    momn_ausmv = up * rhoL * uL + um * rhoR * uR
    momn_ausmd = 0.5 * (mass * (uL + uR) - mass.abs() * (uR - uL))
    momn = (0.5 + s) * momn_ausmv + (0.5 - s) * momn_ausmd + p_half

    half = 0.5 * (mass + mass.abs())
    halfm = 0.5 * (mass - mass.abs())
    momt1 = half * vL + halfm * vR
    momt2 = half * wL + halfm * wR
    HL = EL + pL / rhoL
    HR = ER + pR / rhoR
    ener = half * HL + halfm * HR
    Yflux = half[..., None] * YL + halfm[..., None] * YR
    return mass, momn, momt1, momt2, ener, Yflux


def _central_upwind(L, R, knp: bool):
    """Kurganov(-Noelle-Petrova) central-upwind flux (rhoCentralFoam)."""
    rhoL, uL, pL, EL, YL = L["rho"], L["u"], L["p"], L["E"], L["Y"]
    rhoR, uR, pR, ER, YR = R["rho"], R["u"], R["p"], R["E"], R["Y"]
    zero = torch.zeros((), dtype=uL.dtype, device=uL.device)
    ap = torch.maximum(torch.maximum(uL + L["a"], uR + R["a"]), zero)
    am = torch.minimum(torch.minimum(uL - L["a"], uR - R["a"]), zero)
    FL = _physical_flux(rhoL, uL, L["v"], L["w"], pL, EL, YL)
    FR = _physical_flux(rhoR, uR, R["v"], R["w"], pR, ER, YR)
    UL = (rhoL, rhoL * uL, rhoL * L["v"], rhoL * L["w"], rhoL * EL,
          YL * rhoL[..., None])
    UR = (rhoR, rhoR * uR, rhoR * R["v"], rhoR * R["w"], rhoR * ER,
          YR * rhoR[..., None])
    ex = lambda f, a: a[..., None] if f.dim() > a.dim() else a
    if knp:
        d = 1.0 / torch.maximum(ap - am, _tiny(ap))
        return tuple((ex(fl, ap) * fl - ex(fl, am) * fr) * ex(fl, d)
                     + ex(fl, ap) * ex(fl, am) * ex(fl, d) * (ur - ul)
                     for fl, fr, ul, ur in zip(FL, FR, UL, UR))
    # Kurganov-Tadmor: symmetric max speed
    a_max = torch.maximum(ap, -am)
    return tuple(0.5 * (fl + fr) - 0.5 * ex(fl, a_max) * (ur - ul)
                 for fl, fr, ul, ur in zip(FL, FR, UL, UR))


def kurganov_flux(L, R):
    return _central_upwind(L, R, knp=True)


def tadmor_flux(L, R):
    return _central_upwind(L, R, knp=False)


FLUX_SCHEMES = {
    "HLLC": hllc_flux,
    "HLLCP": hllcp_flux,
    "AUSMDV": ausmdv_flux,
    "Kurganov": kurganov_flux,
    "Tadmor": tadmor_flux,
}
