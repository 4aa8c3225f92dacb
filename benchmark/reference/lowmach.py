"""Plain reference of one low-Mach PIMPLE step on a periodic box: the step of
DeepFlame's dfLowMachFoam as `deepflame_torch/solvers/low_mach.py` defines it
for a structured box whose every side is cyclic, written again in plain
PyTorch with `torch.roll` in place of ghost padding.

    rhoEqn -> mixture (+ Sigma SGS) -> UEqn -> YEqn (the given RR) -> EEqn
    -> T from ha -> n_corr pressure correctors -> continuity rho

Faces: a face array holds, in cell i, the face between cells i and i + 1
along its axis (the program keeps n + 1 faces, the first and last both
the wrap face: `faces_from_program` takes faces 1..n). Every Krylov solve
is the same Jacobi-preconditioned BiCGStab or CG, with OpenFOAM's
normalised residual, tolerances and caps as the program states them.
"""
from __future__ import annotations

import math

import torch

from .props import Props


def roll(f, s, ax):
    return torch.roll(f, s, dims=ax - 3)


def interp(f, ax):
    """Linear value on each cell's high face along ax."""
    return 0.5 * (f + roll(f, -1, ax))


def fdiff(F, ax):
    """Face array -> per-cell high face minus low face."""
    return F - roll(F, 1, ax)


def grad(f, h):
    return torch.stack([fdiff(interp(f, a), a) / h[a] for a in range(3)])


def div_flux(phi, h):
    out = 0.0
    for a in range(3):
        out = out + fdiff(phi[a], a) / h[a]
    return out


def face_value(psi, wf, ax, scheme):
    """Face value of psi on the high faces along ax for flux sign wf:
    upwind, linear, or upwind + TVD limiter * (central - upwind)."""
    own, nei = psi, roll(psi, -1, ax)
    up = torch.where(wf >= 0, own, nei)
    if scheme == "upwind":
        return up
    central = 0.5 * (own + nei)
    if scheme == "linear":
        return central
    d = nei - own
    eps = torch.finfo(psi.dtype).eps
    safe_d = torch.where(d.abs() > eps, d, torch.full_like(d, eps))
    r = torch.where(wf >= 0, (own - roll(psi, 1, ax)) / safe_d,
                    (nei - roll(psi, -2, ax)) / (-safe_d))
    lim = torch.clamp(2.0 * r, 0.0, 1.0)
    if scheme == "limitedLinear01":
        delta = central - up
        big = torch.full_like(delta, 1e30)
        lim_hi = torch.where(delta > eps, (1.0 - up) / torch.clamp(delta, min=eps), big)
        lim_lo = torch.where(delta < -eps, up / torch.clamp(-delta, min=eps), big)
        lim = torch.clamp(torch.minimum(lim, torch.minimum(lim_hi, lim_lo)), min=0.0)
    elif scheme != "limitedLinear":
        raise ValueError(f"scheme {scheme!r}")
    return up + lim * (central - up)


def cubic(f, ax):
    """4-point cubic value on each cell's high face along ax."""
    return (9.0 * (f + roll(f, -1, ax)) - (roll(f, 1, ax) + roll(f, -2, ax))) / 16.0


class Stencil:
    """A x = D x + sum_ax (lo_ax x_{i-1} + hi_ax x_{i+1}), periodic."""

    def __init__(self, D):
        self.D, self.lo, self.hi = D, [0.0] * 3, [0.0] * 3

    def ddt(self, c, dt):
        self.D = self.D + c / dt

    def upwind(self, phi, wf, h):
        for a in range(3):
            w_hi = (wf[a] >= 0).to(phi[a].dtype)
            w_lo = roll(w_hi, 1, a)
            p_hi, p_lo = phi[a], roll(phi[a], 1, a)
            self.D = self.D + (p_hi * w_hi - p_lo * (1.0 - w_lo)) / h[a]
            self.hi[a] = self.hi[a] + p_hi * (1.0 - w_hi) / h[a]
            self.lo[a] = self.lo[a] - p_lo * w_lo / h[a]

    def linear(self, phi, h):
        for a in range(3):
            p_hi, p_lo = phi[a], roll(phi[a], 1, a)
            self.D = self.D + (p_hi - p_lo) / (2.0 * h[a])
            self.hi[a] = self.hi[a] + p_hi / (2.0 * h[a])
            self.lo[a] = self.lo[a] - p_lo / (2.0 * h[a])

    def laplacian(self, g, h):
        """- laplacian(g, x), g per-axis face arrays."""
        for a in range(3):
            g_hi, g_lo = g[a], roll(g[a], 1, a)
            self.D = self.D + (g_lo + g_hi) / (h[a] * h[a])
            self.lo[a] = self.lo[a] - g_lo / (h[a] * h[a])
            self.hi[a] = self.hi[a] - g_hi / (h[a] * h[a])

    def done(self, shape):
        self.D = torch.broadcast_to(self.D, shape).contiguous()
        self.lo = [torch.broadcast_to(t, shape) for t in self.lo]
        self.hi = [torch.broadcast_to(t, shape) for t in self.hi]
        return self

    def __call__(self, x):
        out = self.D * x
        for a in range(3):
            out = out + self.lo[a] * roll(x, 1, a) + self.hi[a] * roll(x, -1, a)
        return out


def tvd_correction(phi, psi, h, scheme):
    """Explicit deferred correction of a TVD scheme: the limited face
    values less the upwind ones, as a divergence."""
    out = 0.0
    for a in range(3):
        hi = face_value(psi, phi[a], a, scheme)
        lo = face_value(psi, phi[a], a, "upwind")
        out = out + fdiff(phi[a] * (hi - lo), a) / h[a]
    return out


# ------------------------------------------------------------------ Krylov

def _vsum(x):
    return x.sum(dim=(-3, -2, -1))


def _b(s):
    return s.reshape(s.shape + (1, 1, 1))


def _safe_div(a, b):
    tiny = torch.finfo(b.dtype).tiny
    return a / torch.where(b.abs() > tiny, b, torch.where(
        b >= 0, torch.full_like(b, tiny), torch.full_like(b, -tiny)))


def _norm(A, b, x):
    xbar = _b(x.mean(dim=(-3, -2, -1))) * torch.ones_like(x)
    Axbar = A(xbar)
    n = _vsum((A(x) - Axbar).abs()) + _vsum((b - Axbar).abs())
    return torch.clamp(n, min=torch.finfo(b.dtype).tiny)


def cg(A, b, x, M, tol, rel_tol, max_iter):
    """Returns (x, iterations per lane)."""
    norm = _norm(A, b, x)
    r = b - A(x)
    res0 = _vsum(r.abs()) / norm
    z = M(r)
    p, rz, res = z, _vsum(r * z), res0
    it = torch.zeros(res0.shape, dtype=torch.long, device=b.device)
    for _ in range(max_iter):
        act = (it < max_iter) & (res > tol) & (res > rel_tol * res0)
        if not bool(act.any()):
            break
        Ap = A(p)
        alpha = _safe_div(rz, _vsum(p * Ap))
        x_n, r_n = x + _b(alpha) * p, r - _b(alpha) * Ap
        z = M(r_n)
        rz_n = _vsum(r_n * z)
        p_n = z + _b(_safe_div(rz_n, rz)) * p
        res_n = _vsum(r_n.abs()) / norm
        ok = torch.isfinite(res_n)
        u = act & ok
        x, r, p = (torch.where(_b(u), n_, o) for n_, o in ((x_n, x), (r_n, r), (p_n, p)))
        rz = torch.where(u, rz_n, rz)
        res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
        it = it + act.long()
    return x, it


def bicgstab(A, b, x, M, tol, max_iter):
    """Returns (x, iterations per lane)."""
    norm = _norm(A, b, x)
    r = b - A(x)
    res0 = _vsum(r.abs()) / norm
    r_hat, p, v = r, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = (torch.ones_like(res0) for _ in range(3))
    res = res0
    it = torch.zeros(res0.shape, dtype=torch.long, device=b.device)
    for _ in range(max_iter):
        act = (it < max_iter) & (res > tol) & (res > 0.0 * res0)
        if not bool(act.any()):
            break
        rho_n = _vsum(r_hat * r)
        beta = _safe_div(rho_n, rho) * _safe_div(alpha, omega)
        p_n = r + _b(beta) * (p - _b(omega) * v)
        p_hat = M(p_n)
        v_n = A(p_hat)
        alpha_n = _safe_div(rho_n, _vsum(r_hat * v_n))
        s = r - _b(alpha_n) * v_n
        s_hat = M(s)
        t = A(s_hat)
        omega_n = _safe_div(_vsum(t * s), _vsum(t * t))
        x_n = x + _b(alpha_n) * p_hat + _b(omega_n) * s_hat
        r_n = s - _b(omega_n) * t
        res_n = _vsum(r_n.abs()) / norm
        ok = torch.isfinite(res_n)
        u = act & ok
        x, r, p, v = (torch.where(_b(u), n_, o) for n_, o in
                      ((x_n, x), (r_n, r), (p_n, p), (v_n, v)))
        rho, alpha, omega = (torch.where(u, n_, o) for n_, o in
                             ((rho_n, rho), (alpha_n, alpha), (omega_n, omega)))
        res = torch.where(act, torch.where(ok, res_n, torch.full_like(res_n, -1.0)), res)
        it = it + act.long()
    return x, it


def _jacobi(D):
    d_inv = 1.0 / torch.where(D.abs() > 1e-300, D, torch.ones_like(D))
    return lambda r: d_inv * r


# ------------------------------------------------------------------ model

def _eig3(a00, a11, a22, a01, a02, a12):
    """Eigenvalues of a symmetric 3x3 field, descending (trigonometric)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    floor = 1e-60 if a00.dtype == torch.float64 else 1e-30
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=floor))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    det = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return e1, 3.0 * q - e1 - e3, e3


def sigma_mu_t(rho, U, h, Csigma):
    """Sigma SGS viscosity (Nicoud et al. 2011), filter width the cube root
    of the cell volume."""
    g = torch.stack([grad(U[c], h) for c in range(3)])      # g[i, j] = dU_i/dx_j

    def c(i, j):
        return g[0, i] * g[0, j] + g[1, i] * g[1, j] + g[2, i] * g[2, j]

    l1, l2, l3 = _eig3(c(0, 0), c(1, 1), c(2, 2), c(0, 1), c(0, 2), c(1, 2))
    s1, s2, s3 = (torch.sqrt(torch.clamp(l, min=0.0)) for l in (l1, l2, l3))
    D = s3 * (s1 - s2) * (s2 - s3) / torch.clamp(s1 * s1, min=1e-30)
    delta = (h[0] * h[1] * h[2]) ** (1.0 / 3.0)
    return rho * (Csigma * delta) ** 2 * torch.clamp(D, min=0.0)


def faces_from_program(phi):
    """The program's (n + 1)-face arrays -> one high face a cell."""
    return tuple(phi[a].narrow(a - 3, 1, phi[a].shape[a - 3] - 1)
                 for a in range(3))


def step(s: dict, RR, dt: float, h, props: Props, cfg: dict):
    """One step from state `s` (rho, U (3, ...), p, ha, Y (ns, ...), T, phi
    (3 face arrays), dpdt) with the chemistry's rates RR (ns, ...).
    `cfg`: the solver settings of the configuration file. Returns the new
    state (same keys) and the iteration counts."""
    rho_old, U_old, p_old, ha_old, Y_old = s["rho"], s["U"], s["p"], s["ha"], s["Y"]
    phi, U, p, ha, Y, T = s["phi"], s["U"], s["p"], s["ha"], s["Y"], s["T"]
    dpdt = s["dpdt"]
    ns, sh = Y.shape[0], T.shape
    iters = {}

    rho = rho_old - dt * div_flux(phi, h)
    # mixture and SGS coefficients
    Yt = torch.movedim(Y, 0, -1)
    X = props.mole_fractions(Yt)
    mu = props.mu_mix(T, X)
    alpha = props.lambda_mix(T, X) / props.cp_mass(T, Yt)
    rhoD = torch.movedim(props.rho(p, T, Yt)[..., None]
                         * props.mix_diff(T, p, X, Yt), -1, 0)
    mu_t = sigma_mu_t(rho, U, h, cfg["Csigma"])
    mu = mu + mu_t
    alpha = alpha + mu_t / cfg["Pr_t"]
    rhoD = rhoD + mu_t[None] / cfg["Sc_t"]

    # UEqn
    gp = grad(p, h)
    gU = [grad(U[c], h) for c in range(3)]
    g_div = grad(mu * (gU[0][0] + gU[1][1] + gU[2][2]), h)
    srcs = torch.stack([
        -gp[c] + (grad(mu * gU[0][c], h)[0] + grad(mu * gU[1][c], h)[1]
                  + grad(mu * gU[2][c], h)[2] - g_div[c] * (2.0 / 3.0))
        for c in range(3)])
    A = Stencil(0.0)
    A.ddt(rho, dt)
    A.linear(phi, h)
    A.laplacian([interp(mu, a) for a in range(3)], h)
    A.done((3,) + sh)
    b = rho_old * U_old / dt + srcs
    U_new, it = bicgstab(A, b, U.contiguous(), _jacobi(A.D),
                         cfg["u_tol"], cfg["max_iter_u"])
    iters["U"] = int(it.max())
    H = b - (A(U_new) - A.D * U_new) + gp
    rAU = 1.0 / A.D[0]
    HbyA = [H[c] / A.D[0] for c in range(3)]
    U = U_new

    # YEqn, one batch of species
    gY = grad(Y, h)                                     # (3, ns, ...)
    sumYDiff = (rhoD[None] * gY).sum(1)
    phiUc = [interp(sumYDiff[a], a) for a in range(3)]
    A = Stencil(0.0)
    A.ddt(rho, dt)
    A.upwind(phi, phi, h)
    A.upwind(phiUc, phi, h)
    A.laplacian([interp(rhoD, a) for a in range(3)], h)
    A.done((ns,) + sh)
    b = rho_old * Y_old / dt - tvd_correction(phi, Y, h, cfg["div_scheme_Y"]) + RR
    Y_sol, it = bicgstab(A, b, Y.contiguous(), _jacobi(A.D), cfg["y_tol"],
                         cfg["max_iter_u"])
    iters["Y"] = int(it.max())
    Y_in = Y
    Y = torch.clamp(Y_sol, 0.0, 1.0).clone()
    i = cfg["inert_index"]
    Y[i] = Y_in[i]
    Y[i] = torch.clamp(1.0 - (Y.sum(0) - Y[i]), 0.0, 1.0)

    # EEqn (absolute enthalpy)
    K = 0.5 * (U * U).sum(0)
    K_old = 0.5 * (U_old * U_old).sum(0)
    conv_K = 0.0
    for a in range(3):
        conv_K = conv_K + fdiff(phi[a] * face_value(K, phi[a], a, cfg["div_scheme"]),
                                a) / h[a]
    dKdt = (rho * K - rho_old * K_old) / dt + conv_K
    h_sp = torch.movedim(props.h_species(T), -1, 0)
    hcorr = (h_sp[None] * (rhoD - alpha)[None] * gY).sum(1)
    hcorr_div = div_flux([cubic(hcorr[a], a) for a in range(3)], h)
    A = Stencil(0.0)
    A.ddt(rho, dt)
    A.upwind(phi, phi, h)
    A.laplacian([interp(alpha, a) for a in range(3)], h)
    A.done(sh)
    b = (rho_old * ha_old / dt - tvd_correction(phi, ha, h, cfg["div_scheme"])
         + (dpdt - dKdt + hcorr_div))
    ha, it = bicgstab(A, b, ha.contiguous(), _jacobi(A.D), cfg["h_tol"],
                      cfg["max_iter_u"])
    iters["h"] = int(it.max())
    Yt = torch.movedim(Y, 0, -1)
    T = props.T_from_h(ha, Yt, T)
    psi = props.psi(T, Yt)

    # pressure correctors
    rhoU_old_f = [interp(rho_old * U_old[a], a) for a in range(3)]
    phi_old = phi
    iters["p"] = 0
    for _ in range(cfg["n_corr"]):
        rho = p * psi
        phiHbyA = [interp(rho, a) * interp(HbyA[a], a) for a in range(3)]
        rAUf = [interp(rho * rAU, a) for a in range(3)]
        for a in range(3):
            corr = phi_old[a] - rhoU_old_f[a]
            coeff = 1.0 - torch.clamp(corr.abs() / (phi_old[a].abs() + 1e-15), max=1.0)
            phiHbyA[a] = phiHbyA[a] + rAUf[a] * coeff * corr / dt
        coeff_d = psi / dt

        def A_p(x):
            out = coeff_d * x
            for a in range(3):
                out = out - (rAUf[a] * (roll(x, -1, a) - x)
                             - roll(rAUf[a], 1, a) * (x - roll(x, 1, a))) / (h[a] * h[a])
            return out

        Dp = Stencil(coeff_d)
        Dp.laplacian(rAUf, h)
        b = rho_old / dt - div_flux(phiHbyA, h)
        p, it = cg(A_p, b, p, _jacobi(Dp.D), cfg["p_tol"], cfg["p_rel_tol"],
                   cfg["max_iter_p"])
        iters["p"] += int(it)
        phi = tuple(phiHbyA[a] - rAUf[a] * (roll(p, -1, a) - p) / h[a]
                    for a in range(3))
        gp = grad(p, h)
        U = torch.stack([HbyA[c] - rAU * gp[c] for c in range(3)])
        dpdt = (p - p_old) / dt
    rho = rho_old - dt * div_flux(phi, h)
    return dict(rho=rho, U=U, p=p, ha=ha, Y=Y, T=T, phi=phi, dpdt=dpdt), iters
