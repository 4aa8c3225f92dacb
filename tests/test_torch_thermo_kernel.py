"""correctThermo's Newton inversion: ThermoData's kernel path
(`ops.kernels.thermo7`, csrc/thermo7.cu) for CUDA tensors and its plain path
on the CPU.

The CPU tests hold the dispatch: CPU tensors launch nothing, count
`thermo.newton_plain`, and `T_psi_from_h` is `T_from_h` then `psi` bit for
bit (tests/test_torch_chemistry.py holds the plain path to JAX's). The card
tests hold the kernel to the plain path on the card; this file imports no
JAX, so they run without it:
    python -m pytest --noconftest tests/test_torch_thermo_kernel.py -m gpu
"""
import os

import numpy as np
import pytest
import torch

from deepflame_torch.chemistry import load_mechanism, make_thermo
from deepflame_torch.chemistry.thermo import ThermoData
from deepflame_torch.constants import GAS_CONSTANT
from deepflame_torch.ops import kernels as K
from deepflame_torch.runtime import timers

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
# H2, H, O, O2, OH, H2O, HO2, H2O2, N2 of a stoichiometric H2/air mixture
UNBURNT = np.array([0.0283, 0, 0, 0.2264, 0, 0, 0, 0, 0.7453])
BURNT = np.array([0, 0, 0, 0, 0, 0.2547, 0, 0, 0.7453])
RADICALS = [1, 2, 4, 6, 7]


def _thermo(ns: int, dtype, device) -> ThermoData:
    """The 9-species H2 table, or a synthetic one of ns species: the 9
    repeated in turn, each copy's coefficients and weight scaled by a few
    per cent (cp stays positive, the ranges still meet near T_mid)."""
    th = make_thermo(load_mechanism(MECH, device="cpu"), dtype=torch.float64,
                     device="cpu")
    if ns != 9:
        rng = np.random.default_rng(ns)
        idx = np.arange(ns) % 9
        s = torch.as_tensor(rng.uniform(0.97, 1.03, (ns, 1)))
        W = th.W[idx] * torch.as_tensor(rng.uniform(0.9, 1.1, ns))
        th = ThermoData(W=W, inv_W=1.0 / W, T_mid=th.T_mid[idx],
                        coeffs_low=th.coeffs_low[idx] * s,
                        coeffs_high=th.coeffs_high[idx] * s,
                        h_formation=th.h_formation[idx], T_min=th.T_min,
                        T_max=th.T_max)
    f = lambda a: a.to(dtype=dtype, device=device)
    return ThermoData(W=f(th.W), inv_W=f(th.inv_W), T_mid=f(th.T_mid),
                      coeffs_low=f(th.coeffs_low),
                      coeffs_high=f(th.coeffs_high),
                      h_formation=f(th.h_formation), T_min=th.T_min,
                      T_max=th.T_max)


def _state(ns: int, n: int, dtype, device, seed: int = 0):
    """(T, T_guess, Y (ns, n)): partly burnt H2/air with radicals up to 1e-3
    (a synthetic table's copies of a species share its fraction); T over
    300-3000 K, an eighth of the cells within 0.5 K of T_mid, 16 cells each
    whose enthalpy lies below T_min and above T_max, and guesses within 20
    % of T, 16 of them beyond each clamp."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (n, 1))
    y9 = (1 - c) * UNBURNT + c * BURNT
    y9[:, RADICALS] += rng.uniform(0.0, 1e-3, (n, len(RADICALS)))
    idx = np.arange(ns) % 9
    share = rng.uniform(0.5, 1.5, (n, ns))
    share /= np.stack([share[:, idx == k].sum(1) for k in idx], 1)
    Y = y9[:, idx] * share
    Y /= Y.sum(1, keepdims=True)
    T = rng.uniform(300.0, 3000.0, n)
    T[: n // 8] = 1000.0 + rng.uniform(-0.5, 0.5, n // 8)
    T[-32:-16], T[-16:] = 100.0, 7000.0
    Tg = T * rng.uniform(0.8, 1.2, n)
    Tg[-48:-40], Tg[-40:-32] = 50.0, 9000.0
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return f(T), f(Tg), f(Y.T.copy())


def _layout(Y, layout: str):
    """(..., ns) views of Y (ns, n): the low-Mach solver's movedim view
    (cells stride 1) or a contiguous (n, ns) block (the face-list solver's)."""
    return (torch.movedim(Y, 0, -1) if layout == "movedim"
            else Y.T.contiguous())


# ---------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["movedim", "rows"])
def test_T_psi_from_h_is_T_from_h_then_psi(dtype, layout):
    th = _thermo(9, dtype, "cpu")
    T, Tg, Y = _state(9, 512, dtype, "cpu")
    Yt = _layout(Y, layout)
    h = th.h_mass(T, Yt)
    T1, psi = th.T_psi_from_h(h, Yt, Tg)
    T2 = th.T_from_h(h, Yt, Tg)
    assert torch.equal(T1, T2)
    assert torch.equal(psi, th.psi(T2, Yt))
    assert torch.equal(T2, th.T_from_h_plain(h, Yt, Tg))
    e = th.e_mass(T, Yt)
    assert torch.equal(th.T_from_e(e, Yt, Tg), th.T_from_e_plain(e, Yt, Tg))


def test_cpu_tensors_launch_nothing(monkeypatch):
    """T_from_h, T_from_e and T_psi_from_h on CPU tensors never reach the
    kernels' launch function, and the kernel wrapper refuses CPU tensors."""
    calls = []
    monkeypatch.setattr(K, "_launch", lambda *a, **k: calls.append(a))
    th = _thermo(9, torch.float64, "cpu")
    T, Tg, Y = _state(9, 64, torch.float64, "cpu")
    Yt = _layout(Y, "movedim")
    th.T_from_h(th.h_mass(T, Yt), Yt, Tg)
    th.T_from_e(th.e_mass(T, Yt), Yt, Tg)
    th.T_psi_from_h(th.h_mass(T, Yt), Yt, Tg)
    assert calls == []
    with pytest.raises(ValueError, match="CUDA"):
        K.thermo7(th.h_mass(T, Yt), Yt, Tg, th.kernel_table, th.T_min,
                  th.T_max, GAS_CONSTANT)
    assert calls == []


def test_cpu_calls_count_plain():
    """Under tracing each CPU call counts thermo.newton_plain once
    (T_psi_from_h through its T_from_h) and none counts the kernel."""
    th = _thermo(9, torch.float64, "cpu")
    T, Tg, Y = _state(9, 64, torch.float64, "cpu")
    Yt = _layout(Y, "movedim")
    with timers.tracing() as tr:
        with timers.span("lowmach.thermo"):
            th.T_psi_from_h(th.h_mass(T, Yt), Yt, Tg)
        th.T_from_h(th.h_mass(T, Yt), Yt, Tg)
        th.T_from_e(th.e_mass(T, Yt), Yt, Tg)
    rec = tr.read()
    assert rec.counters == {"thermo.newton_plain": 3}
    assert rec.spans[0].counts == {"thermo.newton_plain": 1}


def test_kernel_table_layout():
    """(ns, 20): T_mid, 1/W, then a0..a4, a1/2, a2/3, a3/4, a5 of the low
    and the high range, each quotient the plain Horner form's own."""
    th = _thermo(9, torch.float32, "cpu")
    tab = th.kernel_table
    assert tab.shape == (9, 20) and tab.dtype == torch.float32
    assert tab.is_contiguous() and th.kernel_table is tab
    assert torch.equal(tab[:, 0], th.T_mid)
    assert torch.equal(tab[:, 1], th.inv_W)
    for k, a in ((2, th.coeffs_low), (11, th.coeffs_high)):
        assert torch.equal(tab[:, k:k + 5], a[:, :5])
        assert torch.equal(tab[:, k + 5], a[:, 1] / 2)
        assert torch.equal(tab[:, k + 6], a[:, 2] / 3)
        assert torch.equal(tab[:, k + 7], a[:, 3] / 4)
        assert torch.equal(tab[:, k + 8], a[:, 5])


# --------------------------------------------------- CUDA kernel (card only)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _rel(a, b) -> float:
    """max |a - b| over max |b| (the smoke's measure)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns", [9, 53])
@pytest.mark.parametrize("layout", ["movedim", "rows"])
def test_cuda_thermo7_matches_plain(cuda, dtype, ns, layout):
    """T(h) with psi, and T(e), one launch each, against the plain path on
    the card; cells straddling T_mid and beyond both clamps."""
    th = _thermo(ns, dtype, cuda)
    T, Tg, Y = _state(ns, 40_000, dtype, cuda, seed=ns)
    Yt = _layout(Y, layout)
    h, e = th.h_mass(T, Yt), th.e_mass(T, Yt)
    before = K.launches["thermo7"]
    with timers.tracing() as tr:
        Tk, psi = th.T_psi_from_h(h, Yt, Tg)
        Te = th.T_from_e(e, Yt, Tg)
        Th = th.T_from_h(h, Yt, Tg)
    torch.cuda.synchronize()
    assert K.launches["thermo7"] == before + 3
    assert tr.read().counters == {"thermo.newton_kernel": 3}
    Tp = th.T_from_h_plain(h, Yt, Tg)
    assert Tk.dtype == dtype and Tk.shape == T.shape
    assert torch.equal(Tk, Th)
    assert _rel(Tk, Tp) <= TOL[dtype]
    assert _rel(psi, th.psi(Tk, Yt)) <= TOL[dtype]
    assert _rel(Te, th.T_from_e_plain(e, Yt, Tg)) <= TOL[dtype]
    # the clamps hold exactly
    assert bool((Tk[-32:-16] == th.T_min).all())
    assert bool((Tk[-16:] == th.T_max).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_thermo7_one_and_empty(cuda, dtype):
    """A 0-d enthalpy with Y (ns,) (the flame set-up's call), a (1,) batch,
    an (n, ns) row expanded over cells (cj_speed's) with 50 steps, and an
    empty batch, which launches nothing."""
    th = _thermo(9, dtype, cuda)
    T, Tg, Y = _state(9, 64, dtype, cuda)
    Yt = _layout(Y, "rows")
    y0 = Yt[7]
    h0 = th.h_mass(T[7], y0)
    T0 = th.T_from_h(h0, y0, Tg[7])
    assert T0.shape == ()
    assert _rel(T0, th.T_from_h_plain(h0, y0, Tg[7])) <= TOL[dtype]
    T1, psi1 = th.T_psi_from_h(h0[None], Yt[7:8], Tg[7:8])
    assert T1.shape == (1,) and torch.equal(T1[0], T0)
    ye = y0.expand(64, -1)
    e = th.e_mass(T, ye)
    assert _rel(th.T_from_e(e, ye, Tg, iters=50),
                th.T_from_e_plain(e, ye, Tg, iters=50)) <= TOL[dtype]
    before = K.launches["thermo7"]
    Tn, psin = th.T_psi_from_h(th.h_mass(T, Yt)[:0], Yt[:0], Tg[:0])
    assert Tn.shape == psin.shape == (0,)
    assert K.launches["thermo7"] == before


@pytest.mark.gpu
def test_cuda_thermo7_refuses(cuda):
    """bfloat16 fields and tables past the kernel's species limit raise."""
    th = _thermo(9, torch.float32, cuda)
    T, Tg, Y = _state(9, 64, torch.float32, cuda)
    Yt = _layout(Y, "movedim")
    h = th.h_mass(T, Yt)
    with pytest.raises(TypeError):
        K.thermo7(h.bfloat16(), Yt.bfloat16(), Tg.bfloat16(),
                  th.kernel_table.bfloat16(), th.T_min, th.T_max,
                  GAS_CONSTANT)
    big = th.kernel_table.repeat(K.THERMO7_MAX_NS // 9 + 1, 1)
    with pytest.raises(ValueError):
        K.thermo7(h, Yt.repeat(1, big.shape[0] // 9), Tg, big, th.T_min,
                  th.T_max, GAS_CONSTANT)
