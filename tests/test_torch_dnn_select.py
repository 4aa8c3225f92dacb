"""DF-ODENet's reacting-cell selection (deepflame_torch.chemistry.dnn): only
the cells above frozen_T go through the nets, as DeepFlame's GPU DNN
chemistry selects them. CPU, float64, a seeded 12^3 field with a hot sphere
holding 0 %, about 2 %, about 50 % and 100 % of the cells, against the same
nets run on every cell and masked, and against the benchmark's plain
reference (benchmark/reference/dfodenet.py) on the same weights."""
import importlib.util
from pathlib import Path

import pytest
import torch

from deepflame_torch.chemistry import dnn
from deepflame_torch.runtime import timers

_REF = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
        / "dfodenet.py")
_spec = importlib.util.spec_from_file_location("bench_reference_dfodenet", _REF)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

NS, N, FROZEN_T = 9, 12, 610.0
HIDDEN = (64, 32, 16)
# sphere radius over the box side -> share of the 12^3 cells inside
RADII = {"none": 0.0, "kernel": 1.0 / 6.0, "half": 0.4924, "all": 2.0}


def _net():
    g = torch.Generator().manual_seed(22)
    nets = dnn.init_params(g, NS, HIDDEN, dtype=torch.float64,
                           device="cpu")
    f = lambda m, v: torch.full((m,), v, dtype=torch.float64)
    return dnn.DFODENet(nets, f(NS + 2, 0.0), f(NS + 2, 100.0),
                        f(NS - 1, 0.0), f(NS - 1, 1e-3), delta_t=2.5e-7,
                        frozen_T=FROZEN_T)


def _field(radius):
    """T, p, Y (cells axes first, species last, as the solver passes its
    species-first fields through movedim) and rho of a seeded field."""
    g = torch.Generator().manual_seed(7)
    c = (torch.arange(N, dtype=torch.float64) + 0.5) / N
    X, Yg, Z = torch.meshgrid(c, c, c, indexing="ij")
    r = ((X - 0.5) ** 2 + (Yg - 0.5) ** 2 + (Z - 0.5) ** 2).sqrt()
    T = torch.where(r < radius, 1500.0, 300.0) + 400.0 * torch.rand(
        (N, N, N), generator=g, dtype=torch.float64) * (r < radius)
    p = 101325.0 * (1.0 + 0.01 * torch.rand((N, N, N), generator=g,
                                            dtype=torch.float64))
    Ysp = torch.rand((NS, N, N, N), generator=g, dtype=torch.float64) + 0.05
    Y = torch.movedim(Ysp / Ysp.sum(0), 0, -1)
    rho = p / (300.0 * T)
    return T, p, Y, rho


@pytest.fixture(scope="module")
def net():
    return _net()


@pytest.mark.parametrize("share", list(RADII))
def test_selected_rates_equal_every_lane_masked(net, share, monkeypatch):
    """Bit for bit the rates of every cell through the nets, zeroed at or
    below frozen_T; the nets see the reacting lanes alone, none at 0 %,
    and at 100 % the field as it is, with no gather and no scatter."""
    T, p, Y, rho = _field(RADII[share])
    hot = int((T > FROZEN_T).sum())
    expect = {"none": 0, "kernel": 32, "half": 912, "all": N ** 3}[share]
    assert hot == expect
    sent, gathers = [], []
    inner = dnn.mlp_fused
    monkeypatch.setattr(dnn, "mlp_fused",
                        lambda x, *a, **k: sent.append(x.shape[0])
                        or inner(x, *a, **k))
    nz = torch.nonzero_static
    monkeypatch.setattr(torch, "nonzero_static",
                        lambda *a, **k: gathers.append(1) or nz(*a, **k))
    with timers.tracing() as tr:
        with timers.span("lowmach.chemistry"):
            RR = net.rates(T, p, Y, rho)
    r = tr.read()
    monkeypatch.undo()
    full = torch.where((T > FROZEN_T)[..., None],
                       net._lane_rates(T, p, Y, rho), 0.0)
    assert RR.shape == Y.shape and torch.equal(RR, full)
    assert sent == ([hot] if hot else [])
    assert r.counters == {"dnn.lanes": hot, "dnn.cells": N ** 3}
    chem = r.spans[0]
    assert chem.counts == r.counters          # counted in the caller's span
    kids = [s.name for s in r.spans if s.parent == 0]
    partial = 0 < hot < N ** 3
    assert kids == (["dnn.select", "dnn.scatter"] if partial
                    else ["dnn.select"])
    assert gathers == ([1] if partial else [])
    if share == "none":
        assert float(RR.abs().max()) == 0.0
    else:
        assert float(RR[T > FROZEN_T].abs().max()) > 0.0


@pytest.mark.parametrize("share", ["kernel", "half"])
def test_selected_rates_match_the_benchmark_reference(net, share):
    """Against the plain float64 reference on the same weights, within
    float64 rounding: 1e-12 of the largest |RR|."""
    T, p, Y, rho = _field(RADII[share])
    RR = net.rates(T, p, Y, rho).reshape(-1, NS)
    W = dict(Ws=[net.W0[:, :NS + 2]] + [getattr(net, f"W{l}")
                                         for l in (1, 2, 3)],
             bs=[getattr(net, f"b{l}") for l in range(4)],
             x_mean=net.x_mean, x_std=net.x_std, y_mean=net.y_mean,
             y_std=net.y_std, delta_t=net.delta_t, frozen_T=net.frozen_T,
             lam=net.lam)
    RR_ref = ref.rates(T.reshape(-1), p.reshape(-1), Y.reshape(-1, NS),
                       rho.reshape(-1), W)
    scale = float(RR_ref.abs().max())
    assert scale > 0.0
    assert float((RR - RR_ref).abs().max()) <= 1e-12 * scale
    assert torch.equal(RR == 0, RR_ref == 0)


def test_selection_counters_and_spans_show_in_the_report(net):
    T, p, Y, rho = _field(RADII["kernel"])
    with timers.tracing() as tr:
        with timers.span("lowmach.chemistry"):
            net.rates(T, p, Y, rho)
    text = tr.report()
    for name in ("dnn.select", "dnn.scatter"):
        assert any(line.split()[:1] == [name] and line.split()[2] == "1"
                   for line in text.splitlines()), text
    assert "dnn.lanes" in text and "dnn.cells" in text


# ------------------------------------------------------------- card only

@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_card_selected_rates_equal_every_lane_masked(cd):
    """On the card, nets of the benchmark's widths through mlp_fused: the
    selected rates equal the masked rates of every lane, bit for bit, with
    one launch at the reacting lanes' batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepflame_torch.ops import kernels as K
    g = torch.Generator().manual_seed(22)
    f = lambda m, v: torch.full((m,), v, device="cuda")
    net = dnn.DFODENet(dnn.init_params(g, NS, device="cuda"),
                       f(NS + 2, 0.0), f(NS + 2, 100.0), f(NS - 1, 0.0),
                       f(NS - 1, 1e-6), delta_t=2.5e-7, frozen_T=FROZEN_T,
                       compute_dtype=cd)
    for radius in (RADII["kernel"], RADII["half"]):
        T, p, Y, rho = (v.float().cuda() for v in _field(radius))
        K.reset_launches()
        RR = net.rates(T, p, Y, rho)
        assert K.launches["mlp_fused"] == 1
        full = torch.where((T > FROZEN_T)[..., None],
                           net._lane_rates(T, p, Y, rho), 0.0)
        assert torch.equal(RR, full)
