"""Where the stiff TGV's flow on the card departs from the CPU's.

    python3 tools/tgv_flow_deviation.py [--parts card,smag,nut,perturb]

Two float64 steps of cases.reacting_tgv_3d_les at n = 8 (the case of
chip_smoke.py's dist gates, here on one device), each field's largest
deviation over its largest value after each step, for:

- card: the card's step (kernels) against the CPU's (plain versions), with
  the case's Sigma SGS model;
- smag: the same with the dynamic Smagorinsky model in its place;
- nut: the Sigma model's mu_t of the initial state, card against CPU, and
  the largest s3 / s1 (its smallest singular value over its largest) of
  the velocity gradient there: the TGV's velocity has no z component, so
  g^T g has an eigenvalue that is 0 but for round-off, and s3 is the square
  root of that round-off;
- perturb: on the CPU only, the step from U0 (1 + 1e-15 N(0, 1)) (seed 0)
  against the step from U0, with Sigma and with dynamic Smagorinsky, and
  Sigma's mu_t at the perturbed U0 against its mu_t at U0.

Prints one JSON line a part and step. Needs a CUDA card for every part but
perturb; exits 2 without one when asked for one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MECH = os.path.join(HERE, "tests", "data", "h2_air_9sp.json")
DT = 2.5e-7
N = 8


def _case(torch, dev, smag=False):
    from deepflame_torch.cases import reacting_tgv_3d_les
    from deepflame_torch.turbulence import dynamic_smagorinsky
    solver, state = reacting_tgv_3d_les(MECH, n=N, dtype=torch.float64,
                                        device=dev)
    if smag:
        solver = dataclasses.replace(solver, turbulence=dynamic_smagorinsky())
    return solver, state


def _fields(state) -> dict:
    return {"rho": [state.rho], "p": [state.p], "ha": [state.ha],
            "Y": [state.Y], "T": [state.T], "U": [state.U],
            "phi": list(state.phi)}


def _rel(u, v) -> float:
    u, v = u.cpu(), v.cpu()
    return float((u - v).abs().max() / v.abs().max())


def _run(solver, state, steps=2):
    out = []
    for _ in range(steps):
        state, _ = solver.step(state, DT)
        out.append(_fields(state))
    return out


def _report(name, a, b):
    for step, (x, y) in enumerate(zip(a, b), 1):
        dev = {k: max(_rel(u, v) for u, v in zip(x[k], y[k])) for k in x}
        print(json.dumps({"part": name, "step": step, "deviation": {
            k: float(f"{v:.4e}") for k, v in dev.items()}}))


def _mu_t(solver, state):
    return solver.turbulence.mu_t(state.rho, state.U, solver.bcs_U,
                                  solver.mesh)


def _s3_over_s1(torch, solver, state) -> float:
    from deepflame_torch.turbulence.les import _eig3_sym, _grad_U
    g = _grad_U(state.U, solver.bcs_U, solver.mesh)
    gtg = torch.einsum("ki...,kj...->ij...", g, g)
    l1, _, l3 = _eig3_sym(gtg)
    s1 = l1.clamp(min=0.0).sqrt()
    s3 = l3.clamp(min=0.0).sqrt()
    return float((s3 / s1.clamp(min=1e-300)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="card,smag,nut,perturb")
    parts = ap.parse_args().parts.split(",")
    import torch
    sys.path.insert(0, HERE)
    if set(parts) - {"perturb"} and not torch.cuda.is_available():
        print("tgv_flow_deviation: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    solver, state = _case(torch, "cpu")
    cpu = _run(solver, state)
    if "card" in parts:
        _report("card, Sigma", _run(*_case(torch, "cuda")), cpu)
    if "smag" in parts:
        _report("card, dynamicSmagorinsky",
                _run(*_case(torch, "cuda", smag=True)),
                _run(*_case(torch, "cpu", smag=True)))
    if "nut" in parts:
        card_solver, card_state = _case(torch, "cuda")
        print(json.dumps({"part": "nut", "mu_t_card_vs_cpu": _rel(
            _mu_t(card_solver, card_state), _mu_t(solver, state)),
            "mu_t_max": float(_mu_t(solver, state).abs().max()),
            "s3_over_s1_cpu": _s3_over_s1(torch, solver, state),
            "s3_over_s1_card": _s3_over_s1(torch, card_solver,
                                           card_state)}))
    if "perturb" in parts:
        g = torch.Generator().manual_seed(0)
        noise = 1.0 + 1e-15 * torch.randn(state.U.shape, generator=g,
                                          dtype=state.U.dtype)
        for smag in (False, True):
            s, st = _case(torch, "cpu", smag)
            moved = s.initial_state(st.p, st.T, st.Y, st.U * noise)
            name = "dynamicSmagorinsky" if smag else "Sigma"
            _report(f"perturb U0 1e-15, {name}", _run(s, moved), _run(s, st))
            if not smag:
                print(json.dumps({"part": "perturb U0 1e-15, Sigma mu_t",
                                  "mu_t_deviation": _rel(_mu_t(s, moved),
                                                         _mu_t(s, st))}))
    if torch.cuda.is_available():
        print(f"device {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
