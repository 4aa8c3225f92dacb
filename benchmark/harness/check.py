"""How `correct` is decided: the step the window captured, judged against the
plain reference in `benchmark/reference/` (float64; nets served in bf16
computed as bf16 nets compute them), in two stages.

1. Rates: the program's DF-ODENet rates of that step against the
   reference's from the same input state and the benchmark's weights.
2. Flow: the program's T, Y, U and p after that step against the
   reference step from the same input state and the program's own rates
   (stage 1 judges those by themselves).

Numbers (each against its limit in benchmark/limits/<cell>.json):
  rr_gap  the largest over species of max|RR_s - RR_ref,s| over the
          cells, each over its own species' max|RR_ref,s| (floored at
          RR_FLOOR of the largest species' scale, for a species that no
          cell changes): every species net is judged on its own scale
  T_gap   max|T - T_ref| / (max T_ref - min T_ref)
  Y_gap   max|Y - Y_ref| (mass fractions)
  U_gap   max|U - U_ref| / max|U_ref|
  p_gap   max|p - p_ref| / (max p_ref - min p_ref)

`control` computes what the program computes, in the precision below the
configuration's (its `control` entry): the nets' products in that
arithmetic, the flow step in float32 on fields held in bfloat16.
"""
from __future__ import annotations

import torch

from reference import dfodenet, lowmach
from reference.props import Props

# the reference's arithmetic of the nets for the precision they are served in
REFERENCE_MLP = {"bfloat16": "bf16", "float32": "exact", "float64": "exact"}
NAMES = ("rr_gap", "T_gap", "Y_gap", "U_gap", "p_gap")
RR_FLOOR = 1e-6
FIELDS = ("rho", "U", "p", "ha", "Y", "T", "dpdt")


def state_dict(s, dtype, round_to=None):
    """A program state (LowMachState) as the reference's dict of `dtype`
    tensors, optionally rounded through `round_to` first."""
    f = (lambda t: t.to(round_to).to(dtype)) if round_to else (lambda t: t.to(dtype))
    d = {k: f(getattr(s, k)) for k in FIELDS}
    d["phi"] = tuple(f(x) for x in lowmach.faces_from_program(s.phi))
    return d


def net_dict(config: dict, weights: list, device, dtype=torch.float64) -> dict:
    net = config["dfodenet"]
    ns = len(weights) + 1
    n_layers = len(weights[0])
    Ws = [torch.stack([w[l][0] for w in weights]).to(device, dtype)
          for l in range(n_layers)]
    bs = [torch.stack([w[l][1] for w in weights]).to(device, dtype)
          for l in range(n_layers)]
    full = lambda m, v: torch.full((m,), v, dtype=dtype, device=device)
    return dict(Ws=Ws, bs=bs, x_mean=full(ns + 2, 0.0), x_std=full(ns + 2, 1.0),
                y_mean=full(ns - 1, 0.0), y_std=full(ns - 1, net["y_std"]),
                delta_t=net["delta_t"], frozen_T=net["frozen_T"], lam=net["lam"])


def flow_settings(config: dict, species: list) -> dict:
    """The reference's step settings; it has the one outer corrector,
    Jacobi-preconditioned pressure CG and per-field convection."""
    sol = config["solver"]
    if (sol["n_outer"], sol["p_precond"], sol["mv_convection"]) != (
            1, "jacobi", "per-field"):
        raise ValueError("the reference step takes n_outer 1, jacobi and "
                         "per-field convection")
    return dict(config["solver"], **{k: config["les"][k] for k in
                                     ("Csigma", "Pr_t", "Sc_t")},
                inert_index=species.index(config["inert"]))


class Judge:
    """The reference side of the check for one configuration and seed."""

    def __init__(self, config: dict, mech: str, species: list, weights: list,
                 dt: float, device):
        # float32 products of the control are plain float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config, self.dt = config, dt
        self.props = Props(mech, torch.float64, device)
        self.mech, self.device = mech, device
        self.net = net_dict(config, weights, device)
        L, n = config["box_side_m"], config["n"]
        self.h = (L / n,) * 3
        self.cfg = flow_settings(config, species)

    def rates(self, s: dict, mode=None):
        """(ns, n, n, n) rates of state dict `s` (float64); the nets'
        arithmetic `mode` (dfodenet.rates), by default the reference's for
        the configuration's precision."""
        if mode is None:
            mode = REFERENCE_MLP[self.config["dfodenet"]["precision"]]
        ns = s["Y"].shape[0]
        Yt = torch.movedim(s["Y"], 0, -1).reshape(-1, ns)
        T, p = s["T"].reshape(-1), s["p"].reshape(-1)
        rho = self.props.rho(p, T, Yt)
        RR = dfodenet.rates(T, p, Yt, rho, self.net, mode)
        return RR.T.reshape(s["Y"].shape)

    def numbers(self, s_in, RR, s_out) -> dict:
        """The five numbers for a program's (input state, rates (n, n, n,
        ns) as its chemistry gives them, output state)."""
        f64 = torch.float64
        st = state_dict(s_in, f64)
        RR_r = self.rates(st)
        if RR is None:                  # the step never asked for rates
            RR_p, out = torch.zeros_like(RR_r), {"rr_gap": float("inf")}
            self.rr_gaps = [float("inf")] * RR_r.shape[0]
        else:
            RR_p = torch.movedim(RR, -1, 0).to(f64)
            self.rr_gaps = rate_gaps(RR_p, RR_r)
            out = {"rr_gap": max(self.rr_gaps)}
        del RR_r
        ref, _ = lowmach.step(st, RR_p, self.dt, self.h, self.props, self.cfg)
        o = state_dict(s_out, f64)
        rng = lambda t: float(t.max() - t.min())
        out["T_gap"] = float((o["T"] - ref["T"]).abs().max()) / rng(ref["T"])
        out["Y_gap"] = float((o["Y"] - ref["Y"]).abs().max())
        out["U_gap"] = float((o["U"] - ref["U"]).abs().max()) / float(ref["U"].abs().max())
        out["p_gap"] = float((o["p"] - ref["p"]).abs().max()) / rng(ref["p"])
        return {k: (v if v == v else float("inf")) for k, v in out.items()}

    def control(self, s_in):
        """The control's (rates (n, n, n, ns), output state as a plain
        namespace) from the program's input state `s_in`."""
        ctl = self.config["control"]
        st = state_dict(s_in, torch.float64)
        RR = self.rates(st, ctl["mlp"])
        low = getattr(torch, ctl["fields"])
        f32 = torch.float32
        props = Props(self.mech, f32, self.device)
        st32 = state_dict(s_in, f32, round_to=low)
        out, _ = lowmach.step(st32, RR.to(low).to(f32), self.dt, self.h,
                              props, self.cfg)
        out = {k: (tuple(x.to(low) for x in v) if k == "phi" else v.to(low))
               for k, v in out.items()}
        return torch.movedim(RR, 0, -1), _Held(out)


def rate_gaps(RR, RR_ref) -> list:
    """Per species, the gap of rates (ns, ...) against the reference's on
    that species' scale; rr_gap is the largest."""
    scale = RR_ref.abs().flatten(1).amax(1)
    scale = torch.clamp(scale, min=RR_FLOOR * float(scale.max()))
    gap = (RR - RR_ref).abs().flatten(1).amax(1)
    return (gap / scale).tolist()


class _Held:
    """A state dict with attribute access and the program's face layout."""

    def __init__(self, d):
        self.__dict__.update({k: v for k, v in d.items() if k != "phi"})
        self.phi = tuple(torch.cat([f.narrow(a - 3, f.shape[a - 3] - 1, 1), f],
                                   dim=a - 3) for a, f in enumerate(d["phi"]))


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NAMES)
