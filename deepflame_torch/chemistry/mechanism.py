"""Cantera-YAML mechanism parser -> flat dense numpy arrays.

Port of deepflame_tpu/chemistry/mechanism.py, almost line for line. Parsing
happens once, host-side, in numpy float64; stoichiometry is stored as dense
(n_reactions, n_species) matrices so that mass-action kinetics becomes
batched matrix products (kinetics.py).

Files: `.json` files (the Cantera YAML schema written in JSON syntax) are read
with the standard library; other files are read as YAML, importing PyYAML
only then, so the card's path never needs it.

Supported reaction features: elementary Arrhenius, reversible (<=>) and
irreversible (=>); three-body with per-species efficiencies; falloff,
Lindemann and Troe (3- and 4-parameter); duplicates (summed naturally);
explicit fractional orders (`orders:`). Units: input per the `units:` block
(cm-mol-cal, or Cantera's SI-kmol defaults); output SI with kmol.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any

import numpy as np
import torch

from ..constants import ATOMIC_WEIGHTS, CAL_TO_J, GAS_CONSTANT
from ..device import resolve_device

__all__ = ["Mechanism", "load_mechanism", "parse_equation", "MECHANISM_ARRAYS"]

# the numpy array fields of Mechanism (everything but names and device)
MECHANISM_ARRAYS = (
    "molecular_weights", "element_matrix", "nasa_T_low", "nasa_T_mid",
    "nasa_T_high", "nasa_low", "nasa_high", "nu_fwd", "nu_rev", "order_fwd",
    "reversible", "arr_A", "arr_beta", "arr_EaR", "is_three_body",
    "efficiencies", "is_falloff", "low_A", "low_beta", "low_EaR", "has_troe",
    "troe", "troe_has_T2", "geometry", "well_depth", "diameter", "dipole",
    "polarizability", "rot_relax")


@dataclasses.dataclass(frozen=True)
class Mechanism:
    """Immutable mechanism data. All arrays numpy float64; `device` is where
    the tables made from it (make_thermo, make_kinetics, make_transport) live
    unless those are given another."""

    name: str
    species_names: tuple[str, ...]
    element_names: tuple[str, ...]
    molecular_weights: np.ndarray        # (ns,) kg/kmol
    element_matrix: np.ndarray           # (ne, ns) atoms of element e in species s

    # NASA-7 thermo
    nasa_T_low: np.ndarray               # (ns,)
    nasa_T_mid: np.ndarray               # (ns,)
    nasa_T_high: np.ndarray              # (ns,)
    nasa_low: np.ndarray                 # (ns, 7) coeffs for T < T_mid
    nasa_high: np.ndarray                # (ns, 7) coeffs for T >= T_mid

    # Reactions (dense)
    nu_fwd: np.ndarray                   # (nr, ns) reactant stoichiometric coeffs
    nu_rev: np.ndarray                   # (nr, ns) product stoichiometric coeffs
    order_fwd: np.ndarray                # (nr, ns) forward rate orders
    reversible: np.ndarray               # (nr,) float 0/1
    # Arrhenius, SI-kmol: kf = A T^beta exp(-Ea_R / T)
    arr_A: np.ndarray                    # (nr,)
    arr_beta: np.ndarray                 # (nr,)
    arr_EaR: np.ndarray                  # (nr,) activation temperature [K]
    # Third body: [M] = eff @ c applied when is_three_body; eff defaults 1
    is_three_body: np.ndarray            # (nr,) float 0/1
    efficiencies: np.ndarray             # (nr, ns)
    # Falloff (uses efficiencies for [M] too)
    is_falloff: np.ndarray               # (nr,) float 0/1
    low_A: np.ndarray                    # (nr,) low-pressure limit (1 where unused)
    low_beta: np.ndarray                 # (nr,)
    low_EaR: np.ndarray                  # (nr,)
    has_troe: np.ndarray                 # (nr,) float 0/1
    troe: np.ndarray                     # (nr, 4) A, T3, T1, T2
    troe_has_T2: np.ndarray              # (nr,) float 0/1

    # Transport (Lennard-Jones / Stockmayer parameters)
    geometry: np.ndarray                 # (ns,) 0=atom, 1=linear, 2=nonlinear
    well_depth: np.ndarray               # (ns,) eps/kB [K]
    diameter: np.ndarray                 # (ns,) sigma [m]
    dipole: np.ndarray                   # (ns,) [C m]
    polarizability: np.ndarray           # (ns,) [m^3]
    rot_relax: np.ndarray                # (ns,) z_rot at 298 K

    device: torch.device = torch.device("cpu")

    @property
    def n_species(self) -> int:
        return len(self.species_names)

    @property
    def n_reactions(self) -> int:
        return int(self.arr_A.shape[0])

    @property
    def n_elements(self) -> int:
        return len(self.element_names)

    def species_index(self, name: str) -> int:
        return self.species_names.index(name)


def parse_equation(eq: str) -> tuple[dict[str, float], dict[str, float], bool, bool]:
    """Parse 'A + 2 B (+ M) <=> C + M' -> (reactants, products, reversible,
    has_M). Falloff '(+ M)' and three-body 'M' terms are stripped and
    reported through has_M."""
    eq = eq.strip()
    if "<=>" in eq:
        lhs, rhs = eq.split("<=>")
        reversible = True
    elif "=>" in eq:
        lhs, rhs = eq.split("=>")
        reversible = False
    elif " = " in eq:
        lhs, rhs = eq.split(" = ")
        reversible = True
    else:
        raise ValueError(f"cannot parse reaction equation: {eq!r}")

    has_M = False

    def side(s: str) -> dict[str, float]:
        nonlocal has_M
        s = s.strip()
        m = re.search(r"\(\+\s*M\s*\)", s)
        if m:
            has_M = True
            s = s[: m.start()] + s[m.end():]
        out: dict[str, float] = {}
        for tok in s.split(" + "):
            tok = tok.strip()
            if not tok:
                continue
            if tok == "M":
                has_M = True
                continue
            m2 = re.match(r"^(\d+(?:\.\d+)?)\s+(.+)$", tok)
            if m2:
                coef, sp = float(m2.group(1)), m2.group(2).strip()
            else:
                coef, sp = 1.0, tok
            out[sp] = out.get(sp, 0.0) + coef
        return out

    return side(lhs), side(rhs), reversible, has_M


def _ea_to_K(value: float, units: str) -> float:
    """Activation energy -> activation temperature Ea/R [K]."""
    if units == "cal/mol":
        return value * CAL_TO_J * 1000.0 / GAS_CONSTANT
    if units == "J/mol":
        return value * 1000.0 / GAS_CONSTANT
    if units == "J/kmol":
        return value / GAS_CONSTANT
    if units == "K":
        return value
    if units == "kcal/mol":
        return value * 1000.0 * CAL_TO_J * 1000.0 / GAS_CONSTANT
    if units == "kJ/mol":
        return value * 1.0e6 / GAS_CONSTANT
    raise ValueError(f"unknown activation-energy units {units!r}")


def _rate_value(v: Any, default_ea_units: str) -> tuple[float, float, float]:
    """Rate-constant dict {A, b, Ea} -> (A, beta, Ea/R[K]). Ea may carry
    inline units like '1.033e+05 cal/mol'."""
    A = float(v["A"])
    beta = float(v.get("b", 0.0))
    ea = v.get("Ea", 0.0)
    if isinstance(ea, str):
        num, _, unit = ea.partition(" ")
        ea_K = _ea_to_K(float(num), unit.strip() or default_ea_units)
    else:
        ea_K = _ea_to_K(float(ea), default_ea_units)
    return A, beta, ea_K


def _read(path: str) -> dict:
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml                     # only for YAML files
        return yaml.safe_load(f)


def load_mechanism(path: str, phase: str | None = None,
                   device=None) -> Mechanism:
    """Parse a mechanism file. `device` (default: the CUDA card, which must
    exist) is recorded for the tables made from it."""
    device = resolve_device(device)
    doc = _read(path)

    units = doc.get("units", {})
    length_u = units.get("length", "m")
    quantity_u = units.get("quantity", "kmol")
    ea_units = units.get("activation-energy", "cal/mol")
    # A has units (conc)^(1-order)/s; conc unit = quantity / length^3
    len_m = {"m": 1.0, "cm": 1e-2, "mm": 1e-3}[length_u]
    qty_kmol = {"kmol": 1.0, "mol": 1e-3, "molec": 1.0 / 6.02214076e26}[quantity_u]
    conc_to_SI = qty_kmol / len_m**3

    phases = doc.get("phases", [])
    ph = None
    for p in phases:
        if phase is None or p.get("name") == phase:
            ph = p
            break
    if ph is None:
        raise ValueError(f"phase {phase!r} not found in {path}")

    species_sel = ph.get("species", "all")
    all_species = {s["name"]: s for s in doc["species"]}
    if species_sel == "all" or species_sel is None:
        species_names = tuple(all_species.keys())
    else:
        species_names = tuple(species_sel)
    ns = len(species_names)
    sp_index = {n: i for i, n in enumerate(species_names)}

    element_names = tuple(ph.get("elements") or sorted(
        {e for n in species_names for e in all_species[n]["composition"]}))
    ne = len(element_names)
    el_index = {e: i for i, e in enumerate(element_names)}

    W = np.zeros(ns)
    element_matrix = np.zeros((ne, ns))
    nasa_T_low = np.zeros(ns)
    nasa_T_mid = np.zeros(ns)
    nasa_T_high = np.zeros(ns)
    nasa_low = np.zeros((ns, 7))
    nasa_high = np.zeros((ns, 7))
    geometry = np.zeros(ns)
    well_depth = np.zeros(ns)
    diameter = np.zeros(ns)
    dipole = np.zeros(ns)
    polarizability = np.zeros(ns)
    rot_relax = np.zeros(ns)

    GEOM = {"atom": 0, "linear": 1, "nonlinear": 2}
    DEBYE = 3.33564e-30  # C m

    for name in species_names:
        s = all_species[name]
        i = sp_index[name]
        for el, cnt in s["composition"].items():
            if el not in el_index:
                raise ValueError(f"element {el} of species {name} not in phase elements")
            element_matrix[el_index[el], i] = float(cnt)
            W[i] += float(cnt) * ATOMIC_WEIGHTS[el]
        th = s["thermo"]
        if th["model"] != "NASA7":
            raise NotImplementedError(f"thermo model {th['model']} for {name}")
        Tr = th["temperature-ranges"]
        data = th["data"]
        if len(Tr) == 3:
            nasa_T_low[i], nasa_T_mid[i], nasa_T_high[i] = Tr
            nasa_low[i] = np.asarray(data[0])
            nasa_high[i] = np.asarray(data[1])
        elif len(Tr) == 2:
            nasa_T_low[i], nasa_T_high[i] = Tr
            nasa_T_mid[i] = Tr[1]
            nasa_low[i] = np.asarray(data[0])
            nasa_high[i] = np.asarray(data[0])
        else:
            raise ValueError(f"bad temperature-ranges for {name}")
        tr = s.get("transport")
        if tr is not None:
            geometry[i] = GEOM[tr["geometry"]]
            well_depth[i] = float(tr["well-depth"])
            diameter[i] = float(tr["diameter"]) * 1e-10             # A -> m
            dipole[i] = float(tr.get("dipole", 0.0)) * DEBYE
            polarizability[i] = float(tr.get("polarizability", 0.0)) * 1e-30
            rot_relax[i] = float(tr.get("rotational-relaxation", 0.0))
        else:  # no transport data: hard-sphere N2-like defaults
            geometry[i] = 1
            well_depth[i] = 97.53
            diameter[i] = 3.621e-10

    rxns = doc.get("reactions", []) or []
    rows: list[dict[str, Any]] = []
    for r in rxns:
        reac, prod, reversible, has_M = parse_equation(r["equation"])
        rtype = r.get("type", "elementary")
        nu_f = np.zeros(ns)
        nu_r = np.zeros(ns)
        for sp, c in reac.items():
            nu_f[sp_index[sp]] += c
        for sp, c in prod.items():
            nu_r[sp_index[sp]] += c
        order = nu_f.copy()
        if "orders" in r:
            for sp, o in r["orders"].items():
                order[sp_index[sp]] = float(o)

        eff = np.ones(ns)
        for sp, e in (r.get("efficiencies") or {}).items():
            if sp in sp_index:
                eff[sp_index[sp]] = float(e)

        fwd_order = float(order.sum())

        row = dict(nu_f=nu_f, nu_r=nu_r, order=order, reversible=float(reversible),
                   eff=eff, is_tb=0.0, is_fo=0.0,
                   lowA=1.0, lowB=0.0, lowE=0.0, has_troe=0.0,
                   troe=np.zeros(4), troe_T2=0.0)

        if rtype in ("elementary", "three-body"):
            A, beta, eaK = _rate_value(r["rate-constant"], ea_units)
            o = fwd_order + (1.0 if rtype == "three-body" else 0.0)
            row["A"] = A * conc_to_SI ** (1.0 - o)
            row["beta"], row["EaR"] = beta, eaK
            row["is_tb"] = 1.0 if rtype == "three-body" else 0.0
        elif rtype == "falloff":
            A, beta, eaK = _rate_value(r["high-P-rate-constant"], ea_units)
            A0, beta0, ea0K = _rate_value(r["low-P-rate-constant"], ea_units)
            row["A"] = A * conc_to_SI ** (1.0 - fwd_order)
            row["beta"], row["EaR"] = beta, eaK
            row["lowA"] = A0 * conc_to_SI ** (-fwd_order)
            row["lowB"], row["lowE"] = beta0, ea0K
            row["is_fo"] = 1.0
            if "Troe" in r:
                t = r["Troe"]
                row["has_troe"] = 1.0
                T2 = t.get("T2")
                # a sentinel like 1e100 disables the T2 term; treat it as
                # absent so float32 tables stay finite
                if T2 is not None and float(T2) > 1e30:
                    T2 = None
                row["troe"] = np.array([float(t["A"]), float(t["T3"]),
                                        float(t["T1"]), float(T2 or 0.0)])
                row["troe_T2"] = 1.0 if T2 is not None else 0.0
            if "SRI" in r:
                raise NotImplementedError("SRI falloff")
        else:
            raise NotImplementedError(f"reaction type {rtype!r}")
        rows.append(row)

    nr = len(rows)
    _empty_shapes = {"nu_f": (ns,), "nu_r": (ns,), "order": (ns,),
                     "eff": (ns,), "troe": (4,)}

    def stack(key):
        if nr == 0:
            return np.zeros((0,) + _empty_shapes.get(key, ()))
        return np.stack([np.asarray(row[key], dtype=np.float64) for row in rows])

    return Mechanism(
        name=path.rsplit("/", 1)[-1],
        species_names=species_names,
        element_names=element_names,
        molecular_weights=W,
        element_matrix=element_matrix,
        nasa_T_low=nasa_T_low, nasa_T_mid=nasa_T_mid, nasa_T_high=nasa_T_high,
        nasa_low=nasa_low, nasa_high=nasa_high,
        nu_fwd=stack("nu_f"), nu_rev=stack("nu_r"), order_fwd=stack("order"),
        reversible=stack("reversible"),
        arr_A=stack("A"), arr_beta=stack("beta"), arr_EaR=stack("EaR"),
        is_three_body=stack("is_tb"), efficiencies=stack("eff"),
        is_falloff=stack("is_fo"),
        low_A=stack("lowA"), low_beta=stack("lowB"), low_EaR=stack("lowE"),
        has_troe=stack("has_troe"), troe=stack("troe"), troe_has_T2=stack("troe_T2"),
        geometry=geometry, well_depth=well_depth, diameter=diameter,
        dipole=dipole, polarizability=polarizability, rot_relax=rot_relax,
        device=device,
    )
