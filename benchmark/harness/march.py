"""The timed path: a time march of the program's step, in segments of K
steps, each starting from a device-to-device copy of the initial state.

`ChemistryTap` sits in the solver's chemistry slot and passes every call
through to the program's model. It keeps the rates of the one call the
check compares, and in the span stretch times each call synchronised at
both ends (the outside span of chip_smoke.py's `_timed_inside`).
"""
from __future__ import annotations

import dataclasses
import time

import torch


class ChemistryTap:
    def __init__(self, inner):
        self.inner = inner
        self.armed = False
        self.rates = None
        self.spans = None        # a list while the span stretch runs

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def correct(self, *args, **kwargs):
        if self.spans is not None:
            _sync()
            t0 = time.perf_counter()
        out = self.inner.correct(*args, **kwargs)
        if self.spans is not None:
            _sync()
            self.spans.append(time.perf_counter() - t0)
        if self.armed:
            self.rates, self.armed = out.RR, False
        return out


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v


def clone_state(s):
    return type(s)(*(_clone(v) for v in s))


def _copy(dst, src):
    if src is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, v in zip(dst, src):
            _copy(d, v)


class March:
    """Steps `solver` from copies of `s0`; restarts every `K` steps. The
    input, rates and output of step `capture` of the first segment are
    copied for the check into buffers made here, before any timed step, so
    that the memory they hold is the same whichever step a seed captures.
    Each segment's end state is tested on the device (finite fields, T
    strictly inside the thermo's range) without a host read; `close()`
    reads the count."""

    def __init__(self, solver, s0, dt: float, K: int, capture: int):
        self.tap = ChemistryTap(solver.combustion)
        self.solver = dataclasses.replace(solver, combustion=self.tap)
        self.s0, self.dt, self.K, self.capture = s0, dt, K, capture
        self.T_lo, self.T_hi = solver.thermo.T_min, solver.thermo.T_max
        self.s = clone_state(s0)
        self.k = 0
        self.captured = None
        self._held = None
        if capture >= 0:
            ns = s0.Y.shape[0]
            self._held = (clone_state(s0),
                          torch.empty(s0.T.shape + (ns,), dtype=s0.Y.dtype,
                                      device=s0.T.device),
                          clone_state(s0))
        self._bad = torch.zeros((), dtype=torch.long, device=s0.T.device)

    def _check_end(self):
        s = self.s
        ok = (torch.isfinite(s.T).all() & torch.isfinite(s.p).all()
              & torch.isfinite(s.U).all() & torch.isfinite(s.Y).all()
              & (s.T > self.T_lo).all() & (s.T < self.T_hi).all())
        self._bad += (~ok).long() * self.k

    def step(self):
        s_in = self.s
        take = self.captured is None and self.k == self.capture
        self.tap.armed = take
        s_out, diag = self.solver.step(s_in, self.dt)
        if take:
            got = (s_in, self.tap.rates, s_out)
            for held, v in zip(self._held, got):
                _copy(held, v)
            self.captured = tuple(h if v is not None else None
                                  for h, v in zip(self._held, got))
            self._held = self.tap.rates = None
        self.s = s_out
        self.k += 1
        if self.k == self.K:
            self._check_end()
            self.s, self.k = clone_state(self.s0), 0
        return diag

    def close(self) -> int:
        """Test the open segment too; the steps of failed segments."""
        if self.k:
            self._check_end()
        return int(self._bad)


def window(march: March, seconds: float) -> tuple[int, float]:
    """Steps until `seconds` have passed on the host clock, then waits for
    the device: (steps, wall seconds)."""
    _sync()
    t0 = time.perf_counter()
    steps = 0
    while True:
        march.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync()
    return steps, time.perf_counter() - t0


def span_stretch(march: March, steps: int, frozen_T: float) -> list[dict]:
    """`steps` more steps, each synchronised at both ends, the chemistry
    call timed inside: per step its wall and chemistry seconds, the
    Krylov iterations of its diag and the cells above the frozen
    temperature in its input."""
    out = []
    march.tap.spans = []
    try:
        for _ in range(steps):
            hot = int((march.s.T > frozen_T).sum())
            _sync()
            t0 = time.perf_counter()
            diag = march.step()
            _sync()
            wall = time.perf_counter() - t0
            iters = {k: float(diag[k]) for k in ("iters_U", "iters_Y",
                                                  "iters_h", "iters_p")
                     if k in diag}
            out.append(dict(step_s=wall, chem_s=march.tap.spans[-1],
                            iters=iters, hot_cells=hot))
    finally:
        march.tap.spans = None
    return out
