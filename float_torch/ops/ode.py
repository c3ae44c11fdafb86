"""Fixed-step explicit Runge-Kutta integrators (twin of
``float_tpu.ops.ode``): euler, midpoint, rk4 (torchdiffeq's 3/8 rule),
heun2, heun3 as Butcher tableaus, driven by a Python loop over the grid.

``odeint_fixed(f, y0, ts)`` takes ``len(ts) - 1`` steps over the given
grid, so ``nfe=10`` means 9 Euler steps.
"""
from __future__ import annotations

from typing import Callable

import torch

# Butcher tableaus: (c_i offsets, a_ij rows, b weights).
ODE_TABLEAUS: dict[str, tuple] = {
    "euler": ((), (), (1.0,)),
    "midpoint": ((0.5,), ((0.5,),), (0.0, 1.0)),
    "heun2": ((1.0,), ((1.0,),), (0.5, 0.5)),
    "heun3": ((1 / 3, 2 / 3), ((1 / 3,), (0.0, 2 / 3)), (0.25, 0.0, 0.75)),
    "rk4": (
        (1 / 3, 2 / 3, 1.0),
        ((1 / 3,), (-1 / 3, 1.0), (1.0, -1.0, 1.0)),
        (1 / 8, 3 / 8, 3 / 8, 1 / 8),
    ),
}


def _rk_step(f: Callable, t0, dt, y0, method: str):
    cs, a_rows, bs = ODE_TABLEAUS[method]
    ks = [f(t0, y0)]
    for c, row in zip(cs, a_rows):
        yi = y0
        for aij, kj in zip(row, ks):
            if aij != 0.0:
                yi = yi + dt * aij * kj
        ks.append(f(t0 + c * dt, yi))
    dy = None
    for bj, kj in zip(bs, ks):
        if bj == 0.0:
            continue
        term = dt * bj * kj
        dy = term if dy is None else dy + term
    # keep the state dtype under a reduced-precision sampler
    return (y0 + dy).to(y0.dtype)


def odeint_fixed(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
                 method: str = "euler") -> torch.Tensor:
    """Integrate dy/dt = f(t, y) over the grid ``ts``; returns y(ts[-1])."""
    if method not in ODE_TABLEAUS:
        raise ValueError(
            f"unknown ODE method {method!r}; options: {list(ODE_TABLEAUS)}")
    y = y0
    for i in range(ts.shape[0] - 1):
        y = _rk_step(f, ts[i], ts[i + 1] - ts[i], y, method)
    return y
