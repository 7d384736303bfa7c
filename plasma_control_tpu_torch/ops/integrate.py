"""Symplectic kick/drift time integrators.

The counterpart of :mod:`plasma_control_tpu.ops.integrate` (the steppers of
its ``INTEGRATORS`` table). Kick and drift are separate closed-form updates,
so a Yoshida-4 step costs exactly three field evaluations, with the stage
order of the reference: drift(c0), then (kick(d_i), drift(c_{i+1})) pairs.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = [
    "yoshida4_coefficients",
    "kick_drift_step",
    "yoshida4_step",
    "verlet_step",
    "symplectic_euler_step",
    "INTEGRATORS",
]

AccelFn = Callable[[torch.Tensor], torch.Tensor]  # x -> dv/dt


def yoshida4_coefficients() -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Yoshida 4th-order composition coefficients."""
    phi = 2.0 ** (1.0 / 3.0)
    w0 = -phi / (2.0 - phi)
    w1 = 1.0 / (2.0 - phi)
    c = (0.5 * w1, 0.5 * (w0 + w1), 0.5 * (w0 + w1), 0.5 * w1)
    d = (w1, w0, w1)
    return c, d


def kick_drift_step(
    x: torch.Tensor,
    v: torch.Tensor,
    accel_fn: AccelFn,
    dt: float,
    cs: Sequence[float],
    ds: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic splitting: drift(c0), then (kick(d_i), drift(c_{i+1})) pairs;
    each kick uses the field at that stage's pre-drift positions."""
    if len(cs) != len(ds) + 1:
        raise ValueError("kick_drift_step needs one more drift than kick coefficient")
    x = x + cs[0] * dt * v
    for c, d in zip(cs[1:], ds):
        v = v + d * dt * accel_fn(x)
        x = x + c * dt * v
    return x, v


def yoshida4_step(x, v, accel_fn: AccelFn, dt: float):
    """4th-order symplectic step; 3 field evaluations."""
    c, d = yoshida4_coefficients()
    return kick_drift_step(x, v, accel_fn, dt, c, d)


def verlet_step(x, v, accel_fn: AccelFn, dt: float):
    """Stormer-Verlet as the reference composes it: kick(half, at x0) ->
    drift(full) -> kick(half, at x1)."""
    v = v + 0.5 * dt * accel_fn(x)
    x = x + dt * v
    v = v + 0.5 * dt * accel_fn(x)
    return x, v


def symplectic_euler_step(x, v, accel_fn: AccelFn, dt: float):
    """1st-order symplectic."""
    v = v + dt * accel_fn(x)
    x = x + dt * v
    return x, v


#: name -> (x, v, accel_fn, dt) -> (x, v) steppers for the PIC hot loop
INTEGRATORS = {
    "symplectic_euler": symplectic_euler_step,
    "verlet": verlet_step,
    "yoshida4": yoshida4_step,
}
