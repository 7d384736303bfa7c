"""Symplectic kick/drift time integrators.

The counterpart of :mod:`plasma_control_tpu.ops.integrate`. Kick and drift
are separate closed-form updates, so a Yoshida-4 step costs exactly three
field evaluations, with the stage order of the reference: drift(c0), then
(kick(d_i), drift(c_{i+1})) pairs. The generic integrators on the packed
state ``eta = [x; v]`` (forward Euler, explicit and implicit midpoint) take
``grad_fn(eta) -> d(eta)/dt``; they are baselines, not in ``INTEGRATORS``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..utils.guards import check_invalid_value as _is_invalid

__all__ = [
    "yoshida4_coefficients",
    "kick_drift_step",
    "yoshida4_step",
    "verlet_step",
    "symplectic_euler_step",
    "forward_euler",
    "explicit_midpoint",
    "implicit_midpoint",
    "INTEGRATORS",
]

AccelFn = Callable[[torch.Tensor], torch.Tensor]  # x -> dv/dt
GradFn = Callable[[torch.Tensor], torch.Tensor]  # eta -> d(eta)/dt


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


def forward_euler(eta: torch.Tensor, grad_fn: GradFn, dt: float) -> torch.Tensor:
    return eta + dt * grad_fn(eta)


def explicit_midpoint(eta: torch.Tensor, grad_fn: GradFn, dt: float) -> torch.Tensor:
    g = grad_fn(eta)
    return eta + dt * grad_fn(eta + 0.5 * dt * g)


def _verlet_packed(eta: torch.Tensor, grad_fn: GradFn, dt: float) -> torch.Tensor:
    n = eta.shape[0] // 2
    x, v = eta[:n], eta[n:]

    def accel(xq):
        return grad_fn(torch.cat([xq, v]))[n:]

    x2, v2 = verlet_step(x, v, accel, dt)
    return torch.cat([x2, v2])


def implicit_midpoint(
    eta: torch.Tensor,
    grad_fn: GradFn,
    dt: float,
    n_epochs: int = 100,
    eps: float = 1e-12,
    alpha: float = 0.5,
) -> torch.Tensor:
    """Damped fixed-point implicit midpoint with a divergence guard and a
    Verlet fallback. The iteration starts from the Verlet update and stops
    on the first of: an update whose change has norm below ``eps`` (the
    result), an invalid update (:func:`_is_invalid`), or ``n_epochs``
    iterations; the last two return the Verlet step. The JAX package runs
    this as a ``lax.while_loop``; here each iteration reads its two flags on
    the host (nothing on a hot path calls it)."""
    dx = _verlet_packed(eta, grad_fn, dt) - eta
    converged = torch.zeros((), dtype=torch.bool, device=eta.device)
    for _ in range(n_epochs):
        dx_new = (1.0 - alpha) * dx + alpha * (grad_fn(0.5 * dx + eta) * dt)
        converged = torch.linalg.norm(dx_new - dx) < eps
        invalid = _is_invalid(dx_new)
        dx = dx_new
        if bool(converged) or bool(invalid):
            break
    return torch.where(converged, eta + dx, _verlet_packed(eta, grad_fn, dt))


#: name -> (x, v, accel_fn, dt) -> (x, v) steppers for the PIC hot loop
INTEGRATORS = {
    "symplectic_euler": symplectic_euler_step,
    "verlet": verlet_step,
    "yoshida4": yoshida4_step,
}
