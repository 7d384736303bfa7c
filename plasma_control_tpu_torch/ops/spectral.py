"""The gridless spectral plan model, op by op.

The spectral planner scores candidates on a low-mode PIC model with no mesh:
Km Fourier modes ``k_m = 2 pi m / L`` of N particles, their mode sums
``c_m = sum_p cos(k_m x_p)``, ``s_m = sum_p sin(k_m x_p)``, a self-field kick
``g_m (s_m cos(k_m x) - c_m sin(k_m x))`` per mode with ``g_m = 2 n0 / (N
k_m)``, and the field energy ``n0^2/N sum_m (c_m^2 + s_m^2) / k_m^2``. This
module states that model once, in plain PyTorch on any device and dtype.
Kernels 1, 7 and 8 (:mod:`.kernels.spectral_horizon`,
:mod:`.kernels.twin_trajectory`, :mod:`.kernels.fidelity_ratio`) take their
parameter blocks from :func:`constants`, and their plain versions are the
functions here put together.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["coherent_power", "constants", "field_energy", "mode_eval", "mode_sums", "rollout"]


@functools.lru_cache(maxsize=64)
def constants(n_modes: int, length: float, n0: float, n_particles: int):
    """The model's per-mode constants in float64: ``(k, g, inv_k2, scale)``,
    the first three tuples of Km floats (k_m, g_m = 2 n0 / (N k_m),
    1 / k_m^2), ``scale`` = n0^2 / N."""
    k = 2.0 * np.pi / length * np.arange(1, n_modes + 1)
    g = 2.0 * n0 / (n_particles * k)
    inv_k2 = 1.0 / (k * k)
    return tuple(k.tolist()), tuple(g.tolist()), tuple(inv_k2.tolist()), n0**2 / n_particles


def mode_sums(c1: torch.Tensor, s1: torch.Tensor, n_modes: int):
    """(..., Km) mode sums c_m = sum_p cos(k_m x_p), s_m = sum_p sin(k_m x_p)
    by the three-term recurrence from the base harmonic."""
    twoc = c1 + c1
    cs, ss = [c1.sum(-1)], [s1.sum(-1)]
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for _ in range(n_modes - 1):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        cs.append(c_prev.sum(-1))
        ss.append(s_prev.sum(-1))
    return torch.stack(cs, dim=-1), torch.stack(ss, dim=-1)


def mode_eval(c1: torch.Tensor, s1: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor):
    """sum_m pc[m] cos(k_m x_p) + ps[m] sin(k_m x_p) per particle."""
    twoc = c1 + c1
    acc = pc[..., 0:1] * c1 + ps[..., 0:1] * s1
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for m in range(1, pc.shape[-1]):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        acc = acc + pc[..., m : m + 1] * c_prev + ps[..., m : m + 1] * s_prev
    return acc


def _pairs(u: torch.Tensor) -> torch.Tensor:
    """pair_t = u_t + u_{t+1} along the horizon; the last is 2 u_{H-1}."""
    return torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2) + u


def rollout(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot):
    """Post-drift mode-sum trajectories ``(c, s)``, each (..., H, Km), of the
    plan state x0, v0 (N,) under the external drive u_c, u_s (..., H, Km),
    the cosine and sine coefficients of each step (zero beyond the actuated
    modes): one rollout per leading index, all from the shared state.

    A staggered kick-drift-kick: one un-merged half kick at x0 with u_0, then
    per step a drift, the mode sums, and the two half kicks that straddle the
    step boundary merged into one kick with ``2 g s, -2 g c`` and
    ``u_t + u_{t+1}``. ``rot`` drifts by rotating the carried base-harmonic
    phasor through a small angle (degree-5 and degree-4 polynomials); else
    the trig drift wraps x into [0, L) and takes cos/sin. A zero (H, Km)
    drive gives the zero-drive twin of the twin-corrected cost."""
    n_modes = u_c.shape[-1]
    g = torch.tensor(constants(n_modes, length, n0, n_particles)[1], dtype=x0.dtype,
                     device=x0.device)
    c_ang = 2.0 * np.pi / length
    pair_c, pair_s = _pairs(u_c), _pairs(u_s)

    t0 = c_ang * x0
    c1, s1 = torch.cos(t0), torch.sin(t0)
    c, s = mode_sums(c1, s1, n_modes)
    vh = v0 + 0.5 * dt * (-mode_eval(c1, s1, g * s + u_c[..., 0, :], -(g * c) + u_s[..., 0, :]))
    x, inv_l = x0, 1.0 / length
    cs, ss = [], []
    for t in range(u_c.shape[-2]):
        if rot:
            d = (c_ang * dt) * vh
            d2 = d * d
            cd = 1.0 + d2 * (-0.5 + d2 * (1.0 / 24.0))
            sd = d * (1.0 + d2 * (-1.0 / 6.0 + d2 * (1.0 / 120.0)))
            c1, s1 = c1 * cd - s1 * sd, s1 * cd + c1 * sd
        else:
            x = x + dt * vh
            x = x - length * torch.floor(x * inv_l)
            ang = c_ang * x
            c1, s1 = torch.cos(ang), torch.sin(ang)
        c, s = mode_sums(c1, s1, n_modes)
        pc = 2.0 * (g * s) + pair_c[..., t, :]
        ps = 2.0 * (-(g * c)) + pair_s[..., t, :]
        vh = vh + 0.5 * dt * (-mode_eval(c1, s1, pc, ps))
        cs.append(c)
        ss.append(s)
    return torch.stack(cs, dim=-2), torch.stack(ss, dim=-2)


def field_energy(c, s, *, length, n0, n_particles, tc=None, ts=None):
    """(..., H) field energies ``n0^2/N sum_m (c_m^2 + s_m^2) / k_m^2`` of
    mode-sum trajectories c, s (..., H, Km); with the (H, Km) targets tc, ts
    the twin-corrected ``n0^2/N sum_m ((c_m - tc)^2 + (s_m - ts)^2) / k_m^2``."""
    _, _, inv_k2, scale = constants(c.shape[-1], length, n0, n_particles)
    if tc is not None:
        c, s = c - tc, s - ts
    inv_k2 = torch.tensor(inv_k2, dtype=c.dtype, device=c.device)
    return scale * torch.sum((c * c + s * s) * inv_k2, dim=-1)


def coherent_power(x: torch.Tensor, n_modes: int, length: float) -> torch.Tensor:
    """(Km,) coherent power ``max(c_m^2 + s_m^2 - N, 0)`` of the positions x
    (N,): the power of each mode sum above the N that uncorrelated particles
    give on average."""
    t = (2.0 * np.pi / length) * x
    c, s = mode_sums(torch.cos(t), torch.sin(t), n_modes)
    return torch.clamp(c * c + s * s - x.shape[-1], min=0.0)

