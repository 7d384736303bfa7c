"""Objective functionals: phase-space histogram, KL divergence, field energy.

The counterpart of :mod:`plasma_control_tpu.control.objective`, the
reference's ``estimate_f`` / ``estimate_KL_divergence`` /
``estimate_electric_energy``. The histogram buckets by index and adds with
``index_add_``, with ``np.histogram2d``'s edges: the rightmost edge is
inclusive and samples outside the range are dropped.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import cached_grid

EPS = 1e-12

__all__ = ["estimate_f", "estimate_kl_divergence", "estimate_electric_energy",
           "phase_space_histogram"]


def phase_space_histogram(x: torch.Tensor, v: torch.Tensor, bins: int, length: float,
                          vmin: float, vmax: float) -> torch.Tensor:
    """(bins, bins) histogram of (x, v) over [0, L] x [vmin, vmax]."""
    fx = x / length * bins
    fv = (v - vmin) / (vmax - vmin) * bins
    ix = torch.floor(fx).long()
    iv = torch.floor(fv).long()
    # np.histogram2d puts samples on the right edge into the last bin
    ix = torch.where(fx == bins, bins - 1, ix)
    iv = torch.where(fv == bins, bins - 1, iv)
    valid = (ix >= 0) & (ix < bins) & (iv >= 0) & (iv < bins)
    flat = torch.where(valid, ix * bins + iv, bins * bins)  # out of range: overflow slot
    hist = torch.zeros(bins * bins + 1, dtype=x.dtype, device=x.device)
    hist.index_add_(0, flat, torch.ones_like(x))
    return hist[:-1].reshape(bins, bins)


def estimate_f(state: torch.Tensor, n_mesh: int, length: float, vmin: float, vmax: float,
               n0: float) -> torch.Tensor:
    """Normalized f(x, v) on an n_mesh x n_mesh grid from a packed (2N,)
    state (positions, then velocities)."""
    n = state.shape[0] // 2
    dx = length / n_mesh
    dv = (vmax - vmin) / n_mesh
    hist = phase_space_histogram(state[:n], state[n:], n_mesh, length, vmin, vmax)
    return hist * (n0 / dx / dv / n)


def estimate_kl_divergence(f: torch.Tensor, feq: torch.Tensor, dx: float = 0.1,
                           dv: float = 0.04) -> torch.Tensor:
    """sum rel_entr(f, feq + eps) dx dv: f log(f / y) where f > 0, 0 where
    f == 0."""
    y = feq + EPS
    pos = f > 0
    terms = torch.where(pos, f * (torch.log(torch.where(pos, f, torch.ones_like(f))) - torch.log(y)),
                        torch.zeros_like(f))
    return torch.sum(terms) * dx * dv


def estimate_electric_energy(state: torch.Tensor, e_external: Optional[torch.Tensor],
                             n_mesh: int, length: float, n0: float) -> torch.Tensor:
    """0.5 sum(E^2) dx of the field re-deposited (dense CIC) and re-solved
    from a packed (2N,) state, plus ``e_external``. Like the reference, this
    energy is not rescaled by N/L (the environment's is)."""
    n_particles = state.shape[0] // 2
    grid = cached_grid(n_mesh, float(length), state.dtype, state.device)
    dens = deposit(state[:n_particles], grid, n0=n0, kind="cic", method="dense")
    e_mesh = solve_e_mesh(dens, grid, n0)
    if e_external is not None:
        e_mesh = e_mesh + e_external
    return 0.5 * torch.sum(e_mesh * e_mesh) * grid.dx

