"""Field pipeline: density -> electric field -> energies.

The counterpart of :mod:`plasma_control_tpu.ops.fields` (the slice's part):
the Poisson solve plus gradient is one circulant matmul, ``(n - n0) @ e_op.T``.
"""

from __future__ import annotations

import torch

from .grid import Grid

__all__ = ["solve_e_mesh", "electric_energy", "kinetic_energy"]


def solve_e_mesh(n: torch.Tensor, grid: Grid, n0: float = 1.0) -> torch.Tensor:
    """E_mesh from the density via one circulant matmul; ``n`` may carry
    leading batch dims. Full fp32, as in the JAX package: the package turns
    TF32 matmuls off once, when it is imported."""
    return (n - n0) @ grid.e_op.T


def electric_energy(e_mesh: torch.Tensor, grid: Grid, n_particles: int) -> torch.Tensor:
    """PE = (1/2) sum(E^2) dx * N / L."""
    pe = 0.5 * torch.sum(e_mesh * e_mesh, dim=-1) * grid.dx
    return pe * (n_particles / grid.length)


def kinetic_energy(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(v * v, dim=-1)
