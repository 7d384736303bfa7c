"""Field pipeline: density -> potential -> electric field -> energies.

The counterpart of :mod:`plasma_control_tpu.ops.fields`: the Poisson solve
plus gradient is one circulant matmul, ``(n - n0) @ e_op.T``, or an rFFT
against the grid's eigenvalues for large meshes; callers thread
``(n, e_mesh)`` through instead of re-solving.
"""

from __future__ import annotations

from typing import Optional

import torch

from .deposit import Kind, Method, deposit, gather
from .grid import Grid

__all__ = ["solve_e_mesh", "solve_phi_mesh", "solve_e_mesh_fft", "compute_density", "compute_e",
           "electric_energy", "kinetic_energy", "hamiltonian"]


def solve_e_mesh(n: torch.Tensor, grid: Grid, n0: float = 1.0) -> torch.Tensor:
    """E_mesh from the density via one circulant matmul; ``n`` may carry
    leading batch dims. Full fp32, as in the JAX package: the package turns
    TF32 matmuls off once, when it is imported."""
    return (n - n0) @ grid.e_op.T


def solve_phi_mesh(n: torch.Tensor, grid: Grid, n0: float = 1.0) -> torch.Tensor:
    """phi_mesh in the zero-mean gauge. The reference's phi differs by an
    additive constant only, which never reaches E or any diagnostic."""
    return (n - n0) @ grid.phi_op.T


def solve_e_mesh_fft(n: torch.Tensor, grid: Grid, n0: float = 1.0) -> torch.Tensor:
    """The rFFT path for large meshes, with :func:`solve_e_mesh`'s semantics."""
    m = grid.n_mesh
    nk = torch.fft.rfft(n - n0, dim=-1)
    eig = torch.complex(grid.e_eig_r, grid.e_eig_i)[: m // 2 + 1]
    return torch.fft.irfft(nk * eig, n=m, dim=-1).to(n.dtype)


def compute_density(x: torch.Tensor, grid: Grid, n0: float = 1.0, kind: Kind = "cic",
                    method: Method = "dense") -> torch.Tensor:
    """The reference's ``compute_n``: the normalised density on the mesh."""
    return deposit(x, grid, n0=n0, kind=kind, method=method)


def compute_e(
    x: torch.Tensor,
    grid: Grid,
    n0: float = 1.0,
    e_external: Optional[torch.Tensor] = None,
    kind: Kind = "cic",
    method: Method = "dense",
    return_mesh: bool = True,
):
    """Deposit -> solve -> (+ external) -> gather: ``(e_particles, e_mesh)``,
    or ``e_particles`` alone. The external mesh field is added before the
    gather, so particles feel ``E_self + E_ext`` with the same weights."""
    e_mesh = solve_e_mesh(deposit(x, grid, n0=n0, kind=kind, method=method), grid, n0)
    if e_external is not None:
        e_mesh = e_mesh + e_external
    e_p = gather(e_mesh, x, grid, kind=kind, method=method)
    return (e_p, e_mesh) if return_mesh else e_p


def electric_energy(e_mesh: torch.Tensor, grid: Grid, n_particles: int) -> torch.Tensor:
    """PE = (1/2) sum(E^2) dx * N / L."""
    pe = 0.5 * torch.sum(e_mesh * e_mesh, dim=-1) * grid.dx
    return pe * (n_particles / grid.length)


def kinetic_energy(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(v * v, dim=-1)


def hamiltonian(x: torch.Tensor, v: torch.Tensor, grid: Grid, n0: float = 1.0, kind: Kind = "cic",
                method: Method = "dense") -> torch.Tensor:
    """H = KE + PE of the self-consistent field only (no external), with N
    taken from ``x.shape[-1]``."""
    e_mesh = solve_e_mesh(deposit(x, grid, n0=n0, kind=kind, method=method), grid, n0)
    return kinetic_energy(v) + electric_energy(e_mesh, grid, x.shape[-1])
