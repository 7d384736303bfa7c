"""Particle-in-cell simulation: the functional core.

The counterpart of :mod:`plasma_control_tpu.models.pic` (its functions; the
stateful ``PIC`` wrapper is not ported yet). One Yoshida-4 step runs exactly
three deposit -> circulant solve -> gather pipelines.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SimConfig
from ..ops.deposit import deposit, gather
from ..ops.fields import electric_energy, kinetic_energy, solve_e_mesh
from ..ops.grid import Grid
from ..ops.integrate import INTEGRATORS
from .distributions import sample_initial_state

__all__ = ["PlasmaState", "init_state", "make_accel_fn", "step", "diagnostics"]


class PlasmaState(NamedTuple):
    """Particle phase-space state; both tensors have shape (N,)."""

    x: torch.Tensor
    v: torch.Tensor


def init_state(cfg: SimConfig, gen: torch.Generator, device="cuda", dtype=torch.float32) -> PlasmaState:
    """Sample the initial distribution with its perturbation applied; ``gen``
    must live on ``device``."""
    x, v = sample_initial_state(cfg, gen, device=device, dtype=dtype)
    return PlasmaState(x=x, v=v)


def make_accel_fn(grid: Grid, cfg: SimConfig, e_external: Optional[torch.Tensor] = None):
    """dv/dt = -(E_self(x) + E_ext) gathered at the particles; the external
    mesh field is added before the gather and held over the step. (The JAX
    version's state-dependent ``e_external_fn`` serves the unported ``PIC``
    wrapper.)"""

    def accel(x: torch.Tensor) -> torch.Tensor:
        n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_mesh = solve_e_mesh(n, grid, cfg.n0)
        if e_external is not None:
            e_mesh = e_mesh + e_external
        return -gather(e_mesh, x, grid, kind=cfg.interpol, method=cfg.deposit_method)

    return accel


def step(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    e_external: Optional[torch.Tensor] = None,
) -> PlasmaState:
    """One symplectic time step plus the periodic wrap."""
    accel = make_accel_fn(grid, cfg, e_external=e_external)
    x, v = INTEGRATORS[cfg.integrator](state.x, state.v, accel, cfg.clamped_dt())
    return PlasmaState(x=torch.remainder(x, cfg.length), v=v)


def diagnostics(state: PlasmaState, grid: Grid, cfg: SimConfig):
    """(n, e_mesh, PE, KE, H) computed once from the current state."""
    n = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    e_mesh = solve_e_mesh(n, grid, cfg.n0)
    pe = electric_energy(e_mesh, grid, cfg.n_particles)
    ke = kinetic_energy(state.v)
    return n, e_mesh, pe, ke, pe + ke
