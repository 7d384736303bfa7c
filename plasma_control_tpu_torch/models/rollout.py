"""Open-loop rollouts.

The counterpart of :mod:`plasma_control_tpu.models.rollout` (``_energies``,
``rollout`` with optional snapshots and ``snapshot_from_rollout``;
``rollout_batch`` is not ported yet). JAX's ``lax.scan`` over time becomes a
Python loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SimConfig
from ..ops.deposit import deposit
from ..ops.fields import electric_energy, kinetic_energy, solve_e_mesh
from ..ops.grid import Grid
from .pic import PlasmaState, step

__all__ = ["RolloutOutput", "rollout", "snapshot_from_rollout"]


class RolloutOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T+1,) PE(t), self-consistent field
    kinetic: torch.Tensor  # (T+1,)
    hamiltonian: torch.Tensor  # (T+1,)
    xs: Optional[torch.Tensor] = None  # (T+1, N) if recorded
    vs: Optional[torch.Tensor] = None  # (T+1, N) if recorded


def _energies(state: PlasmaState, grid: Grid, cfg: SimConfig):
    n = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    e_mesh = solve_e_mesh(n, grid, cfg.n0)
    pe = electric_energy(e_mesh, grid, cfg.n_particles)
    ke = kinetic_energy(state.v)
    return pe, ke


def rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    e_external_traj: Optional[torch.Tensor] = None,
    record_snapshots: bool = False,
    n_steps: Optional[int] = None,
) -> RolloutOutput:
    """Open-loop rollout for ``n_steps`` (default ``cfg.n_steps``).

    ``e_external_traj``: optional (T, M) external mesh field, held over each
    step. Energies are recorded for the initial state and after every step;
    with ``record_snapshots`` the positions and velocities too, as (T+1, N)
    ``xs`` and ``vs`` on the state's device.
    """
    t = n_steps if n_steps is not None else cfg.n_steps
    pe0, ke0 = _energies(state, grid, cfg)
    pes, kes, xs, vs = [pe0], [ke0], [state.x], [state.v]
    for i in range(t):
        e_ext = None if e_external_traj is None else e_external_traj[i]
        state = step(state, grid, cfg, e_ext)
        pe, ke = _energies(state, grid, cfg)
        pes.append(pe)
        kes.append(ke)
        if record_snapshots:
            xs.append(state.x)
            vs.append(state.v)
    pe_all, ke_all = torch.stack(pes), torch.stack(kes)
    return RolloutOutput(
        final_state=state,
        field_energy=pe_all,
        kinetic=ke_all,
        hamiltonian=pe_all + ke_all,
        xs=torch.stack(xs) if record_snapshots else None,
        vs=torch.stack(vs) if record_snapshots else None,
    )


def snapshot_from_rollout(out: RolloutOutput) -> torch.Tensor:
    """(2N, T+1) packed snapshot in the reference's layout: positions, then
    velocities, one column per recorded state."""
    if out.xs is None:
        raise ValueError("snapshot_from_rollout needs rollout(record_snapshots=True)")
    return torch.cat([out.xs.T, out.vs.T], dim=0)
