"""Particle-in-cell simulation: the functional core and a stateful wrapper.

The counterpart of :mod:`plasma_control_tpu.models.pic`. One Yoshida-4 step
runs exactly three deposit -> circulant solve -> gather pipelines. The
``PIC`` wrapper keeps the reference class's API around the functions, with a
``torch.Generator`` in place of JAX's key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..config import SimConfig
from ..ops.deposit import deposit, gather
from ..ops.fields import electric_energy, kinetic_energy, solve_e_mesh
from ..ops.grid import Grid, make_grid
from ..ops.integrate import INTEGRATORS
from .distributions import make_distribution, sample_initial_state

__all__ = ["PlasmaState", "init_state", "make_accel_fn", "step", "diagnostics", "PIC"]


class PlasmaState(NamedTuple):
    """Particle phase-space state; both tensors have shape (N,), or (B, N)
    for a batch (``rollout_batch``)."""

    x: torch.Tensor
    v: torch.Tensor


def init_state(cfg: SimConfig, gen: torch.Generator, device="cuda", dtype=torch.float32) -> PlasmaState:
    """Sample the initial distribution with its perturbation applied; ``gen``
    must live on ``device``."""
    x, v = sample_initial_state(cfg, gen, device=device, dtype=dtype)
    return PlasmaState(x=x, v=v)


def make_accel_fn(
    grid: Grid,
    cfg: SimConfig,
    e_external: Optional[torch.Tensor] = None,
    e_external_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """dv/dt = -(E_self(x) + E_ext) gathered at the particles; the external
    mesh field is added before the gather and held over the step.
    ``e_external_fn(x)`` adds a state-dependent mesh field on top
    (``PIC.update_state_w_input_func``)."""

    def accel(x: torch.Tensor) -> torch.Tensor:
        n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_mesh = solve_e_mesh(n, grid, cfg.n0)
        if e_external is not None:
            e_mesh = e_mesh + e_external
        if e_external_fn is not None:
            e_mesh = e_mesh + e_external_fn(x)
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


class PIC:
    """Stateful wrapper with the reference class's API: ``initialize`` /
    ``reinit``, ``update_params``, ``update_state``,
    ``update_state_w_input_func``, ``get_state``, ``get_energy``,
    ``get_electric_energy``, ``get_density``, ``get_e_mesh``, ``simulate``.
    Everything runs through the functions above on ``device``; ``gen`` (on
    ``device``, default seeded with ``cfg.seed``) draws every state."""

    def __init__(self, cfg: SimConfig, gen: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = gen if gen is not None else torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.grid = make_grid(cfg.n_mesh, cfg.length, dtype=dtype, device=self.device)
        self.dist = make_distribution(cfg)
        self.initialize()

    # -- lifecycle ---------------------------------------------------------
    def initialize(self):
        self.state = init_state(self.cfg, self.gen, device=self.device, dtype=self.dtype)

    def reinit(self):
        """Full resample from the wrapper's generator."""
        self.initialize()

    def update_params(self, **kwargs):
        """Replace config fields (the config is immutable, so a new one is
        derived), rebuild the grid and distribution, and resample."""
        valid = {k: v for k, v in kwargs.items() if v is not None and hasattr(self.cfg, k)}
        if not valid:
            return
        self.cfg = dataclasses.replace(self.cfg, **valid)
        self.grid = make_grid(self.cfg.n_mesh, self.cfg.length, dtype=self.dtype, device=self.device)
        self.dist = make_distribution(self.cfg)
        self.initialize()

    # -- stepping ----------------------------------------------------------
    def update_state(self, e_external: Optional[torch.Tensor] = None):
        self.state = step(self.state, self.grid, self.cfg, e_external)

    def update_state_w_input_func(self, input_fn: Callable[[torch.Tensor], torch.Tensor]):
        """One step with the state-dependent external mesh field
        ``input_fn(x)`` evaluated inside the integrator at every kick."""
        accel = make_accel_fn(self.grid, self.cfg, e_external_fn=input_fn)
        x, v = INTEGRATORS[self.cfg.integrator](self.state.x, self.state.v, accel,
                                                self.cfg.clamped_dt())
        self.state = PlasmaState(x=torch.remainder(x, self.cfg.length), v=v)

    # -- observers ---------------------------------------------------------
    @property
    def x(self):
        return self.state.x

    @property
    def v(self):
        return self.state.v

    def get_state(self) -> torch.Tensor:
        """Packed (2N,) snapshot column: positions, then velocities."""
        return torch.cat([self.state.x, self.state.v])

    def get_energy(self) -> torch.Tensor:
        return diagnostics(self.state, self.grid, self.cfg)[4]

    def get_electric_energy(self) -> torch.Tensor:
        return diagnostics(self.state, self.grid, self.cfg)[2]

    def get_density(self) -> torch.Tensor:
        return diagnostics(self.state, self.grid, self.cfg)[0]

    def get_e_mesh(self) -> torch.Tensor:
        return diagnostics(self.state, self.grid, self.cfg)[1]

    # -- open-loop rollout -------------------------------------------------
    def simulate(self, e_external_traj: Optional[torch.Tensor] = None):
        """Open-loop ``cfg.n_steps`` rollout from the current state, which it
        advances: ``(snapshot (2N, Nt+1), H (Nt+1,), PE (Nt+1,))`` with the
        initial state included."""
        from .rollout import rollout, snapshot_from_rollout  # rollout imports this module

        out = rollout(self.state, self.grid, self.cfg, e_external_traj=e_external_traj,
                      record_snapshots=True)
        self.state = out.final_state
        return snapshot_from_rollout(out), out.hamiltonian, out.field_energy
