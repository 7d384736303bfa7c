"""Sharded PIC stepping and MPC planning over a device mesh.

The counterpart of :mod:`plasma_control_tpu.parallel.pic_shard`. Where JAX
runs ``shard_map`` bodies over global arrays, each rank here runs the
single-rank code on tensors of its own and the collectives of one mesh
dimension's process group join them:

* **particle sharding**: each rank holds a block of the particles (x, v).
  A deposit is the local partial density of its block (the deposit kernel
  on the card), all-reduced over ranks: one (M,) all-reduce per field
  evaluation, three per Yoshida-4 step, is all the communication. The field
  solve is replicated; the gather needs the local particles and the
  replicated field (the gather kernel on the card). The density is scaled
  after the reduce, where the single-rank deposit scales inside its
  launch, so the step agrees with :func:`..models.pic.step` to float32
  rounding, not bitwise.
* **rollout sharding**: every rank holds the same state and the same K
  candidates (the noise is broadcast from the first rank), scores its K/R
  block with the single-rank :func:`..control.mpc.candidate_costs` (the
  spectral horizon kernel, its twin-corrected variant or the grid kernels
  on the card) and all-gathers the (K,) costs; the MPPI or CEM update then
  runs alike on every rank. A closed loop steps the full environment on
  every rank; the deposits sum in fixed point, so the ranks stay bitwise
  equal.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import ControlConfig, MPCConfig, SimConfig
from ..control.actuator import FourierActuator
from ..control.mpc import MPCOutput, _check_even, _shard_costs, mpc_rollout, plan
from ..models.pic import PlasmaState
from ..ops.deposit import deposit, gather
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid
from ..ops.integrate import INTEGRATORS
from .mesh import DeviceMesh

__all__ = [
    "make_particle_sharded_step",
    "make_sharded_candidate_costs",
    "make_sharded_plan",
    "make_sharded_mpc_rollout",
    "sharded_plan",
]


def make_particle_sharded_step(mesh: DeviceMesh, grid: Grid, cfg: SimConfig,
                               axis: str = "particle") -> Callable:
    """``step_fn(x, v, e_external) -> (x, v)`` on this rank's block of the
    particles (:func:`.mesh.shard_batch` over ``axis``) with the replicated
    (M,) external mesh field: :func:`..models.pic.step`'s semantics, with the
    global ``cfg.n_particles`` in the density's normalisation."""
    group = mesh.get_group(axis)
    norm = cfg.n0 * cfg.length / cfg.n_particles / grid.dx
    kw = dict(kind=cfg.interpol, method=cfg.deposit_method)

    def step_fn(x, v, e_ext):
        def accel(x_local):
            n = deposit(x_local, grid, normalize=False, **kw)
            dist.all_reduce(n, group=group)  # (M,) floats
            e_mesh = solve_e_mesh(n * norm, grid, cfg.n0) + e_ext
            return -gather(e_mesh, x_local, grid, **kw)

        x2, v2 = INTEGRATORS[cfg.integrator](x, v, accel, cfg.clamped_dt())
        return torch.remainder(x2, cfg.length), v2

    return step_fn


def _candidate_dim(mesh: DeviceMesh, mpc: MPCConfig, axis: str) -> DeviceMesh:
    """The ``axis`` dimension of ``mesh`` that the candidates split over,
    refused when K does not divide evenly over it."""
    dim = mesh[axis]
    _check_even(mpc.n_candidates, dim.size(), axis)
    return dim


def make_sharded_candidate_costs(mesh: DeviceMesh, grid: Grid, cfg: SimConfig, mpc: MPCConfig,
                                 actuator: FourierActuator, axis: str = "rollout") -> Callable:
    """``costs_fn(state, coeff_seqs, twin_target=None) -> (K,)`` with the
    candidate axis split over ``axis``; every rank passes the same state and
    all K candidates and gets all K costs."""
    scorer = _shard_costs(_candidate_dim(mesh, mpc, axis))

    def costs_fn(state: PlasmaState, coeff_seqs: torch.Tensor, twin_target=None):
        return scorer(state, coeff_seqs, grid, cfg, mpc, actuator, twin_target)

    return costs_fn


def make_sharded_plan(mesh: DeviceMesh, grid: Grid, cfg: SimConfig, ctrl: ControlConfig,
                      mpc: MPCConfig, actuator: FourierActuator, axis: str = "rollout") -> Callable:
    """The full-featured MPC solve with the candidates split over ``axis``:
    the same :func:`..control.mpc.plan` (sampling, feedback seed, plan-model
    reduction, twin targets, CEM, gradient refinement, the fidelity guard)
    with the noise broadcast from the first rank and the scorer swapped for
    the rank-sharded one (``candidate_sharding``). An uneven split is refused
    here, before any solve.

    Returns ``plan_fn(state, mean, sigma, generator=None, noise=None) ->
    (first_action, new_mean, best_cost)``, called alike on every rank."""
    dim = _candidate_dim(mesh, mpc, axis)

    def plan_fn(state: PlasmaState, mean, sigma, generator=None, noise=None):
        return plan(state, mean, sigma, generator, grid, cfg, ctrl, mpc, actuator, noise=noise,
                    candidate_sharding=dim)

    return plan_fn


def make_sharded_mpc_rollout(mesh: DeviceMesh, grid: Grid, cfg: SimConfig, ctrl: ControlConfig,
                             mpc: MPCConfig, actuator: FourierActuator,
                             axis: str = "rollout") -> Callable:
    """Closed-loop receding-horizon MPC with every solve split over ``axis``:
    ``rollout_fn(state, generator=None, n_steps=None, mean0=None,
    step_noise=None) -> MPCOutput``, :func:`..control.mpc.mpc_rollout`'s
    semantics. The environment step runs in full on every rank."""
    dim = _candidate_dim(mesh, mpc, axis)

    def rollout_fn(state: PlasmaState, generator: Optional[torch.Generator] = None,
                   n_steps: Optional[int] = None, mean0: Optional[torch.Tensor] = None,
                   step_noise: Optional[torch.Tensor] = None) -> MPCOutput:
        return mpc_rollout(state, grid, cfg, ctrl, mpc, actuator, generator, n_steps=n_steps,
                           mean0=mean0, step_noise=step_noise, candidate_sharding=dim)

    return rollout_fn


def sharded_plan(state: PlasmaState, mean: torch.Tensor, sigma, generator, mesh: DeviceMesh,
                 grid: Grid, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
                 actuator: FourierActuator, noise: Optional[torch.Tensor] = None):
    """One full-featured MPC solve sharded over the ``rollout`` mesh axis:
    :func:`make_sharded_plan`'s solve in one call. (The JAX package caches
    its compiled closures here; a closure costs nothing to build in torch.)"""
    return make_sharded_plan(mesh, grid, cfg, ctrl, mpc, actuator)(state, mean, sigma, generator,
                                                                  noise)
