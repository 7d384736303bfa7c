"""Generic closed-loop policy evaluation rollout.

The counterpart of :mod:`plasma_control_tpu.control.evaluate`: roll the
environment under any ``action_fn(state_packed) -> packed coefficients`` and
record snapshots, energies and the applied coefficients. JAX's ``lax.scan``
becomes a Python loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import SimConfig
from ..models.pic import PlasmaState, step
from ..models.rollout import _energies
from ..ops.grid import Grid
from .actuator import FourierActuator

__all__ = ["EvalOutput", "policy_rollout"]


class EvalOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T,)
    kinetic: torch.Tensor
    hamiltonian: torch.Tensor
    coeffs: torch.Tensor  # (T, 2K)
    xs: Optional[torch.Tensor]  # (T+1, N)
    vs: Optional[torch.Tensor]


def policy_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    actuator: FourierActuator,
    action_fn: Callable[[torch.Tensor], torch.Tensor],
    record_snapshots: bool = True,
    n_steps: Optional[int] = None,
) -> EvalOutput:
    """``n_steps`` (default ``cfg.n_steps``) steps, each driven by
    ``action_fn`` of the packed (2N,) state [x; v] before it."""
    t = n_steps if n_steps is not None else cfg.n_steps
    pes, kes, coeffs, xs, vs = [], [], [], [state.x], [state.v]
    for _ in range(t):
        a = action_fn(torch.cat([state.x, state.v]))
        state = step(state, grid, cfg, actuator.compute_e_packed(a))
        pe, ke = _energies(state, grid, cfg)
        pes.append(pe)
        kes.append(ke)
        coeffs.append(a)
        if record_snapshots:
            xs.append(state.x)
            vs.append(state.v)
    pe, ke = torch.stack(pes), torch.stack(kes)
    return EvalOutput(state, pe, ke, pe + ke, torch.stack(coeffs),
                      torch.stack(xs) if record_snapshots else None,
                      torch.stack(vs) if record_snapshots else None)
