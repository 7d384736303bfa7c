"""FFT phase-conjugate feedback controller and its closed loop.

The counterpart of :mod:`plasma_control_tpu.control.feedback`: per step,
take the complex spectrum Ek of the current self-consistent field, set
``a_n = -Re(Ek_n)``, ``b_n = +Im(Ek_n)`` for n = 1..max_mode, synthesize
E_in on the mesh through the actuator and advance one PIC step with it held.
The MPC solve also seeds its candidate pool with this law. JAX's
``lax.scan`` becomes a Python loop that never reads the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ControlConfig, SimConfig
from ..diag.spectrum import e_k_coefficients
from ..models.pic import PlasmaState, step
from ..models.rollout import _energies
from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid
from .actuator import FourierActuator

__all__ = ["feedback_coefficients", "feedback_rollout", "FeedbackOutput"]


class FeedbackOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T,) PE after each step
    kinetic: torch.Tensor
    hamiltonian: torch.Tensor
    coeff_cos: torch.Tensor  # (T, K) applied cosine coefficients
    coeff_sin: torch.Tensor  # (T, K)
    input_energy: torch.Tensor  # (T,) control effort per step
    xs: Optional[torch.Tensor] = None  # (T+1, N) if recorded
    vs: Optional[torch.Tensor] = None


def feedback_coefficients(e_mesh: torch.Tensor, max_mode: int):
    """Phase-conjugate law: (a, b) = (-Re Ek, +Im Ek) for modes 1..K."""
    modes = e_k_coefficients(e_mesh)[..., 1 : max_mode + 1]
    return -modes.real, modes.imag


def feedback_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    actuator: FourierActuator,
    record_snapshots: bool = False,
    n_steps: Optional[int] = None,
) -> FeedbackOutput:
    """Closed-loop feedback run of ``n_steps`` (default ``cfg.n_steps``).

    Each step runs, in the JAX body's order: deposit -> solve -> law ->
    actuator; the PIC step; the energies of the new state; the input
    energy. That is five deposits and three gathers per step."""
    t = n_steps if n_steps is not None else cfg.n_steps
    pes, kes, cos, sin, ies, xs, vs = [], [], [], [], [], [state.x], [state.v]
    for _ in range(t):
        dens = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        a, b = feedback_coefficients(solve_e_mesh(dens, grid, cfg.n0), ctrl.max_mode)
        state = step(state, grid, cfg, actuator.compute_e(a, b))
        pe, ke = _energies(state, grid, cfg)
        pes.append(pe)
        kes.append(ke)
        cos.append(a)
        sin.append(b)
        ies.append(actuator.input_energy(torch.cat([a, b])))
        if record_snapshots:
            xs.append(state.x)
            vs.append(state.v)
    pe, ke = torch.stack(pes), torch.stack(kes)
    return FeedbackOutput(
        final_state=state,
        field_energy=pe,
        kinetic=ke,
        hamiltonian=pe + ke,
        coeff_cos=torch.stack(cos),
        coeff_sin=torch.stack(sin),
        input_energy=torch.stack(ies),
        xs=torch.stack(xs) if record_snapshots else None,
        vs=torch.stack(vs) if record_snapshots else None,
    )
