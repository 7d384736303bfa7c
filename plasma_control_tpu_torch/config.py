"""Configuration dataclasses of the PyTorch port.

A field-for-field twin of :mod:`plasma_control_tpu.config`: the same three
dataclasses, the same field names and the same defaults. The JAX package's
``__init__`` imports jax, which the port must never do, so the port cannot
import that module and carries this copy instead.
``tests/test_torch_config.py`` holds the two equal field by field. The
rationale behind each default is documented at its definition in the JAX
package; only the meaning of each field is repeated here.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Literal, Optional

SimCase = Literal["two-stream", "bump-on-tail", "landau"]

__all__ = ["SimConfig", "ControlConfig", "MPCConfig"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics and discretization parameters."""

    simcase: SimCase = "two-stream"
    n_particles: int = 5000
    n_mesh: int = 250
    t_min: float = 0.0
    t_max: float = 50.0
    dt: float = 0.1
    length: float = 50.0
    n0: float = 1.0
    vb: float = 3.0  # beam velocity
    vth: float = 1.0  # thermal velocity (sigma)
    perturb_amplitude: float = 0.1  # A
    perturb_mode: int = 2  # n_mode
    bump_a: float = 0.2  # bump-on-tail beam fraction parameter
    interpol: Literal["cic", "tsc", "tsc_standard"] = "cic"
    # "pallas" names the hand-written deposit/gather kernel in both packages:
    # the Pallas TPU kernel there, the CUDA kernel of ops/kernels/cic.py here.
    deposit_method: Literal["dense", "scatter", "pallas"] = "dense"
    integrator: Literal["yoshida4", "verlet", "symplectic_euler"] = "yoshida4"
    seed: int = 42

    @property
    def dx(self) -> float:
        return self.length / self.n_mesh

    @property
    def n_steps(self) -> int:
        """Nt = ceil((tmax - tmin)/dt)."""
        return int(math.ceil((self.t_max - self.t_min) / self.dt))

    @property
    def cfl_dt(self) -> float:
        """CFL-like bound dt <= 2/sqrt(N/L)."""
        return 2.0 / math.sqrt(self.n_particles / self.length)

    def clamped_dt(self) -> float:
        return min(self.dt, self.cfl_dt)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Actuator and cost parameters."""

    max_mode: int = 3
    coeff_min: float = -1.0
    coeff_max: float = 1.0
    alpha: float = 1.0
    beta: float = 1.0
    reward_n_mesh: int = 500
    vmin: float = -25.0
    vmax: float = 25.0
    # True keeps the reference's np.linspace(0, L, M) actuator mesh, endpoint
    # included; False uses the periodic cell-edge grid j*dx.
    endpoint_grid: bool = True

    @property
    def n_actions(self) -> int:
        return 2 * self.max_mode


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Receding-horizon sampling MPC.

    The port runs the MPPI and CEM solves with the spectral and the grid plan
    model, at full or reduced fidelity with the fidelity guard and the
    twin-corrected cost, chunked costs and knot, white or AR(1) noise, and
    gradient refinement (``n_grad_iters > 0``, autograd through the
    ``dense``/``scatter`` deposit; the CIC kernels have no backward pass).
    """

    horizon: int = 10  # planning horizon in env steps
    n_candidates: int = 512  # sampled control sequences per solve
    n_elites: int = 64  # CEM elite set
    n_iters: int = 2  # CEM refinement iterations per solve
    sigma0: float = 0.3  # initial sampling stddev
    temperature: float = 0.05  # MPPI softmax temperature
    w_field: float = 1.0  # field-energy cost weight
    w_input: float = 0.05  # control-effort cost weight
    algo: Literal["mppi", "cem"] = "mppi"
    plan_particles: Optional[int] = None  # reduced-fidelity plan model
    plan_mesh: Optional[int] = None
    plan_chunk: Optional[int] = None  # sequential candidate chunks
    plan_correction: Literal["none", "twin"] = "none"
    cost_pe_nref: Optional[float] = 5000.0  # plan PE scaled by nref/n
    fidelity_guard: bool = True
    fidelity_guard_ratio: float = 3.0
    exact_cost_energy: bool = True
    n_grad_iters: int = 0
    grad_lr: float = 0.05
    seed_feedback: bool = True  # phase-conjugate feedback seed at index 1
    plan_integrator: Literal["env", "leapfrog", "kdk"] = "kdk"
    smooth_noise: float = 0.0  # AR(1) beta of the candidate noise
    n_knots: Optional[int] = 3  # knot-interpolated candidate noise
    # "auto": the hand-written spectral horizon kernel for CUDA tensors, the
    # per-step op-by-op path ("xla", named as in the JAX package) otherwise.
    plan_kernel: Literal["auto", "xla", "fused"] = "auto"
    # None behaves as "auto": "rot" where the static angle bound holds.
    spectral_drift: Optional[Literal["trig", "rot", "auto"]] = None
    plan_model: Literal["grid", "spectral"] = "spectral"
    plan_modes: int = 16
    w_terminal: float = 0.0  # w_terminal * PE_H tail cost
    terminal_mode: Literal["const", "growth"] = "const"
    terminal_steps: int = 4
    antithetic: bool = True

    def __post_init__(self):
        if self.plan_correction == "twin" and self.n_grad_iters > 0:
            raise ValueError(
                "plan_correction='twin' does not compose with gradient "
                "refinement (n_grad_iters > 0): the refinement cost is the "
                "uncorrected plan PE and would re-introduce the phantom "
                "noise-cancellation drive the correction removes"
            )
        if self.terminal_steps < 0:
            raise ValueError(
                f"terminal_steps must be >= 0, got {self.terminal_steps}"
            )
        if self.terminal_mode == "growth" and self.horizon < 2:
            warnings.warn(
                "terminal_mode='growth' needs horizon >= 2; the growth tail "
                "is a no-op at this horizon (set w_terminal for a constant "
                "terminal cost instead)",
                stacklevel=2,
            )
