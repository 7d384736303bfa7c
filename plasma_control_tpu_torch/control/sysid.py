"""Data-driven control: Hankel-DMDc system identification + LQR.

The counterpart of :mod:`plasma_control_tpu.control.sysid`. Identify a
linear time-delay (Hankel) model of the Fourier-mode field dynamics from
randomly excited PIC rollouts,

    h_{t+1} = A h_t + B u_t,   h_t = [z_t, ..., z_{t-D+1}, u_{t-1}, ..., u_{t-D+1}],

with z_t the complex E_k coefficients of the self-consistent field (the
feedback law's observable), then play the infinite-horizon LQR policy
u = -K h. The fit and the Riccati iteration are the JAX package's float64
numpy code, copied; the rollouts run on the device.

JAX draws an excitation rollout's initial state and drive inside one jitted
function from one key. Here :func:`excite_rollout` takes both as tensors and
:func:`excitation_inputs` draws them from a generator, so a test can hand
the JAX package's state and drive across.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import ControlConfig, SimConfig
from ..diag.spectrum import e_k_coefficients
from ..models.pic import PlasmaState, init_state, step
from ..models.rollout import _energies
from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid
from .actuator import FourierActuator

__all__ = [
    "mode_observable",
    "excitation_inputs",
    "excite_rollout",
    "collect_excitation_data",
    "hankel_dmdc",
    "lqr_gain",
    "LQROutput",
    "lqr_rollout",
    "identify_lqr_controller",
]


def mode_observable(x: torch.Tensor, grid: Grid, cfg: SimConfig, max_mode: int) -> torch.Tensor:
    """z = [Re Ek_1..K, Im Ek_1..K] of the self-consistent field (2K,)."""
    n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    ek = e_k_coefficients(solve_e_mesh(n, grid, cfg.n0))[1 : max_mode + 1]
    return torch.cat([ek.real, ek.imag])


def excitation_inputs(cfg: SimConfig, ctrl: ControlConfig, gen: torch.Generator, n_steps: int,
                      amplitude: float, device="cuda") -> Tuple[PlasmaState, torch.Tensor]:
    """One excitation rollout's seeded initial state and its (T, 2K) drive
    ``amplitude * N(0, 1)``, drawn from ``gen`` (on ``device``)."""
    s0 = init_state(cfg, gen, device=device)
    us = amplitude * torch.randn((n_steps, ctrl.n_actions), generator=gen, device=device)
    return s0, us


def excite_rollout(state: PlasmaState, us: torch.Tensor, grid: Grid, actuator: FourierActuator,
                   cfg: SimConfig, ctrl: ControlConfig) -> torch.Tensor:
    """Drive ``state`` with the (T, 2K) ``us``; returns the (T, 2K)
    observables, each taken before its step's drive."""
    zs = []
    for u in us:
        zs.append(mode_observable(state.x, grid, cfg, ctrl.max_mode))
        state = step(state, grid, cfg, actuator.compute_e_packed(u))
    return torch.stack(zs)


def collect_excitation_data(
    grid: Grid,
    actuator: FourierActuator,
    cfg: SimConfig,
    ctrl: ControlConfig,
    gen: torch.Generator,
    n_rollouts: int = 6,
    n_steps: int = 150,
    amplitude: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Randomly excited PIC rollouts on ``grid``'s device: (Z (R, T, 2K),
    U (R, T, 2K)) as float32 numpy."""
    zs, us = [], []
    for _ in range(n_rollouts):
        s0, u = excitation_inputs(cfg, ctrl, gen, n_steps, amplitude, device=grid.e_op.device)
        zs.append(excite_rollout(s0, u, grid, actuator, cfg, ctrl).cpu().numpy())
        us.append(u.cpu().numpy())
    return np.stack(zs), np.stack(us)


def hankel_dmdc(Z: np.ndarray, U: np.ndarray, n_lags: int = 6):
    """Least-squares fit of the lifted linear model.

    Z, U: (R, T, 2K). Returns (A, B, residual) with the lifted state
    dimension 2K*n_lags + 2K*(n_lags-1).
    """
    X, Xp, Uc = [], [], []
    for zs, us in zip(Z, U):
        t_len = zs.shape[0]
        for t in range(n_lags, t_len - 1):
            h = np.concatenate([zs[t - d] for d in range(n_lags)] + [us[t - 1 - d] for d in range(n_lags - 1)])
            hp = np.concatenate([zs[t + 1 - d] for d in range(n_lags)] + [us[t - d] for d in range(n_lags - 1)])
            X.append(h)
            Xp.append(hp)
            Uc.append(us[t])
    X, Xp, Uc = np.array(X), np.array(Xp), np.array(Uc)
    G = np.concatenate([X, Uc], axis=1)
    AB, *_ = np.linalg.lstsq(G, Xp, rcond=None)
    nz = X.shape[1]
    A, B = AB[:nz].T, AB[nz:].T
    d = Z.shape[-1]
    pred = G @ AB
    residual = float(np.linalg.norm(pred[:, :d] - Xp[:, :d]) / np.linalg.norm(Xp[:, :d]))
    return A, B, residual


def lqr_gain(A: np.ndarray, B: np.ndarray, n_obs: int, q_weight: float = 1.0, r_weight: float = 0.5, iters: int = 800):
    """Discrete-time Riccati iteration; Q penalizes the lagged z block only."""
    nz = A.shape[0]
    qd = np.zeros(nz)
    qd[:n_obs] = q_weight
    Q = np.diag(qd)
    R = r_weight * np.eye(B.shape[1])
    P = Q.copy()
    for _ in range(iters):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K)
    return K


class LQROutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T,)
    coeffs: torch.Tensor  # (T, 2K)


def lqr_rollout(
    state: PlasmaState,
    gain: torch.Tensor,  # (2K, H_dim)
    grid: Grid,
    actuator: FourierActuator,
    cfg: SimConfig,
    ctrl: ControlConfig,
    n_lags: int,
    n_steps: int,
) -> LQROutput:
    """Closed loop u = clip(-K h) with the lag buffers carried along: z over
    ``n_lags`` lags, u over ``max(n_lags - 1, 1)``, the latter updated only
    when ``n_lags > 1``, as in the JAX package."""
    d = ctrl.n_actions
    dev = state.x.device
    hist_z = torch.zeros((n_lags, d), device=dev)
    hist_u = torch.zeros((max(n_lags - 1, 1), d), device=dev)
    pes, us = [], []
    for _ in range(n_steps):
        z = mode_observable(state.x, grid, cfg, ctrl.max_mode)
        hist_z = torch.cat([z[None], hist_z[:-1]])
        h = torch.cat([hist_z.reshape(-1), hist_u.reshape(-1)])
        u = torch.clamp(-gain @ h, ctrl.coeff_min, ctrl.coeff_max)
        state = step(state, grid, cfg, actuator.compute_e_packed(u))
        if n_lags > 1:
            hist_u = torch.cat([u[None], hist_u[:-1]])
        pe, _ = _energies(state, grid, cfg)
        pes.append(pe)
        us.append(u)
    return LQROutput(state, torch.stack(pes), torch.stack(us))


def identify_lqr_controller(
    grid: Grid,
    actuator: FourierActuator,
    cfg: SimConfig,
    ctrl: ControlConfig,
    gen: torch.Generator,
    n_lags: int = 6,
    n_rollouts: int = 6,
    excite_steps: int = 150,
    amplitude: float = 0.15,
    q_weight: float = 1.0,
    r_weight: float = 0.5,
):
    """Excite -> Hankel-DMDc -> LQR gain: (float32 gain on ``grid``'s
    device, info with the model's residual and spectral radius)."""
    Z, U = collect_excitation_data(grid, actuator, cfg, ctrl, gen, n_rollouts, excite_steps, amplitude)
    A, B, residual = hankel_dmdc(Z, U, n_lags)
    K = lqr_gain(A, B, n_obs=2 * ctrl.max_mode * n_lags, q_weight=q_weight, r_weight=r_weight)
    info = {"residual": residual, "spectral_radius": float(np.max(np.abs(np.linalg.eigvals(A))))}
    return torch.tensor(K, dtype=torch.float32, device=grid.e_op.device), info
