"""Reward and cost terms of the controllers.

The counterpart of :class:`plasma_control_tpu.control.reward.Reward`: it
keeps the equilibrium f_eq of the initial state and gives the three cost
terms (KL divergence, field energy, input energy), the training reward
``alpha max(1 - PE/r_pe_n, 0) + beta max(1 - IE/r_ie_n, 0)``, the shaped
reward and the reference's unused tanh-shaped variants. ``action`` is
whatever the caller squares for the input energy: the coefficient vector or
the mesh field, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .objective import estimate_electric_energy, estimate_f, estimate_kl_divergence

__all__ = ["Reward"]


class Reward:
    def __init__(
        self,
        init_state: torch.Tensor,  # packed (2N,) state
        n_mesh: int = 500,
        length: float = 50.0,
        vmin: float = -25.0,
        vmax: float = 25.0,
        n0: float = 1.0,
        alpha: float = 1.0,
        beta: float = 1.0,
        n_actions: int = 10,
    ):
        self.init_state = init_state
        self.n_mesh = n_mesh
        self.length = float(length)
        self.vmin = vmin
        self.vmax = vmax
        self.n0 = n0
        self.alpha = alpha
        self.beta = beta
        self.n_actions = n_actions

        self.feq = estimate_f(init_state, n_mesh, self.length, vmin, vmax, n0)
        # normalizers: r_ie_n = IE(ones(n_actions)) = n_actions L / 4
        self.r_pe_n = 1.0
        self.r_ie_n = n_actions * self.length * 0.25
        self.pe0 = self.compute_electric_energy(init_state)  # scale of the shaped reward

    def reinit(self):
        self.feq = estimate_f(self.init_state, self.n_mesh, self.length, self.vmin, self.vmax,
                              self.n0)

    # -- cost terms --------------------------------------------------------
    def compute_kl_divergence(self, state: torch.Tensor) -> torch.Tensor:
        f = estimate_f(state, self.n_mesh, self.length, self.vmin, self.vmax, self.n0)
        return estimate_kl_divergence(f, self.feq, self.length / self.n_mesh,
                                      (self.vmax - self.vmin) / self.n_mesh)

    def compute_electric_energy(self, state: torch.Tensor,
                                e_external: Optional[torch.Tensor] = None) -> torch.Tensor:
        return estimate_electric_energy(state.reshape(-1), e_external, self.n_mesh, self.length,
                                        self.n0)

    def compute_input_energy(self, actions: torch.Tensor) -> torch.Tensor:
        return torch.sum(actions**2) * self.length * 0.25

    def compute_cost(self, state: torch.Tensor, action: torch.Tensor):
        return (
            self.compute_kl_divergence(state),
            self.compute_electric_energy(state),
            self.compute_input_energy(action),
        )

    # -- shaped rewards (unused alternates of the reference) ----------------
    def compute_reward_kl_divergence(self, state):
        return torch.tanh(1.0 - torch.sqrt(self.compute_kl_divergence(state) / 25.0))

    def compute_reward_electric_energy(self, state, e_external=None):
        return torch.tanh(1.0 - torch.sqrt(self.compute_electric_energy(state, e_external) / 10.0))

    def compute_reward_input_energy(self, action):
        return torch.tanh(1.0 - torch.sqrt(self.compute_input_energy(action) / 50.0))

    # -- training reward ------------------------------------------------------
    def compute_reward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        r_pe = torch.clamp(1.0 - self.compute_electric_energy(state) / self.r_pe_n, min=0.0)
        r_ie = torch.clamp(1.0 - self.compute_input_energy(action) / self.r_ie_n, min=0.0)
        return r_pe * self.alpha + r_ie * self.beta

    def compute_reward_shaped(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """``alpha / (1 + PE/PE0) + beta max(1 - IE/r_ie_n, 0)``: smooth,
        decreasing in PE and scale-free, where the reference's
        ``max(1 - PE, 0)`` is flat at zero once PE > 1."""
        r_pe = 1.0 / (1.0 + self.compute_electric_energy(state) / self.pe0)
        r_ie = torch.clamp(1.0 - self.compute_input_energy(action) / self.r_ie_n, min=0.0)
        return r_pe * self.alpha + r_ie * self.beta

    def reward_fn(self, shape: str = "reference"):
        """The training reward: ``"reference"`` or ``"shaped"``."""
        if shape == "reference":
            return self.compute_reward
        if shape == "shaped":
            return self.compute_reward_shaped
        raise ValueError(f"unknown reward shape {shape!r} (use 'reference' or 'shaped')")
