"""Fourier-mode external field actuator.

The counterpart of :mod:`plasma_control_tpu.control.actuator`:

    E_in(x) = sum_{n=1..K} a_n cos(k_n x) + b_n sin(k_n x),  k_n = 2 pi n / L

evaluated on the mesh as one (M, K) basis matmul. The basis is built in
float64 numpy as in the JAX package, including the reference's
``np.linspace(0, L, M)`` actuator mesh (endpoint included) behind
``endpoint_grid=True``. ``EField`` is the reference class's stateful API
around it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FourierActuator", "EField", "make_actuator", "actuator_from_numpy"]

ACTUATOR_LEAVES = ("basis_cos", "basis_sin", "wavenumbers")


@dataclasses.dataclass(frozen=True)
class FourierActuator:
    length: float
    n_mesh: int
    max_mode: int
    basis_cos: torch.Tensor  # (M, K)
    basis_sin: torch.Tensor  # (M, K)
    wavenumbers: torch.Tensor  # (K,)

    def compute_e(self, coeff_cos: torch.Tensor, coeff_sin: torch.Tensor) -> torch.Tensor:
        """External mesh field from (..., K) coefficients: (..., M)."""
        return coeff_cos @ self.basis_cos.T + coeff_sin @ self.basis_sin.T

    def compute_e_packed(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Packed (..., 2K) = [cos coeffs, sin coeffs] -> (..., M) field."""
        k = self.max_mode
        return self.compute_e(coeffs[..., :k], coeffs[..., k:])

    def input_energy(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Control-effort cost sum(a^2) * L * 0.25."""
        return torch.sum(coeffs**2, dim=-1) * self.length * 0.25


class EField:
    """Stateful wrapper with the reference class's API: ``update_params``,
    ``reinit``, ``update_e`` / ``update_E`` and ``compute_e`` /
    ``compute_E`` with held coefficients, on ``device``."""

    def __init__(self, length: float, n_mesh: int, max_mode: int, endpoint_grid: bool = True,
                 device="cuda"):
        self.length = length
        self.n_mesh = n_mesh
        self.max_mode = max_mode
        self.endpoint_grid = endpoint_grid
        self.device = device
        self.reinit()

    def update_params(self, **kwargs):
        changed = False
        for k, v in kwargs.items():
            if hasattr(self, k) and v is not None:
                setattr(self, k, v)
                changed = True
        if changed:
            self.reinit()

    def reinit(self):
        self.actuator = make_actuator(self.length, self.n_mesh, self.max_mode, self.endpoint_grid,
                                      device=self.device)
        self.coeff_cos = torch.zeros(self.max_mode, device=self.device)
        self.coeff_sin = torch.zeros(self.max_mode, device=self.device)

    def _coeffs(self, c) -> torch.Tensor:
        return torch.as_tensor(c, dtype=torch.float32, device=self.device).reshape(-1)

    def update_e(self, coeff_cos=None, coeff_sin=None):
        if coeff_cos is not None:
            self.coeff_cos = self._coeffs(coeff_cos)
        if coeff_sin is not None:
            self.coeff_sin = self._coeffs(coeff_sin)

    update_E = update_e  # reference name

    def compute_e(self, coeff_cos=None, coeff_sin=None) -> torch.Tensor:
        a = self.coeff_cos if coeff_cos is None else self._coeffs(coeff_cos)
        b = self.coeff_sin if coeff_sin is None else self._coeffs(coeff_sin)
        return self.actuator.compute_e(a, b)

    compute_E = compute_e  # reference name


def actuator_from_numpy(length: float, n_mesh: int, max_mode: int, device="cuda",
                        dtype=torch.float32, **leaves) -> FourierActuator:
    """A :class:`FourierActuator` from its leaves as numpy arrays
    (``basis_cos``, ``basis_sin``, ``wavenumbers``; e.g. ``np.asarray`` of a
    JAX ``FourierActuator``'s), copied onto ``device``."""
    return FourierActuator(
        length=float(length),
        n_mesh=int(n_mesh),
        max_mode=int(max_mode),
        **{
            name: torch.tensor(np.asarray(leaves[name]), dtype=dtype, device=device)
            for name in ACTUATOR_LEAVES
        },
    )


def make_actuator(
    length: float,
    n_mesh: int,
    max_mode: int,
    endpoint_grid: bool = True,
    dtype=torch.float32,
    device="cuda",
) -> FourierActuator:
    if endpoint_grid:
        xm = np.linspace(0.0, length, n_mesh)  # reference parity
    else:
        xm = (length / n_mesh) * np.arange(n_mesh)
    k = 2.0 * np.pi / length * np.arange(1, max_mode + 1)
    leaves = {
        "basis_cos": np.cos(np.outer(xm, k)),
        "basis_sin": np.sin(np.outer(xm, k)),
        "wavenumbers": k,
    }
    return actuator_from_numpy(length, n_mesh, max_mode, device=device, dtype=dtype, **leaves)
