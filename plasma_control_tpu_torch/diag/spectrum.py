"""E(k) Fourier spectrum of the mesh field.

The counterpart of ``e_k_coefficients`` in :mod:`plasma_control_tpu.diag.spectrum`,
with the reference's normalization ``fft(E)/M*2``.
"""

from __future__ import annotations

import torch

__all__ = ["e_k_coefficients"]


def e_k_coefficients(e_mesh: torch.Tensor) -> torch.Tensor:
    """Complex spectrum fft(E)/M*2 along the last axis (all modes)."""
    m = e_mesh.shape[-1]
    return torch.fft.fft(e_mesh, dim=-1) / m * 2.0
