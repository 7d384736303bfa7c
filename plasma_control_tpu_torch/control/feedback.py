"""FFT phase-conjugate feedback law.

The counterpart of ``feedback_coefficients`` in
:mod:`plasma_control_tpu.control.feedback`; the MPC solve seeds its candidate
pool with it. The closed-loop ``feedback_rollout`` is not ported yet.
"""

from __future__ import annotations

import torch

from ..diag.spectrum import e_k_coefficients

__all__ = ["feedback_coefficients"]


def feedback_coefficients(e_mesh: torch.Tensor, max_mode: int):
    """Phase-conjugate law: (a, b) = (-Re Ek, +Im Ek) for modes 1..K."""
    modes = e_k_coefficients(e_mesh)[..., 1 : max_mode + 1]
    return -modes.real, modes.imag
