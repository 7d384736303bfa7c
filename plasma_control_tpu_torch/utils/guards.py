"""Numerical guards and small array utilities.

The counterpart of :mod:`plasma_control_tpu.utils.guards`, the reference's
``check_invalid_value`` and ``temperal_average``.
"""

from __future__ import annotations

import torch

__all__ = ["check_invalid_value", "temporal_average"]


def check_invalid_value(x: torch.Tensor) -> torch.Tensor:
    """True if NaN/Inf anywhere or |x| > 1e4, as a 0-d bool tensor on
    ``x``'s device (no host sync; usable in ``torch.where``)."""
    finite = torch.all(torch.isfinite(x))
    overflow = torch.max(torch.abs(x)) > 1e4
    return torch.logical_or(~finite, overflow)


def temporal_average(y: torch.Tensor, k: int) -> torch.Tensor:
    """Sliding mean over a window of k, with the reference's asymmetric edge
    clamping: the window [i - k//2, i + k//2) clipped to [0, n - 1]."""
    n = y.shape[0]
    idx = torch.arange(n, device=y.device)
    start = torch.clamp(idx - k // 2, 0, n - 1)
    end = torch.clamp(idx + k // 2, 0, n - 1)
    csum = torch.cat([torch.zeros(1, dtype=y.dtype, device=y.device), torch.cumsum(y, 0)])
    cnt = torch.clamp(end - start, min=1)
    return (csum[end] - csum[start]) / cnt
