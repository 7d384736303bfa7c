"""Charge deposition and field gather.

The counterpart of :mod:`plasma_control_tpu.ops.deposit`:

* ``method="dense"``: evaluate the shape function for every (particle, cell)
  pair and reduce (deposit) or contract with the field (gather);
* ``method="pallas"``: the hand-written kernel of :mod:`.kernels.cic` (the
  config value is shared with the JAX package, where it names the Pallas TPU
  kernel). On CPU tensors it runs the kernel's plain PyTorch version.

Normalization matches the reference: ``n *= n0 * L / N / dx``. ``kind="tsc"``
is the reference's shifted quadratic kernel, ``"tsc_standard"`` the textbook
one (see the JAX module's docstring).
"""

from __future__ import annotations

from typing import Literal

import torch

from .grid import Grid

Kind = Literal["cic", "tsc", "tsc_standard"]
Method = Literal["dense", "scatter", "pallas"]

__all__ = ["deposit", "gather", "shape_weights_dense", "shape_weights_from_offset"]


def _wrapped_offset(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """(..., N, M) periodic offset in cell units: pos_p - j wrapped to [-M/2, M/2)."""
    m = grid.n_mesh
    pos = x / grid.dx
    j = torch.arange(m, dtype=x.dtype, device=x.device)
    d = pos[..., :, None] - j
    return d - m * torch.round(d / m)


def shape_weights_from_offset(d: torch.Tensor, kind: Kind = "cic") -> torch.Tensor:
    """Shape-function weight w(d) of a periodically wrapped cell-unit offset.

    The single source of the three formulas for the dense path and the
    plain version of the CIC kernel; ``csrc/cic.cu::shape_weight`` is their
    CUDA transcription.
    """
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    if kind == "cic":
        return torch.clamp(1.0 - torch.abs(d), min=0.0)
    if kind == "tsc":
        # cell j-1 (d in [1,2)): 0.5*(2.5-d)^2; cell j (d in [0,1)): 0.75-(d-1)^2;
        # cell j+1 (d in [-1,0)): 0.5*(d+0.5)^2
        return torch.where(
            (d >= 1.0) & (d < 2.0),
            0.5 * (2.5 - d) ** 2,
            torch.where(
                (d >= 0.0) & (d < 1.0),
                0.75 - (d - 1.0) ** 2,
                torch.where((d >= -1.0) & (d < 0.0), 0.5 * (d + 0.5) ** 2, zero),
            ),
        )
    if kind == "tsc_standard":
        a = torch.abs(d)
        return torch.where(
            a <= 0.5, 0.75 - a**2, torch.where(a <= 1.5, 0.5 * (1.5 - a) ** 2, zero)
        )
    raise ValueError(f"unknown interpolation kind: {kind}")


def shape_weights_dense(x: torch.Tensor, grid: Grid, kind: Kind = "cic") -> torch.Tensor:
    """Dense (..., N, M) shape-function weights; rows sum to 1."""
    return shape_weights_from_offset(_wrapped_offset(x, grid), kind)


def _check_method(method: str) -> None:
    if method not in ("dense", "pallas"):
        raise NotImplementedError(
            f"deposit method {method!r} is not ported; use 'dense' or 'pallas'"
        )


def deposit(
    x: torch.Tensor,
    grid: Grid,
    n0: float = 1.0,
    kind: Kind = "cic",
    method: Method = "dense",
    normalize: bool = True,
) -> torch.Tensor:
    """Deposit particle charge onto the mesh: (..., N) positions to the (..., M)
    density."""
    _check_method(method)
    xw = torch.remainder(x, grid.length)
    if method == "pallas":
        from .kernels.cic import deposit_cic

        n = deposit_cic(xw, grid.n_mesh, grid.length, kind=kind)
    else:
        n = shape_weights_dense(xw, grid, kind).sum(-2)
    if normalize:
        n = n * (n0 * grid.length / x.shape[-1] / grid.dx)
    return n


def gather(
    field_mesh: torch.Tensor,
    x: torch.Tensor,
    grid: Grid,
    kind: Kind = "cic",
    method: Method = "dense",
) -> torch.Tensor:
    """Interpolate a (..., M) mesh field to (..., N) positions with the same
    weights as :func:`deposit`."""
    _check_method(method)
    xw = torch.remainder(x, grid.length)
    if method == "pallas":
        from .kernels.cic import gather_cic

        return gather_cic(field_mesh, xw, grid.n_mesh, grid.length, kind=kind)
    w = shape_weights_dense(xw, grid, kind)
    return (w @ field_mesh[..., :, None])[..., 0]
