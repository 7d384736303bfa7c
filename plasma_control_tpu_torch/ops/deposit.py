"""Charge deposition and field gather.

The counterpart of :mod:`plasma_control_tpu.ops.deposit`:

* ``method="dense"``: evaluate the shape function for every (particle, cell)
  pair and reduce (deposit) or contract with the field (gather);
* ``method="scatter"``: each particle's two (CIC) or three (TSC) cells and
  weights (:func:`deposit_and_gather_indices`), summed with ``scatter_add_``
  (deposit) or read back with ``gather`` (gather). This is XLA code in the
  JAX package, not a TPU kernel, so plain PyTorch ops are its port;
* ``method="pallas"``: the hand-written kernel of :mod:`.kernels.cic` (the
  config value is shared with the JAX package, where it names the Pallas TPU
  kernel), which wraps the positions and normalises in the kernel, so a
  deposit is one device op. On CPU tensors it runs the kernel's plain PyTorch
  version.

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

__all__ = ["deposit", "gather", "shape_weights_dense", "shape_weights_from_offset",
           "deposit_and_gather_indices"]


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


def deposit_and_gather_indices(x: torch.Tensor, grid: Grid, kind: Kind = "cic"):
    """Scatter-path cells and weights of (..., N) positions, in the
    reference's layout: CIC ((idx_l, idx_r), (w_l, w_r)); TSC and textbook
    TSC ((idx_l, idx_m, idx_r), (w_l, w_m, w_r))."""
    m = grid.n_mesh
    pos = torch.remainder(x, grid.length) / grid.dx
    base = torch.floor(pos).long()
    frac = pos - base
    if kind == "cic":
        return (torch.remainder(base, m), torch.remainder(base + 1, m)), (1.0 - frac, frac)
    if kind == "tsc":
        w_l = 0.5 * (1.5 - frac) ** 2
        w_m = 0.75 - (frac - 1.0) ** 2
        w_r = 0.5 * (frac - 0.5) ** 2
        cells = (torch.remainder(base - 1, m), torch.remainder(base, m),
                 torch.remainder(base + 1, m))
        return cells, (w_l, w_m, w_r)
    if kind == "tsc_standard":
        # centred on the nearest cell, offsets relative to it
        c = torch.round(pos).long()
        u = pos - c
        w_m = 0.75 - u**2
        w_l = 0.5 * (0.5 - u) ** 2
        w_r = 0.5 * (0.5 + u) ** 2
        cells = (torch.remainder(c - 1, m), torch.remainder(c, m), torch.remainder(c + 1, m))
        return cells, (w_l, w_m, w_r)
    raise ValueError(f"unknown interpolation kind: {kind}")


def _check_method(method: str) -> None:
    if method not in ("dense", "scatter", "pallas"):
        raise ValueError(f"unknown deposit method {method!r}: use 'dense', 'scatter' or 'pallas'")


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
    scale = n0 * grid.length / x.shape[-1] / grid.dx if normalize else None
    if method == "pallas":
        from .kernels.cic import deposit_cic

        # the kernel wraps the positions and applies the scale: one launch
        return deposit_cic(x, grid.n_mesh, grid.length, kind=kind,
                           scale=1.0 if scale is None else scale)
    if method == "scatter":
        n = torch.zeros(x.shape[:-1] + (grid.n_mesh,), dtype=x.dtype, device=x.device)
        for idx, w in zip(*deposit_and_gather_indices(x, grid, kind)):
            n.scatter_add_(-1, idx, w)
    else:
        n = shape_weights_dense(torch.remainder(x, grid.length), grid, kind).sum(-2)
    return n if scale is None else n * scale


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
    if method == "pallas":
        from .kernels.cic import gather_cic

        # the kernel wraps the positions itself, as torch.remainder does
        return gather_cic(field_mesh, x, grid.n_mesh, grid.length, kind=kind)
    if method == "scatter":
        idxs, ws = deposit_and_gather_indices(x, grid, kind)
        batch = torch.broadcast_shapes(field_mesh.shape[:-1], x.shape[:-1])
        field = field_mesh.expand(*batch, grid.n_mesh)
        out = torch.zeros(*batch, x.shape[-1], dtype=x.dtype, device=x.device)
        for idx, w in zip(idxs, ws):
            out = out + w * torch.gather(field, -1, idx.expand(*batch, x.shape[-1]))
        return out
    w = shape_weights_dense(torch.remainder(x, grid.length), grid, kind)
    return (w @ field_mesh[..., :, None])[..., 0]
