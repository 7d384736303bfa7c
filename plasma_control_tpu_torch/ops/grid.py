"""Periodic 1D grid and its field-solve operators, held as torch tensors.

The counterpart of :mod:`plasma_control_tpu.ops.grid`. The operators are
built exactly as there, in float64 numpy: the periodic FD Laplacian and the
central-difference gradient are both circulant, so ``n -> phi -> E``
collapses into one real circulant matmul ``E_mesh = e_op @ (n - n0)``
(k=0 null mode pinned to zero). They are then cast and moved once to the
requested dtype and device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Grid", "make_grid", "cached_grid", "grid_from_numpy", "fd_laplacian_eigenvalues",
           "fd_gradient_eigenvalues"]

GRID_LEAVES = ("e_op", "phi_op", "inv_lap_eig", "e_eig_r", "e_eig_i", "cells")


def fd_laplacian_eigenvalues(n_mesh: int, dx: float) -> np.ndarray:
    """Eigenvalues of the periodic 3-point FD Laplacian (real, <= 0)."""
    k = np.arange(n_mesh)
    return (2.0 * np.cos(2.0 * np.pi * k / n_mesh) - 2.0) / dx**2


def fd_gradient_eigenvalues(n_mesh: int, dx: float) -> np.ndarray:
    """Eigenvalues of the periodic central-difference gradient (imaginary)."""
    k = np.arange(n_mesh)
    return 1j * np.sin(2.0 * np.pi * k / n_mesh) / dx


def _circulant_from_eigenvalues(d: np.ndarray) -> np.ndarray:
    """Dense circulant matrix with DFT eigenvalues ``d`` (first column ifft(d))."""
    m = d.shape[0]
    col = np.fft.ifft(d)
    idx = (np.arange(m)[:, None] - np.arange(m)[None, :]) % m
    mat = col[idx]
    assert np.max(np.abs(mat.imag)) < 1e-10 * max(1.0, np.max(np.abs(mat.real)))
    return np.ascontiguousarray(mat.real)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Periodic mesh geometry plus precomputed field-solve operators.

    Same fields as the JAX ``Grid``: ``e_op``/``phi_op`` are real (M, M)
    circulant operators with ``E_mesh = e_op @ (n - n0)``; ``inv_lap_eig`` and
    ``e_eig_*`` are the DFT eigenvalues; ``cells`` the cell edges ``j*dx``.
    """

    n_mesh: int
    length: float
    e_op: torch.Tensor  # (M, M)
    phi_op: torch.Tensor  # (M, M)
    inv_lap_eig: torch.Tensor  # (M,)
    e_eig_r: torch.Tensor  # (M,)
    e_eig_i: torch.Tensor  # (M,)
    cells: torch.Tensor  # (M,)

    @property
    def dx(self) -> float:
        return self.length / self.n_mesh

    def with_dtype(self, dtype) -> "Grid":
        return dataclasses.replace(self, **{name: getattr(self, name).to(dtype)
                                            for name in GRID_LEAVES})


def grid_from_numpy(n_mesh: int, length: float, device="cuda", dtype=torch.float32,
                    **leaves) -> Grid:
    """A :class:`Grid` from its leaves as numpy arrays (``e_op``, ``phi_op``,
    ``inv_lap_eig``, ``e_eig_r``, ``e_eig_i``, ``cells``; e.g. ``np.asarray``
    of a JAX ``Grid``'s), copied onto ``device``."""
    return Grid(
        n_mesh=int(n_mesh),
        length=float(length),
        **{
            name: torch.tensor(np.asarray(leaves[name]), dtype=dtype, device=device)
            for name in GRID_LEAVES
        },
    )


def make_grid(n_mesh: int, length: float, dtype=torch.float32, device="cuda") -> Grid:
    """Build a periodic grid with operators computed in float64 on the host."""
    dx = length / n_mesh
    lam = fd_laplacian_eigenvalues(n_mesh, dx)
    g = fd_gradient_eigenvalues(n_mesh, dx)

    inv_lam = np.zeros(n_mesh)
    inv_lam[1:] = 1.0 / lam[1:]  # pin the k=0 (constant) null mode

    e_eig = -g * inv_lam  # purely imaginary
    leaves = {
        "e_op": _circulant_from_eigenvalues(e_eig),
        "phi_op": _circulant_from_eigenvalues(inv_lam.astype(complex)),
        "inv_lap_eig": inv_lam,
        "e_eig_r": e_eig.real,
        "e_eig_i": e_eig.imag,
        "cells": dx * np.arange(n_mesh),
    }
    return grid_from_numpy(n_mesh, length, device=device, dtype=dtype, **leaves)


_GRIDS = {}


def cached_grid(n_mesh: int, length: float, dtype, device) -> Grid:
    """:func:`make_grid` built once per (n_mesh, length, dtype, device) and
    reused: the plan grid of reduced-fidelity planning and the objective's
    reward mesh."""
    key = (n_mesh, float(length), dtype, str(device))
    if key not in _GRIDS:
        _GRIDS[key] = make_grid(n_mesh, length, dtype=dtype, device=device)
    return _GRIDS[key]
