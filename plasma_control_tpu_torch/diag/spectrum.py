"""E(k, t) Fourier spectrum diagnostics.

The counterpart of :mod:`plasma_control_tpu.diag.spectrum`, with the
reference's normalization ``fft(E)/M*2``. The JAX package re-deposits every
snapshot column at once, a dense (Nt, N, M) weight tensor (2.5 GB at
Nt=501, N=5000, M=250); here the columns go through in chunks of at most
``_CHUNK_ELEMENTS`` weights, each column's result the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid

__all__ = ["e_k_coefficients", "compute_e_k_spectrum", "spectrum_wavenumbers", "snapshot_e_mesh"]

_CHUNK_ELEMENTS = 1 << 24  # dense weights per chunk: 64 MB of float32


def spectrum_wavenumbers(n_mesh: int, dx: float) -> np.ndarray:
    """Non-negative wavenumbers 2*pi*fftfreq."""
    ks = np.fft.fftfreq(n_mesh, d=dx) * 2.0 * np.pi
    return ks[ks >= 0]


def e_k_coefficients(e_mesh: torch.Tensor) -> torch.Tensor:
    """Complex spectrum fft(E)/M*2 along the last axis (all modes)."""
    m = e_mesh.shape[-1]
    return torch.fft.fft(e_mesh, dim=-1) / m * 2.0


def snapshot_e_mesh(snapshot: torch.Tensor, grid: Grid, n0: float) -> torch.Tensor:
    """(Nt, M) self-consistent mesh field of every column of a (2N, Nt)
    snapshot: dense CIC deposit and circulant solve, chunked over columns."""
    n = snapshot.shape[0] // 2
    xs = snapshot[:n].T  # (Nt, N)
    chunk = max(1, _CHUNK_ELEMENTS // max(1, n * grid.n_mesh))
    return torch.cat([
        solve_e_mesh(deposit(xc, grid, n0=n0, kind="cic", method="dense"), grid, n0)
        for xc in xs.split(chunk)
    ])


def compute_e_k_spectrum(n0: float, grid: Grid, snapshot: torch.Tensor, n_mesh: int,
                         return_abs: bool = True) -> torch.Tensor:
    """Spectrum of a (2N, Nt) snapshot: (n_keep, Nt), the k >= 0 rows
    (:func:`spectrum_wavenumbers` gives their k). ``np.fft.fftfreq`` marks
    the Nyquist mode negative for even M, so n_keep is M//2 (even) or
    (M+1)//2 (odd)."""
    ek = e_k_coefficients(snapshot_e_mesh(snapshot, grid, n0))  # (Nt, M) complex
    n_keep = n_mesh // 2 if n_mesh % 2 == 0 else (n_mesh + 1) // 2
    ek = ek[:, :n_keep].T
    return ek.abs() if return_abs else ek
