"""Landau damping / instability-rate diagnostics.

The counterpart of :mod:`plasma_control_tpu.diag.landau`: bounce time,
numerical entropy, the analytic damping rates and the damping rates fitted
by a closed-form least-squares slope of log E^2(t). The slopes are computed
in float32, as the JAX package computes them with x64 off (its
``damping_rate_decay_phase`` picks the window in float64 numpy and fits in
float32); the host-side statistics are numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..control.objective import phase_space_histogram
from ..ops.grid import Grid
from .spectrum import snapshot_e_mesh

__all__ = [
    "compute_bounce_time",
    "compute_numerical_entropy",
    "compute_linear_damping_rate_analytic",
    "landau_damping_rate_analytic_sim",
    "compute_linear_damping_rate",
    "damping_rate_from_field_energy",
    "damping_rate_decay_phase",
    "time_to_pe_threshold",
]


def compute_bounce_time(perturbed_amplitude: float) -> float:
    """1/sqrt(A)."""
    return 1.0 / np.sqrt(perturbed_amplitude)


def compute_numerical_entropy(snapshot_col: torch.Tensor, n_mesh: int, nv_mesh: int, length: float,
                              dx: float, vmin: float, vmax: float, dv: float,
                              n0: float) -> torch.Tensor:
    """-sum f ln f dx dv from a square 2D histogram of max(n_mesh, nv_mesh)
    bins (use n_mesh == nv_mesh for the reference's [N_mesh, Nv_mesh] bins;
    the caller passes ``nv_mesh``, which the reference miscomputes)."""
    n = snapshot_col.shape[0] // 2
    hist = phase_space_histogram(snapshot_col[:n], snapshot_col[n:], max(n_mesh, nv_mesh), length,
                                 vmin, vmax)
    f = hist * (n0 / dx / dv / n)
    nz = f != 0
    terms = torch.where(nz, f * torch.log(torch.where(nz, f, torch.ones_like(f))),
                        torch.zeros_like(f))
    return -torch.sum(terms) * dx * dv


def compute_linear_damping_rate_analytic(k: float, v_th: float, n0: float) -> float:
    """The reference's textbook Landau rate, with its quirks kept: Gaussian
    units' ``w_pe = sqrt(4 pi n0)`` and no Bohm-Gross ``-3/2`` term. Use
    :func:`landau_damping_rate_analytic_sim` for this simulation's units."""
    w_pe = np.sqrt(4.0 * np.pi * n0)
    lamda_de = v_th / w_pe
    kl = k * lamda_de
    return float(np.exp(-1.0 / (2.0 * kl**2)) / kl**3 * np.sqrt(np.pi / 8.0) * w_pe)


def landau_damping_rate_analytic_sim(k: float, v_th: float, n0: float = 1.0) -> float:
    """Linear Landau damping rate gamma (< 0) in this simulation's units
    (``w_pe = sqrt(n0)``), weak-damping expansion about the Bohm-Gross
    frequency; valid for ``k lambda_D <~ 0.5``."""
    w_pe = np.sqrt(n0)
    kl = k * v_th / w_pe
    return float(-np.sqrt(np.pi / 8.0) * w_pe / kl**3 * np.exp(-1.0 / (2.0 * kl**2) - 1.5))


def _lstsq_slope(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    tm = t - torch.mean(t)
    return torch.sum(tm * (y - torch.mean(y))) / torch.sum(tm * tm)


def compute_linear_damping_rate(tmax: float, n0: float, grid: Grid, snapshot: torch.Tensor,
                                n_mesh: int) -> torch.Tensor:
    """gamma from the fit log E^2(t) = 2 gamma t + C over the field
    re-solved from every snapshot column (chunked, :func:`snapshot_e_mesh`)."""
    nt = snapshot.shape[1]
    e_mesh = snapshot_e_mesh(snapshot, grid, n0)
    e2 = torch.sum(e_mesh**2, dim=-1) * grid.dx
    ts = torch.linspace(0.0, tmax, nt, dtype=e2.dtype, device=e2.device)
    return 0.5 * _lstsq_slope(ts, torch.log(e2))


def damping_rate_from_field_energy(ts: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """The same fit on a recorded PE(t) series (PE differs from sum E^2 dx
    by a constant factor only, which leaves the log-slope alone)."""
    return 0.5 * _lstsq_slope(ts, torch.log(pe))


def damping_rate_decay_phase(ts, pe, floor_factor: float = 2.0) -> float:
    """gamma fitted over the decay phase only: log PE from the global PE
    peak to the first sample at or below ``floor_factor`` times the
    post-peak minimum. The window is picked on the host in float64; a
    degenerate window (fewer than 3 samples) falls back to the whole trace,
    and so does a non-finite trace or ``floor_factor < 1``. The fit itself
    runs in float32."""
    ts = np.asarray(ts, dtype=np.float64)
    pe = np.asarray(pe, dtype=np.float64)
    i0 = int(np.argmax(pe))
    post = pe[i0:]
    if len(post) < 3:
        i0, post = 0, pe
    floor = float(np.min(post))
    below = np.nonzero(post <= floor_factor * floor)[0]
    i1 = i0 + int(below[0]) + 1 if len(below) else len(pe)
    if i1 - i0 < 3:
        i0, i1 = 0, len(pe)
    t32 = torch.as_tensor(ts[i0:i1], dtype=torch.float32)
    pe32 = torch.as_tensor(pe[i0:i1], dtype=torch.float32)
    return float(0.5 * _lstsq_slope(t32, torch.log(pe32)))


def time_to_pe_threshold(ts, pe, threshold: float, after_peak: bool = True,
                         sustained: bool = True) -> float:
    """First time at which PE(t) falls to or below ``threshold`` (host
    numpy); NaN if it never does. ``after_peak`` searches from the global
    peak on; ``sustained`` requires the trace to stay at or below the
    threshold for the rest of the run."""
    ts = np.asarray(ts, dtype=np.float64)
    pe = np.asarray(pe, dtype=np.float64)
    i0 = int(np.argmax(pe)) if after_peak else 0
    below = pe[i0:] <= threshold
    if sustained:
        ok = np.flip(np.logical_and.accumulate(np.flip(below)))
        hit = np.nonzero(ok)[0]
    else:
        hit = np.nonzero(below)[0]
    return float(ts[i0 + hit[0]]) if len(hit) else float("nan")
