"""Plotting: the reference's full figure set, drawn from snapshots.

The counterpart of :mod:`plasma_control_tpu.viz.plots`: the same 16
``plot_*`` functions, signatures, figure layouts and PDF outputs. Snapshots
are (2N, Nt) arrays (positions, then velocities, one column per recorded
step). The field-dependent plots re-solve E from the snapshot with
:func:`_e_mesh_series`: on the card through the deposit kernel, one launch
for all Nt columns, then the circulant solve; on the CPU through the dense
deposit, as the JAX package does. Their ``device`` argument chooses; it
defaults to the card, as every entry point of the port does.

matplotlib and scipy are imported inside the functions, so this module
imports where they are missing (the GPU machine has no matplotlib);
:func:`matplotlib_available` says whether a plot can be drawn.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = [
    "plot_x_dist_snapshot",
    "plot_v_dist_snapshot",
    "plot_dist_snapshot",
    "plot_two_stream_snapshot",
    "plot_bump_on_tail_snapshot",
    "plot_x_dist_evolution",
    "plot_v_dist_evolution",
    "plot_dist_evolution",
    "plot_two_stream_evolution",
    "plot_bump_on_tail_evolution",
    "plot_log_e",
    "plot_e_k_spectrum",
    "plot_e_k_over_time",
    "plot_e_k_external_over_time",
    "plot_loss_curve",
    "plot_cost_over_time",
    "matplotlib_available",
]


def matplotlib_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    """pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _gaussian_kde(data):
    from scipy.stats import gaussian_kde

    return gaussian_kde(data)


def _filepath(save_dir: Optional[str], filename: Optional[str]) -> Optional[str]:
    if save_dir is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    return os.path.join(save_dir, filename)


def _finish(fig, filepath):
    fig.tight_layout()
    if filepath is not None:
        fig.savefig(filepath, dpi=120)
        _plt().close(fig)  # saved to disk; do not leak open figures
    return fig


def _e_mesh_series(snapshot, length: float, n_mesh: int, n0: float = 1.0,
                   device="cuda") -> np.ndarray:
    """(Nt, M) self-consistent mesh fields re-solved from a (2N, Nt)
    snapshot. On a CUDA device the Nt columns are one launch of the deposit
    kernel (at most 65535 columns); on the CPU the dense deposit runs in
    chunks of columns (:func:`..diag.spectrum.snapshot_e_mesh`)."""
    from ..diag.spectrum import snapshot_e_mesh
    from ..ops.deposit import deposit
    from ..ops.fields import solve_e_mesh
    from ..ops.grid import make_grid

    grid = make_grid(int(n_mesh), length, device=device)
    snap = torch.as_tensor(np.asarray(snapshot), dtype=torch.float32, device=grid.e_op.device)
    if snap.is_cuda:
        xs = snap[: snap.shape[0] // 2].T  # (Nt, N)
        e = solve_e_mesh(deposit(xs, grid, n0=n0, method="pallas"), grid, n0)
    else:
        e = snapshot_e_mesh(snap, grid, n0)
    return e.cpu().numpy()


# ---------------------------------------------------------------------------
# 1D marginal distributions (KDE)
# ---------------------------------------------------------------------------


def plot_x_dist_snapshot(snapshot, save_dir, filename, xmin=0.0, xmax=50.0, n_mesh=500):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n = snapshot.shape[0] // 2
    xs = np.linspace(xmin, xmax, n_mesh)
    kde = _gaussian_kde(np.asarray(snapshot[:n]).ravel())
    fig, ax = plt.subplots(1, 1, figsize=(6, 4), facecolor="white", dpi=120)
    ax.plot(xs, kde(xs))
    ax.set_xlabel("x")
    ax.set_ylabel(r"$f(x,\cdot)$")
    ax.set_xlim([xmin, xmax])
    return _finish(fig, fp), ax


def plot_v_dist_snapshot(snapshot, save_dir, filename, vmin=-10.0, vmax=10.0, n_mesh=500):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n = snapshot.shape[0] // 2
    vs = np.linspace(vmin, vmax, n_mesh)
    kde = _gaussian_kde(np.asarray(snapshot[n:]).ravel())
    fig, ax = plt.subplots(1, 1, figsize=(6, 4), facecolor="white", dpi=120)
    ax.plot(vs, kde(vs))
    ax.set_xlabel("v")
    ax.set_ylabel(r"$f(\cdot,v)$")
    ax.set_xlim([vmin, vmax])
    return _finish(fig, fp), ax


def plot_dist_snapshot(
    snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0, vmax=10.0, n_mesh=100
):
    """f(x, v) as a 2D histogram image."""
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n = snapshot.shape[0] // 2
    hist, _, _ = np.histogram2d(
        np.asarray(snapshot[:n]).ravel(),
        np.asarray(snapshot[n:]).ravel(),
        bins=[n_mesh, n_mesh],
        range=[[xmin, xmax], [vmin, vmax]],
    )
    fig, ax = plt.subplots(1, 1, figsize=(5, 3), facecolor="white", dpi=120)
    ax.imshow(hist.T, extent=[xmin, xmax, vmin, vmax], aspect="auto", origin="lower")
    ax.set_xlabel("x")
    ax.set_ylabel("v")
    ax.set_title(r"$f(x,v)$")
    return _finish(fig, fp), ax


def _kde_panels(series, grid_pts, labels, xlabel, ylabel, lims):
    plt = _plt()
    fig, axes = plt.subplots(1, len(series), figsize=(4 * len(series), 4), facecolor="white",
                             dpi=120, sharey=True)
    axes = np.atleast_1d(axes).ravel()
    for ax, data, title in zip(axes, series, labels):
        kde = _gaussian_kde(np.asarray(data).ravel())
        ax.plot(grid_pts, kde(grid_pts))
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_xlim(lims)
        ax.set_title(title)
    return fig, axes


_T_LABELS = [r"$t=0$", r"$t=t_{max}/2$", r"$t=t_{max}$"]


def plot_x_dist_evolution(snapshot, save_dir, filename, xmin=0.0, xmax=50.0, n_mesh=500):
    fp = _filepath(save_dir, filename)
    n, nt = snapshot.shape[0] // 2, snapshot.shape[1]
    xs = np.linspace(xmin, xmax, n_mesh)
    fig, axes = _kde_panels(
        [snapshot[:n, 0], snapshot[:n, nt // 2], snapshot[:n, -1]],
        xs, _T_LABELS, "x", r"$f(x,\cdot)$", [xmin, xmax],
    )
    return _finish(fig, fp), axes


def plot_v_dist_evolution(snapshot, save_dir, filename, vmin=-10.0, vmax=10.0, n_mesh=500):
    fp = _filepath(save_dir, filename)
    n, nt = snapshot.shape[0] // 2, snapshot.shape[1]
    vs = np.linspace(vmin, vmax, n_mesh)
    fig, axes = _kde_panels(
        [snapshot[n:, 0], snapshot[n:, nt // 2], snapshot[n:, -1]],
        vs, _T_LABELS, "v", r"$f(\cdot,v)$", [vmin, vmax],
    )
    return _finish(fig, fp), axes


def plot_dist_evolution(
    snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0, vmax=10.0, n_mesh=100
):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n, nt = snapshot.shape[0] // 2, snapshot.shape[1]
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), facecolor="white", dpi=120)
    axes = axes.ravel()
    for ax, idx, title in zip(axes, [0, nt // 2, nt - 1], _T_LABELS):
        hist, _, _ = np.histogram2d(
            np.asarray(snapshot[:n, idx]).ravel(),
            np.asarray(snapshot[n:, idx]).ravel(),
            bins=[n_mesh, n_mesh],
            range=[[xmin, xmax], [vmin, vmax]],
        )
        ax.imshow(hist.T, extent=[xmin, xmax, vmin, vmax], aspect="auto", origin="lower")
        ax.set_xlabel("x")
        ax.set_ylabel("v")
        ax.set_title(title)
    return _finish(fig, fp), axes


# ---------------------------------------------------------------------------
# Phase-space scatter
# ---------------------------------------------------------------------------


def _scatter_two_stream(ax, x_all, v_all, xmin, xmax, vmin, vmax, title):
    nh = x_all.shape[0] // 2
    ax.scatter(x_all[:nh], v_all[:nh], s=0.3, color="blue", alpha=0.5)
    ax.scatter(x_all[nh:], v_all[nh:], s=0.3, color="red", alpha=0.5)
    ax.set_xlabel("x")
    ax.set_ylabel("v")
    ax.axis([xmin, xmax, vmin, vmax])
    ax.set_title(title)


def plot_two_stream_snapshot(snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0,
                             vmax=10.0):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n = snapshot.shape[0] // 2
    fig, ax = plt.subplots(1, 1, figsize=(5, 3), facecolor="white", dpi=120)
    _scatter_two_stream(ax, np.asarray(snapshot[:n]).ravel(), np.asarray(snapshot[n:]).ravel(),
                        xmin, xmax, vmin, vmax, "Phase space")
    return _finish(fig, fp), ax


def plot_two_stream_evolution(snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0,
                              vmax=10.0):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n, nt = snapshot.shape[0] // 2, snapshot.shape[1]
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), facecolor="white", dpi=120)
    axes = axes.ravel()
    for ax, idx, title in zip(axes, [0, nt // 2, nt - 1], _T_LABELS):
        _scatter_two_stream(ax, np.asarray(snapshot[:n, idx]), np.asarray(snapshot[n:, idx]),
                            xmin, xmax, vmin, vmax, title)
    return _finish(fig, fp), axes


def _scatter_bump(ax, x_all, v_all, high_idx, xmin, xmax, vmin, vmax, title):
    mask = np.zeros(x_all.shape[0], dtype=bool)
    if high_idx is not None:
        mask[np.asarray(high_idx)] = True
    ax.scatter(x_all[~mask], v_all[~mask], s=0.3, color="blue", alpha=0.5)
    if high_idx is not None:
        ax.scatter(x_all[mask], v_all[mask], s=0.3, color="red", alpha=0.5)
    ax.set_xlabel("x")
    ax.set_ylabel("v")
    ax.axis([xmin, xmax, vmin, vmax])
    ax.set_title(title)


def plot_bump_on_tail_snapshot(
    snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0, vmax=10.0,
    high_electron_indice=None
):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n = snapshot.shape[0] // 2
    fig, ax = plt.subplots(1, 1, figsize=(5, 3), facecolor="white", dpi=120)
    _scatter_bump(ax, np.asarray(snapshot[:n]).ravel(), np.asarray(snapshot[n:]).ravel(),
                  high_electron_indice, xmin, xmax, vmin, vmax, "Phase space")
    return _finish(fig, fp), ax


def plot_bump_on_tail_evolution(
    snapshot, save_dir, filename, xmin=0.0, xmax=50.0, vmin=-10.0, vmax=10.0,
    high_electron_indice=None
):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    n, nt = snapshot.shape[0] // 2, snapshot.shape[1]
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), facecolor="white", dpi=120)
    axes = axes.ravel()
    for ax, idx, title in zip(axes, [0, nt // 2, nt - 1], _T_LABELS):
        _scatter_bump(ax, np.asarray(snapshot[:n, idx]), np.asarray(snapshot[n:, idx]),
                      high_electron_indice, xmin, xmax, vmin, vmax, title)
    return _finish(fig, fp), axes


# ---------------------------------------------------------------------------
# Field energy / spectrum
# ---------------------------------------------------------------------------


def plot_log_e(tmax, length, dx, n_mesh, snapshot, save_dir, filename, device="cuda"):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    nt = snapshot.shape[1]
    ts = np.linspace(0, tmax, nt)
    e_mesh = _e_mesh_series(snapshot, length, int(n_mesh), device=device)
    e2 = np.mean(e_mesh**2, axis=1)
    fig, ax = plt.subplots(1, 1, figsize=(5, 3), facecolor="white", dpi=120)
    ax.plot(ts, e2)
    ax.set_xlabel("Timestep")
    ax.set_ylabel(r"$\log <E^2>$")
    ax.set_yscale("log")
    return _finish(fig, fp), ax


def _spectrum(snapshot, length, dx, n_mesh, device="cuda"):
    """(ks, (n_keep, Nt) spectrum |fft(E)/M*2|) of a snapshot."""
    from ..diag.spectrum import spectrum_wavenumbers

    e_mesh = _e_mesh_series(snapshot, length, int(n_mesh), device=device)  # (Nt, M)
    ek = np.abs(np.fft.fft(e_mesh, axis=1) / n_mesh * 2.0)
    ks = spectrum_wavenumbers(int(n_mesh), dx)
    return ks, ek[:, : len(ks)].T


def plot_e_k_spectrum(tmax, length, dx, n_mesh, snapshot, save_dir, filename, device="cuda"):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    ks, spec = _spectrum(snapshot, length, dx, n_mesh, device)
    fig, ax = plt.subplots(1, 1, figsize=(6, 3), facecolor="white", dpi=120)
    ax.imshow(spec, extent=[0, tmax, ks[0], ks[-1]], aspect="auto", origin="lower")
    ax.set_xlabel(r"$t$")
    ax.set_ylabel(r"$k$")
    ax.set_title(r"$E_k$")
    ax.set_ylim([0, 1.0])
    ax.grid(True)
    return _finish(fig, fp), ax


def plot_e_k_over_time(tmax, length, dx, n_mesh, max_mode, snapshot, save_dir, filename,
                       device="cuda"):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    nt = snapshot.shape[1]
    ts = np.linspace(0, tmax, nt)
    _, spec = _spectrum(snapshot, length, dx, n_mesh, device)
    fig, ax = plt.subplots(1, 1, figsize=(6, 3), facecolor="white", dpi=120)
    for i in range(1, max_mode + 1):
        ax.plot(ts, spec[i, :].ravel(), label=rf"$n={i}$")
    ax.set_xlabel(r"$t$")
    ax.set_ylabel(r"$E_k$")
    ax.legend()
    ax.grid(True)
    return _finish(fig, fp), ax


def plot_e_k_external_over_time(tmax, coeff_cos, coeff_sin, save_dir, filename):
    """Mode amplitudes sqrt(a^2+b^2)(t) of (K, Nt) actuator coefficient
    histories."""
    plt = _plt()
    fp = _filepath(save_dir, filename)
    coeff_cos = np.asarray(coeff_cos)
    coeff_sin = np.asarray(coeff_sin)
    max_mode, nt = coeff_cos.shape
    amp = np.sqrt(coeff_cos**2 + coeff_sin**2)
    ts = np.linspace(0, tmax, nt)
    fig, ax = plt.subplots(1, 1, figsize=(6, 3), facecolor="white", dpi=120)
    for i in range(max_mode):
        ax.plot(ts, amp[i, :].ravel(), label=rf"$n={i + 1}$")
    ax.set_xlabel(r"$t$")
    ax.set_ylabel(r"$E_k$")
    ax.legend()
    ax.grid(True)
    return _finish(fig, fp), ax


# ---------------------------------------------------------------------------
# Training curves / cost traces
# ---------------------------------------------------------------------------


def plot_loss_curve(info: Dict, save_dir, filename):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    fig, ax = plt.subplots(1, 1, figsize=(5, 3), facecolor="white", dpi=120)
    for name, value in info.items():
        ax.plot(np.asarray(value), label=f"{name}")
    ax.set_xlabel("Episode")
    ax.set_ylabel("Loss")
    ax.legend()
    ax.grid(True)
    return _finish(fig, fp), ax


def plot_cost_over_time(tmax, nt, mdict: Dict, save_dir, filename):
    plt = _plt()
    fp = _filepath(save_dir, filename)
    ts = np.linspace(0, tmax, nt)
    fig, ax = plt.subplots(1, 1, figsize=(6, 3), facecolor="white", dpi=120)
    for key, value in mdict.items():
        ax.plot(ts, np.asarray(value), label=f"{key}")
    ax.set_xlabel(r"$t$")
    ax.set_ylabel("Cost")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True)
    return _finish(fig, fp), ax
