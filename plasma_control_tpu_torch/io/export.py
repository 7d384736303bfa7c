"""Run dumps: ``.mat`` and ``.npz`` files in the reference's schema.

A copy of :mod:`plasma_control_tpu.io.export`, which is numpy-only but
lives under the JAX package, so the port cannot import it. The key set
(snapshot, E, PE, the parameters, coeff_cos/coeff_sin, the cost dict) is the
reference's, so its analysis notebooks read the port's dumps unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config import SimConfig

__all__ = ["build_run_dict", "save_mat", "save_npz", "load_initial_state", "load_run"]


def build_run_dict(
    cfg: SimConfig,
    snapshot: np.ndarray,
    energy: np.ndarray,
    field_energy: np.ndarray,
    coeff_cos: Optional[np.ndarray] = None,
    coeff_sin: Optional[np.ndarray] = None,
    costs: Optional[Dict[str, np.ndarray]] = None,
) -> dict:
    """The reference's ``mdic`` layout."""
    mdic = {
        "snapshot": np.asarray(snapshot),
        "E": np.asarray(energy),
        "PE": np.asarray(field_energy),
        "N": cfg.n_particles,
        "N_mesh": cfg.n_mesh,
        "n0": cfg.n0,
        "L": cfg.length,
        "dt": cfg.dt,
        "tmin": cfg.t_min,
        "tmax": cfg.t_max,
        "n_mode": cfg.perturb_mode,
        "A": cfg.perturb_amplitude,
        "vth": cfg.vth,
        "vb": cfg.vb,
        "a": cfg.bump_a,
    }
    if coeff_cos is not None:
        mdic["coeff_cos"] = np.asarray(coeff_cos)
    if coeff_sin is not None:
        mdic["coeff_sin"] = np.asarray(coeff_sin)
    if costs is not None:
        mdic["cost"] = {k: np.asarray(v) for k, v in costs.items()}
    return mdic


def save_mat(path: str, mdic: dict) -> None:
    from scipy.io import savemat

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    savemat(file_name=path, mdict=mdic, do_compression=True)


def save_npz(path: str, mdic: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for k, v in mdic.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"{k}/{kk}"] = np.asarray(vv)
        else:
            flat[k] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_initial_state(path: str, column: int = 0):
    """(x, v) float32 arrays from one snapshot column of a run dump, this
    package's or the reference's (same ``data.mat`` schema)."""
    run = load_run(path)
    snap = np.asarray(run["snapshot"])
    n = snap.shape[0] // 2
    col = snap[:, column] if snap.ndim == 2 else snap
    return col[:n].astype(np.float32), col[n:].astype(np.float32)


def load_run(path: str) -> dict:
    """Load a .mat or .npz run dump."""
    if path.endswith(".mat"):
        from scipy.io import loadmat

        return loadmat(path)
    data = np.load(path, allow_pickle=False)
    out: dict = {}
    for k in data.files:
        if "/" in k:
            g, kk = k.split("/", 1)
            out.setdefault(g, {})[kk] = data[k]
        else:
            out[k] = data[k]
    return out
