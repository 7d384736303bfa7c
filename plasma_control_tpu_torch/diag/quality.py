"""Control quality held to the reference's own seeds.

The reference measured its controllers' quality over seeds: 8 of config-4
(``experiments/config4_frontier.py``, written to
``artifacts/results_r5/config4_frontier.json``) and one of the
controller-damping row (``bench_scaling.py:96-131``, ``SCALING_r05.json``).
This module holds the port to those numbers:

* the reference's initial states, as the JAX package drew them
  (``init_state(cfg, PRNGKey(cfg.seed + s))`` for config-4's seeds s = 0..7,
  ``init_state(cfg, PRNGKey(0))`` for the damping row), committed as float32
  numpy in ``data/reference_states.npz`` and read by :func:`reference_states`:
  torch's generator cannot redraw JAX's;
* the statistics as the two scripts compute them (:func:`frontier_stats`,
  :func:`damping_tail`);
* readers of the two artifacts (:func:`frontier_reference`,
  :func:`damping_reference`), read at run time, never copied into code;
* the gates: seed-paired within the fp32-chaos bound where the runs are
  deterministic (:func:`paired_gate`), and as distributions where the MPC
  noise cannot be paired with JAX's draws (:func:`distribution_gate`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..interop import state_from_numpy
from ..models.pic import PlasmaState
from .landau import damping_rate_decay_phase

__all__ = ["STATES_PATH", "FRONTIER_PATH", "SCALING_PATH", "CONFIG4", "CONFIG4_SEEDS", "DAMPING",
           "PAIRED_RTOL", "MEAN_RATIO", "MIN_P", "Gate", "reference_states", "frontier_stats",
           "damping_tail", "frontier_reference", "damping_reference", "paired_gate",
           "distribution_gate"]

_PACKAGE = Path(__file__).resolve().parents[1]
STATES_PATH = _PACKAGE / "data" / "reference_states.npz"
FRONTIER_PATH = _PACKAGE.parent / "artifacts" / "results_r5" / "config4_frontier.json"
SCALING_PATH = _PACKAGE.parent / "SCALING_r05.json"

# config-4 as experiments/config4_frontier.py:61-63 sets it (SimConfig fields;
# the seed is SimConfig's default, 42) and its seed count
CONFIG4 = dict(simcase="two-stream", n_particles=100_000, n_mesh=256, dt=0.1, t_max=50.0,
               length=50.0)
CONFIG4_SEEDS = 8
# the controller-damping row's environment at bench_scaling.py:98-101's full shapes
DAMPING = dict(simcase="bump-on-tail", n_particles=10_000, n_mesh=128, dt=0.1, t_max=30.0)
DAMPING_TAIL_STEPS = 60  # bench_scaling.py:138: the mean of the last 60 entries

# a deterministic run from a handed state: within the fp32-chaos bound of
# tests/test_golden.py:137-146 of the reference's tail, seed by seed
PAIRED_RTOL = 0.01
# an MPC row, whose noise cannot be paired: the mean within a factor 1.5 of
# the reference's either way, and a two-sided Mann-Whitney U test that does
# not tell the two samples apart at 1 %
MEAN_RATIO = (2.0 / 3.0, 1.5)
MIN_P = 0.01


class Gate(NamedTuple):
    """A gate's verdict: ``ok``, and what it was decided on (per-seed
    relative differences for :func:`paired_gate`; the ratio of the means and
    the Mann-Whitney p-value for :func:`distribution_gate`)."""

    ok: bool
    rel: tuple = ()
    ratio: float = float("nan")
    p: float = float("nan")


def reference_states(name: str, device="cuda") -> list[PlasmaState]:
    """The reference's initial states of ``name`` ("config4": 8 states, one
    per seed; "damping": one), float32 on ``device``."""
    if name not in ("config4", "damping"):
        raise ValueError(f"no reference states named {name!r}: 'config4' or 'damping'")
    with np.load(STATES_PATH) as data:
        xs, vs = data[f"{name}_x"], data[f"{name}_v"]
    return [state_from_numpy(x, v, device=device) for x, v in zip(xs, vs)]


def frontier_stats(pe, t_max: float, n_steps: int) -> dict:
    """experiments/config4_frontier.py:117-127 on one field-energy trace:
    ``tail_pe`` the mean of its last fifth, ``peak_pe`` its maximum,
    ``gamma_decay_phase`` the decay-phase fit over the run's times
    ``linspace(0, t_max, n_steps)[:len(pe)]``. Unrounded (the script
    rounds what it stores to 2 and 5 decimals)."""
    pe = _numpy(pe)
    ts = np.linspace(0, t_max, n_steps)
    return {"tail_pe": float(pe[-len(pe) // 5:].mean()),
            "peak_pe": float(pe.max()),
            "gamma_decay_phase": damping_rate_decay_phase(ts[: len(pe)], pe)}


def damping_tail(pe) -> float:
    """bench_scaling.py:138's tail PE: the mean of the last 60 entries."""
    return float(_numpy(pe)[-DAMPING_TAIL_STEPS:].mean())


def frontier_reference() -> dict:
    """Per-seed tail PE of every row of the config-4 frontier artifact:
    row name -> list ordered by seed."""
    with open(FRONTIER_PATH) as f:
        per_run = json.load(f)["per_run"]
    return {name: [r["tail_pe"] for r in sorted(rows, key=lambda r: r["seed"])]
            for name, rows in per_run.items()}


def damping_reference() -> dict:
    """The controller-damping row's tail PE of each controller
    ("uncontrolled", "feedback", "mpc") from the scaling artifact."""
    with open(SCALING_PATH) as f:
        for line in f:
            row = json.loads(line)
            if row.get("config") == "2-controller-damping":
                return dict(row["tail_pe"])
    raise ValueError(f"{SCALING_PATH}: no 2-controller-damping row")


def paired_gate(port, ref) -> Gate:
    """Seed by seed: ``|port - ref| <= PAIRED_RTOL * |ref|`` for every pair."""
    port, ref = _numpy(port), _numpy(ref)
    if port.shape != ref.shape:
        raise ValueError(f"paired samples differ in shape: {port.shape} and {ref.shape}")
    rel = np.abs(port - ref) / np.abs(ref)
    return Gate(ok=bool(np.all(rel <= PAIRED_RTOL)), rel=tuple(float(r) for r in rel))


def distribution_gate(port, ref) -> Gate:
    """Unpaired samples: the ratio of the means lies in ``MEAN_RATIO`` and
    the two-sided Mann-Whitney U test gives p >= ``MIN_P``."""
    from scipy.stats import mannwhitneyu

    port, ref = _numpy(port), _numpy(ref)
    ratio = float(port.mean() / ref.mean())
    p = float(mannwhitneyu(port, ref, alternative="two-sided").pvalue)
    ok = MEAN_RATIO[0] <= ratio <= MEAN_RATIO[1] and p >= MIN_P
    return Gate(ok=ok, ratio=ratio, p=p)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)
