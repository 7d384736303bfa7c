"""Segmented, resumable rollouts and the trainers' full training state.

The counterpart of :mod:`plasma_control_tpu.io.resume`. A long rollout runs
in segments of ``segment_steps`` with its complete state checkpointed after
each (:func:`.checkpoint.save_checkpoint`), so a preempted run resumes where
it stopped and continues as the uninterrupted run would have: bitwise on
the same device, since every step is deterministic.

Where JAX splits one key into a per-step key schedule, the port draws from
one ``torch.Generator``: the MPC checkpoint stores the generator's state
after each segment and a resume sets it back, and
:func:`resumable_mpc_rollout` also takes a (T, ...) ``step_noise`` indexed
by global step in place of the draws, as :func:`..control.mpc.mpc_rollout`
does. The trainers' checkpoint (:func:`save_train_checkpoint`) holds the
networks, the optimisers' moments and step counts, the replay buffer's
filled rows, SAC's temperature, the generator's state, the history and the
best actor.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..models.pic import PlasmaState
from ..models.rollout import rollout
from ..ops.grid import Grid
from .checkpoint import conform, load_params, restore_checkpoint, save_checkpoint, save_params

__all__ = [
    "resumable_rollout",
    "resumable_feedback_rollout",
    "resumable_mpc_rollout",
    "save_train_checkpoint",
    "restore_train_checkpoint",
]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _train_tree(ts) -> dict:
    """The trainer state's networks (state dicts, targets included), its
    optimisers (:meth:`..control.rl.optim.Adam.state_dict`) and its bare
    tensors (SAC's ``log_alpha``), by field name."""
    out = {}
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        out[f.name] = v if isinstance(v, torch.Tensor) else v.state_dict()
    return out


@torch.no_grad()
def _load_train_tree(ts, tree: dict) -> None:
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if isinstance(v, torch.Tensor):
            v.copy_(tree[f.name])
        else:
            v.load_state_dict(tree[f.name])


def save_train_checkpoint(path: str, ts, buf, generator: torch.Generator, ep_done: int,
                          hist: dict, best_reward: Optional[float], best_params) -> None:
    """Persist the complete training state: the trainer state ``ts``
    (networks, optimiser moments and counts, SAC's temperature), the replay
    buffer ``buf`` (its filled rows; None for PPO), the generator's state,
    the episode counter, the per-episode history and the best actor (a host
    flax tree). Layout: ``<path>/state`` (:func:`.checkpoint.save_checkpoint`),
    ``<path>/meta.npz`` (counters and history), ``<path>/best.msgpack``
    (flax's layout).

    Each file goes to a temporary name and is renamed into place. The episode
    counter is stored in ``state`` and in ``meta.npz``, written last;
    :func:`restore_train_checkpoint` refuses a checkpoint whose two counters
    disagree (a preemption between the writes)."""
    tree = {"ts": _train_tree(ts), "generator": generator, "ep": int(ep_done)}
    if buf is not None:
        tree["buf"] = buf.state_dict()
    save_checkpoint(os.path.join(path, "state"), tree)
    best = os.path.join(path, "best.msgpack")
    save_params(best + ".tmp", best_params)
    os.replace(best + ".tmp", best)
    meta = {
        "ep_done": np.asarray(ep_done),
        "best_reward": np.asarray(np.nan if best_reward is None else best_reward),
    }
    for k, v in hist.items():
        meta[f"hist_{k}"] = np.asarray(v, dtype=np.float64)
    tmp = os.path.join(path, "meta.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **meta)
    os.replace(tmp, os.path.join(path, "meta.npz"))


def restore_train_checkpoint(path: str, ts, buf, generator: torch.Generator) -> Optional[dict]:
    """Inverse of :func:`save_train_checkpoint`: loads the stored state into
    ``ts``, ``buf`` and ``generator`` in place and returns ``{"ep_done",
    "hist", "best_reward", "best_params"}``. Returns ``None``, and changes
    nothing, when ``<path>/meta.npz`` is missing; and with a warning when
    ``meta.npz`` or the state is unreadable or does not fit (another
    configuration), or when the two episode counters disagree: training then
    starts fresh rather than from mismatched state."""
    meta_path = os.path.join(path, "meta.npz")
    if not os.path.exists(meta_path):
        return None
    try:
        meta = np.load(meta_path)
        ep_done = int(meta["ep_done"])
        best_reward = float(meta["best_reward"])
        hist = {k[len("hist_"):]: [float(x) for x in meta[k]]
                for k in meta.files if k.startswith("hist_")}
    except Exception as e:  # truncated meta
        warnings.warn(f"unreadable training checkpoint meta at {meta_path} ({e}); starting fresh")
        return None
    like = {"ts": _train_tree(ts), "generator": generator.get_state(), "ep": 0}
    try:
        raw = restore_checkpoint(os.path.join(path, "state"))
        tree = conform({k: v for k, v in raw.items() if k != "buf"}, like)
        best_params = load_params(os.path.join(path, "best.msgpack"))
        if tree["ep"] == ep_done and buf is not None:
            buf.load_state_dict(raw["buf"])  # checks every field before it copies
    except Exception as e:  # a partial or foreign checkpoint
        warnings.warn(f"unreadable training checkpoint at {path} ({e}); starting fresh")
        return None
    if tree["ep"] != ep_done:
        warnings.warn(
            f"inconsistent training checkpoint at {path}: state is from episode {tree['ep']} "
            f"but meta says {ep_done} (preempted mid-save); starting fresh"
        )
        return None
    _load_train_tree(ts, tree["ts"])
    generator.set_state(tree["generator"])
    return {
        "ep_done": ep_done,
        "hist": hist,
        "best_reward": None if np.isnan(best_reward) else best_reward,
        "best_params": best_params,
    }


def _state_like(state: PlasmaState) -> dict:
    return {"x": state.x, "v": state.v, "t_done": 0}


def _restore_state(ckpt_path, resume, state, like, total, what):
    """(checkpoint tree or None, t_done, state) of a segmented run's start."""
    if not (ckpt_path and resume and os.path.exists(ckpt_path)):
        return None, 0, state
    raw = restore_checkpoint(ckpt_path)
    ck = conform(raw, like(raw))
    t_done = int(ck["t_done"])
    if 0 < t_done <= total:
        state = PlasmaState(ck["x"], ck["v"])
        print(f"# resumed {what}from {ckpt_path} at step {t_done}")
    return ck, t_done, state


def resumable_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ckpt_path: Optional[str] = None,
    segment_steps: int = 100,
    e_external_traj: Optional[torch.Tensor] = None,
    resume: bool = True,
):
    """Open-loop rollout of ``cfg.n_steps`` in segments of ``segment_steps``.

    Returns (final_state, pe, ke, xs, vs), the series as numpy, covering the
    steps run by THIS call: a fresh run returns the full T+1 series with the
    initial sample; a resumed run the remaining [t_resume, T] (the
    interrupted run produced the rest). If ``ckpt_path`` exists and
    ``resume``, continues from the stored step; a checkpoint of another N
    raises ``ValueError``."""
    total = cfg.n_steps
    _, t_done, state = _restore_state(ckpt_path, resume, state, lambda _: _state_like(state),
                                      total, "")
    pe_parts, ke_parts, xs_parts, vs_parts = [], [], [], []
    # the initial sample belongs to a fresh run only: a resumed run's first
    # state is the interrupted run's last recorded one
    first = t_done == 0
    while t_done < total:
        n = min(segment_steps, total - t_done)
        e_seg = None if e_external_traj is None else e_external_traj[t_done: t_done + n]
        out = rollout(state, grid, cfg, e_external_traj=e_seg, record_snapshots=True, n_steps=n)
        state = out.final_state
        sl = slice(None) if first else slice(1, None)
        pe_parts.append(_host(out.field_energy[sl]))
        ke_parts.append(_host(out.kinetic[sl]))
        xs_parts.append(_host(out.xs[sl]))
        vs_parts.append(_host(out.vs[sl]))
        first = False
        t_done += n
        if ckpt_path:
            save_checkpoint(ckpt_path, {"x": state.x, "v": state.v, "t_done": t_done})

    pe = np.concatenate(pe_parts) if pe_parts else np.zeros(0)
    ke = np.concatenate(ke_parts) if ke_parts else np.zeros(0)
    xs = np.concatenate(xs_parts) if xs_parts else None
    vs = np.concatenate(vs_parts) if vs_parts else None
    return state, pe, ke, xs, vs


def resumable_feedback_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl,
    actuator,
    ckpt_path: Optional[str] = None,
    segment_steps: int = 100,
    resume: bool = True,
):
    """Closed-loop phase-conjugate feedback in resumable segments.

    The law is memoryless in the particle state, so the checkpoint is (x, v,
    t_done). Returns ``(final_state, traces)``: the per-step series
    (field_energy, kinetic, coeff_cos, coeff_sin, input_energy) and the xs /
    vs snapshots, as numpy, covering the steps run by THIS call (a fresh run
    includes the initial snapshot, as in :func:`resumable_rollout`)."""
    from ..control.feedback import feedback_rollout

    total = cfg.n_steps
    _, t_done, state = _restore_state(ckpt_path, resume, state, lambda _: _state_like(state),
                                      total, "feedback ")
    per_step = ("field_energy", "kinetic", "coeff_cos", "coeff_sin", "input_energy")
    parts = {k: [] for k in per_step}
    xs_parts, vs_parts = [], []
    first = t_done == 0
    while t_done < total:
        n = min(segment_steps, total - t_done)
        out = feedback_rollout(state, grid, cfg, ctrl, actuator, record_snapshots=True, n_steps=n)
        state = out.final_state
        for k in parts:
            parts[k].append(_host(getattr(out, k)))
        sl = slice(None) if first else slice(1, None)
        xs_parts.append(_host(out.xs[sl]))
        vs_parts.append(_host(out.vs[sl]))
        first = False
        t_done += n
        if ckpt_path:
            save_checkpoint(ckpt_path, {"x": state.x, "v": state.v, "t_done": t_done})

    traces = {k: np.concatenate(v) if v else np.zeros(0) for k, v in parts.items()}
    traces["xs"] = np.concatenate(xs_parts) if xs_parts else None
    traces["vs"] = np.concatenate(vs_parts) if vs_parts else None
    return state, traces


def resumable_mpc_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl,
    mpc,
    actuator,
    generator: Optional[torch.Generator] = None,
    ckpt_path: Optional[str] = None,
    segment_steps: int = 100,
    resume: bool = True,
    step_noise: Optional[torch.Tensor] = None,
):
    """Closed-loop MPC of ``cfg.n_steps`` in resumable segments.

    The checkpoint after each segment holds the particles, the shifted
    nominal (restored as ``mean0``), the applied coefficients so far, the
    step counter and the generator's state, so a resumed run draws what the
    uninterrupted run drew. ``step_noise`` (T, ...) replaces the draws,
    indexed by global step (:func:`..control.mpc.mpc_rollout`).

    Returns ``(final_state, traces)``: the per-step series (field_energy,
    kinetic, hamiltonian, coeffs, input_energy, plan_cost) of the steps run by
    THIS call, as numpy, and ``coeffs_full``, the (T, 2K) applied
    coefficients across interruptions, from which a caller replays the whole
    controlled trajectory."""
    from ..control.mpc import mpc_rollout

    total = cfg.n_steps
    d = 2 * ctrl.max_mode
    x = state.x
    mean = torch.zeros((mpc.horizon, d), dtype=x.dtype, device=x.device)
    coeffs_full = np.zeros((total, d), dtype=_host(x[:0]).dtype)

    def like(raw):
        # the checkpoint may come from a shorter run (a smaller t_max): it
        # holds the applied coefficients of its t_done steps
        return {**_state_like(state), "mean": mean,
                "coeffs": np.zeros((int(raw["t_done"]), d), dtype=coeffs_full.dtype),
                "generator": None if generator is None else generator.get_state()}

    ck, t_done, state = _restore_state(ckpt_path, resume, state, like, total, "MPC ")
    if 0 < t_done <= total:
        mean = ck["mean"]
        coeffs_full[:t_done] = ck["coeffs"]
        if generator is not None:
            generator.set_state(ck["generator"])

    keys = ("field_energy", "kinetic", "hamiltonian", "coeffs", "input_energy", "plan_cost")
    parts = {k: [] for k in keys}
    while t_done < total:
        n = min(segment_steps, total - t_done)
        noise = None if step_noise is None else step_noise[t_done: t_done + n]
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, actuator, generator, n_steps=n,
                          mean0=mean, step_noise=noise)
        state, mean = out.final_state, out.final_mean
        for k in parts:
            parts[k].append(_host(getattr(out, k)))
        coeffs_full[t_done: t_done + n] = parts["coeffs"][-1]
        t_done += n
        if ckpt_path:
            save_checkpoint(ckpt_path, {"x": state.x, "v": state.v, "mean": mean,
                                        "coeffs": coeffs_full[:t_done], "t_done": t_done,
                                        "generator": generator})

    traces = {k: (np.concatenate(v) if v else np.zeros((0, d) if k == "coeffs" else (0,)))
              for k, v in parts.items()}
    traces["coeffs_full"] = coeffs_full
    return state, traces
