"""Shared machinery of the RL run scripts: train (``--optimize``), then a
deterministic closed-loop evaluation and the data dump.

The counterpart of :mod:`plasma_control_tpu.cli_rl` for
``python -m plasma_control_tpu_torch.run_ddpg`` / ``run_ppo`` / ``run_sac``:
the same weight files (``<save_file>/<simcase>/<algo>-control/<algo>_best``
and ``_last.msgpack``, flax's layout), the same evaluation from the seeded
state and the same ``run_and_save`` tag. The JAX package plots the loss and
reward curves; here they go into the data file's ``history`` group (the
viz slice is not ported). With ``--optimize``, ``--checkpoint_every`` or
``--checkpoint_path`` alone turns on the full training-state checkpoint
(:mod:`.io.resume`): every ``--checkpoint_every`` episodes (default 10)
into ``--checkpoint_path`` (default
``<save_file>/<simcase>/<algo>-control/train_ckpt``), resumed from unless
``--no_resume``.
"""

from __future__ import annotations

import argparse
import os

import torch

from .cli import add_resume_args, compute_cost_traces, high_indices, run_and_save
from .config import ControlConfig, SimConfig
from .control.actuator import make_actuator
from .control.evaluate import policy_rollout
from .interop import actor_params_from_numpy, actor_params_to_numpy
from .io.checkpoint import load_params, save_params
from .models.pic import init_state
from .ops.grid import make_grid

__all__ = ["add_rl_args", "run_rl"]


def add_rl_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The weight-file, training and checkpoint flags every RL script has."""
    p.add_argument("--save_last", type=str, default=None)
    p.add_argument("--save_best", type=str, default=None)
    p.add_argument("--optimize", action="store_true", default=False)
    return add_resume_args(p, every_help="episodes between full training-state checkpoints "
                                         "(0 = off)")


def _algo(name: str):
    """(train, make, actor of a training state) of one algorithm."""
    if name == "ddpg":
        from .control.rl.ddpg import make_ddpg, train

        return train, make_ddpg, lambda ts: ts.actor
    if name == "ppo":
        from .control.rl.ppo import make_ppo, train

        return train, make_ppo, lambda ts: ts.policy
    if name == "sac":
        from .control.rl.sac import make_sac, train

        return train, make_sac, lambda ts: ts.actor
    raise ValueError(name)


def _deterministic_action(algo: str, actor):
    """The evaluation policy: the mean action, no exploration noise."""
    if algo in ("ppo", "sac"):
        return lambda s: actor.sample(s[None], deterministic=True)[0][0]
    return lambda s: actor.sample(s[None])[0]


def run_rl(algo: str, args: dict, cfg: SimConfig, ctrl: ControlConfig, hp, device="cuda"):
    """Train (``--optimize``) or load the best weights, then evaluate the
    policy closed-loop on ``device`` and save the run under
    ``<algo>-control``."""
    tag = f"{algo}-control"
    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    ckpt_dir = os.path.join(args["save_file"], args["simcase"], tag)
    os.makedirs(ckpt_dir, exist_ok=True)
    best_path = args.get("save_best") or os.path.join(ckpt_dir, f"{algo}_best.msgpack")
    last_path = args.get("save_last") or os.path.join(ckpt_dir, f"{algo}_last.msgpack")
    train, make, actor_of = _algo(algo)

    history = None
    if args.get("optimize"):
        kw = dict(num_episodes=args.get("num_episode"), verbose=args.get("verbose", 10))
        # either flag alone turns the full training-state checkpoint on (a
        # bare --checkpoint_path resumes, at the default cadence of 10)
        if args.get("checkpoint_every") or args.get("checkpoint_path"):
            kw.update(ckpt_path=args.get("checkpoint_path") or os.path.join(ckpt_dir, "train_ckpt"),
                      ckpt_every=args.get("checkpoint_every") or 10,
                      resume=not args.get("no_resume"))
        if algo == "ddpg":
            kw.update(save_best=best_path)  # periodic persistence
        ts, best_params, history = train(cfg, ctrl, hp, grid, actuator, gen, **kw)
        actor = actor_of(ts)
        save_params(best_path, best_params)
        save_params(last_path, actor_params_to_numpy(actor))
        actor.load_state_dict(actor_params_from_numpy(best_params, actor))
    else:
        actor = actor_of(make(cfg, ctrl, hp, gen))
        if os.path.exists(best_path):
            load_params(best_path, like=actor)
            print(f"# loaded weights from {best_path}")
        else:
            print("# no trained weights found; evaluating the untrained policy "
                  "(pass --optimize to train)")

    # deterministic closed-loop evaluation from the seeded state
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    with torch.no_grad():
        out = policy_rollout(state, grid, cfg, actuator, _deterministic_action(algo, actor),
                             record_snapshots=True)
    save_rollout(tag, args, cfg, ctrl, out, device, history=history)


def save_rollout(tag: str, args: dict, cfg: SimConfig, ctrl: ControlConfig, out, device,
                 history=None) -> None:
    """Cost traces and the data dump of a ``policy_rollout`` with snapshots."""
    snapshot = torch.cat([out.xs.T, out.vs.T], dim=0)
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=out.coeffs, device=device)
    coeffs = out.coeffs.cpu().numpy()
    run_and_save(
        tag, args, cfg, ctrl, snapshot.cpu().numpy(), out.hamiltonian.cpu().numpy(),
        out.field_energy.cpu().numpy(), coeff_cos=coeffs[:, : ctrl.max_mode].T,
        coeff_sin=coeffs[:, ctrl.max_mode:].T, costs=costs, high_idx=high_indices(cfg),
        history=history,
    )
