"""Amortised-MPC learned controller on the GPU: DAgger-distil the sampling
MPC planner into a one-forward-pass actor, or load a committed actor, then
evaluate it closed-loop with the standard data dump.

    # evaluate the committed weights (artifacts/dagger_actor_<simcase>.msgpack)
    python -m plasma_control_tpu_torch.run_dagger --simcase two-stream --is_save
    # train at the target scale and save the actor weights
    python -m plasma_control_tpu_torch.run_dagger --simcase two-stream --optimize \\
        --actor_path artifacts/dagger_actor_two_stream.msgpack

The port's counterpart of the repo's ``run_dagger.py``, with the same flags
and defaults. ``--optimize`` runs :func:`.control.rl.dagger.dagger_train`
with the MPC expert (one launch of the spectral horizon kernel per expert
solve on the card) from a generator seeded ``seed + 7`` and writes the
actor in flax's msgpack layout; otherwise ``--actor_path`` is loaded by the
port's own reader. The evaluation starts from the state seeded ``seed``,
prints the tail field energy (mean of the last fifth) and writes
``data.mat`` / ``data.npz`` (``--is_save``).
"""

from __future__ import annotations

import os

import torch

from .cli import (add_control_args, add_mpc_args, base_parser, build_control_config,
                  build_mpc_config, build_sim_config)
from .cli_rl import save_rollout
from .control.actuator import make_actuator
from .control.evaluate import policy_rollout
from .control.rl.dagger import dagger_train
from .control.rl.ddpg import DDPGConfig, make_actor
from .interop import actor_params_from_numpy
from .io.checkpoint import load_params, save_params
from .models.pic import init_state
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_mpc_args(add_control_args(base_parser(
        "Learned control by amortized MPC: DAgger distillation of the sampling planner")))
    p.add_argument("--optimize", action="store_true", help="train (else load --actor_path)")
    p.add_argument("--actor_path", type=str, default=None,
                   help="msgpack weights path (load for eval; save after --optimize)")
    p.add_argument("--encoder", type=str, default="spectral",
                   choices=["spectral", "deepsets", "attention"],
                   help="actor state encoder (spectral moments; deepsets; attention: "
                        "mode-token transformer over the spectral moments)")
    p.add_argument("--encoder_modes", type=int, default=8)
    p.add_argument("--encoder_v_order", type=int, default=1,
                   help="velocity-moment order of the spectral encoder "
                        "(1: density+current; 2: +pressure; 3: +heat flux)")
    p.add_argument("--mlp_dim", type=int, default=64)
    p.add_argument("--dagger_iters", type=int, default=6)
    p.add_argument("--epochs_per_iter", type=int, default=400)
    args = vars(p.parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    mpc = build_mpc_config(args)
    hp = DDPGConfig(encoder=args["encoder"], encoder_modes=args["encoder_modes"],
                    encoder_v_order=args["encoder_v_order"], mlp_dim=args["mlp_dim"],
                    output_min=ctrl.coeff_min, output_max=ctrl.coeff_max)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    actor_path = args["actor_path"] or os.path.join(
        "artifacts", f"dagger_actor_{args['simcase'].replace('-', '_')}.msgpack")
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)

    if args["optimize"]:
        actor, params, hist = dagger_train(
            cfg, ctrl, hp, grid, actuator, gen, n_iters=args["dagger_iters"],
            epochs_per_iter=args["epochs_per_iter"], mpc=mpc)
        actor.load_state_dict(actor_params_from_numpy(params, actor))
        save_params(actor_path, params)
        print(f"# saved actor weights: {actor_path}")
        print(f"# per-iteration closed-loop tail PE: {[round(v, 1) for v in hist['pe_tail']]}")
    else:
        actor = make_actor(cfg, ctrl, hp, gen)
        if os.path.exists(actor_path):
            load_params(actor_path, like=actor)
            print(f"# loaded actor weights: {actor_path}")
        else:
            print(f"# WARNING: {actor_path} not found; evaluating an UNTRAINED actor "
                  "(pass --optimize to train)")

    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    with torch.no_grad():
        out = policy_rollout(state, grid, cfg, actuator, lambda s: actor.sample(s[None])[0],
                             record_snapshots=True)
    pe = out.field_energy
    print(f"# closed-loop tail field energy (last 20%): "
          f"{float(pe[-max(1, pe.shape[0] // 5):].mean()):.2f}")
    save_rollout("dagger-control", args, cfg, ctrl, out, device)


if __name__ == "__main__":
    main()
