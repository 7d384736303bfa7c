"""DDPG (TD3+BC) training and evaluation on the GPU.

    python -m plasma_control_tpu_torch.run_ddpg --simcase two-stream --optimize \\
        --num_episode 500

The port's counterpart of the repo's ``run_ddpg.py``, with the same flags
and defaults (:mod:`.cli_rl`): train with ``--optimize`` (offline BC, then
online episodes), or load ``<algo>_best.msgpack``; then a deterministic
closed-loop evaluation and the run data (``--is_save``).
"""

from __future__ import annotations

from .cli import add_control_args, base_parser, build_control_config, build_sim_config
from .cli_rl import add_rl_args, run_rl
from .control.rl.ddpg import DDPGConfig


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_control_args(base_parser("RL-based optimal control: DDPG"), max_mode=3, coeff=1.25)
    p.add_argument("--update_freq", type=int, default=10)
    p.add_argument("--mlp_dim", type=int, default=64)
    p.add_argument("--r", type=float, default=0.995)
    p.add_argument("--tau", type=float, default=0.005)
    p.add_argument("--capacity", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--num_episode", type=int, default=500)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--noise_scale", type=float, default=0.1)
    p.add_argument("--mu", type=float, default=0.0)
    p.add_argument("--theta", type=float, default=0.15)
    p.add_argument("--sigma", type=float, default=0.20)
    p.add_argument("--alpha", type=float, default=0.100)
    p.add_argument("--beta", type=float, default=0.100)
    p.add_argument("--min_buffer_size", type=int, default=10000)
    p.add_argument("--reward_shape", type=str, default="reference", choices=["reference", "shaped"],
                   help="training reward: reference parity, or the scale-free shaped variant")
    p.add_argument("--encoder", type=str, default="deepsets", choices=["deepsets", "spectral"],
                   help="actor/critic state encoder: the reference's DeepSets ParticleEncoder, "
                        "or spectral phase-space moments (DDPGConfig.encoder)")
    args = vars(add_rl_args(p).parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    hp = DDPGConfig(
        mlp_dim=args["mlp_dim"], lr=args["lr"], gamma=args["r"], tau=args["tau"],
        capacity=args["capacity"], batch_size=args["batch_size"],
        update_freq=args["update_freq"], min_buffer_size=args["min_buffer_size"],
        num_episodes=args["num_episode"], noise_scale=args["noise_scale"], ou_mu=args["mu"],
        ou_theta=args["theta"], ou_sigma=args["sigma"], output_min=args["coeff_min"],
        output_max=args["coeff_max"], alpha=args["alpha"], beta=args["beta"],
        reward_shape=args["reward_shape"], encoder=args["encoder"],
    )
    run_rl("ddpg", args, cfg, ctrl, hp, device=device)


if __name__ == "__main__":
    main()
