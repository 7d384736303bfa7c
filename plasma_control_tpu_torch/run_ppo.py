"""PPO training and evaluation on the GPU.

    python -m plasma_control_tpu_torch.run_ppo --simcase two-stream --optimize \\
        --num_episode 200

The port's counterpart of the repo's ``run_ppo.py``, with the same flags and
defaults (its dt default is 0.05): see :mod:`.cli_rl`.
"""

from __future__ import annotations

from .cli import add_control_args, base_parser, build_control_config, build_sim_config
from .cli_rl import add_rl_args, run_rl
from .control.rl.ppo import PPOConfig


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_control_args(base_parser("RL-based optimal control: PPO"), max_mode=3, coeff=1.0)
    p.set_defaults(dt=0.05)
    p.add_argument("--mlp_dim", type=int, default=32)
    p.add_argument("--r", type=float, default=0.995)
    p.add_argument("--std", type=float, default=0.5)
    p.add_argument("--capacity", type=int, default=8)
    p.add_argument("--eps_clip", type=float, default=0.25)
    p.add_argument("--entropy_coeff", type=float, default=0.01)
    p.add_argument("--value_coeff", type=float, default=0.20)
    p.add_argument("--num_episode", type=int, default=200)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--k_epoch", type=int, default=4)
    p.add_argument("--alpha", type=float, default=0.10)
    p.add_argument("--beta", type=float, default=0.00)
    p.add_argument("--reward_shape", type=str, default="reference", choices=["reference", "shaped"],
                   help="training reward: reference parity, or the scale-free shaped variant")
    args = vars(add_rl_args(p).parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    hp = PPOConfig(
        mlp_dim=args["mlp_dim"], lr=args["lr"], gamma=args["r"], std_init=args["std"],
        chunk_size=args["capacity"], eps_clip=args["eps_clip"],
        entropy_coeff=args["entropy_coeff"], value_coeff=args["value_coeff"],
        k_epoch=args["k_epoch"], num_episodes=args["num_episode"],
        output_min=args["coeff_min"], output_max=args["coeff_max"], alpha=args["alpha"],
        beta=args["beta"], reward_shape=args["reward_shape"],
    )
    run_rl("ppo", args, cfg, ctrl, hp, device=device)


if __name__ == "__main__":
    main()
