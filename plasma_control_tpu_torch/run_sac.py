"""SAC training and evaluation on the GPU.

    python -m plasma_control_tpu_torch.run_sac --simcase bump-on-tail --optimize \\
        --num_episode 1000

The port's counterpart of the repo's ``run_sac.py``, with the same flags and
defaults (N=10000, N_mesh=500, max_mode=5): see :mod:`.cli_rl`.
"""

from __future__ import annotations

from .cli import add_control_args, base_parser, build_control_config, build_sim_config
from .cli_rl import add_rl_args, run_rl
from .control.rl.sac import SACConfig


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_control_args(base_parser("RL-based optimal control: SAC"), max_mode=5, coeff=1.0)
    p.set_defaults(num_particle=10000, num_mesh=500)
    p.add_argument("--mlp_dim", type=int, default=32)
    p.add_argument("--r", type=float, default=0.995)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--capacity", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_episode", type=int, default=1000)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--reward_shape", type=str, default="reference", choices=["reference", "shaped"],
                   help="training reward: reference parity, or the scale-free shaped variant")
    args = vars(add_rl_args(p).parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    hp = SACConfig(
        mlp_dim=args["mlp_dim"], lr=args["lr"], gamma=args["r"], tau=args["tau"],
        capacity=args["capacity"], batch_size=args["batch_size"],
        num_episodes=args["num_episode"], output_min=args["coeff_min"],
        output_max=args["coeff_max"], alpha=args["alpha"], reward_shape=args["reward_shape"],
    )
    run_rl("sac", args, cfg, ctrl, hp, device=device)


if __name__ == "__main__":
    main()
