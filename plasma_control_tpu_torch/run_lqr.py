"""Data-driven control on the GPU: Hankel-DMDc identification + LQR.

    python -m plasma_control_tpu_torch.run_lqr --simcase two-stream \\
        --max_mode 3 --is_save

The port's counterpart of the repo's ``run_lqr.py``, with the same flags and
artifacts: identify a linear time-delay model of the Fourier-mode dynamics
from excitation rollouts (generator seeded ``seed + 7``), run the LQR policy
closed loop from the seeded state, replay the applied drive with snapshots,
and write the cost traces and the run data (``--is_save``).
"""

from __future__ import annotations

import torch

from .cli import (add_control_args, base_parser, build_control_config, build_sim_config,
                  compute_cost_traces, high_indices, run_and_save)
from .control.actuator import make_actuator
from .control.sysid import identify_lqr_controller, lqr_rollout
from .models.pic import init_state
from .models.rollout import rollout, snapshot_from_rollout
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_control_args(base_parser("PIC simulation with identified-model LQR E-field control"))
    p.add_argument("--n_lags", type=int, default=6)
    p.add_argument("--n_excite_rollouts", type=int, default=6)
    p.add_argument("--excite_steps", type=int, default=150)
    p.add_argument("--excite_amplitude", type=float, default=0.15)
    p.add_argument("--q_weight", type=float, default=1.0)
    p.add_argument("--r_weight", type=float, default=0.5)
    args = vars(p.parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    gain, info = identify_lqr_controller(
        grid, actuator, cfg, ctrl, torch.Generator(device=device).manual_seed(cfg.seed + 7),
        n_lags=args["n_lags"], n_rollouts=args["n_excite_rollouts"],
        excite_steps=args["excite_steps"], amplitude=args["excite_amplitude"],
        q_weight=args["q_weight"], r_weight=args["r_weight"],
    )
    print(f"# identified model: residual {info['residual']:.4f}, spectral radius "
          f"{info['spectral_radius']:.4f}")

    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    out = lqr_rollout(state, gain, grid, actuator, cfg, ctrl, n_lags=args["n_lags"],
                      n_steps=cfg.n_steps)
    # re-play the applied drive to collect snapshots
    replay = rollout(state, grid, cfg, e_external_traj=actuator.compute_e_packed(out.coeffs),
                     record_snapshots=True)
    snapshot = snapshot_from_rollout(replay)
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=out.coeffs, device=device)
    coeffs = out.coeffs.cpu().numpy()

    run_and_save(
        "lqr-control", args, cfg, ctrl, snapshot.cpu().numpy(), replay.hamiltonian.cpu().numpy(),
        replay.field_energy.cpu().numpy(), coeff_cos=coeffs[:, : ctrl.max_mode].T,
        coeff_sin=coeffs[:, ctrl.max_mode:].T, costs=costs, high_idx=high_indices(cfg),
        device=device,
    )


if __name__ == "__main__":
    main()
