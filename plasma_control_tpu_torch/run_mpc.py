"""Receding-horizon sampling MPC control of the PIC plasma on the GPU.

    python -m plasma_control_tpu_torch.run_mpc --simcase two-stream \\
        --num_particle 100000 --num_mesh 256 --max_mode 8 --n_candidates 1024 \\
        --plan_particles 10000 --plan_mesh 64 --plan_correction twin --is_save

The port's counterpart of the repo's ``run_mpc.py``, with the same flags:
build the configs, make the grid, the actuator and the seeded initial state
on the card, run the closed loop (:func:`..control.mpc.mpc_rollout`), replay
the applied drive with snapshots, and write the cost traces and the run data
(``--is_save``). ``--plan_particles`` without ``--plan_correction twin``
warns at t=0 when the plan subsample's noise floor rivals the coherent field.
``--aot``, ``--save_aot`` and the resume flags (``--checkpoint_every``,
``--checkpoint_path``, ``--no_resume``) parse as in the JAX package and raise
``NotImplementedError``: the ``io/aot`` and ``io/resume`` slices are not
ported yet.
"""

from __future__ import annotations

import torch

from .cli import (
    add_control_args,
    add_mpc_args,
    base_parser,
    build_control_config,
    build_mpc_config,
    build_sim_config,
    compute_cost_traces,
    run_and_save,
)
from .control.actuator import make_actuator
from .control.mpc import _plan_frac, mpc_rollout, plan_fidelity_check
from .models.distributions import make_distribution
from .models.pic import init_state
from .models.rollout import rollout, snapshot_from_rollout
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_mpc_args(add_control_args(base_parser(
        "PIC simulation with receding-horizon MPC E-field control")))
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="env steps between full controller-state checkpoints (0 = off); "
                        "not ported yet (io/resume)")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--no_resume", action="store_true", help="ignore an existing checkpoint")
    p.add_argument("--aot", type=str, default=None, metavar="ARTIFACT",
                   help="run the closed loop through a saved control-step artifact; not "
                        "ported yet (io/aot)")
    p.add_argument("--save_aot", type=str, default=None, metavar="PATH",
                   help="build and save the control-step artifact, then exit; not ported "
                        "yet (io/aot)")
    args = vars(p.parse_args(argv))
    if args["aot"] or args["save_aot"]:
        raise NotImplementedError("--aot / --save_aot: the control-step artifact slice "
                                  "(io/aot) is not ported to PyTorch yet")
    if args["checkpoint_every"] or args["checkpoint_path"] or args["no_resume"]:
        raise NotImplementedError("--checkpoint_every / --checkpoint_path / --no_resume: "
                                  "segmented resume (io/resume) is not ported to PyTorch yet")
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    mpc = build_mpc_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)

    if _plan_frac(cfg, mpc) < 1.0 and mpc.plan_correction == "none":
        # with --plan_correction twin the subsampled cost is noise-corrected
        # and this warning does not apply
        chk = plan_fidelity_check(state, cfg, ctrl, mpc)
        if not chk["safe"]:
            guard_msg = (
                "the on-device fidelity guard (MPCConfig.fidelity_guard, on by default) will "
                "hold the drive OFF until the coherent signal clears the floor"
                if mpc.fidelity_guard
                else "the guard is DISABLED: the planner can 'cancel' noise that does not "
                "exist in the real plasma and pump it instead of damping"
            )
            print(
                f"# WARNING: --plan_particles {mpc.plan_particles} injects a plan-model "
                f"noise floor ({chk['injected_noise_pe']:.1f}) comparable to the coherent "
                f"field energy ({chk['coherent_pe']:.1f}, ratio {chk['ratio']:.2f} < "
                f"{mpc.fidelity_guard_ratio:g}) at t=0; {guard_msg}. Plan at full fidelity "
                "(drop --plan_particles) for quiet/saturated plasmas."
            )

    out = mpc_rollout(state, grid, cfg, ctrl, mpc, actuator,
                      torch.Generator(device=device).manual_seed(cfg.seed + 1))
    coeffs = out.coeffs  # (T, 2K)

    # re-play the recorded control sequence to collect snapshots
    replay = rollout(state, grid, cfg, e_external_traj=actuator.compute_e_packed(coeffs),
                     record_snapshots=True)
    snapshot = snapshot_from_rollout(replay)
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=coeffs, device=device)
    coeffs = coeffs.cpu().numpy()
    coeff_cos = coeffs[:, : ctrl.max_mode].T
    coeff_sin = coeffs[:, ctrl.max_mode:].T

    high_idx = None
    if cfg.simcase == "bump-on-tail":
        high_idx = make_distribution(cfg).high_indices().numpy()

    run_and_save(
        "mpc-control", args, cfg, ctrl, snapshot.cpu().numpy(), replay.hamiltonian.cpu().numpy(),
        replay.field_energy.cpu().numpy(), coeff_cos=coeff_cos, coeff_sin=coeff_sin,
        costs=costs, high_idx=high_idx,
    )


if __name__ == "__main__":
    main()
