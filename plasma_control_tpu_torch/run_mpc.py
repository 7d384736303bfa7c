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

``--checkpoint_every S`` runs the loop in resumable segments of S steps
(:func:`.io.resume.resumable_mpc_rollout`), checkpointed into
``--checkpoint_path`` (default ``checkpoints/<simcase>-mpc``) and resumed
from there unless ``--no_resume``; the replay then takes the applied
coefficients of the whole run, the interrupted part included.
``--save_aot PATH`` writes the control-step artifact of these flags and
exits: a ``.pkl`` path the compiled one (the kernel library inside),
anything else the portable JSON (:mod:`.io.aot`). ``--aot PATH`` runs the
closed loop as a host loop over that artifact's step, one CUDA graph replay
per control step on the card (eagerly when the caller asks for the CPU);
the artifact must describe these flags' step.
"""

from __future__ import annotations

import time

import torch

from .cli import (
    add_control_args,
    add_mpc_args,
    add_resume_args,
    base_parser,
    build_control_config,
    build_mpc_config,
    build_sim_config,
    compute_cost_traces,
    high_indices,
    run_and_save,
)
from .control.actuator import make_actuator
from .control.mpc import _plan_frac, mpc_rollout, plan_fidelity_check
from .models.pic import init_state
from .models.rollout import rollout, snapshot_from_rollout
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_resume_args(add_mpc_args(add_control_args(base_parser(
        "PIC simulation with receding-horizon MPC E-field control"))),
        every_help="env steps between full controller-state checkpoints (0 = off)")
    p.add_argument("--aot", type=str, default=None, metavar="ARTIFACT",
                   help="run the closed loop through a saved control-step artifact "
                        "(io/aot.py: portable JSON from export_plan(kind='control_step'), or "
                        ".pkl from save_compiled_plan), one CUDA graph replay per control "
                        "step. The artifact must describe these flags' step.")
    p.add_argument("--save_aot", type=str, default=None, metavar="PATH",
                   help="build and save the control-step artifact for this configuration "
                        "and exit (.pkl -> compiled, with the kernel library; else portable "
                        "JSON)")
    args = vars(p.parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    mpc = build_mpc_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)

    if args["save_aot"]:
        from .io.aot import export_plan, save_compiled_plan

        t0 = time.perf_counter()
        if args["save_aot"].endswith(".pkl"):
            save_compiled_plan(args["save_aot"], grid, cfg, ctrl, mpc, actuator,
                               kind="control_step")
        else:
            export_plan(grid, cfg, ctrl, mpc, actuator, path=args["save_aot"],
                        kind="control_step")
        print(f"# AOT control-step artifact written to {args['save_aot']} "
              f"({time.perf_counter() - t0:.1f}s)")
        return

    if args["aot"] and args["checkpoint_every"]:
        raise SystemExit("--aot runs a host loop over a fixed artifact; use the "
                         "traced path for --checkpoint_every segmented resume")

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

    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    if args["aot"]:
        from .io.aot import aot_mpc_rollout, check_plan, load_compiled_plan, load_plan

        t0 = time.perf_counter()
        loader = load_compiled_plan if args["aot"].endswith(".pkl") else load_plan
        ctrl_step = loader(args["aot"], device=device)
        check_plan(ctrl_step, cfg, ctrl, mpc)
        print(f"# AOT artifact loaded in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        coeffs = aot_mpc_rollout(ctrl_step, state, generator, cfg.n_steps, mpc.horizon,
                                 ctrl.n_actions).coeffs
        if coeffs.is_cuda:
            torch.cuda.synchronize(coeffs.device)
        print(f"# {cfg.n_steps} control steps through the artifact in "
              f"{time.perf_counter() - t0:.2f}s (the first captures the step on the card)")
    elif args["checkpoint_every"]:
        from .io.resume import resumable_mpc_rollout

        _, traces = resumable_mpc_rollout(
            state, grid, cfg, ctrl, mpc, actuator, generator,
            ckpt_path=args["checkpoint_path"] or f"checkpoints/{args['simcase']}-mpc",
            segment_steps=args["checkpoint_every"], resume=not args["no_resume"],
        )
        coeffs = torch.from_numpy(traces["coeffs_full"]).to(device)
    else:
        coeffs = mpc_rollout(state, grid, cfg, ctrl, mpc, actuator, generator).coeffs  # (T, 2K)

    # re-play the recorded control sequence to collect snapshots
    replay = rollout(state, grid, cfg, e_external_traj=actuator.compute_e_packed(coeffs),
                     record_snapshots=True)
    snapshot = snapshot_from_rollout(replay)
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=coeffs, device=device)
    coeffs = coeffs.cpu().numpy()
    coeff_cos = coeffs[:, : ctrl.max_mode].T
    coeff_sin = coeffs[:, ctrl.max_mode:].T

    run_and_save(
        "mpc-control", args, cfg, ctrl, snapshot.cpu().numpy(), replay.hamiltonian.cpu().numpy(),
        replay.field_energy.cpu().numpy(), coeff_cos=coeff_cos, coeff_sin=coeff_sin,
        costs=costs, high_idx=high_indices(cfg),
    )


if __name__ == "__main__":
    main()
