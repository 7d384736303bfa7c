"""Uncontrolled Vlasov-Poisson PIC rollout on the GPU.

    python -m plasma_control_tpu_torch.run_wo_oc --simcase two-stream \\
        --num_particle 5000 --is_save

The port's counterpart of the repo's ``run_wo_oc.py``, with the same flags:
build the config, the grid and the seeded initial state on the card, run the
rollout with snapshots, and write the cost traces and the run data
(``--is_save``). ``--checkpoint_every S`` runs it in resumable segments of S
steps (:func:`.io.resume.resumable_rollout`), checkpointed into
``--checkpoint_path`` (default ``checkpoints/<simcase>-wo-oc``) and resumed
from there unless ``--no_resume``; a resumed run saves the steps it ran.
"""

from __future__ import annotations

import torch

import numpy as np

from .cli import (add_resume_args, base_parser, build_control_config, build_sim_config,
                  compute_cost_traces, high_indices, run_and_save)
from .models.pic import init_state
from .models.rollout import rollout, snapshot_from_rollout
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_resume_args(base_parser(
        "Vlasov-Poisson plasma kinetic simulation without E-field control"))
    args = vars(p.parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    if args["checkpoint_every"]:
        from .io.resume import resumable_rollout

        _, pe, ke, xs, vs = resumable_rollout(
            state, grid, cfg,
            ckpt_path=args["checkpoint_path"] or f"checkpoints/{args['simcase']}-wo-oc",
            segment_steps=args["checkpoint_every"], resume=not args["no_resume"],
        )
        snapshot, hamiltonian = np.concatenate([xs.T, vs.T], axis=0), pe + ke
    else:
        out = rollout(state, grid, cfg, record_snapshots=True)
        snapshot = snapshot_from_rollout(out).cpu().numpy()
        hamiltonian, pe = out.hamiltonian.cpu().numpy(), out.field_energy.cpu().numpy()
    costs = compute_cost_traces(snapshot, cfg, ctrl, device=device)

    run_and_save("wo-oc", args, cfg, ctrl, snapshot, hamiltonian, pe, costs=costs,
                 high_idx=high_indices(cfg))


if __name__ == "__main__":
    main()
