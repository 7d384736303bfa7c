"""Uncontrolled Vlasov-Poisson PIC rollout on the GPU.

    python -m plasma_control_tpu_torch.run_wo_oc --simcase two-stream \\
        --num_particle 5000 --is_save

The port's counterpart of the repo's ``run_wo_oc.py``, with the same flags:
build the config, the grid and the seeded initial state on the card, run the
rollout with snapshots, and write the cost traces and the run data
(``--is_save``). The resume flags (``--checkpoint_every``,
``--checkpoint_path``, ``--no_resume``) parse as in the JAX package and
raise ``NotImplementedError``: the ``io/resume`` slice is not ported yet.
"""

from __future__ import annotations

import torch

from .cli import (add_resume_args, base_parser, build_control_config, build_sim_config,
                  compute_cost_traces, high_indices, reject_resume, run_and_save)
from .models.pic import init_state
from .models.rollout import rollout, snapshot_from_rollout
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_resume_args(base_parser(
        "Vlasov-Poisson plasma kinetic simulation without E-field control"))
    args = vars(p.parse_args(argv))
    reject_resume(args)
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    out = rollout(state, grid, cfg, record_snapshots=True)
    snapshot = snapshot_from_rollout(out)
    costs = compute_cost_traces(snapshot, cfg, ctrl, device=device)

    run_and_save(
        "wo-oc", args, cfg, ctrl, snapshot.cpu().numpy(), out.hamiltonian.cpu().numpy(),
        out.field_energy.cpu().numpy(), costs=costs, high_idx=high_indices(cfg),
    )


if __name__ == "__main__":
    main()
