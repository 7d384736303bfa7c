"""Closed-loop FFT phase-conjugate feedback control on the GPU.

    python -m plasma_control_tpu_torch.run_feedback --simcase two-stream \\
        --max_mode 3 --is_save

The port's counterpart of the repo's ``run_feedback.py``, with the same
flags and artifacts: the law a_n = -Re Ek_n, b_n = +Im Ek_n closed around
the PIC step (:func:`..control.feedback.feedback_rollout`) with snapshots,
then the cost traces and the run data (``--is_save``). ``--checkpoint_every
S`` runs the loop in resumable segments of S steps
(:func:`.io.resume.resumable_feedback_rollout`), checkpointed into
``--checkpoint_path`` (default ``checkpoints/<simcase>-feedback``) and
resumed from there unless ``--no_resume``.
"""

from __future__ import annotations

import numpy as np
import torch

from .cli import (add_control_args, add_resume_args, base_parser, build_control_config,
                  build_sim_config, compute_cost_traces, high_indices, run_and_save)
from .control.actuator import make_actuator
from .control.feedback import feedback_rollout
from .models.pic import init_state
from .ops.grid import make_grid


def main(argv=None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run on ``device``."""
    p = add_resume_args(add_control_args(base_parser(
        "PIC simulation with feedback E-field control (Fourier transform)")))
    args = vars(p.parse_args(argv))
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)

    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                             endpoint_grid=ctrl.endpoint_grid, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(cfg.seed), device=device)
    if args["checkpoint_every"]:
        from .io.resume import resumable_feedback_rollout

        _, tr = resumable_feedback_rollout(
            state, grid, cfg, ctrl, actuator,
            ckpt_path=args["checkpoint_path"] or f"checkpoints/{args['simcase']}-feedback",
            segment_steps=args["checkpoint_every"], resume=not args["no_resume"],
        )
    else:
        fb = feedback_rollout(state, grid, cfg, ctrl, actuator, record_snapshots=True)
        tr = {k: getattr(fb, k).cpu().numpy()
              for k in ("xs", "vs", "field_energy", "kinetic", "coeff_cos", "coeff_sin")}

    snapshot = np.concatenate([tr["xs"].T, tr["vs"].T], axis=0)
    coeff_cos = tr["coeff_cos"].T  # (K, T), the reference's stacking
    coeff_sin = tr["coeff_sin"].T
    coeffs = np.concatenate([coeff_cos, coeff_sin], axis=0).T  # (T, 2K)
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=coeffs, device=device)

    run_and_save(
        "feedback", args, cfg, ctrl, snapshot, tr["field_energy"] + tr["kinetic"],
        tr["field_energy"], coeff_cos=coeff_cos, coeff_sin=coeff_sin, costs=costs,
        high_idx=high_indices(cfg), device=device,
    )


if __name__ == "__main__":
    main()
