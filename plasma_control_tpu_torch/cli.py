"""Command-line machinery of the port's run scripts.

The counterpart of :mod:`plasma_control_tpu.cli` for the port's entry points
(``run_wo_oc``, ``run_feedback``, ``run_mpc``, ``run_lqr``, and through
:mod:`.cli_rl` ``run_ddpg``, ``run_ppo``, ``run_sac``): the same flags,
defaults and choices (``base_parser``, ``add_control_args``,
``add_mpc_args``, and the segmented-resume flags), the same
functions that build the configs, the cost traces, and ``run_and_save``'s
data dump and plot set (:mod:`.viz.plots`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from .config import ControlConfig, MPCConfig, SimConfig

__all__ = ["base_parser", "add_control_args", "add_mpc_args", "add_resume_args", "build_sim_config",
           "build_control_config", "build_mpc_config", "compute_cost_traces", "high_indices",
           "run_and_save"]


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--simcase", type=str, default="two-stream",
                   choices=["two-stream", "bump-on-tail", "landau"])
    p.add_argument("--interpol", type=str, default="CIC", choices=["CIC", "TSC"])
    p.add_argument("--gamma", type=float, default=5.0,
                   help="kept for reference-CLI parity; the spectral solve needs no gamma")
    p.add_argument("--save_file", type=str, default="./dataset/")
    p.add_argument("--save_plot", type=str, default="./result/")
    p.add_argument("--is_save", action="store_true", default=False)
    p.add_argument("--num_particle", type=int, default=5000)
    p.add_argument("--num_mesh", type=int, default=250)
    p.add_argument("--t_min", type=float, default=0.0)
    p.add_argument("--t_max", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--L", type=float, default=50.0)
    p.add_argument("--n0", type=float, default=1.0)
    p.add_argument("--vb", type=float, default=3.0)
    p.add_argument("--vth", type=float, default=1.0)
    p.add_argument("--A", type=float, default=0.1)
    p.add_argument("--n_mode", type=int, default=2)
    p.add_argument("--a", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deposit_method", type=str, default="dense", choices=["dense", "scatter"])
    return p


def add_control_args(p: argparse.ArgumentParser, max_mode: int = 3, coeff: float = 1.0):
    p.add_argument("--max_mode", type=int, default=max_mode)
    p.add_argument("--coeff_max", type=float, default=coeff)
    p.add_argument("--coeff_min", type=float, default=-coeff)
    return p


def add_mpc_args(p: argparse.ArgumentParser):
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--n_candidates", type=int, default=512)
    p.add_argument("--n_elites", type=int, default=64)
    p.add_argument("--n_iters", type=int, default=2)
    p.add_argument("--sigma0", type=float, default=0.3)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--w_field", type=float, default=1.0)
    p.add_argument("--w_input", type=float, default=0.05)
    p.add_argument("--algo", type=str, default="mppi", choices=["mppi", "cem"])
    p.add_argument("--plan_particles", type=int, default=0, help="0 = full fidelity")
    p.add_argument("--plan_chunk", type=int, default=0,
                   help="score candidates in sequential chunks of this size, one kernel "
                        "launch each (0 = one batch)")
    p.add_argument("--plan_mesh", type=int, default=0, help="0 = full fidelity")
    p.add_argument("--smooth_noise", type=float, default=0.0,
                   help="AR(1) beta for temporally correlated candidate noise (0 = white)")
    p.add_argument("--n_knots", type=int, default=3,
                   help="sample candidate noise at N knots and interpolate over the "
                        "horizon (0 = off/white); an explicit --smooth_noise > 0 wins")
    p.add_argument("--plan_integrator", type=str, default="kdk",
                   choices=["env", "leapfrog", "kdk"],
                   help="candidate-rollout integrator; applied steps always use Yoshida-4")
    p.add_argument("--plan_kernel", type=str, default="auto",
                   choices=["auto", "xla", "fused"],
                   help="spectral planning path on CPU tensors: 'fused' = the spectral "
                        "horizon kernel's plain version, 'xla'/'auto' = the op-by-op scan; "
                        "CUDA tensors always run the hand-written kernel")
    p.add_argument("--plan_model", type=str, default="spectral",
                   choices=["spectral", "grid"],
                   help="candidate-rollout dynamics: gridless low-mode spectral (default) "
                        "or the mesh PIC at plan fidelity")
    p.add_argument("--plan_modes", type=int, default=16,
                   help="Fourier modes kept by the spectral planning model "
                        "(at least max_mode is always used)")
    p.add_argument("--w_terminal", type=float, default=0.0,
                   help="terminal tail-cost weight on the final-step planning field "
                        "energy. 0 = off")
    p.add_argument("--spectral_drift", type=str, default=None,
                   choices=["trig", "rot", "auto"],
                   help="drift variant inside the spectral horizon kernel; default auto = "
                        "the phasor-rotation drift where its angle bound holds, else trig")
    p.add_argument("--terminal_mode", type=str, default="const",
                   choices=["const", "growth"],
                   help="terminal tail estimator: 'const' = flat --w_terminal weight; "
                        "'growth' = --terminal_steps more running-cost steps at the "
                        "candidate's own end-of-horizon PE growth ratio")
    p.add_argument("--terminal_steps", type=int, default=4,
                   help="tail length of the 'growth' extrapolation in planning steps")
    p.add_argument("--no_antithetic", action="store_true",
                   help="disable mirrored-pair (antithetic) candidate sampling")
    p.add_argument("--plan_correction", type=str, default="none",
                   choices=["none", "twin"],
                   help="noise-floor correction for SUBSAMPLED planning: 'twin' scores "
                        "each candidate's mode phasors against a zero-drive twin of the "
                        "plan subsample shrunk by the full-state coherence per mode "
                        "(MPCConfig.plan_correction); spectral plan model only")
    p.add_argument("--cost_pe_nref", type=float, default=5000.0,
                   help="scale-free plan cost: multiply the planning field energy by "
                        "this / n_plan_particles (0 = raw plan PE)")
    return p


def add_resume_args(p: argparse.ArgumentParser,
                    every_help: str = "steps between full-state checkpoints (0 = off)"):
    """The JAX scripts' segmented-resume flags (:mod:`.io.resume`)."""
    p.add_argument("--checkpoint_every", type=int, default=0, help=every_help)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--no_resume", action="store_true", help="ignore an existing checkpoint")
    return p


def build_sim_config(args: dict) -> SimConfig:
    return SimConfig(
        simcase=args["simcase"],
        n_particles=args["num_particle"],
        n_mesh=args["num_mesh"],
        t_min=args["t_min"],
        t_max=args["t_max"],
        dt=args["dt"],
        length=args["L"],
        n0=args["n0"],
        vb=args["vb"],
        vth=args["vth"],
        perturb_amplitude=args["A"],
        perturb_mode=args["n_mode"],
        bump_a=args["a"],
        interpol=args["interpol"].lower(),
        deposit_method=args["deposit_method"],
        seed=args["seed"],
    )


def build_control_config(args: dict) -> ControlConfig:
    return ControlConfig(
        max_mode=args.get("max_mode", 3),
        coeff_min=args.get("coeff_min", -1.0),
        coeff_max=args.get("coeff_max", 1.0),
        reward_n_mesh=args["num_mesh"],
    )


def build_mpc_config(args: dict) -> MPCConfig:
    return MPCConfig(
        horizon=args["horizon"],
        n_candidates=args["n_candidates"],
        n_elites=args["n_elites"],
        n_iters=args["n_iters"],
        sigma0=args["sigma0"],
        temperature=args["temperature"],
        w_field=args["w_field"],
        w_input=args["w_input"],
        algo=args["algo"],
        plan_particles=args["plan_particles"] or None,
        plan_mesh=args["plan_mesh"] or None,
        plan_chunk=args.get("plan_chunk", 0) or None,
        smooth_noise=args.get("smooth_noise", 0.0),
        n_knots=args.get("n_knots", 0) or None,
        plan_integrator=args.get("plan_integrator", "kdk"),
        plan_kernel=args.get("plan_kernel", "auto"),
        plan_model=args.get("plan_model", "spectral"),
        plan_modes=args.get("plan_modes", 16),
        w_terminal=args.get("w_terminal", 0.0),
        terminal_mode=args.get("terminal_mode", "const"),
        spectral_drift=args.get("spectral_drift"),
        terminal_steps=args.get("terminal_steps", 4),
        antithetic=not args.get("no_antithetic", False),
        plan_correction=args.get("plan_correction", "none"),
        cost_pe_nref=args.get("cost_pe_nref", 5000.0) or None,
    )


def compute_cost_traces(snapshot, cfg: SimConfig, ctrl: ControlConfig, coeffs=None,
                        device="cuda") -> dict:
    """Per-step J_KL / J_ee (and J_ie with ``coeffs``) traces of a (2N, T+1)
    snapshot (array or tensor), evaluated on ``device`` over the post-step
    states (columns 1..T) one state at a time: a (T, N, M) dense weight
    tensor does not fit at N=100000."""
    from .control.reward import Reward

    snap = torch.as_tensor(snapshot, dtype=torch.float32, device=device)
    reward = Reward(snap[:, 0], ctrl.reward_n_mesh, cfg.length, ctrl.vmin, ctrl.vmax, cfg.n0)
    states = snap[:, 1:].T.contiguous()  # (T, 2N)
    j_kl = torch.stack([reward.compute_kl_divergence(s) for s in states])
    j_ee = torch.stack([reward.compute_electric_energy(s) for s in states])
    costs = {r"$J_{KL}$": j_kl.cpu().numpy(), r"$J_{ee}$": j_ee.cpu().numpy()}
    if coeffs is not None:
        actions = torch.as_tensor(coeffs, dtype=torch.float32, device=device)
        costs[r"$J_{ie}$"] = torch.stack([reward.compute_input_energy(a) for a in actions]).cpu().numpy()
    return costs


def high_indices(cfg: SimConfig) -> Optional[np.ndarray]:
    """The bump-on-tail beam's particle indices (the plots mark them), else
    None."""
    if cfg.simcase != "bump-on-tail":
        return None
    from .models.distributions import make_distribution

    return make_distribution(cfg).high_indices().numpy()


def run_and_save(
    tag: str,
    args: dict,
    cfg: SimConfig,
    ctrl: Optional[ControlConfig],
    snapshot,
    energy,
    field_energy,
    coeff_cos=None,
    coeff_sin=None,
    costs=None,
    high_idx=None,
    history=None,
    device="cuda",
):
    """Dump one run's data (``data.mat`` and ``data.npz`` under
    ``<save_file>/<simcase>/<tag>/``) when ``--is_save`` is set, and draw the
    JAX package's plot set into ``<save_plot>/<simcase>/<tag>/`` (``high_idx``
    marks the bump-on-tail beam; the field plots re-solve E on ``device``). A
    trainer's per-episode loss and reward ``history`` also goes into the data
    as the ``history`` group.

    Where matplotlib cannot be imported (the GPU machine has none), the data
    are still written and a line says that the plots were not drawn. That is
    a missing plotting library, not a device fallback: nothing of the run
    moves off ``device``."""
    from .io.export import build_run_dict, save_mat, save_npz
    from .viz import plots as P

    filepath = os.path.join(args["save_file"], args["simcase"], tag)
    savepath = os.path.join(args["save_plot"], args["simcase"], tag)
    snapshot = np.asarray(snapshot)
    mdic = build_run_dict(cfg, snapshot, np.asarray(energy), np.asarray(field_energy),
                          coeff_cos, coeff_sin, costs)
    if history is not None:
        mdic["history"] = {k: np.asarray(v) for k, v in history.items()}
    if args.get("is_save"):
        save_mat(os.path.join(filepath, "data.mat"), mdic)
        save_npz(os.path.join(filepath, "data.npz"), mdic)
        print(f"# saved data: {filepath} (data.mat, data.npz)")
    if not P.matplotlib_available():
        print(f"# plots for {savepath} are not drawn: matplotlib is not installed")
        return

    nt = snapshot.shape[1] - 1
    dx = cfg.length / cfg.n_mesh
    if costs and nt > 0:
        # a resumed run's data covers its own steps, without the state before
        # the first: its J_ie trace is one entry longer than the others. Every
        # trace ends at the last step, so each is drawn over its last nt
        P.plot_cost_over_time(cfg.t_max, nt, {k: np.asarray(v)[-nt:] for k, v in costs.items()},
                              savepath, "cost.pdf")
    P.plot_log_e(cfg.t_max, cfg.length, dx, cfg.n_mesh, snapshot, savepath, "log_E.pdf",
                 device=device)
    P.plot_e_k_spectrum(cfg.t_max, cfg.length, dx, cfg.n_mesh, snapshot, savepath,
                        "Ek_spectrum.pdf", device=device)
    P.plot_e_k_over_time(cfg.t_max, cfg.length, dx, cfg.n_mesh, 5, snapshot, savepath,
                         "Ek_t.pdf", device=device)
    if coeff_cos is not None:
        P.plot_e_k_external_over_time(cfg.t_max, coeff_cos, coeff_sin, savepath,
                                      "Ek_t_external.pdf")
    if args["simcase"] == "bump-on-tail":
        P.plot_bump_on_tail_evolution(snapshot, savepath, "phase_space_evolution.pdf", 0,
                                      cfg.length, -10.0, 10.0, high_idx)
    else:  # two-stream and landau: plain phase-space scatter
        P.plot_two_stream_evolution(snapshot, savepath, "phase_space_evolution.pdf", 0,
                                    cfg.length, -10.0, 10.0)
    P.plot_x_dist_evolution(snapshot, savepath, "x_dist.pdf", 0, cfg.length, cfg.n_mesh)
    P.plot_v_dist_evolution(snapshot, savepath, "v_dist.pdf", -10.0, 10.0, cfg.n_mesh)
    print(f"# saved plots: {savepath}")
