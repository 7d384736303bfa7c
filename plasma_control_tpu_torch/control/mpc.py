"""Receding-horizon sampling MPC: the main path of the control loop.

The counterpart of :mod:`plasma_control_tpu.control.mpc`: the MPPI and CEM
solves, both plan models, multi-fidelity planning with the twin-corrected
cost, chunked candidate costs and knot, white or AR(1) candidate noise. One
control step:

1. reduce the plan model when ``plan_particles`` / ``plan_mesh`` ask for it
   (strided particle subsample, coarser plan grid and actuator);
2. with ``plan_correction="twin"`` and a subsampled plan state, the (H, Km)
   noise-correction targets of :func:`twin_targets`, once per solve (on CUDA
   tensors one launch of the twin trajectory kernel,
   :mod:`..ops.kernels.twin_trajectory`);
3. seed the candidate pool with the phase-conjugate feedback action
   (deposit, circulant solve, FFT) at the plan state;
4. sample K antithetic candidates around the nominal (knot-interpolated by
   default; ``smooth_noise > 0`` colours white noise AR(1) instead);
5. score all K x H candidate rollouts, in sequential chunks of
   ``plan_chunk`` when it is set. On CUDA tensors always through the
   hand-written kernels, whatever ``plan_kernel`` and ``deposit_method``
   say: the spectral model in one launch of the spectral horizon kernel per
   chunk (:mod:`..ops.kernels.spectral_horizon`; its twin-corrected variant
   with the targets of step 2); the grid model with
   ``plan_integrator="kdk"`` in one launch of the merged-kick horizon kernel,
   with ``"leapfrog"`` in H launches of the fused leapfrog step
   (:mod:`..ops.kernels.fused_step`), with ``"env"`` as a Yoshida-4 step
   batched over K through the CIC kernels. On CPU tensors the spectral
   model goes through the same wrappers, which run the kernels' plain
   versions (:mod:`..ops.spectral`); ``plan_kernel="auto"`` and ``"xla"``
   there take the trig drift of the JAX package's CPU scan. The grid model
   runs op by op (K as a batch dimension, a loop over H), as the JAX
   package's CPU ``"auto"`` does;
6. MPPI softmax update (or ``n_iters`` CEM refits on the ``n_elites``
   best, steps 4-5 repeated), then the fidelity guard: a reduced-fidelity
   solve whose plan-frame coherent signal is not ``fidelity_guard_ratio``
   times the subsample's injected noise applies no drive and resets the warm
   start (``torch.where`` on the device, no host sync);
7. apply the first action through one full PIC step, record the energies
   and shift the nominal.

JAX's ``vmap`` over candidates becomes a candidate batch dimension and its
``lax.scan`` over time a Python loop. Random draws come from a
``torch.Generator``; ``plan(noise=...)`` and ``mpc_rollout(step_noise=...)``
take the unit-variance draws instead, which is how the tests hand both
packages the same noise. With ``n_grad_iters > 0`` the solve's nominal is
then refined by Adam on the horizon cost, with gradients through the PIC
dynamics of the plan model (:func:`_gradient_refine`): autograd through the
``dense`` or ``scatter`` deposit, each step recomputed in the backward pass
(``torch.utils.checkpoint``). The JAX package cannot differentiate its
Pallas CIC kernels, and the CIC kernels here have no backward pass either:
``deposit_method="pallas"`` with refinement raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..config import ControlConfig, MPCConfig, SimConfig
from ..models.pic import PlasmaState, step
from ..models.rollout import _energies
from ..ops.deposit import deposit, gather, shape_weights_dense
from ..ops.fields import electric_energy, solve_e_mesh
from ..ops.grid import Grid, cached_grid
from ..ops.integrate import yoshida4_coefficients
from ..ops.kernels.fidelity_ratio import fidelity_ratio
from ..ops.kernels.fused_step import fused_leapfrog_step, fused_packed_horizon
from ..ops.kernels.spectral_horizon import spectral_horizon, use_rot
from ..ops.kernels.twin_trajectory import twin_trajectory
from ..ops.spectral import constants
from ..utils import trace
from .actuator import FourierActuator, make_actuator
from .feedback import feedback_coefficients
from .rl.optim import Adam

__all__ = ["MPCOutput", "candidate_costs", "knot_noise", "ar1_noise", "draw_noise", "solve_noise",
           "plan", "plan_fidelity_check", "twin_targets", "control_step_fn", "closed_loop",
           "mpc_rollout"]


class MPCOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T,) PE after each applied step
    kinetic: torch.Tensor  # (T,)
    hamiltonian: torch.Tensor  # (T,)
    coeffs: torch.Tensor  # (T, 2K) applied packed coefficients
    input_energy: torch.Tensor  # (T,)
    plan_cost: torch.Tensor  # (T,) best candidate cost at each solve
    final_mean: torch.Tensor  # (H, 2K) shifted nominal after the last solve


def _subsample(cfg: SimConfig, mpc: MPCConfig) -> tuple[int, int]:
    """(stride, n_eff) of the plan's particle subsample x[::stride]: stride
    N // plan_particles (1 without a reduction), n_eff = ceil(N / stride)."""
    n = cfg.n_particles
    if mpc.plan_particles is None or mpc.plan_particles >= n:
        return 1, n
    stride = max(1, n // mpc.plan_particles)
    return stride, -(-n // stride)


def _reduced_model(grid: Grid, cfg: SimConfig, mpc: MPCConfig, dtype=torch.float32):
    """Static half of the multi-fidelity reduction: (plan_grid, plan_cfg),
    the plan grid built on the device of ``grid``."""
    plan_cfg, plan_grid = cfg, grid
    stride, n_eff = _subsample(cfg, mpc)
    if stride > 1:
        plan_cfg = dataclasses.replace(plan_cfg, n_particles=n_eff)
    if mpc.plan_mesh is not None and mpc.plan_mesh < cfg.n_mesh:
        plan_cfg = dataclasses.replace(plan_cfg, n_mesh=mpc.plan_mesh)
        plan_grid = cached_grid(mpc.plan_mesh, cfg.length, dtype, grid.e_op.device)
    return plan_grid, plan_cfg


def _reduce_state(state: PlasmaState, cfg: SimConfig, mpc: MPCConfig) -> PlasmaState:
    """Dynamic half of the reduction: the strided particle subsample, which
    keeps the beam-ordering mixture proportions of the initial
    distributions."""
    stride = _subsample(cfg, mpc)[0]
    if stride > 1:
        return PlasmaState(state.x[::stride], state.v[::stride])
    return state


def _plan_model(state: PlasmaState, grid: Grid, cfg: SimConfig, mpc: MPCConfig):
    """Reduced planning model: (plan_state, plan_grid, plan_cfg)."""
    plan_grid, plan_cfg = _reduced_model(grid, cfg, mpc, state.x.dtype)
    return _reduce_state(state, cfg, mpc), plan_grid, plan_cfg


def _plan_frac(cfg: SimConfig, mpc: MPCConfig) -> float:
    """Actual planned-particle fraction n_eff/N of :func:`_subsample`, not
    plan_particles/N; 1.0 when the stride is 1."""
    return _subsample(cfg, mpc)[1] / cfg.n_particles


def _guard_terms(cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig):
    """(Km, frac, injected) of the fidelity guard: the plan model's modes,
    the plan's particle fraction and the sampling noise ``n0^2 (1 - frac)
    sum_m 1/k_m^2`` that the subsample injects into those modes."""
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    frac = _plan_frac(cfg, mpc)
    inv_k2 = constants(km, cfg.length, cfg.n0, cfg.n_particles)[2]
    return km, frac, cfg.n0**2 * (1.0 - frac) * sum(inv_k2)


def _fidelity_ratio(x: torch.Tensor, cfg: SimConfig, ctrl: ControlConfig,
                    mpc: MPCConfig) -> torch.Tensor:
    """On-device coherent-vs-injected-noise ratio of subsampled planning:
    the statistics of :func:`plan_fidelity_check`, one O(N Km) mode-sum pass
    over the full state, no host sync. On the card one launch of
    :func:`..ops.kernels.fidelity_ratio.fidelity_ratio`; on the CPU its plain
    version, op by op."""
    km, frac, injected = _guard_terms(cfg, ctrl, mpc)
    return fidelity_ratio(x, n_modes=km, length=cfg.length, n0=cfg.n0,
                          n_particles=cfg.n_particles, frac=frac, injected=max(injected, 1e-30))


def plan_fidelity_check(state: PlasmaState, cfg: SimConfig, ctrl: ControlConfig,
                        mpc: MPCConfig) -> dict:
    """Is subsampled planning (``mpc.plan_particles < N``) safe at this state?

    Subsampling n of N particles injects unscreened sampling noise of
    ``n0^2 (1 - n/N) / k_m^2`` per mode into the plan model; the full
    state's coherent modal energy (its modal PE less its own Poisson floor
    ``n0^2/k^2``) appears there attenuated by n/N. ``safe`` means that
    coherent part is at least ``mpc.fidelity_guard_ratio`` times the injected
    noise, the threshold of the per-solve guard. The JAX package's docstring
    gives the physics and the measurements behind it. Host numpy, one pass
    over the full state, in the JAX package's ops (the float32 positions'
    phases in float32); returns {"coherent_pe", "injected_noise_pe",
    "ratio", "safe"}.
    """
    n = cfg.n_particles
    km, frac, injected = _guard_terms(cfg, ctrl, mpc)
    k = np.array(constants(km, cfg.length, cfg.n0, n)[0])
    t = (2.0 * np.pi / cfg.length) * state.x.detach().reshape(-1).cpu().numpy()
    c = np.stack([np.sum(np.cos(m * t)) for m in range(1, km + 1)])
    s = np.stack([np.sum(np.sin(m * t)) for m in range(1, km + 1)])
    modal = (cfg.n0**2 / n) * (c * c + s * s) / (k * k)
    floor_full = cfg.n0**2 / (k * k)
    coherent = frac * float(np.sum(np.maximum(modal - floor_full, 0.0)))
    ratio = coherent / injected if injected > 0 else float("inf")
    return {
        "coherent_pe": coherent,
        "injected_noise_pe": injected,
        "ratio": ratio,
        "safe": ratio >= mpc.fidelity_guard_ratio,
    }


_PLAN_ACTS = {}


def _actuator_cache(length: float, n_mesh: int, max_mode: int, dtype, device):
    key = (float(length), n_mesh, max_mode, dtype, str(device))
    if key not in _PLAN_ACTS:
        _PLAN_ACTS[key] = make_actuator(length, n_mesh, max_mode, dtype=dtype, device=device)
    return _PLAN_ACTS[key]


def _pe_factor(plan_cfg: SimConfig, mpc: MPCConfig) -> float:
    """Scale-free plan-cost factor nref/n (1.0 at N = 5000)."""
    if mpc.cost_pe_nref is None:
        return 1.0
    return float(mpc.cost_pe_nref) / float(plan_cfg.n_particles)


def _reject_grid_pallas_kernel(plan_kernel: str) -> None:
    """``plan_kernel="fused"`` names the spectral horizon kernel. The JAX
    package refuses it for the grid plan model, and so does the port: there
    ``"auto"`` and ``"xla"`` apply, and on CUDA tensors both run the grid
    planner's own kernels."""
    if plan_kernel in ("fused", "packed"):
        raise ValueError(
            f"plan_kernel={plan_kernel!r} does not apply to plan_model='grid': use "
            "plan_kernel='auto' or 'xla' (on CUDA tensors the grid planner always runs "
            "its fused kernels), or plan_model='spectral' with plan_kernel='fused'"
        )


def _kernel_cfg(cfg: SimConfig, x: torch.Tensor) -> SimConfig:
    """On CUDA tensors the grid planner deposits and gathers through the CIC
    kernels whatever ``deposit_method`` says; on CPU tensors as configured."""
    return dataclasses.replace(cfg, deposit_method="pallas") if x.is_cuda else cfg


def _step_and_pe(
    state: PlasmaState,  # (K, N) candidate states
    e_ext: torch.Tensor,  # (K, M) drive fields, held over the step
    grid: Grid,
    cfg: SimConfig,
    exact: bool,
    plan_integrator: str = "env",
    plan_kernel: str = "auto",
):
    """One planning step of a candidate batch: returns (state, (K,) PE).

    ``"leapfrog"``: position-Verlet drift-kick-drift, one deposit + solve +
    gather per step; with ``exact=False`` the PE reuses the kick-stage field
    instead of re-solving at the post-step positions. On CUDA tensors this
    is one launch of the fused leapfrog kernel. ``"env"``: the environment's
    own step (exact PE), or with ``exact=False`` and Yoshida-4 the split whose
    PE reuses the last stage's field; on CUDA tensors its deposits and
    gathers run on the CIC kernels."""
    _reject_grid_pallas_kernel(plan_kernel)
    dt = cfg.clamped_dt()
    if plan_integrator == "leapfrog":
        if state.x.is_cuda:
            x, v, e_self = fused_leapfrog_step(
                state.x, state.v, e_ext, grid.e_op.T, n_mesh=grid.n_mesh, length=cfg.length,
                dt=dt, n0=cfg.n0, exact=exact, kind=cfg.interpol,
            )
            return PlasmaState(x, v), electric_energy(e_self, grid, cfg.n_particles)
        kw = dict(kind=cfg.interpol, method=cfg.deposit_method)
        x = state.x + 0.5 * dt * state.v
        e_self = solve_e_mesh(deposit(x, grid, n0=cfg.n0, **kw), grid, cfg.n0)
        v = state.v + dt * -gather(e_self + e_ext, x, grid, **kw)
        x = torch.remainder(x + 0.5 * dt * v, cfg.length)
        if exact:
            e_self = solve_e_mesh(deposit(x, grid, n0=cfg.n0, **kw), grid, cfg.n0)
        return PlasmaState(x, v), electric_energy(e_self, grid, cfg.n_particles)

    cfg = _kernel_cfg(cfg, state.x)
    if cfg.integrator != "yoshida4" or exact:
        new = step(state, grid, cfg, e_ext)
        pe, _ = _energies(new, grid, cfg)
        return new, pe
    kw = dict(kind=cfg.interpol, method=cfg.deposit_method)
    cs, ds = yoshida4_coefficients()
    x, v = state.x, state.v
    x = x + cs[0] * dt * v
    e_self = None
    for c, d in zip(cs[1:], ds):
        e_self = solve_e_mesh(deposit(x, grid, n0=cfg.n0, **kw), grid, cfg.n0)
        v = v + d * dt * -gather(e_self + e_ext, x, grid, **kw)
        x = x + c * dt * v
    pe = electric_energy(e_self, grid, cfg.n_particles)
    return PlasmaState(torch.remainder(x, cfg.length), v), pe


def _horizon_cost_kdk(
    state: PlasmaState,
    coeff_seqs: torch.Tensor,  # (K, H, 2K)
    grid: Grid,
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
) -> torch.Tensor:
    """Velocity-Verlet (kick-drift-kick) candidate costs, (K,).

    The two half-kicks that straddle each step boundary merge into one
    gather of ``2 E_self + u_t + u_{t+1}`` at the post-drift positions, so a
    step costs one deposit + solve + gather and its PE is exact (the JAX
    package's docstring derives it). On CUDA tensors the whole K x H block is
    one launch of the merged-kick horizon kernel. On CPU tensors it runs op
    by op, the candidates as a batch dimension; ``deposit_method="dense"``
    there shares one (K, N, M) weight tensor between deposit and gather, as
    the JAX package does."""
    dt = cfg.clamped_dt()
    e_ext_seq = actuator.compute_e_packed(coeff_seqs)  # (K, H, M)
    pe_f = _pe_factor(cfg, mpc)
    if state.x.is_cuda:
        half_e2dx = fused_packed_horizon(
            state.x, state.v, e_ext_seq, grid.e_op.T, n_mesh=grid.n_mesh, length=cfg.length,
            dt=dt, n0=cfg.n0, kind=cfg.interpol,
        )  # (K, H) 0.5 sum(E_self^2) dx; electric_energy's N/L rescale below
        pes = pe_f * (half_e2dx * (cfg.n_particles / cfg.length))
    else:
        # u_t + u_{t+1} at each boundary; the last is arbitrary (the final
        # merged kick changes no PE entering the cost)
        e_pair_seq = torch.cat([e_ext_seq[:, 1:], e_ext_seq[:, -1:]], dim=1) + e_ext_seq
        norm = cfg.n0 * cfg.length / cfg.n_particles / grid.dx
        kw = dict(kind=cfg.interpol, method=cfg.deposit_method)

        def fields_and_kick(x, e_add):
            """(E_self, scale -> -gather(scale E_self + e_add, x)), one weight
            evaluation."""
            if cfg.deposit_method == "dense":
                w = shape_weights_dense(torch.remainder(x, cfg.length), grid, cfg.interpol)
                e_self = solve_e_mesh(w.sum(-2) * norm, grid, cfg.n0)
                return e_self, lambda scale: -(w @ (scale * e_self + e_add)[..., None])[..., 0]
            e_self = solve_e_mesh(deposit(x, grid, n0=cfg.n0, **kw), grid, cfg.n0)
            return e_self, lambda scale: -gather(scale * e_self + e_add, x, grid, **kw)

        x = state.x.expand(coeff_seqs.shape[0], -1)
        _, kick0 = fields_and_kick(x, e_ext_seq[:, 0])
        vh = state.v + 0.5 * dt * kick0(1.0)
        pes = []
        for t in range(coeff_seqs.shape[1]):
            x = torch.remainder(x + dt * vh, cfg.length)
            e2, kick = fields_and_kick(x, e_pair_seq[:, t])
            vh = vh + 0.5 * dt * kick(2.0)
            pes.append(pe_f * electric_energy(e2, grid, cfg.n_particles))
        pes = torch.stack(pes, dim=-1)
    costs = mpc.w_field * pes + mpc.w_input * actuator.input_energy(coeff_seqs)
    return _finite_or_huge(_add_terminal(costs.sum(-1), pes, mpc))


def _horizon_cost_steps(
    state: PlasmaState,
    coeff_seqs: torch.Tensor,  # (K, H, 2K)
    grid: Grid,
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
) -> torch.Tensor:
    """Candidate costs of the grid model stepped by :func:`_step_and_pe`
    (``plan_integrator="env"`` or ``"leapfrog"``): the JAX package's per-step
    scan with the candidates as a batch dimension. (K,)."""
    k, h, _ = coeff_seqs.shape
    st = PlasmaState(state.x.expand(k, -1), state.v.expand(k, -1))
    pe_f = _pe_factor(cfg, mpc)
    costs, pes = [], []
    for t in range(h):
        u = coeff_seqs[:, t]
        st, pe = _step_and_pe(st, actuator.compute_e_packed(u), grid, cfg, mpc.exact_cost_energy,
                              mpc.plan_integrator, mpc.plan_kernel)
        pe = pe_f * pe
        costs.append(mpc.w_field * pe + mpc.w_input * actuator.input_energy(u))
        pes.append(pe)
    total = _add_terminal(torch.stack(costs, -1).sum(-1), torch.stack(pes, -1), mpc)
    return _finite_or_huge(total)


def _finite_or_huge(total: torch.Tensor) -> torch.Tensor:
    """Diverged candidates get an effectively infinite cost."""
    return torch.where(torch.isfinite(total), total, torch.full_like(total, 3.4e38))


def _add_terminal(total: torch.Tensor, pes: torch.Tensor, mpc: MPCConfig) -> torch.Tensor:
    """Add the terminal tail cost; ``pes`` is the (..., H) planning PE.

    ``"const"``: ``w_terminal * PE_H``. ``"growth"``: ``terminal_steps`` more
    steps of running field cost at the candidate's own end-of-horizon growth
    ratio ``r = PE_H / PE_{H-1}`` (clipped to [0.7, 1.3]). The two compose.
    """
    pe_h = pes[..., -1]
    if mpc.terminal_mode == "growth" and pes.shape[-1] >= 2:
        r = torch.clamp(pes[..., -1] / (pes[..., -2] + 1e-30), 0.7, 1.3)
        t = int(mpc.terminal_steps)
        # sum_{i=1..T} r^i, guarded at the removable r=1 singularity
        near_one = torch.abs(r - 1.0) < 1e-6
        geom = torch.where(
            near_one,
            torch.full_like(r, float(t)),
            r * (1.0 - r**t) / torch.where(torch.abs(1.0 - r) < 1e-6, torch.ones_like(r), 1.0 - r),
        )
        total = total + mpc.w_field * pe_h * geom
    if mpc.w_terminal:
        total = total + mpc.w_terminal * pe_h
    return total


def knot_noise(gen, n_candidates, horizon, dim, n_knots, dtype=torch.float32, device="cuda"):
    """(K, H, D) unit-variance noise linearly interpolated from ``n_knots``
    iid normal samples along the horizon, each step renormalized to unit
    marginal variance."""
    eps = torch.randn((n_candidates, n_knots, dim), generator=gen, dtype=dtype, device=device)
    t = torch.linspace(0.0, n_knots - 1.0, horizon, device=device)
    i0 = torch.clamp(torch.floor(t).long(), 0, max(n_knots - 2, 0))
    f = (t - i0)[None, :, None].to(dtype)
    out = (1.0 - f) * eps[:, i0] + f * eps[:, torch.clamp(i0 + 1, max=n_knots - 1)]
    return out / torch.sqrt((1.0 - f) ** 2 + f**2)


_AR1 = {}


def ar1_noise(eps: torch.Tensor, beta: float) -> torch.Tensor:
    """(K, H, D) white noise coloured AR(1) along the horizon:
    ``out_0 = eps_0``, ``out_t = beta out_{t-1} + sqrt(1 - beta^2) eps_t``, so
    every step keeps unit variance. ``beta <= 0`` returns ``eps``. The two
    coefficients are device tensors made at the first call for each beta,
    dtype and device, so that a captured step copies nothing from the host."""
    if beta <= 0.0:
        return eps
    key = (float(beta), eps.dtype, str(eps.device))
    if key not in _AR1:
        b = torch.tensor(beta, dtype=eps.dtype, device=eps.device)
        _AR1[key] = (b, torch.sqrt(1.0 - b**2))
    b, scale = _AR1[key]
    out = [eps[:, 0]]
    for t in range(1, eps.shape[1]):
        out.append(b * out[-1] + scale * eps[:, t])
    return torch.stack(out, dim=1)


def draw_noise(gen, mpc: MPCConfig, horizon: int, dim: int, dtype=torch.float32, device="cuda"):
    """(K, H, D) unit-variance candidate perturbations of one solve:
    knot-interpolated, or white coloured by :func:`ar1_noise` when
    ``smooth_noise > 0`` (an explicit AR(1) setting wins over the knot
    default) or ``n_knots`` is off or >= H; drawn for K/2 candidates and
    mirrored (eps, -eps) when ``antithetic``."""

    def base(n):
        if mpc.smooth_noise <= 0.0 and mpc.n_knots and 1 <= mpc.n_knots < horizon:
            return knot_noise(gen, n, horizon, dim, mpc.n_knots, dtype, device)
        eps = torch.randn((n, horizon, dim), generator=gen, dtype=dtype, device=device)
        return ar1_noise(eps, mpc.smooth_noise)

    k = mpc.n_candidates
    if mpc.antithetic and k >= 2:
        eps = base((k + 1) // 2)
        return torch.cat([eps, -eps])[:k]
    return base(k)


def twin_targets(full_x: torch.Tensor, plan_state: PlasmaState, plan_cfg: SimConfig,
                 full_cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig):
    """Noise-correction targets of subsampled spectral planning, or None.

    Returns ``(tc, ts)``, each (H, Km): the per-mode noise fraction
    ``rho_m = 1 - lambda_m`` times the mode-sum trajectory of the plan
    state's zero-drive twin (:func:`..ops.spectral.rollout` with no drive
    and the exact trig drift, the discretization of the candidate rollouts).
    ``lambda_m`` is the Wiener shrinkage of the
    subsample's mode phasor, estimated once per solve from the full state:
    with coherent power ``sig2_m = max(C_m^2 + S_m^2 - N, 0)``, subsample
    fraction r = n/N and subsample noise power n (1 - r),
    ``lambda_m = r^2 sig2_m / (r^2 sig2_m + n (1 - r))``. None at full
    fidelity or when ``mpc.plan_correction != "twin"``; the JAX package's
    docstring gives the derivation. On CUDA tensors one launch of the twin
    trajectory kernel computes both (:mod:`..ops.kernels.twin_trajectory`);
    on CPU tensors its plain version runs, op by op."""
    if mpc.plan_correction != "twin" or _plan_frac(full_cfg, mpc) >= 1.0:
        return None
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    return twin_trajectory(
        full_x.reshape(-1).to(plan_state.x.dtype), plan_state.x, plan_state.v, n_modes=km,
        horizon=mpc.horizon, length=plan_cfg.length, dt=plan_cfg.clamped_dt(), n0=plan_cfg.n0,
        n_full=full_cfg.n_particles, n_plan=plan_cfg.n_particles,
    )


def candidate_costs(state, coeff_seqs, grid, cfg, mpc, actuator, twin_target=None):
    """(K, H, 2K) candidates -> (K,) costs under the plan model.

    ``state``, ``grid``, ``cfg`` and ``actuator`` are the (possibly reduced)
    planning model; ``twin_target`` the optional (H, Km) targets of
    :func:`twin_targets` (spectral plan model only). CUDA tensors always go
    through the kernels: the spectral model through the spectral horizon
    kernel (its corrected variant with a target), the grid model through the
    fused grid kernels (``"kdk"``, ``"leapfrog"``) or the CIC kernels
    (``"env"``). No shape falls back to plain PyTorch on the card. On CPU
    tensors the spectral model runs the spectral horizon kernel's plain
    version, the grid model op by op.

    ``mpc.plan_chunk`` scores the candidates in sequential chunks of that
    size, one kernel launch each; the last chunk is padded with copies of
    candidate 0 whose costs are dropped, so every launch has the requested
    size."""
    if mpc.plan_chunk is not None and coeff_seqs.shape[0] > mpc.plan_chunk:
        k_total, chunk = coeff_seqs.shape[0], int(mpc.plan_chunk)
        k_pad = -(-k_total // chunk) * chunk
        if k_pad != k_total:
            pad = coeff_seqs[:1].expand(k_pad - k_total, *coeff_seqs.shape[1:])
            coeff_seqs = torch.cat([coeff_seqs, pad])
        inner = dataclasses.replace(mpc, plan_chunk=None)
        out = torch.cat([candidate_costs(state, c, grid, cfg, inner, actuator, twin_target)
                         for c in coeff_seqs.split(chunk)])
        return out[:k_total]
    if twin_target is not None and mpc.plan_model != "spectral":
        raise ValueError(
            "plan_correction='twin' requires plan_model='spectral': the grid planner has no "
            "per-mode phasor to correct"
        )
    if mpc.plan_model == "grid":
        _reject_grid_pallas_kernel(mpc.plan_kernel)
        with trace.span("plan.kernel"):
            if mpc.plan_integrator == "kdk":
                return _horizon_cost_kdk(state, coeff_seqs, grid, cfg, mpc, actuator)
            return _horizon_cost_steps(state, coeff_seqs, grid, cfg, mpc, actuator)
    ka = actuator.max_mode
    km = max(int(mpc.plan_modes), ka)
    # "xla" names the op-by-op scan, whose drift is trig, and so does "auto"
    # on the CPU, where the JAX package runs the scan; on the card "auto"
    # takes the configured drift
    drift = mpc.spectral_drift
    if mpc.plan_kernel == "xla" or (mpc.plan_kernel == "auto" and not state.x.is_cuda):
        drift = "trig"
    tc, ts = (None, None) if twin_target is None else twin_target
    with trace.span("plan.kernel"):
        pe = spectral_horizon(
            state.x, state.v, coeff_seqs[..., :ka], coeff_seqs[..., ka:], n_modes=km,
            length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
            rot=use_rot(cfg.clamped_dt(), cfg.length, drift), twin_c=tc, twin_s=ts,
        )  # (K, H) post-drift spectral-model PE, corrected with a target
    pe = _pe_factor(cfg, mpc) * pe
    ie = actuator.input_energy(coeff_seqs)  # (K, H)
    total = _add_terminal(torch.sum(mpc.w_field * pe + mpc.w_input * ie, dim=-1), pe, mpc)
    return _finite_or_huge(total)


def _plan_impl(state, mean, sigma, noise, grid, cfg, ctrl, mpc, actuator, twin_target=None,
               costs_fn=candidate_costs):
    """MPPI or CEM solve body over handed-in unit-variance noise: (K, H, D)
    for MPPI, (n_iters, K, H, D) for CEM. ``costs_fn`` scores a candidate
    block with :func:`candidate_costs`'s signature: that function itself, or
    its rank-sharded form (:func:`_shard_costs`)."""
    h, d = mean.shape
    fb_seq = None
    if mpc.seed_feedback and mpc.n_candidates >= 2:
        # phase-conjugate expert action at the current state, held over the horizon
        with trace.span("plan.seed"):
            dens = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol,
                           method=cfg.deposit_method)
            fa, fb = feedback_coefficients(solve_e_mesh(dens, grid, cfg.n0), ctrl.max_mode)
            fb_seq = torch.cat([fa, fb]).to(mean.dtype).expand(h, d)

    def costs_of(cand):
        with trace.span("plan.costs"):
            return costs_fn(state, cand, grid, cfg, mpc, actuator, twin_target)

    if mpc.algo == "mppi":
        cand = mean[None] + sigma * noise
        cand[0] = mean  # keep the nominal itself in the pool: never regress
        if fb_seq is not None:
            cand[1] = fb_seq
        cand = torch.clamp(cand, ctrl.coeff_min, ctrl.coeff_max)
        costs = costs_of(cand)
        with trace.span("plan.update"):
            best = torch.min(costs)
            w = torch.softmax(-(costs - best) / mpc.temperature, dim=0)
            mu = torch.einsum("k,khd->hd", w, cand)
    else:  # CEM: refit mean and spread to the n_elites cheapest, n_iters times
        mu = mean
        sd = torch.broadcast_to(torch.as_tensor(sigma, dtype=mean.dtype, device=mean.device),
                                (h, d))
        for eps in noise:
            cand = torch.clamp(mu[None] + sd * eps, ctrl.coeff_min, ctrl.coeff_max)
            cand[0] = mu
            if fb_seq is not None:
                cand[1] = torch.clamp(fb_seq, ctrl.coeff_min, ctrl.coeff_max)
            costs = costs_of(cand)
            with trace.span("plan.update"):
                elites = cand[torch.topk(-costs, mpc.n_elites).indices]
                mu = elites.mean(dim=0)
                sd = elites.std(dim=0, correction=0) + 1e-3
                best = torch.min(costs)
    if mpc.n_grad_iters > 0:
        mu = _gradient_refine(state, mu, grid, cfg, ctrl, mpc, actuator)
    return mu[0], mu, best


def _check_differentiable(cfg: SimConfig) -> None:
    if cfg.deposit_method == "pallas":
        raise ValueError(
            "gradient refinement (n_grad_iters > 0) differentiates the PIC step, and the CIC "
            "kernels (deposit_method='pallas') have no backward pass: use 'dense' or 'scatter'"
        )


def _refine_cost(u: torch.Tensor, state: PlasmaState, grid: Grid, cfg: SimConfig,
                 mpc: MPCConfig, actuator: FourierActuator) -> torch.Tensor:
    """Horizon cost of the (H, 2K) sequence ``u`` under the plan model's full
    PIC step, each step recomputed in the backward pass."""
    pe_f = _pe_factor(cfg, mpc)

    def one_step(x, v, e_ext):
        new = step(PlasmaState(x, v), grid, cfg, e_ext)
        return new.x, new.v

    st, costs, pes = state, [], []
    for ut in u:
        x, v = checkpoint(one_step, st.x, st.v, actuator.compute_e_packed(ut), use_reentrant=False)
        st = PlasmaState(x, v)
        pe = pe_f * _energies(st, grid, cfg)[0]
        costs.append(mpc.w_field * pe + mpc.w_input * actuator.input_energy(ut))
        pes.append(pe)
    return _add_terminal(torch.sum(torch.stack(costs)), torch.stack(pes), mpc)


def _gradient_refine(state, mean, grid, cfg, ctrl, mpc, actuator):
    """Local trajectory optimisation of the nominal: ``n_grad_iters`` Adam
    steps (``grad_lr``, no clip, optax's arithmetic) on the horizon cost,
    with gradients through the PIC dynamics; non-finite gradient entries are
    zeroed and each iterate is clipped to the coefficient bounds. The result
    replaces ``mean`` only if it lowers the cost."""
    _check_differentiable(cfg)
    opt = Adam([mean], mpc.grad_lr)
    u = mean.detach()
    for _ in range(mpc.n_grad_iters):
        leaf = u.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(_refine_cost(leaf, state, grid, cfg, mpc, actuator), leaf)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))  # divergence guard
        u = torch.clamp(u + opt.updates([g])[0], ctrl.coeff_min, ctrl.coeff_max)
    with torch.no_grad():
        better = (_refine_cost(u, state, grid, cfg, mpc, actuator)
                  < _refine_cost(mean, state, grid, cfg, mpc, actuator))
    return torch.where(better, u, mean)


def _apply_fidelity_guard(plan_out, full_x, full_cfg, ctrl, mpc):
    """Gate an (action, new_mean, best) solve on the fidelity ratio.

    A no-op at full fidelity (the stride keeps every particle) or with the
    guard off. Otherwise the applied action and the warm-start mean are
    zeroed whenever the coherent/injected ratio of the full state is below
    ``mpc.fidelity_guard_ratio``: an unsafe solve's mean encodes the
    cancellation of the subsample's noise phases and must not seed the next
    solve. ``torch.where`` on the device, no host sync."""
    if not (mpc.fidelity_guard and _plan_frac(full_cfg, mpc) < 1.0):
        return plan_out
    action, new_mean, best = plan_out
    safe = _fidelity_ratio(full_x, full_cfg, ctrl, mpc) >= mpc.fidelity_guard_ratio
    return (
        torch.where(safe, action, torch.zeros_like(action)),
        torch.where(safe, new_mean, torch.zeros_like(new_mean)),
        best,
    )


def _check_even(k: int, n_ranks: int, axis: str) -> None:
    if k % n_ranks:
        raise ValueError(f"n_candidates={k} must divide evenly over the {axis!r} mesh axis "
                         f"({n_ranks} ranks)")


def _shard_costs(candidate_sharding) -> Callable:
    """:func:`candidate_costs` with the candidate axis split over the ranks
    of a one-dimensional ``DeviceMesh``: each rank scores its K/R block,
    twin targets included, and the (K,) costs are all-gathered in rank
    order."""
    group = candidate_sharding.get_group()
    names = candidate_sharding.mesh_dim_names
    axis = names[0] if names else "mesh"
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)

    def sharded(state, coeff_seqs, grid, cfg, mpc, actuator, twin_target=None):
        k = coeff_seqs.shape[0]
        _check_even(k, n_ranks, axis)
        size = k // n_ranks
        local = candidate_costs(state, coeff_seqs[rank * size:(rank + 1) * size], grid, cfg,
                                mpc, actuator, twin_target).contiguous()
        blocks = [torch.empty_like(local) for _ in range(n_ranks)]
        dist.all_gather(blocks, local, group=group)
        return torch.cat(blocks)

    return sharded


def _broadcast_noise(noise: torch.Tensor, candidate_sharding) -> torch.Tensor:
    """A copy of ``noise`` holding the values of the mesh's first rank on
    every rank, so that all ranks score the same K candidates."""
    group = candidate_sharding.get_group()
    noise = noise.clone(memory_format=torch.contiguous_format)
    dist.broadcast(noise, src=dist.get_global_rank(group, 0), group=group)
    return noise


def solve_noise(generator: Optional[torch.Generator], mpc: MPCConfig,
                mean: torch.Tensor) -> torch.Tensor:
    """One solve's unit-variance draws from ``generator``: (K, H, D) for
    MPPI, (n_iters, K, H, D) for CEM."""
    if generator is None:
        raise ValueError("plan needs a torch.Generator or handed-in noise")
    h, d = mean.shape
    draws = [draw_noise(generator, mpc, h, d, mean.dtype, mean.device)
             for _ in range(1 if mpc.algo == "mppi" else mpc.n_iters)]
    return draws[0] if mpc.algo == "mppi" else torch.stack(draws)


def plan(
    state: PlasmaState,
    mean: torch.Tensor,  # (H, 2K) warm-started nominal sequence
    sigma,  # scalar or (H, 2K) sampling stddev
    generator: Optional[torch.Generator],
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    noise: Optional[torch.Tensor] = None,
    candidate_sharding=None,
):
    """One MPC solve. Returns (first_action, new_mean, best_cost).

    ``state``, ``grid``, ``cfg`` and ``actuator`` are the full environment
    model; the candidates are scored on the reduced plan model when
    ``plan_particles`` / ``plan_mesh`` ask for it (with the twin-corrected
    cost under ``plan_correction="twin"``), and the fidelity guard then gates
    the result. ``noise``: optional unit-variance perturbations (antithetic
    pairs included) in place of draws from ``generator``: (K, H, 2K) for
    MPPI, (n_iters, K, H, 2K) for CEM.

    ``candidate_sharding``: a one-dimensional ``DeviceMesh`` (e.g.
    ``mesh["rollout"]`` of :func:`..parallel.mesh.make_mesh`), the
    counterpart of the JAX package's ``NamedSharding`` over a ``"rollout"``
    axis. Every rank of it calls ``plan`` alike; the noise is broadcast from
    its first rank, each rank scores its K/R block of candidates with
    :func:`candidate_costs` and the (K,) costs are gathered
    (:func:`_shard_costs`), so every rank returns the same solve. The JAX
    package refuses its forced Pallas kernels on this path (GSPMD cannot
    partition them); here every kernel runs on each rank's block, so
    nothing is refused."""
    if mpc.n_grad_iters > 0:
        _check_differentiable(cfg)
    if mean.shape[-1] != 2 * actuator.max_mode:
        raise ValueError(
            f"coefficient/actuator mode mismatch: the nominal carries "
            f"{mean.shape[-1] // 2} modes but the actuator was built with "
            f"max_mode={actuator.max_mode}"
        )
    with trace.span("plan"):
        if noise is None:
            with trace.span("plan.noise"):
                noise = solve_noise(generator, mpc, mean)
        costs_fn = candidate_costs
        if candidate_sharding is not None:
            noise = _broadcast_noise(noise, candidate_sharding)
            costs_fn = _shard_costs(candidate_sharding)
        full_x, full_cfg = state.x, cfg
        with trace.span("plan.model"):
            state, grid, cfg = _plan_model(state, grid, cfg, mpc)
            if actuator.n_mesh != grid.n_mesh:
                actuator = _actuator_cache(cfg.length, grid.n_mesh, actuator.max_mode,
                                           mean.dtype, mean.device)
        # noise-floor correction of subsampled planning, once per solve
        with trace.span("plan.twin_targets"):
            target = twin_targets(full_x, state, cfg, full_cfg, ctrl, mpc)
        out = _plan_impl(state, mean, sigma, noise, grid, cfg, ctrl, mpc, actuator, target,
                         costs_fn)
        with trace.span("plan.guard"):
            return _apply_fidelity_guard(out, full_x, full_cfg, ctrl, mpc)


def control_step_fn(grid: Grid, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
                    actuator: FourierActuator, candidate_sharding=None) -> Callable:
    """The closed-loop control step with the configuration closed over:
    ``(x, v, mean, generator=None, noise=None) -> (x', v', mean', action,
    pe, ke, ie, best)``. It solves from ``mean`` (``noise``, the unit draws,
    in place of the generator's), applies the first action through one full
    PIC step, records the energies after it and the action's input energy,
    and shifts the nominal. ``candidate_sharding`` goes to :func:`plan`; the
    environment step runs in full on every rank.
    :func:`mpc_rollout` is :func:`closed_loop` over it."""
    sigma = torch.tensor(mpc.sigma0, dtype=grid.e_op.dtype, device=grid.e_op.device)

    def ctrl_step(x, v, mean, generator=None, noise=None):
        with trace.span("control_step"):
            state = PlasmaState(x, v)
            action, new_mean, best = plan(state, mean, sigma, generator, grid, cfg, ctrl, mpc,
                                          actuator, noise=noise,
                                          candidate_sharding=candidate_sharding)
            with trace.span("env_step"):
                state = step(state, grid, cfg, actuator.compute_e_packed(action))
            with trace.span("energies"):
                pe, ke = _energies(state, grid, cfg)
            # receding horizon: shift, repeat last
            shifted = torch.cat([new_mean[1:], new_mean[-1:]])
            return state.x, state.v, shifted, action, pe, ke, actuator.input_energy(action), best

    return ctrl_step


def closed_loop(ctrl_step: Callable, state: PlasmaState, mean: torch.Tensor,
                generator: Optional[torch.Generator], n_steps: int,
                step_noise: Optional[torch.Tensor] = None) -> MPCOutput:
    """The host loop of receding-horizon control over a control step (as
    :func:`control_step_fn` returns): ``n_steps`` steps from ``state`` and
    the nominal ``mean``, each with the generator's draws or
    ``step_noise[i]``."""
    x, v = state
    cols = []
    for i in range(n_steps):
        trace.next_step()
        noise = None if step_noise is None else step_noise[i]
        x, v, mean, action, pe, ke, ie, best = ctrl_step(x, v, mean, generator, noise)
        cols.append((pe, ke, action, ie, best))
    pe, ke, coeffs, ie, best = (torch.stack(col) for col in zip(*cols))
    return MPCOutput(
        final_state=PlasmaState(x, v),
        field_energy=pe,
        kinetic=ke,
        hamiltonian=pe + ke,
        coeffs=coeffs,
        input_energy=ie,
        plan_cost=best,
        final_mean=mean,
    )


def mpc_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    generator: Optional[torch.Generator] = None,
    n_steps: Optional[int] = None,
    mean0: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    candidate_sharding=None,
) -> MPCOutput:
    """Closed-loop receding-horizon control for ``n_steps`` env steps.

    Each step solves, applies the first action through one full PIC step
    and shifts the nominal (:func:`control_step_fn`). ``step_noise`` (T, K,
    H, 2K), or (T, n_iters, K, H, 2K) for CEM, overrides the per-solve draws
    (the counterpart of JAX's ``step_keys``). ``candidate_sharding`` splits
    every solve's candidates over the ranks of a one-dimensional mesh
    (:func:`plan`)."""
    t_steps = step_noise.shape[0] if step_noise is not None else (
        n_steps if n_steps is not None else cfg.n_steps
    )
    mean = mean0 if mean0 is not None else torch.zeros(
        (mpc.horizon, 2 * ctrl.max_mode), dtype=state.x.dtype, device=state.x.device
    )
    step = control_step_fn(grid, cfg, ctrl, mpc, actuator,
                           candidate_sharding=candidate_sharding)
    return closed_loop(step, state, mean, generator, t_steps, step_noise)
