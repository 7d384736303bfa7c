"""Receding-horizon sampling MPC: the main path of the control loop.

The counterpart of :mod:`plasma_control_tpu.control.mpc` for the MPPI solve
with the gridless spectral plan model at full fidelity. One control step:

1. seed the candidate pool with the phase-conjugate feedback action
   (deposit, circulant solve, FFT);
2. sample K knot-interpolated antithetic candidates around the nominal;
3. score all K x H candidate rollouts: on CUDA tensors always in one launch
   of the spectral horizon kernel (:mod:`..ops.kernels.spectral_horizon`),
   which raises for shapes beyond its limits; on CPU tensors
   ``plan_kernel="fused"`` takes the kernel's plain version and ``"auto"`` /
   ``"xla"`` the op-by-op scan :func:`_horizon_cost_spectral`, as the JAX
   package's CPU ``"auto"`` does;
4. MPPI softmax update;
5. apply the first action through one full PIC step, record the energies
   and shift the nominal.

JAX's ``vmap`` over candidates becomes a candidate batch dimension and its
``lax.scan`` over time a Python loop. Random draws come from a
``torch.Generator``; ``plan(noise=...)`` and ``mpc_rollout(step_noise=...)``
take the unit-variance draws instead, which is how the tests hand both
packages the same noise. Settings off this path raise ``NotImplementedError``
(:func:`_check_supported`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import ControlConfig, MPCConfig, SimConfig
from ..models.pic import PlasmaState, step
from ..models.rollout import _energies
from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid
from ..ops.kernels.spectral_horizon import spectral_horizon, use_rot
from .actuator import FourierActuator
from .feedback import feedback_coefficients

__all__ = ["MPCOutput", "candidate_costs", "knot_noise", "draw_noise", "plan", "mpc_rollout"]


class MPCOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: torch.Tensor  # (T,) PE after each applied step
    kinetic: torch.Tensor  # (T,)
    hamiltonian: torch.Tensor  # (T,)
    coeffs: torch.Tensor  # (T, 2K) applied packed coefficients
    input_energy: torch.Tensor  # (T,)
    plan_cost: torch.Tensor  # (T,) best candidate cost at each solve
    final_mean: torch.Tensor  # (H, 2K) shifted nominal after the last solve


def _check_supported(cfg: SimConfig, mpc: MPCConfig) -> None:
    """Raise for the MPC settings this port does not run yet."""
    reduced = (mpc.plan_particles is not None and mpc.plan_particles < cfg.n_particles) or (
        mpc.plan_mesh is not None and mpc.plan_mesh < cfg.n_mesh
    )
    unsupported = {
        "algo='cem'": mpc.algo != "mppi",
        "plan_model='grid'": mpc.plan_model != "spectral",
        "reduced-fidelity planning (plan_particles / plan_mesh)": reduced,
        "gradient refinement (n_grad_iters > 0)": mpc.n_grad_iters > 0,
        "chunked candidate costs (plan_chunk)": mpc.plan_chunk is not None,
        "AR(1) candidate noise (smooth_noise > 0)": mpc.smooth_noise > 0.0,
    }
    for what, hit in unsupported.items():
        if hit:
            raise NotImplementedError(f"MPC with {what} is not ported to PyTorch yet")


def _pe_factor(plan_cfg: SimConfig, mpc: MPCConfig) -> float:
    """Scale-free plan-cost factor nref/n (1.0 at N = 5000)."""
    if mpc.cost_pe_nref is None:
        return 1.0
    return float(mpc.cost_pe_nref) / float(plan_cfg.n_particles)


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


def knot_noise(gen, n_candidates, horizon, dim, n_knots, dtype=torch.float32, device="cpu"):
    """(K, H, D) unit-variance noise linearly interpolated from ``n_knots``
    iid normal samples along the horizon, each step renormalized to unit
    marginal variance."""
    eps = torch.randn((n_candidates, n_knots, dim), generator=gen, dtype=dtype, device=device)
    t = torch.linspace(0.0, n_knots - 1.0, horizon, device=device)
    i0 = torch.clamp(torch.floor(t).long(), 0, max(n_knots - 2, 0))
    f = (t - i0)[None, :, None].to(dtype)
    out = (1.0 - f) * eps[:, i0] + f * eps[:, torch.clamp(i0 + 1, max=n_knots - 1)]
    return out / torch.sqrt((1.0 - f) ** 2 + f**2)


def draw_noise(gen, mpc: MPCConfig, horizon: int, dim: int, dtype=torch.float32, device="cpu"):
    """(K, H, D) unit-variance candidate perturbations of one solve:
    knot-interpolated (white when ``n_knots`` is off or >= H), drawn for
    K/2 candidates and mirrored (eps, -eps) when ``antithetic``."""

    def base(n):
        if mpc.n_knots and 1 <= mpc.n_knots < horizon:
            return knot_noise(gen, n, horizon, dim, mpc.n_knots, dtype, device)
        return torch.randn((n, horizon, dim), generator=gen, dtype=dtype, device=device)

    k = mpc.n_candidates
    if mpc.antithetic and k >= 2:
        eps = base((k + 1) // 2)
        return torch.cat([eps, -eps])[:k]
    return base(k)


def _mode_sums(c1: torch.Tensor, s1: torch.Tensor, n_modes: int):
    """(..., Km) mode sums c_m = sum_p cos(k_m x_p), s_m = sum_p sin(k_m x_p)
    by the three-term recurrence from the base harmonic."""
    twoc = c1 + c1
    cs, ss = [c1.sum(-1)], [s1.sum(-1)]
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for _ in range(n_modes - 1):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        cs.append(c_prev.sum(-1))
        ss.append(s_prev.sum(-1))
    return torch.stack(cs, dim=-1), torch.stack(ss, dim=-1)


def _mode_eval(c1: torch.Tensor, s1: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor):
    """sum_m pc[m] cos(k_m x_p) + ps[m] sin(k_m x_p) per particle."""
    twoc = c1 + c1
    acc = pc[..., 0:1] * c1 + ps[..., 0:1] * s1
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for m in range(1, pc.shape[-1]):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        acc = acc + pc[..., m : m + 1] * c_prev + ps[..., m : m + 1] * s_prev
    return acc


def _pad_modes(u_half: torch.Tensor, km: int) -> torch.Tensor:
    """(..., ka) -> (..., km) zero padding of the actuator's coefficients."""
    return F.pad(u_half, (0, km - u_half.shape[-1]))


def _horizon_cost_spectral(
    state: PlasmaState,
    coeff_seqs: torch.Tensor,  # (..., H, 2K)
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
) -> torch.Tensor:
    """Gridless low-mode spectral rollout cost of a batch of candidates, op
    by op (the JAX package's per-candidate scan with the candidates as a
    batch dimension): the same staggered KDK with merged half-kicks, the
    same initial un-merged half-kick and post-drift PE as the kernel, with
    the per-mode constants in float32 as there. Returns (...,) costs."""
    n_p = cfg.n_particles
    ka = actuator.max_mode
    km = max(int(mpc.plan_modes), ka)
    dt = cfg.clamped_dt()
    x, dtype = state.x, state.x.dtype
    two_pi_over_l = 2.0 * math.pi / cfg.length
    k = two_pi_over_l * torch.arange(1, km + 1, dtype=dtype, device=x.device)
    g = 2.0 * cfg.n0 / (n_p * k)
    inv_k2 = 1.0 / (k * k)
    pe_scale = cfg.n0**2 / n_p * _pe_factor(cfg, mpc)

    u_c = _pad_modes(coeff_seqs[..., :ka], km)
    u_s = _pad_modes(coeff_seqs[..., ka:], km)
    pair_c = torch.cat([u_c[..., 1:, :], u_c[..., -1:, :]], dim=-2) + u_c
    pair_s = torch.cat([u_s[..., 1:, :], u_s[..., -1:, :]], dim=-2) + u_s

    # initial (un-merged) half-kick at the current positions
    t0 = two_pi_over_l * x
    c1_0, s1_0 = torch.cos(t0), torch.sin(t0)
    c0, s0 = _mode_sums(c1_0, s1_0, km)
    pc0 = g * s0 + u_c[..., 0, :]
    ps0 = -(g * c0) + u_s[..., 0, :]
    vh = state.v + 0.5 * dt * (-_mode_eval(c1_0, s1_0, pc0, ps0))

    costs, pes = [], []
    for t in range(coeff_seqs.shape[-2]):
        x = torch.remainder(x + dt * vh, cfg.length)
        ang = two_pi_over_l * x
        c1, s1 = torch.cos(ang), torch.sin(ang)
        c, s = _mode_sums(c1, s1, km)
        pc = 2.0 * (g * s) + pair_c[..., t, :]
        ps = 2.0 * (-g * c) + pair_s[..., t, :]
        vh = vh + 0.5 * dt * (-_mode_eval(c1, s1, pc, ps))
        pe = pe_scale * torch.sum((c * c + s * s) * inv_k2, dim=-1)
        costs.append(mpc.w_field * pe + mpc.w_input * actuator.input_energy(coeff_seqs[..., t, :]))
        pes.append(pe)
    total = _add_terminal(torch.stack(costs, -1).sum(-1), torch.stack(pes, -1), mpc)
    return _finite_or_huge(total)


def candidate_costs(state, coeff_seqs, grid, cfg, mpc, actuator):
    """(K, H, 2K) candidates -> (K,) costs of the spectral plan model.

    CUDA tensors always go through the kernel: no shape falls back to the
    op-by-op scan on the card."""
    _check_supported(cfg, mpc)
    ka = actuator.max_mode
    km = max(int(mpc.plan_modes), ka)
    if not state.x.is_cuda and mpc.plan_kernel != "fused":
        return _horizon_cost_spectral(state, coeff_seqs, cfg, mpc, actuator)
    # "xla" names the op-by-op scan, whose drift is trig; on the card it runs
    # as the kernel's trig variant
    drift = "trig" if mpc.plan_kernel == "xla" else mpc.spectral_drift
    pe = spectral_horizon(
        state.x, state.v,
        _pad_modes(coeff_seqs[..., :ka], km), _pad_modes(coeff_seqs[..., ka:], km),
        length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
        rot=use_rot(cfg.clamped_dt(), cfg.length, drift),
    )  # (K, H) post-drift spectral-model PE
    pe = _pe_factor(cfg, mpc) * pe
    ie = actuator.input_energy(coeff_seqs)  # (K, H)
    total = _add_terminal(torch.sum(mpc.w_field * pe + mpc.w_input * ie, dim=-1), pe, mpc)
    return _finite_or_huge(total)


def _plan_impl(state, mean, sigma, noise, grid, cfg, ctrl, mpc, actuator):
    """MPPI solve body over handed-in unit-variance noise (K, H, D)."""
    h, d = mean.shape
    cand = mean[None] + sigma * noise
    cand[0] = mean  # keep the nominal itself in the pool: never regress
    if mpc.seed_feedback and mpc.n_candidates >= 2:
        # phase-conjugate expert action at the current state, held over the horizon
        dens = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        fa, fb = feedback_coefficients(solve_e_mesh(dens, grid, cfg.n0), ctrl.max_mode)
        cand[1] = torch.cat([fa, fb]).to(mean.dtype).expand(h, d)
    cand = torch.clamp(cand, ctrl.coeff_min, ctrl.coeff_max)
    costs = candidate_costs(state, cand, grid, cfg, mpc, actuator)
    best = torch.min(costs)
    w = torch.softmax(-(costs - best) / mpc.temperature, dim=0)
    new_mean = torch.einsum("k,khd->hd", w, cand)
    return new_mean[0], new_mean, best


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
):
    """One MPC solve. Returns (first_action, new_mean, best_cost).

    ``noise``: optional (K, H, 2K) unit-variance perturbations (antithetic
    pairs included) in place of draws from ``generator``."""
    _check_supported(cfg, mpc)
    if mean.shape[-1] != 2 * actuator.max_mode:
        raise ValueError(
            f"coefficient/actuator mode mismatch: the nominal carries "
            f"{mean.shape[-1] // 2} modes but the actuator was built with "
            f"max_mode={actuator.max_mode}"
        )
    h, d = mean.shape
    if noise is None:
        if generator is None:
            raise ValueError("plan needs a torch.Generator or handed-in noise")
        noise = draw_noise(generator, mpc, h, d, mean.dtype, mean.device)
    return _plan_impl(state, mean, sigma, noise, grid, cfg, ctrl, mpc, actuator)


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
) -> MPCOutput:
    """Closed-loop receding-horizon control for ``n_steps`` env steps.

    Each step solves, applies the first action through one full PIC step
    and shifts the nominal. ``step_noise`` (T, K, H, 2K) overrides the
    per-solve draws (the counterpart of JAX's ``step_keys``)."""
    t_steps = step_noise.shape[0] if step_noise is not None else (
        n_steps if n_steps is not None else cfg.n_steps
    )
    x = state.x
    mean = mean0 if mean0 is not None else torch.zeros(
        (mpc.horizon, 2 * ctrl.max_mode), dtype=x.dtype, device=x.device
    )
    sigma = torch.tensor(mpc.sigma0, dtype=x.dtype, device=x.device)
    outs = []
    for i in range(t_steps):
        noise = None if step_noise is None else step_noise[i]
        action, new_mean, best = plan(state, mean, sigma, generator, grid, cfg, ctrl, mpc,
                                      actuator, noise=noise)
        state = step(state, grid, cfg, actuator.compute_e_packed(action))
        pe, ke = _energies(state, grid, cfg)
        outs.append((pe, ke, action, actuator.input_energy(action), best))
        mean = torch.cat([new_mean[1:], new_mean[-1:]])  # receding horizon: shift, repeat last
    pe, ke, coeffs, ie, best = (torch.stack(col) for col in zip(*outs))
    return MPCOutput(
        final_state=state,
        field_energy=pe,
        kinetic=ke,
        hamiltonian=pe + ke,
        coeffs=coeffs,
        input_energy=ie,
        plan_cost=best,
        final_mean=mean,
    )
