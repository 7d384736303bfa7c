"""DAgger behaviour cloning of the feedback or the MPC expert.

The counterpart of :mod:`plasma_control_tpu.control.rl.dagger`: each
iteration refits the actor on the aggregated data set, rolls it closed-loop
through the PIC dynamics, relabels every visited state with the expert's
action and aggregates. The expert is the phase-conjugate feedback law or,
with an ``MPCConfig``, a full MPC solve per visited state (amortised MPC):
on CUDA tensors one launch of the spectral horizon kernel per solve,
warm-started along the learner's own trajectory. JAX's scans become Python
loops that keep the state on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import ControlConfig, MPCConfig, SimConfig
from ...interop import actor_params_to_numpy
from ...models.pic import PlasmaState, init_state, step
from ...models.rollout import _energies, rollout
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..feedback import feedback_rollout
from ..mpc import mpc_rollout, plan
from .ddpg import DDPGConfig, _expert_action, make_ddpg
from .optim import Adam, grads_of

__all__ = ["collect_policy_rollout", "fit_bc", "dagger_train"]


def collect_policy_rollout(actor: torch.nn.Module, state0: PlasmaState, grid: Grid,
                           actuator: FourierActuator, cfg: SimConfig, ctrl: ControlConfig,
                           n_steps: int, mpc: Optional[MPCConfig] = None,
                           generator: Optional[torch.Generator] = None):
    """Roll the actor closed-loop for ``n_steps``; return (visited states
    (T, 2N), expert actions there (T, A), field energy after each step (T,)).

    ``mpc=None`` relabels with the phase-conjugate feedback law; an
    ``MPCConfig`` with an MPC solve at every visited state (its candidate
    noise drawn from ``generator``), the nominal warm-started and shifted
    along the learner's trajectory as a receding-horizon controller's."""
    if mpc is not None and generator is None:
        raise ValueError("expert='mpc' relabelling needs a torch.Generator")
    if mpc is not None:
        x = state0.x
        sigma = torch.tensor(mpc.sigma0, dtype=x.dtype, device=x.device)
        mean = torch.zeros((mpc.horizon, ctrl.n_actions), dtype=x.dtype, device=x.device)
    st, states, experts, pes = state0, [], [], []
    for _ in range(n_steps):
        s_packed = torch.cat([st.x, st.v])
        if mpc is None:
            a_exp = _expert_action(st.x, grid, cfg, ctrl.max_mode)
        else:
            a_exp, new_mean, _ = plan(st, mean, sigma, generator, grid, cfg, ctrl, mpc, actuator)
            mean = torch.cat([new_mean[1:], new_mean[-1:]])
        with torch.no_grad():
            a = actor.sample(s_packed[None])[0]
        st = step(st, grid, cfg, actuator.compute_e_packed(a))
        states.append(s_packed)
        experts.append(a_exp)
        pes.append(_energies(st, grid, cfg)[0])
    return torch.stack(states), torch.stack(experts), torch.stack(pes)


def fit_bc(actor: torch.nn.Module, opt: Adam, states: torch.Tensor, actions: torch.Tensor,
           n_epochs: int) -> torch.Tensor:
    """Full-batch L2 regression of the actor onto the expert actions, one
    step per epoch, in place. Returns the last epoch's loss (before its
    step)."""
    loss = torch.zeros(())
    for _ in range(n_epochs):
        loss = torch.mean(torch.sum((actions - actor.sample(states)) ** 2, dim=1))
        opt.step(grads_of(loss, opt.params))
    return loss.detach()


def dagger_train(cfg: SimConfig, ctrl: ControlConfig, hp: DDPGConfig, grid: Grid,
                 actuator: FourierActuator, generator: torch.Generator, n_iters: int = 5,
                 epochs_per_iter: int = 300, verbose: bool = True,
                 mpc: Optional[MPCConfig] = None, return_best: bool = True):
    """The DAgger loop on the grid's device (the generator must live there).
    Returns (actor, params, history): ``params`` is a host flax tree of the
    iteration with the lowest closed-loop tail PE when ``return_best`` (and
    one was finite), else of the last iteration; the actor holds the last
    iteration's weights. ``history['pe_tail'][i]`` is the tail PE (mean of
    the last fifth) of iteration i's evaluation rollout."""
    dev = grid.e_op.device
    ts = make_ddpg(cfg, ctrl, hp, generator)
    actor, opt = ts.actor, ts.actor_opt
    n_steps = cfg.n_steps

    # iteration 0's data set: the expert's own trajectory
    state0 = init_state(cfg, generator, device=dev)
    if mpc is None:
        fb = feedback_rollout(state0, grid, cfg, ctrl, actuator, record_snapshots=True,
                              n_steps=n_steps)
        states = torch.cat([fb.xs[:-1], fb.vs[:-1]], dim=1)
        actions = torch.cat([fb.coeff_cos, fb.coeff_sin], dim=1)
    else:
        out = mpc_rollout(state0, grid, cfg, ctrl, mpc, actuator, generator, n_steps=n_steps)
        replay = rollout(state0, grid, cfg, e_external_traj=actuator.compute_e_packed(out.coeffs),
                         record_snapshots=True, n_steps=n_steps)
        states = torch.cat([replay.xs[:-1], replay.vs[:-1]], dim=1)
        actions = out.coeffs

    history = {"bc_loss": [], "pe_tail": []}
    best_params, best_pe = None, float("inf")
    for it in range(n_iters):
        loss = float(fit_bc(actor, opt, states, actions, epochs_per_iter))
        roll_state = init_state(cfg, generator, device=dev)
        s_new, a_new, pes = collect_policy_rollout(actor, roll_state, grid, actuator, cfg, ctrl,
                                                   n_steps, mpc=mpc, generator=generator)
        states = torch.cat([states, s_new])
        actions = torch.cat([actions, a_new])
        pe_tail = float(torch.mean(pes[-n_steps // 5:]))
        history["bc_loss"].append(loss)
        history["pe_tail"].append(pe_tail)
        if pe_tail < best_pe:  # a host copy: the actor moves on
            best_pe, best_params = pe_tail, actor_params_to_numpy(actor)
        if verbose:
            print(f"| dagger iter {it + 1}/{n_iters} | bc_loss {loss:.5f} "
                  f"| policy PE_tail {pe_tail:.1f}", flush=True)
    if return_best and best_params is not None:
        return actor, best_params, history
    return actor, actor_params_to_numpy(actor), history

