"""DDPG (TD3-flavoured, with behaviour cloning) in PyTorch.

The counterpart of :mod:`plasma_control_tpu.control.rl.ddpg`, with the same
hyperparameters and update: twin critics, target-policy smoothing noise 0.1
clipped to +-0.1 and the min(Q1', Q2') bootstrap; Huber critic losses; the
actor loss -Q1(s, pi(s)) against the *updated* Q1 plus the reward-weighted
BC term towards the phase-conjugate expert action; Polyak target updates;
optax's clip-and-Adam arithmetic (:mod:`.optim`). The offline stage is one
expert (feedback) rollout and ``n_bc_epochs`` of reward-weighted cloning.

JAX compiles an episode into one ``lax.scan``; here it is a Python loop that
keeps everything on the device: the environment step, the expert action,
the reward and the buffer write (the buffer's pointer and size are host
integers, so the update condition reads nothing back). Each draw comes from
the caller's ``torch.Generator``; the functions that JAX and torch cannot
draw alike take their unit-normal draws as arguments (``update_policy``'s
target noise, ``behavior_cloning``'s prediction noise), so a test hands
JAX's draws across.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...config import ControlConfig, SimConfig
from ...interop import actor_params_to_numpy
from ...models.pic import PlasmaState, init_state, step
from ...ops.deposit import deposit
from ...ops.fields import solve_e_mesh
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..feedback import feedback_coefficients, feedback_rollout
from ..reward import Reward
from .buffer import ReplayBuffer
from .networks import DDPGActor, DDPGCritic, SpectralActor, SpectralAttentionActor
from .optim import Adam, grads_of, huber, polyak

__all__ = ["DDPGConfig", "DDPGState", "make_actor", "make_ddpg", "update_policy",
           "behavior_cloning", "run_episode", "train"]


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """The JAX package's DDPG hyperparameters (the reference CLI defaults);
    ``encoder`` picks the actor: "deepsets" (:class:`DDPGActor`),
    "spectral" (:class:`SpectralActor`) or "attention"
    (:class:`SpectralAttentionActor`)."""

    mlp_dim: int = 64
    lr: float = 1e-3
    gamma: float = 0.995  # --r
    tau: float = 0.005
    capacity: int = 100_000
    batch_size: int = 100
    update_freq: int = 10
    min_buffer_size: int = 10_000
    num_episodes: int = 500
    noise_scale: float = 0.1
    ou_mu: float = 0.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    output_min: float = -1.25  # --coeff_min
    output_max: float = 1.25  # --coeff_max
    alpha: float = 0.1  # reward weights
    beta: float = 0.1
    bc_weight: float = 1.0  # actor BC term weight
    policy_noise: float = 0.1  # target smoothing
    noise_clip: float = 0.1
    n_bc_epochs: int = 50  # offline BC epochs
    reward_shape: str = "reference"  # or "shaped"
    encoder: str = "deepsets"  # or "spectral", "attention"
    encoder_modes: int = 8
    encoder_v_order: int = 1
    attn_dim: int = 64
    attn_heads: int = 4
    attn_layers: int = 2


@dataclasses.dataclass
class DDPGState:
    """Six networks and three optimisers; the targets never take gradients."""

    actor: torch.nn.Module
    q1: DDPGCritic
    q2: DDPGCritic
    target_actor: torch.nn.Module
    target_q1: DDPGCritic
    target_q2: DDPGCritic
    actor_opt: Adam
    q1_opt: Adam
    q2_opt: Adam


def _target(net: torch.nn.Module) -> torch.nn.Module:
    tgt = copy.deepcopy(net)
    tgt.requires_grad_(False)
    return tgt


def make_actor(cfg: SimConfig, ctrl: ControlConfig, hp: DDPGConfig, generator: torch.Generator):
    """The actor ``hp.encoder`` names, drawn from ``generator`` on its device."""
    kw = dict(mlp_dim=hp.mlp_dim, n_actions=ctrl.n_actions, output_min=hp.output_min,
              output_max=hp.output_max, length=cfg.length, generator=generator)
    if hp.encoder == "attention":
        return SpectralAttentionActor(n_modes=hp.encoder_modes, v_order=hp.encoder_v_order,
                                      d_model=hp.attn_dim, n_heads=hp.attn_heads,
                                      n_layers=hp.attn_layers, **kw)
    if hp.encoder == "spectral":
        return SpectralActor(n_modes=hp.encoder_modes, v_order=hp.encoder_v_order, **kw)
    if hp.encoder == "deepsets":
        return DDPGActor(**kw)
    raise ValueError(f"unknown encoder {hp.encoder!r}: use 'deepsets', 'spectral' or 'attention'")


def make_ddpg(cfg: SimConfig, ctrl: ControlConfig, hp: DDPGConfig,
              generator: torch.Generator) -> DDPGState:
    """Six networks (drawn from ``generator``, on its device) and three
    optimisers, ``clip_by_global_norm(1.0)`` then Adam(``hp.lr``)."""
    actor = make_actor(cfg, ctrl, hp, generator)
    q1, q2 = (DDPGCritic(hp.mlp_dim, ctrl.n_actions, length=cfg.length, generator=generator)
              for _ in range(2))
    opt = lambda net: Adam(net.parameters(), hp.lr, max_norm=1.0)
    return DDPGState(actor=actor, q1=q1, q2=q2, target_actor=_target(actor), target_q1=_target(q1),
                     target_q2=_target(q2), actor_opt=opt(actor), q1_opt=opt(q1), q2_opt=opt(q2))


def _mean_huber(pred, target):
    return torch.mean(huber(pred, target))


def update_policy(ts: DDPGState, batch, noise: torch.Tensor, hp: DDPGConfig):
    """One TD3+BC update in place; ``noise`` is the (B, A) unit-normal draw of
    the target-policy smoothing. Returns the (q1, q2, policy) losses."""
    s, a, s2, r, d, a_bc = batch
    with torch.no_grad():
        next_a = ts.target_actor.sample(s2)
        smooth = torch.clamp(noise * hp.policy_noise, -hp.noise_clip, hp.noise_clip)
        next_a = torch.clamp(next_a + smooth, hp.output_min, hp.output_max)
        tq = torch.minimum(ts.target_q1(s2, next_a), ts.target_q2(s2, next_a))
        target_q = r[:, None] + hp.gamma * (1.0 - d[:, None]) * tq

    losses = []
    for q, opt in ((ts.q1, ts.q1_opt), (ts.q2, ts.q2_opt)):
        loss = _mean_huber(q(s, a), target_q)
        opt.step(grads_of(loss, opt.params))
        losses.append(loss.detach())

    a_pi = ts.actor.sample(s)
    bc = torch.mean(torch.sum((a_bc - a_pi) ** 2, dim=1) * r)
    p_loss = -torch.mean(ts.q1(s, a_pi)) + hp.bc_weight * bc  # the updated q1
    ts.actor_opt.step(grads_of(p_loss, ts.actor_opt.params))

    polyak(ts.target_actor, ts.actor, hp.tau)
    polyak(ts.target_q1, ts.q1, hp.tau)
    polyak(ts.target_q2, ts.q2, hp.tau)
    return losses[0], losses[1], p_loss.detach()


def _expert_action(x: torch.Tensor, grid: Grid, cfg: SimConfig, max_mode: int) -> torch.Tensor:
    """Phase-conjugate expert action (packed [a, b]) of the current state on
    the environment's grid."""
    n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    a, b = feedback_coefficients(solve_e_mesh(n, grid, cfg.n0), max_mode)
    return torch.cat([a, b])


def _ou_step(ou: torch.Tensor, noise: torch.Tensor, hp: DDPGConfig) -> torch.Tensor:
    """Ornstein-Uhlenbeck step with the unit-normal draw ``noise``."""
    return ou + (hp.ou_theta * (hp.ou_mu - ou) + hp.ou_sigma * noise)


def behavior_cloning(ts: DDPGState, states_bc: torch.Tensor, actions_bc: torch.Tensor,
                     rewards_bc: torch.Tensor, noise: torch.Tensor, hp: DDPGConfig):
    """Offline reward-weighted BC of the actor in place, one full-batch step
    per epoch; ``noise`` (n_epochs, T, A) is the unit-normal exploration
    noise added (x 0.1, clipped to +-0.1) to each epoch's predictions.
    Returns the (n_epochs,) losses, each before its step."""
    losses = []
    for eps in noise:
        pred = ts.actor.sample(states_bc)
        pred = torch.clamp(pred + torch.clamp(eps * 0.1, -0.1, 0.1), hp.output_min, hp.output_max)
        loss = torch.sum(torch.sum((actions_bc - pred) ** 2, dim=1) * rewards_bc)
        ts.actor_opt.step(grads_of(loss, ts.actor_opt.params))
        losses.append(loss.detach())
    return torch.stack(losses)


def _episode_reward(state0: PlasmaState, reward_feq: torch.Tensor, cfg: SimConfig,
                    ctrl: ControlConfig, alpha: float, beta: float) -> Reward:
    """The episode's reward: built from its initial state, with the training
    run's equilibrium f_eq."""
    reward = Reward(torch.cat([state0.x, state0.v]), ctrl.reward_n_mesh, cfg.length, ctrl.vmin,
                    ctrl.vmax, cfg.n0, alpha, beta, ctrl.n_actions)
    reward.feq = reward_feq
    return reward


def _summary(rewards, updated, sums: dict) -> dict:
    """The JAX episode's metrics: loss sums and the reward over the update
    steps divided by the update count (at least 1), the total reward."""
    rs = torch.stack(rewards).cpu().numpy()
    mask = np.asarray(updated, dtype=np.float32)
    n_upd = max(int(mask.sum()), 1)
    out = {k: float(v) / n_upd for k, v in sums.items()}
    out.update(reward_mean=float(np.sum(rs * mask)) / n_upd, n_updates=int(mask.sum()),
               reward_total=float(rs.sum()))
    return out


def run_episode(ts: DDPGState, buf: ReplayBuffer, state0: PlasmaState, reward_feq: torch.Tensor,
                generator: torch.Generator, grid: Grid, actuator: FourierActuator, cfg: SimConfig,
                ctrl: ControlConfig, hp: DDPGConfig, n_steps: int) -> dict:
    """One online episode: per step the expert action, the actor's action plus
    OU noise, one environment step, the reward, a buffer write, and a TD3
    update when the buffer holds ``min_buffer_size`` and ``t % update_freq
    == 0``. Returns the metrics dict (floats)."""
    reward_fn = _episode_reward(state0, reward_feq, cfg, ctrl, hp.alpha, hp.beta).reward_fn(
        hp.reward_shape)
    dev = state0.x.device
    ou = torch.full((ctrl.n_actions,), hp.ou_mu, dtype=state0.x.dtype, device=dev)
    env, rewards, updated = state0, [], []
    sums = {k: torch.zeros((), device=dev) for k in ("q1_loss", "q2_loss", "p_loss")}
    for t in range(n_steps):
        s_packed = torch.cat([env.x, env.v])
        a_bc = _expert_action(env.x, grid, cfg, ctrl.max_mode)
        with torch.no_grad():
            a = ts.actor.sample(s_packed[None])[0]
        ou = _ou_step(ou, torch.randn(ou.shape, generator=generator, device=dev), hp)
        a = torch.clamp(a + ou * hp.noise_scale, hp.output_min, hp.output_max)
        env2 = step(env, grid, cfg, actuator.compute_e_packed(a))
        r = reward_fn(s_packed, a)
        buf.push(s_packed, a, torch.cat([env2.x, env2.v]), r, 1.0 if t == n_steps - 1 else 0.0, a_bc)
        do_update = buf.size >= hp.min_buffer_size and t % hp.update_freq == 0
        if do_update:
            batch = buf.sample(buf.draw_indices(generator, hp.batch_size))
            noise = torch.randn((hp.batch_size, ctrl.n_actions), generator=generator, device=dev)
            for k, v in zip(sums, update_policy(ts, batch, noise, hp)):
                sums[k] += v
        rewards.append(r)
        updated.append(do_update)
        env = env2
    return _summary(rewards, updated, sums)


def train(cfg: SimConfig, ctrl: ControlConfig, hp: DDPGConfig, grid: Grid,
          actuator: FourierActuator, generator: torch.Generator,
          num_episodes: Optional[int] = None, verbose: int = 10, save_best: Optional[str] = None,
          save_every: int = 10, ckpt_path: Optional[str] = None, ckpt_every: int = 10,
          resume: bool = True):
    """Offline expert BC, then online episodes, on the grid's device (the
    generator must live there). ``save_best`` writes the best actor every
    ``save_every`` episodes. With ``ckpt_path`` the complete training state
    (networks, optimiser moments, replay buffer, generator state, history)
    is checkpointed every ``ckpt_every`` episodes and after the last
    (:func:`...io.resume.save_train_checkpoint`), and with ``resume`` a run
    continues from a checkpoint found there, skipping the offline stage, as
    the uninterrupted run would have. Returns (ts, best actor params as a
    host flax tree, history dict of per-episode arrays)."""
    dev = grid.e_op.device
    state0 = init_state(cfg, generator, device=dev)
    ts = make_ddpg(cfg, ctrl, hp, generator)
    n_steps = cfg.n_steps
    reward = Reward(torch.cat([state0.x, state0.v]), ctrl.reward_n_mesh, cfg.length, ctrl.vmin,
                    ctrl.vmax, cfg.n0, hp.alpha, hp.beta, ctrl.n_actions)
    buf = ReplayBuffer(hp.capacity, 2 * cfg.n_particles, ctrl.n_actions, device=dev)
    episodes = num_episodes if num_episodes is not None else hp.num_episodes
    hist = {"reward": [], "q1_loss": [], "q2_loss": [], "p_loss": []}

    # a restored checkpoint overwrites the cloned actor, so the offline stage
    # is skipped on resume
    ck = None
    if ckpt_path and resume:
        from ...io.resume import restore_train_checkpoint

        ck = restore_train_checkpoint(ckpt_path, ts, buf, generator)
    if ck is not None:
        ep0, hist = ck["ep_done"], ck["hist"]
        best_reward, best_params = ck["best_reward"], ck["best_params"]
        print(f"# resumed DDPG training from {ckpt_path} at episode {ep0}")
    else:
        # offline stage: expert rollout + reward-weighted BC
        fb = feedback_rollout(state0, grid, cfg, ctrl, actuator, record_snapshots=True,
                              n_steps=n_steps)
        states_bc = torch.cat([fb.xs[:-1], fb.vs[:-1]], dim=1)  # (T, 2N)
        actions_bc = torch.cat([fb.coeff_cos, fb.coeff_sin], dim=1)  # (T, A)
        reward_fn = reward.reward_fn(hp.reward_shape)
        rewards_bc = torch.stack([reward_fn(s, a) for s, a in zip(states_bc, actions_bc)])
        noise = torch.randn((hp.n_bc_epochs,) + actions_bc.shape, generator=generator, device=dev)
        behavior_cloning(ts, states_bc, actions_bc, rewards_bc, noise, hp)
        ep0, best_reward, best_params = 0, None, actor_params_to_numpy(ts.actor)

    for ep in range(ep0, episodes):
        ep_state = init_state(cfg, generator, device=dev)  # env.reinit(): full resample
        m = run_episode(ts, buf, ep_state, reward.feq, generator, grid, actuator, cfg, ctrl, hp,
                        n_steps)
        for k in hist:
            hist[k].append(m["reward_mean" if k == "reward" else k])
        if m["n_updates"] > 0 and (best_reward is None or m["reward_mean"] > best_reward):
            best_reward, best_params = m["reward_mean"], actor_params_to_numpy(ts.actor)
        if save_best and ep % save_every == 0:
            from ...io.checkpoint import save_params

            save_params(save_best, best_params)
        if ckpt_path and ((ep + 1) % ckpt_every == 0 or ep == episodes - 1):
            from ...io.resume import save_train_checkpoint

            save_train_checkpoint(ckpt_path, ts, buf, generator, ep + 1, hist, best_reward,
                                  best_params)
        if verbose and ep % verbose == 0:
            print(f"| episode:{ep + 1} | reward:{m['reward_mean']:.4f} | "
                  f"p_loss:{m['p_loss']:.4f}")
    return ts, best_params, {k: np.asarray(v) for k, v in hist.items()}
