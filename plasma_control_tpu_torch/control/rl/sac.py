"""SAC in PyTorch.

The counterpart of :mod:`plasma_control_tpu.control.rl.sac`: entropy-
regularised twin-Q targets, a learned temperature ``log_alpha`` with target
entropy -n_actions, reward batch normalisation, the Bellman target clamped
to +-``bellman_clamp``, Polyak target updates; online only. Updates fire
when the buffer holds ``batch_size`` transitions, every ``batch_size // 4``
steps. Networks and critic step with ``clip_by_global_norm(1.0)`` then Adam,
the temperature with a bare Adam (:mod:`.optim`).

The reference's quirks stay, as the JAX module documents them: the entropy
bonus is the Gaussian's mean scalar entropy, the actor loss detaches Q (its
gradient flows through the entropy term only), and the reward's input-energy
term squares the external *mesh field*, not the coefficients. The
reparameterisation draws are ``update_policy``'s arguments, so a test hands
JAX's across.
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
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..reward import Reward
from .buffer import ReplayBuffer
from .ddpg import _episode_reward, _summary
from .networks import SACActor, SACCritic
from .optim import Adam, grads_of, huber, polyak

__all__ = ["SACConfig", "SACState", "make_sac", "update_policy", "run_episode", "train"]


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """The JAX package's SAC hyperparameters (the reference CLI defaults)."""

    mlp_dim: int = 32
    lr: float = 5e-4
    gamma: float = 0.995  # --r
    tau: float = 0.5  # --tau
    capacity: int = 256
    batch_size: int = 128
    num_episodes: int = 1000
    output_min: float = -1.0
    output_max: float = 1.0
    alpha: float = 1.0  # reward weight
    bellman_clamp: float = 1e3
    reward_shape: str = "reference"  # or "shaped"


@dataclasses.dataclass
class SACState:
    actor: SACActor
    critic: SACCritic
    target_critic: SACCritic
    log_alpha: torch.Tensor  # () leaf tensor that takes gradients
    actor_opt: Adam
    critic_opt: Adam
    alpha_opt: Adam


def make_sac(cfg: SimConfig, ctrl: ControlConfig, hp: SACConfig,
             generator: torch.Generator) -> SACState:
    sdim = 2 * cfg.n_particles
    actor = SACActor(sdim, hp.mlp_dim, ctrl.n_actions, output_min=hp.output_min,
                     output_max=hp.output_max, generator=generator)
    critic = SACCritic(sdim, ctrl.n_actions, hp.mlp_dim, generator=generator)
    target = copy.deepcopy(critic)
    target.requires_grad_(False)
    log_alpha = torch.zeros((), device=generator.device, requires_grad=True)
    return SACState(actor=actor, critic=critic, target_critic=target, log_alpha=log_alpha,
                    actor_opt=Adam(actor.parameters(), hp.lr, max_norm=1.0),
                    critic_opt=Adam(critic.parameters(), hp.lr, max_norm=1.0),
                    alpha_opt=Adam([log_alpha], hp.lr))


def update_policy(ts: SACState, batch, noise_next: torch.Tensor, noise_pi: torch.Tensor,
                  hp: SACConfig, target_entropy: float):
    """One SAC update in place; ``noise_next`` and ``noise_pi`` are the (B, A)
    unit-normal draws of the next-state and the policy-loss actions.
    Returns the (q1, q2, policy) losses."""
    s, a, s2, r, d, _ = batch
    r = (r - torch.mean(r)) / (torch.std(r, correction=0) + 1e-6)  # reward batch normalisation
    alpha = torch.exp(ts.log_alpha.detach())
    with torch.no_grad():
        next_a, next_entropy, _ = ts.actor.sample(s2, noise=noise_next)
        nq1, nq2 = ts.target_critic(s2, next_a)
        # terminal next-states are masked out of the bootstrap
        next_q = (torch.minimum(nq1, nq2) + alpha * next_entropy) * (1.0 - d[:, None])
        target = torch.clamp(r[:, None] + hp.gamma * next_q, -hp.bellman_clamp, hp.bellman_clamp)

    q1, q2 = ts.critic(s, a)
    q1_l, q2_l = torch.mean(huber(q1, target)), torch.mean(huber(q2, target))
    ts.critic_opt.step(grads_of(q1_l + q2_l, ts.critic_opt.params))

    a_pi, entropy, _ = ts.actor.sample(s, noise=noise_pi)
    q = torch.minimum(*ts.critic(s, a_pi)).detach()  # detached: the gradient is the entropy's
    p_loss = -torch.mean(q + entropy * alpha)
    ts.actor_opt.step(grads_of(p_loss, ts.actor_opt.params))

    a_loss = -torch.mean(ts.log_alpha * (target_entropy - entropy.detach()))
    ts.alpha_opt.step(grads_of(a_loss, [ts.log_alpha]))

    polyak(ts.target_critic, ts.critic, hp.tau)
    return q1_l.detach(), q2_l.detach(), p_loss.detach()


def run_episode(ts: SACState, buf: ReplayBuffer, state0: PlasmaState, reward_feq: torch.Tensor,
                generator: torch.Generator, grid: Grid, actuator: FourierActuator, cfg: SimConfig,
                ctrl: ControlConfig, hp: SACConfig, n_steps: int) -> dict:
    """One online episode: per step a sampled action, one environment step,
    the reward of the state and the external mesh field, a buffer write,
    and an update when the buffer holds ``batch_size`` and ``t % (batch_size
    // 4) == 0``."""
    reward_fn = _episode_reward(state0, reward_feq, cfg, ctrl, hp.alpha, 1.0).reward_fn(
        hp.reward_shape)
    dev, a_dim, b = state0.x.device, ctrl.n_actions, hp.batch_size
    target_entropy = float(-ctrl.n_actions)
    update_every = max(b // 4, 1)
    env, rewards, updated = state0, [], []
    sums = {k: torch.zeros((), device=dev) for k in ("q1_loss", "q2_loss", "p_loss")}
    for t in range(n_steps):
        s_packed = torch.cat([env.x, env.v])
        with torch.no_grad():
            a = ts.actor.sample(s_packed[None], noise=torch.randn(
                (1, a_dim), generator=generator, device=dev))[0][0]
        e_ext = actuator.compute_e_packed(a)
        env2 = step(env, grid, cfg, e_ext)
        r = reward_fn(s_packed, e_ext)
        buf.push(s_packed, a, torch.cat([env2.x, env2.v]), r, 1.0 if t == n_steps - 1 else 0.0)
        do_update = buf.size >= b and t % update_every == 0
        if do_update:
            batch = buf.sample(buf.draw_indices(generator, b))
            n1, n2 = torch.randn((2, b, a_dim), generator=generator, device=dev)
            for k, v in zip(sums, update_policy(ts, batch, n1, n2, hp, target_entropy)):
                sums[k] += v
        rewards.append(r)
        updated.append(do_update)
        env = env2
    return _summary(rewards, updated, sums)


def train(cfg: SimConfig, ctrl: ControlConfig, hp: SACConfig, grid: Grid,
          actuator: FourierActuator, generator: torch.Generator,
          num_episodes: Optional[int] = None, verbose: int = 10, ckpt_path: Optional[str] = None,
          ckpt_every: int = 10, resume: bool = True):
    """Online-only training on the grid's device. ``ckpt_path``,
    ``ckpt_every`` and ``resume`` as in :func:`.ddpg.train` (the checkpoint
    also holds the learned temperature). Returns (ts, best actor params as a
    host flax tree, history dict of per-episode arrays)."""
    dev = grid.e_op.device
    state0 = init_state(cfg, generator, device=dev)
    ts = make_sac(cfg, ctrl, hp, generator)
    n_steps = cfg.n_steps
    reward = Reward(torch.cat([state0.x, state0.v]), ctrl.reward_n_mesh, cfg.length, ctrl.vmin,
                    ctrl.vmax, cfg.n0, hp.alpha, 1.0, ctrl.n_actions)
    buf = ReplayBuffer(hp.capacity, 2 * cfg.n_particles, ctrl.n_actions, device=dev)
    episodes = num_episodes if num_episodes is not None else hp.num_episodes
    hist = {"reward": [], "q1_loss": [], "q2_loss": [], "p_loss": []}
    ep0, best_reward, best_params = 0, None, actor_params_to_numpy(ts.actor)
    if ckpt_path and resume:
        from ...io.resume import restore_train_checkpoint

        ck = restore_train_checkpoint(ckpt_path, ts, buf, generator)
        if ck is not None:
            ep0, hist = ck["ep_done"], ck["hist"]
            best_reward, best_params = ck["best_reward"], ck["best_params"]
            print(f"# resumed SAC training from {ckpt_path} at episode {ep0}")
    for ep in range(ep0, episodes):
        ep_state = init_state(cfg, generator, device=dev)
        m = run_episode(ts, buf, ep_state, reward.feq, generator, grid, actuator, cfg, ctrl, hp,
                        n_steps)
        for k in hist:
            hist[k].append(m["reward_mean" if k == "reward" else k])
        if m["n_updates"] > 0 and (best_reward is None or m["reward_mean"] > best_reward):
            best_reward, best_params = m["reward_mean"], actor_params_to_numpy(ts.actor)
        if ckpt_path and ((ep + 1) % ckpt_every == 0 or ep == episodes - 1):
            from ...io.resume import save_train_checkpoint

            save_train_checkpoint(ckpt_path, ts, buf, generator, ep + 1, hist, best_reward,
                                  best_params)
        if verbose and ep % verbose == 0:
            print(f"| episode:{ep + 1} | p_loss:{m['p_loss']:.4f} | reward:{m['reward_mean']:.4f}")
    return ts, best_params, {k: np.asarray(v) for k, v in hist.items()}
