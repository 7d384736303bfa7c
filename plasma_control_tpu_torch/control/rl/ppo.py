"""PPO in PyTorch.

The counterpart of :mod:`plasma_control_tpu.control.rl.ppo`: a shared
actor-critic trunk with a learned global log_std, GAE(gamma, lam), the
clipped surrogate plus Huber value plus entropy loss over ``k_epoch`` inner
epochs of each on-policy chunk of ``chunk_size`` steps, updated whenever the
chunk fills; ``clip_by_global_norm(0.5)`` then Adam (:mod:`.optim`).

The reference's quirks stay, as the JAX module documents them: the inner
epochs re-sample fresh actions and put their log-probs in the ratio, and the
offline warm start takes one gradient step on ``-sum(l2)`` to the expert
(``anti_bc_warmstart``). Each draw comes from the caller's
``torch.Generator``; ``update_policy`` takes its (k_epoch, C, A) unit-normal
draws as an argument so a test hands JAX's across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...config import ControlConfig, SimConfig
from ...interop import actor_params_to_numpy
from ...models.pic import PlasmaState, init_state, step
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..feedback import feedback_rollout
from ..reward import Reward
from .ddpg import _episode_reward
from .networks import PPOActorCritic
from .optim import Adam, grads_of, huber

__all__ = ["PPOConfig", "PPOState", "make_ppo", "compute_gae", "update_policy", "run_episode",
           "train"]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's PPO hyperparameters (the reference CLI defaults)."""

    mlp_dim: int = 32
    lr: float = 5e-4
    gamma: float = 0.995  # --r
    lam: float = 0.95
    std_init: float = 0.5
    chunk_size: int = 8  # --capacity
    eps_clip: float = 0.25
    entropy_coeff: float = 0.01
    value_coeff: float = 0.20
    k_epoch: int = 4
    num_episodes: int = 200
    output_min: float = -1.0
    output_max: float = 1.0
    alpha: float = 0.1
    beta: float = 0.0
    anti_bc_warmstart: bool = True
    reward_shape: str = "reference"  # or "shaped"


@dataclasses.dataclass
class PPOState:
    policy: PPOActorCritic
    opt: Adam


def make_ppo(cfg: SimConfig, ctrl: ControlConfig, hp: PPOConfig,
             generator: torch.Generator) -> PPOState:
    policy = PPOActorCritic(hp.mlp_dim, ctrl.n_actions, std_init=hp.std_init,
                            output_min=hp.output_min, output_max=hp.output_max, length=cfg.length,
                            generator=generator)
    return PPOState(policy=policy, opt=Adam(policy.parameters(), hp.lr, max_norm=0.5))


def compute_gae(rewards, values, dones, next_values, gamma: float = 0.995, lam: float = 0.95):
    """GAE by a reverse pass over the chunk: (advantages, returns)."""
    gae = torch.zeros((), dtype=rewards.dtype, device=rewards.device)
    adv = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * (1.0 - dones[t]) - values[t]
        gae = delta + gamma * lam * (1.0 - dones[t]) * gae
        adv.append(gae)
    adv = torch.stack(adv[::-1])
    return adv, adv + values


def update_policy(ts: PPOState, chunk, noise: torch.Tensor, hp: PPOConfig) -> torch.Tensor:
    """``k_epoch`` clipped-surrogate steps over one chunk (s, s', logp_old,
    r, done), in place; ``noise`` (k_epoch, C, A) holds each epoch's
    unit-normal action draws. Returns the mean loss over the epochs."""
    policy = ts.policy
    s, s2, logp_old, r, d = chunk
    with torch.no_grad():
        values = policy(s)[2][:, 0]
        next_values = policy(s2)[2][:, 0]
        adv, returns = compute_gae(r, values, d, next_values, hp.gamma, hp.lam)
    td_target = adv[:, None]
    losses = []
    for eps in noise:
        _, entropy, logp, value = policy.sample(s, noise=eps)
        delta = td_target - value
        ratio = torch.exp(logp - logp_old)
        surr = torch.minimum(ratio * delta,
                             torch.clamp(ratio, 1 - hp.eps_clip, 1 + hp.eps_clip) * delta)
        loss = (-torch.mean(surr) + hp.value_coeff * torch.mean(huber(value[:, 0], returns))
                - hp.entropy_coeff * entropy)
        ts.opt.step(grads_of(loss, ts.opt.params))
        losses.append(loss.detach())
    return torch.mean(torch.stack(losses))


def run_episode(ts: PPOState, state0: PlasmaState, reward_feq: torch.Tensor,
                generator: torch.Generator, grid: Grid, actuator: FourierActuator, cfg: SimConfig,
                ctrl: ControlConfig, hp: PPOConfig, n_steps: int) -> dict:
    """One online episode: per step a sampled action, one environment step,
    the reward and a chunk slot; an update each time the chunk fills."""
    reward_fn = _episode_reward(state0, reward_feq, cfg, ctrl, hp.alpha, hp.beta).reward_fn(
        hp.reward_shape)
    dev, c, a_dim = state0.x.device, hp.chunk_size, ctrl.n_actions
    sdim = 2 * cfg.n_particles
    z = lambda *shape: torch.zeros(shape, dtype=state0.x.dtype, device=dev)
    chunk = (z(c, sdim), z(c, sdim), z(c, 1), z(c), z(c))
    env, rewards, fulls = state0, [], []
    loss_sum = torch.zeros((), device=dev)
    for t in range(n_steps):
        s_packed = torch.cat([env.x, env.v])
        with torch.no_grad():
            a, _, logp, _ = ts.policy.sample(
                s_packed[None], noise=torch.randn((1, a_dim), generator=generator, device=dev))
        a = a[0]
        env2 = step(env, grid, cfg, actuator.compute_e_packed(a))
        r = reward_fn(s_packed, a)
        slot = t % c
        for buf, val in zip(chunk, (s_packed, torch.cat([env2.x, env2.v]), logp[0], r,
                                    1.0 if t == n_steps - 1 else 0.0)):
            buf[slot] = val
        full = slot == c - 1
        if full:
            noise = torch.randn((hp.k_epoch, c, a_dim), generator=generator, device=dev)
            loss_sum += update_policy(ts, chunk, noise, hp)
        rewards.append(r)
        fulls.append(full)
        env = env2
    rs = torch.stack(rewards).cpu().numpy()
    mask = np.asarray(fulls, dtype=np.float32)
    n_upd = max(int(mask.sum()), 1)
    return {"reward_mean": float(np.sum(rs * mask)) / n_upd, "loss": float(loss_sum) / n_upd,
            "reward_total": float(rs.sum())}


def train(cfg: SimConfig, ctrl: ControlConfig, hp: PPOConfig, grid: Grid,
          actuator: FourierActuator, generator: torch.Generator,
          num_episodes: Optional[int] = None, verbose: int = 10, ckpt_path: Optional[str] = None,
          ckpt_every: int = 10, resume: bool = True):
    """The anti-BC warm start (``anti_bc_warmstart``), then online episodes on
    the grid's device. ``ckpt_path``, ``ckpt_every`` and ``resume`` as in
    :func:`.ddpg.train` (PPO is on-policy: no buffer to keep); a resumed run
    skips the warm start. Returns (ts, best policy params as a host flax
    tree, history dict of per-episode arrays)."""
    dev = grid.e_op.device
    state0 = init_state(cfg, generator, device=dev)
    ts = make_ppo(cfg, ctrl, hp, generator)
    n_steps = cfg.n_steps
    reward = Reward(torch.cat([state0.x, state0.v]), ctrl.reward_n_mesh, cfg.length, ctrl.vmin,
                    ctrl.vmax, cfg.n0, hp.alpha, hp.beta, ctrl.n_actions)
    ck = None
    if ckpt_path and resume:
        from ...io.resume import restore_train_checkpoint

        ck = restore_train_checkpoint(ckpt_path, ts, None, generator)
    if ck is None and hp.anti_bc_warmstart:
        # a single -sum(l2) step away from the expert, as the reference takes it
        fb = feedback_rollout(state0, grid, cfg, ctrl, actuator, record_snapshots=True,
                              n_steps=n_steps)
        states_bc = torch.cat([fb.xs[:-1], fb.vs[:-1]], dim=1)
        actions_bc = torch.cat([fb.coeff_cos, fb.coeff_sin], dim=1)
        noise = torch.randn(actions_bc.shape, generator=generator, device=dev)
        pred = ts.policy.sample(states_bc, noise=noise)[0]
        loss = -torch.sum(torch.sum((actions_bc - pred) ** 2, dim=1))
        ts.opt.step(grads_of(loss, ts.opt.params))

    episodes = num_episodes if num_episodes is not None else hp.num_episodes
    hist = {"reward": [], "loss": []}
    ep0, best_reward, best_params = 0, None, actor_params_to_numpy(ts.policy)
    if ck is not None:
        ep0, hist = ck["ep_done"], ck["hist"]
        best_reward, best_params = ck["best_reward"], ck["best_params"]
        print(f"# resumed PPO training from {ckpt_path} at episode {ep0}")
    for ep in range(ep0, episodes):
        ep_state = init_state(cfg, generator, device=dev)
        m = run_episode(ts, ep_state, reward.feq, generator, grid, actuator, cfg, ctrl, hp, n_steps)
        hist["reward"].append(m["reward_mean"])
        hist["loss"].append(m["loss"])
        if best_reward is None or m["reward_mean"] > best_reward:
            best_reward, best_params = m["reward_mean"], actor_params_to_numpy(ts.policy)
        if ckpt_path and ((ep + 1) % ckpt_every == 0 or ep == episodes - 1):
            from ...io.resume import save_train_checkpoint

            save_train_checkpoint(ckpt_path, ts, None, generator, ep + 1, hist, best_reward,
                                  best_params)
        if verbose and ep % verbose == 0:
            print(f"| episode:{ep + 1} | loss:{m['loss']:.4f} | reward:{m['reward_mean']:.4f}")
    return ts, best_params, {k: np.asarray(v) for k, v in hist.items()}
