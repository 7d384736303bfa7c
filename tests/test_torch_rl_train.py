"""The RL trainers' pieces on CPU against the JAX package: the replay
buffer, GAE, one ``update_policy`` step of DDPG, PPO and SAC from the same
parameters, batch and noise (JAX's draws rebuilt from its key and handed
across), offline BC and DAgger's ``fit_bc`` over 20 epochs, and the Adam /
clip arithmetic of ``optim`` against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control.rl import buffer as jbuffer
from plasma_control_tpu.control.rl import dagger as jdagger
from plasma_control_tpu.control.rl import ddpg as jddpg
from plasma_control_tpu.control.rl import ppo as jppo
from plasma_control_tpu.control.rl import sac as jsac
from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control.rl import dagger, ddpg, ppo, sac
from plasma_control_tpu_torch.control.rl.buffer import ReplayBuffer
from plasma_control_tpu_torch.control.rl.optim import Adam
from plasma_control_tpu_torch.interop import actor_params_from_numpy, actor_params_to_numpy

torch.set_num_threads(1)

N, KA, B = 64, 2, 8  # particles, actuated modes, batch
A = 2 * KA
SIM = dict(n_particles=N, n_mesh=16, dt=0.1, t_max=1.0)
RTOL, ATOL = 1e-5, 1e-7


def _cfgs():
    return (JSimConfig(**SIM), JControlConfig(max_mode=KA), SimConfig(**SIM),
            ControlConfig(max_mode=KA))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(net, params):
    net.load_state_dict(actor_params_from_numpy(_np(params), net))


def _same_params(net, params, rtol=RTOL, atol=ATOL):
    got, want = actor_params_to_numpy(net), _np(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _batch(seed, with_bc=True):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 50.0, (2, B, N))
    v = r.standard_normal((2, B, N)) * 1.5
    s, s2 = np.concatenate([x, v], axis=2).astype(np.float32)
    out = [s, r.uniform(-1, 1, (B, A)).astype(np.float32), s2,
           r.uniform(0, 1, B).astype(np.float32), (r.uniform(size=B) < 0.25).astype(np.float32)]
    if with_bc:
        out.append(r.uniform(-1, 1, (B, A)).astype(np.float32))
    return out


def test_buffer_push_sample_and_wraparound():
    """Seven pushes into a ring of five (two wrap), with and without the BC
    action; a sample at JAX's randint draws equals JAX's ``buffer_sample``."""
    r = np.random.default_rng(0)
    jb = jbuffer.buffer_init(5, 6, 2)
    tb = ReplayBuffer(5, 6, 2, device="cpu")
    for i in range(7):
        s, a, s2 = r.standard_normal(6), r.standard_normal(2), r.standard_normal(6)
        rew, done = float(r.standard_normal()), float(i == 6)
        bc = r.standard_normal(2) if i % 2 else None
        cast = lambda t: None if t is None else t.astype(np.float32)
        jb = jbuffer.buffer_push(jb, *(jnp.asarray(cast(t)) for t in (s, a, s2)), rew, done,
                                 None if bc is None else jnp.asarray(cast(bc)))
        tb.push(*(torch.tensor(cast(t)) for t in (s, a, s2)), rew, done,
                None if bc is None else torch.tensor(cast(bc)))
    assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size)) == (2, 5)
    for t, j in zip(tb.fields(), (jb.state, jb.action, jb.next_state, jb.reward, jb.done,
                                  jb.action_bc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jax.random.randint(key, (11,), 0, 5))
    for t, j in zip(tb.sample(torch.tensor(idx)), jbuffer.buffer_sample(jb, key, 11)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    drawn = tb.draw_indices(torch.Generator().manual_seed(0), 1000)
    assert drawn.min() >= 0 and drawn.max() < 5


def test_compute_gae_matches_jax():
    r = np.random.default_rng(1)
    rew, val, nval = (r.standard_normal(12).astype(np.float32) for _ in range(3))
    done = (r.uniform(size=12) < 0.3).astype(np.float32)
    ja, jr = jppo.compute_gae(*(jnp.asarray(t) for t in (rew, val, done, nval)), 0.99, 0.9)
    ta, tr = ppo.compute_gae(*(torch.tensor(t) for t in (rew, val, done, nval)), 0.99, 0.9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [None, 1e-3, 10.0])
def test_adam_matches_optax(max_norm):
    """Three steps of Adam (clipped by global norm or not) on two tensors,
    the second one's gradient exactly zero in one entry."""
    r = np.random.default_rng(2)
    p = [r.standard_normal((3, 4)).astype(np.float32), r.standard_normal(5).astype(np.float32)]
    tx = optax.adam(0.01) if max_norm is None else optax.chain(
        optax.clip_by_global_norm(max_norm), optax.adam(0.01))
    jp = [jnp.asarray(a) for a in p]
    st = tx.init(jp)
    tp = [torch.tensor(a) for a in p]
    opt = Adam(tp, 0.01, max_norm=max_norm)
    for i in range(3):
        g = [r.standard_normal(a.shape).astype(np.float32) for a in p]
        g[1][0] = 0.0
        u, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, u)
        opt.step([torch.tensor(a) for a in g])
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_ddpg_update_matches_jax():
    """One TD3+BC update: the critics against one target, the actor against
    the updated q1, Polyak; losses and all six networks after the step."""
    jcfg, jctrl, cfg, ctrl = _cfgs()
    jhp, hp = jddpg.DDPGConfig(mlp_dim=16), ddpg.DDPGConfig(mlp_dim=16)
    nets, jts = jddpg.make_ddpg(jcfg, jctrl, jhp, jax.random.PRNGKey(0))
    ts = ddpg.make_ddpg(cfg, ctrl, hp, torch.Generator().manual_seed(0))
    pairs = [("actor", "actor_params"), ("q1", "q1_params"), ("q2", "q2_params"),
             ("target_actor", "target_actor_params"), ("target_q1", "target_q1_params"),
             ("target_q2", "target_q2_params")]
    for tname, jname in pairs:
        _load(getattr(ts, tname), getattr(jts, jname))
    batch = _batch(4)
    key = jax.random.PRNGKey(7)
    jts2, *jl = jddpg.update_policy(nets, jts, tuple(jnp.asarray(t) for t in batch), key, jhp)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (B, A))))
    tl = ddpg.update_policy(ts, tuple(torch.tensor(t) for t in batch), noise, hp)
    np.testing.assert_allclose([float(t) for t in tl], [float(j) for j in jl], rtol=RTOL)
    for tname, jname in pairs:
        _same_params(getattr(ts, tname), getattr(jts2, jname))


def test_ppo_update_matches_jax():
    """k_epoch=4 clipped-surrogate steps over one chunk of 8, each epoch's
    action draws from JAX's split keys; mean loss and the policy after."""
    jcfg, jctrl, cfg, ctrl = _cfgs()
    jhp, hp = jppo.PPOConfig(mlp_dim=16), ppo.PPOConfig(mlp_dim=16)
    nets, jts = jppo.make_ppo(jcfg, jctrl, jhp, jax.random.PRNGKey(1))
    ts = ppo.make_ppo(cfg, ctrl, hp, torch.Generator().manual_seed(1))
    _load(ts.policy, jts.params)
    s, _, s2, rew, done = _batch(5, with_bc=False)
    logp_old = (np.random.default_rng(6).standard_normal((B, 1)) - 2.0).astype(np.float32)
    chunk = (s, s2, logp_old, rew, done)
    key = jax.random.PRNGKey(8)
    jts2, jl = jppo.update_policy(nets, jts, tuple(jnp.asarray(t) for t in chunk), key, jhp)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, A)))
                      for k in jax.random.split(key, jhp.k_epoch)])
    tl = ppo.update_policy(ts, tuple(torch.tensor(t) for t in chunk), torch.tensor(noise), hp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _same_params(ts.policy, jts2.params)


def test_sac_update_matches_jax():
    """One SAC update: reward normalisation, entropy-regularised clamped
    target, critic, actor (through the entropy only), temperature, Polyak."""
    jcfg, jctrl, cfg, ctrl = _cfgs()
    jhp, hp = jsac.SACConfig(mlp_dim=16, batch_size=B), sac.SACConfig(mlp_dim=16, batch_size=B)
    nets, jts = jsac.make_sac(jcfg, jctrl, jhp, jax.random.PRNGKey(2))
    ts = sac.make_sac(cfg, ctrl, hp, torch.Generator().manual_seed(2))
    for tname, jname in (("actor", "actor_params"), ("critic", "critic_params"),
                         ("target_critic", "target_critic_params")):
        _load(getattr(ts, tname), getattr(jts, jname))
    batch = _batch(9)
    key = jax.random.PRNGKey(10)
    jts2, *jl = jsac.update_policy(nets, jts, tuple(jnp.asarray(t) for t in batch), key, jhp,
                                   float(-A))
    k1, k2 = jax.random.split(key)
    n1, n2 = (torch.tensor(np.asarray(jax.random.normal(k, (B, A)))) for k in (k1, k2))
    tl = sac.update_policy(ts, tuple(torch.tensor(t) for t in batch), n1, n2, hp, float(-A))
    np.testing.assert_allclose([float(t) for t in tl], [float(j) for j in jl], rtol=RTOL)
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(jts2.log_alpha), rtol=RTOL, atol=ATOL)
    for tname, jname in (("actor", "actor_params"), ("critic", "critic_params"),
                         ("target_critic", "target_critic_params")):
        _same_params(getattr(ts, tname), getattr(jts2, jname))


def _bc_data(seed, t=24):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 50.0, (t, N))
    v = r.standard_normal((t, N)) * 1.5 + 2.0 * np.sin(2 * np.pi * x / 50.0)
    states = np.concatenate([x, v], axis=1).astype(np.float32)
    actions = r.uniform(-1, 1, (t, A)).astype(np.float32)
    return states, actions, r.uniform(0, 1, t).astype(np.float32)


def test_behavior_cloning_matches_jax():
    """20 epochs of reward-weighted BC of the DeepSets actor with JAX's
    per-epoch noise: the final noise-free loss within 1e-3 relative."""
    jcfg, jctrl, cfg, ctrl = _cfgs()
    kw = dict(mlp_dim=16, n_bc_epochs=20)
    jhp, hp = jddpg.DDPGConfig(**kw), ddpg.DDPGConfig(**kw)
    nets, jts = jddpg.make_ddpg(jcfg, jctrl, jhp, jax.random.PRNGKey(3))
    ts = ddpg.make_ddpg(cfg, ctrl, hp, torch.Generator().manual_seed(3))
    _load(ts.actor, jts.actor_params)
    states, actions, rewards = _bc_data(11)
    key = jax.random.PRNGKey(12)
    jts2 = jddpg.behavior_cloning(nets, jts, *(jnp.asarray(t) for t in (states, actions, rewards)),
                                  key, jhp)
    noise = np.stack([np.asarray(jax.random.normal(k, actions.shape))
                      for k in jax.random.split(key, 20)])
    losses = ddpg.behavior_cloning(ts, *(torch.tensor(t) for t in (states, actions, rewards)),
                                   torch.tensor(noise), hp)
    assert losses.shape == (20,) and bool(torch.isfinite(losses).all())
    jpred = np.asarray(nets.actor.sample(jts2.actor_params, jnp.asarray(states)))
    tpred = ts.actor.sample(torch.tensor(states)).detach().numpy()
    loss = lambda pred: float(np.sum(np.sum((actions - pred) ** 2, axis=1) * rewards))
    np.testing.assert_allclose(loss(tpred), loss(jpred), rtol=1e-3)


def test_fit_bc_matches_jax():
    """DAgger's full-batch L2 fit of the spectral actor, 20 epochs: the last
    epoch's loss within 1e-3 relative."""
    jcfg, jctrl, cfg, ctrl = _cfgs()
    kw = dict(mlp_dim=16, encoder="spectral", encoder_modes=4)
    jhp, hp = jddpg.DDPGConfig(**kw), ddpg.DDPGConfig(**kw)
    nets, jts = jddpg.make_ddpg(jcfg, jctrl, jhp, jax.random.PRNGKey(4))
    ts = ddpg.make_ddpg(cfg, ctrl, hp, torch.Generator().manual_seed(4))
    _load(ts.actor, jts.actor_params)
    states, actions, _ = _bc_data(13)
    copy = lambda tree: jax.tree.map(jnp.array, tree)
    _, _, jl = jdagger.fit_bc(nets, copy(jts.actor_params), copy(jts.actor_opt),
                              jnp.asarray(states), jnp.asarray(actions), jax.random.PRNGKey(0),
                              jhp, 20)
    tl = dagger.fit_bc(ts.actor, ts.actor_opt, torch.tensor(states), torch.tensor(actions), 20)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
