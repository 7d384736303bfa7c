"""The RL networks of the port against the JAX package's flax modules on CPU:
flax-initialised weights carried across by ``interop``, the same seeded
inputs, outputs within 1e-5 relative (atol 1e-6 for entries near zero); the
committed DAgger actors' actions against JAX's ``actor.sample``; the weight
map's round trip and the port's own initialisation."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasma_control_tpu.control.rl import networks as jnets
from plasma_control_tpu_torch.control.rl import networks as tnets
from plasma_control_tpu_torch.interop import actor_params_from_numpy, actor_params_to_numpy
from plasma_control_tpu_torch.io.checkpoint import load_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, A, MLP = 40, 4, 16  # particles, actions, width
RTOL, ATOL = 1e-5, 1e-6


def _state(seed, batch, n=N, length=50.0):
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, length, (batch, n))
    v = r.standard_normal((batch, n)) * 1.5 + np.where(np.arange(n) < n // 2, 3.0, -3.0)
    return np.concatenate([x, v], axis=1).astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


# name -> (flax module, torch module, inputs are (state,) or (state, action))
NETS = {
    "ddpg_actor": (jnets.DDPGActor(MLP, A, output_min=-1.25, output_max=1.25),
                   lambda: tnets.DDPGActor(MLP, A, output_min=-1.25, output_max=1.25,
                                           generator=_gen()), False),
    "ddpg_critic": (jnets.DDPGCritic(MLP),
                    lambda: tnets.DDPGCritic(MLP, A, generator=_gen()), True),
    "spectral_actor": (jnets.SpectralActor(MLP, A, n_modes=5),
                       lambda: tnets.SpectralActor(MLP, A, n_modes=5, generator=_gen()), False),
    "attention_actor": (
        jnets.SpectralAttentionActor(MLP, A, n_modes=4, d_model=8, n_heads=2, n_layers=2),
        lambda: tnets.SpectralAttentionActor(MLP, A, n_modes=4, d_model=8, n_heads=2,
                                             n_layers=2, generator=_gen()), False),
    "attention_actor_v2": (
        jnets.SpectralAttentionActor(MLP, 6, n_modes=3, v_order=2, d_model=12, n_heads=3,
                                     n_layers=1),
        lambda: tnets.SpectralAttentionActor(MLP, 6, n_modes=3, v_order=2, d_model=12, n_heads=3,
                                             n_layers=1, generator=_gen()), False),
    "ppo": (jnets.PPOActorCritic(MLP, A, std_init=0.5),
            lambda: tnets.PPOActorCritic(MLP, A, std_init=0.5, generator=_gen()), False),
    "sac_actor": (jnets.SACActor(MLP, A), lambda: tnets.SACActor(2 * N, MLP, A, generator=_gen()),
                  False),
    "sac_critic": (jnets.SACCritic(MLP), lambda: tnets.SACCritic(2 * N, A, MLP, generator=_gen()),
                   True),
}


def _carried(name, seed=1):
    """(flax module, flax params, torch module holding the same weights)."""
    jnet, make, with_action = NETS[name]
    args = (jnp.zeros((1, 2 * N)),) + ((jnp.zeros((1, A)),) if with_action else ())
    params = jnet.init(jax.random.PRNGKey(seed), *args)
    tnet = make()
    tnet.load_state_dict(actor_params_from_numpy(jax.tree.map(np.asarray, params), tnet))
    return jnet, params, tnet, with_action


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_flax(name):
    jnet, params, tnet, with_action = _carried(name)
    s = _state(2, 5)
    args = (s,) + ((np.random.default_rng(3).uniform(-1, 1, (5, A)).astype(np.float32),)
                   if with_action else ())
    jout = jnet.apply(params, *(jnp.asarray(a) for a in args))
    tout = tnet(*(torch.tensor(a) for a in args))
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    for t, j in zip(tout, jout):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("v_order", [1, 2, 3])
def test_spectral_encoder_matches_flax(v_order):
    """The angle-addition recurrence and the feature order, 6 modes."""
    s = _state(4, 3, n=200)
    j = jnets.SpectralEncoder(6, 50.0, v_order).apply({}, jnp.asarray(s))
    enc = tnets.SpectralEncoder(6, 50.0, v_order)
    t = enc(torch.tensor(s))
    assert t.shape[-1] == enc.n_features == 2 * (v_order + 1) * 6 + v_order + 1
    _close(t, j)


@pytest.mark.parametrize("name,noise", [("ppo", True), ("ppo", False), ("sac_actor", True),
                                        ("sac_actor", False)])
def test_stochastic_sample_matches_flax(name, noise):
    """``sample`` with JAX's normal draw handed across, and the
    deterministic action."""
    jnet, params, tnet, _ = _carried(name)
    s = _state(5, 4)
    key = jax.random.PRNGKey(9)
    if noise:
        jout = jnet.sample(params, jnp.asarray(s), key=key)
        eps = np.asarray(jax.random.normal(key, (4, A)))
        tout = tnet.sample(torch.tensor(s), noise=torch.tensor(eps))
    else:
        jout = jnet.sample(params, jnp.asarray(s), deterministic=True)
        tout = tnet.sample(torch.tensor(s), deterministic=True)
    for t, j in zip(tout, jout):
        _close(t, j)


@pytest.mark.parametrize("name", sorted(NETS))
def test_weight_map_round_trip(name):
    """tree -> state_dict -> tree is the identity, key for key."""
    _, params, tnet, _ = _carried(name)
    back = actor_params_to_numpy(tnet)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(NETS))
def test_fresh_init_has_flax_shapes_and_scales(name):
    """The port draws the same tree as flax: equal shapes, zero biases, unit
    LayerNorm scales, kernels inside the +-2 sigma truncation of
    lecun-normal; the same generator seed draws the same weights."""
    jnet, params, tnet, _ = _carried(name)
    tree = actor_params_to_numpy(NETS[name][1]())
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, params))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        names = [p.key for p in path]
        if names[-1] == "bias":
            assert not leaf.any(), names
        elif names[-1] == "scale":
            np.testing.assert_array_equal(leaf, 1.0)
        elif names[-1] == "kernel":
            fan_in = leaf.shape[0] if names[-2] != "out" else leaf.shape[0] * leaf.shape[1]
            assert np.abs(leaf).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566 + 1e-6, names
    again = actor_params_to_numpy(NETS[name][1]())
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_attention_actor_rejects_short_token_list():
    with pytest.raises(ValueError):
        tnets.SpectralAttentionActor(MLP, 8, n_modes=3, generator=_gen())


SIMCASES = ["two_stream", "bump_on_tail", "landau"]


@pytest.mark.parametrize("simcase", SIMCASES)
def test_committed_dagger_actor_matches_jax(simcase):
    """Each committed DAgger actor (a SpectralActor, 34 features at 8 modes
    and v_order 1 -> 3 x 64 -> 6, 11,334 parameters), loaded by the port's
    msgpack reader, acts within 1e-5 of JAX's ``actor.sample`` on 8 seeded
    5000-particle states (actions in [-1, 1], absolute tolerance). The
    trained trunk amplifies the float32 rounding of the 5000-particle means:
    each package's actions lie up to 7.3e-6 from a float64 evaluation of the
    same weights, so the two agree to that order."""
    path = os.path.join(ROOT, "artifacts", f"dagger_actor_{simcase}.msgpack")
    jactor = jnets.SpectralActor(64, 6, output_min=-1.0, output_max=1.0)
    with open(path, "rb") as f:
        jparams = flax.serialization.msgpack_restore(f.read())
    tactor = load_params(path, like=tnets.SpectralActor(64, 6, generator=_gen()))
    assert sum(p.numel() for p in tactor.parameters()) == 11334
    s = _state(6, 8, n=5000)
    ja = jactor.sample(jparams, jnp.asarray(s))
    ta = tactor.sample(torch.tensor(s))
    assert ta.shape == (8, 6)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=0, atol=1e-5)
