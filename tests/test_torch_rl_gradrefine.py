"""MPC gradient refinement on CPU against the JAX package (N=256, M=32,
H=3): ``_gradient_refine`` from the same nominal through the ``dense`` and
the ``scatter`` deposit, and whole ``plan`` solves with ``n_grad_iters=3``
(MPPI and CEM, JAX's noise handed across); the refined nominal within 1e-4.
The CIC kernels have no backward pass: ``deposit_method="pallas"`` raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import MPCConfig as JMPCConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import mpc as jmpc
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L, M, N, KA, H = 50.0, 32, 256, 2, 3
D = 2 * KA
TOL = 1e-4


def _both(deposit_method="dense", **mpc_kw):
    """A two-stream state with a mode-2 density ripple, so the field and its
    gradient are well above the noise, in both packages."""
    r = np.random.default_rng(0)
    x = r.uniform(0, L, N)
    x = ((x + 2.0 * np.sin(4 * np.pi * x / L)) % L).astype(np.float32)
    v = (r.standard_normal(N) * 1.5 + np.where(np.arange(N) < N // 2, 3.0, -3.0)).astype(
        np.float32)
    sim = dict(simcase="two-stream", n_particles=N, n_mesh=M, dt=0.1, t_max=5.0, length=L,
               deposit_method=deposit_method)
    kw = dict(dict(horizon=H, n_candidates=16, plan_modes=4, n_grad_iters=3), **mpc_kw)
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(M, L),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(max_mode=KA), mpc=JMPCConfig(**kw),
             actuator=jmake_actuator(L, M, KA))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(M, L, device="cpu"),
             cfg=SimConfig(**sim), ctrl=ControlConfig(max_mode=KA), mpc=MPCConfig(**kw),
             actuator=make_actuator(L, M, KA, device="cpu"))
    return j, t


def _mean(seed=1):
    return (0.1 * np.random.default_rng(seed).standard_normal((H, D))).astype(np.float32)


def _refine(side, mean, lib):
    return lib._gradient_refine(side["state"], mean, side["grid"], side["cfg"], side["ctrl"],
                                side["mpc"], side["actuator"])


@pytest.mark.parametrize("deposit_method,grad_lr", [("dense", 0.05), ("scatter", 0.05),
                                                    ("dense", 5.0)])
def test_gradient_refine_matches_jax(deposit_method, grad_lr):
    """Three Adam steps through three Yoshida-4 steps of the plan model; at
    grad_lr=5 the iterate hits the coefficient bounds and the refinement is
    rejected when it does not lower the cost, in both packages alike."""
    j, t = _both(deposit_method, grad_lr=grad_lr)
    mean = _mean()
    jr = np.asarray(_refine(j, jnp.asarray(mean), jmpc))
    tr = _refine(t, torch.tensor(mean), mpc)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=TOL)
    if grad_lr == 0.05:
        assert np.abs(jr - mean).max() > 0.1  # three steps of ~lr each moved it
    assert np.array_equal(jr, mean) == torch.equal(tr, torch.tensor(mean))


def _jax_noise(key, cfg, algo):
    """JAX's unit draws for one solve: knot noise for ceil(K/2) candidates,
    mirrored; CEM draws one such block per refit from the split keys."""
    def one(k):
        eps = jmpc.knot_noise(k, (cfg.n_candidates + 1) // 2, cfg.horizon, D, cfg.n_knots)
        return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])

    if algo == "mppi":
        return one(key)
    return np.stack([one(k) for k in jax.random.split(key, cfg.n_iters)])


@pytest.mark.parametrize("algo", ["mppi", "cem"])
def test_plan_with_refinement_matches_jax(algo):
    """A whole solve: sampling (op-by-op spectral costs), the MPPI or CEM
    update, then three refinement steps of the nominal."""
    j, t = _both(algo=algo, n_elites=4, plan_kernel="xla")
    mean = _mean(2)
    key = jax.random.PRNGKey(5)
    ja, jm, jb = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                           j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    noise = torch.tensor(_jax_noise(key, j["mpc"], algo))
    ta, tm, tb = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"],
                          t["ctrl"], t["mpc"], t["actuator"], noise=noise)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)
    # the refinement moved the sampled nominal
    unrefined = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"], t["ctrl"],
                         dataclasses.replace(t["mpc"], n_grad_iters=0), t["actuator"],
                         noise=noise)[1]
    assert float((tm - unrefined).abs().max()) > 1e-3


def test_pallas_deposit_raises():
    """The CIC kernels have no backward pass, so refinement refuses them
    before any work, in ``plan`` and in ``_gradient_refine``."""
    _, t = _both("pallas")
    with pytest.raises(ValueError, match="backward"):
        mpc.plan(t["state"], torch.zeros(H, D), 0.3, torch.Generator(), t["grid"], t["cfg"],
                 t["ctrl"], t["mpc"], t["actuator"])
    with pytest.raises(ValueError, match="backward"):
        _refine(t, torch.zeros(H, D), mpc)


def test_closed_loop_with_refinement_runs():
    """Two control steps of ``mpc_rollout`` with refinement from a seeded
    generator: finite energies and actions within the bounds."""
    _, t = _both(n_grad_iters=2)
    out = mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"], t["actuator"],
                          torch.Generator().manual_seed(0), n_steps=2)
    assert bool(torch.isfinite(out.field_energy).all()) and out.coeffs.abs().max() <= 1.0
