"""The MPC solve on CPU: noise, the feedback seed, one plan and a short closed
loop of the port against the JAX package, with the same noise handed to
both (JAX's draws rebuilt from the key, passed to the port as numpy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import MPCConfig as JMPCConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import mpc as jmpc
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.control.feedback import feedback_coefficients as jfeedback
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.feedback import feedback_coefficients
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L, M, N, KA = 50.0, 32, 384, 2
SIM = dict(simcase="bump-on-tail", n_particles=N, n_mesh=M, dt=0.1, t_max=5.0, length=L,
           deposit_method="pallas")


def test_knot_noise_shape_and_unit_variance():
    """Every horizon step has unit marginal variance (the knot interpolation
    renormalizes); 4000 draws per step give a standard error of ~0.022."""
    gen = torch.Generator().manual_seed(0)
    eps = mpc.knot_noise(gen, 4000, 7, 4, 3, device="cpu")
    assert eps.shape == (4000, 7, 4) and eps.dtype == torch.float32
    var = eps.var(dim=(0, 2))
    np.testing.assert_allclose(var.numpy(), 1.0, atol=0.07)
    # knots at steps 0, 3, 6 are the raw draws; steps between are blends
    corr = torch.corrcoef(torch.stack([eps[:, 0, 0], eps[:, 1, 0]]))[0, 1]
    assert 0.5 < float(corr) < 0.95


def test_draw_noise_is_antithetic():
    gen = torch.Generator().manual_seed(1)
    cfg = MPCConfig(n_candidates=9, horizon=6)
    eps = mpc.draw_noise(gen, cfg, 6, 4, device="cpu")
    assert eps.shape == (9, 6, 4)
    assert torch.equal(eps[5:9], -eps[:4])


def test_feedback_coefficients_match(rng):
    """fp32 FFT of M=32 points on both sides: atol 1e-6."""
    e = rng.standard_normal((3, M)).astype(np.float32)
    ja, jb = jfeedback(jnp.asarray(e), 4)
    ta, tb = feedback_coefficients(torch.tensor(e), 4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


def _jax_noise(key, cfg: JMPCConfig, d):
    """The (K, H, D) unit draws JAX's plan makes from ``key``: knot noise for
    ceil(K/2) candidates, mirrored."""
    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


def _both(mpc_kw, seed=0):
    r = np.random.default_rng(seed)
    x = r.uniform(0, L, N).astype(np.float32)
    v = (r.standard_normal(N) * 1.5).astype(np.float32)
    v[N // 2:] += 3.0  # a beam, so the plasma has a field worth controlling
    jside = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(M, L),
                 cfg=JSimConfig(**SIM), ctrl=JControlConfig(max_mode=KA),
                 mpc=JMPCConfig(**mpc_kw), actuator=jmake_actuator(L, M, KA))
    tside = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(M, L, device="cpu"),
                 cfg=SimConfig(**SIM),
                 ctrl=ControlConfig(max_mode=KA), mpc=MPCConfig(**mpc_kw),
                 actuator=make_actuator(L, M, KA, device="cpu"))
    return jside, tside


# Like drift against like drift: JAX's fused Pallas kernel (interpret mode)
# against the port's kernel wrapper (plain version on CPU), each with the rot
# drift the angle gate picks here; and the XLA scan against the port's
# op-by-op path, both with the trig drift.
PLAN_PATHS = {
    "fused-rot": dict(plan_kernel="fused"),
    "xla-trig": dict(plan_kernel="xla"),
}


@pytest.mark.parametrize("path", PLAN_PATHS)
def test_plan_matches_jax(path):
    """MPPI's temperature of 0.05 turns a cost difference dc into a relative
    weight change of dc/0.05; with costs equal to ~1e-5 relative, the new
    nominal agrees to atol 2e-4 and the best cost to rtol 2e-4."""
    mpc_kw = dict(horizon=5, n_candidates=16, plan_modes=6, w_terminal=4.0, **PLAN_PATHS[path])
    j, t = _both(mpc_kw)
    d = 2 * KA
    key = jax.random.PRNGKey(5)
    mean = (0.1 * np.random.default_rng(2).standard_normal((5, d))).astype(np.float32)
    ja, jm, jb = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                           j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    noise = torch.tensor(_jax_noise(key, j["mpc"], d))
    ta, tm, tb = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"],
                          t["ctrl"], t["mpc"], t["actuator"], noise=noise)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)


@pytest.mark.parametrize("path", PLAN_PATHS)
def test_closed_loop_matches_jax(path):
    """Three control steps, each a solve plus a full Yoshida-4 step through
    the CIC kernel path, with JAX's per-step keys turned into the port's
    step_noise. Each solve's fp32 cost differences pass through the MPPI
    softmax (temperature 0.05) into the applied action and then into the
    state: the PE trace agrees to rtol 2e-3, the applied coefficients to
    atol 1e-3."""
    mpc_kw = dict(horizon=4, n_candidates=16, plan_modes=4, w_terminal=4.0, **PLAN_PATHS[path])
    j, t = _both(mpc_kw, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    jout = jmpc.mpc_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"],
                            keys[0], step_keys=keys)
    step_noise = torch.tensor(np.stack([_jax_noise(k, j["mpc"], 2 * KA) for k in keys]))
    tout = mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"], t["actuator"],
                           step_noise=step_noise)
    assert tout.field_energy.shape == (3,) and tout.coeffs.shape == (3, 2 * KA)
    assert tout.final_mean.shape == (4, 2 * KA)
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-3)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=2e-3)
    np.testing.assert_allclose(tout.plan_cost.numpy(), np.asarray(jout.plan_cost), rtol=2e-3)
    np.testing.assert_allclose(tout.final_state.x.numpy(), np.asarray(jout.final_state.x),
                               atol=1e-3)


def test_generator_draws_are_seeded():
    _, t = _both(dict(horizon=4, n_candidates=8, plan_modes=4))
    run = lambda: mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"],
                                  t["actuator"], torch.Generator().manual_seed(4), n_steps=2)
    a, b = run(), run()
    assert torch.equal(a.coeffs, b.coeffs)
    assert torch.isfinite(a.field_energy).all()


def test_mode_mismatch_raises():
    _, t = _both(dict(horizon=4, n_candidates=8, plan_modes=4))
    with pytest.raises(ValueError):
        mpc.plan(t["state"], torch.zeros(4, 6), 0.3, torch.Generator(), t["grid"], t["cfg"],
                 t["ctrl"], t["mpc"], t["actuator"])
