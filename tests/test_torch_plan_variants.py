"""The solve's variants on CPU against the JAX package: chunked candidate
costs (with and without padding, with and without the twin correction), CEM
over handed-in noise and AR(1)-coloured candidate noise."""

import dataclasses

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
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L, M, KA = 50.0, 32, 2


def _both(mpc_kw, n=1200, seed=0):
    """A coherent two-stream state (mode-1 density modulation 0.5) on both
    sides, so that a subsampled plan passes the fidelity guard."""
    sim = dict(simcase="two-stream", n_particles=n, n_mesh=M, dt=0.1, t_max=5.0, length=L,
               deposit_method="pallas")
    r = np.random.default_rng(seed)
    x0 = r.uniform(0, L, n)
    x = np.mod(x0 + (0.5 * L / (2 * np.pi)) * np.sin(2 * np.pi / L * x0), L).astype(np.float32)
    v = (r.standard_normal(n) + np.where(np.arange(n) % 2 == 0, 3.0, -3.0)).astype(np.float32)
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(M, L),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(max_mode=KA), mpc=JMPCConfig(**mpc_kw),
             actuator=jmake_actuator(L, M, KA))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(M, L, device="cpu"),
             cfg=SimConfig(**sim), ctrl=ControlConfig(max_mode=KA), mpc=MPCConfig(**mpc_kw),
             actuator=make_actuator(L, M, KA, device="cpu"))
    return j, t


def _knot_draws(key, cfg: JMPCConfig, d):
    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


def _plan_both(j, t, noise, key, d=2 * KA):
    """One solve on each side from the same nominal; JAX draws from ``key``,
    the port takes ``noise``."""
    mean = (0.1 * np.random.default_rng(2).standard_normal((j["mpc"].horizon, d))).astype(
        np.float32)
    jout = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                     j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    tout = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"], t["ctrl"],
                    t["mpc"], t["actuator"], noise=torch.tensor(noise))
    return jout, tout


def _assert_plans_close(jout, tout):
    """MPPI's and CEM's updates amplify cost differences of ~1e-5 relative:
    the nominal and the action to atol 2e-4, the best cost to rtol 2e-4 (the
    bars of test_torch_mpc.py::test_plan_matches_jax)."""
    (ja, jm, jb), (ta, tm, tb) = jout, tout
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)


@pytest.mark.parametrize("twin", [False, True], ids=["plain", "twin"])
@pytest.mark.parametrize("chunk", [4, 5], ids=["even", "padded"])
def test_chunked_costs_match_jax_and_unchunked(chunk, twin):
    """K=16 candidates in chunks of 4 (four full chunks) or 5 (the last
    padded with three copies of candidate 0, whose costs are dropped), on
    the subsampled plan model, with and without the twin targets: against
    JAX's chunked costs at rtol 2e-4 / atol 1e-5, and against the port's
    unchunked costs at rtol 1e-6 (the same per-candidate program)."""
    kw = dict(horizon=4, n_candidates=16, plan_modes=4, w_terminal=4.0, plan_kernel="fused",
              plan_particles=300, plan_chunk=chunk,
              plan_correction="twin" if twin else "none")
    j, t = _both(kw)
    jst, jgrid, jcfg = jmpc._plan_model(j["state"], j["grid"], j["cfg"], j["mpc"])
    tst, tgrid, tcfg = mpc._plan_model(t["state"], t["grid"], t["cfg"], t["mpc"])
    jtarget = jmpc.twin_targets(j["state"].x, jst, jcfg, j["cfg"], j["ctrl"], j["mpc"])
    ttarget = mpc.twin_targets(t["state"].x, tst, tcfg, t["cfg"], t["ctrl"], t["mpc"])
    assert (ttarget is not None) == twin
    cand = (0.3 * np.random.default_rng(6).standard_normal((16, 4, 2 * KA))).astype(np.float32)
    ref = jmpc.candidate_costs(jst, jnp.asarray(cand), jgrid, jcfg, j["mpc"], j["actuator"],
                               twin_target=jtarget)
    got = mpc.candidate_costs(tst, torch.tensor(cand), tgrid, tcfg, t["mpc"], t["actuator"],
                              twin_target=ttarget)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
    whole = mpc.candidate_costs(tst, torch.tensor(cand), tgrid, tcfg,
                                dataclasses.replace(t["mpc"], plan_chunk=None), t["actuator"],
                                twin_target=ttarget)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6)


def test_chunked_plan_matches_jax():
    """One chunked MPPI solve (chunks of 6 of K=16, padded) with JAX's draws
    handed over."""
    j, t = _both(dict(horizon=4, n_candidates=16, plan_modes=4, plan_chunk=6))
    key = jax.random.PRNGKey(8)
    _assert_plans_close(*_plan_both(j, t, _knot_draws(key, j["mpc"], 2 * KA), key))


@pytest.mark.parametrize("path", ["fused", "xla"])
def test_cem_plan_matches_jax(path):
    """CEM, two iterations over the 4 best of 16 candidates, with JAX's
    per-iteration draws handed over as (n_iters, K, H, D) noise: the same
    elites on both sides, so the refit nominal agrees to atol 2e-4."""
    kw = dict(horizon=4, n_candidates=16, plan_modes=4, algo="cem", n_elites=4, n_iters=2,
              plan_kernel=path)
    j, t = _both(kw)
    key = jax.random.PRNGKey(5)
    noise = np.stack([_knot_draws(k, j["mpc"], 2 * KA)
                      for k in jax.random.split(key, j["mpc"].n_iters)])
    _assert_plans_close(*_plan_both(j, t, noise, key))


def test_cem_closed_loop_matches_jax():
    """Two CEM control steps with JAX's step keys handed over as
    (T, n_iters, K, H, D) step_noise: PE rtol 2e-3, coefficients atol 1e-3
    (the closed-loop bars of test_torch_mpc.py)."""
    kw = dict(horizon=4, n_candidates=16, plan_modes=4, algo="cem", n_elites=4, n_iters=2)
    j, t = _both(kw, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jout = jmpc.mpc_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"],
                            keys[0], step_keys=keys)
    step_noise = np.stack([np.stack([_knot_draws(k, j["mpc"], 2 * KA)
                                     for k in jax.random.split(key, 2)]) for key in keys])
    tout = mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"], t["actuator"],
                           step_noise=torch.tensor(step_noise))
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-3)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=2e-3)


def test_smooth_noise_plan_matches_jax():
    """smooth_noise=0.6 wins over the knot default: JAX's plan colours its
    white draws AR(1) along the horizon; the port colours the same white
    draws with ar1_noise and gets the same solve."""
    kw = dict(horizon=5, n_candidates=16, plan_modes=4, smooth_noise=0.6)
    j, t = _both(kw)
    key = jax.random.PRNGKey(4)
    white = torch.tensor(np.asarray(jax.random.normal(key, (8, 5, 2 * KA), dtype=jnp.float32)))
    eps = mpc.ar1_noise(white, 0.6)
    assert not torch.equal(eps, white)
    _assert_plans_close(*_plan_both(j, t, torch.cat([eps, -eps]).numpy(), key))


def test_ar1_draws_have_unit_variance():
    """Every horizon step of the AR(1) draws keeps unit variance, and
    neighbouring steps correlate by beta: 8000 draws per step, standard
    error ~0.016."""
    cfg = MPCConfig(n_candidates=8000, horizon=6, smooth_noise=0.7, antithetic=False)
    eps = mpc.draw_noise(torch.Generator().manual_seed(0), cfg, 6, 1, device="cpu")
    assert eps.shape == (8000, 6, 1)
    np.testing.assert_allclose(eps.var(dim=(0, 2)).numpy(), 1.0, atol=0.07)
    corr = torch.corrcoef(torch.stack([eps[:, 2, 0], eps[:, 3, 0]]))[0, 1]
    np.testing.assert_allclose(float(corr), 0.7, atol=0.05)
    assert torch.equal(mpc.ar1_noise(eps, 0.0), eps)


def test_generator_draws_cover_the_variants():
    """With a generator instead of handed-in noise every variant solves:
    CEM draws n_iters blocks, AR(1) and chunking run, all seeded."""
    for kw in (dict(algo="cem", n_elites=3, n_iters=3), dict(smooth_noise=0.5),
               dict(plan_chunk=3)):
        _, t = _both(dict(horizon=4, n_candidates=8, plan_modes=4, **kw), n=400)
        a, b = (mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"],
                                t["actuator"], torch.Generator().manual_seed(4), n_steps=2)
                for _ in range(2))
        assert torch.equal(a.coeffs, b.coeffs) and torch.isfinite(a.field_energy).all()
