"""The grid planner and multi-fidelity planning on CPU: the port's reduction,
fidelity statistics, grid candidate costs (all three integrators), one
reduced-fidelity plan and a short reduced-fidelity closed loop against the
JAX package, with the same state and noise handed to both as numpy."""

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
from plasma_control_tpu_torch.ops.grid import cached_grid, make_grid

torch.set_num_threads(1)

L, KA = 50.0, 2


def _plasma(n, seed, amplitude):
    """Two counter-streaming beams with a mode-1 density modulation of the
    given amplitude: 0 is a quiet plasma (the fidelity guard trips), 0.5 a
    coherent one (it passes)."""
    r = np.random.default_rng(seed)
    x0 = r.uniform(0, L, n)
    k1 = 2 * np.pi / L
    x = np.mod(x0 + (amplitude / k1) * np.sin(k1 * x0), L).astype(np.float32)
    v = (r.standard_normal(n) + np.where(np.arange(n) % 2 == 0, 3.0, -3.0)).astype(np.float32)
    return x, v


def _both(n, m, mpc_kw, sim_kw=None, amplitude=0.5, seed=0):
    sim = dict(simcase="two-stream", n_particles=n, n_mesh=m, dt=0.1, t_max=5.0, length=L,
               **(sim_kw or {}))
    x, v = _plasma(n, seed, amplitude)
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(m, L),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(max_mode=KA), mpc=JMPCConfig(**mpc_kw),
             actuator=jmake_actuator(L, m, KA))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(m, L, device="cpu"),
             cfg=SimConfig(**sim),
             ctrl=ControlConfig(max_mode=KA), mpc=MPCConfig(**mpc_kw),
             actuator=make_actuator(L, m, KA, device="cpu"))
    return j, t


def _jax_noise(key, cfg: JMPCConfig, d):
    """The (K, H, D) unit draws JAX's plan makes from ``key``: knot noise for
    ceil(K/2) candidates, mirrored."""
    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


@pytest.mark.parametrize("n,plan_particles,plan_mesh", [
    (5000, 1024, 64),  # the grid-planner slice: stride 4, n_eff 1250
    (701, 100, 16),  # stride 7, ceil: n_eff 101
    (700, 400, None),  # stride 1: full fidelity, frac 1.0
    (700, None, 16),  # mesh only
])
def test_reduction_matches_jax(n, plan_particles, plan_mesh):
    """Same stride arithmetic, same strided subsample (bitwise), same plan
    config and plan grid operator (float64-built, cast to float32)."""
    kw = dict(plan_particles=plan_particles, plan_mesh=plan_mesh)
    j, t = _both(n, 32 if plan_mesh else 64, kw)
    assert mpc._plan_frac(t["cfg"], t["mpc"]) == jmpc._plan_frac(j["cfg"], j["mpc"])
    jst, jgrid, jcfg = jmpc._plan_model(j["state"], j["grid"], j["cfg"], j["mpc"])
    tst, tgrid, tcfg = mpc._plan_model(t["state"], t["grid"], t["cfg"], t["mpc"])
    assert (tcfg.n_particles, tcfg.n_mesh) == (jcfg.n_particles, jcfg.n_mesh)
    assert tst.x.shape == (jcfg.n_particles,)
    np.testing.assert_array_equal(tst.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(tst.v.numpy(), np.asarray(jst.v))
    assert tgrid.n_mesh == jgrid.n_mesh
    np.testing.assert_allclose(tgrid.e_op.numpy(), np.asarray(jgrid.e_op), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("amplitude,safe", [(0.0, False), (0.5, True)], ids=["quiet", "coherent"])
def test_fidelity_statistics_match_jax(amplitude, safe):
    """plan_fidelity_check is host numpy on both sides over the same float32
    positions: equal to rtol 1e-6. The on-device ratio sums cos/sin of N
    particles in float32 in another order: rtol 1e-3."""
    kw = dict(plan_particles=500)
    j, t = _both(2000, 32, kw, amplitude=amplitude)
    jc = jmpc.plan_fidelity_check(j["state"], j["cfg"], j["ctrl"], j["mpc"])
    tc = mpc.plan_fidelity_check(t["state"], t["cfg"], t["ctrl"], t["mpc"])
    assert tc["safe"] == jc["safe"] == safe
    for key in ("coherent_pe", "injected_noise_pe", "ratio"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=1e-6)
    jr = jmpc._fidelity_ratio(j["state"].x, j["cfg"], j["ctrl"], j["mpc"])
    tr = mpc._fidelity_ratio(t["state"].x, t["cfg"], t["ctrl"], t["mpc"])
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-3)
    np.testing.assert_allclose(float(tr), tc["ratio"], rtol=1e-3)


GRID_PATHS = {
    "kdk-dense": (dict(plan_integrator="kdk"), dict(deposit_method="dense")),
    "kdk-pallas": (dict(plan_integrator="kdk"), dict(deposit_method="pallas")),
    "kdk-tsc": (dict(plan_integrator="kdk"), dict(interpol="tsc")),
    "leapfrog-exact": (dict(plan_integrator="leapfrog"), dict(deposit_method="pallas")),
    "leapfrog-kick-field": (dict(plan_integrator="leapfrog", exact_cost_energy=False), {}),
    "env-yoshida4": (dict(plan_integrator="env"), dict(deposit_method="pallas")),
    "env-split": (dict(plan_integrator="env", exact_cost_energy=False), {}),
    "env-verlet": (dict(plan_integrator="env"), dict(integrator="verlet")),
}


@pytest.mark.parametrize("path", GRID_PATHS)
def test_grid_candidate_costs_match_jax(path):
    """K=8 candidates, H=4 grid-PIC steps at N=300, M=32, with the terminal
    cost: the same ops in fp32, with deposits summed in another order (the
    port's plain CIC kernel scatters 4 taps; JAX's dense path sums an (N, M)
    tile, its Pallas path runs in interpret mode): rtol 2e-4, atol 1e-5, the
    bar of the spectral cost tests."""
    mpc_kw, sim_kw = GRID_PATHS[path]
    mpc_kw = dict(horizon=4, n_candidates=8, plan_model="grid", w_terminal=4.0, **mpc_kw)
    j, t = _both(300, 32, mpc_kw, sim_kw)
    cand = (0.3 * np.random.default_rng(4).standard_normal((8, 4, 2 * KA))).astype(np.float32)
    ref = jmpc.candidate_costs(j["state"], jnp.asarray(cand), j["grid"], j["cfg"], j["mpc"],
                               j["actuator"])
    got = mpc.candidate_costs(t["state"], torch.tensor(cand), t["grid"], t["cfg"], t["mpc"],
                              t["actuator"])
    assert got.shape == (8,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)


def test_grid_fused_plan_kernel_raises_like_jax():
    """plan_kernel="fused" is the spectral kernel: the grid model refuses it."""
    kw = dict(horizon=3, n_candidates=4, plan_model="grid", plan_kernel="fused")
    j, t = _both(128, 16, kw)
    cand = np.zeros((4, 3, 2 * KA), np.float32)
    with pytest.raises(ValueError):
        jmpc.candidate_costs(j["state"], jnp.asarray(cand), j["grid"], j["cfg"], j["mpc"],
                             j["actuator"])
    with pytest.raises(ValueError):
        mpc.candidate_costs(t["state"], torch.tensor(cand), t["grid"], t["cfg"], t["mpc"],
                            t["actuator"])


# the grid-planner slice's settings, cut to a CPU test: N=2000 -> n_eff 500
# (stride 4), plan mesh 16 of 32, guard on at ratio 3
REDUCED = dict(plan_particles=500, plan_mesh=16, horizon=4, n_candidates=16, w_terminal=4.0)
PLANS = {
    "grid-kdk": dict(plan_model="grid"),
    "grid-leapfrog": dict(plan_model="grid", plan_integrator="leapfrog"),
    "spectral": dict(plan_model="spectral", plan_modes=4),
}


@pytest.mark.parametrize("amplitude", [0.0, 0.5], ids=["guard-trips", "guard-passes"])
@pytest.mark.parametrize("model", PLANS)
def test_reduced_plan_matches_jax(model, amplitude):
    """One reduced-fidelity solve with JAX's draws handed over. MPPI's
    temperature of 0.05 turns a cost difference dc into a relative weight
    change of dc/0.05; with costs equal to ~1e-5 relative the new nominal and
    the action agree to atol 2e-4, the best cost to rtol 2e-4. A quiet plasma
    trips the guard: action and nominal are exactly zero on both sides."""
    kw = dict(REDUCED, **PLANS[model])
    j, t = _both(2000, 32, kw, dict(deposit_method="pallas"), amplitude=amplitude, seed=1)
    d = 2 * KA
    key = jax.random.PRNGKey(3)
    mean = (0.1 * np.random.default_rng(2).standard_normal((4, d))).astype(np.float32)
    ja, jm, jb = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                           j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    noise = torch.tensor(_jax_noise(key, j["mpc"], d))
    ta, tm, tb = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"],
                          t["ctrl"], t["mpc"], t["actuator"], noise=noise)
    tripped = amplitude == 0.0
    assert bool((tm == 0).all()) == bool((np.asarray(jm) == 0).all()) == tripped
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)


@pytest.mark.parametrize("amplitude", [0.0, 0.5], ids=["guard-trips", "guard-passes"])
def test_reduced_grid_closed_loop_matches_jax(amplitude):
    """Three control steps of the grid-planner slice's settings (reduced plan
    model, staggered KDK, guard on), each a solve plus a full Yoshida-4 step
    through the CIC kernel path, with JAX's per-step keys turned into the
    port's step_noise. Each solve's fp32 cost differences pass through the
    MPPI softmax (temperature 0.05) into the action and then into the state:
    the PE trace and plan costs agree to rtol 2e-3, the applied coefficients
    to atol 1e-3, and both sides zero the same solves."""
    kw = dict(REDUCED, plan_model="grid")
    j, t = _both(2000, 32, kw, dict(deposit_method="pallas"), amplitude=amplitude, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    jout = jmpc.mpc_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"],
                            keys[0], step_keys=keys)
    step_noise = torch.tensor(np.stack([_jax_noise(k, j["mpc"], 2 * KA) for k in keys]))
    tout = mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"], t["actuator"],
                           step_noise=step_noise)
    assert tout.field_energy.shape == (3,) and tout.final_mean.shape == (4, 2 * KA)
    zeroed = (tout.coeffs == 0).all(-1)
    np.testing.assert_array_equal(zeroed.numpy(), (np.asarray(jout.coeffs) == 0).all(-1))
    assert bool(zeroed.all()) if amplitude == 0.0 else not bool(zeroed.any())
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-3)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=2e-3)
    np.testing.assert_allclose(tout.plan_cost.numpy(), np.asarray(jout.plan_cost), rtol=2e-3)


def test_guard_is_off_at_full_fidelity_and_when_disabled():
    """plan_particles with stride 1, or fidelity_guard=False: the solve is
    returned as it is, even on a quiet plasma."""
    for kw in (dict(plan_particles=1500), dict(plan_particles=500, fidelity_guard=False)):
        _, t = _both(2000, 32, dict(kw, horizon=3, n_candidates=8, plan_model="grid"),
                     amplitude=0.0)
        out = (torch.ones(4), torch.ones(3, 4), torch.tensor(1.0))
        assert mpc._apply_fidelity_guard(out, t["state"].x, t["cfg"], t["ctrl"], t["mpc"]) is out
    _, t = _both(2000, 32, dict(plan_particles=500), amplitude=0.0)
    a, m, b = mpc._apply_fidelity_guard(out, t["state"].x, t["cfg"], t["ctrl"], t["mpc"])
    assert not a.any() and not m.any() and b is out[2]


def test_plan_grid_and_actuator_are_cached():
    """plan_mesh below M: the plan grid and the plan actuator are built at
    the plan mesh once, on the state's device, and reused."""
    _, t = _both(400, 32, dict(plan_mesh=16))
    cpu = torch.device("cpu")
    grid = mpc._reduced_model(t["grid"], t["cfg"], t["mpc"])[0]
    assert grid.n_mesh == 16 and grid is cached_grid(16, L, torch.float32, cpu)
    act = mpc._actuator_cache(L, 16, KA, torch.float32, cpu)
    assert act is mpc._actuator_cache(L, 16, KA, torch.float32, cpu)
    np.testing.assert_array_equal(act.basis_cos.numpy(), make_actuator(L, 16, KA, device=cpu).basis_cos.numpy())
