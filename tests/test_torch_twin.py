"""The twin-corrected cost of subsampled spectral planning on CPU: the
noise-correction targets, the spectral horizon kernel's corrected variant
(its plain version against the Pallas TPU kernel in interpret mode), the
corrected candidate costs, one plan and a short closed loop of the port
against the JAX package, with the same state and noise handed to both."""

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
from plasma_control_tpu.ops.pallas.spectral_horizon import fused_spectral_horizon
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops import spectral
from plasma_control_tpu_torch.ops.kernels import twin_trajectory as tt
from plasma_control_tpu_torch.ops.kernels.spectral_horizon import spectral_horizon

torch.set_num_threads(1)

L, M, KA = 50.0, 32, 2
# config-4's twin-corrected controller cut to a CPU test: N=2000 -> a stride-4
# plan subsample of 500 particles, plan mesh 16, Km=4, guard on at ratio 3
TWIN = dict(plan_particles=500, plan_mesh=16, plan_correction="twin", plan_modes=4, horizon=4,
            n_candidates=16, w_terminal=4.0)
# like drift against like drift: JAX's fused Pallas kernel (interpret mode) and
# the port's kernel wrapper (plain version on CPU) with the rot drift; the XLA
# scan and the port's op-by-op path with the trig drift
PATHS = {"fused-rot": dict(plan_kernel="fused"), "xla-trig": dict(plan_kernel="xla")}


def _plasma(n, seed, amplitude):
    """Two counter-streaming beams with a mode-1 density modulation: 0 is a
    quiet plasma (the fidelity guard trips), 0.5 a coherent one."""
    r = np.random.default_rng(seed)
    x0 = r.uniform(0, L, n)
    k1 = 2 * np.pi / L
    x = np.mod(x0 + (amplitude / k1) * np.sin(k1 * x0), L).astype(np.float32)
    v = (r.standard_normal(n) + np.where(np.arange(n) % 2 == 0, 3.0, -3.0)).astype(np.float32)
    return x, v


def _both(mpc_kw, n=2000, amplitude=0.5, seed=0):
    sim = dict(simcase="two-stream", n_particles=n, n_mesh=M, dt=0.1, t_max=5.0, length=L,
               deposit_method="pallas")
    x, v = _plasma(n, seed, amplitude)
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(M, L),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(max_mode=KA), mpc=JMPCConfig(**mpc_kw),
             actuator=jmake_actuator(L, M, KA))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(M, L, device="cpu"),
             cfg=SimConfig(**sim), ctrl=ControlConfig(max_mode=KA), mpc=MPCConfig(**mpc_kw),
             actuator=make_actuator(L, M, KA, device="cpu"))
    return j, t


def _plan_models(j, t):
    """Both sides' reduced plan models and twin targets."""
    jst, jgrid, jcfg = jmpc._plan_model(j["state"], j["grid"], j["cfg"], j["mpc"])
    tst, tgrid, tcfg = mpc._plan_model(t["state"], t["grid"], t["cfg"], t["mpc"])
    jtarget = jmpc.twin_targets(j["state"].x, jst, jcfg, j["cfg"], j["ctrl"], j["mpc"])
    ttarget = mpc.twin_targets(t["state"].x, tst, tcfg, t["cfg"], t["ctrl"], t["mpc"])
    return (jst, jgrid, jcfg, jtarget), (tst, tgrid, tcfg, ttarget)


def _zero_drive_twin(st, cfg, km):
    """The plan state's (H, Km) mode-sum trajectories under no drive, with
    the trig drift: the port's zero-drive twin."""
    zero = torch.zeros(TWIN["horizon"], km)
    return spectral.rollout(st.x, st.v, zero, zero, length=L, dt=cfg.clamped_dt(), n0=cfg.n0,
                            n_particles=cfg.n_particles, rot=False)


def _jax_noise(key, cfg: JMPCConfig, d):
    """The (K, H, D) unit draws JAX's plan makes from ``key``."""
    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


@pytest.mark.parametrize("amplitude", [0.0, 0.5], ids=["quiet", "coherent"])
def test_twin_targets_match_jax(amplitude):
    """The zero-drive twin's (H, Km) mode-sum trajectory and the shrunk
    targets: full-state mode sums over 2000 particles and a 4-step op-by-op
    rollout of 500, float32 sums in another order: max |err| <= 1e-4 of the
    largest target component."""
    j, t = _both(TWIN, amplitude=amplitude)
    (jst, _, jcfg, jtarget), (tst, _, tcfg, ttarget) = _plan_models(j, t)
    km = TWIN["plan_modes"]
    jc0, js0 = jmpc._twin_mode_traj(jst, jcfg, j["mpc"], km)
    tc0, ts0 = _zero_drive_twin(tst, tcfg, km)
    for got, ref in ((tc0, jc0), (ts0, js0)) + tuple(zip(ttarget, jtarget)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (TWIN["horizon"], km)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_twin_targets_inactive_like_jax():
    """None without the correction and at full fidelity (stride 1)."""
    for kw in (dict(TWIN, plan_correction="none"), dict(TWIN, plan_particles=1500)):
        j, t = _both(kw)
        (_, _, _, jtarget), (_, _, _, ttarget) = _plan_models(j, t)
        assert jtarget is None and ttarget is None


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km", [(384, 8, 6, 6), (500, 12, 4, 4)])
def test_corrected_plain_matches_pallas_kernel(rot, n, k, h, km):
    """The corrected energies sum_m ((c_m - tc)^2 + (s_m - ts)^2) / k_m^2
    with targets of the size of the mode sums (~sqrt(N)): the same ops in
    the same order as the TPU kernel, mode sums reduced in another order:
    rtol 2e-4, the bar of the uncorrected variant."""
    r = np.random.default_rng(n + k)
    x = r.uniform(0, L, n).astype(np.float32)
    v = (2.0 * r.standard_normal(n)).astype(np.float32)
    u_c, u_s = ((0.3 * r.standard_normal((k, h, km))).astype(np.float32) for _ in range(2))
    tc, ts = ((np.sqrt(n) * r.standard_normal((h, km))).astype(np.float32) for _ in range(2))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot)
    ref = fused_spectral_horizon(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u_c),
                                 jnp.asarray(u_s), interpret=True, twin_c=jnp.asarray(tc),
                                 twin_s=jnp.asarray(ts), **kw)
    got = spectral_horizon(*(torch.tensor(a) for a in (x, v, u_c, u_s)),
                           twin_c=torch.tensor(tc), twin_s=torch.tensor(ts), **kw)
    assert got.shape == (k, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-6)
    plain = spectral_horizon(*(torch.tensor(a) for a in (x, v, u_c, u_s)), **kw)
    assert not torch.allclose(got, plain, rtol=1e-2)  # the targets change the energies


@pytest.mark.parametrize("path", PATHS)
def test_corrected_candidate_costs_match_jax(path):
    """Corrected costs of K=16 candidates on the plan model, with each side's
    own targets: rtol 2e-4, atol 1e-5, the bar of the uncorrected cost
    tests."""
    j, t = _both(dict(TWIN, **PATHS[path]))
    (jst, jgrid, jcfg, jtarget), (tst, tgrid, tcfg, ttarget) = _plan_models(j, t)
    jact = jmake_actuator(L, 16, KA)
    tact = make_actuator(L, 16, KA, device="cpu")
    cand = (0.3 * np.random.default_rng(4).standard_normal((16, 4, 2 * KA))).astype(np.float32)
    ref = jmpc.candidate_costs(jst, jnp.asarray(cand), jgrid, jcfg, j["mpc"], jact,
                               twin_target=jtarget)
    got = mpc.candidate_costs(tst, torch.tensor(cand), tgrid, tcfg, t["mpc"], tact,
                              twin_target=ttarget)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
    plain = mpc.candidate_costs(tst, torch.tensor(cand), tgrid, tcfg, t["mpc"], tact)
    assert not torch.allclose(got, plain, rtol=1e-3)


PLANS = {
    "guard-passes": (dict(), 0.5),
    "guard-trips": (dict(), 0.0),
    "guard-off": (dict(fidelity_guard=False), 0.0),
}


@pytest.mark.parametrize("case", PLANS)
def test_twin_plan_matches_jax(case):
    """One twin-corrected solve with JAX's draws handed over. MPPI's
    temperature of 0.05 turns a cost difference dc into a relative weight
    change of dc/0.05; with costs equal to ~1e-5 relative the nominal and
    the action agree to atol 2e-4, the best cost to rtol 2e-4. With the guard
    on, a quiet plasma zeroes the solve on both sides; with it off the
    corrected solve drives."""
    mpc_kw, amplitude = PLANS[case]
    j, t = _both(dict(TWIN, plan_kernel="fused", **mpc_kw), amplitude=amplitude, seed=1)
    d = 2 * KA
    key = jax.random.PRNGKey(3)
    mean = (0.1 * np.random.default_rng(2).standard_normal((4, d))).astype(np.float32)
    ja, jm, jb = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                           j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    noise = torch.tensor(_jax_noise(key, j["mpc"], d))
    ta, tm, tb = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"],
                          t["ctrl"], t["mpc"], t["actuator"], noise=noise)
    tripped = case == "guard-trips"
    assert bool((tm == 0).all()) == bool((np.asarray(jm) == 0).all()) == tripped
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)


def test_twin_with_grid_plan_model_raises_like_jax():
    """The grid planner has no per-mode phasor to correct: both packages
    raise ValueError at the first solve."""
    j, t = _both(dict(TWIN, plan_model="grid"))
    for plan, side, mean, sigma, key in (
            (jmpc.plan, j, jnp.zeros((4, 2 * KA)), jnp.asarray(0.3), jax.random.PRNGKey(0)),
            (mpc.plan, t, torch.zeros(4, 2 * KA), 0.3, torch.Generator())):
        with pytest.raises(ValueError):
            plan(side["state"], mean, sigma, key, side["grid"], side["cfg"], side["ctrl"],
                 side["mpc"], side["actuator"])


@pytest.mark.parametrize("path", PATHS)
def test_twin_closed_loop_matches_jax(path):
    """Three control steps of the twin-corrected controller with the guard
    off (the config-4 frontier's setting, so the corrected costs drive), each
    a solve plus a full Yoshida-4 step through the CIC kernel path, with
    JAX's per-step keys turned into the port's step_noise. The tolerances of
    test_torch_mpc.py::test_closed_loop_matches_jax: PE and plan costs rtol
    2e-3, applied coefficients atol 1e-3."""
    kw = dict(TWIN, fidelity_guard=False, **PATHS[path])
    j, t = _both(kw, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    jout = jmpc.mpc_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"],
                            keys[0], step_keys=keys)
    step_noise = torch.tensor(np.stack([_jax_noise(k, j["mpc"], 2 * KA) for k in keys]))
    tout = mpc.mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"], t["mpc"], t["actuator"],
                           step_noise=step_noise)
    assert not bool((tout.coeffs == 0).all())
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-3)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=2e-3)
    np.testing.assert_allclose(tout.plan_cost.numpy(), np.asarray(jout.plan_cost), rtol=2e-3)


@pytest.mark.parametrize("amplitude", [0.0, 0.5], ids=["quiet", "coherent"])
def test_twin_targets_on_cpu_are_the_plain_version(amplitude):
    """On CPU tensors mpc.twin_targets is the twin kernel's plain version,
    bitwise, and the kernel is never launched."""
    _, t = _both(TWIN, amplitude=amplitude)
    tst, _, tcfg = mpc._plan_model(t["state"], t["grid"], t["cfg"], t["mpc"])
    before = tt.twin_trajectory.launches
    got = mpc.twin_targets(t["state"].x, tst, tcfg, t["cfg"], t["ctrl"], t["mpc"])
    assert tt.twin_trajectory.launches == before == 0
    ref = tt.twin_trajectory_plain(
        t["state"].x, tst.x, tst.v, n_modes=TWIN["plan_modes"], horizon=TWIN["horizon"],
        length=L, dt=tcfg.clamped_dt(), n0=tcfg.n0, n_full=t["cfg"].n_particles,
        n_plan=tcfg.n_particles)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if amplitude:  # the coherent plasma's mode 1 is shrunk
        c0, _ = _zero_drive_twin(tst, tcfg, TWIN["plan_modes"])
        assert not torch.equal(got[0], c0)


def test_twin_trajectory_refuses_other_devices():
    x = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError):
        tt.twin_trajectory(x, x[::2], x[::2], n_modes=4, horizon=2, length=L, dt=0.1, n0=1.0,
                           n_full=8, n_plan=4)


@pytest.mark.parametrize("n_full,n_plan,cluster,slice_", [
    (100_000, 10_000, 16, 625),  # the twin slice
    (5000, 500, 4, 125),
    (2000, 500, 1, 500),
    (200_000, 20_000, 16, 1250),
])
def test_twin_trajectory_launch_geometry(n_full, n_plan, cluster, slice_):
    """The smallest power-of-two cluster that leaves at most 2048 particles
    of the larger state per CTA; the plan state's 16 B per particle in shared
    memory."""
    geo = tt.launch_geometry(n_full, n_plan)
    assert (geo.cluster, geo.slice, geo.shared_bytes) == (cluster, slice_, 16 * slice_)


def test_twin_trajectory_global_scratch_beyond_shared_memory():
    """At C=16 a CTA holds 230016 plan particles beside the kernel's static
    shared memory; one more moves the state to the global scratch."""
    assert tt.launch_geometry(2_300_160, 230_016).shared_bytes == 16 * 14_376
    assert tt.launch_geometry(2_300_170, 230_017).shared_bytes == 0
    assert tt.launch_geometry(100_000, 10_000, cluster=2) == (2, 5000, 80_000)
