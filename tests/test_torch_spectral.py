"""The spectral planner on CPU: the CUDA kernel's plain version against the
Pallas TPU kernel it replaces (interpret mode), and the port's candidate
costs against the JAX package's on both planning paths."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import MPCConfig as JMPCConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.control.mpc import candidate_costs as jcandidate_costs
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu.ops.pallas.spectral_horizon import fused_spectral_horizon
from plasma_control_tpu_torch.config import MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.mpc import candidate_costs
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops.kernels.spectral_horizon import (
    spectral_horizon, spectral_horizon_supported, state_in_shared, use_rot,
)

torch.set_num_threads(1)

L = 50.0


def _inputs(seed, n, k, h, km):
    r = np.random.default_rng(seed)
    x = r.uniform(0, L, n).astype(np.float32)
    v = (2.0 * r.standard_normal(n)).astype(np.float32)
    u_c = (0.3 * r.standard_normal((k, h, km))).astype(np.float32)
    u_s = (0.3 * r.standard_normal((k, h, km))).astype(np.float32)
    return x, v, u_c, u_s


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km", [(384, 8, 6, 6), (500, 12, 4, 4), (512, 16, 5, 5)])
def test_plain_matches_pallas_kernel(rot, n, k, h, km):
    """Same ops in the same order as the TPU kernel; the mode sums reduce in
    another order (and N=384, 500 exercise the TPU side's lane padding):
    rtol 2e-4, the bar of the JAX package's own drift-equivalence test."""
    x, v, u_c, u_s = _inputs(n + k, n, k, h, km)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot)
    ref = fused_spectral_horizon(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u_c),
                                 jnp.asarray(u_s), interpret=True, **kw)
    got = spectral_horizon(torch.tensor(x), torch.tensor(v), torch.tensor(u_c),
                           torch.tensor(u_s), **kw)
    assert got.shape == (k, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-6)


def test_drift_gate_and_limits():
    assert use_rot(0.1, 50.0) and use_rot(0.1, 50.0, "auto")  # 2pi/50*0.1*25 = 0.31
    assert not use_rot(0.5, 10.0) and use_rot(0.5, 10.0, "rot")
    assert not use_rot(0.1, 50.0, "trig")
    assert spectral_horizon_supported(5000, 8)
    assert spectral_horizon_supported(100_000, 8)  # any N: large N keeps its state in global memory
    assert not spectral_horizon_supported(5000, 17)
    assert state_in_shared(14448, rot=False) and not state_in_shared(14449, rot=False)
    assert state_in_shared(19264, rot=True) and not state_in_shared(19265, rot=True)


def _setup(n, ka, **mpc_kw):
    kw = dict(simcase="bump-on-tail", n_particles=n, n_mesh=32, dt=0.1, t_max=5.0, length=L)
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    r = np.random.default_rng(n)
    x = r.uniform(0, L, n).astype(np.float32)
    v = (r.standard_normal(n) * 1.5).astype(np.float32)
    jst = JPlasmaState(jnp.asarray(x), jnp.asarray(v))
    tst = state_from_numpy(x, v)
    jside = (jst, jmake_grid(32, L), jcfg, jmake_actuator(L, 32, ka))
    tside = (tst, make_grid(32, L), tcfg, make_actuator(L, 32, ka))
    return jside, tside


@pytest.mark.parametrize("mpc_kw", [
    dict(horizon=4, n_candidates=8, plan_modes=4, w_terminal=3.0),
    dict(horizon=5, n_candidates=16, plan_modes=6, w_terminal=4.0, spectral_drift="trig"),
    dict(horizon=6, n_candidates=12, plan_modes=5, terminal_mode="growth", terminal_steps=3),
])
def test_candidate_costs_kernel_path_matches_jax_fused(mpc_kw):
    """Port with plan_kernel="fused" (the kernel wrapper; its plain version
    on CPU) against JAX's fused Pallas path in interpret mode, including the
    ka -> km zero padding and the terminal cost: rtol 2e-4, atol 1e-5, the
    bar of the JAX package's fused-vs-XLA cost test."""
    n, ka = 384, 2
    (jst, jg, jcfg, jact), (tst, tg, tcfg, tact) = _setup(n, ka)
    r = np.random.default_rng(7)
    cand = (0.3 * r.standard_normal((mpc_kw["n_candidates"], mpc_kw["horizon"], 2 * ka))
            ).astype(np.float32)
    ref = jcandidate_costs(jst, jnp.asarray(cand), jg, jcfg,
                           JMPCConfig(plan_kernel="fused", **mpc_kw), jact)
    got = candidate_costs(tst, torch.tensor(cand), tg, tcfg,
                          MPCConfig(plan_kernel="fused", **mpc_kw), tact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("mpc_kw", [
    dict(horizon=4, n_candidates=8, plan_modes=4, w_terminal=3.0),
    dict(horizon=5, n_candidates=6, plan_modes=3, terminal_mode="growth", cost_pe_nref=None),
])
def test_candidate_costs_op_path_matches_jax_xla(mpc_kw):
    """Port's op-by-op path (the default on CPU tensors) against JAX's XLA
    scan (JAX's CPU default): same trig drift and float32 constants on both
    sides; rtol 2e-4, atol 1e-5."""
    n, ka = 300, 2
    (jst, jg, jcfg, jact), (tst, tg, tcfg, tact) = _setup(n, ka)
    r = np.random.default_rng(8)
    cand = (0.3 * r.standard_normal((mpc_kw["n_candidates"], mpc_kw["horizon"], 2 * ka))
            ).astype(np.float32)
    ref = jcandidate_costs(jst, jnp.asarray(cand), jg, jcfg, JMPCConfig(**mpc_kw), jact)
    got = candidate_costs(tst, torch.tensor(cand), tg, tcfg, MPCConfig(**mpc_kw), tact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)


def test_kernel_and_op_paths_agree_on_trig():
    """Within the port: the kernel wrapper's trig drift and the op-by-op path
    rank candidates alike (costs within 2e-4; the kernel path rounds its
    per-mode constants from float64, the op path computes them in float32)."""
    n, ka = 256, 2
    _, (tst, tg, tcfg, tact) = _setup(n, ka)
    cand = 0.3 * torch.randn((10, 5, 2 * ka), generator=torch.Generator().manual_seed(1))
    kw = dict(horizon=5, n_candidates=10, plan_modes=4, w_terminal=2.0, spectral_drift="trig")
    fused = candidate_costs(tst, cand, tg, tcfg, MPCConfig(plan_kernel="fused", **kw), tact)
    ops = candidate_costs(tst, cand, tg, tcfg, MPCConfig(plan_kernel="xla", **kw), tact)
    np.testing.assert_allclose(fused.numpy(), ops.numpy(), rtol=2e-4, atol=1e-5)
    assert torch.equal(torch.argsort(fused), torch.argsort(ops))


def test_plain_horizon_above_the_old_particle_cap_matches_jax_xla():
    """N=15000, above the 14336 particles the kernel once held: the port's
    plain spectral horizon (plan_kernel="fused", trig drift; on the card the
    kernel with its state in global memory) against the JAX package's XLA
    scan, K=4, H=3: rtol 2e-4, atol 1e-5, the bar of the cost tests above."""
    n, ka = 15_000, 2
    (jst, jg, jcfg, jact), (tst, tg, tcfg, tact) = _setup(n, ka)
    cand = (0.3 * np.random.default_rng(9).standard_normal((4, 3, 2 * ka))).astype(np.float32)
    kw = dict(horizon=3, n_candidates=4, plan_modes=4, w_terminal=2.0)
    ref = jcandidate_costs(jst, jnp.asarray(cand), jg, jcfg, JMPCConfig(plan_kernel="xla", **kw),
                           jact)
    got = candidate_costs(tst, torch.tensor(cand), tg, tcfg,
                          MPCConfig(plan_kernel="fused", spectral_drift="trig", **kw), tact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
