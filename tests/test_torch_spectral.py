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
from plasma_control_tpu_torch.ops import spectral
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops.kernels import _build
from plasma_control_tpu_torch.ops.kernels.spectral_horizon import (
    launch_geometry, spectral_horizon, spectral_horizon_supported, state_in_shared, use_rot,
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
    assert spectral_horizon_supported(5000, 17)  # Km > 16 runs in blocks of 16 modes
    assert not spectral_horizon_supported(5000, 65)
    # a cluster of 16 CTAs holds 16 slices of 227 KB less the 1408 B of
    # reduction scratch
    assert state_in_shared(231040, rot=False) and not state_in_shared(231041, rot=False)
    assert state_in_shared(308048, rot=True) and not state_in_shared(308049, rot=True)


def _setup(n, ka, **mpc_kw):
    kw = dict(simcase="bump-on-tail", n_particles=n, n_mesh=32, dt=0.1, t_max=5.0, length=L)
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    r = np.random.default_rng(n)
    x = r.uniform(0, L, n).astype(np.float32)
    v = (r.standard_normal(n) * 1.5).astype(np.float32)
    jst = JPlasmaState(jnp.asarray(x), jnp.asarray(v))
    tst = state_from_numpy(x, v, device="cpu")
    jside = (jst, jmake_grid(32, L), jcfg, jmake_actuator(L, 32, ka))
    tside = (tst, make_grid(32, L, device="cpu"), tcfg, make_actuator(L, 32, ka, device="cpu"))
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
    """On CPU tensors plan_kernel="xla" and "auto" name the JAX package's
    op-by-op scan, whose drift is trig: both score on the kernel wrapper's
    plain version with the trig drift, bitwise plan_kernel="fused" with
    spectral_drift="trig", whatever drift the configuration names."""
    n, ka = 256, 2
    _, (tst, tg, tcfg, tact) = _setup(n, ka)
    cand = 0.3 * torch.randn((10, 5, 2 * ka), generator=torch.Generator().manual_seed(1))
    kw = dict(horizon=5, n_candidates=10, plan_modes=4, w_terminal=2.0)
    fused = candidate_costs(tst, cand, tg, tcfg,
                            MPCConfig(plan_kernel="fused", spectral_drift="trig", **kw), tact)
    rot = candidate_costs(tst, cand, tg, tcfg, MPCConfig(plan_kernel="fused", **kw), tact)
    assert not torch.equal(fused, rot)  # the default drift at dt=0.1, L=50 is rot
    for plan_kernel in ("xla", "auto"):
        for drift in (None, "rot"):
            mpc = MPCConfig(plan_kernel=plan_kernel, spectral_drift=drift, **kw)
            assert torch.equal(candidate_costs(tst, cand, tg, tcfg, mpc, tact), fused)


def test_zero_drive_candidate_reproduces_the_twin():
    """A zero-drive candidate on the trig drift, scored against the plan
    state's unshrunk zero-drive twin as its target: its corrected energy
    vanishes up to float32 rounding, at most 1e-6 of its uncorrected energy
    (the candidates' (K, N) row sums and the twin's (N,) sums need not round
    alike)."""
    n, h, km = 500, 6, 4
    x, v, _, _ = _inputs(3, n, 1, h, km)
    x, v = torch.tensor(x), torch.tensor(v)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n)
    zero = torch.zeros(h, km)
    tc, ts = spectral.rollout(x, v, zero, zero, rot=False, **kw)
    u = torch.zeros(3, h, km)
    plain = spectral_horizon(x, v, u, u, rot=False, **kw)
    corrected = spectral_horizon(x, v, u, u, rot=False, twin_c=tc, twin_s=ts, **kw)
    assert plain.shape == corrected.shape == (3, h) and bool((plain > 0).all())
    assert bool((corrected.abs() <= 1e-6 * plain).all()), (corrected, plain)


def test_plain_horizon_above_the_old_particle_cap_matches_jax_xla():
    """N=15000, above the 14336 particles the kernel once held in one CTA:
    the port's plain spectral horizon (plan_kernel="fused", trig drift; on
    the card the kernel on a cluster of CTAs) against the JAX package's XLA
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


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n", [1, 7, 255, 2730, 5000, 5462, 10_000, 20_000, 100_000, 231_041,
                               308_048, 308_049, 1_000_003])
def test_launch_geometry_covers_every_particle(n, rot):
    """The kernel's split of one candidate over a cluster, as the kernel
    computes it (CTA r: lo = min(r S, N), min(S, N - lo) particles): every
    particle in exactly one CTA; C a power of two within the cluster limit,
    the smallest whose slice fits 64 KiB, 16 where none does; a slice in
    shared memory within one CTA's share beside the kernel's 1408 B of
    reduction scratch, else the global scratch."""
    geo = launch_geometry(n, rot)
    per = 12 if rot else 16
    assert geo.cluster in (1, 2, 4, 8, 16) and geo.cluster <= _build.MAX_CLUSTER
    assert geo.slice == -(-n // geo.cluster)
    owners = np.zeros(n, dtype=int)
    for r in range(geo.cluster):
        lo = min(r * geo.slice, n)
        owners[lo:lo + min(geo.slice, n - lo)] += 1
    assert (owners == 1).all()
    fits = per * geo.slice <= _build.SHARED_BYTES - 1408
    assert geo.shared_bytes == (per * geo.slice if fits else 0)
    if geo.cluster < _build.MAX_CLUSTER:
        assert per * geo.slice <= 64 * 1024
    if geo.cluster > 1:
        assert per * -(-n // (geo.cluster // 2)) > 64 * 1024
    assert state_in_shared(n, rot) == fits


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
def test_drive_views_padded_to_n_modes(rot):
    """candidate_costs hands the kernel (K, H, Ka) views of one candidate
    tensor and the model's Km: the same energies as zero-padded (K, H, Km)
    inputs, exactly, and as the Pallas kernel on those to rtol 2e-4."""
    x, v, u_c, u_s = _inputs(5, 384, 6, 4, 3)
    cand = torch.tensor(np.concatenate([u_c, u_s], axis=-1))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=384, rot=rot)
    got = spectral_horizon(torch.tensor(x), torch.tensor(v), cand[..., :3], cand[..., 3:],
                           n_modes=8, **kw)
    pad = ((0, 0), (0, 0), (0, 5))
    pc, ps = np.pad(u_c, pad), np.pad(u_s, pad)
    assert torch.equal(got, spectral_horizon(torch.tensor(x), torch.tensor(v), torch.tensor(pc),
                                             torch.tensor(ps), **kw))
    ref = fused_spectral_horizon(jnp.asarray(x), jnp.asarray(v), jnp.asarray(pc), jnp.asarray(ps),
                                 interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-6)
