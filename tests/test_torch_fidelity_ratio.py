"""The fidelity guard's statistic on the CPU (``ops/kernels/fidelity_ratio.py``):
CPU tensors take the plain version, op by op, bitwise the guard's statistic
as the spectral plan model states it, and leave the kernel's launch count where it
was (0 in a process without a card); the launch geometry and the kernel's
parameter block. The kernel itself is held to the plain version in float32
and float64 on the card (``tests/test_torch_kernels.py``, ``cuda`` marker)."""

import ctypes
import math

import numpy as np
import pytest
import torch

from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc as port_mpc
from plasma_control_tpu_torch.ops.kernels import _build
from plasma_control_tpu_torch.ops.kernels import fidelity_ratio as fr
from plasma_control_tpu_torch.ops.spectral import mode_sums

L = 50.0


def _op_by_op(x, cfg, ctrl, mpc):
    """The guard's statistic in torch ops: the plan's particle fraction times
    the coherent energy (n0^2/N) sum_m max(c_m^2 + s_m^2 - N, 0) / k_m^2, over
    the injected noise n0^2 (1 - frac) sum_m 1/k_m^2, with 1/k_m^2 in
    float64."""
    n = cfg.n_particles
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    k = (2.0 * np.pi / cfg.length) * np.arange(1, km + 1)
    t = (2.0 * math.pi / cfg.length) * x.reshape(-1)
    c, s = mode_sums(torch.cos(t), torch.sin(t), km)
    power = torch.clamp(c * c + s * s - n, min=0.0)
    inv_k2 = torch.tensor(1.0 / (k * k), dtype=x.dtype, device=x.device)
    frac = port_mpc._plan_frac(cfg, mpc)
    coherent = frac * ((cfg.n0**2 / n) * torch.sum(power * inv_k2))
    injected = cfg.n0**2 * (1.0 - frac) * sum((1.0 / (k * k)).tolist())
    return coherent / max(injected, 1e-30)


def _modulated(n, amplitude, dtype, seed=0):
    """Uniform positions displaced by modes 1 and 3, so that the low modes
    carry coherent power above the Poisson floor."""
    g = torch.Generator().manual_seed(seed)
    x0 = torch.rand(n, generator=g, dtype=torch.float64) * L
    k1 = 2.0 * math.pi / L
    x = x0 + (amplitude / k1) * (torch.sin(k1 * x0) + 0.3 * torch.sin(3 * k1 * x0))
    return torch.remainder(x, L).to(dtype)


# (N, plan particles, max_mode, plan_modes): the guard's Km = max of the last two
CASES = [(777, 100, 3, 5), (5000, 1024, 4, 16), (20_000, 2048, 8, 32)]


@pytest.mark.parametrize("n,plan,max_mode,plan_modes", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_takes_the_plain_version_and_launches_nothing(n, plan, max_mode, plan_modes, dtype):
    """CPU tensors: the guard's statistic is the op-by-op code, bitwise, in
    the dtype of x, and the kernel's launch count stays where it was."""
    cfg = SimConfig(simcase="two-stream", n_particles=n, n_mesh=64, length=L)
    ctrl = ControlConfig(max_mode=max_mode)
    mpc = MPCConfig(plan_particles=plan, plan_modes=plan_modes)
    x = _modulated(n, 0.2, dtype)
    before = fr.fidelity_ratio.launches
    got = port_mpc._fidelity_ratio(x, cfg, ctrl, mpc)
    assert fr.fidelity_ratio.launches == before
    want = _op_by_op(x, cfg, ctrl, mpc)
    assert got.dtype == dtype and got.shape == () and torch.equal(got, want)
    assert float(got) > 0.0  # the modulated modes rise above their floor


def test_guard_on_the_cpu_leaves_the_launch_count_at_zero():
    """A guarded solve's gate on CPU tensors (_apply_fidelity_guard) runs
    the plain version: it zeroes an unsafe solve, keeps a safe one, and
    launches nothing."""
    cfg = SimConfig(simcase="two-stream", n_particles=5000, n_mesh=64, length=L)
    ctrl = ControlConfig(max_mode=4)
    mpc = MPCConfig(plan_particles=1024, plan_modes=16, fidelity_guard=True)
    out = (torch.ones(8), torch.ones(6, 8), torch.tensor(1.5))
    before = fr.fidelity_ratio.launches
    quiet = port_mpc._apply_fidelity_guard(out, _modulated(5000, 0.0, torch.float32), cfg, ctrl,
                                           mpc)
    loud = port_mpc._apply_fidelity_guard(out, _modulated(5000, 0.5, torch.float32), cfg, ctrl,
                                          mpc)
    assert fr.fidelity_ratio.launches == before
    assert not quiet[0].any() and not quiet[1].any() and quiet[2] is out[2]
    assert torch.equal(loud[0], out[0]) and torch.equal(loud[1], out[1])


@pytest.mark.parametrize("n,ctas", [(1, 1), (777, 1), (1024, 1), (1025, 2), (5000, 5),
                                    (100_000, 98), (270_336, 264), (1_000_000, 264)])
def test_launch_ctas(n, ctas):
    """One CTA per 1024 particles (4 per thread of 256), at most 264."""
    assert fr.launch_ctas(n) == ctas


def test_parameter_block():
    """The ctypes block mirrors the source's FidelityParams (8 scalars, 64
    k_m^2) and holds the model's constants in float32."""
    fr._params.cache_clear()
    p = fr._params(5000, 1, 16, L, 1.0, 5000, 0.25, 0.5)
    assert ctypes.sizeof(_build.FidelityParams) == 4 * (8 + _build.MAX_MODES)
    assert (p.n, p.x_st, p.km) == (5000, 1, 16)
    assert p.scale == pytest.approx(1.0 / 5000, rel=1e-7)
    assert p.frac == 0.25 and p.injected == 0.5 and p.n0sq == 1.0
    k1 = 2.0 * math.pi / L
    assert p.c_ang == pytest.approx(k1, rel=1e-7)
    assert list(p.k2[:16]) == pytest.approx([(m * k1) ** 2 for m in range(1, 17)], rel=1e-7)
    assert all(v == 0.0 for v in p.k2[16:])


def test_refuses_other_devices():
    """No kernel for a device that is neither the CPU nor CUDA."""
    with pytest.raises(RuntimeError, match="no kernel"):
        fr.fidelity_ratio(torch.empty(10, device="meta"), n_modes=4, length=L, n0=1.0,
                          n_particles=10, frac=0.5, injected=1.0)
