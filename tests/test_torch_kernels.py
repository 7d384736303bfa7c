"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. The
repo's conftest imports jax, which the GPU machine does not have, so run
them there with

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import dataclasses

import pytest
import torch

from plasma_control_tpu_torch.config import MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.mpc import candidate_costs
from plasma_control_tpu_torch.models.pic import PlasmaState
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops.kernels import cic
from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

L, M, N = 50.0, 250, 5000
KINDS = ["cic", "tsc", "tsc_standard"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; CPU tensors take "
                    "the plain versions, tested against JAX in test_torch_ops/_spectral)")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_deposit_matches_plain(dev, gen, kind, b):
    """fp32 atomics in varying order: rtol 1e-5, atol 1e-4; charge is
    conserved to 1e-5 relative."""
    x = torch.rand((b, N), generator=gen, device=dev) * L
    before = cic.deposit_cic.launches
    got = cic.deposit_cic(x, M, L, kind)
    assert cic.deposit_cic.launches == before + 1
    torch.testing.assert_close(got, cic.deposit_cic_plain(x, M, L, kind), rtol=1e-5, atol=1e-4)
    assert abs(float(got.sum()) - b * N) <= 1e-5 * b * N


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_matches_plain(dev, gen, kind, b):
    """A 4-tap sum per particle: atol 1e-5."""
    x = torch.rand((b, N), generator=gen, device=dev) * L
    e = torch.randn((b, M), generator=gen, device=dev)
    got = cic.gather_cic(e, x, M, L, kind)
    torch.testing.assert_close(got, cic.gather_cic_plain(e, x, M, L, kind), rtol=0.0, atol=1e-5)
    shared = cic.gather_cic(e[0], x, M, L, kind)  # one (M,) field for every row
    torch.testing.assert_close(shared, cic.gather_cic_plain(e[0], x, M, L, kind), rtol=0.0, atol=1e-5)


def test_deposit_wrap_edge(dev):
    x = torch.tensor([L * (1 - 1e-7), 0.0, 0.1, L - 0.1], device=dev)
    for kind in KINDS:
        torch.testing.assert_close(cic.deposit_cic(x, M, L, kind), cic.deposit_cic_plain(x, M, L, kind),
                                   rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km", [(5000, 384, 6, 8), (384, 7, 4, 5), (300, 16, 3, 16),
                                      (sh.MAX_PARTICLES, 8, 2, 4)])
def test_spectral_horizon_matches_plain(dev, gen, rot, n, k, h, km):
    """Mode sums reduced in another order: rtol 2e-4 (the JAX package's bar
    for the TPU kernel's drift variants)."""
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot)
    before = sh.spectral_horizon.launches
    got = sh.spectral_horizon(x0, v0, u_c, u_s, **kw)
    assert sh.spectral_horizon.launches == before + 1
    ref = sh.spectral_horizon_plain(x0, v0, u_c, u_s, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)


def test_spectral_horizon_refuses_unsupported_shapes(dev):
    n = sh.MAX_PARTICLES + 1
    x = torch.zeros(n, device=dev)
    u = torch.zeros((2, 2, 4), device=dev)
    with pytest.raises(ValueError):
        sh.spectral_horizon(x, x, u, u, length=L, dt=0.1, n0=1.0, n_particles=n, rot=True)
    with pytest.raises(TypeError):
        sh.spectral_horizon(x[:8].double(), x[:8].double(), u.double(), u.double(), length=L,
                            dt=0.1, n0=1.0, n_particles=8, rot=True)


def _cost_inputs(dev, gen, n, k=8, h=4, ka=2):
    cfg = SimConfig(simcase="bump-on-tail", n_particles=n, n_mesh=32, dt=0.1, t_max=5.0, length=L)
    st = PlasmaState(torch.rand(n, generator=gen, device=dev) * L,
                     torch.randn(n, generator=gen, device=dev))
    cand = 0.3 * torch.randn((k, h, 2 * ka), generator=gen, device=dev)
    return st, cand, make_grid(32, L, device=dev), cfg, make_actuator(L, 32, ka, device=dev)


@pytest.mark.parametrize("plan_kernel", ["auto", "xla", "fused"])
def test_candidate_costs_on_card_always_launch_the_kernel(dev, gen, plan_kernel):
    """Every plan_kernel setting scores CUDA candidates with one kernel
    launch. Against the CPU: "auto" and "fused" match the kernel's plain
    version, "xla" the op-by-op scan (trig drift), to rtol 2e-4."""
    st, cand, grid, cfg, act = _cost_inputs(dev, gen, 512)
    mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=4, plan_kernel=plan_kernel)
    before = sh.spectral_horizon.launches
    got = candidate_costs(st, cand, grid, cfg, mpc, act)
    assert sh.spectral_horizon.launches == before + 1
    cpu = PlasmaState(st.x.cpu(), st.v.cpu())
    cpu_mpc = mpc if plan_kernel == "xla" else dataclasses.replace(mpc, plan_kernel="fused")
    ref = candidate_costs(cpu, cand.cpu(), make_grid(32, L), cfg, cpu_mpc,
                          make_actuator(L, 32, 2))
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("plan_kernel", ["auto", "xla"])
def test_candidate_costs_on_card_raise_beyond_the_kernel(dev, gen, plan_kernel):
    """No op-by-op fallback on the card: N above the kernel's limit raises."""
    st, cand, grid, cfg, act = _cost_inputs(dev, gen, sh.MAX_PARTICLES + 1)
    mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=4, plan_kernel=plan_kernel)
    with pytest.raises(ValueError):
        candidate_costs(st, cand, grid, cfg, mpc, act)
