"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. The
repo's conftest imports jax, which the GPU machine does not have, so run
them there with

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from plasma_control_tpu_torch.config import MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.mpc import candidate_costs
from plasma_control_tpu_torch.models.pic import PlasmaState
from plasma_control_tpu_torch.ops import deposit as dep
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops.kernels import cic
from plasma_control_tpu_torch.ops.kernels import fused_step as fs
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
    """Exact fixed-point sums against the plain version's fp32 sums: rtol
    1e-5, atol 1e-4; charge is conserved to 1e-5 relative."""
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


def _device_ops(fn, tmp_path):
    """Names of the device kernels, copies and sets that one call of ``fn``
    puts on the card, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e["name"] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("ph") == "X"]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_shared_field_and_unwrapped_positions(dev, gen, kind, b):
    """Positions in [-L, 2L) and one (M,) field read at row stride 0: the
    kernel wraps as torch.remainder does, atol 1e-5 against the plain
    version, and deposit.gather(method="pallas") agrees with the dense
    method to the dense tests' bar (rtol 1e-5, atol 1e-4)."""
    x = torch.rand((b, N), generator=gen, device=dev) * (3 * L) - L
    e = torch.randn(M, generator=gen, device=dev)
    before = cic.gather_cic.launches
    got = cic.gather_cic(e, x, M, L, kind)
    assert cic.gather_cic.launches == before + 1
    torch.testing.assert_close(got, cic.gather_cic_plain(e, x, M, L, kind), rtol=0.0, atol=1e-5)
    # a (1, M) field and a strided field take the layout path to the same launch
    assert torch.equal(cic.gather_cic(e[None], x, M, L, kind), got)
    e2 = torch.stack([e, e], dim=-1)[:, 0]
    assert not e2.is_contiguous() and torch.equal(cic.gather_cic(e2, x, M, L, kind), got)
    grid = make_grid(M, L, device=dev)
    torch.testing.assert_close(dep.gather(e, x, grid, kind=kind, method="pallas"),
                               dep.gather(e, x, grid, kind=kind, method="dense"),
                               rtol=1e-5, atol=1e-4)


def test_gather_is_one_device_op(dev, gen, tmp_path):
    """The env path's gather: a shared field, unwrapped positions, one
    kernel on the card and nothing else (no remainder, no field copy)."""
    x = torch.rand((4, N), generator=gen, device=dev) * (3 * L) - L
    e = torch.randn(M, generator=gen, device=dev)
    grid = make_grid(M, L, device=dev)
    dep.gather(e, x, grid, method="pallas")
    names = _device_ops(lambda: dep.gather(e, x, grid, method="pallas"), tmp_path)
    assert len(names) == 1 and "gather_kernel" in names[0], names


# kernel 2's shapes on the main paths: the spectral and grid slices'
# environment, and the config-4 / twin environment
DEPOSIT_SHAPES = [(5000, 250), (100_000, 256)]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_deposit_wraps_and_scales_like_plain(dev, gen, kind, b):
    """Positions in [-L, 2L), wrapped in the kernel as torch.remainder wraps
    them, and the normalisation n0 L / N / dx applied in the kernel: rtol
    1e-5, atol 1e-4 against the plain version."""
    x = torch.rand((b, N), generator=gen, device=dev) * (3 * L) - L
    scale = L / N / (L / M)
    got = cic.deposit_cic(x, M, L, kind, scale=scale)
    torch.testing.assert_close(got, cic.deposit_cic_plain(x, M, L, kind, scale=scale),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,m", DEPOSIT_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_deposit_is_deterministic(dev, gen, kind, n, m):
    """Fixed-point counts: two launches give bitwise equal densities."""
    x = torch.rand((1, n), generator=gen, device=dev) * (3 * L) - L
    first = cic.deposit_cic(x, m, L, kind)
    assert torch.equal(first, cic.deposit_cic(x, m, L, kind))


@pytest.mark.parametrize("kind", KINDS)
def test_deposit_is_the_same_at_every_cluster_size(dev, gen, kind):
    """At N=100000 the wrapper may choose any cluster of 1-16 CTAs per row:
    every size gives bitwise the same row, within rtol 1e-5, atol 1e-4 of
    the plain version."""
    n, m = DEPOSIT_SHAPES[1]
    x = torch.rand((1, n), generator=gen, device=dev) * (3 * L) - L
    assert cic.deposit_cluster(n, 1, dev.index or 0) in (1, 2, 4, 8, 16)
    one = cic._deposit_cuda(x, m, L, kind, 1.0, 1)
    for c in (2, 4, 8, 16):
        assert torch.equal(cic._deposit_cuda(x, m, L, kind, 1.0, c), one), c
    torch.testing.assert_close(one, cic.deposit_cic_plain(x, m, L, kind), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,m", DEPOSIT_SHAPES)
def test_deposit_is_one_device_op(dev, gen, tmp_path, n, m):
    """deposit(method="pallas") on unwrapped positions with the
    normalisation: one kernel on the card and nothing else (no remainder,
    no memset, no multiply), as close to the dense method as the dense
    tests hold it (rtol 1e-5, atol 1e-4)."""
    x = torch.rand((1, n), generator=gen, device=dev) * (3 * L) - L
    grid = make_grid(m, L, device=dev)
    before = cic.deposit_cic.launches
    got = dep.deposit(x, grid, n0=1.3, method="pallas")
    assert cic.deposit_cic.launches == before + 1
    names = _device_ops(lambda: dep.deposit(x, grid, n0=1.3, method="pallas"), tmp_path)
    assert len(names) == 1 and "deposit_kernel" in names[0], names
    if n <= 5000:
        torch.testing.assert_close(got, dep.deposit(x, grid, n0=1.3, method="dense"),
                                   rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got, dep.deposit(x, grid, n0=1.3, method="scatter"),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_deposit_rows_and_mesh_limit(dev, gen, kind):
    """Batched rows on gridDim.y (a (2, 3, N) batch, 700 short rows) and the
    mesh at its limit of 12288 cells (96 KB of counts per CTA), against the
    plain version; beyond the limit the wrapper raises."""
    for shape, m in (((2, 3, 3000), M), ((700, 64), 32), ((2, 20_000), 12288)):
        x = torch.rand(shape, generator=gen, device=dev) * L
        got = cic.deposit_cic(x, m, L, kind)
        assert got.shape == shape[:-1] + (m,)
        torch.testing.assert_close(got, cic.deposit_cic_plain(x, m, L, kind), rtol=1e-5, atol=1e-4)
        assert torch.equal(got, cic.deposit_cic(x, m, L, kind))
    with pytest.raises(ValueError):
        cic.deposit_cic(x, 12289, L, kind)


def test_deposit_wrap_edge(dev):
    x = torch.tensor([L * (1 - 1e-7), 0.0, 0.1, L - 0.1], device=dev)
    for kind in KINDS:
        torch.testing.assert_close(cic.deposit_cic(x, M, L, kind), cic.deposit_cic_plain(x, M, L, kind),
                                   rtol=0.0, atol=1e-6)


# sha256 of the gather kernel's float32 output on _fixed_gather_input, per
# kind, as the kernel computed it before its cell wrap became a compare and
# an add and its position wrap skipped fmodf where that is exact (NVIDIA H100
# 80GB HBM3): neither change may alter one bit
GATHER_SHA256 = {
    "cic": "7edc3857c570225435f061f3a679911526ce77813e287994440d84b0e2e0cdac",
    "tsc": "535accd6fa65c28b20f74032cedb1f8a210c1d10152b7bbb58b149e7570bcccf",
    "tsc_standard": "999aba1608ad82a9461928a0f2d18cbb58a700ce8a3bc397f82bb0e0909aba83",
}


def _fixed_gather_input():
    """(3, 2000) positions in [-L, 2L) with the wrap's edge cases in front,
    and one (M,) field, made from a seed."""
    r = np.random.default_rng(2024)
    x = r.uniform(-L, 2 * L, (3, 2000)).astype(np.float32)
    f32 = np.float32
    edges = np.array([0.0, -0.0, L, -L, 2 * L, np.nextafter(f32(L), f32(0)),
                      np.nextafter(f32(0), f32(-1)), np.nextafter(f32(2 * L), f32(0)),
                      np.nextafter(f32(-L), f32(0)), np.nextafter(f32(-L), f32(-1e9)), 3 * L,
                      -2.5 * L, L / M * 17, np.nextafter(f32(L / M * 17), f32(0))], f32)
    x[:, :len(edges)] = edges
    return x, r.standard_normal(M).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_bits_unchanged(dev, kind):
    x, e = _fixed_gather_input()
    got = cic.gather_cic(torch.tensor(e, device=dev), torch.tensor(x, device=dev), M, L, kind)
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == GATHER_SHA256[kind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1_000_000, 100_000])
def test_gather_at_large_n_is_the_per_particle_arithmetic(dev, gen, n, kind):
    """The env step's gather at N=1M and N=100000 (M=256, one shared field,
    positions in [-L, 2L)): against the plain version to atol 1e-5, and
    bitwise equal to the same positions read one particle per thread (a copy
    at a 4-byte offset, whose rows the kernel reads scalar, as the
    one-thread-per-particle kernel did): the 16-byte loads and the
    grid-stride walk change no bit."""
    m = 256
    x = torch.rand((1, n), generator=gen, device=dev) * (3 * L) - L
    e = torch.randn(m, generator=gen, device=dev)
    got = cic.gather_cic(e, x, m, L, kind)
    torch.testing.assert_close(got, cic.gather_cic_plain(e, x, m, L, kind), rtol=0.0, atol=1e-5)
    shifted = torch.empty(n + 1, device=dev)[1:]
    shifted.copy_(x[0])
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(cic.gather_cic(e, shifted, m, L, kind), got[0])


@pytest.mark.parametrize("shape", [(3, 1001), (2, 4099), (5, 3), (1, 1), (2, 300_001),
                                   (1, 1_000_003)])
def test_gather_ragged_rows(dev, gen, shape):
    """Rows whose length is no multiple of 4, short (one position per
    thread) and long (float4 rounds: each row's scalar head and tail around
    its 16-byte-aligned body): against the plain version to atol 1e-5,
    bitwise equal to the scalar reading of each row."""
    x = torch.rand(shape, generator=gen, device=dev) * (3 * L) - L
    e = torch.randn((shape[0], M), generator=gen, device=dev)
    got = cic.gather_cic(e, x, M, L, "tsc")
    torch.testing.assert_close(got, cic.gather_cic_plain(e, x, M, L, "tsc"), rtol=0.0, atol=1e-5)
    for r in range(shape[0]):
        shifted = torch.empty(shape[1] + 1, device=dev)[1:]
        shifted.copy_(x[r])
        assert torch.equal(cic.gather_cic(e[r], shifted, M, L, "tsc"), got[r])


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km", [(5000, 384, 6, 8), (384, 7, 4, 5), (300, 16, 3, 16),
                                      (14448, 8, 2, 4), (20_000, 64, 10, 16)])
def test_spectral_horizon_matches_plain(dev, gen, rot, n, k, h, km):
    """Mode sums reduced in another order and the field by Clenshaw's
    recurrence: rtol 2e-4 (the JAX package's bar for the TPU kernel's drift
    variants), each at the cluster size launch_geometry chooses. N=5000 is
    the spectral slice."""
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


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km", [(10_000, 1024, 10, 16), (384, 7, 4, 5), (20_000, 64, 10, 16)])
def test_corrected_spectral_horizon_matches_plain(dev, gen, rot, n, k, h, km):
    """The twin-corrected variant at the twin slice's plan model, a small odd
    shape and at N=20000, targets of the size of the mode sums (~sqrt(N)):
    rtol 2e-4, as for the plain energies; one launch, counted as
    corrected."""
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = (n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts)
    before = (sh.spectral_horizon.launches, sh.spectral_horizon.twin_launches)
    got = sh.spectral_horizon(x0, v0, u_c, u_s, **kw)
    assert (sh.spectral_horizon.launches, sh.spectral_horizon.twin_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, sh.spectral_horizon_plain(x0, v0, u_c, u_s, **kw),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("corrected", [False, True], ids=["plain", "corrected"])
@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("km", [1, 8, 16])
@pytest.mark.parametrize("fill", ["ragged", "short"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_spectral_horizon_at_every_cluster_size(dev, gen, cluster, fill, km, rot, corrected):
    """Each cluster size launch_geometry can choose, forced on the private
    launch: N not a multiple of C * 256 ("ragged", K=5) and N < C * 256
    ("short", K=1: each CTA holds fewer particles than threads), against the
    plain version to rtol 2e-4."""
    n = cluster * 256 * 3 + 77 if fill == "ragged" else max(cluster * 256 - 37, 5)
    k, h = (5, 4) if fill == "ragged" else (1, 3)
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = ((n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
              if corrected else (None, None))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts)
    s = -(-n // cluster)
    geo = sh.Geometry(cluster, s, 4 * (3 if rot else 4) * s)
    got = sh._spectral_horizon_cuda(x0, v0, u_c, u_s, n_modes=None, geometry=geo, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, sh.spectral_horizon_plain(x0, v0, u_c, u_s, **kw),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("corrected", [False, True], ids=["plain", "corrected"])
@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,cluster", [(5000, 16), (3001, 1), (320_000, 16)])
def test_spectral_horizon_global_scratch(dev, gen, n, cluster, rot, corrected):
    """The state in a global scratch: forced at N=5000 and N=3001, and as
    the wrapper chooses it at N=320000, beyond what 16 CTAs hold; rtol
    2e-4 against the plain version."""
    k, h, km = 4, 3, 8
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = ((n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
              if corrected else (None, None))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts)
    geo = sh.Geometry(cluster, -(-n // cluster), 0)
    if n == 320_000:
        assert sh.launch_geometry(n, rot) == geo and not sh.state_in_shared(n, rot)
        got = sh.spectral_horizon(x0, v0, u_c, u_s, **kw)
    else:
        got = sh._spectral_horizon_cuda(x0, v0, u_c, u_s, n_modes=None, geometry=geo, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, sh.spectral_horizon_plain(x0, v0, u_c, u_s, **kw),
                               rtol=2e-4, atol=1e-6)


# Km > 16: the million-particle controller's solve (N=1M, a chunk of K=16,
# Km=32 over 16 drive modes, global scratch), the shared-memory check shape,
# the twin plan model at Km=32, and odd shapes up to the 64-mode limit
WIDE_SHAPES = [(1_000_000, 16, 10, 32, 16), (20_000, 64, 10, 32, 32), (10_000, 128, 10, 32, 16),
               (3001, 5, 3, 20, 12), (700, 3, 4, 64, 33)]


@pytest.mark.parametrize("corrected", [False, True], ids=["plain", "corrected"])
@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,k,h,km,ka", WIDE_SHAPES)
def test_spectral_horizon_beyond_16_modes_matches_plain(dev, gen, n, k, h, km, ka, rot,
                                                         corrected):
    """The blocked kernel (ceil(Km / 16) blocks of modes) against the plain
    version on (K, H, Ka) views padded to Km in the kernel: rtol 2e-4, as at
    Km <= 16; one launch."""
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    cand = 0.3 * torch.randn((k, h, 2 * ka), generator=gen, device=dev)
    tc, ts = ((n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
              if corrected else (None, None))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts,
              n_modes=km)
    before = sh.spectral_horizon.launches
    got = sh.spectral_horizon(x0, v0, cand[..., :ka], cand[..., ka:], **kw)
    assert sh.spectral_horizon.launches == before + 1
    ref = sh.spectral_horizon_plain(x0, v0, cand[..., :ka], cand[..., ka:], **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("km", [20, 32])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_spectral_horizon_beyond_16_modes_at_every_cluster_size(dev, gen, cluster, km, rot):
    """The blocked kernel at each cluster size, N not a multiple of C * 256,
    with the state in shared memory and (forced) in the global scratch:
    rtol 2e-4 against the plain version, corrected energies."""
    n, k, h = cluster * 256 * 3 + 77, 5, 4
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = (n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts)
    ref = sh.spectral_horizon_plain(x0, v0, u_c, u_s, **kw)
    s = -(-n // cluster)
    for shared in (4 * (3 if rot else 4) * s, 0):
        got = sh._spectral_horizon_cuda(x0, v0, u_c, u_s, n_modes=None,
                                        geometry=sh.Geometry(cluster, s, shared), **kw)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("corrected", [False, True], ids=["plain", "corrected"])
@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("km", [5, 8, 16, 20, 32, 40, 64])
@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_spectral_horizon_global_scratch_is_the_shared_path(dev, gen, cluster, km, rot,
                                                            corrected):
    """The state in the global scratch (one fused pass per step) against the
    state in shared memory (a drift pass and a field pass per step) at the
    same cluster: the same particles per thread, order of accumulation,
    reductions and per-particle arithmetic, so bitwise equal energies, at
    Km <= 16, at Km <= 32 (two blocks in the fused pass) and beyond (one
    more pass per pair of blocks)."""
    n, k, h = cluster * 256 * 3 + 77, 5, 4
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = ((n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
              if corrected else (None, None))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, twin_c=tc, twin_s=ts,
              n_modes=None)
    s = -(-n // cluster)
    shared, scratch = (sh._spectral_horizon_cuda(x0, v0, u_c, u_s,
                                                 geometry=sh.Geometry(cluster, s, nbytes), **kw)
                       for nbytes in (4 * (3 if rot else 4) * s, 0))
    assert torch.isfinite(scratch).all()
    assert torch.equal(scratch, shared)


def test_spectral_horizon_beyond_16_modes_is_deterministic(dev, gen):
    """Each block's sums through the cluster reduction in rank order: two
    launches at Km=32 give bitwise equal energies, in shared memory and in
    the global scratch."""
    for n, k in ((20_000, 64), (400_000, 8)):
        x0 = torch.rand(n, generator=gen, device=dev) * L
        v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
        u = 0.3 * torch.randn((k, 10, 32), generator=gen, device=dev)
        kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=True)
        assert torch.equal(sh.spectral_horizon(x0, v0, u, u, **kw),
                           sh.spectral_horizon(x0, v0, u, u, **kw))


@pytest.mark.parametrize("n,k,km", [(10_000, 1024, 16), (100_000, 32, 16), (5000, 384, 8)])
def test_spectral_horizon_is_deterministic(dev, gen, n, k, km):
    """Mode sums added in a fixed order (threads, warps, the cluster's ranks
    0..C-1) and no atomics: two launches give bitwise equal energies."""
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, 10, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, 10, km), generator=gen, device=dev)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=True)
    assert torch.equal(sh.spectral_horizon(x0, v0, u_c, u_s, **kw),
                       sh.spectral_horizon(x0, v0, u_c, u_s, **kw))


def test_spectral_horizon_is_one_device_op(dev, gen, tmp_path):
    """The twin slice's call as candidate_costs makes it: a stride-10 plan
    subsample and (K, H, Ka) views of one candidate tensor padded to Km in
    the kernel. One launch counted, one kernel on the card and no other
    device op; the energies equal those of contiguous, zero-padded inputs."""
    x = torch.rand(100_000, generator=gen, device=dev) * L
    v = 1.5 * torch.randn(100_000, generator=gen, device=dev)
    x0, v0 = x[::10], v[::10]
    cand = 0.3 * torch.randn((64, 10, 16), generator=gen, device=dev)
    tc, ts = (100.0 * torch.randn((10, 16), generator=gen, device=dev) for _ in range(2))
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=10_000, rot=True, twin_c=tc, twin_s=ts)

    def call():
        return sh.spectral_horizon(x0, v0, cand[..., :8], cand[..., 8:], n_modes=16, **kw)

    got = call()
    before = sh.spectral_horizon.launches
    names = _device_ops(call, tmp_path)
    assert sh.spectral_horizon.launches == before + 1
    assert len(names) == 1 and "spectral_horizon_kernel" in names[0], names
    pad = torch.nn.functional.pad
    ref = sh.spectral_horizon(x0.contiguous(), v0.contiguous(), pad(cand[..., :8], (0, 8)),
                              pad(cand[..., 8:], (0, 8)), **kw)
    assert torch.equal(got, ref)


def test_corrected_spectral_horizon_refuses_bad_targets(dev):
    x = torch.zeros(64, device=dev)
    u = torch.zeros((2, 3, 4), device=dev)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=64, rot=True)
    with pytest.raises(ValueError):  # one target without the other
        sh.spectral_horizon(x, x, u, u, twin_c=torch.zeros((3, 4), device=dev), **kw)
    with pytest.raises(ValueError):  # not (H, Km)
        bad = torch.zeros((4, 3), device=dev)
        sh.spectral_horizon(x, x, u, u, twin_c=bad, twin_s=bad, **kw)


def test_twin_candidate_costs_on_card_launch_the_corrected_kernel(dev, gen):
    """A subsampled twin-corrected plan on CUDA tensors: one corrected launch
    per solve, the costs matching the CPU's plain version to rtol 2e-4."""
    from plasma_control_tpu_torch.config import ControlConfig
    from plasma_control_tpu_torch.control.mpc import _plan_model, twin_targets

    st, cand, grid, cfg, act = _cost_inputs(dev, gen, 2000, k=16)
    mpc = MPCConfig(horizon=4, n_candidates=16, plan_modes=4, plan_particles=500,
                    plan_correction="twin", plan_kernel="fused")
    ctrl = ControlConfig(max_mode=2)
    costs = {}
    for side in ("cuda", "cpu"):
        s = st if side == "cuda" else PlasmaState(st.x.cpu(), st.v.cpu())
        g = grid if side == "cuda" else make_grid(32, L, device="cpu")
        a = act if side == "cuda" else make_actuator(L, 32, 2, device="cpu")
        pst, pgrid, pcfg = _plan_model(s, g, cfg, mpc)
        target = twin_targets(s.x, pst, pcfg, cfg, ctrl, mpc)
        before = sh.spectral_horizon.twin_launches
        costs[side] = candidate_costs(pst, cand.to(s.x.device), pgrid, pcfg, mpc, a,
                                      twin_target=target).cpu()
        assert sh.spectral_horizon.twin_launches == before + (side == "cuda")
    torch.testing.assert_close(costs["cuda"], costs["cpu"], rtol=2e-4, atol=1e-5)


def test_spectral_horizon_refuses_unsupported_shapes(dev):
    n = 64
    x = torch.zeros(n, device=dev)
    u = torch.zeros((2, 2, 4), device=dev)
    with pytest.raises(ValueError):  # Km above the kernel's 64 modes
        u65 = torch.zeros((2, 2, 65), device=dev)
        sh.spectral_horizon(x, x, u65, u65, length=L, dt=0.1, n0=1.0, n_particles=n, rot=True)
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
    ref = candidate_costs(cpu, cand.cpu(), make_grid(32, L, device="cpu"), cfg, cpu_mpc,
                          make_actuator(L, 32, 2, device="cpu"))
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("plan_kernel", ["auto", "xla"])
def test_candidate_costs_on_card_raise_beyond_the_kernel(dev, gen, plan_kernel):
    """No op-by-op fallback on the card: Km above the kernel's 64 modes
    raises."""
    st, cand, grid, cfg, act = _cost_inputs(dev, gen, 512)
    mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=65, plan_kernel=plan_kernel)
    with pytest.raises(ValueError):
        candidate_costs(st, cand, grid, cfg, mpc, act)


@pytest.mark.parametrize("plan_kernel", ["auto", "xla"])
def test_candidate_costs_on_card_launch_the_kernel_at_large_n(dev, gen, plan_kernel):
    """N=20000, beyond one CTA's shared memory: still one kernel launch,
    matching the CPU to rtol 2e-4."""
    st, cand, grid, cfg, act = _cost_inputs(dev, gen, 20_000)
    mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=4, plan_kernel=plan_kernel)
    before = sh.spectral_horizon.launches
    got = candidate_costs(st, cand, grid, cfg, mpc, act)
    assert sh.spectral_horizon.launches == before + 1
    cpu = PlasmaState(st.x.cpu(), st.v.cpu())
    cpu_mpc = mpc if plan_kernel == "xla" else dataclasses.replace(mpc, plan_kernel="fused")
    ref = candidate_costs(cpu, cand.cpu(), make_grid(32, L, device="cpu"), cfg, cpu_mpc,
                          make_actuator(L, 32, 2, device="cpu"))
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=1e-5)


# grid planner kernels: the slice's plan model (N=1250, M=64, K=512, H=10),
# small and odd shapes, global-memory particle state (N=40000: 8 N bytes
# beyond shared memory) and a global-memory operator (M=256: 256 KB)
GRID_SHAPES = [(1250, 64, 512, 10), (700, 32, 13, 5), (40_000, 64, 16, 3), (2000, 256, 8, 3)]


def _grid_inputs(gen, dev, n, m, k, h, batched):
    shape = (k, n) if batched else (n,)
    x = torch.rand(shape, generator=gen, device=dev) * L
    v = torch.randn(shape, generator=gen, device=dev)
    u = 0.05 * torch.randn((k, h, m), generator=gen, device=dev)
    return x, v, u, make_grid(m, L, device=dev).e_op.T.contiguous()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "kick-field"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,k,h", GRID_SHAPES)
def test_fused_leapfrog_step_matches_plain(dev, gen, n, m, k, h, kind, exact):
    """x and v to rtol 1e-5 / atol 1e-4, field energy to rtol 1e-4 (the bars
    of the experiments' test of the TPU kernel); the deposit's atomics and
    the in-kernel solve sum in another order than the plain version."""
    x, v, u, eop = _grid_inputs(gen, dev, n, m, k, h, batched=True)
    kw = dict(n_mesh=m, length=L, dt=0.1, exact=exact, kind=kind)
    before = fs.fused_leapfrog_step.launches
    got = fs.fused_leapfrog_step(x, v, u[:, 0], eop, **kw)
    assert fs.fused_leapfrog_step.launches == before + 1
    ref = fs.fused_leapfrog_step_plain(x, v, u[:, 0], eop, **kw)
    # positions are periodic: one that wraps to 0 on one side and to L on
    # the other is no error
    dx = torch.remainder(got[0] - ref[0] + L / 2, L) - L / 2
    assert bool((dx.abs() <= 1e-4 + 1e-5 * ref[0].abs()).all())
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)
    pe = lambda e: (e.double() ** 2).sum(-1)
    torch.testing.assert_close(pe(got[2]), pe(ref[2]), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "kick-field"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,k", [(1250, 64, 512), (700, 17, 13), (2048, 200, 9), (1, 8, 3)])
def test_fused_leapfrog_step_rows_kernel_is_the_per_row_kernel(dev, gen, n, m, k, kind, exact):
    """The rows kernel (rows over a persistent grid, the half-step state in
    registers) at the CTA count the wrapper picks, at one CTA, at three and
    at one per row, against the one-CTA-per-row kernel on the same inputs:
    x', v' and E bitwise equal (the same particle arithmetic, fixed-point
    histograms and solve). M=17 takes the 4-byte copies of e_op_t."""
    x, v, u, eop = _grid_inputs(gen, dev, n, m, k, 1, batched=True)
    kw = dict(n_mesh=m, length=L, dt=0.1, n0=1.0, exact=exact, kind=kind)
    assert fs._layout(n, m).rows
    ref = fs._leapfrog_cuda(x, v, u[:, 0], eop, rows_grid=0, **kw)
    for grid in (None, 1, 3, k):
        got = fs._leapfrog_cuda(x, v, u[:, 0], eop, rows_grid=grid, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), grid


def _assert_energies_close(got, ref, kind):
    """Every (candidate, step) energy to rtol 2e-4. The reference's shifted
    "tsc" weight jumps at the cell offsets 0, 1 and 2, so a particle that
    lands an ulp either side of a cell edge moves a weight of 0.375 into the
    next cell. At the slice's shapes one particle (candidate 49, step 6)
    lies 1 ulp from an edge; the kernel and the plain version sum in other
    orders and may put it on either side, and that step's energy then
    differs by 4.9e-4 relative (the kernel missed in 48 of 100 runs on the
    H100 while its deposit summed in atomic order). For that kind at most 1
    in 1000 energies may miss rtol 2e-4, and none misses rtol 1e-2."""
    if kind != "tsc":
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)
        return
    miss = (got - ref).abs() > 1e-6 + 2e-4 * ref.abs()
    assert int(miss.sum()) <= got.numel() // 1000, int(miss.sum())
    torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,k,h", GRID_SHAPES)
def test_grid_horizons_match_plain(dev, gen, n, m, k, h, kind):
    """Kernels 5 (explicit KDK) and 6 (merged half-kicks) against their
    plain versions, and against each other (one contract): rtol 2e-4, the
    bar of the experiments' horizon tests."""
    x, v, u, eop = _grid_inputs(gen, dev, n, m, k, h, batched=False)
    kw = dict(n_mesh=m, length=L, dt=0.1, kind=kind)
    before = (fs.fused_kdk_horizon.launches, fs.fused_packed_horizon.launches)
    kdk = fs.fused_kdk_horizon(x, v, u, eop, **kw)
    packed = fs.fused_packed_horizon(x, v, u, eop, **kw)
    assert (fs.fused_kdk_horizon.launches, fs.fused_packed_horizon.launches) == (
        before[0] + 1, before[1] + 1)
    assert kdk.shape == (k, h) and torch.isfinite(kdk).all() and torch.isfinite(packed).all()
    _assert_energies_close(kdk, fs.fused_kdk_horizon_plain(x, v, u, eop, **kw), kind)
    _assert_energies_close(packed, fs.fused_packed_horizon_plain(x, v, u, eop, **kw), kind)
    # the merged kick reassociates the two half-kicks, and a particle that
    # lands on the other side of a cell edge moves one step's energy by ~5e-4
    # relative over H=10: held, as the experiments hold it, on horizon sums
    torch.testing.assert_close(packed.sum(-1), kdk.sum(-1), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_grid_kernels_are_deterministic(dev, gen, kind):
    """Fixed-point deposits, a warp-spread solve and energy sums in a fixed
    order: two launches of kernels 4, 5 and 6 give bitwise equal results at
    the grid slice's plan model."""
    n, m, k, h = GRID_SHAPES[0]
    x, v, u, eop = _grid_inputs(gen, dev, n, m, k, h, batched=True)
    kw = dict(n_mesh=m, length=L, dt=0.1, kind=kind)
    for fn in (fs.fused_kdk_horizon, fs.fused_packed_horizon):
        assert torch.equal(fn(x[0], v[0], u, eop, **kw), fn(x[0], v[0], u, eop, **kw)), fn
    one, two = (fs.fused_leapfrog_step(x, v, u[:, 0], eop, **kw) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# beyond 3631 cells the mesh arrays live in a global scratch: the grid
# slice's plan model on 4096 cells, and an odd shape
WIDE_MESH_SHAPES = [(1250, 4096, 8, 4), (300, 3700, 5, 3)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,k,h", WIDE_MESH_SHAPES)
def test_grid_kernels_beyond_3631_cells_match_plain(dev, gen, n, m, k, h, kind):
    """Kernels 4-6 with their mesh arrays in the global scratch, against the
    plain versions at the bars of the tests above; two launches bitwise
    equal (integer deposits, whatever the memory)."""
    assert not fs._layout(n, m).mesh
    x, v, u, eop = _grid_inputs(gen, dev, n, m, k, h, batched=True)
    kw = dict(n_mesh=m, length=L, dt=0.1, kind=kind)
    got = fs.fused_leapfrog_step(x, v, u[:, 0], eop, **kw)
    ref = fs.fused_leapfrog_step_plain(x, v, u[:, 0], eop, **kw)
    dx = torch.remainder(got[0] - ref[0] + L / 2, L) - L / 2
    assert bool((dx.abs() <= 1e-4 + 1e-5 * ref[0].abs()).all())
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)
    pe = lambda e: (e.double() ** 2).sum(-1)
    torch.testing.assert_close(pe(got[2]), pe(ref[2]), rtol=1e-4, atol=1e-9)
    assert all(torch.equal(a, b) for a, b in zip(got, fs.fused_leapfrog_step(x, v, u[:, 0], eop,
                                                                             **kw)))
    for fn, plain in ((fs.fused_kdk_horizon, fs.fused_kdk_horizon_plain),
                      (fs.fused_packed_horizon, fs.fused_packed_horizon_plain)):
        got = fn(x[0], v[0], u, eop, **kw)
        assert torch.isfinite(got).all() and torch.equal(got, fn(x[0], v[0], u, eop, **kw))
        _assert_energies_close(got, plain(x[0], v[0], u, eop, **kw), kind)


@pytest.mark.parametrize("plan_integrator", ["kdk", "leapfrog", "env"])
@pytest.mark.parametrize("plan_kernel", ["auto", "xla"])
def test_grid_candidate_costs_on_card_launch_the_kernels(dev, gen, plan_integrator, plan_kernel):
    """The grid planner on CUDA tensors: "kdk" is one launch of kernel 6,
    "leapfrog" H launches of kernel 4, "env" the CIC kernels, for every
    plan_kernel value the JAX package takes for the grid model; the costs
    match the CPU (op by op) to rtol 2e-4."""
    st, cand, grid, cfg, act = _cost_inputs(dev, gen, 1000)
    mpc = MPCConfig(horizon=4, n_candidates=8, plan_model="grid", plan_kernel=plan_kernel,
                    plan_integrator=plan_integrator)
    counters = (fs.fused_packed_horizon, fs.fused_leapfrog_step, cic.gather_cic)
    before = [f.launches for f in counters]
    got = candidate_costs(st, cand, grid, cfg, mpc, act)
    added = [f.launches - b for f, b in zip(counters, before)]
    assert added == {"kdk": [1, 0, 0], "leapfrog": [0, 4, 0], "env": [0, 0, 12]}[plan_integrator]
    cpu = PlasmaState(st.x.cpu(), st.v.cpu())
    ref = candidate_costs(cpu, cand.cpu(), make_grid(32, L, device="cpu"), cfg, mpc,
                          make_actuator(L, 32, 2, device="cpu"))
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=1e-5)


def _no_plain(monkeypatch):
    """Make the CIC kernels' plain versions raise: a CUDA tensor must never
    reach them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(cic, "deposit_cic_plain", refuse)
    monkeypatch.setattr(cic, "gather_cic_plain", refuse)


def _two_stream(gen, dev, n, batch=()):
    x = torch.rand(batch + (n,), generator=gen, device=dev) * L
    v = 0.5 * torch.randn(batch + (n,), generator=gen, device=dev)
    v += torch.where(torch.arange(n, device=dev) < n // 2, 3.0, -3.0)
    return PlasmaState(x, v)


@pytest.mark.parametrize("record", [False, True], ids=["no-snapshots", "snapshots"])
def test_feedback_rollout_on_card_launches_the_cic_kernels(dev, gen, monkeypatch, record):
    """feedback_rollout with deposit_method="pallas" on CUDA tensors: five
    launches of kernel 2 and three of kernel 3 per step, no plain version;
    PE rtol 1e-4 and coefficients atol 1e-5 against the same loop on the
    CPU's plain versions (six steps, N=20000, M=256)."""
    from plasma_control_tpu_torch.config import ControlConfig
    from plasma_control_tpu_torch.control.feedback import feedback_rollout

    cfg = SimConfig(simcase="two-stream", n_particles=20000, n_mesh=256, deposit_method="pallas")
    ctrl = ControlConfig(max_mode=8)
    st = _two_stream(gen, dev, cfg.n_particles)
    ref = feedback_rollout(PlasmaState(st.x.cpu(), st.v.cpu()), make_grid(256, L, device="cpu"),
                           cfg, ctrl, make_actuator(L, 256, 8, device="cpu"), record, n_steps=6)
    _no_plain(monkeypatch)
    before = (cic.deposit_cic.launches, cic.gather_cic.launches)
    got = feedback_rollout(st, make_grid(256, L, device=dev), cfg, ctrl,
                           make_actuator(L, 256, 8, device=dev), record, n_steps=6)
    assert (cic.deposit_cic.launches - before[0], cic.gather_cic.launches - before[1]) == (30, 18)
    torch.testing.assert_close(got.field_energy.cpu(), ref.field_energy, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got.coeff_cos.cpu(), ref.coeff_cos, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(got.coeff_sin.cpu(), ref.coeff_sin, rtol=0.0, atol=1e-5)
    assert (got.xs is None) is not record


@pytest.mark.parametrize("fields", [False, True], ids=["no-fields", "fields"])
def test_rollout_batch_on_card_is_one_launch_per_batched_deposit(dev, gen, monkeypatch, fields):
    """rollout_batch of B=8 rows on CUDA tensors: one launch of kernel 2 per
    batched deposit (1 + 4 per step) and of kernel 3 per batched gather (3 per
    step), no plain version; each row's PE within 1e-5 relative of its own
    single rollout on the card after 5 steps."""
    from plasma_control_tpu_torch.models.rollout import rollout, rollout_batch

    cfg = SimConfig(simcase="two-stream", n_particles=20000, n_mesh=256, deposit_method="pallas")
    grid = make_grid(256, L, device=dev)
    st = _two_stream(gen, dev, cfg.n_particles, batch=(8,))
    trajs = 0.05 * torch.randn((8, 5, 256), generator=gen, device=dev) if fields else None
    _no_plain(monkeypatch)
    before = (cic.deposit_cic.launches, cic.gather_cic.launches)
    out = rollout_batch(st, grid, cfg, trajs, n_steps=5)
    assert (cic.deposit_cic.launches - before[0], cic.gather_cic.launches - before[1]) == (21, 15)
    assert out.field_energy.shape == (8, 6)
    for b in range(8):
        one = rollout(PlasmaState(st.x[b], st.v[b]), grid, cfg,
                      None if trajs is None else trajs[b], n_steps=5)
        torch.testing.assert_close(out.field_energy[b], one.field_energy, rtol=1e-5, atol=1e-7)
