"""The grid planner's fused kernels on CPU: each plain version of
``plasma_control_tpu_torch/ops/kernels/fused_step.py`` against the Pallas
TPU kernel it replaces (``experiments/pallas_fused_step.py``, interpret mode),
and, for the interpolation kinds the TPU kernels lack, against the JAX
package's op-by-op grid planner."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "experiments"))

from pallas_fused_step import (  # noqa: E402
    fused_kdk_horizon as jfused_kdk_horizon,
    fused_leapfrog_step as jfused_leapfrog_step,
    fused_packed_horizon as jfused_packed_horizon,
)
from plasma_control_tpu.config import SimConfig as JSimConfig  # noqa: E402
from plasma_control_tpu.control.mpc import _step_and_pe  # noqa: E402
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState  # noqa: E402
from plasma_control_tpu.ops.grid import make_grid as jmake_grid  # noqa: E402
from plasma_control_tpu_torch.ops.grid import make_grid  # noqa: E402
from plasma_control_tpu_torch.ops.kernels import fused_step as fs  # noqa: E402

torch.set_num_threads(1)

L, N, K, H, DT = 50.0, 700, 13, 5, 0.1


def _state(seed, shape):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


def _e_op_t(m):
    return make_grid(m, L, device="cpu").e_op.T.contiguous()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "kick-field"])
@pytest.mark.parametrize("m", [32, 64])
def test_leapfrog_plain_matches_pallas(m, exact):
    """B=13 rows of N=700 (both unaligned for the TPU tiles): x and v to
    rtol 1e-5 / atol 1e-4 and the field energy to rtol 1e-4, the bars of
    experiments/test_pallas_fused_step.py."""
    x, v = _state(m, (K, N))
    e_ext = (0.05 * np.random.default_rng(m + 1).standard_normal((K, m))).astype(np.float32)
    kw = dict(n_mesh=m, length=L, dt=DT, exact=exact)
    jx, jv, je = jfused_leapfrog_step(jnp.asarray(x), jnp.asarray(v), jnp.asarray(e_ext),
                                      jnp.asarray(_e_op_t(m).numpy()), interpret=True, **kw)
    tx, tv, te = fs.fused_leapfrog_step(torch.tensor(x), torch.tensor(v), torch.tensor(e_ext),
                                        _e_op_t(m), **kw)
    assert tx.shape == (K, N) and te.shape == (K, m)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    pe = lambda e: 0.5 * (L / m) * np.sum(np.asarray(e, np.float64) ** 2, axis=-1)
    np.testing.assert_allclose(pe(te.numpy()), pe(je), rtol=1e-4)


@pytest.mark.parametrize("merged", [False, True], ids=["kdk", "packed"])
@pytest.mark.parametrize("m", [32, 64])
def test_horizon_plain_matches_pallas(m, merged):
    """K=13 candidates (odd), H=5, N=700: per-step energies to rtol 2e-4, the
    bar of the experiments' horizon tests."""
    x, v = _state(100 + m, N)
    u = (0.05 * np.random.default_rng(m).standard_normal((K, H, m))).astype(np.float32)
    kw = dict(n_mesh=m, length=L, dt=DT)
    jfn, tfn = ((jfused_packed_horizon, fs.fused_packed_horizon) if merged
                else (jfused_kdk_horizon, fs.fused_kdk_horizon))
    ref = jfn(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u), jnp.asarray(_e_op_t(m).numpy()),
              interpret=True, **kw)
    got = tfn(torch.tensor(x), torch.tensor(v), torch.tensor(u), _e_op_t(m), **kw)
    assert got.shape == (K, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


@pytest.mark.parametrize("merged", [False, True], ids=["kdk", "packed"])
def test_horizon_plain_matches_pallas_at_the_wrap_edge(merged):
    """Particles that start at 0 and an ulp below L, with velocities that
    carry them across 0 and L in the first drift: the plain versions wrap as
    the CUDA kernels do (torch.remainder's arithmetic), the TPU kernels with
    jnp.mod. Per-step energies to rtol 2e-4, as above."""
    m = 64
    x, v = _state(11, N)
    x[:60] = np.nextafter(np.float32(L), np.float32(0))
    x[60:120] = 0.0
    v[:120] = np.where(np.arange(120) % 2 == 0, 2.0, -2.0).astype(np.float32)
    u = (0.05 * np.random.default_rng(12).standard_normal((K, H, m))).astype(np.float32)
    kw = dict(n_mesh=m, length=L, dt=DT)
    jfn, tfn = ((jfused_packed_horizon, fs.fused_packed_horizon) if merged
                else (jfused_kdk_horizon, fs.fused_kdk_horizon))
    ref = jfn(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u), jnp.asarray(_e_op_t(m).numpy()),
              interpret=True, **kw)
    got = tfn(torch.tensor(x), torch.tensor(v), torch.tensor(u), _e_op_t(m), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


@pytest.mark.parametrize("kind", ["cic", "tsc", "tsc_standard"])
def test_kernel_tap_sets_cover_every_weight(kind):
    """The CUDA kernels evaluate only the taps that can carry weight
    (csrc/shape.cuh::taps): cic b and b+1; tsc b-1 .. b+1, and b+2 where b
    is -1 or 0; tsc_standard c-1 .. c+1 around c = b + (pos - b >= 0.5),
    b = floor(pos). In float32, every tap of the 4-tap evaluation b-1 .. b+2
    that the set leaves out weighs exactly 0, on random positions and on
    cell edges and half cells an ulp either side."""
    from plasma_control_tpu_torch.ops.deposit import shape_weights_from_offset

    g = torch.Generator().manual_seed(0)
    grid_pts = torch.arange(-3, 260, dtype=torch.float32)
    marks = torch.cat([grid_pts, grid_pts + 0.5])
    pos = torch.cat([
        torch.rand(400_000, generator=g) * 263.0 - 3.0,
        (torch.rand(100_000, generator=g) - 0.5) * 2e-3,
        marks, torch.nextafter(marks, torch.tensor(-1e9)), torch.nextafter(marks, torch.tensor(1e9)),
        torch.tensor([1 - 2 ** -24, -(2 ** -24), -(2 ** -30), 2 ** -30]),
    ])
    b = torch.floor(pos)
    if kind == "cic":
        first, count = b, 2
    elif kind == "tsc":
        first, count = b - 1, 3
    else:
        first, count = b - 1 + (pos - b >= 0.5).float(), 3
    edge = (kind == "tsc") & ((b == -1) | (b == 0))
    for o in range(-1, 3):
        j = b + o
        w = shape_weights_from_offset(pos - j, kind)
        kept = ((j >= first) & (j < first + count)) | (edge & (o == 2))
        assert int(((w != 0) & ~kept).sum()) == 0, (o, pos[(w != 0) & ~kept][:5])


def test_explicit_and_merged_horizons_agree():
    """Kernels 5 and 6 have one contract: the merged kick reassociates the two
    half-kicks, so the energies agree to rtol 2e-4."""
    x, v = _state(3, N)
    u = 0.05 * torch.randn((K, H, 64), generator=torch.Generator().manual_seed(3))
    kw = dict(n_mesh=64, length=L, dt=DT, kind="tsc")
    a = fs.fused_kdk_horizon(torch.tensor(x), torch.tensor(v), u, _e_op_t(64), **kw)
    b = fs.fused_packed_horizon(torch.tensor(x), torch.tensor(v), u, _e_op_t(64), **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4)


@pytest.mark.parametrize("kind", ["tsc", "tsc_standard"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "kick-field"])
def test_leapfrog_plain_matches_jax_step_for_tsc(kind, exact):
    """The TPU kernel is CIC only; for the TSC kinds the plain version is held
    against the JAX package's op-by-op leapfrog step (dense deposit): x to
    atol 1e-4 (the kernel wraps the half-drifted positions, JAX does not),
    v to rtol 1e-5 / atol 1e-4, field energy to rtol 1e-4."""
    m = 32
    x, v = _state(7, N)
    e_ext = (0.05 * np.random.default_rng(8).standard_normal(m)).astype(np.float32)
    cfg = JSimConfig(n_particles=N, n_mesh=m, dt=DT, t_max=5.0, length=L, interpol=kind)
    jgrid = jmake_grid(m, L)
    st, jpe = _step_and_pe(JPlasmaState(jnp.asarray(x), jnp.asarray(v)), jnp.asarray(e_ext),
                           jgrid, cfg, exact, "leapfrog", "xla")
    tx, tv, te = fs.fused_leapfrog_step(torch.tensor(x), torch.tensor(v), torch.tensor(e_ext),
                                        _e_op_t(m), n_mesh=m, length=L, dt=cfg.clamped_dt(),
                                        exact=exact, kind=kind)
    np.testing.assert_allclose(tx.numpy(), np.asarray(st.x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(st.v), rtol=1e-5, atol=1e-4)
    pe = 0.5 * (L / m) * float(torch.sum(te.double() ** 2)) * (N / L)
    np.testing.assert_allclose(pe, float(jpe), rtol=1e-4)


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    x, v = _state(9, 64)
    before = (fs.fused_leapfrog_step.launches, fs.fused_kdk_horizon.launches,
              fs.fused_packed_horizon.launches)
    u = torch.zeros((2, 2, 16))
    fs.fused_leapfrog_step(torch.tensor(x), torch.tensor(v), torch.zeros(16), _e_op_t(16),
                           n_mesh=16, length=L, dt=DT)
    fs.fused_kdk_horizon(torch.tensor(x), torch.tensor(v), u, _e_op_t(16), n_mesh=16, length=L,
                         dt=DT)
    fs.fused_packed_horizon(torch.tensor(x), torch.tensor(v), u, _e_op_t(16), n_mesh=16,
                            length=L, dt=DT)
    assert before == (fs.fused_leapfrog_step.launches, fs.fused_kdk_horizon.launches,
                      fs.fused_packed_horizon.launches)
