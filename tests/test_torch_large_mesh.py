"""The grid planner beyond 3631 cells on CPU: where kernels 4-6 keep their
mesh arrays (``_layout``: in a global scratch once they exceed a CTA's
shared memory), the kernels' plain versions at M=4096 against the Pallas TPU
kernels they replace (``experiments/pallas_fused_step.py``, interpret mode),
and the grid planner's candidate costs at M=4096 against the JAX package's."""

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
)
from plasma_control_tpu.config import MPCConfig as JMPCConfig  # noqa: E402
from plasma_control_tpu.config import SimConfig as JSimConfig  # noqa: E402
from plasma_control_tpu.control import mpc as jmpc  # noqa: E402
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator  # noqa: E402
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState  # noqa: E402
from plasma_control_tpu.ops.grid import make_grid as jmake_grid  # noqa: E402
from plasma_control_tpu_torch.config import MPCConfig, SimConfig  # noqa: E402
from plasma_control_tpu_torch.control import mpc  # noqa: E402
from plasma_control_tpu_torch.control.actuator import make_actuator  # noqa: E402
from plasma_control_tpu_torch.interop import state_from_numpy  # noqa: E402
from plasma_control_tpu_torch.ops.grid import make_grid  # noqa: E402
from plasma_control_tpu_torch.ops.kernels import _build  # noqa: E402
from plasma_control_tpu_torch.ops.kernels import fused_step as fs  # noqa: E402

torch.set_num_threads(1)

L, M, N, K, H, DT = 50.0, 4096, 64, 2, 2, 0.1


@pytest.fixture(scope="module")
def e_op_t():
    return make_grid(M, L, device="cpu").e_op.T.contiguous()


def _state(seed, shape):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("m,mesh", [(64, True), (3631, True), (3632, False), (4096, False),
                                    (12288, False)])
def test_layout_puts_the_mesh_arrays_where_they_fit(m, mesh):
    """The mesh arrays take 64 M + 32 bytes (two fixed-point histograms, four
    fields, eight rows of densities, eight energy partials): in shared memory
    up to M=3631, in a global scratch of that many floats per CTA beyond,
    and then the state and the operator in global memory too."""
    layout = fs._layout(N, m)
    assert layout.mesh == mesh
    assert 4 * fs._mesh_words(m) == 64 * m + 32
    assert (4 * fs._mesh_words(m) <= _build.SHARED_BYTES) == mesh
    if not mesh:
        assert layout == fs.Layout(False, False, False)
    else:
        assert layout.state == (64 * m + 32 + 8 * N <= _build.SHARED_BYTES)


def test_mesh_scratch_rows():
    """One row of the global scratch per CTA (per candidate or batch row),
    none where the mesh arrays fit shared memory."""
    assert fs._mesh_scratch(fs._layout(N, 64), 8, 64, "cpu") is None
    scratch = fs._mesh_scratch(fs._layout(N, M), 8, M, "cpu")
    assert scratch.shape == (8, 16 * M + 8) and scratch.dtype == torch.float32


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "kick-field"])
def test_leapfrog_plain_matches_pallas_at_4096_cells(exact, e_op_t):
    """K=2 rows of N=64 particles on 4096 cells: x and v to rtol 1e-5 / atol
    1e-4 and the field energy to rtol 1e-4, the bars of
    experiments/test_pallas_fused_step.py."""
    x, v = _state(1, (K, N))
    e_ext = (0.05 * np.random.default_rng(2).standard_normal((K, M))).astype(np.float32)
    kw = dict(n_mesh=M, length=L, dt=DT, exact=exact)
    jx, jv, je = jfused_leapfrog_step(jnp.asarray(x), jnp.asarray(v), jnp.asarray(e_ext),
                                      jnp.asarray(e_op_t.numpy()), interpret=True, **kw)
    tx, tv, te = fs.fused_leapfrog_step(torch.tensor(x), torch.tensor(v), torch.tensor(e_ext),
                                        e_op_t, **kw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    pe = lambda e: 0.5 * (L / M) * np.sum(np.asarray(e, np.float64) ** 2, axis=-1)
    np.testing.assert_allclose(pe(te.numpy()), pe(je), rtol=1e-4)


@pytest.mark.parametrize("merged", [False, True], ids=["kdk", "packed"])
def test_horizon_plain_matches_pallas_at_4096_cells(merged, e_op_t):
    """K=2 candidates, H=2 steps, N=64 on 4096 cells: per-step energies to
    rtol 2e-4, the bar of the experiments' horizon tests. The TPU's
    merged-kick kernel packs 128 // M candidates per vector row and takes at
    most 128 cells, so at 4096 the merged-kick plain version is held against
    the explicit TPU kernel, whose contract it shares (the merged kick only
    reassociates the two half-kicks)."""
    x, v = _state(3, N)
    u = (0.05 * np.random.default_rng(4).standard_normal((K, H, M))).astype(np.float32)
    kw = dict(n_mesh=M, length=L, dt=DT)
    jfn, tfn = jfused_kdk_horizon, fs.fused_packed_horizon if merged else fs.fused_kdk_horizon
    ref = jfn(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u), jnp.asarray(e_op_t.numpy()),
              interpret=True, **kw)
    got = tfn(torch.tensor(x), torch.tensor(v), torch.tensor(u), e_op_t, **kw)
    assert got.shape == (K, H) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4)


@pytest.mark.parametrize("integrator", ["kdk", "leapfrog"])
def test_grid_planner_costs_at_4096_cells_match_jax(integrator):
    """The grid planner on a 4096-cell model (K=2, H=2, N=64, dense deposit,
    max_mode 2): the port's op-by-op costs against the JAX package's, rtol
    2e-4 / atol 1e-5, the bar of test_torch_grid_plan.py."""
    sim = dict(simcase="two-stream", n_particles=N, n_mesh=M, dt=DT, t_max=5.0, length=L)
    x, v = _state(5, N)
    kw = dict(horizon=H, n_candidates=K, plan_model="grid", plan_integrator=integrator,
              w_terminal=2.0)
    cand = (0.3 * np.random.default_rng(6).standard_normal((K, H, 4))).astype(np.float32)
    ref = jmpc.candidate_costs(JPlasmaState(jnp.asarray(x), jnp.asarray(v)), jnp.asarray(cand),
                               jmake_grid(M, L), JSimConfig(**sim), JMPCConfig(**kw),
                               jmake_actuator(L, M, 2))
    got = mpc.candidate_costs(state_from_numpy(x, v, device="cpu"), torch.tensor(cand),
                              make_grid(M, L, device="cpu"), SimConfig(**sim), MPCConfig(**kw),
                              make_actuator(L, M, 2, device="cpu"))
    assert got.shape == (K,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)


def test_explicit_and_merged_horizons_agree_at_4096_cells(e_op_t):
    """Kernels 5 and 6 have one contract: at M=4096 their plain versions'
    energies agree to rtol 2e-4 (the merged kick reassociates the two
    half-kicks)."""
    x, v = _state(7, N)
    u = 0.05 * torch.randn((K, H, M), generator=torch.Generator().manual_seed(7))
    kw = dict(n_mesh=M, length=L, dt=DT)
    a = fs.fused_kdk_horizon(torch.tensor(x), torch.tensor(v), u, e_op_t, **kw)
    b = fs.fused_packed_horizon(torch.tensor(x), torch.tensor(v), u, e_op_t, **kw)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4)
