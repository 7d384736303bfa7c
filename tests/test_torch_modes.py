"""Kernel 1 beyond 16 modes and the million-particle 32-mode controller on
CPU: the spectral horizon's plain version against the Pallas TPU kernel
(interpret mode) at Km = 20 and 32 with fewer drive modes than model modes,
the blocked kernel's launch geometry, and one solve of the port's ``plan``
against the JAX package's at a small size of
``experiments/million_r5.py``'s ``fullfid_K384_wt4_wraw05_cm2_mm16``
(two-stream, ``max_mode=16``, ``plan_modes=32``, ``plan_chunk``, bounds +-2),
with JAX's draws handed over."""

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
from plasma_control_tpu_torch.ops.kernels import _build
from plasma_control_tpu_torch.ops.kernels.spectral_horizon import _state_floats
from plasma_control_tpu_torch.ops.kernels.spectral_horizon import (
    Geometry, StreamLayout, launch_geometry, scratch_shape, spectral_horizon,
    spectral_horizon_supported, state_in_shared, stream_layout,
)

torch.set_num_threads(1)

L = 50.0


def _inputs(seed, n, k, h, ka, twin_km=None):
    r = np.random.default_rng(seed)
    x = r.uniform(0, L, n).astype(np.float32)
    v = (2.0 * r.standard_normal(n)).astype(np.float32)
    u_c = (0.3 * r.standard_normal((k, h, ka))).astype(np.float32)
    u_s = (0.3 * r.standard_normal((k, h, ka))).astype(np.float32)
    twin = None
    if twin_km is not None:  # targets of the size of the mode sums, ~sqrt(N)
        twin = [(np.sqrt(n) * r.standard_normal((h, twin_km))).astype(np.float32)
                for _ in range(2)]
    return x, v, u_c, u_s, twin


@pytest.mark.parametrize("corrected", [False, True], ids=["plain", "corrected"])
@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("km,ka", [(20, 12), (32, 16)])
def test_plain_matches_pallas_beyond_16_modes(km, ka, rot, corrected):
    """Ka drive modes padded to Km model modes, as candidate_costs hands them
    over: the port's (K, H, Ka) inputs with n_modes=Km against the Pallas
    kernel on zero-padded (K, H, Km) inputs. The mode sums reduce in another
    order: rtol 2e-4, the bar of the JAX package's drift-equivalence test."""
    n, k, h = 384, 6, 4
    x, v, u_c, u_s, twin = _inputs(km + ka, n, k, h, ka, km if corrected else None)
    kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot)
    pad = ((0, 0), (0, 0), (0, km - ka))
    jtwin = dict(twin_c=jnp.asarray(twin[0]), twin_s=jnp.asarray(twin[1])) if corrected else {}
    ttwin = dict(twin_c=torch.tensor(twin[0]), twin_s=torch.tensor(twin[1])) if corrected else {}
    ref = fused_spectral_horizon(jnp.asarray(x), jnp.asarray(v), jnp.asarray(np.pad(u_c, pad)),
                                 jnp.asarray(np.pad(u_s, pad)), interpret=True, **kw, **jtwin)
    got = spectral_horizon(torch.tensor(x), torch.tensor(v), torch.tensor(u_c),
                           torch.tensor(u_s), n_modes=km, **kw, **ttwin)
    assert got.shape == (k, h) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("km", [17, 32, 64])
def test_kernel_takes_up_to_64_modes(km):
    """Every Km from 1 to 64 is the kernel's (per-mode constants in a
    64-entry parameter block); 65 is refused, as Km = 0 is."""
    assert spectral_horizon_supported(5000, km) and spectral_horizon_supported(1_000_000, km)
    assert _build.MAX_MODES == 64 and _build.BLOCK_MODES == 16
    assert len(_build.SpectralParams().g) == len(_build.SpectralParams().inv_k2) == 64
    assert not spectral_horizon_supported(5000, 65) and not spectral_horizon_supported(5000, 0)


@pytest.mark.parametrize("rot,limit", [(True, 307_360), (False, 230_528)], ids=["rot", "trig"])
def test_blocked_geometry_leaves_room_for_the_block_coefficients(rot, limit):
    """Km > 16 keeps 512 B of block coefficients beside the reduction's
    1408 B, so a cluster of 16 CTAs holds up to 16 * floor((227 KB - 1920
    B) / (12 or 16 B)) particles in shared memory; beyond, the global
    scratch. Km <= 16 keeps its limits (308048 and 231040)."""
    assert state_in_shared(limit, rot, 32) and not state_in_shared(limit + 1, rot, 32)
    assert state_in_shared(limit + 1, rot, 16) and state_in_shared(limit + 1, rot)
    per = 12 if rot else 16
    geo = launch_geometry(limit, rot, 32)
    assert geo.cluster == 16 and geo.shared_bytes == per * geo.slice
    assert per * geo.slice <= _build.SHARED_BYTES - 1408 - 512


@pytest.mark.parametrize("n,km,shared", [(1_000_000, 32, False), (20_000, 32, True),
                                         (10_000, 32, True), (320_000, 20, False)])
def test_path_shapes_placement(n, km, shared):
    """The million-particle controller's solve (N=1M, Km=32: clusters of 16
    CTAs, state in the global scratch), kernel 1's shared-memory check shape
    (N=20000) and the twin plan model at Km=32 (N=10000) on the rot drift."""
    geo = launch_geometry(n, True, km)
    assert (geo.shared_bytes > 0) == shared
    assert geo.cluster == (16 if n >= 320_000 else 4 if n == 20_000 else 2)


@pytest.mark.parametrize("rot", [True, False], ids=["rot", "trig"])
@pytest.mark.parametrize("n,km,k", [(1_000_000, 32, 16), (320_000, 16, 32), (308_049, 8, 3),
                                    (2_500_001, 64, 2)])
def test_global_scratch_layout(n, km, k, rot):
    """The state in the global scratch (the million path's chunk, the
    [global] check shape, just past the shared limit, and an odd N at 64
    modes): clusters of 16 CTAs; CTA r of candidate c (row c * 16 + r of the
    scratch) owns particles [r S, min((r + 1) S, N)), every particle once; a
    row holds _state_floats(rot, in_global=True) = 3 floats a particle for
    rot (c1, s1, vh) and 2 for trig (x, vh), S of each."""
    geo = launch_geometry(n, rot, km)
    assert geo.cluster == 16 and geo.shared_bytes == 0 and geo.slice == -(-n // 16)
    assert _state_floats(rot, in_global=True) == (3 if rot else 2)
    # one cluster of 16 CTAs per candidate, forced
    rows, width = scratch_shape(k, geo, rot)
    assert (rows, width) == (k * geo.cluster, _state_floats(rot, in_global=True) * geo.slice)
    # the clusters the rule picks from a card's table: a row per CTA of the
    # launch, the slices of its 16 / C virtual ranks side by side
    layout = stream_layout(k, geo.cluster, TABLE)
    per = geo.cluster // layout.cluster
    assert scratch_shape(k, geo, rot, layout) == (
        layout.clusters * layout.cluster, _state_floats(rot, in_global=True) * per * geo.slice)
    owners = np.zeros(n, dtype=np.int8)
    for r in range(layout.cluster):
        for j in range(per):
            q = r * per + j  # CTA r's local rank j
            lo = min(q * geo.slice, n)
            cnt = min(geo.slice, n - lo)
            assert 0 <= cnt <= geo.slice  # the row's slice holds the virtual rank's particles
            owners[lo:lo + cnt] += 1
    assert (owners == 1).all()


# clusters of C CTAs an H100 might hold at once (A(C)): 264 CTA slots at
# two CTAs per SM, 224 at C=16 (14 clusters, as measured); and the
# card's own table (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3)
TABLE = {16: 14, 8: 30, 4: 66, 2: 132, 1: 264}
H100 = {16: 14, 8: 30, 4: 62, 2: 132, 1: 264}


@pytest.mark.parametrize("table,k,want", [
    (TABLE, 1, (16, 1)), (TABLE, 16, (16, 14)), (TABLE, 32, (16, 14)), (TABLE, 384, (4, 66)),
    (H100, 1, (16, 1)), (H100, 16, (16, 14)), (H100, 24, (16, 14)), (H100, 32, (16, 14)),
    (H100, 384, (2, 132)),
], ids=["1", "16", "32", "384", "h100-1", "h100-16", "h100-24", "h100-32", "h100-384"])
def test_stream_layout_choice(table, k, want):
    """The physical cluster of the global path at 16 virtual ranks: the C
    of least rounds x slices per CTA, the larger C on a tie. K=1: C=16 (one
    slice per CTA); K=16 (the source's chunk): C=16, 2 rounds of one slice
    (C=8: one round of two); K=32: C=16, 3 rounds of 14; K=384: C=4 in 6
    rounds of 66 (24 slice-rounds, as C=2 in 3 rounds of 132), or on the
    H100's table, whose A(4) is 62, C=2 (C=4: 28; C=16: 28)."""
    got = stream_layout(k, 16, table)
    assert got == StreamLayout(*want)
    assert got.clusters == min(k, table[got.cluster])


@pytest.mark.parametrize("k", [1, 16, 32, 384])
def test_stream_layout_keeps_16_on_a_flat_table(k):
    """A card that holds as many clusters at every C gains nothing from
    smaller ones: C=16, min(K, A) clusters."""
    assert stream_layout(k, 16, dict.fromkeys(TABLE, 14)) == StreamLayout(16, min(k, 14))


@pytest.mark.parametrize("ranks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 3, 16, 32, 100, 384, 1024])
def test_stream_layout_divides_the_ranks(k, ranks):
    """C divides the virtual ranks and fits; min(K, A(C)) clusters, so no
    cluster is left without a candidate."""
    got = stream_layout(k, ranks, TABLE)
    assert ranks % got.cluster == 0 and got.cluster in TABLE
    assert got.clusters == min(k, TABLE[got.cluster]) and 1 <= got.clusters <= k


def test_stream_layout_skips_what_does_not_fit():
    """A C the card cannot hold (A(C) = 0) is never chosen; none at all
    raises."""
    assert stream_layout(384, 16, {**H100, 2: 0}) == StreamLayout(8, 30)
    # C=4 ties C=16 at 28 slice-rounds: the larger C, of 28 rounds
    assert stream_layout(384, 16, {**H100, 2: 0, 8: 0}) == StreamLayout(16, 14)
    with pytest.raises(RuntimeError, match="no cluster"):
        stream_layout(4, 16, dict.fromkeys(TABLE, 0))


@pytest.mark.parametrize("k,clusters", [(384, 132), (16, 14), (32, 14)])
def test_stream_scratch_shrinks(k, clusters):
    """The million solve's scratch (N=1M, Km=32, rot): a row per CTA of the
    chosen clusters, 3 x 62500 floats per virtual rank, against K x 16 rows
    of 3 x 62500 for one cluster per candidate (6144 rows at K=384,
    4.608e9 B)."""
    geo = launch_geometry(1_000_000, True, 32)
    assert geo == Geometry(16, 62_500, 0)
    layout = stream_layout(k, geo.cluster, H100)
    assert layout.clusters == clusters
    rows, width = scratch_shape(k, geo, True, layout)
    assert (rows, width) == (clusters * layout.cluster, 3 * 62_500 * 16 // layout.cluster)
    assert rows * width == clusters * 16 * 3 * 62_500
    assert scratch_shape(k, geo, True) == (16 * k, 3 * 62_500)
    assert clusters < k and rows * width < 16 * k * 3 * 62_500


@pytest.mark.parametrize("n,rot,km,geo", [
    (5000, True, 8, (1, 5000, 60000)), (10_000, True, 16, (2, 5000, 60000)),
    (20_000, True, 16, (4, 5000, 60000)), (20_000, False, 16, (8, 2500, 40000)),
    (100_000, True, 16, (16, 6250, 75000)), (100_000, False, 16, (16, 6250, 100000)),
    (20_000, True, 32, (4, 5000, 60000)), (10_000, True, 32, (2, 5000, 60000)),
    (308_048, True, 16, (16, 19253, 231036)), (231_040, False, 16, (16, 14440, 231040)),
])
def test_shared_memory_geometry_is_unchanged(n, rot, km, geo):
    """Where the state fits the cluster's shared memory (the spectral, twin,
    config-4, [km32] shapes and the two limits), the geometry is the one
    the kernel's shared-memory path has always been launched with, 3 or 4
    floats a particle, and no scratch."""
    got = launch_geometry(n, rot, km)
    assert got == Geometry(*geo) and state_in_shared(n, rot, km)
    assert got.shared_bytes == 4 * _state_floats(rot) * got.slice == 4 * (3 if rot else 4) * got.slice
    assert scratch_shape(384, got, rot) is None


# experiments/million_r5.py:51-53, 118-121 cut to a CPU test: N=2000 on 64
# cells (the study: N=1M on 256), K=32 in chunks of 8 (384 in chunks of 16),
# H=4 (10); Km=32 model modes over 16 actuated modes, bounds +-2, w_input
# 0.0025, w_terminal 4, scatter deposit, full fidelity
N, MESH, KA = 2000, 64, 16
MILLION = dict(n_candidates=32, w_input=0.0025, horizon=4, plan_modes=32, plan_chunk=8,
               w_terminal=4.0)
# like drift against like drift: the Pallas kernel (interpret mode) and the
# port's kernel wrapper (plain version on CPU) on the rot drift; the XLA scan
# and the port's op-by-op path on the trig drift
PATHS = {"fused-rot": dict(plan_kernel="fused"), "xla-trig": dict(plan_kernel="xla")}


def _both(mpc_kw, seed=0):
    sim = dict(simcase="two-stream", n_particles=N, n_mesh=MESH, dt=0.1, t_max=5.0, length=L,
               deposit_method="scatter")
    ctrl = dict(max_mode=KA, coeff_min=-2.0, coeff_max=2.0)
    r = np.random.default_rng(seed)
    x0 = r.uniform(0, L, N)
    k1 = 2 * np.pi / L
    x = np.mod(x0 + (0.5 / k1) * np.sin(k1 * x0), L).astype(np.float32)
    v = (r.standard_normal(N) + np.where(np.arange(N) % 2 == 0, 3.0, -3.0)).astype(np.float32)
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(MESH, L),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(**ctrl), mpc=JMPCConfig(**mpc_kw),
             actuator=jmake_actuator(L, MESH, KA))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(MESH, L, device="cpu"),
             cfg=SimConfig(**sim), ctrl=ControlConfig(**ctrl), mpc=MPCConfig(**mpc_kw),
             actuator=make_actuator(L, MESH, KA, device="cpu"))
    return j, t


def _jax_noise(key, cfg: JMPCConfig, d):
    """The (K, H, D) unit draws JAX's plan makes from ``key``."""
    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


@pytest.mark.parametrize("path", list(PATHS))
def test_chunked_costs_at_32_modes_match_jax(path):
    """The four chunks of 8 candidates at Km=32 over 16 actuated modes:
    rtol 2e-4, atol 1e-5 (the bar of the cost tests in
    test_torch_spectral.py)."""
    j, t = _both(dict(MILLION, **PATHS[path]))
    cand = np.clip(0.6 * np.random.default_rng(3).standard_normal((32, 4, 2 * KA)), -2, 2)
    cand = cand.astype(np.float32)
    ref = jmpc.candidate_costs(j["state"], jnp.asarray(cand), j["grid"], j["cfg"], j["mpc"],
                               j["actuator"])
    got = mpc.candidate_costs(t["state"], torch.tensor(cand), t["grid"], t["cfg"], t["mpc"],
                              t["actuator"])
    assert got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("path", list(PATHS))
def test_plan_at_32_modes_matches_jax(path):
    """One MPPI solve with JAX's knot draws handed over, from one warm-start
    nominal: MPPI's softmax (temperature 0.05) amplifies cost differences of
    ~1e-5 relative, so the nominal and the action to atol 2e-4 and the best
    cost to rtol 2e-4 (the bars of test_torch_mpc.py::test_plan_matches_jax)."""
    j, t = _both(dict(MILLION, **PATHS[path]))
    key = jax.random.PRNGKey(21)
    d = 2 * KA
    noise = _jax_noise(key, j["mpc"], d)
    mean = (0.3 * np.random.default_rng(2).standard_normal((j["mpc"].horizon, d))).astype(
        np.float32)
    ja, jm, jb = jmpc.plan(j["state"], jnp.asarray(mean), jnp.asarray(0.3, jnp.float32), key,
                           j["grid"], j["cfg"], j["ctrl"], j["mpc"], j["actuator"])
    ta, tm, tb = mpc.plan(t["state"], torch.tensor(mean), 0.3, None, t["grid"], t["cfg"],
                          t["ctrl"], t["mpc"], t["actuator"], noise=torch.tensor(noise))
    assert tm.shape == (4, d) and ta.shape == (d,)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=2e-4)
