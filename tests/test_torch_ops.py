"""PyTorch port of ops/ against the JAX package on CPU: grid operators, the
field solve and energies, deposit and gather (dense path and the CIC
kernel's plain version), all from the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.ops import deposit as jdep
from plasma_control_tpu.ops import fields as jfields
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu.ops.pallas.cic_pallas import deposit_cic_pallas, gather_cic_pallas
from plasma_control_tpu_torch.interop import grid_from_numpy
from plasma_control_tpu_torch.ops import deposit as tdep
from plasma_control_tpu_torch.ops import fields as tfields
from plasma_control_tpu_torch.ops.grid import GRID_LEAVES, make_grid as tmake_grid
from plasma_control_tpu_torch.ops.kernels import cic

torch.set_num_threads(1)

L, M = 50.0, 64
KINDS = ["cic", "tsc", "tsc_standard"]


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("m,length", [(64, 50.0), (33, 10.0)])
def test_grid_operators_match(m, length):
    """Both sides build the operators in float64 numpy and round once to
    float32: exact equality."""
    jg, tg = jmake_grid(m, length), tmake_grid(m, length, device="cpu")
    for name in GRID_LEAVES:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), name)
    assert (tg.n_mesh, tg.length, tg.dx) == (jg.n_mesh, jg.length, jg.dx)


def test_grid_from_numpy_copies_jax_leaves():
    jg = jmake_grid(M, L)
    leaves = {name: np.asarray(jax.device_put(getattr(jg, name))) for name in GRID_LEAVES}
    tg = grid_from_numpy(jg.n_mesh, jg.length, device="cpu", **leaves)
    tg.e_op.mul_(0.0)  # writable: the read-only JAX buffer was copied
    assert np.abs(np.asarray(jg.e_op)).max() > 0


def test_actuator_matches_and_hands_over():
    """The actuator basis is built in float64 numpy on both sides and rounded
    once: exact equality, for make_actuator and for the numpy hand-over."""
    from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
    from plasma_control_tpu_torch.control.actuator import ACTUATOR_LEAVES, make_actuator
    from plasma_control_tpu_torch.interop import actuator_from_numpy

    for endpoint in (True, False):
        ja = jmake_actuator(L, M, 4, endpoint_grid=endpoint)
        ta = make_actuator(L, M, 4, endpoint_grid=endpoint, device="cpu")
        leaves = {name: np.asarray(getattr(ja, name)) for name in ACTUATOR_LEAVES}
        tb = actuator_from_numpy(ja.length, ja.n_mesh, ja.max_mode, device="cpu", **leaves)
        for name in ACTUATOR_LEAVES:
            np.testing.assert_array_equal(getattr(ta, name).numpy(), leaves[name])
            np.testing.assert_array_equal(getattr(tb, name).numpy(), leaves[name])
    coeffs = np.linspace(-1, 1, 24, dtype=np.float32).reshape(3, 8)
    np.testing.assert_allclose(ta.compute_e_packed(_t(coeffs)).numpy(),
                               np.asarray(ja.compute_e_packed(jnp.asarray(coeffs))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ta.input_energy(_t(coeffs)).numpy(),
                               np.asarray(ja.input_energy(jnp.asarray(coeffs))), rtol=1e-6)


def test_solve_and_energies_match(rng):
    """fp32 matmul over M=64 terms and fp32 sums: rtol 1e-5."""
    jg, tg = jmake_grid(M, L), tmake_grid(M, L, device="cpu")
    n = (1.0 + 0.1 * rng.standard_normal((3, M))).astype(np.float32)
    v = rng.standard_normal(500).astype(np.float32)
    je = jfields.solve_e_mesh(jnp.asarray(n), jg)
    te = tfields.solve_e_mesh(_t(n), tg)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tfields.electric_energy(te, tg, 500).numpy(),
        np.asarray(jfields.electric_energy(je, jg, 500)), rtol=1e-5)
    np.testing.assert_allclose(
        tfields.kinetic_energy(_t(v)).numpy(), np.asarray(jfields.kinetic_energy(jnp.asarray(v))),
        rtol=1e-5)


@pytest.mark.parametrize("method", ["dense", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_deposit_matches_jax_dense(rng, kind, method):
    """Positions outside [0, L) exercise the wrap. Same bar as the JAX
    package's Pallas tests (fp32 weight sums of ~11 particles per cell):
    rtol 1e-5, atol 1e-4."""
    x = rng.uniform(-L, 2 * L, 700).astype(np.float32)  # N not a multiple of 128
    ref = jdep.deposit(jnp.asarray(x), jmake_grid(M, L), kind=kind, method="dense")
    got = tdep.deposit(_t(x), tmake_grid(M, L, device="cpu"), kind=kind, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", ["dense", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_matches_jax_dense(rng, kind, method):
    """The port sums 4 taps, the JAX dense path a full (N, M) @ (M,) row of
    mostly zero weights: fp32 reassociation only, rtol 1e-5, atol 1e-4 as for
    the deposit."""
    x = rng.uniform(-L, 2 * L, 700).astype(np.float32)
    e = rng.standard_normal(M).astype(np.float32)
    ref = jdep.gather(jnp.asarray(e), jnp.asarray(x), jmake_grid(M, L), kind=kind, method="dense")
    got = tdep.gather(_t(e), _t(x), tmake_grid(M, L, device="cpu"), kind=kind, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_cic_plain_matches_pallas_kernel(rng, kind):
    """The CUDA kernel's plain version against the Pallas TPU kernel it
    replaces (interpret mode), batched (B, N) with a per-row field, at the
    JAX package's own Pallas bar (rtol 1e-5, atol 1e-4: fp32 sums in another
    order); and charge conservation, sum of weights = N per row to fp32
    rounding of a 512-term sum (rtol 1e-6)."""
    x = rng.uniform(0, L, (4, 512)).astype(np.float32)
    e = rng.standard_normal((4, M)).astype(np.float32)
    ref_n = deposit_cic_pallas(jnp.asarray(x), M, L, block_n=256, interpret=True, kind=kind)
    got_n = cic.deposit_cic(_t(x), M, L, kind=kind)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_n.sum(-1).numpy(), 512.0, rtol=1e-6)
    ref_g = gather_cic_pallas(jnp.asarray(e), jnp.asarray(x), M, L, block_n=256, interpret=True,
                              kind=kind)
    got_g = cic.gather_cic(_t(e), _t(x), M, L, kind=kind)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shared", [True, False], ids=["shared-field", "row-fields"])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_of_unwrapped_positions_matches_pallas(rng, kind, shared):
    """The gather kernel wraps positions itself, as torch.remainder does:
    its plain version and deposit.gather(method="pallas") on positions in
    [-L, 2L), with one (M,) field for every row or a field per row, against
    the Pallas TPU kernel (interpret mode) on the jnp.mod-wrapped positions
    (the same fmod and sign fix-up, so the same float32 positions): atol
    1e-5, the bar of the kernel against its plain version."""
    x = rng.uniform(-L, 2 * L, (4, 512)).astype(np.float32)
    e = rng.standard_normal(M if shared else (4, M)).astype(np.float32)
    ref = gather_cic_pallas(jnp.asarray(np.broadcast_to(e, (4, M))), jnp.mod(jnp.asarray(x), L), M,
                            L, block_n=256, interpret=True, kind=kind)
    got = cic.gather_cic_plain(_t(e), _t(x), M, L, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.0, atol=1e-5)
    via = tdep.gather(_t(e), _t(x), tmake_grid(M, L, device="cpu"), kind=kind, method="pallas")
    np.testing.assert_allclose(via.numpy(), np.asarray(ref), rtol=0.0, atol=1e-5)


def test_cic_plain_at_the_wrap_edge():
    """A position that rounds to pos == M (x just below L) deposits into
    cells M-1, 0, 1 like the dense path. The kernel scales by 1/dx (as the
    Pallas kernel does), the dense path divides by dx: one fp32 ulp of
    pos ~ M = 64 (7.6e-6) apart."""
    x = np.array([np.nextafter(np.float32(L), np.float32(0)), 0.0, L / M * 0.5], np.float32)
    tg = tmake_grid(M, L, device="cpu")
    for kind in KINDS:
        dense = tdep.deposit(_t(x), tg, kind=kind, method="dense", normalize=False)
        np.testing.assert_allclose(cic.deposit_cic(_t(x), M, L, kind).numpy(), dense.numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("kind", KINDS)
def test_pallas_deposit_wraps_and_normalizes_like_jax(rng, kind, normalize):
    """deposit(method="pallas") on positions in [-L, 2L): the port wraps and
    scales inside the kernel (on the CPU its plain version), the JAX package
    wraps with jnp.mod before its Pallas kernel (interpret mode) and
    multiplies after it. Same bar as the Pallas tests above: rtol 1e-5, atol
    1e-4."""
    x = rng.uniform(-L, 2 * L, 700).astype(np.float32)
    ref = jdep.deposit(jnp.asarray(x), jmake_grid(M, L), n0=1.3, kind=kind, method="pallas",
                       normalize=normalize)
    got = tdep.deposit(_t(x), tmake_grid(M, L, device="cpu"), n0=1.3, kind=kind,
                       method="pallas", normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_cic_plain_scale_matches_pallas_kernel(rng, kind):
    """deposit_cic with a scale (the caller's normalisation, applied by the
    kernel) against the Pallas TPU kernel's density times the same scale,
    batched (B, N): rtol 1e-5, atol 1e-4."""
    x = rng.uniform(0, L, (4, 512)).astype(np.float32)
    scale = 1.3 * L / 512 / (L / M)
    ref = deposit_cic_pallas(jnp.asarray(x), M, L, block_n=256, interpret=True, kind=kind) * scale
    for fn in (cic.deposit_cic, cic.deposit_cic_plain):
        np.testing.assert_allclose(fn(_t(x), M, L, kind, scale=scale).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_pallas_deposit_at_the_wrap_edges(rng, kind):
    """x = L - ulp stays below L, x = L wraps to 0 and x = -ulp to L - 0 = L
    after rounding, which lands on cell 0 as pos = M: the port wraps with
    torch.remainder's arithmetic (the kernel: fmodf or its exact shortcuts),
    the JAX package with jnp.mod, the same float32 positions. Against the
    JAX package's pallas deposit, normalised and not: rtol 1e-5, atol 1e-4."""
    f32 = np.float32
    edges = np.array([np.nextafter(f32(L), f32(0)), L, np.nextafter(f32(0), f32(-1)),
                      -np.nextafter(f32(L), f32(0)), np.nextafter(f32(2 * L), f32(0)), 0.0], f32)
    x = np.concatenate([np.repeat(edges, 5), rng.uniform(0, L, 97).astype(f32)])
    for normalize in (True, False):
        ref = jdep.deposit(jnp.asarray(x), jmake_grid(M, L), kind=kind, method="pallas",
                           normalize=normalize)
        got = tdep.deposit(_t(x), tmake_grid(M, L, device="cpu"), kind=kind, method="pallas",
                           normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError):
        cic.deposit_cic(x, M, L)
    with pytest.raises(RuntimeError):
        cic.gather_cic(torch.zeros(M, device="meta"), x, M, L)


def test_unported_method_raises():
    """A method that neither package has raises; "scatter" is ported."""
    tg = tmake_grid(M, L, device="cpu")
    for fn in (lambda: tdep.deposit(torch.zeros(8), tg, method="segment"),
               lambda: tdep.gather(torch.zeros(M), torch.zeros(8), tg, method="segment")):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("kind", KINDS)
def test_scatter_matches_jax_scatter(rng, kind):
    """The scatter path against the JAX package's: the same two or three
    cells and weights per particle, summed with scatter_add_ (deposit) and
    read back with gather, for batched (B, N) positions and a shared (M,)
    field, row by row. XLA may scale by 1/dx where the port divides by dx:
    one ulp of a cell position near M=64 (7.6e-6) moves a weight by as much,
    so both are held to the bar of the dense tests above, rtol 1e-5 and atol
    1e-4 (weights to atol 1e-5)."""
    x = rng.uniform(-L, 2 * L, (3, 700)).astype(np.float32)
    e = rng.standard_normal(M).astype(np.float32)
    jg, tg = jmake_grid(M, L), tmake_grid(M, L, device="cpu")
    got_n = tdep.deposit(_t(x), tg, kind=kind, method="scatter")
    got_e = tdep.gather(_t(e), _t(x), tg, kind=kind, method="scatter")
    assert got_n.shape == (3, M) and got_e.shape == (3, 700)
    for row in range(3):
        ref_n = jdep.deposit(jnp.asarray(x[row]), jg, kind=kind, method="scatter")
        ref_e = jdep.gather(jnp.asarray(e), jnp.asarray(x[row]), jg, kind=kind, method="scatter")
        np.testing.assert_allclose(got_n[row].numpy(), np.asarray(ref_n), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got_e[row].numpy(), np.asarray(ref_e), rtol=1e-5, atol=1e-4)
    cells, weights = tdep.deposit_and_gather_indices(_t(x[0]), tg, kind)
    jcells, jweights = jdep.deposit_and_gather_indices(jnp.asarray(x[0]), jg, kind)
    for a, b in zip(cells, jcells):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(weights, jweights):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
