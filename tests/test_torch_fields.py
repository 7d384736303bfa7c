"""PyTorch port of the rest of ops/ and utils/guards against the JAX package
on CPU: the five field functions (and the float64 oracle of the reference
semantics), the packed-state integrators including both exits of implicit
midpoint, and the guards, all from the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.ops import fields as jfields
from plasma_control_tpu.ops import integrate as jint
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu.utils import guards as jguards
from plasma_control_tpu_torch.ops import fields as tfields
from plasma_control_tpu_torch.ops import integrate as tint
from plasma_control_tpu_torch.ops.grid import make_grid as tmake_grid
from plasma_control_tpu_torch.utils import guards as tguards

import oracle

torch.set_num_threads(1)

L, N = 50.0, 1500
METHODS = [("dense", "cic"), ("scatter", "cic"), ("pallas", "cic"), ("pallas", "tsc"),
           ("dense", "tsc_standard")]


def _x(rng, n=N):
    return rng.uniform(0, L, n).astype(np.float32)


def _density(rng, m):
    return (1.0 + 0.1 * rng.standard_normal(m)).astype(np.float32)


def _grids(m):
    return jmake_grid(m, L), tmake_grid(m, L, device="cpu")


@pytest.mark.parametrize("m", [64, 63])
def test_phi_and_fft_solves_match(rng, m):
    """solve_phi_mesh is the circulant matvec (rtol 1e-5 against JAX);
    solve_e_mesh_fft the rFFT path, odd meshes too (atol 1e-6 against JAX,
    and 1e-5 against the matmul path as the JAX test holds it)."""
    jg, tg = _grids(m)
    n = _density(rng, m)
    phi = tfields.solve_phi_mesh(torch.tensor(n), tg).numpy()
    np.testing.assert_allclose(phi, np.asarray(jfields.solve_phi_mesh(jnp.asarray(n), jg)),
                               rtol=1e-5, atol=1e-6)
    e_fft = tfields.solve_e_mesh_fft(torch.tensor(n), tg)
    assert e_fft.dtype == torch.float32 and e_fft.shape == (m,)
    np.testing.assert_allclose(e_fft.numpy(), np.asarray(jfields.solve_e_mesh_fft(jnp.asarray(n), jg)),
                               atol=1e-6)
    np.testing.assert_allclose(e_fft.numpy(), tfields.solve_e_mesh(torch.tensor(n), tg).numpy(),
                               atol=1e-5)


def test_fft_solve_batched(rng):
    """Leading batch dims go through the rFFT path row by row."""
    _, tg = _grids(64)
    n = np.stack([_density(rng, 64) for _ in range(3)])
    got = tfields.solve_e_mesh_fft(torch.tensor(n), tg)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(),
                                   tfields.solve_e_mesh_fft(torch.tensor(n[i]), tg).numpy(), atol=1e-7)


@pytest.mark.parametrize("method,kind", METHODS)
def test_density_field_and_hamiltonian_match(rng, method, kind):
    """compute_density, compute_e (with and without an external field and
    the mesh) and hamiltonian against JAX with the same method and kind:
    rtol 1e-5 on densities and H, atol 1e-5 on fields (differences of
    nearly equal sums)."""
    jg, tg = _grids(48)
    x, v = _x(rng), rng.standard_normal(N).astype(np.float32)
    e_ext = (0.05 * rng.standard_normal(48)).astype(np.float32)
    kw = dict(kind=kind, method=method)
    np.testing.assert_allclose(tfields.compute_density(torch.tensor(x), tg, **kw).numpy(),
                               np.asarray(jfields.compute_density(jnp.asarray(x), jg, **kw)),
                               rtol=1e-5, atol=1e-5)
    te_p, te_mesh = tfields.compute_e(torch.tensor(x), tg, 1.0, torch.tensor(e_ext), **kw)
    je_p, je_mesh = jfields.compute_e(jnp.asarray(x), jg, 1.0, jnp.asarray(e_ext), **kw)
    np.testing.assert_allclose(te_mesh.numpy(), np.asarray(je_mesh), atol=1e-5)
    np.testing.assert_allclose(te_p.numpy(), np.asarray(je_p), atol=1e-5)
    only = tfields.compute_e(torch.tensor(x), tg, return_mesh=False, **kw)
    np.testing.assert_allclose(only.numpy(), np.asarray(jfields.compute_e(jnp.asarray(x), jg,
                                                                         return_mesh=False, **kw)),
                               atol=1e-5)
    h = tfields.hamiltonian(torch.tensor(x), torch.tensor(v), tg, **kw)
    np.testing.assert_allclose(float(h), float(jfields.hamiltonian(jnp.asarray(x), jnp.asarray(v),
                                                                   jg, **kw)), rtol=1e-5)


def test_fields_match_float64_oracle(rng):
    """The reference semantics in float64 numpy (tests/oracle.py): CIC
    density rtol 3e-4, E on the mesh and at the particles atol 1e-4, H
    rtol 1e-3 (the JAX package's own oracle tolerances)."""
    _, tg = _grids(64)
    x64, v64 = rng.uniform(0, L, N), rng.standard_normal(N)
    x32 = torch.tensor(x64, dtype=torch.float32)
    n = tfields.compute_density(x32, tg).numpy()
    n_ref = oracle.deposit_cic(x64, 1.0, L, 64)
    np.testing.assert_allclose(n, n_ref, rtol=3e-4, atol=3e-4)
    e_p, e_mesh = tfields.compute_e(x32, tg)
    e_ref = oracle.solve_e_mesh(n_ref, L, 1.0)
    np.testing.assert_allclose(e_mesh.numpy(), e_ref, atol=1e-4)
    np.testing.assert_allclose(e_p.numpy(), oracle.gather_cic(e_ref, x64, L, 64), atol=1e-4)
    np.testing.assert_allclose(tfields.solve_e_mesh_fft(torch.tensor(n_ref, dtype=torch.float32),
                                                        tg).numpy(), e_ref, atol=1e-5)
    h = float(tfields.hamiltonian(x32, torch.tensor(v64, dtype=torch.float32), tg))
    h_ref = oracle.hamiltonian(x64, v64, L, 64, 1.0)
    assert abs(h - h_ref) / abs(h_ref) < 1e-3


def _sho(lib):
    def grad(e):
        return lib.stack([e[1], -e[0]])

    return grad


def _pic_grad(grid, tgrid):
    """d(eta)/dt of a small PIC state, for both packages."""

    def jgrad(e):
        n = e.shape[0] // 2
        return jnp.concatenate([e[n:], -jfields.compute_e(e[:n], grid, return_mesh=False)])

    def tgrad(e):
        n = e.shape[0] // 2
        return torch.cat([e[n:], -tfields.compute_e(e[:n], tgrid, return_mesh=False)])

    return jgrad, tgrad


@pytest.mark.parametrize("name", ["forward_euler", "explicit_midpoint"])
def test_explicit_packed_integrators_match(rng, name):
    """On a PIC state (N=256, M=32): rtol 1e-5 against JAX."""
    jg, tg = jmake_grid(32, L), tmake_grid(32, L, device="cpu")
    jgrad, tgrad = _pic_grad(jg, tg)
    eta = np.concatenate([_x(rng, 256), rng.standard_normal(256).astype(np.float32)])
    got = getattr(tint, name)(torch.tensor(eta), tgrad, 0.1).numpy()
    ref = np.asarray(getattr(jint, name)(jnp.asarray(eta), jgrad, 0.1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_implicit_midpoint_converges_like_jax():
    """The converged exit: a harmonic oscillator's fixed-point iteration in
    float32 reaches an exact fixed point (norm of the change 0 < 1e-12) on
    both sides (after 10 iterations from this state), so the result is
    eta + dx, which differs from the Verlet fallback here; 10 steps from
    (1, 0) agree with JAX to 1e-6, and 100 with cos(1) to 1e-3 (the JAX
    test)."""
    eta0 = np.array([1.0, 0.5], np.float32)
    fallback = tint._verlet_packed(torch.tensor(eta0), _sho(torch), 0.01)
    first = tint.implicit_midpoint(torch.tensor(eta0), _sho(torch), 0.01)
    assert not torch.equal(first, fallback)
    np.testing.assert_allclose(first.numpy(), np.asarray(jint.implicit_midpoint(
        jnp.asarray(eta0), _sho(jnp), 0.01)), rtol=1e-6, atol=1e-7)
    te, je = torch.tensor([1.0, 0.0]), jnp.asarray([1.0, 0.0])
    tgrad, jgrad = _sho(torch), _sho(jnp)
    for i in range(100):
        te = tint.implicit_midpoint(te, tgrad, 0.01)
        if i < 10:
            je = jint.implicit_midpoint(je, jgrad, 0.01)
        if i == 9:
            np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=1e-6)
    assert abs(float(te[0]) - np.cos(1.0)) < 1e-3


@pytest.mark.parametrize("case", ["invalid", "n_epochs"])
def test_implicit_midpoint_falls_back_to_verlet(case):
    """The two other exits return the Verlet step, as in JAX: an update
    beyond 1e4 (the guard), or the iteration budget spent unconverged."""
    eta0 = np.array([1.0, 0.5, 0.0, -0.2], np.float32)
    if case == "invalid":
        def tgrad(e):
            return 1e7 * e

        def jgrad(e):
            return 1e7 * e
        kw = {}
    else:
        tgrad, jgrad = _sho(torch), _sho(jnp)
        eta0 = eta0[:2]
        kw = dict(n_epochs=1)
    got = tint.implicit_midpoint(torch.tensor(eta0), tgrad, 0.01, **kw)
    assert torch.equal(got, tint._verlet_packed(torch.tensor(eta0), tgrad, 0.01))
    np.testing.assert_allclose(got.numpy(), np.asarray(jint.implicit_midpoint(
        jnp.asarray(eta0), jgrad, 0.01, **kw)), rtol=1e-6)


@pytest.mark.parametrize("values,expected", [
    ([1.0, -2.0, 3.0], False), ([1.0, float("nan")], True), ([float("inf")], True),
    ([1.0, 2e4], True), ([-1e4, 0.0], False)],
    ids=["finite", "nan", "inf", "overflow", "edge"])
def test_check_invalid_value_matches(values, expected):
    """A 0-d bool tensor, equal to JAX's flag."""
    got = tguards.check_invalid_value(torch.tensor(values))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) is expected is bool(jguards.check_invalid_value(jnp.asarray(values)))
    assert tint._is_invalid is tguards.check_invalid_value


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_temporal_average_matches(rng, k):
    """The reference's asymmetric edge clamping: rtol 1e-6 against JAX."""
    y = rng.standard_normal(40).astype(np.float32)
    got = tguards.temporal_average(torch.tensor(y), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(jguards.temporal_average(jnp.asarray(y), k)),
                               rtol=1e-6, atol=1e-6)
