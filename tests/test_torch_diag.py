"""PyTorch port of diag/ against the JAX package on CPU: the E(k, t)
spectrum (chunked over snapshot columns in the port) and every function of
``diag/landau.py``, including the decay-phase fit's float32 slope, from the
same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.diag import landau as jlandau
from plasma_control_tpu.diag import spectrum as jspec
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.diag import landau as tlandau
from plasma_control_tpu_torch.diag import spectrum as tspec
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L = 50.0


def _snapshot(rng, n=1000, nt=7, growth=0.0):
    """(2N, Nt) columns: positions with a mode-2 modulation of growing
    amplitude (so E^2 has a trend), then velocities."""
    u = rng.uniform(0, L, n)
    amp = 0.2 * np.exp(growth * np.arange(nt))
    x = u[:, None] - amp[None, :] * np.sin(4 * np.pi * u[:, None] / L) * L / (4 * np.pi)
    v = rng.standard_normal((n, nt))
    return np.concatenate([np.mod(x, L), v]).astype(np.float32)


@pytest.mark.parametrize("m", [32, 33])
def test_spectrum_wavenumbers_match(m):
    """The same numpy code: exact, even and odd meshes."""
    np.testing.assert_array_equal(tspec.spectrum_wavenumbers(m, L / m),
                                  jspec.spectrum_wavenumbers(m, L / m))


@pytest.mark.parametrize("return_abs", [True, False], ids=["abs", "complex"])
@pytest.mark.parametrize("m", [32, 33])
def test_e_k_spectrum_matches(rng, m, return_abs):
    """(n_keep, Nt) with the Nyquist handling of an even or odd mesh:
    atol 1e-6 on |E_k| and the complex coefficients against JAX's one-shot
    vmap."""
    snap = _snapshot(rng)
    got = tspec.compute_e_k_spectrum(1.0, make_grid(m, L, device="cpu"), torch.tensor(snap), m,
                                     return_abs=return_abs)
    ref = np.asarray(jspec.compute_e_k_spectrum(1.0, jmake_grid(m, L), jnp.asarray(snap), m,
                                                return_abs=return_abs))
    assert got.shape == ref.shape == (len(tspec.spectrum_wavenumbers(m, L / m)), 7)
    assert got.is_complex() is (not return_abs)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_spectrum_chunks_agree(rng, monkeypatch):
    """Chunking changes no column: one column per chunk equals one chunk
    for all (rtol 1e-6), and the dominant row is the seeded mode 2."""
    snap = torch.tensor(_snapshot(rng))
    grid = make_grid(32, L, device="cpu")
    whole = tspec.compute_e_k_spectrum(1.0, grid, snap, 32)
    monkeypatch.setattr(tspec, "_CHUNK_ELEMENTS", 1)
    split = tspec.compute_e_k_spectrum(1.0, grid, snap, 32)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)
    assert int(torch.argmax(whole[1:, -1])) + 1 == 2


def test_bounce_time_and_analytic_rates_match():
    """Host float64 code on both sides: exact."""
    for a in (0.01, 0.25, 1.0):
        assert tlandau.compute_bounce_time(a) == jlandau.compute_bounce_time(a)
    for k, vth in ((0.5, 1.0), (0.8, 1.0), (0.3, 0.5)):
        assert (tlandau.compute_linear_damping_rate_analytic(k, vth, 1.0)
                == jlandau.compute_linear_damping_rate_analytic(k, vth, 1.0))
        assert (tlandau.landau_damping_rate_analytic_sim(k, vth)
                == jlandau.landau_damping_rate_analytic_sim(k, vth))


@pytest.mark.parametrize("bins", [(50, 50), (32, 40)])
def test_numerical_entropy_matches(rng, bins):
    """The phase-space histogram entropy (square histogram of max bins):
    rtol 1e-5 against JAX."""
    n = 2000
    col = np.concatenate([rng.uniform(0, L, n), 2.0 * rng.standard_normal(n)]).astype(np.float32)
    args = (bins[0], bins[1], L, L / bins[0], -10.0, 10.0, 20.0 / bins[1], 1.0)
    got = tlandau.compute_numerical_entropy(torch.tensor(col), *args)
    ref = jlandau.compute_numerical_entropy(jnp.asarray(col), *args)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_linear_damping_rates_match(rng):
    """The snapshot regression (re-solved fields, chunked) and the recorded
    PE regression: rtol 1e-4 against JAX (float32 sums of logs)."""
    snap = _snapshot(rng, nt=12, growth=0.15)
    got = tlandau.compute_linear_damping_rate(5.0, 1.0, make_grid(32, L, device="cpu"),
                                              torch.tensor(snap), 32)
    ref = jlandau.compute_linear_damping_rate(5.0, 1.0, jmake_grid(32, L), jnp.asarray(snap), 32)
    assert float(got) > 0.1
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    ts = np.linspace(0.0, 10.0, 50, dtype=np.float32)
    pe = (3.0 * np.exp(0.4 * ts) * (1 + 0.05 * rng.standard_normal(50))).astype(np.float32)
    got = tlandau.damping_rate_from_field_energy(torch.tensor(ts), torch.tensor(pe))
    ref = jlandau.damping_rate_from_field_energy(jnp.asarray(ts), jnp.asarray(pe))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("trace", ["crushed", "peak", "noisy", "short", "nan"])
def test_decay_phase_fit_matches(rng, trace):
    """The decay-phase window (host float64) and its float32 slope: equal to
    JAX's to 2e-6 relative on every window case (saturated floor, peak
    first, noisy, a degenerate window, a non-finite trace)."""
    ts = np.linspace(0.0, 50.0, 500)
    if trace == "crushed":
        pe = np.maximum(100.0 * np.exp(-ts), 1.0)
    elif trace == "peak":
        pe = np.where(ts < 5.0, np.exp(ts), np.exp(5.0) * np.exp(-2.0 * (ts - 5.0)))
    elif trace == "noisy":
        pe = 50.0 * np.exp(-0.3 * ts) * (1.0 + 0.2 * rng.uniform(size=500)) + 0.5
    elif trace == "short":
        ts, pe = ts[:4], np.array([1.0, 2.0, 3.0, 4.0])
    else:
        pe = np.exp(-ts)
        pe[7] = np.nan
    got = tlandau.damping_rate_decay_phase(ts, pe)
    ref = jlandau.damping_rate_decay_phase(ts, pe)
    if trace == "nan":
        assert np.isnan(got) and np.isnan(ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-6)


def test_decay_phase_fit_is_float32():
    """The slope is a float32 fit, as in the JAX package (x64 off): on a
    trace where float64 and float32 disagree past the 6th digit the port
    sides with JAX."""
    ts = np.linspace(0.0, 30.0, 300) + 1e3
    pe = np.exp(-0.37 * (ts - 1e3)) * (1.0 + 1e-3 * np.sin(ts))
    got = tlandau.damping_rate_decay_phase(ts, pe)
    ref = jlandau.damping_rate_decay_phase(ts, pe)
    tm = ts - ts.mean()
    f64 = 0.5 * np.sum(tm * (np.log(pe) - np.log(pe).mean())) / np.sum(tm * tm)
    assert abs(ref - f64) > 1e-6 * abs(f64)
    np.testing.assert_allclose(got, ref, rtol=2e-6)


@pytest.mark.parametrize("after_peak,sustained", [(True, True), (True, False), (False, True),
                                                  (False, False)])
def test_time_to_pe_threshold_matches(after_peak, sustained):
    """Host numpy on both sides: exact, including NaN when never reached."""
    ts = np.linspace(0.0, 30.0, 301)
    pe = 50.0 * np.exp(-ts) + 30.0 / (1.0 + np.exp(-(ts - 15.0)))
    for thr in (10.0, 40.0, 1e-9):
        got = tlandau.time_to_pe_threshold(ts, pe, thr, after_peak, sustained)
        ref = jlandau.time_to_pe_threshold(ts, pe, thr, after_peak, sustained)
        assert (np.isnan(got) and np.isnan(ref)) or got == ref
