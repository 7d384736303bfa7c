"""The port's loader of the native C++ reference library
(plasma_control_tpu_torch/utils/native.py) against the JAX package's
(plasma_control_tpu/utils/native.py) and against the port's float64 PIC step:

* both build ``native/pic_ref.cpp`` with the same flags, so every entry point
  returns bitwise the same arrays;
* the native step, rollout and solve agree with the port's float64 CPU
  Yoshida-4 step and circulant solve at tests/test_native.py's tolerances;
* the port's loader, run in a fresh process on a copy of the tree, builds
  into ``build/plasma_control_tpu_torch/`` and writes nothing under
  ``native/``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plasma_control_tpu.utils.native as jnative
from plasma_control_tpu_torch.config import SimConfig
from plasma_control_tpu_torch.models.pic import PlasmaState, diagnostics, step
from plasma_control_tpu_torch.models.rollout import rollout
from plasma_control_tpu_torch.ops.fields import solve_e_mesh
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.utils import native

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
L, M, N, DT = 50.0, 64, 2000, 0.1


def _copy_native(dst: Path) -> Path:
    (dst / "native").mkdir(parents=True)
    for name in ("pic_ref.cpp", "Makefile"):
        shutil.copy2(ROOT / "native" / name, dst / "native" / name)
    return dst / "native"


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's loader, building with its own ``make -C native`` on
    a copy of native/ (other test processes may be building the checkout's
    native/libpic_ref.so at the same time)."""
    src = _copy_native(tmp_path)
    monkeypatch.setattr(jnative, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(jnative, "_LIB_PATH", str(src / "libpic_ref.so"))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.load_library() is not None, "make -C native failed on a copy of native/"
    return jnative


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    assert lib is not None, "g++ failed on native/pic_ref.cpp"
    return lib


def _phase_space(rng, n=N):
    return rng.uniform(0, L, n), rng.standard_normal(n)


def test_bitwise_equal_to_the_jax_loader(lib, jax_native, rng):
    x, v = _phase_space(rng)
    e_ext = 0.05 * np.sin(2 * np.pi * np.arange(M) / M)
    for e in (None, e_ext):
        xp, vp, pep = native.native_step(x.copy(), v.copy(), M, L, DT, e_external=e)
        xj, vj, pej = jax_native.native_step(x.copy(), v.copy(), M, L, DT, e_external=e)
        assert np.array_equal(xp, xj) and np.array_equal(vp, vj) and pep == pej
    xp, vp, pep = native.native_rollout(x.copy(), v.copy(), M, L, DT, 20)
    xj, vj, pej = jax_native.native_rollout(x.copy(), v.copy(), M, L, DT, 20)
    assert np.array_equal(xp, xj) and np.array_equal(vp, vj) and np.array_equal(pep, pej)
    rho = 0.1 * rng.standard_normal(M)
    rho -= rho.mean()
    assert np.array_equal(native.native_solve_e(rho, L), jax_native.native_solve_e(rho, L))


def _port64(x, v):
    cfg = SimConfig(n_particles=len(x), n_mesh=M, length=L, dt=DT, t_max=2.0)
    grid = make_grid(M, L, dtype=torch.float64, device="cpu")
    return cfg, grid, PlasmaState(torch.tensor(x), torch.tensor(v))


def test_step_matches_port_float64(lib, rng):
    x, v = _phase_space(rng)
    e_ext = 0.05 * np.sin(2 * np.pi * np.arange(M) / M)
    cfg, grid, state = _port64(x, v)
    for e in (None, e_ext):
        xn, vn, pe = native.native_step(x.copy(), v.copy(), M, L, DT, e_external=e)
        st = step(state, grid, cfg, None if e is None else torch.tensor(e))
        np.testing.assert_allclose(xn, st.x.numpy(), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(vn, st.v.numpy(), rtol=1e-8, atol=1e-8)
        pe_port = float(diagnostics(st, grid, cfg)[2])
        assert abs(pe - pe_port) / pe_port < 1e-6


def test_rollout_matches_port_float64(lib, rng):
    x, v = _phase_space(rng)
    cfg, grid, state = _port64(x, v)
    xn, vn, pe = native.native_rollout(x.copy(), v.copy(), M, L, DT, cfg.n_steps)
    out = rollout(state, grid, cfg)
    assert pe.shape == (cfg.n_steps,) and np.isfinite(pe).all() and (pe > 0).all()
    np.testing.assert_allclose(pe, out.field_energy[1:].numpy(), rtol=1e-6)
    np.testing.assert_allclose(xn, out.final_state.x.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(vn, out.final_state.v.numpy(), rtol=1e-8, atol=1e-8)


def test_solve_matches_port_float64(lib, rng):
    rho = 0.1 * rng.standard_normal(M)
    rho -= rho.mean()
    grid = make_grid(M, L, dtype=torch.float64, device="cpu")
    e_port = solve_e_mesh(torch.tensor(rho + 1.0), grid, 1.0).numpy()
    np.testing.assert_allclose(native.native_solve_e(rho, L), e_port, rtol=1e-8, atol=1e-10)


def test_bad_shapes_refused(lib):
    with pytest.raises(ValueError, match="one \\(N,\\) pair"):
        native.native_step(np.zeros(4), np.zeros(5), M, L, DT)
    with pytest.raises(ValueError, match="e_external"):
        native.native_step(np.zeros(4), np.zeros(4), M, L, DT, e_external=np.zeros(M + 1))
    with pytest.raises(ValueError, match="rho"):
        native.native_solve_e(np.zeros((2, M)), L)


def test_fresh_loader_writes_nothing_under_native(tmp_path):
    """A fresh process on a copy of the tree (the port and native/): the
    port's loader builds the library into build/plasma_control_tpu_torch/,
    and native/'s names and mtimes are as before."""
    src = _copy_native(tmp_path)
    shutil.copytree(ROOT / "plasma_control_tpu_torch", tmp_path / "plasma_control_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "data", "*.so"))
    before = {p.name: p.stat().st_mtime_ns for p in src.iterdir()}
    code = ("from plasma_control_tpu_torch.utils import native\n"
            "assert native.load_library() is not None\n"
            "print(native._library_path())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.strip())
    assert built.parent == tmp_path / "build" / "plasma_control_tpu_torch" and built.is_file()
    assert {p.name: p.stat().st_mtime_ns for p in src.iterdir()} == before
