"""ctypes binding to the native C++ reference-kernel library.

The counterpart of :mod:`plasma_control_tpu.utils.native`, with its names and
contracts. ``native/pic_ref.cpp`` implements the reference's exact discrete
semantics (Thomas + Sherman-Morrison periodic Poisson solve, CIC, Yoshida-4)
in -O3 C++: an independent float64 oracle for the port, and the compiled
single-core CPU baseline that a benchmark compares against.

The library is built on demand from the checkout's ``native/pic_ref.cpp``
with ``g++`` and the flags of ``native/Makefile`` into
``build/plasma_control_tpu_torch/libpic_ref_<hash>.so``, written to a
temporary name and renamed into place, so concurrent builds never leave a
partial library. The hash covers the source, the compiler, the flags and the
host's name: ``-march=native`` builds for the host's CPU, so a build
directory copied to another machine is rebuilt there, not loaded. It never
runs ``make`` and writes nothing under ``native/``: the JAX package's loader
owns ``native/libpic_ref.so``. As in the JAX package, every entry point
returns None where no toolchain is available: this is a host library, not
a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load_library", "native_step", "native_rollout", "native_solve_e"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "pic_ref.cpp"
BUILD_DIR = _ROOT / "build" / "plasma_control_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, platform.node(), platform.machine())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpic_ref_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = os.path.join(work, path.name)
            subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """The library with every entry point's argtypes and restype set, built
    first if needed; None if it cannot be built or loaded (tried once per
    process)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _library_path()
    except OSError:  # no native/ in this checkout
        return None
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.pic_ref_step.restype = ctypes.c_double
    lib.pic_ref_step.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.pic_ref_rollout.restype = None
    lib.pic_ref_rollout.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int, dp,
    ]
    lib.pic_ref_solve_e.restype = None
    lib.pic_ref_solve_e.argtypes = [dp, ctypes.c_int, ctypes.c_double, ctypes.c_double, dp]
    _LIB = lib
    return _LIB


def _phase_space(x, v):
    x = np.ascontiguousarray(x, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    if x.ndim != 1 or x.shape != v.shape:
        raise ValueError(f"x and v must be one (N,) pair, got {x.shape} and {v.shape}")
    return x, v


def native_step(x, v, n_mesh, length, dt, n0=1.0, gamma=5.0, e_external=None):
    """In-place Yoshida-4 step; returns (x, v, PE) or None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    x, v = _phase_space(x, v)
    e_ext = None
    if e_external is not None:
        e_ext = np.ascontiguousarray(e_external, dtype=np.float64)
        if e_ext.shape != (n_mesh,):
            raise ValueError(f"e_external must have shape ({n_mesh},), got {e_ext.shape}")
    ptr = None if e_ext is None else e_ext.ctypes.data_as(ctypes.c_void_p)
    pe = lib.pic_ref_step(x, v, x.shape[0], n_mesh, length, dt, n0, gamma, ptr)
    return x, v, pe


def native_rollout(x, v, n_mesh, length, dt, n_steps, n0=1.0, gamma=5.0):
    """Open-loop rollout; returns (x, v, pe_series) or None."""
    lib = load_library()
    if lib is None:
        return None
    x, v = _phase_space(x, v)
    pe = np.zeros(n_steps, dtype=np.float64)
    lib.pic_ref_rollout(x, v, x.shape[0], n_mesh, length, dt, n0, gamma, n_steps, pe)
    return x, v, pe


def native_solve_e(rho, length, gamma=5.0):
    """E mesh from rho = n - n0 via the reference's elimination path, or None."""
    lib = load_library()
    if lib is None:
        return None
    rho = np.ascontiguousarray(rho, dtype=np.float64)
    if rho.ndim != 1:
        raise ValueError(f"rho must be one (M,) mesh, got shape {rho.shape}")
    out = np.zeros_like(rho)
    lib.pic_ref_solve_e(rho, rho.shape[0], length, gamma, out)
    return out
