"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, at first use, keyed by a hash of the
sources and flags: ``build/plasma_control_tpu_torch/libpct_<hash>.so`` at the
root of the checkout (``build/`` and ``*.so`` are git-ignored). The library is
then loaded with ctypes. Nothing here runs at import time, so the CPU-only
test machine can import every module. Compiling the sources side by side
halves the build: 5.2-5.5 s against 10.6-11.0 s for one ``nvcc`` over all
of them (NVIDIA H100 80GB HBM3 machine, 8 cores).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` passes it PyTorch's current stream as a
raw handle (no ``torch.cuda.Stream`` object), sets the device only when the
tensors lie on another device than the current one, and turns a nonzero code
into an exception (:func:`check`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["SpectralParams", "TwinParams", "GridParams", "FidelityParams", "Geometry", "MAX_MODES",
           "BLOCK_MODES", "MAX_CLUSTER", "SHARED_BYTES", "REDUCTION_BYTES", "BLOCK_COEF_BYTES",
           "KIND_ID", "build", "library", "call", "check", "check_device"]

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "plasma_control_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers, shared memory and spills in the build log
)

MAX_MODES = 64  # kMaxModes of csrc/spectral_horizon.cuh: the largest Km
BLOCK_MODES = 16  # kBlockModes: Km beyond it runs in blocks of 16 modes
MAX_CLUSTER = 16  # kMaxCluster of csrc/spectral_horizon.cuh: Hopper's largest (non-portable) cluster
SHARED_BYTES = 232448  # shared memory one CTA may use on Hopper
# static shared memory of csrc/spectral_horizon.cuh, which kernels 1 and 7
# share: the reduction scratch (sizeof(Reduction)), and the coefficients of
# every block of modes (sizeof(BlockCoefs)), which kernel 1 holds for Km > 16
REDUCTION_BYTES = 1408
BLOCK_COEF_BYTES = 4 * 2 * MAX_MODES
# the shape-function kind as csrc/cic.cu and csrc/fused_step.cu take it
KIND_ID = {"cic": 0, "tsc": 1, "tsc_standard": 2}


class Geometry(NamedTuple):
    """Launch geometry of kernels 1 and 7: a cluster of ``cluster`` CTAs, CTA
    r holding particles [r * slice, min((r + 1) * slice, N)) in
    ``shared_bytes`` of dynamic shared memory; 0 shared bytes: the slices
    live in a global scratch."""

    cluster: int
    slice: int
    shared_bytes: int


class SpectralParams(ctypes.Structure):
    """By-value parameter block of ``pct_spectral_horizon`` (same layout as
    ``SpectralParams`` in csrc/spectral_horizon.cu)."""

    _fields_ = [
        ("k", ctypes.c_int),
        ("h", ctypes.c_int),
        ("km", ctypes.c_int),
        ("n", ctypes.c_int),
        ("ka", ctypes.c_int),
        ("u_sk", ctypes.c_int),
        ("u_sh", ctypes.c_int),
        ("x_st", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("dt", ctypes.c_float),
        ("half_dt", ctypes.c_float),
        ("length", ctypes.c_float),
        ("inv_l", ctypes.c_float),
        ("c_ang", ctypes.c_float),
        ("c_ang_dt", ctypes.c_float),
        ("pe_scale", ctypes.c_float),
        ("g", ctypes.c_float * MAX_MODES),
        ("inv_k2", ctypes.c_float * MAX_MODES),
    ]


class TwinParams(ctypes.Structure):
    """By-value parameter block of ``pct_twin_trajectory`` (same layout as
    ``TwinParams`` in csrc/twin_trajectory.cu)."""

    _fields_ = [
        ("s", SpectralParams),
        ("n_full", ctypes.c_int),
        ("xf_st", ctypes.c_int),
        ("n_full_f", ctypes.c_float),
        ("r2", ctypes.c_float),
        ("noise", ctypes.c_float),
    ]


class FidelityParams(ctypes.Structure):
    """By-value parameter block of ``pct_fidelity_ratio`` (same layout as
    ``FidelityParams`` in csrc/fidelity_ratio.cu)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("x_st", ctypes.c_int),
        ("km", ctypes.c_int),
        ("c_ang", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("n0sq", ctypes.c_float),
        ("frac", ctypes.c_float),
        ("injected", ctypes.c_float),
        ("k2", ctypes.c_float * MAX_MODES),
    ]


class GridParams(ctypes.Structure):
    """By-value parameter block of ``pct_fused_leapfrog_step`` and
    ``pct_grid_horizon`` (same layout as ``GridParams`` in csrc/fused_step.cu)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("m", ctypes.c_int),
        ("h", ctypes.c_int),
        ("kind", ctypes.c_int),
        ("dt", ctypes.c_float),
        ("half_dt", ctypes.c_float),
        ("length", ctypes.c_float),
        ("inv_dx", ctypes.c_float),
        ("norm", ctypes.c_float),
        ("n0", ctypes.c_float),
        ("half_dx", ctypes.c_float),
    ]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, out, b, n, m, length, inv_dx, scale, kind, cluster, stream
    "pct_cic_deposit": [_P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P],
    # e, x, out, b, n, m, e_stride, length, inv_dx, kind, stream
    "pct_cic_gather": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # x0, v0, uc, us, tc, ts, pe, scratch, params, rot, cluster, clusters, stream
    "pct_spectral_horizon": [_P, _P, _P, _P, _P, _P, _P, _P, SpectralParams, _I, _I, _I, _P],
    # params, rot, global, corrected, cluster, out max_clusters
    "pct_spectral_max_clusters": [SpectralParams, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    # xf, x0, v0, tc, ts, scratch, params, stream
    "pct_twin_trajectory": [_P, _P, _P, _P, _P, _P, TwinParams, _P],
    # params, global, out max_clusters
    "pct_twin_max_clusters": [TwinParams, _I, ctypes.POINTER(ctypes.c_int)],
    # x, partials, out, params, ctas, stream
    "pct_fidelity_ratio": [_P, _P, _P, FidelityParams, _I, _P],
    # x, v, e_ext, eop_t, xo, vo, eo, mesh, b, grid, params, exact, eop_smem, state_smem,
    # stream
    "pct_fused_leapfrog_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, GridParams, _I, _I, _I,
                                _P],
    # params, out CTAs of the rows kernel per SM
    "pct_leapfrog_rows_ctas": [GridParams, ctypes.POINTER(ctypes.c_int)],
    # x0, v0, u, eop_t, pe, scratch, mesh, k, params, merged, eop_smem, stream
    "pct_grid_horizon": [_P, _P, _P, _P, _P, _P, _P, _I, GridParams, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(p for p in SOURCE_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpct_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every process; raise with its output if one failed."""
    log, failed = [], []
    for what, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {what} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build() -> tuple[Path, float, str]:
    """Compile the sources unless the library for their hash exists.

    One ``nvcc -c`` per source, all running at once, then one link. Returns
    (library path, seconds spent compiling, nvcc's output). The library goes
    to a temporary name first and is renamed into place, so a concurrent or
    interrupted build never leaves a partial library.
    """
    path = _library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = str(Path(work) / f"{src.stem}.o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        output = _run(procs)
        tmp = str(Path(work) / path.name)
        output += _run([("link", subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))])
        os.replace(tmp, path)
    return path, time.perf_counter() - t0, output


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes and restype set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pct_error_string.argtypes = [ctypes.c_int]
    lib.pct_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (e.g. a refused launch)."""
    if err != 0:
        msg = library().pct_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise on any other."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return False


def call(name: str, index: int, *args) -> None:
    """Run the C entry point ``name`` with ``args`` and the raw handle of
    PyTorch's current stream on CUDA device ``index``; a device guard only
    when that device is not the current one. Raises on a CUDA error."""
    fn = getattr(library(), name)
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, name)
