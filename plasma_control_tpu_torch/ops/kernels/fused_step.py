"""The grid planner's fused kernels: the CUDA kernels of ``csrc/fused_step.cu``
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``experiments/pallas_fused_step.py``:

* :func:`fused_leapfrog_step` (``_fused_impl``): one drift-kick-drift grid-PIC
  planning step for B rows, with the exact post-step field or the
  kick-stage field;
* :func:`fused_kdk_horizon`: K candidates x H explicit KDK steps from one
  shared state, per-step ``0.5 * sum(E_self^2) * dx``;
* :func:`fused_packed_horizon`: the same contract with merged half-kicks
  (the staggered KDK of ``control/mpc.py::_horizon_cost_kdk``).

The horizon kernels return the field energy before ``electric_energy``'s N/L
rescale, as the TPU kernels do. Unlike the TPU kernels (CIC only) every
kernel takes the three interpolation kinds of the grid planner. The design
note at the top of the CUDA source says what bounds the kernels on the H100
and where the particle state lives.

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors (float32); any other device raises. Each kernel launch adds one to
the wrapper's ``launches`` count. The kernels sum their deposits in integers,
so two launches on the same inputs return bitwise the same results. Any mesh
size runs: beyond 3631 cells, where the mesh arrays exceed a CTA's shared
memory, they live in a global scratch that the wrapper allocates
(:func:`_layout`). Kernel 4 runs rows over a persistent grid with the
half-step state in registers where a row allows it (``Layout.rows``,
:func:`_row_grid`), else one CTA per row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .cic import _KIND_ID, _check_device, deposit_cic_plain, gather_cic_plain

__all__ = [
    "fused_leapfrog_step",
    "fused_kdk_horizon",
    "fused_packed_horizon",
    "fused_leapfrog_step_plain",
    "fused_kdk_horizon_plain",
    "fused_packed_horizon_plain",
]

def _density(x, n_mesh, length, kind, n0):
    """Normalised density n0 L / N / dx * sum of shape weights: (..., M)."""
    n = x.shape[-1]
    return deposit_cic_plain(x, n_mesh, length, kind) * (n0 * length / n / (length / n_mesh))


def _solve(x, e_op_t, n_mesh, length, kind, n0):
    """E_self at positions x: (n - n0) @ e_op_t."""
    return (_density(x, n_mesh, length, kind, n0) - n0) @ e_op_t


def _half_field_energy(e, length, n_mesh):
    return 0.5 * (length / n_mesh) * torch.sum(e * e, dim=-1)


def fused_leapfrog_step_plain(x, v, e_ext, e_op_t, *, n_mesh, length, dt, n0=1.0, exact=True,
                              kind="cic"):
    """Plain version: x, v (..., N); e_ext (..., M) or (M,) -> (x', v', E_post)."""
    xh = torch.remainder(x + (0.5 * dt) * v, length)
    e_self = _solve(xh, e_op_t, n_mesh, length, kind, n0)
    vn = v + dt * (-gather_cic_plain(e_self + e_ext, xh, n_mesh, length, kind))
    xn = torch.remainder(xh + (0.5 * dt) * vn, length)
    eo = _solve(xn, e_op_t, n_mesh, length, kind, n0) if exact else e_self
    return xn, vn, eo


def fused_kdk_horizon_plain(x, v, u_mesh_seq, e_op_t, *, n_mesh, length, dt, n0=1.0, kind="cic"):
    """Plain version of the explicit KDK horizon: x, v (N,); u_mesh_seq
    (K, H, M) -> (K, H) per-step 0.5 sum(E_self^2) dx."""
    k, h, _ = u_mesh_seq.shape
    x, v = x.expand(k, -1), v.expand(k, -1)
    e = _solve(x, e_op_t, n_mesh, length, kind, n0)
    pes = []
    for t in range(h):
        u = u_mesh_seq[:, t]
        vh = v + (0.5 * dt) * (-gather_cic_plain(e + u, x, n_mesh, length, kind))
        x = torch.remainder(x + dt * vh, length)
        e = _solve(x, e_op_t, n_mesh, length, kind, n0)
        v = vh + (0.5 * dt) * (-gather_cic_plain(e + u, x, n_mesh, length, kind))
        pes.append(_half_field_energy(e, length, n_mesh))
    return torch.stack(pes, dim=-1)


def fused_packed_horizon_plain(x, v, u_mesh_seq, e_op_t, *, n_mesh, length, dt, n0=1.0,
                               kind="cic"):
    """Plain version of the merged-half-kick horizon: same contract as
    :func:`fused_kdk_horizon_plain`."""
    k, h, _ = u_mesh_seq.shape
    x = x.expand(k, -1)
    e = _solve(x, e_op_t, n_mesh, length, kind, n0)
    vh = v + (0.5 * dt) * (-gather_cic_plain(e + u_mesh_seq[:, 0], x, n_mesh, length, kind))
    pes = []
    for t in range(h):
        x = torch.remainder(x + dt * vh, length)
        e = _solve(x, e_op_t, n_mesh, length, kind, n0)
        pes.append(_half_field_energy(e, length, n_mesh))
        if t + 1 < h:
            f = 2.0 * e + u_mesh_seq[:, t] + u_mesh_seq[:, t + 1]
            vh = vh + (0.5 * dt) * (-gather_cic_plain(f, x, n_mesh, length, kind))
    return torch.stack(pes, dim=-1)


def _params(n, m, h, kind, length, dt, n0):
    dx = length / m
    return _build.GridParams(
        n=n, m=m, h=h, kind=_KIND_ID[kind], dt=dt, half_dt=0.5 * dt, length=length,
        inv_dx=1.0 / dx, norm=n0 * length / n / dx, n0=n0, half_dx=0.5 * dx,
    )


_WARPS = 8  # kWarps of csrc/fused_step.cu


def _eop_stride(m: int) -> int:
    """Row stride of e_op_t in shared memory (eop_stride in the source)."""
    return m + (8 - m % 32) % 32


def _mesh_words(m: int) -> int:
    """Floats of a CTA's mesh arrays (mesh_words in the source): two
    fixed-point histograms of 2 words a cell, four fields, a row of densities
    per warp, the warps' energy partials."""
    return (8 + _WARPS) * m + _WARPS


_THREADS = 256  # kThreads of csrc/fused_step.cu
_ROW_Q = 8  # kRowQ: particles per thread the rows kernel holds in registers


class Layout(NamedTuple):
    """Where a launch keeps what (shared_words and carve in the source)."""

    mesh: bool  # the mesh arrays in shared memory, else in a global scratch
    state: bool  # the particle state (8 B per particle) in shared memory
    eop: bool  # the (M, M) operator in shared memory
    # kernel 4 only: rows over a persistent grid, the half-step state in
    # registers (rows_fit in the source)
    rows: bool = False


def _layout(n: int, m: int) -> Layout:
    """The mesh arrays in shared memory where they fit (M <= 3631), then the
    particle state, then the operator, each where it still fits; beyond
    3631 cells all three in global memory. Kernel 4 takes the rows kernel
    where a row is at most 8 particles per thread, M at most 256 cells, and
    the operator fits beside the mesh arrays."""
    fields = 4 * _mesh_words(m)
    if fields > _build.SHARED_BYTES:
        return Layout(False, False, False)
    state = fields + 8 * n <= _build.SHARED_BYTES
    eop_bytes = 4 * m * _eop_stride(m)
    eop = fields + (8 * n if state else 0) + eop_bytes <= _build.SHARED_BYTES
    rows = (n <= _ROW_Q * _THREADS and m <= _THREADS
            and fields + eop_bytes <= _build.SHARED_BYTES)
    return Layout(True, state, eop, rows)


def _row_grid(b: int, slots: int) -> int:
    """CTAs of the rows kernel for B rows when ``slots`` CTAs fit the card
    at once: as few rows per CTA as one wave allows, ceil(B / slots), and
    no more CTAs than that needs. CTA c takes rows c, c + grid, ..."""
    per_cta = -(-b // max(slots, 1))
    return -(-b // per_cta)


@functools.lru_cache(maxsize=None)
def _row_slots(device: int, n: int, m: int, kind: str) -> int:
    """CTAs of the rows kernel that fit the card at once: its CTAs per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, which the shared memory
    of N and M decides; the physical constants are placeholders) times the
    SMs."""
    ctas = ctypes.c_int(0)
    _build.check(_build.library().pct_leapfrog_rows_ctas(_params(n, m, 1, kind, 1.0, 0.1, 1.0),
                                                         ctypes.byref(ctas)),
                 "fused_leapfrog_step")
    if ctas.value < 1:
        raise RuntimeError(f"fused_leapfrog_step: no CTA of the rows kernel fits (N={n}, M={m})")
    return ctas.value * torch.cuda.get_device_properties(device).multi_processor_count


def _mesh_scratch(layout: Layout, rows: int, m: int, device):
    """The global scratch of the mesh arrays, one row per CTA, or None."""
    if layout.mesh:
        return None
    return torch.empty((rows, _mesh_words(m)), dtype=torch.float32, device=device)


def _f32(what, *tensors):
    if any(t.dtype != torch.float32 or t.device != tensors[0].device for t in tensors):
        raise TypeError(f"{what}: the CUDA kernel takes float32 tensors on one device")
    return [t.contiguous() for t in tensors]


def _leapfrog_cuda(x, v, e_ext, e_op_t, *, n_mesh, length, dt, n0, exact, kind, rows_grid=None):
    """The kernel launch. ``rows_grid`` overrides :func:`_row_grid`'s CTA
    count of the rows kernel, and 0 takes the one-CTA-per-row kernel
    instead (tests and experiments force them with it)."""
    n = x.shape[-1]
    if v.shape != x.shape or e_op_t.shape != (n_mesh, n_mesh) or e_ext.shape[-1] != n_mesh:
        raise ValueError("fused_leapfrog_step: x, v (..., N), e_ext (..., M), e_op_t (M, M)")
    lead = x.shape[:-1]
    xr, vr, er, eop = _f32("fused_leapfrog_step", x.reshape(-1, n), v.reshape(-1, n),
                           e_ext.expand(lead + (n_mesh,)).reshape(-1, n_mesh), e_op_t)
    b = xr.shape[0]
    xo, vo = torch.empty_like(xr), torch.empty_like(vr)
    eo = torch.empty((b, n_mesh), dtype=torch.float32, device=x.device)
    layout = _layout(n, n_mesh)
    mesh = _mesh_scratch(layout, b, n_mesh, x.device)
    rows = layout.rows and rows_grid != 0
    grid = 0
    if rows:
        grid = rows_grid or _row_grid(b, _row_slots(x.get_device(), n, n_mesh, kind))
    _build.call("pct_fused_leapfrog_step", x.get_device(),
                xr.data_ptr(), vr.data_ptr(), er.data_ptr(), eop.data_ptr(),
                xo.data_ptr(), vo.data_ptr(), eo.data_ptr(),
                None if mesh is None else mesh.data_ptr(), b, grid,
                _params(n, n_mesh, 1, kind, length, dt, n0), int(exact),
                int(layout.eop or rows), int(layout.state and not rows))
    fused_leapfrog_step.launches += 1
    return xo.reshape(x.shape), vo.reshape(x.shape), eo.reshape(lead + (n_mesh,))


def fused_leapfrog_step(x, v, e_ext, e_op_t, *, n_mesh, length, dt, n0=1.0, exact=True,
                        kind="cic"):
    """One leapfrog planning step: (x', v', E_post).

    x, v: (..., N); e_ext: (..., M), or (M,) shared by every row; e_op_t:
    (M, M) = ``grid.e_op.T``. ``E_post`` is the self-consistent field at the
    post-step positions when ``exact``, else the kick-stage field.
    """
    kw = dict(n_mesh=n_mesh, length=length, dt=dt, n0=n0, exact=exact, kind=kind)
    if not _check_device(x, "fused_leapfrog_step"):
        return fused_leapfrog_step_plain(x, v, e_ext, e_op_t, **kw)
    return _leapfrog_cuda(x, v, e_ext, e_op_t, **kw)


fused_leapfrog_step.launches = 0


def _horizon_cuda(x, v, u_mesh_seq, e_op_t, *, n_mesh, length, dt, n0, kind, merged, what):
    (n,) = x.shape
    k, h, m = u_mesh_seq.shape
    if v.shape != x.shape or m != n_mesh or e_op_t.shape != (m, m):
        raise ValueError(f"{what}: x, v (N,), u_mesh_seq (K, H, M), e_op_t (M, M)")
    xc, vc, uc, eop = _f32(what, x, v, u_mesh_seq, e_op_t)
    layout = _layout(n, m)
    scratch = None if layout.state else torch.empty((k, 2 * n), dtype=torch.float32,
                                                    device=x.device)
    mesh = _mesh_scratch(layout, k, m, x.device)
    pe = torch.empty((k, h), dtype=torch.float32, device=x.device)
    _build.call("pct_grid_horizon", x.get_device(),
                xc.data_ptr(), vc.data_ptr(), uc.data_ptr(), eop.data_ptr(), pe.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                None if mesh is None else mesh.data_ptr(), k,
                _params(n, m, h, kind, length, dt, n0), int(merged), int(layout.eop))
    return pe


def fused_kdk_horizon(x, v, u_mesh_seq, e_op_t, *, n_mesh, length, dt, n0=1.0, kind="cic"):
    """K candidate H-step explicit KDK rollouts from the shared state x, v
    (N,) under drive fields u_mesh_seq (K, H, M): (K, H) per-step
    ``0.5 * sum(E_self^2) * dx`` (callers apply the N/L rescale)."""
    if not _check_device(x, "fused_kdk_horizon"):
        return fused_kdk_horizon_plain(x, v, u_mesh_seq, e_op_t, n_mesh=n_mesh, length=length,
                                       dt=dt, n0=n0, kind=kind)
    pe = _horizon_cuda(x, v, u_mesh_seq, e_op_t, n_mesh=n_mesh, length=length, dt=dt, n0=n0,
                       kind=kind, merged=False, what="fused_kdk_horizon")
    fused_kdk_horizon.launches += 1
    return pe


fused_kdk_horizon.launches = 0


def fused_packed_horizon(x, v, u_mesh_seq, e_op_t, *, n_mesh, length, dt, n0=1.0, kind="cic"):
    """Staggered-KDK horizon with merged half-kicks; the contract of
    :func:`fused_kdk_horizon`."""
    if not _check_device(x, "fused_packed_horizon"):
        return fused_packed_horizon_plain(x, v, u_mesh_seq, e_op_t, n_mesh=n_mesh,
                                          length=length, dt=dt, n0=n0, kind=kind)
    pe = _horizon_cuda(x, v, u_mesh_seq, e_op_t, n_mesh=n_mesh, length=length, dt=dt, n0=n0,
                       kind=kind, merged=True, what="fused_packed_horizon")
    fused_packed_horizon.launches += 1
    return pe


fused_packed_horizon.launches = 0
