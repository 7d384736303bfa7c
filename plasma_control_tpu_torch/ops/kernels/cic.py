"""CIC/TSC deposit and gather: the CUDA kernels of ``csrc/cic.cu`` and their
plain PyTorch versions.

Replaces the Pallas TPU kernels ``_deposit_impl`` / ``_gather_impl``
(``plasma_control_tpu/ops/pallas/cic_pallas.py``, public
``deposit_cic_pallas`` / ``gather_cic_pallas``). Each particle touches only
the four cells b-1 .. b+2 around b = floor(x/dx), which cover the support of
all three shape functions; see the note at the top of ``csrc/cic.cu`` for what
bounds the kernels on the H100 and how they are laid out.

A wrapper runs the plain version for a CPU tensor and the kernel for a CUDA
tensor (float32, any leading batch shape); any other device raises. Each
kernel launch adds one to the wrapper's ``launches`` count; while
:mod:`...utils.debug`'s NaN checks are on, the wrapper then checks the
launch's inputs and output. Both take any positions and wrap them as
``torch.remainder(x, L)`` does, in the kernel and in the plain version alike;
the deposit also applies a float32 ``scale`` (the caller's normalisation), so
that a deposit on the card is one device op and sums bitwise the same in
every launch (fixed-point counts, ``csrc/cic.cu``).
"""

from __future__ import annotations

import functools

import torch

from ...utils.debug import check_kernel
from ..deposit import shape_weights_from_offset
from . import _build
from ._build import KIND_ID, check_device

__all__ = ["deposit_cic", "gather_cic", "deposit_cic_plain", "gather_cic_plain"]

_MAX_BATCH = 65535  # gridDim.y
_MAX_MESH = 12288  # the gather stages a field row in 48 KB of shared memory, the deposit
                   # keeps 96 KB of fixed-point counts
_MAX_CLUSTER = 16  # kMaxCluster of csrc/cic.cu
_DEPOSIT_THREADS = 1024  # kDepositThreads of csrc/cic.cu
_CTA_PARTICLES = 8 * _DEPOSIT_THREADS  # a CTA's share of a row: 8 particles per thread
_F32 = torch.float32


def _taps(x: torch.Tensor, n_mesh: int, length: float, kind: str):
    """(..., N, 4) wrapped cell indices and weights of the cells b-1 .. b+2."""
    pos = x * (1.0 / (length / n_mesh))
    cell = torch.floor(pos)[..., None] + torch.arange(-1, 3, dtype=x.dtype, device=x.device)
    w = shape_weights_from_offset(pos[..., None] - cell, kind)
    return torch.remainder(cell.long(), n_mesh), w


def deposit_cic_plain(x: torch.Tensor, n_mesh: int, length: float, kind: str = "cic",
                      scale: float = 1.0) -> torch.Tensor:
    """Plain version of the deposit kernel: (..., N) positions, wrapped to
    [0, L) first, to the (..., M) density ``scale * (sum of shape weights per
    cell)``."""
    idx, w = _taps(torch.remainder(x, length), n_mesh, length, kind)
    out = torch.zeros(x.shape[:-1] + (n_mesh,), dtype=x.dtype, device=x.device)
    out.scatter_add_(-1, idx.flatten(-2), w.flatten(-2))
    return out if scale == 1.0 else out * scale


def gather_cic_plain(e_mesh: torch.Tensor, x: torch.Tensor, n_mesh: int, length: float,
                     kind: str = "cic") -> torch.Tensor:
    """Plain version of the gather kernel: the (..., M) mesh field
    interpolated to (..., N) positions, wrapped to [0, L) first, with the
    same weights."""
    idx, w = _taps(torch.remainder(x, length), n_mesh, length, kind)
    e = e_mesh.expand(x.shape[:-1] + (n_mesh,))
    taps = torch.take_along_dim(e, idx.flatten(-2), dim=-1).view(idx.shape)
    return (w * taps).sum(-1)


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def deposit_cluster(n_particles: int, n_rows: int, index: int = 0) -> int:
    """CTAs per row of the deposit: the smallest power of two whose CTAs each
    take at most 8 particles per thread, at most 16, and no more than it takes
    for the rows' clusters to cover the card's multiprocessors once. A
    cluster's CTAs add their histograms through distributed shared memory;
    the result is bitwise the same at every size."""
    cover = max(1, _multiprocessors(index) // max(n_rows, 1))
    c = 1
    while c < _MAX_CLUSTER and 2 * c <= cover and -(-n_particles // c) > _CTA_PARTICLES:
        c *= 2
    return c


def deposit_cic(x: torch.Tensor, n_mesh: int, length: float, kind: str = "cic",
                scale: float = 1.0) -> torch.Tensor:
    """``scale`` times the density of (..., N) positions, wrapped to [0, L)
    as ``torch.remainder`` wraps them: (..., M).

    On the card this is one launch and one allocation (``torch.empty``: the
    kernel writes every cell). Inputs in another layout are made contiguous
    first."""
    if x.get_device() < 0:
        check_device(x, "deposit_cic")
        return deposit_cic_plain(x, n_mesh, length, kind, scale)
    return _deposit_cuda(x, n_mesh, length, kind, scale, None)


def _deposit_cuda(x, n_mesh, length, kind, scale, cluster):
    """The launch. ``cluster`` overrides :func:`deposit_cluster` (tests force
    a cluster size with it)."""
    index = x.get_device()
    if not (x.dtype is _F32 and x.is_contiguous() and 1 <= n_mesh <= _MAX_MESH):
        if x.dtype != torch.float32:
            raise TypeError(f"deposit_cic: the CUDA kernel takes float32, got {x.dtype}")
        if not 1 <= n_mesh <= _MAX_MESH:
            raise ValueError(f"deposit_cic: mesh of {n_mesh} cells (the kernel takes at most "
                             f"{_MAX_MESH})")
        return _deposit_cuda(x.contiguous(), n_mesh, length, kind, scale, cluster)
    out = torch.empty(x.shape[:-1] + (n_mesh,), dtype=_F32, device=x.device)
    n = x.shape[-1]
    b = out.numel() // n_mesh
    if b:
        if b > _MAX_BATCH:
            raise ValueError(f"deposit_cic: batch {b} beyond the kernel's limit {_MAX_BATCH}")
        c = deposit_cluster(n, b, index) if cluster is None else cluster
        _build.call("pct_cic_deposit", index, x.data_ptr(), out.data_ptr(), b, n, n_mesh,
                    length, 1.0 / (length / n_mesh), scale, KIND_ID[kind], c)
        deposit_cic.launches += 1
        check_kernel("deposit_cic", (x,), (out,))
    return out


deposit_cic.launches = 0


def _gather_layout(e_mesh: torch.Tensor, x: torch.Tensor, n_mesh: int):
    """Check the gather's CUDA inputs and bring them to the kernel's layout:
    contiguous float32 positions and a contiguous field of one (M,) row or
    one row per row of ``x``, on one device."""
    if x.dtype != torch.float32 or e_mesh.dtype != torch.float32 or e_mesh.device != x.device:
        raise TypeError("gather_cic: the CUDA kernel takes float32 tensors on one device")
    if e_mesh.shape[-1] != n_mesh or n_mesh > _MAX_MESH:
        raise ValueError(f"gather_cic: field of {e_mesh.shape[-1]} cells for a {n_mesh}-cell "
                         f"mesh (the kernel takes at most {_MAX_MESH})")
    if e_mesh.numel() == n_mesh:
        e_mesh = e_mesh.reshape(n_mesh)
    else:
        e_mesh = e_mesh.expand(x.shape[:-1] + (n_mesh,))
    return e_mesh.contiguous(), x.contiguous()


def gather_cic(e_mesh: torch.Tensor, x: torch.Tensor, n_mesh: int, length: float,
               kind: str = "cic") -> torch.Tensor:
    """(..., M) mesh field at (..., N) positions, wrapped to [0, L) as
    ``torch.remainder`` wraps them: (..., N). A single (M,) field is shared
    by every batch row of ``x``.

    On the card this is one launch and one allocation: the kernel wraps the
    positions, reads a shared (M,) field at row stride 0 and a batched one in
    place, and :func:`_build.call` sets no device guard when ``x`` lies on
    the current device. Inputs in another layout are made contiguous first."""
    index = x.get_device()
    if index < 0:
        check_device(x, "gather_cic")
        return gather_cic_plain(e_mesh, x, n_mesh, length, kind)
    one_row = e_mesh.dim() == 1
    if not (x.dtype is _F32 and e_mesh.dtype is _F32 and e_mesh.get_device() == index
            and x.is_contiguous() and e_mesh.is_contiguous() and e_mesh.shape[-1] == n_mesh
            and n_mesh <= _MAX_MESH and (one_row or e_mesh.shape[:-1] == x.shape[:-1])):
        return gather_cic(*_gather_layout(e_mesh, x, n_mesh), n_mesh, length, kind)
    out = torch.empty_like(x)
    n = x.shape[-1]
    if n:
        b = x.numel() // n
        if b > _MAX_BATCH:
            raise ValueError(f"gather_cic: batch {b} beyond the kernel's limit {_MAX_BATCH}")
        _build.call("pct_cic_gather", index, e_mesh.data_ptr(), x.data_ptr(), out.data_ptr(), b, n,
                    n_mesh, 0 if one_row else n_mesh, length, 1.0 / (length / n_mesh),
                    KIND_ID[kind])
        gather_cic.launches += 1
        check_kernel("gather_cic", (e_mesh, x), (out,))
    return out


gather_cic.launches = 0
