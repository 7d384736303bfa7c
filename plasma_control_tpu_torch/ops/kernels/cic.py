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
kernel launch adds one to the wrapper's ``launches`` count.
"""

from __future__ import annotations

import torch

from ..deposit import shape_weights_from_offset
from . import _build

__all__ = ["deposit_cic", "gather_cic", "deposit_cic_plain", "gather_cic_plain"]

_KIND_ID = {"cic": 0, "tsc": 1, "tsc_standard": 2}
_MAX_BATCH = 65535  # gridDim.y


def _taps(x: torch.Tensor, n_mesh: int, length: float, kind: str):
    """(..., N, 4) wrapped cell indices and weights of the cells b-1 .. b+2."""
    pos = x * (1.0 / (length / n_mesh))
    cell = torch.floor(pos)[..., None] + torch.arange(-1, 3, dtype=x.dtype, device=x.device)
    w = shape_weights_from_offset(pos[..., None] - cell, kind)
    return torch.remainder(cell.long(), n_mesh), w


def deposit_cic_plain(x: torch.Tensor, n_mesh: int, length: float, kind: str = "cic") -> torch.Tensor:
    """Plain version of the deposit kernel: (..., N) positions in [0, L) to the
    (..., M) unnormalised density (sum of shape weights per cell)."""
    idx, w = _taps(x, n_mesh, length, kind)
    out = torch.zeros(x.shape[:-1] + (n_mesh,), dtype=x.dtype, device=x.device)
    return out.scatter_add_(-1, idx.flatten(-2), w.flatten(-2))


def gather_cic_plain(e_mesh: torch.Tensor, x: torch.Tensor, n_mesh: int, length: float,
                     kind: str = "cic") -> torch.Tensor:
    """Plain version of the gather kernel: the (..., M) mesh field
    interpolated to (..., N) positions in [0, L) with the same weights."""
    idx, w = _taps(x, n_mesh, length, kind)
    e = e_mesh.expand(x.shape[:-1] + (n_mesh,))
    taps = torch.take_along_dim(e, idx.flatten(-2), dim=-1).view(idx.shape)
    return (w * taps).sum(-1)


def _as_rows(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    return t.reshape(-1, t.shape[-1]).contiguous()


def _check_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise on any other."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return False


def deposit_cic(x: torch.Tensor, n_mesh: int, length: float, kind: str = "cic") -> torch.Tensor:
    """Unnormalised density of (..., N) positions wrapped to [0, L): (..., M)."""
    if not _check_device(x, "deposit_cic"):
        return deposit_cic_plain(x, n_mesh, length, kind)
    rows = _as_rows(x, "deposit_cic")
    b, n = rows.shape
    if b > _MAX_BATCH or n_mesh * 4 > 48 * 1024:
        raise ValueError(f"deposit_cic: batch {b} or mesh {n_mesh} beyond the kernel's limits")
    out = torch.zeros((b, n_mesh), dtype=torch.float32, device=x.device)
    if n > 0:
        with torch.cuda.device(x.device):
            err = _build.library().pct_cic_deposit(
                rows.data_ptr(), out.data_ptr(), b, n, n_mesh,
                1.0 / (length / n_mesh), _KIND_ID[kind],
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, "deposit_cic")
        deposit_cic.launches += 1
    return out.reshape(x.shape[:-1] + (n_mesh,))


deposit_cic.launches = 0


def gather_cic(e_mesh: torch.Tensor, x: torch.Tensor, n_mesh: int, length: float,
               kind: str = "cic") -> torch.Tensor:
    """(..., M) mesh field at (..., N) positions wrapped to [0, L): (..., N).
    A single (M,) field is shared by every batch row of ``x``."""
    if not _check_device(x, "gather_cic"):
        return gather_cic_plain(e_mesh, x, n_mesh, length, kind)
    rows = _as_rows(x, "gather_cic")
    b, n = rows.shape
    if b > _MAX_BATCH:
        raise ValueError(f"gather_cic: batch {b} beyond the kernel's limit {_MAX_BATCH}")
    e_rows = _as_rows(e_mesh.expand(x.shape[:-1] + (n_mesh,)), "gather_cic")
    if e_rows.device != x.device:
        raise RuntimeError("gather_cic: field and positions lie on different devices")
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if n > 0:
        with torch.cuda.device(x.device):
            err = _build.library().pct_cic_gather(
                e_rows.data_ptr(), rows.data_ptr(), out.data_ptr(), b, n, n_mesh,
                1.0 / (length / n_mesh), _KIND_ID[kind],
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, "gather_cic")
        gather_cic.launches += 1
    return out.reshape(x.shape)


gather_cic.launches = 0
