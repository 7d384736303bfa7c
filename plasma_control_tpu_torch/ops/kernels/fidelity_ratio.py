"""The fidelity guard's statistic: the CUDA kernel of
``csrc/fidelity_ratio.cu`` and its plain PyTorch version.

No TPU kernel corresponds to it: the JAX package computes the ratio with XLA
ops (``plasma_control_tpu/control/mpc.py::_fidelity_ratio``). From the full
state's positions it returns the coherent-vs-injected-noise ratio that
:func:`plasma_control_tpu_torch.control.mpc._apply_fidelity_guard` compares
with ``mpc.fidelity_guard_ratio``: the full state's modal power
``(n0^2/N) (c_m^2 + s_m^2) / k_m^2`` less its Poisson floor ``n0^2/k_m^2``,
clamped at 0 and summed over m = 1..Km, times the plan's particle fraction,
over the injected noise power (a host constant).

The plain version states it with the coherent power of :mod:`..spectral`;
CPU tensors take it. On the card the whole statistic is one
launch (:func:`launch_ctas` CTAs); the design note at the top of the CUDA
source says what bounds it.
"""

from __future__ import annotations

import functools
import math

import torch

from ...utils import trace
from ...utils.debug import check_kernel
from .. import spectral
from . import _build

__all__ = ["fidelity_ratio", "fidelity_ratio_plain", "launch_ctas"]

_PER_CTA = 1024  # particles per CTA (4 per thread) before the grid grows
_MAX_CTAS = 264  # kMaxCtas of the source: two CTAs per SM of an H100


def fidelity_ratio_plain(x, *, n_modes, length, n0, n_particles, frac, injected):
    """Plain version: x (N,) -> the 0-dim ratio, in the dtype of x:
    ``frac (n0^2/N) sum_m sig2_m / k_m^2 / injected`` with the coherent power
    ``sig2_m = max(c_m^2 + s_m^2 - N, 0)`` of :func:`..spectral.coherent_power`,
    which equals the modal power less its floor, clamped."""
    _, _, inv_k2, scale = spectral.constants(n_modes, length, n0, n_particles)
    power = spectral.coherent_power(x.reshape(-1), n_modes, length)
    inv_k2 = torch.tensor(inv_k2, dtype=x.dtype, device=x.device)
    return frac * (scale * torch.sum(power * inv_k2)) / injected


def launch_ctas(n: int) -> int:
    """CTAs of the launch over n particles: one per 1024, at most 264."""
    return min(-(-n // _PER_CTA), _MAX_CTAS)


@functools.lru_cache(maxsize=64)
def _params(n, x_st, km, length, n0, n_particles, frac, injected):
    """The kernel's parameter block, built once per shape and model."""
    k = spectral.constants(km, length, n0, n_particles)[0]
    params = _build.FidelityParams(n=n, x_st=x_st, km=km, c_ang=2.0 * math.pi / length,
                                   scale=n0**2 / n_particles, n0sq=n0**2, frac=frac,
                                   injected=injected)
    params.k2[:km] = [v * v for v in k]
    return params


def _fidelity_ratio_cuda(x, *, n_modes, length, n0, n_particles, frac, injected):
    """The kernel launch."""
    if x.dtype != torch.float32:
        raise TypeError("fidelity_ratio: the CUDA kernel takes float32 positions")
    x = x.reshape(-1)
    if not 1 <= n_modes <= _build.MAX_MODES or x.shape[0] < 1 or x.stride(0) < 1:
        raise ValueError(f"fidelity_ratio: Km={n_modes}, N={x.shape[0]}: the kernel takes "
                         f"1 <= Km <= {_build.MAX_MODES}, N >= 1 and a positive stride")
    if not injected > 0.0:
        raise ValueError("fidelity_ratio: the injected noise power must be positive")
    n = x.shape[0]
    ctas = launch_ctas(n)
    modes = 8 if n_modes <= 8 else _build.BLOCK_MODES
    sums = -(-n_modes // modes) * 2 * modes
    params = _params(n, x.stride(0), n_modes, float(length), float(n0), int(n_particles),
                     float(frac), float(injected))
    partials = torch.empty((sums, ctas), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _build.call("pct_fidelity_ratio", x.get_device(), x.data_ptr(), partials.data_ptr(),
                out.data_ptr(), params, ctas)
    fidelity_ratio.launches += 1
    trace.count("plan.guard_kernel")
    check_kernel("fidelity_ratio", (x,), (out,))
    return out


def fidelity_ratio(x, *, n_modes, length, n0, n_particles, frac, injected):
    """The guard's 0-dim ratio.

    x: the full state's positions (N,); n_modes = Km of the plan; length and
    n0 of the model; n_particles = N; frac the plan's particle fraction;
    injected the injected noise power, > 0. CPU tensors take the plain
    version, CUDA tensors the kernel, which raises on what it does not take
    (any dtype but float32, Km > 64)."""
    kw = dict(n_modes=n_modes, length=length, n0=n0, n_particles=n_particles, frac=frac,
              injected=injected)
    if x.is_cuda:
        return _fidelity_ratio_cuda(x, **kw)
    if x.device.type != "cpu":
        raise RuntimeError(f"fidelity_ratio: no kernel for device {x.device}")
    return fidelity_ratio_plain(x, **kw)


fidelity_ratio.launches = 0  # launches of the kernel
