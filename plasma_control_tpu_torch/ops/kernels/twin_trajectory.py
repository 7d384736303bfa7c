"""The twin-corrected solve's targets: the CUDA kernel of
``csrc/twin_trajectory.cu`` and its plain PyTorch version.

No TPU kernel corresponds to it: the JAX package computes these targets with
XLA ops (``plasma_control_tpu/control/mpc.py::twin_targets``). From the full
state's positions and the plan state's subsample it returns the (H, Km)
noise-correction targets ``(tc, ts)`` of
:func:`plasma_control_tpu_torch.control.mpc.twin_targets`: each mode's noise
fraction ``rho_m = 1 - lambda_m`` (the Wiener shrinkage estimated from the
full state's mode sums) times the mode-sum trajectory of the plan state's
zero-drive twin (the spectral plan rollout's discretization with the exact
trig drift). Kernel 1's corrected variant
(:mod:`.spectral_horizon`) subtracts them from every candidate's mode sums.

The plain version puts the targets together from the plan model of
:mod:`..spectral`: the full state's coherent power and the zero-drive
rollout with the trig drift. CPU tensors take it. On the card the whole
computation is one launch on one thread-block cluster
(:func:`launch_geometry`); the design note at the top of the CUDA source
says what bounds it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils import trace
from ...utils.debug import check_kernel
from .. import spectral
from . import _build

__all__ = ["launch_geometry", "twin_trajectory", "twin_trajectory_plain"]

# bytes of the kernel's static shared memory (sizeof(TwinShared) in the
# source): kernel 1's reduction scratch and block coefficients, and the noise
# fractions, laid out as the coefficients
_STATIC_BYTES = _build.REDUCTION_BYTES + 2 * _build.BLOCK_COEF_BYTES
_STATE_FLOATS = 4  # c1, s1, vh, x per plan particle
# particles of the larger state per CTA before the cluster doubles
_PER_CTA = 2048


def twin_trajectory_plain(full_x, x0, v0, *, n_modes, horizon, length, dt, n0, n_full, n_plan):
    """Plain version: full_x (N,), x0, v0 (n,) -> (tc, ts), each (H, Km), in
    the dtype of x0. With coherent power ``sig2_m = max(C_m^2 + S_m^2 - N,
    0)`` of the full state's mode sums, r = n/N and the subsample's noise
    power n (1 - r), ``lambda_m = r^2 sig2_m / (r^2 sig2_m + n (1 - r))``."""
    sig2 = spectral.coherent_power(full_x.to(x0.dtype), n_modes, length)
    n = float(n_plan)
    r = n / n_full
    lam = (r * r * sig2) / (r * r * sig2 + n * (1.0 - r))
    rho = 1.0 - lam  # (Km,) noise fraction per mode
    zero = x0.new_zeros(horizon, n_modes)
    c0, s0 = spectral.rollout(x0, v0, zero, zero, length=length, dt=dt, n0=n0,
                              n_particles=n_plan, rot=False)
    return rho * c0, rho * s0


@functools.lru_cache(maxsize=None)
def launch_geometry(n_full: int, n_plan: int, cluster: int | None = None) -> _build.Geometry:
    """One cluster of C CTAs, C the smallest power of two that leaves at
    most 2048 particles of the larger state per CTA, at most MAX_CLUSTER
    (or ``cluster``, which tests force); CTA r holds plan particles
    [r * slice, min((r + 1) * slice, n)) in ``shared_bytes`` of dynamic
    shared memory, or, where they exceed a CTA's shared memory (n > 230016
    at C=16), in a global scratch (0 bytes)."""
    c = cluster
    if c is None:
        c = 1
        while c < _build.MAX_CLUSTER and -(-max(n_full, n_plan) // c) > _PER_CTA:
            c *= 2
    s = -(-n_plan // c)
    nbytes = 4 * _STATE_FLOATS * s
    return _build.Geometry(c, s, nbytes if nbytes <= _build.SHARED_BYTES - _STATIC_BYTES else 0)


@functools.lru_cache(maxsize=64)
def _params(n_full, n_plan, km, h, xf_st, x_st, cluster, length, dt, n0, in_global):
    """The kernel's parameter block, built once per shape and model, after
    checking that the launch's cluster fits the card
    (cudaOccupancyMaxActiveClusters); raises if it does not."""
    g = spectral.constants(km, length, n0, n_plan)[1]
    r = n_plan / n_full
    block = _build.SpectralParams(
        k=1, h=h, km=km, n=n_plan, ka=0, u_sk=0, u_sh=0, x_st=x_st, cluster=cluster, dt=dt,
        half_dt=0.5 * dt, length=length, inv_l=1.0 / length, c_ang=2.0 * np.pi / length,
        c_ang_dt=(2.0 * np.pi / length) * dt, pe_scale=0.0,
    )
    block.g[:km] = g
    params = _build.TwinParams(s=block, n_full=n_full, xf_st=xf_st, n_full_f=float(n_full),
                               r2=r * r, noise=n_plan * (1.0 - r))
    fits = ctypes.c_int(0)
    err = _build.library().pct_twin_max_clusters(params, int(in_global), ctypes.byref(fits))
    _build.check(err, "twin_trajectory")
    if fits.value < 1:
        raise RuntimeError(f"twin_trajectory: no cluster of {cluster} CTAs fits the card "
                           f"(N={n_full}, n={n_plan})")
    return params


def _twin_trajectory_cuda(full_x, x0, v0, *, n_modes, horizon, length, dt, n0, n_full, n_plan,
                          cluster=None):
    """The kernel launch. ``cluster`` forces :func:`launch_geometry`'s
    cluster size (tests check and time other sizes with it)."""
    tensors = (full_x, x0, v0)
    if any(t.dtype != torch.float32 or t.device != x0.device for t in tensors):
        raise TypeError("twin_trajectory: the CUDA kernel takes float32 tensors on one device")
    if full_x.shape != (n_full,) or x0.shape != (n_plan,) or v0.shape != (n_plan,):
        raise ValueError("twin_trajectory: full_x must be (N,) and x0, v0 (n,)")
    if x0.stride() != v0.stride() or x0.stride(0) < 1 or full_x.stride(0) < 1:
        raise ValueError("twin_trajectory: x0 and v0 must share one positive stride, and "
                         "full_x's stride must be positive")
    if not 1 <= n_modes <= _build.MAX_MODES or horizon < 1:
        raise ValueError(f"twin_trajectory: Km={n_modes}, H={horizon}: the kernel takes "
                         f"1 <= Km <= {_build.MAX_MODES} and H >= 1")
    geo = launch_geometry(n_full, n_plan, cluster)
    in_global = geo.shared_bytes == 0
    params = _params(n_full, n_plan, n_modes, horizon, full_x.stride(0), x0.stride(0),
                     geo.cluster, float(length), float(dt), float(n0), in_global)
    out = torch.empty((2, horizon, n_modes), dtype=torch.float32, device=x0.device)
    scratch = (torch.empty((geo.cluster, _STATE_FLOATS * geo.slice), dtype=torch.float32,
                           device=x0.device) if in_global else None)
    _build.call(
        "pct_twin_trajectory", x0.get_device(), full_x.data_ptr(), x0.data_ptr(),
        v0.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        None if scratch is None else scratch.data_ptr(), params,
    )
    twin_trajectory.launches += 1
    trace.count("plan.twin_kernel")
    check_kernel("twin_trajectory", tensors, (out,))
    return out[0], out[1]


def twin_trajectory(full_x, x0, v0, *, n_modes, horizon, length, dt, n0, n_full, n_plan):
    """(tc, ts), each (H, Km): the twin-corrected solve's noise-correction
    targets.

    full_x: (N,) positions of the full state; x0, v0: (n,) the plan state
    (strided views of the subsample are read in place); n_modes = Km and
    horizon = H of the plan; length, dt, n0 of the plan model; n_full = N
    and n_plan = n. CPU tensors take the plain version, CUDA tensors the
    kernel, which raises on what it does not take (any dtype but float32,
    Km > 64)."""
    kw = dict(n_modes=n_modes, horizon=horizon, length=length, dt=dt, n0=n0, n_full=n_full,
              n_plan=n_plan)
    if x0.is_cuda:
        return _twin_trajectory_cuda(full_x, x0, v0, **kw)
    if x0.device.type != "cpu":
        raise RuntimeError(f"twin_trajectory: no kernel for device {x0.device}")
    return twin_trajectory_plain(full_x, x0, v0, **kw)


twin_trajectory.launches = 0  # launches of the kernel
