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

The plain version is the op-by-op code the port ran on every device before
the kernel; on CPU tensors it still runs, and :mod:`...control.mpc` scores
its op-by-op spectral cost with the harmonic helpers :func:`mode_sums` and
:func:`mode_eval` defined here. On the card the whole computation is one
launch on one thread-block cluster (:func:`launch_geometry`); the design note
at the top of the CUDA source says what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...utils import trace
from ...utils.debug import check_kernel
from . import _build
from .spectral_horizon import _BLOCK_COEF_BYTES, _REDUCTION_BYTES, Geometry, _constants

__all__ = ["launch_geometry", "mode_eval", "mode_sums", "twin_rollout_plain", "twin_trajectory",
           "twin_trajectory_plain"]

# bytes of the kernel's static shared memory (sizeof(TwinShared) in the
# source): kernel 1's reduction scratch and block coefficients, and the noise
# fractions, laid out as the coefficients
_STATIC_BYTES = _REDUCTION_BYTES + 2 * _BLOCK_COEF_BYTES
_STATE_FLOATS = 4  # c1, s1, vh, x per plan particle
# particles of the larger state per CTA before the cluster doubles
_PER_CTA = 2048


def mode_sums(c1: torch.Tensor, s1: torch.Tensor, n_modes: int):
    """(..., Km) mode sums c_m = sum_p cos(k_m x_p), s_m = sum_p sin(k_m x_p)
    by the three-term recurrence from the base harmonic."""
    twoc = c1 + c1
    cs, ss = [c1.sum(-1)], [s1.sum(-1)]
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for _ in range(n_modes - 1):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        cs.append(c_prev.sum(-1))
        ss.append(s_prev.sum(-1))
    return torch.stack(cs, dim=-1), torch.stack(ss, dim=-1)


def mode_eval(c1: torch.Tensor, s1: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor):
    """sum_m pc[m] cos(k_m x_p) + ps[m] sin(k_m x_p) per particle."""
    twoc = c1 + c1
    acc = pc[..., 0:1] * c1 + ps[..., 0:1] * s1
    c_pp, s_pp = torch.ones_like(c1), torch.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for m in range(1, pc.shape[-1]):
        c_pp, c_prev = c_prev, twoc * c_prev - c_pp
        s_pp, s_prev = s_prev, twoc * s_prev - s_pp
        acc = acc + pc[..., m : m + 1] * c_prev + ps[..., m : m + 1] * s_prev
    return acc


def twin_rollout_plain(x, v, *, n_modes, horizon, length, dt, n0, n_particles):
    """Zero-drive twin of the spectral plan rollout: the (H, Km) mode-sum
    trajectory of the state (x, v) under no external drive, with the
    discretization of the candidate rollouts (merged-half-kick staggered KDK,
    the same initial un-merged half kick, post-drift sampling) and the exact
    trig drift, as in the JAX package. Op by op, on any device."""
    two_pi_over_l = 2.0 * math.pi / length
    k = two_pi_over_l * torch.arange(1, n_modes + 1, dtype=x.dtype, device=x.device)
    g = 2.0 * n0 / (n_particles * k)

    t0 = two_pi_over_l * x
    c1_0, s1_0 = torch.cos(t0), torch.sin(t0)
    c0, s0 = mode_sums(c1_0, s1_0, n_modes)
    vh = v + 0.5 * dt * (-mode_eval(c1_0, s1_0, g * s0, -(g * c0)))
    cs, ss = [], []
    for _ in range(horizon):
        x = torch.remainder(x + dt * vh, length)
        ang = two_pi_over_l * x
        c1, s1 = torch.cos(ang), torch.sin(ang)
        c, s = mode_sums(c1, s1, n_modes)
        vh = vh + 0.5 * dt * (-mode_eval(c1, s1, 2.0 * (g * s), 2.0 * (-(g * c))))
        cs.append(c)
        ss.append(s)
    return torch.stack(cs), torch.stack(ss)  # each (H, Km)


def twin_trajectory_plain(full_x, x0, v0, *, n_modes, horizon, length, dt, n0, n_full, n_plan):
    """Plain version: full_x (N,), x0, v0 (n,) -> (tc, ts), each (H, Km), in
    the dtype of x0. With coherent power ``sig2_m = max(C_m^2 + S_m^2 - N,
    0)`` of the full state's mode sums, r = n/N and the subsample's noise
    power n (1 - r), ``lambda_m = r^2 sig2_m / (r^2 sig2_m + n (1 - r))``."""
    t = (2.0 * math.pi / length) * full_x.to(x0.dtype)
    cf, sf = mode_sums(torch.cos(t), torch.sin(t), n_modes)
    nf, n = float(n_full), float(n_plan)
    r = n / nf
    sig2 = torch.clamp(cf * cf + sf * sf - nf, min=0.0)
    lam = (r * r * sig2) / (r * r * sig2 + n * (1.0 - r))
    rho = 1.0 - lam  # (Km,) noise fraction per mode
    c0, s0 = twin_rollout_plain(x0, v0, n_modes=n_modes, horizon=horizon, length=length, dt=dt,
                                n0=n0, n_particles=n_plan)
    return rho * c0, rho * s0


@functools.lru_cache(maxsize=None)
def launch_geometry(n_full: int, n_plan: int, cluster: int | None = None) -> Geometry:
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
    return Geometry(c, s, nbytes if nbytes <= _build.SHARED_BYTES - _STATIC_BYTES else 0)


@functools.lru_cache(maxsize=64)
def _params(n_full, n_plan, km, h, xf_st, x_st, cluster, length, dt, n0, in_global):
    """The kernel's parameter block, built once per shape and model, after
    checking that the launch's cluster fits the card
    (cudaOccupancyMaxActiveClusters); raises if it does not."""
    g, _, _ = _constants(km, length, n0, n_plan)
    r = n_plan / n_full
    spectral = _build.SpectralParams(
        k=1, h=h, km=km, n=n_plan, ka=0, u_sk=0, u_sh=0, x_st=x_st, cluster=cluster, dt=dt,
        half_dt=0.5 * dt, length=length, inv_l=1.0 / length, c_ang=2.0 * np.pi / length,
        c_ang_dt=(2.0 * np.pi / length) * dt, pe_scale=0.0,
    )
    spectral.g[:km] = [float(v) for v in g]
    params = _build.TwinParams(s=spectral, n_full=n_full, xf_st=xf_st, n_full_f=float(n_full),
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
