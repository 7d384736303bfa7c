"""The spectral planner's whole horizon: the CUDA kernel of
``csrc/spectral_horizon.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``fused_spectral_horizon`` / ``_kernel``
(``plasma_control_tpu/ops/pallas/spectral_horizon.py``). For K candidate
drive sequences it rolls the shared particle state through the gridless
low-mode PIC model and returns the (K, H) post-drift field energies
``n0^2/N * sum_m (c_m^2 + s_m^2) / k_m^2``. The design note at the top of the
CUDA source says what bounds it on the H100 and how the kernel keeps each
candidate's particle state in shared memory for the whole horizon.

The plain version follows the TPU kernel op by op (same constants, same
order of operations), so on CPU tensors it stands in for the kernel in the
parity tests. Drift variants: ``rot`` (small-angle rotation of the carried
base-harmonic phasor) and ``trig`` (wrap, then cos/sin). With the (H, Km)
noise-correction targets ``twin_c``, ``twin_s`` of
:func:`plasma_control_tpu_torch.control.mpc.twin_targets`, both compute the
TPU kernel's twin-corrected energies
``n0^2/N * sum_m ((c_m - tc)^2 + (s_m - ts)^2) / k_m^2`` (the kernel's
``CORRECTED`` template variant).

On the card each candidate runs on a thread-block cluster of C CTAs, each
holding a slice of the particle state in shared memory;
:func:`launch_geometry` chooses C from N and the drift. Where even the largest
cluster cannot hold the state, it lives in a global scratch that the wrapper
allocates (:func:`scratch_shape`), so every N runs; there the kernel makes
one pass over the state per step. Km up to 16 runs a compile-time 8 or 16
modes; Km from 17 to 64 (``_build.MAX_MODES``) runs the kernel's blocked
variant, 16 modes at a time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "Geometry",
    "launch_geometry",
    "scratch_shape",
    "spectral_horizon",
    "spectral_horizon_plain",
    "spectral_horizon_supported",
    "state_in_shared",
    "use_rot",
]

# shared memory left for a CTA's slice of the particle state beside the
# kernel's static shared memory: the reduction scratch (sizeof(Reduction) in
# the source), and for Km > 16 the coefficients of every block of modes
# (sizeof(BlockCoefs))
_REDUCTION_BYTES = 1408
_BLOCK_COEF_BYTES = 4 * 2 * _build.MAX_MODES
# a slice of at most 64 KiB leaves room for three CTAs per SM, the rot
# kernel's register budget; a sweep on the H100 found the smallest such
# cluster fastest at every main-path shape (PERF.md §6)
_SLICE_BYTES = 64 * 1024
_V_SAFE = 25.0  # velocity bound of the rot drift's static angle gate


def use_rot(dt: float, length: float, mode: str | None = None) -> bool:
    """Resolve the drift choice: "rot" / "trig" force it; None or "auto"
    take "rot" when the small-angle bound (2 pi / L) dt 25 <= 0.5 holds."""
    if mode == "rot":
        return True
    if mode == "trig":
        return False
    return (2.0 * np.pi / length) * dt * _V_SAFE <= 0.5


def spectral_horizon_supported(n_particles: int, km: int) -> bool:
    """True if the kernel takes Km modes, 1 <= Km <= 64 (its per-mode
    constants are a fixed-size parameter block); any N >= 1 runs
    (:func:`state_in_shared` says where its state lives)."""
    return n_particles >= 1 and 1 <= km <= _build.MAX_MODES


def _state_limit(km: int) -> int:
    """Bytes of shared memory a CTA's slice of the state may take at Km."""
    blocks = _BLOCK_COEF_BYTES if km > _build.BLOCK_MODES else 0
    return _build.SHARED_BYTES - _REDUCTION_BYTES - blocks


def _state_floats(rot: bool, in_global: bool = False) -> int:
    """Floats of state per particle: in shared memory c1, s1, vh, plus x for
    the trig drift; in the global scratch (c1, s1, vh) for rot and (x, vh)
    for trig, whose phasor each pass recomputes from x
    (``stream_floats`` in the source)."""
    if in_global:
        return 3 if rot else 2
    return 3 if rot else 4


class Geometry(NamedTuple):
    """Launch geometry of one candidate: a cluster of ``cluster`` CTAs, CTA r
    holding particles [r * slice, min((r + 1) * slice, N)) in
    ``shared_bytes`` of dynamic shared memory; 0 shared bytes: the slices
    live in a global scratch."""

    cluster: int
    slice: int
    shared_bytes: int


@functools.lru_cache(maxsize=None)
def launch_geometry(n_particles: int, rot: bool, km: int = 1) -> Geometry:
    """The smallest power-of-two cluster whose CTAs each hold at most 64 KiB
    of state, at most MAX_CLUSTER CTAs; a cluster of MAX_CLUSTER whose slices
    exceed one CTA's shared memory (less 512 B more for Km > 16) keeps them
    in global memory. More CTAs per candidate add a cluster barrier's wait
    per step for each CTA's smaller share of the particles."""
    per = 4 * _state_floats(rot)
    c = 1
    while c < _build.MAX_CLUSTER and per * -(-n_particles // c) > _SLICE_BYTES:
        c *= 2
    s = -(-n_particles // c)
    return Geometry(c, s, per * s if per * s <= _state_limit(km) else 0)


def state_in_shared(n_particles: int, rot: bool, km: int = 1) -> bool:
    """True if the candidate's particle state fits the shared memory of its
    cluster (N <= 308048 for rot, 231040 for trig; 307360 and 230528 for
    Km > 16); otherwise it lives in a global scratch."""
    return launch_geometry(n_particles, rot, km).shared_bytes > 0


def scratch_shape(k: int, geometry: Geometry, rot: bool) -> tuple[int, int] | None:
    """The global scratch of a launch of K candidates at ``geometry``: one
    row per CTA of ``_state_floats(rot, True) * slice`` floats; None when
    the state lives in shared memory."""
    if geometry.shared_bytes:
        return None
    return k * geometry.cluster, _state_floats(rot, in_global=True) * geometry.slice


def _constants(km: int, length: float, n0: float, n_particles: int):
    """Per-mode constants in float64, as the TPU kernel's wrapper builds them."""
    kv = 2.0 * np.pi / length * np.arange(1, km + 1)
    g = 2.0 * n0 / (n_particles * kv)
    inv_k2 = 1.0 / (kv * kv)
    return g, inv_k2, n0**2 / n_particles


def _pairs(u: torch.Tensor) -> torch.Tensor:
    """pair_t = u_t + u_{t+1} along the horizon; the last is 2 u_{H-1}."""
    return torch.cat([u[:, 1:], u[:, -1:]], dim=1) + u


def spectral_horizon_plain(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot,
                           twin_c=None, twin_s=None, n_modes=None):
    """Plain version: x0, v0 (N,); u_c, u_s (K, H, Ka), zero-padded to
    ``n_modes`` (default Ka) modes; twin_c, twin_s (H, Km) or None -> (K, H)
    float32."""
    if n_modes is not None:
        u_c = F.pad(u_c, (0, n_modes - u_c.shape[-1]))
        u_s = F.pad(u_s, (0, n_modes - u_s.shape[-1]))
    k_cand, horizon, km = u_c.shape
    g, inv_k2, pe_scale = _constants(km, length, n0, n_particles)
    g, inv_k2 = [float(v) for v in g], [float(v) for v in inv_k2]
    c_ang = 2.0 * np.pi / length
    pair_c, pair_s = _pairs(u_c), _pairs(u_s)
    x0 = x0.to(torch.float32)
    ones = torch.ones_like(x0)

    # initial un-merged half kick at the shared x0
    t0 = c_ang * x0
    raw_c0 = torch.cos(t0)
    twoc_0 = raw_c0 + raw_c0
    c1_0, s1_0 = raw_c0, torch.sin(t0)
    c_prev2, s_prev2, c_prev, s_prev = ones, torch.zeros_like(x0), c1_0, s1_0
    acc0 = torch.zeros((k_cand, x0.shape[0]), dtype=torch.float32, device=x0.device)
    for m in range(km):
        if m > 0:
            c_prev2, c_prev = c_prev, twoc_0 * c_prev - c_prev2
            s_prev2, s_prev = s_prev, twoc_0 * s_prev - s_prev2
        cm, sm = torch.sum(c_prev), torch.sum(s_prev)
        pc0 = g[m] * sm + u_c[:, 0, m : m + 1]  # (K, 1)
        ps0 = -(g[m] * cm) + u_s[:, 0, m : m + 1]
        acc0 = acc0 + pc0 * c_prev + ps0 * s_prev
    vh = v0.to(torch.float32) + 0.5 * dt * (-acc0)
    if rot:
        c1, s1 = c1_0.expand_as(vh), s1_0.expand_as(vh)
    else:
        x = x0.expand_as(vh)

    inv_l = 1.0 / length
    pes = []
    for t in range(horizon):
        if rot:
            d = (c_ang * dt) * vh
            d2 = d * d
            cd = 1.0 + d2 * (-0.5 + d2 * (1.0 / 24.0))
            sd = d * (1.0 + d2 * (-1.0 / 6.0 + d2 * (1.0 / 120.0)))
            c1, s1 = c1 * cd - s1 * sd, s1 * cd + c1 * sd
            c_prev, s_prev = c1, s1
            twoc = c1 + c1
        else:
            x = x + dt * vh
            x = x - length * torch.floor(x * inv_l)
            ang = c_ang * x
            c_prev, s_prev = torch.cos(ang), torch.sin(ang)
            twoc = c_prev + c_prev
        c_prev2, s_prev2 = torch.ones_like(vh), torch.zeros_like(vh)
        acc = torch.zeros_like(vh)
        pe = torch.zeros((k_cand, 1), dtype=torch.float32, device=vh.device)
        for m in range(km):
            if m > 0:
                c_prev2, c_prev = c_prev, twoc * c_prev - c_prev2
                s_prev2, s_prev = s_prev, twoc * s_prev - s_prev2
            cm = torch.sum(c_prev, dim=-1, keepdim=True)  # (K, 1)
            sm = torch.sum(s_prev, dim=-1, keepdim=True)
            pc = 2.0 * (g[m] * sm) + pair_c[:, t, m : m + 1]
            ps = 2.0 * (-(g[m] * cm)) + pair_s[:, t, m : m + 1]
            acc = acc + pc * c_prev + ps * s_prev
            if twin_c is not None:
                cm = cm - twin_c[t, m]
                sm = sm - twin_s[t, m]
            pe = pe + (cm * cm + sm * sm) * inv_k2[m]
        vh = vh + 0.5 * dt * (-acc)
        pes.append(pe_scale * pe)
    return torch.cat(pes, dim=1)


@functools.lru_cache(maxsize=256)
def _params(k, h, km, n, ka, u_sk, u_sh, x_st, cluster, length, dt, n0, rot, in_global,
            corrected):
    """The kernel's parameter block, built once per shape and model, after
    checking that at least one cluster of the launch fits the card
    (cudaOccupancyMaxActiveClusters); raises if none does."""
    g, inv_k2, pe_scale = _constants(km, length, n0, n)
    params = _build.SpectralParams(
        k=k, h=h, km=km, n=n, ka=ka, u_sk=u_sk, u_sh=u_sh, x_st=x_st, cluster=cluster,
        dt=dt, half_dt=0.5 * dt, length=length, inv_l=1.0 / length,
        c_ang=2.0 * np.pi / length, c_ang_dt=(2.0 * np.pi / length) * dt, pe_scale=pe_scale,
    )
    params.g[:km] = [float(v) for v in g]
    params.inv_k2[:km] = [float(v) for v in inv_k2]
    fits = ctypes.c_int(0)
    err = _build.library().pct_spectral_max_clusters(params, int(rot), int(in_global),
                                                     int(corrected), ctypes.byref(fits))
    _build.check(err, "spectral_horizon")
    if fits.value < 1:
        raise RuntimeError(f"spectral_horizon: no cluster of {cluster} CTAs fits the card "
                           f"(N={n}, {'rot' if rot else 'trig'})")
    return params


def _spectral_horizon_cuda(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot, twin_c,
                           twin_s, n_modes, geometry=None):
    """The kernel launch. ``geometry`` overrides :func:`launch_geometry`
    (tests force a cluster size or the global scratch with it)."""
    k_cand, horizon, ka = u_c.shape
    km = ka if n_modes is None else n_modes
    if not spectral_horizon_supported(n_particles, km) or ka > km:
        raise ValueError(
            f"spectral_horizon: Ka={ka} drive modes padded to Km={km} (N={n_particles}): the "
            f"kernel takes Ka <= Km <= {_build.MAX_MODES}"
        )
    corrected = twin_c is not None
    if corrected != (twin_s is not None):
        raise ValueError("spectral_horizon: pass both twin_c and twin_s, or neither")
    tensors = (x0, v0, u_c, u_s) + ((twin_c, twin_s) if corrected else ())
    if any(t.dtype != torch.float32 or t.device != x0.device for t in tensors):
        raise TypeError("spectral_horizon: the CUDA kernel takes float32 tensors on one device")
    if x0.shape != (n_particles,) or v0.shape != (n_particles,) or u_s.shape != u_c.shape:
        raise ValueError("spectral_horizon: x0, v0 must be (N,) and u_c, u_s (K, H, Ka)")
    if corrected and not twin_c.shape == twin_s.shape == (horizon, km):
        raise ValueError("spectral_horizon: twin_c, twin_s must be (H, Km)")
    # strided views are read in place: x0, v0 at one stride, the drive with
    # unit mode stride and the same strides for u_c and u_s
    if x0.stride() != v0.stride() or x0.stride(0) < 1:
        x0, v0 = x0.contiguous(), v0.contiguous()
    if u_c.stride() != u_s.stride() or u_c.stride(-1) != 1:
        u_c, u_s = u_c.contiguous(), u_s.contiguous()
    if corrected:
        twin_c, twin_s = twin_c.contiguous(), twin_s.contiguous()
    geo = launch_geometry(n_particles, rot, km) if geometry is None else geometry
    in_global = geo.shared_bytes == 0
    params = _params(k_cand, horizon, km, n_particles, ka, u_c.stride(0), u_c.stride(1),
                     x0.stride(0), geo.cluster, float(length), float(dt), float(n0), bool(rot),
                     in_global, corrected)
    pe = torch.empty((k_cand, horizon), dtype=torch.float32, device=x0.device)
    shape = scratch_shape(k_cand, geo, rot)
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float32,
                                                     device=x0.device)
    _build.call(
        "pct_spectral_horizon", x0.get_device(),
        x0.data_ptr(), v0.data_ptr(), u_c.data_ptr(), u_s.data_ptr(),
        twin_c.data_ptr() if corrected else None, twin_s.data_ptr() if corrected else None,
        pe.data_ptr(), None if scratch is None else scratch.data_ptr(), params, int(rot),
    )
    spectral_horizon.launches += 1
    if corrected:
        spectral_horizon.twin_launches += 1
    return pe


def spectral_horizon(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot,
                     twin_c=None, twin_s=None, n_modes=None):
    """(K, H) post-drift spectral-model field energies per candidate.

    x0, v0: (N,) shared particle state; u_c, u_s: (K, H, Ka) external cosine
    and sine coefficients, zero-padded to the model's ``n_modes`` = Km modes
    (default Ka; the kernel pads in place, so views of one candidate tensor
    are read as they are); twin_c, twin_s: (H, Km) noise-correction targets,
    which make the energies the twin-corrected ones. CPU tensors take the
    plain version, CUDA tensors the kernel.
    """
    kw = dict(length=length, dt=dt, n0=n0, n_particles=n_particles, rot=rot,
              twin_c=twin_c, twin_s=twin_s, n_modes=n_modes)
    if x0.is_cuda:
        return _spectral_horizon_cuda(x0, v0, u_c, u_s, **kw)
    if x0.device.type != "cpu":
        raise RuntimeError(f"spectral_horizon: no kernel for device {x0.device}")
    return spectral_horizon_plain(x0, v0, u_c, u_s, **kw)


# launches of the kernel, and of its twin-corrected variant among them
spectral_horizon.launches = 0
spectral_horizon.twin_launches = 0
