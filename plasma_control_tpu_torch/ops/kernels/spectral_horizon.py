"""The spectral planner's whole horizon: the CUDA kernel of
``csrc/spectral_horizon.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``fused_spectral_horizon`` / ``_kernel``
(``plasma_control_tpu/ops/pallas/spectral_horizon.py``). For K candidate
drive sequences it rolls the shared particle state through the gridless
low-mode PIC model and returns the (K, H) post-drift field energies
``n0^2/N * sum_m (c_m^2 + s_m^2) / k_m^2``. The design note at the top of the
CUDA source says what bounds it on the H100 and how the kernel keeps each
candidate's particle state in shared memory for the whole horizon.

The plain version is the plan model of :mod:`..spectral`, its rollout and
field energy: the TPU kernel's constants and order of operations, except
that the energy sums its modes at the end. On CPU tensors it stands in for
the kernel, in the planner and in the parity tests. Drift variants: ``rot``
(small-angle rotation of the carried base-harmonic phasor) and ``trig``
(wrap, then cos/sin). With the (H, Km) noise-correction targets
``twin_c``, ``twin_s`` of
:func:`plasma_control_tpu_torch.control.mpc.twin_targets`, both compute the
TPU kernel's twin-corrected energies
``n0^2/N * sum_m ((c_m - tc)^2 + (s_m - ts)^2) / k_m^2`` (the kernel's
``CORRECTED`` template variant).

On the card each candidate runs on a thread-block cluster of C CTAs, each
holding a slice of the particle state in shared memory;
:func:`launch_geometry` chooses C from N and the drift. Where even the largest
cluster cannot hold the state, it lives in a global scratch that the wrapper
allocates (:func:`scratch_shape`), so every N runs; there the kernel makes
one pass over the state per step, on persistent clusters that fill the card
(:func:`stream_layout`), each walking several candidates. Km up to 16 runs
a compile-time 8 or 16 modes; Km from 17 to 64 (``_build.MAX_MODES``) runs
the kernel's blocked variant, 16 modes at a time. While
:mod:`...utils.debug`'s NaN checks are on, the wrapper checks each launch's
inputs and output. Under a
:mod:`...utils.trace` recording it counts each launch of the blocked variant
(``plan.blocks_kernel``), adds the bytes of each launch's global scratch
(``plan.kernel_scratch_bytes``) and the clusters each such launch runs
(``plan.stream_clusters``).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import trace
from ...utils.debug import check_kernel
from .. import spectral
from . import _build
from ._build import Geometry

__all__ = [
    "Geometry",
    "StreamLayout",
    "cluster_fits",
    "launch_geometry",
    "scratch_shape",
    "spectral_horizon",
    "spectral_horizon_plain",
    "spectral_horizon_supported",
    "state_in_shared",
    "stream_layout",
    "use_rot",
]

# a slice of at most 64 KiB leaves room for three CTAs per SM, the rot
# kernel's register budget; a sweep on the H100 found the smallest such
# cluster fastest at every main-path shape (PERF.md §6)
_SLICE_BYTES = 64 * 1024
_V_SAFE = 25.0  # velocity bound of the rot drift's static angle gate
_CLUSTERS = (1, 2, 4, 8, 16)  # the physical cluster sizes of the global-scratch path


class StreamLayout(NamedTuple):
    """The physical launch of the global-scratch path: ``clusters`` clusters
    of ``cluster`` CTAs, ``cluster`` dividing the geometry's cluster (its
    virtual ranks, whose slices a CTA works through in turn, geometry.cluster
    / cluster of them); cluster c runs candidates c, c + clusters, ..."""

    cluster: int
    clusters: int


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
    blocks = _build.BLOCK_COEF_BYTES if km > _build.BLOCK_MODES else 0
    return _build.SHARED_BYTES - _build.REDUCTION_BYTES - blocks


def _state_floats(rot: bool, in_global: bool = False) -> int:
    """Floats of state per particle: in shared memory c1, s1, vh, plus x for
    the trig drift; in the global scratch (c1, s1, vh) for rot and (x, vh)
    for trig, whose phasor each pass recomputes from x
    (``stream_floats`` in the source)."""
    if in_global:
        return 3 if rot else 2
    return 3 if rot else 4


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


def stream_layout(k: int, ranks: int, fits: Mapping[int, int]) -> StreamLayout:
    """The global-scratch path's physical clusters for K candidates over
    ``ranks`` virtual ranks (the geometry's cluster), given ``fits``, the
    clusters of C CTAs the card holds at once (A(C), C in 1, 2, 4, 8, 16):
    of the C that divide ``ranks`` and fit, the one that minimises rounds
    times slices per CTA, ceil(K / min(K, A(C))) * ranks / C; min(K, A(C))
    clusters. On a tie the larger C, of more rounds: CTAs launched together
    share their SMs two by two whatever their number, so a round of fewer
    clusters runs no faster, while the candidates of a partly empty last
    round run on SMs whose other CTA has finished (an H100, N=1M, K=16: C=16
    on 14 clusters, 2 rounds, 3.9 ms; C=8 on 16 clusters, 1 round of 2
    slices, 5.2 ms)."""
    best = None
    for c in _CLUSTERS:
        if ranks % c or fits.get(c, 0) < 1:
            continue
        clusters = min(k, fits[c])
        rounds = -(-k // clusters)
        key = (rounds * (ranks // c), -rounds)
        if best is None or key < best[0]:
            best = key, StreamLayout(c, clusters)
    if best is None:
        raise RuntimeError(f"spectral_horizon: no cluster dividing {ranks} CTAs fits the card")
    return best[1]


def scratch_shape(k: int, geometry: Geometry, rot: bool,
                  layout: StreamLayout | None = None) -> tuple[int, int] | None:
    """The global scratch of a launch of K candidates at ``geometry`` on
    ``layout``'s clusters (None: one cluster of geometry.cluster CTAs per
    candidate): one row per CTA, ``_state_floats(rot, True) * slice``
    floats for each of its virtual ranks; None when the state lives in
    shared memory."""
    if geometry.shared_bytes:
        return None
    layout = StreamLayout(geometry.cluster, k) if layout is None else layout
    per = geometry.cluster // layout.cluster
    return (layout.clusters * layout.cluster,
            _state_floats(rot, in_global=True) * per * geometry.slice)


def spectral_horizon_plain(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot,
                           twin_c=None, twin_s=None, n_modes=None):
    """Plain version: x0, v0 (N,); u_c, u_s (K, H, Ka), zero-padded to
    ``n_modes`` (default Ka) modes; twin_c, twin_s (H, Km) or None -> (K, H)
    float32."""
    if n_modes is not None:
        u_c = F.pad(u_c, (0, n_modes - u_c.shape[-1]))
        u_s = F.pad(u_s, (0, n_modes - u_s.shape[-1]))
    model = dict(length=length, n0=n0, n_particles=n_particles)
    c, s = spectral.rollout(x0.to(torch.float32), v0.to(torch.float32), u_c, u_s, dt=dt, rot=rot,
                            **model)
    return spectral.field_energy(c, s, tc=twin_c, ts=twin_s, **model)


def _max_clusters(params, rot, in_global, corrected, cluster) -> int:
    """Clusters of ``cluster`` CTAs of the launch the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    fits = ctypes.c_int(0)
    err = _build.library().pct_spectral_max_clusters(params, int(rot), int(in_global),
                                                     int(corrected), cluster, ctypes.byref(fits))
    _build.check(err, "spectral_horizon")
    return fits.value


@functools.lru_cache(maxsize=None)
def cluster_fits(device: int, rot: bool, corrected: bool, blocks: bool) -> dict[int, int]:
    """A(C) of the global-scratch path on CUDA device ``device`` (an index)
    for each C in 1, 2, 4, 8, 16, the table :func:`stream_layout` takes: on
    one card its occupancy depends only on the drift, the energy and whether
    Km > 16."""
    km = _build.MAX_MODES if blocks else _build.BLOCK_MODES
    params = _build.SpectralParams(k=1, h=1, km=km, n=1, ka=0, u_sk=0, u_sh=0, x_st=1,
                                   cluster=_build.MAX_CLUSTER)
    with torch.cuda.device(device):
        return {c: _max_clusters(params, rot, True, corrected, c) for c in _CLUSTERS}


@functools.lru_cache(maxsize=256)
def _params(k, h, km, n, ka, u_sk, u_sh, x_st, cluster, length, dt, n0, rot, in_global,
            corrected):
    """The kernel's parameter block, built once per shape and model; with the
    state in shared memory after checking that at least one cluster of the
    launch fits the card (cudaOccupancyMaxActiveClusters; the global path's
    clusters are :func:`stream_layout`'s); raises if none does."""
    _, g, inv_k2, pe_scale = spectral.constants(km, length, n0, n)
    params = _build.SpectralParams(
        k=k, h=h, km=km, n=n, ka=ka, u_sk=u_sk, u_sh=u_sh, x_st=x_st, cluster=cluster,
        dt=dt, half_dt=0.5 * dt, length=length, inv_l=1.0 / length,
        c_ang=2.0 * np.pi / length, c_ang_dt=(2.0 * np.pi / length) * dt, pe_scale=pe_scale,
    )
    params.g[:km] = g
    params.inv_k2[:km] = inv_k2
    if not in_global and _max_clusters(params, rot, False, corrected, cluster) < 1:
        raise RuntimeError(f"spectral_horizon: no cluster of {cluster} CTAs fits the card "
                           f"(N={n}, {'rot' if rot else 'trig'})")
    return params


def _spectral_horizon_cuda(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot, twin_c,
                           twin_s, n_modes, geometry=None, layout=None):
    """The kernel launch. ``geometry`` overrides :func:`launch_geometry`
    (tests force a cluster size or the global scratch with it), ``layout``
    the global-scratch path's :func:`stream_layout` (tests and the cluster
    sweep force its clusters with it)."""
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
    if not in_global:
        layout = StreamLayout(geo.cluster, k_cand)
    elif layout is None:
        layout = stream_layout(k_cand, geo.cluster, cluster_fits(
            x0.get_device(), bool(rot), corrected, km > _build.BLOCK_MODES))
    pe = torch.empty((k_cand, horizon), dtype=torch.float32, device=x0.device)
    shape = scratch_shape(k_cand, geo, rot, layout)
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float32,
                                                     device=x0.device)
    _build.call(
        "pct_spectral_horizon", x0.get_device(),
        x0.data_ptr(), v0.data_ptr(), u_c.data_ptr(), u_s.data_ptr(),
        twin_c.data_ptr() if corrected else None, twin_s.data_ptr() if corrected else None,
        pe.data_ptr(), None if scratch is None else scratch.data_ptr(), params, int(rot),
        layout.cluster, layout.clusters,
    )
    spectral_horizon.launches += 1
    if corrected:
        spectral_horizon.twin_launches += 1
    if km > _build.BLOCK_MODES:
        trace.count("plan.blocks_kernel")
    if shape is not None:
        trace.count("plan.kernel_scratch_bytes", 4 * shape[0] * shape[1])
        trace.count("plan.stream_clusters", layout.clusters)
    check_kernel("spectral_horizon", tensors, (pe,))
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
