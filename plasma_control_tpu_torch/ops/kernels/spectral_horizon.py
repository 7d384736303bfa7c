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
base-harmonic phasor) and ``trig`` (wrap, then cos/sin). The twin-corrected
variant of the TPU kernel is not ported yet.

Every N runs on the card: where a candidate's state does not fit one CTA's
shared memory, the wrapper allocates a global scratch for it and the same
kernel body keeps the state there.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = [
    "spectral_horizon",
    "spectral_horizon_plain",
    "spectral_horizon_supported",
    "state_in_shared",
    "use_rot",
]

# shared memory left for the particle state beside the kernel's 1.25 KB of
# reduction scratch
_STATE_BYTES = _build.SHARED_BYTES - 1280
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
    """True if the kernel takes Km modes in its fixed-size mode arrays; any
    N >= 1 runs (:func:`state_in_shared` says where its state lives)."""
    return n_particles >= 1 and 1 <= km <= _build.MAX_MODES


def _state_floats(rot: bool) -> int:
    """Floats of state per particle: c1, s1, vh, plus x for the trig drift."""
    return 3 if rot else 4


def state_in_shared(n_particles: int, rot: bool) -> bool:
    """True if one candidate's particle state fits one CTA's shared memory
    (N <= 19264 for rot, 14448 for trig); otherwise it lives in a global
    scratch."""
    return 4 * _state_floats(rot) * n_particles <= _STATE_BYTES


def _constants(km: int, length: float, n0: float, n_particles: int):
    """Per-mode constants in float64, as the TPU kernel's wrapper builds them."""
    kv = 2.0 * np.pi / length * np.arange(1, km + 1)
    g = 2.0 * n0 / (n_particles * kv)
    inv_k2 = 1.0 / (kv * kv)
    return g, inv_k2, n0**2 / n_particles


def _pairs(u: torch.Tensor) -> torch.Tensor:
    """pair_t = u_t + u_{t+1} along the horizon; the last is 2 u_{H-1}."""
    return torch.cat([u[:, 1:], u[:, -1:]], dim=1) + u


def spectral_horizon_plain(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot):
    """Plain version: x0, v0 (N,); u_c, u_s (K, H, Km) -> (K, H) float32."""
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
            pe = pe + (cm * cm + sm * sm) * inv_k2[m]
        vh = vh + 0.5 * dt * (-acc)
        pes.append(pe_scale * pe)
    return torch.cat(pes, dim=1)


def _spectral_horizon_cuda(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot):
    k_cand, horizon, km = u_c.shape
    if not spectral_horizon_supported(n_particles, km):
        raise ValueError(
            f"spectral_horizon: Km={km} modes (N={n_particles}) beyond the kernel's "
            f"limit Km <= {_build.MAX_MODES}"
        )
    tensors = (x0, v0, u_c, u_s)
    if any(t.dtype != torch.float32 or t.device != x0.device for t in tensors):
        raise TypeError("spectral_horizon: the CUDA kernel takes float32 tensors on one device")
    if x0.shape != (n_particles,) or v0.shape != (n_particles,) or u_s.shape != u_c.shape:
        raise ValueError("spectral_horizon: x0, v0 must be (N,) and u_c, u_s (K, H, Km)")
    g, inv_k2, pe_scale = _constants(km, length, n0, n_particles)
    params = _build.SpectralParams(
        k=k_cand, h=horizon, km=km, n=n_particles,
        dt=dt, half_dt=0.5 * dt, length=length, inv_l=1.0 / length,
        c_ang=2.0 * np.pi / length, c_ang_dt=(2.0 * np.pi / length) * dt,
        pe_scale=pe_scale,
    )
    params.g[:km] = [float(v) for v in g]
    params.inv_k2[:km] = [float(v) for v in inv_k2]
    x0c, v0c = x0.contiguous(), v0.contiguous()
    u0c, u0s = u_c[:, 0].contiguous(), u_s[:, 0].contiguous()
    pair_c = _pairs(u_c).contiguous()
    pair_s = _pairs(u_s).contiguous()
    pe = torch.empty((k_cand, horizon), dtype=torch.float32, device=x0.device)
    scratch = None
    if not state_in_shared(n_particles, rot):
        scratch = torch.empty((k_cand, _state_floats(rot) * n_particles),
                              dtype=torch.float32, device=x0.device)
    with torch.cuda.device(x0.device):
        err = _build.library().pct_spectral_horizon(
            x0c.data_ptr(), v0c.data_ptr(), u0c.data_ptr(), u0s.data_ptr(),
            pair_c.data_ptr(), pair_s.data_ptr(), pe.data_ptr(),
            None if scratch is None else scratch.data_ptr(), params, int(rot),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "spectral_horizon")
    spectral_horizon.launches += 1
    return pe


def spectral_horizon(x0, v0, u_c, u_s, *, length, dt, n0, n_particles, rot):
    """(K, H) post-drift spectral-model field energies per candidate.

    x0, v0: (N,) shared particle state; u_c, u_s: (K, H, Km) external cosine
    and sine coefficients, zero-padded to the model's Km modes. CPU tensors
    take the plain version, CUDA tensors the kernel.
    """
    if x0.is_cuda:
        return _spectral_horizon_cuda(x0, v0, u_c, u_s, length=length, dt=dt, n0=n0,
                                      n_particles=n_particles, rot=rot)
    if x0.device.type != "cpu":
        raise RuntimeError(f"spectral_horizon: no kernel for device {x0.device}")
    return spectral_horizon_plain(x0, v0, u_c, u_s, length=length, dt=dt, n0=n0,
                                  n_particles=n_particles, rot=rot)


spectral_horizon.launches = 0
