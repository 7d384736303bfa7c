"""Episode start states, drawn from ``--seed`` on the device.

A copy of the initial distributions that the program's configuration names
(``SimConfig.simcase``): two counter-streaming beams, or a Maxwellian
background with a fast beam, velocities by inverse-CDF truncated normals in
[-10, 10], positions uniform, and the velocity perturbation
``v *= 1 + A sin(2 pi n x / L)``. The benchmark draws every state itself and
hands the same tensors to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

V_WINDOW = 10.0


def _truncated_normal(gen, n, mean, sigma, device):
    lo, hi = (-V_WINDOW - mean) / sigma, (V_WINDOW - mean) / sigma
    a = torch.tensor(lo, device=device)
    b = torch.tensor(hi, device=device)
    u = torch.rand(n, generator=gen, device=device)
    fa, fb = torch.special.ndtr(a), torch.special.ndtr(b)
    z = torch.special.ndtri(fa + u * (fb - fa))
    return mean + sigma * torch.clamp(z, a, b)


def draw_state(sim: dict, gen: torch.Generator, device):
    """(x, v), float32, (N,) each, on ``device`` (``gen`` lives there)."""
    n, length = sim["n_particles"], sim["length"]
    x = torch.rand(n, generator=gen, device=device) * length
    if sim["simcase"] == "two-stream":
        n1 = n // 2
        v = torch.cat([_truncated_normal(gen, n1, sim["vb"], sim["vth"], device),
                       _truncated_normal(gen, n - n1, -sim["vb"], sim["vth"], device)])
    elif sim["simcase"] == "bump-on-tail":
        n1 = int(n * (1.0 / (1.0 + sim["bump_a"])))
        v = torch.cat([_truncated_normal(gen, n1, 0.0, 1.0, device),
                       _truncated_normal(gen, n - n1, sim["vb"], sim["vth"], device)])
    else:
        raise ValueError(f"no sampler for simcase {sim['simcase']!r}")
    v = v * (1.0 + sim["perturb_amplitude"] * torch.sin(
        2.0 * math.pi * sim["perturb_mode"] * x / sim["length"]))
    return x.contiguous(), v.contiguous()


def start_states(sim: dict, seed: int, count: int, device) -> list:
    """``count`` start states drawn in turn from one generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, 0))
    return [draw_state(sim, gen, device) for _ in range(count)]


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)
