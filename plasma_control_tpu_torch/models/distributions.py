"""Initial phase-space distributions: two-stream, bump-on-tail, Maxwellian.

The counterpart of :mod:`plasma_control_tpu.models.distributions`: the same
target distributions, sampled directly with a ``torch.Generator`` through
inverse-CDF truncated normals (``torch.special.ndtr`` / ``ndtri``). The
random bits cannot agree with ``jax.random``'s, so the two packages agree in
distribution, not sample by sample.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

__all__ = ["TwoStream", "BumpOnTail", "Maxwellian", "make_distribution", "sample_initial_state"]

V_WINDOW = 10.0  # proposal window [-10, 10] of the reference's rejection sampler


def _uniform(gen: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, dtype=torch.float32, device=device)


def _truncated_normal(gen, n, mean, sigma, lo, hi, device, dtype=torch.float32):
    """Inverse-CDF sampling of N(mean, sigma^2) truncated to [lo, hi]."""
    a = torch.tensor((lo - mean) / sigma, dtype=torch.float32, device=device)
    b = torch.tensor((hi - mean) / sigma, dtype=torch.float32, device=device)
    u = _uniform(gen, n, device)
    fa, fb = torch.special.ndtr(a), torch.special.ndtr(b)
    z = torch.special.ndtri(fa + u * (fb - fa))
    return (mean + sigma * torch.clamp(z, a, b)).to(dtype)


@dataclasses.dataclass(frozen=True)
class TwoStream:
    """Two counter-streaming beams at +/- v0; the first half of the particles
    is the +v0 beam, the second half the -v0 beam."""

    v0: float = 4.0
    sigma: float = 0.5
    n_samples: int = 40000
    length: float = 50.0

    def sample(self, gen, device, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        n1 = self.n_samples // 2
        n2 = self.n_samples - n1
        x = (_uniform(gen, self.n_samples, device) * self.length).to(dtype)
        v_plus = _truncated_normal(gen, n1, self.v0, self.sigma, -V_WINDOW, V_WINDOW, device, dtype)
        v_minus = _truncated_normal(gen, n2, -self.v0, self.sigma, -V_WINDOW, V_WINDOW, device, dtype)
        return x, torch.cat([v_plus, v_minus])

    def high_indices(self) -> torch.Tensor:
        """No beam of its own: empty."""
        return torch.arange(0)


@dataclasses.dataclass(frozen=True)
class BumpOnTail:
    """Maxwellian background (fraction 1/(1+a), N(0, 1)) plus a fast beam
    N(v0, sigma) at indices [N1, N)."""

    a: float = 0.3
    v0: float = 4.0
    sigma: float = 0.5
    n_samples: int = 40000
    length: float = 10.0

    @property
    def n_background(self) -> int:
        return int(self.n_samples * (1.0 / (1.0 + self.a)))

    def sample(self, gen, device, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        n1 = self.n_background
        n2 = self.n_samples - n1
        x = (_uniform(gen, self.n_samples, device) * self.length).to(dtype)
        v_bg = _truncated_normal(gen, n1, 0.0, 1.0, -V_WINDOW, V_WINDOW, device, dtype)
        v_beam = _truncated_normal(gen, n2, self.v0, self.sigma, -V_WINDOW, V_WINDOW, device, dtype)
        return x, torch.cat([v_bg, v_beam])

    def high_indices(self) -> torch.Tensor:
        """Indices of the beam ('high energy') particles, [N1, N)."""
        return torch.arange(self.n_background, self.n_samples)


@dataclasses.dataclass(frozen=True)
class Maxwellian:
    """Thermal Maxwellian with the density perturbation n0 (1 + A cos(k x));
    positions by the exact inverse CDF (6 Newton iterations)."""

    vth: float = 1.0
    amplitude: float = 0.1  # A
    mode: int = 1  # k = 2 pi mode / L
    n_samples: int = 40000
    length: float = 50.0

    def sample(self, gen, device, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        k = 2.0 * math.pi * self.mode / self.length
        a_over_k = self.amplitude / k
        u = _uniform(gen, self.n_samples, device) * self.length
        x = u
        for _ in range(6):
            x = x - (x + a_over_k * torch.sin(k * x) - u) / (1.0 + self.amplitude * torch.cos(k * x))
        x = torch.remainder(x, self.length).to(dtype)
        v = _truncated_normal(gen, self.n_samples, 0.0, self.vth, -V_WINDOW, V_WINDOW, device, dtype)
        return x, v

    def high_indices(self) -> torch.Tensor:
        """No beam: empty."""
        return torch.arange(0)


def make_distribution(cfg):
    """Distribution from a :class:`SimConfig`."""
    if cfg.simcase == "two-stream":
        return TwoStream(v0=cfg.vb, sigma=cfg.vth, n_samples=cfg.n_particles, length=cfg.length)
    if cfg.simcase == "bump-on-tail":
        return BumpOnTail(a=cfg.bump_a, v0=cfg.vb, sigma=cfg.vth, n_samples=cfg.n_particles, length=cfg.length)
    if cfg.simcase == "landau":
        return Maxwellian(
            vth=cfg.vth, amplitude=cfg.perturb_amplitude, mode=cfg.perturb_mode,
            n_samples=cfg.n_particles, length=cfg.length,
        )
    raise ValueError(f"unknown simcase {cfg.simcase}")


def sample_initial_state(cfg, gen: torch.Generator, device="cuda", dtype=torch.float32):
    """Sample (x, v) and apply the velocity perturbation
    ``v *= 1 + A sin(2 pi n_mode x / L)``; ``landau`` carries its perturbation
    in the positions instead."""
    x, v = make_distribution(cfg).sample(gen, device, dtype=dtype)
    if cfg.simcase != "landau":
        v = v * (1.0 + cfg.perturb_amplitude * torch.sin(2.0 * math.pi * cfg.perturb_mode * x / cfg.length))
    return x, v
