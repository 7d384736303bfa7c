"""Network definitions of the RL controllers as ``nn.Module``s.

The counterpart of :mod:`plasma_control_tpu.control.rl.networks`, whose flax
modules are plain XLA code (no Pallas kernel), so plain PyTorch layers are
their port: ``nn.Linear``, ``nn.LayerNorm`` and the attention as explicit
matmuls and a softmax. Submodules keep flax's automatic names (``Dense_0``,
``LayerNorm_1``, ``_LNTrunk_0``, ``MultiHeadDotProductAttention_0``, ...) so
that :mod:`...interop` maps a flax params tree onto a ``state_dict`` name by
name. What a straight translation would get wrong, and this module keeps:

* flax ``Dense`` stores its kernel as (in, out); ``nn.Linear.weight`` is
  (out, in). The weight map transposes (:mod:`...interop`);
* flax ``LayerNorm`` uses ``epsilon=1e-6`` (torch's default is 1e-5);
* flax ``nn.gelu`` is the tanh approximation;
* the spectral encoder builds mode m by the angle-addition recurrence, in
  the JAX module's feature order, which the committed actors expect;
* fresh weights are drawn as flax draws them, from the caller's
  ``torch.Generator``: ``lecun_normal`` kernels (a normal truncated at two
  standard deviations), zero biases, unit LayerNorm scales, ``normal(0.02)``
  for ``mode_embed``.

Reference quirks the JAX module documents stay: PPO's encoder takes the raw
state (no x/v normalisation), and SAC's log-prob has no tanh Jacobian term.
The stochastic ``sample`` methods take their unit-normal draws as
``noise`` (no noise or ``deterministic=True`` gives the mean action), so a
test can hand JAX's draws across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ParticleEncoder",
    "SpectralEncoder",
    "DDPGActor",
    "SpectralActor",
    "SpectralAttentionActor",
    "DDPGCritic",
    "PPOActorCritic",
    "SACActor",
    "SACCritic",
    "MultiHeadAttention",
]

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _dense(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``Dense``: lecun-normal kernel
    (fan-in ``n_in``), zero bias; built on the generator's device without
    touching the global RNG."""
    lin = nn.utils.skip_init(nn.Linear, n_in, n_out, device=gen.device)
    std = math.sqrt(1.0 / n_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
        lin.bias.zero_()
    return lin


def _layer_norm(dim: int, gen: torch.Generator) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6, device=gen.device)


def _rescale(y: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Affine map [-1, 1] -> [lo, hi]."""
    return (0.5 + 0.5 * y) * (hi - lo) + lo


def _normalised(x: torch.Tensor, x_norm: float, v_norm: float) -> torch.Tensor:
    n = x.shape[-1] // 2
    return torch.cat([x[..., :n] / x_norm, x[..., n:] / v_norm], dim=-1)


class ParticleEncoder(nn.Module):
    """DeepSets encoder: per-particle (cos q', sin q', p) -> Dense + LayerNorm
    + ReLU -> mean over particles -> Dense + LayerNorm + ReLU. Input (..., 2N)."""

    def __init__(self, hidden_dim: int, output_dim: int, length: float = 50.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.length = length
        self.Dense_0 = _dense(3, hidden_dim, generator)
        self.LayerNorm_0 = _layer_norm(hidden_dim, generator)
        self.Dense_1 = _dense(hidden_dim, output_dim, generator)
        self.LayerNorm_1 = _layer_norm(output_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] // 2
        q, p = x[..., :n], x[..., n:]
        ang = q * (2.0 * math.pi / self.length)
        z = torch.stack([torch.cos(ang), torch.sin(ang), p], dim=-1)  # (..., N, 3)
        z = F.relu(self.LayerNorm_0(self.Dense_0(z)))
        z = torch.mean(z, dim=-2)  # permutation-invariant pool
        return F.relu(self.LayerNorm_1(self.Dense_1(z)))


class SpectralEncoder(nn.Module):
    """Per-mode phase-space moments, no parameters: for m = 1..n_modes and
    j = 0..v_order the pair (mean v^j cos(k_m x), mean v^j sin(k_m x)), then
    the bulk moments <v^j>, j = 1..v_order+1. Feature count
    2 (v_order+1) n_modes + (v_order+1); the JAX module's docstring gives the
    physics."""

    def __init__(self, n_modes: int = 8, length: float = 50.0, v_order: int = 1):
        super().__init__()
        self.n_modes, self.length, self.v_order = n_modes, length, v_order

    @property
    def n_features(self) -> int:
        return 2 * (self.v_order + 1) * self.n_modes + self.v_order + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] // 2
        q, p = x[..., :n], x[..., n:]
        ang = q * (2.0 * math.pi / self.length)
        c1, s1 = torch.cos(ang), torch.sin(ang)
        powers = [torch.ones_like(p)]  # v^j weight planes, j = 0..v_order
        for _ in range(self.v_order):
            powers.append(powers[-1] * p)
        feats = []
        c_prev, s_prev = c1, s1
        for m in range(self.n_modes):
            if m > 0:  # angle addition: mode m+1 from mode m and mode 1
                c_prev, s_prev = c_prev * c1 - s_prev * s1, s_prev * c1 + c_prev * s1
            for w in powers:
                feats += [torch.mean(w * c_prev, dim=-1), torch.mean(w * s_prev, dim=-1)]
        bulk = p
        for _ in range(self.v_order + 1):
            feats.append(torch.mean(bulk, dim=-1))
            bulk = bulk * p
        return torch.stack(feats, dim=-1)


class _LNTrunk(nn.Module):
    """3 x (Dense + LayerNorm + ReLU)."""

    def __init__(self, in_dim: int, mlp_dim: int, *, generator: torch.Generator):
        super().__init__()
        for i in range(3):
            setattr(self, f"Dense_{i}", _dense(in_dim if i == 0 else mlp_dim, mlp_dim, generator))
            setattr(self, f"LayerNorm_{i}", _layer_norm(mlp_dim, generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            z = F.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(z)))
        return z


class _DeterministicActor(nn.Module):
    """``sample`` = the tanh output rescaled to [output_min, output_max]."""

    output_min: float
    output_max: float

    def sample(self, x: torch.Tensor) -> torch.Tensor:
        return _rescale(self(x), self.output_min, self.output_max)


class SpectralActor(_DeterministicActor):
    """Deterministic actor over :class:`SpectralEncoder` features, the DAgger
    distillation target: features -> 3 x (Dense + LayerNorm + ReLU) ->
    Dense, tanh."""

    def __init__(self, mlp_dim: int, n_actions: int, n_modes: int = 8, output_min: float = -1.0,
                 output_max: float = 1.0, length: float = 50.0, v_order: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.output_min, self.output_max = output_min, output_max
        self.SpectralEncoder_0 = SpectralEncoder(n_modes, length, v_order)
        self._LNTrunk_0 = _LNTrunk(self.SpectralEncoder_0.n_features, mlp_dim, generator=generator)
        self.Dense_0 = _dense(mlp_dim, n_actions, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.Dense_0(self._LNTrunk_0(self.SpectralEncoder_0(x))))


class MultiHeadAttention(nn.Module):
    """Self-attention with flax ``MultiHeadDotProductAttention``'s arithmetic
    (``qkv_features = out_features = d``): per-head query, key and value
    projections, the query scaled by 1/sqrt(head_dim), a softmax over the
    keys, and the heads' outputs projected back to d. The four projections
    are ``nn.Linear``s over the flattened (heads, head_dim) axis, the layout
    the weight map reshapes flax's (d, heads, head_dim) kernels into."""

    def __init__(self, d_model: int, n_heads: int, *, generator: torch.Generator):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of n_heads={n_heads}")
        self.n_heads = n_heads
        self.query = _dense(d_model, d_model, generator)
        self.key = _dense(d_model, d_model, generator)
        self.value = _dense(d_model, d_model, generator)
        self.out = _dense(d_model, d_model, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        split = lambda t: t.unflatten(-1, (self.n_heads, -1))  # (..., L, heads, head_dim)
        q, k, v = split(self.query(h)), split(self.key(h)), split(self.value(h))
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v).flatten(-2))


class SpectralAttentionActor(_DeterministicActor):
    """Mode-token transformer actor: one token per Fourier mode carrying its
    :class:`SpectralEncoder` moments plus a learned per-mode embedding, one
    global token of the bulk moments, ``n_layers`` pre-LN self-attention
    blocks, and per-mode (cos, sin) heads for the actuated modes (packed
    [cos(1..K), sin(1..K)]), tanh. The JAX module's docstring gives the
    design."""

    def __init__(self, mlp_dim: int, n_actions: int, n_modes: int = 8, output_min: float = -1.0,
                 output_max: float = 1.0, length: float = 50.0, v_order: int = 1,
                 d_model: int = 64, n_heads: int = 4, n_layers: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        if n_actions // 2 > n_modes:
            # one token per actuated mode: a short token list would hand the
            # top mode's head the bulk token or emit a short action vector
            raise ValueError(
                f"SpectralAttentionActor needs n_modes >= n_actions/2 (one token per actuated "
                f"mode); got n_modes={n_modes}, n_actions={n_actions}"
            )
        self.output_min, self.output_max = output_min, output_max
        self.n_modes, self.n_layers, self.k_act = n_modes, n_layers, n_actions // 2
        self.per_mode = 2 * (v_order + 1)
        gen = generator
        self.SpectralEncoder_0 = SpectralEncoder(n_modes, length, v_order)
        # registered in the order flax creates the parameters
        self.Dense_0 = _dense(self.per_mode, d_model, gen)
        self.mode_embed = nn.Parameter(
            torch.randn((n_modes, d_model), generator=gen, device=gen.device) * 0.02)
        self.Dense_1 = _dense(v_order + 1, d_model, gen)
        for i in range(n_layers):
            setattr(self, f"LayerNorm_{2 * i}", _layer_norm(d_model, gen))
            setattr(self, f"MultiHeadDotProductAttention_{i}",
                    MultiHeadAttention(d_model, n_heads, generator=gen))
            setattr(self, f"LayerNorm_{2 * i + 1}", _layer_norm(d_model, gen))
            # flax names the outer Dense first: Dense_{2+2i} is (2d -> d)
            setattr(self, f"Dense_{3 + 2 * i}", _dense(d_model, 2 * d_model, gen))
            setattr(self, f"Dense_{2 + 2 * i}", _dense(2 * d_model, d_model, gen))
        setattr(self, f"LayerNorm_{2 * n_layers}", _layer_norm(d_model, gen))
        setattr(self, f"Dense_{2 + 2 * n_layers}", _dense(d_model, mlp_dim, gen))
        setattr(self, f"Dense_{3 + 2 * n_layers}", _dense(mlp_dim, 2, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sub = lambda name: getattr(self, name)
        feats = self.SpectralEncoder_0(x)
        n_tok = self.n_modes * self.per_mode
        mode_feats = feats[..., :n_tok].unflatten(-1, (self.n_modes, self.per_mode))
        tok = self.Dense_0(mode_feats) + self.mode_embed  # (..., M, d)
        g = self.Dense_1(feats[..., n_tok:])[..., None, :]  # global bulk token
        z = torch.cat([tok, g], dim=-2)  # (..., M+1, d)
        for i in range(self.n_layers):
            h = sub(f"LayerNorm_{2 * i}")(z)
            z = z + sub(f"MultiHeadDotProductAttention_{i}")(h)
            h = sub(f"LayerNorm_{2 * i + 1}")(z)
            inner = F.gelu(sub(f"Dense_{3 + 2 * i}")(h), approximate="tanh")
            z = z + sub(f"Dense_{2 + 2 * i}")(inner)
        z = sub(f"LayerNorm_{2 * self.n_layers}")(z)
        zh = F.relu(sub(f"Dense_{2 + 2 * self.n_layers}")(z[..., : self.k_act, :]))
        pair = sub(f"Dense_{3 + 2 * self.n_layers}")(zh)  # (..., k_act, 2)
        return torch.tanh(torch.cat([pair[..., 0], pair[..., 1]], dim=-1))


class DDPGActor(_DeterministicActor):
    """Deterministic actor: state (..., 2N), positions over ``x_norm`` and
    velocities over ``v_norm`` -> :class:`ParticleEncoder` -> trunk -> Dense,
    tanh."""

    def __init__(self, mlp_dim: int, n_actions: int, output_min: float = -1.0,
                 output_max: float = 1.0, x_norm: float = 1.0, v_norm: float = 10.0,
                 length: float = 50.0, *, generator: torch.Generator):
        super().__init__()
        self.output_min, self.output_max = output_min, output_max
        self.x_norm, self.v_norm = x_norm, v_norm
        self.ParticleEncoder_0 = ParticleEncoder(mlp_dim, mlp_dim, length, generator=generator)
        self._LNTrunk_0 = _LNTrunk(mlp_dim, mlp_dim, generator=generator)
        self.Dense_0 = _dense(mlp_dim, n_actions, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.ParticleEncoder_0(_normalised(x, self.x_norm, self.v_norm))
        return torch.tanh(self.Dense_0(self._LNTrunk_0(z)))


class DDPGCritic(nn.Module):
    """Q(s, a): the encoded state concatenated with the action -> trunk ->
    Dense(1)."""

    def __init__(self, mlp_dim: int, n_actions: int, x_norm: float = 1.0, v_norm: float = 10.0,
                 length: float = 50.0, *, generator: torch.Generator):
        super().__init__()
        self.x_norm, self.v_norm = x_norm, v_norm
        self.ParticleEncoder_0 = ParticleEncoder(mlp_dim, mlp_dim, length, generator=generator)
        self._LNTrunk_0 = _LNTrunk(mlp_dim + n_actions, mlp_dim, generator=generator)
        self.Dense_0 = _dense(mlp_dim, 1, generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        z = self.ParticleEncoder_0(_normalised(x, self.x_norm, self.v_norm))
        return self.Dense_0(self._LNTrunk_0(torch.cat([z, a], dim=-1)))


class PPOActorCritic(nn.Module):
    """Shared-trunk Gaussian policy with a learned global ``log_std`` and a
    value head. The encoder takes the raw state, as in the reference."""

    def __init__(self, mlp_dim: int, n_actions: int, std_init: float = 0.25,
                 output_min: float = -1.0, output_max: float = 1.0, length: float = 50.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.output_min, self.output_max = output_min, output_max
        self.ParticleEncoder_0 = ParticleEncoder(mlp_dim, mlp_dim, length, generator=generator)
        self._LNTrunk_0 = _LNTrunk(mlp_dim, mlp_dim, generator=generator)
        self.Dense_0 = _dense(mlp_dim, n_actions, generator)
        self.Dense_1 = _dense(mlp_dim, 1, generator)
        log_std = torch.log(torch.tensor(std_init, dtype=torch.float32, device=generator.device))
        self.log_std = nn.Parameter(log_std.expand(n_actions).clone())

    def forward(self, x: torch.Tensor):
        """(mu, std, value)."""
        z = self._LNTrunk_0(self.ParticleEncoder_0(x))
        mu = torch.tanh(self.Dense_0(z))
        return mu, torch.exp(self.log_std).expand(mu.shape), self.Dense_1(z)

    def sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               deterministic: bool = False):
        """(action, entropy, log_prob, value); ``noise`` is the unit-normal
        draw shaped like the action."""
        mu, std, value = self(x)
        y = mu if deterministic or noise is None else mu + std * noise
        action = _rescale(y, self.output_min, self.output_max)
        log_prob = torch.sum(-0.5 * ((y - mu) / std) ** 2 - torch.log(std) - _HALF_LOG_2PI,
                             dim=-1, keepdim=True)
        entropy = torch.mean(0.5 + _HALF_LOG_2PI + torch.log(std))
        return action, entropy, log_prob, value


class SACActor(nn.Module):
    """Gaussian actor with tanh squash over the raw 2N state: 3 x (LayerNorm
    -> Dense -> tanh), then clamped mu and log_std heads."""

    def __init__(self, state_dim: int, mlp_dim: int, n_actions: int, mu_min: float = -10.0,
                 mu_max: float = 10.0, log_std_min: float = -2.0, log_std_max: float = 2.0,
                 output_min: float = -1.0, output_max: float = 1.0, x_norm: float = 50.0,
                 v_norm: float = 10.0, *, generator: torch.Generator):
        super().__init__()
        self.mu_min, self.mu_max = mu_min, mu_max
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.output_min, self.output_max = output_min, output_max
        self.x_norm, self.v_norm = x_norm, v_norm
        for i in range(3):
            dim = state_dim if i == 0 else mlp_dim
            setattr(self, f"LayerNorm_{i}", _layer_norm(dim, generator))
            setattr(self, f"Dense_{i}", _dense(dim, mlp_dim, generator))
        self.Dense_3 = _dense(mlp_dim, n_actions, generator)
        self.Dense_4 = _dense(mlp_dim, n_actions, generator)

    def forward(self, x: torch.Tensor):
        """(mu, log_std)."""
        z = _normalised(x, self.x_norm, self.v_norm)
        for i in range(3):
            z = torch.tanh(getattr(self, f"Dense_{i}")(getattr(self, f"LayerNorm_{i}")(z)))
        mu = torch.clamp(self.Dense_3(z), self.mu_min, self.mu_max)
        return mu, torch.clamp(self.Dense_4(z), self.log_std_min, self.log_std_max)

    def sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               deterministic: bool = False):
        """(action, entropy, log_prob); no tanh Jacobian in the log-prob, as in
        the reference."""
        mu, log_std = self(x)
        std = torch.exp(log_std)
        xs = mu if deterministic or noise is None else mu + std * noise
        action = _rescale(torch.tanh(xs), self.output_min, self.output_max)
        log_prob = torch.sum(-0.5 * ((xs - mu) / std) ** 2 - log_std - _HALF_LOG_2PI,
                             dim=-1, keepdim=True)
        entropy = torch.mean(0.5 + _HALF_LOG_2PI + log_std)
        return action, entropy, log_prob


class _SACQNetwork(nn.Module):
    def __init__(self, in_dim: int, mlp_dim: int, x_norm: float = 50.0, v_norm: float = 10.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.x_norm, self.v_norm = x_norm, v_norm
        for i in range(3):
            dim = in_dim if i == 0 else mlp_dim
            setattr(self, f"LayerNorm_{i}", _layer_norm(dim, generator))
            setattr(self, f"Dense_{i}", _dense(dim, mlp_dim, generator))
        self.Dense_3 = _dense(mlp_dim, 1, generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        z = torch.cat([_normalised(x, self.x_norm, self.v_norm), a], dim=-1)
        for i in range(3):
            z = torch.tanh(getattr(self, f"Dense_{i}")(getattr(self, f"LayerNorm_{i}")(z)))
        return self.Dense_3(z)


class SACCritic(nn.Module):
    """Twin Q networks: (q1, q2)."""

    def __init__(self, state_dim: int, n_actions: int, mlp_dim: int, x_norm: float = 50.0,
                 v_norm: float = 10.0, *, generator: torch.Generator):
        super().__init__()
        for i in range(2):
            setattr(self, f"_SACQNetwork_{i}",
                    _SACQNetwork(state_dim + n_actions, mlp_dim, x_norm, v_norm, generator=generator))

    def forward(self, x: torch.Tensor, a: torch.Tensor):
        return self._SACQNetwork_0(x, a), self._SACQNetwork_1(x, a)
