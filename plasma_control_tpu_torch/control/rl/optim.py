"""Adam with optax's arithmetic, and the losses the trainers share.

The JAX trainers step with ``optax.chain(optax.clip_by_global_norm(c),
optax.adam(lr))`` (SAC's temperature and MPC gradient refinement with a bare
``optax.adam(lr)``). ``torch.optim.Adam`` does not compute the same numbers:
it folds the bias corrections into the step size and adds ``eps`` to
sqrt(nu) / sqrt(1 - b2^t) rather than to sqrt(nu_hat), and
``clip_grad_norm_`` adds 1e-6 to the norm where optax does not. :class:`Adam`
writes optax's few lines out: the global-norm clip (unchanged below the
bound, ``g / |g| * c`` at or above it), the moment updates
``(1 - b) g + b m``, the bias corrections ``1 - b^t`` in float32, and
``p + (-lr) * m_hat / (sqrt(nu_hat) + eps)``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

__all__ = ["Adam", "grads_of", "huber", "polyak"]


class Adam:
    """Adam over a fixed list of tensors (a network's parameters, or a leaf
    tensor such as MPC's nominal), with an optional global-norm clip in
    front, as ``optax.chain(clip_by_global_norm(max_norm), adam(lr))``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, max_norm: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Advance the moments by one step and return the updates (added to
        the parameters by :meth:`step`)."""
        grads = list(grads)
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in grads]
        self.count += 1
        one = torch.ones((), dtype=torch.float32, device=grads[0].device)
        bc1 = 1 - (one * self.b1) ** self.count
        bc2 = 1 - (one * self.b2) ** self.count
        out = []
        for g, m, v in zip(grads, self.mu, self.nu):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            out.append(-self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
        return out

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u)

    def state_dict(self) -> dict:
        """The moments (the tensors themselves, not copies) and the step
        count."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into the moments in place."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError(f"Adam state of {len(state['mu'])} moments, expected {len(self.mu)}")
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"Adam moment {tuple(src.shape)}, expected {tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(state["count"])


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach (as
    ``jax.grad`` returns them)."""
    gs = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise ``optax.losses.huber_loss``."""
    abs_err = torch.abs(pred - target)
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad**2 + delta * (abs_err - quad)


@torch.no_grad()
def polyak(target: torch.nn.Module, source: torch.nn.Module, tau: float) -> None:
    """``optax.incremental_update(source, target, tau)`` in place:
    ``target = tau * source + (1 - tau) * target``."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(tau * s + (1.0 - tau) * t)
