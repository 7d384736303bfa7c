"""Device-resident replay buffer.

The counterpart of :mod:`plasma_control_tpu.control.rl.buffer`: preallocated
(capacity, ...) tensors on the device with a ring pointer, so a transition
never leaves the card. The pointer and the filled count are host integers
(the trainers' loops know them without reading the device). Sampling is
uniform over the filled region, with replacement; :meth:`draw_indices`
draws the indices from a ``torch.Generator`` and :meth:`sample` takes any
indices, so a test can hand JAX's ``randint`` draws across.
:meth:`ReplayBuffer.state_dict` holds only the filled rows (a full DDPG
buffer is 8 GB on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    """Ring storage of (s, a, s', r, done, a_bc) transitions."""

    def __init__(self, capacity: int, state_dim: int, action_dim: int, device="cuda",
                 dtype=torch.float32):
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self.state = z(capacity, state_dim)
        self.action = z(capacity, action_dim)
        self.next_state = z(capacity, state_dim)
        self.reward = z(capacity)
        self.done = z(capacity)
        self.action_bc = z(capacity, action_dim)
        self.capacity = capacity
        self.ptr = 0  # next write slot
        self.size = 0  # filled count

    _NAMES = ("state", "action", "next_state", "reward", "done", "action_bc")

    def fields(self):
        return (self.state, self.action, self.next_state, self.reward, self.done, self.action_bc)

    def state_dict(self) -> dict:
        """The filled rows of each field (views, not copies), the pointer and
        the filled count. Rows fill from 0 and the ring wraps only once
        full, so the filled rows are always ``[0, size)``."""
        return {"fields": {k: t[: self.size] for k, t in zip(self._NAMES, self.fields())},
                "ptr": self.ptr, "size": self.size}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in place; raises ``ValueError`` if it
        does not fit this buffer."""
        size, ptr = int(state["size"]), int(state["ptr"])
        if not (0 <= size <= self.capacity and 0 <= ptr < self.capacity):
            raise ValueError(f"replay buffer state of {size} rows at {ptr}, capacity "
                             f"{self.capacity}")
        fields = state["fields"]
        if set(fields) != set(self._NAMES):
            raise ValueError(f"replay buffer state holds {sorted(fields)}")
        for name, dst in zip(self._NAMES, self.fields()):
            src = fields[name]
            if tuple(src.shape) != (size,) + tuple(dst.shape[1:]) or src.dtype != dst.dtype:
                raise ValueError(f"replay buffer field {name}: {src.dtype} {tuple(src.shape)}, "
                                 f"expected {dst.dtype} {(size,) + tuple(dst.shape[1:])}")
        for name, dst in zip(self._NAMES, self.fields()):
            dst[:size].copy_(fields[name])
        self.ptr, self.size = ptr, size

    def push(self, state, action, next_state, reward, done, action_bc: Optional[torch.Tensor] = None):
        """Write one transition at the pointer (a missing ``action_bc`` is
        stored as zeros) and advance it around the ring."""
        i = self.ptr
        self.state[i] = state
        self.action[i] = action
        self.next_state[i] = next_state
        self.reward[i] = reward
        self.done[i] = done
        if action_bc is None:
            self.action_bc[i] = 0.0
        else:
            self.action_bc[i] = action_bc
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def draw_indices(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """(batch_size,) uniform indices into the filled region."""
        return torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                             device=self.state.device)

    def sample(self, idx: torch.Tensor):
        """(s, a, s', r, done, a_bc) at ``idx``."""
        return tuple(t[idx] for t in self.fields())
