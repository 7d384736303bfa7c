"""Hand-over from the JAX package as numpy arrays.

On the control loop's path the "weights" are the grid operators, the
actuator basis and the particle state; no learned parameters lie on it.
These functions take them as numpy arrays (``np.asarray`` of the JAX
leaves) and copy them onto a torch device. The copy matters:
``np.asarray`` of a JAX array is a read-only view, which
``torch.from_numpy`` would alias. This module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .control.actuator import actuator_from_numpy
from .models.pic import PlasmaState
from .ops.grid import grid_from_numpy

__all__ = ["state_from_numpy", "grid_from_numpy", "actuator_from_numpy"]


def state_from_numpy(x, v, device="cuda", dtype=torch.float32) -> PlasmaState:
    """A :class:`PlasmaState` from (N,) position and velocity arrays
    (``torch.tensor`` copies them)."""
    return PlasmaState(
        x=torch.tensor(np.asarray(x), dtype=dtype, device=device),
        v=torch.tensor(np.asarray(v), dtype=dtype, device=device),
    )
