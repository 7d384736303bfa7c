"""Hand-over from the JAX package as numpy arrays.

On the control loop's path the "weights" are the grid operators, the
actuator basis and the particle state, and for the LQR controller its gain;
a drive sequence is handed across the same way. These functions take them as
numpy arrays (``np.asarray`` of the JAX leaves) and copy them onto a torch
device. The copy matters: ``np.asarray`` of a JAX array is a read-only view,
which ``torch.from_numpy`` would alias. This module never imports jax.

The learned controllers' weights cross as flax params trees of numpy arrays
(what ``flax.serialization`` writes and :mod:`.io.checkpoint` reads):
:func:`actor_params_from_numpy` maps a tree onto the ``state_dict`` of any
network of :mod:`.control.rl.networks`, whose submodules carry flax's names,
and :func:`actor_params_to_numpy` is its inverse. ``Dense`` kernels are
transposed into ``nn.Linear`` weights, ``LayerNorm`` scales become weights,
and the attention's (d, heads, head_dim) / (heads, head_dim, d) kernels
flatten into (heads*head_dim, d) / (d, heads*head_dim) weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .control.actuator import actuator_from_numpy
from .control.rl.networks import MultiHeadAttention
from .models.pic import PlasmaState
from .ops.grid import grid_from_numpy

__all__ = ["state_from_numpy", "tensor_from_numpy", "grid_from_numpy", "actuator_from_numpy",
           "actor_params_from_numpy", "actor_params_to_numpy"]


def state_from_numpy(x, v, device="cuda", dtype=torch.float32) -> PlasmaState:
    """A :class:`PlasmaState` from (N,) position and velocity arrays
    (``torch.tensor`` copies them)."""
    return PlasmaState(x=tensor_from_numpy(x, device, dtype), v=tensor_from_numpy(v, device, dtype))


def tensor_from_numpy(a, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A copy of an array (an LQR gain, a (T, 2K) drive) on ``device``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _leaf_to_tree(mod: nn.Module):
    """Flax leaves of one layer, or None for a container."""
    if isinstance(mod, nn.Linear):
        return {"kernel": _host(mod.weight.T), "bias": _host(mod.bias)}
    if isinstance(mod, nn.LayerNorm):
        return {"scale": _host(mod.weight), "bias": _host(mod.bias)}
    if isinstance(mod, MultiHeadAttention):
        h = mod.n_heads
        tree = {}
        for name in ("query", "key", "value"):
            lin = getattr(mod, name)
            tree[name] = {"kernel": _host(lin.weight.T.unflatten(1, (h, -1))),
                          "bias": _host(lin.bias.unflatten(0, (h, -1)))}
        tree["out"] = {"kernel": _host(mod.out.weight.T.unflatten(0, (h, -1))),
                       "bias": _host(mod.out.bias)}
        return tree
    return None


def _to_tree(mod: nn.Module) -> dict:
    tree = {name: _host(p) for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        sub = _leaf_to_tree(child)
        if sub is None:
            sub = _to_tree(child)
        if sub:
            tree[name] = sub
    return tree


def actor_params_to_numpy(net: nn.Module) -> dict:
    """The flax params tree ``{"params": {...}}`` of a network of
    :mod:`.control.rl.networks`, as host numpy copies: the layout
    ``flax.serialization`` reads into the JAX module of the same name."""
    return {"params": _to_tree(net)}


def _from_tree(mod: nn.Module, tree: dict, prefix: str, out: dict) -> None:
    as_tensor = lambda a: torch.tensor(np.asarray(a))
    for name, _ in mod.named_parameters(recurse=False):
        out[prefix + name] = as_tensor(tree[name])
    for name, child in mod.named_children():
        p = f"{prefix}{name}."
        if isinstance(child, nn.Linear):
            out[p + "weight"] = as_tensor(tree[name]["kernel"]).T
            out[p + "bias"] = as_tensor(tree[name]["bias"])
        elif isinstance(child, nn.LayerNorm):
            out[p + "weight"] = as_tensor(tree[name]["scale"])
            out[p + "bias"] = as_tensor(tree[name]["bias"])
        elif isinstance(child, MultiHeadAttention):
            for sub in ("query", "key", "value"):
                out[f"{p}{sub}.weight"] = as_tensor(tree[name][sub]["kernel"]).flatten(1).T
                out[f"{p}{sub}.bias"] = as_tensor(tree[name][sub]["bias"]).flatten()
            out[p + "out.weight"] = as_tensor(tree[name]["out"]["kernel"]).flatten(0, 1).T
            out[p + "out.bias"] = as_tensor(tree[name]["out"]["bias"])
        elif any(True for _ in child.parameters()):
            _from_tree(child, tree[name], p, out)


def actor_params_from_numpy(tree: dict, net: nn.Module) -> dict:
    """A ``state_dict`` for ``net`` (any network of
    :mod:`.control.rl.networks`) from a flax params tree of numpy arrays,
    with or without the top-level ``"params"`` key; load it with
    ``net.load_state_dict``, which copies it onto the network's device."""
    out: dict = {}
    _from_tree(net, tree.get("params", tree), "", out)
    return {k: v.contiguous() for k, v in out.items()}
