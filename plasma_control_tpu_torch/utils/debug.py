"""NaN checks: fail loudly at the operation that produced a NaN.

The counterpart of :mod:`plasma_control_tpu.utils.debug`, which turns on
``jax_debug_nans``. Here :func:`enable_nan_checks` pushes a
``TorchDispatchMode`` that looks at the outputs of every aten operation,
forward and backward alike (``torch.autograd.detect_anomaly`` sees only the
backward pass), and raises ``FloatingPointError`` naming the first one that
holds a NaN, as JAX does. Two differences from the JAX module:

* it reads no environment variable (the JAX module also turns the checks on
  from ``PLASMA_DEBUG_NANS``): call :func:`enable_nan_checks` or enter
  :func:`nan_checks`;
* a dispatch mode belongs to the thread that pushed it (and to the autograd
  threads of that thread's backward passes), where JAX's flag is global.

The CUDA kernels are called through ctypes, outside the dispatcher, so each
kernel wrapper calls :func:`check_kernel` on its inputs and outputs around a
launch. The inputs count too: the deposit kernel turns a NaN weight into a
zero count, so a NaN position leaves no trace in its output. Every check
reads a flag back to the host, a synchronisation, so a CUDA graph cannot be
captured while the checks are on (``io/aot.py::GraphedStep`` refuses).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["enable_nan_checks", "nan_checks", "nan_checks_enabled", "check_kernel"]

# operations whose outputs are uninitialised memory, not computed values
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided", "resize_", "set_")


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
            and bool(torch.isnan(t).any()))


class _NaNCheckMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            if any(_has_nan(t) for t in tree_leaves(out)):
                raise FloatingPointError(f"nan_checks: the output of {func} holds a NaN")
        return out


_thread = threading.local()  # .mode: the mode this thread pushed, while the checks are on


def nan_checks_enabled() -> bool:
    """Whether the checks are on in this thread."""
    return getattr(_thread, "mode", None) is not None


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the checks on or off in this thread; a no-op if already so."""
    if enable and not nan_checks_enabled():
        _thread.mode = _NaNCheckMode()
        _thread.mode.__enter__()
    elif not enable and nan_checks_enabled():
        mode, _thread.mode = _thread.mode, None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def nan_checks():
    """The checks on inside the block, and the previous state restored after
    it."""
    prev = nan_checks_enabled()
    enable_nan_checks(True)
    try:
        yield
    finally:
        enable_nan_checks(prev)


def check_kernel(name: str, inputs, outputs) -> None:
    """While the checks are on, raise ``FloatingPointError`` if a floating
    tensor among the inputs or outputs of the kernel ``name`` holds a NaN
    (``None`` entries are skipped)."""
    if not nan_checks_enabled():
        return
    for what, tensors in (("an input", inputs), ("the output", outputs)):
        if any(_has_nan(t) for t in tensors):
            raise FloatingPointError(f"nan_checks: {what} of the {name} kernel holds a NaN")
