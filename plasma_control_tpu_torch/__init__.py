"""plasma_control_tpu_torch — the PyTorch/CUDA port of ``plasma_control_tpu``.

Runs one receding-horizon MPC control loop on the 1D electrostatic PIC
plasma on an NVIDIA Hopper GPU. Plain tensor code is PyTorch; the three
hand-written kernels of the control step (the spectral planner's whole
horizon, the CIC deposit and the CIC gather) are CUDA C++ under ``csrc/``,
compiled with ``nvcc`` at first use (:mod:`.ops.kernels._build`). On CPU
tensors every kernel wrapper runs its plain PyTorch version instead.

The package imports torch and numpy only, never jax: the JAX package stays
the reference, and the tests hold the two against each other.
"""

import torch

from .config import ControlConfig, MPCConfig, SimConfig

# The circulant field solve runs in full fp32, as in the JAX package: no TF32
# for cuBLAS matmuls (PyTorch's default, set here once so that it holds).
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["ControlConfig", "MPCConfig", "SimConfig"]
