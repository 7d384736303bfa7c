"""plasma_control_tpu_torch — the PyTorch/CUDA port of ``plasma_control_tpu``.

Optimal control of the 1D electrostatic PIC plasma (two-stream, bump-on-tail,
Landau) on an NVIDIA Hopper GPU: the uncontrolled rollout, receding-horizon
sampling MPC (spectral or grid plan model, optional gradient refinement),
phase-conjugate feedback, Hankel-DMDc + LQR and the learned controllers
(DDPG, PPO, SAC, DAgger), with their entry points (``run_*.py``), resumable
runs, the control step as a CUDA graph, the sharded planner and step on
``torch.distributed``, diagnostics and plots.

Plain tensor code is PyTorch. The seven hand-written kernels are CUDA C++
under ``csrc/``, compiled with ``nvcc`` at first use
(:mod:`.ops.kernels._build`): 1, the spectral planner's whole-horizon cost,
and 1c, its twin-corrected variant (``spectral_horizon.cu(h)``,
``spectral_horizon_trig.cu``); 2, the CIC/TSC deposit, and 3, the field
gather (``cic.cu``); 4, the fused leapfrog step, 5, the explicit KDK grid
horizon, and 6, the merged-kick grid horizon (``fused_step.cu``). On CPU
tensors every kernel wrapper runs its plain PyTorch version instead.

The top-level names are the JAX package's, each from its counterpart module
here; ``tests/test_torch_surface.py`` holds the port's public surface to the
JAX package's module by module. The package imports torch and numpy only,
never jax: the JAX package stays the reference, and the tests hold the two
against each other.
"""

import torch

from .config import ControlConfig, MPCConfig, SimConfig, preset
from .ops.grid import Grid, make_grid
from .models.pic import PIC, PlasmaState, init_state, step
from .models.rollout import rollout, rollout_batch

# The circulant field solve runs in full fp32, as in the JAX package: no TF32
# for cuBLAS matmuls (PyTorch's default, set here once so that it holds).
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "ControlConfig",
    "MPCConfig",
    "SimConfig",
    "preset",
    "Grid",
    "make_grid",
    "PIC",
    "PlasmaState",
    "init_state",
    "step",
    "rollout",
    "rollout_batch",
]
