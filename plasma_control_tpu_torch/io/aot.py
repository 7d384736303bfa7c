"""The MPC solve and the closed-loop control step as served artifacts.

The counterpart of :mod:`plasma_control_tpu.io.aot`. The step functions are
the same: :func:`plan_step_fn`, the solve ``(x, v, mean) -> (action,
new_mean, best_cost)``, and :func:`control_step_fn`
(:func:`..control.mpc.control_step_fn`, the step
:func:`..control.mpc.mpc_rollout` loops over: solve, apply the first action,
one env step, the energies, the shifted nominal). Where JAX takes a key, a step here
takes a ``torch.Generator`` or handed-in unit draws (``noise``).

Where JAX compiles the step into one device program, the port captures it on
the card as one ``torch.cuda.CUDAGraph`` (:class:`GraphedStep`): static input
and output buffers, a few eager warm-up steps on a side stream first (they
fill the lazy caches: plan grids and actuators, kernel parameter blocks,
occupancy queries), the generator registered with the graph, and then every
call is one ``graph.replay()``, bitwise the eager step's. On the CPU the
step runs eagerly.

The two artifact kinds map onto JAX's pair:

* :func:`export_plan` / :func:`load_plan`, the **portable** artifact: a JSON
  fingerprint of the step (its kind, the ``SimConfig`` / ``ControlConfig``
  / ``MPCConfig`` fields, the pinned shapes and dtype, the torch version and
  the name of the kernel library, ``libpct_<hash of csrc/ and the nvcc
  flags>.so``). It holds no code and is safe to commit; at load the step is
  rebuilt from the repo's code and the kernels are built from its sources at
  first use, as always.
* :func:`save_compiled_plan` / :func:`load_compiled_plan`, the **compiled**
  artifact: the same fingerprint and the bytes of the built kernel library.
  Load refuses it unless its hash is the current sources' and installs the
  library into the build directory under its name, so a fresh checkout
  skips ``nvcc``. Loading it runs the code it carries: see
  :func:`load_compiled_plan`'s warning.

:func:`aot_mpc_rollout` is the host loop over any such step: it reproduces
``mpc_rollout`` from a zero nominal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import warnings
from typing import Callable, Optional

import torch

from ..config import ControlConfig, MPCConfig, SimConfig
from ..control.actuator import FourierActuator, make_actuator
from ..control.mpc import MPCOutput, closed_loop, control_step_fn, plan
from ..models.pic import PlasmaState
from ..ops.grid import Grid, make_grid
from ..utils.debug import nan_checks_enabled

__all__ = [
    "plan_step_fn",
    "plan_example_args",
    "control_step_fn",
    "GraphedStep",
    "LoadedStep",
    "export_plan",
    "load_plan",
    "save_compiled_plan",
    "install_compiled_plan",
    "load_compiled_plan",
    "check_plan",
    "aot_mpc_rollout",
]

FORMAT = "plasma_control_tpu_torch step artifact 1"
_MAGIC = b"PCTSTEP1"
# fields that set the initial state, the run's length or the reward, not the step
_NOT_STEP = {"sim": {"simcase", "t_min", "t_max", "seed", "vb", "vth", "perturb_amplitude",
                     "perturb_mode", "bump_a"},
             "control": {"alpha", "beta", "reward_n_mesh", "vmin", "vmax"},
             "mpc": set()}


def plan_step_fn(grid: Grid, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
                 actuator: FourierActuator, sigma=None) -> Callable:
    """The production solve with the configuration closed over:
    ``(x, v, mean, generator=None, noise=None) -> (action, new_mean,
    best_cost)``."""
    sigma_t = torch.as_tensor(mpc.sigma0 if sigma is None else sigma, dtype=torch.float32,
                              device=grid.e_op.device)

    def plan_step(x, v, mean, generator=None, noise=None):
        return plan(PlasmaState(x, v), mean, sigma_t, generator, grid, cfg, ctrl, mpc, actuator,
                    noise=noise)

    return plan_step


def plan_example_args(cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig, device="cuda"):
    """Example (x, v, mean) fixing the artifact's shapes and dtype."""
    n = cfg.n_particles
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return z(n), z(n), z(mpc.horizon, ctrl.n_actions)


class GraphedStep:
    """A control step captured as one CUDA graph at its first call.

    Called as the step it wraps, ``(x, v, mean, generator) -> (x', v', mean',
    action, pe, ke, ie, best)``. The first call copies its inputs into static
    buffers, runs ``WARMUP`` eager steps on a side stream (they fill every
    lazy cache and allocation outside the capture), puts the buffers and the
    generator's state back, registers the generator with the graph and
    captures one step, whose body ends by writing the new state into the
    input buffers and packing the small outputs into one buffer. Every call,
    the first included, is then one ``graph.replay()`` and one copy of the
    packed outputs; an input that is not already the static buffer is copied
    in first. The returned x', v', mean' ARE the static buffers: the next call
    overwrites them, and passing them back costs no copy. Replays draw from
    the generator as the eager steps do, so they match the eager loop
    bitwise. Handed-in ``noise`` is not captured: it raises, and so does a
    capture while :mod:`..utils.debug`'s NaN checks are on."""

    WARMUP = 3  # eager steps before the capture

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.graph = None
        self.generator = None

    def _body(self) -> torch.Tensor:
        """One step from the static buffers into them; returns the packed
        (action, pe, ke, ie, best)."""
        nx, nv, nmean, a, pe, ke, ie, best = self.step_fn(self.x, self.v, self.mean,
                                                          self.generator)
        out = torch.cat([a, torch.stack([pe, ke, ie, best]).to(a.dtype)])
        self.x.copy_(nx)
        self.v.copy_(nv)
        self.mean.copy_(nmean)
        return out

    def capture(self, x, v, mean, generator: torch.Generator) -> None:
        """Warm up and capture from these inputs (the first call does it)."""
        if not x.is_cuda or generator is None or generator.device.type != "cuda":
            raise ValueError("GraphedStep captures a CUDA step that draws from a CUDA "
                             "generator")
        if nan_checks_enabled():
            raise RuntimeError("GraphedStep cannot capture while the NaN checks are on: each "
                               "check reads a flag back to the host, which a CUDA graph cannot "
                               "hold (utils.debug.enable_nan_checks(False) first)")
        self.generator = generator
        self.x, self.v, self.mean = x.clone(), v.clone(), mean.clone()
        start = (x.clone(), v.clone(), mean.clone(), generator.get_state())

        def rewind():
            for dst, src in zip((self.x, self.v, self.mean), start[:3]):
                dst.copy_(src)
            generator.set_state(start[3])

        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self._body()
        torch.cuda.current_stream(x.device).wait_stream(side)
        rewind()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            self.out = self._body()
        rewind()

    def __call__(self, x, v, mean, generator=None, noise=None):
        if noise is not None:
            raise ValueError("the captured step draws its noise from its generator")
        if self.graph is None:
            self.capture(x, v, mean, generator)
        elif generator is not self.generator:
            raise ValueError("the captured step draws from the generator it was captured with")
        for dst, src in ((self.x, x), (self.v, v), (self.mean, mean)):
            if src is not dst:
                dst.copy_(src)
        self.graph.replay()
        out = self.out.clone()
        d = out.shape[0] - 4
        return self.x, self.v, self.mean, out[:d], out[d], out[d + 1], out[d + 2], out[d + 3]


def _fingerprint(grid: Grid, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
                 actuator: FourierActuator, kind: str) -> dict:
    from ..ops.kernels import _build

    if kind not in ("plan", "control_step"):
        raise ValueError(f"unknown artifact kind {kind!r}")
    if grid.n_mesh != cfg.n_mesh or actuator.n_mesh != cfg.n_mesh or (
            actuator.max_mode != ctrl.max_mode):
        raise ValueError("the grid and the actuator must be the configuration's")
    return {
        "format": FORMAT,
        "kind": kind,
        "sim": dataclasses.asdict(cfg),
        "control": dataclasses.asdict(ctrl),
        "mpc": dataclasses.asdict(mpc),
        "shapes": {name: list(t.shape) for name, t in
                   zip(("x", "v", "mean"), plan_example_args(cfg, ctrl, mpc, device="meta"))},
        "dtype": "float32",
        "torch": torch.__version__,
        "kernels": _build._library_path().name,
    }


class LoadedStep:
    """The step an artifact describes, rebuilt from the repo's code on
    ``device``: called as :func:`plan_step_fn` / :func:`control_step_fn`'s
    step, with shapes and dtype checked against the artifact's
    (``ValueError`` on a mismatch). On CUDA a control step runs as a
    :class:`GraphedStep`. ``fingerprint`` is the artifact's JSON."""

    def __init__(self, fingerprint: dict, device="cuda"):
        if fingerprint.get("format") != FORMAT:
            raise ValueError(f"not a step artifact of this package: {fingerprint.get('format')!r}")
        if fingerprint.get("torch") != torch.__version__:
            warnings.warn(f"the artifact was written under torch {fingerprint.get('torch')}, this "
                          f"is torch {torch.__version__}: its step is rebuilt with this torch "
                          f"and may not match the writer's bitwise", stacklevel=2)
        self.fingerprint, self.kind = fingerprint, fingerprint["kind"]
        cfg = SimConfig(**fingerprint["sim"])
        ctrl = ControlConfig(**fingerprint["control"])
        mpc = MPCConfig(**fingerprint["mpc"])
        grid = make_grid(cfg.n_mesh, cfg.length, device=device)
        actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                                 endpoint_grid=ctrl.endpoint_grid, device=device)
        build = control_step_fn if self.kind == "control_step" else plan_step_fn
        self.fn = build(grid, cfg, ctrl, mpc, actuator)
        if self.kind == "control_step" and torch.device(device).type == "cuda":
            self.fn = GraphedStep(self.fn)

    def __call__(self, x, v, mean, generator=None, noise=None):
        for name, t in (("x", x), ("v", v), ("mean", mean)):
            want = self.fingerprint["shapes"][name]
            if list(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"Shape mismatch: {name} is {t.dtype} {tuple(t.shape)}, the "
                                 f"artifact pins float32 {tuple(want)}")
        return self.fn(x, v, mean, generator, noise)


def check_plan(step: LoadedStep, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
               kind: str = "control_step") -> None:
    """Raise ``ValueError`` unless the artifact behind ``step`` is a ``kind``
    step of this configuration (every field the step reads; the initial
    state's, the run length's and the reward's may differ)."""
    fp = step.fingerprint
    if fp["kind"] != kind:
        raise ValueError(f"the artifact holds a {fp['kind']!r} step, not {kind!r}")
    for group, conf in (("sim", cfg), ("control", ctrl), ("mpc", mpc)):
        for name, value in dataclasses.asdict(conf).items():
            if name not in _NOT_STEP[group] and fp[group].get(name) != value:
                raise ValueError(f"the artifact's {group} config has {name}="
                                 f"{fp[group].get(name)!r}, the run asks for {value!r}")


def export_plan(grid: Grid, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig,
                actuator: FourierActuator, path: Optional[str] = None,
                kind: str = "plan") -> bytes:
    """The portable artifact of the solve (``kind="plan"``) or of the
    control step (``kind="control_step"``): JSON bytes, written to ``path``
    if given."""
    blob = json.dumps(_fingerprint(grid, cfg, ctrl, mpc, actuator, kind), indent=1).encode()
    if path is not None:
        _write(path, blob)
    return blob


def load_plan(blob_or_path, device="cuda") -> LoadedStep:
    """The step of an :func:`export_plan` artifact on ``device``. The kernels
    build from the repo's sources at first use, as at any first use."""
    if isinstance(blob_or_path, (bytes, bytearray)):
        blob = bytes(blob_or_path)
    else:
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    return LoadedStep(json.loads(blob), device)


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def save_compiled_plan(path: str, grid: Grid, cfg: SimConfig, ctrl: ControlConfig,
                       mpc: MPCConfig, actuator: FourierActuator, kind: str = "plan") -> None:
    """Build the kernel library now (``nvcc``, unless built) and write the
    compiled artifact: magic, the fingerprint's length and JSON, then the
    library's bytes."""
    from ..ops.kernels import _build

    blob = json.dumps(_fingerprint(grid, cfg, ctrl, mpc, actuator, kind)).encode()
    lib_path, _, _ = _build.build()
    _write(path, _MAGIC + struct.pack("<Q", len(blob)) + blob + lib_path.read_bytes())


def install_compiled_plan(path: str) -> dict:
    """Read a :func:`save_compiled_plan` artifact, refuse it (``ValueError``)
    unless its kernel library's hash is the current sources', install the
    library under its name in the build directory (a temporary name, then a
    rename) unless it is there, and return the fingerprint. Loads nothing."""
    from ..ops.kernels import _build

    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path} is not a compiled step artifact")
    start = len(_MAGIC) + 8
    (n,) = struct.unpack("<Q", data[len(_MAGIC):start])
    fingerprint = json.loads(data[start:start + n])
    lib = _build._library_path()
    if fingerprint.get("kernels") != lib.name:
        raise ValueError(f"stale artifact: its kernel library {fingerprint.get('kernels')} was "
                         f"built from other sources than this checkout's ({lib.name})")
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        tmp.write_bytes(data[start + n:])
        os.replace(tmp, lib)
    return fingerprint


def load_compiled_plan(path: str, device="cuda") -> LoadedStep:
    """The step of a :func:`save_compiled_plan` artifact on the card, its
    kernel library installed first (:func:`install_compiled_plan`), so that
    no ``nvcc`` runs. Raises if ``device`` is not a CUDA device or no card
    is present, and refuses a stale artifact.

    .. warning:: The artifact carries a compiled shared library, and the
       step loads and runs it. Only load artifacts you produced or obtained
       from a trusted source; across a trust boundary use the portable
       artifact (:func:`export_plan` / :func:`load_plan`), which holds no
       code.
    """
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("a compiled step artifact carries a CUDA kernel library: it loads "
                           "onto a CUDA device only")
    return LoadedStep(install_compiled_plan(path), device)


def aot_mpc_rollout(ctrl_step: Callable, state: PlasmaState, generator: Optional[torch.Generator],
                    n_steps: int, horizon: int, n_actions: int,
                    step_noise: Optional[torch.Tensor] = None) -> MPCOutput:
    """Closed-loop receding-horizon control as the host loop
    (:func:`..control.mpc.closed_loop`) over a control step
    (:func:`control_step_fn`, a :class:`GraphedStep` or a loaded artifact)
    from a zero nominal: per step the generator's draws, or
    ``step_noise[i]``. Reproduces ``mpc_rollout(state, ..., generator,
    n_steps)``. The final state and nominal are copies, never a graph's
    static buffers."""
    mean = torch.zeros((horizon, n_actions), dtype=torch.float32, device=state.x.device)
    out = closed_loop(ctrl_step, state, mean, generator, n_steps, step_noise)
    return out._replace(final_state=PlasmaState(out.final_state.x.clone(),
                                                out.final_state.v.clone()),
                        final_mean=out.final_mean.clone())
