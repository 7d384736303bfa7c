"""The port's public surface held to the JAX package's, name by name.

For every module that ``pkgutil.walk_packages`` finds under
``plasma_control_tpu``, the port's module of the same dotted path (the two
Pallas modules: ``ops/kernels/cic.py`` and ``ops/kernels/spectral_horizon.py``)
must (a) define every public name of the JAX module: each function or class
whose ``__module__`` is that module and whose name has no leading ``_``,
plus its ``__all__``; and (b) for each public function present in both, take
every JAX parameter name. Where the port differs by design, ``DIVERGENCES``
says how and why, one entry each, and every entry must be met by the walk.

Beside it: ``preset`` field by field against JAX's for all eight names, the
top-level ``__all__``, and the README's library-use example through the
top-level names on the CPU against the JAX package.
"""

import ast
import dataclasses
import importlib
import inspect
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plasma_control_tpu
import plasma_control_tpu.config as jcfg
import plasma_control_tpu_torch
import plasma_control_tpu_torch.config as tcfg

torch.set_num_threads(1)

JAX_ROOT, PORT_ROOT = "plasma_control_tpu", "plasma_control_tpu_torch"
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
_CLI_MODULES = (f"{JAX_ROOT}.cli", f"{JAX_ROOT}.cli_rl")

# The Pallas modules' counterparts hold the CUDA kernels' wrappers.
PALLAS_MODULES = {
    "ops.pallas": "ops.kernels",
    "ops.pallas.cic_pallas": "ops.kernels.cic",
    "ops.pallas.spectral_horizon": "ops.kernels.spectral_horizon",
}


class Divergence(NamedTuple):
    """Where the port's surface differs from the JAX package's by design.

    ``names``: JAX public name (dotted, relative to ``plasma_control_tpu``)
    -> the port's counterparts (dotted, relative to
    ``plasma_control_tpu_torch``, attributes allowed), every one of which must
    exist; () where there is none. ``params``: JAX parameter -> the port's
    parameters that stand for it, one of which must be in the port's
    signature; () where it has no counterpart. ``where``: the JAX functions
    (dotted, relative) the params apply to, ``"*"`` for every function."""

    names: dict
    params: dict
    where: tuple
    reason: str


_FLAX_STATE = ("control.rl.dagger.collect_policy_rollout", "control.rl.dagger.fit_bc",
               "control.rl.ddpg.update_policy", "control.rl.ddpg.behavior_cloning",
               "control.rl.ddpg.run_episode", "control.rl.ppo.update_policy",
               "control.rl.ppo.run_episode", "control.rl.sac.update_policy",
               "control.rl.sac.run_episode", "control.rl.networks.DDPGActor.sample",
               "control.rl.networks.PPOActorCritic.sample", "control.rl.networks.SACActor.sample",
               "control.rl.networks.SpectralActor.sample",
               "control.rl.networks.SpectralAttentionActor.sample")

DIVERGENCES = {
    "pallas": Divergence(
        names={"ops.pallas.cic_pallas.deposit_cic_pallas": ("ops.kernels.cic.deposit_cic",),
               "ops.pallas.cic_pallas.gather_cic_pallas": ("ops.kernels.cic.gather_cic",),
               "ops.pallas.spectral_horizon.fused_spectral_horizon":
                   ("ops.kernels.spectral_horizon.spectral_horizon",)},
        params={"block_n": (), "interpret": ()},
        where=("ops.pallas.cic_pallas.deposit_cic_pallas", "ops.pallas.cic_pallas.gather_cic_pallas",
               "ops.pallas.spectral_horizon.fused_spectral_horizon"),
        reason="each Pallas entry point is its CUDA kernel's wrapper; block_n and interpret "
               "are Pallas launch options"),
    "buffer": Divergence(
        names={"control.rl.buffer.buffer_init": ("control.rl.buffer.ReplayBuffer",),
               "control.rl.buffer.buffer_push": ("control.rl.buffer.ReplayBuffer.push",),
               "control.rl.buffer.buffer_sample": ("control.rl.buffer.ReplayBuffer.draw_indices",
                                                   "control.rl.buffer.ReplayBuffer.sample")},
        params={"buf": ("self",)},
        where=("control.rl.buffer.buffer_push", "control.rl.buffer.buffer_sample"),
        reason="the functional buffer's state is a ReplayBuffer on the card, written in place"),
    "keys": Divergence(
        names={},
        params={"key": ("generator", "gen", "noise", "noise_next", "noise_pi"),
                "step_keys": ("step_noise",)},
        where=("*",),
        reason="a PRNG key becomes a torch.Generator, or the draws made from one where a "
               "jitted update split it; mpc_rollout's per-step keys become its per-step noise"),
    "flax": Divergence(
        names={},
        params={"nets": (), "actor_params": ("actor",), "opt_state": ("opt",), "hp": (),
                "params": ()},
        where=_FLAX_STATE,
        reason="flax's module definitions, parameter trees and optax state become nn.Module "
               "and Adam state (the train state, or the actor and its optimizer; a network's "
               "sample reads its own weights)"),
    "fit_bc_key": Divergence(
        names={},
        params={"key": ()},
        where=("control.rl.dagger.fit_bc",),
        reason="JAX's fit_bc splits its key into per-epoch keys that its full-batch epochs "
               "never read"),
    "resume_like": Divergence(
        names={},
        params={"like_ts": ("ts",), "like_buf": ("buf",), "like_key": ("generator",),
                "like_best": ()},
        where=("io.resume.restore_train_checkpoint",),
        reason="the port's own checkpoint format restores into the live train state, buffer "
               "and generator, and carries the best actor itself"),
    "mesh_devices": Divergence(
        names={},
        params={"devices": ("device_type",)},
        where=("parallel.mesh.make_mesh",),
        reason="a DeviceMesh has one rank per device: the ranks of the process group on "
               "device_type"),
    "jax_sharding": Divergence(
        names={"parallel.mesh.Mesh": ("parallel.mesh.DeviceMesh",), "parallel.mesh.P": ()},
        params={},
        where=(),
        reason="jax.sharding's Mesh and PartitionSpec, re-exported: the port's mesh is "
               "torch's DeviceMesh and it shards by axis name"),
}


def _jax_modules() -> list:
    names = [m.name for m in pkgutil.walk_packages(plasma_control_tpu.__path__, JAX_ROOT + ".")]
    return [""] + sorted(n[len(JAX_ROOT) + 1:] for n in names)


JAX_MODULES = _jax_modules()


def _port_module_name(rel: str) -> str:
    rel = PALLAS_MODULES.get(rel, rel)
    return f"{PORT_ROOT}.{rel}" if rel else PORT_ROOT


def _resolve(path: str):
    """The port's object at a dotted path relative to the package: the
    longest importable module prefix, then attributes."""
    parts = path.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(_port_module_name(".".join(parts[:cut])))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(path)


def _import_jax(rel: str):
    """The JAX module at ``rel``, without the import-time side effect of the
    CLI modules (importing ``cli`` turns on jax's persistent compilation
    cache), as tests/test_torch_cli.py's ``jcli`` fixture does: the cache
    settings are put back, and a CLI module imported here first is dropped
    again, so the JAX package's own tests import it as they would without
    this file."""
    saved = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    fresh = [name for name in _CLI_MODULES if name not in sys.modules]
    module = importlib.import_module(f"{JAX_ROOT}.{rel}" if rel else JAX_ROOT)
    for key, value in saved.items():
        jax.config.update(key, value)
    for name in fresh:
        if sys.modules.pop(name, None) is not None:
            delattr(plasma_control_tpu, name.rsplit(".", 1)[1])
    return module


def _public_names(module) -> set:
    names = {n for n, o in vars(module).items()
             if not n.startswith("_") and callable(o)
             and getattr(o, "__module__", None) == module.__name__}
    return names | set(getattr(module, "__all__", ()))


def _params(obj) -> set:
    return set(inspect.signature(obj).parameters)


def _check_params(qual: str, jfn, targets: tuple, problems: list, used: set) -> None:
    """Every parameter of the JAX function ``jfn`` is taken by one of the
    port's ``targets``, or stands in the table for ``qual``."""
    have = set().union(*(_params(t) for t in targets))
    for p in inspect.signature(jfn).parameters:
        if p in have:
            continue
        entry = next((k for k, d in DIVERGENCES.items()
                      if p in d.params and ("*" in d.where or qual in d.where)
                      and (not d.params[p] or have & set(d.params[p]))), None)
        if entry is None:
            problems.append(f"{qual}: the port takes no parameter {p!r}")
        else:
            used.add(entry)


def _public_members(cls) -> list:
    """The public methods and properties that ``cls`` defines itself."""
    return sorted(n for n, o in vars(cls).items() if not n.startswith("_")
                  and (inspect.isfunction(o) or isinstance(o, (property, classmethod,
                                                               staticmethod))))


def _compare(rel: str) -> tuple[list, set]:
    """(problems, names of the divergences used) for one JAX module."""
    jmod = _import_jax(rel)
    pmod = importlib.import_module(_port_module_name(rel))
    problems, used = [], set()
    for name in sorted(_public_names(jmod)):
        qual = f"{rel}.{name}" if rel else name
        jobj = getattr(jmod, name)
        if hasattr(pmod, name):
            targets = (getattr(pmod, name),)
        else:
            entry = next((k for k, d in DIVERGENCES.items() if qual in d.names), None)
            if entry is None:
                problems.append(f"{qual}: missing from {pmod.__name__}")
                continue
            used.add(entry)
            try:
                targets = tuple(_resolve(p) for p in DIVERGENCES[entry].names[qual])
            except (AttributeError, ModuleNotFoundError) as err:
                problems.append(f"{qual}: its counterpart is missing ({err})")
                continue
        own = getattr(jobj, "__module__", None) == jmod.__name__
        if not own or not targets:
            continue
        if inspect.isclass(jobj) and inspect.isclass(targets[0]):
            for member in _public_members(jobj):
                if not hasattr(targets[0], member):
                    problems.append(f"{qual}.{member}: missing from the port's {name}")
                elif callable(getattr(jobj, member)):
                    _check_params(f"{qual}.{member}", getattr(jobj, member),
                                  (getattr(targets[0], member),), problems, used)
        elif callable(jobj) and not inspect.isclass(jobj):
            _check_params(qual, jobj, targets, problems, used)
    return problems, used


@pytest.mark.parametrize("rel", JAX_MODULES, ids=lambda r: r or "<package>")
def test_module_surface(rel):
    problems, _ = _compare(rel)
    assert not problems, "\n".join(problems)


def test_every_divergence_is_met():
    """No entry of the table is stale: each is needed by some difference."""
    used = set().union(*(_compare(rel)[1] for rel in JAX_MODULES))
    assert used == set(DIVERGENCES), sorted(set(DIVERGENCES) - used)


def test_walk_covers_the_package():
    assert len(JAX_MODULES) >= 50 and "ops.pallas.cic_pallas" in JAX_MODULES


def test_grid_with_dtype_matches_jax():
    """``Grid.with_dtype``, which the class walk found missing: every leaf
    cast as JAX casts it, the geometry kept."""
    from plasma_control_tpu.ops.grid import make_grid as jmake_grid
    from plasma_control_tpu_torch.ops.grid import GRID_LEAVES, make_grid

    ours = make_grid(32, 50.0, device="cpu").with_dtype(torch.bfloat16)
    ref = jmake_grid(32, 50.0).with_dtype(jnp.bfloat16)
    assert (ours.n_mesh, ours.length, ours.dx) == (ref.n_mesh, ref.length, ref.dx)
    for name in GRID_LEAVES:
        leaf = getattr(ours, name)
        assert leaf.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(getattr(ref, name), dtype=np.float32), name)


# ---------------------------------------------------------------------------
# preset and the top-level names


def _jax_preset_names() -> list:
    """The keys of the dict literal inside JAX's ``preset``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jcfg.preset)))
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    assert len(dicts) == 1
    return [k.value for k in dicts[0].keys]


PRESETS = ["wo-oc", "feedback", "ddpg", "ppo", "sac", "bench-small", "bench-host",
           "bench-multihost"]


def test_preset_names_are_the_jax_packages():
    assert _jax_preset_names() == PRESETS


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("overrides", [{}, dict(t_max=7.0, dt=0.02, deposit_method="pallas")],
                         ids=["plain", "overrides"])
def test_preset_matches_jax(name, overrides):
    ours, ref = tcfg.preset(name, **overrides), jcfg.preset(name, **overrides)
    assert isinstance(ours, tcfg.SimConfig)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.n_steps, ours.dx) == (ref.n_steps, ref.dx)


def test_preset_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        jcfg.preset("no-such-preset")
    with pytest.raises(KeyError):
        tcfg.preset("no-such-preset")


def test_top_level_all_and_objects():
    """The same names in the same order, each the very object of the port's
    counterpart of the JAX name's defining module."""
    assert plasma_control_tpu_torch.__all__ == plasma_control_tpu.__all__
    for name in plasma_control_tpu.__all__:
        jmod = getattr(plasma_control_tpu, name).__module__
        assert jmod.startswith(JAX_ROOT + "."), (name, jmod)
        port_mod = importlib.import_module(_port_module_name(jmod[len(JAX_ROOT) + 1:]))
        assert getattr(plasma_control_tpu_torch, name) is getattr(port_mod, name), name


def test_top_level_import_builds_nothing():
    """A fresh interpreter imports the package: no jax, flax or matplotlib,
    no process started (so no nvcc), no kernel library loaded."""
    code = textwrap.dedent("""
        import subprocess, sys
        started = []
        real = subprocess.Popen.__init__
        def spy(self, *a, **k):
            started.append(a[0] if a else k.get("args"))
            real(self, *a, **k)
        subprocess.Popen.__init__ = spy
        from plasma_control_tpu_torch import (ControlConfig, MPCConfig, SimConfig, preset, Grid,
            make_grid, PIC, PlasmaState, init_state, step, rollout, rollout_batch)
        from plasma_control_tpu_torch.ops.kernels import _build
        banned = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "matplotlib", "triton")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in banned or m.startswith("plasma_control_tpu."))
        assert not bad, bad
        assert not started, started
        assert _build.library.cache_info().currsize == 0
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# ---------------------------------------------------------------------------
# the README's library-use example, through the top-level names, on the CPU

N, M, KA, K, H, T = 512, 32, 3, 16, 4, 3
MPC_KW = dict(n_candidates=K, horizon=H, plan_particles=128, plan_mesh=16)


def _jax_noise(key, cfg, d):
    """The (K, H, D) unit draws JAX's plan makes from ``key``: knot noise for
    ceil(K/2) candidates, mirrored."""
    from plasma_control_tpu.control import mpc as jmpc

    eps = jmpc.knot_noise(key, (cfg.n_candidates + 1) // 2, cfg.horizon, d, cfg.n_knots)
    return np.asarray(jnp.concatenate([eps, -eps])[: cfg.n_candidates])


def test_readme_example_matches_jax():
    """The README's example at N=512, M=32, K=16, H=4 with the port's
    top-level names and device="cpu"; the port's seeded state is handed to
    the JAX package's top-level names. Uncontrolled, all cfg.n_steps = 500
    steps (dense deposit, as SimConfig's default): PE agrees to rtol 1e-3
    through step 300 (growth and the onset of saturation); beyond it fp32
    rounding grows chaotically in the saturated plasma, faster at 512
    particles than at tests/test_golden.py's 5000 (single steps ~1 % apart by
    step 450), so the last fifth is held as a statistic: its mean within that
    test's 1 % fp32-chaos bound (tests/test_golden.py:137-146). Three MPC steps, JAX's
    per-step keys handed across as the port's step_noise: PE rtol 2e-3,
    applied coefficients atol 1e-3 (tests/test_torch_mpc.py's bounds)."""
    from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
    from plasma_control_tpu.control.mpc import mpc_rollout as jmpc_rollout
    from plasma_control_tpu_torch import (ControlConfig, MPCConfig, SimConfig, init_state,
                                          make_grid, rollout)
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.mpc import mpc_rollout

    cfg = SimConfig(simcase="two-stream", n_particles=N, n_mesh=M)
    grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = rollout(state, grid, cfg)
    pe = out.field_energy.numpy()
    assert pe.shape == (cfg.n_steps + 1,) and np.isfinite(pe).all()

    jx = plasma_control_tpu
    jcfg_ = jx.SimConfig(simcase="two-stream", n_particles=N, n_mesh=M)
    jgrid = jx.make_grid(jcfg_.n_mesh, jcfg_.length)
    jstate = jx.PlasmaState(jnp.asarray(state.x.numpy()), jnp.asarray(state.v.numpy()))
    jpe = np.asarray(jx.rollout(jstate, jgrid, jcfg_).field_energy)
    np.testing.assert_allclose(pe[:301], jpe[:301], rtol=1e-3)
    tail = cfg.n_steps // 5
    np.testing.assert_allclose(pe[-tail:].mean(), jpe[-tail:].mean(), rtol=1e-2)

    ctrl, mpc = ControlConfig(max_mode=KA), MPCConfig(**MPC_KW)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device="cpu")
    jctrl, jmpc_cfg = jx.ControlConfig(max_mode=KA), jx.MPCConfig(**MPC_KW)
    keys = jax.random.split(jax.random.PRNGKey(1), T)
    jres = jmpc_rollout(jstate, jgrid, jcfg_, jctrl, jmpc_cfg,
                        jmake_actuator(jcfg_.length, jcfg_.n_mesh, KA), keys[0], step_keys=keys)
    noise = torch.tensor(np.stack([_jax_noise(k, jmpc_cfg, 2 * KA) for k in keys]))
    res = mpc_rollout(state, grid, cfg, ctrl, mpc, act, step_noise=noise)
    assert res.field_energy.shape == (T,) and torch.isfinite(res.field_energy).all()
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs), atol=1e-3)
    np.testing.assert_allclose(res.field_energy.numpy(), np.asarray(jres.field_energy),
                               rtol=2e-3)
