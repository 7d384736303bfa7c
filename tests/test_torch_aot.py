"""The control-step artifacts of the port (``plasma_control_tpu_torch.io.aot``)
on CPU: a host loop over ``control_step_fn`` against ``mpc_rollout``
bitwise; the port's step and host loop against the JAX package's on JAX's
draws; the portable artifact's round trip and the compiled artifact's file
handling (its library installed under its hash, a stale one refused, no
load without a card); pinned shapes and configurations; and ``run_mpc
--save_aot`` then ``--aot`` against the plain run. The graph replay against
the eager loop needs the card (``cuda`` marker); the JAX package is imported
inside the tests that use it, so that the file also runs on a GPU machine
without jax: ``python -m pytest tests/test_torch_aot.py --noconftest -m cuda``."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from plasma_control_tpu_torch import run_mpc
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.mpc import mpc_rollout
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.io import aot
from plasma_control_tpu_torch.io.export import load_run
from plasma_control_tpu_torch.models.pic import init_state
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.ops.kernels import _build

torch.set_num_threads(1)

L, M = 50.0, 32
SIM = dict(simcase="bump-on-tail", n_particles=384, n_mesh=M, dt=0.1, t_max=0.6, length=L)
MPC_KW = dict(horizon=4, n_candidates=16, plan_modes=4, w_terminal=4.0)


def _port(device="cpu", sim=SIM, mpc_kw=MPC_KW, max_mode=2):
    cfg, ctrl, mpc = SimConfig(**sim), ControlConfig(max_mode=max_mode), MPCConfig(**mpc_kw)
    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    act = make_actuator(cfg.length, cfg.n_mesh, max_mode, device=device)
    return cfg, ctrl, mpc, grid, act


@pytest.mark.parametrize("mpc_kw", [MPC_KW, dict(MPC_KW, smooth_noise=0.5),
                                    dict(MPC_KW, algo="cem", n_elites=4)],
                         ids=["mppi-knots", "mppi-ar1", "cem"])
def test_host_loop_equals_mpc_rollout(mpc_kw):
    """Six steps of ``aot_mpc_rollout`` over ``control_step_fn`` and of
    ``mpc_rollout`` from one state and generator seed: every output bitwise
    the same (the step is the rollout's loop body)."""
    cfg, ctrl, mpc, grid, act = _port(mpc_kw=mpc_kw)
    st = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, torch.Generator().manual_seed(4))
    out = aot.aot_mpc_rollout(aot.control_step_fn(grid, cfg, ctrl, mpc, act), st,
                              torch.Generator().manual_seed(4), cfg.n_steps, mpc.horizon,
                              ctrl.n_actions)
    for name in ref._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if name == "final_state":
            assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
        else:
            assert torch.equal(a, b), name


def test_plan_step_matches_live_plan():
    from plasma_control_tpu_torch.control.mpc import plan

    cfg, ctrl, mpc, grid, act = _port()
    st = init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    mean = torch.zeros(mpc.horizon, ctrl.n_actions)
    got = aot.plan_step_fn(grid, cfg, ctrl, mpc, act)(st.x, st.v, mean,
                                                      torch.Generator().manual_seed(2))
    want = plan(st, mean, torch.tensor(mpc.sigma0), torch.Generator().manual_seed(2), grid, cfg,
                ctrl, mpc, act)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _jax_side(x, v):
    """The JAX package's (state, grid, cfg, ctrl, mpc, actuator) from numpy."""
    import jax.numpy as jnp

    from plasma_control_tpu.config import ControlConfig as JControlConfig
    from plasma_control_tpu.config import MPCConfig as JMPCConfig
    from plasma_control_tpu.config import SimConfig as JSimConfig
    from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
    from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
    from plasma_control_tpu.ops.grid import make_grid as jmake_grid

    return (JPlasmaState(jnp.asarray(x), jnp.asarray(v)), jmake_grid(M, L), JSimConfig(**SIM),
            JControlConfig(max_mode=2), JMPCConfig(**MPC_KW, plan_kernel="xla"),
            jmake_actuator(L, M, 2))


def _numpy_state(seed=3):
    r = np.random.default_rng(seed)
    x = r.uniform(0, L, SIM["n_particles"]).astype(np.float32)
    v = (r.standard_normal(SIM["n_particles"]) * 1.5).astype(np.float32)
    v[SIM["n_particles"] // 2:] += 3.0
    return x, v


def test_control_step_matches_jax():
    """One control step of each package from one numpy state on JAX's
    draws: the new state within 1e-5, the applied action atol 2e-4 and the
    nominal atol 2e-4, the energies and best cost rtol 2e-4 (the tolerances
    of ``test_torch_mpc.py``'s single solve)."""
    import jax
    import jax.numpy as jnp

    from plasma_control_tpu.io import aot as jaot
    from test_torch_mpc import _jax_noise

    x, v = _numpy_state()
    jst, jgrid, jcfg, jctrl, jmpc, jact = _jax_side(x, v)
    key = jax.random.PRNGKey(5)
    jout = jaot.control_step_fn(jgrid, jcfg, jctrl, jmpc, jact)(
        jst.x, jst.v, jnp.zeros((4, 4), jnp.float32), key)
    cfg, ctrl, mpc, grid, act = _port(mpc_kw=dict(MPC_KW, plan_kernel="xla"))
    st = state_from_numpy(x, v, device="cpu")
    tout = aot.control_step_fn(grid, cfg, ctrl, mpc, act)(
        st.x, st.v, torch.zeros(4, 4), noise=torch.tensor(_jax_noise(key, jmpc, 4)))
    for i, (t, j) in enumerate(zip(tout, jout)):
        t, j = t.numpy(), np.asarray(j)
        if i < 2:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
        elif i < 4:
            np.testing.assert_allclose(t, j, atol=2e-4)
        else:
            np.testing.assert_allclose(t, j, rtol=2e-4, atol=1e-6)


def test_host_loop_matches_jax():
    """Three control steps through ``aot_mpc_rollout`` in both packages,
    JAX's per-step keys turned into the port's ``step_noise``: PE rtol
    2e-3 and the applied coefficients atol 1e-3, as ``test_torch_mpc.py``'s
    closed loop."""
    import jax

    from plasma_control_tpu.io import aot as jaot
    from test_torch_mpc import _jax_noise

    x, v = _numpy_state(4)
    jst, jgrid, jcfg, jctrl, jmpc, jact = _jax_side(x, v)
    key = jax.random.PRNGKey(11)
    jout = jaot.aot_mpc_rollout(jaot.control_step_fn(jgrid, jcfg, jctrl, jmpc, jact), jst, key,
                                3, 4, 4)
    noise = torch.tensor(np.stack([_jax_noise(k, jmpc, 4) for k in jax.random.split(key, 3)]))
    cfg, ctrl, mpc, grid, act = _port(mpc_kw=dict(MPC_KW, plan_kernel="xla"))
    tout = aot.aot_mpc_rollout(aot.control_step_fn(grid, cfg, ctrl, mpc, act),
                               state_from_numpy(x, v, device="cpu"), None, 3, 4, 4,
                               step_noise=noise)
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-3)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=2e-3)


@pytest.mark.parametrize("kind", ["plan", "control_step"])
def test_portable_artifact_round_trip(kind, tmp_path):
    """The JSON holds the configs, the pinned shapes, the torch version and
    the kernel library's name, and no code; the loaded step on the CPU
    computes the live step's outputs bitwise."""
    cfg, ctrl, mpc, grid, act = _port()
    path = str(tmp_path / "step.json")
    blob = aot.export_plan(grid, cfg, ctrl, mpc, act, path=path, kind=kind)
    with open(path, "rb") as f:
        assert f.read() == blob
    fp = json.loads(blob)
    assert fp["kind"] == kind and fp["sim"]["n_particles"] == 384 and fp["torch"] == torch.__version__
    assert fp["shapes"] == {"x": [384], "v": [384], "mean": [4, 4]}
    assert fp["kernels"] == _build._library_path().name
    loaded = aot.load_plan(path, device="cpu")
    live = (aot.control_step_fn if kind == "control_step" else aot.plan_step_fn)(
        grid, cfg, ctrl, mpc, act)
    st = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    args = (st.x, st.v, torch.zeros(4, 4))
    got = loaded(*args, torch.Generator().manual_seed(9))
    want = live(*args, torch.Generator().manual_seed(9))
    assert len(got) == (8 if kind == "control_step" else 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _fake_build(tmp_path, monkeypatch, payload=b"\x7fELF not really a library"):
    """Point the build directory at ``tmp_path`` and stand a file in for the
    library nvcc would build (the CPU machine has no nvcc)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build._library_path()
    lib.parent.mkdir(parents=True)
    lib.write_bytes(payload)
    monkeypatch.setattr(_build, "build", lambda: (lib, 0.0, ""))
    return lib


def test_compiled_artifact_round_trip(tmp_path, monkeypatch):
    """The compiled artifact holds the fingerprint and the library's bytes;
    installing it into an empty build directory puts the library under its
    hash name (no nvcc), and the fingerprint loads as the portable one."""
    cfg, ctrl, mpc, grid, act = _port()
    lib = _fake_build(tmp_path, monkeypatch)
    path = str(tmp_path / "step.pkl")
    aot.save_compiled_plan(path, grid, cfg, ctrl, mpc, act, kind="control_step")
    lib.unlink()
    fp = aot.install_compiled_plan(path)
    assert lib.read_bytes() == b"\x7fELF not really a library"
    assert not [p for p in lib.parent.iterdir() if p.name.endswith(".tmp")]
    assert fp == json.loads(aot.export_plan(grid, cfg, ctrl, mpc, act, kind="control_step"))


def test_compiled_artifact_refuses_stale_and_needs_a_card(tmp_path, monkeypatch):
    cfg, ctrl, mpc, grid, act = _port()
    _fake_build(tmp_path, monkeypatch)
    path = str(tmp_path / "step.pkl")
    aot.save_compiled_plan(path, grid, cfg, ctrl, mpc, act, kind="control_step")
    with pytest.raises(RuntimeError, match="CUDA device only"):
        aot.load_compiled_plan(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device only"):
            aot.load_compiled_plan(path)
    # other kernel sources: another hash
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    with pytest.raises(ValueError, match="stale artifact"):
        aot.install_compiled_plan(path)
    (tmp_path / "junk.pkl").write_bytes(b"junk")
    with pytest.raises(ValueError, match="not a compiled step artifact"):
        aot.install_compiled_plan(str(tmp_path / "junk.pkl"))


def test_pinned_shapes_and_configs_raise(tmp_path):
    """A state of another N is refused by the loaded step, and an artifact
    of another configuration or kind by ``check_plan``; fields that only set
    the initial state or the run's length may differ."""
    cfg, ctrl, mpc, grid, act = _port()
    step = aot.load_plan(aot.export_plan(grid, cfg, ctrl, mpc, act, kind="control_step"),
                         device="cpu")
    x = torch.zeros(384)
    with pytest.raises(ValueError, match="Shape mismatch"):
        step(x[:-1], x[:-1], torch.zeros(4, 4), torch.Generator())
    with pytest.raises(ValueError, match="Shape mismatch"):
        step(x, x, torch.zeros(4, 4, dtype=torch.float64), torch.Generator())
    aot.check_plan(step, dataclasses.replace(cfg, t_max=9.0, seed=1), ctrl, mpc)
    with pytest.raises(ValueError, match="n_candidates"):
        aot.check_plan(step, cfg, ctrl, dataclasses.replace(mpc, n_candidates=32))
    with pytest.raises(ValueError, match="n_particles"):
        aot.check_plan(step, dataclasses.replace(cfg, n_particles=500), ctrl, mpc)
    with pytest.raises(ValueError, match="'control_step' step, not 'plan'"):
        aot.check_plan(step, cfg, ctrl, mpc, kind="plan")


def test_artifact_of_another_torch_warns():
    """An artifact written under another torch version loads with a warning
    (its step is rebuilt with this torch); one of this version loads
    silently."""
    cfg, ctrl, mpc, grid, act = _port()
    fp = json.loads(aot.export_plan(grid, cfg, ctrl, mpc, act, kind="control_step"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        aot.LoadedStep(fp, device="cpu")
    with pytest.warns(UserWarning, match="written under torch 0.0.1"):
        aot.LoadedStep(dict(fp, torch="0.0.1"), device="cpu")


FLAGS = ["--simcase", "bump-on-tail", "--num_particle", "256", "--num_mesh", "32", "--t_max",
         "0.5", "--max_mode", "2", "--n_candidates", "8", "--horizon", "4", "--plan_modes", "4"]


def test_run_mpc_save_aot_then_aot_reproduces_the_plain_run(tmp_path, capsys):
    """``--save_aot`` writes the portable artifact and exits; ``--aot`` with
    it writes the plain run's data.npz bitwise; a mismatched artifact is
    refused before any work."""
    path = str(tmp_path / "aot" / "control_step.json")
    run_mpc.main(FLAGS + ["--save_aot", path], device="cpu")
    assert "AOT control-step artifact written" in capsys.readouterr().out
    assert json.load(open(path))["kind"] == "control_step"
    runs = {}
    for name, extra in (("plain", []), ("aot", ["--aot", path])):
        out = str(tmp_path / name)
        run_mpc.main(FLAGS + extra + ["--is_save", "--save_file", out], device="cpu")
        runs[name] = load_run(os.path.join(out, "bump-on-tail", "mpc-control", "data.npz"))
    assert "control steps through the artifact" in capsys.readouterr().out
    for key in ("snapshot", "E", "PE", "coeff_cos", "coeff_sin"):
        np.testing.assert_array_equal(runs["aot"][key], runs["plain"][key], err_msg=key)
    for key in runs["plain"]["cost"]:
        np.testing.assert_array_equal(runs["aot"]["cost"][key], runs["plain"]["cost"][key])
    with pytest.raises(ValueError, match="n_candidates"):
        run_mpc.main(FLAGS[:-6] + ["--n_candidates", "16", "--horizon", "4", "--aot", path],
                     device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mpc_kw", [MPC_KW, dict(MPC_KW, smooth_noise=0.5),
                                    dict(MPC_KW, plan_particles=128, plan_correction="twin",
                                         fidelity_guard=False)],
                         ids=["knots", "ar1", "twin"])
def test_graph_replay_equals_eager(mpc_kw):
    """On the card: the captured step's replays equal the eager loop
    bitwise from one generator seed, and two replays from one state differ
    in the applied action or the best cost (the registered generator
    advances; the step is deterministic given its draws)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _port(dev, sim=dict(SIM, deposit_method="pallas"), mpc_kw=mpc_kw)
    st = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eager = aot.aot_mpc_rollout(aot.control_step_fn(grid, cfg, ctrl, mpc, act), st,
                                torch.Generator(device=dev).manual_seed(4), 6, 4, 4)
    graphed = aot.GraphedStep(aot.control_step_fn(grid, cfg, ctrl, mpc, act))
    gen = torch.Generator(device=dev).manual_seed(4)
    replay = aot.aot_mpc_rollout(graphed, st, gen, 6, 4, 4)
    for name in ("field_energy", "coeffs", "plan_cost", "final_mean"):
        assert torch.equal(getattr(eager, name), getattr(replay, name)), name
    assert torch.equal(eager.final_state.x, replay.final_state.x)
    mean0 = torch.zeros(4, 4, device=dev)
    one, two = (graphed(st.x, st.v, mean0, gen) for _ in range(2))
    assert not (torch.equal(one[3], two[3]) and torch.equal(one[7], two[7]))
