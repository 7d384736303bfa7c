"""The learned controllers end to end on CPU: the committed two-stream DAgger
actor closed around the port's PIC step against JAX's ``policy_rollout``
from the same state; two-episode runs of every trainer and of DAgger with
both experts at a tiny size; ``main()`` of ``run_ddpg``, ``run_ppo``,
``run_sac`` and ``run_dagger`` with the JAX scripts' flags, writing data."""

import os
import re
import runpy
import sys

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.control.evaluate import policy_rollout as jpolicy_rollout
from plasma_control_tpu.control.rl.networks import SpectralActor as JSpectralActor
from plasma_control_tpu.models.pic import init_state as jinit_state
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch import run_dagger, run_ddpg, run_ppo, run_sac
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.evaluate import policy_rollout
from plasma_control_tpu_torch.control.rl import dagger, ddpg, ppo, sac
from plasma_control_tpu_torch.control.rl.networks import SpectralActor
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.io.checkpoint import load_params
from plasma_control_tpu_torch.io.export import load_run
from plasma_control_tpu_torch.models.pic import init_state
from plasma_control_tpu_torch.ops.grid import make_grid
from test_torch_cli import jcli  # noqa: F401  (fixture: the JAX CLI without its cache side effect)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTOR = os.path.join(ROOT, "artifacts", "dagger_actor_two_stream.msgpack")


def test_committed_actor_closed_loop_matches_jax():
    """20 steps at TestLearnedSuppression's configuration (two-stream,
    N=5000, M=250, max_mode 3) from JAX's seeded state: the port's CIC
    kernel path (its plain version here) against JAX's dense deposit, PE
    within 1e-4 relative at every step."""
    sim = dict(simcase="two-stream", n_particles=5000, n_mesh=250, dt=0.1, t_max=2.0)
    jcfg = JSimConfig(**sim)
    jst = jinit_state(jcfg, jax.random.PRNGKey(jcfg.seed))
    with open(ACTOR, "rb") as f:
        jparams = flax.serialization.msgpack_restore(f.read())
    jactor = JSpectralActor(64, 6)
    jout = jpolicy_rollout(jst, jmake_grid(250, 50.0), jcfg, jmake_actuator(50.0, 250, 3),
                           lambda s: jactor.sample(jparams, s[None])[0], record_snapshots=False)
    cfg = SimConfig(deposit_method="pallas", **sim)
    actor = load_params(ACTOR, like=SpectralActor(64, 6, generator=torch.Generator()))
    with torch.no_grad():
        out = policy_rollout(state_from_numpy(np.asarray(jst.x), np.asarray(jst.v), device="cpu"),
                             make_grid(250, 50.0, device="cpu"), cfg,
                             make_actuator(50.0, 250, 3, device="cpu"),
                             lambda s: actor.sample(s[None])[0], record_snapshots=False)
    assert out.field_energy.shape == (20,)
    np.testing.assert_allclose(out.field_energy.numpy(), np.asarray(jout.field_energy), rtol=1e-4)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-4)


TINY_SIM = dict(n_particles=64, n_mesh=16, dt=0.1, t_max=1.0)  # 10 steps


def _tiny():
    cfg, ctrl = SimConfig(**TINY_SIM), ControlConfig(max_mode=2, reward_n_mesh=16)
    return (cfg, ctrl, make_grid(cfg.n_mesh, cfg.length, device="cpu"),
            make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device="cpu"),
            torch.Generator().manual_seed(0))


@pytest.mark.parametrize("algo", ["ddpg", "ppo", "sac"])
def test_trainer_two_episodes(algo):
    """Two episodes with updates in each: finite histories, best params a
    flax tree of the actor, and a seeded rerun that repeats exactly."""
    cfg, ctrl, grid, act, _ = _tiny()
    mod, hp = {
        "ddpg": (ddpg, ddpg.DDPGConfig(mlp_dim=8, capacity=50, min_buffer_size=5, update_freq=2,
                                       batch_size=4, n_bc_epochs=3)),
        "ppo": (ppo, ppo.PPOConfig(mlp_dim=8, chunk_size=4)),
        "sac": (sac, sac.SACConfig(mlp_dim=8, capacity=16, batch_size=4)),
    }[algo]
    runs = [mod.train(cfg, ctrl, hp, grid, act, torch.Generator().manual_seed(0), num_episodes=2,
                      verbose=0) for _ in range(2)]
    ts, best, hist = runs[0]
    for key, trace in hist.items():
        assert trace.shape == (2,) and np.isfinite(trace).all(), key
    assert "params" in best
    for k, trace in hist.items():
        np.testing.assert_array_equal(trace, runs[1][2][k])


@pytest.mark.parametrize("expert", ["feedback", "mpc"])
def test_dagger_two_iterations(expert):
    cfg, ctrl, grid, act, gen = _tiny()
    hp = ddpg.DDPGConfig(mlp_dim=8, encoder="spectral", encoder_modes=4,
                         output_min=-1.0, output_max=1.0)
    mpc = MPCConfig(horizon=2, n_candidates=8, plan_modes=4) if expert == "mpc" else None
    actor, params, hist = dagger.dagger_train(cfg, ctrl, hp, grid, act, gen, n_iters=2,
                                              epochs_per_iter=3, verbose=False, mpc=mpc)
    assert np.isfinite(hist["bc_loss"]).all() and np.isfinite(hist["pe_tail"]).all()
    assert len(hist["pe_tail"]) == 2 and "params" in params
    states, experts, pes = dagger.collect_policy_rollout(
        actor, init_state(cfg, gen, device="cpu"), grid, act, cfg, ctrl, 3, mpc=mpc,
        generator=gen)
    assert states.shape == (3, 128) and experts.shape == (3, 4) and pes.shape == (3,)


SCRIPTS = {"ddpg": run_ddpg, "ppo": run_ppo, "sac": run_sac, "dagger": run_dagger}
TINY = ["--num_particle", "64", "--num_mesh", "16", "--t_max", "1.0", "--max_mode", "2"]
TRAIN = {
    "ddpg": ["--optimize", "--num_episode", "2", "--min_buffer_size", "5", "--batch_size", "4",
             "--capacity", "50", "--update_freq", "2", "--mlp_dim", "8"],
    "ppo": ["--optimize", "--num_episode", "2", "--capacity", "4", "--mlp_dim", "8"],
    "sac": ["--optimize", "--num_episode", "2", "--batch_size", "4", "--capacity", "16",
            "--mlp_dim", "8"],
    "dagger": ["--optimize", "--dagger_iters", "2", "--epochs_per_iter", "3", "--n_candidates",
               "8", "--horizon", "2", "--plan_modes", "4", "--mlp_dim", "8"],
}


def _flags(text):
    return set(re.findall(r"--[a-z_A-Z0-9]+", text))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_flags_match_jax_script(name, capsys, monkeypatch, jcli):  # noqa: F811
    fresh = "plasma_control_tpu.cli_rl" not in sys.modules
    monkeypatch.setattr(sys, "argv", [f"run_{name}.py", "--help"])
    with pytest.raises(SystemExit):
        runpy.run_path(os.path.join(ROOT, f"run_{name}.py"), run_name="__main__")
    want = _flags(capsys.readouterr().out)
    with pytest.raises(SystemExit):
        SCRIPTS[name].main(["--help"], device="cpu")
    assert _flags(capsys.readouterr().out) == want and "--simcase" in want
    if fresh:
        sys.modules.pop("plasma_control_tpu.cli_rl", None)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_main_trains_and_writes_a_run(name, tmp_path, capsys):
    """``--optimize`` at a tiny size: the weights in flax's layout, then the
    evaluation's data (and the training history for the RL trainers)."""
    argv = TINY + TRAIN[name] + ["--is_save", "--save_file", str(tmp_path / "d"),
                                 "--save_plot", str(tmp_path / "p")]
    actor_path = str(tmp_path / "actor.msgpack")
    if name == "dagger":
        argv += ["--actor_path", actor_path]
    SCRIPTS[name].main(argv, device="cpu")
    tag = f"{name}-control"
    run = load_run(str(tmp_path / "d" / "two-stream" / tag / "data.npz"))
    t = 20 if name == "ppo" else 10  # run_ppo's dt defaults to 0.05
    assert run["snapshot"].shape == (128, t + 1) and np.isfinite(run["PE"]).all()
    assert run["coeff_cos"].shape == run["coeff_sin"].shape == (2, t)
    if name == "dagger":
        assert "closed-loop tail field energy" in capsys.readouterr().out
        weights = [actor_path]
    else:
        assert set(run["history"]) >= {"reward"}
        assert all(h.shape == (2,) for h in run["history"].values())
        weights = [str(tmp_path / "d" / "two-stream" / tag / f"{name}_{w}.msgpack")
                   for w in ("best", "last")]
    for path in weights:
        with open(path, "rb") as f:
            assert "params" in flax.serialization.msgpack_restore(f.read())


def test_run_dagger_evaluates_the_committed_actor(tmp_path, capsys):
    """Without ``--optimize`` the default ``--actor_path`` (relative to the
    working directory, as in the JAX script) is the committed actor."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        run_dagger.main(TINY[:6] + ["--is_save", "--save_file", str(tmp_path)], device="cpu")
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "loaded actor weights: artifacts/dagger_actor_two_stream.msgpack" in out
    run = load_run(str(tmp_path / "two-stream" / "dagger-control" / "data.npz"))
    assert run["coeff_cos"].shape == (3, 10) and np.isfinite(run["PE"]).all()


@pytest.mark.parametrize("flags", [["--checkpoint_every", "10"], ["--checkpoint_path", "ck"],
                                   ["--no_resume"]], ids=["every", "path", "no_resume"])
@pytest.mark.parametrize("name", ["ddpg", "ppo", "sac"])
def test_resume_flags(name, flags, tmp_path, capsys):
    """With ``--optimize``, as in the JAX scripts: ``--checkpoint_every``
    checkpoints into ``<save_file>/<simcase>/<algo>-control/train_ckpt`` and
    a longer run resumes from it; a bare ``--checkpoint_path`` turns the
    checkpoint on at the cadence of 10 (two episodes: one save, after the
    last); ``--no_resume`` trains afresh past an existing checkpoint."""
    argv = TINY + TRAIN[name] + ["--save_file", str(tmp_path / "d")]
    tag_dir = tmp_path / "d" / "two-stream" / f"{name}-control"
    if flags[0] == "--checkpoint_every":
        SCRIPTS[name].main(argv + ["--checkpoint_every", "1"], device="cpu")
        ck = tag_dir / "train_ckpt"
        assert int(np.load(ck / "meta.npz")["ep_done"]) == 2
        SCRIPTS[name].main(argv[:argv.index("--num_episode") + 1] + ["3"]
                           + argv[argv.index("--num_episode") + 2:]
                           + ["--checkpoint_every", "1"], device="cpu")
        assert "at episode 2" in capsys.readouterr().out
        assert int(np.load(ck / "meta.npz")["ep_done"]) == 3
    elif flags[0] == "--checkpoint_path":
        ck = tmp_path / "ck"
        SCRIPTS[name].main(argv + ["--checkpoint_path", str(ck)], device="cpu")
        assert int(np.load(ck / "meta.npz")["ep_done"]) == 2
        assert not (tag_dir / "train_ckpt").exists()
        SCRIPTS[name].main(argv + ["--checkpoint_path", str(ck)], device="cpu")
        assert "at episode 2" in capsys.readouterr().out
    else:
        SCRIPTS[name].main(argv + ["--checkpoint_every", "1"], device="cpu")
        capsys.readouterr()
        SCRIPTS[name].main(argv + ["--checkpoint_every", "1"] + flags, device="cpu")
        assert "resumed" not in capsys.readouterr().out
