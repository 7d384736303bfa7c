"""The port's MPC entry point on CPU: the CLI's configs, the objective
functionals, the reward, the cost traces and the run dump against the JAX
package, and one small run of ``plasma_control_tpu_torch.run_mpc``."""

import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import plasma_control_tpu
from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import objective as jobj
from plasma_control_tpu.control.reward import Reward as JReward
from plasma_control_tpu_torch import cli, run_mpc
from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control import objective
from plasma_control_tpu_torch.control.reward import Reward
from plasma_control_tpu_torch.io.export import build_run_dict, load_initial_state, load_run

torch.set_num_threads(1)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def jcli():
    """The JAX package's CLI module, without its import-time side effect on
    this process: importing it turns on jax's persistent compilation cache.
    The cache settings are put back as they were, and a module imported
    here first is dropped again afterwards, so the JAX package's own tests
    import it, and turn the cache on, as they would without this file."""
    saved = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    fresh = "plasma_control_tpu.cli" not in sys.modules
    import plasma_control_tpu.cli as module

    for key, value in saved.items():
        jax.config.update(key, value)
    yield module
    if fresh:
        del sys.modules["plasma_control_tpu.cli"]
        del plasma_control_tpu.cli

TWIN_FLAGS = ["--simcase", "two-stream", "--num_particle", "100000", "--num_mesh", "256",
              "--max_mode", "8", "--n_candidates", "1024", "--plan_particles", "10000",
              "--plan_mesh", "64", "--plan_correction", "twin"]
SMALL = ["--num_particle", "256", "--num_mesh", "32", "--max_mode", "2", "--n_candidates", "8",
         "--horizon", "4", "--plan_modes", "4", "--t_max", "0.5"]


def _parse(mod, argv):
    return vars(mod.add_mpc_args(mod.add_control_args(mod.base_parser("t"))).parse_args(argv))


@pytest.mark.parametrize("argv", [[], TWIN_FLAGS, ["--algo", "cem", "--plan_chunk", "64",
                                                   "--smooth_noise", "0.5", "--n_knots", "0",
                                                   "--deposit_method", "scatter",
                                                   "--cost_pe_nref", "0", "--no_antithetic"]],
                         ids=["default", "twin", "variants"])
def test_configs_match_jax(argv, jcli):
    """Same flags, defaults and choices: the parsed arguments and the three
    built configs equal the JAX package's field by field."""
    targs, jargs = _parse(cli, argv), _parse(jcli, argv)
    assert targs == jargs
    for build in ("build_sim_config", "build_control_config", "build_mpc_config"):
        t, j = getattr(cli, build)(targs), getattr(jcli, build)(jargs)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), build


def _snapshot(n=300, t=4, seed=0):
    """A (2N, T+1) snapshot of a drifting two-beam plasma: positions in
    [0, 50), velocities around +-3."""
    r = np.random.default_rng(seed)
    x = r.uniform(0, 50.0, n)
    v = r.standard_normal(n) + np.where(np.arange(n) % 2 == 0, 3.0, -3.0)
    cols = [np.concatenate([np.mod(x + 0.3 * i * v, 50.0), v * (1 + 0.05 * i)])
            for i in range(t + 1)]
    return np.stack(cols, axis=1).astype(np.float32)


def test_phase_space_histogram_edges_match_jax():
    """np.histogram2d's edges: x = L and v = vmax land in the last bin,
    samples outside the range are dropped. Counts are exact."""
    x = np.array([0.0, 49.99, 50.0, 50.01, -0.01, 25.0, 12.5], np.float32)
    v = np.array([-25.0, 24.99, 25.0, 0.0, 0.0, 25.01, -25.01], np.float32)
    got = objective.phase_space_histogram(torch.tensor(x), torch.tensor(v), 8, 50.0, -25.0, 25.0)
    ref = jobj.phase_space_histogram(jnp.asarray(x), jnp.asarray(v), 8, 50.0, -25.0, 25.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.histogram2d(x, v, bins=8,
                                                              range=[[0, 50], [-25, 25]])[0])


def test_objective_functionals_match_jax():
    """estimate_f is exact (counts times a constant, rtol 1e-6); the KL
    divergence sums fp32 logs in another order (rtol 1e-5); the field energy
    deposits 300 particles densely and solves over M=64 (rtol 1e-5)."""
    snap = _snapshot()
    s0, s1 = snap[:, 0], snap[:, 3]
    kw = (64, 50.0, -25.0, 25.0, 1.0)
    f0, f1 = (objective.estimate_f(torch.tensor(s), *kw) for s in (s0, s1))
    jf0, jf1 = (jobj.estimate_f(jnp.asarray(s), *kw) for s in (s0, s1))
    np.testing.assert_allclose(f1.numpy(), np.asarray(jf1), rtol=1e-6)
    np.testing.assert_allclose(float(objective.estimate_kl_divergence(f1, f0, 0.78, 0.78)),
                               float(jobj.estimate_kl_divergence(jf1, jf0, 0.78, 0.78)), rtol=1e-5)
    e_ext = np.linspace(-0.1, 0.1, 64, dtype=np.float32)
    for ext in (None, e_ext):
        got = objective.estimate_electric_energy(
            torch.tensor(s1), None if ext is None else torch.tensor(ext), 64, 50.0, 1.0)
        ref = jobj.estimate_electric_energy(
            jnp.asarray(s1), None if ext is None else jnp.asarray(ext), 64, 50.0, 1.0)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_reward_matches_jax():
    """Every cost and reward term of Reward from the same initial state and
    actions: fp32 sums in another order, rtol 1e-5."""
    snap = _snapshot()
    args = (32, 50.0, -25.0, 25.0, 1.0, 1.0, 1.0, 4)
    t, j = Reward(torch.tensor(snap[:, 0]), *args), JReward(jnp.asarray(snap[:, 0]), *args)
    state, action = snap[:, 2], np.array([0.3, -0.2, 0.5, 0.1], np.float32)
    ts, ta, js, ja = torch.tensor(state), torch.tensor(action), jnp.asarray(state), jnp.asarray(action)
    pairs = [(t.compute_cost(ts, ta), j.compute_cost(js, ja)),
             ((t.compute_reward(ts, ta), t.compute_reward_shaped(ts, ta),
               t.reward_fn("shaped")(ts, ta), t.compute_reward_kl_divergence(ts),
               t.compute_reward_electric_energy(ts), t.compute_reward_input_energy(ta)),
              (j.compute_reward(js, ja), j.compute_reward_shaped(js, ja),
               j.reward_fn("shaped")(js, ja), j.compute_reward_kl_divergence(js),
               j.compute_reward_electric_energy(js), j.compute_reward_input_energy(ja)))]
    for got, ref in pairs:
        np.testing.assert_allclose([float(a) for a in got], [float(b) for b in ref], rtol=1e-5)
    assert (t.r_ie_n, t.r_pe_n) == (j.r_ie_n, j.r_pe_n)
    with pytest.raises(ValueError):
        t.reward_fn("other")


def test_cost_traces_match_jax(jcli):
    """J_KL, J_ee and J_ie over the T post-step columns of one snapshot, the
    port one state at a time, JAX vmapped: rtol 1e-5."""
    snap = _snapshot(t=5)
    kw = dict(simcase="two-stream", n_particles=300, n_mesh=32)
    coeffs = (0.3 * np.random.default_rng(1).standard_normal((5, 4))).astype(np.float32)
    got = cli.compute_cost_traces(snap, SimConfig(**kw), ControlConfig(reward_n_mesh=32),
                                  coeffs=coeffs, device="cpu")
    ref = jcli.compute_cost_traces(snap, JSimConfig(**kw), JControlConfig(reward_n_mesh=32),
                                   coeffs=coeffs)
    assert got.keys() == ref.keys() == {r"$J_{KL}$", r"$J_{ee}$", r"$J_{ie}$"}
    for key in ref:
        assert got[key].shape == (5,)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)


def test_run_dict_and_dumps_round_trip(tmp_path):
    """build_run_dict has the reference's keys and shapes; the .npz and .mat
    dumps load back, and load_initial_state reads the first column."""
    snap = _snapshot(n=50, t=3)
    cfg = SimConfig(n_particles=50, n_mesh=16)
    costs = {"J": np.arange(3.0)}
    mdic = build_run_dict(cfg, snap, np.ones(4), np.zeros(4), np.ones((2, 3)), np.zeros((2, 3)),
                          costs)
    assert set(mdic) == {"snapshot", "E", "PE", "N", "N_mesh", "n0", "L", "dt", "tmin", "tmax",
                         "n_mode", "A", "vth", "vb", "a", "coeff_cos", "coeff_sin", "cost"}
    assert mdic["snapshot"].shape == (100, 4) and mdic["N"] == 50
    cli.run_and_save("t", dict(save_file=str(tmp_path / "d"), save_plot=str(tmp_path / "p"),
                               simcase="two-stream", is_save=True),
                     cfg, None, snap, np.ones(4), np.zeros(4), np.ones((2, 3)), np.zeros((2, 3)),
                     costs)
    base = tmp_path / "d" / "two-stream" / "t"
    for name in ("data.npz", "data.mat"):
        run = load_run(str(base / name))
        np.testing.assert_array_equal(np.asarray(run["snapshot"]), snap)
    x, v = load_initial_state(str(base / "data.npz"))
    np.testing.assert_array_equal(x, snap[:50, 0])
    np.testing.assert_array_equal(v, snap[50:, 0])


def test_run_mpc_main_writes_a_run(tmp_path, capsys):
    """The entry point's main path at N=256, M=32, K=8, H=4, five control
    steps of the twin-corrected subsampled controller on the CPU: the dump
    holds a (2N, 6) snapshot, finite PE and cost traces and the applied
    coefficients, and the state in its first column is the seeded one."""
    argv = SMALL + ["--plan_particles", "64", "--plan_mesh", "16", "--plan_correction", "twin",
                    "--simcase", "bump-on-tail", "--is_save", "--save_file",
                    str(tmp_path / "d"), "--save_plot", str(tmp_path / "p")]
    run_mpc.main(argv, device="cpu")
    assert "saved data" in capsys.readouterr().out
    run = load_run(str(tmp_path / "d" / "bump-on-tail" / "mpc-control" / "data.npz"))
    assert run["snapshot"].shape == (512, 6) and run["coeff_cos"].shape == (2, 5)
    assert np.isfinite(run["PE"]).all() and run["PE"].shape == (6,)
    for key in (r"$J_{KL}$", r"$J_{ee}$", r"$J_{ie}$"):
        assert run["cost"][key].shape == (5,) and np.isfinite(run["cost"][key]).all()
    from plasma_control_tpu_torch.models.pic import init_state

    cfg = cli.build_sim_config(_parse(cli, argv))
    st = init_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    np.testing.assert_array_equal(run["snapshot"][:256, 0], st.x.numpy())


def _mpc_run(out, argv):
    run_mpc.main(SMALL + argv + ["--is_save", "--save_file", str(out)], device="cpu")
    return load_run(os.path.join(str(out), "two-stream", "mpc-control", "data.npz"))


def _same_run(a, b):
    for key in ("snapshot", "E", "PE", "coeff_cos", "coeff_sin"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("flags", [["--aot", "a.pkl"], ["--save_aot", "a.stablehlo"],
                                   ["--checkpoint_every", "10"], ["--checkpoint_path", "ck"],
                                   ["--no_resume"]],
                         ids=["aot", "save_aot", "resume", "checkpoint_path", "no_resume"])
def test_run_mpc_resume_and_aot_flags(flags, tmp_path, monkeypatch, capsys):
    """Each flag run to its result (JAX's semantics): ``--aot`` with
    ``--checkpoint_every`` exits before any work; ``--save_aot`` writes the
    portable artifact and exits; ``--checkpoint_every`` (segments of 2 here)
    checkpoints into the default ``checkpoints/<simcase>-mpc`` and saves the
    unsegmented run's data bitwise, and a resumed run replays the whole
    drive; a bare ``--checkpoint_path`` starts no segmented run;
    ``--no_resume`` ignores a checkpoint of a shorter run."""
    monkeypatch.chdir(tmp_path)
    if flags[0] == "--aot":
        with pytest.raises(SystemExit, match="--checkpoint_every segmented resume"):
            run_mpc.main(SMALL + flags + ["--checkpoint_every", "2", "--save_file", "out"],
                         device="cpu")
        assert not os.listdir(tmp_path)
        return
    if flags[0] == "--save_aot":
        run_mpc.main(SMALL + flags + ["--save_file", "out"], device="cpu")
        assert os.listdir(tmp_path) == ["a.stablehlo"]
        step = __import__("plasma_control_tpu_torch.io.aot", fromlist=["aot"]).load_plan(
            "a.stablehlo", device="cpu")
        assert step.kind == "control_step" and step.fingerprint["shapes"]["x"] == [256]
        return
    plain = _mpc_run(tmp_path / "plain", [])
    if flags[0] == "--checkpoint_every":
        got = _mpc_run(tmp_path / "seg", ["--checkpoint_every", "2"])
        assert os.path.exists("checkpoints/two-stream-mpc")
        _same_run(got, plain)
        # cut at step 2, then resumed: the replay takes the whole drive
        _mpc_run(tmp_path / "cut", ["--checkpoint_every", "2", "--checkpoint_path", "ck2",
                                    "--t_max", "0.2"])
        _same_run(_mpc_run(tmp_path / "res", ["--checkpoint_every", "2", "--checkpoint_path",
                                              "ck2"]), plain)
        assert "# resumed MPC from ck2 at step 2" in capsys.readouterr().out
    elif flags[0] == "--checkpoint_path":
        _same_run(_mpc_run(tmp_path / "p", flags), plain)
        assert not os.path.exists("ck")
    else:
        _mpc_run(tmp_path / "cut", ["--checkpoint_every", "2", "--t_max", "0.2"])
        _same_run(_mpc_run(tmp_path / "fresh", ["--checkpoint_every", "2"] + flags), plain)
        assert "resumed" not in capsys.readouterr().out
