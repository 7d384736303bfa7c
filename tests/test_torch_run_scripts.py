"""The port's uncontrolled, feedback and LQR entry points on CPU, at a tiny
size: each takes its JAX script's flags, writes a run whose dict has the keys
and shapes of the JAX package's ``build_run_dict`` for that script, starts
from the seeded state, and runs the segmented-resume flags where the JAX
script has them."""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.io.export import build_run_dict as jbuild_run_dict
from plasma_control_tpu_torch import cli, run_feedback, run_lqr, run_wo_oc
from plasma_control_tpu_torch.config import SimConfig
from plasma_control_tpu_torch.io.export import load_run
from plasma_control_tpu_torch.models.pic import init_state
from test_torch_cli import jcli  # noqa: F401  (fixture: the JAX CLI without its cache side effect)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"wo_oc": (run_wo_oc, "wo-oc"), "feedback": (run_feedback, "feedback"),
           "lqr": (run_lqr, "lqr-control")}
TINY = ["--num_particle", "256", "--num_mesh", "32", "--t_max", "0.5", "--max_mode", "2"]
LQR_TINY = ["--n_excite_rollouts", "2", "--excite_steps", "20", "--n_lags", "2"]
RESUME = [["--checkpoint_every", "10"], ["--checkpoint_path", "ck"], ["--no_resume"]]


def _argv(name, tmp_path, simcase="two-stream"):
    argv = TINY + ["--simcase", simcase, "--is_save", "--save_file", str(tmp_path / "d"),
                   "--save_plot", str(tmp_path / "p")]
    if name == "wo_oc":
        argv = [a for a in argv if a not in ("--max_mode", "2")]
    return argv + (LQR_TINY if name == "lqr" else [])


def _flags(text):
    return set(re.findall(r"--[a-z_A-Z0-9]+", text))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_flags_match_jax_script(name, capsys, monkeypatch, jcli):  # noqa: F811
    """The --help of the port's entry point lists the JAX script's flags."""
    monkeypatch.setattr(sys, "argv", [f"run_{name}.py", "--help"])
    with pytest.raises(SystemExit):
        runpy.run_path(os.path.join(ROOT, f"run_{name}.py"), run_name="__main__")
    want = _flags(capsys.readouterr().out)
    with pytest.raises(SystemExit):
        SCRIPTS[name][0].main(["--help"], device="cpu")
    assert _flags(capsys.readouterr().out) == want and "--simcase" in want


@pytest.mark.parametrize("simcase", ["two-stream", "bump-on-tail"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_main_writes_a_run_with_jax_keys(name, simcase, tmp_path, capsys):
    """Five steps at N=256, M=32: the saved run has the keys of the JAX
    package's build_run_dict for the same script (coefficients for the
    controllers, J_ie with them), a (2N, T+1) snapshot whose first column is
    the seeded state, finite energies of the script's length and finite
    cost traces."""
    module, tag = SCRIPTS[name]
    argv = _argv(name, tmp_path, simcase)
    module.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "saved data" in out
    if name == "lqr":
        assert "# identified model: residual" in out
    run = load_run(str(tmp_path / "d" / simcase / tag / "data.npz"))
    controlled = name != "wo_oc"
    t, k, n = 5, 2, 256
    cost_keys = {r"$J_{KL}$", r"$J_{ee}$"} | ({r"$J_{ie}$"} if controlled else set())
    coeffs = np.zeros((k, t)) if controlled else None
    jcfg = JSimConfig(n_particles=n, n_mesh=32, t_max=0.5)
    ref = jbuild_run_dict(jcfg, np.zeros((2 * n, t + 1)), np.zeros(t), np.zeros(t), coeffs, coeffs,
                          {key: np.zeros(t) for key in cost_keys})
    assert set(run) == set(ref)
    assert set(run["cost"]) == cost_keys
    assert run["snapshot"].shape == (2 * n, t + 1)
    pe_len = t if name == "feedback" else t + 1
    assert run["PE"].shape == run["E"].shape == (pe_len,)
    assert np.isfinite(run["PE"]).all() and np.isfinite(run["E"]).all()
    for key in cost_keys:
        assert run["cost"][key].shape == (t,) and np.isfinite(run["cost"][key]).all()
    if controlled:
        assert run["coeff_cos"].shape == run["coeff_sin"].shape == (k, t)
    cfg = SimConfig(simcase=simcase, n_particles=n, n_mesh=32, t_max=0.5)  # the CLI's seed 42
    st = init_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    np.testing.assert_array_equal(run["snapshot"][:n, 0], st.x.numpy())


def test_feedback_run_holds_the_loop_traces(tmp_path):
    """run_feedback stores the loop's coefficients transposed to (K, T), as
    the JAX script stacks them, and the loop's own PE trace."""
    from plasma_control_tpu_torch.config import ControlConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.feedback import feedback_rollout
    from plasma_control_tpu_torch.ops.grid import make_grid

    argv = _argv("feedback", tmp_path)
    run_feedback.main(argv, device="cpu")
    run = load_run(str(tmp_path / "d" / "two-stream" / "feedback" / "data.npz"))
    cfg = cli.build_sim_config(vars(cli.add_control_args(cli.base_parser("t")).parse_args(argv)))
    fb = feedback_rollout(init_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu"),
                          make_grid(32, cfg.length, device="cpu"), cfg, ControlConfig(max_mode=2),
                          make_actuator(cfg.length, 32, 2, device="cpu"))
    np.testing.assert_array_equal(run["coeff_cos"], fb.coeff_cos.numpy().T)
    np.testing.assert_array_equal(run["coeff_sin"], fb.coeff_sin.numpy().T)
    np.testing.assert_array_equal(run["PE"], fb.field_energy.numpy())


@pytest.mark.parametrize("flags", RESUME, ids=["every", "path", "no_resume"])
@pytest.mark.parametrize("name", ["wo_oc", "feedback"])
def test_resume_flags(name, flags, tmp_path, monkeypatch, capsys):
    """As in the JAX scripts: ``--checkpoint_every`` (segments of 2 here)
    checkpoints into ``checkpoints/<simcase>-<tag>`` and saves the
    unsegmented run's data bitwise, and a run cut at step 2 resumes and
    saves the remaining steps; a bare ``--checkpoint_path`` starts no
    segmented run; ``--no_resume`` ignores a checkpoint of a shorter run."""
    monkeypatch.chdir(tmp_path)
    mod, tag = SCRIPTS[name]
    argv = [a for a in _argv(name, tmp_path) if a not in ("--is_save", "--save_file",
                                                          str(tmp_path / "d"))]

    def run(out, extra):
        mod.main(argv + extra + ["--is_save", "--save_file", out], device="cpu")
        return load_run(os.path.join(out, "two-stream", tag, "data.npz"))

    plain = run("plain", [])
    keys = ("snapshot", "E", "PE") + (("coeff_cos", "coeff_sin") if name == "feedback" else ())
    if flags[0] == "--checkpoint_every":
        got = run("seg", ["--checkpoint_every", "2"])
        assert os.path.exists(f"checkpoints/two-stream-{tag}")
        run("cut", ["--checkpoint_every", "2", "--checkpoint_path", "ck2", "--t_max", "0.2"])
        res = run("res", ["--checkpoint_every", "2", "--checkpoint_path", "ck2"])
        assert f"# resumed {'feedback ' if name == 'feedback' else ''}from ck2 at step 2" in \
            capsys.readouterr().out
        # steps 3-5 only; the uncontrolled PE trace starts at step 0, feedback's at 1
        np.testing.assert_array_equal(res["PE"], plain["PE"][3 if name == "wo_oc" else 2:])
        np.testing.assert_array_equal(res["snapshot"], plain["snapshot"][:, 3:])
    elif flags[0] == "--checkpoint_path":
        got = run("p", flags)
        assert not os.path.exists("ck")
    else:
        run("cut", ["--checkpoint_every", "2", "--t_max", "0.2"])
        got = run("fresh", ["--checkpoint_every", "2"] + flags)
        assert "resumed" not in capsys.readouterr().out
    for key in keys:
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)
