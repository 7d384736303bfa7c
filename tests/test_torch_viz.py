"""The port's plots (``plasma_control_tpu_torch.viz.plots``) on the CPU:
the re-solved field series and the E(k, t) spectrum against the JAX
module's arrays (rtol 1e-5, with an absolute floor of 1e-5 of the largest
value for entries near zero), every ``plot_*`` writing its file, and the
entry points drawing the JAX package's plot sets: ``run_mpc`` against the
files of the JAX ``run_and_save`` on the same run, a one-episode trainer
its loss and reward curves, and the data written without matplotlib."""

import os

import numpy as np
import pytest
import torch

from plasma_control_tpu.viz import plots as jplots
from plasma_control_tpu_torch import cli, run_mpc, run_ppo
from plasma_control_tpu_torch.config import SimConfig
from plasma_control_tpu_torch.io.export import load_run
from plasma_control_tpu_torch.viz import plots
from test_torch_cli import SMALL, jcli  # noqa: F401  (fixture: the JAX CLI without its cache side effect)

torch.set_num_threads(1)

L, M, N, NT = 50.0, 32, 400, 21


@pytest.fixture(scope="module")
def snapshot():
    """(2N, Nt): perturbed positions drifting at their velocities, so that
    the fields and the spectrum change over the columns."""
    rng = np.random.default_rng(5)
    x0 = rng.uniform(0.0, L, N)
    x0 = x0 + 0.8 * np.sin(2 * np.pi * 2 * x0 / L)
    v = rng.normal(0.0, 1.0, N)
    t = np.arange(NT) * 0.5
    xs = np.mod(x0[:, None] + v[:, None] * t[None], L)
    return np.concatenate([xs, np.repeat(v[:, None], NT, axis=1)]).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_e_mesh_series_matches_jax(snapshot):
    got = plots._e_mesh_series(snapshot, L, M, device="cpu")
    want = jplots._e_mesh_series(snapshot, L, M)
    assert got.shape == want.shape == (NT, M)
    _close(got, want)


def test_spectrum_matches_jax(snapshot):
    ks, spec = plots._spectrum(snapshot, L, L / M, M, device="cpu")
    jks, jspec = jplots._spectrum(snapshot, L, L / M, M)
    np.testing.assert_array_equal(ks, jks)
    assert spec.shape == jspec.shape == (M // 2, NT)
    _close(spec, jspec)


def _plot_calls(snapshot):
    """name -> (arguments before ``save_dir, filename``, arguments after)."""
    one, idx = snapshot[:, :1], np.arange(10)
    coeffs = np.linspace(-1.0, 1.0, 2 * NT).reshape(2, NT)
    field = (5.0, L, L / M, M)
    return {
        "plot_x_dist_snapshot": ((one,), (0.0, L)),
        "plot_v_dist_snapshot": ((one,), ()),
        "plot_dist_snapshot": ((one,), (0.0, L)),
        "plot_two_stream_snapshot": ((one,), (0.0, L)),
        "plot_bump_on_tail_snapshot": ((one,), (0.0, L, -10.0, 10.0, idx)),
        "plot_x_dist_evolution": ((snapshot,), (0.0, L)),
        "plot_v_dist_evolution": ((snapshot,), ()),
        "plot_dist_evolution": ((snapshot,), (0.0, L)),
        "plot_two_stream_evolution": ((snapshot,), (0.0, L)),
        "plot_bump_on_tail_evolution": ((snapshot,), (0.0, L, -10.0, 10.0, idx)),
        "plot_log_e": (field + (snapshot,), ()),
        "plot_e_k_spectrum": (field + (snapshot,), ()),
        "plot_e_k_over_time": (field + (3, snapshot), ()),
        "plot_e_k_external_over_time": ((5.0, coeffs[:1], coeffs[1:]), ()),
        "plot_loss_curve": (({"loss": np.linspace(1.0, 0.1, 5)},), ()),
        "plot_cost_over_time": ((5.0, NT, {"J": np.linspace(1.0, 2.0, NT)}), ()),
    }


PLOTS = sorted(n for n in jplots.__all__ if n.startswith("plot_"))


def test_every_plot_is_ported():
    assert sorted(n for n in plots.__all__ if n.startswith("plot_")) == PLOTS
    assert len(PLOTS) == 16


@pytest.mark.parametrize("name", PLOTS)
def test_plot_writes_its_file(name, snapshot, tmp_path):
    """Each plot saves a non-empty PDF with the JAX signature (the three
    field plots re-solve E on the ``device`` they are given)."""
    pre, post = _plot_calls(snapshot)[name]
    kw = {"device": "cpu"} if name in ("plot_log_e", "plot_e_k_spectrum",
                                        "plot_e_k_over_time") else {}
    fig, _ = getattr(plots, name)(*pre, str(tmp_path), "f.pdf", *post, **kw)
    path = tmp_path / "f.pdf"
    assert fig is not None and path.exists() and path.stat().st_size > 0


def test_run_mpc_draws_the_jax_plot_set(tmp_path, jcli):  # noqa: F811
    """run_mpc.main on the CPU draws into ``<save_plot>/<simcase>/mpc-control``
    the files the JAX package's run_and_save draws for the same run."""
    argv = SMALL + ["--simcase", "bump-on-tail", "--is_save", "--save_file",
                    str(tmp_path / "d"), "--save_plot", str(tmp_path / "p")]
    run_mpc.main(argv, device="cpu")
    got = sorted(os.listdir(tmp_path / "p" / "bump-on-tail" / "mpc-control"))
    run = load_run(str(tmp_path / "d" / "bump-on-tail" / "mpc-control" / "data.npz"))
    args = dict(save_file=str(tmp_path / "jd"), save_plot=str(tmp_path / "jp"),
                simcase="bump-on-tail", is_save=False)
    jcfg = jcli.build_sim_config(_parse(argv))
    jcli.run_and_save("mpc-control", args, jcfg, None, run["snapshot"], run["E"], run["PE"],
                      run["coeff_cos"], run["coeff_sin"], run["cost"], high_idx=np.arange(10))
    want = sorted(os.listdir(tmp_path / "jp" / "bump-on-tail" / "mpc-control"))
    assert got == want and "log_E.pdf" in got and "Ek_t_external.pdf" in got


def _parse(argv):
    return vars(cli.add_mpc_args(cli.add_control_args(cli.base_parser("t"))).parse_args(argv))


def test_trainer_draws_loss_and_reward_curves(tmp_path):
    argv = ["--num_particle", "64", "--num_mesh", "16", "--t_max", "1.0", "--max_mode", "2",
            "--optimize", "--num_episode", "1", "--capacity", "4", "--mlp_dim", "8",
            "--save_file", str(tmp_path / "d"), "--save_plot", str(tmp_path / "p")]
    run_ppo.main(argv, device="cpu")
    got = set(os.listdir(tmp_path / "p" / "two-stream" / "ppo-control"))
    assert {"loss_curve.pdf", "reward_curve.pdf", "log_E.pdf", "phase_space_evolution.pdf",
            "x_dist.pdf", "v_dist.pdf", "cost.pdf"} <= got


def test_run_and_save_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib cannot be imported the data are written, no plot is
    drawn and a line says why."""
    monkeypatch.setattr(plots, "matplotlib_available", lambda: False)
    snap = np.zeros((8, 3), np.float32)
    cli.run_and_save("t", dict(save_file=str(tmp_path / "d"), save_plot=str(tmp_path / "p"),
                               simcase="two-stream", is_save=True),
                     SimConfig(n_particles=4, n_mesh=8), None, snap, np.ones(3), np.zeros(3),
                     device="cpu")
    out = capsys.readouterr().out
    assert "not drawn: matplotlib is not installed" in out
    assert (tmp_path / "d" / "two-stream" / "t" / "data.npz").exists()
    assert not (tmp_path / "p").exists()
