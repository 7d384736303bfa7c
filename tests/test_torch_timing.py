"""The port's timing harness (plasma_control_tpu_torch/utils/timing.py) on the
CPU at tiny shapes: the contracts of plasma_control_tpu/utils/timing.py (a
mean per call, a chain slope, the solves/s dict with NaN for a rate with no
positive slope, a trace written into the given directory)."""

import json
import math
import time

import pytest
import torch

from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.models.pic import init_state
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.utils.timing import (mpc_solve_rate, profile_trace, slope_time,
                                                   time_fn)

torch.set_num_threads(1)

KEYS = {"solves_per_s", "sec_per_solve_all", "wall_chain_s", "compile_s"}


def _spectral(device="cpu"):
    """A spectral solve at K=8, H=2, N=500."""
    cfg = SimConfig(simcase="bump-on-tail", n_particles=500, n_mesh=32, dt=0.1, t_max=5.0)
    ctrl = ControlConfig(max_mode=2)
    mpc = MPCConfig(n_candidates=8, horizon=2, plan_modes=4)
    state = init_state(cfg, torch.Generator().manual_seed(0), device=device)
    return (state, make_grid(cfg.n_mesh, cfg.length, device=device), cfg, ctrl, mpc,
            make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=device))


def test_time_fn_is_positive_and_finite():
    x = torch.randn(256, 256)
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    t = time_fn(fn, x, reps=4, warmup=2)
    assert math.isfinite(t) and t > 0
    assert len(calls) == 6


def test_slope_time_is_the_chain_slope():
    """Each iteration sleeps 2 ms: the slope is at least that, and each of
    the four chains (two warm-up, two timed) runs its length."""
    calls = []

    def step(carry):
        calls.append(carry)
        time.sleep(0.002)
        return carry + 1

    slope = slope_time(step, 0, r1=2, r2=12)
    assert 0.002 <= slope < 0.02
    assert len(calls) == 2 * (2 + 12)
    assert calls[:2] == [0, 1] and calls[2:14] == list(range(12))


def test_mpc_solve_rate_spectral():
    r = mpc_solve_rate(*_spectral(), r1=1, r2=4, trials=3, seed=3)
    assert set(r) == KEYS
    assert math.isfinite(r["solves_per_s"]) and r["solves_per_s"] > 0
    assert len(r["sec_per_solve_all"]) == 3
    assert r["wall_chain_s"] > 0 and r["compile_s"] > 0


def test_mpc_solve_rate_chains_warm_start_and_nan_without_a_positive_slope():
    """An injected solve that returns its nominal plus one and sleeps at the
    start of every short chain: each chain warm-starts from the last
    nominal, and the long chains take less time than the short ones, so
    every slope is negative and the rate is NaN."""
    r1, r2, trials = 2, 5, 3
    chains, lengths = [], []

    def plan_fn(state, mean, sigma, gen):
        if not mean.any():  # a chain starts from the zero nominal
            chains.append(len(chains))
            lengths.append(0)
            if chains[-1] % 2 == 0:  # chains alternate r1, r2: the short ones sleep
                time.sleep(0.05)
        lengths[-1] += 1
        assert torch.all(mean == lengths[-1] - 1)
        return mean[0], mean + 1, mean.sum()

    r = mpc_solve_rate(*_spectral(), r1=r1, r2=r2, trials=trials, plan_fn=plan_fn)
    assert set(r) == KEYS
    assert lengths == [r1, r2] * (trials + 1)
    assert all(s < 0 for s in r["sec_per_solve_all"])
    assert math.isnan(r["solves_per_s"])


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)) as where:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert where == str(logdir)
    (trace,) = logdir.iterdir()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_profile_trace_writes_the_trace_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with profile_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise KeyError("stop")
    assert len(list(tmp_path.iterdir())) == 1
