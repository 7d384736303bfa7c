"""The million-particle two-stream controller's cell
(``two_stream_n1m.mpc_million``: ``experiments/million_r5.py``'s
``fullfid_K384_wt4_wraw05_cm2_mm16`` uncut) on the CPU at a small size: the
port's control step against the benchmark's plain reference within the
cell's limits, the lower-precision control outside them, chunked costs equal
to one launch's, the frozen counts at the cell's shapes, and the cell's two
per-layer readers on synthetic traces."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import counts, harness, judge, measure  # noqa: E402
from benchmark.cell import load_cell, load_metric  # noqa: E402
from benchmark.tests.helpers import tiny_cell  # noqa: E402
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig  # noqa: E402
from plasma_control_tpu_torch.control import mpc as port_mpc  # noqa: E402
from plasma_control_tpu_torch.control.actuator import make_actuator  # noqa: E402
from plasma_control_tpu_torch.ops.grid import make_grid  # noqa: E402

torch.set_num_threads(1)

NAME = "two_stream_n1m.mpc_million"
SEED = 2718281828459  # the benchmark's own CPU tests' seed
READERS = ("blocks_kernel_roofline", "full_state_span_device_ms")
BLOCKS = "void (anonymous namespace)::spectral_horizon_blocks_kernel<true, true, false>(Buffers)"


def test_the_cell_is_the_source_controller():
    """The configuration and traffic as the source runs them, uncut; only
    the chunk differs (see the configuration's ``assumed``)."""
    cell = load_cell(NAME)
    assert cell.chips == 1 and cell.traffic["path"] == "eager"
    assert cell.config["reduced"] == []
    sim, ctrl, mpc = cell.sim, cell.control, cell.mpc
    assert (sim["simcase"], sim["n_particles"], sim["n_mesh"], sim["length"], sim["dt"]) == (
        "two-stream", 1_000_000, 256, 50.0, 0.1)
    assert (ctrl["max_mode"], ctrl["coeff_min"], ctrl["coeff_max"]) == (16, -2.0, 2.0)
    want = dict(n_candidates=384, horizon=10, plan_modes=32, plan_chunk=None, w_input=0.0025,
                w_terminal=4.0, plan_particles=None, plan_correction="none", algo="mppi")
    assert {k: mpc[k] for k in want} == want
    defaults = MPCConfig()
    same = ("n_elites", "n_iters", "sigma0", "temperature", "w_field", "cost_pe_nref",
            "fidelity_guard", "fidelity_guard_ratio", "seed_feedback", "plan_integrator",
            "n_knots", "plan_kernel", "spectral_drift", "terminal_mode", "terminal_steps",
            "antithetic")
    assert {k: mpc[k] for k in same} == {k: getattr(defaults, k) for k in same}
    assert cell.traffic["episode_steps"] == 500
    assert {m["name"] for m in cell.end_to_end} == {"control_steps_per_s", "step_ms_p95",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        reader = load_metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    # a full-fidelity solve: the guard never stops it, so the plan is compared
    assert cell.limits["plan_gap"] is not None and cell.limits["ie_gap"] is not None
    assert cell.limits["guard_gap"] == 0 and cell.limits["carry_gap"] == 0.0


def test_control_step_agrees_with_the_reference():
    """N=2000 on 64 cells, K=32: the plain path (the kernel's plain version,
    rot drift) against the float64 reference within the cell's limits."""
    r = harness.run(tiny_cell(NAME), SEED, 0.01, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] == 30 and r["failed"] == 0
    assert set(r["checks"]) == set(judge.CHECKS)


def test_the_control_is_not_correct():
    """The reference in bfloat16 with TF32 products, in the program's place
    on the same inputs, fails the cell's limits."""
    cell = tiny_cell(NAME)
    prog = harness.Program(cell, "cpu")
    rec = harness.Recorder(prog.step, "cpu", 0, SEED, cell.traffic["check_steps"] - 3, 29)
    x, v = harness.sampler.start_states(cell.sim, SEED, 1, "cpu")[0]
    prog.episode(rec, SEED, 0, (x, v), 30, harness._episode_sample(SEED, 0, 30))
    values, _ = harness.check(cell, rec.records, "cpu", control=True)
    ok, checks = judge.verdict(values, cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("plan_kernel", ["fused", "auto"])
def test_chunked_costs_equal_one_launch(plan_kernel):
    """The source's plan_chunk against none, at Km=32 over Ka=16 with
    w_terminal 4: K=30 in chunks of 8 (the last padded with copies of
    candidate 0, dropped) gives the same costs, each candidate scored
    alone."""
    cell = tiny_cell(NAME)
    cfg, ctrl = SimConfig(**cell.sim), ControlConfig(**cell.control)
    mpc = MPCConfig(**dict(cell.mpc, plan_kernel=plan_kernel, plan_chunk=8))
    grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                        endpoint_grid=ctrl.endpoint_grid, device="cpu")
    x, v = harness.sampler.start_states(cell.sim, SEED, 1, "cpu")[0]
    state = port_mpc.PlasmaState(x, v)
    gen = torch.Generator().manual_seed(5)
    cand = torch.clamp(0.5 * torch.randn((30, mpc.horizon, 2 * ctrl.max_mode), generator=gen),
                       ctrl.coeff_min, ctrl.coeff_max)
    chunked = port_mpc.candidate_costs(state, cand, grid, cfg, mpc, act)
    whole = port_mpc.candidate_costs(state, cand, grid, cfg,
                                     dataclasses.replace(mpc, plan_chunk=None), act)
    assert chunked.shape == (30,) and torch.isfinite(whole).all()
    assert torch.equal(chunked, whole)


def test_counts_reproduce_the_million_chunk_bound():
    """chip_smoke.py's million chunk (K=16) is bound at 0.8363 ms; the cell's
    one launch of K=384 counts 24 chunks' work less 23 of the prologue's
    mode sums at the shared x0, which every chunk repeats."""
    cell = load_cell(NAME)
    chunk = dict(cell.mpc, n_candidates=16)
    assert round(counts.bound_ms(*counts.plan_cost(cell.sim, cell.control, chunk)), 4) == 0.8363
    ops, nbytes = counts.plan_cost(cell.sim, cell.control, cell.mpc)
    chunk_ops, chunk_bytes = counts.plan_cost(cell.sim, cell.control, chunk)
    n, km = cell.sim["n_particles"], 32
    assert ops == 24 * chunk_ops - 23 * n * (6 * km - 1)
    assert nbytes < 24 * chunk_bytes
    ms = counts.bound_ms(ops, nbytes)
    assert ms == pytest.approx(24 * 0.8363, rel=4e-3) and ms == pytest.approx(20.005, abs=1e-3)
    assert ms == 1e3 * ops / counts.PEAK_FLOPS  # operations set the bound


def _op(ts, dur, name="elementwise_kernel"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {}}


def _span_ctx(blocks_per_step=1, check=None):
    """Two steps of a span window: each step a blocked launch under
    plan.kernel (100 us), glue, an env step and energies (2, 3, 4 us)."""
    dev, paths = [], []
    for step in range(2):
        t = 1000.0 * step
        for j in range(blocks_per_step):
            dev.append(_op(t + 10 + 200 * j, 100, BLOCKS))
            paths.append("control_step/plan/plan.costs/plan.kernel")
        dev += [_op(t + 500, 2), _op(t + 600, 3), _op(t + 700, 4), _op(t + 900, 50)]
        paths += ["control_step/plan/plan.update", "control_step/env_step",
                  "control_step/energies", ""]
    return {"device_events": dev, "op_spans": paths, "program_spans": [], "steps": 2,
            "untraced_step_spans_ms": [1.0], "span_check": check, "measure": measure}


def test_the_readers_on_synthetic_traces():
    cell = load_cell(NAME)
    full = load_metric("full_state_span_device_ms")
    assert full.read(_span_ctx()) == pytest.approx((2 + 3 + 4) / 1e3)
    for ctx in (_span_ctx(0), _span_ctx(2), _span_ctx(1, "1 spans dropped")):
        assert full.read(ctx) is None
    roof = load_metric("blocks_kernel_roofline")
    ctx = {"device_events": [_op(0, 96_000, BLOCKS), _op(96_000, 500),
                             _op(100_000, 96_000, BLOCKS)],
           "steps": 2, "sim": cell.sim, "control": cell.control, "mpc": cell.mpc,
           "counts": counts, "measure": measure}
    bound = counts.bound_ms(*counts.plan_cost(cell.sim, cell.control, cell.mpc))
    assert roof.read(ctx) == pytest.approx(100.0 * bound / 96.0)
    ctx["device_events"] = [_op(0, 500)]
    assert roof.read(ctx) is None
