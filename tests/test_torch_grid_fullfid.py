"""The full-fidelity grid planner's cell (``bump_on_tail_n100k.mpc_grid_fullfid_graph``:
``run_mpc --plan_model grid``'s controller on config 4's bump-on-tail plasma, uncut) on the
CPU at a small size: the port's control step against the benchmark's plain reference within
the cell's limits, the lower-precision control outside them, the fidelity guard a no-op at
full fidelity, the frozen counts at the cell's shapes, kernel 6's scratch counter with the
library stubbed out, and the cell's own per-layer reader and the planner kernels' roofline on
synthetic traces."""

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
from benchmark.reference import Reference  # noqa: E402
from benchmark.tests.helpers import tiny_cell  # noqa: E402
from plasma_control_tpu_torch import cli  # noqa: E402
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig  # noqa: E402
from plasma_control_tpu_torch.control import mpc as port_mpc  # noqa: E402
from plasma_control_tpu_torch.control.actuator import make_actuator  # noqa: E402
from plasma_control_tpu_torch.ops.grid import make_grid  # noqa: E402
from plasma_control_tpu_torch.ops.kernels import fused_step as fs  # noqa: E402
from plasma_control_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(1)

NAME = "bump_on_tail_n100k.mpc_grid_fullfid_graph"
SEED = 2718281828459  # the benchmark's own CPU tests' seed
# the accepted readers of the layers the cell runs, and its own
READERS = ("device_idle_share", "device_ops_per_step", "plan_kernel_roofline",
           "env_step_device_ms", "plan_glue_device_ms", "step_mfu", "host_step_ms",
           "env_step_span_device_ms", "plan_glue_span_device_ms",
           "grid_outside_kernel_span_device_ms")
GRID = "void (anonymous namespace)::horizon_kernel<true, 0, false, false>(float const*)"
FLAGS = ["--simcase", "bump-on-tail", "--num_particle", "100000", "--num_mesh", "256",
         "--max_mode", "8", "--plan_model", "grid"]


def _small(k: int = 16, h: int = 4):
    """The cell at N=2000 on 64 cells, K candidates, an H-step horizon."""
    cell = tiny_cell(NAME, k=k)
    cell.traffic["mpc"]["horizon"] = h
    return cell


def _cli():
    p = cli.add_mpc_args(cli.add_control_args(cli.base_parser("run_mpc")))
    return vars(p.parse_args(FLAGS))


def test_the_cell_is_the_cli_grid_controller_uncut():
    """run_mpc's flags with --plan_model grid at config 4's scale build the
    cell's plasma and controller; only the deposit kernel is the cell's
    choice (see the configuration's ``assumed``)."""
    cell = load_cell(NAME)
    assert cell.chips == 1 and cell.traffic["path"] == "graph"
    assert cell.config["reduced"] == []
    args = _cli()
    want = dataclasses.replace(cli.build_sim_config(args), deposit_method="pallas")
    assert SimConfig(**cell.sim) == want
    assert MPCConfig(**cell.mpc) == cli.build_mpc_config(args)
    ctrl = ControlConfig(**cell.control)
    assert (ctrl.max_mode, ctrl.coeff_min, ctrl.coeff_max) == (8, -1.0, 1.0)
    mpc = cell.mpc
    assert (mpc["n_candidates"], mpc["horizon"], mpc["plan_model"], mpc["plan_integrator"],
            mpc["plan_particles"], mpc["plan_mesh"], mpc["algo"]) == (
        512, 10, "grid", "kdk", None, None, "mppi")
    assert cell.traffic["episode_steps"] == 500 and cell.traffic["check_steps"] == 8
    assert {m["name"] for m in cell.end_to_end} == {"control_steps_per_s", "step_ms_p95",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        reader = load_metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    assert fs._layout(100_000, 256) == fs.Layout(True, False, False)


def test_every_gap_is_compared():
    limits = load_cell(NAME).limits
    assert set(limits) == set(judge.CHECKS)
    assert all(limits[name] is not None for name in judge.CHECKS)
    assert limits["guard_gap"] == 0 and limits["carry_gap"] == 0.0


def test_control_step_agrees_with_the_reference():
    """N=2000 on 64 cells, K=16, H=4: the grid planner op by op against the
    float64 reference within the cell's limits, every gap compared."""
    r = harness.run(_small(), SEED, 0.01, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] == 30 and r["failed"] == 0
    assert set(r["checks"]) == set(judge.CHECKS)


def test_the_control_is_not_correct():
    """The reference in bfloat16 with TF32 products, in the program's place
    on the same inputs, fails the cell's limits."""
    cell = _small()
    prog = harness.Program(cell, "cpu")
    rec = harness.Recorder(prog.step, "cpu", 0, SEED, cell.traffic["check_steps"] - 3, 29)
    x, v = harness.sampler.start_states(cell.sim, SEED, 1, "cpu")[0]
    prog.episode(rec, SEED, 0, (x, v), 30, harness._episode_sample(SEED, 0, 30))
    values, _ = harness.check(cell, rec.records, "cpu", control=True)
    ok, checks = judge.verdict(values, cell.limits)
    assert not ok, checks


def test_the_guard_is_a_no_op_and_the_plan_is_compared():
    """At full fidelity the guard changes no solve and the reference has no
    ratio: the MPPI nominal is held to plan_gap, and the planner drives."""
    cell = _small()
    cfg, ctrl = SimConfig(**cell.sim), ControlConfig(**cell.control)
    mpc = MPCConfig(**cell.mpc)
    assert mpc.fidelity_guard and port_mpc._plan_frac(cfg, mpc) == 1.0
    grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device="cpu")
    x, v = harness.sampler.start_states(cell.sim, SEED, 1, "cpu")[0]
    state = port_mpc.PlasmaState(x, v)
    mean = torch.zeros((mpc.horizon, 2 * ctrl.max_mode))
    sigma = torch.tensor(mpc.sigma0)
    out = [port_mpc.plan(state, mean, sigma, torch.Generator().manual_seed(3), grid, cfg, ctrl,
                         dataclasses.replace(mpc, fidelity_guard=guard), act)
           for guard in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert out[0][0].abs().max() > 0
    ref = Reference(cell.sim, cell.control, cell.mpc, "cpu")
    p = ref.plan(x, v, mean, torch.zeros((mpc.n_candidates, mpc.horizon, 2 * ctrl.max_mode)))
    assert ref.frac == 1.0 and p["ratio"] is None


def test_counts_give_the_cells_bound():
    """K x H x N = 512M particle-steps of the merged-kick KDK: 23.72 GFLOP,
    bound by the operations at 0.354 ms."""
    cell = load_cell(NAME)
    ops, nbytes = counts.plan_cost(cell.sim, cell.control, cell.mpc)
    assert round(ops / 1e9, 2) == 23.72
    ms = counts.bound_ms(ops, nbytes)
    assert round(ms, 3) == 0.354 and ms == 1e3 * ops / counts.PEAK_FLOPS
    shapes = counts.plan_shapes(cell.sim, cell.control, cell.mpc)
    assert (shapes["k"], shapes["h"], shapes["n"], shapes["m"]) == (512, 10, 100_000, 256)
    assert shapes["grid"] and shapes["merged"]


def _launch(n, m, k, h=2, merged=True):
    """One call of kernels 5-6's launch wrapper (CPU tensors suffice: the
    caller stubs the library out)."""
    x, v = torch.rand(n) * 50.0, torch.randn(n)
    u = torch.zeros((k, h, m))
    eop = torch.zeros((m, m))
    return fs._horizon_cuda(x, v, u, eop, n_mesh=m, length=50.0, dt=0.1, n0=1.0, kind="cic",
                            merged=merged, what="fused_packed_horizon")


def test_grid_scratch_counter_without_a_launch(monkeypatch):
    """Each launch of kernel 5 or 6 counts the bytes of its global
    scratch: the (K, 2N) particle state beyond shared memory
    (4 x K x 2N: 409,600,000 at the cell's K=512, N=100000), the mesh arrays
    beyond 3631 cells, nothing where both fit; off, nothing is recorded."""
    monkeypatch.setattr(fs, "_params", lambda *a: None)
    monkeypatch.setattr(fs._build, "call", lambda *a: None)
    _launch(100_000, 256, 4)
    assert trace.counters() == {}
    with trace.recording(8):
        _launch(100_000, 256, 4)
        _launch(1250, 64, 4, merged=False)
        _launch(1250, 4096, 2)
        got = trace.counters()
    state = 4 * 4 * 2 * 100_000
    wide = 4 * 2 * 2 * 1250 + 4 * 2 * fs._mesh_words(4096)
    assert got == {"plan.grid_scratch_bytes": state + wide, "dropped": 0}
    assert 4 * 512 * 2 * 100_000 == 409_600_000


def _op(ts, dur, name="elementwise_kernel"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {}}


def _span_ctx(grid_per_step=1, check=None):
    """Two steps of a span window: each step kernel 6 under plan.kernel
    (100 us), the drive fields beside it (1 us), an update, an env step and
    energies (2, 3, 4 us), and a copy outside the step."""
    dev, paths = [], []
    kernel = "graphed_step/graph.replay/control_step/plan/plan.costs/plan.kernel"
    for step in range(2):
        t = 1000.0 * step
        for j in range(grid_per_step):
            dev.append(_op(t + 10 + 200 * j, 100, GRID))
            paths.append(kernel)
        dev += [_op(t + 5, 1), _op(t + 500, 2), _op(t + 600, 3), _op(t + 700, 4),
                _op(t + 900, 50)]
        paths += [kernel, "graphed_step/graph.replay/control_step/plan/"
                  "plan.update", "graphed_step/graph.replay/control_step/env_step",
                  "graphed_step/graph.replay/control_step/energies", "graphed_step"]
    return {"device_events": dev, "op_spans": paths, "program_spans": [], "steps": 2,
            "untraced_step_spans_ms": [1.0], "span_check": check, "measure": measure}


def test_the_readers_on_synthetic_traces():
    cell = load_cell(NAME)
    beside = load_metric("grid_outside_kernel_span_device_ms")
    assert beside.read(_span_ctx()) == pytest.approx((1 + 2 + 3 + 4) / 1e3)
    for ctx in (_span_ctx(0), _span_ctx(2), _span_ctx(1, "1 spans dropped")):
        assert beside.read(ctx) is None
    # the planner kernels' roofline reads kernel 6 by its name (and any spectral kernel beside it)
    roof = load_metric("plan_kernel_roofline")
    ctx = {"device_events": [_op(0, 3000, GRID), _op(3000, 500),
                             _op(3600, 3000, GRID), _op(6700, 40, "spectral_horizon_kernel")],
           "steps": 2, "sim": cell.sim, "control": cell.control, "mpc": cell.mpc,
           "counts": counts, "measure": measure}
    bound = counts.bound_ms(*counts.plan_cost(cell.sim, cell.control, cell.mpc))
    assert roof.read(ctx) == pytest.approx(100.0 * bound / 3.02)
    ctx["device_events"] = [_op(0, 500)]
    assert roof.read(ctx) is None
