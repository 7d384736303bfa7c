"""The port's span recorder (plasma_control_tpu_torch/utils/trace.py) on the
CPU: off it records and allocates nothing; on it nests spans, shares step
ids, counts what overflows; its spans land on torch.profiler's timeline; the
control step's spans form the tree of the control path's layers without
changing a bit of its outputs; profile_trace merges them into its trace."""

import json
import tracemalloc

import pytest
import torch

from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.mpc import control_step_fn, mpc_rollout
from plasma_control_tpu_torch.models.pic import init_state
from plasma_control_tpu_torch.ops.grid import make_grid
from plasma_control_tpu_torch.utils import trace
from plasma_control_tpu_torch.utils.timing import merge_spans, profile_trace

torch.set_num_threads(1)

SIM = dict(simcase="two-stream", n_particles=2000, n_mesh=64, dt=0.1, t_max=0.5, length=50.0)
TWIN = dict(horizon=3, n_candidates=16, plan_modes=4, plan_particles=500, plan_mesh=32,
            plan_correction="twin", fidelity_guard=True)
GRID = dict(horizon=3, n_candidates=16, plan_model="grid", plan_integrator="kdk",
            plan_particles=500, plan_mesh=32, fidelity_guard=True)
CEM = dict(horizon=3, n_candidates=16, plan_modes=4, algo="cem", n_elites=4, n_iters=2)
PLAN = ["plan.noise", "plan.model", "plan.twin_targets", "plan.seed", "plan.costs",
        "plan.update", "plan.guard"]


def _port(mpc_kw):
    cfg, ctrl, mpc = SimConfig(**SIM), ControlConfig(max_mode=2), MPCConfig(**mpc_kw)
    grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device="cpu")
    return cfg, ctrl, mpc, grid, act


def _tree(recorded):
    """(name, parent's name) of each span, in order."""
    return [(s.name, recorded[s.parent].name if s.parent >= 0 else None) for s in recorded]


def test_off_records_and_allocates_nothing():
    assert not trace.active()
    assert trace.span("plan") is trace.span("env_step")
    assert trace.next_step() is None
    trace.count("graph.replays")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with trace.span("control_step"):
                with trace.span("plan"):
                    pass
            trace.count("graph.replays")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(mine).compare_to(before.filter_traces(mine), "filename")
    assert sum(stat.size_diff for stat in grown) == 0
    assert trace.spans() == [] and trace.counters() == {} and trace.chrome_events(0) == []


def test_nesting_parents_step_ids_and_self_time():
    with trace.recording(16):
        assert trace.active()
        for _ in range(2):
            assert trace.next_step() in (0, 1)
            with trace.span("control_step"):
                with trace.span("plan"):
                    with trace.span("plan.costs"):
                        pass
                with trace.span("env_step"):
                    pass
        got = trace.spans()
        counters = trace.counters()
    assert not trace.active() and trace.spans() == []
    assert [s.name for s in got] == ["control_step", "plan", "plan.costs", "env_step"] * 2
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1, 4, 5, 4]
    assert [s.step for s in got] == [0] * 4 + [1] * 4
    assert all(s.start_ns <= s.end_ns for s in got)
    own = trace.self_ns(got)
    for i, s in enumerate(got):
        children = sum(c.end_ns - c.start_ns for c in got if c.parent == i)
        assert own[i] == s.end_ns - s.start_ns - children >= 0
    assert counters == {"dropped": 0}


def test_overflow_counts_dropped_and_grows_nothing():
    with trace.recording(3):
        for _ in range(4):
            with trace.span("control_step"):
                trace.count("graph.replays")
        with trace.span("plan"):
            with trace.span("plan.kernel"):
                pass
        got, counters = trace.spans(), trace.counters()
    assert [s.name for s in got] == ["control_step"] * 3
    assert counters == {"graph.replays": 4, "dropped": 3}


def test_open_span_and_nested_recordings():
    with trace.recording(4):
        with trace.span("control_step"):
            assert trace.spans()[0].end_ns is None and trace.self_ns(trace.spans()) == [None]
            assert trace.chrome_events(0)[1:] == []
        with pytest.raises(RuntimeError):
            with trace.recording(4):
                pass
    with pytest.raises(ValueError):
        with trace.recording(0):
            pass


def test_spans_enclose_the_profilers_op(tmp_path):
    """A span around a CPU matrix product holds the profiler's aten::mm once
    placed on the exported trace's timeline."""
    a = torch.randn(256, 256)
    path = tmp_path / "trace.json"
    with trace.recording(8):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with trace.span("env_step"):
                    a @ a
        prof.export_chrome_trace(str(path))
        chrome = json.loads(path.read_text())
        events = trace.chrome_events(chrome["baseTimeNanoseconds"])
    mm = [e for e in chrome["traceEvents"] if e.get("name") == "aten::mm"]
    spans = [e for e in events if e.get("cat") == trace.CATEGORY]
    assert len(mm) == len(spans) == 3
    for s, m in zip(spans, mm):
        assert s["ts"] <= m["ts"] and m["ts"] + m["dur"] <= s["ts"] + s["dur"]
    assert [s["args"]["parent"] for s in spans] == [-1, -1, -1]


@pytest.mark.parametrize("mpc_kw", [TWIN, GRID, CEM], ids=["twin", "grid-kdk", "cem"])
def test_control_step_span_tree_and_bitwise_outputs(mpc_kw):
    """One eager control step: the spans of the control path's layers in
    their tree, and the same bits with recording on as off."""
    cfg, ctrl, mpc, grid, act = _port(mpc_kw)
    st = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    ctrl_step = control_step_fn(grid, cfg, ctrl, mpc, act)
    mean = torch.zeros(mpc.horizon, ctrl.n_actions)
    off = ctrl_step(st.x, st.v, mean, torch.Generator().manual_seed(3))
    with trace.recording(64):
        on = ctrl_step(st.x, st.v, mean, torch.Generator().manual_seed(3))
        got = trace.spans()
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    iters = mpc.n_iters if mpc.algo == "cem" else 1
    plan = PLAN[:4] + ["plan.costs", "plan.kernel", "plan.update"] * iters + PLAN[-1:]
    parents = {"plan.kernel": "plan.costs", "plan": "control_step", "env_step": "control_step",
               "energies": "control_step"}
    want = ["control_step", "plan"] + plan + ["env_step", "energies"]
    assert _tree(got) == [(n, parents.get(n, "plan") if n != "control_step" else None)
                          for n in want]
    assert all(s.end_ns is not None and s.step == -1 for s in got)


def test_closed_loop_gives_each_step_an_id():
    cfg, ctrl, mpc, grid, act = _port(TWIN)
    st = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    with trace.recording(256):
        mpc_rollout(st, grid, cfg, ctrl, mpc, act, torch.Generator().manual_seed(1), n_steps=3)
        got = trace.spans()
    steps = [s.step for s in got if s.name == "control_step"]
    assert steps == [0, 1, 2]
    assert {s.step for s in got} == {0, 1, 2}
    assert len(got) == 3 * 12


@pytest.mark.parametrize("recording", [True, False], ids=["recording", "not-recording"])
def test_profile_trace_merges_the_spans(tmp_path, recording):
    a = torch.randn(64, 64)
    if recording:
        with trace.recording(8):
            with profile_trace(str(tmp_path)):
                with trace.span("energies"):
                    a @ a
    else:
        with profile_trace(str(tmp_path)):
            with trace.span("energies"):
                a @ a
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == trace.CATEGORY]
    assert [e["name"] for e in ours] == (["energies"] if recording else [])
    assert any(e.get("name") == "aten::mm" for e in events)


def test_merge_spans_adds_nothing_without_a_recording():
    chrome = {"traceEvents": [{"ph": "X", "name": "aten::mm", "ts": 1.0, "dur": 1.0}],
              "baseTimeNanoseconds": 0}
    assert merge_spans(chrome)["traceEvents"] == [{"ph": "X", "name": "aten::mm", "ts": 1.0,
                                                   "dur": 1.0}]


def _launch(km, geometry, k=4, n=1000):
    """One call of kernel 1's launch wrapper at ``km`` modes and
    ``geometry`` (CPU tensors suffice: the caller stubs the library out)."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    x0, v0 = torch.rand(n) * 50.0, torch.randn(n)
    u = torch.zeros((k, 3, km))
    return sh._spectral_horizon_cuda(x0, v0, u, u, length=50.0, dt=0.1, n0=1.0, n_particles=n,
                                     rot=True, twin_c=None, twin_s=None, n_modes=None,
                                     geometry=geometry)


def test_kernel_counters_without_a_launch(monkeypatch):
    """The wrapper's counters with the library stubbed out: one
    plan.blocks_kernel per launch beyond 16 modes, the global scratch's bytes
    and clusters per launch that has one (a card that holds one cluster of
    4 CTAs: K=4 candidates on one cluster, 4 rows of 3 S floats for rot),
    nothing where the state is in shared memory; off, nothing is
    recorded."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    monkeypatch.setattr(sh, "_params", lambda *a: None)
    monkeypatch.setattr(sh, "cluster_fits", lambda *a: {1: 3, 2: 1, 4: 1, 8: 0, 16: 0})
    monkeypatch.setattr(sh._build, "call", lambda *a: None)
    scratch, shared = sh.Geometry(4, 250, 0), sh.Geometry(4, 250, 3000)
    _launch(32, scratch)
    assert trace.counters() == {}
    with trace.recording(8):
        _launch(32, scratch)
        _launch(32, shared)
        _launch(16, scratch)
        _launch(8, shared)
        got = trace.counters()
    assert got == {"plan.blocks_kernel": 2, "plan.kernel_scratch_bytes": 2 * 4 * 4 * 750,
                   "plan.stream_clusters": 2, "dropped": 0}
    assert sh.stream_layout(4, 4, sh.cluster_fits()) == sh.StreamLayout(4, 1)
    assert sh.scratch_shape(4, scratch, True, sh.StreamLayout(4, 1)) == (4, 750)
    assert sh.scratch_shape(4, scratch, True) == (16, 750)


@pytest.mark.cuda
def test_kernel_counters_on_the_card():
    """Real launches under a recording: the million-particle solve's chunk
    (N=1M, K=16, Km=32: blocked, global scratch of a row per CTA of the
    clusters stream_layout picks from the card's table, 3 x 62500 floats per
    virtual rank, the clusters counted), the blocked variant in shared
    memory (N=20000), and kernel 1 at 16 modes in shared memory (N=100000),
    which counts neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    gen = torch.Generator(device="cuda").manual_seed(0)
    with trace.recording(8):
        for n, k, km in ((1_000_000, 16, 32), (20_000, 8, 32), (100_000, 8, 16)):
            x0 = torch.rand(n, generator=gen, device="cuda") * 50.0
            v0 = torch.randn(n, generator=gen, device="cuda")
            u = 0.3 * torch.randn((k, 10, 16), generator=gen, device="cuda")
            sh.spectral_horizon(x0, v0, u, u, length=50.0, dt=0.01414, n0=1.0, n_particles=n,
                                rot=True, n_modes=km)
        got = trace.counters()
    geo = sh.launch_geometry(1_000_000, True, 32)
    assert sh.scratch_shape(16, geo, True) == (256, 3 * 62_500)  # one cluster per candidate
    fits = sh.cluster_fits(torch.cuda.current_device(), True, False, True)
    layout = sh.stream_layout(16, 16, fits)
    rows, width = sh.scratch_shape(16, geo, True, layout)
    assert (rows, width) == (layout.clusters * layout.cluster, 3 * 62_500 * 16 // layout.cluster)
    assert got == {"plan.blocks_kernel": 2, "plan.kernel_scratch_bytes": 4 * rows * width,
                   "plan.stream_clusters": layout.clusters, "dropped": 0}
