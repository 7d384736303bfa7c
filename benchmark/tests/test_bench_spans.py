"""Device operations put under the program's spans, on synthetic traces; the
four span readers on a synthetic context; idle gaps named by the spans; the
span window of small cells on the CPU; and, on the card, a capture under a
recording that replays the same operations and bits, and each cell's span
window passing its self-check.

    python -m pytest benchmark/tests/test_bench_spans.py -q
    python -m pytest benchmark/tests/test_bench_spans.py -m cuda -q   # on the card
"""

import collections
import contextlib
import importlib.util

import pytest
import torch

from benchmark import harness, measure, sampler, spans
from benchmark.cell import load_cell, load_metric
from benchmark.tests.helpers import CELLS, tiny_cell

SEED = 3141592653589793
READERS = ("host_step_ms", "env_step_span_device_ms", "plan_glue_span_device_ms",
           "twin_targets_device_ms")
GRAPH_CELLS = [c for c in CELLS if load_cell(c).traffic["path"] == "graph"]


def _span(i, name, ts, dur, parent=-1):
    return {"ph": "X", "cat": spans.PORT_SPAN, "name": name, "ts": ts, "dur": dur,
            "args": {"index": i, "parent": parent, "step": 0}}


def _call(name, ts, corr, dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _op(ts, corr, dur=5.0, name="void k<0>(float*)"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


EAGER_SPANS = [_span(0, "control_step", 0, 100), _span(1, "plan", 5, 60, 0),
               _span(2, "plan.costs", 10, 30, 1), _span(3, "plan.kernel", 15, 10, 2),
               _span(4, "env_step", 70, 20, 0)]


def test_eager_operations_by_correlation():
    host = [_call("cudaLaunchKernel", 6, 1), _call("cudaLaunchKernelExC", 16, 2),
            _call("cudaMemsetAsync", 72, 3), _call("cudaLaunchKernel", 95, 4),
            _call("cudaLaunchKernel", 200, 5)]
    dev = [_op(300, 2), _op(120, 1), _op(330, 3), _op(340, 4), _op(400, 5), _op(410, 99)]
    paths, problems, labelled = spans.attribute(dev, host, EAGER_SPANS, {})
    assert paths == ["control_step/plan/plan.costs/plan.kernel", "control_step/plan",
                     "control_step/env_step", "control_step", "", ""]
    assert problems == [] and labelled == 0


CAPTURE = [_span(0, "graphed_step", 0, 1000), _span(1, "graph.capture", 10, 500, 0),
           _span(2, "control_step", 20, 400, 1), _span(3, "plan", 30, 200, 2),
           _span(4, "plan.kernel", 40, 50, 3), _span(5, "env_step", 300, 50, 2)]
CAPTURE_CALLS = [_call("cudaLaunchKernel", 12, 7), _call("cudaStreamBeginCapture", 25, 8),
                 _call("cudaLaunchKernel", 35, 1), _call("cudaStreamIsCapturing", 50, 2),
                 _call("cudaLaunchKernelExC", 45, 3), _call("cudaMemsetAsync", 310, 4),
                 _call("cuLaunchKernel", 450, 5), _call("cudaStreamEndCapture", 460, 9),
                 _call("cudaLaunchKernel", 600, 6)]
LABELS = {"kernel": ["control_step/plan", "control_step/plan/plan.kernel", ""],
          "set": ["control_step/env_step"]}


def test_capture_labels_in_the_order_of_the_calls():
    """Only calls while the stream captures are nodes: not the fill launched
    inside the capture's span before the capture begins (at 12)."""
    assert spans.capture_labels(CAPTURE + CAPTURE_CALLS) == LABELS
    assert spans.capture_labels(CAPTURE_CALLS) == {}
    unmarked = [c for c in CAPTURE_CALLS if "Capture" not in c["name"]]
    assert spans.capture_labels(CAPTURE + unmarked) == {}


def _replay(n_kernels, n_sets=1):
    """One replay: a fill launched before the graph, then the graph's
    kernels and sets interleaved as captured (listed out of order)."""
    port = [_span(10, "graphed_step", 2000, 100), _span(11, "graph.replay", 2010, 20, 10)]
    host = [_call("cudaLaunchKernel", 2005, 8), _call("cudaGraphLaunch", 2012, 9)]
    ts = [2050, 2060, 2080, 2090, 2095][:n_kernels]
    dev = [_op(2001, 8)] + [_op(t, 9) for t in reversed(ts)]
    dev += [dict(_op(2070 + k, 9), cat="gpu_memset") for k in range(n_sets)]
    return dev, host, port


def test_replayed_operations_take_the_labels_in_order():
    dev, host, port = _replay(3)
    paths, problems, labelled = spans.attribute(dev, host, port, LABELS)
    base = "graphed_step/graph.replay"
    assert problems == [] and labelled == 1
    assert paths == ["graphed_step", base, base + "/control_step/plan/plan.kernel",
                     base + "/control_step/plan", base + "/control_step/env_step"]


def _more(dev, host, n_kernels, n_sets, shift):
    """``dev`` and ``host`` with one more replay, ``shift`` us later."""
    d, h, _ = _replay(n_kernels, n_sets)
    d = [dict(e, ts=e["ts"] + shift, args={"correlation": e["args"]["correlation"] + shift})
         for e in d]
    h = [dict(c, ts=c["ts"] + shift, args={"correlation": c["args"]["correlation"] + shift})
         for c in h]
    return dev + d, host + h


@pytest.mark.parametrize("n_kernels, n_sets, problem", [
    (4, 1, "a graph launch ran 4 kernel operations; the capture labelled 3"),
    (3, 2, "a graph launch ran 2 set operations; the capture labelled 1"),
])
def test_more_operations_than_labels_is_a_problem(n_kernels, n_sets, problem):
    dev, host, port = _replay(n_kernels, n_sets)
    _, problems, labelled = spans.attribute(dev, host, port, LABELS)
    assert problems == [problem] and labelled == 0


@pytest.mark.parametrize("n_kernels, n_sets", [(2, 1), (3, 0)])
def test_a_replay_short_of_records_is_left_out(n_kernels, n_sets):
    """One launch of four lost records: the other three are labelled; two of
    four short is a problem."""
    dev, host, port = _replay(3)
    for shift in (1000, 2000):
        dev, host = _more(dev, host, 3, 1, shift)
    port += [dict(e, ts=e["ts"] + t) for t in (1000, 2000, 3000) for e in port[:2]]
    short_dev, short_host = _more(dev, host, n_kernels, n_sets, 3000)
    paths, problems, labelled = spans.attribute(short_dev, short_host, port, LABELS)
    assert problems == [] and labelled == 3
    assert all(p.startswith("graphed_step/graph.replay") or p == "graphed_step"
               for p in paths[-(n_kernels + n_sets + 1):])
    assert not any(spans.under(p, "plan") for p in paths[-(n_kernels + n_sets + 1):])
    worse, worse_host = _more(short_dev, short_host, n_kernels, n_sets, 4000)
    port += [dict(e, ts=e["ts"] + 4000) for e in port[:2]]
    _, problems, labelled = spans.attribute(worse, worse_host, port, LABELS)
    assert problems == ["2 of 5 graph launches short of their labels"] and labelled == 3


@pytest.mark.parametrize("counters, graph, problem", [
    ({"dropped": 0, "graph.captures": 1, "graph.replays": 13}, True, None),
    ({"dropped": 0}, False, None),
    ({"dropped": 2, "graph.captures": 1, "graph.replays": 13}, True, "2 spans dropped"),
    ({"dropped": 0, "graph.captures": 2, "graph.replays": 13}, True, "2 graph captures"),
    ({"dropped": 0, "graph.captures": 1, "graph.replays": 12}, True,
     "12 graph replays in 13 steps"),
])
def test_self_check(counters, graph, problem):
    assert spans.self_check(counters, graph, 13, 7, 7) == ([problem] if problem else [])
    assert "6 step spans in a window of 7 steps" in spans.self_check(counters, graph, 13, 6, 7)


def _ctx(check=None):
    """Two steps: a plan op, the planner kernel, the twin targets' two ops
    (overlapping), the env step's two and the energies' one."""
    dev = [_op(0, 1, 10), _op(10, 2, 40), _op(50, 3, 4), _op(52, 4, 4), _op(60, 5, 6),
           _op(66, 6, 6), _op(72, 7, 8)]
    paths = ["control_step/plan", "control_step/plan/plan.costs/plan.kernel",
             "control_step/plan/plan.twin_targets", "control_step/plan/plan.twin_targets",
             "control_step/env_step", "control_step/env_step", "control_step/energies"]
    return {"device_events": dev, "op_spans": paths, "program_spans": [], "steps": 2,
            "untraced_step_spans_ms": [0.05, 0.07, 0.09], "span_check": check,
            "measure": measure}


def test_the_readers_on_a_synthetic_context():
    got = {name: load_metric(name).read(_ctx()) for name in READERS}
    assert got["host_step_ms"] == pytest.approx(0.07)
    assert got["env_step_span_device_ms"] == pytest.approx(0.006)
    assert got["plan_glue_span_device_ms"] == pytest.approx((10 + 6) / 1e3 / 2)
    assert got["twin_targets_device_ms"] == pytest.approx(0.003)
    assert all(load_metric(name).read(_ctx("1 spans dropped")) is None for name in READERS)
    quiet = dict(_ctx(), op_spans=["control_step/plan"] * 7)
    assert load_metric("twin_targets_device_ms").read(quiet) is None
    assert load_metric("env_step_span_device_ms").read(quiet) is None


def test_readers_read_nothing_without_spans():
    """A traced run's context without spans, outside a run of benchmark/run.py:
    no span window, nothing read."""
    ctx = {"device_events": [_op(0, 1)], "host_events": [], "steps": 1, "measure": measure}
    assert spans.context(ctx) is None
    assert all(load_metric(name).read(ctx) is None for name in READERS)


def test_idle_gaps_named_by_spans_where_no_call_covers_them():
    dev = [_op(0, 1, 10), _op(50, 2, 10), _op(100, 3, 10)]
    host = [_call("cudaLaunchKernel", 20, 1, dur=20)]
    port = [_span(0, "plan", 0, 110), _span(1, "plan.update", 55, 60, 0)]
    gaps = dict(spans.idle_gaps(dev, host, port))
    assert gaps == {"cudaLaunchKernel": pytest.approx(40e-6),
                    "port:plan_update": pytest.approx(40e-6)}
    assert dict(measure.idle_gaps(dev, host, 0, 110))[measure.BETWEEN_OPS] == pytest.approx(
        40e-6)


@pytest.mark.parametrize("name", ["two_stream_n100k.mpc_eager",
                                  "bump_on_tail_n5k.mpc_grid_graph"])
def test_the_span_window_on_the_cpu(name):
    """A small cell's span window: every step span found, nothing dropped,
    the untraced steps' host times, the solve's spans once per step."""
    s = spans.run_cell(tiny_cell(name, steps=8), SEED, "cpu")
    assert s["span_check"] is None and s["steps"] == 4
    assert len(s["untraced_step_spans_ms"]) == 3 * 4 + 1 - 4 - 1
    assert load_metric("host_step_ms").read(s) > 0
    names = collections.Counter(e["name"] for e in s["program_spans"])
    steps = 2 + 3 * 4 + 1  # the warm-up's and the window's
    for span in ("control_step", "plan", "plan.kernel", "plan.guard", "env_step", "energies"):
        assert names[span] == steps, span


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(spans.importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".utils.trace") else real(name, *a))
    assert spans.program_trace() is None
    assert spans.run_cell(tiny_cell("two_stream_n100k.mpc_eager"), SEED, "cpu") is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plasma_control_tpu_torch.models.pic import PlasmaState
    from plasma_control_tpu_torch.utils import trace

    return trace, PlasmaState


def _largest_replay(path) -> int:
    """The most device operations correlated with one graph launch of a
    trace (the profiler may lose records of a replay, never add them)."""
    events = measure.load_trace(str(path))
    launches = {e["args"]["correlation"] for e in measure.host_events(events)
                if e["name"].startswith(spans.GRAPH_LAUNCH)}
    per = collections.Counter(e["args"]["correlation"] for e in measure.device_events(events)
                              if e.get("args", {}).get("correlation") in launches)
    return max(per.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CELLS)
def test_recording_at_capture_changes_no_replay(name, tmp_path):
    """The step captured under a recording and a CUDA-activity profiler, as
    the span window captures it, and without: the same device operations in
    a replay and the same bits over an episode's first 40 steps."""
    trace, PlasmaState = _card()
    cell = load_cell(name)
    outs, ops = [], []
    for recording in (False, True):
        prog = harness.Program(cell, "cuda")
        x, v = sampler.start_states(cell.sim, SEED, 1, "cuda")[0]
        prog.generator.manual_seed(SEED % (1 << 63))
        mean = torch.zeros((prog.h, prog.d), device="cuda")
        with (trace.recording(4096) if recording else contextlib.nullcontext()):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                x, v, mean, *rest = prog.step(x, v, mean, prog.generator)
                torch.cuda.synchronize()
        got = [torch.cat([t.reshape(-1) for t in (x, v, mean, *rest)]).clone()]
        for i in range(39):
            x, v, mean, *rest = prog.step(x, v, mean, prog.generator)
            if i == 30:
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        x, v, mean, *rest = prog.step(x, v, mean, prog.generator)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(str(tmp_path / f"{recording}.json"))
                ops.append(_largest_replay(tmp_path / f"{recording}.json"))
            got.append(torch.cat([t.reshape(-1) for t in (x, v, mean, *rest)]).clone())
        outs.append(torch.stack(got))
        del prog
    assert ops[0] == ops[1] > 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_span_window_on_the_card(name):
    """Each cell's span window passes its self-check and reads its metrics;
    every profiled step launches the Yoshida-4 rounds' three deposits and
    three gathers under ``env_step``, the energies' and the feedback seed's
    deposit under theirs: on the eager path, the spans sit on the trace's
    clock; on the graph path, the node labels fall in order."""
    _card()
    cell = load_cell(name)
    cell.traffic = dict(cell.traffic, trace_steps=20)
    s = spans.run_cell(cell, SEED, "cuda")
    assert s["span_check"] is None, s["span_check"]
    for reader in READERS[:3]:
        assert load_metric(reader).read(s) > 0, reader
    twin = cell.mpc["plan_correction"] == "twin"
    assert (load_metric("twin_targets_device_ms").read(s) is not None) == twin
    kinds = collections.Counter()
    for e, path in zip(s["device_events"], s["op_spans"]):
        kinds[path.rsplit("/", 1)[-1], measure.kernel_name(e["name"])] += 1
    if cell.traffic["path"] == "eager":
        calls = [e for e in s["host_events"] if spans.is_launch(e["name"])]
        port = s["program_spans"]
        starts = spans.innermost(port, [e["ts"] for e in calls])
        ends = spans.innermost(port, [e["ts"] + e["dur"] for e in calls])
        assert len(calls) >= 110 * 20 and starts == ends and None not in starts
    steps = s["steps"]  # the profiled steps whose operations all have a span path
    assert 15 <= steps <= 20
    assert kinds["env_step", "deposit_kernel"] == kinds["env_step", "gather_kernel"] == 3 * steps
    assert kinds["energies", "deposit_kernel"] == kinds["plan.seed", "deposit_kernel"] == steps
