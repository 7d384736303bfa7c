"""Device and host time by the program's own layers: its spans.

The program marks the layer boundaries of its control step with spans
(``plasma_control_tpu_torch/utils/trace.py``: ``control_step``, ``plan``
and its children, ``env_step``, ``energies``; ``graphed_step``,
``graph.capture``, ``graph.replay`` around the captured step) and counts
graph captures and replays. Here every device operation of a profiled
window is put under the span path the host was in when it launched it:

* eager: the kernel, copy or set -> its ``correlation`` -> the CUDA API
  call (``cuda*`` or ``cu*``) that launched it -> the innermost span at that
  call's ``ts``;
* replayed: the operations of one ``cudaGraphLaunch``, in ``ts`` order,
  take the capture's node labels in order, kernels, copies and sets each
  their own: the innermost span at each launching call inside
  ``graph.capture``, recorded by a CUDA-activity profiler over the step
  that captures.

The spans reach the trace's timeline through the program's own merge
(``utils/timing.py::merge_spans``). A self-check guards the graph labels:
one capture, as many replays as steps, in every replay as many operations
of each kind the trace shows as the capture labelled, and no span dropped;
where it fails, the span metrics read None and the log says why.

The harness hands its readers no spans: its traced run records none. So
:func:`context` runs one more window of the cell, in the same process
after the traced sub-window: the program built anew under a recording, the
warm-up episode (the capture profiled on the graph path), then
``trace_steps`` untraced steps, ``trace_steps`` profiled ones and
``trace_steps + 1`` untraced ones, from the run's ``--seed``. A program
without the recorder (before it existed) gives None, and its readers read
nothing.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
import traceback

import torch

from . import harness, measure, sampler
from .harness import log

PORT_SPAN = "port_span"
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")
CAPTURE = "graph.capture"
STEP_SPANS = ("control_step", "graphed_step")  # one step of the eager / the graph path
SPANS_PER_STEP = 48  # room for the deepest step (CEM's costs and updates per iteration)
_SIDE: dict = {}  # this process's extra window, by (workload, seed)


def program_trace():
    """The program's recorder and its trace merge, or None for a program
    that has none."""
    if importlib.util.find_spec("plasma_control_tpu_torch.utils.trace") is None:
        return None
    from plasma_control_tpu_torch.utils import timing, trace

    return trace, timing.merge_spans


def is_launch(name: str) -> bool:
    """A CUDA API call (``cuda*`` or ``cu*``) that puts one kernel, copy or
    set on a stream (a graph's launch excepted)."""
    if name.startswith(GRAPH_LAUNCH):
        return False
    return "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy",
                                                "cuMemset"))


def span_paths(port: list) -> list:
    """The slash-joined names from the outermost span down to each span
    (``control_step/plan/plan.costs``), by the ``index`` and ``parent`` the
    program gives each span event."""
    by_index = {e["args"]["index"]: e for e in port}
    memo = {}

    def path(i):
        if i not in memo:
            e = by_index[i]
            parent = e["args"]["parent"]
            memo[i] = e["name"] if parent < 0 or parent not in by_index else (
                path(parent) + "/" + e["name"])
        return memo[i]

    return [path(e["args"]["index"]) for e in port]


def innermost(port: list, times: list) -> list:
    """For each time (us), the index into ``port`` of the innermost span
    that holds it, or None. The spans of one thread nest, so a sweep in
    order of time keeps the open ones on a stack."""
    order = sorted(range(len(port)), key=lambda i: (port[i]["ts"], -port[i]["dur"]))
    out = [None] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=lambda q: times[q]):
        t = times[q]
        while j < len(order) and port[order[j]]["ts"] <= t:
            s = order[j]
            while stack and port[stack[-1]]["ts"] + port[stack[-1]]["dur"] <= port[s]["ts"]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and port[stack[-1]]["ts"] + port[stack[-1]]["dur"] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def kind(e: dict) -> str:
    """``kernel``, ``copy`` or ``set``: of a device event by its category, of
    a launching call by its name."""
    if e.get("cat") in measure.DEVICE_CATS:
        return {"gpu_memcpy": "copy", "gpu_memset": "set"}.get(e["cat"], "kernel")
    name = e["name"]
    return "copy" if "Memcpy" in name else "set" if "Memset" in name else "kernel"


def capture_labels(events: list) -> dict:
    """The node labels of the graph captured in a trace, by kind of node: the
    span path, below ``graph.capture``, of each call that launches a kernel,
    copy or set while the stream captures (between ``cudaStreamBeginCapture``
    and ``cudaStreamEndCapture``; the generators' fills before the capture
    begins run at once and are no nodes), in the order of the calls. Empty
    where the trace holds no one capture."""
    port = [e for e in events if e.get("cat") == PORT_SPAN and e.get("ph") == "X"]
    paths = span_paths(port)
    captures = [i for i, e in enumerate(port) if e["name"] == CAPTURE]
    if len(captures) != 1:
        return {}
    cap = port[captures[0]]
    calls = sorted((e for e in measure.host_events(events)
                    if cap["ts"] <= e["ts"] < cap["ts"] + cap["dur"]), key=lambda e: e["ts"])
    begin = [e["ts"] for e in calls if e["name"].startswith("cudaStreamBeginCapture")]
    end = [e["ts"] for e in calls if e["name"].startswith("cudaStreamEndCapture")]
    if len(begin) != 1 or len(end) != 1:
        return {}
    calls = [e for e in calls if begin[0] < e["ts"] < end[0] and is_launch(e["name"])]
    inner = innermost(port, [e["ts"] for e in calls])
    below = paths[captures[0]] + "/"
    labels = collections.defaultdict(list)
    for call, i in zip(calls, inner):
        labels[kind(call)].append(paths[i][len(below):] if paths[i].startswith(below) else "")
    return dict(labels)


def attribute(dev: list, host: list, port: list, labels: dict):
    """(span path of each device event, problems, graph launches labelled).
    Eager operations take the innermost span at their launching call. The
    operations of each graph launch take ``labels`` (:func:`capture_labels`)
    in order, kernels, copies and sets each their own. A launch with fewer
    operations of a kind than labelled lost records in the profiler (seen
    with the twin cell's ~3000 nodes): it is left at its launch's path and
    not counted; one with more, or more than a quarter of the launches
    short, is a problem."""
    paths = span_paths(port)
    calls = {e["args"]["correlation"]: e for e in host
             if "correlation" in e.get("args", {})}
    call_of = [calls.get(e.get("args", {}).get("correlation")) for e in dev]
    inner = innermost(port, [c["ts"] if c is not None else float("-inf") for c in call_of])
    at = [paths[i] if i is not None else "" for i in inner]
    out, replays, problems = list(at), collections.defaultdict(list), []
    for k, c in enumerate(call_of):
        if c is not None and c["name"].startswith(GRAPH_LAUNCH):
            replays[c["args"]["correlation"]].append(k)
    labelled = short = 0
    for ops in replays.values():
        by_kind = collections.defaultdict(list)
        for k in sorted(ops, key=lambda k: dev[k]["ts"]):
            by_kind[kind(dev[k])].append(k)
        counts = {what: (len(by_kind.get(what, [])), len(labels.get(what, [])))
                  for what in set(by_kind) | set(labels)}
        over = [f"a graph launch ran {got} {what} operations; the capture labelled {want}"
                for what, (got, want) in sorted(counts.items()) if got > want]
        problems += [p for p in over if p not in problems]
        if over:
            continue
        if any(got < want for got, want in counts.values()):
            short += 1
            continue
        labelled += 1
        for what, got in by_kind.items():
            for k, label in zip(got, labels[what]):
                out[k] = at[k] + "/" + label if label else at[k]
    if short * 4 > len(replays):
        problems.append(f"{short} of {len(replays)} graph launches short of their labels")
    return out, problems, labelled


def self_check(counters: dict, graph: bool, calls: int, step_spans: int, steps: int) -> list:
    """What is wrong with a span window (empty when nothing is): spans
    dropped, a step span missing, and on the graph path a capture other than
    one or a replay count other than the ``calls`` of the captured step."""
    problems = []
    if step_spans != steps:
        problems.append(f"{step_spans} step spans in a window of {steps} steps")
    if counters.get("dropped", 0):
        problems.append(f"{counters['dropped']} spans dropped")
    if graph:
        if counters.get("graph.captures") != 1:
            problems.append(f"{counters.get('graph.captures')} graph captures")
        if counters.get("graph.replays") != calls:
            problems.append(f"{counters.get('graph.replays')} graph replays in {calls} steps")
    return problems


def idle_gaps(dev: list, host: list, port: list) -> list:
    """``measure.idle_gaps`` over the trace's device and host events, with
    the program's spans as host events named ``port:<span>``: a gap under a
    runtime call keeps the call's name (the shortest event that covers it);
    one the harness would name ``host:_between_ops`` gets the innermost
    span the host was in."""
    spread = dev + host
    lo = min((e["ts"] for e in spread), default=0.0)
    hi = max((e["ts"] + e["dur"] for e in spread), default=0.0)
    named = host + [dict(e, name="port:" + e["name"]) for e in port]
    return measure.idle_gaps(dev, named, lo, hi)


def under(path: str, name: str) -> bool:
    return name in path.split("/")


def _export(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _table(recorded: list, own: list, steps: set, dev: list, op_paths: list, n: int,
           dev_steps: int) -> list:
    """Per span name over the ``n`` profiled steps: calls and host self ms per
    step, and device ms and operations per step over ``dev_steps`` (the
    operations whose innermost span it is)."""
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0, 0])
    for s, t in zip(recorded, own):
        if s.step in steps and t is not None:
            rows[s.name][0] += 1
            rows[s.name][1] += t / 1e6
    for e, p in zip(dev, op_paths or []):
        if p:
            rows[p.rsplit("/", 1)[-1]][2] += e["dur"] / 1e3
            rows[p.rsplit("/", 1)[-1]][3] += 1
    return sorted(((name, c / n, h / n, d / dev_steps, k / dev_steps)
                   for name, (c, h, d, k) in rows.items()),
                  key=lambda r: -r[3])


def run_cell(cell, seed: int, device="cuda"):
    """The span context of one extra window of ``cell`` (see the module's
    docstring), or None for a program without the recorder."""
    found = program_trace()
    if found is None:
        return None
    trace, merge_spans = found
    traffic = cell.traffic
    n = traffic["trace_steps"]
    total = 3 * n + 1
    warm = traffic["warmup_steps"]
    cuda = torch.device(device).type == "cuda"
    graph = traffic["path"] == "graph" and cuda
    labels, calls = {}, {}
    with trace.recording(SPANS_PER_STEP * (warm + total + 8)):
        prog = harness.Program(cell, device)
        state = sampler.start_states(cell.sim, seed, 1, device)[0]
        rec = harness.Recorder(prog.step, device, total + 1, seed, 0,
                               traffic["episode_steps"] - 1)
        rec.hook = capture = harness.Profiler(cuda, 0, 1) if graph else None
        prog.episode(rec, seed, -1, state, warm, set())
        if capture is not None:
            capture.close()
            captured = merge_spans(_export(capture.prof))["traceEvents"]
            labels = capture_labels(captured)
            calls = collections.Counter(e["name"] for e in measure.host_events(captured))
        if cuda:
            torch.cuda.synchronize()
        rec.hook = window = harness.Profiler(cuda, n, n)
        rec.start()
        t0 = time.perf_counter_ns()
        e = 0
        while rec.n < total:
            prog.episode(rec, seed, e, state, min(traffic["episode_steps"], total - rec.n),
                         set())
            e += 1
        window.close()
        if cuda:
            torch.cuda.synchronize()
        events = merge_spans(_export(window.prof))["traceEvents"]
        recorded, counters = trace.spans(), trace.counters()
        own = trace.self_ns(recorded)
    boundaries = measure.untraced_steps(rec.intervals_ms(), n, n) if cuda else []
    del prog, rec
    step_spans = [s for s in recorded if s.parent < 0 and s.name in STEP_SPANS
                  and s.start_ns >= t0]
    problems = self_check(counters, graph, warm + total, len(step_spans), total)
    dev = measure.device_events(events)
    host = measure.host_events(events)
    port = [e for e in events if e.get("cat") == PORT_SPAN and e.get("ph") == "X"]
    op_paths, bad, labelled = attribute(dev, host, port, labels)
    problems += bad
    dev_steps = labelled if graph else n  # steps whose operations all have a span path
    host_ms = [(s.end_ns - s.start_ns) / 1e6 for s in step_spans]
    untraced = measure.untraced_steps(host_ms, n, n)
    profiled = {s.step for s in step_spans[n:2 * n]}
    for row in _table(recorded, own, profiled, dev, op_paths, n, max(dev_steps, 1)):
        log("[spans] {} calls {:.2f}/step host self {:.4f} ms/step device {:.4f} ms/step "
            "ops {:.2f}/step".format(*row))
    log(f"[spans] host {mean_ms(untraced)} ms a step over the untraced steps (before the "
        f"profiled ones {mean_ms(host_ms[:n])}, after {mean_ms(host_ms[2 * n + 1:])}); "
        f"step boundaries {mean_ms(boundaries)} ms apart; device operations a profiled step "
        + json.dumps({k: v / n for k, v in collections.Counter(kind(e) for e in dev).items()}))
    if graph:
        setup = {k: sum(x.end_ns - x.start_ns for x in recorded if x.name == k) / 1e6
                 for k in ("graph.warmup", CAPTURE)}
        log(f"[spans] capture: graph.warmup {setup['graph.warmup']:.3f} ms, graph.capture "
            f"{setup[CAPTURE]:.3f} ms (under a CUDA-activity profiler); nodes labelled "
            + json.dumps({k: len(v) for k, v in labels.items()}) + "; the step's calls "
            + json.dumps(calls))
    log("[spans] idle gaps (s, over the profiled steps): "
        + json.dumps(idle_gaps(dev, host, port)))
    log(f"[spans] {len(dev)} device operations over {n} profiled steps, "
        f"{sum(1 for p in op_paths if p)} under a span, {labelled} graph launches labelled; "
        f"counters {json.dumps(counters)}; "
        + ("self-check passed" if not problems else "self-check failed: " + "; ".join(problems)))
    return {"device_events": dev, "op_spans": op_paths, "program_spans": port,
            "host_events": host, "steps": dev_steps,
            "untraced_step_spans_ms": untraced, "span_check": "; ".join(problems) or None,
            "measure": measure}


def _run_args():
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return args.workload, args.seed


def context(ctx: dict):
    """The span context of a traced run: ``ctx`` itself where it already
    holds ``op_spans``, else the extra window of the run's own cell and seed
    (``--workload``, ``--seed``), run once per process; None where there is
    no card, no such run or no recorder in the program."""
    if "op_spans" in ctx:
        return ctx
    workload, seed = _run_args()
    if workload is None or seed is None or not torch.cuda.is_available():
        return None
    key = (workload, seed)
    if key not in _SIDE:
        from .cell import load_cell

        try:
            _SIDE[key] = run_cell(load_cell(workload), seed)
        except Exception:  # a per-layer reading must not end the traced run
            log("[spans] the span window failed:\n" + traceback.format_exc())
            _SIDE[key] = None
    return _SIDE[key]


def checked(ctx: dict):
    """The span context if its self-check passed, else None."""
    s = context(ctx)
    return s if s is not None and s["span_check"] is None else None


def device_ms(s: dict, keep, busy: bool = True):
    """Device time per step (ms) of the operations whose span path ``keep``
    accepts: the union of their intervals, or with ``busy`` False the sum of
    their durations; None where there is none."""
    ops = [e for e, p in zip(s["device_events"], s["op_spans"]) if keep(p)]
    if not ops:
        return None
    us = s["measure"].busy_us(ops) if busy else sum(e["dur"] for e in ops)
    return us / 1e3 / s["steps"]


def mean_ms(values: list):
    return statistics.fmean(values) if values else None
