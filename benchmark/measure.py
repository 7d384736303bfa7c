"""The arithmetic from step boundaries and traces to metrics.

Plain functions, so that the CPU tests hold them on synthetic steps and
traces. The trace arithmetic is a frozen copy of
``profile_control_step.py``'s (``DEVICE_CATS`` :52, ``device_events`` :64,
``busy_us`` :72, ``_group`` :99): device work is the events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` of an exported Chrome trace;
annotations that appear on the device timeline are no device work and are
left out; busy time is the union of the device events' intervals.
"""

from __future__ import annotations

import collections
import json
import math

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
BETWEEN_OPS = "host:_between_ops"
TOP = 10


def steps_per_s(steps: int, seconds: float) -> float:
    """Control steps completed over the wall time of the window."""
    return steps / seconds


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95 % of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def load_trace(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_events(events: list) -> list:
    """Device work of a trace: kernels, copies and sets."""
    return [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]


def host_events(events: list) -> list:
    return [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]


def union(intervals) -> list:
    """The union of [start, stop) intervals as sorted disjoint intervals."""
    out = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def busy_us(events: list) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    return sum(stop - start for start, stop in union((e["ts"], e["ts"] + e["dur"])
                                                      for e in events))


def by_name(events: list) -> dict:
    """Total duration (us) and count of the events of each name."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        out[e["name"]][0] += e["dur"]
        out[e["name"]][1] += 1
    return out


def top_ops(events: list, n: int = TOP) -> list:
    """[name, seconds] of the device operations that took most time."""
    totals = sorted(((dur, name) for name, (dur, _) in by_name(events).items()), reverse=True)
    return [[_short(name), dur / 1e6] for dur, name in totals[:n]]


def idle_gaps(dev: list, host: list, start: float, stop: float, n: int = TOP) -> list:
    """[name, seconds] of the device's idle time inside [start, stop),
    named by the innermost host event under each gap's midpoint (the
    shortest that covers it), ``host:_between_ops`` where none does; summed
    by name, the longest first."""
    busy = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, at = [], start
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, min(lo, stop)))
        at = max(at, hi)
    if at < stop:
        gaps.append((at, stop))
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host)
    totals = collections.defaultdict(float)
    active, i = [], 0
    for lo, hi in gaps:  # in order of time: a sweep over the host spans
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > mid]
        inner = [(b - a, name) for a, b, name in active]
        totals[min(inner)[1] if inner else BETWEEN_OPS] += hi - lo
    ranked = sorted(((v, k) for k, v in totals.items()), reverse=True)
    return [[_short(name), us / 1e6] for us, name in ranked[:n]]


def _short(name: str) -> str:
    """A device or host op's name in at most 64 letters, digits and _."""
    out = "".join(ch if ch.isalnum() or ch in "_:" else "_" for ch in name)
    return out[:64]


def qualified_name(name: str) -> str:
    """The qualified function name of a demangled kernel signature, its
    template arguments (which may hold parentheses of their own) and its
    parameters left out:
    ``std::enable_if<!(false), void>::type internal::gemvx::kernel<int, ...>(...)``
    -> ``internal::gemvx::kernel``."""
    head, depth = [], 0
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            head.append(ch)
    return "".join(head).split("(", 1)[0].strip().split(" ")[-1]


def kernel_name(name: str) -> str:
    """The function name of a demangled kernel signature:
    ``void ns::spectral_horizon_kernel<true, 16>(Buffers, ...)`` ->
    ``spectral_horizon_kernel``."""
    return qualified_name(name).split("::")[-1]


def untraced_steps(intervals_ms, first: int, steps: int) -> list:
    """The boundary intervals of a run's untraced steps: all but the
    ``steps`` traced ones from step ``first`` on and the step after them,
    which holds the sub-window's closing synchronise (the first traced
    step holds the opening one). Their mean, over the whole run, is the
    rate's own mix of the two levels a run's steps sit on (PERF.md)."""
    return list(intervals_ms[:first]) + list(intervals_ms[first + steps + 1:])


def untraced_window_us(untraced_ms, steps: int):
    """The wall time (us) that ``steps`` steps take untraced: the mean
    interval between the step boundaries of the untraced steps, times
    ``steps``. The profiler's recording of each launch (each node of a
    replayed graph) lengthens the traced sub-window's own wall time, so the
    shares of the device's time divide by this instead. None without
    untraced steps."""
    if not untraced_ms:
        return None
    return 1e3 * sum(untraced_ms) / len(untraced_ms) * steps


def device_ms_of(events: list, names, steps: int) -> float:
    """Device time per step (ms) of the kernels whose function name is in
    ``names``."""
    names = set(names)
    return sum(e["dur"] for e in events if kernel_name(e["name"]) in names) / 1e3 / steps
