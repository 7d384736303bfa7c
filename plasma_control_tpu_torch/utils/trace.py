"""Spans and counters at the layer boundaries of the port's control path.

A span is one pass through a layer: its name, its start and end on the host
(``time.perf_counter_ns``), the index of the span that encloses it and the
id of the control step it belongs to (:func:`next_step`, which
:func:`..control.mpc.closed_loop` calls at the top of every step). A counter
adds up events the spans do not show (a graph captured, a graph replayed).

Recording is off unless a :func:`recording` block is open. Off, :func:`span`
reads one module global and returns one shared object that does nothing: no
clock is read and nothing is allocated. On, spans go into arrays that
:func:`recording` allocates up front; a span past the capacity is counted as
``dropped`` and nothing grows, so no garbage collection runs because of it.
Neither state touches a tensor, launches device work or synchronises, so a
CUDA graph captured under a recording holds the same work as one captured
without it.

:func:`chrome_events` places the spans on a ``torch.profiler`` trace's
timeline: an exported trace's ``ts`` is the microseconds of
``time.time_ns()`` after the trace's ``baseTimeNanoseconds``, and
:func:`recording` measures the offset between ``perf_counter_ns`` and
``time_ns`` when it opens. :func:`..utils.timing.merge_spans` adds them to a
trace; :func:`..utils.timing.profile_trace` does so for the trace it writes.

    with recording(capacity=100_000):
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, gen, n_steps=50)
        tree = spans()
"""

from __future__ import annotations

import contextlib
import os
import time
from array import array
from typing import NamedTuple, Optional

__all__ = ["Span", "recording", "active", "span", "next_step", "count", "spans", "counters",
           "self_ns", "chrome_events"]

CATEGORY = "port_span"
_CLOCK_PAIRS = 7  # back-to-back clock readings; the tightest sets the offset


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: Optional[int]  # None while the span is open
    parent: int  # index of the enclosing span in spans(), -1 at the top
    step: int  # id of the control step (next_step), -1 before the first


class _Off:
    """The shared span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    """The recording's span of one name; nesting lives on the recording's
    stack, so one object serves every entry of its name."""

    __slots__ = ("rec", "name_id")

    def __init__(self, rec: "_Recording", name_id: int):
        self.rec, self.name_id = rec, name_id

    def __enter__(self):
        rec = self.rec
        i = rec.n
        if i < rec.capacity:
            rec.names[i] = self.name_id
            rec.parents[i] = rec.stack[-1]
            rec.steps[i] = rec.step
            rec.n = i + 1
            rec.starts[i] = time.perf_counter_ns()
        else:
            rec.dropped += 1
            i = -1
        rec.stack.append(i)
        return None

    def __exit__(self, exc_type, exc, tb):
        t = time.perf_counter_ns()
        rec = self.rec
        i = rec.stack.pop()
        if i >= 0:
            rec.ends[i] = t
        return False


class _Recording:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"a recording needs a capacity of at least 1 span, not {capacity}")
        self.capacity, self.n, self.dropped, self.step = capacity, 0, 0, -1
        self.starts = array("q", bytes(8 * capacity))
        self.ends = array("q", bytes(8 * capacity))
        self.parents = array("q", bytes(8 * capacity))
        self.steps = array("q", bytes(8 * capacity))
        self.names = array("q", bytes(8 * capacity))
        self.stack = [-1]  # indices of the open spans; -1 is the top level
        self.objects, self.name_list = {}, []
        self.counts = {}
        self.offset_ns = _wall_offset_ns()

    def span(self, name: str) -> _Span:
        obj = self.objects.get(name)
        if obj is None:
            obj = self.objects[name] = _Span(self, len(self.name_list))
            self.name_list.append(name)
        return obj


def _wall_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a few
    back-to-back readings (the wall clock read between two of the other)."""
    best = None
    for _ in range(_CLOCK_PAIRS):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_active: Optional[_Recording] = None


@contextlib.contextmanager
def recording(capacity: int):
    """Record spans and counters inside the block, at most ``capacity``
    spans (the rest are counted as ``dropped``). Read them with
    :func:`spans`, :func:`counters` and :func:`chrome_events` before the
    block ends; recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    _active = _Recording(capacity)
    try:
        yield
    finally:
        _active = None


def active() -> bool:
    """Whether a recording is open."""
    return _active is not None


def span(name: str):
    """A context manager around one pass through the layer ``name``."""
    rec = _active
    if rec is None:
        return _OFF
    return rec.span(name)


def next_step() -> Optional[int]:
    """Start a new control step: the spans opened from here on share its id,
    which is returned (None when not recording)."""
    rec = _active
    if rec is None:
        return None
    rec.step += 1
    return rec.step


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _active
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def spans() -> list:
    """The open recording's spans in the order they started ([] when not
    recording)."""
    rec = _active
    if rec is None:
        return []
    out = []
    for i in range(rec.n):
        end = rec.ends[i]
        out.append(Span(rec.name_list[rec.names[i]], rec.starts[i], end if end else None,
                        rec.parents[i], rec.steps[i]))
    return out


def counters() -> dict:
    """The open recording's counters and ``dropped``, the spans that found
    no room ({} when not recording)."""
    rec = _active
    if rec is None:
        return {}
    return {**rec.counts, "dropped": rec.dropped}


def self_ns(recorded: list) -> list:
    """Each closed span's self time: its duration less the time its direct
    children cover (children of one thread do not overlap); None for a span
    still open."""
    out = [None if s.end_ns is None else s.end_ns - s.start_ns for s in recorded]
    for s in recorded:
        if s.parent >= 0 and s.end_ns is not None and out[s.parent] is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def chrome_events(base_ns: int) -> list:
    """The open recording's closed spans as Chrome-trace complete events
    (``ph`` X, ``cat`` :data:`CATEGORY`, ``ts`` and ``dur`` in us) on the
    timeline of a trace whose ``baseTimeNanoseconds`` is ``base_ns``, in a
    thread of their own; ``args`` hold the span's index, its parent's and
    its step."""
    rec = _active
    if rec is None:
        return []
    pid, tid = os.getpid(), 0
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "port spans"}}]
    shift = rec.offset_ns - base_ns
    for i, s in enumerate(spans()):
        if s.end_ns is None:
            continue
        out.append({"ph": "X", "cat": CATEGORY, "name": s.name, "pid": pid, "tid": tid,
                    "ts": (s.start_ns + shift) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"index": i, "parent": s.parent, "step": s.step}})
    return out
