"""One run of one cell: set-up, the measured window, the traced sub-window
and the comparison with the reference.

The window drives the program's own closed loop: ``closed_loop`` over
``control_step_fn`` (the ``eager`` path, exactly ``mpc_rollout``), or
``aot_mpc_rollout`` over ``GraphedStep(control_step_fn(...))`` (the ``graph``
path, the captured step that ``run_mpc --aot`` serves). The benchmark hands
the loop a thin wrapper of the step that records a CUDA event from a pool
made at set-up after every step (the step boundaries), and at the sampled
steps keeps copies of the step's input and output for the comparison. The
window runs whole episodes from start states drawn at set-up until
``--seconds`` have passed, then synchronises once.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import counts, judge, measure, sampler
from .cell import Cell, load_metric
from .reference import CONTROL, REFERENCE, Reference


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Recorder:
    """The program's step with the benchmark's bookkeeping around it: a CUDA
    event from a pool made at set-up after every step, and at the sampled
    steps a copy of the step's input and output into buffers allocated at
    the first sampled step of the warm-up, so that the window allocates
    nothing. The first episode's steps 0, 1 and its last are always kept;
    of the other sampled steps ``keep`` are, a uniform draw from the seed
    (reservoir sampling)."""

    FIXED = 3

    def __init__(self, step, device, pool: int, seed: int, keep: int, last: int):
        self.step, self.keep, self.last = step, keep, last
        self.cuda = torch.device(device).type == "cuda"
        self.events = [self._event() for _ in range(pool)] if self.cuda else []
        self.n = 0  # steps taken since the window started
        self.episode, self.i, self.sample = 0, 0, set()
        self.rng = random.Random(sampler.derive(seed, 2))
        self.seen, self.kept, self.buffers = 0, {}, None
        self.hook = None  # called before the step with the window's step index

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        """Begin the window: forget the warm-up's records; the first
        boundary is recorded now."""
        self.n, self.seen, self.kept = 0, 0, {}
        if self.cuda:
            self.first = self._event()
            self.first.record()

    def begin_episode(self, episode: int, sample: set) -> None:
        self.episode, self.i, self.sample = episode, 0, sample

    def _slot(self):
        """The buffer the current sampled step goes to, or None."""
        if self.episode == 0 and self.i in (0, 1, self.last):
            return (0, 1, self.last).index(self.i)
        self.seen += 1
        j = self.seen - 1 if self.seen <= self.keep else self.rng.randrange(self.seen)
        return self.FIXED + j if j < self.keep else None

    def __call__(self, x, v, mean, generator=None, noise=None):
        if self.hook is not None:
            self.hook(self.n)
        slot = self._slot() if self.i in self.sample else None
        if slot is not None:
            inputs = {"x": x, "v": v, "mean": mean}
            if self.buffers is None:
                self.buffers = [{k: torch.empty_like(t) for k, t in inputs.items()}
                                for _ in range(self.FIXED + self.keep)]
            buf = self.buffers[slot]
            for k, t in inputs.items():
                buf[k].copy_(t)
            self.kept[slot] = {"episode": self.episode, "step": self.i,
                               "gen_state": generator.get_state()}
        out = self.step(x, v, mean, generator, noise)
        if self.cuda:
            if self.n >= len(self.events):
                self.events.append(self._event())
            self.events[self.n].record()
        if slot is not None:
            names = ("x1", "v1", "mean1", "action", "pe", "ke", "ie", "best")
            if "x1" not in self.buffers[slot]:
                for b in self.buffers:
                    b.update({k: torch.empty_like(t) for k, t in zip(names, out)})
            for k, t in zip(names, out):
                self.buffers[slot][k].copy_(t)
        self.n += 1
        self.i += 1
        return out

    @property
    def records(self) -> list:
        """The kept steps: input, output, episode, step and generator state."""
        return [dict(self.buffers[s], **meta) for s, meta in sorted(self.kept.items())]

    def intervals_ms(self) -> list:
        """Milliseconds between consecutive step boundaries, after a
        synchronise."""
        marks = [self.first] + self.events[:self.n]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


class Profiler:
    """``torch.profiler`` over a bounded sub-window of whole steps, from a
    synchronise before its first step to one after its last. On the card it
    records the device's activity only (kernels, copies, sets and the CUDA
    runtime calls that launch them): recording every host op as well slows
    the host enough to starve the device and would overstate its idle
    share."""

    def __init__(self, cuda: bool, first: int, steps: int):
        self.cuda, self.first, self.steps = cuda, first, steps
        self.prof = None
        self.wall_s = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, n: int) -> None:
        if n == self.first:
            self._sync()
            self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                            else ProfilerActivity.CPU])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif n == self.first + self.steps:
            self._sync()
            self.wall_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)

    def close(self) -> None:
        """Stop the profiler if the sub-window did not close it."""
        if self.prof is not None and self.wall_s is None:
            self.prof.__exit__(None, None, None)

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return measure.load_trace(path)
        finally:
            os.remove(path)


def _port():
    """The program's entry points, imported when a run starts."""
    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control import mpc as port_mpc
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.io import aot
    from plasma_control_tpu_torch.models.pic import PlasmaState
    from plasma_control_tpu_torch.ops.grid import make_grid

    return dict(SimConfig=SimConfig, ControlConfig=ControlConfig, MPCConfig=MPCConfig,
                mpc=port_mpc, make_actuator=make_actuator, aot=aot, PlasmaState=PlasmaState,
                make_grid=make_grid)


def _episode_sample(seed: int, episode: int, steps: int) -> set:
    """The steps of an episode whose input and output are kept: two drawn
    from the seed, and in the first episode also its first two (the start
    and the carry into the next step) and its last."""
    rng = random.Random(sampler.derive(seed, 1000 + episode))
    chosen = set(rng.sample(range(2, steps - 1), 2))
    if episode == 0:
        chosen |= {0, 1, steps - 1}
    return chosen


class Program:
    """The system under test, built once per process: the configuration's
    grid, actuator and control step (captured as a graph on the ``graph``
    path at its first call), and the generator its solves draw from."""

    def __init__(self, cell: Cell, device):
        p = _port()
        self.p, self.cell, self.device = p, cell, device
        self.cuda = torch.device(device).type == "cuda"
        cfg = p["SimConfig"](**cell.sim)
        ctrl = p["ControlConfig"](**cell.control)
        mpc = p["MPCConfig"](**cell.mpc)
        grid = p["make_grid"](cfg.n_mesh, cfg.length, device=device)
        act = p["make_actuator"](cfg.length, cfg.n_mesh, ctrl.max_mode,
                                 endpoint_grid=ctrl.endpoint_grid, device=device)
        self.step = p["mpc"].control_step_fn(grid, cfg, ctrl, mpc, act)
        if cell.traffic["path"] == "graph" and self.cuda:
            self.step = p["aot"].GraphedStep(self.step)
        self.h, self.d = mpc.horizon, 2 * ctrl.max_mode
        self.generator = torch.Generator(device=device)

    def episode(self, rec: Recorder, seed: int, e: int, state, count: int, sample: set):
        """One episode of ``count`` steps from ``state`` through the
        program's closed loop, the solves' generator seeded from (seed, e)."""
        gen, p = self.generator, self.p
        gen.manual_seed(sampler.derive(seed, 100 + e))
        rec.begin_episode(e, sample)
        state = p["PlasmaState"](*state)
        if self.cell.traffic["path"] == "graph":
            return p["aot"].aot_mpc_rollout(rec, state, gen, count, self.h, self.d)
        mean = torch.zeros((self.h, self.d), dtype=torch.float32, device=self.device)
        return p["mpc"].closed_loop(rec, state, mean, gen, count)


def failed_steps(out) -> torch.Tensor:
    """Steps of an episode whose field energy or applied action is not
    finite, counted on the device."""
    return (~torch.isfinite(out.field_energy)).sum() + (~torch.isfinite(out.coeffs)).any(-1).sum()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    traffic = cell.traffic
    n_steps = traffic["episode_steps"]
    prog = Program(cell, device)
    states = sampler.start_states(cell.sim, seed, traffic["start_states"], device)
    rec = Recorder(prog.step, device, int(seconds * traffic["max_steps_per_s"]) + n_steps, seed,
                   traffic["check_steps"] - Recorder.FIXED, n_steps - 1)
    # warm-up: the shapes of the window (and the graph's capture), off the record
    prog.episode(rec, seed, -1, states[-1], traffic["warmup_steps"], {0})
    if cuda:
        torch.cuda.synchronize()
    # the objects of the imports and the set-up go to the permanent generation,
    # so that no full collection in the window walks them
    gc.collect()
    gc.freeze()
    prof = None
    if trace:
        prof = Profiler(cuda, traffic["trace_start"], traffic["trace_steps"])
        rec.hook = prof
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    rec.start()
    failed, e = 0, 0
    try:
        while True:
            failed = failed + failed_steps(prog.episode(rec, seed, e, states[e % len(states)],
                                                        n_steps, _episode_sample(seed, e, n_steps)))
            e += 1
            # a traced run goes on until its sub-window has closed
            if time.perf_counter() - t0 >= seconds and (prof is None or prof.wall_s is not None):
                break
    finally:
        if prof is not None:
            prof.close()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    rec.hook = None
    steps = rec.n
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int(failed)
    result = {"correct": None, "attempted": steps, "failed": failed}
    iv = rec.intervals_ms() if cuda else []
    if trace:
        untraced = measure.untraced_steps(iv, prof.first, prof.steps)
        result["metrics"], result["breakdown"], trace_dev = _per_layer(cell, prof, untraced)
    else:
        per_ep = [sum(iv[i:i + n_steps]) / n_steps for i in range(0, len(iv), n_steps)]
        if per_ep:
            log("[episodes] mean ms per step, episode by episode: "
                + " ".join(f"{v:.4f}" for v in per_ep))
        values = {"control_steps_per_s": measure.steps_per_s(steps, window_s),
                  "step_ms_p95": measure.p95(iv) if iv else None, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if values.get(m["name"]) is not None}
        trace_dev = {}
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": name,
                        "count": cell.chips, "memory_peak_bytes": peak, **trace_dev}
    log(f"[window] {steps} steps in {e} episodes, {window_s:.3f} s; set-up {setup_s:.3f} s")
    # the comparison, once the program's state is freed
    records = rec.records
    del rec, prog, states, prof
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values, per_step = check(cell, records, device)
    log(f"[reference] {len(per_step)} steps compared in {time.perf_counter() - t_ref:.3f} s")
    ok, checks = judge.verdict(values, cell.limits)
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = checks
    return result


def check(cell: Cell, records: list, device, control: bool = False):
    """The comparison's numbers over the compared steps: (worst of each,
    per-step gaps). With ``control`` the reference at the lower precision
    stands in the program's place."""
    chosen = records
    ref = Reference(cell.sim, cell.control, cell.mpc, device, REFERENCE)
    if control:
        low = Reference(cell.sim, cell.control, cell.mpc, device, CONTROL)
        chosen = [judge.control_record(low, r) for r in chosen]
    per_step = [judge.step_gaps(ref, r) for r in chosen]
    return judge.worst(per_step, [] if control else records), per_step


def _per_layer(cell: Cell, prof, untraced_ms: list):
    """The cell's per-layer metrics from the traced sub-window (and the
    boundary intervals of the run's untraced steps, the time its steps take
    untraced), the breakdown, and the device's busy and window
    seconds.
    The window is the host's wall time between the two synchronises; every
    device event of the trace lies inside it."""
    if prof is None or prof.prof is None or prof.wall_s is None:
        raise RuntimeError("the traced sub-window did not run")
    events = prof.events()
    dev = measure.device_events(events)
    host = measure.host_events(events)
    window_us = prof.wall_s * 1e6
    ctx = {"device_events": dev, "host_events": host, "window_us": window_us,
           "steps": prof.steps, "step_intervals_ms": untraced_ms, "sim": cell.sim,
           "control": cell.control, "mpc": cell.mpc, "counts": counts, "measure": measure}
    metrics = {}
    for m in cell.per_layer:
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    spans = dev + host
    lo = min((e["ts"] for e in spans), default=0.0)
    hi = max((e["ts"] + e["dur"] for e in spans), default=0.0)
    breakdown = {"device_ops": measure.top_ops(dev),
                 "idle_gaps": measure.idle_gaps(dev, host, lo, hi)}
    log(f"[trace] {len(dev)} device events, {len(host)} host events over {hi - lo:.1f} us of "
        f"trace, {window_us:.1f} us of wall")
    return metrics, breakdown, {"busy_s": measure.busy_us(dev) / 1e6, "window_s": prof.wall_s}
