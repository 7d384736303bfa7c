#!/usr/bin/env python3
"""Where the time of one control step goes on one NVIDIA GPU.

    python3 profile_control_step.py [--slice spectral|grid|twin] [--steps 50] [--trace PATH]
    python3 profile_control_step.py --sweep-clusters

Runs the control step of one of ``chip_smoke.py``'s slices, the spectral
slice, the grid-planner slice or the twin slice (one MPPI solve, one
Yoshida-4 environment step, the energies, the nominal shift: the body of
``mpc_rollout``) with ``record_function`` ranges around plan / env step /
energies, after 20 warm-up steps, and prints:

1. the untraced wall time per step: synchronised after every step (median
   and p90 of 100 steps, three repeats) and one chain of 100 steps with a
   single synchronise at the end;
2. for a traced window of ``--steps`` steps (``torch.profiler``, CPU + CUDA):
   the device launches per step and the device busy time per step. Both are
   read from the exported trace's device events of category ``kernel``,
   ``gpu_memcpy`` and ``gpu_memset``; busy time is the union of their
   intervals. The ranges also appear on the device timeline, as events of
   category ``gpu_user_annotation`` that span whole ranges; they are no
   device work and are left out;
3. the device idle share twice: against the traced window's own wall time
   (tracing slows the host) and against the untraced synchronised median
   of step 1, measured in the same process just before;
4. device time per step by kernel name, the planner kernel's device time
   per step and per launch, and host time per step in each range.

``--sweep-clusters`` instead times kernel 1 at each main path's shape
(spectral slice, twin slice, N=20000, config-4) on every cluster size whose
slices fit shared memory, forced through the wrapper's private launch,
beside the size ``launch_geometry`` chooses: CUDA events around 20
back-to-back launches (10 at config-4), which at these sizes keep the
device busy, so the time per launch is the device's.

Imports only ``plasma_control_tpu_torch`` and ``chip_smoke``'s settings.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

from chip_smoke import CFG4_MAX_MODE, CFG4_SIM, GRID_MPC, MPC, TWIN_MPC, _setup

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("plan", "env_step", "energies")
# the planner kernels' device names: kernel 1 and kernels 5-6
PLANNER_KERNELS = ("spectral_horizon_kernel", "horizon_kernel")
SLICES = {
    "spectral": dict(mpc=MPC),
    "grid": dict(mpc=GRID_MPC),
    "twin": dict(sim=CFG4_SIM, max_mode=CFG4_MAX_MODE, mpc=TWIN_MPC),
}


def device_events(trace_path: str) -> list:
    """Device work of an exported Chrome trace: kernels, copies and sets."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]


def busy_us(events: list) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def summarize(trace_path: str, steps: int, wall_ms: float, untraced_ms: float) -> dict:
    """Launches, busy time and idle shares per step from a trace of ``steps`` steps."""
    events = device_events(trace_path)
    by_cat = collections.Counter(e["cat"] for e in events)
    busy = busy_us(events) / 1e3 / steps
    return dict(
        launches_per_step={c: by_cat[c] / steps for c in DEVICE_CATS},
        device_busy_ms_per_step=busy,
        traced_ms_per_step=wall_ms / steps,
        idle_share_traced=1.0 - busy / (wall_ms / steps),
        idle_share_untraced=1.0 - busy / untraced_ms,
        by_name=sorted(
            ((sum(e["dur"] for e in es) / steps, len(es) / steps, name)
             for name, es in _group(events).items()),
            reverse=True,
        ),
    )


def _group(events: list) -> dict:
    groups = collections.defaultdict(list)
    for e in events:
        groups[e["name"]].append(e)
    return groups


def sweep_clusters(torch) -> None:
    """Kernel 1's time per launch at each cluster size, main-path shapes."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (("spectral slice", 5000, 384, 6, 8, False), ("twin slice", 10000, 1024, 10, 16, True),
              ("N=20000", 20000, 64, 10, 16, False), ("config-4", 100_000, 384, 10, 16, False))
    for what, n, k, h, km, twin in shapes:
        x = torch.rand(n, generator=gen, device=dev) * 50.0
        v = 1.5 * torch.randn(n, generator=gen, device=dev)
        u_c, u_s = (0.3 * torch.randn((k, h, km), generator=gen, device=dev) for _ in range(2))
        tc, ts = ((100.0 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
                  if twin else (None, None))
        kw = dict(length=50.0, dt=0.1, n0=1.0, n_particles=n, rot=True, twin_c=tc, twin_s=ts,
                  n_modes=None)
        reps = 10 if n == 100_000 else 20
        chosen = sh.launch_geometry(n, True)
        for c in (1, 2, 4, 8, 16):
            s = -(-n // c)
            if 12 * s > sh._STATE_BYTES:
                continue
            geo = sh.Geometry(c, s, 12 * s)
            fn = lambda: sh._spectral_horizon_cuda(x, v, u_c, u_s, geometry=geo, **kw)  # noqa: E731
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            print(f"[sweep] {what} (K={k}, H={h}, Km={km}, N={n}, rot{', corrected' if twin else ''})"
                  f": C={c:2d}, {s * 12 / 1024:.1f} KiB per CTA: "
                  f"{start.elapsed_time(end) / reps:.4f} ms per launch"
                  f"{'  <- launch_geometry' if c == chosen.cluster else ''}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice", choices=tuple(SLICES), default="spectral",
                    help="chip_smoke.py's spectral, grid-planner or twin slice")
    ap.add_argument("--steps", type=int, default=50, help="control steps in the traced window")
    ap.add_argument("--trace", default="chiprun_out/control_step_trace.json",
                    help="where to write the Chrome trace")
    ap.add_argument("--sweep-clusters", action="store_true",
                    help="time kernel 1 at each cluster size instead of a control step")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from plasma_control_tpu_torch.control.mpc import plan
    from plasma_control_tpu_torch.models.pic import init_state, step
    from plasma_control_tpu_torch.models.rollout import _energies

    if not torch.cuda.is_available():
        raise SystemExit("profile_control_step: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.sweep_clusters:
        sweep_clusters(torch)
        return 0
    print(f"slice: {args.slice}", flush=True)

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, **SLICES[args.slice])
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    mean = torch.zeros((mpc.horizon, 2 * ctrl.max_mode), device=dev)
    sigma = torch.tensor(mpc.sigma0, device=dev)

    def control_step(state, mean):
        with record_function("plan"):
            action, new_mean, _ = plan(state, mean, sigma, gen, grid, cfg, ctrl, mpc, act)
        with record_function("env_step"):
            state = step(state, grid, cfg, act.compute_e_packed(action))
        with record_function("energies"):
            _energies(state, grid, cfg)
        return state, torch.cat([new_mean[1:], new_mean[-1:]])

    for _ in range(20):
        state, mean = control_step(state, mean)
    torch.cuda.synchronize()

    medians = []
    for rep in range(3):
        times = []
        for _ in range(100):
            t0 = time.perf_counter()
            state, mean = control_step(state, mean)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        medians.append(statistics.median(times))
        print(f"untraced, synchronised each step, rep {rep}: median {medians[-1]:.4f} ms, "
              f"p90 {times[89]:.4f} ms, min {times[0]:.4f} ms (100 steps)", flush=True)
    t0 = time.perf_counter()
    for _ in range(100):
        state, mean = control_step(state, mean)
    torch.cuda.synchronize()
    print(f"untraced chain of 100 steps, one synchronise: "
          f"{10 * (time.perf_counter() - t0):.4f} ms/step", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, mean = control_step(state, mean)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)

    untraced = statistics.median(medians)
    s = summarize(args.trace, args.steps, wall_ms, untraced)
    launches = s["launches_per_step"]
    print(f"traced window: {args.steps} steps, {s['traced_ms_per_step']:.4f} ms/step wall; "
          f"device launches per step: {launches['kernel']:.2f} kernels, "
          f"{launches['gpu_memcpy']:.2f} copies, {launches['gpu_memset']:.2f} sets "
          f"(range annotations excluded)")
    print(f"device busy {s['device_busy_ms_per_step']:.4f} ms/step (union of device events); "
          f"idle {100 * s['idle_share_traced']:.2f} % of the traced step, "
          f"{100 * s['idle_share_untraced']:.2f} % of the untraced synchronised median "
          f"({untraced:.4f} ms, median of the three reps above)")
    print("device time per step by name (us; launches per step):")
    for us, n, name in s["by_name"][:20]:
        print(f"  {us:9.2f}  {n:6.2f}  {name[:110]}")
    planner = [(us, n, name) for us, n, name in s["by_name"]
               if any(k in name for k in PLANNER_KERNELS)]
    for us, n, name in planner:
        print(f"planner kernel {name[:80]}: {us / 1e3:.5f} ms device time per step, "
              f"{us / 1e3 / n:.5f} ms per launch, {n:.2f} launches per step")
    host = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.key in RANGES:
            host[e.key] += e.cpu_time_total / 1e3 / args.steps
    print("host time per step in the ranges (ms): "
          + ", ".join(f"{r} {host[r]:.4f}" for r in RANGES))
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
