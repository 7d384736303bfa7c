#!/usr/bin/env python3
"""Kernel 1's time per launch at every cluster size, main-path shapes.

    python3 profile_control_step.py --sweep-clusters

Times kernel 1 at each main path's shape whose state fits shared memory
(spectral slice, twin slice, N=20000, config-4) on every cluster size whose
slices fit there, and at the global-scratch path's shapes (the million
controller's chunk of K=16 and its whole solve of K=384 at N=1M, Km=32; the
[global] check shape N=320000, K=32, Km=16) on every physical cluster C of
its 16 virtual ranks, with the clusters the card holds at once (A(C)),
beside one 16-CTA cluster per candidate; each forced through the wrapper's
private launch and marked where it is the size the wrapper chooses
(``launch_geometry``, ``stream_layout``). CUDA events around back-to-back
launches (20; 10 at config-4, 3 for K=384), which at these sizes keep the
device busy, so the time per launch is the device's.

Where the control step's time goes is the benchmark's traced run, the
program's spans over its kernels (``benchmark/spans.py``):
``python3 benchmark/run.py --workload <cell> --seed 0 --seconds 40 --trace 1``;
for a Chrome trace of any block with the port's spans above its kernels,
``plasma_control_tpu_torch.utils.timing.profile_trace`` inside a
``plasma_control_tpu_torch.utils.trace.recording``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def _ms_per_launch(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sweep_clusters(torch) -> None:
    """Kernel 1's time per launch at each cluster size, main-path shapes."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(n, k, h, km, twin):
        x = torch.rand(n, generator=gen, device=dev) * 50.0
        v = 1.5 * torch.randn(n, generator=gen, device=dev)
        u_c, u_s = (0.3 * torch.randn((k, h, km), generator=gen, device=dev) for _ in range(2))
        tc, ts = ((100.0 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
                  if twin else (None, None))
        return x, v, u_c, u_s, tc, ts

    shapes = (("spectral slice", 5000, 384, 6, 8, False), ("twin slice", 10000, 1024, 10, 16, True),
              ("N=20000", 20000, 64, 10, 16, False), ("config-4", 100_000, 384, 10, 16, False))
    for what, n, k, h, km, twin in shapes:
        x, v, u_c, u_s, tc, ts = inputs(n, k, h, km, twin)
        kw = dict(length=50.0, dt=0.1, n0=1.0, n_particles=n, rot=True, twin_c=tc, twin_s=ts,
                  n_modes=None)
        reps = 10 if n == 100_000 else 20
        chosen = sh.launch_geometry(n, True)
        for c in (1, 2, 4, 8, 16):
            s = -(-n // c)
            if 12 * s > sh._state_limit(km):
                continue
            geo = sh.Geometry(c, s, 12 * s)
            ms = _ms_per_launch(torch, lambda: sh._spectral_horizon_cuda(
                x, v, u_c, u_s, geometry=geo, **kw), reps)
            print(f"[sweep] {what} (K={k}, H={h}, Km={km}, N={n}, rot{', corrected' if twin else ''})"
                  f": C={c:2d}, {s * 12 / 1024:.1f} KiB per CTA: {ms:.4f} ms per launch"
                  f"{'  <- launch_geometry' if c == chosen.cluster else ''}", flush=True)

    # the global scratch: 16 virtual ranks on persistent clusters of C CTAs
    shapes = (("million chunk", 1_000_000, 16, 10, 32), ("million solve", 1_000_000, 384, 10, 32),
              ("[global]", 320_000, 32, 10, 16))
    for what, n, k, h, km in shapes:
        x, v, u_c, u_s, _, _ = inputs(n, k, h, km, False)
        kw = dict(length=50.0, dt=2.0 / (n / 50.0) ** 0.5, n0=1.0, n_particles=n, rot=True,
                  twin_c=None, twin_s=None, n_modes=None)
        reps = 3 if k > 64 else 20
        geo = sh.launch_geometry(n, True, km)
        fits = sh.cluster_fits(x.get_device(), True, False, km > 16)
        chosen = sh.stream_layout(k, geo.cluster, fits)
        layouts = [sh.StreamLayout(geo.cluster, k)]
        layouts += [sh.StreamLayout(c, min(k, fits[c])) for c in (1, 2, 4, 8, 16)
                    if geo.cluster % c == 0 and fits[c] > 0]
        for i, layout in enumerate(layouts):
            ms = _ms_per_launch(torch, lambda: sh._spectral_horizon_cuda(
                x, v, u_c, u_s, layout=layout, **kw), reps)
            rounds = -(-k // layout.clusters)
            per = geo.cluster // layout.cluster
            print(f"[sweep] {what} (K={k}, H={h}, Km={km}, N={n}, rot, {geo.cluster} virtual "
                  f"ranks): C={layout.cluster:2d}, A(C)={fits[layout.cluster]}, "
                  f"{layout.clusters} clusters{' (one per candidate)' if i == 0 else ''}, "
                  f"{rounds} rounds x {per} slices per CTA = {rounds * per}: {ms:.4f} ms per launch"
                  f"{'  <- stream_layout' if i and layout == chosen else ''}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep-clusters", action="store_true",
                    help="time kernel 1 at each cluster size")
    args = ap.parse_args()
    if not args.sweep_clusters:
        ap.error("give --sweep-clusters; the control step's profile is the benchmark's traced "
                 "run: python3 benchmark/run.py --workload <cell> --seed 0 --seconds 40 --trace 1")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_control_step: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sweep_clusters(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
