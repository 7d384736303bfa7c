#!/usr/bin/env python3
"""Kernel 1's time per launch at every cluster size, main-path shapes.

    python3 profile_control_step.py --sweep-clusters

Times kernel 1 at each main path's shape (spectral slice, twin slice,
N=20000, config-4) on every cluster size whose slices fit shared memory,
forced through the wrapper's private launch, beside the size
``launch_geometry`` chooses: CUDA events around 20 back-to-back launches (10
at config-4), which at these sizes keep the device busy, so the time per
launch is the device's.

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
