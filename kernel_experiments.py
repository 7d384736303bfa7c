#!/usr/bin/env python3
"""Measurements behind the design of the deposit and grid-planner kernels
(``csrc/cic.cu``, ``csrc/fused_step.cu``) on one NVIDIA GPU.

    python3 kernel_experiments.py compare --parent DIR
    python3 kernel_experiments.py variants
    python3 kernel_experiments.py stamps
    python3 kernel_experiments.py sass [--root DIR] [--listing PATH]

* ``compare``: kernel 2 (``deposit_cic`` and ``deposit(method="pallas")`` at
  N=5000, M=250 and N=100000, M=256, and the deposit at every cluster size),
  kernel 3 (``gather_cic`` on one (M,) field at N=5000, M=250, N=100000 and
  N=1M, M=256), kernel 1 at the spectral slice's, the twin slice's
  (corrected) and config-4's shapes, and kernels 4-6 (the grid slice's plan
  model, all three kinds) of this checkout and of the checkout at DIR (e.g. the parent commit,
  unpacked with ``git archive``), in turns: DIR, this, this, DIR. Each side
  runs in its own process and builds its own kernels; per entry it prints
  the wrapped time (CUDA-event median of 30 calls), the device time per
  launch of the kernel and the device ops per call (profiler trace, 20
  calls); for the gather also the sha256 of its output on positions made
  from a seed with numpy at N=1M, so that equal hashes show the two
  kernels' results bitwise equal.
* ``variants``: kernel 6 (CIC) as shipped, with 128 threads per CTA, and with
  the taps of each deposit kept in shared memory for the next step's gather,
  in turns.
* ``stamps``: cycles per CTA in each phase of kernels 5 and 6 (prologue,
  particle pass, solve, barrier waits), from ``clock64()`` stamps.
* ``sass``: the loops with shared-memory atomics of the built deposit and
  grid kernels (``cuobjdump -sass``; of the checkout at DIR with ``--root``):
  static instruction count and opcode mix of each; the full listing goes to
  ``--listing`` (default ``chiprun_out/sass.txt``). The path one particle
  takes through a loop is read from that listing.

Variants and stamps are built from a copy of the package in a temporary
directory, with the source edits that this script holds; the package in the
checkout is never changed. Imports only ``plasma_control_tpu_torch``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "plasma_control_tpu_torch"
KINDS = ("cic", "tsc", "tsc_standard")
L = 50.0
GRID = dict(n=1250, m=64, k=512, h=10)  # chip_smoke.py's GRID_PLAN

# source edits of fused_step.cu, each (old, new), for the variants and stamps
THREADS_128 = [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]
KEEP_TAPS = [  # CIC only: the deposit's first cell and two weights, kept per particle
    ("(state_smem ? 2 * (size_t)p.n : 0);", "(state_smem ? 5 * (size_t)p.n : 0);"),
    ("  float* vs = xs + n;\n  const float* uk",
     "  float* vs = xs + n;\n  int* tcell = reinterpret_cast<int*>(s.state + 2 * n);\n"
     "  float* tw0 = s.state + 3 * n;\n  float* tw1 = s.state + 4 * n;\n  const float* uk"),
    ("      const pct::Taps<KIND> tp = pct::taps<KIND, true>(xq * p.inv_dx, m);",
     "      pct::Taps<KIND> tp;\n      if (t == 0) {\n"
     "        tp = pct::taps<KIND, true>(xq * p.inv_dx, m);\n      } else {\n"
     "        tp.cell[0] = tcell[q];\n        tp.cell[1] = pct::next_cell(tp.cell[0], m);\n"
     "        tp.w[0] = tw0[q];\n        tp.w[1] = tw1[q];\n      }"),
    ("      deposit_at<KIND, true>(xq, cur, p);\n    }\n    __syncthreads();",
     "      const pct::Taps<KIND> tn = pct::taps<KIND, true>(xq * p.inv_dx, m);\n"
     "      pct::deposit(tn, cur, m);\n      tcell[q] = tn.cell[0];\n      tw0[q] = tn.w[0];\n"
     "      tw1[q] = tn.w[1];\n    }\n    __syncthreads();"),
]
STAMPS = [  # thread 0 and the last warp's lane 0 of each CTA: 6 counters each
    ("template <bool MERGED, int KIND, bool SMEM, bool GMESH>\n__global__",
     "__device__ long long g_stamps[4096 * 12];\n\n"
     "template <bool MERGED, int KIND, bool SMEM, bool GMESH>\n__global__"),
    ("  const int n = p.n, m = p.m, h = p.h, k = blockIdx.x;\n",
     "  const int n = p.n, m = p.m, h = p.h, k = blockIdx.x;\n"
     "  const long long t_start = clock64();\n  long long acc[6] = {0, 0, 0, 0, 0, 0};\n"),
    ("  for (int t = 0; t < h; ++t) {\n    unsigned* cur",
     "  acc[0] = clock64() - t_start;\n  for (int t = 0; t < h; ++t) {\n"
     "    const long long ta = clock64();\n    unsigned* cur"),
    ("      deposit_at<KIND, true>(xq, cur, p);\n    }\n    __syncthreads();\n",
     "      deposit_at<KIND, true>(xq, cur, p);\n    }\n    const long long tb = clock64();\n"
     "    __syncthreads();\n    const long long tc = clock64();\n"),
    ("    energy_partial(e2, s.pe_part);\n    __syncthreads();\n  }",
     "    energy_partial(e2, s.pe_part);\n    const long long td = clock64();\n"
     "    __syncthreads();\n    const long long te = clock64();\n"
     "    acc[1] += tb - ta; acc[2] += tc - tb; acc[3] += td - tc; acc[4] += te - td;\n  }"),
    ("  if (threadIdx.x == 0) pe[(size_t)k * h + h - 1] = energy(s.pe_part, p);\n}",
     "  if (threadIdx.x == 0) pe[(size_t)k * h + h - 1] = energy(s.pe_part, p);\n"
     "  acc[5] = clock64() - t_start;\n"
     "  const int slot = threadIdx.x == 0 ? 0 : (threadIdx.x == kThreads - 32 ? 1 : -1);\n"
     "  if (slot >= 0 && k < 4096)\n"
     "    for (int i = 0; i < 6; ++i) g_stamps[(size_t)k * 12 + slot * 6 + i] = acc[i];\n}"),
    ('extern "C" {\n',
     'extern "C" {\n\nint pct_stamps(long long* dst, int count) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(long long) * count));\n"
     "}\n"),
]
PHASES = ("prologue", "pass", "barrier 1", "solve", "barrier 2", "total")


def patched_copy(edits: list, tmp: str, name: str) -> str:
    """A copy of the package under tmp/name with edits applied to
    csrc/fused_step.cu; returns the root to import it from."""
    root = Path(tmp) / name
    shutil.copytree(ROOT / PACKAGE, root / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PACKAGE / "csrc" / "fused_step.cu"
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"kernel_experiments: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new, 1)
    src.write_text(text)
    if edits is THREADS_128:  # the wrapper mirrors the warp count in its layout
        py = root / PACKAGE / "ops" / "kernels" / "fused_step.py"
        py.write_text(py.read_text().replace("_WARPS = 8 ", "_WARPS = 4 ", 1))
    return str(root)


def run_side(root: str, what: str) -> dict:
    """This script's --side mode in a fresh process, importing the package at root."""
    out = subprocess.run([sys.executable, __file__, "--side", root, what], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"kernel_experiments: side {root} failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---- one side: runs in its own process ------------------------------------

def _time_ms(torch, fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device(torch, fn, kernel, reps=20):
    """(median device ms per launch of the kernels named ``kernel``, device
    ops per call) from a profiler trace; a window the profiler dropped is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                trace = json.load(f)
        events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e.get("ph") == "X"]
        ours = [e["dur"] for e in events if kernel in e["name"]]
        if len(ours) >= reps - 2:
            return statistics.median(ours) / 1e3, len(events) / reps
    raise SystemExit(f"kernel_experiments: the profiler saw {len(ours)} of {reps} {kernel} launches")


def side(what: str) -> dict:
    import numpy as np
    import torch

    from plasma_control_tpu_torch.ops import deposit as dep
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.ops.kernels import _build, cic
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs

    dev = torch.device("cuda")
    library, build_s, _ = _build.build()
    res = {"build_s": build_s, "library": str(library)}
    if what == "build":
        return res
    gen = torch.Generator(device=dev).manual_seed(1)
    n, m, k, h = (GRID[key] for key in ("n", "m", "k", "h"))
    x0 = torch.rand(n, generator=gen, device=dev) * L
    v0 = torch.randn(n, generator=gen, device=dev)
    xb = torch.rand((k, n), generator=gen, device=dev) * L
    vb = torch.randn((k, n), generator=gen, device=dev)
    u = 0.05 * torch.randn((k, h, m), generator=gen, device=dev)
    eop = make_grid(m, L, device=dev).e_op.T.contiguous()
    kw = dict(n_mesh=m, length=L, dt=0.1)
    if what == "stamps":
        lib = _build.library()
        lib.pct_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name in ("fused_packed_horizon", "fused_kdk_horizon"):
            for _ in range(5):
                getattr(fs, name)(x0, v0, u, eop, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (k * 12))()
            _build.check(lib.pct_stamps(ctypes.addressof(buf), k * 12), "pct_stamps")
            cycles = [[sum(buf[c * 12 + who * 6 + i] for c in range(k)) / k for i in range(6)]
                      for who in range(2)]
            res[name] = {who: dict(zip(PHASES, cyc)) for who, cyc in zip(("thread 0", "last warp"),
                                                                         cycles)}
        return res
    for kind in KINDS if what == "compare" else ("cic",):
        names = ("fused_packed_horizon", "fused_kdk_horizon") if what == "compare" else (
            "fused_packed_horizon",)
        for name in names:
            call = lambda fn=getattr(fs, name): fn(x0, v0, u, eop, kind=kind, **kw)  # noqa: E731
            res[f"{name} {kind}"] = [_time_ms(torch, call),
                                     *_device(torch, call, "horizon_kernel")]
        if what == "compare":
            def call(kind=kind):
                return fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, kind=kind, **kw)
            res[f"fused_leapfrog_step {kind}"] = [_time_ms(torch, call),
                                                  *_device(torch, call, "leapfrog_kernel")]
    if what != "compare":
        return res
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    # kernel 1: (K, H, Km, N, corrected) of the spectral, twin and config-4 paths
    for k1, h1, km1, n1, twin in ((384, 6, 8, 5000, False), (1024, 10, 16, 10_000, True),
                                  (384, 10, 16, 100_000, False)):
        x1 = torch.rand(n1, generator=gen, device=dev) * L
        v1 = 1.5 * torch.randn(n1, generator=gen, device=dev)
        u1 = 0.3 * torch.randn((k1, h1, km1), generator=gen, device=dev)
        t1 = n1 ** 0.5 * torch.randn((h1, km1), generator=gen, device=dev) if twin else None
        call = lambda: sh.spectral_horizon(x1, v1, u1, u1, length=L, dt=0.1, n0=1.0,  # noqa: E731
                                           n_particles=n1, rot=True, twin_c=t1, twin_s=t1)
        res[f"spectral_horizon K={k1} Km={km1} N={n1}{' corrected' if twin else ''}"] = [
            _time_ms(torch, call, reps=10), *_device(torch, call, "spectral_horizon_kernel")]
    for n_gat, m_gat in ((5000, 250), (100_000, 256), (1_000_000, 256)):
        r = np.random.default_rng(n_gat)
        x = torch.tensor(r.uniform(-L, 2 * L, (1, n_gat)).astype(np.float32), device=dev)
        e = torch.tensor(r.standard_normal(m_gat).astype(np.float32), device=dev)
        call = lambda: cic.gather_cic(e, x, m_gat, L)  # noqa: E731
        res[f"gather_cic N={n_gat}"] = [_time_ms(torch, call), *_device(torch, call, "gather_kernel")]
        for kind in KINDS:
            out = cic.gather_cic(e, x, m_gat, L, kind).cpu().numpy()
            res[f"gather_cic N={n_gat} {kind} sha256"] = hashlib.sha256(out.tobytes()).hexdigest()
    for n_dep, m_dep in ((5000, 250), (100_000, 256)):
        x = torch.rand((1, n_dep), generator=gen, device=dev) * L
        grid = make_grid(m_dep, L, device=dev)
        for label, call in (("deposit_cic", lambda: cic.deposit_cic(x, m_dep, L)),
                            ("deposit()", lambda: dep.deposit(x, grid, method="pallas"))):
            res[f"{label} N={n_dep}"] = [_time_ms(torch, call),
                                         *_device(torch, call, "deposit_kernel")]
        if hasattr(cic, "deposit_cluster"):
            for c in (1, 2, 4, 8, 16):
                call = lambda c=c: cic._deposit_cuda(x, m_dep, L, "cic", 1.0, c)  # noqa: E731
                res[f"deposit_cic N={n_dep} cluster {c}"] = [
                    _time_ms(torch, call), *_device(torch, call, "deposit_kernel")]
    return res


# ---- the commands -----------------------------------------------------------

def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def table(runs: list) -> None:
    """One line per entry: wrapped ms, (device ms per launch, device ops per call) per run."""
    print("entry | " + " | ".join(tag for tag, _ in runs))
    for key in dict.fromkeys(key for _, r in runs for key in r):
        if key in ("build_s", "library"):
            continue
        cells = [("-" if key not in r else r[key][:16] if isinstance(r[key], str) else
                  f"{r[key][0]:.4f} ({r[key][1]:.5f}, {r[key][2]:.0f} ops)") for _, r in runs]
        print(f"{key} | " + " | ".join(cells))


def sass(root: str, listing_path: str) -> None:
    path = run_side(root, "build")["library"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    listing = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                             check=True).stdout
    Path(listing_path).parent.mkdir(parents=True, exist_ok=True)
    Path(listing_path).write_text(listing)
    print("shared-memory atomics:", dict(collections.Counter(
        re.findall(r"ATOMS[.A-Z0-9]*", listing))))
    for func in re.split(r"\n\s*Function : ", listing)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not re.search(r"deposit_kernel|(?<!spectral_)horizon_kernel|leapfrog_kernel", name):
            continue
        code = [(int(a, 16), op.strip()) for a, op in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        at = {a: i for i, (a, _) in enumerate(code)}
        print(f"{name}: {len(code)} instructions")
        for i, (a, op) in enumerate(code):
            target = re.search(r"BRA\s+0x([0-9a-f]+)", op)
            if target and int(target.group(1), 16) <= a and int(target.group(1), 16) in at:
                body = code[at[int(target.group(1), 16)]:i + 1]
                if any("ATOMS" in o for _, o in body):
                    ops = (re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                           for _, o in body)
                    mix = collections.Counter(ops)
                    print(f"  loop {body[0][0]:#x}..{a:#x} with atomics: {len(body)} instructions; "
                          + ", ".join(f"{k} {v}" for k, v in mix.most_common(12)))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--side":
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(side(sys.argv[3])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("compare", "variants", "stamps", "sass"))
    ap.add_argument("--parent", help="compare: root of the checkout to hold this one against")
    ap.add_argument("--root", help="sass: root of the checkout to list (default: this one)")
    ap.add_argument("--listing", default="chiprun_out/sass.txt",
                    help="sass: where the full listing goes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_experiments: no CUDA device")
    print(card(), flush=True)
    here = str(ROOT)
    if args.command == "sass":
        sass(str(Path(args.root).resolve()) if args.root else here, args.listing)
    elif args.command == "compare":
        if not args.parent:
            raise SystemExit("kernel_experiments: compare needs --parent DIR")
        parent = str(Path(args.parent).resolve())
        runs = [(tag, run_side(root, "compare")) for tag, root in
                (("parent", parent), ("this", here), ("this", here), ("parent", parent))]
        table(runs)
        for key in (k for k, v in runs[0][1].items() if isinstance(v, str) and "sha256" in k):
            same = len({r.get(key) for _, r in runs}) == 1
            print(f"{key}: {'bitwise the same in all four runs' if same else 'DIFFERS'}")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            if args.command == "variants":
                t128 = patched_copy(THREADS_128, tmp, "threads128")
                keep = patched_copy(KEEP_TAPS, tmp, "keep_taps")
                table([(tag, run_side(root, "variants")) for tag, root in
                       (("shipped", here), ("128 threads", t128), ("taps kept", keep),
                        ("shipped", here), ("128 threads", t128), ("taps kept", keep))])
            else:
                res = run_side(patched_copy(STAMPS, tmp, "stamps"), "stamps")
                for name in ("fused_packed_horizon", "fused_kdk_horizon"):
                    for who, cyc in res[name].items():
                        total = cyc["total"]
                        print(f"{name}, {who}: mean cycles per CTA " + ", ".join(
                            f"{ph} {cyc[ph]:.0f} ({100 * cyc[ph] / total:.1f} %)" for ph in PHASES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
