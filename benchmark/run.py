"""Runs one cell of the benchmark once and prints its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, one process per run and per card. The cell
(an entry of ``BENCHMARK.json``'s ``workloads``) names its configuration and
traffic files; see ``benchmark/cell.py``. With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a traced sub-window. Every run compares the program's outputs
with the plain reference (``benchmark/judge.py``) and prints each number
beside its limit as the last lines on standard error and last in the
result line. Without a CUDA device the run fails; it never falls back to the
CPU. The last line on standard output is the result's JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# names whose presence means JAX was loaded, compared as whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "plasma_control_tpu")


def loaded_forbidden() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout (the program builds
    # its own CUDA library into build/plasma_control_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(REPO / "build" / "benchmark" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(REPO))

    import torch

    from benchmark import harness
    from benchmark.cell import load_cell

    cell = load_cell(args.workload, REPO)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}: the program must not import "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    harness.log(f"[device] {card_line()}")
    for name, c in result["checks"].items():
        harness.log(f"[check] {name} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
