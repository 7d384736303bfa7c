"""The readings that the comparison's limits are set from.

    python benchmark/calibrate.py --workload <cell> [--seeds 12] [--control-seeds 3]
        [--episodes 2] [--first-seed N] [--out FILE]

In one process on the card: the cell's program is built once; for each seed
it runs ``--episodes`` whole episodes through the same closed loop and
recorder as a run's window, and compares the same sampled steps with the
reference (the lower reading: the largest over the seeds). On the first
``--control-seeds`` seeds the control, the reference at the precision below
the configuration's (bfloat16, TF32 products), stands in the program's place
on the same inputs (the upper reading: the smallest over those seeds). One
JSON line per seed and reading, then a summary line. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def readings(cell, seeds, control_seeds, episodes, device, out=None):
    """Yields one dict per seed and kind, then the summary."""
    import torch

    from benchmark import harness, judge, sampler

    prog = harness.Program(cell, device)
    n_steps = cell.traffic["episode_steps"]
    lower = {k: 0.0 for k in judge.CHECKS}
    upper = {k: float("inf") for k in judge.CHECKS}
    for i, seed in enumerate(seeds):
        states = sampler.start_states(cell.sim, seed, cell.traffic["start_states"], device)
        rec = harness.Recorder(prog.step, device, episodes * n_steps, seed,
                               cell.traffic["check_steps"] - harness.Recorder.FIXED, n_steps - 1)
        rec.start()
        failed = sum(int(harness.failed_steps(prog.episode(
            rec, seed, e, states[e % len(states)], n_steps,
            harness._episode_sample(seed, e, n_steps)))) for e in range(episodes))
        if prog.cuda:
            torch.cuda.synchronize()
        kinds = [("program", False)] + ([("control", True)] if i < control_seeds else [])
        for kind, control in kinds:
            t0 = time.perf_counter()
            values, per_step = harness.check(cell, rec.records, device, control)
            row = {"seed": seed, "kind": kind, "failed": failed,
                   "seconds": time.perf_counter() - t0, "gaps": values, "per_step": per_step}
            for k in judge.CHECKS:
                if control:
                    upper[k] = min(upper[k], values[k])
                else:
                    lower[k] = max(lower[k], values[k])
            yield row
    yield {"summary": cell.name, "seeds": len(seeds), "control_seeds": control_seeds,
           "lower": lower, "upper": upper,
           "upper_over_lower": {k: (upper[k] / lower[k] if lower[k] else None)
                                for k in judge.CHECKS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark.cell import load_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, REPO)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    sink = open(args.out, "a") if args.out else None
    try:
        for row in readings(cell, seeds, args.control_seeds, args.episodes, "cuda"):
            line = json.dumps(row)
            short = {k: v for k, v in row.items() if k != "per_step"}
            print(json.dumps(short), flush=True)
            if sink:
                sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
