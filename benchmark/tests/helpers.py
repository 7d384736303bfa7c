"""Small copies of the benchmark's cells for the CPU tests."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.cell import load_cell  # noqa: E402

CELLS = ("two_stream_n100k.mpc_eager", "two_stream_n100k.mpc_twin_graph",
         "bump_on_tail_n5k.mpc_graph", "bump_on_tail_n5k.mpc_grid_graph")


def tiny_cell(name: str, n: int = 2000, m: int = 64, k: int = 32, steps: int = 30):
    """The cell ``name`` cut to a CPU test's size: its controller, path and
    limits, N particles on M cells, K candidates, ``steps``-step episodes
    (the graph path runs eagerly on the CPU, as ``io.aot.LoadedStep`` does).
    The spectral planner takes ``plan_kernel="fused"``: on CPU tensors that
    is the kernel's plain version, with the card's drift, where ``"auto"``
    would take the op-by-op scan and its trig drift."""
    c = load_cell(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["sim"].update(n_particles=n, n_mesh=m)
    mpc = c.traffic["mpc"]
    mpc["n_candidates"] = k
    if mpc["plan_model"] == "spectral":
        mpc["plan_kernel"] = "fused"
    if mpc["plan_particles"] is not None:
        mpc["plan_particles"] = n // 4
    if mpc["plan_mesh"] is not None:
        mpc["plan_mesh"] = m // 2
    c.traffic.update(episode_steps=steps, warmup_steps=2, trace_start=3, trace_steps=4,
                     start_states=2)
    return c
