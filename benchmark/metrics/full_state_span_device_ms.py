"""Device busy time per control step of the step's work outside its planner
kernel: the operations under the program's ``control_step`` span and not
under ``plan.kernel`` (the Yoshida-4 env step, the energies, the feedback
seed's deposit and solve, the noise, the MPPI update), from the span window
(``benchmark/spans.py``). In the million-particle cell it is the work on the
full state that a faster kernel 1 would run into. None unless every
profiled step launched kernel 1's blocked variant once under ``plan.kernel``
(the span context carries the device trace, not the recording's counters,
so the launches are counted there)."""

from benchmark import spans

LAYER = ("env step, energies and solve glue on the full state (models/pic.py::step, "
         "ops/kernels/cic.py, control/mpc.py::plan outside plan.kernel)")
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # whatever runs under control_step and outside plan.kernel
BLOCKS = "spectral_horizon_blocks_kernel"


def read(ctx):
    s = spans.checked(ctx)
    if s is None:
        return None
    name = s["measure"].kernel_name
    launches = sum(1 for e, path in zip(s["device_events"], s["op_spans"])
                   if spans.under(path, "plan.kernel") and name(e["name"]) == BLOCKS)
    if launches != s["steps"]:
        return None
    return spans.device_ms(s, lambda path: spans.under(path, "control_step")
                           and not spans.under(path, "plan.kernel"))
