"""Device busy time per control step of everything the step runs beside the
grid planner's kernel: the operations under the program's ``control_step``
span other than the launch of kernel 6 (``horizon_kernel``) under
``plan.kernel`` (the Yoshida-4 env step, the energies, the feedback seed,
the noise, the candidates' drive fields and the cost's glue, the MPPI
update), from the span window (``benchmark/spans.py``). It is what a faster
kernel 6 runs into. None unless every profiled step launched kernel 6 once
under ``plan.kernel``, counted from the device trace (the span context holds
no counters)."""

from benchmark import spans

LAYER = ("env step, energies and the grid planner's glue beside kernel 6 (models/pic.py::step, "
         "ops/kernels/cic.py, control/mpc.py::plan, _horizon_cost_kdk)")
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # whatever runs under control_step but kernel 6
GRID = "horizon_kernel"


def read(ctx):
    s = spans.checked(ctx)
    if s is None:
        return None
    name = s["measure"].kernel_name
    ops = list(zip(s["device_events"], s["op_spans"]))
    grid = [spans.under(path, "plan.kernel") and name(e["name"]) == GRID for e, path in ops]
    if sum(grid) != s["steps"]:
        return None
    rest = [op for op, g in zip(ops, grid) if not g]
    beside = dict(s, device_events=[e for e, _ in rest], op_spans=[path for _, path in rest])
    return spans.device_ms(beside, lambda path: spans.under(path, "control_step"))
