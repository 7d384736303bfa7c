"""Device busy time per control step of the solve's operations outside its
planner kernel: those under the program's ``plan`` span and not under
``plan.kernel`` (candidate noise, plan-model reduction, twin targets,
feedback seed, the cost's glue around the kernel, the MPPI update, the
guard), from the span window (``benchmark/spans.py``)."""

from benchmark import spans

LAYER = "planner glue (control/mpc.py::_plan_impl, twin_targets, the MPPI update, the guard)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # whatever runs under plan and outside plan.kernel


def read(ctx):
    s = spans.checked(ctx)
    if s is None:
        return None
    return spans.device_ms(s, lambda path: spans.under(path, "plan")
                           and not spans.under(path, "plan.kernel"))
