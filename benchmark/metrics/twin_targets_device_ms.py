"""Device busy time per control step of the twin-corrected solve's targets:
the operations under the program's ``plan.twin_targets`` span (the full
state's mode sums and the zero-drive twin's H-step trajectory), from the
span window (``benchmark/spans.py``). None where the solve has no twin
correction, as its span then launches nothing."""

from benchmark import spans

LAYER = "planner glue (control/mpc.py::_plan_impl, twin_targets, the MPPI update, the guard)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # whatever runs under plan.twin_targets


def read(ctx):
    s = spans.checked(ctx)
    if s is None:
        return None
    return spans.device_ms(s, lambda path: spans.under(path, "plan.twin_targets"))
