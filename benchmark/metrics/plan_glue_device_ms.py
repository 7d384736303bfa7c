"""Device time per control step outside the planner kernels and the field
kernels: the planner's glue (candidate sampling, twin targets, the MPPI
update, the guard), the energies' reductions and the copies."""

import importlib.util
from pathlib import Path

LAYER = "planner glue (control/mpc.py::_plan_impl, twin_targets, the MPPI update, the guard)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # all but the planner and field kernels


def _sibling(name):
    spec = importlib.util.spec_from_file_location(f"_glue_{name}", Path(__file__).with_name(
        f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(ctx):
    m, dev = ctx["measure"], ctx["device_events"]
    if not dev:
        return None
    plan = set(_sibling("plan_kernel_roofline").KERNELS)
    field = _sibling("env_step_device_ms")
    rest = [e for e in dev if m.kernel_name(e["name"]) not in plan
            and not field.is_field_kernel(e["name"], m)]
    return m.busy_us(rest) / 1e3 / ctx["steps"]
