"""Device operations (kernels, copies, sets) per control step in the traced
sub-window: a count, which repeats exactly."""

LAYER = "device"
UNIT = "ops/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # every kernel, copy and set


def read(ctx):
    dev = ctx["device_events"]
    if not dev:
        return None
    return len(dev) / ctx["steps"]
