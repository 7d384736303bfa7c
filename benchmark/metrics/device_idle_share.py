"""Share of the steps' wall time in which no device operation ran: 1 - the
traced sub-window's busy time (the union of its kernels, copies and sets)
over the time its steps take untraced (``measure.untraced_window_us``: the
mean step interval, by CUDA events, of the run's untraced steps, times the
traced step count). The traced sub-window's own
wall time is not the denominator: recording each launch slows the host,
most of all a replayed graph's, and would read as idle device."""

LAYER = "device"
UNIT = "%"
MOVES = "control_steps_per_s"
KERNELS = ()  # every kernel, copy and set


def read(ctx):
    dev = ctx["device_events"]
    wall = ctx["measure"].untraced_window_us(ctx["step_intervals_ms"], ctx["steps"])
    if not dev or wall is None:
        return None
    return 100.0 * (1.0 - ctx["measure"].busy_us(dev) / wall)
