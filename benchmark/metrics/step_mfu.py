"""The whole step's share of the card's fp32 peak: the operations one
control step needs (the candidate horizon and the Yoshida-4 step's three
deposit-solve-gather rounds, counted from the shapes, whatever implements
them) at 67 TFLOP/s, over the wall time of a step untraced
(``measure.untraced_window_us``: the mean step interval, by CUDA events,
of the run's untraced steps)."""

LAYER = "whole step (control/mpc.py::control_step_fn)"
UNIT = "%"
MOVES = "control_steps_per_s"
KERNELS = ()


def read(ctx):
    wall = ctx["measure"].untraced_window_us(ctx["step_intervals_ms"], ctx["steps"])
    if not ctx["device_events"] or wall is None:
        return None
    c = ctx["counts"]
    ops = c.step_ops(ctx["sim"], ctx["control"], ctx["mpc"])
    return 100.0 * ops / c.PEAK_FLOPS / (wall / 1e6 / ctx["steps"])
