"""Host time per control step: the mean duration of the program's step span
(``control_step`` on the eager path, ``graphed_step`` around one replay on
the graph path) over the untraced steps of the span window
(``benchmark/spans.py``; ``measure.untraced_steps``' set: all but the
profiled steps and the one after them). The time the host loop spends
inside the program's step, recording included; below the step interval the
device sets the pace."""

from benchmark import spans

LAYER = "host loop (control/mpc.py::closed_loop, io/aot.py::GraphedStep)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()


def read(ctx):
    s = spans.checked(ctx)
    return None if s is None else spans.mean_ms(s["untraced_step_spans_ms"])
