"""Device time per control step of the operations the env step launches:
those under the program's ``env_step`` span (the actuator's drive synthesis
and Yoshida-4's three deposit-solve-gather rounds), without the energies'
and the feedback seed's deposit and solve, which ``env_step_device_ms``
takes in by kernel name. Summed durations, from the span window
(``benchmark/spans.py``)."""

from benchmark import spans

LAYER = "env step and field kernels (models/pic.py::step, ops/kernels/cic.py, ops/fields.py)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ()  # whatever runs under the env_step span


def read(ctx):
    s = spans.checked(ctx)
    if s is None:
        return None
    return spans.device_ms(s, lambda path: spans.under(path, "env_step"), busy=False)
