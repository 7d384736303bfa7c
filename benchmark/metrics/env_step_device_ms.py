"""Device time per control step of the field kernels by name: the CIC
deposit and gather kernels and the matrix-vector products of the field
solve (cuBLAS's, whose names hold ``gemv``: ``gemv2T_kernel_val``,
``internal::gemvx::kernel``). By name these also take in the energies' and
the feedback seed's deposit and solve and the actuator's field synthesis,
which share the kernels with the Yoshida-4 step's three rounds."""

LAYER = "env step and field kernels (models/pic.py::step, ops/kernels/cic.py, ops/fields.py)"
UNIT = "ms/step"
MOVES = "control_steps_per_s"
KERNELS = ("deposit_kernel", "gather_kernel")
MATVEC = "gemv"  # in the qualified function name of cuBLAS's matrix-vector kernels


def is_field_kernel(name: str, measure) -> bool:
    return (measure.kernel_name(name) in KERNELS
            or MATVEC in measure.qualified_name(name).lower())


def read(ctx):
    m = ctx["measure"]
    dev = [e for e in ctx["device_events"] if is_field_kernel(e["name"], m)]
    if not dev:
        return None
    return sum(e["dur"] for e in dev) / 1e3 / ctx["steps"]
