"""The planner kernels' share of their roofline: the least time the
candidate horizon's work needs on the card (operations over the fp32 peak or
bytes over the memory rate, counted from the cell's plan shapes), over the
planner kernels' device time per step."""

LAYER = "planner kernels (ops/kernels/spectral_horizon.py, ops/kernels/fused_step.py)"
UNIT = "%"
MOVES = "control_steps_per_s"
# kernel 1 and 1c (both share these names), and the grid horizon's kernel 6
KERNELS = ("spectral_horizon_kernel", "spectral_horizon_blocks_kernel", "horizon_kernel")


def read(ctx):
    ms = ctx["measure"].device_ms_of(ctx["device_events"], KERNELS, ctx["steps"])
    if ms <= 0.0:
        return None
    c = ctx["counts"]
    ops, nbytes = c.plan_cost(ctx["sim"], ctx["control"], ctx["mpc"])
    return 100.0 * c.bound_ms(ops, nbytes) / ms
