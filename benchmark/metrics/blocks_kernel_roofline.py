"""Kernel 1's blocked variant's share of its roofline: the least time the
candidate horizon's work needs on the card (``counts.plan_cost`` of the
cell's plan shapes, the same count at any Km, whatever implements it) over
the device time per step of ``spectral_horizon_blocks_kernel`` alone (Km
above 16; in the million-particle cell its state lives in the global
scratch, ``csrc/spectral_horizon.cuh::horizon_stream``)."""

LAYER = ("planner kernels, blocked global-scratch variant (ops/kernels/spectral_horizon.py, "
         "csrc/spectral_horizon.cuh::horizon_stream)")
UNIT = "%"
MOVES = "control_steps_per_s"
KERNELS = ("spectral_horizon_blocks_kernel",)


def read(ctx):
    ms = ctx["measure"].device_ms_of(ctx["device_events"], KERNELS, ctx["steps"])
    if ms <= 0.0:
        return None
    c = ctx["counts"]
    return 100.0 * c.bound_ms(*c.plan_cost(ctx["sim"], ctx["control"], ctx["mpc"])) / ms
