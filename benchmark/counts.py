"""Operations and bytes that a control step's work needs, counted from its
shapes, and the card's published peaks.

A frozen copy of ``chip_smoke.py``'s counting arithmetic (``PEAK_FLOPS`` and
``PEAK_BYTES`` at chip_smoke.py:331-332, ``bound`` :362, the per-particle
costs :373-375, ``spectral_ops`` :378, ``spectral_bytes`` :394, ``solve_ops``
:400, ``grid_horizon_ops`` :407, and the grid horizon's bytes :1048-1052).
They count what the function needs, not what a kernel repeats: an FMA is 2
operations, sincosf and fmodf 2 each, a shared-memory atomic add 1.
"""

from __future__ import annotations

# published peaks of one H100 SXM at 700 W: fp32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TAPS_OPS = 13  # pos, then 4 x (offset, |d|, max)
DEPOSIT_OPS = TAPS_OPS + 4
GATHER_OPS = TAPS_OPS + 8  # taps plus 4 FMAs


def bound_ms(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    return max(1e3 * ops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES)


def spectral_ops(k: int, h: int, n: int, km: int, rot: bool) -> float:
    """One spectral horizon: per candidate, particle and step the harmonic
    recurrence once (4 Km - 3), the mode sums (2 Km), the field evaluation
    (4 Km) and the kick (2), plus the drift (17 rot, 8 trig); per candidate
    and particle the prologue's field and half kick (4 Km + 2); the
    prologue's phasors and mode sums at the shared x0 once: N (6 Km - 1)."""
    step = 10 * km - 1 + (17 if rot else 8)
    return k * n * (h * step + 4 * km + 2) + n * (6 * km - 1)


def spectral_bytes(k: int, h: int, n: int, km: int, twin: bool) -> float:
    """x0, v0 and u_c, u_s (K, H, Km) in, the (H, Km) targets in for the
    corrected variant, (K, H) energies out."""
    return 4 * (2 * n + 2 * k * h * km + (2 * h * km if twin else 0) + k * h)


def solve_ops(m: int) -> float:
    """One Poisson solve (hist * norm - n0) @ e_op_t: the affine once per
    cell, then the M x M product."""
    return 2 * m * m + 2 * m


def grid_horizon_ops(k: int, h: int, n: int, m: int, merged: bool) -> float:
    """The grid horizon: the prologue's deposit and solve at the shared x0
    once, the drive added per candidate; per step and particle taps, one
    (merged) or two gathers and kicks, drift, wrap and a deposit; per step
    and candidate one solve and the drive fields and energy (4 M)."""
    per_particle = TAPS_OPS + (8 + 3 if merged else 16 + 6) + 4 + DEPOSIT_OPS
    return DEPOSIT_OPS * n + solve_ops(m) + k * (m + h * (per_particle * n + solve_ops(m) + 4 * m))


def grid_horizon_bytes(k: int, h: int, n: int, m: int) -> float:
    """x0, v0, the (K, H, M) drive fields and e_op in, (K, H) energies out."""
    return 4 * (2 * n + k * h * m + m * m + k * h)


def env_round_ops(n: int, m: int) -> float:
    """One deposit, solve and gather of the environment with the kick and
    the drift that follow it (an FMA each per particle)."""
    return n * (DEPOSIT_OPS + GATHER_OPS + 4) + solve_ops(m)


def plan_shapes(sim: dict, control: dict, mpc: dict) -> dict:
    """The plan model's shapes as the program reduces them: the strided
    subsample's particle count, the plan mesh, the modes, and whether the
    spectral model drifts by rotation."""
    n = sim["n_particles"]
    n_plan = n
    pp = mpc["plan_particles"]
    if pp is not None and pp < n:
        stride = max(1, n // pp)
        n_plan = -(-n // stride)
    m = sim["n_mesh"]
    mesh = mpc["plan_mesh"] if mpc["plan_mesh"] is not None and mpc["plan_mesh"] < m else m
    dt = min(sim["dt"], 2.0 / (n_plan / sim["length"]) ** 0.5)
    drift = "trig" if mpc["plan_kernel"] == "xla" else mpc["spectral_drift"]
    rot = drift == "rot" or (drift in (None, "auto") and (
        6.283185307179586 / sim["length"]) * dt * 25.0 <= 0.5)
    twin = mpc["plan_correction"] == "twin" and n_plan < n
    return {"k": mpc["n_candidates"], "h": mpc["horizon"], "n": n_plan, "m": mesh,
            "km": max(int(mpc["plan_modes"]), control["max_mode"]), "rot": rot, "twin": twin,
            "grid": mpc["plan_model"] == "grid", "merged": mpc["plan_integrator"] == "kdk"}


def plan_cost(sim: dict, control: dict, mpc: dict) -> tuple[float, float]:
    """(operations, bytes) of one solve's candidate horizon."""
    s = plan_shapes(sim, control, mpc)
    if s["grid"]:
        return (grid_horizon_ops(s["k"], s["h"], s["n"], s["m"], s["merged"]),
                grid_horizon_bytes(s["k"], s["h"], s["n"], s["m"]))
    return (spectral_ops(s["k"], s["h"], s["n"], s["km"], s["rot"]),
            spectral_bytes(s["k"], s["h"], s["n"], s["km"], s["twin"]))


def step_ops(sim: dict, control: dict, mpc: dict) -> float:
    """Operations one control step needs: the candidate horizon and the
    Yoshida-4 step's three rounds, whatever implements them."""
    return plan_cost(sim, control, mpc)[0] + 3 * env_round_ops(sim["n_particles"], sim["n_mesh"])
