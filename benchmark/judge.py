"""The comparison that decides ``correct``.

The closed loop is chaotic: two correct float32 implementations part ways
within an episode. So the reference follows the program step by step: at
each sampled step it takes the program's own input (positions, velocities,
nominal, the generator's state) and works out the step again, and the
program's outputs are held against it stage by stage:

* the planner, from the program's input state: ``plan_gap``, the largest
  difference of the MPPI nominal (the applied action and the shifted
  nominal together), in coefficient units; ``best_gap``, the least
  candidate cost's relative difference (relative to at least a thousandth
  of the median candidate's cost: the twin-corrected cost of an undriven
  candidate can cancel to almost nothing, where round-off is all there is);
* the environment step, from the program's input state and the action the
  program applied: ``kick_gap`` and ``drift_gap``, the largest difference of
  the velocity and position increments relative to the reference's largest
  increment; ``pe_gap``, ``ke_gap``, ``ie_gap``, the relative differences of
  the field, kinetic and input energies;
* the fidelity guard: ``guard_gap``, the count of compared steps at which
  the program drove while the reference's guard stopped the solve, or the
  other way round (a tie at the threshold counts for neither), which must be
  nought;
* the carry between steps: ``carry_gap``, the largest difference between a
  step's output and the next step's input, which must be nought.

Each number is the worst over the sampled steps; each has its limit in the
cell's ``limits/<workload>.json``, where ``null`` marks a number the cell
does not compare (``PERF.md`` says why).
"""

from __future__ import annotations

import torch

from .reference import Reference

CHECKS = ("plan_gap", "best_gap", "kick_gap", "drift_gap", "pe_gap", "ke_gap", "ie_gap",
          "guard_gap", "carry_gap")
GUARD_BAND = 1e-3  # relative distance of the guard's ratio from its threshold read as a tie
TINY = 1e-30
COST_FLOOR = 1e-3  # of the median candidate cost, the least scale of best_gap


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), TINY)


def _wrapped(d: torch.Tensor, length: float) -> torch.Tensor:
    return d - length * torch.round(d / length)


def plan_outputs(ref: Reference, rec: dict) -> dict:
    """What a step's solve produces by the precision of ``ref``: the action,
    the shifted nominal and the least cost, as the program reports them."""
    p = ref.plan(rec["x"], rec["v"], rec["mean"], ref.noise(rec["gen_state"]))
    mu = p["mu"]
    return {"action": mu[0], "mean1": torch.cat([mu[1:], mu[-1:]]), "best": p["best"]}


def env_outputs(ref: Reference, rec: dict, action) -> dict:
    x1, v1, pe, ke, ie = ref.env_step(rec["x"], rec["v"], action)
    return {"x1": x1, "v1": v1, "pe": pe, "ke": ke, "ie": ie}


def step_gaps(ref: Reference, rec: dict) -> dict:
    """The gaps of one recorded step (program or control outputs in ``rec``)
    against ``ref``, the reference."""
    dev, f64 = ref.device, torch.float64
    t = lambda a: torch.as_tensor(a).to(device=dev, dtype=f64)  # noqa: E731
    noise = ref.noise(rec["gen_state"])
    p = ref.plan(rec["x"], rec["v"], rec["mean"], noise)
    mu_prog = torch.cat([t(rec["action"])[None], t(rec["mean1"])[:-1]])
    choices = [p["mu"]]
    thr = ref.mpc["fidelity_guard_ratio"]
    tie = p["ratio"] is not None and abs(p["ratio"] - thr) <= GUARD_BAND * thr
    if tie:  # either branch is what the solve says
        choices = [p["mu_unguarded"], torch.zeros_like(p["mu"])]
    plan_gap = min(float(torch.max(torch.abs(mu_prog - c.to(f64)))) for c in choices)
    stopped = p["ratio"] is not None and p["ratio"] < thr
    guard = 0 if tie else int(stopped != bool(torch.all(mu_prog == 0)))
    x, v = t(rec["x"]), t(rec["v"])
    x1r, v1r, per, ker, ier = ref.env_step(rec["x"], rec["v"], rec["action"])
    x1r, v1r = x1r.to(f64), v1r.to(f64)
    dv_ref = v1r - v
    kick = float(torch.max(torch.abs((t(rec["v1"]) - v) - dv_ref)) / torch.max(torch.abs(dv_ref)))
    dx_ref = _wrapped(x1r - x, ref.length)
    drift = float(torch.max(torch.abs(_wrapped(t(rec["x1"]) - x1r, ref.length)))
                  / torch.max(torch.abs(dx_ref)))
    return {
        "plan_gap": plan_gap,
        "best_gap": abs(float(rec["best"]) - float(p["best"])) / max(
            abs(float(p["best"])), COST_FLOOR * float(p["cost_scale"]), TINY),
        "kick_gap": kick,
        "drift_gap": drift,
        "pe_gap": _rel(rec["pe"], per),
        "ke_gap": _rel(rec["ke"], ker),
        "ie_gap": _rel(rec["ie"], ier),
        "guard_gap": guard,
        "guard_tie": tie,
    }


def control_record(ctrl: Reference, rec: dict) -> dict:
    """``rec`` with the program's outputs replaced by the control's: the
    reference at the lower precision put in the program's place."""
    out = dict(rec)
    p = plan_outputs(ctrl, rec)
    out.update(p)
    out.update(env_outputs(ctrl, rec, p["action"]))
    return out


def carry_gap(records: list) -> float:
    """Largest difference between a recorded step's output and the input of
    the next step of its episode, where both are recorded."""
    by_key = {(r["episode"], r["step"]): r for r in records}
    gap = 0.0
    for (e, s), r in by_key.items():
        nxt = by_key.get((e, s + 1))
        if nxt is None:
            continue
        for a, b in (("x1", "x"), ("v1", "v"), ("mean1", "mean")):
            gap = max(gap, float(torch.max(torch.abs(r[a].double() - nxt[b].double()))))
    return gap


def worst(per_step: list, records: list) -> dict:
    """Each number's worst over the sampled steps."""
    out = {name: max(g[name] for g in per_step) for name in CHECKS[:-2]}
    out["guard_gap"] = sum(g["guard_gap"] for g in per_step)
    out["carry_gap"] = carry_gap(records)
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    compares: correct when each is finite and within its limit."""
    checks = {name: {"value": values[name], "limit": limits[name]} for name in CHECKS
              if limits[name] is not None}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
