"""The comparison that decides ``correct``, on the CPU at a small size: the
program agrees with the reference, the lower-precision control does not, and
a run whose timed path is broken underneath comes out not correct."""

import dataclasses

import pytest
import torch

from benchmark import harness, judge
from benchmark.tests.helpers import CELLS, tiny_cell

SEED = 2718281828459


def _run(cell):
    return harness.run(cell, SEED, 0.01, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    r = _run(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] == 30 and r["failed"] == 0
    compared = {k for k in judge.CHECKS if tiny_cell(name).limits[k] is not None}
    assert list(r)[-1] == "checks" and set(r["checks"]) == compared


def test_a_traced_run_reports_its_window():
    """On the CPU the trace has no device events: no per-layer metric is
    read, and the run still compares its steps."""
    r = harness.run(tiny_cell("two_stream_n100k.mpc_twin_graph"), SEED, 0.01, True, "cpu")
    assert r["correct"] and r["metrics"] == {}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0.0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference at the precision below the configuration's, in the
    program's place on the same inputs, fails the cell's limits."""
    cell = tiny_cell(name)
    prog = harness.Program(cell, "cpu")
    rec = harness.Recorder(prog.step, "cpu", 0, SEED, 5, 29)
    x, v = harness.sampler.start_states(cell.sim, SEED, 1, "cpu")[0]
    prog.episode(rec, SEED, 0, (x, v), 30, harness._episode_sample(SEED, 0, 30))
    values, _ = harness.check(cell, rec.records, "cpu", control=True)
    ok, checks = judge.verdict(values, cell.limits)
    assert not ok, checks


def _unchanged_state(monkeypatch):
    from plasma_control_tpu_torch.control import mpc

    monkeypatch.setattr(mpc, "step", lambda state, grid, cfg, e_ext=None: state)


def _half_the_particles(monkeypatch):
    """The environment's deposit over every other particle, normalised over
    the half it keeps."""
    from plasma_control_tpu_torch.models import pic

    deposit = pic.deposit
    monkeypatch.setattr(pic, "deposit", lambda x, grid, **kw: deposit(x[..., ::2], grid, **kw))


def _half_the_plan_state(monkeypatch):
    """The candidates scored on every other particle of the plan state."""
    from plasma_control_tpu_torch.control import mpc
    from plasma_control_tpu_torch.models.pic import PlasmaState

    costs = mpc.candidate_costs

    def half(state, coeff_seqs, grid, cfg, mpc_cfg, actuator, twin_target=None):
        kept = PlasmaState(state.x[::2], state.v[::2])
        cfg = dataclasses.replace(cfg, n_particles=kept.x.shape[-1])
        return costs(kept, coeff_seqs, grid, cfg, mpc_cfg, actuator, twin_target)

    monkeypatch.setattr(mpc, "candidate_costs", half)


def _altered_energy(monkeypatch):
    """The field energy altered by a tenth where it is produced."""
    from plasma_control_tpu_torch.control import mpc

    energies = mpc._energies

    def altered(state, grid, cfg):
        pe, ke = energies(state, grid, cfg)
        return pe * 1.1, ke

    monkeypatch.setattr(mpc, "_energies", altered)


def _altered_action(monkeypatch):
    """The applied action altered by a twentieth of the coefficient range
    where the solve produces it."""
    from plasma_control_tpu_torch.control import mpc

    plan = mpc.plan

    def altered(*args, **kw):
        action, new_mean, best = plan(*args, **kw)
        return action + 0.1 * torch.ones_like(action), new_mean, best

    monkeypatch.setattr(mpc, "plan", altered)


FAULTS = {"state_unchanged": _unchanged_state, "half_the_particles": _half_the_particles,
          "half_the_plan_state": _half_the_plan_state, "energy_altered": _altered_energy,
          "action_altered": _altered_action}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    r = _run(tiny_cell(name))
    assert r["correct"] is False, r["checks"]
