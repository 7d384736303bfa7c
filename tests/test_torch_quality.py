"""The port's control-quality gates (plasma_control_tpu_torch/diag/quality.py)
against the JAX package and the reference's artifacts:

* the committed reference states equal the JAX package's ``init_state`` of
  config-4's 8 seeds and of the damping row's seed, bitwise;
* the statistics equal experiments/config4_frontier.py's and
  bench_scaling.py's formulas on a fixed trace;
* the gates pass the artifact against itself and refuse it scaled or with
  one seed moved;
* one handed config-4 state rolled 20 steps by the port equals JAX's.

Run as a script, it writes the reference states from the JAX package
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quality.py``).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.diag.landau import damping_rate_decay_phase as jdamping_rate_decay_phase
from plasma_control_tpu.models.pic import init_state as jinit_state
from plasma_control_tpu.models.rollout import rollout as jrollout
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import SimConfig
from plasma_control_tpu_torch.diag import quality
from plasma_control_tpu_torch.models.rollout import rollout
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(2)


def jax_reference_states() -> dict:
    """The states the reference's scripts start from, drawn by the JAX
    package: config-4's ``PRNGKey(cfg.seed + s)`` (config4_frontier.py:146)
    and the damping row's ``PRNGKey(0)`` (bench_scaling.py:107)."""
    cfg4 = JSimConfig(**quality.CONFIG4)
    c4 = [jinit_state(cfg4, jax.random.PRNGKey(cfg4.seed + s)) for s in range(quality.CONFIG4_SEEDS)]
    damping = jinit_state(JSimConfig(**quality.DAMPING), jax.random.PRNGKey(0))
    return {"config4_x": np.stack([np.asarray(s.x) for s in c4]),
            "config4_v": np.stack([np.asarray(s.v) for s in c4]),
            "damping_x": np.asarray(damping.x)[None], "damping_v": np.asarray(damping.v)[None]}


@pytest.fixture(scope="module")
def jax_states():
    return jax_reference_states()


def test_committed_states_are_jax_init_states(jax_states):
    with np.load(quality.STATES_PATH) as data:
        assert sorted(data.files) == sorted(jax_states)
        for name, want in jax_states.items():
            got = data[name]
            assert got.dtype == np.float32 and got.shape == want.shape, name
            assert np.array_equal(got, want), name
    states = quality.reference_states("config4", device="cpu")
    assert len(states) == quality.CONFIG4_SEEDS
    assert states[3].x.dtype == torch.float32
    assert np.array_equal(states[3].v.numpy(), jax_states["config4_v"][3])
    (damping,) = quality.reference_states("damping", device="cpu")
    assert damping.x.shape == (quality.DAMPING["n_particles"],)
    with pytest.raises(ValueError, match="no reference states"):
        quality.reference_states("config5", device="cpu")


def _trace(n: int = 500) -> np.ndarray:
    """A fixed trace shaped like a two-stream run: growth, peak, decay to a
    noisy floor."""
    rng = np.random.default_rng(3)
    t = np.arange(n) * 0.1
    return 50.0 * np.exp(0.4 * t) / (1.0 + np.exp(0.4 * (t - 12.0))) ** 2 + rng.uniform(5, 9, n)


def test_frontier_stats_match_the_experiment():
    pe = _trace()
    got = quality.frontier_stats(torch.tensor(pe, dtype=torch.float32), 50.0, 500)
    pe32 = pe.astype(np.float32).astype(np.float64)
    ts = np.linspace(0, 50.0, 500)
    # experiments/config4_frontier.py:117-127 before its rounding
    assert got["tail_pe"] == pytest.approx(float(pe32[-len(pe32) // 5:].mean()), rel=1e-12)
    assert got["peak_pe"] == float(pe32.max())
    want_gamma = jdamping_rate_decay_phase(ts[: len(pe32)], jnp.asarray(pe32))
    assert got["gamma_decay_phase"] == pytest.approx(float(want_gamma), rel=1e-5)
    # bench_scaling.py:138: float(jnp.mean(pe[-60:]))
    assert quality.damping_tail(pe32[:300]) == pytest.approx(float(jnp.mean(pe32[:300][-60:])),
                                                             rel=1e-6)


def test_reference_readers():
    frontier = quality.frontier_reference()
    assert len(frontier["uncontrolled"]) == quality.CONFIG4_SEEDS
    assert frontier["uncontrolled"][0] == 17182.1
    assert len(frontier["fullfid_K384"]) == len(frontier["sub10000_K1024_corr_guarded"]) == 8
    assert quality.damping_reference() == {"uncontrolled": 34.28, "feedback": 106.5, "mpc": 14.04}


def test_gates_pass_the_artifact_against_itself_and_refuse_changes():
    frontier = quality.frontier_reference()
    un = np.array(frontier["uncontrolled"])
    assert quality.paired_gate(un, un).ok
    shifted = un.copy()
    shifted[5] *= 1.02
    gate = quality.paired_gate(shifted, un)
    assert not gate.ok and gate.rel[5] == pytest.approx(0.02) and max(gate.rel[:5]) == 0
    assert not quality.paired_gate(2 * un, un).ok
    with pytest.raises(ValueError, match="shape"):
        quality.paired_gate(un[:7], un)
    for row in ("fullfid_K384", "sub10000_K1024_corr_guarded"):
        ref = np.array(frontier[row])
        same = quality.distribution_gate(ref, ref)
        assert same.ok and same.ratio == 1.0 and same.p == pytest.approx(1.0)
        doubled = quality.distribution_gate(2 * ref, ref)
        assert not doubled.ok and doubled.ratio == pytest.approx(2.0)
        assert doubled.p < quality.MIN_P
        assert not quality.distribution_gate(ref / 2, ref).ok


def test_handed_state_rollout_matches_jax(jax_states):
    """Seed 1 of config-4 (N=100000, M=256), 20 uncontrolled steps: the
    port's field energies within 1e-4 relative of JAX's."""
    steps = 20
    x, v = jax_states["config4_x"][1], jax_states["config4_v"][1]
    jcfg = JSimConfig(**quality.CONFIG4)
    jstate = jinit_state(jcfg, jax.random.PRNGKey(jcfg.seed + 1))
    want = np.asarray(jrollout(jstate, jmake_grid(jcfg.n_mesh, jcfg.length), jcfg,
                               n_steps=steps).field_energy)
    cfg = SimConfig(**quality.CONFIG4, deposit_method="pallas")
    state = quality.reference_states("config4", device="cpu")[1]
    assert np.array_equal(state.x.numpy(), x) and np.array_equal(state.v.numpy(), v)
    got = rollout(state, make_grid(cfg.n_mesh, cfg.length, device="cpu"), cfg,
                  n_steps=steps).field_energy.numpy()
    assert got.shape == want.shape == (steps + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


if __name__ == "__main__":
    quality.STATES_PATH.parent.mkdir(exist_ok=True)
    np.savez(quality.STATES_PATH, **jax_reference_states())
    print("wrote", quality.STATES_PATH, file=sys.stderr)
