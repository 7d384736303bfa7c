"""The fidelity guard of the grid-planner slice on CPU, the port against the
JAX package on the same states: the on-device coherent-vs-injected ratio
(``_fidelity_ratio``) and the guard's decision (``_apply_fidelity_guard``)
along a few uncontrolled steps of the slice's bump-on-tail environment, from
the JAX package's initial state at seeds 0, 1 and 2, handed across as numpy.

Run as a script, it counts the solves the guard lets through in 20 closed-loop
steps of the grid slice at its full size (bump-on-tail, N=5000, M=250,
max_mode 4, K=512, H=10, grid plan model on a stride-4 subsample of 1250
particles and 64 cells), once through each package from the same initial
state, for seeds 0, 1 and 2:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_guard_parity.py
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import MPCConfig as JMPCConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import mpc as jmpc
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.models.pic import init_state as jinit_state
from plasma_control_tpu.models.pic import step as jstep
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control import mpc
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

# chip_smoke.py's grid slice: SIM, MAX_MODE and GRID_MPC
SLICE_SIM = dict(simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0,
                 length=50.0, deposit_method="pallas")
SLICE_MPC = dict(n_candidates=512, plan_particles=1024, plan_mesh=64, plan_model="grid")
MAX_MODE = 4
# the same environment and guard at a CPU test's size: N=2000, stride 3
SMALL_SIM = dict(SLICE_SIM, n_particles=2000, t_max=1.0)
SMALL_MPC = dict(n_candidates=8, horizon=3, plan_particles=512, plan_mesh=32, plan_model="grid")
STEPS = 4


def _configs(sim, mpc_kw):
    return ((JSimConfig(**sim), JControlConfig(max_mode=MAX_MODE), JMPCConfig(**mpc_kw)),
            (SimConfig(**sim), ControlConfig(max_mode=MAX_MODE), MPCConfig(**mpc_kw)))


def _states(seed):
    """The JAX package's initial state at ``seed`` and the next STEPS - 1
    uncontrolled steps of it, as numpy."""
    (jcfg, _, _), _ = _configs(SMALL_SIM, SMALL_MPC)
    grid = jmake_grid(jcfg.n_mesh, jcfg.length)
    state = jinit_state(jcfg, jax.random.PRNGKey(seed))
    out = []
    for _ in range(STEPS):
        out.append((np.asarray(state.x).copy(), np.asarray(state.v).copy()))
        state = jstep(state, grid, jcfg)
    return out


@pytest.fixture(scope="module", params=[0, 1, 2], ids=lambda s: f"seed{s}")
def states(request):
    return _states(request.param)


@pytest.mark.parametrize("t", range(STEPS))
def test_guard_decides_as_jax(states, t):
    """The same float32 positions on both sides: the ratio's float32 mode
    sums run in another order (rtol 1e-3, as
    test_torch_grid_plan.py::test_fidelity_statistics_match_jax holds it),
    the decision against fidelity_guard_ratio and the zeroed action and
    warm start are the same, and both agree with the host check
    plan_fidelity_check."""
    x, v = states[t]
    (jcfg, jctrl, jm), (tcfg, tctrl, tm) = _configs(SMALL_SIM, SMALL_MPC)
    assert mpc._plan_frac(tcfg, tm) == jmpc._plan_frac(jcfg, jm) < 1.0
    jr = float(jmpc._fidelity_ratio(jnp.asarray(x), jcfg, jctrl, jm))
    tr = float(mpc._fidelity_ratio(torch.tensor(x), tcfg, tctrl, tm))
    np.testing.assert_allclose(tr, jr, rtol=1e-3)
    host = mpc.plan_fidelity_check(state_from_numpy(x, v, device="cpu"), tcfg, tctrl, tm)
    assert (tr >= tm.fidelity_guard_ratio) == (jr >= jm.fidelity_guard_ratio) == host["safe"]

    d = 2 * MAX_MODE
    plan_out = (np.ones(d, np.float32), np.ones((tm.horizon, d), np.float32), np.float32(1.5))
    ja, jmean, _ = jmpc._apply_fidelity_guard(tuple(jnp.asarray(a) for a in plan_out),
                                              jnp.asarray(x), jcfg, jctrl, jm)
    ta, tmean, _ = mpc._apply_fidelity_guard(tuple(torch.tensor(a) for a in plan_out),
                                             torch.tensor(x), tcfg, tctrl, tm)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tmean.numpy(), np.asarray(jmean))


def count_passes(seed, steps=20):
    """Solves the guard let through (a nonzero applied drive) in ``steps``
    closed-loop steps of the grid slice from the JAX package's initial state
    at ``seed``, through the JAX package and through the port (CPU), and the
    ratio at the initial state on each side."""
    (jcfg, jctrl, jm), (tcfg, tctrl, tm) = _configs(SLICE_SIM, SLICE_MPC)
    m, length = jcfg.n_mesh, jcfg.length
    jstate = jinit_state(jcfg, jax.random.PRNGKey(seed))
    x, v = np.asarray(jstate.x).copy(), np.asarray(jstate.v).copy()
    jout = jmpc.mpc_rollout(jstate, jmake_grid(m, length), jcfg, jctrl, jm,
                            jmake_actuator(length, m, MAX_MODE), jax.random.PRNGKey(100 + seed),
                            n_steps=steps)
    tout = mpc.mpc_rollout(state_from_numpy(x, v, device="cpu"), make_grid(m, length, device="cpu"),
                           tcfg, tctrl, tm, make_actuator(length, m, MAX_MODE, device="cpu"),
                           torch.Generator().manual_seed(100 + seed), n_steps=steps)
    return dict(
        seed=seed,
        jax_passed=int((np.asarray(jout.coeffs) != 0).any(-1).sum()),
        port_passed=int((tout.coeffs != 0).any(-1).sum()),
        jax_ratio=float(jmpc._fidelity_ratio(jnp.asarray(x), jcfg, jctrl, jm)),
        port_ratio=float(mpc._fidelity_ratio(torch.tensor(x), tcfg, tctrl, tm)),
        threshold=tm.fidelity_guard_ratio,
    )


if __name__ == "__main__":
    for s in (0, 1, 2):
        print(count_passes(s), flush=True)
