"""PyTorch port of control/sysid.py against the JAX package on CPU: the mode
observable, the excitation rollout with JAX's own initial state and drive
handed across, the float64 Hankel-DMDc fit and Riccati iteration (bitwise:
the same numpy code), the LQR closed loop with 1 and 6 lags, and the
identification end to end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import sysid as jsysid
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.models import pic as jpic
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control import sysid as tsysid
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy, tensor_from_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L, M, N, K = 50.0, 32, 1024, 3
BASE = dict(simcase="two-stream", n_particles=N, n_mesh=M, dt=0.1, t_max=2.0, length=L)


def _setup(method="dense"):
    kw = dict(BASE, deposit_method=method)
    jside = (JSimConfig(**kw), JControlConfig(max_mode=K), jmake_grid(M, L), jmake_actuator(L, M, K))
    tside = (SimConfig(**kw), ControlConfig(max_mode=K), make_grid(M, L, device="cpu"),
             make_actuator(L, M, K, device="cpu"))
    return jside, tside


@pytest.mark.parametrize("method", ["dense", "scatter", "pallas"])
def test_mode_observable_matches(rng, method):
    """z = [Re Ek, Im Ek] of modes 1..K: atol 1e-6 against JAX."""
    (jcfg, _, jg, _), (tcfg, _, tg, _) = _setup(method)
    x = rng.uniform(0, L, N).astype(np.float32)
    got = tsysid.mode_observable(torch.tensor(x), tg, tcfg, K)
    assert got.shape == (2 * K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsysid.mode_observable(jnp.asarray(x), jg,
                                                                              jcfg, K)), atol=1e-6)


def test_excitation_rollout_matches_with_jax_inputs():
    """JAX's excitation rollout draws its state and drive inside one jitted
    function from one key; handing both across (init_state of that key and
    the returned drive), the port's observables agree over 15 driven steps
    (atol 1e-4: fp32 round-off over the steps)."""
    (jcfg, jctrl, jg, ja), (tcfg, tctrl, tg, ta) = _setup("pallas")
    key = jax.random.PRNGKey(3)
    zs, us = jsysid._excite_rollout(key, jg, ja, jcfg, jctrl, 15, 0.15)
    s0 = jpic.init_state(jcfg, key)
    got = tsysid.excite_rollout(state_from_numpy(np.asarray(s0.x), np.asarray(s0.v), device="cpu"),
                                tensor_from_numpy(us, device="cpu"), tg, ta, tcfg, tctrl)
    assert got.shape == (15, 2 * K)
    np.testing.assert_allclose(got.numpy(), np.asarray(zs), atol=1e-4)


def test_excitation_inputs_and_collection():
    """The port's draws: the seeded state and an amplitude-scaled normal
    drive from one generator, repeatable; collect_excitation_data stacks R
    rollouts as float32 numpy."""
    _, (tcfg, tctrl, tg, ta) = _setup()
    s0, us = tsysid.excitation_inputs(tcfg, tctrl, torch.Generator().manual_seed(5), 40, 0.15,
                                      device="cpu")
    s1, us1 = tsysid.excitation_inputs(tcfg, tctrl, torch.Generator().manual_seed(5), 40, 0.15,
                                       device="cpu")
    assert torch.equal(s0.x, s1.x) and torch.equal(us, us1) and us.shape == (40, 2 * K)
    assert 0.1 < float(us.std()) < 0.2
    Z, U = tsysid.collect_excitation_data(tg, ta, tcfg, tctrl, torch.Generator().manual_seed(5),
                                          n_rollouts=2, n_steps=12)
    assert Z.shape == U.shape == (2, 12, 2 * K) and Z.dtype == U.dtype == np.float32
    assert np.isfinite(Z).all()


@pytest.mark.parametrize("n_lags", [1, 3, 6])
def test_hankel_dmdc_and_lqr_gain_bitwise(rng, n_lags):
    """The same float64 numpy code on the same data: A, B, residual and the
    gain bitwise equal."""
    Z = rng.standard_normal((2, 40, 2 * K)).astype(np.float32)
    U = (0.15 * rng.standard_normal((2, 40, 2 * K))).astype(np.float32)
    ta, tb, tres = tsysid.hankel_dmdc(Z, U, n_lags)
    ja, jb, jres = jsysid.hankel_dmdc(Z, U, n_lags)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert tres == jres
    assert ta.shape == (2 * K * (2 * n_lags - 1),) * 2
    gain = tsysid.lqr_gain(0.9 * ta / max(1.0, np.abs(np.linalg.eigvals(ta)).max()), tb,
                           n_obs=2 * K * n_lags, iters=200)
    ref = jsysid.lqr_gain(0.9 * ja / max(1.0, np.abs(np.linalg.eigvals(ja)).max()), jb,
                          n_obs=2 * K * n_lags, iters=200)
    np.testing.assert_array_equal(gain, ref)


@pytest.mark.parametrize("n_lags", [1, 6])
def test_lqr_rollout_matches(rng, n_lags):
    """Ten closed-loop steps with one gain handed to both sides (shaped for
    the loop's lag buffers: n_lags z lags and max(n_lags - 1, 1) u lags,
    the u buffer held at zero with one lag): PE rtol 1e-4, coefficients
    atol 1e-5 (fp32 round-off over the steps)."""
    (jcfg, jctrl, jg, ja), (tcfg, tctrl, tg, ta) = _setup("scatter")
    x = rng.uniform(0, L, N).astype(np.float32)
    v = np.concatenate([np.full(N // 2, 3.0), np.full(N // 2, -3.0)]).astype(np.float32)
    v += (0.5 * rng.standard_normal(N)).astype(np.float32)
    h_dim = 2 * K * (n_lags + max(n_lags - 1, 1))
    gain = (2.0 * rng.standard_normal((2 * K, h_dim)) / np.sqrt(h_dim)).astype(np.float32)
    jout = jsysid.lqr_rollout(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jnp.asarray(gain),
                              jg, ja, jcfg, jctrl, n_lags=n_lags, n_steps=10)
    tout = tsysid.lqr_rollout(state_from_numpy(x, v, device="cpu"), tensor_from_numpy(gain, "cpu"),
                              tg, ta, tcfg, tctrl, n_lags=n_lags, n_steps=10)
    assert tout.field_energy.shape == (10,) and tout.coeffs.shape == (10, 2 * K)
    assert float(tout.coeffs.abs().max()) > 1e-3
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy), rtol=1e-4)
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-5)
    np.testing.assert_allclose(tout.final_state.v.numpy(), np.asarray(jout.final_state.v), atol=1e-4)


def test_identify_lqr_controller_end_to_end():
    """Excite -> fit -> gain on the port's side: a float32 gain of the
    lifted dimension on the grid's device, and the model's residual and
    spectral radius."""
    _, (tcfg, tctrl, tg, ta) = _setup()
    gain, info = tsysid.identify_lqr_controller(tg, ta, tcfg, tctrl, torch.Generator().manual_seed(1),
                                                n_lags=2, n_rollouts=2, excite_steps=30)
    assert gain.dtype == torch.float32 and gain.device.type == "cpu"
    assert gain.shape == (2 * K, 2 * K * 3)
    assert set(info) == {"residual", "spectral_radius"} and np.isfinite(list(info.values())).all()
