"""PyTorch port of the feedback loop and the stateful wrappers against the
JAX package on CPU: ``feedback_rollout`` with every deposit method, with and
without snapshots; ``EField``; the ``PIC`` wrapper; ``rollout_batch``; and
``policy_rollout``. Both sides start from the same numpy state."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control import actuator as jact
from plasma_control_tpu.control.evaluate import policy_rollout as jpolicy_rollout
from plasma_control_tpu.control.feedback import feedback_rollout as jfeedback_rollout
from plasma_control_tpu.models import pic as jpic
from plasma_control_tpu.models import rollout as jroll
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control import actuator as tact
from plasma_control_tpu_torch.control.evaluate import policy_rollout
from plasma_control_tpu_torch.control.feedback import feedback_rollout
from plasma_control_tpu_torch.interop import state_from_numpy, tensor_from_numpy
from plasma_control_tpu_torch.models import pic as tpic
from plasma_control_tpu_torch.models import rollout as troll
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

L, M, N, K = 50.0, 32, 1024, 3
STEPS = 10
BASE = dict(simcase="two-stream", n_particles=N, n_mesh=M, dt=0.1, t_max=STEPS * 0.1, length=L)


def _state(rng, n=N, batch=()):
    x = rng.uniform(0, L, batch + (n,)).astype(np.float32)
    v = np.where(np.arange(n) < n // 2, 3.0, -3.0).astype(np.float32) + \
        (0.5 * rng.standard_normal(batch + (n,))).astype(np.float32)
    return x, v.astype(np.float32)


def _both(method="dense"):
    kw = dict(BASE, deposit_method=method)
    return (JSimConfig(**kw), jmake_grid(M, L), jact.make_actuator(L, M, K)), \
        (SimConfig(**kw), make_grid(M, L, device="cpu"), tact.make_actuator(L, M, K, device="cpu"))


@pytest.mark.parametrize("snapshots", [False, True], ids=["no-snapshots", "snapshots"])
@pytest.mark.parametrize("method", ["dense", "scatter", "pallas"])
def test_feedback_rollout_matches(rng, method, snapshots):
    """Ten closed-loop steps of a two-stream plasma (JAX's pallas method
    runs its Pallas kernels in interpret mode here, the port the kernels'
    plain versions): PE, KE, H and input energy rtol 1e-4, coefficients
    atol 1e-5, snapshots atol 1e-4 (fp32 round-off of the deposit sums
    grows over the steps of an unstable plasma: ~4e-6 relative on PE and
    ~1.5e-5 on positions after ten steps)."""
    (jcfg, jg, ja), (tcfg, tg, ta) = _both(method)
    x, v = _state(rng)
    jout = jfeedback_rollout(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jg, jcfg,
                             JControlConfig(max_mode=K), ja, record_snapshots=snapshots)
    tout = feedback_rollout(state_from_numpy(x, v, device="cpu"), tg, tcfg, ControlConfig(max_mode=K),
                            ta, record_snapshots=snapshots)
    assert tout.field_energy.shape == (STEPS,) and tout.coeff_cos.shape == (STEPS, K)
    for name in ("field_energy", "kinetic", "hamiltonian", "input_energy"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("coeff_cos", "coeff_sin"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-5, err_msg=name)
    if snapshots:
        assert tout.xs.shape == (STEPS + 1, N)
        np.testing.assert_array_equal(tout.xs[0].numpy(), x)
        np.testing.assert_allclose(tout.xs.numpy(), np.asarray(jout.xs), atol=1e-4)
        np.testing.assert_allclose(tout.vs.numpy(), np.asarray(jout.vs), atol=1e-4)
    else:
        assert tout.xs is None and tout.vs is None
    np.testing.assert_allclose(tout.final_state.x.numpy(), np.asarray(jout.final_state.x), atol=1e-4)


def test_feedback_rollout_n_steps_and_law(rng):
    """``n_steps`` overrides cfg.n_steps; the first step's coefficients are
    the law of the initial field, and its input energy their effort."""
    from plasma_control_tpu_torch.control.feedback import feedback_coefficients
    from plasma_control_tpu_torch.ops.fields import compute_e

    _, (tcfg, tg, ta) = _both()
    x, v = _state(rng)
    out = feedback_rollout(state_from_numpy(x, v, device="cpu"), tg, tcfg, ControlConfig(max_mode=K),
                           ta, n_steps=3)
    assert out.field_energy.shape == (3,)
    a, b = feedback_coefficients(compute_e(torch.tensor(x), tg)[1], K)
    torch.testing.assert_close(out.coeff_cos[0], a)
    torch.testing.assert_close(out.coeff_sin[0], b)
    torch.testing.assert_close(out.input_energy[0], ta.input_energy(torch.cat([a, b])))


def test_efield_matches(rng):
    """EField against JAX: held coefficients, per-call coefficients, the
    reference-name aliases, update_params rebuilding the basis (rtol 1e-5)."""
    je = jact.EField(L, M, K)
    te = tact.EField(L, M, K, device="cpu")
    np.testing.assert_array_equal(te.compute_E().numpy(), np.asarray(je.compute_E()))
    c, s = rng.standard_normal(K).astype(np.float32), rng.standard_normal(K).astype(np.float32)
    je.update_E(c, s)
    te.update_E(c, s)
    np.testing.assert_allclose(te.compute_e().numpy(), np.asarray(je.compute_e()), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te.compute_E(s, c).numpy(), np.asarray(je.compute_E(s, c)),
                               rtol=1e-5, atol=1e-6)
    te.update_params(max_mode=5, endpoint_grid=False)
    je.update_params(max_mode=5, endpoint_grid=False)
    assert te.coeff_cos.shape == (5,) and not bool(te.coeff_cos.any())
    c5 = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(te.compute_e(c5, c5).numpy(), np.asarray(je.compute_e(c5, c5)),
                               rtol=1e-5, atol=1e-6)
    assert te.update_E == te.update_e and te.compute_E == te.compute_e


def test_pic_wrapper_matches(rng):
    """The PIC wrapper's stepping and observers against JAX's from one handed
    state: update_state with a drive, update_state_w_input_func with a
    state-dependent field, the packed state, energies, density and field;
    then simulate: (2N, Nt+1) snapshot, H and PE, advancing the state.
    rtol 1e-4 on energies, atol 1e-4 elsewhere."""
    cfg = dict(BASE, t_max=0.5)
    jp = jpic.PIC(JSimConfig(**cfg), key=jax.random.PRNGKey(0))
    tp = tpic.PIC(SimConfig(**cfg), gen=torch.Generator().manual_seed(0), device="cpu")
    assert tp.x.shape == (N,) and tp.grid.n_mesh == M
    x, v = _state(rng)
    jp.state = jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v))
    tp.state = state_from_numpy(x, v, device="cpu")
    e_ext = (0.1 * rng.standard_normal(M)).astype(np.float32)
    jp.update_state(jnp.asarray(e_ext))
    tp.update_state(torch.tensor(e_ext))
    ja, ta = jact.make_actuator(L, M, K), tact.make_actuator(L, M, K, device="cpu")

    def jfn(xq):
        return ja.compute_e(jnp.full(K, 0.01) * jnp.mean(xq), jnp.zeros(K))

    def tfn(xq):
        return ta.compute_e(torch.full((K,), 0.01) * torch.mean(xq), torch.zeros(K))

    jp.update_state_w_input_func(jfn)
    tp.update_state_w_input_func(tfn)
    np.testing.assert_allclose(tp.get_state().numpy(), np.asarray(jp.get_state()), atol=1e-4)
    for name in ("get_energy", "get_electric_energy"):
        np.testing.assert_allclose(float(getattr(tp, name)()), float(getattr(jp, name)()), rtol=1e-4)
    for name in ("get_density", "get_e_mesh"):
        np.testing.assert_allclose(getattr(tp, name)().numpy(), np.asarray(getattr(jp, name)()),
                                   atol=1e-4)
    x1 = tp.x.clone()
    jsnap, jh, jpe = jp.simulate()
    tsnap, th, tpe = tp.simulate()
    assert tsnap.shape == (2 * N, 6) and th.shape == tpe.shape == (6,)
    np.testing.assert_array_equal(tsnap[:N, 0].numpy(), x1.numpy())
    np.testing.assert_allclose(tsnap.numpy(), np.asarray(jsnap), atol=1e-4)
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4)
    np.testing.assert_array_equal(tp.x.numpy(), tsnap[:N, -1].numpy())


def test_pic_wrapper_lifecycle():
    """Seeded draws repeat; reinit draws a new state; update_params derives
    a new config and grid and resamples (ignoring unknown and None keys)."""
    cfg = SimConfig(**BASE)
    a = tpic.PIC(cfg, device="cpu")
    b = tpic.PIC(cfg, device="cpu")
    assert torch.equal(a.x, b.x)
    a.reinit()
    assert not torch.equal(a.x, b.x)
    a.update_params(n_mesh=16, n_particles=512, no_such_field=3, dt=None)
    assert a.cfg.n_mesh == 16 and a.grid.n_mesh == 16 and a.x.shape == (512,) and a.cfg.dt == 0.1
    assert a.get_density().shape == (16,)


@pytest.mark.parametrize("fields", [False, True], ids=["no-fields", "fields"])
def test_rollout_batch_matches(rng, fields):
    """B=3 rows, 8 steps, as one batch on the port's side and a vmap on
    JAX's: (B, T+1) energies rtol 1e-3, the final states atol 1e-4; and each
    row equals the port's own single rollout (rtol 1e-5)."""
    (jcfg, jg, _), (tcfg, tg, _) = _both("pallas")
    x, v = _state(rng, batch=(3,))
    trajs = (0.1 * rng.standard_normal((3, 8, M))).astype(np.float32) if fields else None
    jout = jroll.rollout_batch(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jg, jcfg,
                               None if trajs is None else jnp.asarray(trajs), n_steps=8)
    tout = troll.rollout_batch(state_from_numpy(x, v, device="cpu"), tg, tcfg,
                               None if trajs is None else torch.tensor(trajs), n_steps=8)
    assert tout.field_energy.shape == (3, 9) and tout.xs is None
    for name in ("field_energy", "kinetic", "hamiltonian"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tout.final_state.x.numpy(), np.asarray(jout.final_state.x), atol=1e-4)
    for b in range(3):
        one = troll.rollout(state_from_numpy(x[b], v[b], device="cpu"), tg, tcfg,
                            None if trajs is None else torch.tensor(trajs[b]), n_steps=8)
        np.testing.assert_allclose(tout.field_energy[b].numpy(), one.field_energy.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_policy_rollout_matches(rng):
    """A linear policy a = clip(W [x; v]) through both packages for 8 steps,
    the weights handed across as numpy: PE rtol 1e-3, coefficients atol
    1e-4, snapshots atol 1e-4."""
    (jcfg, jg, ja), (tcfg, tg, ta) = _both("scatter")
    x, v = _state(rng)
    w = (rng.standard_normal((2 * K, 2 * N)) / (4 * N)).astype(np.float32)
    jw, tw = jnp.asarray(w), tensor_from_numpy(w, device="cpu")
    jout = jpolicy_rollout(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jg, jcfg, ja,
                           lambda s: jnp.clip(jw @ s, -1.0, 1.0), n_steps=8)
    tout = policy_rollout(state_from_numpy(x, v, device="cpu"), tg, tcfg, ta,
                          lambda s: torch.clamp(tw @ s, -1.0, 1.0), n_steps=8)
    assert tout.coeffs.shape == (8, 2 * K) and tout.xs.shape == (9, N)
    assert float(tout.coeffs.abs().max()) > 1e-3
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(tout.hamiltonian.numpy(), np.asarray(jout.hamiltonian), rtol=1e-3)
    np.testing.assert_allclose(tout.coeffs.numpy(), np.asarray(jout.coeffs), atol=1e-4)
    np.testing.assert_allclose(tout.vs.numpy(), np.asarray(jout.vs), atol=1e-4)
    bare = policy_rollout(state_from_numpy(x, v, device="cpu"), tg, tcfg, ta,
                          lambda s: torch.clamp(tw @ s, -1.0, 1.0), record_snapshots=False, n_steps=2)
    assert bare.xs is None and bare.vs is None
