"""PyTorch port of models/ against the JAX package on CPU: one full PIC step
and its energies from the same numpy state, a short uncontrolled rollout,
and the initial distributions' moments."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.models import pic as jpic
from plasma_control_tpu.models import rollout as jroll
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.models import pic, rollout
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

BASE = dict(simcase="bump-on-tail", n_particles=512, n_mesh=48, dt=0.1, t_max=5.0, length=50.0)


def _state(cfg, rng):
    x = rng.uniform(0, cfg.length, cfg.n_particles).astype(np.float32)
    v = (rng.standard_normal(cfg.n_particles) * 1.5).astype(np.float32)
    return x, v


@pytest.mark.parametrize("integrator", ["yoshida4", "verlet", "symplectic_euler"])
@pytest.mark.parametrize("method,kind", [("dense", "cic"), ("pallas", "cic"), ("pallas", "tsc"),
                                         ("pallas", "tsc_standard")])
def test_step_and_energies_match(rng, method, kind, integrator):
    """One step with an external drive: x, v and the energies agree to fp32
    reassociation of the deposit sums and the circulant matvec (rtol 1e-5
    on x, v and KE; PE is a difference of nearly equal fields, atol 1e-4)."""
    kw = dict(BASE, deposit_method=method, interpol=kind, integrator=integrator)
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    x, v = _state(tcfg, rng)
    coeffs = (0.3 * rng.standard_normal(6)).astype(np.float32)
    jgrid, jact = jmake_grid(48, 50.0), jmake_actuator(50.0, 48, 3)
    tgrid, tact = make_grid(48, 50.0, device="cpu"), make_actuator(50.0, 48, 3, device="cpu")

    jnew = jpic.step(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jgrid, jcfg,
                     jact.compute_e_packed(jnp.asarray(coeffs)))
    tnew = pic.step(state_from_numpy(x, v, device="cpu"), tgrid, tcfg,
                    tact.compute_e_packed(torch.tensor(coeffs)))
    np.testing.assert_allclose(tnew.x.numpy(), np.asarray(jnew.x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tnew.v.numpy(), np.asarray(jnew.v), rtol=1e-5, atol=1e-5)
    jpe, jke = jroll._energies(jnew, jgrid, jcfg)
    tpe, tke = rollout._energies(tnew, tgrid, tcfg)
    np.testing.assert_allclose(float(tpe), float(jpe), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tke), float(jke), rtol=1e-5)


def test_uncontrolled_rollout_matches(rng):
    """Ten steps of the uncontrolled bump-on-tail push with the CIC kernel
    path: the PE trace agrees within 1e-3 relative (fp32 round-off grows
    over the steps of a weakly unstable plasma)."""
    kw = dict(BASE, deposit_method="pallas")
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    x, v = _state(tcfg, rng)
    jout = jroll.rollout(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)),
                         jmake_grid(48, 50.0), jcfg, n_steps=10)
    tout = rollout.rollout(state_from_numpy(x, v, device="cpu"), make_grid(48, 50.0, device="cpu"),
                           tcfg, n_steps=10)
    assert tout.field_energy.shape == (11,)
    np.testing.assert_allclose(tout.field_energy.numpy(), np.asarray(jout.field_energy),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tout.hamiltonian.numpy(), np.asarray(jout.hamiltonian), rtol=1e-4)


@pytest.mark.parametrize("simcase", ["bump-on-tail", "two-stream", "landau"])
def test_initial_state_moments_match(simcase):
    """Random bits cannot agree, so compare moments of N=20000 samples:
    tolerances are ~5 standard errors of each statistic."""
    kw = dict(simcase=simcase, n_particles=20000, n_mesh=64, length=50.0)
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    tx, tv = (a.numpy() for a in pic.init_state(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    jst = jpic.init_state(jcfg, jax.random.PRNGKey(0))
    jx, jv = np.asarray(jst.x), np.asarray(jst.v)
    n = tcfg.n_particles
    assert tx.dtype == np.float32 and tx.shape == tv.shape == (n,)
    assert tx.min() >= 0.0 and tx.max() < tcfg.length
    assert abs(tx.mean() - jx.mean()) < 5 * 2 * 14.4 / np.sqrt(n)  # uniform on [0, 50)
    assert abs(tv.mean() - jv.mean()) < 5 * 2 * jv.std() / np.sqrt(n)
    assert abs(tv.var() / jv.var() - 1.0) < 5 * 2 * np.sqrt(2.0 / n) * 2
    if simcase == "bump-on-tail":
        # beam fraction: the last n - n1 particles are the fast beam
        n1 = int(n * (1.0 / (1.0 + tcfg.bump_a)))
        assert abs(tv[n1:].mean() - jv[n1:].mean()) < 0.05
        assert abs(tv[:n1].mean() - jv[:n1].mean()) < 0.05
        assert abs((tv > 2.0).mean() - (jv > 2.0).mean()) < 5 * 2 * np.sqrt(0.25 / n)
    if simcase == "landau":
        # density perturbation A cos(k x): first Fourier moment of the positions
        k = 2 * np.pi * tcfg.perturb_mode / tcfg.length
        assert abs(np.cos(k * tx).mean() - np.cos(k * jx).mean()) < 5 * 2 * np.sqrt(0.5 / n)


def test_init_state_is_seeded():
    cfg = SimConfig(**BASE)
    a = pic.init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = pic.init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JSimConfig(**BASE))


def test_diagnostics_match(rng):
    """(n, E_mesh, PE, KE, H) of one state through the CIC kernel path:
    fp32 deposit sums and matvec, rtol 1e-5 (PE atol 1e-4 as above)."""
    kw = dict(BASE, deposit_method="pallas")
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    x, v = _state(tcfg, rng)
    jout = jpic.diagnostics(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jmake_grid(48, 50.0), jcfg)
    tout = pic.diagnostics(state_from_numpy(x, v, device="cpu"),
                           make_grid(48, 50.0, device="cpu"), tcfg)
    for name, a, b in zip(("n", "e_mesh", "pe", "ke", "h"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4, err_msg=name)


def test_rollout_snapshots_match_jax(rng):
    """Five recorded steps through the CIC kernel path: the (T+1, N) xs, vs
    and the packed (2N, T+1) snapshot agree with the JAX package's to the
    tolerance of one step above, compounded (atol 1e-4)."""
    kw = dict(BASE, deposit_method="pallas")
    tcfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    x, v = _state(tcfg, rng)
    e_ext = (0.05 * rng.standard_normal((5, 48))).astype(np.float32)
    jout = jroll.rollout(jpic.PlasmaState(jnp.asarray(x), jnp.asarray(v)), jmake_grid(48, 50.0),
                         jcfg, e_external_traj=jnp.asarray(e_ext), record_snapshots=True, n_steps=5)
    tout = rollout.rollout(state_from_numpy(x, v, device="cpu"), make_grid(48, 50.0, device="cpu"),
                           tcfg, e_external_traj=torch.tensor(e_ext), record_snapshots=True,
                           n_steps=5)
    assert tout.xs.shape == tout.vs.shape == (6, 512)
    np.testing.assert_array_equal(tout.xs[0].numpy(), x)
    snap = rollout.snapshot_from_rollout(tout)
    jsnap = jroll.snapshot_from_rollout(jout)
    assert snap.shape == (1024, 6)
    np.testing.assert_allclose(snap.numpy(), np.asarray(jsnap), rtol=1e-5, atol=1e-4)
    plain = rollout.rollout(state_from_numpy(x, v, device="cpu"), make_grid(48, 50.0, device="cpu"),
                            tcfg, n_steps=1)
    assert plain.xs is None and plain.vs is None
    with pytest.raises(ValueError):
        rollout.snapshot_from_rollout(plain)


@pytest.mark.parametrize("simcase", ["bump-on-tail", "two-stream", "landau"])
def test_high_indices_match_jax(simcase):
    """The beam particles' indices: [N1, N) for bump-on-tail, none
    otherwise."""
    from plasma_control_tpu.models.distributions import make_distribution as jmake
    from plasma_control_tpu_torch.models.distributions import make_distribution

    kw = dict(BASE, simcase=simcase, n_particles=1000)
    got = make_distribution(SimConfig(**kw)).high_indices()
    ref = np.asarray(jmake(JSimConfig(**kw)).high_indices())
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numel() > 0) == (simcase == "bump-on-tail")
