"""Full-state checkpoints and segmented, resumable rollouts of the port on
CPU (``plasma_control_tpu_torch.io.checkpoint`` / ``io.resume``): the
checkpoint format round trip and its ``like`` checks, the training
checkpoint's crash consistency (the counterparts of
``tests/test_io_utils.py``'s TestTrainCheckpointRobustness), the three
rollouts segmented and interrupted-then-resumed against their uninterrupted
runs bitwise, and each against the JAX package's resumable rollout on the
same numpy state (the MPC run with JAX's per-step draws handed across)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasma_control_tpu.config import ControlConfig as JControlConfig
from plasma_control_tpu.config import MPCConfig as JMPCConfig
from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.control.actuator import make_actuator as jmake_actuator
from plasma_control_tpu.io import resume as jresume
from plasma_control_tpu.models.pic import PlasmaState as JPlasmaState
from plasma_control_tpu.ops.grid import make_grid as jmake_grid
from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.feedback import feedback_rollout
from plasma_control_tpu_torch.control.mpc import mpc_rollout
from plasma_control_tpu_torch.control.rl import ppo
from plasma_control_tpu_torch.interop import state_from_numpy
from plasma_control_tpu_torch.io import resume
from plasma_control_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from plasma_control_tpu_torch.models.pic import init_state
from plasma_control_tpu_torch.models.rollout import rollout
from plasma_control_tpu_torch.ops.grid import make_grid
from test_torch_mpc import _jax_noise

torch.set_num_threads(1)


# ---------------------------------------------------------------- the format


def _tree():
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)  # a state away from the seed's
    return {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "idx": torch.tensor([4, 5], dtype=torch.int64),
            "host": np.linspace(0.0, 1.0, 4),
            "t_done": 7, "scale": 0.25, "flag": True, "none": None,
            "nested": {"moments": [torch.ones(2), torch.zeros(3, dtype=torch.float64)]},
            "generator": gen}


def test_checkpoint_round_trip(tmp_path):
    """Tensors, numpy arrays, scalars and a generator's state come back with
    their dtypes; with ``like`` each tensor on ``like``'s device, and a
    generator set to the stored state draws what the saved one would have
    drawn next."""
    tree = _tree()
    path = str(tmp_path / "sub" / "ck")
    save_checkpoint(path, tree)
    assert os.listdir(tmp_path / "sub") == ["ck"]  # the temporary name is gone
    raw = restore_checkpoint(path)
    torch.testing.assert_close(raw["x"], tree["x"], rtol=0, atol=0)
    assert raw["idx"].dtype == torch.int64 and raw["nested"]["moments"][1].dtype == torch.float64
    assert isinstance(raw["host"], np.ndarray) and raw["host"].dtype == np.float64
    np.testing.assert_array_equal(raw["host"], tree["host"])
    assert (raw["t_done"], raw["scale"], raw["flag"], raw["none"]) == (7, 0.25, True, None)
    assert torch.equal(raw["generator"], tree["generator"].get_state())

    like = dict(_tree(), generator=torch.Generator().get_state())
    out = restore_checkpoint(path, like=like)
    fresh = torch.Generator().manual_seed(99)
    fresh.set_state(out["generator"])
    assert torch.equal(torch.rand(4, generator=fresh), torch.rand(4, generator=tree["generator"]))
    assert out["x"].device == like["x"].device and out["x"].dtype == torch.float32


@pytest.mark.parametrize("change,leaf", [
    (lambda t: t.update(x=torch.zeros(2, 4)), "/x"),
    (lambda t: t.update(idx=torch.zeros(2, dtype=torch.int32)), "/idx"),
    (lambda t: t.update(host=np.zeros(5)), "/host"),
    (lambda t: t.update(scale=1), "/scale"),
    (lambda t: t["nested"]["moments"].append(torch.ones(1)), "/nested/moments"),
    (lambda t: t.pop("scale"), "the root"),
    (lambda t: t.update(generator=torch.Generator().get_state()[:16]), "/generator"),
], ids=["shape", "dtype", "numpy-shape", "scalar-kind", "list-length", "keys", "generator"])
def test_like_mismatch_names_the_leaf(tmp_path, change, leaf):
    """A checkpoint of another structure, shape or dtype (a run at another
    N, say) raises ValueError naming the leaf."""
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree())
    like = _tree()
    change(like)
    with pytest.raises(ValueError, match=f"checkpoint leaf {leaf}"):
        restore_checkpoint(path, like=like)


# ------------------------------------------------- training-state robustness


def _ppo_state():
    cfg, ctrl = SimConfig(n_particles=64, n_mesh=16, t_max=1.0), ControlConfig(max_mode=2)
    gen = torch.Generator().manual_seed(0)
    return ppo.make_ppo(cfg, ctrl, ppo.PPOConfig(mlp_dim=8), gen), gen


def test_train_checkpoint_round_trip(tmp_path):
    """Parameters, Adam's moments and count, the generator, the history and
    the best actor come back; the state written is the state read."""
    from plasma_control_tpu_torch.interop import actor_params_to_numpy

    ts, gen = _ppo_state()
    ts.opt.step([torch.ones_like(p) for p in ts.opt.params])
    torch.rand(3, generator=gen)
    best = actor_params_to_numpy(ts.policy)
    resume.save_train_checkpoint(str(tmp_path), ts, None, gen, 2, {"reward": [1.0, 2.0]}, 2.0,
                                 best)
    assert sorted(os.listdir(tmp_path)) == ["best.msgpack", "meta.npz", "state"]
    other, gen2 = _ppo_state()
    ck = resume.restore_train_checkpoint(str(tmp_path), other, None, gen2)
    assert ck["ep_done"] == 2 and ck["hist"] == {"reward": [1.0, 2.0]} and ck["best_reward"] == 2.0
    for a, b in zip(other.policy.state_dict().values(), ts.policy.state_dict().values()):
        assert torch.equal(a, b)
    assert other.opt.count == 1 and all(torch.equal(a, b) for a, b in zip(other.opt.nu, ts.opt.nu))
    assert torch.equal(torch.rand(3, generator=gen2), torch.rand(3, generator=gen))
    np.testing.assert_array_equal(ck["best_params"]["params"]["Dense_0"]["kernel"],
                                  best["params"]["Dense_0"]["kernel"])


def test_corrupt_meta_returns_none(tmp_path):
    """A truncated meta.npz warns and returns None: a fresh start, not an
    exception in the trainer."""
    (tmp_path / "meta.npz").write_bytes(b"\x00garbage")
    ts, gen = _ppo_state()
    with pytest.warns(UserWarning, match="unreadable training checkpoint meta"):
        assert resume.restore_train_checkpoint(str(tmp_path), ts, None, gen) is None


def test_missing_dir_returns_none(tmp_path):
    assert resume.restore_train_checkpoint(str(tmp_path / "nope"), None, None, None) is None


def test_disagreeing_counters_return_none_and_change_nothing(tmp_path):
    """The state says episode 1, meta.npz episode 2 (a preemption between
    the writes): warn, return None and leave the trainer as it was."""
    ts, gen = _ppo_state()
    resume.save_train_checkpoint(str(tmp_path), ts, None, gen, 1, {"reward": [1.0]}, None,
                                 {"params": {}})
    with open(tmp_path / "meta.npz", "wb") as f:
        np.savez(f, ep_done=np.asarray(2), best_reward=np.asarray(np.nan))
    other, gen2 = _ppo_state()
    before = [t.clone() for t in other.policy.state_dict().values()]
    with pytest.warns(UserWarning, match="inconsistent training checkpoint"):
        assert resume.restore_train_checkpoint(str(tmp_path), other, None, gen2) is None
    assert all(torch.equal(a, b) for a, b in zip(before, other.policy.state_dict().values()))


def test_state_of_another_configuration_returns_none(tmp_path):
    """A checkpoint of a wider network does not fit: warn and start fresh."""
    ts, gen = _ppo_state()
    resume.save_train_checkpoint(str(tmp_path), ts, None, gen, 1, {}, None, {"params": {}})
    cfg, ctrl = SimConfig(n_particles=64, n_mesh=16), ControlConfig(max_mode=2)
    wide = ppo.make_ppo(cfg, ctrl, ppo.PPOConfig(mlp_dim=16), torch.Generator().manual_seed(0))
    with pytest.warns(UserWarning, match="unreadable training checkpoint at"):
        assert resume.restore_train_checkpoint(str(tmp_path), wide, None, gen) is None


# ------------------------------------------------- the rollouts, within the port

L, M = 50.0, 32
CFG = dict(n_particles=500, n_mesh=M, dt=0.1, t_max=4.0, length=L)  # 40 steps


def _setup(max_mode=2, **sim):
    cfg = SimConfig(**dict(CFG, **sim))
    return (cfg, ControlConfig(max_mode=max_mode), make_grid(M, L, device="cpu"),
            make_actuator(L, M, max_mode, device="cpu"),
            init_state(cfg, torch.Generator().manual_seed(0), device="cpu"))


def test_rollout_segmented_and_resumed_bitwise(tmp_path):
    """Segments of 7 equal one rollout; a run cut at step 20 and resumed
    returns steps 21..40 and ends where the uninterrupted run ends."""
    cfg, _, grid, _, st = _setup()
    ref = rollout(st, grid, cfg, record_snapshots=True)
    fin, pe, ke, xs, vs = resume.resumable_rollout(st, grid, cfg, segment_steps=7)
    np.testing.assert_array_equal(pe, ref.field_energy.numpy())
    np.testing.assert_array_equal(ke, ref.kinetic.numpy())
    np.testing.assert_array_equal(xs, ref.xs.numpy())
    np.testing.assert_array_equal(vs, ref.vs.numpy())

    ck = str(tmp_path / "ck")
    resume.resumable_rollout(st, grid, dataclasses.replace(cfg, t_max=2.0), ckpt_path=ck,
                             segment_steps=10)
    fin, pe, _, xs, _ = resume.resumable_rollout(st, grid, cfg, ckpt_path=ck, segment_steps=10)
    assert pe.shape == (20,) and xs.shape == (20, 500)
    np.testing.assert_array_equal(pe, ref.field_energy.numpy()[21:])
    np.testing.assert_array_equal(fin.x.numpy(), ref.final_state.x.numpy())
    np.testing.assert_array_equal(fin.v.numpy(), ref.final_state.v.numpy())
    # not resumed: the whole run again
    _, pe, _, _, _ = resume.resumable_rollout(st, grid, cfg, ckpt_path=ck, resume=False)
    np.testing.assert_array_equal(pe, ref.field_energy.numpy())


def test_rollout_checkpoint_of_another_n_raises(tmp_path):
    cfg, _, grid, _, st = _setup()
    ck = str(tmp_path / "ck")
    resume.resumable_rollout(st, grid, dataclasses.replace(cfg, t_max=0.5), ckpt_path=ck)
    wide_cfg, _, _, _, wide = _setup(n_particles=600)
    with pytest.raises(ValueError, match="checkpoint leaf /x"):
        resume.resumable_rollout(wide, grid, wide_cfg, ckpt_path=ck)


def test_feedback_segmented_and_resumed_bitwise(tmp_path):
    cfg, ctrl, grid, act, st = _setup()
    ref = feedback_rollout(st, grid, cfg, ctrl, act, record_snapshots=True)
    _, tr = resume.resumable_feedback_rollout(st, grid, cfg, ctrl, act, segment_steps=7)
    for name in ("field_energy", "kinetic", "coeff_cos", "coeff_sin", "input_energy", "xs", "vs"):
        np.testing.assert_array_equal(tr[name], getattr(ref, name).numpy(), err_msg=name)

    ck = str(tmp_path / "fb")
    resume.resumable_feedback_rollout(st, grid, dataclasses.replace(cfg, t_max=2.0), ctrl, act,
                                      ckpt_path=ck, segment_steps=10)
    fin, tr = resume.resumable_feedback_rollout(st, grid, cfg, ctrl, act, ckpt_path=ck,
                                                segment_steps=10)
    assert tr["field_energy"].shape == (20,) and tr["xs"].shape == (20, 500)
    np.testing.assert_array_equal(tr["field_energy"], ref.field_energy.numpy()[20:])
    np.testing.assert_array_equal(tr["coeff_cos"], ref.coeff_cos.numpy()[20:])
    np.testing.assert_array_equal(fin.x.numpy(), ref.final_state.x.numpy())


MPC_CFG = dict(n_particles=400, t_max=1.2)  # 12 steps
MPC_KW = dict(horizon=3, n_candidates=8)


def test_mpc_segmented_and_resumed_bitwise(tmp_path):
    """The generator's state travels in the checkpoint: a run cut at step 6
    (a shorter t_max) and resumed applies the uninterrupted run's
    coefficients, and ``coeffs_full`` carries the first six across."""
    cfg, ctrl, grid, act, st = _setup(**MPC_CFG)
    mpc = MPCConfig(**MPC_KW)
    ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, torch.Generator().manual_seed(7))
    _, tr = resume.resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act,
                                         torch.Generator().manual_seed(7), segment_steps=5)
    for name in ("field_energy", "kinetic", "hamiltonian", "coeffs", "input_energy", "plan_cost"):
        np.testing.assert_array_equal(tr[name], getattr(ref, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(tr["coeffs_full"], ref.coeffs.numpy())

    ck = str(tmp_path / "mpc")
    resume.resumable_mpc_rollout(st, grid, dataclasses.replace(cfg, t_max=0.6), ctrl, mpc, act,
                                 torch.Generator().manual_seed(7), ckpt_path=ck, segment_steps=3)
    fin, tr = resume.resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act,
                                           torch.Generator().manual_seed(7), ckpt_path=ck,
                                           segment_steps=3)
    assert tr["field_energy"].shape == (6,) and tr["coeffs"].shape == (6, 4)
    np.testing.assert_array_equal(tr["field_energy"], ref.field_energy.numpy()[6:])
    np.testing.assert_array_equal(tr["coeffs_full"], ref.coeffs.numpy())
    np.testing.assert_array_equal(fin.x.numpy(), ref.final_state.x.numpy())


def test_mpc_step_noise_is_indexed_by_global_step(tmp_path):
    """With handed-in draws a resumed run takes rows t_resume.. of them."""
    cfg, ctrl, grid, act, st = _setup(**MPC_CFG)
    mpc = MPCConfig(**MPC_KW)
    gen = torch.Generator().manual_seed(5)
    from plasma_control_tpu_torch.control.mpc import draw_noise

    noise = torch.stack([draw_noise(gen, mpc, 3, 4, device="cpu") for _ in range(cfg.n_steps)])
    ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, step_noise=noise)
    ck = str(tmp_path / "mpc")
    resume.resumable_mpc_rollout(st, grid, dataclasses.replace(cfg, t_max=0.5), ctrl, mpc, act,
                                 ckpt_path=ck, segment_steps=2, step_noise=noise)
    _, tr = resume.resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act, ckpt_path=ck,
                                         segment_steps=4, step_noise=noise)
    np.testing.assert_array_equal(tr["coeffs_full"], ref.coeffs.numpy())


# ------------------------------------------------------------- against JAX

JL, JM = 50.0, 32


def _jax_and_port(sim, max_mode, rng):
    x = rng.uniform(0, JL, sim["n_particles"]).astype(np.float32)
    v = (rng.standard_normal(sim["n_particles"]) * 1.5).astype(np.float32)
    v[sim["n_particles"] // 2:] += 3.0
    j = dict(state=JPlasmaState(jnp.asarray(x), jnp.asarray(v)), grid=jmake_grid(JM, JL),
             cfg=JSimConfig(**sim), ctrl=JControlConfig(max_mode=max_mode),
             act=jmake_actuator(JL, JM, max_mode))
    t = dict(state=state_from_numpy(x, v, device="cpu"), grid=make_grid(JM, JL, device="cpu"),
             cfg=SimConfig(**sim), ctrl=ControlConfig(max_mode=max_mode),
             act=make_actuator(JL, JM, max_mode, device="cpu"))
    return j, t


def test_resumable_rollout_matches_jax(rng):
    """Ten bump-on-tail steps in segments of 4 from one numpy state: PE
    within 1e-3 relative and the snapshots within 1e-4, the tolerances of
    ``test_torch_pic.py``'s uncontrolled rollout and snapshots."""
    sim = dict(simcase="bump-on-tail", n_particles=512, n_mesh=JM, dt=0.1, t_max=1.0, length=JL)
    j, t = _jax_and_port(sim, 2, rng)
    _, jpe, jke, jxs, _ = jresume.resumable_rollout(j["state"], j["grid"], j["cfg"],
                                                    segment_steps=4)
    _, pe, ke, xs, _ = resume.resumable_rollout(t["state"], t["grid"], t["cfg"], segment_steps=4)
    assert pe.shape == jpe.shape == (11,) and xs.shape == jxs.shape
    np.testing.assert_allclose(pe, jpe, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ke, jke, rtol=1e-4)
    np.testing.assert_allclose(xs, jxs, rtol=1e-5, atol=1e-4)


def test_resumable_feedback_matches_jax(rng):
    """Ten closed-loop feedback steps of a two-stream plasma in segments of
    4: PE and input energy rtol 1e-4, coefficients atol 1e-5, snapshots atol
    1e-4, as ``test_torch_feedback.py`` holds the unsegmented loop."""
    sim = dict(simcase="two-stream", n_particles=1024, n_mesh=JM, dt=0.1, t_max=1.0, length=JL)
    j, t = _jax_and_port(sim, 3, rng)
    _, jtr = jresume.resumable_feedback_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"],
                                                j["act"], segment_steps=4)
    _, tr = resume.resumable_feedback_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"],
                                              t["act"], segment_steps=4)
    for name in ("field_energy", "input_energy"):
        np.testing.assert_allclose(tr[name], jtr[name], rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("coeff_cos", "coeff_sin"):
        np.testing.assert_allclose(tr[name], jtr[name], atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tr["xs"], jtr["xs"], atol=1e-4)


def test_resumable_mpc_matches_jax(rng):
    """Three control steps in segments of 2, JAX's per-step draws (its key
    schedule split from one key) handed to the port as ``step_noise``: PE
    rtol 2e-3 and applied coefficients atol 1e-3, the tolerances of
    ``test_torch_mpc.py``'s closed loop."""
    sim = dict(simcase="bump-on-tail", n_particles=384, n_mesh=JM, dt=0.1, t_max=0.3, length=JL)
    mpc_kw = dict(horizon=4, n_candidates=16, plan_modes=4, w_terminal=4.0, plan_kernel="xla")
    j, t = _jax_and_port(sim, 2, rng)
    jmpc, key = JMPCConfig(**mpc_kw), jax.random.PRNGKey(11)
    _, jtr = jresume.resumable_mpc_rollout(j["state"], j["grid"], j["cfg"], j["ctrl"], jmpc,
                                           j["act"], key, segment_steps=2)
    noise = torch.tensor(np.stack([_jax_noise(k, jmpc, 4) for k in jax.random.split(key, 3)]))
    _, tr = resume.resumable_mpc_rollout(t["state"], t["grid"], t["cfg"], t["ctrl"],
                                         MPCConfig(**mpc_kw), t["act"], segment_steps=2,
                                         step_noise=noise)
    assert tr["coeffs_full"].shape == jtr["coeffs_full"].shape == (3, 4)
    np.testing.assert_allclose(tr["coeffs_full"], jtr["coeffs_full"], atol=1e-3)
    np.testing.assert_allclose(tr["field_energy"], jtr["field_energy"], rtol=2e-3)
