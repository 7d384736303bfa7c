"""The trainers' full training-state checkpoint on CPU: DDPG, PPO and SAC
interrupted after episode 1 and resumed to episode 3 equal an uninterrupted
run of 3 bitwise (the counterparts of ``tests/test_rl.py``'s
``test_train_checkpoint_resume``, which hold JAX's to 1e-6); the state
dicts of ``Adam`` and ``ReplayBuffer``; and the checkpoint's best actor in
flax's layout."""

import flax.serialization
import flax.traverse_util
import numpy as np
import pytest
import torch

from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.rl import ddpg, ppo, sac
from plasma_control_tpu_torch.control.rl.buffer import ReplayBuffer
from plasma_control_tpu_torch.control.rl.optim import Adam
from plasma_control_tpu_torch.interop import actor_params_to_numpy
from plasma_control_tpu_torch.ops.grid import make_grid

torch.set_num_threads(1)

TINY_SIM = dict(n_particles=64, n_mesh=16, dt=0.1, t_max=1.0)  # 10 steps
TRAINERS = {
    "ddpg": (ddpg, lambda: ddpg.DDPGConfig(mlp_dim=8, capacity=50, min_buffer_size=5,
                                           update_freq=2, batch_size=4, n_bc_epochs=3),
             lambda ts: ts.actor),
    "ppo": (ppo, lambda: ppo.PPOConfig(mlp_dim=8, chunk_size=4), lambda ts: ts.policy),
    "sac": (sac, lambda: sac.SACConfig(mlp_dim=8, capacity=16, batch_size=4), lambda ts: ts.actor),
}


def _train(name, episodes, **kw):
    mod, hp, _ = TRAINERS[name]
    cfg, ctrl = SimConfig(**TINY_SIM), ControlConfig(max_mode=2, reward_n_mesh=16)
    grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device="cpu")
    return mod.train(cfg, ctrl, hp(), grid, act, torch.Generator().manual_seed(3),
                     num_episodes=episodes, verbose=0, **kw)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_resumed_training_equals_uninterrupted(name, tmp_path, capsys):
    """Interrupted after episode 1 (ckpt_every=1) and resumed to 3: the
    history, every network and optimiser moment, the buffer and the best
    actor are bitwise those of an uninterrupted run of 3 episodes (the
    resumed run skips the offline stage and draws on from the restored
    generator state)."""
    actor_of = TRAINERS[name][2]
    ts_full, best_full, hist_full = _train(name, 3)
    ck = str(tmp_path / "ck")
    _train(name, 1, ckpt_path=ck, ckpt_every=1)
    ts_res, best_res, hist_res = _train(name, 3, ckpt_path=ck, ckpt_every=1)
    assert f"resumed {name.upper()} training from {ck} at episode 1" in capsys.readouterr().out
    assert set(hist_res) == set(hist_full)
    for k in hist_full:
        assert hist_res[k].shape == (3,)
        np.testing.assert_array_equal(hist_res[k], hist_full[k], err_msg=k)
    for field in vars(ts_full):
        a, b = getattr(ts_full, field), getattr(ts_res, field)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), field
        elif isinstance(a, Adam):
            assert a.count == b.count and all(torch.equal(x, y) for x, y in
                                               zip(a.mu + a.nu, b.mu + b.nu)), field
        else:
            for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
                assert torch.equal(x, y), f"{field}.{k}"
    flat = lambda t: [np.asarray(x) for x in flax.traverse_util.flatten_dict(t).values()]
    for x, y in zip(flat(best_full), flat(best_res)):
        np.testing.assert_array_equal(x, y)
    # the checkpoint after the last episode holds episode 3
    assert int(np.load(f"{ck}/meta.npz")["ep_done"]) == 3
    # the best actor in flax's layout, read by flax
    with open(f"{ck}/best.msgpack", "rb") as f:
        restored = flax.serialization.from_bytes(actor_params_to_numpy(actor_of(ts_res)), f.read())
    for x, y in zip(flat(restored), flat(best_res)):
        np.testing.assert_array_equal(x, y)


def test_no_resume_ignores_the_checkpoint(tmp_path, capsys):
    """resume=False trains from scratch (and overwrites the checkpoint)."""
    ck = str(tmp_path / "ck")
    _train("ppo", 1, ckpt_path=ck, ckpt_every=1)
    _, _, hist = _train("ppo", 2, ckpt_path=ck, resume=False)
    assert "resumed" not in capsys.readouterr().out and hist["reward"].shape == (2,)
    _, _, ref = _train("ppo", 2)
    np.testing.assert_array_equal(hist["reward"], ref["reward"])


def test_adam_state_dict_round_trip():
    """Moments and count copied into another optimiser over the same
    shapes; the next step of both is bitwise the same."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(3, 2, generator=gen), torch.randn(4, generator=gen)]
    twin = [p.clone() for p in params]
    a, b = Adam(params, 1e-2, max_norm=1.0), Adam(twin, 1e-2, max_norm=1.0)
    for _ in range(2):
        a.step([torch.randn(p.shape, generator=gen) for p in params])
    b.load_state_dict({k: ([t.clone() for t in v] if isinstance(v, list) else v)
                       for k, v in a.state_dict().items()})
    for p, q in zip(params, twin):
        q.copy_(p)
    g = [torch.randn(p.shape, generator=gen) for p in params]
    a.step(g)
    b.step(g)
    assert a.count == b.count == 3
    assert all(torch.equal(p, q) for p, q in zip(params, twin))
    with pytest.raises(ValueError, match="Adam"):
        Adam([torch.zeros(5)], 1e-2).load_state_dict(a.state_dict())


@pytest.mark.parametrize("pushes", [3, 9], ids=["partial", "wrapped"])
def test_replay_buffer_state_dict_round_trip(pushes):
    """Only the filled rows are kept; pointer and count come back, and the
    same draws sample the same transitions."""
    gen = torch.Generator().manual_seed(1)
    buf = ReplayBuffer(6, 4, 2, device="cpu")
    for _ in range(pushes):
        buf.push(torch.randn(4, generator=gen), torch.randn(2, generator=gen),
                 torch.randn(4, generator=gen), 0.5, 0.0, torch.randn(2, generator=gen))
    state = buf.state_dict()
    assert state["fields"]["state"].shape == (min(pushes, 6), 4)
    other = ReplayBuffer(6, 4, 2, device="cpu")
    other.load_state_dict({**state, "fields": {k: v.clone() for k, v in state["fields"].items()}})
    assert (other.ptr, other.size) == (buf.ptr, buf.size)
    idx = torch.arange(other.size)
    assert all(torch.equal(a, b) for a, b in zip(buf.sample(idx), other.sample(idx)))
    with pytest.raises(ValueError, match="replay buffer"):
        ReplayBuffer(6, 5, 2, device="cpu").load_state_dict(state)
