"""Multi-rank dry run: one full sharded MPC control step on small shapes.

The counterpart of ``__graft_entry__.py::dryrun_multichip``. Every rank of
the process group calls :func:`dryrun_multichip` after
:func:`.launch.initialize_distributed` (or its own
``init_process_group``): one full-featured MPC solve with the candidates
sharded over a ``"rollout"`` mesh, a two-step closed loop with every solve
sharded, one environment step with the particles sharded over a
``"particle"`` mesh, and a 2D ``("rollout", "particle")`` mesh when the
number of ranks is even. With no process group it runs on a mesh of one
rank.

    torchrun --nproc_per_node R -m plasma_control_tpu_torch.parallel.dryrun
    torchrun --nproc_per_node 2 -m plasma_control_tpu_torch.parallel.dryrun --device cpu

(``--device cpu`` runs on the CPU over a gloo group, with or without a card.)
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def _setup(device, n_particles=512, n_mesh=32, n_candidates=64, horizon=4, max_mode=2):
    from ..config import ControlConfig, MPCConfig, SimConfig
    from ..control.actuator import make_actuator
    from ..models.pic import init_state
    from ..ops.grid import make_grid

    cfg = SimConfig(n_particles=n_particles, n_mesh=n_mesh, dt=0.1, t_max=5.0, length=50.0,
                    deposit_method="pallas")
    ctrl = ControlConfig(max_mode=max_mode)
    mpc = MPCConfig(horizon=horizon, n_candidates=n_candidates)
    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    return cfg, ctrl, mpc, grid, act, state


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
    """One sharded control step over ``n_ranks`` ranks (the process group's
    size), each rank on its own device or, on one card, all on ``device``."""
    from .mesh import make_mesh, shard_batch
    from .pic_shard import make_particle_sharded_step, make_sharded_mpc_rollout, make_sharded_plan

    device_type = torch.device(device).type
    mesh_r = make_mesh(axis_names=("rollout",), device_type=device_type)
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"dryrun_multichip({n_ranks}) in a group of {dist.get_world_size()}")
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else device
    # particles and candidates divisible by the ranks
    cfg, ctrl, mpc, grid, act, state = _setup(dev, n_particles=64 * n_ranks,
                                              n_candidates=8 * n_ranks, horizon=3)

    # rollout sharding: the production solve, every feature of plan
    plan_fn = make_sharded_plan(mesh_r, grid, cfg, ctrl, mpc, act)
    mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
    sigma = torch.tensor(0.3, device=dev)
    action, _, best = plan_fn(state, mean, sigma, torch.Generator(device=dev).manual_seed(0))
    if not math.isfinite(float(best)):
        raise RuntimeError("dryrun: sharded plan's best cost is not finite")

    # closed-loop receding-horizon control, every solve sharded
    roll_fn = make_sharded_mpc_rollout(mesh_r, grid, cfg, ctrl, mpc, act)
    out = roll_fn(state, torch.Generator(device=dev).manual_seed(2), n_steps=2)
    if not bool(torch.isfinite(out.field_energy).all()):
        raise RuntimeError("dryrun: sharded closed loop's PE is not finite")

    # particle sharding: the environment step
    mesh_p = make_mesh(axis_names=("particle",), device_type=device_type)
    step_fn = make_particle_sharded_step(mesh_p, grid, cfg)
    x, v = shard_batch((state.x, state.v), mesh_p, axis="particle")
    x2, _ = step_fn(x, v, act.compute_e_packed(action))
    if not bool(torch.isfinite(x2).all()):
        raise RuntimeError("dryrun: particle-sharded step is not finite")

    # a 2D (rollout x particle) mesh
    if n_ranks % 2 == 0:
        mesh2 = make_mesh(axis_sizes=(n_ranks // 2, 2), axis_names=("rollout", "particle"),
                          device_type=device_type)
        if mesh2.size(0) * mesh2.size(1) != n_ranks:
            raise RuntimeError("dryrun: 2D mesh size")


def main(argv=None) -> None:
    import argparse

    from .launch import initialize_distributed, process_summary

    p = argparse.ArgumentParser(description="one sharded MPC control step on every rank")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    initialize_distributed(device_type=args.device)
    try:
        dryrun_multichip(dist.get_world_size() if dist.is_initialized() else 1, args.device)
        print(f"dryrun ok: {process_summary()}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
