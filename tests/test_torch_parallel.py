"""The port's sharded PIC step and sharded MPC planner
(``plasma_control_tpu_torch.parallel``) in a real two-process gloo group on
the CPU, against the JAX package's ``parallel/pic_shard.py`` (on the 8
virtual CPU devices of ``tests/conftest.py``) and against the port's
single-rank functions.

The module fixture computes the JAX references in this process, writes the
inputs and the references as ``.npz`` and spawns two ranks of this file run
as a script (``python tests/test_torch_parallel.py RANK PORT DIR``), which
join one gloo group through ``initialize_distributed``, run every check of
the port and write their results back; the tests then read them. Each
check of a rank is recorded on its own, so a failing check fails its test
only. Tolerances: the particle-sharded step within 1e-4 of JAX's and of the
port's single-rank step (its density is scaled after the all-reduce, the
single-rank deposit scales inside); sharded costs within rtol = atol = 1e-4
of JAX's ``candidate_costs``; sharded plans within 1e-5 of the single-rank
``plan`` on the same noise, best cost to 1e-4 relative (JAX's
``tests/_distributed_worker.py``); the two ranks bitwise equal.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
SIM = dict(n_particles=1024, n_mesh=32, dt=0.1, t_max=5.0, length=50.0)
SMALL = dict(SIM, n_particles=256)
LARGE = dict(SIM, n_particles=2**16, n_mesh=128)  # the million-particle step, cut for the CPU
# candidate costs: (environment, MPCConfig) as tests/test_parallel.py has them
COSTS = {
    "spectral": (SIM, dict(horizon=3, n_candidates=16)),
    "fused": (SMALL, dict(horizon=3, n_candidates=32, plan_modes=4, plan_kernel="fused")),
    "chunked": (SMALL, dict(horizon=3, n_candidates=32, plan_modes=4, plan_chunk=2)),
    "twin": (SIM, dict(horizon=3, n_candidates=16, plan_modes=4, plan_particles=512,
                       plan_correction="twin")),
}
PLAN_BASE = dict(horizon=4, n_candidates=32, plan_modes=4)
PLANS = {
    "default": dict(w_terminal=2.0),
    "twin": dict(plan_particles=512, plan_correction="twin"),
    "cem-reduced": dict(algo="cem", n_iters=2, n_elites=8, plan_particles=512),
    "chunked": dict(plan_chunk=8),
}
MAX_MODE = 2
LOOP_STEPS = 2


# ---------------------------------------------------------------------------
# the ranks (run as a script)
# ---------------------------------------------------------------------------


def _rank_checks(rank: int, data: dict) -> dict:
    """Every check of one rank: name -> dict of arrays (or an exception)."""
    import torch
    import torch.distributed as dist

    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.mpc import mpc_rollout, plan, solve_noise
    from plasma_control_tpu_torch.interop import state_from_numpy
    from plasma_control_tpu_torch.models.pic import step
    from plasma_control_tpu_torch.ops.deposit import deposit
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.parallel import pic_shard
    from plasma_control_tpu_torch.parallel.dryrun import dryrun_multichip
    from plasma_control_tpu_torch.parallel.launch import is_multihost, process_summary
    from plasma_control_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    def env(sim):
        cfg = SimConfig(**sim)
        grid = make_grid(cfg.n_mesh, cfg.length, device="cpu")
        act = make_actuator(cfg.length, cfg.n_mesh, MAX_MODE, device="cpu")
        return cfg, grid, act

    def state(name):
        return state_from_numpy(data[f"{name}_x"], data[f"{name}_v"], device="cpu")

    def gathered(t):
        blocks = [torch.empty_like(t) for _ in range(WORLD)]
        dist.all_gather(blocks, t.contiguous())
        return torch.cat(blocks)

    mesh_p = make_mesh(axis_names=("particle",), device_type="cpu")
    mesh_r = make_mesh(axis_names=("rollout",), device_type="cpu")
    ctrl = ControlConfig(max_mode=MAX_MODE)
    checks = {}

    def check(fn):
        try:
            checks[fn.__name__] = {k: np.asarray(v) for k, v in fn().items()}
        except Exception as exc:  # recorded for the test of this check
            checks[fn.__name__] = exc
        return fn

    @check
    def launch():
        summary = process_summary()
        return dict(multihost=is_multihost(), summary=summary,
                    ok=f"process {rank}/{WORLD}, 1 local / {WORLD} global devices" == summary)

    def sharded_step(sim, name, e_ext):
        cfg, grid, _ = env(sim)
        st = state(name)
        step_fn = pic_shard.make_particle_sharded_step(mesh_p, grid, cfg)
        x, v = shard_batch((st.x, st.v), mesh_p, axis="particle")
        e = torch.as_tensor(e_ext)
        x2, v2 = step_fn(x, v, e)
        ref = step(st, grid, cfg, e)
        return dict(x=gathered(x2), v=gathered(v2), single_x=ref.x, single_v=ref.v)

    for name, e_key in (("step", "zero"), ("step_e_ext", "sin")):
        def run(name=name, e_key=e_key):
            return sharded_step(SIM, name, data[f"e_{e_key}"])
        run.__name__ = name
        check(run)

    @check
    def step_large():
        out = sharded_step(LARGE, "step_large", data["e_large"])
        cfg, grid, _ = env(LARGE)
        total = float(deposit(torch.as_tensor(out["x"]), grid).sum()) * grid.dx
        return dict(out, total_charge=total)

    for name, (sim, mpc_kw) in COSTS.items():
        def run(sim=sim, mpc_kw=mpc_kw, name=name):
            from plasma_control_tpu_torch.control.mpc import _plan_model, twin_targets

            cfg, grid, act = env(sim)
            mpc = MPCConfig(**mpc_kw)
            st = state(f"costs_{name}")
            cand = torch.as_tensor(data[f"costs_{name}_cand"])
            target = None
            if mpc.plan_correction == "twin":  # score on the plan model with its targets
                pst, grid, pcfg = _plan_model(st, grid, cfg, mpc)
                target = twin_targets(st.x, pst, pcfg, cfg, ctrl, mpc)
                st, cfg = pst, pcfg
                act = make_actuator(cfg.length, grid.n_mesh, MAX_MODE, device="cpu")
            costs_fn = pic_shard.make_sharded_candidate_costs(mesh_r, grid, cfg, mpc, act)
            return dict(costs=costs_fn(st, cand, target))
        run.__name__ = f"costs_{name}"
        check(run)

    sigma = torch.tensor(0.3)
    for name, mpc_kw in PLANS.items():
        def run(mpc_kw=mpc_kw):
            cfg, grid, act = env(SIM)
            mpc = MPCConfig(**PLAN_BASE, **mpc_kw)
            st = state("plan")
            mean = torch.zeros((mpc.horizon, ctrl.n_actions))
            noise = solve_noise(torch.Generator().manual_seed(7), mpc, mean)
            single = plan(st, mean, sigma, None, grid, cfg, ctrl, mpc, act, noise=noise)
            plan_fn = pic_shard.make_sharded_plan(mesh_r, grid, cfg, ctrl, mpc, act)
            sharded = plan_fn(st, mean, sigma, torch.Generator().manual_seed(7))
            mapped = plan(st, mean, sigma, None, grid, cfg, ctrl, mpc, act, noise=noise,
                          candidate_sharding=mesh_r["rollout"])
            return dict(action=sharded[0], mean=sharded[1], best=sharded[2],
                        single_action=single[0], single_mean=single[1], single_best=single[2],
                        mapped_mean=mapped[1])
        run.__name__ = f"plan_{name}"
        check(run)

    @check
    def closed_loop():
        cfg, grid, act = env(SIM)
        mpc = MPCConfig(**PLAN_BASE)
        st = state("plan")
        roll_fn = pic_shard.make_sharded_mpc_rollout(mesh_r, grid, cfg, ctrl, mpc, act)
        out = roll_fn(st, torch.Generator().manual_seed(1), n_steps=LOOP_STEPS)
        ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, torch.Generator().manual_seed(1),
                          n_steps=LOOP_STEPS)
        x_all = gathered(out.final_state.x[None])
        v_all = gathered(out.final_state.v[None])
        return dict(pe=out.field_energy, coeffs=out.coeffs, x=out.final_state.x,
                    ranks_equal=bool(torch.equal(x_all[0], x_all[1])
                                     and torch.equal(v_all[0], v_all[1])),
                    single_pe=ref.field_energy, single_coeffs=ref.coeffs,
                    single_x=ref.final_state.x)

    @check
    def uneven_split():
        cfg, grid, act = env(SIM)
        mpc = MPCConfig(**dict(PLAN_BASE, n_candidates=31))
        try:
            pic_shard.make_sharded_plan(mesh_r, grid, cfg, ctrl, mpc, act)
        except ValueError as exc:
            return dict(raised="divide evenly" in str(exc))
        return dict(raised=False)

    @check
    def sharded_plan_cache():
        cfg, grid, act = env(SIM)
        mpc = MPCConfig(**PLAN_BASE)
        st = state("plan")
        mean = torch.zeros((mpc.horizon, ctrl.n_actions))
        got = pic_shard.sharded_plan(st, mean, sigma, torch.Generator().manual_seed(0), mesh_r,
                                     grid, cfg, ctrl, mpc, act)
        want = pic_shard.make_sharded_plan(mesh_r, grid, cfg, ctrl, mpc, act)(
            st, mean, sigma, torch.Generator().manual_seed(0))
        return dict(same=all(torch.equal(a, b) for a, b in zip(got, want)))

    @check
    def mesh_2d():
        mesh = make_mesh(axis_sizes=(1, 2), axis_names=("rollout", "particle"),
                         device_type="cpu")
        x = torch.arange(8.0)
        return dict(shape=(mesh.size(0), mesh.size(1)),
                    block=shard_batch(x, mesh, axis="particle"),
                    rollout_block=shard_batch(x, mesh, axis="rollout"))

    @check
    def replicate_tree():
        mesh = make_mesh(axis_sizes=(1, 2), axis_names=("rollout", "particle"),
                         device_type="cpu")
        mine = torch.full((2, 3), float(rank + 1)).t()  # not contiguous
        out = replicate({"a": mine, "n": 5}, mesh)
        return dict(a=out["a"], n=out["n"], untouched=bool(torch.equal(mine, mine * 0 + rank + 1)))

    @check
    def dryrun():
        dryrun_multichip(WORLD, "cpu")
        return dict(ok=True)

    return checks


def _rank_main(rank: int, port: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from plasma_control_tpu_torch.parallel.launch import initialize_distributed

    active = initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                    num_processes=WORLD, process_id=rank, device_type="cpu")
    data = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    checks = _rank_checks(rank, data)
    arrays, errors = {}, {"initialize_distributed": active}
    for name, result in checks.items():
        if isinstance(result, Exception):
            errors[name] = f"{type(result).__name__}: {result}"
        else:
            arrays.update({f"{name}/{k}": v for k, v in result.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(errors, fh)
    import torch.distributed as dist

    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX references and the spawn (pytest)
# ---------------------------------------------------------------------------


def _jax_references() -> dict:
    import jax
    import jax.numpy as jnp

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import _plan_model, candidate_costs, twin_targets
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.ops.grid import make_grid
    from plasma_control_tpu.parallel.mesh import make_mesh, shard_batch
    from plasma_control_tpu.parallel.pic_shard import make_particle_sharded_step

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    rng = np.random.default_rng(11)
    data = {}

    def put_state(name, sim, seed):
        st = init_state(SimConfig(**sim), jax.random.PRNGKey(seed))
        data[f"{name}_x"], data[f"{name}_v"] = np.array(st.x), np.array(st.v)
        return st

    m = SIM["n_mesh"]
    data["e_zero"] = np.zeros(m, np.float32)
    data["e_sin"] = (0.1 * np.sin(2 * np.pi * np.arange(m) / m)).astype(np.float32)
    data["e_large"] = np.zeros(LARGE["n_mesh"], np.float32)
    mesh = make_mesh(axis_names=("particle",))
    for name, sim, seed, e_key in (("step", SIM, 0, "e_zero"), ("step_e_ext", SIM, 3, "e_sin"),
                                   ("step_large", LARGE, 0, "e_large")):
        cfg = SimConfig(**sim)
        st = put_state(name, sim, seed)
        step_fn = make_particle_sharded_step(mesh, make_grid(cfg.n_mesh, cfg.length), cfg)
        x, v = shard_batch((st.x, st.v), mesh, axis="particle")
        x2, v2 = step_fn(x, v, jnp.asarray(data[e_key]))
        data[f"{name}_jax_x"], data[f"{name}_jax_v"] = np.array(x2), np.array(v2)

    ctrl = ControlConfig(max_mode=MAX_MODE)
    for name, (sim, mpc_kw) in COSTS.items():
        cfg, mpc = SimConfig(**sim), MPCConfig(**mpc_kw)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, MAX_MODE)
        st = put_state(f"costs_{name}", sim, 0)
        cand = (0.3 * rng.standard_normal((mpc.n_candidates, mpc.horizon, 2 * MAX_MODE))
                ).astype(np.float32)
        data[f"costs_{name}_cand"] = cand
        if mpc.plan_correction == "twin":
            pst, pgrid, pcfg = _plan_model(st, grid, cfg, mpc)
            target = twin_targets(st.x, pst, pcfg, cfg, ctrl, mpc)
            pact = make_actuator(pcfg.length, pgrid.n_mesh, MAX_MODE)
            ref = candidate_costs(pst, jnp.asarray(cand), pgrid, pcfg, mpc, pact,
                                  twin_target=target)
        else:
            ref = candidate_costs(st, jnp.asarray(cand), grid, cfg, mpc, act)
        data[f"costs_{name}_jax"] = np.array(ref)
    put_state("plan", SIM, 0)
    return data


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(JAX references and inputs, [rank 0, rank 1] arrays, [errors])."""
    out = tmp_path_factory.mktemp("ranks")
    data = _jax_references()
    np.savez(out / "inputs.npz", **data)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), port, str(out)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    errors = [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]
    return data, arrays, errors


def _result(ranks, name):
    """Both ranks' arrays of one check (failing if a rank raised in it)."""
    _, arrays, errors = ranks
    for r, err in enumerate(errors):
        assert name not in err, f"rank {r}: {err[name]}"
    prefix = f"{name}/"
    return [{k[len(prefix):]: v for k, v in a.items() if k.startswith(prefix)} for a in arrays]


def test_initialize_distributed_joins_the_group(ranks):
    _, _, errors = ranks
    assert all(err["initialize_distributed"] is True for err in errors)
    for res in _result(ranks, "launch"):
        assert res["multihost"] and res["ok"], res["summary"]


def test_backend_follows_device_type():
    """The backend is chosen by the device the caller asks for, not by the
    machine: device_type="cpu" makes a gloo group even where CUDA is present;
    a device type other than "cuda" and "cpu" (a numbered card) is refused."""
    import torch.distributed as dist

    from plasma_control_tpu_torch.parallel.launch import initialize_distributed

    call = dict(coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="'cuda:0'"):
        initialize_distributed(**call, device_type="cuda:0")
    assert not dist.is_initialized()
    assert initialize_distributed(**call, device_type="cpu") is False
    try:
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("route", ["torchrun", "explicit"])
def test_initialize_distributed_needs_a_card(monkeypatch, route):
    """With no card and no device_type, initialize_distributed raises before
    any process group is made, under torchrun's variables and with explicit
    arguments alike: it never falls to the CPU unless asked."""
    import torch
    import torch.distributed as dist

    from plasma_control_tpu_torch.parallel.launch import initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _free_port()
    if route == "torchrun":
        for key, value in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port)).items():
            monkeypatch.setenv(key, value)
        call = dict()
    else:
        call = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        initialize_distributed(**call)
    assert not dist.is_initialized()


def test_single_process_is_noop(monkeypatch):
    """No process group and no torchrun variables: not distributed, one
    process; a mesh of one rank then runs on a group made in memory."""
    import torch.distributed as dist

    from plasma_control_tpu_torch.parallel.launch import (initialize_distributed, is_multihost,
                                                          process_summary)
    from plasma_control_tpu_torch.parallel.mesh import make_mesh

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    assert is_multihost() is False
    assert process_summary().startswith("process 0/1")
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("rollout",)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["step", "step_e_ext"])
def test_particle_sharded_step(ranks, name):
    """Two ranks of 512 particles each against JAX's shard_map step (8
    devices) and the port's single-rank step: x and v within 1e-4."""
    data = ranks[0]
    r0, r1 = _result(ranks, name)
    for key in ("x", "v"):
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], data[f"{name}_jax_{key}"], atol=1e-4)
        np.testing.assert_allclose(r0[key], r0[f"single_{key}"], atol=1e-4)


def test_million_scale_step_cut_to_2_16(ranks):
    """Config-5's particle-sharded step cut to 2^16 particles on 128 cells:
    one step conserves charge and agrees with JAX's within 1e-4."""
    data = ranks[0]
    r0, _ = _result(ranks, "step_large")
    assert abs(float(r0["total_charge"]) - SIM["length"]) < 1e-2
    np.testing.assert_allclose(r0["x"], data["step_large_jax_x"], atol=1e-4)
    np.testing.assert_allclose(r0["v"], data["step_large_jax_v"], atol=1e-4)


@pytest.mark.parametrize("name", list(COSTS))
def test_sharded_costs_match_jax(ranks, name):
    """Each rank scores half the candidates; the gathered (K,) costs equal
    JAX's candidate_costs within rtol = atol = 1e-4 on both ranks (the
    spectral planner, its kernel's plain version, chunks of 2 per rank, and
    the twin-corrected costs of a subsampled plan model)."""
    data = ranks[0]
    r0, r1 = _result(ranks, f"costs_{name}")
    np.testing.assert_array_equal(r0["costs"], r1["costs"])
    np.testing.assert_allclose(r0["costs"], data[f"costs_{name}_jax"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(PLANS))
def test_sharded_plan_matches_single_rank(ranks, name):
    """make_sharded_plan from identically seeded generators against the
    single-rank plan on the same draws: action and new mean within 1e-5,
    best cost to 1e-4 relative; plan(candidate_sharding=mesh["rollout"]) the
    same solve bitwise; the two ranks bitwise equal."""
    r0, r1 = _result(ranks, f"plan_{name}")
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    np.testing.assert_allclose(r0["action"], r0["single_action"], atol=1e-5)
    np.testing.assert_allclose(r0["mean"], r0["single_mean"], atol=1e-5)
    best, ref = float(r0["best"]), float(r0["single_best"])
    assert abs(best - ref) < 1e-4 * max(1.0, abs(ref))
    np.testing.assert_array_equal(r0["mapped_mean"], r0["mean"])


def test_sharded_closed_loop(ranks):
    """Two control steps with every solve sharded: the final states of the
    ranks bitwise equal (gathered and compared inside the group), PE within
    1e-5 relative and applied coefficients within 1e-5 of the single-rank
    mpc_rollout from the same generator seed."""
    r0, r1 = _result(ranks, "closed_loop")
    assert bool(r0["ranks_equal"]) and bool(r1["ranks_equal"])
    np.testing.assert_array_equal(r0["x"], r1["x"])
    assert np.isfinite(r0["pe"]).all()
    np.testing.assert_allclose(r0["pe"], r0["single_pe"], rtol=1e-5)
    np.testing.assert_allclose(r0["coeffs"], r0["single_coeffs"], atol=1e-5)


def test_uneven_candidate_split_rejected(ranks):
    for res in _result(ranks, "uneven_split"):
        assert bool(res["raised"])


def test_sharded_plan_wrapper_caches(ranks):
    """sharded_plan (the JAX package's cached wrapper; nothing to cache in
    torch) returns make_sharded_plan's solve bitwise from the same seed."""
    for res in _result(ranks, "sharded_plan_cache"):
        assert bool(res["same"])


def test_2d_mesh(ranks):
    """A (1, 2) rollout x particle mesh: each rank holds its half along
    "particle" and all of it along "rollout"."""
    for r, res in enumerate(_result(ranks, "mesh_2d")):
        assert tuple(res["shape"]) == (1, 2)
        np.testing.assert_array_equal(res["block"], np.arange(4.0) + 4 * r)
        np.testing.assert_array_equal(res["rollout_block"], np.arange(8.0))


def test_replicate_broadcasts_the_first_rank(ranks):
    """replicate over a (1, 2) mesh: both ranks hold the first rank's
    values, the caller's tensor is left as it was, other leaves pass."""
    for res in _result(ranks, "replicate_tree"):
        np.testing.assert_array_equal(res["a"], np.ones((3, 2), np.float32))
        assert int(res["n"]) == 5 and bool(res["untouched"])


def test_dryrun_multichip(ranks):
    for res in _result(ranks, "dryrun"):
        assert bool(res["ok"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
