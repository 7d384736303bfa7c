#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU (sm_90a), the
CUDA toolkit (nvcc) and PyTorch built for CUDA. It imports only
``plasma_control_tpu_torch``, never jax, and works through these phases;
any failure exits non-zero:

1. find the card (no CPU fallback) and print its name and power limit as
   nvidia-smi reports them;
2. build the CUDA kernels from ``plasma_control_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, with the tolerance printed, and time both (CUDA
   events, median of 30 calls): the spectral slice's kernels 1-3; the grid
   planner's kernels 4-6 at its plan model (K=512, H=10, N=1250, M=64),
   kernel 5 against kernel 6 (one contract); kernel 1 with its particle
   state in global memory (N=20000, K=64, H=10, Km=16);
4. run the control loops, each with every launch count set to 0 just before
   it and read just after:
   a. the spectral slice, the repo's headline MPC configuration
      (bump-on-tail, N=5000, M=250, max_mode 4, K=384, H=6, Km=8, rot drift,
      CIC kernels for the environment step), all 500 control steps after a
      three-step warm-up, plus the uncontrolled rollout from the same seeded
      state;
   b. the grid-planner slice (``experiments/bot_bench_scale_debug.py:32-46``:
      the same environment, K=512, H=10, grid plan model with staggered KDK
      on a stride-4 subsample of 1250 particles and a 64-cell plan mesh,
      fidelity guard on), all 500 control steps: one launch of kernel 6 per
      solve;
   c. 20 control steps of the grid slice with ``plan_integrator="leapfrog"``:
      H launches of kernel 4 per solve;
   d. kernel 5, which has no caller in either package: it scores ten of the
      grid slice's candidate blocks beside kernel 6, at the state the 500-step
      loop ended in, as ``experiments/test_pallas_fused_step.py`` does;
   e. three control steps of config-4's full-fidelity controller
      (``bench_scaling.py:222-227,276-287``: two-stream, N=100000, M=256,
      max_mode 8, K=384, H=10, Km=16), kernel 1 with its state in global
      memory; then kernel 1 against its plain version at those shapes;
5. check one candidate block and a three-step closed loop on the card
   against the same computation on the CPU, where every wrapper runs its
   plain version: the spectral slice from its initial state; the grid slice
   from the state its 500-step loop ended in, and from a coherent
   two-stream state at which the fidelity guard must pass every solve, so
   that the loop applies a drive on both sides.

The last two lines of standard output are one JSON object per kernel
(launches in its path's run, error against the plain version, times) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SIM = dict(simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0,
           length=50.0, deposit_method="pallas")
MAX_MODE = 4
MPC = dict(horizon=6, w_terminal=4.0, n_candidates=384, plan_modes=8, spectral_drift="rot")
KINDS = ("cic", "tsc", "tsc_standard")
# the grid-planner slice (experiments/bot_bench_scale_debug.py:32-46) on the
# environment above; MPCConfig's defaults otherwise (H=10, kdk, exact cost
# energy, fidelity guard at ratio 3, cost_pe_nref 5000). Its plan model:
# stride 5000 // 1024 = 4, n_eff 1250 particles, 64 cells
GRID_MPC = dict(n_candidates=512, plan_particles=1024, plan_mesh=64, plan_model="grid")
GRID_PLAN = dict(n=1250, m=64, k=512, h=10)
LEAPFROG_STEPS = 20
# config-4's quality-gated controller of record (bench_scaling.py:222-227,
# 276-287), the environment step on the CIC kernels
CFG4_SIM = dict(simcase="two-stream", n_particles=100_000, n_mesh=256, dt=0.1,
                deposit_method="pallas")
CFG4_MAX_MODE = 8
CFG4_MPC = dict(horizon=10, n_candidates=384)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 30) -> float:
    """Median milliseconds per call over ``reps`` calls, CUDA events around
    each (wrapper and launch included), after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def find_card(torch) -> str:
    require(torch.cuda.is_available(), "no CUDA device: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    return card


def build_kernels() -> None:
    from plasma_control_tpu_torch.ops.kernels import _build

    path, seconds, output = _build.build()
    log(f"[build] {path.name}: nvcc {seconds:.1f} s")
    for line in output.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build]   {line.strip()}")
    _build.library()


def check_kernels(torch, rows: dict) -> None:
    """Phase 3: every kernel against its plain version on the card."""
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.config import SimConfig
    from plasma_control_tpu_torch.ops.kernels import cic
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(123)
    n, m, length = SIM["n_particles"], SIM["n_mesh"], SIM["length"]

    # deposit / gather: every kind, B = 1 and 4. Deposit sums ~20 weights per
    # cell in fp32 atomics of varying order: rtol 1e-5, atol 1e-4 (the JAX
    # package's Pallas bar); gather is a 4-tap sum: atol 1e-5.
    dep_err = gat_err = 0.0
    for b in (1, 4):
        x = torch.rand((b, n), generator=gen, device=dev) * length
        e = torch.randn((b, m), generator=gen, device=dev)
        for kind in KINDS:
            got, ref = cic.deposit_cic(x, m, length, kind), cic.deposit_cic_plain(x, m, length, kind)
            torch.cuda.synchronize()
            require(torch.allclose(got, ref, rtol=1e-5, atol=1e-4), f"deposit {kind} B={b}")
            charge = float(got.sum())
            require(abs(charge - n * b) <= 1e-5 * n * b, f"deposit {kind} B={b}: charge {charge}")
            dep_err = max(dep_err, float((got - ref).abs().max()))
            got, ref = cic.gather_cic(e, x, m, length, kind), cic.gather_cic_plain(e, x, m, length, kind)
            torch.cuda.synchronize()
            require(torch.allclose(got, ref, rtol=0.0, atol=1e-5), f"gather {kind} B={b}")
            gat_err = max(gat_err, float((got - ref).abs().max()))
    log(f"[kernels] deposit: 3 kinds x B in (1, 4), N={n}, M={m}: max |err| {dep_err:.3g} "
        f"(rtol 1e-5, atol 1e-4), charge conserved to 1e-5")
    log(f"[kernels] gather: 3 kinds x B in (1, 4): max |err| {gat_err:.3g} (atol 1e-5)")

    x1 = torch.rand((1, n), generator=gen, device=dev) * length
    e1 = torch.randn((1, m), generator=gen, device=dev)
    rows["deposit_cic"].update(
        max_abs_err=dep_err,
        ms=time_ms(torch, lambda: cic.deposit_cic(x1, m, length)),
        plain_ms=time_ms(torch, lambda: cic.deposit_cic_plain(x1, m, length)),
    )
    rows["gather_cic"].update(
        max_abs_err=gat_err,
        ms=time_ms(torch, lambda: cic.gather_cic(e1, x1, m, length)),
        plain_ms=time_ms(torch, lambda: cic.gather_cic_plain(e1, x1, m, length)),
    )

    # spectral horizon: rot and trig at K=384, H=6, Km=8 on a bump-on-tail
    # state. The kernel and the plain version reduce the mode sums in another
    # order: rtol 2e-4 (the JAX package's bar for the TPU kernel's variants).
    st = init_state(SimConfig(**SIM), gen, device=dev)
    k, h, km = MPC["n_candidates"], MPC["horizon"], MPC["plan_modes"]
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    kw = dict(length=length, dt=SIM["dt"], n0=1.0, n_particles=n)
    sh_err = 0.0
    for rot in (True, False):
        got = sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=rot, **kw)
        ref = sh.spectral_horizon_plain(st.x, st.v, u_c, u_s, rot=rot, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"spectral_horizon rot={rot}: non-finite PE")
        require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), f"spectral_horizon rot={rot}")
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        log(f"[kernels] spectral_horizon {'rot' if rot else 'trig'}: K={k}, H={h}, Km={km}, "
            f"N={n}: max |err| {float((got - ref).abs().max()):.3g}, max rel {rel:.3g} (rtol 2e-4)")
        sh_err = max(sh_err, float((got - ref).abs().max()))
        if not rot:
            trig_ms = time_ms(torch, lambda: sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=False, **kw))
            trig_plain = time_ms(torch, lambda: sh.spectral_horizon_plain(st.x, st.v, u_c, u_s,
                                                                         rot=False, **kw))
            log(f"[kernels] spectral_horizon trig: kernel {trig_ms:.4f} ms, plain {trig_plain:.4f} ms")
    rows["spectral_horizon"].update(
        max_abs_err=sh_err,
        ms=time_ms(torch, lambda: sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=True, **kw)),
        plain_ms=time_ms(torch, lambda: sh.spectral_horizon_plain(st.x, st.v, u_c, u_s, rot=True, **kw)),
    )
    for name in ("deposit_cic", "gather_cic", "spectral_horizon"):
        log(f"[kernels] {name}: kernel {rows[name]['ms']:.4f} ms, "
            f"plain {rows[name]['plain_ms']:.4f} ms per call")


def check_grid_kernels(torch, rows: dict) -> None:
    """Phase 3, second part: kernels 4-6 at the grid slice's plan model, and
    kernel 1 with its particle state in global memory."""
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(321)
    n, m, k, h = (GRID_PLAN[key] for key in ("n", "m", "k", "h"))
    length = SIM["length"]
    eop = make_grid(m, length, device=dev).e_op.T.contiguous()
    xb = torch.rand((k, n), generator=gen, device=dev) * length
    vb = torch.randn((k, n), generator=gen, device=dev)
    u = 0.05 * torch.randn((k, h, m), generator=gen, device=dev)
    kw = dict(n_mesh=m, length=length, dt=SIM["dt"])

    # kernel 4, B=K rows: x (as a periodic distance) and v to rtol 1e-5 /
    # atol 1e-4, the field energy to rtol 1e-4 (the experiments' bars for
    # the TPU kernel); the deposit's atomics and the in-kernel solve sum in
    # another order than the plain version
    err = 0.0
    for kind in KINDS:
        for exact in (True, False):
            got = fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, exact=exact, kind=kind, **kw)
            ref = fs.fused_leapfrog_step_plain(xb, vb, u[:, 0], eop, exact=exact, kind=kind, **kw)
            torch.cuda.synchronize()
            what = f"fused_leapfrog_step {kind} exact={exact}"
            dx = torch.remainder(got[0] - ref[0] + length / 2, length) - length / 2
            require(bool((dx.abs() <= 1e-4 + 1e-5 * ref[0].abs()).all()), f"{what}: x")
            require(torch.allclose(got[1], ref[1], rtol=1e-5, atol=1e-4), f"{what}: v")
            pe_got, pe_ref = ((e.double() ** 2).sum(-1) for e in (got[2], ref[2]))
            require(torch.allclose(pe_got, pe_ref, rtol=1e-4, atol=1e-9), f"{what}: field energy")
            err = max(err, float(dx.abs().max()), float((got[1] - ref[1]).abs().max()))
    log(f"[kernels] fused_leapfrog_step: 3 kinds x exact/kick-field, B={k}, N={n}, M={m}: "
        f"max |err| x, v {err:.3g} (rtol 1e-5, atol 1e-4; field energy rtol 1e-4)")
    rows["fused_leapfrog_step"].update(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, **kw)),
        plain_ms=time_ms(torch, lambda: fs.fused_leapfrog_step_plain(xb, vb, u[:, 0], eop, **kw)),
    )

    # kernels 5 and 6 from one shared state: per-step energies to rtol 2e-4
    # (the experiments' bar for the TPU kernels). The reference's shifted
    # "tsc" weight jumps at the cell offsets 0, 1 and 2: a particle within an
    # ulp of such an edge lands on either side from run to run (both
    # deposits sum in atomic order) and moves a weight of 0.375 into the
    # next cell, so for that kind at most 1 in 1000 energies may miss rtol
    # 2e-4, and none misses rtol 1e-2 (tests/test_torch_kernels.py)
    x0, v0 = xb[0].contiguous(), vb[0].contiguous()
    out = {}
    for name, plain in (("fused_kdk_horizon", fs.fused_kdk_horizon_plain),
                        ("fused_packed_horizon", fs.fused_packed_horizon_plain)):
        fn, err = getattr(fs, name), 0.0
        for kind in KINDS:
            got, ref = fn(x0, v0, u, eop, kind=kind, **kw), plain(x0, v0, u, eop, kind=kind, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"{name} {kind}: non-finite energies")
            miss = int(((got - ref).abs() > 1e-6 + 2e-4 * ref.abs()).sum())
            require(miss <= (got.numel() // 1000 if kind == "tsc" else 0),
                    f"{name} {kind}: {miss} energies beyond rtol 2e-4")
            require(torch.allclose(got, ref, rtol=1e-2, atol=1e-6), f"{name} {kind}")
            err = max(err, float((got - ref).abs().max()))
            out[name, kind] = got
        log(f"[kernels] {name}: 3 kinds, K={k}, H={h}, N={n}, M={m}: max |err| {err:.3g} "
            f"(rtol 2e-4)")
        rows[name].update(
            max_abs_err=err,
            ms=time_ms(torch, lambda: fn(x0, v0, u, eop, **kw)),
            plain_ms=time_ms(torch, lambda: plain(x0, v0, u, eop, **kw)),
        )
    # one contract: the merged kick reassociates the two half-kicks, held on
    # horizon sums to rtol 2e-4, as the experiments hold the TPU kernels
    rel = 0.0
    for kind in KINDS:
        a, b = out["fused_kdk_horizon", kind].sum(-1), out["fused_packed_horizon", kind].sum(-1)
        require(torch.allclose(b, a, rtol=2e-4, atol=1e-6), f"kernel 5 vs kernel 6, {kind}")
        rel = max(rel, float(((b - a).abs() / a.abs()).max()))
    log(f"[kernels] fused_kdk_horizon vs fused_packed_horizon: horizon sums max rel {rel:.3g} "
        f"(rtol 2e-4)")

    # kernel 1 beyond one CTA's shared memory: the state in a global scratch
    n1, k1, h1, km1 = 20_000, 64, 10, 16
    x1 = torch.rand(n1, generator=gen, device=dev) * length
    v1 = 1.5 * torch.randn(n1, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k1, h1, km1), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k1, h1, km1), generator=gen, device=dev)
    kw1 = dict(length=length, dt=SIM["dt"], n0=1.0, n_particles=n1)
    for rot in (True, False):
        require(not sh.state_in_shared(n1, rot), f"N={n1} should exceed shared memory")
        got = sh.spectral_horizon(x1, v1, u_c, u_s, rot=rot, **kw1)
        ref = sh.spectral_horizon_plain(x1, v1, u_c, u_s, rot=rot, **kw1)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"spectral_horizon N={n1} rot={rot}: non-finite")
        require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), f"spectral_horizon N={n1} rot={rot}")
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        ms = time_ms(torch, lambda: sh.spectral_horizon(x1, v1, u_c, u_s, rot=rot, **kw1))
        plain_ms = time_ms(torch, lambda: sh.spectral_horizon_plain(x1, v1, u_c, u_s, rot=rot, **kw1))
        log(f"[kernels] spectral_horizon {'rot' if rot else 'trig'}, state in global memory: "
            f"K={k1}, H={h1}, Km={km1}, N={n1}: max |err| {float((got - ref).abs().max()):.3g}, "
            f"max rel {rel:.3g} (rtol 2e-4); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for name in ("fused_leapfrog_step", "fused_kdk_horizon", "fused_packed_horizon"):
        log(f"[kernels] {name}: kernel {rows[name]['ms']:.4f} ms, "
            f"plain {rows[name]['plain_ms']:.4f} ms per call")


def _setup(torch, device, sim=SIM, max_mode=MAX_MODE, mpc=MPC):
    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.ops.grid import make_grid

    cfg, ctrl, mpc = SimConfig(**sim), ControlConfig(max_mode=max_mode), MPCConfig(**mpc)
    grid = make_grid(cfg.n_mesh, cfg.length, device=device)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=device)
    return cfg, ctrl, mpc, grid, act


def check_against_cpu(torch) -> None:
    """Phase 5: one candidate block and a three-step closed loop on the card against
    the same computation on the CPU, where every wrapper runs its plain
    version; same state, same noise."""
    import dataclasses

    from plasma_control_tpu_torch.control.mpc import candidate_costs, draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state

    runs = {}
    gen = torch.Generator().manual_seed(7)
    for device in ("cuda", "cpu"):
        cfg, ctrl, mpc, grid, act = _setup(torch, device)
        runs[device] = (cfg, ctrl, dataclasses.replace(mpc, plan_kernel="fused"), grid, act)
    cfg, ctrl, mpc = runs["cpu"][:3]
    st_cpu = init_state(cfg, gen)
    d = 2 * ctrl.max_mode
    cand = torch.clamp(0.3 * torch.randn((mpc.n_candidates, mpc.horizon, d), generator=gen), -1, 1)
    noise = torch.stack([draw_noise(gen, mpc, mpc.horizon, d) for _ in range(3)])
    out = {}
    for device, (cfg, ctrl, mpc, grid, act) in runs.items():
        st = PlasmaState(st_cpu.x.to(device), st_cpu.v.to(device))
        costs = candidate_costs(st, cand.to(device), grid, cfg, mpc, act)
        loop = mpc_rollout(st, grid, cfg, ctrl, mpc, act, step_noise=noise.to(device))
        out[device] = (costs.cpu(), loop.field_energy.cpu(), loop.coeffs.cpu())
    (c_gpu, pe_gpu, a_gpu), (c_cpu, pe_cpu, a_cpu) = out["cuda"], out["cpu"]
    require(torch.allclose(c_gpu, c_cpu, rtol=2e-4), "candidate costs: card vs CPU plain")
    # each solve's costs pass through MPPI's softmax (temperature 0.05): the
    # three-step loop is held to rtol 1e-2 on PE and atol 1e-2 on actions
    require(torch.allclose(pe_gpu, pe_cpu, rtol=1e-2), f"3-step PE: {pe_gpu} vs {pe_cpu}")
    require(torch.allclose(a_gpu, a_cpu, atol=1e-2), "3-step applied coefficients")
    log(f"[slice] card vs CPU plain: costs max rel "
        f"{float(((c_gpu - c_cpu).abs() / c_cpu.abs()).max()):.3g} (rtol 2e-4); 3-step PE "
        f"{pe_gpu.tolist()} vs {pe_cpu.tolist()} (rtol 1e-2); actions max |diff| "
        f"{float((a_gpu - a_cpu).abs().max()):.3g} (atol 1e-2)")


def _counts(fns: dict) -> dict:
    return {name: fn.launches for name, fn in fns.items()}


def _kernel_fns() -> dict:
    from plasma_control_tpu_torch.ops.kernels import cic
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    return {"deposit_cic": cic.deposit_cic, "gather_cic": cic.gather_cic,
            "spectral_horizon": sh.spectral_horizon,
            "fused_leapfrog_step": fs.fused_leapfrog_step,
            "fused_kdk_horizon": fs.fused_kdk_horizon,
            "fused_packed_horizon": fs.fused_packed_horizon}


def _reset(fns: dict) -> None:
    for fn in fns.values():
        fn.launches = 0


def run_slice(torch, rows: dict) -> None:
    """Phase 4a: the full 500-step control loop and the uncontrolled push."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout
    from plasma_control_tpu_torch.ops.kernels import cic
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plan_gen = torch.Generator(device=dev).manual_seed(1)
    steps = cfg.n_steps
    # warm-up: cuBLAS/cuFFT handles and plans, allocator pools
    mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev), n_steps=3)

    counters = {"deposit_cic": cic.deposit_cic, "gather_cic": cic.gather_cic,
                "spectral_horizon": sh.spectral_horizon}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, plan_gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, fn in counters.items():
        rows[name]["launches"] = fn.launches

    t1 = time.perf_counter()
    base = rollout(state, grid, cfg)
    torch.cuda.synchronize()
    wall_base = time.perf_counter() - t1

    launches = {name: rows[name]["launches"] for name in counters}
    log(f"[slice] {steps} control steps; kernel launches in the controlled run: {launches}")
    require(launches["spectral_horizon"] == steps, "one spectral_horizon launch per solve")
    require(launches["gather_cic"] == 3 * steps, "three gathers per Yoshida-4 step")
    require(launches["deposit_cic"] >= 5 * steps, "five deposits per control step")
    require(out.field_energy.shape == (steps,) and base.field_energy.shape == (steps + 1,),
            "trace shapes")
    for name, t in (("controlled PE", out.field_energy), ("uncontrolled PE", base.field_energy),
                    ("applied coefficients", out.coeffs), ("plan cost", out.plan_cost)):
        require(bool(torch.isfinite(t).all()), f"{name} not finite")
    tail = float(out.field_energy[-20:].mean())
    tail_base = float(base.field_energy[-20:].mean())
    log(f"[slice] tail PE (mean of last 20 steps): controlled {tail:.6g}, uncontrolled {tail_base:.6g}")
    log(f"[slice] controlled loop: {wall:.3f} s wall, {1e3 * wall / steps:.4f} ms per control step, "
        f"{steps / wall:.2f} control steps/s; uncontrolled push {1e3 * wall_base / steps:.4f} ms/step")


def run_grid_slice(torch, rows: dict):
    """Phase 4b: the grid-planner slice for all 500 control steps, and the
    uncontrolled push from the same state. Returns the final state."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, mpc=GRID_MPC)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plan_gen = torch.Generator(device=dev).manual_seed(2)
    steps = cfg.n_steps
    mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev), n_steps=3)

    fns = _kernel_fns()
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, plan_gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fns)
    rows["fused_packed_horizon"]["launches"] = launches["fused_packed_horizon"]
    log(f"[grid] {steps} control steps; kernel launches in the controlled run: {launches}")
    require(launches["fused_packed_horizon"] == steps, "one fused_packed_horizon launch per solve")
    require(launches["spectral_horizon"] == launches["fused_leapfrog_step"]
            == launches["fused_kdk_horizon"] == 0, "no other planner kernel")
    require(launches["gather_cic"] == 3 * steps, "three gathers per Yoshida-4 step")
    require(launches["deposit_cic"] >= 5 * steps, "five deposits per control step")

    t1 = time.perf_counter()
    base = rollout(state, grid, cfg)
    torch.cuda.synchronize()
    wall_base = time.perf_counter() - t1
    require(out.field_energy.shape == (steps,) and base.field_energy.shape == (steps + 1,),
            "trace shapes")
    for name, t in (("controlled PE", out.field_energy), ("uncontrolled PE", base.field_energy),
                    ("applied coefficients", out.coeffs), ("plan cost", out.plan_cost)):
        require(bool(torch.isfinite(t).all()), f"{name} not finite")
    passed = int((out.coeffs != 0).any(-1).sum())
    tail = float(out.field_energy[-20:].mean())
    tail_base = float(base.field_energy[-20:].mean())
    log(f"[grid] fidelity guard let {passed} of {steps} solves through (the others applied "
        f"no drive)")
    log(f"[grid] tail PE (mean of last 20 steps): controlled {tail:.6g}, uncontrolled {tail_base:.6g}")
    log(f"[grid] controlled loop: {wall:.3f} s wall, {1e3 * wall / steps:.4f} ms per control step, "
        f"{steps / wall:.2f} control steps/s; uncontrolled push {1e3 * wall_base / steps:.4f} ms/step")
    return out.final_state


def run_leapfrog_loop(torch, rows: dict) -> None:
    """Phase 4c: the grid slice with plan_integrator="leapfrog", 20 steps."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, mpc=dict(GRID_MPC, plan_integrator="leapfrog"))
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    fns = _kernel_fns()
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev).manual_seed(3),
                      n_steps=LEAPFROG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fns)
    rows["fused_leapfrog_step"]["launches"] = launches["fused_leapfrog_step"]
    log(f"[leapfrog] {LEAPFROG_STEPS} control steps; kernel launches: {launches}")
    require(launches["fused_leapfrog_step"] == LEAPFROG_STEPS * mpc.horizon,
            "H fused_leapfrog_step launches per solve")
    require(launches["fused_packed_horizon"] == 0, "no merged-kick horizon in the leapfrog loop")
    for name, t in (("PE", out.field_energy), ("plan cost", out.plan_cost)):
        require(bool(torch.isfinite(t).all()), f"leapfrog loop {name} not finite")
    log(f"[leapfrog] {1e3 * wall / LEAPFROG_STEPS:.4f} ms per control step (first steps of the "
        f"episode, no warm-up)")


def run_kdk_horizon(torch, rows: dict, state) -> None:
    """Phase 4d: kernel 5 scores ten of the grid slice's candidate blocks at
    ``state``, each beside kernel 6 (same contract): horizon costs to rtol
    2e-4, as experiments/test_pallas_fused_step.py holds the TPU kernels."""
    from plasma_control_tpu_torch.control.mpc import _actuator_cache, _plan_model, draw_noise
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, _ = _setup(torch, dev, mpc=GRID_MPC)
    pst, pgrid, pcfg = _plan_model(state, grid, cfg, mpc)
    pact = _actuator_cache(pcfg.length, pgrid.n_mesh, ctrl.max_mode, torch.float32, dev)
    eop = pgrid.e_op.T.contiguous()
    kw = dict(n_mesh=pgrid.n_mesh, length=pcfg.length, dt=pcfg.clamped_dt(), n0=pcfg.n0,
              kind=pcfg.interpol)
    gen = torch.Generator(device=dev).manual_seed(5)
    fns = _kernel_fns()
    _reset(fns)
    rel = 0.0
    for _ in range(10):
        cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, mpc.horizon, 2 * ctrl.max_mode,
                                                   device=dev), ctrl.coeff_min, ctrl.coeff_max)
        e_seq = pact.compute_e_packed(cand)
        a = fs.fused_kdk_horizon(pst.x, pst.v, e_seq, eop, **kw).sum(-1)
        b = fs.fused_packed_horizon(pst.x, pst.v, e_seq, eop, **kw).sum(-1)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(a).all()), "kernel 5: non-finite energies")
        require(torch.allclose(b, a, rtol=2e-4, atol=1e-6), "kernel 5 vs kernel 6 on the slice")
        rel = max(rel, float(((b - a).abs() / a.abs()).max()))
    rows["fused_kdk_horizon"]["launches"] = fns["fused_kdk_horizon"].launches
    require(rows["fused_kdk_horizon"]["launches"] == 10, "ten fused_kdk_horizon launches")
    log(f"[kdk] fused_kdk_horizon on 10 candidate blocks of the grid slice (n_eff={pcfg.n_particles}, "
        f"plan mesh {pgrid.n_mesh}) beside fused_packed_horizon: horizon sums max rel {rel:.3g} "
        f"(rtol 2e-4)")


def run_config4(torch) -> None:
    """Phase 4e: three control steps of config-4's full-fidelity controller,
    then kernel 1 against its plain version at that path's shapes."""
    from plasma_control_tpu_torch.control.mpc import _pad_modes, draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE,
                                       mpc=CFG4_MPC)
    rot = sh.use_rot(cfg.clamped_dt(), cfg.length, mpc.spectral_drift)
    require(not sh.state_in_shared(cfg.n_particles, rot), "config-4 state should need global memory")
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    fns = _kernel_fns()
    _reset(fns)
    mean, times, pes = None, [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, gen, n_steps=1, mean0=mean)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        state, mean = out.final_state, out.final_mean
        pes.append(float(out.field_energy[0]))
    launches = _counts(fns)
    log(f"[config-4] 3 control steps at N={cfg.n_particles}, M={cfg.n_mesh}, K={mpc.n_candidates}, "
        f"H={mpc.horizon}, Km={max(mpc.plan_modes, ctrl.max_mode)}, {'rot' if rot else 'trig'} "
        f"drift; launches {launches}")
    require(launches["spectral_horizon"] == 3, "one spectral_horizon launch per solve")
    require(all(math.isfinite(pe) for pe in pes), "config-4 PE not finite")
    log(f"[config-4] ms per control step: {', '.join(f'{t:.4f}' for t in times)} "
        f"(the first includes one-time set-up); PE {pes}")

    # kernel 1 at this path's own shapes, on the state the three steps ended
    # in and one solve's clipped knot-noise candidates, padded to Km modes as
    # candidate_costs pads them: against its plain version to rtol 2e-4
    ka = ctrl.max_mode
    km = max(int(mpc.plan_modes), ka)
    cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, mpc.horizon, 2 * ka, device=dev),
                       ctrl.coeff_min, ctrl.coeff_max)
    u_c, u_s = _pad_modes(cand[..., :ka], km), _pad_modes(cand[..., ka:], km)
    kw = dict(length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
              rot=rot)
    got = sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw)
    ref = sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "config-4 spectral_horizon: non-finite PE")
    require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), "config-4 spectral_horizon vs plain")
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    ms = time_ms(torch, lambda: sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw), reps=10)
    plain_ms = time_ms(torch, lambda: sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw),
                       reps=3)
    log(f"[config-4] spectral_horizon at the path's shapes (K={u_c.shape[0]}, H={u_c.shape[1]}, "
        f"Km={km}, N={cfg.n_particles}, state in global memory): max |err| "
        f"{float((got - ref).abs().max()):.3g}, max rel {rel:.3g} (rtol 2e-4); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


def coherent_state(torch, n: int, length: float, seed: int, amplitude: float = 0.5):
    """Two counter-streaming beams (v = N(0, 1) +- 3) with a mode-1 density
    modulation of the given amplitude, made on the CPU from ``seed``: the
    state of ``tests/test_torch_grid_plan.py``'s guard-passing cases, at
    which subsampled planning is safe."""
    from plasma_control_tpu_torch.models.pic import PlasmaState

    gen = torch.Generator().manual_seed(seed)
    x0 = torch.rand(n, generator=gen, dtype=torch.float64) * length
    k1 = 2.0 * math.pi / length
    x = torch.remainder((x0 + (amplitude / k1) * torch.sin(k1 * x0)).float(), length)
    beams = torch.where(torch.arange(n) % 2 == 0, 3.0, -3.0).double()
    v = (torch.randn(n, generator=gen, dtype=torch.float64) + beams).float()
    return PlasmaState(x, v)


def check_grid_against_cpu(torch, state) -> None:
    """Phase 5, second part: one grid candidate block (on the plan model) and
    a three-step grid loop on the card against the same computation on the
    CPU; same state, same candidates, same noise. Twice: from ``state``,
    where the fidelity guard has zeroed every solve so far, and from a
    coherent two-stream state at the slice's width, where the guard must pass
    every solve, so that the loop drives the plasma."""
    from plasma_control_tpu_torch.control.mpc import (
        _actuator_cache, _plan_model, candidate_costs, draw_noise, mpc_rollout,
        plan_fidelity_check,
    )
    from plasma_control_tpu_torch.models.pic import PlasmaState

    runs = {device: _setup(torch, device, mpc=GRID_MPC) for device in ("cuda", "cpu")}
    cfg, ctrl, mpc = runs["cpu"][:3]
    coherent = coherent_state(torch, cfg.n_particles, cfg.length, seed=10)
    ratio = plan_fidelity_check(coherent, cfg, ctrl, mpc)["ratio"]
    require(ratio >= mpc.fidelity_guard_ratio, f"coherent state: fidelity ratio {ratio}")
    starts = (("the end state of the 500-step loop", PlasmaState(state.x.cpu(), state.v.cpu()),
               False),
              (f"a coherent two-stream state (fidelity ratio {ratio:.4g})", coherent, True))
    gen = torch.Generator().manual_seed(9)
    d = 2 * ctrl.max_mode
    for where, start, drives in starts:
        cand = torch.clamp(0.3 * torch.randn((mpc.n_candidates, mpc.horizon, d), generator=gen),
                           -1, 1)
        noise = torch.stack([draw_noise(gen, mpc, mpc.horizon, d) for _ in range(3)])
        out = {}
        for device, (cfg, ctrl, mpc, grid, act) in runs.items():
            st = PlasmaState(start.x.to(device), start.v.to(device))
            pst, pgrid, pcfg = _plan_model(st, grid, cfg, mpc)
            pact = _actuator_cache(pcfg.length, pgrid.n_mesh, ctrl.max_mode, torch.float32, device)
            costs = candidate_costs(pst, cand.to(device), pgrid, pcfg, mpc, pact)
            loop = mpc_rollout(st, grid, cfg, ctrl, mpc, act, step_noise=noise.to(device))
            out[device] = (costs.cpu(), loop.field_energy.cpu(), loop.coeffs.cpu())
        (c_gpu, pe_gpu, a_gpu), (c_cpu, pe_cpu, a_cpu) = out["cuda"], out["cpu"]
        require(torch.allclose(c_gpu, c_cpu, rtol=2e-4), f"grid candidate costs at {where}")
        zeroed = (a_gpu == 0).all(-1)
        require(torch.equal(zeroed, (a_cpu == 0).all(-1)), "the guard zeroes the same solves")
        require(not (drives and bool(zeroed.any())),
                f"guard at {where}: {int((~zeroed).sum())} of 3 solves passed")
        # each solve's costs pass through MPPI's softmax (temperature 0.05): the
        # three-step loop is held to rtol 1e-2 on PE and atol 1e-2 on actions
        require(torch.allclose(pe_gpu, pe_cpu, rtol=1e-2), f"grid 3-step PE: {pe_gpu} vs {pe_cpu}")
        require(torch.allclose(a_gpu, a_cpu, atol=1e-2), f"grid 3-step actions at {where}")
        log(f"[grid] card vs CPU plain at {where}: costs max rel "
            f"{float(((c_gpu - c_cpu).abs() / c_cpu.abs()).max()):.3g} (rtol 2e-4); 3-step PE "
            f"{pe_gpu.tolist()} vs {pe_cpu.tolist()} (rtol 1e-2); actions max |a| "
            f"{float(a_gpu.abs().max()):.3g}, max |diff| {float((a_gpu - a_cpu).abs().max()):.3g} "
            f"(atol 1e-2); guard passed {int((~zeroed).sum())} of 3 solves on both")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    card = find_card(torch)
    build_kernels()
    rows = {
        "deposit_cic": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                            replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:91"),
        "gather_cic": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                           replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:122"),
        "spectral_horizon": dict(source="plasma_control_tpu_torch/csrc/spectral_horizon.cu",
                                 replaces="plasma_control_tpu/ops/pallas/spectral_horizon.py:303"),
        "fused_leapfrog_step": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                    replaces="experiments/pallas_fused_step.py:165"),
        "fused_kdk_horizon": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                  replaces="experiments/pallas_fused_step.py:301"),
        "fused_packed_horizon": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                     replaces="experiments/pallas_fused_step.py:452"),
    }
    check_kernels(torch, rows)
    check_grid_kernels(torch, rows)
    run_slice(torch, rows)
    end_state = run_grid_slice(torch, rows)
    run_leapfrog_loop(torch, rows)
    run_kdk_horizon(torch, rows, end_state)
    run_config4(torch)
    check_against_cpu(torch)
    check_grid_against_cpu(torch, end_state)
    log(f"[total] {time.perf_counter() - t_start:.1f} s wall, build included")

    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in rows.items()
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
