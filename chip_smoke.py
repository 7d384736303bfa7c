#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU (sm_90a), the
CUDA toolkit (nvcc) and PyTorch built for CUDA. It imports only
``plasma_control_tpu_torch``, never jax, and works through these phases;
any failure exits non-zero:

1. find the card (no CPU fallback) and print its name and power limit as
   nvidia-smi reports them;
2. build the CUDA kernels from ``plasma_control_tpu_torch/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card at the
   control loop's shapes, with the tolerance printed, and time both (CUDA
   events, median of 30 calls);
4. run the control loop: the repo's headline MPC configuration (bump-on-tail,
   N=5000, M=250, max_mode 4, K=384, H=6, Km=8, rot drift, CIC kernels for
   the environment step) for all 500 control steps after a three-step
   warm-up, plus the uncontrolled rollout from the same seeded state; the
   kernels' launch counts during the controlled run prove that it went
   through them;
5. check one candidate block and a three-step closed loop on the card
   against the same computation on the CPU, where every wrapper runs its
   plain version.

The last two lines of standard output are one JSON object per kernel
(launches in the control loop, error against the plain version, times)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SIM = dict(simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0,
           length=50.0, deposit_method="pallas")
MAX_MODE = 4
MPC = dict(horizon=6, w_terminal=4.0, n_candidates=384, plan_modes=8, spectral_drift="rot")
KINDS = ("cic", "tsc", "tsc_standard")


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
    for name, row in rows.items():
        log(f"[kernels] {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms per call")


def _setup(torch, device):
    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.ops.grid import make_grid

    cfg, ctrl, mpc = SimConfig(**SIM), ControlConfig(max_mode=MAX_MODE), MPCConfig(**MPC)
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


def run_slice(torch, rows: dict) -> None:
    """Phase 4: the full 500-step control loop and the uncontrolled push."""
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

    launches = {name: rows[name]["launches"] for name in rows}
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
    }
    check_kernels(torch, rows)
    run_slice(torch, rows)
    check_against_cpu(torch)
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
