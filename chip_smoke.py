#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --guard [PARENT_DIR]   # the [guard] section alone
    python3 chip_smoke.py --grid-fullfid         # the [grid-fullfid] section alone

Run from the root of a checkout on a machine with a Hopper GPU (sm_90a), the
CUDA toolkit (nvcc) and PyTorch built for CUDA. It imports only
``plasma_control_tpu_torch`` (and, for ``[guard]``'s steps/s and
``[grid-fullfid]``'s cell, the benchmark harness in ``benchmark/``, which
imports nothing else), never jax, and works
through these phases;
any failure exits non-zero:

1. find the card (no CPU fallback) and print its name and power limit as
   nvidia-smi reports them;
2. build the CUDA kernels from ``plasma_control_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, with the tolerance printed, and time both (CUDA
   events, median of 30 calls, wrapper included) and the kernel alone (its
   device time per launch in a profiler trace, and the device ops per
   call): the spectral slice's kernels 1-3, the gather also on positions
   outside [0, L) and on one (M,) field for every row, the deposit on
   positions in [-L, 2L) with the normalisation applied in the kernel, two
   of its launches bitwise equal and ``deposit(method="pallas")`` one device
   op per call, at N=5000, M=250 and at the twin slice's environment
   (N=100000, M=256, also bitwise the same at every cluster size); the grid
   planner's kernels 4-6 at its plan model (K=512, H=10, N=1250, M=64), two
   launches of kernels 5-6 bitwise equal for each kind, kernel 5 against
   kernel 6 (one contract); kernel 1 at N=20000 (K=64, H=10, Km=16,
   clusters of 4 CTAs for rot, 8 for trig); kernel 1's twin-corrected
   variant at the twin slice's plan model (K=1024, H=10, Km=16, N=10000)
   with both drifts, at
   N=20000, and the trig drift's zero-drive identity against the twin
   trajectory; kernel 7, the twin-corrected solve's targets, at the twin
   slice's shapes (N=100000, a stride-10 plan subsample, H=10, Km=16)
   against its plain version in float32 and float64, one device op per
   call and bitwise equal over two launches; kernel 1's global-scratch
   variant, both energies and drifts,
   at N=320000, beyond what a cluster of 16 CTAs holds; ``[guard]``: kernel
   8, the fidelity guard's statistic, at the twin slice's full state
   (N=100000, Km=16) and the grid slice's (N=5000, Km=16) against its plain
   version in float32 and float64, bitwise equal over two launches, one
   device op per call, its CUDA-event and device time beside its bound and
   the plain version's time and device ops; then the twin and grid graph
   cells' control steps/s (``benchmark/``'s program, 2000 replayed steps
   after the capture, each run in a fresh process), and with ``--guard
   PARENT_DIR`` the same for the checkout at PARENT_DIR in turns (parent,
   this, this, parent); two launches of
   kernel 1 bitwise equal; the gather beside ``grid_sample``, the one
   PyTorch call that computes it; kernel 1 and its corrected variant beyond
   16 modes (Km=32 over 16 drive modes, both drifts) in shared memory
   (N=20000) and in the global scratch (N=1M, the million-particle solve's
   chunk); kernels 4-6 beyond 3631 cells (M=4096, mesh arrays in a global
   scratch, every kind) and the grid planner's costs on a 4096-cell plan
   model (``[mesh]``, counted); kernel 3 at N=100000 and N=1M against its
   plain version, bitwise equal to its one-particle-per-thread reading, in
   turns with ``grid_sample``; kernels 2 and 3 at the damping row's
   environment (N=10000, M=128);
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
      max_mode 8, K=384, H=10, Km=16), kernel 1 on clusters of 16 CTAs;
      then kernel 1 against its plain version at those shapes;
   f. the twin slice, config-4's twin-corrected subsampled controller
      (``bench_scaling.py:222-227,268-269``: the config-4 environment,
      K=1024, H=10, a stride-10 plan subsample of 10000 particles, 64 plan
      cells, Km=16, ``plan_correction="twin"``, fidelity guard on), all 500
      control steps: one launch of kernel 1's corrected variant per solve;
      plus the uncontrolled rollout from the same seeded state;
   g. the port's entry point, ``plasma_control_tpu_torch.run_mpc.main`` with
      the twin slice's flags, ``--t_max 5`` and the CLI's dense deposit: 50
      control steps, the replay, the cost traces and the saved run;
   h. three control steps of the repo's million-particle 32-mode controller
      (``experiments/million_r5.py:51-53,118-121``, unreduced: two-stream,
      N=1M, M=256, scatter deposit, 16 actuated modes at +-2, K=384 in
      chunks of 16, H=10, Km=32), 24 launches of kernel 1's blocked variant
      per solve, its state in the global scratch (one pass over it per
      step); then that launch against its plain version, one chunk's
      costs on the card against the CPU, and a three-step uncontrolled push
      of its state on kernels 2-3;
      ``[grid-fullfid]``: the full-fidelity grid planner's benchmark cell
      (bump-on-tail, N=100000, M=256, K=512, H=10, kdk on the whole
      plasma): kernel 6 with its state in the (K, 2N) global scratch and the
      operator read from L2, against its plain version on horizon sums,
      timed beside its bound; three captured control steps of the cell's
      controller, one launch of kernel 6 a replay, its scratch counter;
   i. three control steps of the twin slice at ``plan_modes=32``: kernel
      1c beyond 16 modes, one launch per solve;
   j. ``feedback_rollout`` at config-4's environment (N=100000, M=256,
      max_mode 8, CIC kernels), all 500 steps from the twin slice's seeded
      state, the card synchronised after each step: 2500 launches of kernel
      2 and 1500 of kernel 3; tail PE beside the uncontrolled rollout's;
   k. ``bench_scaling.py:96-131``'s controller-damping row at its full
      shapes (bump-on-tail, N=10000, M=128, 300 steps, max_mode 3; MPC
      K=384, H=6, Km=8, w_terminal 4): uncontrolled, feedback and MPC from
      the reference's own state (the JAX package's, handed across), 300
      launches of kernel 1 for MPC; the uncontrolled and feedback tail PE
      within 1 % of SCALING_r05.json's, the MPC tail beside its; decay-phase
      gamma and time to stay below 2x the MPC floor reported;
   l. ``rollout_batch`` of 8 config-4 states for 20 steps: one launch of
      kernel 2 or 3 per batched deposit or gather (81 and 60), each row
      within 1e-5 relative PE of its single rollout;
   m. the reference DDPG controller's two-stream run
      (``tests/data/ddpg_golden_two_stream.npz``) replayed through
      ``rollout`` on kernels 2-3: PE(0) within 1e-5, 499 steps within 1 %;
   n. ``main()`` of the port's ``run_wo_oc``, ``run_feedback`` and
      ``run_lqr`` at their CLI defaults (N=5000, M=250, 500 steps, dense
      deposit) with ``--is_save``: a data.npz with finite PE each;
   o. the three committed DAgger actors (``artifacts/dagger_actor_*``, read
      by the port's msgpack reader) closed-loop at tests/test_rl.py's
      TestLearnedSuppression configurations on kernels 2-3 (4 deposits and
      3 gathers per step), held to that test's tail-PE gates; ms per step
      and the actor's forward time;
   p. ``dagger_train`` with the MPC expert at run_dagger.py's CLI width
      (N=5000, M=250, K=512, H=10, Km=16), 2 iterations of 100 epochs: one
      launch of kernel 1 per expert solve (1500); then kernel 1 at those
      shapes against its plain version, ms per solve and per BC epoch;
   q. two episodes each of the DDPG, PPO and SAC trainers at their run
      scripts' widths (DDPG with its 100000-transition replay buffer on the
      card), kernels 2-3 in every env step; ms per env step and per update,
      the buffer's bytes and the peak allocation;
   r. ``plan`` with five gradient-refinement steps at the spectral slice's
      shapes (dense deposit, which autograd differentiates): one launch of
      kernel 1 per solve, ms per solve; the refinement on the card against
      the CPU from one nominal, within 1e-4;
   s. ``main()`` of ``run_dagger`` (the committed actor; and ``--optimize``
      cut to one iteration), ``run_ddpg``, ``run_ppo`` and ``run_sac``
      (``--optimize``, one episode) at their CLI defaults: data written;
   t. ``[resume]``: ``main()`` of ``run_wo_oc`` and ``run_feedback`` at
      config-4's environment (40 steps) and of ``run_mpc`` with the twin
      flags (20 steps) with ``--checkpoint_every`` at half the run, each
      uninterrupted and then cut at half and resumed: final checkpoints,
      resumed traces and launches per step asserted bitwise / exact; ms per
      checkpoint save and restore;
   u. ``[resume-train]``: DDPG, PPO and SAC at ``[rl-train]``'s widths, one
      episode with a checkpoint, resumed to two, against two uninterrupted
      episodes run twice: the resumed run at least as close to the
      uninterrupted one as the two repeats are to each other, and the
      offline stage skipped; the checkpoint's bytes, save and restore ms;
   v. ``[aot]``: the control step captured as one CUDA graph
      (``io/aot.py``) at the spectral, grid and twin slices: 20 replays
      bitwise equal to 20 eager steps, the noise advancing between replays,
      the device ops of a replay against the eager body's; ms per control
      step eager against replay (synchronised, 100 steps), device busy per
      replay, capture time, graph memory;
   w. ``[aot-cold]``: ``run_mpc --save_aot`` writes the portable and the
      compiled artifact at the spectral slice's flags; a fresh
      ``python -m plasma_control_tpu_torch.run_mpc --aot`` from a copy of the
      package with an empty build directory runs each (the portable one
      builds the kernels, the compiled one, run with no nvcc to be found,
      installs its library), both equal to the eager run bitwise; wall
      times; a stale artifact refused;
5. check one candidate block and a three-step closed loop on the card
   against the same computation on the CPU, where every wrapper runs its
   plain version: the spectral slice from its initial state; the grid slice
   from the state its 500-step loop ended in, and from a coherent
   two-stream state at which the fidelity guard must pass every solve, so
   that the loop applies a drive on both sides; the twin slice with one
   corrected candidate block of 128 and a three-step loop at K=64 with the
   guard off (``experiments/config4_frontier.py:92-95``), so that the
   corrected costs drive on both sides; a 3-step feedback and a 3-step
   LQR loop (one seeded gain) at config-4's environment on kernels 2-3;
   20 steps of the committed two-stream actor (PE within 1e-5 relative);
6. launch kernel 1 at the million path's chunk (its state in the global
   scratch) and kernel 4 at the grid slice's plan model (every kind, exact
   or not) twice each and require bitwise equal results; then run the
   spectral, the grid and the twin slice and the feedback loop twice for
   20 steps from one seed and report whether the two runs end in bitwise
   the same state;
7. the sharded paths, the plots and the NaN checks, each with the launch
   counts set to 0 before it and read after:
   a. ``[parallel]`` in this process, a one-rank NCCL group: config-4's
      full-fidelity solve (N=100000, M=256, max_mode 8, K=384, H=10, Km=16)
      through ``make_sharded_plan`` bitwise ``plan`` on the same draws (one
      launch of kernel 1, one deposit), three steps of
      ``make_sharded_mpc_rollout`` bitwise ``mpc_rollout`` (1 / 5 / 3
      launches of kernels 1 / 2 / 3 per step); the group destroyed after;
   b. ``[parallel]`` in two ranks of this script on one card in a gloo group
      (``--parallel-rank``; they load the library built here): config-4's
      solve at K=768 (384 per rank) and one grid-slice solve (K=512, kernel
      6) against the one-rank solve, five twin-slice steps (K=1024, 512 per
      rank, guard on, from a coherent state where the guard lets the solves
      through) with the ranks' final states compared bitwise, and config-5's
      particle-sharded push (``bench_scaling.py:481-498``: N=1M, M=256,
      500000 per rank on kernels 2-3) against the one-rank step, one step
      at atol 1e-4 and 20 with the field energies and charge; then
      ``dryrun_multichip(2)``. Per-rank launch counts; ms per solve and per
      step, which time collectives on one card, not multi-GPU scaling;
   c. ``[viz]``: ``_e_mesh_series`` and ``_spectrum`` of a config-4 snapshot
      (50 steps, 51 columns) on the card, one deposit launch per call,
      against the CPU's dense version (atol 1e-4); ``run_and_save`` writes
      the data and says whether it drew the plots (no matplotlib there);
   d. ``[debug]``: ``nan_checks()`` raises on a torch operation's NaN on the
      card and on a NaN position fed to the deposit kernel, and
      ``GraphedStep`` refuses to capture while it is on;
   e. ``[twin-tail]``: the twin slice's seeded state rolled 500 steps
      uncontrolled through kernels 2-3 and through the scatter deposit, the
      two last-20 tails side by side (fp32-chaos bound 1 %);
8. the reference's baseline, quality and rates:
   a. ``[native]``: the port's loader builds ``native/pic_ref.cpp`` with g++
      into ``build/plasma_control_tpu_torch/``; the C++ step and a 20-step
      rollout at the baseline's shape (N=5000, M=250) against the port's
      float64 step on the CPU; the C++ steps/s;
   b. ``[quality]``: config-4 (N=100000, M=256, max_mode 8, 500 steps) from
      the reference's 8 initial states (the JAX package's, handed across):
      uncontrolled, each seed's tail PE within 1 % of
      ``artifacts/results_r5/config4_frontier.json``'s; ``fullfid_K384``
      (kernel 1) and ``sub10000_K1024_corr_guarded`` (the twin slice, kernel
      1c) through the captured control step, 8 seeds each, held to the
      artifact's 8 as distributions (ratio of the means in [2/3, 3/2],
      Mann-Whitney p >= 0.01); every per-seed number printed;
   c. ``[timing]``: ``utils/timing.py::mpc_solve_rate`` of the spectral,
      grid and twin slices and ``fullfid_K384`` at a t=15 state, beside ms
      per control step eager and replayed.
9. ``[surface]``, the package's library-use path through its top-level names
   (``plasma_control_tpu_torch``'s ``__all__``, the JAX package's), each with
   the launch counts set to 0 before it and read after:
   a. the README's library-use example at its own widths (two-stream,
      N=10000, M=128): ``rollout`` over ``cfg.n_steps`` as written (the dense
      deposit, no CIC launch), ``mpc_rollout`` (max_mode 3, K=512, H=10,
      ``plan_particles`` 2048, ``plan_mesh`` 64) for 20 steps, one launch of
      kernel 1 per solve, and the same ``rollout`` with
      ``deposit_method="pallas"``: 4T+1 deposits and 3T gathers, its PE
      trace within 1 % of the dense one's at every step (the fp32-chaos
      bound of ``tests/test_golden.py:137-146``);
   b. ``PIC(preset(name, deposit_method="pallas"))`` for each of the eight
      presets at its full width (``bench-host`` is config 4,
      ``bench-multihost`` config 5, N=1M): three steps, each with its
      electric and total energy, 5 deposits and 3 gathers per step, finite;
   c. ``initialize_distributed(address, 1, 0)`` with no device type: a
      one-rank NCCL group, destroyed after;
   its wall time beside the card's name and power limit.

The last two lines of standard output are one JSON object per kernel
(launches in its path's run, error against the plain version, times, the
card's least time for the same work and what sets it, the library call's
time where one computes the same function) and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
# config-4's twin-corrected subsampled controller, the round-5 quality point
# (bench_scaling.py:222-227,268-269), on the config-4 environment above;
# MPCConfig's defaults otherwise (Km=16, auto = rot drift, knot-3 antithetic
# MPPI with the feedback seed, cost_pe_nref 5000, fidelity guard on). Its
# plan model: stride 100000 // 10000 = 10, 10000 particles, 64 cells
TWIN_MPC = dict(horizon=10, n_candidates=1024, plan_particles=10000, plan_mesh=64,
                plan_correction="twin")
TWIN_FLAGS = ["--simcase", "two-stream", "--num_particle", "100000", "--num_mesh", "256",
              "--max_mode", "8", "--n_candidates", "1024", "--plan_particles", "10000",
              "--plan_mesh", "64", "--plan_correction", "twin"]
ENTRY_STEPS = 50  # --t_max 5 at dt 0.1
# bench_scaling.py:96-131's "2-controller-damping" row at its full shapes:
# uncontrolled, feedback and MPC from one seeded bump-on-tail state
DAMPING_SIM = dict(simcase="bump-on-tail", n_particles=10_000, n_mesh=128, dt=0.1, t_max=30.0,
                   deposit_method="pallas")
DAMPING_MAX_MODE = 3
DAMPING_MPC = dict(horizon=6, w_terminal=4.0, n_candidates=384, plan_modes=8)
BATCH, BATCH_STEPS = 8, 20
GOLDEN_CASE = "two_stream"  # tests/data/ddpg_golden_two_stream.npz, 499 replay steps
ENTRY_SCRIPTS = (("wo-oc", "run_wo_oc", "wo-oc"), ("feedback", "run_feedback", "feedback"),
                 ("lqr", "run_lqr", "lqr-control"))
# the repo's million-particle 32-mode controller, unreduced
# (experiments/million_r5.py:51-53, 118-121, fullfid_K384_wt4_wraw05_cm2_mm16):
# two-stream, N=1M, M=256, scatter deposit; 16 actuated modes at +-2; K=384
# in chunks of 16, H=10, Km=32, w_input 0.0025, w_terminal 4, full fidelity
MILLION_SIM = dict(simcase="two-stream", n_particles=1_000_000, n_mesh=256, dt=0.1, t_max=50.0,
                   length=50.0, deposit_method="scatter")
MILLION_CTRL = dict(max_mode=16, coeff_min=-2.0, coeff_max=2.0)
MILLION_MPC = dict(n_candidates=384, w_input=0.0025, horizon=10, plan_modes=32, plan_chunk=16,
                   w_terminal=4.0)
MILLION_STEPS = 3
# kernels 4-6 beyond 3631 cells: the grid slice's plan particles on 4096 cells
WIDE_MESH = dict(n=1250, m=4096, k=8, h=4)
# the committed DAgger actors at tests/test_rl.py's TestLearnedSuppression
# configurations and gates: (simcase, environment, tail PE bound, bound as a
# fraction of the uncontrolled tail PE or None)
LEARNED = (
    ("two-stream", dict(simcase="two-stream", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0),
     250.0, 0.25),
    ("bump-on-tail", dict(simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1,
                          t_max=50.0), 18.0, None),
    ("landau", dict(simcase="landau", n_particles=2000, n_mesh=32, dt=0.1, t_max=15.0,
                    perturb_amplitude=0.3, perturb_mode=2), 25.0, None),
)
LEARNED_MAX_MODE = 3
# run_dagger.py --optimize at its CLI defaults (N=5000, M=250, 500 steps,
# max_mode 3; K=512, H=10, Km=16), depth cut from 6 iterations x 400 epochs
DAGGER_ITERS, DAGGER_EPOCHS = 2, 100
# run_ddpg's min_buffer_size of 10000 would start the updates in episode 21;
# lowered so that both episodes of [rl-train] update
RL_MIN_BUFFER = 250
RL_EPISODES = 2
# run_ppo's 1000 steps at its dt of 0.05, cut to 500 (t_max 25)
PPO_T_MAX = 25.0
GRADREFINE_ITERS, GRADREFINE_SOLVES = 5, 10
# the README's library-use example (README.md:135-144) at its own widths;
# its mpc_rollout cut from cfg.n_steps to SURFACE_MPC_STEPS
SURFACE_SIM = dict(simcase="two-stream", n_particles=10_000, n_mesh=128)
SURFACE_MAX_MODE = 3
SURFACE_MPC = dict(n_candidates=512, horizon=10, plan_particles=2048, plan_mesh=64)
SURFACE_MPC_STEPS = 20
SURFACE_PRESETS = ("wo-oc", "feedback", "ddpg", "ppo", "sac", "bench-small", "bench-host",
                   "bench-multihost")
SURFACE_PIC_STEPS = 3
RL_CPU_STEPS = 20

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM at 700 W: fp32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes (each input read once, each output
    written once) over the memory rate, and which of the two sets it."""
    t_ops, t_bytes = 1e3 * ops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


# Operations per particle, counted from the CUDA sources for the "cic" kind:
# an FMA is 2, sincosf and fmodf 2 each, a shared-memory atomic add 1.
TAPS_OPS = 13  # shape.cuh taps(): pos, then 4 x (offset, |d|, max)
DEPOSIT_OPS = TAPS_OPS + 4
GATHER_OPS = TAPS_OPS + 8  # taps plus 4 FMAs


def spectral_ops(k: int, h: int, n: int, km: int, rot: bool) -> float:
    """Operations that one spectral horizon needs (the function of
    csrc/spectral_horizon.cu, not its schedule): per candidate, particle and
    step the harmonic recurrence once (4 Km - 3), the mode sums (2 Km), the
    field evaluation (4 Km) and the kick (2), plus the drift: 17 for rot (two
    Horner polynomials, one rotation), 8 for trig (wrap, sincosf); per
    candidate and particle the prologue's field and half kick (4 Km + 2).
    The prologue's phasors and mode sums at the shared x0 are needed once,
    not per candidate: N (6 Km - 1). The kernel reruns the recurrence in its
    field pass (14 Km - 4 per particle-step as written) and redoes the
    prologue's sums in every CTA; that is its overhead, not part of the
    bound. Block reductions (2 Km values per step and CTA) are left out."""
    step = 10 * km - 1 + (17 if rot else 8)
    return k * n * (h * step + 4 * km + 2) + n * (6 * km - 1)


def spectral_bytes(k: int, h: int, n: int, km: int, twin: bool) -> float:
    """x0, v0 and u_c, u_s (K, H, Km) in, the (H, Km) targets in for the
    corrected variant, (K, H) energies out."""
    return 4 * (2 * n + 2 * k * h * km + (2 * h * km if twin else 0) + k * h)


def twin_ops(n_full: int, n: int, h: int, km: int) -> float:
    """Operations of the twin-corrected solve's targets (kernel 7,
    csrc/twin_trajectory.cu): the full state's angle, sincosf, harmonic
    recurrence and mode sums once per particle (6 Km); the plan state's
    prologue (the same, then the field, 4 Km, and the half kick, 2) and per
    step its trig drift (8), recurrence and sums, field and kick (10 Km + 7);
    the shrinkage and the (H, Km) products are left out."""
    return n_full * 6 * km + n * (10 * km + 2) + h * n * (10 * km + 7)


def twin_bytes(n_full: int, n: int, h: int, km: int) -> float:
    """full_x and the plan state's x0, v0 in, the (H, Km) targets out."""
    return 4 * (n_full + 2 * n + 2 * h * km)


def guard_ops(n: int, km: int) -> float:
    """Operations of the fidelity guard's statistic (kernel 8,
    csrc/fidelity_ratio.cu): per particle the angle and sincosf, and per mode
    the recurrence's two FMAs and two adds of the sums, N (6 Km + 1) as the
    source's note counts them; the (Km,) tail is left out."""
    return n * (6 * km + 1)


def guard_bytes(n: int) -> float:
    """The full state's positions in; one float out (left out)."""
    return 4 * n


def solve_ops(m: int) -> float:
    """One Poisson solve (hist * norm - n0) @ e_op_t: the affine once per
    cell, then the M x M product. The kernels of csrc/fused_step.cu redo
    the affine for every output column (4 M^2 as written): their overhead."""
    return 2 * m * m + 2 * m


def grid_horizon_ops(k: int, h: int, n: int, m: int, merged: bool) -> float:
    """Kernels 5-6 (csrc/fused_step.cu): the prologue's deposit and solve at
    the shared x0 once (each CTA redoes them), the drive added per
    candidate; per step and particle taps, one (merged) or two gathers and
    kicks, drift, wrap and a deposit; per step and candidate one solve and
    the drive fields and energy (4 M)."""
    per_particle = TAPS_OPS + (8 + 3 if merged else 16 + 6) + 4 + DEPOSIT_OPS
    return DEPOSIT_OPS * n + solve_ops(m) + k * (m + h * (per_particle * n + solve_ops(m) + 4 * m))


def queued_ms(torch, fn, reps: int = 10) -> float:
    """Milliseconds per call of ``fn`` launched ``reps`` times back to back
    between two CUDA events: the device time of a call whose kernel runs far
    longer than its host path takes to launch it (the launches queue up, so
    the device never waits on the host after the first)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_WINDOWS = 8


def trace_window(torch, fn, reps: int, accept, what: str):
    """``accept(events)`` of the first profiler window it accepts: the device
    events (kernels, copies, sets) of ``reps`` calls of ``fn``, recorded
    after a discarded warm-up window of ``reps`` calls, so that the tracer
    has started before the recorded calls. ``accept`` returns None for a
    window that missed device events (the profiler drops a window now and
    then over the many this run opens): it is taken again, up to
    ``PROFILER_WINDOWS`` times, each miss logged; then the run fails."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/trace.json"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                         on_trace_ready=lambda p, path=path: p.export_chrome_trace(path)) as prof:
                for _step in range(2):  # warm-up, then the recorded window
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
            with open(path) as f:
                trace = json.load(f)
        events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("ph") == "X"]
        got = accept(events)
        if got is not None:
            return got
        log(f"[profiler] window {attempt + 1} of {PROFILER_WINDOWS} for {what}: {len(events)} "
            f"device events for {reps} calls")
    require(False, f"{what}: no profiler window of {PROFILER_WINDOWS} held the calls' device "
            f"events")


def device_ms(torch, fn, kernel: str | None, reps: int = 20) -> tuple[float, float]:
    """(median device time in ms of the kernels whose name contains
    ``kernel``, device ops per call) over ``reps`` calls of ``fn``, from a
    profiler window (:func:`trace_window`). ``kernel=None``: the mean device
    time of all of a call's kernels together."""

    def accept(events):
        kernels = [e for e in events if e["cat"] == "kernel"]
        if kernel is None:
            return (sum(e["dur"] for e in kernels) / 1e3 / reps, len(events) / reps) if (
                kernels) else None
        # the trace may miss an event at the start of the window
        ours = [e["dur"] for e in kernels if kernel in e["name"]]
        if reps - 2 <= len(ours) <= reps:
            return statistics.median(ours) / 1e3, len(events) / len(ours)
        return None

    for _ in range(3):
        fn()
    return trace_window(torch, fn, reps, accept, f"device time of {kernel or 'all kernels'}")


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

    # deposit / gather: every kind, B = 1 and 4. The deposit sums ~20 weights
    # per cell exactly (fixed point), the plain version in fp32: rtol 1e-5,
    # atol 1e-4 (the JAX package's Pallas bar), on positions in [-L, 2L) that
    # the kernel wraps, with the normalisation n0 L / N / dx applied in the
    # kernel; gather is a 4-tap sum: atol 1e-5.
    dep_err = gat_err = 0.0
    scale = length / n / (length / m)
    for b in (1, 4):
        x = torch.rand((b, n), generator=gen, device=dev) * length
        xu = torch.rand((b, n), generator=gen, device=dev) * (3 * length) - length
        e = torch.randn((b, m), generator=gen, device=dev)
        for kind in KINDS:
            got = cic.deposit_cic(xu, m, length, kind, scale=scale)
            ref = cic.deposit_cic_plain(xu, m, length, kind, scale=scale)
            torch.cuda.synchronize()
            require(torch.allclose(got, ref, rtol=1e-5, atol=1e-4), f"deposit {kind} B={b}")
            charge = float(got.sum())
            require(abs(charge - m * b) <= 1e-5 * m * b, f"deposit {kind} B={b}: charge {charge}")
            dep_err = max(dep_err, float((got - ref).abs().max()))
            got, ref = cic.gather_cic(e, x, m, length, kind), cic.gather_cic_plain(e, x, m, length, kind)
            torch.cuda.synchronize()
            require(torch.allclose(got, ref, rtol=0.0, atol=1e-5), f"gather {kind} B={b}")
            gat_err = max(gat_err, float((got - ref).abs().max()))
    log(f"[kernels] deposit: 3 kinds x B in (1, 4), N={n}, M={m}, positions in [-L, 2L), scale "
        f"n0 L / N / dx: max |err| {dep_err:.3g} (rtol 1e-5, atol 1e-4), charge conserved to 1e-5")
    log(f"[kernels] gather: 3 kinds x B in (1, 4): max |err| {gat_err:.3g} (atol 1e-5)")
    # the env path's inputs: positions outside [0, L), one (M,) field read
    # at row stride 0; the kernel wraps as torch.remainder does
    err = 0.0
    for b in (1, 4):
        x = torch.rand((b, n), generator=gen, device=dev) * (3 * length) - length
        e = torch.randn(m, generator=gen, device=dev)
        for kind in KINDS:
            got, ref = cic.gather_cic(e, x, m, length, kind), cic.gather_cic_plain(e, x, m, length, kind)
            torch.cuda.synchronize()
            require(torch.allclose(got, ref, rtol=0.0, atol=1e-5), f"gather {kind} B={b}, unwrapped")
            err = max(err, float((got - ref).abs().max()))
    log(f"[kernels] gather on positions in [-L, 2L) with one shared (M,) field: 3 kinds x B in "
        f"(1, 4): max |err| {err:.3g} (atol 1e-5)")

    x1 = torch.rand((1, n), generator=gen, device=dev) * length
    e1 = torch.randn((1, m), generator=gen, device=dev)
    check_deposit(torch, rows, "deposit_cic", n, m, length, gen)
    rows["gather_cic"].update(
        max_abs_err=gat_err,
        ms=time_ms(torch, lambda: cic.gather_cic(e1, x1, m, length)),
        plain_ms=time_ms(torch, lambda: cic.gather_cic_plain(e1, x1, m, length)),
    )
    rows["deposit_cic"]["max_abs_err"] = max(dep_err, rows["deposit_cic"]["max_abs_err"])
    rows["gather_cic"]["device_ms"], ops = device_ms(
        torch, lambda: cic.gather_cic(e1, x1, m, length), "gather_kernel")
    log(f"[kernels] gather_cic: device time {rows['gather_cic']['device_ms']:.5f} ms per launch, "
        f"{ops:.3g} device ops per call")
    rows["gather_cic"].update(**bound(GATHER_OPS * n, 4 * (m + 2 * n)))

    # the library's periodic linear interpolation: grid_sample over the mesh
    # padded circularly by one cell (align_corners=True puts -1 on cell 0
    # and +1 on cell M, so x maps to 2 x / L - 1), the same function as the
    # "cic" gather; the padding and the grid are its inputs, not timed. The
    # normalised coordinate rounds to ~6e-8, which grid_sample scales by M:
    # 1.5e-5 of a cell at M=250, times field differences of a few units, so
    # the two agree to atol 1e-4
    import torch.nn.functional as F

    e_pad = torch.cat([e1, e1[:, :1]], dim=1)[:, None, None, :]  # (1, 1, 1, M + 1)
    coords = torch.stack([2.0 * x1 / length - 1.0, torch.zeros_like(x1)], dim=-1)[:, None]

    def lib():
        return F.grid_sample(e_pad, coords, mode="bilinear", align_corners=True)

    lib_err = float((lib()[:, 0, 0] - cic.gather_cic(e1, x1, m, length)).abs().max())
    require(lib_err <= 1e-4, f"grid_sample vs the cic gather: max |err| {lib_err}")
    # in turns, kernel and library, so that both see the same host
    kern, libr = [], []
    for _ in range(2):
        kern.append(time_ms(torch, lambda: cic.gather_cic(e1, x1, m, length)))
        libr.append(time_ms(torch, lib))
    rows["gather_cic"]["ms"], rows["gather_cic"]["library_ms"] = min(kern), min(libr)
    lib_dev, _ = device_ms(torch, lib, None)
    log(f"[kernels] gather vs its library call, in turns: kernel {kern} ms, grid_sample {libr} ms "
        f"per call (wrapper included); device {rows['gather_cic']['device_ms']:.5f} vs "
        f"{lib_dev:.5f} ms; grid_sample max |err| {lib_err:.3g} against the kernel (atol 1e-4)")

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
    one = sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=True, **kw)
    require(torch.equal(one, sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=True, **kw)),
            "spectral_horizon: two launches differ")
    dev_ms, ops = device_ms(torch, lambda: sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=True, **kw),
                            "spectral_horizon_kernel")
    require(ops == 1, f"spectral_horizon: {ops:.3g} device ops per call")
    rows["spectral_horizon"].update(
        max_abs_err=sh_err, device_ms=dev_ms,
        ms=time_ms(torch, lambda: sh.spectral_horizon(st.x, st.v, u_c, u_s, rot=True, **kw)),
        plain_ms=time_ms(torch, lambda: sh.spectral_horizon_plain(st.x, st.v, u_c, u_s, rot=True, **kw)),
        library_ms=None,
        **bound(spectral_ops(k, h, n, km, rot=True), spectral_bytes(k, h, n, km, twin=False)),
    )
    log(f"[kernels] spectral_horizon rot at K={k}, H={h}, Km={km}, N={n} "
        f"({sh.launch_geometry(n, True)}): device time {dev_ms:.5f} ms per launch, one device op "
        f"per call, two launches bitwise equal")
    for name in ("deposit_cic", "gather_cic", "spectral_horizon"):
        log(f"[kernels] {name}: kernel {rows[name]['ms']:.4f} ms, "
            f"plain {rows[name]['plain_ms']:.4f} ms per call")


def check_deposit(torch, rows: dict, name: str, n: int, m: int, length: float, gen) -> None:
    """Kernel 2 at one of its paths' shapes (B=1, N positions in [-L, 2L),
    M cells, the normalisation of ops/deposit.py::deposit): two launches
    bitwise equal; at every cluster size the wrapper can choose bitwise the
    same row, each size's device time; deposit(method="pallas") one device
    op per call; timed wrapped, on the device and beside the plain
    version."""
    from plasma_control_tpu_torch.ops import deposit as dep
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.ops.kernels import cic

    dev = torch.device("cuda")
    x = torch.rand((1, n), generator=gen, device=dev) * (3 * length) - length
    grid = make_grid(m, length, device=dev)
    scale = length / n / grid.dx
    one = cic.deposit_cic(x, m, length, scale=scale)
    require(torch.equal(one, cic.deposit_cic(x, m, length, scale=scale)),
            f"{name}: two launches differ")
    chosen = cic.deposit_cluster(n, 1, 0)
    sizes = (1, 2, 4, 8, 16)
    for c in sizes:
        require(torch.equal(cic._deposit_cuda(x, m, length, "cic", scale, c), one),
                f"{name}: cluster of {c} CTAs differs")
    err = float((one - cic.deposit_cic_plain(x, m, length, scale=scale)).abs().max())
    require(torch.allclose(one, cic.deposit_cic_plain(x, m, length, scale=scale), rtol=1e-5,
                           atol=1e-4), f"{name} vs plain")
    call = lambda: dep.deposit(x, grid, method="pallas")  # noqa: E731
    require(torch.equal(call(), one), f"{name}: deposit() and the kernel")
    dev_ms, ops = device_ms(torch, call, "deposit_kernel")
    require(ops == 1, f"{name}: deposit(method='pallas') is {ops:.3g} device ops per call")
    per = {c: device_ms(torch, lambda: cic._deposit_cuda(x, m, length, "cic", scale, c),
                        "deposit_kernel")[0] for c in sizes}
    rows[name].update(
        max_abs_err=err, device_ms=dev_ms,
        ms=time_ms(torch, lambda: cic.deposit_cic(x, m, length, scale=scale)),
        plain_ms=time_ms(torch, lambda: cic.deposit_cic_plain(x, m, length, scale=scale)),
        library_ms=None, **bound(DEPOSIT_OPS * n + 2 * m, 4 * (n + m)),
    )
    log(f"[kernels] {name}: N={n}, M={m}, cluster of {chosen} CTAs: two launches bitwise equal, "
        f"the same row at clusters of {sizes} CTAs, max |err| {err:.3g} against plain (rtol 1e-5, "
        f"atol 1e-4); deposit(method='pallas') one device op per call; device time "
        f"{dev_ms:.5f} ms per launch (by cluster size: "
        f"{', '.join(f'{c}: {t:.5f}' for c, t in per.items())} ms); kernel "
        f"{rows[name]['ms']:.4f} ms, plain {rows[name]['plain_ms']:.4f} ms per call")


def check_grid_kernels(torch, rows: dict) -> None:
    """Phase 3, second part: kernels 4-6 at the grid slice's plan model, and
    kernel 1 at N=20000 on a cluster of CTAs."""
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
    # exact: drift, wrap, deposit, taps, gather, kick, drift, wrap, deposit per
    # particle; two M x M solves per row
    leapfrog_ops = k * ((2 * 2 + 2 * 2 + 2 * DEPOSIT_OPS + GATHER_OPS + 3) * n + 2 * solve_ops(m) + m)
    rows["fused_leapfrog_step"]["device_ms"], _ = device_ms(
        torch, lambda: fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, **kw), "leapfrog_rows_kernel")
    rows["fused_leapfrog_step"].update(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, **kw)),
        plain_ms=time_ms(torch, lambda: fs.fused_leapfrog_step_plain(xb, vb, u[:, 0], eop, **kw)),
        library_ms=None,
        **bound(leapfrog_ops, 4 * (4 * k * n + 2 * k * m + m * m)),
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
            require(torch.equal(got, fn(x0, v0, u, eop, kind=kind, **kw)),
                    f"{name} {kind}: two launches differ")
            miss = int(((got - ref).abs() > 1e-6 + 2e-4 * ref.abs()).sum())
            require(miss <= (got.numel() // 1000 if kind == "tsc" else 0),
                    f"{name} {kind}: {miss} energies beyond rtol 2e-4")
            require(torch.allclose(got, ref, rtol=1e-2, atol=1e-6), f"{name} {kind}")
            err = max(err, float((got - ref).abs().max()))
            out[name, kind] = got
        log(f"[kernels] {name}: 3 kinds, K={k}, H={h}, N={n}, M={m}: max |err| {err:.3g} "
            f"(rtol 2e-4); two launches bitwise equal for each kind")
        rows[name]["device_ms"], _ = device_ms(
            torch, lambda: fn(x0, v0, u, eop, **kw),
            "horizon_kernel<true" if name == "fused_packed_horizon" else "horizon_kernel<false")
        rows[name].update(
            max_abs_err=err,
            ms=time_ms(torch, lambda: fn(x0, v0, u, eop, **kw)),
            plain_ms=time_ms(torch, lambda: plain(x0, v0, u, eop, **kw)),
            library_ms=None,
            **bound(grid_horizon_ops(k, h, n, m, merged=name == "fused_packed_horizon"),
                    4 * (2 * n + k * h * m + m * m + k * h)),
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

    # kernel 1 at N=20000: one candidate over a cluster of CTAs
    n1, k1, h1, km1 = 20_000, 64, 10, 16
    x1 = torch.rand(n1, generator=gen, device=dev) * length
    v1 = 1.5 * torch.randn(n1, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k1, h1, km1), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k1, h1, km1), generator=gen, device=dev)
    kw1 = dict(length=length, dt=SIM["dt"], n0=1.0, n_particles=n1)
    for rot in (True, False):
        geo = sh.launch_geometry(n1, rot)
        require(geo.cluster > 1 and geo.shared_bytes > 0, f"N={n1}: {geo}")
        got = sh.spectral_horizon(x1, v1, u_c, u_s, rot=rot, **kw1)
        ref = sh.spectral_horizon_plain(x1, v1, u_c, u_s, rot=rot, **kw1)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"spectral_horizon N={n1} rot={rot}: non-finite")
        require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), f"spectral_horizon N={n1} rot={rot}")
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        ms = time_ms(torch, lambda: sh.spectral_horizon(x1, v1, u_c, u_s, rot=rot, **kw1))
        dev_ms, _ = device_ms(torch, lambda: sh.spectral_horizon(x1, v1, u_c, u_s, rot=rot, **kw1),
                              "spectral_horizon_kernel")
        plain_ms = time_ms(torch, lambda: sh.spectral_horizon_plain(x1, v1, u_c, u_s, rot=rot, **kw1))
        b = bound(spectral_ops(k1, h1, n1, km1, rot), spectral_bytes(k1, h1, n1, km1, twin=False))
        log(f"[kernels] spectral_horizon {'rot' if rot else 'trig'}, {geo}: "
            f"K={k1}, H={h1}, Km={km1}, N={n1}: max |err| {float((got - ref).abs().max()):.3g}, "
            f"max rel {rel:.3g} (rtol 2e-4); kernel {ms:.4f} ms, device {dev_ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms; bound {b['bound_ms']:.6f} ms ({b['bound_by']}, {b['ops']:.4g} "
            f"operations)")
    for name in ("fused_leapfrog_step", "fused_kdk_horizon", "fused_packed_horizon"):
        log(f"[kernels] {name}: kernel {rows[name]['ms']:.4f} ms, "
            f"plain {rows[name]['plain_ms']:.4f} ms per call")


def _setup(torch, device, sim=SIM, max_mode=MAX_MODE, mpc=MPC, ctrl=None):
    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.ops.grid import make_grid

    cfg, mpc = SimConfig(**sim), MPCConfig(**mpc)
    ctrl = ControlConfig(**(ctrl or dict(max_mode=max_mode)))
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
    st_cpu = init_state(cfg, gen, device="cpu")
    d = 2 * ctrl.max_mode
    cand = torch.clamp(0.3 * torch.randn((mpc.n_candidates, mpc.horizon, d), generator=gen), -1, 1)
    noise = torch.stack([draw_noise(gen, mpc, mpc.horizon, d, device="cpu") for _ in range(3)])
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
    return {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}


def _kernel_fns() -> dict:
    """Row name -> (kernel wrapper, its launch count). Kernel 1's wrapper
    counts every launch in ``launches`` and those of its twin-corrected
    variant also in ``twin_launches``."""
    from plasma_control_tpu_torch.ops.kernels import cic
    from plasma_control_tpu_torch.ops.kernels import fidelity_ratio as fr
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh
    from plasma_control_tpu_torch.ops.kernels import twin_trajectory as tt

    return {"deposit_cic": (cic.deposit_cic, "launches"),
            "gather_cic": (cic.gather_cic, "launches"),
            "spectral_horizon": (sh.spectral_horizon, "launches"),
            "spectral_horizon_twin": (sh.spectral_horizon, "twin_launches"),
            "fused_leapfrog_step": (fs.fused_leapfrog_step, "launches"),
            "fused_kdk_horizon": (fs.fused_kdk_horizon, "launches"),
            "fused_packed_horizon": (fs.fused_packed_horizon, "launches"),
            "twin_trajectory": (tt.twin_trajectory, "launches"),
            "fidelity_ratio": (fr.fidelity_ratio, "launches")}


def _reset(fns: dict) -> None:
    for fn, attr in fns.values():
        setattr(fn, attr, 0)


def check_wide_modes(torch) -> None:
    """Phase 3, fifth part: kernel 1 beyond 16 modes (its blocked variant)
    at Km=32 over 16 drive modes, both drifts, the plain and the corrected
    energy, with the state in shared memory (N=20000, K=64, H=10, clusters
    of 4 CTAs) and in the global scratch (the million-particle solve's
    chunk: N=1M, K=16, H=10), against the plain version to rtol 2e-4; two
    launches bitwise equal; device times."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    length, km, ka, h = SIM["length"], 32, 16, 10
    for n, k in ((20_000, 64), (MILLION_SIM["n_particles"], MILLION_MPC["plan_chunk"])):
        x = torch.rand(n, generator=gen, device=dev) * length
        v = 1.5 * torch.randn(n, generator=gen, device=dev)
        cand = 0.6 * torch.randn((k, h, 2 * ka), generator=gen, device=dev)
        tc, ts = (n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
        for rot in (True, False):
            geo = sh.launch_geometry(n, rot, km)
            require((geo.shared_bytes > 0) == (n == 20_000), f"N={n}, Km={km}: {geo}")
            for twin in (False, True):
                kw = dict(length=length, dt=0.1, n0=1.0, n_particles=n, rot=rot, n_modes=km,
                          twin_c=tc if twin else None, twin_s=ts if twin else None)
                call = lambda: sh.spectral_horizon(x, v, cand[..., :ka], cand[..., ka:], **kw)  # noqa: E731
                got = call()
                ref = sh.spectral_horizon_plain(x, v, cand[..., :ka], cand[..., ka:], **kw)
                torch.cuda.synchronize()
                what = f"Km={km} N={n} rot={rot} twin={twin}"
                require(bool(torch.isfinite(got).all()), f"spectral_horizon {what}: non-finite")
                require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), f"spectral_horizon {what}")
                require(torch.equal(got, call()), f"spectral_horizon {what}: two launches differ")
                rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
                dev_ms, ops = device_ms(torch, call, "spectral_horizon", reps=5)
                require(ops == 1, f"spectral_horizon {what}: {ops:.3g} device ops per call")
                b = bound(spectral_ops(k, h, n, km, rot), spectral_bytes(k, h, n, km, twin))
                plain = lambda: sh.spectral_horizon_plain(  # noqa: E731
                    x, v, cand[..., :ka], cand[..., ka:], **kw)
                log(f"[km32] spectral_horizon{'_twin' if twin else ''} {'rot' if rot else 'trig'}, "
                    f"{geo}: K={k}, H={h}, Km={km} over Ka={ka}, N={n}: max rel {rel:.3g} (rtol "
                    f"2e-4), two launches bitwise equal; kernel {time_ms(torch, call, reps=5):.4f} "
                    f"ms, device {dev_ms:.5f} ms per launch, one device op per call, plain "
                    f"{time_ms(torch, plain, reps=2):.4f} ms; bound {b['bound_ms']:.6f} ms "
                    f"({b['bound_by']}) = {100 * b['bound_ms'] / dev_ms:.2f} %")


def check_wide_mesh(torch, rows: dict) -> None:
    """Phase 3, sixth part: kernels 4-6 beyond 3631 cells, their mesh arrays
    in a global scratch: the grid slice's plan particles on 4096 cells (K=8,
    H=4, N=1250), every kind, against the plain versions at the bars of the
    64-cell checks, two launches bitwise equal; then the grid planner's
    candidate costs on a 4096-cell plan model with kernels 6 and 4
    (``[mesh]``, launch counts set to 0 before and read after), and each
    kernel timed."""
    from plasma_control_tpu_torch.config import MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.mpc import candidate_costs
    from plasma_control_tpu_torch.models.pic import PlasmaState
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    n, m, k, h = (WIDE_MESH[key] for key in ("n", "m", "k", "h"))
    length = SIM["length"]
    require(not fs._layout(n, m).mesh, f"M={m}: {fs._layout(n, m)}")
    grid = make_grid(m, length, device=dev)
    eop = grid.e_op.T.contiguous()
    xb = torch.rand((k, n), generator=gen, device=dev) * length
    vb = torch.randn((k, n), generator=gen, device=dev)
    u = 0.05 * torch.randn((k, h, m), generator=gen, device=dev)
    kw = dict(n_mesh=m, length=length, dt=SIM["dt"])
    x0, v0 = xb[0].contiguous(), vb[0].contiguous()
    errs = {name: 0.0 for name in ("fused_leapfrog_step", "fused_kdk_horizon",
                                   "fused_packed_horizon")}
    for kind in KINDS:
        got = fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, kind=kind, **kw)
        ref = fs.fused_leapfrog_step_plain(xb, vb, u[:, 0], eop, kind=kind, **kw)
        torch.cuda.synchronize()
        dx = torch.remainder(got[0] - ref[0] + length / 2, length) - length / 2
        require(bool((dx.abs() <= 1e-4 + 1e-5 * ref[0].abs()).all()), f"M={m} leapfrog {kind}: x")
        require(torch.allclose(got[1], ref[1], rtol=1e-5, atol=1e-4), f"M={m} leapfrog {kind}: v")
        pe_got, pe_ref = ((e.double() ** 2).sum(-1) for e in (got[2], ref[2]))
        require(torch.allclose(pe_got, pe_ref, rtol=1e-4, atol=1e-9), f"M={m} leapfrog {kind}: PE")
        again = fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, kind=kind, **kw)
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"M={m} leapfrog {kind}: repeat")
        errs["fused_leapfrog_step"] = max(errs["fused_leapfrog_step"], float(dx.abs().max()),
                                          float((got[1] - ref[1]).abs().max()))
        for name, plain in (("fused_kdk_horizon", fs.fused_kdk_horizon_plain),
                            ("fused_packed_horizon", fs.fused_packed_horizon_plain)):
            fn = getattr(fs, name)
            got, ref = fn(x0, v0, u, eop, kind=kind, **kw), plain(x0, v0, u, eop, kind=kind, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"M={m} {name} {kind}: non-finite")
            require(torch.equal(got, fn(x0, v0, u, eop, kind=kind, **kw)),
                    f"M={m} {name} {kind}: two launches differ")
            miss = int(((got - ref).abs() > 1e-6 + 2e-4 * ref.abs()).sum())
            require(miss <= (got.numel() // 1000 if kind == "tsc" else 0),
                    f"M={m} {name} {kind}: {miss} energies beyond rtol 2e-4")
            require(torch.allclose(got, ref, rtol=1e-2, atol=1e-6), f"M={m} {name} {kind}")
            errs[name] = max(errs[name], float((got - ref).abs().max()))
    log(f"[mesh] kernels 4-6 at M={m} (mesh arrays in a global scratch), K={k}, H={h}, N={n}, "
        f"3 kinds: max |err| {errs} (leapfrog rtol 1e-5 / atol 1e-4, field energy rtol 1e-4; "
        f"horizons rtol 2e-4); two launches bitwise equal")

    # the grid planner on a 4096-cell plan model: one candidate block through
    # kernel 6 (kdk) and through H launches of kernel 4 (leapfrog)
    cfg = SimConfig(simcase="bump-on-tail", n_particles=n, n_mesh=m, dt=SIM["dt"], t_max=5.0,
                    length=length)
    act = make_actuator(length, m, MAX_MODE, device=dev)
    st = PlasmaState(x0, v0)
    cand = torch.clamp(0.3 * torch.randn((k, h, 2 * MAX_MODE), generator=gen, device=dev), -1, 1)
    mpcs = {integrator: MPCConfig(horizon=h, n_candidates=k, plan_model="grid",
                                  plan_integrator=integrator) for integrator in ("kdk", "leapfrog")}
    fns = _kernel_fns()
    _reset(fns)
    costs = {integrator: candidate_costs(st, cand, grid, cfg, mpc, act)
             for integrator, mpc in mpcs.items()}
    kdk_costs = candidate_costs(st, cand, grid, cfg, mpcs["kdk"], act)
    launches = _counts(fns)
    require(launches["fused_packed_horizon"] == 2 and launches["fused_leapfrog_step"] == h,
            f"[mesh] launches {launches}")
    require(torch.equal(kdk_costs, costs["kdk"]), "[mesh] kernel 6 costs repeat")
    for integrator, c in costs.items():
        require(bool(torch.isfinite(c).all()), f"[mesh] {integrator} costs not finite")
    log(f"[mesh] grid planner costs on the {m}-cell plan model, K={k}, H={h}: launches {launches}; "
        f"kdk {costs['kdk'].tolist()}, leapfrog {costs['leapfrog'].tolist()}")
    # explicit KDK (kernel 5) has no caller: one launch counted here
    _reset(fns)
    fs.fused_kdk_horizon(x0, v0, act.compute_e_packed(cand), eop, **kw)
    kdk_launches = _counts(fns)["fused_kdk_horizon"]

    leapfrog_ops = k * ((2 * 2 + 2 * 2 + 2 * DEPOSIT_OPS + GATHER_OPS + 3) * n + 2 * solve_ops(m) + m)
    entries = (
        ("fused_leapfrog_step_m4096", lambda: fs.fused_leapfrog_step(xb, vb, u[:, 0], eop, **kw),
         lambda: fs.fused_leapfrog_step_plain(xb, vb, u[:, 0], eop, **kw), "leapfrog_kernel",
         bound(leapfrog_ops, 4 * (4 * k * n + 2 * k * m + m * m)), launches["fused_leapfrog_step"],
         errs["fused_leapfrog_step"]),
        ("fused_kdk_horizon_m4096", lambda: fs.fused_kdk_horizon(x0, v0, u, eop, **kw),
         lambda: fs.fused_kdk_horizon_plain(x0, v0, u, eop, **kw), "horizon_kernel<false",
         bound(grid_horizon_ops(k, h, n, m, merged=False), 4 * (2 * n + k * h * m + m * m + k * h)),
         kdk_launches, errs["fused_kdk_horizon"]),
        ("fused_packed_horizon_m4096", lambda: fs.fused_packed_horizon(x0, v0, u, eop, **kw),
         lambda: fs.fused_packed_horizon_plain(x0, v0, u, eop, **kw), "horizon_kernel<true",
         bound(grid_horizon_ops(k, h, n, m, merged=True), 4 * (2 * n + k * h * m + m * m + k * h)),
         launches["fused_packed_horizon"], errs["fused_packed_horizon"]),
    )
    for name, call, plain, kernel, b, count, err in entries:
        rows[name].update(launches=count, max_abs_err=err, ms=time_ms(torch, call, reps=10),
                          plain_ms=time_ms(torch, plain, reps=3), library_ms=None, **b)
        rows[name]["device_ms"], _ = device_ms(torch, call, kernel, reps=5)
        log(f"[mesh] {name}: kernel {rows[name]['ms']:.4f} ms, device "
            f"{rows[name]['device_ms']:.5f} ms, plain {rows[name]['plain_ms']:.4f} ms per call; "
            f"bound {b['bound_ms']:.6f} ms ({b['bound_by']})")


def check_gather_large(torch, rows: dict) -> None:
    """Phase 3, seventh part: kernel 3 at the env step's large shapes (one
    (M,) field, M=256): N=100000, the twin and config-4 environment, and
    N=1M, the million-particle environment (:func:`check_gather`)."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(19)
    m = CFG4_SIM["n_mesh"]
    for name, n in (("gather_cic_100k", CFG4_SIM["n_particles"]),
                    ("gather_cic_million", MILLION_SIM["n_particles"])):
        check_gather(torch, rows, name, n, m, gen)


def check_damping_kernels(torch, rows: dict) -> None:
    """Phase 3, eighth part: kernels 2 and 3 at the ``[damping]`` row's
    environment (N=10000, M=128; :func:`check_deposit`,
    :func:`check_gather`)."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(23)
    n, m = DAMPING_SIM["n_particles"], DAMPING_SIM["n_mesh"]
    check_deposit(torch, rows, "deposit_cic_damping", n, m, SIM["length"], gen)
    check_gather(torch, rows, "gather_cic_damping", n, m, gen)


def check_gather(torch, rows: dict, name: str, n: int, m: int, gen) -> None:
    """Kernel 3 at one of its paths' shapes (one (M,) field, N positions):
    against the plain version (atol 1e-5) on positions in [-L, 2L); bitwise
    equal to the same positions read one particle per thread (a copy at a
    4-byte offset, which the kernel reads scalar, as the
    one-thread-per-particle kernel did); timed in turns with grid_sample,
    wrapped and on the device."""
    import torch.nn.functional as F

    from plasma_control_tpu_torch.ops.kernels import cic

    dev = torch.device("cuda")
    length = SIM["length"]
    e = torch.randn(m, generator=gen, device=dev)
    xu = torch.rand((1, n), generator=gen, device=dev) * (3 * length) - length
    err = 0.0
    for kind in KINDS:
        got = cic.gather_cic(e, xu, m, length, kind)
        ref = cic.gather_cic_plain(e, xu, m, length, kind)
        shifted = torch.empty(n + 1, device=dev)[1:]
        shifted.copy_(xu[0])
        scalar = cic.gather_cic(e, shifted, m, length, kind)
        torch.cuda.synchronize()
        require(torch.allclose(got, ref, rtol=0.0, atol=1e-5), f"{name} {kind} vs plain")
        require(torch.equal(got[0], scalar), f"{name} {kind}: vector and scalar reads differ")
        err = max(err, float((got - ref).abs().max()))
    # timed on positions in [0, L), where grid_sample computes the same
    # function (see check_kernels)
    x = torch.rand((1, n), generator=gen, device=dev) * length
    e_pad = torch.cat([e, e[:1]])[None, None, None, :]
    coords = torch.stack([2.0 * x / length - 1.0, torch.zeros_like(x)], dim=-1)[:, None]
    call = lambda: cic.gather_cic(e, x, m, length)  # noqa: E731
    lib = lambda: F.grid_sample(e_pad, coords, mode="bilinear", align_corners=True)  # noqa: E731
    lib_err = float((lib()[:, 0, 0] - call()).abs().max())
    require(lib_err <= 1e-4, f"{name}: grid_sample vs the cic gather: max |err| {lib_err}")
    kern, libr = [], []
    for _ in range(2):
        kern.append(time_ms(torch, call))
        libr.append(time_ms(torch, lib))
    dev_ms, ops = device_ms(torch, call, "gather_kernel")
    require(ops == 1, f"{name}: {ops:.3g} device ops per call")
    lib_dev, _ = device_ms(torch, lib, None)
    rows[name].update(max_abs_err=err, ms=min(kern), library_ms=min(libr), device_ms=dev_ms,
                      plain_ms=time_ms(torch, lambda: cic.gather_cic_plain(e, x, m, length),
                                       reps=10),
                      **bound(GATHER_OPS * n, 4 * (m + 2 * n)))
    b = rows[name]
    log(f"[gather] {name}: N={n}, M={m}, 3 kinds: max |err| {err:.3g} against plain (atol "
        f"1e-5), bitwise equal to the scalar reading; in turns: kernel {kern} ms, grid_sample "
        f"{libr} ms per call; device {dev_ms:.5f} ms (grid_sample {lib_dev:.5f} ms); bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}) = {100 * b['bound_ms'] / dev_ms:.2f} % on "
        f"the device; plain {b['plain_ms']:.4f} ms")


def run_slice(torch, rows: dict) -> None:
    """Phase 4a: the full 500-step control loop and the uncontrolled push."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plan_gen = torch.Generator(device=dev).manual_seed(1)
    steps = cfg.n_steps
    # warm-up: cuBLAS/cuFFT handles and plans, allocator pools
    mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev), n_steps=3)

    fns = _kernel_fns()
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, plan_gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(fns)
    counters = ("deposit_cic", "gather_cic", "spectral_horizon")
    for name in counters:
        rows[name]["launches"] = counts[name]

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
    rows["fidelity_ratio_grid"]["launches"] = launches["fidelity_ratio"]
    log(f"[grid] {steps} control steps; kernel launches in the controlled run: {launches}")
    require(launches["fused_packed_horizon"] == launches["fidelity_ratio"] == steps,
            "one fused_packed_horizon launch and one fidelity_ratio launch per solve")
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
    rows["fused_kdk_horizon"]["launches"] = _counts(fns)["fused_kdk_horizon"]
    require(rows["fused_kdk_horizon"]["launches"] == 10, "ten fused_kdk_horizon launches")
    log(f"[kdk] fused_kdk_horizon on 10 candidate blocks of the grid slice (n_eff={pcfg.n_particles}, "
        f"plan mesh {pgrid.n_mesh}) beside fused_packed_horizon: horizon sums max rel {rel:.3g} "
        f"(rtol 2e-4)")


def run_config4(torch) -> None:
    """Phase 4e: three control steps of config-4's full-fidelity controller,
    then kernel 1 against its plain version at that path's shapes."""
    from plasma_control_tpu_torch.control.mpc import draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE,
                                       mpc=CFG4_MPC)
    rot = sh.use_rot(cfg.clamped_dt(), cfg.length, mpc.spectral_drift)
    geo = sh.launch_geometry(cfg.n_particles, rot)
    require(geo.cluster == 16 and geo.shared_bytes > 0, f"config-4 launch geometry {geo}")
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
    u_c, u_s = (torch.nn.functional.pad(u, (0, km - ka)) for u in (cand[..., :ka], cand[..., ka:]))
    kw = dict(length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
              rot=rot)
    got = sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw)
    ref = sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "config-4 spectral_horizon: non-finite PE")
    require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), "config-4 spectral_horizon vs plain")
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    ms = time_ms(torch, lambda: sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw), reps=10)
    dev_ms, _ = device_ms(torch, lambda: sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw),
                          "spectral_horizon_kernel", reps=10)
    plain_ms = time_ms(torch, lambda: sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw),
                       reps=3)
    k, h = u_c.shape[:2]
    b = bound(spectral_ops(k, h, cfg.n_particles, km, rot),
              spectral_bytes(k, h, cfg.n_particles, km, twin=False))
    log(f"[config-4] spectral_horizon at the path's shapes (K={k}, H={h}, "
        f"Km={km}, N={cfg.n_particles}, {geo}): max |err| "
        f"{float((got - ref).abs().max()):.3g}, max rel {rel:.3g} (rtol 2e-4); "
        f"kernel {ms:.4f} ms, device {dev_ms:.5f} ms, plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}, {b['ops']:.4g} operations)")


def run_million(torch, rows: dict) -> None:
    """Phase 4h: three control steps of the million-particle 32-mode
    controller (MILLION_*: N=1M, K=384 in 24 chunks of 16, H=10, Km=32 over
    16 actuated modes, rot drift), kernel 1's blocked variant with its state
    in the global scratch, 24 launches per solve; the same three steps as
    the benchmark cell runs them (plan_chunk None: one launch per solve on
    the persistent clusters stream_layout picks for K=384); then kernel 1
    against its plain version on one chunk of the path's candidates and on
    the whole solve's K=384 in one launch, that launch bitwise its 24
    chunks, one chunk's costs on the card against the CPU's plain version,
    and a three-step uncontrolled push of the end state on kernels 2-3 (the
    env step at N=1M with deposit_method="pallas"), for kernel 3's launches
    at this size."""
    import dataclasses

    from plasma_control_tpu_torch.control.mpc import candidate_costs, draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state
    from plasma_control_tpu_torch.models.rollout import rollout
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh
    from plasma_control_tpu_torch.utils import trace

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=MILLION_SIM, mpc=MILLION_MPC,
                                       ctrl=MILLION_CTRL)
    rot = sh.use_rot(cfg.clamped_dt(), cfg.length, mpc.spectral_drift)
    ka, km = ctrl.max_mode, max(mpc.plan_modes, ctrl.max_mode)
    geo = sh.launch_geometry(cfg.n_particles, rot, km)
    # 16 virtual ranks, the state (c1, s1, vh) in a global scratch of one row
    # per CTA of the persistent clusters stream_layout picks from the card's
    # table, 3 S floats per virtual rank, one fused pass over it per step
    fits = sh.cluster_fits(torch.cuda.current_device(), rot, False, km > 16)
    layout = sh.stream_layout(mpc.plan_chunk, geo.cluster, fits)
    scratch = sh.scratch_shape(mpc.plan_chunk, geo, rot, layout)
    require(rot and geo.cluster == 16 and geo.shared_bytes == 0
            and scratch == (layout.clusters * layout.cluster, 3 * geo.slice * 16 // layout.cluster),
            f"million launch geometry {geo}, {layout}, scratch {scratch}")
    # the cell's one launch per solve: fewer clusters than candidates, each
    # walking several, and several virtual ranks per CTA
    solve = sh.stream_layout(mpc.n_candidates, geo.cluster, fits)
    solve_scratch = sh.scratch_shape(mpc.n_candidates, geo, rot, solve)
    require(solve.clusters < mpc.n_candidates and solve.cluster < geo.cluster
            and solve.clusters == min(mpc.n_candidates, fits[solve.cluster]),
            f"million solve layout {solve} of {fits}")
    log(f"[million] clusters the card holds at once by size C, {fits}: a chunk of "
        f"{mpc.plan_chunk} runs on {layout}, a solve's {mpc.n_candidates} in one launch on "
        f"{solve}, scratch {solve_scratch}")
    state0 = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = state0
    gen = torch.Generator(device=dev).manual_seed(16)
    chunks = -(-mpc.n_candidates // mpc.plan_chunk)
    fns = _kernel_fns()
    _reset(fns)
    mean, times, pes = None, [], []
    for _ in range(MILLION_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, gen, n_steps=1, mean0=mean)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        state, mean = out.final_state, out.final_mean
        pes.append(float(out.field_energy[0]))
    launches = _counts(fns)
    rows["spectral_horizon_million"]["launches"] = launches["spectral_horizon"]
    log(f"[million] {MILLION_STEPS} control steps at N={cfg.n_particles}, M={cfg.n_mesh}, "
        f"K={mpc.n_candidates} in chunks of {mpc.plan_chunk}, H={mpc.horizon}, Km={km} over "
        f"{ka} actuated modes at +-{ctrl.coeff_max}, {'rot' if rot else 'trig'} drift, {geo}; "
        f"launches {launches}")
    require(launches["spectral_horizon"] == chunks * MILLION_STEPS,
            f"{chunks} spectral_horizon launches per solve")
    require(launches["spectral_horizon_twin"] == 0, "no corrected launch at full fidelity")
    require(all(math.isfinite(pe) for pe in pes), f"million PE not finite: {pes}")
    log(f"[million] ms per control step: {', '.join(f'{t:.4f}' for t in times)} (the first "
        f"includes one-time set-up); PE {pes}")

    # the same steps as the cell runs them: one launch per solve, on the
    # solve's layout (its clusters and scratch as counted under a recording)
    mpc_one = dataclasses.replace(mpc, plan_chunk=None)
    one_state, one_mean, one_times, one_pes = state0, None, [], []
    one_gen = torch.Generator(device=dev).manual_seed(16)
    _reset(fns)
    with trace.recording(4096):
        for _ in range(MILLION_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mpc_rollout(one_state, grid, cfg, ctrl, mpc_one, act, one_gen, n_steps=1,
                              mean0=one_mean)
            torch.cuda.synchronize()
            one_times.append(1e3 * (time.perf_counter() - t0))
            one_state, one_mean = out.final_state, out.final_mean
            one_pes.append(float(out.field_energy[0]))
        counters = trace.counters()
    launches = _counts(fns)
    log(f"[million] {MILLION_STEPS} control steps as the cell runs them (plan_chunk None): "
        f"launches {launches}; counters {counters}; ms per step "
        f"{', '.join(f'{t:.4f}' for t in one_times)}; PE {one_pes} (the chunked steps' PE "
        f"{'equal' if one_pes == pes else 'differ: the input energy is costed chunk by chunk'})")
    require(launches["spectral_horizon"] == MILLION_STEPS, "one spectral_horizon launch per solve")
    require(counters.get("plan.stream_clusters") == MILLION_STEPS * solve.clusters
            and counters.get("plan.kernel_scratch_bytes")
            == MILLION_STEPS * 4 * solve_scratch[0] * solve_scratch[1],
            f"million solve counters {counters} against {solve}, scratch {solve_scratch}")
    require(all(math.isfinite(pe) for pe in one_pes),
            f"million one-launch PE not finite: {one_pes}")

    # kernel 1 at the path's shape: one chunk of one solve's clipped
    # candidates, as candidate_costs hands them over ((K, H, Ka) views,
    # padded to Km in the kernel), against its plain version to rtol 2e-4
    whole = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, mpc.horizon, 2 * ka, device=dev),
                        ctrl.coeff_min, ctrl.coeff_max)
    cand = whole[:mpc.plan_chunk]
    kw = dict(length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
              rot=rot, n_modes=km)
    call = lambda: sh.spectral_horizon(state.x, state.v, cand[..., :ka], cand[..., ka:], **kw)  # noqa: E731
    plain = lambda: sh.spectral_horizon_plain(state.x, state.v, cand[..., :ka], cand[..., ka:],  # noqa: E731
                                              **kw)
    got, ref = call(), plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "million spectral_horizon: non-finite PE")
    require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), "million spectral_horizon vs plain")
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    k, h = cand.shape[:2]
    # ~10 ms per launch: its device time from launches queued back to back
    # (the profiler's window has dropped launches of this call; [km32] holds
    # the same shape's profiler time and one device op per call)
    dev_ms = queued_ms(torch, call)
    rows["spectral_horizon_million"].update(
        max_abs_err=err, device_ms=dev_ms, ms=time_ms(torch, call, reps=10),
        plain_ms=time_ms(torch, plain, reps=2), library_ms=None,
        **bound(spectral_ops(k, h, cfg.n_particles, km, rot),
                spectral_bytes(k, h, cfg.n_particles, km, twin=False)),
    )
    b = rows["spectral_horizon_million"]
    log(f"[million] spectral_horizon at the path's shapes (K={k}, H={h}, Km={km}, N="
        f"{cfg.n_particles}): max |err| {err:.3g}, max rel {rel:.3g} (rtol 2e-4); kernel "
        f"{b['ms']:.4f} ms, device {dev_ms:.5f} ms (launches queued back to back), plain "
        f"{b['plain_ms']:.4f} ms; bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}, {b['ops']:.4g} operations) = "
        f"{100 * b['bound_ms'] / dev_ms:.2f} % on the device")

    # kernel 1 at the cell's shape: the whole solve's K candidates in one
    # launch on the solve's layout, against its plain version to rtol 2e-4
    # and bitwise the 24 chunks, each on its own layout
    one = lambda: sh.spectral_horizon(state.x, state.v, whole[..., :ka], whole[..., ka:],  # noqa: E731
                                      **kw)
    _reset(fns)
    got = one()
    require(_counts(fns)["spectral_horizon"] == 1, "the solve in one launch")
    chunked = torch.cat([sh.spectral_horizon(state.x, state.v, c[..., :ka], c[..., ka:], **kw)
                         for c in whole.split(mpc.plan_chunk)])
    t0 = time.perf_counter()
    ref = sh.spectral_horizon_plain(state.x, state.v, whole[..., :ka], whole[..., ka:], **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(bool(torch.isfinite(got).all()), "million solve spectral_horizon: non-finite PE")
    require(torch.equal(got, chunked), "million solve in one launch against its chunks")
    require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6),
            "million solve spectral_horizon vs plain")
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    del ref, chunked
    solve_ms = time_ms(torch, one, reps=3)
    log(f"[million] spectral_horizon at the cell's shape (K={whole.shape[0]} in one launch on "
        f"{solve}): bitwise its {whole.shape[0] // mpc.plan_chunk} chunks; max |err| {err:.3g}, "
        f"max rel {rel:.3g} against plain (rtol 2e-4); kernel {solve_ms:.4f} ms, plain "
        f"{plain_s:.1f} s")

    # one chunk's costs on the card against the CPU, where the wrapper runs
    # the plain version (plan_kernel="fused": the kernel's rot arithmetic)
    cpu_cfg, cpu_ctrl, cpu_mpc, cpu_grid, cpu_act = _setup(torch, "cpu", sim=MILLION_SIM,
                                                           mpc=MILLION_MPC, ctrl=MILLION_CTRL)
    cpu_mpc = dataclasses.replace(cpu_mpc, plan_kernel="fused")
    c_gpu = candidate_costs(state, cand, grid, cfg, mpc, act).cpu()
    t0 = time.perf_counter()
    c_cpu = candidate_costs(PlasmaState(state.x.cpu(), state.v.cpu()), cand.cpu(), cpu_grid,
                            cpu_cfg, cpu_mpc, cpu_act)
    cpu_s = time.perf_counter() - t0
    require(torch.allclose(c_gpu, c_cpu, rtol=2e-4), "million chunk costs: card vs CPU plain")
    log(f"[million] card vs CPU plain, one chunk of {k} candidates at Km={km}: costs max rel "
        f"{float(((c_gpu - c_cpu).abs() / c_cpu.abs()).max()):.3g} (rtol 2e-4); the CPU took "
        f"{cpu_s:.1f} s")

    # the env step at N=1M on kernels 2-3
    push_cfg = dataclasses.replace(cfg, deposit_method="pallas")
    _reset(fns)
    push = rollout(state, grid, push_cfg, n_steps=MILLION_STEPS)
    torch.cuda.synchronize()
    launches = _counts(fns)
    rows["gather_cic_million"]["launches"] = launches["gather_cic"]
    require(launches["gather_cic"] == 3 * MILLION_STEPS, "three gathers per Yoshida-4 step")
    require(bool(torch.isfinite(push.field_energy).all()), "million push PE not finite")
    log(f"[million] {MILLION_STEPS}-step uncontrolled push at N={cfg.n_particles} on kernels 2-3: "
        f"launches {launches}, PE {push.field_energy.tolist()}")


GRID_FULLFID_CELL = "bump_on_tail_n100k.mpc_grid_fullfid_graph"
GRID_FULLFID_STEPS = 3


def run_grid_fullfid(torch, rows: dict) -> None:
    """``[grid-fullfid]``: the full-fidelity grid planner's benchmark cell
    (GRID_FULLFID_CELL: bump-on-tail, N=100000 on 256 cells, K=512, H=10,
    kdk on the whole plasma). Kernel 6 at the cell's plan model, the
    particle state in the (K, 2N) global scratch and the operator read from
    L2, on one solve's clipped candidates from a start state of the cell,
    against its plain version on horizon sums (rtol 2e-4), two launches
    bitwise equal; its CUDA-event and device time beside the counted bound.
    Then three captured control steps of the cell's controller (the
    benchmark's program): one kernel 6 launch in each replay, and for each
    warm-up step and the capture one launch of the wrapper and, under a
    recording, the scratch's bytes in ``plan.grid_scratch_bytes``."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, sampler
    from benchmark.cell import load_cell
    from plasma_control_tpu_torch.control.mpc import draw_noise
    from plasma_control_tpu_torch.io import aot
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs
    from plasma_control_tpu_torch.utils import trace

    dev = torch.device("cuda")
    cell = load_cell(GRID_FULLFID_CELL, ROOT)
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=cell.sim, mpc=cell.mpc, ctrl=cell.control)
    n, m, k, h = cfg.n_particles, cfg.n_mesh, mpc.n_candidates, mpc.horizon
    require(fs._layout(n, m) == fs.Layout(True, False, False), f"layout {fs._layout(n, m)}")
    x, v = sampler.start_states(cell.sim, GUARD_SEED, 1, dev)[0]
    gen = torch.Generator(device=dev).manual_seed(25)
    cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, h, 2 * ctrl.max_mode, device=dev),
                       ctrl.coeff_min, ctrl.coeff_max)
    u = act.compute_e_packed(cand)
    eop = grid.e_op.T.contiguous()
    kw = dict(n_mesh=m, length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, kind=cfg.interpol)
    call = lambda: fs.fused_packed_horizon(x, v, u, eop, **kw)  # noqa: E731
    plain = lambda: fs.fused_packed_horizon_plain(x, v, u, eop, **kw)  # noqa: E731
    got, ref = call(), plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "grid-fullfid kernel 6: non-finite energies")
    require(torch.equal(got, call()), "grid-fullfid kernel 6: two launches differ")
    require(torch.allclose(got.sum(-1), ref.sum(-1), rtol=2e-4, atol=1e-6),
            "grid-fullfid kernel 6 vs plain on horizon sums")
    rel = float(((got.sum(-1) - ref.sum(-1)).abs() / ref.sum(-1).abs()).max())
    step_rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
    dev_ms, ops = device_ms(torch, call, "horizon_kernel", reps=10)
    rows["fused_packed_horizon_fullfid"].update(
        launches=0, max_abs_err=float((got - ref).abs().max()), device_ms=dev_ms,
        ms=time_ms(torch, call, reps=10), plain_ms=time_ms(torch, plain, reps=2),
        library_ms=None,
        **bound(grid_horizon_ops(k, h, n, m, merged=True), 4 * (2 * n + k * h * m + m * m + k * h)))
    b = rows["fused_packed_horizon_fullfid"]
    log(f"[grid-fullfid] fused_packed_horizon at the cell's plan model (K={k}, H={h}, N={n}, "
        f"M={m}, {fs._layout(n, m)}, a {4 * k * 2 * n} B scratch): horizon sums max rel "
        f"{rel:.3g} (rtol 2e-4), per step max rel {step_rel:.3g}; two launches bitwise equal; "
        f"kernel {b['ms']:.4f} ms, device {dev_ms:.5f} ms per launch in {ops:.3g} device ops "
        f"per call, plain {b['plain_ms']:.4f} ms; bound {b['bound_ms']:.6f} ms "
        f"({b['bound_by']}, {b['ops']:.4g} operations) = {100 * b['bound_ms'] / dev_ms:.2f} %")
    del ref

    # the cell's controller, captured: the first call warms up, captures
    # and replays once, under a recording
    prog = harness.Program(cell, "cuda")
    x, v = sampler.start_states(cell.sim, GUARD_SEED, 1, "cuda")[0]
    prog.generator.manual_seed(GUARD_SEED)
    state = [x, v, torch.zeros((prog.h, prog.d), device=dev)]
    actions = []

    def step():
        out = prog.step(*state, prog.generator)
        state[:] = out[:3]
        actions.append(out[3].clone())
        return out

    before = fs.fused_packed_horizon.launches
    with trace.recording(4096):
        step()
        counters = trace.counters()
    made = aot.GraphedStep.WARMUP + 1
    b["launches"] = fs.fused_packed_horizon.launches - before
    require(b["launches"] == made
            and counters.get("plan.grid_scratch_bytes") == made * 4 * k * 2 * n,
            f"grid-fullfid: {b['launches']} launches, counters {counters}: {made} launches of "
            f"a {4 * k * 2 * n} B scratch")
    events = device_window(torch, step, GRID_FULLFID_STEPS, "horizon_kernel")
    kernel_ms = sum(e["dur"] for e in events if "horizon_kernel" in e["name"]) / 1e3
    times = synced_ms(torch, step, GRID_FULLFID_STEPS)
    acts = torch.stack(actions)
    require(bool(torch.isfinite(acts).all()), "grid-fullfid: non-finite actions")
    log(f"[grid-fullfid] {GRID_FULLFID_STEPS} captured control steps of {GRID_FULLFID_CELL}: "
        f"at the warm-up and capture {b['launches']} launches, counters {counters}; one "
        f"kernel 6 launch a replay, "
        f"{len(events) / GRID_FULLFID_STEPS:.0f} device ops a step, busy "
        f"{busy_ms(events) / GRID_FULLFID_STEPS:.4f} ms of which kernel 6 "
        f"{kernel_ms / GRID_FULLFID_STEPS:.4f} ms; ms per step (synchronised) "
        f"{_spread(times)}; max |action| per step "
        f"{[round(float(a.abs().max()), 6) for a in acts]}")


def run_twin_km32(torch, rows: dict) -> None:
    """Phase 4i: three control steps of the twin slice with plan_modes=32
    (the corrected variant beyond 16 modes: K=1024, a 10000-particle plan
    state, clusters of 2 CTAs, shared memory), one corrected launch per
    solve; then that launch against its plain version, timed."""
    from plasma_control_tpu_torch.control.mpc import draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _twin_setup(torch, dev, plan_modes=32)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    fns = _kernel_fns()
    _reset(fns)
    mean, times = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, act, gen, n_steps=1, mean0=mean)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        state, mean = out.final_state, out.final_mean
        require(bool(torch.isfinite(out.field_energy).all()), "twin Km=32: PE not finite")
    launches = _counts(fns)
    rows["spectral_horizon_twin_km32"]["launches"] = launches["spectral_horizon_twin"]
    require(launches["spectral_horizon_twin"] == launches["spectral_horizon"]
            == launches["twin_trajectory"] == 3,
            f"one corrected launch and one twin_trajectory launch per solve: {launches}")
    pst, _, pcfg, mpc, (tc, ts), _ = _twin_plan(torch, state, dev, plan_modes=32)
    ka, km = ctrl.max_mode, max(mpc.plan_modes, ctrl.max_mode)
    k, h, n = mpc.n_candidates, mpc.horizon, pcfg.n_particles
    rot = sh.use_rot(pcfg.clamped_dt(), pcfg.length, mpc.spectral_drift)
    cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, h, 2 * ka, device=dev), -1.0, 1.0)
    u_c, u_s = (torch.nn.functional.pad(u, (0, km - ka)) for u in (cand[..., :ka], cand[..., ka:]))
    kw = dict(length=pcfg.length, dt=pcfg.clamped_dt(), n0=pcfg.n0, n_particles=n, rot=rot,
              twin_c=tc, twin_s=ts)
    call = lambda: sh.spectral_horizon(pst.x, pst.v, u_c, u_s, **kw)  # noqa: E731
    got, ref = call(), sh.spectral_horizon_plain(pst.x, pst.v, u_c, u_s, **kw)
    torch.cuda.synchronize()
    require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), "twin Km=32 corrected vs plain")
    dev_ms, _ = device_ms(torch, call, "spectral_horizon", reps=10)
    rows["spectral_horizon_twin_km32"].update(
        max_abs_err=float((got - ref).abs().max()), device_ms=dev_ms,
        ms=time_ms(torch, call, reps=10),
        plain_ms=time_ms(torch, lambda: sh.spectral_horizon_plain(pst.x, pst.v, u_c, u_s, **kw),
                         reps=3),
        library_ms=None, **bound(spectral_ops(k, h, n, km, rot), spectral_bytes(k, h, n, km, True)),
    )
    b = rows["spectral_horizon_twin_km32"]
    log(f"[twin-km32] 3 control steps of the twin slice at plan_modes=32: ms per step "
        f"{', '.join(f'{t:.4f}' for t in times)}; launches {launches}; corrected kernel at K={k}, "
        f"H={h}, Km={km}, N={n} ({sh.launch_geometry(n, rot, km)}): max |err| "
        f"{b['max_abs_err']:.3g} (rtol 2e-4); kernel {b['ms']:.4f} ms, device {dev_ms:.5f} ms, "
        f"plain {b['plain_ms']:.4f} ms; bound {b['bound_ms']:.6f} ms ({b['bound_by']}) = "
        f"{100 * b['bound_ms'] / dev_ms:.2f} % on the device")


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
        noise = torch.stack([draw_noise(gen, mpc, mpc.horizon, d, device="cpu") for _ in range(3)])
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


def _twin_setup(torch, device, **mpc_kw):
    return _setup(torch, device, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE, mpc=dict(TWIN_MPC, **mpc_kw))


def _twin_plan(torch, state, device, **mpc_kw):
    """The twin slice's plan model at ``state``: (plan state, plan grid, plan
    config, MPC config, targets, plan actuator)."""
    from plasma_control_tpu_torch.control.mpc import _actuator_cache, _plan_model, twin_targets

    cfg, ctrl, mpc, grid, _ = _twin_setup(torch, device, **mpc_kw)
    pst, pgrid, pcfg = _plan_model(state, grid, cfg, mpc)
    target = twin_targets(state.x, pst, pcfg, cfg, ctrl, mpc)
    pact = _actuator_cache(pcfg.length, pgrid.n_mesh, ctrl.max_mode, torch.float32, device)
    return pst, pgrid, pcfg, mpc, target, pact


def check_twin_kernel(torch, rows: dict) -> None:
    """Phase 3, third part: kernel 1's twin-corrected variant against its
    plain version at the twin slice's plan model and at N=20000, timed;
    kernel 7, the targets, against its plain version at the slice's shapes,
    timed; and the zero-drive identity on the trig drift."""
    from plasma_control_tpu_torch.control.mpc import draw_noise
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state
    from plasma_control_tpu_torch.ops import spectral
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh
    from plasma_control_tpu_torch.ops.kernels import twin_trajectory as tt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    cfg, ctrl, mpc, _, _ = _twin_setup(torch, dev)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pst, _, pcfg, mpc, (tc, ts), _ = _twin_plan(torch, state, dev)
    ka, km = ctrl.max_mode, max(mpc.plan_modes, ctrl.max_mode)
    k, h, n = mpc.n_candidates, mpc.horizon, pcfg.n_particles
    cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, h, 2 * ka, device=dev), -1.0, 1.0)
    u_c, u_s = (torch.nn.functional.pad(u, (0, km - ka)) for u in (cand[..., :ka], cand[..., ka:]))
    kw = dict(length=pcfg.length, dt=pcfg.clamped_dt(), n0=pcfg.n0, n_particles=n)

    # both drifts at the slice's plan model and at N=20000: mode sums reduced
    # in another order, rtol 2e-4 as for the plain energies
    n2, k2 = 20_000, 64
    x2 = torch.rand(n2, generator=gen, device=dev) * pcfg.length
    v2 = 1.5 * torch.randn(n2, generator=gen, device=dev)
    tc2, ts2 = (n2 ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
    cases = {"slice": (pst.x, pst.v, u_c, u_s, dict(twin_c=tc, twin_s=ts, n_particles=n)),
             "N=20000": (x2, v2, u_c[:k2], u_s[:k2], dict(twin_c=tc2, twin_s=ts2, n_particles=n2))}
    err = 0.0
    for where, (x, v, uc, us, extra) in cases.items():
        nn = extra["n_particles"]
        for rot in (True, False):
            require(sh.state_in_shared(nn, rot), f"{where}: state in shared memory")
            args = dict(kw, rot=rot, **extra)
            before = sh.spectral_horizon.twin_launches
            got = sh.spectral_horizon(x, v, uc, us, **args)
            ref = sh.spectral_horizon_plain(x, v, uc, us, **args)
            torch.cuda.synchronize()
            require(sh.spectral_horizon.twin_launches == before + 1, "corrected launch counted")
            require(bool(torch.isfinite(got).all()), f"corrected {where} rot={rot}: non-finite")
            require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6), f"corrected {where} rot={rot}")
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
            err = max(err, float((got - ref).abs().max()))
            log(f"[kernels] spectral_horizon_twin {'rot' if rot else 'trig'}, {where} (K={uc.shape[0]}, "
                f"H={h}, Km={km}, N={nn}, {sh.launch_geometry(nn, rot)}): max |err| "
                f"{float((got - ref).abs().max()):.3g}, max rel {rel:.3g} (rtol 2e-4)")
    args = dict(kw, rot=sh.use_rot(pcfg.clamped_dt(), pcfg.length, mpc.spectral_drift),
                twin_c=tc, twin_s=ts)
    twin_call = lambda: sh.spectral_horizon(pst.x, pst.v, u_c, u_s, **args)  # noqa: E731
    require(torch.equal(twin_call(), twin_call()), "corrected spectral_horizon: two launches differ")
    dev_ms, ops = device_ms(torch, twin_call, "spectral_horizon_kernel", reps=10)
    require(ops == 1, f"corrected spectral_horizon: {ops:.3g} device ops per call")
    rows["spectral_horizon_twin"].update(
        max_abs_err=err, device_ms=dev_ms,
        ms=time_ms(torch, twin_call, reps=10),
        plain_ms=time_ms(torch, lambda: sh.spectral_horizon_plain(pst.x, pst.v, u_c, u_s, **args),
                         reps=3),
        library_ms=None,
        **bound(spectral_ops(k, h, n, km, args["rot"]), spectral_bytes(k, h, n, km, twin=True)),
    )
    log(f"[kernels] spectral_horizon_twin at the slice's plan model ({'rot' if args['rot'] else 'trig'}, "
        f"{sh.launch_geometry(n, args['rot'])}): kernel {rows['spectral_horizon_twin']['ms']:.4f} ms, "
        f"device {dev_ms:.5f} ms, plain {rows['spectral_horizon_twin']['plain_ms']:.4f} ms per call; "
        f"one device op per call, two launches bitwise equal")

    # kernel 2 at the twin slice's environment: N=100000, M=256
    check_deposit(torch, rows, "deposit_cic_twin", cfg.n_particles, cfg.n_mesh, cfg.length, gen)

    # kernel 7, the targets themselves, at the slice's shapes (N=100000, its
    # stride-10 plan subsample): against the plain version in float32 and,
    # as the sums are added in another order, no further from the float64
    # plain version than twice the float32 one
    tkw = dict(n_modes=km, horizon=h, length=pcfg.length, dt=pcfg.clamped_dt(), n0=pcfg.n0,
               n_full=cfg.n_particles, n_plan=n)
    twin_call = lambda: tt.twin_trajectory(state.x, pst.x, pst.v, **tkw)  # noqa: E731
    plain_call = lambda: tt.twin_trajectory_plain(state.x, pst.x, pst.v, **tkw)  # noqa: E731
    got, ref = twin_call(), plain_call()
    ref64 = tt.twin_trajectory_plain(state.x.double(), pst.x.double(), pst.v.double(), **tkw)
    top = max(float(t.abs().max()) for t in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    err64, plain64 = (max(float((a.double() - b).abs().max()) for a, b in zip(side, ref64))
                      for side in (got, ref))
    require(err64 <= 2.0 * plain64, f"twin_trajectory: {err64} from float64, plain {plain64}")
    require(all(torch.equal(a, b) for a, b in zip(got, twin_call())),
            "twin_trajectory: two launches differ")
    dev_ms, ops = device_ms(torch, twin_call, "twin_trajectory_kernel", reps=20)
    require(ops == 1, f"twin_trajectory: {ops:.3g} device ops per call")
    rows["twin_trajectory"].update(
        max_abs_err=err, device_ms=dev_ms, ms=time_ms(torch, twin_call),
        plain_ms=time_ms(torch, plain_call, reps=10), library_ms=None,
        **bound(twin_ops(cfg.n_particles, n, h, km), twin_bytes(cfg.n_particles, n, h, km)),
    )
    b = rows["twin_trajectory"]
    log(f"[kernels] twin_trajectory at the twin slice (N={cfg.n_particles}, n={n} at stride "
        f"{pst.x.stride(0)}, H={h}, Km={km}, {tt.launch_geometry(cfg.n_particles, n)}): max "
        f"|err| {err:.3g}, max rel {err / top:.3g} of the largest target {top:.6g}; from float64 "
        f"{err64:.3g} against the float32 plain version's {plain64:.3g} (bar: twice); kernel "
        f"{b['ms']:.4f} ms, device {dev_ms:.5f} ms per launch, bound {b['bound_ms']:.6f} ms "
        f"({b['bound_by']}) = {100 * b['bound_ms'] / dev_ms:.2f} %, plain {b['plain_ms']:.4f} ms; "
        f"one device op per call, two launches bitwise equal")

    # zero drive on the trig drift, where the kernel's drift is the twin's:
    # the candidate's phasor is the twin's (c0, s0), the target rho (c0, s0),
    # so its corrected energy is pe_scale sum_m lambda_m^2 (c0^2 + s0^2) / k_m^2.
    # lambda from the full state in float64 (cos(m k1 x) directly), at a
    # coherent two-stream state where mode 1 carries lambda ~ 1
    coh = coherent_state(torch, cfg.n_particles, cfg.length, seed=12)
    coh = PlasmaState(coh.x.to(dev), coh.v.to(dev))
    pst, _, pcfg, mpc, (tc, ts), _ = _twin_plan(torch, coh, dev)
    zero = torch.zeros((1, h, km), device=dev)
    got = sh.spectral_horizon(pst.x, pst.v, zero, zero, rot=False, twin_c=tc, twin_s=ts, **kw)[0]
    c0, s0 = spectral.rollout(pst.x, pst.v, zero[0], zero[0], rot=False, **kw)
    kv = (2.0 * math.pi / cfg.length) * torch.arange(1, km + 1, dtype=torch.float64, device=dev)
    ang = kv[:, None] * coh.x.double()[None, :]
    sig2 = torch.clamp(torch.cos(ang).sum(-1) ** 2 + torch.sin(ang).sum(-1) ** 2 - cfg.n_particles,
                       min=0.0)
    r = n / cfg.n_particles
    lam = r * r * sig2 / (r * r * sig2 + n * (1.0 - r))
    want = (pcfg.n0 ** 2 / n) * ((lam ** 2) * (c0.double() ** 2 + s0.double() ** 2) / kv ** 2).sum(-1)
    rel = float(((got.double() - want).abs() / want.abs()).max())
    require(rel <= 1e-4, f"zero-drive identity: max rel {rel}")
    log(f"[kernels] spectral_horizon_twin trig, zero drive at a coherent state (lambda_1 "
        f"{float(lam[0]):.6f}), the targets from twin_trajectory: corrected PE = pe_scale sum "
        f"lambda^2 (c0^2 + s0^2) / k^2 to max rel {rel:.3g} (rtol 1e-4)")


# kernel 8 at the two guarded slices' full states: (row, N, Km, frac, cell of
# benchmark/ whose steps/s [guard] reports)
GUARD_SLICES = (("fidelity_ratio", 100_000, 16, 0.1, "two_stream_n100k.mpc_twin_graph"),
                ("fidelity_ratio_grid", 5000, 16, 0.25, "bump_on_tail_n5k.mpc_grid_graph"))
GUARD_STEPS = 2000  # replayed steps per timed run, four 500-step episodes
GUARD_SEED = 2_718_281_828


def check_guard_kernel(torch, rows: dict) -> None:
    """``[guard]``: kernel 8 at the twin and grid slices' full states, from a
    coherent two-stream state (the guard's ratio well above 0): against the
    plain version in float32 and, as its sums are added in another order, no
    further from the float64 plain version than twice the float32 one (one
    float32 rounding of the ratio the least bar); two launches bitwise equal;
    one device op per call; CUDA-event and device time beside the bound, and
    the plain version's time and device ops per call."""
    from plasma_control_tpu_torch.ops.kernels import fidelity_ratio as fr

    dev = torch.device("cuda")
    for row, n, km, frac, _ in GUARD_SLICES:
        x = coherent_state(torch, n, 50.0, seed=13, amplitude=0.2).x.to(dev)
        injected = sum((1.0 - frac) / (2.0 * math.pi * m / 50.0) ** 2 for m in range(1, km + 1))
        kw = dict(n_modes=km, length=50.0, n0=1.0, n_particles=n, frac=frac, injected=injected)
        call = lambda: fr.fidelity_ratio(x, **kw)  # noqa: E731
        plain = lambda: fr.fidelity_ratio_plain(x, **kw)  # noqa: E731
        got, ref = float(call()), float(plain())
        ref64 = float(fr.fidelity_ratio_plain(x.double(), **kw))
        err64, plain64 = abs(got - ref64), abs(ref - ref64)
        least = float(torch.finfo(torch.float32).eps) * abs(ref64)
        require(err64 <= 2.0 * max(plain64, least),
                f"{row}: {err64} from float64, plain float32 {plain64}")
        require(torch.equal(call(), call()), f"{row}: two launches differ")
        dev_ms, ops = device_ms(torch, call, "fidelity_ratio_kernel", reps=20)
        require(ops == 1, f"{row}: {ops:.3g} device ops per call")
        plain_dev_ms, plain_ops = device_ms(torch, plain, None, reps=20)
        rows[row].update(max_abs_err=abs(got - ref), device_ms=dev_ms, ms=time_ms(torch, call),
                         plain_ms=time_ms(torch, plain), library_ms=None,
                         **bound(guard_ops(n, km), guard_bytes(n)))
        b = rows[row]
        log(f"[guard] {row} (N={n}, Km={km}, frac {frac}, {fr.launch_ctas(n)} CTAs): ratio "
            f"{got:.7g}, plain {ref:.7g}, float64 {ref64:.7g}; from float64 {err64:.3g} against "
            f"the float32 plain version's {plain64:.3g} (bar: twice, at least {least:.3g}); "
            f"kernel {b['ms']:.4f} ms, device {dev_ms:.5f} ms per launch, bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}) = {100 * b['bound_ms'] / dev_ms:.2f} %; "
            f"plain {b['plain_ms']:.4f} ms, device {plain_dev_ms:.5f} ms in {plain_ops:.0f} "
            f"device ops per call; one device op per call, two launches bitwise equal")


def guard_cell_steps(cell_name: str, steps: int, seed: int) -> dict:
    """One side of ``[guard]``'s turns, in its own process run from the root
    of a checkout: that checkout's program for the benchmark cell (the
    captured step), a warm-up episode of 6 steps (the capture), then
    ``steps`` steps in 500-step episodes from the cell's start states,
    timed on the host clock up to a synchronise."""
    import os

    sys.path.insert(0, os.getcwd())
    import torch

    import plasma_control_tpu_torch
    from benchmark import harness, sampler
    from benchmark.cell import load_cell

    cell = load_cell(cell_name, Path(os.getcwd()))
    prog = harness.Program(cell, "cuda")
    p = prog.p
    states = sampler.start_states(cell.sim, seed, cell.traffic["start_states"], "cuda")
    gen = prog.generator
    episode = cell.traffic["episode_steps"]

    def run(state, count):
        return p["aot"].aot_mpc_rollout(prog.step, p["PlasmaState"](*state), gen, count,
                                        prog.h, prog.d)

    gen.manual_seed(seed)
    run(states[-1], cell.traffic["warmup_steps"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(steps // episode):
        run(states[e % len(states)], episode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"cell": cell_name, "steps_per_s": steps / wall, "steps": steps,
            "package": str(Path(plasma_control_tpu_torch.__file__).parent)}


def run_guard_turns(torch, parent: str | None) -> None:
    """``[guard]``: the twin and grid graph cells' control steps/s, each run
    in a fresh process (``--guard-steps``); with ``parent``, the checkout
    there and this one in turns (parent, this, this, parent)."""
    sides = [("parent", Path(parent).resolve()), ("change", ROOT), ("change", ROOT),
             ("parent", Path(parent).resolve())] if parent else [("change", ROOT)]
    for _, _, _, _, cell in GUARD_SLICES:
        got = {}
        for side, root in sides:
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--guard-steps",
                                  cell, str(GUARD_STEPS), str(GUARD_SEED)],
                                 cwd=root, capture_output=True, text=True, timeout=900)
            require(out.returncode == 0, f"[guard] {side} {cell}: {out.stdout[-2000:]}"
                    f"{out.stderr[-4000:]}")
            line = json.loads(out.stdout.strip().splitlines()[-1])
            require(Path(line["package"]).parent == root,
                    f"[guard] {side} {cell} imported {line['package']}")
            got.setdefault(side, []).append(line["steps_per_s"])
        log(f"[guard] {cell}: control steps/s over {GUARD_STEPS} replayed steps, in turns: "
            + "; ".join(f"{side} {', '.join(f'{v:.2f}' for v in vals)}"
                        for side, vals in got.items()))


def check_global_scratch(torch) -> None:
    """Phase 3, fourth part: kernel 1's global-scratch variant, which runs
    where a cluster of 16 CTAs cannot hold the state: N=320000 at K=32,
    H=10, Km=16, both drifts, the plain and the corrected energy, against
    the plain version to rtol 2e-4."""
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    n, k, h, km, length = 320_000, 32, 10, 16, SIM["length"]
    x = torch.rand(n, generator=gen, device=dev) * length
    v = 1.5 * torch.randn(n, generator=gen, device=dev)
    u_c = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    u_s = 0.3 * torch.randn((k, h, km), generator=gen, device=dev)
    tc, ts = (n ** 0.5 * torch.randn((h, km), generator=gen, device=dev) for _ in range(2))
    for rot in (True, False):
        geo = sh.launch_geometry(n, rot)
        require(geo.shared_bytes == 0 and geo.cluster == 16, f"N={n}: {geo}")
        for twin in (False, True):
            kw = dict(length=length, dt=0.1, n0=1.0, n_particles=n, rot=rot,
                      twin_c=tc if twin else None, twin_s=ts if twin else None)
            got = sh.spectral_horizon(x, v, u_c, u_s, **kw)
            ref = sh.spectral_horizon_plain(x, v, u_c, u_s, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"global scratch rot={rot} twin={twin}: non-finite")
            require(torch.allclose(got, ref, rtol=2e-4, atol=1e-6),
                    f"global scratch rot={rot} twin={twin} vs plain")
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-6)).max())
            call = lambda: sh.spectral_horizon(x, v, u_c, u_s, **kw)  # noqa: E731
            dev_ms, _ = device_ms(torch, call, "spectral_horizon_kernel", reps=5)
            b = bound(spectral_ops(k, h, n, km, rot), spectral_bytes(k, h, n, km, twin=twin))
            log(f"[global] spectral_horizon{'_twin' if twin else ''} {'rot' if rot else 'trig'}, "
                f"state in a global scratch ({geo}): K={k}, H={h}, Km={km}, N={n}: max rel "
                f"{rel:.3g} (rtol 2e-4); kernel {time_ms(torch, call, reps=5):.4f} ms, device "
                f"{dev_ms:.4f} ms, plain "
                f"{time_ms(torch, lambda: sh.spectral_horizon_plain(x, v, u_c, u_s, **kw), reps=2):.4f}"
                f" ms; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")


def run_twin_slice(torch, rows: dict) -> None:
    """Phase 4f: the twin slice's 500 control steps, run as five 100-step
    segments (each continues the last one's state, nominal and generator, so
    together they are one 500-step run) to see where the host time goes, and
    the uncontrolled rollout from the same seeded state."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _twin_setup(torch, dev)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    steps = cfg.n_steps
    mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev), n_steps=3)

    gen = torch.Generator(device=dev).manual_seed(6)
    st, mean, outs, seg_ms = state, None, [], []
    fns = _kernel_fns()
    _reset(fns)
    for _ in range(steps // 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg = mpc_rollout(st, grid, cfg, ctrl, mpc, act, gen, n_steps=100, mean0=mean)
        torch.cuda.synchronize()
        seg_ms.append(1e3 * (time.perf_counter() - t0) / 100)
        st, mean = seg.final_state, seg.final_mean
        outs.append(seg)
    launches = _counts(fns)
    wall = sum(seg_ms) * 100 / 1e3
    field_energy = torch.cat([o.field_energy for o in outs])
    coeffs = torch.cat([o.coeffs for o in outs])
    plan_cost = torch.cat([o.plan_cost for o in outs])
    rows["spectral_horizon_twin"]["launches"] = launches["spectral_horizon_twin"]
    rows["deposit_cic_twin"]["launches"] = launches["deposit_cic"]
    rows["gather_cic_100k"]["launches"] = launches["gather_cic"]
    rows["twin_trajectory"]["launches"] = launches["twin_trajectory"]
    rows["fidelity_ratio"]["launches"] = launches["fidelity_ratio"]
    log(f"[twin] {steps} control steps; kernel launches in the controlled run: {launches}")
    require(launches["spectral_horizon"] == launches["spectral_horizon_twin"]
            == launches["twin_trajectory"] == launches["fidelity_ratio"] == steps,
            "one corrected spectral_horizon, twin_trajectory and fidelity_ratio launch per solve")
    require(launches["fused_leapfrog_step"] == launches["fused_kdk_horizon"]
            == launches["fused_packed_horizon"] == 0, "no grid planner kernel")
    require(launches["gather_cic"] == 3 * steps, "three gathers per Yoshida-4 step")
    require(launches["deposit_cic"] >= 5 * steps, "five deposits per control step")

    t1 = time.perf_counter()
    base = rollout(state, grid, cfg)
    torch.cuda.synchronize()
    wall_base = time.perf_counter() - t1
    require(field_energy.shape == (steps,), "twin slice: trace shape")
    for name, t in (("controlled PE", field_energy), ("uncontrolled PE", base.field_energy),
                    ("applied coefficients", coeffs), ("plan cost", plan_cost)):
        require(bool(torch.isfinite(t).all()), f"twin slice: {name} not finite")
    passed = (coeffs != 0).any(-1)
    log(f"[twin] fidelity guard let {int(passed.sum())} of {steps} solves through (the others "
        f"applied no drive); per 100-step segment {[int(p.sum()) for p in passed.split(100)]}")
    log(f"[twin] tail PE (mean of last 20 steps): controlled {float(field_energy[-20:].mean()):.6g}, "
        f"uncontrolled {float(base.field_energy[-20:].mean()):.6g}")
    log(f"[twin] controlled loop: {wall:.3f} s wall, {1e3 * wall / steps:.4f} ms per control step "
        f"(host clock, synchronised at the segment ends), {steps / wall:.2f} control steps/s; per "
        f"100-step segment {', '.join(f'{t:.4f}' for t in seg_ms)} ms/step; uncontrolled push "
        f"{1e3 * wall_base / steps:.4f} ms/step")


def run_entry_point(torch) -> None:
    """Phase 4g: the port's run_mpc entry point with the twin slice's flags
    for 50 steps, the CLI's dense deposit, saving its run."""
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch import run_mpc
    from plasma_control_tpu_torch.io.export import load_run

    fns = _kernel_fns()
    with tempfile.TemporaryDirectory() as tmp:
        argv = TWIN_FLAGS + ["--t_max", "5", "--is_save", "--save_file", f"{tmp}/data",
                             "--save_plot", f"{tmp}/plots"]
        _reset(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_mpc.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fns)
        run = load_run(f"{tmp}/data/two-stream/mpc-control/data.npz")
    log(f"[entry] python -m plasma_control_tpu_torch.run_mpc {' '.join(argv[:-4])} ...: "
        f"{wall:.3f} s wall (closed loop, replay, cost traces, saving); launches {launches}")
    require(launches["spectral_horizon"] == launches["spectral_horizon_twin"]
            == launches["twin_trajectory"] == ENTRY_STEPS,
            "one corrected spectral_horizon and one twin_trajectory launch per solve of the "
            "entry point")
    require(run["snapshot"].shape == (2 * CFG4_SIM["n_particles"], ENTRY_STEPS + 1),
            f"snapshot shape {run['snapshot'].shape}")
    require(bool(np.isfinite(run["PE"]).all()), "entry point: PE not finite")
    for key in (r"$J_{KL}$", r"$J_{ee}$", r"$J_{ie}$"):
        trace = run["cost"][key]
        require(trace.shape == (ENTRY_STEPS,) and bool(np.isfinite(trace).all()),
                f"entry point: {key} trace")
    log(f"[entry] data.npz: snapshot {run['snapshot'].shape}, tail PE {float(run['PE'][-5:].mean()):.6g}, "
        f"J_KL[-1] {float(run['cost'][r'$J_{KL}$'][-1]):.6g}, J_ee[-1] "
        f"{float(run['cost'][r'$J_{ee}$'][-1]):.6g}, J_ie sum {float(run['cost'][r'$J_{ie}$'].sum()):.6g}")


def run_feedback(torch) -> None:
    """Phase 4j: ``feedback_rollout`` at config-4's environment (two-stream,
    N=100000, M=256, max_mode 8, CIC kernels), all 500 steps from the seeded
    state the twin slice's uncontrolled rollout starts from, one step per
    call with the card synchronised after each (the law depends on the state
    only, so the calls chain into one 500-step run): five launches of kernel
    2 and three of kernel 3 per step; then the uncontrolled rollout from the
    same state."""
    from plasma_control_tpu_torch.control.feedback import feedback_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, ctrl, _, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    steps = cfg.n_steps
    feedback_rollout(state, grid, cfg, ctrl, act, n_steps=3)  # warm-up
    fns = _kernel_fns()
    _reset(fns)
    st, outs, times = state, [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = feedback_rollout(st, grid, cfg, ctrl, act, n_steps=1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        st = out.final_state
        outs.append(out)
    launches = _counts(fns)
    pe = torch.cat([o.field_energy for o in outs])
    ie = torch.cat([o.input_energy for o in outs])
    log(f"[feedback] {steps} steps at N={cfg.n_particles}, M={cfg.n_mesh}, max_mode "
        f"{ctrl.max_mode}; launches {launches}")
    require(launches["deposit_cic"] == 5 * steps and launches["gather_cic"] == 3 * steps,
            "five deposits and three gathers per feedback step")
    require(sum(launches.values()) == 8 * steps, "no other kernel in the feedback loop")
    base = rollout(state, grid, cfg)
    require(pe.shape == ie.shape == (steps,), "feedback traces' shape")
    for name, t in (("feedback PE", pe), ("input energy", ie), ("uncontrolled PE", base.field_energy)):
        require(bool(torch.isfinite(t).all()), f"{name} not finite")
    log(f"[feedback] ms per step (synchronised each step): median {statistics.median(times):.4f}, "
        f"min {min(times):.4f}, max {max(times):.4f}; {steps / (sum(times) / 1e3):.2f} steps/s")
    log(f"[feedback] tail PE (mean of last 20 steps): feedback {float(pe[-20:].mean()):.6g}, "
        f"uncontrolled {float(base.field_energy[-20:].mean()):.6g}; input energy: total "
        f"{float(ie.sum()):.6g}, mean per step {float(ie.mean()):.6g}")


def run_damping(torch, rows: dict) -> None:
    """Phase 4k: bench_scaling.py's "2-controller-damping" row through the
    port at its full shapes (DAMPING_*: bump-on-tail, N=10000, M=128, 300
    steps, max_mode 3; MPC K=384, H=6, Km=8, w_terminal 4; CIC kernels):
    uncontrolled, feedback and MPC from the reference's own state (the JAX
    package's ``init_state(cfg, PRNGKey(0))``, handed across in
    ``diag/quality.py``'s states file). The uncontrolled and feedback runs
    are deterministic given the state: their tail PE (mean of the last 60,
    bench_scaling.py:138) is held to SCALING_r05.json's within the fp32-chaos
    bound (``quality.PAIRED_RTOL``); the MPC tail is reported beside the
    reference's (one unpaired seed). The decay-phase gamma and the time to
    stay below 2x the MPC floor are reported; the launch counts and
    finiteness are asserted."""
    import numpy as np

    from plasma_control_tpu_torch.control.feedback import feedback_rollout
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.diag import quality
    from plasma_control_tpu_torch.diag.landau import damping_rate_decay_phase, time_to_pe_threshold
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=DAMPING_SIM, max_mode=DAMPING_MAX_MODE,
                                       mpc=DAMPING_MPC)
    (state,) = quality.reference_states("damping", device=dev)
    require(state.x.shape == (cfg.n_particles,), "[damping] reference state's shape")
    steps = cfg.n_steps
    fns = _kernel_fns()
    runs, walls = {}, {}
    rows["deposit_cic_damping"]["launches"] = rows["gather_cic_damping"]["launches"] = 0
    for name in ("uncontrolled", "feedback", "mpc"):
        _reset(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "uncontrolled":
            pe = rollout(state, grid, cfg).field_energy[1:]
        elif name == "feedback":
            pe = feedback_rollout(state, grid, cfg, ctrl, act).field_energy
        else:
            pe = mpc_rollout(state, grid, cfg, ctrl, mpc, act,
                             torch.Generator(device=dev).manual_seed(1)).field_energy
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches = _counts(fns)
        require(pe.shape == (steps,) and bool(torch.isfinite(pe).all()), f"[damping] {name} PE")
        want = {"uncontrolled": (4 * steps + 1, 3 * steps, 0), "feedback": (5 * steps, 3 * steps, 0),
                "mpc": (None, 3 * steps, steps)}[name]
        got = (launches["deposit_cic"], launches["gather_cic"], launches["spectral_horizon"])
        require(all(w is None or w == g for w, g in zip(want, got)),
                f"[damping] {name}: launches (deposit, gather, spectral_horizon) {got}, want {want}")
        rows["deposit_cic_damping"]["launches"] += got[0]
        rows["gather_cic_damping"]["launches"] += got[1]
        log(f"[damping] {name}: {steps} steps, {1e3 * walls[name] / steps:.4f} ms per step; "
            f"launches {launches}")
        runs[name] = pe.cpu().numpy()
    ts = np.linspace(0.0, cfg.t_max, steps)
    thresh = 2.0 * quality.damping_tail(runs["mpc"])
    ref = quality.damping_reference()
    for name, pe in runs.items():
        t_below = time_to_pe_threshold(ts, pe, thresh)
        log(f"[damping] {name}: decay-phase gamma {damping_rate_decay_phase(ts, pe):.6g}, time to "
            f"stay below 2x the MPC floor ({thresh:.6g}) {t_below:.4g}, tail PE (mean of last 60) "
            f"{quality.damping_tail(pe):.6g}, reference {ref[name]}")
    paired = ("uncontrolled", "feedback")
    gate = quality.paired_gate([quality.damping_tail(runs[n]) for n in paired],
                               [ref[n] for n in paired])
    log(f"[damping] paired gate on the reference's state, {' / '.join(paired)}: rel diff "
        f"{' / '.join(f'{r:.3g}' for r in gate.rel)} (bound {quality.PAIRED_RTOL}); MPC "
        f"reported, not gated (one unpaired seed)")
    require(gate.ok, "[damping] uncontrolled or feedback tail PE off the reference's beyond "
                     "the fp32-chaos bound")


def run_batch(torch) -> None:
    """Phase 4l: ``rollout_batch`` of B=8 seeded config-4 states (N=100000,
    M=256, CIC kernels) under eight drives for 20 steps: one launch of
    kernel 2 per batched deposit (the initial energies, then 4 per step) and
    of kernel 3 per batched gather (3 per step); each row against its own
    single rollout, PE at step 20 within 1e-5 relative (the batched solve is
    a GEMM where a single one is a GEMV), bitwise equality reported."""
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state
    from plasma_control_tpu_torch.models.rollout import rollout, rollout_batch

    dev = torch.device("cuda")
    cfg, ctrl, _, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE)
    rows = [init_state(cfg, torch.Generator(device=dev).manual_seed(100 + b), device=dev)
            for b in range(BATCH)]
    states = PlasmaState(torch.stack([r.x for r in rows]), torch.stack([r.v for r in rows]))
    gen = torch.Generator(device=dev).manual_seed(9)
    trajs = act.compute_e_packed(0.2 * torch.randn((BATCH, BATCH_STEPS, 2 * ctrl.max_mode),
                                                   generator=gen, device=dev))
    rollout_batch(states, grid, cfg, trajs, n_steps=2)  # warm-up
    fns = _kernel_fns()
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rollout_batch(states, grid, cfg, trajs, n_steps=BATCH_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fns)
    log(f"[batch] rollout_batch B={BATCH}, N={cfg.n_particles}, M={cfg.n_mesh}, {BATCH_STEPS} "
        f"steps: {1e3 * wall / BATCH_STEPS:.4f} ms per step; launches {launches}")
    require(launches["deposit_cic"] == 4 * BATCH_STEPS + 1
            and launches["gather_cic"] == 3 * BATCH_STEPS,
            "one deposit launch per batched deposit, one gather launch per batched gather")
    require(out.field_energy.shape == (BATCH, BATCH_STEPS + 1)
            and bool(torch.isfinite(out.field_energy).all()), "batched PE")
    singles = [rollout(rows[b], grid, cfg, trajs[b], n_steps=BATCH_STEPS) for b in range(BATCH)]
    pe1 = torch.stack([o.field_energy for o in singles])
    rel = float(((out.field_energy[:, -1] - pe1[:, -1]).abs() / pe1[:, -1].abs()).max())
    same = torch.equal(out.field_energy, pe1) and all(
        torch.equal(out.final_state.x[b], singles[b].final_state.x) for b in range(BATCH))
    require(rel <= 1e-5, f"[batch] PE at step {BATCH_STEPS}: max rel {rel:.3g} against the singles")
    log(f"[batch] against the eight single rollouts: PE at step {BATCH_STEPS} max rel {rel:.3g} "
        f"(tolerance 1e-5); bitwise equal: {same}")


def run_golden(torch) -> None:
    """Phase 4m: the reference DDPG controller's recorded two-stream run
    (tests/data/ddpg_golden_two_stream.npz) replayed through the port's
    ``rollout(e_external_traj=...)`` on the card with the CIC kernels: PE(0)
    within 1e-5 and all 499 steps within the JAX golden test's 1 %."""
    import os

    import numpy as np

    from plasma_control_tpu_torch.config import SimConfig
    from plasma_control_tpu_torch.interop import state_from_numpy, tensor_from_numpy
    from plasma_control_tpu_torch.models.rollout import rollout
    from plasma_control_tpu_torch.ops.grid import make_grid

    root = os.path.dirname(os.path.abspath(__file__))
    d = np.load(os.path.join(root, "tests", "data", f"ddpg_golden_{GOLDEN_CASE}.npz"))
    n_mesh, length, dt = int(d["n_mesh"]), float(d["length"]), float(d["dt"])
    steps = int(d["pe"].shape[0]) - 1
    cfg = SimConfig(simcase=str(d["simcase"]), n_particles=int(d["n_particles"]), n_mesh=n_mesh,
                    dt=dt, t_max=dt * steps, length=length, deposit_method="pallas")
    # actuator fields of replay steps 1..T-1 on the reference's endpoint mesh
    cc, cs = d["coeff_cos"], d["coeff_sin"]
    k = 2.0 * np.pi / length * np.arange(1, cc.shape[0] + 1)
    xm = np.linspace(0.0, length, n_mesh)
    e_traj = (np.cos(np.outer(xm, k)) @ cc[:, 1:] + np.sin(np.outer(xm, k)) @ cs[:, 1:]).T
    dev = torch.device("cuda")
    fns = _kernel_fns()
    _reset(fns)
    out = rollout(state_from_numpy(d["x0"], d["v0"], device=dev), make_grid(n_mesh, length, device=dev),
                  cfg, e_external_traj=tensor_from_numpy(e_traj, device=dev), n_steps=steps)
    pe = out.field_energy.cpu().numpy()
    launches = _counts(fns)
    ref = d["pe"]
    rel0 = abs(pe[0] - ref[0]) / abs(ref[0])
    rel = np.abs(pe[1:] - ref[1:]) / np.abs(ref[1:])
    log(f"[golden] {GOLDEN_CASE}: {steps} replay steps at N={cfg.n_particles}, M={n_mesh}; "
        f"launches {launches}; PE(0) rel {rel0:.3g} (1e-5), max rel over the trace "
        f"{rel.max():.4g} at step {int(rel.argmax()) + 1} (0.01)")
    require(launches["deposit_cic"] == 4 * steps + 1 and launches["gather_cic"] == 3 * steps,
            "[golden] the replay runs on kernels 2-3")
    require(rel0 < 1e-5 and rel.max() < 0.01, "[golden] PE trace against the reference's")


def run_entry_scripts(torch) -> None:
    """Phase 4n: ``main()`` of the port's uncontrolled, feedback and LQR
    entry points at their CLI defaults (two-stream, N=5000, M=250, 500
    steps, dense deposit; LQR identification 6 x 150 steps) with
    ``--is_save`` into a git-ignored directory, removed afterwards: each
    writes a data.npz with finite PE."""
    import importlib
    import os
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch.io.export import load_run

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataset")
    os.makedirs(data, exist_ok=True)
    fns = _kernel_fns()
    for phase, module, tag in ENTRY_SCRIPTS:
        script = importlib.import_module(f"plasma_control_tpu_torch.{module}")
        with tempfile.TemporaryDirectory(dir=data) as tmp:
            argv = ["--is_save", "--save_file", f"{tmp}/data", "--save_plot", f"{tmp}/plots"]
            _reset(fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            script.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = load_run(f"{tmp}/data/two-stream/{tag}/data.npz")
        steps = run["snapshot"].shape[1] - 1
        require(run["snapshot"].shape == (10000, 501) and bool(np.isfinite(run["PE"]).all()),
                f"[entry-{phase}] data.npz: snapshot {run['snapshot'].shape}, PE finite")
        log(f"[entry-{phase}] python -m plasma_control_tpu_torch.{module} (CLI defaults, "
            f"--is_save): {wall:.3f} s wall, {steps} steps; tail PE (mean of last 20) "
            f"{float(np.mean(run['PE'][-20:])):.6g}; launches {_counts(fns)}")


def check_twin_against_cpu(torch) -> None:
    """Phase 5, third part: the twin slice on the card against the CPU, where
    every wrapper runs its plain version (``plan_kernel="fused"`` on both
    sides, so both run kernel 1's arithmetic with the rot drift), with the
    same states, candidates and noise: one corrected block of 128 candidates
    at the slice's seeded initial state, and three control steps at K=64
    with the fidelity guard off. On that quiet state the corrected cost
    ranks the zero drive first, so the loop starts from a coherent
    two-stream state, where the corrected costs drive on both sides."""
    from plasma_control_tpu_torch.control.mpc import candidate_costs, draw_noise, mpc_rollout
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state

    cfg, ctrl, _, _, _ = _twin_setup(torch, "cpu")
    start = init_state(cfg, torch.Generator().manual_seed(13), device="cpu")
    gen = torch.Generator().manual_seed(14)
    d = 2 * ctrl.max_mode
    block = dict(plan_kernel="fused", n_candidates=128)
    loop = dict(plan_kernel="fused", n_candidates=64, fidelity_guard=False)
    cand = torch.clamp(0.3 * torch.randn((128, TWIN_MPC["horizon"], d), generator=gen), -1, 1)
    mpc_loop = _twin_setup(torch, "cpu", **loop)[2]
    noise = torch.stack([draw_noise(gen, mpc_loop, mpc_loop.horizon, d, device="cpu")
                         for _ in range(3)])
    coherent = coherent_state(torch, cfg.n_particles, cfg.length, seed=10)
    out = {}
    for device in ("cuda", "cpu"):
        st = PlasmaState(start.x.to(device), start.v.to(device))
        pst, pgrid, pcfg, mpc, target, pact = _twin_plan(torch, st, device, **block)
        costs = candidate_costs(pst, cand.to(device), pgrid, pcfg, mpc, pact, twin_target=target)
        cfg, ctrl, mpc, grid, act = _twin_setup(torch, device, **loop)
        st = PlasmaState(coherent.x.to(device), coherent.v.to(device))
        run = mpc_rollout(st, grid, cfg, ctrl, mpc, act, step_noise=noise.to(device))
        out[device] = (costs.cpu(), run.field_energy.cpu(), run.coeffs.cpu(), target[0].cpu())
    (c_gpu, pe_gpu, a_gpu, t_gpu), (c_cpu, pe_cpu, a_cpu, t_cpu) = out["cuda"], out["cpu"]
    require(torch.allclose(t_gpu, t_cpu, rtol=1e-4, atol=1e-4 * float(t_cpu.abs().max())),
            "twin targets: card vs CPU")
    require(torch.allclose(c_gpu, c_cpu, rtol=2e-4), "corrected candidate costs: card vs CPU plain")
    require(not bool((a_gpu == 0).all()), "the unguarded twin loop applies a drive")
    # each solve's costs pass through MPPI's softmax (temperature 0.05): the
    # three-step loop is held to rtol 1e-2 on PE and atol 1e-2 on actions
    require(torch.allclose(pe_gpu, pe_cpu, rtol=1e-2), f"twin 3-step PE: {pe_gpu} vs {pe_cpu}")
    require(torch.allclose(a_gpu, a_cpu, atol=1e-2), "twin 3-step applied coefficients")
    log(f"[twin] card vs CPU plain: targets max |diff| {float((t_gpu - t_cpu).abs().max()):.3g}; "
        f"128 corrected costs max rel {float(((c_gpu - c_cpu).abs() / c_cpu.abs()).max()):.3g} "
        f"(rtol 2e-4); 3-step unguarded loop at K=64 from a coherent state: PE {pe_gpu.tolist()} vs {pe_cpu.tolist()} "
        f"(rtol 1e-2), actions max |a| {float(a_gpu.abs().max()):.3g}, max |diff| "
        f"{float((a_gpu - a_cpu).abs().max()):.3g} (atol 1e-2)")


def check_new_loops_against_cpu(torch) -> None:
    """Phase 5, fourth part: a 3-step ``feedback_rollout`` and a 3-step
    ``lqr_rollout`` (six lags, one seeded gain handed to both sides) at
    config-4's environment with the CIC kernels, on the card against the
    CPU's plain versions from one seeded state. The deposits sum in another
    order on the CPU (3 steps of two CPU deposit methods differ by ~2e-5
    relative in PE): PE rtol 1e-3, coefficients atol 1e-4 (feedback) and
    1e-3 (LQR, whose gain amplifies the observable)."""
    from plasma_control_tpu_torch.control.feedback import feedback_rollout
    from plasma_control_tpu_torch.control.sysid import lqr_rollout
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state

    cfg, ctrl, _, _, _ = _setup(torch, "cpu", sim=CFG4_SIM, max_mode=CFG4_MAX_MODE)
    start = init_state(cfg, torch.Generator().manual_seed(21), device="cpu")
    n_lags, d = 6, 2 * ctrl.max_mode
    gain = torch.randn((d, d * (2 * n_lags - 1)), generator=torch.Generator().manual_seed(22))
    out = {}
    for device in ("cuda", "cpu"):
        cfg, ctrl, _, grid, act = _setup(torch, device, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE)
        st = PlasmaState(start.x.to(device), start.v.to(device))
        fb = feedback_rollout(st, grid, cfg, ctrl, act, n_steps=3)
        lq = lqr_rollout(st, gain.to(device), grid, act, cfg, ctrl, n_lags=n_lags, n_steps=3)
        out[device] = [t.cpu() for t in (fb.field_energy, fb.coeff_cos, fb.coeff_sin,
                                         lq.field_energy, lq.coeffs)]
    (fpe, fc, fs, lpe, lu), (fpe0, fc0, fs0, lpe0, lu0) = out["cuda"], out["cpu"]
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())
    log(f"[loops] card vs CPU plain, 3 steps at N={cfg.n_particles}, M={cfg.n_mesh}: feedback PE "
        f"max rel {rel(fpe, fpe0):.3g} (rtol 1e-3), coefficients max |diff| "
        f"{float(max((fc - fc0).abs().max(), (fs - fs0).abs().max())):.3g} (atol 1e-4); LQR PE "
        f"max rel {rel(lpe, lpe0):.3g} (rtol 1e-3), actions max |a| {float(lu.abs().max()):.3g}, "
        f"max |diff| {float((lu - lu0).abs().max()):.3g} (atol 1e-3)")
    require(torch.allclose(fpe, fpe0, rtol=1e-3) and torch.allclose(fc, fc0, rtol=0, atol=1e-4)
            and torch.allclose(fs, fs0, rtol=0, atol=1e-4), "feedback loop: card vs CPU")
    require(float(lu.abs().max()) > 1e-3, "the LQR loop applies a drive")
    require(torch.allclose(lpe, lpe0, rtol=1e-3) and torch.allclose(lu, lu0, rtol=0, atol=1e-3),
            "LQR loop: card vs CPU")


def check_loops_repeat(torch) -> None:
    """Phase 6: kernel 1 at the million path's chunk (its state in the
    global scratch) and kernel 4 at the grid slice's plan model, each
    launched twice on the same inputs: asserted bitwise equal. Then the
    spectral, the grid and the twin slice, each run twice for 20 control
    steps from one seeded state and plan generator: reports whether the two
    runs end in bitwise the same state and traces (not asserted)."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.ops.kernels import fused_step as fs
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    n, k, h, km, ka = (MILLION_SIM["n_particles"], MILLION_MPC["plan_chunk"],
                       MILLION_MPC["horizon"], MILLION_MPC["plan_modes"], MILLION_CTRL["max_mode"])
    x = torch.rand(n, generator=gen, device=dev) * MILLION_SIM["length"]
    v = 1.5 * torch.randn(n, generator=gen, device=dev)
    cand = 0.6 * torch.randn((k, h, 2 * ka), generator=gen, device=dev)
    kw = dict(length=MILLION_SIM["length"], dt=MILLION_SIM["dt"], n0=1.0, n_particles=n,
              rot=True, n_modes=km)
    one, two = (sh.spectral_horizon(x, v, cand[..., :ka], cand[..., ka:], **kw) for _ in range(2))
    require(bool(torch.isfinite(one).all()) and torch.equal(one, two),
            "spectral_horizon at the million chunk: two launches differ")
    log(f"[repeat] spectral_horizon at the million path's chunk (K={k}, H={h}, Km={km}, N={n}, "
        f"global scratch): two launches bitwise equal")
    gn, gm, gk = GRID_PLAN["n"], GRID_PLAN["m"], GRID_PLAN["k"]
    length = SIM["length"]
    xb = torch.rand((gk, gn), generator=gen, device=dev) * length
    vb = torch.randn((gk, gn), generator=gen, device=dev)
    eb = 0.05 * torch.randn((gk, gm), generator=gen, device=dev)
    eop = make_grid(gm, length, device=dev).e_op.T.contiguous()
    for kind in KINDS:
        for exact in (True, False):
            one, two = (fs.fused_leapfrog_step(xb, vb, eb, eop, n_mesh=gm, length=length,
                                               dt=SIM["dt"], exact=exact, kind=kind)
                        for _ in range(2))
            require(all(torch.equal(a, b) for a, b in zip(one, two)),
                    f"fused_leapfrog_step {kind} exact={exact}: two launches differ")
    log(f"[repeat] fused_leapfrog_step at B={gk}, N={gn}, M={gm}, 3 kinds x exact/kick-field: "
        f"two launches bitwise equal")

    for what, setup in (("spectral", lambda: _setup(torch, dev, mpc=MPC)),
                        ("grid", lambda: _setup(torch, dev, mpc=GRID_MPC)),
                        ("twin", lambda: _twin_setup(torch, dev))):
        cfg, ctrl, mpc, grid, act = setup()
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        runs = [mpc_rollout(state, grid, cfg, ctrl, mpc, act,
                            torch.Generator(device=dev).manual_seed(8), n_steps=20)
                for _ in range(2)]
        same = {name: torch.equal(getattr(runs[0], name), getattr(runs[1], name))
                for name in ("field_energy", "coeffs", "plan_cost")}
        same["x"] = torch.equal(runs[0].final_state.x, runs[1].final_state.x)
        same["v"] = torch.equal(runs[0].final_state.v, runs[1].final_state.v)
        first = next((t for t in range(20) if not torch.equal(runs[0].field_energy[t],
                                                               runs[1].field_energy[t])), None)
        log(f"[repeat] {what} slice, 20 steps twice from one seed: bitwise the same "
            f"{'in every output' if all(same.values()) else same}"
            f"{'' if first is None else f'; PE first differs at step {first}'}")

    from plasma_control_tpu_torch.control.feedback import feedback_rollout

    cfg, ctrl, _, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    runs = [feedback_rollout(state, grid, cfg, ctrl, act, n_steps=20) for _ in range(2)]
    same = {name: torch.equal(getattr(runs[0], name), getattr(runs[1], name))
            for name in ("field_energy", "coeff_cos", "coeff_sin")}
    same["x"] = torch.equal(runs[0].final_state.x, runs[1].final_state.x)
    same["v"] = torch.equal(runs[0].final_state.v, runs[1].final_state.v)
    log(f"[repeat] feedback loop at config-4's environment, 20 steps twice: bitwise the same "
        f"{'in every output' if all(same.values()) else same}")


def _actor_path(simcase: str) -> str:
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(root, "artifacts", f"dagger_actor_{simcase.replace('-', '_')}.msgpack")


def _load_actor(torch, simcase: str, device):
    """The committed DAgger actor of ``simcase``, read by the port's msgpack
    reader into a SpectralActor (34 features -> 3 x 64 -> 6, outputs +-1)."""
    from plasma_control_tpu_torch.control.rl.networks import SpectralActor
    from plasma_control_tpu_torch.io.checkpoint import load_params

    fresh = SpectralActor(64, 2 * LEARNED_MAX_MODE,
                          generator=torch.Generator(device=device).manual_seed(0))
    return load_params(_actor_path(simcase), like=fresh)


def run_learned(torch) -> None:
    """Phase 4o: the three committed DAgger actors closed-loop at
    tests/test_rl.py's TestLearnedSuppression configurations (two-stream and
    bump-on-tail: N=5000, M=250, 500 steps, max_mode 3; landau: N=2000,
    M=32, 150 steps), the env step on kernels 2-3, one synchronised step per
    call (the actor reads the state only, so the calls chain into one run):
    four launches of kernel 2 (three in the Yoshida-4 step, one for the
    energies) and three of kernel 3 per step. Hard gates, the JAX test's:
    two-stream tail PE (mean of the last fifth) < 250 and < 0.25 x the
    uncontrolled tail; bump-on-tail < 18; landau < 25. Reports ms per step
    and the actor's forward time."""
    from plasma_control_tpu_torch.control.evaluate import policy_rollout
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    fns = _kernel_fns()
    for simcase, sim, tail_abs, tail_frac in LEARNED:
        cfg, ctrl, _, grid, act = _setup(torch, dev, sim=dict(sim, deposit_method="pallas"),
                                         max_mode=LEARNED_MAX_MODE)
        actor = _load_actor(torch, simcase, dev)
        policy = lambda s, actor=actor: actor.sample(s[None])[0]  # noqa: E731
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), device=dev)
        steps = cfg.n_steps
        with torch.no_grad():
            policy_rollout(state, grid, cfg, act, policy, record_snapshots=False, n_steps=3)
            _reset(fns)
            st, pes, times = state, [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = policy_rollout(st, grid, cfg, act, policy, record_snapshots=False, n_steps=1)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                st = out.final_state
                pes.append(out.field_energy)
            launches = _counts(fns)
            s0 = torch.cat([state.x, state.v])[None]
            fwd_ms = time_ms(torch, lambda: actor.sample(s0))
        pe = torch.cat(pes)
        tail = float(pe[-(steps // 5):].mean())
        require(bool(torch.isfinite(pe).all()) and pe.shape == (steps,), f"[learned] {simcase} PE")
        require(launches["deposit_cic"] == 4 * steps and launches["gather_cic"] == 3 * steps
                and sum(launches.values()) == 7 * steps,
                f"[learned] {simcase}: launches {launches}, want 4 deposits and 3 gathers per step")
        msg = f"tail PE {tail:.6g} (< {tail_abs:g})"
        ok = tail < tail_abs
        if tail_frac is not None:
            base = rollout(state, grid, cfg).field_energy[1:]
            tail_u = float(base[-(steps // 5):].mean())
            msg += f", uncontrolled {tail_u:.6g} (controlled < {tail_frac:g} x that)"
            ok = ok and tail < tail_frac * tail_u
        log(f"[learned] {simcase}: committed actor, {steps} steps at N={cfg.n_particles}, "
            f"M={cfg.n_mesh}; launches {launches}; {msg}; ms per synchronised step: median "
            f"{statistics.median(times):.4f}, min {min(times):.4f}, max {max(times):.4f}; actor "
            f"forward {fwd_ms:.4f} ms (N={cfg.n_particles}, CUDA events, median of 30)")
        require(ok, f"[learned] {simcase}: {msg}")


def run_dagger(torch, rows: dict) -> None:
    """Phase 4p: ``dagger_train`` with the MPC expert at run_dagger.py's CLI
    defaults (two-stream, N=5000, M=250, 500 steps, max_mode 3; K=512, H=10,
    Km=16 knot-3 antithetic MPPI; spectral actor, 8 modes, v_order 1), the
    depth cut to DAGGER_ITERS iterations of DAGGER_EPOCHS epochs, the env
    step on kernels 2-3: one launch of kernel 1 per expert solve (500 for
    the expert's own rollout, 500 per iteration's relabelling). Then kernel
    1 at this path's shapes against its plain version (the kernel row), and
    the time of one solve and of one BC epoch on the final data set's
    shape."""
    import dataclasses

    from plasma_control_tpu_torch.cli import (add_control_args, add_mpc_args, base_parser,
                                              build_control_config, build_mpc_config,
                                              build_sim_config)
    from plasma_control_tpu_torch.control.mpc import draw_noise, plan
    from plasma_control_tpu_torch.control.rl.dagger import dagger_train, fit_bc
    from plasma_control_tpu_torch.control.rl.ddpg import DDPGConfig, make_ddpg
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.kernels import spectral_horizon as sh

    dev = torch.device("cuda")
    args = vars(add_mpc_args(add_control_args(base_parser("dagger"))).parse_args([]))
    cfg = dataclasses.replace(build_sim_config(args), deposit_method="pallas")
    ctrl, mpc = build_control_config(args), build_mpc_config(args)
    hp = DDPGConfig(encoder="spectral", encoder_modes=8, encoder_v_order=1, mlp_dim=64,
                    output_min=ctrl.coeff_min, output_max=ctrl.coeff_max)
    _, _, _, grid, act = _setup(torch, dev, sim=dataclasses.asdict(cfg), max_mode=ctrl.max_mode)
    steps = cfg.n_steps
    fns = _kernel_fns()
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    actor, params, hist = dagger_train(cfg, ctrl, hp, grid, act,
                                       torch.Generator(device=dev).manual_seed(cfg.seed + 7),
                                       n_iters=DAGGER_ITERS, epochs_per_iter=DAGGER_EPOCHS,
                                       verbose=False, mpc=mpc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fns)
    solves = steps * (1 + DAGGER_ITERS)
    rows["spectral_horizon_dagger"]["launches"] = launches["spectral_horizon"]
    log(f"[dagger] dagger_train, MPC expert, {DAGGER_ITERS} iterations x {DAGGER_EPOCHS} epochs "
        f"at N={cfg.n_particles}, M={cfg.n_mesh}, K={mpc.n_candidates}, H={mpc.horizon}, "
        f"Km={mpc.plan_modes}: {wall:.3f} s wall; launches {launches}; bc_loss "
        f"{hist['bc_loss']}, policy tail PE {hist['pe_tail']}")
    require(launches["spectral_horizon"] == solves, f"[dagger] one kernel 1 launch per expert "
            f"solve: {launches['spectral_horizon']}, want {solves}")
    # the expert's loop (a solve's feedback seed, the step, the energies), its
    # replay, and each iteration's relabelled rollout
    want_dep = 5 * steps + (4 * steps + 1) + DAGGER_ITERS * 5 * steps
    want_gat = 3 * steps * (2 + DAGGER_ITERS)
    require(launches["deposit_cic"] == want_dep and launches["gather_cic"] == want_gat,
            f"[dagger] deposits {launches['deposit_cic']} (want {want_dep}), gathers "
            f"{launches['gather_cic']} (want {want_gat})")
    require(all(math.isfinite(v) for v in hist["bc_loss"] + hist["pe_tail"]) and "params" in params,
            "[dagger] finite losses and tail PE, a params tree")

    state = init_state(cfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
    sigma = torch.tensor(mpc.sigma0, device=dev)
    solve_ms = time_ms(torch, lambda: plan(state, mean, sigma, gen, grid, cfg, ctrl, mpc, act))
    fresh = make_ddpg(cfg, ctrl, hp, torch.Generator(device=dev).manual_seed(5))
    data = solves  # the final data set: the expert's rollout plus one per iteration
    states = torch.cat([torch.rand((data, cfg.n_particles), generator=gen, device=dev) * cfg.length,
                        torch.randn((data, cfg.n_particles), generator=gen, device=dev)], dim=1)
    targets = torch.rand((data, ctrl.n_actions), generator=gen, device=dev) * 2.0 - 1.0
    epoch_ms = time_ms(torch, lambda: fit_bc(fresh.actor, fresh.actor_opt, states, targets, 1),
                       reps=10)
    log(f"[dagger] one expert solve {solve_ms:.4f} ms (CUDA events, median of 30); one BC epoch "
        f"on {data} x {2 * cfg.n_particles} states {epoch_ms:.4f} ms (median of 10)")

    # kernel 1 at the path's shapes: one solve's clipped knot-noise
    # candidates, padded to Km as candidate_costs pads them
    ka, km = ctrl.max_mode, max(int(mpc.plan_modes), ctrl.max_mode)
    cand = torch.clamp(mpc.sigma0 * draw_noise(gen, mpc, mpc.horizon, 2 * ka, device=dev),
                       ctrl.coeff_min, ctrl.coeff_max)
    u_c, u_s = (torch.nn.functional.pad(u, (0, km - ka)) for u in (cand[..., :ka], cand[..., ka:]))
    rot = sh.use_rot(cfg.clamped_dt(), cfg.length, mpc.spectral_drift)
    kw = dict(length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0, n_particles=cfg.n_particles,
              rot=rot, n_modes=km)
    call = lambda: sh.spectral_horizon(state.x, state.v, u_c, u_s, **kw)  # noqa: E731
    got, ref = call(), sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()) and torch.allclose(got, ref, rtol=2e-4, atol=1e-6),
            "[dagger] spectral_horizon vs plain")
    dev_ms, ops = device_ms(torch, call, "spectral_horizon_kernel")
    require(ops == 1, f"[dagger] spectral_horizon: {ops:.3g} device ops per call")
    k, h = u_c.shape[:2]
    rows["spectral_horizon_dagger"].update(
        max_abs_err=float((got - ref).abs().max()), device_ms=dev_ms, ms=time_ms(torch, call),
        plain_ms=time_ms(torch, lambda: sh.spectral_horizon_plain(state.x, state.v, u_c, u_s, **kw),
                         reps=10),
        library_ms=None,
        **bound(spectral_ops(k, h, cfg.n_particles, km, rot),
                spectral_bytes(k, h, cfg.n_particles, km, twin=False)))
    r = rows["spectral_horizon_dagger"]
    log(f"[dagger] spectral_horizon at the expert's shapes (K={k}, H={h}, Km={km}, "
        f"N={cfg.n_particles}, {'rot' if rot else 'trig'}, {sh.launch_geometry(cfg.n_particles, rot)}"
        f"): max |err| {r['max_abs_err']:.3g} (rtol 2e-4); kernel {r['ms']:.4f} ms, device "
        f"{dev_ms:.5f} ms, plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}, {r['ops']:.4g} operations)")


def _synchronised_timer(torch, module, name: str, times: list):
    """Replace ``module.name`` with a wrapper that records each call's
    milliseconds (the card synchronised before and after); returns the
    original, to put back."""
    orig = getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    setattr(module, name, timed)
    return orig


def run_rl_train(torch) -> None:
    """Phase 4q: RL_EPISODES episodes of each trainer's ``train`` at its run
    script's defaults, the env step on kernels 2-3: DDPG (N=5000, M=250, 500
    steps, max_mode 3 at +-1.25, the real replay capacity of 100000
    transitions, min_buffer_size cut to RL_MIN_BUFFER, offline BC on a
    feedback rollout first), PPO (N=5000, M=250, dt 0.05, t_max cut to
    PPO_T_MAX: 500 steps; the anti-BC warm start first) and SAC (N=10000,
    M=500, 500 steps, max_mode 5). Asserts finite histories, an update in
    every episode and the kernel 2-3 launches of every env step; reports ms
    per env step (updates excluded), per update, and the replay buffer's
    bytes beside the peak of ``torch.cuda.max_memory_allocated``."""
    import numpy as np

    from plasma_control_tpu_torch.config import ControlConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.rl import ddpg, ppo, sac
    from plasma_control_tpu_torch.ops.grid import make_grid

    dev = torch.device("cuda")
    env = dict(simcase="two-stream", dt=0.1, t_max=50.0, deposit_method="pallas")
    cases = (
        ("ddpg", ddpg, SimConfig(**env), dict(max_mode=3, coeff_min=-1.25, coeff_max=1.25),
         ddpg.DDPGConfig(output_min=-1.25, output_max=1.25, min_buffer_size=RL_MIN_BUFFER)),
        ("ppo", ppo, SimConfig(**dict(env, dt=0.05, t_max=PPO_T_MAX)), dict(max_mode=3),
         ppo.PPOConfig()),
        ("sac", sac, SimConfig(**dict(env, n_particles=10000, n_mesh=500)), dict(max_mode=5),
         sac.SACConfig()),
    )
    fns = _kernel_fns()
    for name, mod, cfg, ctrl_kw, hp in cases:
        ctrl = ControlConfig(reward_n_mesh=cfg.n_mesh, **ctrl_kw)
        grid = make_grid(cfg.n_mesh, cfg.length, device=dev)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=dev)
        episodes, updates = [], []
        saved = (_synchronised_timer(torch, mod, "run_episode", episodes),
                 _synchronised_timer(torch, mod, "update_policy", updates))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(fns)
        t0 = time.perf_counter()
        try:
            _, best, hist = mod.train(cfg, ctrl, hp, grid, act,
                                      torch.Generator(device=dev).manual_seed(cfg.seed),
                                      num_episodes=RL_EPISODES, verbose=0)
        finally:
            mod.run_episode, mod.update_policy = saved
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fns)
        peak = torch.cuda.max_memory_allocated()
        steps = cfg.n_steps
        # the offline stage's feedback rollout: 5 deposits and 3 gathers a
        # step; each episode step: the Yoshida-4 step, plus DDPG's expert
        # action (one deposit); the reward's field energy is a dense deposit
        offline = name in ("ddpg", "ppo")
        per_step = 4 if name == "ddpg" else 3
        want_dep = (5 * steps if offline else 0) + RL_EPISODES * per_step * steps
        want_gat = (3 * steps if offline else 0) + RL_EPISODES * 3 * steps
        losses = {k: v for k, v in hist.items() if k != "reward"}
        log(f"[rl-train] {name}: {RL_EPISODES} episodes of {steps} steps at N={cfg.n_particles}, "
            f"M={cfg.n_mesh}, max_mode {ctrl.max_mode}: {wall:.3f} s wall; {len(updates)} "
            f"updates; launches {launches}; history "
            f"{ {k: [float(x) for x in v] for k, v in hist.items()} }")
        require(all(np.isfinite(v).all() for v in hist.values()) and "params" in best,
                f"[rl-train] {name}: finite history")
        require(all((v != 0).all() for v in losses.values()),
                f"[rl-train] {name}: an update in every episode (a loss of 0 is none)")
        require(len(episodes) == RL_EPISODES and launches["deposit_cic"] == want_dep
                and launches["gather_cic"] == want_gat and launches["spectral_horizon"] == 0,
                f"[rl-train] {name}: launches {launches}, want {want_dep} deposits, {want_gat} "
                f"gathers")
        env_ms = (sum(episodes) - sum(updates)) / (RL_EPISODES * steps)
        buf = 0
        if name != "ppo":
            s_dim, a_dim = 2 * cfg.n_particles, ctrl.n_actions
            buf = 4 * hp.capacity * (2 * s_dim + 2 * a_dim + 2)
        log(f"[rl-train] {name}: ms per env step (updates excluded, synchronised per episode) "
            f"{env_ms:.4f}; per update (synchronised): median {statistics.median(updates):.4f}, "
            f"min {min(updates):.4f}, max {max(updates):.4f}; episodes "
            f"{[round(e, 3) for e in episodes]} ms; replay buffer {buf} bytes, peak "
            f"torch.cuda.max_memory_allocated {peak} bytes")


def run_gradrefine(torch) -> None:
    """Phase 4r: ``plan`` with ``n_grad_iters`` = GRADREFINE_ITERS at the
    spectral slice's environment and planner (N=5000, M=250, K=384, H=6,
    Km=8) with the dense deposit that autograd differentiates: one launch
    of kernel 1 per solve and no CIC kernel; ms per solve. Then the
    refinement alone on the card and on the CPU from one state and the
    card's sampled nominal: the refined nominals within 1e-4."""
    import dataclasses

    from plasma_control_tpu_torch.control.mpc import _gradient_refine, plan
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state

    dev = torch.device("cuda")
    sim = dict(SIM, deposit_method="dense")
    mpc_kw = dict(MPC, n_grad_iters=GRADREFINE_ITERS)
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=sim, mpc=mpc_kw)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
    sigma = torch.tensor(mpc.sigma0, device=dev)
    plan(state, mean, sigma, gen, grid, cfg, ctrl, mpc, act)  # warm-up
    fns = _kernel_fns()
    _reset(fns)
    times = []
    for _ in range(GRADREFINE_SOLVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        action, new_mean, _ = plan(state, mean, sigma, gen, grid, cfg, ctrl, mpc, act)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        mean = torch.cat([new_mean[1:], new_mean[-1:]])
    launches = _counts(fns)
    require(launches["spectral_horizon"] == GRADREFINE_SOLVES and sum(launches.values())
            == GRADREFINE_SOLVES, f"[gradrefine] launches {launches}: one kernel 1 per solve")
    require(bool(torch.isfinite(new_mean).all()), "[gradrefine] refined nominal not finite")
    sampled = plan(state, mean, sigma, gen, grid, cfg, ctrl,
                   dataclasses.replace(mpc, n_grad_iters=0), act)[1]
    out = {}
    for device in ("cuda", "cpu"):
        c, k, m_, g, a = _setup(torch, device, sim=sim, mpc=mpc_kw)
        st = PlasmaState(state.x.to(device), state.v.to(device))
        t0 = time.perf_counter()
        out[device] = _gradient_refine(st, sampled.to(device), g, c, k, m_, a).cpu()
        out[device + "_s"] = time.perf_counter() - t0
    diff = float((out["cuda"] - out["cpu"]).abs().max())
    moved = float((out["cuda"] - sampled.cpu()).abs().max())
    log(f"[gradrefine] plan with {GRADREFINE_ITERS} Adam steps through H={mpc.horizon} Yoshida-4 "
        f"steps (dense deposit, N={cfg.n_particles}, M={cfg.n_mesh}), K={mpc.n_candidates}: "
        f"launches {launches}; ms per solve (synchronised): median "
        f"{statistics.median(times):.4f}, min {min(times):.4f}, max {max(times):.4f}; refinement "
        f"alone, card vs CPU from one nominal: max |diff| {diff:.3g} (atol 1e-4), moved the "
        f"nominal by up to {moved:.4g}; {out['cuda_s']:.3f} s card, {out['cpu_s']:.3f} s CPU")
    require(diff <= 1e-4, f"[gradrefine] refined nominal: card vs CPU max |diff| {diff}")


def run_entry_rl(torch) -> None:
    """Phase 4s: ``main()`` of the port's run_dagger (the committed
    two-stream actor, and ``--optimize`` cut to 1 iteration of 10 epochs),
    run_ddpg, run_ppo and run_sac (``--optimize``, 1 episode; DDPG's
    min_buffer_size at RL_MIN_BUFFER) at their CLI defaults otherwise, with
    ``--is_save`` into a git-ignored directory, removed afterwards: each
    writes a data.npz with finite PE and the trainers their weights."""
    import importlib
    import os
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch.io.export import load_run

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataset")
    os.makedirs(data, exist_ok=True)
    runs = (("dagger", "run_dagger", ["--actor_path", _actor_path("two-stream")]),
            ("dagger-optimize", "run_dagger", ["--optimize", "--dagger_iters", "1",
                                               "--epochs_per_iter", "10"]),
            ("ddpg", "run_ddpg", ["--optimize", "--num_episode", "1", "--min_buffer_size",
                                  str(RL_MIN_BUFFER)]),
            ("ppo", "run_ppo", ["--optimize", "--num_episode", "1"]),
            ("sac", "run_sac", ["--optimize", "--num_episode", "1"]))
    fns = _kernel_fns()
    for phase, module, flags in runs:
        script = importlib.import_module(f"plasma_control_tpu_torch.{module}")
        tag = module[len("run_"):] + "-control"
        with tempfile.TemporaryDirectory(dir=data) as tmp:
            argv = flags + ["--is_save", "--save_file", f"{tmp}/data", "--save_plot", f"{tmp}/plots"]
            if phase == "dagger-optimize":
                argv += ["--actor_path", f"{tmp}/actor.msgpack"]
            _reset(fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            script.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = load_run(f"{tmp}/data/two-stream/{tag}/data.npz")
            weights = sorted(f for _, _, fs in os.walk(tmp) for f in fs if f.endswith(".msgpack"))
        steps = run["snapshot"].shape[1] - 1
        require(bool(np.isfinite(run["PE"]).all()) and steps == run["coeff_cos"].shape[1],
                f"[entry-{phase}] data.npz: PE finite, {steps} steps")
        require(phase == "dagger" or weights, f"[entry-{phase}] no weights written")
        log(f"[entry-{phase}] python -m plasma_control_tpu_torch.{module} {' '.join(flags[:1])} "
            f"(CLI defaults otherwise, --is_save): {wall:.3f} s wall, {steps} evaluation steps at "
            f"N={run['snapshot'].shape[0] // 2}; tail PE (mean of the last fifth) "
            f"{float(np.mean(run['PE'][-(steps // 5):])):.6g}; weights {weights}; launches "
            f"{_counts(fns)}")


def check_rl_against_cpu(torch) -> None:
    """Phase 5, fifth part: RL_CPU_STEPS closed-loop steps of the committed
    two-stream actor at TestLearnedSuppression's configuration from one
    seeded state, on the card (kernels 2-3) against the CPU (their plain
    versions): PE within 1e-5 relative."""
    from plasma_control_tpu_torch.control.evaluate import policy_rollout
    from plasma_control_tpu_torch.models.pic import PlasmaState, init_state

    sim = dict(LEARNED[0][1], deposit_method="pallas")
    cfg = _setup(torch, "cpu", sim=sim, max_mode=LEARNED_MAX_MODE)[0]
    start = init_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        cfg, ctrl, _, grid, act = _setup(torch, device, sim=sim, max_mode=LEARNED_MAX_MODE)
        actor = _load_actor(torch, "two-stream", device)
        st = PlasmaState(start.x.to(device), start.v.to(device))
        with torch.no_grad():
            r = policy_rollout(st, grid, cfg, act, lambda s, a=actor: a.sample(s[None])[0],
                               record_snapshots=False, n_steps=RL_CPU_STEPS)
        out[device] = (r.field_energy.cpu(), r.coeffs.cpu())
    (pe, a), (pe0, a0) = out["cuda"], out["cpu"]
    rel = float(((pe - pe0).abs() / pe0.abs()).max())
    log(f"[rl-cpu] committed two-stream actor, {RL_CPU_STEPS} steps at N={cfg.n_particles}, "
        f"M={cfg.n_mesh}: card vs CPU plain PE max rel {rel:.3g} (rtol 1e-5); actions max |diff| "
        f"{float((a - a0).abs().max()):.3g}")
    require(rel <= 1e-5, f"[rl-cpu] PE card vs CPU: max rel {rel}")


# the slices whose control step [aot] captures: (name, _setup arguments)
AOT_SLICES = (("spectral", dict(mpc=MPC)), ("grid", dict(mpc=GRID_MPC)),
              ("twin", dict(sim=CFG4_SIM, max_mode=CFG4_MAX_MODE, mpc=TWIN_MPC)))
AOT_STEPS, AOT_TIMED = 20, 100
AOT_REFINE_STEPS = 3


def device_window(torch, fn, reps: int, marker: str) -> list:
    """The device events of ``reps`` calls of ``fn`` in one profiler window
    (:func:`trace_window`). ``fn`` launches one kernel whose name holds
    ``marker`` per call and the same device ops in every call: a window
    without exactly ``reps`` marked kernels, or in which some op's count is
    not a multiple of ``reps``, missed events. (A window that drops one event
    of each of ``reps`` ops keeps its total a multiple of ``reps``: only the
    count of each op shows it.)"""

    def accept(events):
        marked = sum(marker in e["name"] for e in events if e["cat"] == "kernel")
        per_op = collections.Counter(e["name"] for e in events)
        return events if marked == reps and all(n % reps == 0 for n in per_op.values()) else None

    return trace_window(torch, fn, reps, accept, f"{reps} calls marked {marker}")


def busy_ms(events: list) -> float:
    """Length of the union of the events' intervals, in ms."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def synced_ms(torch, fn, reps: int) -> list:
    """Host-clock milliseconds of each of ``reps`` calls, the card
    synchronised after each."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _spread(times: list) -> str:
    return f"median {statistics.median(times):.4f} (min {min(times):.4f}, max {max(times):.4f})"


def run_aot(torch) -> None:
    """The control step captured as one CUDA graph (``io/aot.py``
    ``GraphedStep``) at the spectral, grid and twin slices, each from its
    seeded state: AOT_STEPS replays against AOT_STEPS eager steps of
    ``control_step_fn`` from the same state and generator seed, asserted
    bitwise equal (traces, applied coefficients, final state and nominal);
    two replays from one coherent two-stream state must differ in the
    applied action or the best cost (the registered generator advances:
    the step is deterministic given its draws); the device ops of one
    replay must be those of one eager call of the captured body (the step,
    the three state copies and the output packing) plus the two fills of
    the generator's seed and offset that replay() launches (the bare step's
    count is reported beside them). Reports ms per control step eager
    against replay (host clock, card synchronised each step, AOT_TIMED
    steps), device busy per replayed step, capture time and the graph's
    memory; then the refined step (:func:`run_aot_refine`)."""
    from plasma_control_tpu_torch.io.aot import GraphedStep, aot_mpc_rollout, control_step_fn
    from plasma_control_tpu_torch.models.pic import init_state

    dev = torch.device("cuda")
    fns = _kernel_fns()
    for name, kw in AOT_SLICES:
        cfg, ctrl, mpc, grid, act = _setup(torch, dev, **kw)
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), device=dev)
        shape = (mpc.horizon, ctrl.n_actions)
        eager_step = control_step_fn(grid, cfg, ctrl, mpc, act)
        _reset(fns)
        eager = aot_mpc_rollout(eager_step, state, torch.Generator(device=dev).manual_seed(11),
                                AOT_STEPS, *shape)
        eager_launches = _counts(fns)
        graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
        gen = torch.Generator(device=dev).manual_seed(11)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _reset(fns)
        graphed.capture(state.x, state.v, torch.zeros(shape, device=dev), gen)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        capture_launches = _counts(fns)
        mem1 = torch.cuda.memory_allocated()
        _reset(fns)
        replay = aot_mpc_rollout(graphed, state, gen, AOT_STEPS, *shape)
        require(not any(_counts(fns).values()), f"[aot] {name}: a replay called a wrapper")
        same = {k: torch.equal(getattr(eager, k), getattr(replay, k))
                for k in ("field_energy", "kinetic", "coeffs", "input_energy", "plan_cost",
                          "final_mean")}
        same["x"] = torch.equal(eager.final_state.x, replay.final_state.x)
        same["v"] = torch.equal(eager.final_state.v, replay.final_state.v)
        require(all(same.values()) and bool(torch.isfinite(replay.field_energy).all()),
                f"[aot] {name}: {AOT_STEPS} replays against eager steps, bitwise equal: {same}")
        # two replays from one state draw different noise: another action
        # and best candidate cost, from a coherent two-stream state at which
        # the fidelity guards let the drive through (at the seeded states the
        # grid and twin guards zero the action and the nominal wins)
        mean0 = torch.zeros(shape, device=dev)
        drive = coherent_state(torch, cfg.n_particles, cfg.length, seed=5)
        one, two = (graphed(drive.x.to(dev), drive.v.to(dev), mean0, gen) for _ in range(2))
        require(not (torch.equal(one[3], two[3]) and torch.equal(one[7], two[7])),
                f"[aot] {name}: two replays from one state applied the same action and found "
                f"the same best cost: the noise did not advance")
        # device ops of one replay against one eager call of the captured body
        reps = 5
        marker = "horizon_kernel"  # kernel 1 (spectral_horizon_kernel) or 6, once per step
        replay_events = device_window(torch, graphed.graph.replay, reps, marker)
        body_events = device_window(torch, graphed._body, reps, marker)
        x, v, m = state.x, state.v, mean0
        step_events = device_window(torch, lambda: eager_step(x, v, m, gen), reps, marker)
        per = lambda evs: len(evs) / reps
        # a graph runs a device-to-device copy as a kernel of its own name
        names = lambda evs: collections.Counter(
            "device-to-device copy" if e["name"].lower().startswith("memcpy") else e["name"]
            for e in evs)
        extra = names(replay_events) - names(body_events)
        missing = names(body_events) - names(replay_events)
        # replay() writes the registered generator's seed and offset into
        # the graph's device tensors before it launches the graph: two fills
        require(not missing and sum(extra.values()) == 2 * reps
                and all("Fill" in k for k in extra),
                f"[aot] {name}: {per(replay_events)} device ops per replay, {per(body_events)} "
                f"per eager call of the captured body; replay only {dict(extra)}, eager only "
                f"{dict(missing)}")
        busy = busy_ms(replay_events) / reps
        # ms per control step: eager against replay, synchronised each step
        carry = [state.x, state.v, torch.zeros(shape, device=dev)]

        def eager_call():
            carry[:] = eager_step(*carry, gen)[:3]

        def replay_call():
            carry[:] = graphed(*carry, gen)[:3]

        eager_step(*carry, gen)
        t_eager = synced_ms(torch, eager_call, AOT_TIMED)
        carry[:] = [state.x, state.v, torch.zeros(shape, device=dev)]
        t_replay = synced_ms(torch, replay_call, AOT_TIMED)
        log(f"[aot] {name} slice (N={cfg.n_particles}, M={cfg.n_mesh}, K={mpc.n_candidates}, "
            f"H={mpc.horizon}): {AOT_STEPS} replays bitwise equal to {AOT_STEPS} eager steps "
            f"(wrapper launches in the eager run {eager_launches}); two replays from one "
            f"coherent state differ; capture {capture_s:.3f} s ({graphed.WARMUP} eager warm-up "
            f"steps, wrapper launches {capture_launches}); graph memory "
            f"{mem1 - mem0} bytes (torch.cuda.memory_allocated before and after capture)")
        log(f"[aot] {name}: device ops per replay {per(replay_events):g} (the captured body's "
            f"{per(body_events):g} plus the generator's seed and offset fills "
            f"{ {k: v / reps for k, v in extra.items()} }), per bare control_step_fn call "
            f"{per(step_events):g}; device busy per replayed step {busy:.4f} ms (profiler "
            f"window of {reps})")
        log(f"[aot] {name}: ms per control step, host clock, card synchronised each step, "
            f"{AOT_TIMED} steps: eager {_spread(t_eager)}; replay {_spread(t_replay)}")
    run_aot_refine(torch)


def run_aot_refine(torch) -> None:
    """The control step with gradient refinement (``[gradrefine]``'s solve:
    the spectral slice, dense deposit, GRADREFINE_ITERS Adam steps with
    autograd and ``torch.utils.checkpoint`` through the plan model) captured
    as one CUDA graph: AOT_REFINE_STEPS replays bitwise equal to as many
    eager steps from one generator seed; ms per control step eager against
    replay, synchronised each step, after those (so both run warm)."""
    from plasma_control_tpu_torch.io.aot import GraphedStep, aot_mpc_rollout, control_step_fn
    from plasma_control_tpu_torch.models.pic import init_state

    dev = torch.device("cuda")
    cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=dict(SIM, deposit_method="dense"),
                                       mpc=dict(MPC, n_grad_iters=GRADREFINE_ITERS))
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), device=dev)
    shape = (mpc.horizon, ctrl.n_actions)
    eager_step = control_step_fn(grid, cfg, ctrl, mpc, act)
    eager = aot_mpc_rollout(eager_step, state, torch.Generator(device=dev).manual_seed(11),
                            AOT_REFINE_STEPS, *shape)
    graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    graphed.capture(state.x, state.v, torch.zeros(shape, device=dev), gen)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay = aot_mpc_rollout(graphed, state, gen, AOT_REFINE_STEPS, *shape)
    same = {k: torch.equal(getattr(eager, k), getattr(replay, k))
            for k in ("field_energy", "coeffs", "plan_cost", "final_mean")}
    same["x"] = torch.equal(eager.final_state.x, replay.final_state.x)
    require(all(same.values()), f"[aot] refined step: replays against eager steps: {same}")
    carry = [replay.final_state.x, replay.final_state.v, replay.final_mean]

    def eager_call():
        carry[:] = eager_step(*carry, gen)[:3]

    def replay_call():
        carry[:] = graphed(*carry, gen)[:3]

    t_eager = synced_ms(torch, eager_call, AOT_REFINE_STEPS)
    carry[:] = [replay.final_state.x, replay.final_state.v, replay.final_mean]
    t_replay = synced_ms(torch, replay_call, AOT_REFINE_STEPS)
    log(f"[aot] refined step ({GRADREFINE_ITERS} Adam steps through H={mpc.horizon} dense "
        f"Yoshida-4 steps, autograd and torch.utils.checkpoint inside the capture): "
        f"{AOT_REFINE_STEPS} replays bitwise equal to {AOT_REFINE_STEPS} eager steps; capture "
        f"{capture_s:.3f} s; ms per control step, synchronised each, {AOT_REFINE_STEPS} steps: "
        f"eager {_spread(t_eager)}; replay {_spread(t_replay)}")


RESUME_STEPS, RESUME_MPC_STEPS = 40, 20
# the spectral slice through run_mpc's flags (bench.py:163-181), the CLI's
# dense deposit
SPECTRAL_FLAGS = ["--simcase", "bump-on-tail", "--num_particle", "5000", "--num_mesh", "250",
                  "--max_mode", "4", "--horizon", "6", "--w_terminal", "4", "--n_candidates",
                  "384", "--plan_modes", "8", "--spectral_drift", "rot"]
AOT_COLD_STEPS = 3


def _data_dir() -> str:
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataset")
    os.makedirs(data, exist_ok=True)
    return data


def run_resume(torch) -> None:
    """Segmented runs through ``main()`` with ``--checkpoint_every`` (half
    the run per segment): run_wo_oc and run_feedback at config-4's
    environment (N=100000, M=256, max_mode 8 for feedback, the CIC kernels
    as CFG4_SIM sets them) for RESUME_STEPS steps, and run_mpc with the twin
    slice's flags (the CLI's dense deposit, as ``[entry]``) for
    RESUME_MPC_STEPS. Each is run uninterrupted, then cut at half (a shorter
    ``--t_max`` into another checkpoint path) and resumed. Asserts bitwise:
    the final checkpoints (state, and for MPC the nominal, the applied
    coefficients and the generator's state), the resumed run's traces
    against the tail of the uninterrupted run's (MPC: the whole saved run,
    replayed from the carried coefficients), and the launches of kernels
    1c / 2 / 3 per step of ``[entry]`` / ``[feedback]`` (the uncontrolled
    run's energies also deposit once per segment at its start). Reports ms
    per checkpoint save and restore (synchronised) and the checkpoint's
    bytes."""
    import dataclasses
    import importlib
    import os
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch.io import resume
    from plasma_control_tpu_torch.io.checkpoint import restore_checkpoint
    from plasma_control_tpu_torch.io.export import load_run

    env = ["--simcase", "two-stream", "--num_particle", str(CFG4_SIM["n_particles"]),
           "--num_mesh", str(CFG4_SIM["n_mesh"])]
    cases = (("wo-oc", "run_wo_oc", env, RESUME_STEPS, True),
             ("feedback", "run_feedback", env + ["--max_mode", str(CFG4_MAX_MODE)],
              RESUME_STEPS, True),
             ("mpc-control", "run_mpc", TWIN_FLAGS, RESUME_MPC_STEPS, False))
    fns = _kernel_fns()
    for tag, module, flags, steps, pallas in cases:
        script = importlib.import_module(f"plasma_control_tpu_torch.{module}")
        saves, restores = [], []
        saved = (_synchronised_timer(torch, resume, "save_checkpoint", saves),
                 _synchronised_timer(torch, resume, "restore_checkpoint", restores))
        build = script.build_sim_config
        if pallas:  # config-4's environment steps on the CIC kernels
            script.build_sim_config = lambda args: dataclasses.replace(
                build(args), deposit_method=CFG4_SIM["deposit_method"])
        half = steps // 2
        try:
            with tempfile.TemporaryDirectory(dir=_data_dir()) as tmp:
                def run(name, t_steps, ck):
                    argv = flags + ["--t_max", f"{0.1 * t_steps:g}", "--checkpoint_every",
                                    str(half), "--checkpoint_path", f"{tmp}/{ck}", "--is_save",
                                    "--save_file", f"{tmp}/{name}", "--save_plot", f"{tmp}/p"]
                    _reset(fns)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    script.main(argv)
                    torch.cuda.synchronize()
                    return (load_run(f"{tmp}/{name}/two-stream/{tag}/data.npz"), _counts(fns),
                            time.perf_counter() - t0)

                full, full_counts, full_wall = run("full", steps, "ck_full")
                run("cut", half, "ck_res")
                res, res_counts, res_wall = run("res", steps, "ck_res")
                ck_full = restore_checkpoint(f"{tmp}/ck_full")
                ck_res = restore_checkpoint(f"{tmp}/ck_res")
                ck_bytes = os.path.getsize(f"{tmp}/ck_full")
        finally:
            resume.save_checkpoint, resume.restore_checkpoint = saved
            script.build_sim_config = build
        same = {k: (np.array_equal(ck_full[k], ck_res[k]) if isinstance(ck_full[k], np.ndarray)
                    else torch.equal(ck_full[k], ck_res[k]) if isinstance(ck_full[k], torch.Tensor)
                    else ck_full[k] == ck_res[k]) for k in ck_full}
        require(all(same.values()) and ck_full["t_done"] == steps,
                f"[resume] {tag}: final checkpoints of the resumed and the uninterrupted run "
                f"differ: {same}")
        if tag == "mpc-control":
            keys, tail = ("snapshot", "E", "PE", "coeff_cos", "coeff_sin"), {}
            want = {"spectral_horizon_twin": steps}
            want_res = {"spectral_horizon_twin": half}
        else:
            pe0 = half + 1 if tag == "wo-oc" else half  # feedback's PE starts at step 1
            keys = ("snapshot", "PE") + (("coeff_cos", "coeff_sin") if tag == "feedback" else ())
            tail = {"snapshot": (slice(None), slice(half + 1, None)), "PE": slice(pe0, None),
                    "coeff_cos": (slice(None), slice(half, None)),
                    "coeff_sin": (slice(None), slice(half, None))}
            per = 4 if tag == "wo-oc" else 5
            lead = 1 if tag == "wo-oc" else 0  # the initial energies of each segment
            want = {"deposit_cic": per * steps + 2 * lead, "gather_cic": 3 * steps}
            want_res = {"deposit_cic": per * half + lead, "gather_cic": 3 * half}
        for key in keys:
            ref = full[key][tail[key]] if key in tail else full[key]
            require(np.array_equal(res[key], ref) and bool(np.isfinite(res[key]).all()),
                    f"[resume] {tag}: resumed {key} differs from the uninterrupted run's")
        require(all(full_counts[k] == v for k, v in want.items())
                and all(res_counts[k] == v for k, v in want_res.items()),
                f"[resume] {tag}: launches {full_counts} uninterrupted, {res_counts} resumed; "
                f"want {want}, {want_res}")
        log(f"[resume] {tag}: {steps} steps in segments of {half} (N={CFG4_SIM['n_particles']}"
            f"), cut at {half} and resumed: final checkpoint ({', '.join(ck_full)}) and resumed "
            f"{', '.join(keys)} bitwise equal to the uninterrupted run's; launches uninterrupted "
            f"{ {k: v for k, v in full_counts.items() if v} }, resumed "
            f"{ {k: v for k, v in res_counts.items() if v} }; wall {full_wall:.3f} s "
            f"uninterrupted, {res_wall:.3f} s resumed")
        log(f"[resume] {tag}: checkpoint {ck_bytes} bytes; save (synchronised) "
            f"{_spread(saves)} ms over {len(saves)}; restore {_spread(restores)} ms over "
            f"{len(restores)}")


def run_resume_train(torch) -> None:
    """DDPG, PPO and SAC at ``[rl-train]``'s widths and depth cuts: one
    episode with ``ckpt_every=1``, then resumed to two, against two
    uninterrupted episodes run twice. Asserts that the resumed run matches
    the uninterrupted one at least as closely as the two uninterrupted runs
    match each other (history, the actor's parameters, the best actor), and
    bitwise where they do; that the resumed run skipped the offline stage
    (its launches are one episode's); reports both differences, the
    checkpoint's bytes on disk, and the save and restore times."""
    import os
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch.config import ControlConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.rl import ddpg, ppo, sac
    from plasma_control_tpu_torch.interop import actor_params_to_numpy
    from plasma_control_tpu_torch.io import resume
    from plasma_control_tpu_torch.ops.grid import make_grid

    dev = torch.device("cuda")
    env = dict(simcase="two-stream", dt=0.1, t_max=50.0, deposit_method="pallas")
    cases = (
        ("ddpg", ddpg, SimConfig(**env), dict(max_mode=3, coeff_min=-1.25, coeff_max=1.25),
         ddpg.DDPGConfig(output_min=-1.25, output_max=1.25, min_buffer_size=RL_MIN_BUFFER),
         lambda ts: ts.actor),
        ("ppo", ppo, SimConfig(**dict(env, dt=0.05, t_max=PPO_T_MAX)), dict(max_mode=3),
         ppo.PPOConfig(), lambda ts: ts.policy),
        ("sac", sac, SimConfig(**dict(env, n_particles=10000, n_mesh=500)), dict(max_mode=5),
         sac.SACConfig(), lambda ts: ts.actor),
    )
    fns = _kernel_fns()
    for name, mod, cfg, ctrl_kw, hp, actor_of in cases:
        ctrl = ControlConfig(reward_n_mesh=cfg.n_mesh, **ctrl_kw)
        grid = make_grid(cfg.n_mesh, cfg.length, device=dev)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=dev)

        def train(episodes, **kw):
            ts, best, hist = mod.train(cfg, ctrl, hp, grid, act,
                                       torch.Generator(device=dev).manual_seed(cfg.seed),
                                       num_episodes=episodes, verbose=0, **kw)
            flat = [np.asarray(hist[k]) for k in sorted(hist)]
            params = [p.detach().cpu().numpy() for p in actor_of(ts).state_dict().values()]
            best = list(_leaves(best))
            return flat + params + best

        saves, restores = [], []
        saved = (_synchronised_timer(torch, resume, "save_train_checkpoint", saves),
                 _synchronised_timer(torch, resume, "restore_train_checkpoint", restores))
        try:
            with tempfile.TemporaryDirectory(dir=_data_dir()) as tmp:
                one, two = train(RL_EPISODES), train(RL_EPISODES)
                train(1, ckpt_path=f"{tmp}/ck", ckpt_every=1)
                ck_bytes = sum(os.path.getsize(f"{tmp}/ck/{f}") for f in os.listdir(f"{tmp}/ck"))
                _reset(fns)
                resumed = train(RL_EPISODES, ckpt_path=f"{tmp}/ck", ckpt_every=1)
                launches = _counts(fns)
        finally:
            resume.save_train_checkpoint, resume.restore_train_checkpoint = saved
        diff = lambda a, b: max(float(np.max(np.abs(x.astype(np.float64) - y)))
                                if x.size else 0.0 for x, y in zip(a, b))
        bitwise = lambda a, b: all(np.array_equal(x, y) for x, y in zip(a, b))
        d_repeat, d_resume = diff(one, two), diff(resumed, one)
        require(d_resume <= d_repeat and (bitwise(resumed, one) or not bitwise(one, two)),
                f"[resume-train] {name}: resumed run off the uninterrupted one by {d_resume}, "
                f"two uninterrupted runs by {d_repeat}")
        steps = cfg.n_steps
        per_step = 4 if name == "ddpg" else 3
        require(launches["deposit_cic"] == per_step * steps and launches["gather_cic"] == 3 * steps,
                f"[resume-train] {name}: resumed launches {launches}: want one episode's, the "
                f"offline stage skipped")
        log(f"[resume-train] {name} (N={cfg.n_particles}, M={cfg.n_mesh}, {steps} steps per "
            f"episode): 1 episode, checkpoint, resumed to {RL_EPISODES} against {RL_EPISODES} "
            f"uninterrupted episodes twice: max |resumed - uninterrupted| {d_resume:.6g}, max "
            f"|uninterrupted - uninterrupted| {d_repeat:.6g} (history, actor parameters, best "
            f"actor; bitwise {'equal' if d_resume == 0 else 'different'}); resumed launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"[resume-train] {name}: checkpoint {ck_bytes} bytes on disk (state, meta.npz, "
            f"best.msgpack); ms per save (synchronised; after episode 1, then after episode "
            f"{RL_EPISODES} of the resumed run) {[round(t, 4) for t in saves]}; restore that "
            f"loaded it {restores[-1]:.4f} ms (the interrupted run's look for one found none: "
            f"{restores[0]:.4f} ms)")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        import numpy as np

        yield np.asarray(tree)


def run_aot_cold(torch) -> None:
    """``run_mpc --save_aot`` at the spectral slice's flags writes both
    artifacts (portable JSON and compiled ``.pkl``); then for each a fresh
    ``python -m plasma_control_tpu_torch.run_mpc --aot`` of AOT_COLD_STEPS
    steps runs in a subprocess from a copy of the package in a temporary
    directory, whose build directory is empty: the portable artifact builds
    the kernels (nvcc), the compiled one installs its library. Reports each
    process's wall time to the end of its loop (from its output lines'
    arrival) beside its own load and loop times; asserts that both saved
    runs equal an eager in-process run of the same flags bitwise, that the
    compiled artifact's process ran with no nvcc to be found (neither on
    its PATH nor under its CUDA_HOME, so a build would have failed it) and
    left the artifact's library bytes in its build directory, and that an
    artifact with another kernel hash is refused."""
    import json
    import os
    import shutil
    import struct
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch import run_mpc
    from plasma_control_tpu_torch.io import aot
    from plasma_control_tpu_torch.io.export import load_run
    from plasma_control_tpu_torch.ops.kernels import _build

    steps = ["--t_max", f"{0.1 * AOT_COLD_STEPS:g}", "--is_save", "--save_plot", "p"]
    with tempfile.TemporaryDirectory(dir=_data_dir()) as tmp:
        for kind, name in (("portable", "step.json"), ("compiled", "step.pkl")):
            t0 = time.perf_counter()
            run_mpc.main(SPECTRAL_FLAGS + ["--save_aot", f"{tmp}/{name}"])
            log(f"[aot-cold] run_mpc --save_aot {name}: {time.perf_counter() - t0:.3f} s, "
                f"{os.path.getsize(f'{tmp}/{name}')} bytes")
        run_mpc.main(SPECTRAL_FLAGS + steps + ["--save_file", f"{tmp}/eager"])
        eager = load_run(f"{tmp}/eager/bump-on-tail/mpc-control/data.npz")
        lib_name = _build._library_path().name
        for kind, name in (("portable", "step.json"), ("compiled", "step.pkl")):
            fresh = f"{tmp}/fresh_{kind}"
            shutil.copytree(os.path.dirname(os.path.abspath(run_mpc.__file__)),
                            f"{fresh}/plasma_control_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            require(not os.path.exists(f"{fresh}/build"), "[aot-cold] the copy has a build")
            argv = [sys.executable, "-m", "plasma_control_tpu_torch.run_mpc", *SPECTRAL_FLAGS,
                    *steps, "--save_file", f"{fresh}/out", "--aot", f"{tmp}/{name}"]
            env = None
            if kind == "compiled":
                # no nvcc to be found: a build would raise, and the run fail
                os.makedirs(f"{tmp}/no_cuda")
                path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
                        if d and not os.path.exists(os.path.join(d, "nvcc"))]
                env = dict(os.environ, PATH=os.pathsep.join(path), CUDA_HOME=f"{tmp}/no_cuda")
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv, cwd=fresh, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True, env=env)
            lines = []
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip()))
            rc = proc.wait()
            wall = time.perf_counter() - t0
            out = "\n".join(text for _, text in lines)
            require(rc == 0, f"[aot-cold] {kind}: the fresh process failed ({rc}):\n{out[-3000:]}")
            at = {key: t for t, text in lines for key in ("loaded", "through the artifact")
                  if key in text}
            fresh_run = load_run(f"{fresh}/out/bump-on-tail/mpc-control/data.npz")
            for key in ("snapshot", "E", "PE", "coeff_cos", "coeff_sin"):
                require(np.array_equal(fresh_run[key], eager[key]),
                        f"[aot-cold] {kind}: {key} differs from the eager in-process run")
            built = os.listdir(f"{fresh}/build/plasma_control_tpu_torch")
            require(lib_name in built, f"[aot-cold] {kind}: no {lib_name} in {built}")
            if kind == "compiled":
                with open(f"{tmp}/{name}", "rb") as f:
                    data = f.read()
                (n,) = struct.unpack("<Q", data[8:16])
                with open(f"{fresh}/build/plasma_control_tpu_torch/{lib_name}", "rb") as f:
                    require(f.read() == data[16 + n:], "[aot-cold] compiled: the installed "
                            "library is not the artifact's")
            load_line = next(text for _, text in lines if "loaded" in text)
            loop_line = next(text for _, text in lines if "through the artifact" in text)
            log(f"[aot-cold] {kind} artifact, fresh process (python -m "
                f"plasma_control_tpu_torch.run_mpc --aot, {AOT_COLD_STEPS} steps, empty build "
                f"directory{', no nvcc to be found' if env else ''}): {wall:.3f} s wall to exit; its loop ended {at['through the artifact']:.3f}"
                f" s after launch (load line at {at['loaded']:.3f} s); '{load_line}'; "
                f"'{loop_line}'; saved run bitwise the eager in-process run's")
        # another kernel hash: refused
        with open(f"{tmp}/step.pkl", "rb") as f:
            data = f.read()
        (n,) = struct.unpack("<Q", data[8:16])
        fp = json.loads(data[16:16 + n])
        fp["kernels"] = "libpct_0000000000000000.so"
        blob = json.dumps(fp).encode()
        with open(f"{tmp}/stale.pkl", "wb") as f:
            f.write(data[:8] + struct.pack("<Q", len(blob)) + blob + data[16 + n:])
        try:
            aot.load_compiled_plan(f"{tmp}/stale.pkl")
            refused = None
        except ValueError as e:
            refused = str(e)
        require(refused is not None and "stale artifact" in refused,
                "[aot-cold] an artifact of other kernel sources was loaded")
        log(f"[aot-cold] artifact with another kernel hash refused: {refused}")


# ---------------------------------------------------------------------------
# The sharded planner and step ([parallel]), the plots' field
# series ([viz]), the NaN checks ([debug]), the twin state's uncontrolled tail
# ---------------------------------------------------------------------------

# bench_scaling.py:481-498's config-5 push on the CIC kernels: two-stream,
# N=1M, M=256, 500000 particles per rank on two ranks
CFG5_SIM = dict(simcase="two-stream", n_particles=1_000_000, n_mesh=256, dt=0.1,
                deposit_method="pallas")
PARTICLE_STEPS = 20
PARALLEL_RANKS = 2
PARALLEL_TWIN_STEPS = 5
PARALLEL_CFG4_STEPS = 3
VIZ_STEPS = 50  # [entry]'s run: config-4's environment, --t_max 5


def _periodic_diff(torch, a, b, length: float):
    """Largest |a - b| with differences taken modulo the box: a particle
    that wraps in one run and not in the other counts by its distance."""
    d = torch.remainder(a - b + 0.5 * length, length) - 0.5 * length
    return float(d.abs().max())


def _same(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _solve_ms(torch, fn, reps: int = 5) -> list:
    fn()  # warm-up
    torch.cuda.synchronize()
    return synced_ms(torch, fn, reps)


def run_parallel_nccl(torch) -> None:
    """[parallel] (a): a one-rank NCCL group in this process (a mesh built
    with no group starts one in memory): config-4's full-fidelity solve
    through make_sharded_plan against plan on the same draws, bitwise, and
    three steps of make_sharded_mpc_rollout against mpc_rollout; the group
    is destroyed at the end, so the later phases run as before."""
    import torch.distributed as dist

    from plasma_control_tpu_torch.control.mpc import mpc_rollout, plan, solve_noise
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.parallel.mesh import make_mesh
    from plasma_control_tpu_torch.parallel.pic_shard import (make_sharded_mpc_rollout,
                                                             make_sharded_plan)

    dev = torch.device("cuda")
    require(not dist.is_initialized(), "[parallel] a process group before the phase")
    mesh = make_mesh(device_type="cuda")
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"[parallel] group {dist.get_backend()} of {dist.get_world_size()}")
        cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=CFG4_SIM, max_mode=CFG4_MAX_MODE,
                                           mpc=CFG4_MPC)
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
        sigma = torch.tensor(mpc.sigma0, device=dev)
        noise = solve_noise(torch.Generator(device=dev).manual_seed(3), mpc, mean)
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)
        ref = plan(state, mean, sigma, None, grid, cfg, ctrl, mpc, act, noise=noise)
        fns = _kernel_fns()
        _reset(fns)
        got = plan_fn(state, mean, sigma, noise=noise)
        torch.cuda.synchronize()
        launches = _counts(fns)
        log(f"[parallel] (a) NCCL, 1 rank: config-4 sharded solve (N={cfg.n_particles}, "
            f"M={cfg.n_mesh}, K={mpc.n_candidates}, H={mpc.horizon}, Km={mpc.plan_modes}); "
            f"launches {launches}")
        require(_same(torch, got, ref), "[parallel] sharded solve (NCCL, 1 rank) vs plan: bitwise")
        require(launches["spectral_horizon"] == 1 and launches["deposit_cic"] == 1,
                "[parallel] one kernel 1 launch and one deposit (the feedback seed) per solve")
        sharded_ms = _solve_ms(torch, lambda: plan_fn(state, mean, sigma, noise=noise))
        plain_ms = _solve_ms(torch, lambda: plan(state, mean, sigma, None, grid, cfg, ctrl, mpc,
                                                 act, noise=noise))
        log(f"[parallel] (a) solve bitwise equal to plan; ms per solve (synchronised, 5): "
            f"sharded {_spread(sharded_ms)}, plan {_spread(plain_ms)}")

        roll = make_sharded_mpc_rollout(mesh, grid, cfg, ctrl, mpc, act)
        steps = PARALLEL_CFG4_STEPS
        _reset(fns)
        times, st, m, outs = [], state, None, []
        gen = torch.Generator(device=dev).manual_seed(4)
        for _ in range(steps):
            t0 = time.perf_counter()
            out = roll(st, gen, n_steps=1, mean0=m)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            st, m = out.final_state, out.final_mean
            outs.append(out)
        launches = _counts(fns)
        ref = mpc_rollout(state, grid, cfg, ctrl, mpc, act,
                          torch.Generator(device=dev).manual_seed(4), n_steps=steps)
        pe = torch.cat([o.field_energy for o in outs])
        log(f"[parallel] (a) {steps} sharded control steps: launches {launches}; ms per step "
            f"{', '.join(f'{t:.4f}' for t in times)}; PE {pe.tolist()}")
        require(launches["spectral_horizon"] == steps, "[parallel] one kernel 1 launch per step")
        require(launches["deposit_cic"] == 5 * steps and launches["gather_cic"] == 3 * steps,
                "[parallel] five deposits and three gathers per control step")
        require(torch.equal(pe, ref.field_energy) and torch.equal(st.x, ref.final_state.x),
                "[parallel] sharded loop (NCCL, 1 rank) vs mpc_rollout: bitwise")
        log("[parallel] (a) the 3-step sharded loop is bitwise mpc_rollout's")
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "[parallel] group not destroyed")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_parallel_ranks(torch) -> None:
    """[parallel] (b): two ranks of this script on cuda:0 in one gloo group
    (NCCL takes one card per rank). They load the kernel library this
    process built and run :func:`parallel_rank`; this process relays their
    output and checks both finished."""
    import os
    import tempfile

    port = str(_free_port())
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ)
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                                   str(r), port, out], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(PARALLEL_RANKS)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, texts)):
            for line in text.splitlines():
                log(f"[parallel r{r}] {line}")
            require(p.returncode == 0, f"[parallel] rank {r} exited {p.returncode}")
        results = [json.load(open(os.path.join(out, f"rank{r}.json")))
                   for r in range(PARALLEL_RANKS)]
    for r, res in enumerate(results):
        log(f"[parallel] rank {r} launch counts per path: {json.dumps(res['launches'])}")
    log("[parallel] (b) two ranks share one card: these times are collectives through gloo "
        "on one H100, not a multi-GPU scaling figure")


def parallel_rank(rank: int, port: str, out_dir: str) -> int:
    """One rank of [parallel] (b), run as ``chip_smoke.py --parallel-rank R
    PORT DIR``: the checks below, then ``DIR/rank<R>.json``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    from plasma_control_tpu_torch.control.mpc import mpc_rollout, plan, solve_noise
    from plasma_control_tpu_torch.models.pic import diagnostics, init_state, step
    from plasma_control_tpu_torch.ops.deposit import deposit
    from plasma_control_tpu_torch.ops.kernels import _build
    from plasma_control_tpu_torch.parallel.dryrun import dryrun_multichip
    from plasma_control_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from plasma_control_tpu_torch.parallel.pic_shard import (make_particle_sharded_step,
                                                             make_sharded_mpc_rollout,
                                                             make_sharded_plan)

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    # a rank that fails stops its collectives: the other gives up after 120 s
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=PARALLEL_RANKS, timeout=datetime.timedelta(seconds=120))
    path, seconds, _ = _build.build()
    require(seconds == 0.0, "[parallel] a rank compiled the kernels (the parent built them)")
    log(f"rank {rank}/{PARALLEL_RANKS} on {torch.cuda.get_device_name(0)}, gloo; kernel "
        f"library {path.name} loaded, not rebuilt")
    mesh = make_mesh(axis_names=("rollout",), device_type="cuda")
    fns = _kernel_fns()
    launches = {}

    def gathered(t):
        blocks = [torch.empty_like(t) for _ in range(PARALLEL_RANKS)]
        dist.all_gather(blocks, t.contiguous())
        return blocks

    def ranks_equal(*tensors) -> bool:
        return all(all(torch.equal(b[0], b_r) for b_r in b[1:])
                   for b in (gathered(t) for t in tensors))

    def solve_check(name, sim, max_mode, mpc_kw, seed_state):
        cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=sim, max_mode=max_mode, mpc=mpc_kw)
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(seed_state), device=dev)
        mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
        sigma = torch.tensor(mpc.sigma0, device=dev)
        noise = solve_noise(torch.Generator(device=dev).manual_seed(3), mpc, mean)
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)
        ref = plan(state, mean, sigma, None, grid, cfg, ctrl, mpc, act, noise=noise)
        _reset(fns)
        got = plan_fn(state, mean, sigma, noise=noise)
        torch.cuda.synchronize()
        launches[name] = _counts(fns)
        bitwise = _same(torch, got, ref)
        err = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2]))
        rel = abs(float(got[2]) - float(ref[2])) / max(1.0, abs(float(ref[2])))
        require(ranks_equal(*got), f"[parallel] {name}: ranks differ")
        # without bitwise equality: the JAX distributed test's bounds
        require(bitwise or (err <= 1e-5 and rel <= 1e-4), f"[parallel] {name}: {err}, {rel}")
        sharded_ms = _solve_ms(torch, lambda: plan_fn(state, mean, sigma, noise=noise))
        single_ms = _solve_ms(torch, lambda: plan(state, mean, sigma, None, grid, cfg, ctrl, mpc,
                                                  act, noise=noise))
        log(f"{name}: K={mpc.n_candidates} ({mpc.n_candidates // PARALLEL_RANKS} per rank) "
            f"against the one-rank plan on the same draws: bitwise {bitwise} (max |diff| action/"
            f"mean {err:.3g}, best cost rel {rel:.3g}; bounds 1e-5 / 1e-4), ranks bitwise equal; "
            f"launches {launches[name]}; ms per solve: sharded {_spread(sharded_ms)}, one rank "
            f"{_spread(single_ms)}")
        return launches[name]

    # config-4's full-fidelity solve, K=384 per rank
    got = solve_check("config-4 solve", CFG4_SIM, CFG4_MAX_MODE,
                      dict(CFG4_MPC, n_candidates=PARALLEL_RANKS * CFG4_MPC["n_candidates"]), 0)
    require(got["spectral_horizon"] == 1 and got["deposit_cic"] == 1,
            "[parallel] config-4 solve: one kernel 1 launch, one deposit per rank")
    # one grid-slice solve: kernel 6 on each rank's 256 candidates
    got = solve_check("grid solve", SIM, MAX_MODE, GRID_MPC, 0)
    require(got["fused_packed_horizon"] == 1, "[parallel] grid solve: one kernel 6 launch per rank")

    # the twin slice's loop, 5 steps, from a coherent state at which the guard
    # lets the solves through (seeded states make it zero the drive)
    cfg, ctrl, mpc, grid, act = _twin_setup(torch, dev)
    cs = coherent_state(torch, cfg.n_particles, cfg.length, seed=11)
    state = type(cs)(cs.x.to(dev), cs.v.to(dev))
    roll = make_sharded_mpc_rollout(mesh, grid, cfg, ctrl, mpc, act)
    steps = PARALLEL_TWIN_STEPS
    _reset(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = roll(state, torch.Generator(device=dev).manual_seed(6), n_steps=steps)
    torch.cuda.synchronize()
    sharded_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches["twin loop"] = _counts(fns)
    t0 = time.perf_counter()
    ref = mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev).manual_seed(6),
                      n_steps=steps)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0) / steps
    equal = ranks_equal(out.final_state.x, out.final_state.v, out.coeffs, out.field_energy)
    bitwise = torch.equal(out.final_state.x, ref.final_state.x) and torch.equal(out.coeffs,
                                                                               ref.coeffs)
    pe_rel = float(((out.field_energy - ref.field_energy).abs()
                    / ref.field_energy.abs().clamp_min(1e-30)).max())
    a_err = float((out.coeffs - ref.coeffs).abs().max())
    passed = int((out.coeffs != 0).any(-1).sum())
    log(f"twin loop: {steps} steps, K={mpc.n_candidates} ({mpc.n_candidates // PARALLEL_RANKS} "
        f"per rank), plan_particles {mpc.plan_particles}, plan_mesh {mpc.plan_mesh}, Km "
        f"{mpc.plan_modes}, twin correction, guard on ({passed} of {steps} solves drove): ranks "
        f"bitwise equal {equal}; against the one-rank loop bitwise {bitwise}, PE max rel "
        f"{pe_rel:.3g} (bound 1e-4), coefficients max |diff| {a_err:.3g} (bound 1e-4); "
        f"launches {launches['twin loop']}; ms per step sharded {sharded_ms:.4f}, one rank "
        f"{single_ms:.4f}")
    require(equal, "[parallel] twin loop: the ranks' final states differ")
    require(passed > 0, "[parallel] twin loop: the guard zeroed every solve")
    require(bitwise or (pe_rel <= 1e-4 and a_err <= 1e-4), "[parallel] twin loop vs one rank")
    got = launches["twin loop"]
    require(got["spectral_horizon_twin"] == steps and got["gather_cic"] == 3 * steps
            and got["deposit_cic"] >= 5 * steps, "[parallel] twin loop launches")

    # config-5's particle-sharded push: 500000 particles per rank
    mesh_p = make_mesh(axis_names=("particle",), device_type="cuda")
    cfg5, _, _, grid5, _ = _setup(torch, dev, sim=CFG5_SIM)
    st5 = init_state(cfg5, torch.Generator(device=dev).manual_seed(0), device=dev)
    step_fn = make_particle_sharded_step(mesh_p, grid5, cfg5)
    e0 = torch.zeros(cfg5.n_mesh, device=dev)
    x, v = shard_batch((st5.x, st5.v), mesh_p, axis="particle")
    _reset(fns)
    x1, v1 = step_fn(x, v, e0)
    torch.cuda.synchronize()
    launches["particle step"] = _counts(fns)
    full = step(st5, grid5, cfg5, e0)
    x1_all, v1_all = torch.cat(gathered(x1)), torch.cat(gathered(v1))
    dx1 = _periodic_diff(torch, x1_all, full.x, cfg5.length)
    dv1 = float((v1_all - full.v).abs().max())
    log(f"config-5 particle-sharded step: N={cfg5.n_particles} ({x.shape[0]} per rank), "
        f"M={cfg5.n_mesh}: one step against the one-rank step max |dx| {dx1:.3g} (periodic), "
        f"|dv| {dv1:.3g} (atol 1e-4); launches {launches['particle step']}")
    require(dx1 <= 1e-4 and dv1 <= 1e-4, "[parallel] particle-sharded step vs step: atol 1e-4")
    require(launches["particle step"]["deposit_cic"] == 3
            and launches["particle step"]["gather_cic"] == 3,
            "[parallel] three deposits and three gathers per sharded step")
    xs, vs, st, times = x1, v1, full, []
    for _ in range(PARTICLE_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, vs = step_fn(xs, vs, e0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        st = step(st, grid5, cfg5, e0)
    one_rank_ms = _solve_ms(torch, lambda: step(st5, grid5, cfg5, e0), reps=10)
    x_all, v_all = torch.cat(gathered(xs)), torch.cat(gathered(vs))
    pe_sharded = float(diagnostics(type(st)(x_all, v_all), grid5, cfg5)[2])
    pe_full = float(diagnostics(st, grid5, cfg5)[2])
    charge = float(deposit(x_all, grid5, method="pallas").sum()) * grid5.dx
    log(f"config-5 particle-sharded push, {PARTICLE_STEPS} steps: max |dx| "
        f"{_periodic_diff(torch, x_all, st.x, cfg5.length):.3g}, |dv| "
        f"{float((v_all - st.v).abs().max()):.3g} against the one-rank steps; field energy "
        f"{pe_sharded:.9g} sharded, {pe_full:.9g} one rank; charge {charge:.6f} (L = "
        f"{cfg5.length}); ms per sharded step {_spread(times)}, one-rank step "
        f"{_spread(one_rank_ms)}")
    require(abs(charge - cfg5.length) < 1e-2, "[parallel] charge not conserved")
    require(math.isfinite(pe_sharded), "[parallel] sharded push: PE not finite")

    dryrun_multichip(PARALLEL_RANKS, "cuda")
    log("dryrun_multichip(2) on cuda:0: ok")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"launches": launches}, fh)
    dist.destroy_process_group()
    return 0


def run_viz(torch) -> None:
    """[viz]: the plots' field series on the card (one deposit launch for
    all Nt columns) against the CPU's dense deposit, the spectrum from it,
    and run_and_save writing the data where matplotlib is missing."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from plasma_control_tpu_torch import cli
    from plasma_control_tpu_torch.diag.spectrum import spectrum_wavenumbers
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout, snapshot_from_rollout
    from plasma_control_tpu_torch.viz import plots

    dev = torch.device("cuda")
    sim = dict(CFG4_SIM, t_max=VIZ_STEPS * CFG4_SIM["dt"])
    cfg, ctrl, _, grid, _ = _setup(torch, dev, sim=sim, max_mode=CFG4_MAX_MODE, mpc=CFG4_MPC)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = rollout(state, grid, cfg, record_snapshots=True)
    snap = snapshot_from_rollout(out).cpu().numpy()
    m, length = cfg.n_mesh, cfg.length
    fns = _kernel_fns()
    _reset(fns)
    e_card = plots._e_mesh_series(snap, length, m, device="cuda")
    ks, spec_card = plots._spectrum(snap, length, grid.dx, m, device="cuda")
    launches = _counts(fns)
    t0 = time.perf_counter()
    e_cpu = plots._e_mesh_series(snap, length, m, device="cpu")
    cpu_s = time.perf_counter() - t0
    n_keep = len(spectrum_wavenumbers(m, grid.dx))
    spec_cpu = np.abs(np.fft.fft(e_cpu, axis=1) / m * 2.0)[:, :n_keep].T  # _spectrum's formula
    card_ms = _solve_ms(torch, lambda: plots._e_mesh_series(snap, length, m, device="cuda"), 5)
    e_err = float(np.abs(e_card - e_cpu).max())
    s_err = float(np.abs(spec_card - spec_cpu).max())
    log(f"[viz] _e_mesh_series of a ({snap.shape[0]}, {snap.shape[1]}) snapshot (config-4 "
        f"environment, {VIZ_STEPS} steps), M={m}: launches {launches} (one deposit over "
        f"{snap.shape[1]} columns per call); card vs CPU dense: E max |diff| {e_err:.3g} "
        f"(max |E| {float(np.abs(e_cpu).max()):.4g}; atol 1e-4), spectrum max |diff| {s_err:.3g} "
        f"(atol 1e-4), {len(ks)} wavenumbers; ms per call on the card {_spread(card_ms)}, the "
        f"CPU dense version {1e3 * cpu_s:.1f} ms")
    require(launches["deposit_cic"] == 2 and launches["gather_cic"] == 0,
            "[viz] one deposit launch per field series")
    require(e_err <= 1e-4 and s_err <= 1e-4, "[viz] card vs CPU field series / spectrum")

    with tempfile.TemporaryDirectory() as tmp:
        args = dict(save_file=f"{tmp}/d", save_plot=f"{tmp}/p", simcase=cfg.simcase,
                    is_save=True)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.run_and_save("viz", args, cfg, ctrl, snap, out.hamiltonian.cpu().numpy(),
                             out.field_energy.cpu().numpy(), device="cuda")
        saved = os.path.exists(f"{tmp}/d/{cfg.simcase}/viz/data.npz")
        drawn = sorted(os.listdir(f"{tmp}/p/{cfg.simcase}/viz")) if os.path.isdir(
            f"{tmp}/p/{cfg.simcase}/viz") else []
    for line in text.getvalue().splitlines():
        log(f"[viz] run_and_save: {line}")
    require(saved, "[viz] run_and_save wrote no data")
    if plots.matplotlib_available():
        require("log_E.pdf" in drawn, f"[viz] plots drawn: {drawn}")
    else:
        require("not drawn: matplotlib is not installed" in text.getvalue() and not drawn,
                "[viz] run_and_save without matplotlib")
    log(f"[viz] matplotlib {'present' if plots.matplotlib_available() else 'missing'}: "
        f"data written, plots {drawn or 'not drawn'}")


def run_debug(torch) -> None:
    """[debug]: the NaN checks on the card: a torch operation's NaN, a NaN
    position fed to the deposit kernel, and a CUDA-graph capture refused."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from plasma_control_tpu_torch.io.aot import GraphedStep, control_step_fn
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.kernels.cic import deposit_cic
    from plasma_control_tpu_torch.utils import debug

    dev = torch.device("cuda")

    def raises(fn, exc, what):
        try:
            fn()
        except exc as err:
            return str(err)
        raise SystemExit(f"chip_smoke: FAILED: [debug] {what} did not raise {exc.__name__}")

    with debug.nan_checks():
        msg_op = raises(lambda: torch.log(torch.full((8,), -1.0, device=dev)), FloatingPointError,
                        "torch.log of -1 on the card")
    x = torch.rand(5000, device=dev, generator=torch.Generator(device=dev).manual_seed(1)) * 50.0
    x[17] = float("nan")
    silent = deposit_cic(x, 250, 50.0)
    fns = _kernel_fns()
    _reset(fns)
    with debug.nan_checks():
        msg_kernel = raises(lambda: deposit_cic(x, 250, 50.0), FloatingPointError,
                            "the deposit kernel on a NaN position")
    launched = _counts(fns)["deposit_cic"]
    cfg, ctrl, mpc, grid, act = _setup(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = init_state(cfg, gen, device=dev)
    graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
    mean = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
    with debug.nan_checks():
        msg_graph = raises(lambda: graphed.capture(st.x, st.v, mean, gen), RuntimeError,
                           "GraphedStep.capture")
    require(launched == 1 and "deposit_cic" in msg_kernel, "[debug] the deposit's own check")
    require("NaN checks" in msg_graph and graphed.graph is None, "[debug] capture refused")
    require(not debug.nan_checks_enabled() and _get_current_dispatch_mode() is None,
            "[debug] checks left on")
    log(f"[debug] nan_checks on the card: {msg_op!r}; without the checks the deposit kernel "
        f"drops the NaN position (density sum {float(silent.sum()):.6g} for 4999 particles), "
        f"with them its launch ({launched}) raises {msg_kernel!r}; capture refused: "
        f"{msg_graph!r}")


def check_twin_tail(torch) -> None:
    """[twin-tail]: the twin slice's seeded state (seed 0 on the card) rolled
    500 steps uncontrolled twice on the card, through kernels 2-3 and through
    the plain scatter deposit: the tails of the last 20 steps side by side,
    held to the fp32-chaos bound of tests/test_golden.py:137-146 (1 %)."""
    import dataclasses

    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    cfg, _, _, grid, _ = _twin_setup(torch, dev)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    fns = _kernel_fns()
    _reset(fns)
    kernels = rollout(state, grid, cfg).field_energy
    launches = _counts(fns)
    plain = rollout(state, grid, dataclasses.replace(cfg, deposit_method="scatter")).field_energy
    tail_k, tail_p = float(kernels[-20:].mean()), float(plain[-20:].mean())
    rel = abs(tail_k - tail_p) / tail_p
    off = torch.nonzero((kernels - plain).abs() > 1e-2 * plain.abs()).flatten()
    first = int(off[0]) if off.numel() else None
    log(f"[twin-tail] seeded twin-slice state, {kernels.shape[0]} uncontrolled steps: tail PE "
        f"(mean of the last 20) {tail_k:.6g} on kernels 2-3, {tail_p:.6g} on the scatter "
        f"deposit, rel diff {rel:.3g} (fp32-chaos bound 1e-2); first step off by more than 1 %: "
        f"{first}; launches {launches}")
    require(launches["deposit_cic"] > 0 and launches["gather_cic"] > 0, "[twin-tail] kernels")
    require(math.isfinite(tail_k) and math.isfinite(tail_p), "[twin-tail] tails not finite")
    require(rel <= 1e-2, "[twin-tail] kernels 2-3 and the scatter deposit part beyond fp32 chaos")


# experiments/config4_frontier.py's two controlled rows of the port's paths
# (:68-75, :98-101): full fidelity at K=384, and the twin slice under the
# default guard; config-4's environment (quality.CONFIG4) on the CIC kernels
QUALITY_ROWS = (
    ("fullfid_K384", dict(n_candidates=384, horizon=10, plan_modes=16)),
    ("sub10000_K1024_corr_guarded", dict(n_candidates=1024, plan_particles=10000,
                                         plan_correction="twin", horizon=10, plan_modes=16,
                                         plan_mesh=64)),
)
QUALITY_NOISE_SEED = 100  # config4_frontier.py:168,173: seed s draws from cfg.seed + 100 + s
QUALITY_EAGER_STEPS = 5  # seed 0's first replays held bitwise to eager mpc_rollout steps
# the C++ baseline's shape (bench.py:399-411: the headline's full-fidelity
# plan model, N=5000 on 250 cells, L=50, dt 0.1) and its rate's trials
NATIVE_N, NATIVE_M, NATIVE_L, NATIVE_DT = 5000, 250, 50.0, 0.1
NATIVE_CHECK_STEPS = 20
NATIVE_TRIALS, NATIVE_REPS = 5, 100
# [timing]: solves/s at a t=15 state (config4_frontier.py:185-187: 150
# uncontrolled steps), beside ms per control step eager and replayed
TIMING_WARM_STEPS = 150
TIMING_STEPS = 20


def run_native(torch) -> None:
    """[native]: the port's loader of the C++ reference library
    (``utils/native.py``) builds ``native/pic_ref.cpp`` with g++ into
    ``build/plasma_control_tpu_torch/`` of this checkout (timed). At the C++
    baseline's shape (bench.py:399-411: N=5000, M=250) one ``native_step``
    and a NATIVE_CHECK_STEPS-step ``native_rollout`` are held to the port's
    float64 Yoshida-4 step on the CPU at tests/test_native.py's tolerances
    (x and v rtol = atol = 1e-8, PE 1e-6 relative); then the C++ steps/s as
    bench.py takes them (the best of NATIVE_TRIALS trials of NATIVE_REPS
    steps)."""
    import numpy as np

    from plasma_control_tpu_torch.config import SimConfig
    from plasma_control_tpu_torch.models.pic import PlasmaState, diagnostics, step
    from plasma_control_tpu_torch.models.rollout import rollout
    from plasma_control_tpu_torch.ops.grid import make_grid
    from plasma_control_tpu_torch.utils import native

    path = native._library_path()
    built = not path.exists()
    t0 = time.perf_counter()
    lib = native.load_library()
    load_s = time.perf_counter() - t0
    require(lib is not None, "[native] g++ could not build or load native/pic_ref.cpp")
    require(path.parent == native.BUILD_DIR and path.is_file(), f"[native] library at {path}")
    n, m, length, dt = NATIVE_N, NATIVE_M, NATIVE_L, NATIVE_DT
    rng = np.random.default_rng(0)
    x, v = rng.uniform(0, length, n), rng.standard_normal(n)
    cfg = SimConfig(n_particles=n, n_mesh=m, length=length, dt=dt)
    grid = make_grid(m, length, dtype=torch.float64, device="cpu")
    state = PlasmaState(torch.tensor(x), torch.tensor(v))

    xn, vn, pe = native.native_step(x.copy(), v.copy(), m, length, dt)
    st = step(state, grid, cfg)
    pe_port = float(diagnostics(st, grid, cfg)[2])
    err = max(float(np.abs(xn - st.x.numpy()).max()), float(np.abs(vn - st.v.numpy()).max()))
    ok_step = (np.allclose(xn, st.x.numpy(), rtol=1e-8, atol=1e-8)
               and np.allclose(vn, st.v.numpy(), rtol=1e-8, atol=1e-8)
               and abs(pe - pe_port) / pe_port < 1e-6)
    xr, vr, pes = native.native_rollout(x.copy(), v.copy(), m, length, dt, NATIVE_CHECK_STEPS)
    out = rollout(state, grid, cfg, n_steps=NATIVE_CHECK_STEPS)
    pe_ref = out.field_energy[1:].numpy()
    rel = float((np.abs(pes - pe_ref) / pe_ref).max())
    err_roll = max(float(np.abs(xr - out.final_state.x.numpy()).max()),
                   float(np.abs(vr - out.final_state.v.numpy()).max()))
    ok_roll = (rel < 1e-6 and np.allclose(xr, out.final_state.x.numpy(), rtol=1e-8, atol=1e-8)
               and np.allclose(vr, out.final_state.v.numpy(), rtol=1e-8, atol=1e-8))
    how = f"built (g++ {' '.join(native.CXX_FLAGS)}) and loaded" if built else "loaded"
    log(f"[native] {path.relative_to(native.BUILD_DIR.parents[1])}: {how} in {load_s:.2f} s; "
        f"at N={n}, M={m}: one step against the "
        f"port's float64 step max |diff| {err:.3g} in x, v (1e-8), PE {pe:.10g} vs "
        f"{pe_port:.10g}; {NATIVE_CHECK_STEPS}-step rollout PE max rel {rel:.3g} (1e-6), "
        f"final x, v max |diff| {err_roll:.3g}")
    require(ok_step, "[native] native_step against the port's float64 step")
    require(ok_roll, "[native] native_rollout against the port's float64 rollout")

    native.native_step(x.copy(), v.copy(), m, length, dt)  # warm
    rates = []
    for _ in range(NATIVE_TRIALS):
        xt, vt = x.copy(), v.copy()
        t0 = time.perf_counter()
        for _ in range(NATIVE_REPS):
            xt, vt, _ = native.native_step(xt, vt, m, length, dt)
        rates.append(NATIVE_REPS / (time.perf_counter() - t0))
    log(f"[native] C++ reference step at N={n}, M={m}, one host core: best {max(rates):.2f} "
        f"steps/s of {NATIVE_TRIALS} trials of {NATIVE_REPS} ({', '.join(f'{r:.2f}' for r in rates)})")


def run_quality(torch) -> None:
    """[quality]: the port's control quality on the reference's own states,
    config-4 at its published shapes (two-stream, N=100000, M=256, max_mode
    8, 500 steps; CIC kernels), against
    artifacts/results_r5/config4_frontier.json read at run time:

    a. uncontrolled, each of the 8 handed states (``diag/quality.py``):
       the tail PE (mean of the last fifth of ``field_energy[1:]``) within
       ``quality.PAIRED_RTOL`` of the artifact's, seed by seed (the runs are
       deterministic given the state); 4 deposits and 3 gathers per step;
    b. each of QUALITY_ROWS from the same 8 states, through the control step
       captured as a CUDA graph (``io/aot.py``; seed 0's first
       QUALITY_EAGER_STEPS replays bitwise eager ``mpc_rollout``), the MPC
       noise drawn from a generator seeded cfg.seed + 100 + s (JAX's draws
       cannot be redrawn, so the rows are compared as distributions): the
       ratio of the means in ``quality.MEAN_RATIO`` and the two-sided
       Mann-Whitney p >= ``quality.MIN_P``;
    c. every trace finite; the wrapper launches of the eager warm-up steps
       and the captured step as in ``[config-4]`` / ``[twin]`` (one launch
       of kernel 1, or 1c, per solve, three gathers and at least five
       deposits per step), none in the replays.

    Every per-seed tail, peak and gamma is printed beside the artifact's
    before the gates are decided. The damping row's states and gates are
    ``[damping]``'s."""
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.diag import quality
    from plasma_control_tpu_torch.io.aot import GraphedStep, aot_mpc_rollout, control_step_fn
    from plasma_control_tpu_torch.models.rollout import rollout

    dev = torch.device("cuda")
    ref = quality.frontier_reference()
    states = quality.reference_states("config4", device=dev)
    require(len(states) == quality.CONFIG4_SEEDS == len(ref["uncontrolled"]),
            "[quality] one handed state per reference seed")
    sim = dict(quality.CONFIG4, deposit_method="pallas")
    fns = _kernel_fns()
    tails, gates = {}, {}

    cfg, ctrl, _, grid, act = _setup(torch, dev, sim=sim, max_mode=CFG4_MAX_MODE)
    steps = cfg.n_steps
    tails["uncontrolled"] = []
    t0 = time.perf_counter()
    for s, state in enumerate(states):
        _reset(fns)
        pe = rollout(state, grid, cfg).field_energy[1:]
        launches = _counts(fns)
        require(pe.shape == (steps,) and bool(torch.isfinite(pe).all()),
                f"[quality] uncontrolled seed {s}: PE trace")
        require(launches["deposit_cic"] == 4 * steps + 1 and launches["gather_cic"] == 3 * steps
                and sum(launches.values()) == 7 * steps + 1,
                f"[quality] uncontrolled seed {s}: launches {launches}")
        st = quality.frontier_stats(pe, cfg.t_max, steps)
        tails["uncontrolled"].append(st["tail_pe"])
        log(f"[quality] uncontrolled seed {s}: tail PE {st['tail_pe']:.6f} (reference "
            f"{ref['uncontrolled'][s]}), peak {st['peak_pe']:.6f}, gamma "
            f"{st['gamma_decay_phase']:.6f}")
    gates["uncontrolled"] = quality.paired_gate(tails["uncontrolled"], ref["uncontrolled"])
    log(f"[quality] uncontrolled: {quality.CONFIG4_SEEDS} x {steps} steps in "
        f"{time.perf_counter() - t0:.2f} s; rel diff per seed "
        f"{', '.join(f'{r:.3g}' for r in gates['uncontrolled'].rel)} (bound "
        f"{quality.PAIRED_RTOL}): {'pass' if gates['uncontrolled'].ok else 'FAIL'}")

    calls = GraphedStep.WARMUP + 1  # eager warm-up steps and the captured one
    for name, mpc_kw in QUALITY_ROWS:
        cfg, ctrl, mpc, grid, act = _setup(torch, dev, sim=sim, max_mode=CFG4_MAX_MODE, mpc=mpc_kw)
        twin = mpc.plan_correction == "twin"
        tails[name], walls = [], []
        for s, state in enumerate(states):
            graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
            noise_seed = cfg.seed + QUALITY_NOISE_SEED + s
            _reset(fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = aot_mpc_rollout(graphed, state, torch.Generator(device=dev).manual_seed(noise_seed),
                                  steps, mpc.horizon, ctrl.n_actions)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = _counts(fns)
            want = dict(spectral_horizon=calls, spectral_horizon_twin=calls if twin else 0,
                        gather_cic=3 * calls, fused_leapfrog_step=0, fused_kdk_horizon=0,
                        fused_packed_horizon=0)
            require(all(launches[k] == w for k, w in want.items())
                    and launches["deposit_cic"] >= 5 * calls,
                    f"[quality] {name} seed {s}: wrapper launches {launches} for {calls} eager "
                    f"steps, want {want} and >= {5 * calls} deposits")
            for what in ("field_energy", "coeffs", "plan_cost", "input_energy"):
                t = getattr(out, what)
                require(t.shape[0] == steps and bool(torch.isfinite(t).all()),
                        f"[quality] {name} seed {s}: {what} not finite")
            if s == 0:
                eager = mpc_rollout(state, grid, cfg, ctrl, mpc, act,
                                    torch.Generator(device=dev).manual_seed(noise_seed),
                                    n_steps=QUALITY_EAGER_STEPS)
                k = QUALITY_EAGER_STEPS
                require(torch.equal(eager.field_energy, out.field_energy[:k])
                        and torch.equal(eager.coeffs, out.coeffs[:k]),
                        f"[quality] {name}: the first {k} replays differ from eager steps")
            st = quality.frontier_stats(out.field_energy, cfg.t_max, steps)
            tails[name].append(st["tail_pe"])
            passed = int((out.coeffs != 0).any(-1).sum())
            log(f"[quality] {name} seed {s}: tail PE {st['tail_pe']:.6f} (reference seed "
                f"{ref[name][s]}), peak {st['peak_pe']:.6f}, gamma "
                f"{st['gamma_decay_phase']:.6f}, input energy mean "
                f"{float(out.input_energy.mean()):.6f}, solves that drove {passed} of {steps}; "
                f"{walls[-1]:.3f} s ({1e3 * walls[-1] / steps:.4f} ms per step, capture included)")
        gates[name] = quality.distribution_gate(tails[name], ref[name])
        mean, ref_mean = statistics.fmean(tails[name]), statistics.fmean(ref[name])
        log(f"[quality] {name}: tail PE mean {mean:.6f} against the reference's {ref_mean:.6f}, "
            f"ratio {gates[name].ratio:.4f} (bounds {quality.MEAN_RATIO[0]:.4f}-"
            f"{quality.MEAN_RATIO[1]:.4f}), Mann-Whitney two-sided p {gates[name].p:.4g} (>= "
            f"{quality.MIN_P}); the seed-0 first {QUALITY_EAGER_STEPS} replays bitwise eager; "
            f"{sum(walls):.2f} s: {'pass' if gates[name].ok else 'FAIL'}")
    log(f"[quality] summary: {json.dumps({n: {'port': tails[n], 'reference': ref[n]} for n in tails})}")
    failed = [n for n, g in gates.items() if not g.ok]
    require(not failed, f"[quality] gates failed: {failed}")


def run_timing(torch) -> None:
    """[timing]: ``utils/timing.py::mpc_solve_rate`` (its default chains of
    2 and 52 warm-started solves, 5 trials) for the spectral, grid and twin
    slices and config-4's ``fullfid_K384``, each at a t=15 state
    (TIMING_WARM_STEPS uncontrolled steps from the slice's seeded state; the
    config-4 rows from the reference's seed-0 state); one launch of the
    slice's planner kernel per solve asserted. Beside it, ms per control step
    eager (``control_step_fn``) and replayed (``GraphedStep``) from that
    state, host clock, the card synchronised each step, TIMING_STEPS steps."""
    from plasma_control_tpu_torch.diag import quality
    from plasma_control_tpu_torch.io.aot import GraphedStep, control_step_fn
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.models.rollout import rollout
    from plasma_control_tpu_torch.utils.timing import mpc_solve_rate

    dev = torch.device("cuda")
    cfg4 = dict(sim=dict(quality.CONFIG4, deposit_method="pallas"), max_mode=CFG4_MAX_MODE)
    slices = (("spectral", dict(mpc=MPC), "spectral_horizon"),
              ("grid", dict(mpc=GRID_MPC), "fused_packed_horizon"),
              ("twin", dict(cfg4, mpc=TWIN_MPC), "spectral_horizon_twin"),
              ("fullfid_K384", dict(cfg4, mpc=dict(QUALITY_ROWS)["fullfid_K384"]),
               "spectral_horizon"))
    fns = _kernel_fns()
    r1, r2, trials = 2, 52, 5  # mpc_solve_rate's defaults
    for name, kw, kernel in slices:
        cfg, ctrl, mpc, grid, act = _setup(torch, dev, **kw)
        if cfg.n_particles == quality.CONFIG4["n_particles"]:
            state = quality.reference_states("config4", device=dev)[0]
        else:
            state = init_state(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), device=dev)
        state = rollout(state, grid, cfg, n_steps=TIMING_WARM_STEPS).final_state
        _reset(fns)
        rate = mpc_solve_rate(state, grid, cfg, ctrl, mpc, act, r1, r2, trials, seed=13)
        solves = r1 + r2 + trials * (r1 + r2)
        launches = _counts(fns)
        require(launches[kernel] == solves, f"[timing] {name}: {launches[kernel]} launches of "
                                            f"{kernel} for {solves} solves")
        require(math.isfinite(rate["solves_per_s"]) and rate["solves_per_s"] > 0,
                f"[timing] {name}: no positive slope in {rate['sec_per_solve_all']}")

        gen = torch.Generator(device=dev).manual_seed(14)
        zero = torch.zeros((mpc.horizon, ctrl.n_actions), device=dev)
        eager_step = control_step_fn(grid, cfg, ctrl, mpc, act)
        graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
        times = {}
        for what, fn in (("eager", eager_step), ("replay", graphed)):
            carry = [state.x, state.v, zero]
            carry[:] = fn(*carry, gen)[:3]  # warm-up; the graph's capture

            def call(fn=fn, carry=carry):
                carry[:] = fn(*carry, gen)[:3]

            times[what] = synced_ms(torch, call, TIMING_STEPS)
        log(f"[timing] {name} (N={cfg.n_particles}, K={mpc.n_candidates}, H={mpc.horizon}) at "
            f"t={TIMING_WARM_STEPS * cfg.dt:g}: {rate['solves_per_s']:.2f} solves/s (chains of "
            f"{r1} and {r2} warm-started solves, median of the positive slopes of {trials}: "
            f"{', '.join(f'{1e3 * t:.4f}' for t in rate['sec_per_solve_all'])} ms per solve); "
            f"r2-chain wall {rate['wall_chain_s']:.4f} s, first chain {rate['compile_s']:.4f} s; "
            f"ms per control step: eager {_spread(times['eager'])}, replay "
            f"{_spread(times['replay'])}")


def run_surface(torch, card: str) -> None:
    """[surface]: the library-use path through the package's top-level
    names, as a user calls them (phase 9)."""
    import dataclasses

    import torch.distributed as dist

    import plasma_control_tpu_torch as pct
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.control.mpc import mpc_rollout
    from plasma_control_tpu_torch.parallel.launch import initialize_distributed

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    fns = _kernel_fns()

    # (a) the README's example, as written, then with the CIC kernels
    cfg = pct.SimConfig(**SURFACE_SIM)
    grid = pct.make_grid(cfg.n_mesh, cfg.length, device=dev)
    state = pct.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    _reset(fns)
    out = pct.rollout(state, grid, cfg)
    torch.cuda.synchronize()
    launches = _counts(fns)
    pe = out.field_energy
    require(pe.shape == (cfg.n_steps + 1,) and bool(torch.isfinite(pe).all()),
            "[surface] (a) rollout: PE shape or finiteness")
    require(not any(launches.values()), f"[surface] (a) the dense rollout launched {launches}")
    ctrl = pct.ControlConfig(max_mode=SURFACE_MAX_MODE)
    mpc = pct.MPCConfig(**SURFACE_MPC)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, device=dev)
    _reset(fns)
    res = mpc_rollout(state, grid, cfg, ctrl, mpc, act, torch.Generator(device=dev).manual_seed(1),
                      n_steps=SURFACE_MPC_STEPS)
    torch.cuda.synchronize()
    launches = _counts(fns)
    log(f"[surface] (a) README example, {cfg.simcase}, N={cfg.n_particles}, M={cfg.n_mesh}: "
        f"rollout of {cfg.n_steps} steps (dense), tail PE {float(pe[-cfg.n_steps // 5:].mean()):.6g}; "
        f"mpc_rollout {SURFACE_MPC_STEPS} steps (max_mode {ctrl.max_mode}, K={mpc.n_candidates}, "
        f"H={mpc.horizon}, plan {mpc.plan_particles}/{mpc.plan_mesh}): launches {launches}, PE "
        f"{res.field_energy[0].item():.6g} -> {res.field_energy[-1].item():.6g}")
    require(launches["spectral_horizon"] == SURFACE_MPC_STEPS and not launches["spectral_horizon_twin"],
            "[surface] (a) one launch of kernel 1 per solve")
    require(bool(torch.isfinite(res.field_energy).all()), "[surface] (a) mpc_rollout PE not finite")
    _reset(fns)
    out_k = pct.rollout(state, grid, dataclasses.replace(cfg, deposit_method="pallas"))
    torch.cuda.synchronize()
    launches = _counts(fns)
    t_steps = cfg.n_steps
    rel = ((out_k.field_energy - pe).abs() / pe.abs()).max().item()
    log(f"[surface] (a) the same rollout on the CIC kernels: launches {launches}; PE max rel "
        f"diff to the dense trace {rel:.3g} over {t_steps} steps (bound 1e-2)")
    require(launches["deposit_cic"] == 4 * t_steps + 1 and launches["gather_cic"] == 3 * t_steps,
            "[surface] (a) 4T+1 deposits and 3T gathers")
    require(rel < 1e-2, f"[surface] (a) CIC kernels vs dense PE: {rel}")

    # (b) every preset's PIC at its full width, on the CIC kernels
    for name in SURFACE_PRESETS:
        cfg = pct.preset(name, deposit_method="pallas")
        t1 = time.perf_counter()
        pic = pct.PIC(cfg)
        _reset(fns)
        energies = []
        for _ in range(SURFACE_PIC_STEPS):
            pic.update_state()
            energies.append((pic.get_electric_energy().item(), pic.get_energy().item()))
        launches = _counts(fns)
        log(f"[surface] (b) PIC(preset({name!r})): N={cfg.n_particles}, M={cfg.n_mesh}, "
            f"dt={cfg.dt}; {SURFACE_PIC_STEPS} steps, (PE, H) {energies}; launches "
            f"{launches}; {time.perf_counter() - t1:.2f} s")
        require(all(math.isfinite(e) for pair in energies for e in pair),
                f"[surface] (b) {name}: energies not finite")
        require(launches["deposit_cic"] == 5 * SURFACE_PIC_STEPS
                and launches["gather_cic"] == 3 * SURFACE_PIC_STEPS,
                f"[surface] (b) {name}: 5 deposits and 3 gathers per step")
        del pic

    # (c) the process group: NCCL with no device type given
    require(not dist.is_initialized(), "[surface] (c) a process group before the phase")
    try:
        active = initialize_distributed(f"localhost:{_free_port()}", 1, 0)
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"[surface] (c) initialize_distributed(address, 1, 0): {backend}, multi-process "
        f"{active}; destroyed")
    require(backend == "nccl" and active is False, f"[surface] (c) backend {backend}")
    log(f"[surface] {time.perf_counter() - t0:.1f} s wall on {card}")


def timed(fn, *args):
    """``fn(*args)``, logging its wall time (``[phase]``)."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


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
        "spectral_horizon_twin": dict(
            source="plasma_control_tpu_torch/csrc/spectral_horizon.cu",
            replaces="plasma_control_tpu/ops/pallas/spectral_horizon.py:303"),
        "deposit_cic_twin": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                                 replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:91"),
        "spectral_horizon_million": dict(
            source="plasma_control_tpu_torch/csrc/spectral_horizon.cuh",
            replaces="plasma_control_tpu/ops/pallas/spectral_horizon.py:303"),
        "spectral_horizon_twin_km32": dict(
            source="plasma_control_tpu_torch/csrc/spectral_horizon.cuh",
            replaces="plasma_control_tpu/ops/pallas/spectral_horizon.py:303"),
        "fused_leapfrog_step_m4096": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                          replaces="experiments/pallas_fused_step.py:165"),
        "fused_kdk_horizon_m4096": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                        replaces="experiments/pallas_fused_step.py:301"),
        "fused_packed_horizon_m4096": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                           replaces="experiments/pallas_fused_step.py:452"),
        "gather_cic_100k": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                                replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:122"),
        "gather_cic_million": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                                   replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:122"),
        "deposit_cic_damping": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                                    replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:91"),
        "gather_cic_damping": dict(source="plasma_control_tpu_torch/csrc/cic.cu",
                                   replaces="plasma_control_tpu/ops/pallas/cic_pallas.py:122"),
        "spectral_horizon_dagger": dict(
            source="plasma_control_tpu_torch/csrc/spectral_horizon.cu",
            replaces="plasma_control_tpu/ops/pallas/spectral_horizon.py:303"),
        "twin_trajectory": dict(
            source="plasma_control_tpu_torch/csrc/twin_trajectory.cu",
            replaces="none: plasma_control_tpu/control/mpc.py::twin_targets, in XLA ops"),
        "fidelity_ratio": dict(
            source="plasma_control_tpu_torch/csrc/fidelity_ratio.cu",
            replaces="none: plasma_control_tpu/control/mpc.py::_fidelity_ratio, in XLA ops"),
        "fidelity_ratio_grid": dict(
            source="plasma_control_tpu_torch/csrc/fidelity_ratio.cu",
            replaces="none: plasma_control_tpu/control/mpc.py::_fidelity_ratio, in XLA ops"),
        "fused_packed_horizon_fullfid": dict(source="plasma_control_tpu_torch/csrc/fused_step.cu",
                                             replaces="experiments/pallas_fused_step.py:452"),
    }
    timed(check_kernels, torch, rows)
    timed(check_grid_kernels, torch, rows)
    timed(check_twin_kernel, torch, rows)
    timed(check_guard_kernel, torch, rows)
    timed(run_guard_turns, torch, None)
    timed(check_global_scratch, torch)
    timed(check_wide_modes, torch)
    timed(check_wide_mesh, torch, rows)
    timed(check_gather_large, torch, rows)
    timed(check_damping_kernels, torch, rows)
    timed(run_slice, torch, rows)
    end_state = timed(run_grid_slice, torch, rows)
    timed(run_leapfrog_loop, torch, rows)
    timed(run_kdk_horizon, torch, rows, end_state)
    timed(run_config4, torch)
    timed(run_twin_slice, torch, rows)
    timed(run_entry_point, torch)
    timed(run_million, torch, rows)
    timed(run_grid_fullfid, torch, rows)
    timed(run_twin_km32, torch, rows)
    timed(run_feedback, torch)
    timed(run_damping, torch, rows)
    timed(run_batch, torch)
    timed(run_golden, torch)
    timed(run_entry_scripts, torch)
    timed(run_learned, torch)
    timed(run_dagger, torch, rows)
    timed(run_rl_train, torch)
    timed(run_gradrefine, torch)
    timed(run_entry_rl, torch)
    timed(run_resume, torch)
    timed(run_resume_train, torch)
    timed(run_aot, torch)
    timed(run_aot_cold, torch)
    timed(check_against_cpu, torch)
    timed(check_grid_against_cpu, torch, end_state)
    timed(check_twin_against_cpu, torch)
    timed(check_new_loops_against_cpu, torch)
    timed(check_rl_against_cpu, torch)
    timed(check_loops_repeat, torch)
    timed(run_parallel_nccl, torch)
    timed(run_parallel_ranks, torch)
    timed(run_viz, torch)
    timed(run_debug, torch)
    timed(check_twin_tail, torch)
    timed(run_native, torch)
    timed(run_quality, torch)
    timed(run_timing, torch)
    timed(run_surface, torch, card)
    log(f"[total] {time.perf_counter() - t_start:.1f} s wall, build included")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         **{key: r[key] for key in keys}}
        for name, r in rows.items()
    ]
    for row in kernels:
        log(f"[bound] {row['name']}: {rows[row['name']]['ops']:.4g} operations, "
            f"{rows[row['name']]['bytes']:.4g} bytes -> bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}); kernel {row['ms']:.4f} ms per call = "
            f"{100 * row['bound_ms'] / row['ms']:.2f} % of the bound's rate; device "
            f"{row['device_ms']:.5f} ms per launch = {100 * row['bound_ms'] / row['device_ms']:.2f} %")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_guard(parent: str | None) -> int:
    """``--guard [PARENT_DIR]``: the card, the build and ``[guard]`` alone."""
    import torch

    find_card(torch)
    build_kernels()
    rows = {row: {} for row, *_ in GUARD_SLICES}
    timed(check_guard_kernel, torch, rows)
    timed(run_guard_turns, torch, parent)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0)}}), flush=True)
    return 0


def main_grid_fullfid() -> int:
    """``--grid-fullfid``: the card, the build and ``[grid-fullfid]`` alone."""
    import torch

    find_card(torch)
    build_kernels()
    rows = {"fused_packed_horizon_fullfid": {}}
    timed(run_grid_fullfid, torch, rows)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0)}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--guard-steps"]:
        print(json.dumps(guard_cell_steps(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))))
        sys.exit(0)
    if sys.argv[1:2] == ["--guard"]:
        sys.exit(main_guard(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--grid-fullfid"]:
        sys.exit(main_grid_fullfid())
    sys.exit(main())
