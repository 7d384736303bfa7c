"""Golden gates for the PyTorch port, the counterpart of tests/test_golden.py:

* the reference's own DDPG and PPO evaluation runs (``tests/data/
  ddpg_golden_*.npz``) replayed through the port's ``rollout`` with the CIC
  kernels' path (``deposit_method="pallas"``, here their O(N) plain
  versions), held to the JAX test's float32 tolerances;
* the uncontrolled and feedback-controlled PE traces of the JAX tests'
  configurations (N=2000, M=64, 80 steps, the JAX package's seeded states
  handed across) against float64 references of the reference semantics
  built from tests/oracle.py, and, where the native library is already
  available, against it too, within the BASELINE 1 %.
"""

import os
import time

import numpy as np
import jax
import pytest
import torch

from plasma_control_tpu.config import SimConfig as JSimConfig
from plasma_control_tpu.models.pic import init_state as jinit_state
from plasma_control_tpu_torch.config import ControlConfig, SimConfig
from plasma_control_tpu_torch.control.actuator import make_actuator
from plasma_control_tpu_torch.control.feedback import feedback_rollout
from plasma_control_tpu_torch.interop import state_from_numpy, tensor_from_numpy
from plasma_control_tpu_torch.models.rollout import rollout
from plasma_control_tpu_torch.ops.grid import make_grid

import oracle

torch.set_num_threads(1)

L, M, N, DT = 50.0, 64, 2000, 0.1
K = 3  # control modes
TRACES = {"two_stream_uncontrolled": ("two-stream", 42, False),
          "two_stream_feedback": ("two-stream", 42, True),
          "bump_on_tail_feedback": ("bump-on-tail", 7, True)}
# the JAX test's tolerances (tests/test_golden.py TestReferenceDDPGGolden)
F32_TOL = {"two_stream": 0.01, "bump_on_tail": 0.01, "two_stream_ppo": 0.05}
F32_WINDOW_750_TOL = 0.01


def _load_golden(case):
    path = os.path.join(os.path.dirname(__file__), "data", f"ddpg_golden_{case}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden npz missing: {path}")
    return np.load(path)


def _replay_inputs(d):
    """Actuator mesh fields of replay steps 1..T-1: snapshot column t and
    PE[t] are recorded after step t, coefficient column t is the action of
    step t, on the reference's endpoint-inclusive actuator mesh."""
    n_mesh, length = int(d["n_mesh"]), float(d["length"])
    cc, cs = d["coeff_cos"], d["coeff_sin"]
    k = 2.0 * np.pi / length * np.arange(1, cc.shape[0] + 1)
    xm = np.linspace(0.0, length, n_mesh)
    return (np.cos(np.outer(xm, k)) @ cc[:, 1:] + np.sin(np.outer(xm, k)) @ cs[:, 1:]).T


@pytest.mark.parametrize("case", sorted(F32_TOL))
def test_reference_controller_replay_within_tolerance(case):
    """The reference controller's recorded actions through the port's
    float32 dynamics: PE(0) within 1e-5, the trace within 1 % through step
    750 and within the case's tolerance over the whole horizon (1 % for
    the 499-step DDPG cases, 5 % for the 999-step PPO case, whose fp32 chaos
    the JAX test documents)."""
    d = _load_golden(case)
    n_mesh, length, dt = int(d["n_mesh"]), float(d["length"]), float(d["dt"])
    t_steps = int(d["pe"].shape[0]) - 1
    cfg = SimConfig(simcase=str(d["simcase"]), n_particles=int(d["n_particles"]), n_mesh=n_mesh,
                    dt=dt, t_max=dt * t_steps, length=length, deposit_method="pallas")
    t0 = time.perf_counter()
    out = rollout(state_from_numpy(d["x0"], d["v0"], device="cpu"),
                  make_grid(n_mesh, length, device="cpu"), cfg,
                  e_external_traj=tensor_from_numpy(_replay_inputs(d), device="cpu"), n_steps=t_steps)
    pe = out.field_energy.numpy()
    seconds = time.perf_counter() - t0
    ref = d["pe"]
    assert abs(pe[0] - ref[0]) / abs(ref[0]) < 1e-5
    rel = np.abs(pe[1:] - ref[1:]) / np.abs(ref[1:])
    assert rel[:750].max() < F32_WINDOW_750_TOL, f"{rel[:750].max():.4f} through step 750"
    assert rel.max() < F32_TOL[case], f"max relative PE error {rel.max():.4f}"
    print(f"{case}: {t_steps} steps in {seconds:.2f} s on the CPU, max rel {rel.max():.3e}")


def _jax_state(simcase, seed):
    """The JAX golden tests' seeded initial state, as float32 numpy."""
    cfg = JSimConfig(simcase=simcase, n_particles=N, n_mesh=M, dt=DT, t_max=8.0, length=L)
    st = jinit_state(cfg, jax.random.PRNGKey(seed))
    return np.asarray(st.x), np.asarray(st.v)


def _oracle_trace(x, v, steps, feedback):
    """The reference semantics in float64 numpy: PE after each step, the
    phase-conjugate law on modes 1..K of the self-consistent field when
    ``feedback``."""
    xm = np.linspace(0.0, L, M)
    k = 2 * np.pi / L * np.arange(1, K + 1)
    basis_cos, basis_sin = np.cos(np.outer(xm, k)), np.sin(np.outer(xm, k))
    pes = []
    for _ in range(steps):
        e_ext = None
        if feedback:
            ek = np.fft.fft(oracle.solve_e_mesh(oracle.deposit_cic(x, 1.0, L, M), L, 1.0)) / M * 2.0
            e_ext = basis_cos @ -np.real(ek[1: K + 1]) + basis_sin @ np.imag(ek[1: K + 1])
        x, v = oracle.yoshida4_step(x, v, L, M, 1.0, DT, e_ext)
        pes.append(oracle.electric_energy(x, L, M, 1.0))
    return np.asarray(pes)


def _native_trace(x, v, steps, feedback, lib):
    """The same in float64 through the native C++ reference library."""
    from plasma_control_tpu.utils.native import native_solve_e, native_step

    xm = np.linspace(0.0, L, M)
    k = 2 * np.pi / L * np.arange(1, K + 1)
    basis_cos, basis_sin = np.cos(np.outer(xm, k)), np.sin(np.outer(xm, k))
    pes = []
    for _ in range(steps):
        e_ext = None
        if feedback:
            ek = np.fft.fft(native_solve_e(oracle.deposit_cic(x, 1.0, L, M) - 1.0, L)) / M * 2.0
            e_ext = basis_cos @ -np.real(ek[1: K + 1]) + basis_sin @ np.imag(ek[1: K + 1])
        x, v, pe = native_step(x, v, M, L, DT, e_external=e_ext)
        pes.append(pe)
    return np.asarray(pes)


def _port_trace(name, method):
    simcase, seed, feedback = TRACES[name]
    x, v = _jax_state(simcase, seed)
    cfg = SimConfig(simcase=simcase, n_particles=N, n_mesh=M, dt=DT, t_max=8.0, length=L,
                    deposit_method=method)
    st, grid = state_from_numpy(x, v, device="cpu"), make_grid(M, L, device="cpu")
    if feedback:
        pe = feedback_rollout(st, grid, cfg, ControlConfig(max_mode=K),
                              make_actuator(L, M, K, device="cpu")).field_energy
    else:
        pe = rollout(st, grid, cfg).field_energy[1:]
    return x.astype(np.float64), v.astype(np.float64), cfg.n_steps, feedback, pe.numpy()


@pytest.mark.parametrize("method", ["dense", "pallas"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_pe_trace_matches_float64_oracle(name, method):
    """80 steps of the port in float32 against the float64 oracle from the
    same state: every PE within 1 % (BASELINE tolerance)."""
    x, v, steps, feedback, pe = _port_trace(name, method)
    ref = _oracle_trace(x, v, steps, feedback)
    rel = np.abs(pe - ref) / np.abs(ref)
    assert rel.max() < 0.01, f"max relative PE error {rel.max():.4f}"


@pytest.mark.parametrize("name", sorted(TRACES))
def test_pe_trace_matches_native_reference(name):
    """The same traces against the native float64 C++ library, where it is
    already available (the JAX golden tests skip alike without it)."""
    from plasma_control_tpu.utils.native import load_library

    lib = load_library()
    if lib is None:
        pytest.skip("native library unavailable")
    x, v, steps, feedback, pe = _port_trace(name, "pallas")
    ref = _native_trace(x, v, steps, feedback, lib)
    rel = np.abs(pe - ref) / np.abs(ref)
    assert rel.max() < 0.01, f"max relative PE error {rel.max():.4f}"
