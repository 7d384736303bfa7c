"""The port's host utilities against the JAX package's: ``MetricsLogger``
(``utils/metrics.py``) writing the same records from tensors as the JAX
one writes from arrays, and the NaN checks (``utils/debug.py``) raising
``FloatingPointError`` where ``jax_debug_nans`` does, in forward and
backward operations and in the kernel wrappers, with the previous state put
back. The refusal of a CUDA-graph capture while the checks are on, and a
kernel fed a NaN on the card, need the card (``cuda`` marker):
``python -m pytest tests/test_torch_utils.py --noconftest -m cuda``."""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from plasma_control_tpu_torch.utils import debug
from plasma_control_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in open(path)]


def test_metrics_logger_matches_jax(tmp_path):
    """TestMetrics' records, written from tensors (and numpy), equal the JAX
    logger's from jax and numpy arrays, timestamps aside."""
    import jax.numpy as jnp

    from plasma_control_tpu.utils.metrics import MetricsLogger as JMetricsLogger

    path, jpath = str(tmp_path / "m.jsonl"), str(tmp_path / "j.jsonl")
    with MetricsLogger(path, run="test") as log:
        rec = log.log("step", t=1, pe=torch.tensor(0.5))
        log.log_series("trace", {"pe": torch.arange(3.0), "h": np.ones(2)})
    with JMetricsLogger(jpath, run="test") as jlog:
        jlog.log("step", t=1, pe=jnp.asarray(0.5))
        jlog.log_series("trace", {"pe": jnp.arange(3.0), "h": np.ones(2)})
    lines = _records(path)
    assert lines == _records(jpath)
    assert lines[0]["kind"] == "step" and lines[0]["run"] == "test" and lines[0]["pe"] == 0.5
    assert lines[1]["pe"] == [0.0, 1.0, 2.0] and lines[1]["chunk"] == 0
    assert rec["pe"] == 0.5


def test_metrics_logger_without_a_path_returns_records():
    log = MetricsLogger(None, run="x")
    assert log.log("k", a=torch.ones(2))["a"] == [1.0, 1.0]
    log.close()


def test_nan_checks_raise_like_jax():
    """A NaN made by an operation raises FloatingPointError inside the
    context, in both packages, and the checks are off again after it."""
    import jax
    import jax.numpy as jnp

    from plasma_control_tpu.utils.debug import nan_checks as jnan_checks

    with pytest.raises(FloatingPointError):
        with jnan_checks():
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
    with pytest.raises(FloatingPointError, match="aten.log"):
        with debug.nan_checks():
            torch.log(torch.tensor(-1.0))
    assert not debug.nan_checks_enabled()
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # off: no check


def test_nan_checks_see_the_backward_pass():
    w = torch.zeros(3, requires_grad=True)
    loss = (torch.sqrt(w) * 0.0).sum()
    with pytest.raises(FloatingPointError):
        with debug.nan_checks():
            loss.backward()


def test_nan_checks_pass_finite_work_and_fresh_buffers():
    """Finite results and the uninitialised memory of ``torch.empty`` (which
    the kernel wrappers allocate and the kernels fill) do not raise."""
    with debug.nan_checks():
        out = torch.empty(4096)
        y = torch.linspace(0.0, 1.0, 8).exp().sum()
    assert out.shape == (4096,) and torch.isfinite(y)


def test_nan_checks_restore_the_previous_state():
    debug.enable_nan_checks(True)
    try:
        with debug.nan_checks():
            assert debug.nan_checks_enabled()
        assert debug.nan_checks_enabled()  # it was on before the block
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
        debug.enable_nan_checks(True)  # a no-op: one mode, not two
    finally:
        debug.enable_nan_checks(False)
    assert not debug.nan_checks_enabled()


def test_enable_false_leaves_no_mode_active():
    debug.enable_nan_checks(True)
    assert isinstance(_get_current_dispatch_mode(), debug._NaNCheckMode)
    debug.enable_nan_checks(False)
    debug.enable_nan_checks(False)
    assert _get_current_dispatch_mode() is None and not debug.nan_checks_enabled()


def test_nan_checks_belong_to_their_thread():
    """The mode is pushed on this thread's dispatch stack: another thread
    neither sees the checks nor can turn them off."""
    import threading

    seen = {}

    def other():
        seen["enabled"] = debug.nan_checks_enabled()
        debug.enable_nan_checks(False)  # a no-op there
        seen["nan"] = bool(torch.isnan(torch.log(torch.tensor(-1.0))))

    with debug.nan_checks():
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert debug.nan_checks_enabled()
    assert seen == {"enabled": False, "nan": True}


def test_kernel_wrapper_checks_on_the_cpu():
    """On CPU tensors a wrapper runs its plain version, whose operations the
    mode checks: a NaN position raises in the deposit. ``check_kernel``,
    which the wrappers call after a launch, names the kernel and raises
    only while the checks are on."""
    from plasma_control_tpu_torch.ops.kernels.cic import deposit_cic

    x = torch.tensor([1.0, float("nan"), 3.0])
    assert torch.isnan(deposit_cic(x, 8, 10.0)).any()  # off: no check
    with pytest.raises(FloatingPointError):
        with debug.nan_checks():
            deposit_cic(x, 8, 10.0)
    debug.check_kernel("deposit_cic", (x,), ())
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match="an input of the deposit_cic kernel"):
            debug.check_kernel("deposit_cic", (x,), (torch.zeros(8),))
        with pytest.raises(FloatingPointError, match="the output of the gather_cic kernel"):
            debug.check_kernel("gather_cic", (torch.zeros(3), None), (x,))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_capture_refused_under_nan_checks(card):
    from plasma_control_tpu_torch.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu_torch.control.actuator import make_actuator
    from plasma_control_tpu_torch.io.aot import GraphedStep, control_step_fn
    from plasma_control_tpu_torch.models.pic import init_state
    from plasma_control_tpu_torch.ops.grid import make_grid

    cfg = SimConfig(n_particles=256, n_mesh=32, deposit_method="pallas")
    ctrl, mpc = ControlConfig(max_mode=2), MPCConfig(horizon=4, n_candidates=16, plan_modes=4)
    grid = make_grid(cfg.n_mesh, cfg.length, device=card)
    act = make_actuator(cfg.length, cfg.n_mesh, 2, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    st = init_state(cfg, gen, device=card)
    graphed = GraphedStep(control_step_fn(grid, cfg, ctrl, mpc, act))
    with debug.nan_checks():
        with pytest.raises(RuntimeError, match="NaN checks"):
            graphed.capture(st.x, st.v, torch.zeros(4, 4, device=card), gen)


@pytest.mark.cuda
def test_deposit_kernel_nan_position_raises(card):
    """The deposit kernel turns a NaN weight into a zero count, so its
    output alone would not show a NaN position: the wrapper's input check
    raises."""
    from plasma_control_tpu_torch.ops.kernels.cic import deposit_cic

    x = torch.tensor([1.0, float("nan"), 3.0], device=card)
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match="deposit_cic"):
            deposit_cic(x, 8, 10.0)
