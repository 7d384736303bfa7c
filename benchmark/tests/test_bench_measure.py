"""The rate, tail and trace arithmetic on synthetic steps and traces."""

import pytest

from benchmark import measure


def _window(intervals_ms):
    """(steps/s, p95 ms) of a window whose step boundaries are
    ``intervals_ms`` apart, timed from its start to its last boundary."""
    return (measure.steps_per_s(len(intervals_ms), sum(intervals_ms) / 1e3),
            measure.p95(intervals_ms))


def test_rate_and_tail_of_steady_steps():
    rate, tail = _window([4.0] * 1000)
    assert rate == pytest.approx(250.0) and tail == 4.0


@pytest.mark.parametrize("stall_ms, where", [(50.0, 0), (50.0, 500), (50.0, 999)])
def test_a_stall_moves_rate_and_tail(stall_ms, where):
    """One 50 ms stall anywhere in a 1000-step window lowers the rate; a run
    of stalled steps past the 5 % tail raises the p95."""
    base = [4.0] * 1000
    stalled = list(base)
    stalled[where] += stall_ms
    assert _window(stalled)[0] < _window(base)[0] * 0.99
    slow = list(base)
    for i in range(where % 900, where % 900 + 60):
        slow[i] = 6.0
    assert _window(slow)[1] == 6.0 and _window(slow)[0] < _window(base)[0]


def test_p95_is_the_nearest_rank():
    assert measure.p95(list(range(1, 101))) == 95
    assert measure.p95([7.0]) == 7.0
    assert measure.p95([3.0, 1.0, 2.0]) == 3.0


def test_busy_union_and_idle_gaps():
    dev = [{"name": "a", "ts": 0.0, "dur": 10.0}, {"name": "b", "ts": 5.0, "dur": 10.0},
           {"name": "a", "ts": 30.0, "dur": 10.0}, {"name": "c", "ts": 60.0, "dur": 25.0}]
    assert measure.busy_us(dev) == 50.0
    host = [{"name": "aten::copy_", "ts": 15.0, "dur": 15.0},
            {"name": "closed_loop", "ts": 0.0, "dur": 100.0},
            {"name": "aten::cat", "ts": 41.0, "dur": 2.0}]
    gaps = dict(measure.idle_gaps(dev, host, 0.0, 100.0))
    # 15-30 under the copy; 40-60 (midpoint 50) under closed_loop only; 85-100 likewise
    assert gaps["aten::copy_"] == pytest.approx(15e-6)
    assert gaps["closed_loop"] == pytest.approx(35e-6)
    gaps = dict(measure.idle_gaps(dev, [], 0.0, 100.0))
    assert gaps == {measure.BETWEEN_OPS: pytest.approx(50e-6)}
    top = measure.top_ops(dev)
    assert top[0] == ["c", pytest.approx(25e-6)] and len(top) == 3


@pytest.mark.parametrize("signature, name", [
    ("void spectral_horizon_kernel<true, false, false, 16>(Buffers, SpectralParams)",
     "spectral_horizon_kernel"),
    ("void (anonymous namespace)::deposit_kernel<0>(float const*, float*, int)",
     "deposit_kernel"),
    ("void horizon_kernel<0, true, true>(float const*, float const*)", "horizon_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >"
     "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false, "
     "cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, "
     "float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, "
     "float>, float const, float const)", "gemv2T_kernel_val"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, "
     "false, true, true, false, 7, false, cublasGemvParamsEx<int, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float "
     "const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float "
     "const>, cublasGemvTensorStridedBatched<float>, float>)", "internal::gemvx::kernel"),
    ("std::enable_if<true, void>::type internal::gemvx::kernel<int, int, float, float, false, "
     "true, true, false, 7, false, cublasGemvParamsEx<int> >(cublasGemvParamsEx<int>)",
     "internal::gemvx::kernel"),
])
def test_kernel_names(signature, name):
    """The qualified function name: template arguments (with parentheses of
    their own) and parameters left out."""
    qualified = measure.qualified_name(signature)
    assert qualified.endswith(name.split(" ")[-1])
    assert measure.kernel_name(signature) == qualified.split("::")[-1]


def test_untraced_window():
    """The untraced time of a traced sub-window comes from the run's
    untraced steps: not the traced ones, nor the two that hold the
    sub-window's synchronises."""
    iv = [0.25] * 5 + [9.0] + [5.0] * 3 + [8.0] + [0.35] * 5
    untraced = measure.untraced_steps(iv, 5, 4)
    assert untraced == [0.25] * 5 + [0.35] * 5
    assert measure.untraced_window_us(untraced, 600) == pytest.approx(180000.0)
    assert measure.untraced_window_us([], 600) is None
