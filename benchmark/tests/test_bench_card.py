"""One short run of each cell on the card, through `benchmark/run.py` as a
check runs it; skips without a card (decided inside the test).

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests.helpers import CELLS, REPO


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2305843009213693951", "--seconds", "3", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert {"device_idle_share", "device_ops_per_step", "step_mfu",
                "env_step_device_ms"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"control_steps_per_s", "step_ms_p95", "setup_s"}
