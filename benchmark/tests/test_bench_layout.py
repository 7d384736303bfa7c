"""BENCHMARK.json against the benchmark's contract, and cells, mixes,
configurations and metrics found by name."""

import json
import re
import shutil

import pytest

from benchmark import counts, measure
from benchmark.cell import load_cell, load_metric
from benchmark.tests.helpers import CELLS, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_entries_keep_to_the_contract():
    b = _bench()
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            extra = set(e) - want - {"workloads"}
            assert set(e) >= want and not extra, (group, e["name"], extra)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert TEXT.match(e[text])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and TEXT.match(w["why"])
        for name in (w["config"], w["traffic"]):
            assert NAME.match(name)
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == [] and c["source"].startswith("https://")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files(name):
    cell = load_cell(name)
    assert cell.traffic["path"] in ("eager", "graph")
    assert set(cell.limits) >= {"plan_gap", "carry_gap"} and cell.limits["carry_gap"] == 0.0
    assert {m["name"] for m in cell.end_to_end} == {"control_steps_per_s", "step_ms_p95",
                                                    "setup_s"}
    for m in cell.per_layer:
        reader = load_metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])


def test_new_cell_mix_config_and_metric_found_by_name(tmp_path):
    """A later change adds files and entries and edits no file of the
    benchmark: copy the tree, add one of each, and find them by name."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = _bench()
    conf = json.loads((REPO / "benchmark/configs/bump_on_tail_n5k.json").read_text())
    conf["name"] = "landau_n5k"
    conf["sim"]["simcase"] = "landau"
    (tmp_path / "benchmark/configs/landau_n5k.json").write_text(json.dumps(conf))
    mix = json.loads((REPO / "benchmark/traffic/mpc_graph.json").read_text())
    mix["name"], mix["mpc"]["n_candidates"] = "mpc_graph_k768", 768
    (tmp_path / "benchmark/traffic/mpc_graph_k768.json").write_text(json.dumps(mix))
    limits = json.loads((REPO / "benchmark/limits/bump_on_tail_n5k.mpc_graph.json").read_text())
    (tmp_path / "benchmark/limits/landau_n5k.mpc_graph_k768.json").write_text(json.dumps(limits))
    (tmp_path / "benchmark/metrics/host_ms_per_step.py").write_text(
        'LAYER = "host loop"\nUNIT = "ms/step"\nMOVES = "control_steps_per_s"\nKERNELS = ()\n\n'
        'def read(ctx):\n    return ctx["window_us"] / 1e3 / ctx["steps"]\n')
    b["configs"].append({"name": "landau_n5k", "source": "https://example.org/landau",
                         "file": "benchmark/configs/landau_n5k.json", "reduced": [],
                         "why": "a third plasma"})
    b["workloads"].append({"name": "landau_n5k.mpc_graph_k768", "config": "landau_n5k",
                           "traffic": "mpc_graph_k768", "chips": 1, "why": "more candidates"})
    b["per_layer"].append({"name": "host_ms_per_step", "unit": "ms/step", "better": "lower",
                           "source": "host_clock", "layer": "host loop",
                           "moves": "control_steps_per_s",
                           "workloads": ["landau_n5k.mpc_graph_k768"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = load_cell("landau_n5k.mpc_graph_k768", tmp_path)
    assert cell.sim["simcase"] == "landau" and cell.mpc["n_candidates"] == 768
    assert [m["name"] for m in cell.per_layer] == ["host_ms_per_step"]
    reader = load_metric("host_ms_per_step", tmp_path)
    assert reader.read({"window_us": 5000.0, "steps": 10}) == 0.5
    assert load_cell("bump_on_tail_n5k.mpc_graph", tmp_path).per_layer == load_cell(
        "bump_on_tail_n5k.mpc_graph").per_layer
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


@pytest.mark.parametrize("name, bound", [
    ("two_stream_n100k.mpc_eager", 1.0467),
    ("two_stream_n100k.mpc_twin_graph", 0.2791),
    ("bump_on_tail_n5k.mpc_graph", 0.01748),
    ("bump_on_tail_n5k.mpc_grid_graph", 0.00495),
])
def test_counts_reproduce_the_planner_bounds(name, bound):
    """The frozen counts give the bounds of chip_smoke.py's kernel table at
    each cell's plan shapes."""
    cell = load_cell(name)
    ms = counts.bound_ms(*counts.plan_cost(cell.sim, cell.control, cell.mpc))
    decimals = len(repr(bound).split(".")[1])
    assert abs(ms - bound) <= 0.5 * 10.0 ** -decimals  # the table's figure, rounded


GEMVX = ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, "
         "false, true, true, false, 7, false, cublasGemvParamsEx<int, "
         "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float "
         "const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, "
         "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float "
         "const>, cublasGemvTensorStridedBatched<float>, float>)")


@pytest.mark.parametrize("solve", ["void gemv2T_kernel_val<int, int, float>(float const*)",
                                   GEMVX, GEMVX.replace("<!(false), void>", "<true, void>")])
def test_metric_readers_on_a_synthetic_trace(solve):
    """Every reader on a trace of one step: a planner kernel, a deposit, the
    field solve's matrix-vector product under each name cuBLAS gives it on
    the card, and a copy; the untraced steps take 200 us each."""
    cell = load_cell("bump_on_tail_n5k.mpc_graph")
    dev = [
        {"name": "void spectral_horizon_kernel<true, false, false, 8>(Buffers, SpectralParams)",
         "ts": 0.0, "dur": 40.0},
        {"name": "void (anonymous namespace)::deposit_kernel<0>(float const*, float*)",
         "ts": 50.0, "dur": 10.0},
        {"name": solve, "ts": 60.0, "dur": 5.0},
        {"name": "Memcpy DtoD (Device -> Device)", "ts": 70.0, "dur": 5.0},
    ]
    ctx = {"device_events": dev, "host_events": [], "window_us": 100.0, "steps": 1,
           "step_intervals_ms": [0.1, 0.3, 0.2], "sim": cell.sim, "control": cell.control,
           "mpc": cell.mpc, "counts": counts, "measure": measure}
    read = {m["name"]: load_metric(m["name"]).read(ctx) for m in cell.per_layer}
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 60 / 200))
    assert read["device_ops_per_step"] == 4
    assert read["plan_kernel_roofline"] == pytest.approx(100 * 0.01748410447761194 / 0.04)
    assert read["env_step_device_ms"] == pytest.approx(0.015)
    assert read["plan_glue_device_ms"] == pytest.approx(0.005)
    ops = counts.step_ops(cell.sim, cell.control, cell.mpc)
    assert read["step_mfu"] == pytest.approx(100 * ops / counts.PEAK_FLOPS / 2e-4)
    empty = dict(ctx, device_events=[])
    assert all(load_metric(m["name"]).read(empty) is None for m in cell.per_layer)
    untraced = dict(ctx, step_intervals_ms=[])
    assert read["device_idle_share"] is not None
    assert load_metric("device_idle_share").read(untraced) is None
    assert load_metric("step_mfu").read(untraced) is None
