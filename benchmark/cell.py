"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them sits in a file of its own:

* ``BENCHMARK.json``'s ``configs`` entry gives the configuration's ``file``:
  ``{"sim": SimConfig fields, "control": ControlConfig fields, ...}``;
* ``benchmark/traffic/<traffic>.json``: the controller (``mpc``, every
  MPCConfig field), the ``path`` the window drives (``eager`` or
  ``graph``), the episode length and how many start states, how many steps
  are compared, and the traced sub-window;
* ``benchmark/limits/<workload>.json``: the limit of each number the
  comparison reads (``judge.CHECKS``);
* ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A later cell, mix, configuration or metric is a new file and a new entry;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list  # the entries of per_layer this cell reports

    @property
    def sim(self) -> dict:
        return self.config["sim"]

    @property
    def control(self) -> dict:
        return self.config["control"]

    @property
    def mpc(self) -> dict:
        return self.traffic["mpc"]


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are: {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_metric(name: str, root: Path = REPO):
    """The reader module ``benchmark/metrics/<name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
