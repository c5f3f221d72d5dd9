"""Finds every piece of a cell by its name in BENCHMARK.json.

A cell (one entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives for it; the traffic
mix is ``benchmark/traffic/<traffic>.json``; the limits of the comparison
that decides ``correct`` are ``benchmark/limits/<workload>.json``; each
per-layer metric is read by ``benchmark/metrics/<metric name>.py``. A later
cell or metric is added by adding such files, with no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, as it is run
    traffic: dict  # the traffic mix's file
    limits: dict  # {check name: limit}
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of the checkout at ``root`` with its
    configuration, traffic, limits and metrics. Raises KeyError for a
    workload BENCHMARK.json does not name."""
    bench = benchmark_json(root)
    here = Path(root) / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (known: {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(here / "traffic" / f"{cell['traffic']}.json")
    limits = _json(here / "limits" / f"{workload}.json")

    def listed(metric):
        return workload in metric["workloads"] if "workloads" in metric else None

    end_to_end = [m for m in bench["end_to_end"] if listed(m) is not False]
    names = {m["name"] for m in end_to_end}
    per_layer = [
        m for m in bench["per_layer"]
        if listed(m) or ("workloads" not in m and m["moves"] in names)
    ]
    return Cell(workload, int(cell["chips"]), config, traffic, limits, end_to_end, per_layer)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{abs(hash(name))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
