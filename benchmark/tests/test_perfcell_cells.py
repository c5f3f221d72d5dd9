"""Every cell of BENCHMARK.json runs at a tiny size on the CPU and gives a
result line of the contract's shape, with ``correct`` true."""

import json

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import bench_with_kept, root_for, tiny_traffic

# the cells of BENCHMARK.json and those kept for a later PR
WORKLOADS = [w["name"] for w in bench_with_kept()["workloads"]]
SEED = 2**33 + 12345  # more than 32 signed bits hold


def _shape(line: dict, trace: bool):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_the_cpu(workload, tmp_path):
    torch.manual_seed(0)
    line = run_cell(workload, SEED, 2.0, False, device="cpu", traffic=tiny_traffic(workload),
                    root=root_for(workload, tmp_path))
    _shape(line, trace=False)
    bench = bench_with_kept()
    want = {m["name"] for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) == want
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_on_the_cpu(workload, tmp_path):
    line = run_cell(workload, SEED + 1, 2.0, True, device="cpu", traffic=tiny_traffic(workload),
                    root=root_for(workload, tmp_path))
    _shape(line, trace=True)
    assert line["correct"], line["checks"]
