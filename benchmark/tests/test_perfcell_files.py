"""Pieces found by name: a configuration, a traffic mix, limits and a
per-layer metric added as files run with no edit of the harness. The
import check compares top-level module names whole."""

import json
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.tests.conftest import ROOT, tiny_traffic


def test_a_cell_added_as_files_runs(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for part in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / part, tmp_path / "benchmark" / part)
    cfg = json.loads((ROOT / "benchmark/configs/pv_serial.json").read_text())
    cfg.update(name="pv_serial_q2", vqt={**cfg["vqt"], "quality": 2.0, "gamma": 9.6})
    (tmp_path / "benchmark/configs/pv_serial_q2.json").write_text(json.dumps(cfg))
    traffic = {**json.loads((ROOT / "benchmark/traffic/capacity.json").read_text()),
               **tiny_traffic("pv_serial.capacity")}
    (tmp_path / "benchmark/traffic/capacity_small.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/pv_serial_q2.capacity_small.json").write_text(
        (ROOT / "benchmark/limits/pv_serial.capacity.json").read_text())
    (tmp_path / "benchmark/metrics/stages.calls_traced.small.py").write_text(
        "def read(record):\n    return float(len(record.spans['enqueue_per_hop']))\n")
    bench["configs"].append({"name": "pv_serial_q2", "source": "https://example.org/q2",
                             "file": "benchmark/configs/pv_serial_q2.json", "reduced": ["quality"], "why": "a test"})
    bench["workloads"].append({"name": "pv_serial_q2.capacity_small", "config": "pv_serial_q2",
                               "traffic": "capacity_small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "realtime_x":
            m["workloads"].append("pv_serial_q2.capacity_small")
    bench["per_layer"] = [{"name": "stages.calls_traced.small", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "stages", "moves": "realtime_x",
                           "workloads": ["pv_serial_q2.capacity_small"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run.run_cell("pv_serial_q2.capacity_small", 7, 2.0, False, device="cpu", root=tmp_path)
    assert set(line["metrics"]) == {"realtime_x", "setup_s"} and line["correct"], line
    line = run.run_cell("pv_serial_q2.capacity_small", 8, 2.0, True, device="cpu", root=tmp_path)
    assert set(line["metrics"]) == {"stages.calls_traced.small"} and line["correct"], line


def test_the_import_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pitchvis_tpu_torch_extra", sys)
    assert "pitchvis_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pitchvis_tpu.core", sys)
    assert run.forbidden_modules() == ["pitchvis_tpu"]


def test_a_run_and_the_reference_load_no_jax():
    code = (
        "import sys, json\n"
        "import benchmark.reference.chain, benchmark.reference.agc, benchmark.judge, benchmark.bounds\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'pitchvis_tpu_torch', 'pitchvis_tpu', 'jax'}))\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "from benchmark.tests.conftest import tiny_traffic\n"
        "line = run_cell('pv_serial.capacity', 5, 2.0, False, device='cpu', traffic=tiny_traffic('pv_serial.capacity'))\n"
        "print(forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    reference_modules, run_modules = out.stdout.strip().splitlines()[-2:]
    assert reference_modules == "[]"  # the reference imports nothing of the program
    assert run_modules == "[]"
