"""CPU tests of the benchmark (``python3 -m pytest benchmark/tests``), at
tiny sizes with the program's plain versions on the CPU. Tests marked
``card`` need an NVIDIA card and skip without one."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped on a host without one")


# the cells whose files stay in benchmark/ for a later PR (PERF.md, Open
# questions): their entries, as that PR would add them to BENCHMARK.json
KEPT_CONFIGS = [{"name": "pv_viewer", "source": "https://github.com/heinzelotto/pitchvis/blob/main/pitchvis_viewer/src/vqt_system.rs#L40-L68",
                 "file": "benchmark/configs/pv_viewer.json", "reduced": [], "why": "kept for a later PR"}]
KEPT_CELLS = [
    {"name": "pv_serial.live", "config": "pv_serial", "traffic": "live", "chips": 1, "why": "kept for a later PR"},
    {"name": "pv_viewer.capacity", "config": "pv_viewer", "traffic": "capacity", "chips": 1,
     "why": "kept for a later PR"},
]
LIVE_METRICS = [
    {"name": "latency_p50_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": ["pv_serial.live"]},
    {"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": ["pv_serial.live"]},
]


def bench_with_kept() -> dict:
    """BENCHMARK.json with the kept cells added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] += KEPT_CONFIGS
    bench["workloads"] += KEPT_CELLS
    bench["end_to_end"] = LIVE_METRICS + bench["end_to_end"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pv_serial.capacity" in m.get("workloads", []):
            m["workloads"].append("pv_viewer.capacity")
    return bench


def root_for(workload: str, tmp: Path) -> Path:
    """The checkout that defines ``workload``: this one, or for a kept cell
    a checkout at ``tmp`` whose BENCHMARK.json adds the kept cells."""
    if workload not in {c["name"] for c in KEPT_CELLS}:
        return ROOT
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench_with_kept()))
    (tmp / "benchmark").symlink_to(ROOT / "benchmark")
    return tmp


def tiny_traffic(workload: str, hops: int = 4) -> dict:
    """Overrides that shrink a cell's traffic to what a CPU test holds
    (``hops`` a capacity call)."""
    traffic = next(w["traffic"] for w in bench_with_kept()["workloads"] if w["name"] == workload)
    kind = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    music = {**kind["music"], "tracks": 4, "offset_seconds": 0.5}
    if kind["kind"] == "live":
        return {"streams": 8, "producers": 2, "compare": {"streams": 4, "every": 2}, "music": music,
                "trace_seconds": 0.5}
    return {"streams": 4, "hops_per_call": hops, "compare": {"streams": 4, "calls": 2}, "music": music}
