"""The benchmark's command on a card: ``python3 -m pytest -m card
benchmark/tests`` on a machine with one (skipped without)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_the_command_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the command refuses to run without one")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", workload, "--seed", str(2**32 + 3), "--seconds", "3",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line


def test_the_command_refuses_a_host_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", "pv_serial.capacity", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
