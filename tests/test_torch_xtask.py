"""The port's task runner (pitchvis_tpu_torch/xtask.py): its dispatch, what
``clean`` removes, and the commands ``test``, ``bench`` and ``golden`` run
(``_run`` replaced, nothing started)."""

import os
import sys

import pytest

from pitchvis_tpu_torch import xtask


@pytest.mark.parametrize("argv", [[], ["nope"]], ids=["no_task", "unknown_task"])
def test_no_or_unknown_task_returns_2(argv, capsys):
    assert xtask.main(argv) == 2
    assert "python -m pitchvis_tpu_torch.xtask" in capsys.readouterr().out


def test_clean_removes_only_the_ports_outputs(tmp_path):
    ours = tmp_path / "build" / "pitchvis_tpu_torch"
    ours.mkdir(parents=True)
    (ours / "libvqt_0123.so").write_bytes(b"x")
    theirs = [tmp_path / ".cache" / "vqt_kernel_0.npz", tmp_path / "native" / "libpitchvis_native.so",
              tmp_path / "build" / "jax_native_make.lock", tmp_path / "build" / "BENCH_SWEEP_torch.json",
              tmp_path / "build" / "golden_torch" / "vqt_golden.npz", tmp_path / "BENCH_SWEEP.json"]
    for p in theirs:
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    assert xtask.clean(str(tmp_path)) == 0
    assert not ours.exists()
    assert all(p.exists() for p in theirs)
    assert xtask.clean(str(tmp_path)) == 0  # nothing left to remove


@pytest.fixture
def ran(monkeypatch):
    cmds = []
    monkeypatch.setattr(xtask, "_run", lambda cmd, **kw: cmds.append(cmd) or 0)
    return cmds


def test_test_runs_the_ports_tests(ran):
    assert xtask.main(["test", "-x", "-k", "bench"]) == 0
    cmd = ran[-1]
    assert cmd[:3] == [sys.executable, "-m", "pytest"] and cmd[-3:] == ["-x", "-k", "bench"]
    files = [c for c in cmd if c.endswith(".py")]
    assert files and all(os.path.basename(f).startswith("test_torch_") for f in files)
    assert os.path.join("tests", "test_torch_xtask.py") in files


def test_bench_runs_the_ports_runner(ran):
    assert xtask.main(["bench", "--config", "serial", "--device", "cpu"]) == 0
    assert ran[-1] == [sys.executable, "-m", "pitchvis_tpu_torch.bench", "--config", "serial", "--device", "cpu"]


def test_golden_writes_under_build(ran):
    assert xtask.main(["golden", "streaming", "--device", "cpu"]) == 0
    assert ran[-1] == [sys.executable, "-m", "pitchvis_tpu_torch.io.golden", os.path.join("build", "golden_torch"),
                       "streaming", "--device", "cpu"]


def test_check_runs_a_small_vqt_in_a_fresh_process(ran):
    assert xtask.main(["check", "--device", "cpu"]) == 0
    cmd = ran[-1]
    assert cmd[:2] == [sys.executable, "-c"] and cmd[-2:] == ["--device", "cpu"]
    assert "path='pallas'" in cmd[2]


def test_check_on_the_cpu_finds_the_tones(capfd):
    """The check's own code, run: two tones at their bins on the CPU."""
    assert xtask.main(["check", "--device", "cpu"]) == 0
    assert "check ok: (2, 36) on cpu" in capfd.readouterr().out


def test_warm_on_the_cpu(capsys):
    assert xtask.main(["warm", "--small", "--streams", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("warmed pipeline step (2 streams, pallas)", "warmed server step (2 streams)",
                 "warmed server step_multi(8)"):
        assert line in out
