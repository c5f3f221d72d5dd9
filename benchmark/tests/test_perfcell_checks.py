"""What decides ``correct`` comes out false when it should: the control
(the program's own bf16 path, ``fast=True``) and a run with the timed path
broken underneath, once for each fault a cell can have."""


import numpy as np
import pytest
import torch

import pitchvis_tpu_torch.models.pipeline as pipeline_mod
import pitchvis_tpu_torch.runtime.native as native_mod
import pitchvis_tpu_torch.runtime.server as server_mod
from benchmark.run import run_cell
from benchmark.tests.conftest import bench_with_kept, root_for, tiny_traffic

# the cells of BENCHMARK.json and those kept for a later PR
WORKLOADS = [w["name"] for w in bench_with_kept()["workloads"]]
SEED = 2**31 + 99


def _run(workload, tmp_path, fast=None):
    return run_cell(workload, SEED, 2.0, False, device="cpu", fast=fast, traffic=tiny_traffic(workload),
                    root=root_for(workload, tmp_path))


def _both(monkeypatch, name, make):
    """Patches ``name`` where the server and the pipeline look it up."""
    for mod in (server_mod, pipeline_mod):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, make(getattr(mod, name)))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload, tmp_path):
    # calls of 16 hops, so that the compared hops see a ring full of audio
    line = run_cell(workload, SEED, 5.0, False, device="cpu", fast=True, traffic=tiny_traffic(workload, hops=16),
                    root=root_for(workload, tmp_path))
    assert not line["correct"], line["checks"]


def _state_unchanged(fn):
    def step(params, rng, state, x_vqt, dt):
        _, outputs = fn(params, rng, state, x_vqt, dt)
        return state, outputs
    return step


def _half_left_out(fn):
    def vqt(arrays, x, **kw):
        half = x.shape[0] // 2
        head = fn(arrays, x[:half], **kw)
        return torch.cat([head, torch.zeros((x.shape[0] - half, head.shape[1]), dtype=head.dtype)])
    return vqt


def _a_sixteenth_raised(fn):
    """The VQT of the batch's last sixteenth (one compared stream) 3 dB high."""
    def vqt(arrays, x, **kw):
        out = fn(arrays, x, **kw)
        n = max(1, x.shape[0] // 16)
        return torch.cat([out[:-n], out[-n:] + 3.0])
    return vqt


def _led_altered(fn):
    def led(*args):
        return fn(*args) ^ 0x40
    return led


def _chroma_altered(fn):
    def chroma(x, rng):
        return torch.roll(fn(x, rng), 1, dims=-1)
    return chroma


FAULTS = {
    "state_unchanged": ("analysis_step_batch", _state_unchanged),
    "half_left_out": ("vqt_db_auto", _half_left_out),
    "a_sixteenth_raised": ("vqt_db_auto", _a_sixteenth_raised),
    "answer_altered": (None, None),
}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, tmp_path, workload, fault):
    name, make = FAULTS[fault]
    if fault == "answer_altered":
        # the LED block where it is made, or the display's chroma
        viewer = "viewer" in workload
        name, make = ("chroma_vector", _chroma_altered) if viewer else ("led_frame_values", _led_altered)
    _both(monkeypatch, name, make)
    line = _run(workload, tmp_path)
    assert not line["correct"], (fault, line["checks"])


def test_a_consume_that_reads_the_wrong_samples_is_not_correct(monkeypatch, tmp_path):
    """The ring's consume hands out each row a few samples late: the
    replay, which works out from the push log what every consume read,
    counts the rows as off."""
    real = native_mod.NativeRingBank.consume

    def consume(self, n, max_lag=-1, out=None):
        out, gains, adv = real(self, n, max_lag, out)
        out[:] = np.roll(out, 3, axis=1)
        return out, gains, adv

    monkeypatch.setattr(native_mod.NativeRingBank, "consume", consume)
    line = _run("pv_serial.live", tmp_path)
    assert not line["correct"] and line["checks"]["ingest_off_count"]["value"] > 0, line["checks"]
