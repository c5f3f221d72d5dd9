"""The plain reference against the program's own plain path on the CPU, at
each configuration's settings; and the kernel arithmetic against the B=2048
counts of PERF.md's kernel table."""

import json

import numpy as np
import pytest
import torch

from benchmark import audio, bounds, judge
from benchmark.live import program_params
from benchmark.reference.chain import Deployment, vqt_parameters
from benchmark.reference.filter_bank import build_kernel
from benchmark.tests.conftest import ROOT

CONFIGS = ["pv_serial", "pv_viewer"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_on_the_cpu(name):
    from pitchvis_tpu_torch.models.pipeline import StreamingPipeline

    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    params = program_params(cfg)
    hop = int(params.sr / cfg["fps"])
    b, hops = 4, 24
    music = audio.make_music(11, b, hops, hop, params.sr,
                             {**json.loads((ROOT / "benchmark/traffic/capacity.json").read_text())["music"],
                              "tracks": 3, "offset_seconds": 0.3}, cfg["vqt"], "cpu")
    chunks = torch.from_numpy(music.chunks(np.arange(b), 0, hops).reshape(b, hops, hop)).permute(1, 0, 2)
    out = cfg["outputs"]
    pipe = StreamingPipeline(b, params, path=cfg["path"], device="cpu",
                             with_led=out["with_led"], with_viewer=out["with_viewer"])
    got = judge.flatten(pipe.step_multi(chunks.contiguous(), hop / params.sr))
    ref = Deployment(cfg, b)
    from benchmark.reference.agc import agc_chunks

    signal = torch.nn.functional.pad(torch.from_numpy(agc_chunks(chunks.permute(1, 0, 2).numpy())[0].reshape(b, -1)),
                                     (ref.frame_len, 0))
    frames = torch.stack([signal[i, (h + 1) * hop : (h + 1) * hop + ref.frame_len]
                          for h in range(hops) for i in range(b)])
    x_vqt = ref.vqt.db(frames).reshape(hops, b, -1)
    want = judge.flatten(ref.run(x_vqt, torch.full((hops, b), hop / params.sr, dtype=torch.float64).float(),
                                 list(range(hops))))
    gaps = judge.spectrum_gaps(got["analysis.x_vqt_smoothed"], want["analysis.x_vqt_smoothed"])
    assert gaps.max() < 1e-3
    served = judge.served_leaves(want)
    assert len(served) >= 3
    assert not judge.off_rows(got, served, lead=2).any()
    assert torch.equal(got["analysis.peaks"], want["analysis.peaks"])


def test_reference_filter_bank_is_the_configurations():
    from pitchvis_tpu_torch.kernel.builder import build_kernel as program_build

    for name in CONFIGS:
        cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
        ours, theirs = build_kernel(vqt_parameters(cfg)), program_build(program_params(cfg))
        assert [g.window for g in ours.window_groups] == [g.window for g in theirs.window_groups]
        for a, b in zip(ours.window_groups, theirs.window_groups):
            assert np.array_equal(a.filter_bank, b.filter_bank)


def test_kernel_counts_at_b_2048():
    from benchmark.reference.config import VqtParameters

    geo = bounds.vqt_geometry(build_kernel(VqtParameters()))
    b = 2048
    # PERF.md: 3 x 19.85 GFLOP, and 82.9 MB with the weights in bf16 padded
    # to tiles of 128 filters (the kernel's layout)
    assert round(bounds.vqt_ops(b, geo["window_sizes"], geo["filters"], 1) / 1e9, 2) == 19.85
    padded = [-(-f // 128) * 128 for f in geo["filters"]]
    assert round(bounds.vqt_bytes(b, geo["tail"], geo["window_sizes"], padded, geo["bins"], 2) / 1e6, 1) == 82.9
    assert round(b * geo["bins"] * 4 / 1e6, 1) == 4.8  # the peaks kernel's spectra in
    assert round((bounds.peaks_bytes(b, geo["bins"], 2) - b * geo["bins"] * 4) / 1e6, 1) == 2.4  # two masks out
    assert round(bounds.ring_push_bytes(b, 32768, 0) / 1e6, 1) == 536.9  # the ring read and written once
    # the f32 kernel is bound by its operations
    assert bounds.vqt_bound_s(b, geo, fast=False) == pytest.approx(3 * 19.85e9 / bounds.TF32_FLOPS, rel=1e-3)
