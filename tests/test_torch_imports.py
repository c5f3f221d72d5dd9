"""The port stands alone and runs on the card unless asked otherwise: no
file of pitchvis_tpu_torch (nor chip_smoke.py) imports JAX or the JAX
package, and the entry points raise without CUDA instead of moving to the
CPU on their own."""

import ast
import os

import pytest
import torch

import numpy as np
import pitchvis_tpu_torch as pt
from pitchvis_tpu_torch.models.pitch_mlp import PitchMLP
from pitchvis_tpu_torch.models.render import RenderConfig, make_scene, render_streams
from pitchvis_tpu_torch.ops import agc, composite, peaks_pallas, vqt_pallas
from pitchvis_tpu_torch.train.corpus import train_demo
from pitchvis_tpu_torch.train.dataset import generate_dataset
from pitchvis_tpu_torch.train.device_dataset import generate_dataset_device, render_schedule_device, schedule_from_midi
from pitchvis_tpu_torch.train.train import TrainConfig, train
from pitchvis_tpu_torch.synth.midi import MidiFile
from pitchvis_tpu_torch import demo
from pitchvis_tpu_torch.io.capture import WavStreamDriver
from pitchvis_tpu_torch.io.golden import run_chain
from pitchvis_tpu_torch.io.wav import save_wav
from pitchvis_tpu_torch.ops.resample import PolyphaseResampler, resample
from pitchvis_tpu_torch import xtask
from pitchvis_tpu_torch.bench import configs as bench_configs
from pitchvis_tpu_torch.bench import longhaul, soak
from pitchvis_tpu_torch.parallel.sharding import make_mesh
from pitchvis_tpu_torch.runtime import multihost_serve

from conftest import SMALL_PARAMS
from torch_port_helpers import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pitchvis_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "pitchvis_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert len(files) > 15
    assert any(f.endswith("chip_smoke.py") for f in files)
    for module in ("models/pitch_mlp.py", "models/ml_system.py", "train/train.py", "models/render.py",
                   "models/glyph_atlas.py", "ops/composite.py", "synth/midi.py", "synth/sf2.py", "synth/engine.py",
                   "synth/synthesizer.py", "synth/engine_native.py", "train/dataset.py", "train/device_dataset.py",
                   "train/logistic.py", "train/corpus.py", "utils/signal.py", "io/wav.py", "ops/resample.py",
                   "core/settings.py", "core/tuning.py", "io/keytune.py", "io/alsa.py", "io/capture.py",
                   "io/golden.py", "io/png.py", "utils/profiling.py", "demo.py", "bench/__init__.py",
                   "bench/configs.py", "bench/soak.py", "bench/longhaul.py", "bench/__main__.py", "xtask.py",
                   "parallel/__init__.py", "parallel/sharding.py", "runtime/multihost_serve.py"):
        assert os.path.join(ROOT, "pitchvis_tpu_torch", module) in files, module
    assert os.path.exists(os.path.join(ROOT, "pitchvis_tpu_torch", "native", "alsa_stub.c"))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


BENCH_ENTRIES = ("bench_offline_vqt", "bench_streaming", "bench_latency", "bench_analysis", "bench_serial",
                 "bench_train", "bench_train_corpus", "bench_render")


@pytest.mark.parametrize("entry", ["pipeline", "vqt", "arrays", "server", "train", "model", "render", "dataset",
                                   "device_dataset", "render_schedule", "train_demo", "agc_init", "resampler",
                                   "resample", "vqt_freq", "run_chain", "wav_driver", *BENCH_ENTRIES,
                                   "soak_pipeline", "soak_server", "soak_serve_loop", "longhaul", "xtask_warm",
                                   "make_mesh", "multihost_serve"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = to_port(SMALL_PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry in BENCH_ENTRIES:
            getattr(bench_configs, entry)()
        elif entry == "soak_pipeline":
            soak.soak_pipeline(2, 0.01, vqt_params=params)
        elif entry == "soak_server":
            soak.soak_server(2, 0.01, vqt_params=params)
        elif entry == "soak_serve_loop":
            soak.soak_serve_loop(2, 0.01, vqt_params=params)
        elif entry == "longhaul":
            longhaul.longhaul(2, 0.01, vqt_params=params, out_path=str(tmp_path / "lh.json"))
        elif entry == "make_mesh":
            make_mesh()
        elif entry == "multihost_serve":
            multihost_serve.main(["--streams-per-host", "2", "--seconds", "0.01", "--small"])
        elif entry == "xtask_warm":
            xtask.warm(["--small", "--streams", "2"])
        elif entry == "resampler":
            PolyphaseResampler(44100, 22050, 441)
        elif entry == "resample":
            resample(np.zeros(441, np.float32), 44100, 22050)
        elif entry == "vqt_freq":
            pt.Vqt(params, path="freq")
        elif entry == "run_chain":
            run_chain(params, np.zeros(800, np.float32))
        elif entry == "wav_driver":
            save_wav(str(tmp_path / "x.wav"), np.zeros(441, np.float32), 44100)
            WavStreamDriver(str(tmp_path / "x.wav"), 22050, 368)
        elif entry == "train":
            train(np.zeros((8, 8 + 128), np.float32), TrainConfig(n_buckets=8, t_window=2, mlp_size=8, epochs=1))
        elif entry == "dataset":
            generate_dataset([], params)
        elif entry == "device_dataset":
            generate_dataset_device([], params)
        elif entry == "render_schedule":
            render_schedule_device(schedule_from_midi(MidiFile(events=[], length=0.0), 1.0), 64, 22050.0)
        elif entry == "train_demo":
            train_demo(out_dir=str(tmp_path), n_files=1, seconds_per_file=1.0, epochs=1)
        elif entry == "agc_init":
            agc.agc_init(4)
        elif entry == "render":
            make_scene(RenderConfig(width=32, height=24), params.range)
        elif entry == "model":
            PitchMLP(input_bins=40, mlp_size=8, mlp_layers=1)
        elif entry == "pipeline":
            pt.StreamingPipeline(2, params, path="pallas")
        elif entry == "vqt":
            pt.Vqt(params, path="pallas")
        elif entry == "server":
            pt.StreamServer(2, params, buffer_seconds=1.0, path="pallas", fast=True)
        else:
            pt.make_vqt_arrays(pt.get_kernel(params), path="pallas")


@pytest.mark.parametrize("argv", [["--tone", "440", "--seconds", "0.1"], ["--serve"], ["--tone", "440", "--device", "cuda"]])
def test_cli_exits_without_cuda(argv, monkeypatch, capsys):
    """demo.main on the card's default exits non-zero with resolve_device's
    message before any work, offline and live; nothing moves to the CPU on
    its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo.main(argv) == 1
    out = capsys.readouterr()
    assert "CUDA is not available" in out.err and "--device cpu" in out.err and out.out == ""


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the kernels' wrappers run their plain versions and
    count no launch, a render and the AGC's signal mode included."""
    before = (agc.launches, agc.signal_launches, peaks_pallas.launches, vqt_pallas.launches, composite.launches)
    params = to_port(SMALL_PARAMS)
    pipe = pt.StreamingPipeline(2, params, path="pallas", fast=True, with_viewer=True, device="cpu")
    out = pipe.step(torch.zeros(2, 367), 367 / 22050)
    assert out.x_vqt.shape == (2, SMALL_PARAMS.n_buckets)
    frames = render_streams(RenderConfig(width=64, height=36, ball_patch=16, max_balls=8), params.range, out.viewer,
                            out.analysis.scene_calmness, 0.0, streams=range(2))
    assert frames.shape == (2, 36, 64, 3) and frames.dtype == torch.uint8
    processed, gains = agc.agc_signal(torch.full((2, 250), 0.1), 100)
    assert processed.shape == (2, 200) and gains.shape == (2, 2)
    assert (agc.launches, agc.signal_launches, peaks_pallas.launches, vqt_pallas.launches, composite.launches) == before
