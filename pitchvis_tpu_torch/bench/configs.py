"""The benchmark configurations, on one card. Counterpart of the JAX
package's ``bench/configs.py``: the same 13 entries of ALL_CONFIGS, with the
same arguments, and for each the same result keys, metric name and unit.

1. offline_vqt[_bf16]  -- batched offline VQT, default parameters
2. streaming[...]      -- ring + AGC + VQT + analysis at 60 Hz hops, with
                          the bf16 fused-kernel serving path and the
                          output stages (ML + LED, and the viewer's);
                          ``latency`` is the per-hop p50/p95
3. analysis            -- the full analysis chain (peaks, calmness, tuning)
4. serial              -- spectrum -> colors -> u8 LED values
5. train[_corpus]      -- MIDI -> SF2 render -> batched VQT labels ->
                          inference; _corpus adds the thread pool over files
6. render              -- the headless viewer's rasterizer (uint8 frames)

Each bench returns a dict with metric/value/unit/vs_baseline (and the JAX
function's extra keys), measured on the device it ran on. The yardsticks of
vs_baseline are the Rust reference's: 6,060 VQT frames/s (0.165 ms a
default-parameter frame on one desktop CPU core), 100x realtime a core for
the streaming configs, its 30 FPS serial loop and a 60 FPS display.

The timed unit. A JAX throughput config times one compiled program that
scans ``inner`` steps. The port makes ``inner`` eager calls, sums each
output into a device scalar (so that a result is read) and ends the window
with one barrier (``_sync``: a wait for the device). The first call stays
outside the timed window: that is where the port builds its kernels and
copies its static tables to the card. Each config's work is exposed apart
from its timing (the ``*_work`` and ``*_inputs`` functions), so that a test
can hold one unit of it against the JAX package's on the same seeded
inputs.

Every function runs on the card unless given ``device="cpu"`` and raises
without CUDA (core/device.py::resolve_device).
"""

from __future__ import annotations

import functools
import os
import tempfile
import time

import numpy as np
import torch

from ..core.device import resolve_device

REFERENCE_VQT_FPS = 6060.0
ML_T_WINDOW = 3  # the fused streaming configs' ML history (frames)


def _sync(device) -> None:
    """Execution barrier: waits for all the work queued on ``device``
    (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _marker(device):
    """An event recorded after the work queued so far on ``device``, or None
    on the CPU: its ``synchronize()`` waits for that work and none queued
    later, as the JAX bench's wait on one hop's result does."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


def _best_time(fn, device, n_iter=10, repeats=3):
    fn()  # first use (kernel builds, static tables) + warm
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / n_iter)
    return best


def _perturbation(eps: float, i: int) -> float:
    """``1 + eps * i`` rounded as the JAX package's scan computes it in
    float32 from its float32 step counter."""
    return float(np.float32(1.0) + np.float32(eps) * np.float32(i))


def _best_window(unit, inner: int, device) -> float:
    """Seconds of the best of three windows of ``inner`` calls ``unit(i)``,
    each output summed into one device scalar, after a warm window."""

    def run():
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(inner):
            total = total + unit(i).sum(dtype=torch.float32)
        return total

    return _best_time(run, device, n_iter=1)


# ---- 1. offline VQT ---------------------------------------------------------


def offline_inputs(batch: int, n_fft: int) -> np.ndarray:
    """The offline configs' seeded (batch, n_fft) float32 frames."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((batch, n_fft)).astype(np.float32) * 0.1


def offline_vqt_work(batch: int = 2048, path: str = "pallas", fast: bool = False, params=None, device="cuda"):
    """One unit of bench_offline_vqt's work: a callable ``unit(i)`` that
    returns the dB spectra of the seeded frames (``i`` is unused)."""
    from ..core.config import VqtParameters
    from ..kernel.builder import get_kernel
    from ..ops.vqt import make_vqt_arrays, vqt_db_auto

    dev = resolve_device(device)
    params = params or VqtParameters()
    arrays = make_vqt_arrays(get_kernel(params), path=path, fast=fast, device=dev)
    x = torch.from_numpy(offline_inputs(batch, params.n_fft)).to(dev)
    return lambda i: vqt_db_auto(arrays, x, path=path)


def bench_offline_vqt(
    batch: int = 2048, path: str = "pallas", inner: int = 32, fast: bool = False, device="cuda"
) -> dict:
    """Headline: batched VQT throughput, ``inner`` VQT batches a window.
    The JAX config perturbs its input each step to defeat XLA's common
    subexpression elimination; eager calls all run, and on the card that
    multiply would be a pass over the whole (batch, n_fft) float32 batch,
    longer than the VQT of its trailing samples, so it is left out here.

    fast=True benches the bf16 fast mode (bf16 weights, one tensor-core
    pass, float32 sums)."""
    dev = resolve_device(device)
    unit = offline_vqt_work(batch, path, fast, device=dev)
    fps = batch * inner / _best_window(unit, inner, dev)
    return {
        "metric": "vqt_bf16_frames_per_sec_per_chip" if fast else "vqt_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_VQT_FPS, 2),
    }


# ---- 2. streaming and latency ---------------------------------------------------


def streaming_inputs(hops_per_call: int, n_streams: int, hop: int) -> np.ndarray:
    """The streaming configs' seeded (hops_per_call, n_streams, hop) chunks."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((hops_per_call, n_streams, hop)).astype(np.float32) * 0.05


def streaming_pipeline(
    n_streams: int,
    fused: bool = False,
    path: str = "time",
    fast: bool = False,
    with_viewer: bool = False,
    params=None,
    ml_params=None,
    device="cuda",
):
    """The StreamingPipeline a streaming config drives. ``fused`` adds the
    ML stage (a PitchMLP of seed 0 over a history of ML_T_WINDOW frames;
    ``ml_params`` a state_dict in its place) and the LED block;
    ``with_viewer`` implies ``fused`` and adds the viewer's outputs."""
    from ..core.config import VqtParameters
    from ..models.pipeline import StreamingPipeline
    from ..models.pitch_mlp import PitchMLP

    dev = resolve_device(device)
    params = params or VqtParameters()
    if not (fused or with_viewer):
        return StreamingPipeline(n_streams, params, path=path, fast=fast, device=dev)
    model = PitchMLP(input_bins=ML_T_WINDOW * params.n_buckets, seed=0, device=dev)
    return StreamingPipeline(
        n_streams, params, ml_model=model, ml_params=ml_params, ml_t_window=ML_T_WINDOW,
        with_led=True, path=path, fast=fast, with_viewer=with_viewer, device=dev,
    )


def bench_streaming(
    n_streams: int = 512,
    hops_per_call: int = 8,
    fused: bool = False,
    path: str = "time",
    fast: bool = False,
    with_viewer: bool = False,
    device="cuda",
) -> dict:
    """Config #2: 60 Hz hops through ring + AGC + VQT + analysis; the
    aggregate realtime factor of the card (streams x realtime). Each call
    is ``step_multi`` of ``hops_per_call`` hops; on the card the port
    replays the call as one CUDA graph after its first (the untimed call),
    which is what this config measures.

    fused=True adds the ML inference and the LED colors to each hop (the
    reference's single frame update); path="pallas" + fast=True serve the
    bf16 fused VQT kernel; with_viewer=True (implies fused) adds every
    display-derived output of the viewer (pitch balls with their fade carry,
    chroma, bloom, spectrogram row, bass spiral, calmness histogram)."""
    from ..core.config import VqtParameters

    dev = resolve_device(device)
    if with_viewer:
        fused = True
    params = VqtParameters()
    pipe = streaming_pipeline(n_streams, fused, path, fast, with_viewer, device=dev)
    hop = int(params.sr / 60.0)
    chunks = torch.from_numpy(streaming_inputs(hops_per_call, n_streams, hop)).to(dev)
    dt_hop = hop / params.sr

    def step():
        return pipe.step_multi(chunks, dt_hop)

    dt = _best_time(step, dev, n_iter=5) / hops_per_call
    realtime_factor = n_streams * dt_hop / dt
    name = "streaming_fused" if fused else "streaming"
    if with_viewer:
        name += "_viewer"
    if path == "pallas":
        name += "_pallas_bf16" if fast else "_pallas"
    return {
        "metric": f"{name}_realtime_factor_per_chip",
        "value": round(realtime_factor, 1),
        "unit": "x realtime (aggregate)",
        "vs_baseline": round(realtime_factor / 100.0, 2),  # ~100x realtime a core, reference
    }


def latency_inputs(n_streams: int, hop: int) -> np.ndarray:
    """The latency config's seeded (n_streams, hop) chunk."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n_streams, hop)) * 0.05).astype(np.float32)


def latency_server(n_streams: int, path: str = "pallas", fast: bool = True, params=None, device="cuda"):
    """The StreamServer of the latency config, stream 0 fed the first row of
    the config's chunk. On the CPU it is None where the native ingest
    library cannot be built (the JAX bench's skip); on the card that
    library's RuntimeError propagates, so a run there never records a
    latency result without its server keys."""
    from ..core.config import VqtParameters
    from ..runtime import native
    from ..runtime.server import StreamServer

    dev = resolve_device(device)
    if dev.type == "cuda":
        native.load()
    elif not native.available():
        return None
    params = params or VqtParameters()
    srv = StreamServer(n_streams, params, buffer_seconds=1.0, path=path, fast=fast, device=dev)
    srv.push(0, latency_inputs(n_streams, int(params.sr / 60.0))[0])
    return srv


def bench_latency(
    n_streams: int = 512, iters: int = 60, path: str = "pallas", fast: bool = True, device="cuda"
) -> dict:
    """Config #2b: per-hop serving LATENCY of the realtime loop: host work,
    launches, the card's compute and the result's fetch for ONE 60 Hz hop,
    the number an interactive deployment feels (the reference's frame
    budget is 16.7 ms at 60 FPS). Not amortized over hops. Reports the
    median over ``iters`` hops, p95 beside it. vs_baseline = 16.7 ms budget
    / p50 (headroom factor).

    Where the native ingest library builds (on the card it must), it also
    times the serving runtime: ``StreamServer.step(pipelined=True)``,
    ``step_multi(8)`` (the per-hop charge of k ingest-fed hops in one call)
    and the gap between published hops of ``serve(rate_hz=60)``."""
    from ..core.config import VqtParameters
    from ..models.pipeline import StreamingPipeline

    dev = resolve_device(device)
    params = VqtParameters()
    pipe = StreamingPipeline(n_streams, params, path=path, fast=fast, device=dev)
    hop = int(params.sr / 60.0)
    chunk = torch.from_numpy(latency_inputs(n_streams, hop)).to(dev)
    dt_hop = hop / params.sr

    pipe.step(chunk, dt_hop)  # first use
    _sync(dev)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pipe.step(chunk, dt_hop)
        _sync(dev)  # the latency includes the wait for the result
        times.append(time.perf_counter() - t0)
    times.sort()
    p50 = times[len(times) // 2]
    p95 = times[int(len(times) * 0.95)]

    # one-deep pipelining: enqueue hop N+1 BEFORE waiting for hop N (its
    # event, not the device), so the host's work for the next hop overlaps
    # the card's for this one
    pipe.step(chunk, dt_hop)
    prev = _marker(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.step(chunk, dt_hop)
        nxt = _marker(dev)
        if prev is not None:
            prev.synchronize()
        prev = nxt
    pipelined = (time.perf_counter() - t0) / iters
    _sync(dev)
    result = {
        "metric": "serving_hop_latency_p50_ms",
        "value": round(p50 * 1e3, 2),
        "unit": "ms",
        "vs_baseline": round((1000.0 / 60.0) / (p50 * 1e3), 2),
        "p95_ms": round(p95 * 1e3, 2),
        "pipelined_hop_ms": round(pipelined * 1e3, 2),
        "n_streams": n_streams,
    }

    srv = latency_server(n_streams, path, fast, params, dev)
    if srv is None:
        return result
    try:
        # the serving mode a deployment runs: StreamServer.step(pipelined=
        # True), the hop the server charges its caller (host snapshot +
        # launches + the previous hop's wait, overlapping the card's work):
        # each call returns the previous call's hop, whose event it waits on
        srv.step(dt=dt_hop)  # first use
        _sync(dev)
        srv.step(pipelined=True, dt=dt_hop)  # prime the one-deep queue
        prev = _marker(dev)
        stimes = []
        for _ in range(iters):
            t0 = time.perf_counter()
            srv.step(pipelined=True, dt=dt_hop)
            nxt = _marker(dev)
            if prev is not None:
                prev.synchronize()
            prev = nxt
            stimes.append(time.perf_counter() - t0)
        srv.flush()
        _sync(dev)
        stimes.sort()
        result["server_pipelined_hop_p50_ms"] = round(stimes[len(stimes) // 2] * 1e3, 2)
        result["server_pipelined_hop_p95_ms"] = round(stimes[int(len(stimes) * 0.95)] * 1e3, 2)

        # throughput deployments: step_multi(k), k ingest-fed hops in one
        # call, the per-hop charge divided by k
        k = 8
        srv.step_multi(k, dt=dt_hop)  # first use
        _sync(dev)
        mtimes = []
        for _ in range(max(8, iters // k)):
            t0 = time.perf_counter()
            srv.step_multi(k, dt=dt_hop)
            _sync(dev)
            mtimes.append((time.perf_counter() - t0) / k)
        mtimes.sort()
        result["server_multi_hop_ms"] = round(mtimes[len(mtimes) // 2] * 1e3, 2)
        result["server_multi_k"] = k

        # the self-driving loop (serve()): the consumer-observed gap between
        # published hops at the 60 Hz target cadence
        loop = srv.serve(rate_hz=60.0)
        gaps = []
        last = 0
        prev_t = None
        while len(gaps) < iters:
            trip = loop.wait_next(seq=last, timeout=30.0)
            if trip is None:
                break
            last = trip[0]
            now = time.perf_counter()
            if prev_t is not None:
                gaps.append(now - prev_t)
            prev_t = now
        loop.stop()
        if gaps:
            gaps.sort()
            result["serve_loop_gap_p50_ms"] = round(gaps[len(gaps) // 2] * 1e3, 2)
            result["serve_loop_gap_p95_ms"] = round(gaps[int(len(gaps) * 0.95)] * 1e3, 2)
    finally:
        srv.close()
    return result


# ---- 3. analysis ----------------------------------------------------------------


def analysis_inputs(n_streams: int, n_buckets: int) -> np.ndarray:
    """The analysis config's seeded (n_streams, n_buckets) dB spectra."""
    rng = np.random.default_rng(0)
    return (rng.random((n_streams, n_buckets)) * 30).astype(np.float32)


def analysis_work(n_streams: int = 2048, params=None, device="cuda"):
    """bench_analysis's work: (the fresh state, ``unit(state, i)`` -> (state,
    outputs)), step ``i`` on the seeded spectra times ``1 + 1e-4 i``."""
    from ..core.config import AnalysisParameters, VqtParameters
    from ..models.analysis import analysis_step_batch, init_state_batch

    dev = resolve_device(device)
    params = params or VqtParameters()
    aparams = AnalysisParameters()
    x = torch.from_numpy(analysis_inputs(n_streams, params.n_buckets)).to(dev)

    def unit(state, i):
        return analysis_step_batch(aparams, params.range, state, x * _perturbation(1e-4, i), 1.0 / 60.0)

    return init_state_batch(n_streams, params.n_buckets, device=dev), unit


def bench_analysis(n_streams: int = 2048, inner: int = 32, device="cuda") -> dict:
    """Config #3: the full analysis chain, ``inner`` steps a window, the state
    threaded from step to step and the input scaled by 1 + 1e-4 i (which
    changes the work: the peaks move with the scale)."""
    dev = resolve_device(device)
    state0, unit = analysis_work(n_streams, device=dev)

    def run():
        state = state0
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(inner):
            state, out = unit(state, i)
            total = total + out.peak_size.sum()
        return total

    fps = n_streams * inner / _best_time(run, dev, n_iter=1)
    return {
        "metric": "analysis_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_VQT_FPS, 2),
    }


# ---- 4. serial --------------------------------------------------------------------


def serial_inputs(n_streams: int, n_buckets: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The serial config's seeded peak masks, centers and sizes."""
    rng = np.random.default_rng(0)
    mask = rng.random((n_streams, n_buckets)) > 0.9
    center = np.tile(np.arange(n_buckets, dtype=np.float32) + 0.3, (n_streams, 1))
    size = (rng.random((n_streams, n_buckets)) * 20).astype(np.float32)
    return mask, center, size


def serial_work(n_streams: int = 2048, device="cuda"):
    """bench_serial's work: ``unit(i)`` -> the (n_streams, n_buckets, 3) u8
    LED values of the seeded peaks, the sizes times ``1 + 1e-4 i``."""
    from ..core.config import SERIAL_VQT_PARAMETERS
    from ..io.led import led_frame_values

    dev = resolve_device(device)
    rng_cfg = SERIAL_VQT_PARAMETERS.range
    mask, center, size = (torch.from_numpy(a).to(dev) for a in serial_inputs(n_streams, rng_cfg.n_buckets))
    return lambda i: led_frame_values(rng_cfg, mask, center, size * _perturbation(1e-4, i))


def bench_serial(n_streams: int = 2048, inner: int = 32, device="cuda") -> dict:
    """Config #4: spectrum -> peak splat -> LCh color mapping -> u8 LED
    values for every stream, ``inner`` frames a window, the sizes scaled by
    1 + 1e-4 i."""
    dev = resolve_device(device)
    fps = n_streams * inner / _best_window(serial_work(n_streams, dev), inner, dev)
    return {
        "metric": "led_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 2),  # the reference's loop runs at 30 FPS
    }


# ---- 5. training data ---------------------------------------------------------------


def _bench_font(path: str, sr: int) -> None:
    """A small GM-like font: a looped 441 Hz sine sample over every key."""
    from ..synth.sf2 import write_minimal_sf2

    wave = 0.7 * np.sin(2 * np.pi * np.arange(sr // 2) * 441.0 / sr)
    write_minimal_sf2(path, wave, sr, root_key=69, loop=True)


def train_inputs(directory: str, seconds: float, sr: int, with_font: bool = True) -> tuple[str, str | None]:
    """Writes bench_train's MIDI file (a note every 0.25 s) and, with
    ``with_font``, its font into ``directory``: (midi path, font path or
    None)."""
    from ..synth.midi import write_midi

    sf_path = None
    if with_font:
        sf_path = os.path.join(directory, "bench.sf2")
        _bench_font(sf_path, sr)
    midi_path = os.path.join(directory, "bench.mid")
    write_midi(midi_path, [(i * 0.25, 0.4, 0, 40 + (i % 24), 100) for i in range(int(seconds * 4))])
    return midi_path, sf_path


def train_windows(annotated) -> np.ndarray:
    """(frames - 4, 5 * n_buckets) model inputs: five consecutive VQT frames
    of the annotated pairs a row."""
    frames = np.stack([a[1] for a in annotated])
    return np.stack([frames[i : i + 5].reshape(-1) for i in range(len(annotated) - 4)])


def bench_train(seconds: float = 12.0, device_gen: bool = False, device="cuda") -> dict:
    """Config #5: MIDI -> SoundFont-rendered audio -> batched VQT labels ->
    model inference; labelled frames a second end to end. The default is
    the host route of the reference's train.rs (the SF2 engine's render
    loop in native C++, native/synth_engine.cpp, the VQT batched on the
    device). device_gen=True renders on the device instead
    (train/device_dataset.py: the voices in PyTorch, the AGC the AGC
    kernel's signal mode). Inference runs the model in eval mode under
    torch.inference_mode()."""
    from ..core.config import TRAIN_VQT_PARAMETERS
    from ..models.pitch_mlp import PitchMLP
    from ..ops.vqt import Vqt
    from ..synth.midi import load_midi
    from ..synth.sf2 import SoundFont
    from ..train.dataset import annotate_midi
    from ..train.device_dataset import annotate_midi_device

    dev = resolve_device(device)
    params = TRAIN_VQT_PARAMETERS
    vqt = Vqt(params, device=dev)
    with tempfile.TemporaryDirectory() as d:
        midi_path, sf_path = train_inputs(d, seconds, int(params.sr), with_font=not device_gen)
        font = None if sf_path is None else SoundFont.from_file(sf_path)

        def annotate(m, **kw):
            if device_gen:
                return annotate_midi_device(m, vqt, params, **kw)
            return annotate_midi(m, vqt, params, sound_font=font, **kw)

        midi = load_midi(midi_path)
        annotate(midi, max_seconds=seconds)  # first use + warm
        t0 = time.perf_counter()
        annotated = annotate(midi, max_seconds=seconds)
        gen_dt = time.perf_counter() - t0

    model = PitchMLP(input_bins=5 * params.n_buckets, seed=0, device=dev).eval()
    windows = torch.from_numpy(train_windows(annotated)).to(dev)

    def infer():
        with torch.inference_mode():
            return model(windows[:, None, :])

    infer_dt = _best_time(infer, dev, n_iter=5)
    fps = len(annotated) / (gen_dt + infer_dt)
    return {
        "metric": "train_labeled_frames_per_sec",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 2),  # ~1 frame per VQT-delay chunk x3
    }


def corpus_inputs(directory: str, n_files: int, seconds: float, sr: int) -> tuple[str, list[str]]:
    """Writes bench_train_corpus's font and ``n_files`` MIDI files (a note
    every 0.25 s, each file its own keys) into ``directory``: (font path,
    MIDI paths)."""
    from ..synth.midi import write_midi

    sf_path = os.path.join(directory, "bench.sf2")
    _bench_font(sf_path, sr)
    paths = []
    for i in range(n_files):
        p = os.path.join(directory, f"{i}.mid")
        write_midi(p, [(j * 0.25, 0.4, 0, 36 + ((j + 5 * i) % 36), 100) for j in range(int(seconds * 4))])
        paths.append(p)
    return sf_path, paths


def bench_train_corpus(n_files: int = 6, seconds: float = 8.0, n_workers: int = 4, device="cuda") -> dict:
    """Config #5b: multi-file corpus generation (the reference's rayon
    par_iter over MIDI files, train.rs:146-153) through the thread pool of
    train/dataset.py (the native render releases the GIL). Reports the
    parallel labelled frames/s; "speedup_vs_serial" is the gain over
    n_workers=1 on the host that ran it, which depends on its cores."""
    from ..core.config import TRAIN_VQT_PARAMETERS
    from ..train.dataset import generate_dataset

    dev = resolve_device(device)
    params = TRAIN_VQT_PARAMETERS
    with tempfile.TemporaryDirectory() as d:
        sf_path, paths = corpus_inputs(d, n_files, seconds, int(params.sr))
        kw = dict(params=params, sound_font_path=sf_path, max_seconds_per_file=seconds, device=dev)
        generate_dataset(paths[:1], n_workers=1, **kw)  # first use + warm

        t0 = time.perf_counter()
        serial = generate_dataset(paths, n_workers=1, **kw)
        dt_serial = time.perf_counter() - t0
        t0 = time.perf_counter()
        parallel = generate_dataset(paths, n_workers=n_workers, **kw)
        dt_parallel = time.perf_counter() - t0
    row = params.n_buckets + 128
    frames = len(parallel) // row
    if len(serial) != len(parallel):
        raise RuntimeError(f"the serial and parallel datasets differ in size: {len(serial)} != {len(parallel)}")
    fps = frames / dt_parallel
    return {
        "metric": "train_corpus_labeled_frames_per_sec",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 2),  # the scale of bench_train
        "speedup_vs_serial": round(dt_serial / dt_parallel, 2),
        "n_workers": n_workers,
    }


# ---- 6. render ----------------------------------------------------------------------


def render_inputs(n_streams: int, n_buckets: int) -> dict[str, np.ndarray]:
    """The render config's seeded live scenes: three peaks a stream, at
    seeded bins, centers and sizes, and flat calmness, accuracy and
    deviation."""
    rng = np.random.default_rng(0)
    peaks = np.zeros((n_streams, n_buckets), bool)
    center = np.tile(np.arange(n_buckets, dtype=np.float32), (n_streams, 1))
    size = np.zeros((n_streams, n_buckets), np.float32)
    for b in range(n_streams):
        bins = rng.choice(np.arange(12, n_buckets - 12), size=3, replace=False)
        peaks[b, bins] = True
        center[b, bins] = bins + rng.uniform(-0.4, 0.4, 3)
        size[b, bins] = rng.uniform(8.0, 25.0, 3)
    full = lambda v: np.full((n_streams, n_buckets), v, np.float32)  # noqa: E731
    return {"peaks": peaks, "center": center, "size": size, "calm": full(0.5), "acc": full(0.9), "dev": full(0.1)}


def render_time(i: int) -> float:
    """The shader time of display frame ``i``: i / 60 in float32."""
    return float(np.float32(i) / np.float32(60.0))


def render_work(n_streams: int = 64, width: int = 640, height: int = 360, max_balls: int = 64, device="cuda"):
    """bench_render's work: ``unit(i)`` -> the (n_streams, height, width, 3)
    uint8 frames of the seeded scenes at render_time(i). The balls come from
    one update_balls step from a fresh carry and the bass spiral from
    bass_spiral, both batched over the streams."""
    from ..core.config import VqtParameters
    from ..models.render import RenderConfig, make_scene, render_batch
    from ..models.viewer import BallState, bass_spiral, update_balls

    dev = resolve_device(device)
    rng_cfg = VqtParameters().range
    n = rng_cfg.n_buckets
    cfg = RenderConfig(width=width, height=height, max_balls=max_balls)
    st = make_scene(cfg, rng_cfg, dev)
    a = {k: torch.from_numpy(v).to(dev) for k, v in render_inputs(n_streams, n).items()}
    _, balls = update_balls(rng_cfg, BallState.init(n_streams, n, device=dev), a["peaks"], a["center"], a["size"],
                            a["calm"], a["acc"], a["dev"], 1.0 / 60.0)
    bass = bass_spiral(rng_cfg, a["peaks"], a["center"], a["size"])
    scene_calm = torch.full((n_streams,), 0.5, dtype=torch.float32, device=dev)
    return lambda i: render_batch(cfg, rng_cfg, balls, bass, scene_calm, render_time(i), statics=st)


def bench_render(
    n_streams: int = 64,
    width: int = 640,
    height: int = 360,
    max_balls: int = 64,
    inner: int = 4,
    device="cuda",
) -> dict:
    """Config #6 (an extension; the reference renders ONE stream through a
    GPU window at 60 FPS): the headless viewer's rasterizer (models/
    render.py: spider net, bass spiral, the ball fragment, bloom, tonemap)
    as a throughput number. Renders a batch of ``n_streams`` live 3-peak
    scenes at ``width``x``height``, ``inner`` display frames a window with
    the shader time advancing a frame (one render_batch, and so one
    composite launch, a frame). vs_baseline = rendered frames/s / 60: how
    many 60 FPS displays one card sustains."""
    dev = resolve_device(device)
    fps = n_streams * inner / _best_window(render_work(n_streams, width, height, max_balls, dev), inner, dev)
    return {
        "metric": "render_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 60.0, 2),
        "raster": f"{width}x{height}",
        "max_balls": max_balls,
    }


ALL_CONFIGS = {
    "offline_vqt": bench_offline_vqt,
    "offline_vqt_bf16": functools.partial(bench_offline_vqt, fast=True),
    "streaming": bench_streaming,
    "streaming_pallas_bf16": functools.partial(bench_streaming, n_streams=2048, path="pallas", fast=True),
    "streaming_fused": functools.partial(bench_streaming, fused=True),
    # the full display-ready step (ML + LED) on the fastest VQT kernel
    "streaming_fused_pallas_bf16": functools.partial(bench_streaming, fused=True, path="pallas", fast=True),
    # ...and with the viewer stage too (every update_display-derived output,
    # short of rasterized pixels)
    "streaming_fused_viewer_pallas_bf16": functools.partial(
        bench_streaming, with_viewer=True, path="pallas", fast=True
    ),
    "latency": bench_latency,
    "analysis": bench_analysis,
    "serial": bench_serial,
    "train": bench_train,
    "train_corpus": bench_train_corpus,
    "render": bench_render,
}
