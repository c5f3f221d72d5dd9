#!/usr/bin/env python3
"""Drives pitchvis_tpu_torch on one NVIDIA GPU and checks it end to end.

    python3 chip_smoke.py

Run from the root of the checkout on a machine with a CUDA card and the CUDA
toolkit (nvcc). Phases, each of which fails the run on any error:

1. builds the CUDA sources of pitchvis_tpu_torch/csrc/ (the four kernels
   and an empty kernel for timing a launch; one nvcc each, in parallel; the
   two native host libraries with g++ beside them) and
   prints the build seconds and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (default VqtParameters, B=2048 streams): the VQT in f32
   and in bf16 within 1e-3 dB and 1e-4 of the frame maximum, also at B=1, at
   B=130 (no multiple of the kernel's frame tile), at a geometry whose
   windows are no multiple of any tile and on frames whose address and stride
   are unaligned; peaks and AGC bit for bit (the peaks kernel's primitive
   outputs, and its selected masks with two configurations and with one,
   suppression to convergence and for one round, on VQT spectra, a rounded
   random walk, tie-heavy chains at B=67, one frame, n = 65 / 96 / 1100,
   rows off 16-byte alignment and the empty batch; the AGC kernel's chunk
   mode against agc_chunk_plain, and its ring mode, the whole ring push,
   against ring_push_plain on host copies (no kernel in its path) and on the
   card at B=2048, L=32768, T=367 with a NaN, an Inf, a -Inf and a silent
   row, at B=5, L=1003 with T = 367, L, 1, 4, 0, with
   buffer rows off 16-byte alignment, at T = 4500 and 5000 of L=5000, and
   on the empty batch); the f32 VQT within 3e-4 dB of the float64 oracle on
   8 frames; and times kernel, plain version and, where one exists, one
   PyTorch call as a yardstick (for the VQT one torch.matmul per group,
   handed frames already cast to its type and stopping before re^2 + im^2;
   for the ring push one copy_ of buffer[:, T:]), the wrapper as a whole and
   the C call alone, each kernel's time on the card alone (profiler device
   trace) and, beside the peaks kernel, an empty kernel of the same grid;
3. runs the main path, StreamingPipeline(2048, path="pallas", fast=True), for
   16 hops of seeded synthetic audio (sines, noise, one NaN chunk, one silent
   stream), then 4 hops in f32, checking finite outputs and that each kernel
   was launched the expected number of times a hop; then traces one ring
   push (it must be one device op) and its plain version op by op, runs
   one ring push and one analysis step under
   torch.cuda.set_sync_debug_mode("error"), which fails the run if either
   synchronises with the host, and one analysis step under the profiler for
   its launches and device time;
4. replays tests/golden/streaming_golden.npz through the f32 fused path on
   one stream (spectra atol 1e-3 dB, gains rtol 1e-4);
5. serves through the serving runtime, StreamServer(2048, path="pallas",
   fast=True): after a 1 s warm-up push, 16 hops of push_batch of a seeded
   (2048, 367) block (sines and noise, one NaN row, one silent row) and
   step(dt=367/22050), timed by the host clock with a synchronize, each
   checked finite, with the VQT kernel launched once and the peaks kernel
   twice a hop; the split of four more hops (push_batch, native consume and
   the copy's enqueue by the host clock; the copy, roll, VQT + dB and
   analysis by CUDA events); the server's stats, peak device memory and the
   native ring bank's host bytes; a delta hop and a catch-up hop under
   set_sync_debug_mode("error"); serve(rate_hz=60, pipelined=True) and
   serve(hops_per_dispatch=4, publish="per_hop") for 2 s each beside a
   producer thread pushing at the audio rate; then, with torch.equal at
   B=256, step_multi(4) against 4 step()s, per_hop=True against the hops,
   pipelined + flush against unpipelined, delta against snapshot ingest, and
   a reset row against a fresh server's; and a B=64 server on the card
   against one on the CPU for 8 hops (gains equal; continuous outputs within
   1e-3 where the peaks agree, at most 2e-4 of the peak bins flipped).

6. runs the output stages (LED colors and the viewer's display outputs):
   StreamingPipeline(2048, path="pallas", fast=True, with_led=True,
   with_viewer=True) for 16 hops after two of warm-up, beside the bare
   pipeline on the same audio right after; the stages alone
   (models/pipeline.py::derived_stages, both, LED only, viewer only) under
   the profiler for their launches and device ms, and by the host clock for
   their enqueue; one hop under set_sync_debug_mode("error"); the stages on
   the card against the CPU on one hop's analysis outputs and ball carry
   (floats atol 1e-5, positions 1e-4, u8 one level in at most 1e-5 of the
   values, booleans equal); tests/golden/chain_golden.npz (four signals as
   four streams, LED stage, 600 hops) and viewer_golden.npz (two signals,
   both stages, 360 hops) through the f32 fused path, held to the JAX
   ingest-server test's budget and the framing of the serial byte stream;
   and a StreamServer(2048, fetch="led") whose CompactOutputs.led equals a
   with_led server's (torch.equal) on the same pushes, with its hop time.
7. runs the ML stage and its trainer at the trained width
   (TRAIN_VQT_PARAMETERS: 7 octaves x 36 = 252 bins; PitchMLP at T=5,
   mlp 1024, 2 layers, 7.4 M parameters): the VQT kernel at this geometry
   (2 window groups, 233 and 19 filters) in bf16 and f32 against its plain
   version at B=2048 and B=1, and the peaks kernel at 252 bins, 36 an octave
   (both configurations and one, to convergence and one round, torch.equal
   to its plain version) on the VQT's spectra at B=2048 and B=1, a rounded
   random walk, and the ML pipeline's own spectra; 20 train steps of TrainConfig() (batch 300) on
   a seeded synthetic task, with a falling loss, the step's time, launches
   and device time, and one step (dropout 0) on the card against the same
   step on the CPU (loss rtol 1e-5, each gradient within 1e-5 of its
   leaf's largest, parameters atol 1e-6); train(epochs=1)
   with a checkpoint under build/ (deleted after its load); then
   StreamingPipeline(2048, TRAIN_VQT_PARAMETERS, path="pallas", fast=True,
   ml_model=) with the weights it wrote, for 16 hops after two of warm-up,
   beside the bare pipeline on the same audio; the ML stage alone under the
   profiler; a hop under set_sync_debug_mode("error"); the stage on the card
   against the CPU on one hop's history (outputs atol 1e-5, logits 1e-4 of
   the largest); a StreamServer with the ML stage for 16 hops; and
   step_multi(4) against 4 step()s with it at B=256 (torch.equal).
8. runs the rasterizer: the composite kernel (csrc/composite.cu) against
   composite_patches_plain on the card, torch.equal, at the full size (B=64,
   K=64, P=96, 640x360, all patches overlapping), at B=1 and K=1, on the
   golden's 160x96 raster, with origins at both edges, a stride-0 colour, a
   base off 16-byte alignment, K=0 and the empty batch, with its time, its
   plain version's and its time on the card alone; it fails if the
   scene has no pitch-name layer (the atlas missing); then 12 hops of
   StreamingPipeline(2048, path="pallas", fast=True, with_viewer=True), each
   followed by render_streams of streams 0-63 at RenderConfig() (640x360,
   K=64, P=96), timed by the host clock with a synchronize (frames/s, ms a
   batch), one batch's launches, device and enqueue ms, its split by stage
   (CUDA events) and peak memory, and the composite on the path's own
   patches against its plain version; the same on a synthetic scene with K
   full in every stream; tests/golden/render_golden.npz replayed on the card
   (plain and overlay within one 8-bit step); render_batch of 4 streams on
   the card against the CPU, plain and with the debug overlay (within one
   step), and under a caller's allow_tf32=True (torch.equal to the
   default); one render_streams and one debug render under
   set_sync_debug_mode("error").
9. runs the training-data path at TRAIN_VQT_PARAMETERS on the corpus's own
   60-second files (build_training_font and build_midi_corpus(..., 8, 60.0,
   seed=0) under build/dataset_phase/, deleted after): the AGC kernel's
   signal mode (csrc/agc.cu, ops/agc.py::agc_signal) torch.equal to its
   plain version over a whole file (and to the chunk mode carried chunk by
   chunk), on the 8 files zero-padded into one batch against each file
   alone and at B=132 against that batch, at B=8 rows of 2 s, with silent
   chunks, energies just under and over 1e-6, C=1, C=0, strided and
   unaligned rows, the empty batch, 8 rows of unequal lengths zero-padded,
   more rows than the card has SMs, an all-silent row, one chunk and a loud
   chunk after quiet ones (the max clamps the update at k), with
   its time for one file, for the batch and at B=132, ns a sample, its plain
   version's, its bound and the chain's latency floor;
   generate_dataset_device over the 8 files (frames/s, the split into
   render, AGC, windows + VQT and labels, one agc_signal launch a batch of
   at most one row an SM, its rows equal to the file-by-file route's, peak
   memory), render and AGC of the batch under
   set_sync_debug_mode("error"); generate_dataset on 2 files
   with the font and 2 workers, on the card against the CPU (targets equal,
   spectra within 1e-2 dB); the device route against the host route on one
   file without a font (tests/test_device_dataset.py's criteria); the device
   route on the card against the CPU on 3 s; and train_demo(8 files of 60 s,
   1 epoch) end to end, with a train step on its rows.
10. runs the command line, pitchvis_tpu_torch/demo.py: a 60-second 44100 Hz
   WAV (the chain signals' arpeggio, chord and chirp, written by the port's
   save_wav under build/cli_phase/, deleted after) resampled on the card and
   run in process through ``--path pallas --fast --led`` and ``--path
   pallas`` (f32, 588 bins): hops, wall seconds, realtime factor, median
   hop, the resample's ms, the kernels launched once a hop (peaks twice)
   and none of their plain versions called; its first 3 s with ``--device
   cpu`` against the card at the chain budget of
   tests/test_torch_outputs.py; ``--serve --input-sr 48000 --pipelined
   --led`` and ``--serve --loop --hops-per-dispatch 4`` as subprocesses fed
   3 s of f32 tone (one summary line a hop, A4 found); ``--render`` of 1 s
   at 640x360 with the debug overlay (30 PNGs, two composites a frame, no
   frame of one colour); and Vqt(path="freq") at B=2048 in f32 (within 3e-4
   dB of the oracle and of the time path on 8 frames, power within rtol
   1e-5 of the CPU) and bf16 (power within rtol 1e-3 of the CPU; its dB
   error to the oracle printed), beside the time and pallas paths' ms.
11. runs the bench, pitchvis_tpu_torch/bench/: first holds the bf16 VQT
   and the peaks against their plain versions at 512, 1024 and 3840
   streams, on the default parameters' arrays and on the live rebuild's
   (quality x 1.1), and one ring push at 512 and 3840 streams, the shapes
   its paths give them beyond phase 2's; then every ALL_CONFIGS entry once
   at its own arguments, and bench_train(device_gen=True), each result with
   the JAX function's keys and metric name and finite positive numbers,
   nothing skipped, the kernels of its path launched and no other (the
   time path's VQT is torch.matmul; serial, train and train_corpus launch
   none) and no plain version called; a call of the offline and serial
   configs, its enqueue against its wall time, its launches and device ms;
   every soak leg at its default stream count for
   3 s and longhaul at 1024 streams for 0.25 minutes (one live rebuild),
   through their mains, reports under build/bench_phase/ (deleted after)
   with finite outputs, hops served and device memory, longhaul's memory
   all freed after its run and its growth in the run counted in hops of
   the server's outputs; and ``python -m
   pitchvis_tpu_torch.bench`` (the f32 line, then bf16) and ``python -m
   pitchvis_tpu_torch.xtask check`` as subprocesses.

It prints a JSON line of the VQT's times by part, one of the analysis step's
launches and times, one of the output stages' numbers, one of the ML phase's
(``ml_stage``), one of the rasterizer's (``render``), one of per-kernel
numbers (``launches`` summed over the pipeline's, the server's, the
output-stage pipeline's, the ML pipeline's and server's and the render
path's measured hops and batches, the command line's in-process runs and
the bench's configs, soak legs and long-haul run, ``launches_by_path``
each; the ``agc_signal`` entry's over the device route's files and the
bench), one of the dataset phase's (``dataset``), one of the command line's
(``cli``), one of the bench's (``bench``), then the nvidia-smi line, and as
its last line ``{"ok": true, "device": {...}}``.
Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 2048
MAIN_HOPS = 16
F32_HOPS = 4
SEED = 0
SERVER_HOPS = 16
EQ_B = 256  # the server's equalities on the card
CPU_B = 64  # the server on the card against one on the CPU
CPU_HOPS = 8
LOOP_S = 2.0
STAGE_HOPS = 16  # phase 6: hops of the pipeline with the output stages
ML_HOPS = 16  # phase 7: hops of the pipeline and of the server with the ML stage
TRAIN_STEPS = 20  # phase 7: full-width train steps
RENDER_STREAMS = 64  # phase 8: watched streams a batch (bench_render's default)
RENDER_BATCHES = 12  # phase 8: timed batches of the render path
CARD_CPU_STREAMS = 4  # phase 8: streams rendered on the card and on the CPU

# phase 6 tolerances. Card against CPU on the same inputs, those that the CPU
# tests state against the JAX package (tests/test_torch_led.py,
# test_torch_viewer.py): floats atol 1e-5, ball positions 1e-4, u8 values
# within one level in at most 1e-5 of them, booleans exactly.
STAGE_ATOL = 1e-5
POSITION_ATOL = 1e-4
STAGE_U8_SHARE = 1e-5
# golden replays: the chain keys at tests/test_chain_golden.py::
# TestIngestServerPath's budget; the viewer keys on the frames where every
# peak agrees at tests/test_torch_outputs.py's (visibility exactly, u8 values
# within one level in at most 1e-4 of them, other floats within 1e-3: the
# f32 replay drifts some 3e-5 on the CPU, an ulp of the spiral angle in sin
# and cos)
GOLDEN_U8_SHARE = 1e-4
GOLDEN_FLOAT_ATOL = 1e-3
# phase 7 tolerances, card against CPU, those that the CPU tests state
# against the JAX package (tests/test_torch_ml.py, test_torch_train.py): the
# model's outputs atol 1e-5, its logits within 1e-4 of the largest |logit|;
# one train step (dropout 0, lr 1e-5) the loss rtol 1e-5, each gradient
# within 1e-5 of its leaf's largest |gradient|, the parameters atol 1e-6
ML_ATOL = 1e-5
ML_LOGIT_REL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-5
TRAIN_PARAM_ATOL = 1e-6

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s, FFMA, tf32 and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

VQT_DB_TOL = 1e-3  # kernel vs plain, same rounded inputs: only the sum order differs
VQT_REL_TOL = 1e-4  # the same, on power over its frame's maximum (bins under the dB floor too)
ORACLE_DB_TOL = 3e-4  # f32 VQT vs the float64 oracle (tests/test_golden.py holds <5e-4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of CUDA-event time of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_trace(torch, fn, kernel: str | None = None, inner: int = 1, ops: list | None = None,
                 required: bool = True) -> tuple[int, float | None]:
    """Runs ``fn`` ``inner`` times under torch.profiler and reads the device
    side of its trace (kernels, copies, memsets). With ``kernel``: (events
    whose name contains it, their mean device time in ms), the time of one
    such kernel on the card alone. Without: (all events, their summed device
    time in ms). Appends (name, device ms) of each such event to ``ops`` if
    given. The profiler now and then records no device event of a window:
    such a trace is taken again, up to three times in all. Fails if the
    profiler saw no such event, or with ``required=False`` returns (0,
    None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(inner):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and (kernel is None or kernel in e.name)]
        if events:
            break
    if ops is not None:
        ops.extend((e.name, e.device_time_total / 1e3) for e in events)
    times_us = [e.device_time_total for e in events]
    if not times_us and not required:
        return 0, None
    check(len(times_us) > 0, f"the profiler traced no device activity ({kernel or 'any kernel'})")
    total_ms = sum(times_us) / 1e3
    return len(times_us), total_ms / len(times_us) if kernel else total_ms


def vqt_kernel_against_plain(torch, label, arrays, x):
    """The VQT kernel against its plain version on frames ``x``: (power, max
    dB difference, max power difference over the frame's maximum), checked
    against VQT_DB_TOL and VQT_REL_TOL."""
    from pitchvis_tpu_torch.ops import vqt_pallas as vqt_mod
    from pitchvis_tpu_torch.ops.vqt import power_to_db

    got = vqt_mod.vqt_power_pallas(arrays, x)
    want = vqt_mod.vqt_power_pallas_plain(arrays, x)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (x.shape[0], arrays.n_buckets), f"{label}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite power")
    err_db = float((power_to_db(got) - power_to_db(want)).abs().max())
    rel = float(((got - want).abs() / want.amax(dim=1, keepdim=True)).max())
    print(f"{label}: max |dB| vs plain {err_db:.3e} (tol {VQT_DB_TOL}), "
          f"max power err / frame max {rel:.3e} (tol {VQT_REL_TOL})")
    check(err_db <= VQT_DB_TOL, f"{label}: {err_db} dB from its plain version")
    check(rel <= VQT_REL_TOL, f"{label}: power {rel} of its frame's maximum from its plain version")
    return got, err_db, rel


def peaks_masks_against_plain(torch, label, xs, bpo) -> int:
    """The peaks kernel's selected masks against its plain version on rows
    ``xs`` at ``bpo`` bins an octave: AnalysisParameters' two configurations
    (the smoothed spectrum's call) and one (the raw spectrum's), each to
    convergence and for one suppression round, equal by torch.equal. Returns
    in how many of the two calls one round left the first mask short of the
    fixpoint."""
    from pitchvis_tpu_torch.core.config import AnalysisParameters
    from pitchvis_tpu_torch.ops import peaks_pallas as peaks_mod

    ap = AnalysisParameters()
    before = peaks_mod.launches
    unconverged = 0
    for configs in ((ap.bassline_peak_config, ap.peak_config), (ap.peak_config,)):
        got = {}
        for iters in (None, 1):
            got[iters] = peaks_mod.find_peaks_masks(xs, configs, bpo, iters)
            want = peaks_mod.find_peaks_masks_plain(xs, configs, bpo, iters)
            check(len(got[iters]) == len(configs), f"peaks on {label}: {len(got[iters])} masks for {len(configs)} configurations")
            for g, w in zip(got[iters], want):
                check(g.dtype == torch.bool and g.shape == xs.shape, f"peaks on {label}: mask {g.dtype} {tuple(g.shape)}")
                check(bool(torch.equal(g, w)), f"peaks kernel's selected masks differ from the plain version on {label} "
                                               f"({len(configs)} configurations, suppress_iterations={iters})")
        unconverged += int(not torch.equal(got[None][0], got[1][0]))
    check(peaks_mod.launches == before + 4, f"peaks on {label}: a CUDA tensor did not reach the kernel")
    print(f"peaks selection on {label}: masks equal to the plain version for 2 and 1 configurations, "
          f"suppress_iterations None and 1 ({int(got[None][0].sum())} peaks under the general configuration)")
    return unconverged


def push_against_plain(torch, label, ring, xs) -> float:
    """The AGC kernel's ring mode (one ring_push) against ring_push_plain,
    torch.equal, on copies in host memory, where no kernel runs (its AGC
    step there is agc_chunk_plain), and on the card (where its AGC step is
    the chunk mode). Returns the largest difference to the host's."""
    from pitchvis_tpu_torch.ops import agc as agc_mod
    from pitchvis_tpu_torch.stream.ring import RingState, ring_push, ring_push_plain

    before = agc_mod.launches
    got = ring_push(ring, xs)
    check(agc_mod.launches == before + 1, f"ring push on {label}: a CUDA tensor did not reach the kernel")
    want = ring_push_plain(RingState(buffer=ring.buffer.cpu(), gain=ring.gain.cpu()), xs.cpu())
    got_buffer, got_gain = got.buffer.cpu(), got.gain.cpu()
    same = bool(torch.equal(got_buffer, want.buffer)) and bool(torch.equal(got_gain, want.gain))
    on_card = ring_push_plain(ring, xs)
    same_card = bool(torch.equal(got.buffer, on_card.buffer)) and bool(torch.equal(got.gain, on_card.gain))
    print(f"ring push on {label}: buffer and gain equal to ring_push_plain on the CPU: {same}, "
          f"on the card: {same_card}")
    check(same, f"ring push kernel differs from ring_push_plain on the CPU on {label}")
    check(same_card, f"ring push kernel differs from ring_push_plain on the card on {label}")
    return max(float((got_buffer - want.buffer).abs().max()), float((got_gain - want.gain).abs().max()))


def bound_ms(bytes_moved: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def synthetic_audio(torch, n_streams: int, n_samples: int, sr: float, gen) -> "torch.Tensor":
    """Per stream: two sines at seeded frequencies and amplitudes, plus noise,
    made on the card from a seeded generator."""
    dev = "cuda"
    t = torch.arange(n_samples, device=dev, dtype=torch.float64) / sr
    f = 55.0 * 2.0 ** (torch.rand((n_streams, 2), generator=gen, device=dev, dtype=torch.float64) * 6.5)
    amp = torch.rand((n_streams, 2), generator=gen, device=dev, dtype=torch.float64) * 0.4 + 0.02
    sig = (amp[:, :1] * torch.sin(2 * np.pi * f[:, :1] * t) + amp[:, 1:] * torch.sin(2 * np.pi * f[:, 1:] * t))
    noise = torch.randn((n_streams, n_samples), generator=gen, device=dev, dtype=torch.float64) * 0.01
    return (sig + noise).float()


def outputs_equal(torch, a, b, row=None) -> bool:
    """Every field of two AnalysisOutputs equal (torch.equal), or only
    their row ``row``."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if row is not None:
            x, y = x[row], y[row]
        if not torch.equal(x, y):
            return False
    return True


def serving_phase(torch, params, counts, reset_counts) -> dict:
    """Phase 5: StreamServer(2048, path="pallas", fast=True) hop by hop, the
    split of its hop, its equalities on the card, a B=64 server on the card
    against one on the CPU, two hops under set_sync_debug_mode("error"),
    and both serve-loop modes. Returns the kernels' launch counts of the
    measured hops. Its audio comes from generators of its own (seeds
    SEED + 1 and, for the card against the CPU, SEED + 2), so each part can
    be replayed alone."""
    from pitchvis_tpu_torch import StreamServer
    from pitchvis_tpu_torch.models.analysis import analysis_step_batch
    from pitchvis_tpu_torch.ops.vqt import vqt_db_auto

    sr = params.sr
    hop = int(sr / 60.0)  # the server's hop at its default hop_seconds
    dt = hop / sr
    warm = int(sr)
    nan_row, silent_row = 5, 7

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)

    def host_audio(n_streams, n_samples):
        return synthetic_audio(torch, n_streams, n_samples, sr, gen).cpu().numpy()

    def finite(out):
        return all(bool(torch.isfinite(getattr(out, k)).all()) for k in
                   ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_size", "scene_calmness",
                    "tuning_inaccuracy"))

    # (a) the hop at full width: per hop a (2048, 367) block with one NaN row
    # (rejected: that stream freezes) and one silent row
    n_blocks = SERVER_HOPS + 12
    sig = host_audio(B, warm + n_blocks * hop)
    sig[silent_row] = 0.0
    blocks = [sig[:, warm + i * hop : warm + (i + 1) * hop].copy() for i in range(n_blocks)]
    for block in blocks:
        block[nan_row, 100] = np.nan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = StreamServer(B, params, path="pallas", fast=True, device="cuda")
    t = time.perf_counter()
    srv.push_batch(sig[:, :warm])
    warm_push_ms = (time.perf_counter() - t) * 1e3
    srv.step(dt=dt)  # materializes the window from the warm-up second
    srv.push_batch(blocks[0])
    srv.step(dt=dt)
    torch.cuda.synchronize()
    frozen_before = srv.stats["frozen"]
    reset_counts()
    hop_ms, push_ms = [], []
    for h in range(1, SERVER_HOPS + 1):
        t = time.perf_counter()
        ok = srv.push_batch(blocks[h])
        push_ms.append((time.perf_counter() - t) * 1e3)
        check(not ok[nan_row] and int(ok.sum()) == B - 1, "push_batch: the NaN row must be rejected alone")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, gains = srv.step(dt=dt)
        torch.cuda.synchronize()
        hop_ms.append((time.perf_counter() - t) * 1e3)
        check(finite(out), f"server: non-finite output at hop {h}")
    server_counts = counts()
    want = {"vqt": SERVER_HOPS, "peaks": 2 * SERVER_HOPS, "agc": 0}
    check(server_counts == want, f"server: launches {server_counts}, expected {want}")
    check(float(gains[silent_row]) == 1.0, "server: the silent stream's gain moved")
    check(srv.stats["frozen"] - frozen_before == SERVER_HOPS, f"server: frozen stream-hops {srv.stats}")
    check(int(out.peaks.sum()) > 0, "server found no peaks")
    steady = float(np.median(hop_ms))
    print(f"server hop: {SERVER_HOPS} hops at B={B} (StreamServer path=pallas fast=True), hop ms median "
          f"{steady:.3f} (min {min(hop_ms):.3f}, max {max(hop_ms):.3f}), aggregate realtime "
          f"{B * dt * 1e3 / steady:.1f}x; push_batch ms median {float(np.median(push_ms)):.3f} "
          f"(1 s warm-up push {warm_push_ms:.1f} ms); launches {server_counts}")

    # the split of a hop: the step's parts one by one (a measured side path
    # whose hops are written back like served ones)
    split = {k: [] for k in ("push_batch", "consume", "copy_enqueue", "h2d_copy", "roll", "vqt + dB",
                             "analysis (peaks x2)")}
    for h in range(SERVER_HOPS + 1, SERVER_HOPS + 5):
        t0 = time.perf_counter()
        srv.push_batch(blocks[h])
        t1 = time.perf_counter()
        plan, vqt_params, (state, ml, balls), window = srv._capture()
        slot, _, adv = srv._consume_hop()
        t2 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        chunk = srv._stage.send(slot)
        adv_t = srv._stage.put(adv)
        dt_b = torch.full((B,), dt, dtype=torch.float32, device="cuda")
        t3 = time.perf_counter()
        ev[1].record()
        rolled = plan.roll_window(window, chunk, adv_t)
        ev[2].record()
        x_vqt = vqt_db_auto(plan.arrays, rolled, path=plan.path)
        ev[3].record()
        new_state, _ = analysis_step_batch(plan.analysis_params, plan.rng, state, x_vqt, dt_b)
        ev[4].record()
        torch.cuda.synchronize()
        check(srv._writeback(vqt_params, (new_state, ml, balls), rolled), "split hop: write-back refused")
        for key, v in (("push_batch", t1 - t0), ("consume", t2 - t1), ("copy_enqueue", t3 - t2)):
            split[key].append(v * 1e3)
        for i, key in enumerate(("h2d_copy", "roll", "vqt + dB", "analysis (peaks x2)")):
            split[key].append(ev[i].elapsed_time(ev[i + 1]))
    print("server split ms (median of 4 hops; push_batch, consume and copy_enqueue by the host clock, the "
          "rest by CUDA events): " + json.dumps({k: round(float(np.median(v)), 4) for k, v in split.items()}))
    host_bytes = srv.rings.n_streams * srv.rings.capacity * 4
    print(f"server: stats {json.dumps(srv.stats)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; native ring bank {host_bytes / 1e9:.3f} GB "
          f"of host memory ({srv.rings.n_streams} x {srv.rings.capacity} f32); "
          f"{B * hop * 4 / 1e6:.2f} MB of f32 chunks over the link a hop")

    # (b) no host synchronisation in a warmed delta hop, nor in a catch-up
    # hop (after a warm one, which allocates the staging for two chunks)
    def two_hops(i):
        return np.concatenate([blocks[i], blocks[i + 1]], axis=1)

    srv.push_batch(two_hops(SERVER_HOPS + 5))
    srv.step(dt=dt)
    before = srv.stats["catchup_hops"]
    for label, pushed in (("one delta hop", blocks[SERVER_HOPS + 7]),
                          ("a hop and a catch-up hop", two_hops(SERVER_HOPS + 8))):
        srv.push_batch(pushed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            srv.step(dt=dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f'server step at B={B}, {label}, under set_sync_debug_mode("error"): no host synchronisation')
    check(srv.stats["catchup_hops"] == before + 1, f"no catch-up hop ran: {srv.stats}")

    # (c) both serve-loop modes for LOOP_S, a producer thread pushing at the
    # audio rate
    for mode, kw in (("latest", dict(rate_hz=60.0, pipelined=True)),
                     ("per_hop", dict(rate_hz=60.0, hops_per_dispatch=4, publish="per_hop"))):
        stop = threading.Event()

        def produce():
            next_t = time.monotonic()
            i = 0
            while not stop.is_set():
                srv.push_batch(blocks[i % n_blocks])
                i += 1
                next_t += dt
                stop.wait(max(0.0, next_t - time.monotonic()))

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        loop = srv.serve(**kw)
        waits, seq, last = [], 0, None
        t_end = time.monotonic() + LOOP_S
        while time.monotonic() < t_end:
            t = time.monotonic()
            last = loop.wait_next(seq, timeout=2.0)
            waits.append((time.monotonic() - t) * 1e3)
            check(last is not None, f"serve loop ({mode}) published nothing for 2 s")
            seq = last[0]
        loop.stop()
        stop.set()
        producer.join(timeout=10.0)
        check(not producer.is_alive(), "the producer thread did not stop")
        check(loop.error is None and loop.stats["published"] > 0, f"serve loop ({mode}): {loop.stats}")
        check(finite(last[1]), f"serve loop ({mode}): non-finite outputs")
        print(f"serve loop {json.dumps(kw)} for {LOOP_S} s: {json.dumps(loop.stats)}; the consumer's "
              f"wait_next ms median {float(np.median(waits)):.3f}, max {max(waits):.3f} ({len(waits)} waits)")
    srv.close()
    del srv, out, sig, blocks
    torch.cuda.empty_cache()

    # (d) equalities on the card, at B=EQ_B
    eq_sig = host_audio(EQ_B, warm + 12 * hop)
    eq_blocks = [eq_sig[:, warm + i * hop : warm + (i + 1) * hop] for i in range(12)]

    def eq_server(warmed=True, **kw):
        s = StreamServer(EQ_B, params, path="pallas", fast=True, device="cuda", buffer_seconds=2.0, **kw)
        if warmed:
            s.push_batch(eq_sig[:, :warm])
            s.step(dt=dt)
        return s

    k = 4
    singles_srv, multi, per_hop = eq_server(), eq_server(), eq_server()
    singles = []
    for blk in eq_blocks[:k]:
        singles_srv.push_batch(blk)
        singles.append(singles_srv.step(dt=dt)[0])
        multi.push_batch(blk)
        per_hop.push_batch(blk)
    last, _ = multi.step_multi(k)
    check(outputs_equal(torch, last, singles[-1]) and torch.equal(multi._window, singles_srv._window),
          "step_multi(4) differs from 4 step()s")
    hops_out, _ = per_hop.step_multi(k, per_hop=True)
    check(all(outputs_equal(torch, a, b) for a, b in zip(hops_out, singles)),
          "step_multi(4, per_hop=True) differs from the 4 hops")
    plain, piped = eq_server(), eq_server()
    got, want = [], []
    for blk in eq_blocks[:k]:
        plain.push_batch(blk)
        piped.push_batch(blk)
        want.append(plain.step(dt=dt)[0])
        r = piped.step(pipelined=True, dt=dt)
        if r is not None:
            got.append(r[0])
    got.append(piped.flush()[0])
    check(len(got) == k and all(outputs_equal(torch, a, b) for a, b in zip(got, want)),
          "step(pipelined=True) + flush() differs from the unpipelined sequence")
    delta, snap = eq_server(), eq_server(ingest="snapshot")
    for blk in eq_blocks[:k]:
        delta.push_batch(blk)
        snap.push_batch(blk)
        check(outputs_equal(torch, delta.step(dt=dt)[0], snap.step(dt=dt)[0]),
              "delta ingest differs from snapshot ingest at the matched rate")
    row = 9
    reset, fresh = eq_server(), eq_server(warmed=False)
    reset.reset_stream(row)
    for blk in eq_blocks[k : k + 3]:
        reset.push_batch(blk[row : row + 1], streams=np.array([row]))
        fresh.push_batch(blk[row : row + 1], streams=np.array([row]))
        check(outputs_equal(torch, reset.step(dt=dt)[0], fresh.step(dt=dt)[0], row=row),
              "after reset_stream, the row differs from a fresh server's")
    for s in (singles_srv, multi, per_hop, plain, piped, delta, snap, reset, fresh):
        s.close()
    print(f"server equalities on the card at B={EQ_B} (torch.equal): step_multi(4) == 4 steps, "
          f"per_hop == the hops, pipelined + flush == unpipelined, delta == snapshot, reset row == fresh row")

    # (e) a B=CPU_B server on the card against one on the CPU, same pushes
    gen.manual_seed(SEED + 2)
    cpu_sig = host_audio(CPU_B, warm + CPU_HOPS * hop)
    cpu_sig[3, warm + 2 * hop + 5] = np.nan
    pair = {d: StreamServer(CPU_B, params, path="pallas", fast=True, device=d, buffer_seconds=2.0)
            for d in ("cuda", "cpu")}
    for s in pair.values():
        s.push_batch(cpu_sig[:, :warm])
        s.step(dt=dt)
    flips = total = 0
    worst = 0.0
    for h in range(CPU_HOPS):
        outs = {}
        for d, s in pair.items():
            s.push_batch(cpu_sig[:, warm + h * hop : warm + (h + 1) * hop])
            outs[d] = s.step(dt=dt)
        check(np.array_equal(outs["cuda"][1], outs["cpu"][1]), f"card and CPU servers' gains differ at hop {h}")
        card, host = outs["cuda"][0], outs["cpu"][0]
        pk_card, pk_host = card.peaks.cpu().numpy(), host.peaks.numpy()
        agree = pk_card == pk_host
        flips += int((~agree).sum())
        total += agree.size
        for name in ("x_vqt_smoothed", "x_vqt_afterglow", "calmness", "peak_center", "peak_size",
                     "pitch_accuracy", "pitch_deviation"):
            err = float(np.abs(getattr(card, name).cpu().numpy()[agree] - getattr(host, name).numpy()[agree]).max())
            worst = max(worst, err)
            check(err <= 1e-3, f"card vs CPU server: {name} {err} at hop {h}")
        for name in ("scene_calmness", "tuning_inaccuracy"):
            err = float(np.abs(getattr(card, name).cpu().numpy() - getattr(host, name).numpy()).max())
            worst = max(worst, err)
            check(err <= 1e-3, f"card vs CPU server: {name} {err} at hop {h}")
    check(flips <= 2e-4 * total, f"card vs CPU server: {flips} of {total} peak bins flipped")
    for s in pair.values():
        s.close()
    print(f"server on the card vs on the CPU, B={CPU_B}, {CPU_HOPS} hops: gains equal, max |diff| of the "
          f"continuous outputs where the peaks agree {worst:.3e} (tol 1e-3), {flips} of {total} peak bins "
          f"flipped (tol 2e-4)")
    return server_counts


def u8_close(got, want, share: float, what: str) -> tuple[float, float]:
    """u8 levels (or floats holding levels) within one level of each other
    in at most ``share`` of the values; returns (max diff, share moved)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    moved = float((d > 0).mean()) if d.size else 0.0
    check(d.size == 0 or d.max() <= 1.0, f"{what}: a u8 level moved by {d.max()}")
    check(moved <= share, f"{what}: {moved:.2e} of the levels moved (tol {share})")
    return (float(d.max()) if d.size else 0.0), moved


def leaves(tree, prefix="") -> dict:
    """{dotted path: tensor} of every tensor of an output dataclass tree."""
    import dataclasses

    if tree is None:
        return {}
    if not dataclasses.is_dataclass(tree):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(leaves(getattr(tree, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    return out


def stages_close(torch, got: dict, want: dict, what: str) -> dict:
    """The output stages' leaves of the card (``got``) against the CPU's
    (``want``) at the phase 6 tolerances; returns the largest difference of
    the float leaves, of the positions and of the u8 leaves, and the largest
    share of u8 values moved."""
    worst = {"floats": 0.0, "positions": 0.0, "u8_levels": 0.0, "u8_share_moved": 0.0}
    check(set(got) == set(want), f"{what}: leaves {sorted(got)} vs {sorted(want)}")
    for path, g in got.items():
        g, w = g.cpu().numpy(), want[path].cpu().numpy()
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what} {path}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.dtype == np.bool_:
            check(np.array_equal(g, w), f"{what} {path}: {int((g != w).sum())} booleans differ")
        elif g.dtype == np.uint8 or path.endswith("rgba"):
            if g.dtype != np.uint8:  # RGB in levels of 1/255, then alpha
                err = float(np.abs(g[..., 3] - w[..., 3]).max())
                check(err <= STAGE_ATOL, f"{what} {path} alpha: {err}")
                worst["floats"] = max(worst["floats"], err)
                g, w = np.round(g[..., :3] * 255.0), np.round(w[..., :3] * 255.0)
            levels, moved = u8_close(g, w, STAGE_U8_SHARE, f"{what} {path}")
            worst["u8_levels"] = max(worst["u8_levels"], levels)
            worst["u8_share_moved"] = max(worst["u8_share_moved"], moved)
        else:
            key, tol = ("positions", POSITION_ATOL) if path.endswith("position") else ("floats", STAGE_ATOL)
            err = float(np.abs(g - w).max()) if g.size else 0.0
            check(np.isfinite(g).all() and err <= tol, f"{what} {path}: {err} (tol {tol})")
            worst[key] = max(worst[key], err)
    return worst


def golden_phase(torch, counts, reset_counts) -> dict:
    """Phase 6 (c): the committed chain and viewer goldens through the port's
    StreamingPipeline on the card, f32 (fast=False), at the serial
    parameters: the four chain signals as four streams with the LED stage
    for 600 hops, the two viewer signals as two streams with both stages for
    360. Returns their numbers."""
    from pitchvis_tpu_torch import StreamingPipeline
    from pitchvis_tpu_torch.core.config import SERIAL_VQT_PARAMETERS as serial
    from pitchvis_tpu_torch.io.led import frame_bytes

    hop = int(serial.sr / 60.0)
    n = serial.n_buckets
    result = {}
    for file, names, with_viewer in (("chain_golden.npz", ("arpeggio", "chirp", "chord", "synth"), False),
                                      ("viewer_golden.npz", ("arpeggio", "chord"), True)):
        with np.load(os.path.join(ROOT, "tests", "golden", file)) as z:
            g = {k: z[k] for k in z.files}
        sig = np.stack([g[f"in_{name}"] for name in names])
        k_total = sig.shape[1] // hop
        pipe = StreamingPipeline(len(names), serial, path="pallas", fast=False, with_led=True,
                                 with_viewer=with_viewer, device="cuda")
        rec = {}
        reset_counts()
        t = time.perf_counter()
        for i in range(k_total):
            out = pipe.step(sig[:, i * hop : (i + 1) * hop], hop / serial.sr)
            hop_leaves = {"peaks": out.analysis.peaks, "calmness": out.analysis.calmness,
                          "scene_calmness": out.analysis.scene_calmness, "led": out.led}
            hop_leaves.update({f"viewer.{k}": v for k, v in leaves(out.viewer).items()})
            for key, v in hop_leaves.items():
                rec.setdefault(key, []).append(v)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        check(counts() == {"vqt": k_total, "peaks": 2 * k_total, "agc": k_total},
              f"{file}: launches {counts()} for {k_total} hops")
        rec = {key: torch.stack(v, dim=1).cpu().numpy() for key, v in rec.items()}
        del pipe
        worst = {"flips": 0.0, "calmness": 0.0, "scene_calmness": 0.0, "led": 0}
        viewer_worst = {}
        for b, name in enumerate(names):
            flips = rec["peaks"][b] != g[f"{name}_peaks"]
            calm = float(np.abs(rec["calmness"][b] - g[f"{name}_calmness"]).max())
            scene = float(np.abs(rec["scene_calmness"][b] - g[f"{name}_scene_calmness"]).max())
            led_diff = np.abs(rec["led"][b].astype(np.int32) - g[f"{name}_led"].astype(np.int32))
            led = int(led_diff[~flips].max())
            check(flips.mean() <= 2e-4 and calm <= 0.02 and scene <= 5e-3 and led <= 4,
                  f"{file} {name}: peak flips {flips.mean():.2e} (tol 2e-4), calmness {calm} (0.02), "
                  f"scene calmness {scene} (5e-3), LED {led} levels where the peaks agree (4)")
            # the framed serial byte stream, rebuilt with the port's frame_bytes
            stream = np.frombuffer(b"".join(frame_bytes(f) for f in rec["led"][b]), np.uint8)
            frames = stream.reshape(-1, 3 + 3 * n)
            check(stream.size == g[f"{name}_stream"].size and (frames[:, 0] == 0xFF).all()
                  and (frames[:, 1] == n // 256).all() and (frames[:, 2] == n % 256).all()
                  and (frames[:, 3:] <= 0xFE).all(), f"{file} {name}: serial byte stream framing")
            for key, v in zip(worst, (float(flips.mean()), calm, scene, led)):
                worst[key] = max(worst[key], v)
            if not with_viewer:
                continue
            agree = ~flips.any(axis=1)
            check(agree.mean() > 0.99, f"{file} {name}: {agree.mean():.3f} of the frames agree on every peak")
            golden_keys = {"balls.position": "ball_position", "balls.rgba": "ball_rgba", "balls.scale": "ball_scale",
                           "balls.visible": "ball_visible", "balls.calmness": "ball_calmness",
                           "balls.pitch_accuracy": "ball_pitch_accuracy",
                           "balls.pitch_deviation": "ball_pitch_deviation", "chroma": "chroma", "bloom": "bloom",
                           "spectrogram_row": "spectrogram_row", "bass.visible": "bass_visible",
                           "bass.rgba": "bass_rgba", "calmness_histogram.heights": "hist_heights",
                           "calmness_histogram.segment_rgb": "hist_segment_rgb"}
            for path, key in golden_keys.items():
                got, want = rec[f"viewer.{path}"][b][agree], g[f"{name}_{key}"][agree]
                what = f"{file} {name} {key}"
                if got.dtype == np.bool_:
                    check(np.array_equal(got, want), f"{what}: {int((got != want).sum())} differ")
                    err = 0.0
                elif got.dtype == np.uint8:
                    err, _ = u8_close(got, want, GOLDEN_U8_SHARE, what)
                elif path.endswith("rgba"):
                    u8_close(np.round(got[..., :3] * 255.0), np.round(want[..., :3] * 255.0), GOLDEN_U8_SHARE, what)
                    err = float(np.abs(got[..., 3] - want[..., 3]).max())
                else:
                    err = float(np.abs(got - want).max())
                check(err <= (1.0 if got.dtype == np.uint8 else GOLDEN_FLOAT_ATOL), f"{what}: {err}")
                viewer_worst[key] = max(viewer_worst.get(key, 0.0), err)
        label = "viewer_golden" if with_viewer else "chain_golden"
        result[label] = dict(worst, hops=k_total, streams=len(names), seconds=secs, **(
            {"viewer_max_err": viewer_worst} if with_viewer else {}))
        print(f"{file} on the card ({len(names)} streams, {k_total} hops, f32, {secs:.1f} s): peak flips "
              f"{worst['flips']:.2e} (tol 2e-4), calmness {worst['calmness']:.3e} (0.02), scene calmness "
              f"{worst['scene_calmness']:.3e} (5e-3), LED {worst['led']} levels where the peaks agree (4), "
              f"serial stream framing checked"
              + (f"; viewer keys max |diff| {json.dumps(viewer_worst)}" if with_viewer else ""))
    return result


def output_stages_phase(torch, params, counts, reset_counts, gen) -> tuple[dict, dict]:
    """Phase 6: StreamingPipeline(2048, path="pallas", fast=True, with_led=True,
    with_viewer=True) for STAGE_HOPS hops after two of warm-up, beside the bare
    pipeline on the same audio; the output stages alone under the profiler;
    a hop under set_sync_debug_mode("error"); the stages on the card against
    the CPU on one hop's inputs; the golden replays; a fetch="led" server
    against a with_led one. Returns (the stage path's launch counts, the
    phase's numbers)."""
    from pitchvis_tpu_torch import CompactOutputs, StreamingPipeline, StreamServer
    from pitchvis_tpu_torch.models.analysis import AnalysisOutputs
    from pitchvis_tpu_torch.models.pipeline import derived_stages
    from pitchvis_tpu_torch.models.viewer import BallState

    sr = params.sr
    hop = int(sr / 60.0)
    dt = hop / sr
    warm = 2
    audio = synthetic_audio(torch, B, (warm + STAGE_HOPS + 2) * hop, sr, gen)
    audio[7] = 0.0  # a silent stream: no peaks, an all-zero LED frame
    audio[5, 3 * hop + 11] = float("nan")

    def chunk(h):
        return audio[:, h * hop : (h + 1) * hop]

    def run(pipe, counted):
        for h in range(warm):
            pipe.step(chunk(h), dt)
        torch.cuda.synchronize()
        if counted:
            reset_counts()
        ms = []
        for h in range(warm, warm + STAGE_HOPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.step(chunk(h), dt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms, (counts() if counted else None)

    # (a) the hop with the output stages, then the bare hop on the same audio
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = StreamingPipeline(B, params, path="pallas", fast=True, with_led=True, with_viewer=True, device="cuda")
    out, stage_ms, stage_counts = run(pipe, True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"vqt": STAGE_HOPS, "peaks": 2 * STAGE_HOPS, "agc": STAGE_HOPS}
    check(stage_counts == want, f"output stages path: launches {stage_counts}, expected {want}")
    n = params.n_buckets
    check(out.led.dtype == torch.uint8 and tuple(out.led.shape) == (B, n, 3), f"LED {out.led.dtype} {out.led.shape}")
    check(int(out.led.max()) <= 0xFE and int(out.led[7].max()) == 0, "LED: a value above 0xFE or a lit silent stream")
    for path, leaf in leaves(out.viewer).items():
        check(leaf.shape[0] == B and (leaf.dtype in (torch.bool, torch.uint8) or bool(torch.isfinite(leaf).all())),
              f"viewer {path}: {leaf.dtype} {tuple(leaf.shape)}")
    check(bool(out.viewer.balls.visible.any()) and bool(out.led.any()), "the output stages lit nothing")
    bare = StreamingPipeline(B, params, path="pallas", fast=True, device="cuda")
    _, bare_ms, _ = run(bare, False)
    del bare
    torch.cuda.empty_cache()
    med, bare_med = float(np.median(stage_ms)), float(np.median(bare_ms))
    print(f"output stages hop: {STAGE_HOPS} hops at B={B} (StreamingPipeline path=pallas fast=True with_led "
          f"with_viewer), hop ms median {med:.3f} (min {min(stage_ms):.3f}, max {max(stage_ms):.3f}); the bare "
          f"pipeline right after on the same audio {bare_med:.3f} (min {min(bare_ms):.3f}, max {max(bare_ms):.3f}); "
          f"aggregate realtime {B * dt * 1e3 / med:.1f}x; peak device memory {peak_gib:.2f} GiB; launches "
          f"{stage_counts}")

    # (b) the stages alone: device ops and time (profiler, the fullest of
    # three traces) and the host's enqueue (median of 5, not profiled)
    balls = pipe.state.balls
    dt_b = torch.full((B,), dt, dtype=torch.float32, device="cuda")

    def stages(with_led=True, with_viewer=True):
        return derived_stages(params.range, out.analysis, dt_b, with_led=with_led,
                              balls_state=balls, with_viewer=with_viewer)

    profile = {}
    for label, kw in (("both", {}), ("led", dict(with_viewer=False)), ("viewer", dict(with_led=False))):
        launches, device_ms = max(device_trace(torch, lambda: stages(**kw)) for _ in range(3))
        enqueue, wall = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            stages(**kw)
            enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        profile[label] = dict(launches=launches, device_ms=device_ms, enqueue_ms=float(np.median(enqueue)),
                              wall_ms=float(np.median(wall)))
    print(f"output stages alone at B={B} (derived_stages; launches and device ms from the profiler, enqueue and "
          f"wall ms by the host clock): {json.dumps(profile)}")

    # (c) one hop with the stages under set_sync_debug_mode("error")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(chunk(warm + STAGE_HOPS), dt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f'output stages hop at B={B} under set_sync_debug_mode("error"): no host synchronisation')

    # (d) card against CPU: one hop's analysis outputs and ball carry moved
    # to the CPU, the stages run there on the same inputs
    balls_before = pipe.state.balls
    out = pipe.step(chunk(warm + STAGE_HOPS + 1), dt)
    card = dict(leaves(out.viewer, "viewer"), led=out.led, **leaves(pipe.state.balls, "balls_state"))
    cpu_analysis = AnalysisOutputs(**{k: v.cpu() for k, v in leaves(out.analysis).items()})
    cpu_balls = BallState(**{k: v.cpu() for k, v in leaves(balls_before).items()})
    t = time.perf_counter()
    _, _, led, new_balls, viewer = derived_stages(params.range, cpu_analysis, dt_b.cpu(), with_led=True,
                                                  balls_state=cpu_balls, with_viewer=True)
    cpu_s = time.perf_counter() - t
    host = dict(leaves(viewer, "viewer"), led=led, **leaves(new_balls, "balls_state"))
    worst = stages_close(torch, card, host, "stages, card vs CPU")
    print(f"output stages on the card vs on the CPU (one hop's inputs, B={B}, the CPU's run {cpu_s:.2f} s): "
          f"{len(card)} leaves, max |diff| of the floats {worst['floats']:.3e} (tol {STAGE_ATOL}), of the ball "
          f"positions {worst['positions']:.3e} (tol {POSITION_ATOL}), u8 values at most {worst['u8_levels']:.0f} "
          f"level apart in at most {worst['u8_share_moved']:.2e} of a leaf's values (tol {STAGE_U8_SHARE}), "
          f"booleans equal")
    del pipe, out, balls, balls_before, card, host, audio
    torch.cuda.empty_cache()

    # (e) the golden replays
    goldens = golden_phase(torch, counts, reset_counts)

    # (f) StreamServer(fetch="led") against a with_led server fed the same pushes
    gen.manual_seed(SEED + 3)
    n_blocks = STAGE_HOPS + 1
    sig = synthetic_audio(torch, B, int(sr) + n_blocks * hop, sr, gen).cpu().numpy()
    servers = {fetch: StreamServer(B, params, path="pallas", fast=True, fetch=fetch, with_led=True, device="cuda")
               for fetch in ("led", "full")}
    server_ms = []
    try:
        for s in servers.values():
            s.push_batch(sig[:, : int(sr)])
            s.step(dt=dt)
        for h in range(n_blocks):
            block = sig[:, int(sr) + h * hop : int(sr) + (h + 1) * hop]
            outs = {}
            for fetch, s in servers.items():
                s.push_batch(block)
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs[fetch], _ = s.step(dt=dt)
                torch.cuda.synchronize()
                if fetch == "led" and h > 0:
                    server_ms.append((time.perf_counter() - t) * 1e3)
            compact, full = outs["led"], outs["full"]
            check(isinstance(compact, CompactOutputs), f"fetch='led' returned {type(compact).__name__}")
            check(torch.equal(compact.led, full.led) and torch.equal(compact.scene_calmness, full.analysis.scene_calmness)
                  and torch.equal(compact.tuning_inaccuracy, full.analysis.tuning_inaccuracy),
                  f"fetch='led' differs from the with_led server at hop {h}")
    finally:
        for s in servers.values():
            s.close()
    server_med = float(np.median(server_ms))
    print(f"server fetch='led' at B={B}: hop ms median {server_med:.3f} (min {min(server_ms):.3f}, max "
          f"{max(server_ms):.3f}, {len(server_ms)} hops); CompactOutputs.led equal (torch.equal) to a with_led "
          f"fetch='full' server's at every hop")
    numbers = dict(hop_ms=med, hop_min_ms=min(stage_ms), hop_max_ms=max(stage_ms), bare_hop_ms=bare_med,
                   bare_hop_min_ms=min(bare_ms), bare_hop_max_ms=max(bare_ms), peak_gib=peak_gib,
                   stages_alone=profile, card_vs_cpu_max_err=worst, server_fetch_led_hop_ms=server_med, **goldens)
    return stage_counts, numbers


def synthetic_training_data(n_frames: int, seed: int, n_buckets: int = 252) -> np.ndarray:
    """tests/test_ml.py's synthetic task at the trained width, in the
    data.npy layout (flat rows of n_buckets VQT values + 128 MIDI targets):
    per frame 0-2 dB of seeded noise a bin, and each of 12 keys (MIDI 36 to
    91, a fourth apart) active with probability 1/2, lifting its three bins
    (36 an octave from 55 Hz, MIDI 33) by 20 dB."""
    rng = np.random.default_rng(seed)
    keys = np.arange(36, 96, 5)
    vqt = rng.random((n_frames, n_buckets), dtype=np.float32) * 2.0
    active = rng.random((n_frames, len(keys))) > 0.5
    midi = np.zeros((n_frames, 128), np.float32)
    for i, k in enumerate(keys):
        b = (k - 33) * 3
        vqt[active[:, i], b - 1 : b + 2] += 20.0
        midi[active[:, i], k] = 1.0
    return np.concatenate([vqt, midi], axis=1).ravel()


def ml_phase(torch, counts, reset_counts, gen) -> tuple[dict, dict]:
    """Phase 7: the VQT and peaks kernels at TRAIN_VQT_PARAMETERS against
    their plain versions; the trainer at full width (20 steps, the step's launches and
    device time, one step on the card against the CPU, train(epochs=1) with
    a checkpoint and its load); StreamingPipeline(2048, TRAIN_VQT_PARAMETERS,
    path="pallas", fast=True, ml_model=) beside the bare pipeline, the ML
    stage alone, a sync-free hop, the stage on the card against the CPU; a
    StreamServer with the ML stage, and its step_multi(4) against 4 steps.
    Returns (the ML paths' launch counts, the phase's numbers)."""
    import dataclasses
    import shutil

    from pitchvis_tpu_torch import StreamingPipeline, StreamServer
    from pitchvis_tpu_torch.core.config import TRAIN_VQT_PARAMETERS as tp
    from pitchvis_tpu_torch.kernel.builder import get_kernel
    from pitchvis_tpu_torch.models.ml_system import MlState, ml_step_batch, serving_copy
    from pitchvis_tpu_torch.models.pipeline import derived_stages
    from pitchvis_tpu_torch.ops import vqt_pallas as vqt_mod
    from pitchvis_tpu_torch.ops.vqt import power_to_db
    from pitchvis_tpu_torch.train.train import (
        TrainConfig, load_checkpoint, make_model, make_optimizer, train, train_step, window_data,
    )

    numbers = {}
    sr = tp.sr
    hop = int(sr / 60.0)
    dt = hop / sr

    # (a) the VQT kernel at this slice's geometry, before anything is timed
    kernel = get_kernel(tp)
    frames = synthetic_audio(torch, B, tp.n_fft, sr, gen)
    vqt = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        arrays = vqt_mod.PallasVqtArrays.from_kernel(kernel, dtype=dtype, device="cuda")
        power, err_db, rel = vqt_kernel_against_plain(torch, f"vqt_power_{label} at TRAIN_VQT_PARAMETERS, B={B}",
                                                  arrays, frames)
        vqt_kernel_against_plain(torch, f"vqt_power_{label} at TRAIN_VQT_PARAMETERS, B=1", arrays, frames[:1])
        ms = time_ms(torch, lambda: vqt_mod.vqt_power_pallas(arrays, frames))
        _, card_ms = device_trace(torch, lambda: vqt_mod.vqt_power_pallas(arrays, frames), "vqt_kernel", inner=20)
        vqt[label] = dict(max_db_err=err_db, max_rel_err=rel, ms=ms, card_ms=card_ms)
        if dtype == torch.bfloat16:
            spectra = power_to_db(power)
        geometry = dict(tail=arrays.tail, window_sizes=list(arrays.window_sizes), offsets=list(arrays.offsets),
                        nf=list(arrays.nf), nf_pad=list(arrays.nf_pad))
    print(f"vqt at TRAIN_VQT_PARAMETERS ({tp.n_buckets} bins; geometry {json.dumps(geometry)}): "
          f"{json.dumps(vqt)} (ms a call, on the card alone)")
    numbers["vqt_train_params"] = dict(vqt, geometry=geometry)
    del frames, arrays, power

    # the peaks kernel at this slice's 252 bins, 36 an octave (its minimum
    # separation and first allowed bin follow both): the bf16 kernel's dB
    # spectra, one frame, and a rounded random walk (plateaus and ties)
    bpo = tp.range.buckets_per_octave
    walk = np.round(np.cumsum(np.random.default_rng(SEED).standard_normal((B, tp.n_buckets)), 1))
    peak_cases = [(f"vqt spectra at TRAIN_VQT_PARAMETERS, B={B}", spectra),
                  ("one frame at TRAIN_VQT_PARAMETERS", spectra[:1]),
                  (f"rounded random walk of {tp.n_buckets} bins, B={B}",
                   torch.from_numpy(walk.astype(np.float32)).cuda())]
    unconverged = sum(peaks_masks_against_plain(torch, label, xs, bpo) for label, xs in peak_cases)
    peak_labels = [label for label, _ in peak_cases]
    del spectra, walk, peak_cases
    torch.cuda.empty_cache()

    # (b) the trainer at full width: TrainConfig() (the reference recipe:
    # Adam lr 1e-5, batch 300, dropout 0.1) on the synthetic task
    cfg = TrainConfig()
    b = cfg.batch_size
    x, y = window_data(synthetic_training_data(TRAIN_STEPS * b + cfg.t_window - 1, SEED), cfg)
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    model = make_model(cfg, device="cuda")
    model.train()
    optimizer, scheduler = make_optimizer(cfg, model)
    tgen = torch.Generator(device="cuda").manual_seed(SEED)
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        xb, yb = xt[s * b : (s + 1) * b], yt[s * b : (s + 1) * b]
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(train_step(model, optimizer, xb, yb, scheduler, tgen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"trainer: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"trainer: the loss did not fall over {TRAIN_STEPS} steps: {losses}")

    def one_step():
        return train_step(model, optimizer, xb, yb, scheduler, tgen)

    step_launches, step_device_ms = max(device_trace(torch, one_step) for _ in range(3))
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_step()
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # a forward and a backward (twice the forward's products) of the conv
    # and the four dense layers, at the FFMA rate; the batch read once, and
    # the parameters and Adam's two moments read and written once each
    conv_macs = 16 * 5 * ((cfg.t_window * cfg.n_buckets - 5) // 2 + 1)
    flops = 3 * 2.0 * b * (sum(layer.in_features * layer.out_features for layer in model.dense) + conv_macs)
    step_bound, step_bound_by = bound_ms(6 * 4 * n_params + b * (x.shape[1] + 128) * 4, flops, F32_FLOPS)
    trainer = dict(steps=TRAIN_STEPS, batch=b, params=n_params, losses=losses, step_ms=float(np.median(step_ms[1:])),
                   step_min_ms=min(step_ms[1:]), step_max_ms=max(step_ms[1:]), first_step_ms=step_ms[0],
                   launches=step_launches, device_ms=step_device_ms, enqueue_ms=float(np.median(enqueue)),
                   bound_ms=step_bound, bound_by=step_bound_by)
    print(f"trainer at full width ({n_params} parameters, batch {b}, {TRAIN_STEPS} steps of TrainConfig()): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step ms median {trainer['step_ms']:.3f} (min "
          f"{trainer['step_min_ms']:.3f}, max {trainer['step_max_ms']:.3f}, first {step_ms[0]:.1f}); one step: "
          f"{step_launches} device ops, {step_device_ms:.3f} ms on the card (profiler), {trainer['enqueue_ms']:.3f} "
          f"ms to enqueue; bound {step_bound:.4f} ms ({step_bound_by}; {flops / 1e9:.1f} GFLOP)")
    del model, optimizer, scheduler

    # one step (dropout 0) on the card against the same step on the CPU: the
    # same seed gives both the same weights
    pcfg = dataclasses.replace(cfg, dropout=0.0)
    pair = {d: make_model(pcfg, device=d) for d in ("cuda", "cpu")}
    check(all(torch.equal(v.cpu(), pair["cpu"].state_dict()[k]) for k, v in pair["cuda"].state_dict().items()),
          "trainer: one seed gave the card and the CPU different weights")
    step_losses = {}
    for d, m in pair.items():
        m.train()
        opt, sch = make_optimizer(pcfg, m)
        step_losses[d] = float(train_step(m, opt, xt[:b].to(d), yt[:b].to(d), sch))
    loss_rel = abs(step_losses["cuda"] - step_losses["cpu"]) / abs(step_losses["cpu"])
    # the gradients train_step left on the parameters, leaf by leaf over the
    # CPU leaf's largest |gradient|: Adam's update hardly depends on their
    # size, so the parameters alone would not show a scaled or rounded backward
    cpu_grads = dict(pair["cpu"].named_parameters())
    grad_rel = max(float((p.grad.cpu() - cpu_grads[k].grad).abs().max() / cpu_grads[k].grad.abs().max())
                   for k, p in pair["cuda"].named_parameters())
    cpu_sd = pair["cpu"].state_dict()
    param_err = max(float((v.cpu() - cpu_sd[k]).abs().max()) for k, v in pair["cuda"].state_dict().items())
    print(f"train step on the card vs on the CPU (same weights and batch, dropout 0): loss rel err {loss_rel:.3e} "
          f"(tol {TRAIN_LOSS_RTOL}), max |grad diff| / leaf's max |grad| {grad_rel:.3e} (tol {TRAIN_GRAD_REL}), "
          f"max |param diff| {param_err:.3e} (tol {TRAIN_PARAM_ATOL})")
    check(loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL and param_err <= TRAIN_PARAM_ATOL,
          "train step: card and CPU disagree")
    trainer.update(card_vs_cpu_loss_rel_err=loss_rel, card_vs_cpu_grad_rel_err=grad_rel,
                   card_vs_cpu_param_max_err=param_err)
    del pair, xt, yt

    # train(epochs=1) with a checkpoint under build/ (gitignored), and its load
    ckpt_dir = os.path.join(ROOT, "build", "ml_phase_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    small = dataclasses.replace(cfg, epochs=1)
    t = time.perf_counter()
    params, metrics = train(synthetic_training_data(1204, SEED + 4), small, checkpoint_dir=ckpt_dir, device="cuda")
    train_s = time.perf_counter() - t
    loaded = load_checkpoint(ckpt_dir, small, device="cuda")
    check(set(loaded) == set(params) and all(torch.equal(loaded[k], params[k]) for k in params),
          "load_checkpoint differs from what train() saved")
    del params
    files = sorted(os.listdir(ckpt_dir))
    shutil.rmtree(ckpt_dir)
    trainer.update(train_epoch_s=train_s, train_metrics=metrics)
    print(f"train(epochs=1) on 1200 windows: {metrics['steps']} steps in {train_s:.2f} s, epoch loss "
          f"{metrics['epoch_loss']}, micro-F1 {metrics['f1_micro']:.3f}; checkpoint {files} written and loaded equal")
    numbers["trainer"] = trainer
    ml_model = make_model(small, device="cuda")

    # (c) the pipeline hop with the ML stage, then the bare pipeline on the
    # same audio
    warm = 2
    audio = synthetic_audio(torch, B, (warm + ML_HOPS + 2) * hop, sr, gen)

    def chunk(h):
        return audio[:, h * hop : (h + 1) * hop]

    def run(pipe, counted):
        for h in range(warm):
            pipe.step(chunk(h), dt)
        torch.cuda.synchronize()
        if counted:
            reset_counts()
        ms = []
        for h in range(warm, warm + ML_HOPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.step(chunk(h), dt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms, (counts() if counted else None)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = StreamingPipeline(B, tp, path="pallas", fast=True, ml_model=ml_model, ml_params=loaded, device="cuda")
    out, ml_ms, pipe_counts = run(pipe, True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"vqt": ML_HOPS, "peaks": 2 * ML_HOPS, "agc": ML_HOPS}
    check(pipe_counts == want, f"ML pipeline: launches {pipe_counts}, expected {want}")
    midi = out.ml_midi
    check(tuple(midi.shape) == (B, 128) and bool(torch.isfinite(midi).all())
          and bool(((midi >= 0) & (midi <= 1)).all()), f"ml_midi: {tuple(midi.shape)}, not finite or outside [0, 1]")
    check(pipe.ml_model is not ml_model and not any(p.requires_grad for p in pipe.ml_model.parameters()),
          "the pipeline does not serve its own frozen copy")
    # the peaks kernel on the spectra this path fed it in its last hop
    for label, xs in (("the ML pipeline's smoothed spectra", out.analysis.x_vqt_smoothed),
                      ("the ML pipeline's spectra", out.x_vqt)):
        unconverged += peaks_masks_against_plain(torch, f"{label}, B={B}", xs, bpo)
        peak_labels.append(label)
    numbers["peaks_train_params"] = dict(bpo=bpo, n=tp.n_buckets, cases=peak_labels, masks_equal=True,
                                         one_round_short=unconverged)
    bare = StreamingPipeline(B, tp, path="pallas", fast=True, device="cuda")
    _, bare_ms, _ = run(bare, False)
    del bare
    torch.cuda.empty_cache()
    med, bare_med = float(np.median(ml_ms)), float(np.median(bare_ms))
    print(f"ML hop: {ML_HOPS} hops at B={B} (StreamingPipeline TRAIN_VQT_PARAMETERS path=pallas fast=True "
          f"ml_model, the model train(epochs=1) wrote), hop ms median {med:.3f} (min {min(ml_ms):.3f}, max "
          f"{max(ml_ms):.3f}); the bare pipeline right after on the same audio {bare_med:.3f} (min "
          f"{min(bare_ms):.3f}, max {max(bare_ms):.3f}); peak device memory {peak_gib:.2f} GiB; launches "
          f"{pipe_counts}; ml_midi in [{float(midi.min()):.3e}, {float(midi.max()):.3e}], mean {float(midi.mean()):.3e}")

    # the ML stage alone: device ops and time (the fullest of three traces),
    # the host's enqueue and the wall time (median of 5, not profiled)
    dt_b = torch.full((B,), dt, dtype=torch.float32, device="cuda")
    history = pipe.state.ml

    def stage():
        return derived_stages(tp.range, out.analysis, dt_b, ml_model=pipe.ml_model, ml_state=history)

    launches, device_ms = max(device_trace(torch, stage) for _ in range(3))
    enqueue, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stage()
        enqueue.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    # a forward of the ML stage: the conv and four dense products at the
    # FFMA rate; the history, the new spectra and the weights read once, the
    # new history and the outputs written once
    flops = 2.0 * B * (sum(layer.in_features * layer.out_features for layer in pipe.ml_model.dense)
                       + 16 * 5 * ((pipe.ml_model.input_bins - 5) // 2 + 1))
    moved = (2 * history.history.numel() + B * tp.n_buckets + B * 128) * 4 + 4 * sum(
        p.numel() for p in pipe.ml_model.parameters())
    s_bound, s_bound_by = bound_ms(moved, flops, F32_FLOPS)
    alone = dict(launches=launches, device_ms=device_ms, enqueue_ms=float(np.median(enqueue)),
                 wall_ms=float(np.median(wall)), bound_ms=s_bound, bound_by=s_bound_by, gflop=flops / 1e9)
    print(f"ML stage alone at B={B} (derived_stages with ml_model; launches and device ms from the profiler, enqueue "
          f"and wall ms by the host clock): {json.dumps(alone)}")

    # one hop with the ML stage under set_sync_debug_mode("error")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(chunk(warm + ML_HOPS), dt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f'ML hop at B={B} under set_sync_debug_mode("error"): no host synchronisation')

    # the stage on the card against the CPU: the same history, spectra and weights
    before = pipe.state.ml
    out = pipe.step(chunk(warm + ML_HOPS + 1), dt)
    cpu_model = serving_copy(pipe.ml_model, None, "cpu")
    t = time.perf_counter()
    cpu_state, cpu_midi = ml_step_batch(cpu_model, None, MlState(history=before.history.cpu()),
                                        out.analysis.x_vqt_smoothed.cpu())
    cpu_s = time.perf_counter() - t
    check(torch.equal(pipe.state.ml.history.cpu(), cpu_state.history), "ML history: card and CPU differ")
    out_err = float((out.ml_midi.cpu() - cpu_midi).abs().max())
    with torch.no_grad():
        card_logits = pipe.ml_model.logits(pipe.state.ml.history.reshape(B, 1, -1)).cpu()
        cpu_logits = cpu_model.logits(cpu_state.history.reshape(B, 1, -1))
    logit_err = float((card_logits - cpu_logits).abs().max())
    logit_max = float(cpu_logits.abs().max())
    print(f"ML stage on the card vs on the CPU (one hop's history and spectra, B={B}, the CPU's run {cpu_s:.2f} s): "
          f"outputs max |diff| {out_err:.3e} (tol {ML_ATOL}), logits max |diff| {logit_err:.3e} of max |logit| "
          f"{logit_max:.3e} (tol {ML_LOGIT_REL} of it), histories equal")
    check(out_err <= ML_ATOL and logit_err <= ML_LOGIT_REL * logit_max, "ML stage: card and CPU disagree")
    del pipe, out, history, before, audio, cpu_model, cpu_state
    torch.cuda.empty_cache()

    # (d) a server with the ML stage: 16 hops at B=2048
    n_blocks = ML_HOPS + 1
    sig = synthetic_audio(torch, B, int(sr) + n_blocks * hop, sr, gen).cpu().numpy()
    blocks = [sig[:, int(sr) + i * hop : int(sr) + (i + 1) * hop] for i in range(n_blocks)]
    srv = StreamServer(B, tp, path="pallas", fast=True, ml_model=ml_model, ml_params=loaded, device="cuda")
    server_ms = []
    try:
        srv.push_batch(sig[:, : int(sr)])
        srv.step(dt=dt)
        srv.push_batch(blocks[0])
        srv.step(dt=dt)
        torch.cuda.synchronize()
        reset_counts()
        for h in range(1, n_blocks):
            srv.push_batch(blocks[h])
            torch.cuda.synchronize()
            t = time.perf_counter()
            sout, _ = srv.step(dt=dt)
            torch.cuda.synchronize()
            server_ms.append((time.perf_counter() - t) * 1e3)
            check(bool(torch.isfinite(sout.ml_midi).all()), f"ML server: non-finite ml_midi at hop {h}")
        server_counts = counts()
    finally:
        srv.close()
    want = {"vqt": ML_HOPS, "peaks": 2 * ML_HOPS, "agc": 0}
    check(server_counts == want, f"ML server: launches {server_counts}, expected {want}")
    server_med = float(np.median(server_ms))
    print(f"ML server hop: {ML_HOPS} hops at B={B} (StreamServer TRAIN_VQT_PARAMETERS path=pallas fast=True ml_model), "
          f"hop ms median {server_med:.3f} (min {min(server_ms):.3f}, max {max(server_ms):.3f}); launches {server_counts}")
    del sig, blocks

    # step_multi(4) with the ML stage against 4 step()s, at B=EQ_B
    eq_sig = synthetic_audio(torch, EQ_B, int(sr) + 4 * hop, sr, gen).cpu().numpy()
    servers = [StreamServer(EQ_B, tp, path="pallas", fast=True, ml_model=ml_model, ml_params=loaded,
                            buffer_seconds=2.0, device="cuda") for _ in range(2)]
    try:
        for s in servers:
            s.push_batch(eq_sig[:, : int(sr)])
            s.step(dt=dt)
        singles, multi = servers
        for i in range(4):
            blk = eq_sig[:, int(sr) + i * hop : int(sr) + (i + 1) * hop]
            singles.push_batch(blk)
            multi.push_batch(blk)
            last_single, _ = singles.step(dt=dt)
        last_multi, _ = multi.step_multi(4)
        check(torch.equal(last_multi.ml_midi, last_single.ml_midi)
              and outputs_equal(torch, last_multi.analysis, last_single.analysis)
              and torch.equal(multi.ml_state.history, singles.ml_state.history)
              and torch.equal(multi._window, singles._window), "ML server: step_multi(4) differs from 4 step()s")
    finally:
        for s in servers:
            s.close()
    print(f"ML server at B={EQ_B}: step_multi(4) == 4 step()s (torch.equal: ml_midi, analysis outputs, history, window)")

    numbers.update(
        hop_ms=med, hop_min_ms=min(ml_ms), hop_max_ms=max(ml_ms), bare_hop_ms=bare_med, bare_hop_min_ms=min(bare_ms),
        bare_hop_max_ms=max(bare_ms), peak_gib=peak_gib, stage_alone=alone, card_vs_cpu_out_err=out_err,
        card_vs_cpu_logit_err=logit_err, card_vs_cpu_logit_max=logit_max, server_hop_ms=server_med,
        server_hop_min_ms=min(server_ms), server_hop_max_ms=max(server_ms),
    )
    path_counts = {k: pipe_counts[k] + server_counts[k] for k in pipe_counts}
    return path_counts, numbers


def composite_cases(torch, gen) -> dict:
    """Phase 8 (a): the composite kernel against composite_patches_plain on
    the card, torch.equal, in every case the render can give it; its time,
    the plain version's and the kernel's time on the card alone at the main
    path's shapes (64 streams of 640x360, 64 patches of 96 x 96)."""
    from pitchvis_tpu_torch.ops import composite as comp

    dev = "cuda"

    def inputs(b, k, p, hp, wp, origins, offset=0):
        def rand(*shape):
            # offset > 0: a view whose base lies `offset` floats into its buffer
            flat = torch.rand(offset + int(np.prod(shape)), generator=gen, device=dev)
            return flat[offset:].view(*shape)

        img, rgb, a = rand(b, hp, wp, 3), rand(b, k, p, p, 3), rand(b, k, p, p)
        if origins == "overlapping":  # every patch over the raster's middle, all visible
            si = (wp - p) // 2 + torch.randint(-p // 3, p // 3 + 1, (b, k), generator=gen, device=dev)
            sj = (hp - p) // 2 + torch.randint(-p // 3, p // 3 + 1, (b, k), generator=gen, device=dev)
        else:  # both edges
            si = torch.randint(0, 2, (b, k), generator=gen, device=dev) * (wp - p)
            sj = torch.randint(0, 2, (b, k), generator=gen, device=dev) * (hp - p)
        return img, rgb, a, si.to(torch.int32), sj.to(torch.int32)

    cases = {
        "full size: B=64, K=64, P=96, 640x360, all patches visible and overlapping":
            inputs(64, 64, 96, 360, 640, "overlapping"),
        "B=1, K=1": inputs(1, 1, 96, 360, 640, "overlapping"),
        "the golden's 160x96 padded raster, K=16, P=48": inputs(3, 16, 48, 96, 160, "overlapping"),
        "origins at both edges": inputs(5, 24, 40, 90, 130, "edges"),
        "base off 16-byte alignment": inputs(4, 16, 32, 72, 100, "overlapping", offset=1),
        "no patches (K=0)": inputs(2, 0, 8, 24, 40, "edges"),
        "the empty batch": inputs(0, 8, 16, 24, 40, "edges"),
    }
    img, rgb, a, si, sj = inputs(6, 16, 11, 96, 160, "overlapping")
    cases["the disks' stride-0 colours"] = (img, rgb[:, :, :1, :1].expand(-1, -1, 11, 11, -1), a, si, sj)
    for label, (img, rgb, a, si, sj) in cases.items():
        before = comp.launches
        got = comp.composite_patches(img, rgb, a, si, sj)
        want = comp.composite_patches_plain(img, rgb, a, si, sj)
        torch.cuda.synchronize()
        check(comp.launches == before + (1 if img.shape[0] else 0), f"composite, {label}: the kernel did not launch")
        check(got.shape == want.shape and torch.equal(got, want),
              f"composite kernel differs from its plain version: {label}")
    print(f"composite kernel equal (torch.equal) to composite_patches_plain on the card in {len(cases)} cases: "
          + "; ".join(cases))

    img, rgb, a, si, sj = cases["full size: B=64, K=64, P=96, 640x360, all patches visible and overlapping"]
    b, k, p = a.shape[0], a.shape[1], a.shape[2]
    ms = time_ms(torch, lambda: comp.composite_patches(img, rgb, a, si, sj))
    plain_ms = time_ms(torch, lambda: comp.composite_patches_plain(img, rgb, a, si, sj), reps=3, inner=2)
    _, card_ms = device_trace(torch, lambda: comp.composite_patches(img, rgb, a, si, sj), kernel="composite", inner=20)
    # read the raster, each patch's colour and alpha and the origins once,
    # write the raster once; 10 operations a patch pixel (1 - a, then two
    # products and a sum a channel) at the FFMA rate
    bytes_moved = 2 * img.numel() * 4 + (rgb.numel() + a.numel()) * 4 + 2 * b * k * 4
    b_ms, b_by = bound_ms(bytes_moved, 10 * b * k * p * p, F32_FLOPS)
    print(f"composite at B={b}, K={k}, P={p}, 360x640: {ms:.4f} ms a call, {card_ms:.4f} on the card alone, plain "
          f"{plain_ms:.4f}; bound {b_ms:.4f} ms ({b_by}: {bytes_moved / 1e6:.1f} MB); no single PyTorch call "
          f"computes the same function (library none)")
    return dict(cases=list(cases), max_abs_err=0.0, ms=ms, card_ms=card_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=bytes_moved)


def render_phase(torch, params, counts, reset_counts, gen) -> tuple[dict, dict, dict]:
    """Phase 8: the composite kernel against its plain version; the display
    path, StreamingPipeline(2048, path="pallas", fast=True, with_viewer=True)
    hops each followed by render_streams of streams 0-63 at RenderConfig()
    (640x360, K=64, P=96, bloom, net, bass and names): frames/s, ms a batch,
    the split by stage, launches, device and enqueue ms, peak memory; the same
    on a synthetic scene with every stream's K full; the render golden on the
    card; card against CPU on 4 streams with and without the debug overlay,
    and under a caller's TF32 setting; one render under
    set_sync_debug_mode("error"). Returns (the path's pipeline launch counts,
    the composite's kernel entry, the phase's numbers)."""
    import dataclasses

    from pitchvis_tpu_torch import RenderConfig, StreamingPipeline, render_batch, render_frame, render_streams
    from pitchvis_tpu_torch.io.golden import render_scene_inputs
    from pitchvis_tpu_torch.models import render as render_mod
    from pitchvis_tpu_torch.models.viewer import BallOutputs, CalmnessGraphState, SpectrogramState, bin_to_spiral
    from pitchvis_tpu_torch.ops import composite as comp

    numbers = {}
    kernel = composite_cases(torch, gen)
    torch.cuda.empty_cache()

    cfg = RenderConfig()
    rng = params.range
    n = params.n_buckets
    sr = params.sr
    hop = int(sr / 60.0)
    dt = hop / sr
    warm = 8  # hops before the timed ones (the last two rendered): the window fills
    watched = range(RENDER_STREAMS)
    audio = synthetic_audio(torch, B, (warm + RENDER_BATCHES + 2) * hop, sr, gen)

    def chunk(h):
        return audio[:, h * hop : (h + 1) * hop]

    def rows(obj, sel):
        return type(obj)(**{f.name: getattr(obj, f.name)[sel] for f in dataclasses.fields(obj)})

    def frames_ok(frames, n_frames, what):
        check(frames.dtype == torch.uint8 and tuple(frames.shape) == (n_frames, cfg.height, cfg.width, 3),
              f"{what}: frames {frames.dtype} {tuple(frames.shape)}")
        check(float(frames.float().std()) > 5.0, f"{what}: the frames are flat")

    def host_ms(fn, reps=5):
        """(enqueue ms, wall ms), medians of ``reps`` calls by the host clock."""
        enqueue, wall = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        return float(np.median(enqueue)), float(np.median(wall))

    def split(balls, bass, sc, t, reps=3):
        """ms by stage of one batch (CUDA events, median of ``reps``); a
        measured side path, not counted."""
        st = render_mod.make_scene(cfg, rng, "cuda")
        labels = ("under (background, bass)", "fragment", "composite", "text", "bloom (crop, bloom)",
                  "tonemap (tonemap, encode)")
        times = {k: [] for k in labels}
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            img = render_mod.layers_under(cfg, rng, st, bass, None)
            ev[1].record()
            rgb, a, si, sj = render_mod.ball_patches(cfg, balls, t)
            ev[2].record()
            img = comp.composite_patches(img, rgb, a, si, sj)
            ev[3].record()
            img = render_mod.layers_over(cfg, rng, st, img, None)
            ev[4].record()
            img = render_mod.post(cfg, img, sc)
            ev[5].record()
            render_mod.encode(cfg, img, None)
            ev[6].record()
            torch.cuda.synchronize()
            for i, key in enumerate(labels):
                times[key].append(ev[i].elapsed_time(ev[i + 1]))
        return {k: float(np.median(v)) for k, v in times.items()}

    def measure(label, render_once, balls, bass, sc, t, n_frames):
        """The batch's launches and device ms (profiler, the fullest of three
        traces), its enqueue and wall ms, the split and the peak memory."""
        launches, device_ms = max(device_trace(torch, render_once) for _ in range(3))
        enqueue, wall = host_ms(render_once)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        render_once()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        stages = split(balls, bass, sc, t)
        out = dict(launches=launches, device_ms=device_ms, enqueue_ms=enqueue, wall_ms=wall, split_ms=stages,
                   peak_gib=peak / 2**30, render_peak_gib=(peak - base) / 2**30)
        print(f"{label}: one batch of {n_frames} frames {launches} device ops, {device_ms:.3f} ms on the card, "
              f"{enqueue:.3f} ms to enqueue, {wall:.3f} ms to its end; split (CUDA events) {json.dumps(stages)}; "
              f"peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above what was allocated)")
        return out

    # (b) the path: each hop of the pipeline, then the watched streams'
    # frames; a debug display's graph and spectrogram of streams 0-3 follow
    # the hops (for (d))
    dbg_rows = slice(0, CARD_CPU_STREAMS)
    graph = CalmnessGraphState.init(CARD_CPU_STREAMS, device="cuda")
    spectrogram = SpectrogramState.init(CARD_CPU_STREAMS, 200, n, device="cuda")
    pipe = StreamingPipeline(B, params, path="pallas", fast=True, with_viewer=True, device="cuda")
    t_sec = 0.0

    def hop_and_debug(h):
        nonlocal graph, spectrogram
        out = pipe.step(chunk(h), dt)
        graph = graph.push(out.analysis.scene_calmness[dbg_rows])
        spectrogram = spectrogram.push(out.viewer.spectrogram_row[dbg_rows])
        return out

    for h in range(warm):
        out = hop_and_debug(h)
        if h >= warm - 2:
            frames = render_streams(cfg, rng, out.viewer, out.analysis.scene_calmness, t_sec, streams=watched)
    # the atlas is committed beside the package: without it the scene would
    # render no pitch names, with only a warning
    check(render_mod.make_scene(cfg, rng, "cuda").text_premul is not None,
          "the scene has no pitch-name layer (pitchvis_tpu_torch/models/assets/pitch_name_atlas.npz missing)")
    torch.cuda.synchronize()
    reset_counts()
    comp.launches = 0
    batch_ms = []
    for h in range(warm, warm + RENDER_BATCHES):
        out = hop_and_debug(h)
        t_sec += 1.0 / 60.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = render_streams(cfg, rng, out.viewer, out.analysis.scene_calmness, t_sec, streams=watched)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t) * 1e3)
    path_counts = counts()
    path_composite = comp.launches
    want = {"vqt": RENDER_BATCHES, "peaks": 2 * RENDER_BATCHES, "agc": RENDER_BATCHES}
    check(path_counts == want, f"render path: pipeline launches {path_counts}, expected {want}")
    check(path_composite == RENDER_BATCHES,
          f"render path: {path_composite} composite launches for {RENDER_BATCHES} batches")
    frames_ok(frames, RENDER_STREAMS, "render path")
    visible = out.viewer.balls.visible[: RENDER_STREAMS].sum(dim=1)
    check(int((visible > 0).sum()) > RENDER_STREAMS // 2, "render path: most watched streams show no ball")
    med = float(np.median(batch_ms))
    print(f"render path: {RENDER_BATCHES} batches of render_streams(RenderConfig(), streams 0-{RENDER_STREAMS - 1}) "
          f"each after a StreamingPipeline(B={B}, with_viewer) hop: ms a batch median {med:.3f} "
          f"(min {min(batch_ms):.3f}, "
          f"max {max(batch_ms):.3f}), {RENDER_STREAMS * 1e3 / med:.1f} frames/s; {float(visible.float().mean()):.1f} "
          f"visible balls a stream (K={cfg.max_balls}); launches: pipeline {path_counts}, composite {path_composite}")
    viewer, sc = out.viewer, out.analysis.scene_calmness
    balls, bass = rows(viewer.balls, slice(0, RENDER_STREAMS)), rows(viewer.bass, slice(0, RENDER_STREAMS))
    sc64 = sc[:RENDER_STREAMS]
    path = measure("render path", lambda: render_streams(cfg, rng, viewer, sc, t_sec, streams=watched),
                   balls, bass, sc64, t_sec, RENDER_STREAMS)
    # the composite kernel on this path's own patches
    rgb, a, si, sj = render_mod.ball_patches(cfg, balls, t_sec)
    img = render_mod.layers_under(cfg, rng, render_mod.make_scene(cfg, rng, "cuda"), bass, None)
    check(torch.equal(comp.composite_patches(img, rgb, a, si, sj), comp.composite_patches_plain(img, rgb, a, si, sj)),
          "composite kernel differs from its plain version on the render path's patches")
    numbers["path"] = dict(batch_ms=med, batch_min_ms=min(batch_ms), batch_max_ms=max(batch_ms),
                           frames_per_s=RENDER_STREAMS * 1e3 / med, batches=RENDER_BATCHES, streams=RENDER_STREAMS,
                           visible_balls=float(visible.float().mean()), **path)
    del rgb, a, si, sj, img

    # the same on a synthetic scene: some 100 visible balls a stream, so
    # every stream's K is full
    g = gen
    shape = (RENDER_STREAMS, n)
    vis = torch.rand(shape, generator=g, device="cuda") < 100.0 / n
    centers = torch.arange(n, device="cuda", dtype=torch.float32) + torch.rand(shape, generator=g, device="cuda") - 0.5
    x, y = bin_to_spiral(rng.buckets_per_octave, centers)
    z = -12.6 * torch.rand(shape, generator=g, device="cuda")
    full = BallOutputs(
        position=torch.stack([x, y, z], dim=-1),
        rgba=torch.cat([torch.rand((*shape, 3), generator=g, device="cuda"),
                        0.7 + 0.3 * torch.rand((*shape, 1), generator=g, device="cuda")], dim=-1),
        scale=0.02 + 0.06 * torch.rand(shape, generator=g, device="cuda"),
        visible=vis,
        calmness=torch.rand(shape, generator=g, device="cuda"),
        pitch_accuracy=0.5 + 0.5 * torch.rand(shape, generator=g, device="cuda"),
        pitch_deviation=0.8 * torch.rand(shape, generator=g, device="cuda") - 0.4,
    )
    check(int(vis.sum(dim=1).min()) >= cfg.max_balls, "synthetic scene: a stream with fewer than K visible balls")
    full_bass = bass
    full_sc = torch.rand(RENDER_STREAMS, generator=g, device="cuda")
    full_ms = []
    for i in range(RENDER_BATCHES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = render_batch(cfg, rng, full, full_bass, full_sc, t_sec + i / 60.0)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t) * 1e3)
    frames_ok(frames, RENDER_STREAMS, "synthetic scene")
    full_med = float(np.median(full_ms[1:]))
    print(f"synthetic scene (K={cfg.max_balls} full in every stream, {float(vis.sum(dim=1).float().mean()):.1f} "
          f"visible balls a stream): render_batch ms median {full_med:.3f} (min {min(full_ms[1:]):.3f}, "
          f"max {max(full_ms[1:]):.3f}), "
          f"{RENDER_STREAMS * 1e3 / full_med:.1f} frames/s")
    numbers["full_k"] = dict(batch_ms=full_med, batch_min_ms=min(full_ms[1:]), batch_max_ms=max(full_ms[1:]),
                             frames_per_s=RENDER_STREAMS * 1e3 / full_med, **measure(
                                 "synthetic scene", lambda: render_batch(cfg, rng, full, full_bass, full_sc, t_sec),
                                 full, full_bass, full_sc, t_sec, RENDER_STREAMS))
    del full, frames
    torch.cuda.empty_cache()

    # (c) tests/golden/render_golden.npz replayed on the card, through the
    # port's own scene (io/golden.py)
    g_cfg, g_rng, g_balls, g_bass, g_debug, g_sc, g_t = render_scene_inputs(device="cuda")
    with np.load(os.path.join(ROOT, "tests", "golden", "render_golden.npz")) as zf:
        golden = {k: zf[k] for k in ("plain", "overlay")}
    numbers["golden"] = {}
    for key, debug in (("plain", None), ("overlay", g_debug)):
        got = render_frame(g_cfg, g_rng, g_balls, g_bass, g_sc, g_t, debug=debug).cpu().numpy().astype(int)
        d = np.abs(got - golden[key].astype(int))
        check(got.shape == golden[key].shape and d.max() <= 1,
              f"render golden {key} on the card: a value moved by {d.max()}")
        numbers["golden"][key] = dict(max_step=int(d.max()), values_moved=int((d > 0).sum()), values=int(d.size))
    print(f"render golden on the card (160x90, f32): {json.dumps(numbers['golden'])} (tol one 8-bit step)")

    # (d) the card against the CPU: render_batch of streams 0-3 at 640x360,
    # plain and with the debug overlay, the inputs moved to the CPU
    def to_cpu(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)})

    a4 = rows(out.analysis, dbg_rows)
    debug4 = render_mod.DebugInputs(
        x_vqt_smoothed=a4.x_vqt_smoothed, peaks=a4.peaks, peak_center=a4.peak_center, peak_size=a4.peak_size,
        calmness=a4.calmness, graph_values=graph.trace()[0], spectrogram=spectrogram.image,
        spectrogram_write_index=spectrogram.write_index, chroma=viewer.chroma[dbg_rows],
    )
    balls4, bass4, sc4 = rows(viewer.balls, dbg_rows), rows(viewer.bass, dbg_rows), sc[dbg_rows]
    numbers["card_vs_cpu"] = {}
    card_frames = {}
    for key, debug in (("plain", None), ("overlay", debug4)):
        card = render_batch(cfg, rng, balls4, bass4, sc4, t_sec, debug=debug)
        card_frames[key] = card
        t = time.perf_counter()
        host = render_batch(cfg, rng, to_cpu(balls4), to_cpu(bass4), sc4.cpu(), t_sec,
                            debug=None if debug is None else to_cpu(debug))
        cpu_s = time.perf_counter() - t
        d = (card.cpu().to(torch.int32) - host.to(torch.int32)).abs()
        check(int(d.max()) <= 1, f"render {key}, card vs CPU: a value moved by {int(d.max())}")
        numbers["card_vs_cpu"][key] = dict(max_step=int(d.max()), share_moved=float((d > 0).float().mean()),
                                           cpu_s=cpu_s)
    # a caller that allows TF32: the bloom's products stay IEEE float32
    # (frames torch.equal); and what TF32 there would do to the frames
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        check(torch.equal(render_batch(cfg, rng, balls4, bass4, sc4, t_sec), card_frames["plain"]),
              "render under a caller's allow_tf32=True differs from the default")
        guard = render_mod._full_f32_matmul
        render_mod._full_f32_matmul = lambda device: contextlib.nullcontext()
        try:
            tf32 = render_batch(cfg, rng, balls4, bass4, sc4, t_sec)
        finally:
            render_mod._full_f32_matmul = guard
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d = (tf32.to(torch.int32) - card_frames["plain"].to(torch.int32)).abs()
    numbers["tf32_bloom"] = dict(max_step=int(d.max()), share_moved=float((d > 0).float().mean()))
    print(f"render on the card vs on the CPU ({CARD_CPU_STREAMS} streams, 640x360; tol one step): "
          f"{json.dumps(numbers['card_vs_cpu'])}; under a caller's allow_tf32=True the frames are torch.equal to the "
          f"default (the bloom's products run IEEE float32); with TF32 in the bloom they would move "
          f"{json.dumps(numbers['tf32_bloom'])}")

    # (e) one render after warm-up under set_sync_debug_mode("error")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render_streams(cfg, rng, viewer, sc, t_sec, streams=watched)
        render_batch(cfg, rng, balls4, bass4, sc4, t_sec, debug=debug4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f'render_streams of {RENDER_STREAMS} streams and a debug render_batch under set_sync_debug_mode("error"): '
          f"no host synchronisation")
    del pipe, out, viewer, audio
    torch.cuda.empty_cache()

    entry = dict(
        name="composite", route="cuda", source="pitchvis_tpu_torch/csrc/composite.cu",
        replaces="pitchvis_tpu/models/render.py:999", also_replaces="pitchvis_tpu/models/render.py:829",
        max_abs_err=kernel["max_abs_err"], ms=kernel["ms"], card_ms=kernel["card_ms"], plain_ms=kernel["plain_ms"],
        bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"], library_ms=None,
        launches=path_composite, launches_by_path={"render": path_composite},
    )
    numbers["composite"] = kernel
    return path_counts, entry, numbers


DATASET_FILES = 8  # phase 9: 60-second corpus files of the device route
DATASET_SECONDS = 60.0
HOST_FILES = 2  # phase 9 (c): files of the host route, on the card and on the CPU
CARD_CPU_SECONDS = 3.0  # phase 9 (e): seconds of one file, device route on the card and on the CPU
# phase 9 tolerances. The AGC's signal mode equals its plain version and the
# chunk mode bit for bit. The device route against the host route: the
# criteria of tests/test_device_dataset.py::TestDeviceAnnotate (the same key
# sets, labels on the same side of 0.5, strong bins within 3 dB). Card
# against CPU, those tests/test_torch_dataset.py states against the JAX
# package: the render within 1e-6 of the signal's peak, label gains rtol
# 1e-5, spectra within 1e-2 dB where they stand 10 dB over the floor.
DATASET_RENDER_REL = 1e-6
DATASET_GAIN_RTOL = 1e-5
DATASET_DB_TOL = 1e-2
# the AGC chain: six dependent float32 operations a sample (fmul, fmul, fma,
# fma, max, fmul) of some four cycles each on the SM
AGC_CHAIN_OPS = 6
AGC_OP_CYCLES = 4


def agc_signal_cases(torch, gen, signal, batch, own) -> dict:
    """Phase 9 (a): the AGC kernel's signal mode (ops/agc.py::agc_signal)
    against agc_signal_plain on the card, torch.equal, gains included, and
    over the whole 60-second file ``signal`` ((1, N) on the card) also
    against the chunk mode called chunk by chunk with the gain carried.
    Over that file the plain version would take 1.33 M eager steps; it is
    run there as its own per-chunk calls (agc_chunk_plain) on all chunks at
    once, each from the gain the kernel reached before it: every chunk's
    output and end gain equal to the kernel's is, chunk by chunk from the
    first (gain 1), the sequential plain version's result. ``batch``: the
    corpus's rendered files as the device route batches them ((F, N_max),
    zero-padded; ``signal`` is its first row cut to its own ``own[0]``
    chunks), in one launch against each file alone, and 132 rows (the
    batch's rows over and over) against it.
    Its time for one file, the batch and B=132, its plain version's at 2 s,
    and its bound (bytes, and the chain's latency floor beside it)."""
    from pitchvis_tpu_torch.ops import agc as agc_mod
    from pitchvis_tpu_torch.train.device_dataset import TRAIN_AGC

    dev = "cuda"
    chunk = 1984
    p = TRAIN_AGC

    def run(x):
        before = agc_mod.signal_launches
        got = agc_mod.agc_signal(x, chunk, p)
        n_chunks = x.shape[1] // chunk
        launched = agc_mod.signal_launches - before
        check(launched == (1 if x.shape[0] and n_chunks else 0),
              f"agc_signal on {tuple(x.shape)}: {launched} launches")
        return got

    # (1) the whole file against the chunk mode, chunk by chunk, and the plain version per chunk
    out, gains = run(signal)
    n_chunks = signal.shape[1] // chunk
    g = torch.ones(1, device=dev)
    outs, carried = [], []
    for c in range(n_chunks):
        g, o = agc_mod.agc_chunk(g, signal[:, c * chunk : (c + 1) * chunk], p)
        outs.append(o)
        carried.append(g)
    same_chunk = bool(torch.equal(out, torch.cat(outs, 1))) and bool(torch.equal(gains, torch.stack(carried, 1)))
    starts = torch.cat([torch.ones(1, device=dev), gains[0, :-1]])
    g_p, o_p = agc_mod.agc_chunk_plain(starts, signal[0, : n_chunks * chunk].view(n_chunks, chunk), p)
    same_plain = bool(torch.equal(o_p.reshape(1, -1), out)) and bool(torch.equal(g_p, gains[0]))
    frozen = int(((signal[0, : n_chunks * chunk].view(n_chunks, chunk) ** 2).sum(1) < agc_mod.SILENCE_ENERGY).sum())
    print(f"agc signal mode on one {signal.shape[1] / 22050:.1f}-second corpus file ({n_chunks} chunks of {chunk}, "
          f"{frozen} frozen): equal to the chunk mode chunk by chunk: {same_chunk}; to the plain version: {same_plain}")
    check(same_chunk, "AGC signal mode differs from the chunk mode carried chunk by chunk")
    check(same_plain, "AGC signal mode differs from its plain version over the whole file")

    # the corpus batch in one launch: every row, its zero chunks included,
    # against the plain version per chunk as above (all rows' chunks in one
    # call); each row's own chunks as the file alone gives them, the zero
    # chunks after them frozen; 132 rows, the batch's rows over and over,
    # row by row as the batch
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    batch_out, batch_gains = run(batch)
    b_rows, c_all = batch_gains.shape
    starts = torch.cat([torch.ones((b_rows, 1), device=dev), batch_gains[:, :-1]], 1)
    g_p, o_p = agc_mod.agc_chunk_plain(starts.reshape(-1), batch[:, : c_all * chunk].reshape(-1, chunk), p)
    same_batch_plain = bool(torch.equal(o_p.reshape(b_rows, -1), batch_out))
    same_batch_plain &= bool(torch.equal(g_p.reshape(b_rows, c_all), batch_gains))
    check(same_batch_plain, "AGC signal mode differs from its plain version on a row of the corpus batch")
    same_rows = bool(torch.equal(batch_out[0, : out.shape[1]], out[0])) and bool(torch.equal(batch_gains[0, :n_chunks],
                                                                                             gains[0]))
    for i, c_own in enumerate(own):
        alone_out, alone_gains = run(batch[i : i + 1, : c_own * chunk])
        same_rows &= bool(torch.equal(batch_out[i, : c_own * chunk], alone_out[0]))
        same_rows &= bool(torch.equal(batch_gains[i, :c_own], alone_gains[0]))
        same_rows &= bool((batch_gains[i, c_own:] == batch_gains[i, c_own - 1]).all())
    check(same_rows, "AGC signal mode: a padded batch row differs from its file alone")
    wide = batch[torch.arange(n_sms, device=dev) % batch.shape[0]]
    wide_out, wide_gains = run(wide)
    same_wide = bool(torch.equal(wide_out, batch_out[torch.arange(n_sms, device=dev) % batch.shape[0]]))
    same_wide &= bool(torch.equal(wide_gains, batch_gains[torch.arange(n_sms, device=dev) % batch.shape[0]]))
    check(same_wide, f"AGC signal mode at B={n_sms} differs from the batch of {batch.shape[0]}")
    print(f"agc signal mode on the corpus batch ({batch.shape[0]} files zero-padded to {batch.shape[1]} samples, "
          f"{own} chunks of their own) in one launch: every row equal to the plain version chunk by chunk "
          f"({b_rows * c_all} chunks, the padding's included) and to its file alone, the padding frozen; at "
          f"B={n_sms} (its rows over and over) equal to it row by row")

    # (2) small cases against agc_signal_plain itself
    def audio(b, n, scale=0.3):
        return torch.randn((b, n), generator=gen, device=dev) * scale

    rows8 = audio(8, int(2 * 22050))
    silent = audio(3, 6 * chunk)
    silent[0, 2 * chunk : 4 * chunk] = 0.0
    silent[2, chunk : 2 * chunk] = 0.0
    edge = audio(2, 4 * chunk)
    for row, target in ((0, 0.99e-6), (1, 1.01e-6)):  # chunk 1 just under and just over the freeze
        seg = edge[row, chunk : 2 * chunk]
        edge[row, chunk : 2 * chunk] = seg * float(np.sqrt(target / float((seg.double() ** 2).sum())))
    base = audio(4, 3 * (5 * chunk + 7))
    unequal = audio(8, 6 * chunk)
    for row, n in enumerate((6 * chunk, 2 * chunk, 5 * chunk, chunk, 3 * chunk + 700, 6 * chunk, 4 * chunk, 0)):
        unequal[row, n:] = 0.0
    all_silent = audio(3, 3 * chunk)
    all_silent[1] = 0.0
    clamps = audio(2, 8 * chunk, 1e-3)  # the gain grows over quiet chunks, a loud one clamps it at k
    clamps[:, 5 * chunk : 6 * chunk] *= 2000.0
    cases = {
        "B=8 rows of 2 s (22 chunks and a ragged tail)": rows8,
        "rows with silent chunks in the middle": silent,
        "chunks of energy just under and just over 1e-6": edge,
        "C=1 and a ragged tail": audio(4, chunk + 100),
        "fewer samples than a chunk (C=0)": audio(2, chunk - 1),
        "a strided view (every third sample)": base[:, ::3][:, : 5 * chunk],
        "rows off 16-byte alignment (row stride 3 * (5 * chunk + 7))": base[1:, 3 : 3 + 5 * chunk],
        "the empty batch": audio(0, 3 * chunk),
        "B=8 rows of unequal lengths (6, 2, 5, 1, 3 and 700 samples, 6, 4 and 0 chunks), zero-padded":
            unequal,
        f"B={n_sms + 1} rows of 2 chunks, more rows than the card has SMs": audio(n_sms + 1, 2 * chunk),
        "an all-silent row": all_silent,
        "one chunk": audio(2, chunk),
        "quiet chunks, then a loud one that clamps the update at k": clamps,
    }
    plain_ms = None
    for label, x in cases.items():
        got_out, got_gains = run(x)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want_out, want_gains = agc_mod.agc_signal_plain(x, chunk, p)
        ev[1].record()
        torch.cuda.synchronize()
        if x is rows8:
            plain_ms = ev[0].elapsed_time(ev[1])
        check(got_out.shape == want_out.shape and got_gains.shape == want_gains.shape,
              f"agc signal mode, {label}: shapes {tuple(got_out.shape)}, {tuple(got_gains.shape)}")
        check(torch.equal(got_out, want_out) and torch.equal(got_gains, want_gains),
              f"AGC signal mode differs from agc_signal_plain: {label}")
    gains_edge = run(edge)[1]
    check(bool(gains_edge[0, 1] == gains_edge[0, 0]) and bool(gains_edge[1, 1] != gains_edge[1, 0]),
          "the chunk under 1e-6 must keep its gain, the one over it must not")
    check(bool((run(all_silent)[1][1] == 1.0).all()), "an all-silent row must keep the gain of 1")
    gains_clamped = run(clamps)[1]
    check(bool((gains_clamped[:, 5] < 0.01 * gains_clamped[:, 4]).all()), "the loud chunk must clamp the gain")
    print(f"agc signal mode equal (torch.equal, gains included) to agc_signal_plain on the card in {len(cases)} "
          f"cases: " + "; ".join(cases))

    n = signal.shape[1] // chunk * chunk
    ms = time_ms(torch, lambda: agc_mod.agc_signal(signal, chunk, p), reps=5, inner=3)
    # the kernel alone: CUDA events around one launch on an idle stream (a
    # launch takes microseconds of its some 20 ms; the profiler, which loses
    # a window's events now and then, is not needed for one kernel this long)
    card_ms = time_ms(torch, lambda: agc_mod.agc_signal(signal, chunk, p), reps=5, inner=1)
    batch_ms = time_ms(torch, lambda: agc_mod.agc_signal(batch, chunk, p), reps=5, inner=1)
    wide_ms = time_ms(torch, lambda: agc_mod.agc_signal(wide, chunk, p), reps=3, inner=1)
    rows8_ms = time_ms(torch, lambda: agc_mod.agc_signal(rows8, chunk, p), reps=5, inner=5)
    # each sample read once and written once, each chunk's gain written once;
    # seven float operations a sample at the FFMA rate
    bytes_moved = 8 * n + 4 * n_chunks
    b_ms, b_by = bound_ms(bytes_moved, 7.0 * n, F32_FLOPS)
    batch_chunks = sum(own)
    batch_b_ms, _ = bound_ms(8 * batch_chunks * chunk + 4 * batch_chunks, 7.0 * batch_chunks * chunk, F32_FLOPS)
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    chain_ms = n * AGC_CHAIN_OPS * AGC_OP_CYCLES / (clock_mhz * 1e3)
    batch_chain_ms = max(own) * chunk * AGC_CHAIN_OPS * AGC_OP_CYCLES / (clock_mhz * 1e3)
    print(f"agc signal mode, one file (B=1, {n} samples): {ms:.4f} ms a call (3 in a row), {card_ms:.4f} ms on the "
          f"card alone (one launch between CUDA events), "
          f"{card_ms * 1e6 / n:.2f} ns a sample; bound {b_ms:.5f} ms ({b_by}: {bytes_moved / 1e6:.2f} MB); the "
          f"chain's latency floor {chain_ms:.3f} ms ({AGC_CHAIN_OPS} dependent operations of {AGC_OP_CYCLES} cycles "
          f"a sample at {clock_mhz:.0f} MHz, {AGC_CHAIN_OPS * AGC_OP_CYCLES * 1e3 / clock_mhz:.2f} ns a sample); "
          f"B=8 rows of 2 s: kernel {rows8_ms:.4f} ms, plain {plain_ms:.1f} ms; "
          f"no single PyTorch call computes the same function (library none)")
    print(f"agc signal mode, the corpus batch in one launch (B={batch.shape[0]}, {batch_chunks} chunks of their own, "
          f"the longest {max(own)}): {batch_ms:.4f} ms on the card alone, {batch_ms / card_ms:.3f}x one file's; bound "
          f"{batch_b_ms:.5f} ms (bytes), the chain's floor {batch_chain_ms:.3f} ms (the longest row); B={n_sms} (its "
          f"rows over and over): {wide_ms:.4f} ms, {wide_ms / card_ms:.3f}x one file's")
    return dict(cases=["one 60-second corpus file against the chunk mode and the plain version",
                       f"the corpus batch of {batch.shape[0]} files against the plain version and each file alone, "
                       f"and at B={n_sms}"]
                + list(cases),
                max_abs_err=0.0, ms=ms, card_ms=card_ms, ns_per_sample=card_ms * 1e6 / n, plain_ms=plain_ms,
                plain_at="B=8 rows of 2 s", rows8_ms=rows8_ms, bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved,
                chain_floor_ms=chain_ms, sm_clock_mhz=clock_mhz, samples=n, chunks=n_chunks,
                batch_rows=batch.shape[0], batch_ms=batch_ms, batch_over_one=batch_ms / card_ms,
                batch_bound_ms=batch_b_ms, batch_chain_floor_ms=batch_chain_ms, wide_rows=n_sms, wide_ms=wide_ms)


def labels_close(a: dict, b: dict, rtol: float | None = None) -> bool:
    """Two label dicts: the same keys, each on the same side of 0.5, and
    within ``rtol`` of each other where given."""
    if set(a) != set(b) or any((a[k] > 0.5) != (b[k] > 0.5) for k in a):
        return False
    return rtol is None or all(abs(a[k] - b[k]) <= rtol * max(abs(a[k]), 1e-12) for k in a)


def dataset_phase(torch, counts, reset_counts) -> tuple[dict, dict]:
    """Phase 9: the training-data path at TRAIN_VQT_PARAMETERS (22050 Hz,
    n_fft 32768, 252 bins, chunks of 1984 samples) on the corpus's own
    60-second files. Returns (the agc_signal kernels entry, the phase's
    numbers)."""
    import shutil

    from pitchvis_tpu_torch.core.config import TRAIN_VQT_PARAMETERS as params
    from pitchvis_tpu_torch.ops import agc as agc_mod
    from pitchvis_tpu_torch.ops.vqt import Vqt
    from pitchvis_tpu_torch.synth.midi import load_midi
    from pitchvis_tpu_torch.train import dataset as ds
    from pitchvis_tpu_torch.train import device_dataset as dd
    from pitchvis_tpu_torch.train.corpus import build_midi_corpus, build_training_font, train_demo
    from pitchvis_tpu_torch.train.train import TrainConfig, make_model, make_optimizer, train_step, window_data

    work = os.path.join(ROOT, "build", "dataset_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    row = params.n_buckets + 128
    numbers = {}
    artifacts = os.path.join(ROOT, "artifacts")
    artifacts_before = sorted(os.listdir(artifacts)) if os.path.isdir(artifacts) else None

    t = time.perf_counter()
    font = os.path.join(work, "train_font.sf2")
    programs = build_training_font(font, seed=0)
    paths = build_midi_corpus(os.path.join(work, "midi"), DATASET_FILES, DATASET_SECONDS, seed=0, programs=programs)
    numbers["corpus_build_s"] = time.perf_counter() - t
    vqt = Vqt(params, device="cuda")
    chunk = ds._chunk_samples(vqt, int(params.sr))
    check(chunk == 1984, f"chunk {chunk} at TRAIN_VQT_PARAMETERS, expected 1984")
    midis = [load_midi(p) for p in paths]

    def render_inputs(midi, max_seconds=None):
        sched, n_samples = dd._render_inputs(midi, params, chunk, max_seconds)
        return sched, n_samples, dd._file_notes(sched, "cuda")

    # (a) the kernel's signal mode on the corpus's own signals, rendered into
    # one zero-padded batch as the device route renders them
    files = [render_inputs(midi) for midi in midis]
    own = [n_samples // chunk for _, n_samples, _ in files]
    batch = torch.zeros((len(files), max(own) * chunk), device="cuda")
    for b_row, (_, n_samples, notes) in zip(batch, files):
        dd._render_core(*notes, n_samples, params.sr, dd.DEFAULT_MASTER_GAIN, out=b_row[:n_samples])
    kernel = agc_signal_cases(torch, torch.Generator(device="cuda").manual_seed(SEED),
                              batch[:1, : own[0] * chunk], batch, own)
    del batch

    # (b) the device route over the corpus: the main path of this phase
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    agc_mod.signal_launches = 0
    t = time.perf_counter()
    data = dd.generate_dataset_device(paths, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    path_signal = agc_mod.signal_launches
    path_counts = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    frames = len(data) // row
    check(len(data) == frames * row and frames > 0 and bool(np.isfinite(data).all()),
          f"device route: {len(data)} floats, not finite rows of {row}")
    batches = -(-len(paths) // n_sms)
    check(path_signal == batches,
          f"device route: {path_signal} agc_signal launches for {len(paths)} files, not one a batch of at most one "
          f"row an SM ({batches})")
    rows = data.reshape(frames, row)
    check(set(np.unique(rows[:, params.n_buckets:])) <= {0.0, 1.0} and rows[:, params.n_buckets:].sum() > 0,
          "device route: targets not binary or all zero")
    # the same rows file by file (annotate_midi_device: one launch a file)
    one_by_one = np.concatenate([ds.generate_data_row(active, spec, params.n_buckets)
                                 for midi in midis for active, spec in dd.annotate_midi_device(midi, vqt, params)])
    check(np.array_equal(data, one_by_one), "device route: the batched rows differ from the file-by-file route's")
    # its split by stage, as the route runs it: each file's render into its
    # row of the batch, the batch's AGC (one launch) by CUDA events; each
    # file's windows + VQT (to the host) and labels by the host clock
    split = {"render": 0.0, "agc": 0.0, "windows_vqt": 0.0, "labels": 0.0}
    notes_total = sum(len(sched) for sched, _, _ in files)
    batch = torch.zeros((len(files), max(own) * chunk), device="cuda")
    for b_row, (_, n_samples, notes) in zip(batch, files):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        dd._render_core(*notes, n_samples, params.sr, dd.DEFAULT_MASTER_GAIN, out=b_row[:n_samples])
        ev[1].record()
        torch.cuda.synchronize()
        split["render"] += ev[0].elapsed_time(ev[1])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    processed, gains = agc_mod.agc_signal(batch, chunk, dd.TRAIN_AGC)
    ev[1].record()
    torch.cuda.synchronize()
    split["agc"] = ev[0].elapsed_time(ev[1])
    g_host = gains.cpu().numpy()
    for i, (sched, n_samples, _) in enumerate(files):
        caps = [c for c in range(1, own[i] + 1) if c % ds.STEP_SIZE_IN_CHUNKS == 0]
        t = time.perf_counter()
        windows = ds._slice_windows(processed[i, :n_samples], stride=ds.STEP_SIZE_IN_CHUNKS * chunk,
                                    n_caps=len(caps), n_fft=params.n_fft)
        ds._batched_specs(vqt, windows)
        split["windows_vqt"] += (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        for c in caps:
            dd.active_keys_at(sched, c * chunk / params.sr, float(g_host[i, c - 1]))
        split["labels"] += (time.perf_counter() - t) * 1e3
    del batch, processed, gains
    # render and AGC of the batch: its device ops and time (the fullest of
    # three traces) against its time to its end, then under sync-debug
    # "error": it must not wait for the card
    batch_notes = [notes for _, _, notes in files]
    batch_n = [n_samples for _, n_samples, _ in files]

    def render_agc():
        return dd._render_agc_rows(batch_notes, batch_n, sr=params.sr, chunk=chunk)

    traces = [device_trace(torch, render_agc, required=False) for _ in range(3)]
    batch_ops, batch_device_ms = max(traces, key=lambda t: t[0])
    batch_wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render_agc()
        torch.cuda.synchronize()
        batch_wall.append((time.perf_counter() - t) * 1e3)
    batch_wall_ms = float(np.median(batch_wall))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render_agc()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # a full batch as the route cuts it: one row an SM (the batch's files
    # over and over), its rows equal to the batch's; its peak device memory
    # over what was allocated before it
    check(n_sms * max(batch_n) <= dd.BATCH_SAMPLES, f"{n_sms} rows of {max(batch_n)} samples exceed a batch")
    ref_out, ref_gains = render_agc()
    wide_idx = [i % len(files) for i in range(n_sms)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    full_out, full_gains = dd._render_agc_rows([batch_notes[i] for i in wide_idx], [batch_n[i] for i in wide_idx],
                                               sr=params.sr, chunk=chunk)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    full_peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    wide_idx = torch.tensor(wide_idx, device="cuda")
    check(bool(torch.equal(full_out, ref_out[wide_idx])) and bool(torch.equal(full_gains, ref_gains[wide_idx])),
          f"render and AGC of {n_sms} rows differ from the batch of {len(files)}")
    del ref_out, ref_gains, full_out, full_gains
    print(f"device route, render and AGC of a full batch ({n_sms} rows, the batch's files over and over, "
          f"{n_sms * max(batch_n)} padded samples, at most {dd.BATCH_SAMPLES} a batch): equal to the batch's rows, "
          f"{full_s:.3f} s, peak device memory {full_peak_gib:.2f} GiB over what was allocated before it")
    device_route = dict(files=len(paths), seconds_per_file=DATASET_SECONDS, frames=frames, wall_s=wall,
                        frames_per_s=frames / wall, s_per_file=wall / len(paths), notes=notes_total,
                        split_ms=split, agc_signal_launches=path_signal, other_launches=path_counts,
                        peak_gib=peak_gib, batch_ops=batch_ops, batch_device_ms=batch_device_ms,
                        batch_wall_ms=batch_wall_ms, full_batch_rows=n_sms, full_batch_s=full_s,
                        full_batch_peak_gib=full_peak_gib)
    numbers["device_route"] = device_route
    print(f"device route (generate_dataset_device, {len(paths)} corpus files of {DATASET_SECONDS:.0f} s, "
          f"{notes_total} notes): {frames} frames in {wall:.3f} s, {frames / wall:.1f} frames/s, "
          f"{wall / len(paths):.3f} s a file; equal to the file-by-file route's rows; split (each file's render "
          f"and the batch's AGC by CUDA events; windows + VQT, labels by the host clock): "
          + json.dumps({k: round(v, 3) for k, v in split.items()})
          + f" ms; launches: agc_signal {path_signal} (one a batch of at most {n_sms} files), others {path_counts}; "
          f"peak device memory {peak_gib:.2f} GiB")
    busy = ("not measured (the profiler traced no device event in 9 tries)" if batch_device_ms is None else
            f"{batch_ops} device ops, {batch_device_ms:.3f} ms on the card (profiler), the card busy "
            f"{100 * batch_device_ms / batch_wall_ms:.1f}% of it")
    print(f"device route, render and AGC of the batch of {len(files)} files ({notes_total} notes): {batch_wall_ms:.3f} ms "
          f"to its end (host clock, median of 3); {busy}; the AGC runs on {len(files)} SMs of {n_sms}")
    print('device route: render and AGC of the batch under set_sync_debug_mode("error"): no host synchronisation')

    # (c) the host route: native synthesis with the training font, the VQT on the card, then on the CPU
    kw = dict(sound_font_path=font, n_workers=2)
    t = time.perf_counter()
    host_card = ds.generate_dataset(paths[:HOST_FILES], params, **kw)
    host_wall = time.perf_counter() - t
    host_cpu = ds.generate_dataset(paths[:HOST_FILES], params, device="cpu", **kw)
    hc, hp = host_card.reshape(-1, row), host_cpu.reshape(-1, row)
    check(hc.shape == hp.shape and len(hc) > 0, f"host route: {hc.shape} rows on the card, {hp.shape} on the CPU")
    check(np.array_equal(hc[:, params.n_buckets:], hp[:, params.n_buckets:]), "host route: targets differ card/CPU")
    strong = hp[:, : params.n_buckets] >= 10.0
    db_err = float(np.abs(hc[:, : params.n_buckets] - hp[:, : params.n_buckets])[strong].max())
    db_err_all = float(np.abs(hc[:, : params.n_buckets] - hp[:, : params.n_buckets]).max())
    check(db_err <= DATASET_DB_TOL, f"host route: spectra {db_err} dB apart card/CPU")
    numbers["host_route"] = dict(files=HOST_FILES, frames=len(hc), wall_s=host_wall, frames_per_s=len(hc) / host_wall,
                                 db_err_strong=db_err, db_err_all=db_err_all)
    print(f"host route (generate_dataset, {HOST_FILES} files, the training font, 2 workers): {len(hc)} frames in "
          f"{host_wall:.3f} s, {len(hc) / host_wall:.1f} frames/s; on the card vs on the CPU: targets equal, spectra "
          f"within {db_err:.2e} dB where >= 10 dB (tol {DATASET_DB_TOL}), {db_err_all:.2e} dB over all bins")

    # (d) device route against host route on one file without a font (both additive)
    vqt_cpu = Vqt(params, device="cpu")
    t = time.perf_counter()
    host = ds.annotate_midi(midis[0], vqt, params)
    host_s = time.perf_counter() - t
    dev_rows = dd.annotate_midi_device(midis[0], vqt, params)
    check(len(dev_rows) == len(host) > 0, f"device vs host route: {len(dev_rows)} rows against {len(host)}")
    worst = 0.0
    for (hk, hs), (dk, dsp) in zip(host, dev_rows):
        check(labels_close(hk, dk), f"device vs host route: labels {hk} against {dk}")
        sel = hs > 10.0
        if sel.any():
            worst = max(worst, float(np.abs(hs[sel] - dsp[sel]).max()))
    check(worst < 3.0, f"device vs host route: strong bins {worst} dB apart")
    numbers["device_vs_host"] = dict(rows=len(host), strong_db_max=worst, host_additive_s=host_s)
    print(f"device route vs host route on one {DATASET_SECONDS:.0f}-second file, additive synthesis: {len(host)} rows, "
          f"the same key sets, labels on the same side of 0.5, strong bins within {worst:.3f} dB (tol 3); the host "
          f"route took {host_s:.2f} s")

    # (e) the device route on the card against the CPU, on the first seconds of one file
    sched, n_samples, notes = render_inputs(midis[0], CARD_CPU_SECONDS)
    sig_card = dd._render_core(*notes, n_samples, params.sr, dd.DEFAULT_MASTER_GAIN).cpu()
    notes_cpu = [x.cpu() for x in notes]
    sig_cpu = dd._render_core(*notes_cpu, n_samples, params.sr, dd.DEFAULT_MASTER_GAIN)
    render_rel = float((sig_card - sig_cpu).abs().max() / sig_cpu.abs().max())
    check(render_rel <= DATASET_RENDER_REL, f"render card/CPU: {render_rel} of the peak")
    card = dd.annotate_midi_device(midis[0], vqt, params, max_seconds=CARD_CPU_SECONDS)
    cpu = dd.annotate_midi_device(midis[0], vqt_cpu, params, max_seconds=CARD_CPU_SECONDS)
    check(len(card) == len(cpu) > 0, f"device route card/CPU: {len(card)} rows against {len(cpu)}")
    db = 0.0
    for (ck, cs), (pk, ps) in zip(card, cpu):
        check(labels_close(ck, pk, DATASET_GAIN_RTOL), f"device route card/CPU: labels {ck} against {pk}")
        sel = ps >= 10.0
        if sel.any():
            db = max(db, float(np.abs(cs[sel] - ps[sel]).max()))
    check(db <= DATASET_DB_TOL, f"device route card/CPU: spectra {db} dB apart")
    numbers["card_vs_cpu"] = dict(seconds=CARD_CPU_SECONDS, rows=len(card), render_rel=render_rel, db_err=db)
    print(f"device route on the card vs on the CPU, first {CARD_CPU_SECONDS:.0f} s of one file: render within "
          f"{render_rel:.2e} of its peak (tol {DATASET_RENDER_REL}), {len(card)} rows, labels equal within rtol "
          f"{DATASET_GAIN_RTOL}, spectra within {db:.2e} dB where >= 10 dB (tol {DATASET_DB_TOL})")

    # (f) train_demo end to end in a directory of its own
    demo_dir = os.path.join(work, "demo")
    t = time.perf_counter()
    report = train_demo(out_dir=demo_dir, n_files=DATASET_FILES, seconds_per_file=DATASET_SECONDS, epochs=1,
                        metrics_copy=None)
    demo_s = time.perf_counter() - t
    losses = report["metrics"]["epoch_loss"]
    check(report["n_frames"] > 0 and len(losses) == 1 and bool(np.isfinite(losses[0])),
          f"train_demo: {report['n_frames']} frames, losses {losses}")
    check(os.path.isdir(os.path.join(demo_dir, "ckpt")) and os.listdir(os.path.join(demo_dir, "ckpt")),
          "train_demo wrote no checkpoint")
    after = sorted(os.listdir(artifacts)) if os.path.isdir(artifacts) else None
    check(after == artifacts_before, "train_demo wrote under artifacts/")
    # the train step on the corpus's own rows
    cfg = TrainConfig()
    x, y = window_data(np.load(os.path.join(demo_dir, "data.npy")), cfg)
    b = min(cfg.batch_size, len(x))
    xt, yt = torch.from_numpy(x[:b]).cuda(), torch.from_numpy(y[:b]).cuda()
    model = make_model(cfg, device="cuda")
    model.train()
    optimizer, scheduler = make_optimizer(cfg, model)
    tgen = torch.Generator(device="cuda").manual_seed(SEED)
    step_ms, step_losses = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_losses.append(float(train_step(model, optimizer, xt, yt, scheduler, tgen)))
        step_ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(step_losses)), f"train step on the corpus: losses {step_losses}")
    numbers["train_demo"] = dict(s=demo_s, frames=report["n_frames"], epoch_loss=losses[0],
                                 f1_micro=report["metrics"]["f1_micro"], wall_seconds=report["wall_seconds"],
                                 step_ms=float(np.median(step_ms[1:])), batch=b)
    print(f"train_demo ({DATASET_FILES} files of {DATASET_SECONDS:.0f} s, 1 epoch, in {demo_dir}): "
          f"{report['n_frames']} frames, loss {losses[0]:.4f}, micro-F1 {report['metrics']['f1_micro']:.3f}, "
          f"{demo_s:.1f} s ({json.dumps(report['wall_seconds'])}); train step on its rows at batch {b}: "
          f"{numbers['train_demo']['step_ms']:.3f} ms (median of 5 after one); nothing written under artifacts/")
    del model, optimizer, xt, yt
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    numbers["agc_signal"] = kernel
    entry = dict(
        name="agc_signal", route="cuda", source="pitchvis_tpu_torch/csrc/agc.cu",
        replaces="pitchvis_tpu/train/device_dataset.py:226", also_replaces="pitchvis_tpu/train/device_dataset.py:283",
        max_abs_err=kernel["max_abs_err"], ms=kernel["ms"], card_ms=kernel["card_ms"], plain_ms=kernel["plain_ms"],
        plain_at=kernel["plain_at"], bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
        chain_floor_ms=kernel["chain_floor_ms"], batch_rows=kernel["batch_rows"], batch_ms=kernel["batch_ms"],
        wide_rows=kernel["wide_rows"], wide_ms=kernel["wide_ms"], library_ms=None,
        launches=path_signal, launches_by_path={"dataset": path_signal},
    )
    return entry, numbers


CLI_SECONDS = 60.0  # phase 10 (a): the 44100 Hz WAV file the CLI reads
CLI_CARD_CPU_SECONDS = 3.0  # phase 10 (b): its first seconds, on the card and on the CPU
LIVE_SECONDS = 3.0  # phase 10 (c): f32 tone at 48000 Hz on the live CLI's stdin
FREQ_FRAMES = 8  # phase 10 (e): frames held against the oracle, the time path and the CPU
# the chain budget of tests/test_torch_outputs.py::_check_chain: peak flips
# in at most 2e-4 of the bins, LED values within 4 where no peak flips
CHAIN_FLIP_SHARE = 2e-4
CHAIN_LED_STEPS = 4
CHAIN_CALM_TOL = 0.02
# the bf16 freq path on the card against itself on the CPU: the tolerance
# tests/test_torch_vqt_freq.py holds it to against the JAX package (power
# rtol 1e-3 plus 1e-6 of the frame's peak power)
FREQ_BF16_RTOL = 1e-3


@contextlib.contextmanager
def plain_calls():
    """Counts calls of the kernels' plain versions while the block runs (a
    CUDA tensor must never reach one): yields a dict name -> calls."""
    from pitchvis_tpu_torch.ops import agc, composite, peaks_pallas, vqt_pallas
    from pitchvis_tpu_torch.stream import ring

    targets = [(vqt_pallas, "vqt_power_pallas_plain"), (peaks_pallas, "find_peaks_masks_plain"),
               (peaks_pallas, "local_maxima_and_prominences_plain"), (agc, "agc_chunk_plain"),
               (agc, "agc_signal_plain"), (ring, "ring_push_plain"), (composite, "composite_patches_plain")]
    calls = {name: 0 for _, name in targets}
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_cli(demo, argv) -> tuple[list, str, float]:
    """demo.main(argv) in this process with its stdout and stderr captured:
    (stdout lines, stderr, wall seconds). Fails the run on a non-zero
    return."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = demo.main(argv)
    wall = time.perf_counter() - t
    check(rc == 0, f"demo.main({argv}) returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), err.getvalue(), wall


def cli_subprocess(args, stdin: bytes) -> tuple[list, str, float]:
    """``python -m pitchvis_tpu_torch.demo args`` from the checkout's root,
    ``stdin`` on its standard input; (stdout lines, stderr, wall seconds).
    Fails the run on a non-zero exit; the process has ended on return."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pitchvis_tpu_torch.demo", *args], input=stdin,
                          capture_output=True, cwd=ROOT, env=env, timeout=300)
    wall = time.perf_counter() - t
    err = proc.stderr.decode()
    check(proc.returncode == 0, f"demo {' '.join(args)} exited {proc.returncode}: {err[-2000:]}")
    return proc.stdout.decode().splitlines(), err, wall


def led_frames(path: str, n: int) -> np.ndarray:
    """A pitchvis_serial byte stream -> (frames, n, 3) uint8, its framing
    checked."""
    data = np.fromfile(path, np.uint8)
    check(data.size % (3 + 3 * n) == 0, f"{path}: {data.size} bytes are no whole frames of {n} LEDs")
    frames = data.reshape(-1, 3 + 3 * n)
    check(bool((frames[:, 0] == 0xFF).all() and (frames[:, 1] == n // 256).all() and (frames[:, 2] == n % 256).all()
               and (frames[:, 3:] <= 0xFE).all()), f"{path}: the serial framing is broken")
    return frames[:, 3:].reshape(-1, n, 3)


def summary_notes(line: str) -> list:
    """The note names of an offline summary line (``... tune=...ct  A4+0ct(37.3dB), ...``)."""
    tail = line.split("ct  ", 1)[1]
    return [tok.split("(")[0] for tok in tail.split(", ")] if tail else []


def cli_phase(torch, counts, reset_counts, gen) -> tuple[dict, dict]:
    """Phase 10: the command line (pitchvis_tpu_torch/demo.py) on the card.
    (a) a 60-second 44100 Hz WAV, resampled on the card, through
    ``--path pallas --fast --led`` (the serial parameters, 180 bins) and
    ``--path pallas`` (f32, default parameters, 588 bins), the kernels'
    launches counted and their plain versions never called; (b) its first
    3 s with ``--device cpu`` against the card, at the chain budget; (c) the
    live CLI as a subprocess, ``--serve --input-sr 48000 --pipelined --led``
    and ``--serve --loop --hops-per-dispatch 4`` with 3 s of f32 tone on
    stdin; (d) ``--render`` of 1 s to a PNG directory at 640x360 with the
    debug overlay; (e) the ``freq`` VQT path at B=2048 against the oracle,
    the time path and the CPU, with each path's time. Writes under
    build/cli_phase/ and deletes it. Returns (the CLI's launches by kernel
    entry, the phase's numbers)."""
    import re
    import shutil

    from pitchvis_tpu_torch import demo
    from pitchvis_tpu_torch.core.config import SERIAL_VQT_PARAMETERS, VqtParameters
    from pitchvis_tpu_torch.io.golden import chain_signals
    from pitchvis_tpu_torch.io.png import read_png
    from pitchvis_tpu_torch.io.wav import load_wav, save_wav
    from pitchvis_tpu_torch.kernel.builder import get_kernel
    from pitchvis_tpu_torch.ops import composite as comp
    from pitchvis_tpu_torch.ops.resample import PolyphaseResampler, make_spec, resample
    from pitchvis_tpu_torch.ops.vqt import Vqt
    from pitchvis_tpu_torch.ops.vqt_ref import vqt_frame_db_np

    numbers = {}
    cli_launches = {"vqt_power_bf16": 0, "vqt_power_f32": 0, "peaks": 0, "agc": 0, "composite": 0}
    work = os.path.join(ROOT, "build", "cli_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    try:
        # (a) the file: arpeggio, chord and chirp of the chain signals mixed
        # (the f64 synth clip renders about a second of audio a second, so it
        # is left out of 60 s)
        t = time.perf_counter()
        sigs = chain_signals(VqtParameters(sr=44100.0), CLI_SECONDS, with_synth=False)
        mix = (sigs["arpeggio"] + sigs["chord"] + sigs["chirp"]) / 3.0
        wav = os.path.join(work, "chain_mix_44100.wav")
        save_wav(wav, mix, 44100)
        print(f"cli: wrote {CLI_SECONDS:.0f} s of arpeggio + chord + chirp at 44100 Hz, 16 bit, in "
              f"{time.perf_counter() - t:.2f} s")

        # the resample of the file on the card, and against the CPU on its first seconds
        audio, sr = load_wav(wav)
        resample(audio, sr, 22050)  # warm-up
        resample_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            resample(audio, sr, 22050)
            torch.cuda.synchronize()
            resample_ms.append((time.perf_counter() - t) * 1e3)
        # the tap sum alone, on the samples already on the card (CUDA events)
        m = make_spec(sr, 22050).m
        rs = PolyphaseResampler(sr, 22050, (len(audio) // m) * m)
        on_card = torch.from_numpy(audio[None, : rs.chunk_in]).cuda()
        hist = rs.init_state(1)
        process_ms = time_ms(torch, lambda: rs.process(hist, on_card), reps=5, inner=3)
        moved = (rs.chunk_in + rs.chunk_out) * 4 + rs._taps.numel() * 4 + rs._idx.numel() * 8
        numbers["resample_process_ms"] = process_ms
        numbers["resample_process_bound_ms"], _ = bound_ms(moved, 2.0 * rs._taps.numel(), F32_FLOPS)
        del rs, on_card, hist
        head = audio[: int(CLI_CARD_CPU_SECONDS * sr)]
        rs_err = float(np.abs(resample(head, sr, 22050) - resample(head, sr, 22050, device="cpu")).max())
        numbers["resample_ms"] = float(np.median(resample_ms))
        print(f"cli: resample {len(audio)} samples 44100 -> 22050 Hz on the card (host audio in and out, "
              f"median of 5): {numbers['resample_ms']:.3f} ms; its tap sum alone (process(), CUDA events) "
              f"{process_ms:.3f} ms, bound {numbers['resample_process_bound_ms']:.3f} ms (bytes: samples, "
              f"taps and indices read once); card vs CPU on {CLI_CARD_CPU_SECONDS:.0f} s: "
              f"max |diff| {rs_err:.2e} (tol 1e-6)")
        check(rs_err <= 1e-6, f"resample on the card {rs_err} from the CPU")

        runs = {}
        for label, argv, entry in (
            ("bf16_led", [wav, "--path", "pallas", "--fast", "--led", os.path.join(work, "card.bin")],
             "vqt_power_bf16"),
            ("f32_default", [wav, "--path", "pallas"], "vqt_power_f32"),
        ):
            reset_counts()
            with plain_calls() as plain:
                lines, err, wall = run_cli(demo, argv)
            c = counts()
            n_hops = len(lines)
            want = {"vqt": n_hops, "peaks": 2 * n_hops, "agc": n_hops}
            median = re.search(r"median hop ([0-9.]+) ms", err)
            check(median is not None, f"cli {label}: no offline summary on stderr: {err[-500:]}")
            run = dict(hops=n_hops, wall_s=wall, realtime=CLI_SECONDS / wall, median_hop_ms=float(median.group(1)),
                       launches=c, plain_calls=sum(plain.values()))
            print(f"cli {label}: {json.dumps(run)}")
            check(n_hops == int(CLI_SECONDS * 30), f"cli {label}: {n_hops} summary lines for {CLI_SECONDS} s at 30 fps")
            check(c == want, f"cli {label}: launches {c}, expected {want}")
            check(sum(plain.values()) == 0, f"cli {label}: a plain version ran on the card: {plain}")
            check(sum(bool(summary_notes(line)) for line in lines) > n_hops // 2,
                  f"cli {label}: notes in fewer than half the hops")
            cli_launches[entry] += c["vqt"]
            cli_launches["peaks"] += c["peaks"]
            cli_launches["agc"] += c["agc"]
            runs[label] = run
        numbers["offline"] = runs
        n_led = SERIAL_VQT_PARAMETERS.n_buckets
        check(led_frames(os.path.join(work, "card.bin"), n_led).shape[0] == runs["bf16_led"]["hops"],
              "cli: LED frames and hops differ")

        # (b) the first seconds on the card against the CPU, the chain budget
        head_wav = os.path.join(work, "head.wav")
        save_wav(head_wav, mix[: int(CLI_CARD_CPU_SECONDS * 44100)], 44100)
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts()
            out[device] = run_cli(demo, [head_wav, "--path", "pallas", "--fast", "--led",
                                         os.path.join(work, f"head_{device}.bin"), "--device", device])[0]
            if device == "cuda":
                c = counts()
                cli_launches["vqt_power_bf16"] += c["vqt"]
                cli_launches["peaks"] += c["peaks"]
                cli_launches["agc"] += c["agc"]
        card_lines, cpu_lines = out["cuda"], out["cpu"]
        check(len(card_lines) == len(cpu_lines) > 0, "cli: card and CPU print different numbers of lines")
        flipped = [summary_notes(a) != summary_notes(b) for a, b in zip(card_lines, cpu_lines)]
        same_head = all(a.split(" calm=")[0] == b.split(" calm=")[0] for a, b in zip(card_lines, cpu_lines))
        calm = max(abs(float(a.split("calm=")[1][:4]) - float(b.split("calm=")[1][:4]))
                   for a, b in zip(card_lines, cpu_lines))
        led_card = led_frames(os.path.join(work, "head_cuda.bin"), n_led)
        led_cpu = led_frames(os.path.join(work, "head_cpu.bin"), n_led)
        keep = ~np.asarray(flipped)
        led_diff = int(np.abs(led_card[keep].astype(np.int32) - led_cpu[keep].astype(np.int32)).max())
        max_flips = max(1, int(CHAIN_FLIP_SHARE * n_led * len(card_lines)))
        numbers["card_vs_cpu"] = dict(hops=len(card_lines), lines_with_other_notes=int(sum(flipped)),
                                      led_max_steps=led_diff, calm_max_diff=calm, t_and_gain_equal=same_head)
        print(f"cli card vs cpu ({CLI_CARD_CPU_SECONDS:.0f} s, --path pallas --fast --led): "
              f"{json.dumps(numbers['card_vs_cpu'])} (at most {max_flips} lines with other notes, LED within "
              f"{CHAIN_LED_STEPS} elsewhere, calm within {CHAIN_CALM_TOL}, t= and gain= equal)")
        check(sum(flipped) <= max_flips, "cli: card and CPU notes differ beyond the chain budget")
        check(led_diff <= CHAIN_LED_STEPS, f"cli: LED frames card vs CPU differ by {led_diff}")
        check(calm <= CHAIN_CALM_TOL + 0.01, f"cli: calmness card vs CPU differs by {calm}")
        check(same_head, "cli: t= or gain= differ between card and CPU")

        # (c) live: the CLI as a subprocess, the tone on its stdin
        t48 = np.arange(int(48000 * LIVE_SECONDS)) / 48000
        tone = (0.2 * np.sin(2 * np.pi * 440.0 * t48)).astype(np.float32).tobytes()
        live_led = os.path.join(work, "live.bin")
        lines, err, wall = cli_subprocess(["--serve", "--input-sr", "48000", "--pipelined", "--path", "pallas",
                                           "--fast", "--led", live_led], tone)
        want_hops = int(48000 * LIVE_SECONDS) // int(48000 / 30)
        stats = [ln for ln in err.splitlines() if ln.startswith("serving stats")]
        numbers["live_pipelined"] = dict(lines=len(lines), wall_s=wall, led_frames=int(led_frames(live_led, n_led).shape[0]))
        print(f"cli --serve --input-sr 48000 --pipelined: {json.dumps(numbers['live_pipelined'])} "
              f"(process start to end); {stats[-1] if stats else 'no stats line'}")
        check(len(lines) == want_hops and numbers["live_pipelined"]["led_frames"] == want_hops,
              f"cli live: {len(lines)} lines for {want_hops} hops")
        check("A4" in lines[-1], f"cli live: no A4 in the last line: {lines[-1]}")
        lines, err, wall = cli_subprocess(["--serve", "--loop", "--hops-per-dispatch", "4", "--input-sr", "48000",
                                           "--path", "pallas", "--fast"], tone)
        stats = [ln for ln in err.splitlines() if ln.startswith("serving stats")]
        numbers["live_loop"] = dict(lines=len(lines), wall_s=wall)
        print(f"cli --serve --loop --hops-per-dispatch 4: {json.dumps(numbers['live_loop'])}; "
              f"{stats[-1] if stats else 'no stats line'}")
        check(bool(stats) and "loop stats" in stats[-1], "cli loop: no loop stats")
        check(any("A4" in ln for ln in lines), "cli loop: no A4 found")

        # (d) --render: 1 s of the tone at 640x360 with the debug overlay
        frames_dir = os.path.join(work, "frames")
        reset_counts()
        comp.launches = 0
        with plain_calls() as plain:
            lines, err, wall = run_cli(demo, ["--tone", "440", "--seconds", "1", "--render", frames_dir,
                                              "--render-size", "640x360", "--debug-overlay", "--path", "pallas",
                                              "--fast"])
        c = counts()
        n_frames = len(lines)
        pngs = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
        colours = [len(np.unique(read_png(os.path.join(frames_dir, f)).reshape(-1, 3), axis=0)) for f in pngs]
        numbers["render"] = dict(frames=len(pngs), wall_s=wall, ms_a_frame=wall * 1e3 / max(1, len(pngs)),
                                 composite_launches=comp.launches, min_colours=min(colours) if colours else 0,
                                 plain_calls=sum(plain.values()))
        print(f"cli --render 640x360 --debug-overlay (1 s): {json.dumps(numbers['render'])} "
              f"(two composites a frame: the balls and the overlay's peak disks)")
        check(len(pngs) == n_frames == 30, f"cli render: {len(pngs)} PNGs for {n_frames} hops")
        check(comp.launches == 2 * n_frames, f"cli render: {comp.launches} composite launches for {n_frames} frames")
        check(min(colours) > 1, "cli render: a frame of one colour")
        check(sum(plain.values()) == 0, f"cli render: a plain version ran on the card: {plain}")
        cli_launches["composite"] += comp.launches
        cli_launches["vqt_power_bf16"] += c["vqt"]
        cli_launches["peaks"] += c["peaks"]
        cli_launches["agc"] += c["agc"]

        # (e) the freq path at B=2048, default parameters
        params = VqtParameters()
        kernel = get_kernel(params)
        frames = synthetic_audio(torch, B, params.n_fft, params.sr, gen)
        x8 = frames[:FREQ_FRAMES].cpu()
        oracle = np.stack([vqt_frame_db_np(kernel, x8[i].numpy().astype(np.float64)) for i in range(FREQ_FRAMES)])
        freq = {}
        for fast in (False, True):
            tag = "bf16" if fast else "f32"
            v = {path: Vqt(params, path=path, fast=fast) for path in ("freq", "time", "pallas")}
            db = v["freq"].calculate_vqt_batch_in_db(frames)
            check(tuple(db.shape) == (B, params.n_buckets) and bool(torch.isfinite(db).all()),
                  f"freq {tag}: non-finite or misshapen output")
            db8 = db[:FREQ_FRAMES].cpu().numpy()
            time8 = v["time"].calculate_vqt_batch_in_db(frames[:FREQ_FRAMES]).cpu().numpy()
            cpu = Vqt(params, path="freq", fast=fast, device="cpu")
            p_card = v["freq"].calculate_vqt_batch_power(frames[:FREQ_FRAMES]).cpu().numpy()
            p_cpu = cpu.calculate_vqt_batch_power(x8).numpy()
            scale = p_cpu.max(axis=1, keepdims=True)
            rel_excess = float(((np.abs(p_card - p_cpu) - 1e-6 * scale) / (np.abs(p_cpu) + 1e-30)).max())
            ms = {path: time_ms(torch, lambda vq=vq: vq.calculate_vqt_batch_in_db(frames), reps=5, inner=5)
                  for path, vq in v.items()}
            row = dict(oracle_max_db=float(np.abs(db8 - oracle).max()), time_max_db=float(np.abs(db8 - time8).max()),
                       cpu_power_rel_excess=rel_excess, ms=ms)
            freq[tag] = row
            print(f"freq path {tag} at B={B}: {json.dumps(row)} (dB call of each path, CUDA events, median of 5 x 5)")
            if fast:
                # bf16 rounds the packed spectrum, not the samples: its error
                # against the oracle is recorded, and the path is held to
                # itself on the CPU, where it meets the JAX package
                check(rel_excess <= FREQ_BF16_RTOL, f"freq bf16 card vs CPU: power {rel_excess} beyond rtol")
            else:
                check(row["oracle_max_db"] <= ORACLE_DB_TOL, f"freq f32: {row['oracle_max_db']} dB from the oracle")
                check(row["time_max_db"] <= ORACLE_DB_TOL, f"freq f32: {row['time_max_db']} dB from the time path")
                check(rel_excess <= 1e-5, f"freq f32 card vs CPU: power {rel_excess} beyond rtol 1e-5")
            del v, db
        numbers["freq"] = freq
        del frames
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"cli phase: {numbers['phase_s']:.1f} s")
    return cli_launches, numbers


SOAK_MINUTES = 0.05  # phase 11: each soak leg's wall time (3 s), at its default stream count
# phase 11 (0): the stream counts that the bench's paths give the kernels
# beside phase 2's 2048: the streaming and latency configs and the serve
# loops (512), the server legs and longhaul (1024), the soak pipeline and
# capacity legs (3840); the ring push runs at 512 and 3840 (the server legs
# and longhaul run their AGC natively)
BENCH_STREAMS = (512, 1024, 3840)
BENCH_RING_STREAMS = (512, 3840)
LONGHAUL_STREAMS = 1024  # phase 11: the long-haul run
LONGHAUL_MINUTES = 0.25
LONGHAUL_REBUILD_S = 8.0  # one live rebuild inside the run
LONGHAUL_LEFT_MB = 1.0  # device memory that may stay allocated after the run
# phase 11: the keys of each config's result beyond metric, value, unit and
# vs_baseline, and its metric name, as the JAX package's
# pitchvis_tpu/bench/configs.py returns them (:111, :180, :233-239,
# :262-263, :279-280, :300-301, :340, :380, :442, :498-503, :578-583)
BENCH_EXTRA_KEYS = {
    "latency": ("p95_ms", "pipelined_hop_ms", "n_streams", "server_pipelined_hop_p50_ms",
                "server_pipelined_hop_p95_ms", "server_multi_hop_ms", "server_multi_k",
                "serve_loop_gap_p50_ms", "serve_loop_gap_p95_ms"),
    "train_corpus": ("speedup_vs_serial", "n_workers"),
    "render": ("raster", "max_balls"),
}
BENCH_METRICS = {
    "offline_vqt": "vqt_frames_per_sec_per_chip",
    "offline_vqt_bf16": "vqt_bf16_frames_per_sec_per_chip",
    "streaming": "streaming_realtime_factor_per_chip",
    "streaming_pallas_bf16": "streaming_pallas_bf16_realtime_factor_per_chip",
    "streaming_fused": "streaming_fused_realtime_factor_per_chip",
    "streaming_fused_pallas_bf16": "streaming_fused_pallas_bf16_realtime_factor_per_chip",
    "streaming_fused_viewer_pallas_bf16": "streaming_fused_viewer_pallas_bf16_realtime_factor_per_chip",
    "latency": "serving_hop_latency_p50_ms",
    "analysis": "analysis_frames_per_sec_per_chip",
    "serial": "led_frames_per_sec_per_chip",
    "train": "train_labeled_frames_per_sec",
    "train_device_gen": "train_labeled_frames_per_sec",
    "train_corpus": "train_corpus_labeled_frames_per_sec",
    "render": "render_frames_per_sec_per_chip",
}
# the kernels each config launches on the card, and no other: the time path
# runs its VQT as torch.matmul, serial, train and train_corpus run no kernel
# (the host route), the latency config's server runs its AGC natively
_HOP = {"vqt", "peaks", "agc"}
BENCH_KERNELS = {
    "offline_vqt": {"vqt"}, "offline_vqt_bf16": {"vqt"},
    "streaming": {"peaks", "agc"}, "streaming_pallas_bf16": _HOP, "streaming_fused": {"peaks", "agc"},
    "streaming_fused_pallas_bf16": _HOP, "streaming_fused_viewer_pallas_bf16": _HOP, "latency": _HOP,
    "analysis": {"peaks"}, "serial": set(), "train": set(), "train_device_gen": {"agc_signal"},
    "train_corpus": set(), "render": {"composite"},
}
SOAK_LEGS = ("pipeline", "server", "server_capacity", "serve_loop", "serve_loop_throughput", "serve_loop_cadenced")


def bench_subprocess(args) -> tuple[list, float]:
    """``python -m args`` from the checkout's root: (stdout lines, wall
    seconds). Fails the run on a non-zero exit; the process has ended on
    return."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"python -m {' '.join(args)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout.splitlines(), wall


def server_hop_output_mb(torch, n_streams: int) -> float:
    """MB of device memory that one hop's outputs of the long-haul run's
    server hold (the cadenced loop publishes them): a StreamServer of
    ``n_streams`` streams at default parameters, one step_multi(8,
    per_hop=True), its outputs' distinct storages over 8."""
    from pitchvis_tpu_torch import VqtParameters
    from pitchvis_tpu_torch.runtime.server import StreamServer

    srv = StreamServer(n_streams, VqtParameters(), buffer_seconds=2.0, path="pallas", fast=True, device="cuda")
    try:
        outs, _ = srv.step_multi(8, dt=1.0 / 60.0, per_hop=True)
        storages = {}
        for out in outs:
            for leaf in leaves(out).values():
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    st = leaf.untyped_storage()
                    storages[st.data_ptr()] = st.nbytes()
    finally:
        srv.close()
    return sum(storages.values()) / 8 / 1e6


def kernels_at_bench_shapes(torch) -> float:
    """Phase 11 (0): each kernel of the bench's hop against its plain
    version at the shapes and parameter sets that the bench gives it and no
    earlier phase does: the bf16 VQT and the peaks selection at
    BENCH_STREAMS, on the default parameters' arrays and on those of the
    live rebuild's set (quality x 1.1: other filter counts a window), the
    peaks on each one's spectra; one ring push at BENCH_RING_STREAMS,
    L=32768, T=367. Returns its seconds."""
    import dataclasses

    from pitchvis_tpu_torch.core.config import VqtParameters
    from pitchvis_tpu_torch.kernel.builder import get_kernel
    from pitchvis_tpu_torch.ops.vqt import make_vqt_arrays, power_to_db
    from pitchvis_tpu_torch.stream.ring import RingState

    t = time.perf_counter()
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    params = VqtParameters()
    hop = int(params.sr / 60.0)
    bpo = params.range.buckets_per_octave
    frames = synthetic_audio(torch, max(BENCH_STREAMS), params.n_fft, params.sr, gen)
    for label, pset in (("default", params), ("quality x 1.1", dataclasses.replace(params, quality=params.quality * 1.1))):
        # the arrays a pipeline or server of the bench builds for the set
        arrays = make_vqt_arrays(get_kernel(pset), path="pallas", fast=True, device=dev)
        print(f"vqt arrays ({label}): window sizes {arrays.window_sizes}, filters a window {arrays.nf}")
        for b in BENCH_STREAMS:
            power, _, _ = vqt_kernel_against_plain(torch, f"vqt_power_bf16 ({label}) at B={b}", arrays, frames[:b])
            peaks_masks_against_plain(torch, f"vqt spectra ({label}) at B={b}", power_to_db(power), bpo)
        del arrays, power
    del frames
    for b in BENCH_RING_STREAMS:
        ring = RingState(buffer=torch.randn((b, params.n_fft), generator=gen, device=dev) * 0.1,
                         gain=torch.rand(b, generator=gen, device=dev) * 2.0 + 0.1)
        push_against_plain(torch, f"B={b}, L={params.n_fft}, T={hop}", ring,
                           synthetic_audio(torch, b, hop, params.sr, gen))
    del ring
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t
    print(f"kernels at the bench's shapes: {seconds:.1f} s")
    return seconds


def bench_phase(torch, counts, reset_counts) -> tuple[dict, dict]:
    """Phase 11: the port's bench (pitchvis_tpu_torch/bench/) on the card.
    (0) the kernels at the bench's shapes (kernels_at_bench_shapes); (a)
    every ALL_CONFIGS entry once, and bench_train(device_gen=True), each
    result with the JAX function's keys and metric name, finite positive
    numbers, nothing skipped, each config's kernels launched (and no other)
    and no plain version called; (b) every soak leg at its default stream
    count for SOAK_MINUTES and longhaul at 1024 streams for 0.25 minutes,
    through their mains, their reports written under build/bench_phase/
    (deleted after) and checked, and no device memory of longhaul's left
    after it; (c) ``python -m pitchvis_tpu_torch.bench``
    (the two default lines) and ``python -m pitchvis_tpu_torch.xtask check``
    as subprocesses. Returns (the phase's launches by kernel entry, its
    numbers)."""
    import functools
    import shutil

    from pitchvis_tpu_torch.bench import configs, longhaul, soak
    from pitchvis_tpu_torch.ops import agc, composite

    def all_counts():
        return dict(counts(), agc_signal=agc.signal_launches, composite=composite.launches)

    def reset_all():
        reset_counts()
        agc.signal_launches = 0
        composite.launches = 0

    entries = ("vqt_power_bf16", "vqt_power_f32", "peaks", "agc", "composite", "agc_signal")
    launches = dict.fromkeys(entries, 0)

    def add(c, vqt_entry):
        launches[vqt_entry] += c["vqt"]
        for key in ("peaks", "agc", "composite", "agc_signal"):
            launches[key] += c[key]

    def positive_numbers(result, what):
        for key, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                check(bool(np.isfinite(v)) and v > 0, f"{what}: {key} = {v}")

    numbers = {"configs": {}}
    t_phase = time.perf_counter()
    numbers["kernels_at_bench_shapes_s"] = kernels_at_bench_shapes(torch)
    work = os.path.join(ROOT, "build", "bench_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # (a) the configurations
        runs = dict(configs.ALL_CONFIGS, train_device_gen=functools.partial(configs.bench_train, device_gen=True))
        for key, fn in runs.items():
            reset_all()
            t = time.perf_counter()
            with plain_calls() as plain:
                result = fn()
            wall = time.perf_counter() - t
            c = all_counts()
            print(f"bench {key}: {json.dumps(result)}; launches {c}; {wall:.1f} s")
            want = {"metric", "value", "unit", "vs_baseline", *BENCH_EXTRA_KEYS.get(key.split("_device")[0], ())}
            check(set(result) == want, f"bench {key}: keys {sorted(result)}, the JAX function's {sorted(want)}")
            check(result["metric"] == BENCH_METRICS[key], f"bench {key}: metric {result['metric']}")
            check("skipped" not in json.dumps(result), f"bench {key}: something was skipped")
            positive_numbers(result, f"bench {key}")
            launched = {k for k, v in c.items() if v > 0}
            check(launched == BENCH_KERNELS[key], f"bench {key}: launched {sorted(launched)}, "
                                                  f"expected {sorted(BENCH_KERNELS[key])}")
            check(sum(plain.values()) == 0, f"bench {key}: a plain version ran on the card: {plain}")
            add(c, "vqt_power_f32" if key == "offline_vqt" else "vqt_power_bf16")
            numbers["configs"][key] = dict(result, launches=c, wall_s=wall)
        # a call of the window-timed configs, host against card: the host
        # clock's enqueue of 32 calls (output + sum) against the window to
        # its end, and one call's launches and device ms (profiler); where
        # enqueue and wall meet, the line measures the host, not the card
        for key, unit in (("offline_vqt", configs.offline_vqt_work(2048, "pallas", False, device="cuda")),
                          ("offline_vqt_bf16", configs.offline_vqt_work(2048, "pallas", True, device="cuda")),
                          ("serial", configs.serial_work(2048, device="cuda"))):
            split = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for i in range(32):
                    unit(i).sum(dtype=torch.float32)
                enqueue = time.perf_counter() - t
                torch.cuda.synchronize()
                split.append((enqueue / 32 * 1e3, (time.perf_counter() - t) / 32 * 1e3))
            enq_ms, wall_ms = (float(np.median(v)) for v in zip(*split))
            ops, dev_ms = device_trace(torch, lambda: unit(1).sum(dtype=torch.float32))
            numbers["configs"][key].update(call_enqueue_ms=enq_ms, call_wall_ms=wall_ms, call_launches=ops,
                                           call_device_ms=dev_ms)
            print(f"bench {key}: a call (its output + sum) enqueues in {enq_ms:.4f} ms and ends in {wall_ms:.4f} ms "
                  f"(host clock, median of 5 windows of 32); {ops} device ops, {dev_ms:.4f} ms on the card "
                  f"(profiler, one call)")
        del unit
        torch.cuda.empty_cache()

        # (b) the soak legs and the long-haul run
        soak_path = os.path.join(work, "SOAK_torch.json")
        reset_all()
        t = time.perf_counter()
        with plain_calls() as plain:
            check(soak.main(["--minutes", str(SOAK_MINUTES), "--out", soak_path]) == 0, "soak.main failed")
        c = all_counts()
        with open(soak_path) as f:
            report = json.load(f)
        numbers["soak"] = {"wall_s": time.perf_counter() - t, "launches": c}
        for leg in SOAK_LEGS:
            r = report.get(leg, {})
            check("skipped" not in r and "leg" in r, f"soak {leg}: {r}")
            check(r["outputs_finite"], f"soak {leg}: outputs not finite")
            served = r["published"] if leg.startswith("serve_loop") else r["hops"]
            check(served > 0, f"soak {leg}: no hop served")
            numbers["soak"][leg] = {k: v for k, v in r.items() if k not in ("serving_stats", "loop_stats")}
        check({k for k, v in c.items() if v > 0} == _HOP, f"soak: launched {c}")
        check(sum(plain.values()) == 0, f"soak: a plain version ran on the card: {plain}")
        add(c, "vqt_power_bf16")
        print(f"soak ({SOAK_MINUTES * 60:.0f} s a leg): launches {c}, {numbers['soak']['wall_s']:.1f} s")

        lh_path = os.path.join(work, "LONGHAUL_torch.json")
        reset_all()
        gc.collect()
        mb_before = torch.cuda.memory_allocated() / 1e6
        t = time.perf_counter()
        with plain_calls() as plain:
            check(longhaul.main(["--streams", str(LONGHAUL_STREAMS), "--minutes", str(LONGHAUL_MINUTES),
                                 "--rebuild-every-s", str(LONGHAUL_REBUILD_S), "--out", lh_path]) == 0,
                  "longhaul.main failed")
        c = all_counts()
        with open(lh_path) as f:
            lh = json.load(f)
        s = lh["summary"]
        check(s["minutes_recorded"] >= 1 and s["all_outputs_finite"], f"longhaul: {s}")
        check(all(m["published"] > 0 and m["device_mb"] for m in lh["per_minute"]), f"longhaul: {lh['per_minute']}")
        check(lh["device_mb_start"] is not None and s["device_mb_end"] > 0, "longhaul: no device memory reported")
        check({k for k, v in c.items() if v > 0} == {"vqt", "peaks"}, f"longhaul: launched {c}")
        check(sum(plain.values()) == 0, f"longhaul: a plain version ran on the card: {plain}")
        add(c, "vqt_power_bf16")
        wall = time.perf_counter() - t
        # its device memory: none of it may outlive the run (the server and
        # its serve loop hold each other, hence the collection); what it grew
        # by in the run, counted in hops of the server's outputs
        gc.collect()
        mb_after = torch.cuda.memory_allocated() / 1e6
        hop_mb = server_hop_output_mb(torch, LONGHAUL_STREAMS)
        grown = s["device_mb_end"] - lh["device_mb_start"]
        numbers["longhaul"] = dict(summary=s, per_minute=lh["per_minute"], device_mb_start=lh["device_mb_start"],
                                   rss_mb_start=lh["rss_mb_start"], launches=c, wall_s=wall,
                                   device_mb_before=mb_before, device_mb_after=mb_after, hop_output_mb=hop_mb,
                                   grown_in_hops=grown / hop_mb)
        print(f"longhaul ({LONGHAUL_STREAMS} streams, {LONGHAUL_MINUTES} min): {json.dumps(numbers['longhaul'])}")
        print(f"longhaul device memory: {mb_before:.1f} MB before the run, {mb_after:.1f} MB after it "
              f"(tol +{LONGHAUL_LEFT_MB} MB); in the run from {lh['device_mb_start']} to {s['device_mb_end']} MB, "
              f"{grown / hop_mb:.1f} hops of the server's outputs at {hop_mb:.2f} MB a hop")
        check(mb_after - mb_before <= LONGHAUL_LEFT_MB, "longhaul left device memory allocated after its run")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (c) the runner's default lines and the task runner's check
    lines, wall = bench_subprocess(["pitchvis_tpu_torch.bench"])
    default = [json.loads(line) for line in lines[-2:]]
    check([d["metric"] for d in default] == ["vqt_frames_per_sec_per_chip", "vqt_bf16_frames_per_sec_per_chip"],
          f"bench default lines: {lines[-2:]}")
    for d in default:
        positive_numbers(d, "bench default line")
    numbers["default_lines"] = default
    print(f"python -m pitchvis_tpu_torch.bench: {lines[-2:]} ({wall:.1f} s)")
    lines, wall = bench_subprocess(["pitchvis_tpu_torch.xtask", "check"])
    check(any(line.startswith("check ok:") and line.endswith("VQT kernel launches: 1") for line in lines),
          f"xtask check: {lines[-3:]}")
    numbers["xtask_check_s"] = wall
    print(f"python -m pitchvis_tpu_torch.xtask check: {lines[-1]} ({wall:.1f} s)")
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"bench phase: {numbers['phase_s']:.1f} s")
    return launches, numbers


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    sys.path.insert(0, ROOT)
    from pitchvis_tpu_torch import StreamingPipeline, VqtParameters, get_kernel
    from pitchvis_tpu_torch.core.config import AnalysisParameters
    from pitchvis_tpu_torch.models import analysis as analysis_mod
    from pitchvis_tpu_torch.ops import agc as agc_mod
    from pitchvis_tpu_torch.ops import peaks_pallas as peaks_mod
    from pitchvis_tpu_torch.ops import vqt_pallas as vqt_mod
    from pitchvis_tpu_torch.ops.vqt import power_to_db
    from pitchvis_tpu_torch.ops.vqt_ref import vqt_frame_db_np
    from pitchvis_tpu_torch.stream.ring import RingState, ring_push, ring_push_plain, ring_window
    from pitchvis_tpu_torch.utils import host_build, nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    # the server's native ingest library (g++) builds beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        host_libs = [pool.submit(host_build.library_path, lib) for lib in ("pitchvis_native", "synth_engine")]
        build_s = nvcc.build_all()
        for lib in host_libs:
            lib.result()
    print(f"build: {json.dumps(build_s)} wall {time.perf_counter() - t0:.2f} s; "
          f"native ingest library: {host_build.build_logs.get('pitchvis_native', 'already built').splitlines()[-1]}; "
          f"synth engine: {host_build.build_logs.get('synth_engine', 'already built').splitlines()[-1]}")
    for src, log in nvcc.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    smi = nvidia_smi_line()
    print(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    def reset_counts():
        vqt_mod.launches = 0
        peaks_mod.launches = 0
        agc_mod.launches = 0

    def counts():
        return {"vqt": vqt_mod.launches, "peaks": peaks_mod.launches, "agc": agc_mod.launches}

    # ---- 2. kernels against their plain versions ----------------------------
    params = VqtParameters()
    kernel = get_kernel(params)
    sr = params.sr
    hop = int(sr / 60)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    frames = synthetic_audio(torch, B, params.n_fft, sr, gen)
    kernels = {}

    vqt_times = {}
    # the f32 mode makes three tf32 products for each f32 one (3xTF32), so
    # its bound counts three times the multiply-adds at the tf32 rate
    for label, dtype, rate, passes, replaces in (
        ("vqt_power_f32", torch.float32, TF32_FLOPS, 3, "pitchvis_tpu/ops/vqt_pallas.py:311"),
        ("vqt_power_bf16", torch.bfloat16, BF16_FLOPS, 1, "pitchvis_tpu/ops/vqt_pallas.py:291"),
    ):
        arrays = vqt_mod.PallasVqtArrays.from_kernel(kernel, dtype=dtype, device=dev)
        got, err_db, _ = vqt_kernel_against_plain(torch, label, arrays, frames)
        # one frame, and a batch that is no multiple of the kernel's frame tile
        for b in (1, 130):
            vqt_kernel_against_plain(torch, f"{label} at B={b}", arrays, frames[:b])

        tail = frames[:, params.n_fft - arrays.tail :]
        xs = tail.to(dtype)

        def library_call(arrays=arrays, xs=xs):
            for w, off, size in zip(arrays.weights, arrays.offsets, arrays.window_sizes):
                torch.matmul(xs[:, off : off + size], w)

        ms = time_ms(torch, lambda: vqt_mod.vqt_power_pallas(arrays, frames))
        # the C call alone, on frames already checked for alignment (these
        # launches are counted too, and the counts are reset before the main
        # path)
        ready = vqt_mod._kernel_frames(arrays, frames)
        out = torch.empty((B, arrays.n_buckets), dtype=torch.float32, device=dev)
        launch_ms = time_ms(torch, lambda: vqt_mod._launch(arrays, ready, out))
        check(bool(torch.equal(out, got)), f"{label}: the launch alone differs from the wrapper")
        prepare_ms = time_ms(torch, lambda: vqt_mod._kernel_frames(arrays, frames))
        plain_ms = time_ms(torch, lambda: vqt_mod.vqt_power_pallas_plain(arrays, frames), reps=5, inner=3)
        lib_ms = time_ms(torch, library_call)
        _, card_ms = device_trace(torch, lambda: vqt_mod.vqt_power_pallas(arrays, frames), "vqt_kernel", inner=20)
        itemsize = torch.tensor([], dtype=dtype).element_size()
        w_bytes = sum(w.numel() * itemsize for w in arrays.weights)
        # the frames are read as f32 in both modes (bf16 rounds them in registers)
        moved = B * arrays.tail * 4 + w_bytes + B * arrays.n_buckets * 4
        ops = passes * 2.0 * B * sum(size * 2 * nf for size, nf in zip(arrays.window_sizes, arrays.nf))
        b_ms, b_by = bound_ms(moved, ops, rate)
        print(f"{label}: wrapper {ms:.4f} ms (launch alone {launch_ms:.4f} ms, tail view and alignment "
              f"check {prepare_ms:.4f} ms, on the card alone {card_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.matmul per group {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {ops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB)")
        vqt_times[label] = dict(wrapper_ms=ms, launch_ms=launch_ms, prepare_ms=prepare_ms, library_ms=lib_ms)
        kernels[label] = dict(
            name=label, route="cuda", source="pitchvis_tpu_torch/csrc/vqt.cu", replaces=replaces,
            max_abs_err=err_db, ms=ms, card_ms=card_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
        )
        if dtype == torch.float32:
            x8 = frames[:8].cpu().numpy()
            oracle = np.stack([vqt_frame_db_np(kernel, x8[i].astype(np.float64)) for i in range(8)])
            err_oracle = float(np.abs(power_to_db(got[:8]).cpu().numpy() - oracle).max())
            print(f"{label}: max |dB| vs float64 oracle on 8 frames {err_oracle:.3e} (tol {ORACLE_DB_TOL})")
            check(err_oracle <= ORACLE_DB_TOL, f"f32 VQT {err_oracle} dB from the oracle")
        del arrays, xs, got, ready, out

    # the short final K-tile: window sizes that are no multiple of the tile
    rng = np.random.default_rng(SEED)
    ws, offs, nfp = [], [], []
    sizes, nfs, tail_len = (1536, 1100, 700), (7, 130, 3), 1536
    for size, f in zip(sizes, nfs):
        fp = -(-f // 128) * 128
        w = np.zeros((size, 2 * fp), np.float32)
        w[:, :f] = rng.standard_normal((size, f)) * 0.01
        w[:, fp : fp + f] = rng.standard_normal((size, f)) * 0.01
        ws.append(torch.from_numpy(w).to(dev))
        offs.append(tail_len - size)
        nfp.append(fp)
    ragged = vqt_mod.PallasVqtArrays(tuple(ws), tuple(offs), sizes, nfs, tuple(nfp), tail_len, tail_len, sum(nfs))
    ragged_bf16 = vqt_mod.PallasVqtArrays(
        tuple(w.to(torch.bfloat16) for w in ws), tuple(offs), sizes, nfs, tuple(nfp), tail_len, tail_len, sum(nfs))
    xr = torch.from_numpy((rng.standard_normal((5, tail_len)) * 0.3).astype(np.float32)).to(dev)
    want64 = []
    for w, off, size, f, fp in zip(ws, offs, sizes, nfs, nfp):
        y = xr[:, off : off + size].double() @ w.double()
        want64.append(y[:, :f] ** 2 + y[:, fp : fp + f] ** 2)
    want64 = torch.cat(want64, 1)
    got = vqt_mod.vqt_power_pallas(ragged, xr).double()
    rel = float(((got - want64).abs() / want64.abs().clamp_min(1e-12)).max())
    print(f"vqt ragged K-tiles (sizes {sizes}): max rel err vs float64 {rel:.3e} (tol 2e-4)")
    check(rel <= 2e-4, "VQT kernel with a short final K-tile disagrees")
    vqt_kernel_against_plain(torch, "vqt ragged f32", ragged, xr)
    vqt_kernel_against_plain(torch, "vqt ragged bf16", ragged_bf16, xr)
    # frames whose base address and row stride are no multiples of 16 bytes
    # go through an aligned copy, never to the plain version
    wide = torch.zeros((5, tail_len + 3), dtype=torch.float32, device=dev)
    wide[:, 1 : 1 + tail_len] = xr
    before = vqt_mod.launches
    for arr in (ragged, ragged_bf16):
        same = torch.equal(vqt_mod.vqt_power_pallas(arr, wide[:, 1 : 1 + tail_len]), vqt_mod.vqt_power_pallas(arr, xr))
        check(bool(same), "VQT kernel on unaligned frames differs from the same frames aligned")
    check(vqt_mod.launches == before + 4, "unaligned frames did not reach the kernel")
    check(vqt_mod.vqt_power_pallas(ragged, xr[:0]).shape == (0, sum(nfs)) and vqt_mod.launches == before + 4,
          "an empty batch must return an empty tensor without a launch")
    print("vqt unaligned frames: equal to the aligned ones; empty batch: no launch")

    # peaks: real VQT spectra (as the main path feeds it), and plateaus
    spectra = power_to_db(vqt_mod.vqt_power_pallas(
        vqt_mod.PallasVqtArrays.from_kernel(kernel, dtype=torch.bfloat16, device=dev), frames))
    n = params.n_buckets
    bpo = params.range.buckets_per_octave

    def rounded_walk(b, width):
        return torch.from_numpy(np.round(np.cumsum(rng.standard_normal((b, width)), 1)).astype(np.float32)).to(dev)

    walk = rounded_walk(B, n)
    # candidates two bins apart with heights from a few levels: equal heights
    # within the minimum separation, and chains that one round does not settle
    n_chain = len(range(2, n - 2, 2))
    chains = torch.zeros((67, n), dtype=torch.float32, device=dev)
    chains[:, 2:-2:2] = torch.from_numpy(rng.integers(3, 9, (67, n_chain)).astype(np.float32)).to(dev)
    chains[:33, 2:-2:2] += torch.linspace(20.0, 0.0, n_chain, device=dev).round()
    wide = torch.zeros((67, n + 3), dtype=torch.float32, device=dev)
    wide[:, 1 : 1 + n] = spectra[:67]
    wide[:, 0] = 99.0  # what lies beside the rows must not leak into them
    wide[:, 1 + n :] = 99.0
    cases = [("vqt spectra", spectra), ("rounded random walk", walk), ("tie-heavy chains at B=67", chains),
             ("one frame", spectra[:1]), ("n=65", rounded_walk(5, 65)), ("n=96", rounded_walk(5, 96)),
             ("n=1100", rounded_walk(5, 1100)),
             ("rows off 16-byte alignment (base and stride)", wide[:, 1 : 1 + n])]

    # (a) the primitive outputs: local-maximum mask and prominence at every bin
    peak_err = 0.0
    for label, xs in cases:
        before = peaks_mod.launches
        m_k, p_k = peaks_mod.local_maxima_and_prominences(xs)
        m_p, p_p = peaks_mod.local_maxima_and_prominences_plain(xs)
        same = bool(torch.equal(m_k, m_p)) and bool(torch.equal(p_k, p_p))
        peak_err = max(peak_err, float((p_k - p_p).abs().max()))
        print(f"peaks primitives on {label}: masks and prominences equal: {same} "
              f"({int(m_k.sum())} local maxima)")
        check(same, f"peaks kernel's primitive outputs differ from their plain version on {label}")
        check(peaks_mod.launches == before + 1, f"peaks primitives on {label}: a CUDA tensor did not reach the kernel")

    # (b) the selected masks, two configurations and one, to convergence and one round
    ap = AnalysisParameters()
    two = (ap.bassline_peak_config, ap.peak_config)
    one = (ap.peak_config,)
    unconverged = sum(peaks_masks_against_plain(torch, label, xs, bpo) for label, xs in cases)
    check(unconverged > 0, "no case left one suppression round short of the fixpoint")
    before = peaks_mod.launches
    empty = peaks_mod.find_peaks_masks(spectra[:0], two, bpo)
    check([tuple(m.shape) for m in empty] == [(0, n), (0, n)] and peaks_mod.launches == before,
          "an empty batch must return empty masks without a launch")
    print("peaks selection on the empty batch: empty masks, no launch")

    # times: the main path's first call of a hop (two configurations), then the primitives
    def select_two():
        return peaks_mod.find_peaks_masks(spectra, two, bpo)

    ms = time_ms(torch, select_two)
    _, card_ms = device_trace(torch, select_two, "peaks_kernel", inner=20)
    one_ms = time_ms(torch, lambda: peaks_mod.find_peaks_masks(spectra, one, bpo))
    # the kernel's work follows the candidates a row: the same call on the rounded walk
    _, walk_card_ms = device_trace(torch, lambda: peaks_mod.find_peaks_masks(walk, two, bpo), "peaks_kernel", inner=20)
    candidates = [float((peaks_mod.local_maxima_and_prominences(xs)[0] & (xs >= two[0].min_height)).sum(1).float().mean())
                  for xs in (spectra, walk)]
    plain_ms = time_ms(torch, lambda: peaks_mod.find_peaks_masks_plain(spectra, two, bpo), reps=3, inner=1)
    # an empty kernel at the grid, block and shared memory that csrc/peaks.cu
    # launches for these rows: the floor of such a launch on this card
    floor_fn = nvcc.library("launch_floor").launch_floor
    floor_fn.restype = ctypes.c_int
    floor_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    threads = 32 * -(-(-(-n // 4)) // 32)  # four bins a thread, whole warps
    n4 = 4 * -(-n // 4)
    smem = 4 * n4 + 4 * (n // 2 + 1) + 4 * n4

    def empty_launch():
        nvcc.check(floor_fn(B, threads, smem, torch.cuda.current_stream().cuda_stream), "launch_floor")

    floor_call_ms = time_ms(torch, empty_launch)
    _, floor_card_ms = device_trace(torch, empty_launch, "empty_kernel", inner=20)
    # what the function cannot avoid: read the spectrum once, write one byte a
    # bin and configuration once, and at least one compare a bin (one op an
    # instruction, where the FFMA rate counts two)
    b_ms, b_by = bound_ms(B * n * 4 + len(two) * B * n, float(B) * n, F32_FLOPS / 2)
    print(f"peaks (2 configurations): {ms:.4f} ms a call, {card_ms:.4f} ms on the card alone, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); 1 configuration {one_ms:.4f} ms a call; "
          f"{candidates[0]:.1f} candidates a row here, on the rounded walk's {candidates[1]:.1f} a row "
          f"{walk_card_ms:.4f} ms on the card alone; "
          f"empty kernel of {B} blocks x {threads} threads, {smem} B shared: {floor_call_ms:.4f} ms a call, "
          f"{floor_card_ms:.4f} ms on the card alone")
    prim_ms = time_ms(torch, lambda: peaks_mod.local_maxima_and_prominences(spectra))
    _, prim_card_ms = device_trace(torch, lambda: peaks_mod.local_maxima_and_prominences(spectra), "peaks_kernel", inner=20)
    prim_plain_ms = time_ms(torch, lambda: peaks_mod.local_maxima_and_prominences_plain(spectra), reps=3, inner=1)
    pb_ms, pb_by = bound_ms(B * n * 4 + B * n * 5, float(B) * n, F32_FLOPS / 2)
    print(f"peaks primitives (all bins): {prim_ms:.4f} ms a call, {prim_card_ms:.4f} ms on the card alone, "
          f"plain {prim_plain_ms:.4f} ms, bound {pb_ms:.4f} ms ({pb_by})")
    kernels["peaks"] = dict(
        name="peaks", route="cuda", source="pitchvis_tpu_torch/csrc/peaks.cu",
        replaces="pitchvis_tpu/ops/peaks_pallas.py:112", max_abs_err=peak_err, ms=ms, card_ms=card_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        one_config_ms=one_ms, candidates_per_row=candidates[0], walk_card_ms=walk_card_ms,
        walk_candidates_per_row=candidates[1], floor_ms=floor_call_ms, floor_card_ms=floor_card_ms,
        primitives_ms=prim_ms, primitives_card_ms=prim_card_ms, primitives_plain_ms=prim_plain_ms,
        primitives_bound_ms=pb_ms,
    )

    # AGC, chunk mode: one hop of samples against agc_chunk_plain
    chunk = synthetic_audio(torch, B, hop, sr, gen)
    chunk[7] = 0.0  # a silent row: its gain stays
    gain = torch.rand(B, generator=gen, device=dev) * 2.0 + 0.1
    g_k, o_k = agc_mod.agc_chunk(gain, chunk)
    g_p, o_p = agc_mod.agc_chunk_plain(gain, chunk)
    same = bool(torch.equal(g_k, g_p)) and bool(torch.equal(o_k, o_p))
    agc_err = max(float((g_k - g_p).abs().max()), float((o_k - o_p).abs().max()))
    print(f"agc chunk mode: gains and samples equal to the plain version: {same}")
    check(same, "AGC kernel's chunk mode differs from its plain version")
    # the caller's freeze flags (agc_chunk(frozen=)) instead of the energy's
    frozen = torch.rand(B, generator=gen, device=dev) < 0.5
    frozen[7] = False  # the silent row unfrozen: its gain moves
    g_k, o_k = agc_mod.agc_chunk(gain, chunk, frozen=frozen)
    g_p, o_p = agc_mod.agc_chunk_plain(gain, chunk, frozen=frozen)
    same = bool(torch.equal(g_k, g_p)) and bool(torch.equal(o_k, o_p)) and bool(torch.equal(g_k[frozen], gain[frozen]))
    print(f"agc chunk mode with the caller's freeze flags: gains and samples equal to the plain version: {same}")
    check(same, "AGC kernel's chunk mode with frozen= differs from its plain version")
    chunk_ms = time_ms(torch, lambda: agc_mod.agc_chunk(gain, chunk))
    _, chunk_card_ms = device_trace(torch, lambda: agc_mod.agc_chunk(gain, chunk), "ring_push_kernel", inner=20)
    chunk_plain_ms = time_ms(torch, lambda: agc_mod.agc_chunk_plain(gain, chunk), reps=3, inner=1)
    cb_ms, _ = bound_ms(2 * B * hop * 4 + 2 * B * 4, 8.0 * B * hop, F32_FLOPS)
    print(f"agc chunk mode: {chunk_ms:.4f} ms a call, {chunk_card_ms:.4f} ms on the card alone, "
          f"plain {chunk_plain_ms:.4f} ms, bound {cb_ms:.5f} ms (bytes; the chain of {hop} steps is not counted)")

    # AGC, ring mode: the whole push against ring_push_plain, at the main
    # path's shapes with a NaN, an Inf, a -Inf and a silent row, then ragged
    # shapes, a chunk longer than the kernel's tile, unaligned buffer rows and
    # the empty batch
    def random_ring(b, length):
        return RingState(buffer=torch.randn((b, length), generator=gen, device=dev) * 0.1,
                         gain=torch.rand(b, generator=gen, device=dev) * 2.0 + 0.1)

    length = params.n_fft
    ring = random_ring(B, length)
    ring_chunk = chunk.clone()
    ring_chunk[3, 100] = float("nan")
    ring_chunk[4, 0] = float("inf")
    ring_chunk[6, hop - 1] = float("-inf")
    ring_chunk[7] = 0.0
    n_bad = 3
    agc_err = max(agc_err, push_against_plain(torch, f"B={B}, L={length}, T={hop} (NaN, Inf, -Inf, silent rows)",
                                              ring, ring_chunk))
    small = random_ring(5, 1003)
    small_chunk = synthetic_audio(torch, 5, 1003, sr, gen)
    small_chunk[1, 5] = float("nan")
    small_chunk[2] = 0.0
    for t in (hop, 1003, 1, 4, 0):
        push_against_plain(torch, f"B=5, L=1003, T={t}", small, small_chunk[:, :t])
    wide = torch.zeros((5, 1003 + 3), device=dev)
    wide[:, 1 : 1 + 1003] = small.buffer
    push_against_plain(torch, "B=5, L=1003, T=367, buffer rows off 16-byte alignment (base and stride)",
                       RingState(buffer=wide[:, 1 : 1 + 1003], gain=small.gain), small_chunk[:, :hop])
    long_ring = random_ring(3, 5000)
    long_chunk = synthetic_audio(torch, 3, 5000, sr, gen)
    for t in (4500, 5000):
        push_against_plain(torch, f"B=3, L=5000, T={t}", long_ring, long_chunk[:, :t])
    before = agc_mod.launches
    empty = ring_push(RingState(buffer=ring.buffer[:0], gain=ring.gain[:0]), ring_chunk[:0])
    check(tuple(empty.buffer.shape) == (0, length) and agc_mod.launches == before,
          "an empty batch must return an empty ring without a launch")
    print("ring push on the empty batch: empty ring, no launch")

    ms = time_ms(torch, lambda: ring_push(ring, ring_chunk))
    _, card_ms = device_trace(torch, lambda: ring_push(ring, ring_chunk), "ring_push_kernel", inner=20)
    plain_ms = time_ms(torch, lambda: ring_push_plain(ring, ring_chunk))
    buf = ring.buffer
    lib_ms = time_ms(torch, lambda: torch.empty_like(buf)[:, : length - hop].copy_(buf[:, hop:]))
    # what the push cannot avoid: read each kept row's buffer[T:L] (a rejected
    # row's whole buffer), the chunk and the gain once, write the new buffer and
    # gain once; the recurrence's 8 operations a sample at the FFMA rate
    moved = ((B - n_bad) * (length - hop) + n_bad * length + B * hop + B) * 4 + (B * length + B) * 4
    b_ms, b_by = bound_ms(moved, 8.0 * (B - n_bad) * hop, F32_FLOPS)
    print(f"ring push: {ms:.4f} ms a call, {card_ms:.4f} ms on the card alone, plain (ring_push_plain) "
          f"{plain_ms:.4f} ms, copy_ of buffer[:, T:] {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {moved / 1e6:.1f} MB)")
    kernels["agc"] = dict(
        name="agc", route="cuda", source="pitchvis_tpu_torch/csrc/agc.cu",
        replaces="pitchvis_tpu/ops/agc.py:62", fuses="pitchvis_tpu/stream/ring.py:55-62",
        max_abs_err=agc_err, ms=ms, card_ms=card_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, chunk_ms=chunk_ms, chunk_card_ms=chunk_card_ms, chunk_plain_ms=chunk_plain_ms,
        chunk_bound_ms=cb_ms,
    )
    del ring, ring_chunk, buf, small, wide, long_ring, long_chunk
    del frames, spectra, walk, chains, cases
    torch.cuda.empty_cache()

    # ---- 3. the main path ----------------------------------------------------
    dt = hop / sr
    audio = synthetic_audio(torch, B, (MAIN_HOPS + F32_HOPS) * hop, sr, gen)
    audio[7] = 0.0  # one silent stream: its gain must stay frozen at 1
    audio[5, 3 * hop + 11] = float("nan")  # one NaN chunk: stream 5, hop 3

    def drive(pipe, first_hop, n_hops, label):
        reset_counts()
        hop_ms = []
        outs = None
        for h in range(first_hop, first_hop + n_hops):
            chunk = audio[:, h * hop : (h + 1) * hop]
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs = pipe.step(chunk, dt)
            torch.cuda.synchronize()
            hop_ms.append((time.perf_counter() - t) * 1e3)
            for leaf in (outs.x_vqt, outs.gain, outs.analysis.x_vqt_smoothed, outs.analysis.calmness,
                         outs.analysis.peak_size, outs.analysis.scene_calmness, outs.analysis.tuning_inaccuracy):
                check(bool(torch.isfinite(leaf).all()), f"{label}: non-finite output at hop {h}")
        c = counts()
        steady = float(np.median(hop_ms[1:])) if n_hops > 1 else hop_ms[0]
        print(f"{label}: {n_hops} hops at B={B}, hop ms first {hop_ms[0]:.2f}, median after {steady:.3f} "
              f"(min {min(hop_ms[1:] or hop_ms):.3f}, max {max(hop_ms[1:] or hop_ms):.3f}), aggregate realtime {B * dt * 1e3 / steady:.1f}x, launches {c}")
        want = {"vqt": n_hops, "peaks": 2 * n_hops, "agc": n_hops}
        check(c == want, f"{label}: launches {c}, expected {want}")
        return outs, c, steady

    torch.cuda.reset_peak_memory_stats()
    pipe = StreamingPipeline(B, params, path="pallas", fast=True, device=dev)
    outs, main_counts, main_ms = drive(pipe, 0, MAIN_HOPS, "main path (bf16)")
    check(float(pipe.state.ring.gain[7]) == 1.0, "silent stream's gain moved")
    check(int(outs.analysis.peaks.sum()) > 0, "main path found no peaks")
    print(f"main path: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{float(outs.analysis.peaks.float().sum(1).mean()):.1f} peaks per stream")

    # where the hop's time goes, by stage (CUDA events; not counted as the path)
    stage = {"ring_push (agc)": [], "vqt + dB": [], "analysis (peaks x2)": []}
    state = pipe.state
    for h in range(4):
        chunk = audio[:, (MAIN_HOPS + h) * hop : (MAIN_HOPS + h + 1) * hop]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        ring = ring_push(state.ring, chunk, pipe.agc_params)
        ev[1].record()
        x_vqt = vqt_mod.vqt_db_pallas(pipe.arrays, ring_window(ring, params.n_fft))
        ev[2].record()
        analysis_mod.analysis_step_batch(pipe.analysis_params, params.range, state.analysis, x_vqt, dt)
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(stage):
            stage[key].append(ev[i].elapsed_time(ev[i + 1]))
    print("stage ms (median of 4 hops): " + json.dumps({k: round(float(np.median(v)), 4) for k, v in stage.items()}))
    # one ring push on the card: its device ops (the fullest of three traces)
    # and the host's time to enqueue it
    push_ops, push_card_ms = max(device_trace(torch, lambda: ring_push(state.ring, chunk, pipe.agc_params))
                                 for _ in range(3))
    push_enqueue_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ring_push(state.ring, chunk, pipe.agc_params)
        push_enqueue_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    print(f"ring push: {push_ops} device op(s), {push_card_ms:.4f} ms on the card, "
          f"{float(np.median(push_enqueue_ms)):.4f} ms for the host to enqueue it (median of 5)")
    check(push_ops == 1, f"the ring push launched {push_ops} device ops, expected 1")
    # its plain version op by op: the eager ops around the chunk mode
    plain_ops = []
    _, plain_card_ms = device_trace(torch, lambda: ring_push_plain(state.ring, chunk, pipe.agc_params), ops=plain_ops)
    print(f"ring_push_plain: {len(plain_ops)} device ops, {plain_card_ms:.4f} ms on the card: "
          + "; ".join(f"{n} {ms:.4f}" for n, ms in plain_ops))
    # neither the ring push nor the analysis stage may wait for the card:
    # under this mode any synchronising call raises, which ends the run
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ring_push(state.ring, chunk, pipe.agc_params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print('ring push at B=2048 under set_sync_debug_mode("error"): no host synchronisation')

    def analysis_step():
        return analysis_mod.analysis_step_batch(pipe.analysis_params, params.range, state.analysis, x_vqt, dt)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        analysis_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print('analysis step at B=2048 under set_sync_debug_mode("error"): no host synchronisation')
    # host and card shares of the stage: the host's time to enqueue a step,
    # the step's time to its end, and the card's busy time in it
    enqueue_ms, wall_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        analysis_step()
        enqueue_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t) * 1e3)
    # the profiler now and then loses events: of three traced steps, the fullest
    step_launches, step_device_ms = max(device_trace(torch, analysis_step) for _ in range(3))
    analysis_profile = dict(
        launches=step_launches, device_ms=step_device_ms,
        enqueue_ms=float(np.median(enqueue_ms)), wall_ms=float(np.median(wall_ms)),
    )
    print(f"analysis step: {json.dumps(analysis_profile)} (launches and device ms from the profiler, "
          f"one step; enqueue and wall ms by the host clock, median of 5, not under the profiler): "
          f"the card is busy {100 * step_device_ms / analysis_profile['wall_ms']:.1f}% of the step")
    del pipe, outs, state, ring, x_vqt
    torch.cuda.empty_cache()

    pipe = StreamingPipeline(B, params, path="pallas", fast=False, device=dev)
    _, f32_counts, _ = drive(pipe, 0, F32_HOPS, "f32 path")
    del pipe
    torch.cuda.empty_cache()
    kernels["vqt_power_bf16"]["launches"] = main_counts["vqt"]
    kernels["vqt_power_f32"]["launches"] = f32_counts["vqt"]
    kernels["peaks"]["launches"] = main_counts["peaks"]
    kernels["agc"]["launches"] = main_counts["agc"]

    # ---- 4. streaming golden ---------------------------------------------------
    with np.load(os.path.join(ROOT, "tests", "golden", "streaming_golden.npz")) as z:
        sig, g_hop, want_spectra, want_gains = z["signal"], int(z["hop"]), z["spectra"], z["gains"]
    reset_counts()
    pipe = StreamingPipeline(1, params, path="pallas", fast=False, device=dev)
    spectra, gains = [], []
    n_hops = len(sig) // g_hop
    for i in range(n_hops):
        out = pipe.step(sig[None, i * g_hop : (i + 1) * g_hop], g_hop / params.sr)
        spectra.append(out.x_vqt[0])
        gains.append(out.gain[0])
    spectra = torch.stack(spectra).cpu().numpy()
    gains = torch.stack(gains).cpu().numpy()
    err_s = float(np.abs(spectra - want_spectra).max())
    err_g = float(np.abs(gains / want_gains - 1).max())
    print(f"streaming golden: {n_hops} hops, max |dB| {err_s:.3e} (tol 1e-3), max gain rel err {err_g:.3e} "
          f"(tol 1e-4), launches {counts()}")
    check(err_s <= 1e-3 and err_g <= 1e-4, "streaming golden replay out of tolerance")
    check(counts() == {"vqt": n_hops, "peaks": 2 * n_hops, "agc": n_hops}, "golden replay skipped a kernel")

    # ---- 5. the serving runtime ----------------------------------------------
    server_counts = serving_phase(torch, params, counts, reset_counts)

    # ---- 6. the output stages --------------------------------------------------
    stage_counts, stage_numbers = output_stages_phase(torch, params, counts, reset_counts, gen)

    # ---- 7. the ML stage and its trainer -----------------------------------------
    # under torch's default cudnn flags (TF32 allowed), which the top of this
    # function turned off: the card-vs-CPU checks then see what the ML stage
    # and the trainer do in a caller's process
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True):
        ml_counts, ml_numbers = ml_phase(torch, counts, reset_counts, gen)

    # ---- 8. the rasterizer --------------------------------------------------------
    render_counts, kernels["composite"], render_numbers = render_phase(torch, params, counts, reset_counts, gen)
    for label, key in (("vqt_power_bf16", "vqt"), ("vqt_power_f32", "vqt"), ("peaks", "peaks"), ("agc", "agc")):
        by_path = {"pipeline": kernels[label]["launches"],
                   "server": server_counts[key] if label != "vqt_power_f32" else 0,
                   "output_stages": stage_counts[key] if label != "vqt_power_f32" else 0,
                   "ml": ml_counts[key] if label != "vqt_power_f32" else 0,
                   "render": render_counts[key] if label != "vqt_power_f32" else 0}
        kernels[label]["launches_by_path"] = by_path
        kernels[label]["launches"] = sum(by_path.values())

    # ---- 9. the training-data path -----------------------------------------------
    kernels["agc_signal"], dataset_numbers = dataset_phase(torch, counts, reset_counts)

    # ---- 10. the command line ------------------------------------------------------
    cli_counts, cli_numbers = cli_phase(torch, counts, reset_counts, gen)
    for label in ("vqt_power_bf16", "vqt_power_f32", "peaks", "agc", "composite"):
        kernels[label]["launches_by_path"]["cli"] = cli_counts[label]
        kernels[label]["launches"] = sum(kernels[label]["launches_by_path"].values())

    # ---- 11. the bench --------------------------------------------------------------
    bench_counts, bench_numbers = bench_phase(torch, counts, reset_counts)
    order = ("vqt_power_bf16", "vqt_power_f32", "peaks", "agc", "composite", "agc_signal")
    for label in order:
        kernels[label]["launches_by_path"]["bench"] = bench_counts[label]
        kernels[label]["launches"] = sum(kernels[label]["launches_by_path"].values())

    print(json.dumps({"vqt_times": vqt_times}))
    print(json.dumps({"analysis_step": analysis_profile}))
    print(json.dumps({"output_stages": stage_numbers}))
    print(json.dumps({"ml_stage": ml_numbers}))
    print(json.dumps({"render": render_numbers}))
    print(json.dumps({"dataset": dataset_numbers}))
    print(json.dumps({"cli": cli_numbers}))
    print(json.dumps({"bench": bench_numbers}))
    print(json.dumps({"kernels": [kernels[n] for n in order]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
