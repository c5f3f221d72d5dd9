"""Golden-file tooling.

Port of ``pitchvis_tpu/io/golden.py``. Generates and checks golden VQT
spectra: fixed synthetic signals (sine mixtures, chirps, noise bursts —
deterministic seeds) are run through the float64 NumPy oracle
(`ops/vqt_ref.py`, the literal port of the reference semantics) and stored
as .npz. The signal generators are NumPy (the chain's synth clip through the
port's f64 engine, synth/), so they equal the JAX package's bit for bit; the
stateful chain (:func:`run_chain`) runs the port's StreamingPipeline on
``device``, the card unless ``device="cpu"``. :func:`render_scene_inputs`
builds the scene of ``tests/golden/render_golden.npz``.

The writers write where they are told; the committed goldens
(``tests/golden/*.npz``) are the JAX package's, which the port's tests
replay. Write new ones elsewhere:

    python -m pitchvis_tpu_torch.io.golden OUT_DIR [frame|streaming|chain|viewer|render|all] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.config import SERIAL_VQT_PARAMETERS, VqtParameters, VqtRange
from ..core.device import resolve_device
from ..kernel.builder import get_kernel
from ..models.render import DebugInputs, RenderConfig
from ..models.viewer import BallState, bass_spiral, update_balls
from ..ops.vqt_ref import vqt_frame_db_np

GOLDEN_PARAMS = VqtParameters(
    sr=22050.0,
    n_fft=8192,
    range=VqtRange(min_freq=110.0, octaves=4, buckets_per_octave=24),
    sparsity_quantile=0.999,
    quality=1.6,
    gamma=4.8 * 1.6,
)


def golden_signals(params: VqtParameters) -> dict[str, np.ndarray]:
    """Deterministic test signals covering tones, chords, chirps, noise."""
    n = params.n_fft
    sr = params.sr
    t = np.arange(n) / sr
    rng = np.random.default_rng(1234)

    sigs = {
        "tone_a3": np.sin(2 * np.pi * 220.0 * t) / 12.0,
        "chord_a_major": (
            np.sin(2 * np.pi * 220.0 * t)
            + np.sin(2 * np.pi * 277.18 * t)
            + np.sin(2 * np.pi * 329.63 * t)
        )
        / 12.0,
        "detuned_pair": (
            np.sin(2 * np.pi * 440.0 * t) + np.sin(2 * np.pi * 452.0 * t)
        )
        / 12.0,
        "chirp": np.sin(2 * np.pi * (150.0 * t + 400.0 * t * t)) / 12.0,
        "noise": rng.standard_normal(n) * 0.02,
        "tone_plus_noise": np.sin(2 * np.pi * 523.25 * t) / 12.0
        + rng.standard_normal(n) * 0.005,
        "silence": np.zeros(n),
        "impulse": np.eye(1, n, n // 2)[0] * 0.5,
    }
    return {k: v.astype(np.float32) for k, v in sigs.items()}


def generate(out_dir: str, params: VqtParameters = GOLDEN_PARAMS,
             filename: str = "vqt_golden.npz") -> str:
    kernel = get_kernel(params)
    sigs = golden_signals(params)
    blobs = {}
    for name, x in sigs.items():
        blobs[f"in_{name}"] = x
        blobs[f"out_{name}"] = vqt_frame_db_np(kernel, x)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez_compressed(path, **blobs)
    return path


def streaming_signal(params: VqtParameters, seconds: float = 1.5) -> np.ndarray:
    """Deterministic streaming test signal: A-major arpeggio with onsets and
    a noise floor (exercises AGC gain motion and EMA state)."""
    sr = params.sr
    n = int(sr * seconds)
    t = np.arange(n) / sr
    rng = np.random.default_rng(42)
    sig = rng.standard_normal(n) * 0.002
    for i, f in enumerate([220.0, 277.18, 329.63, 440.0]):
        start = int(i * 0.3 * sr)
        if start >= n:  # short signals: skip notes past the end
            continue
        seg = slice(start, n)
        tt = t[seg] - start / sr
        sig[seg] += np.sin(2 * np.pi * f * tt) * 0.1 * np.exp(-tt * 1.5)
    return sig.astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def generate_streaming(out_dir: str, params: VqtParameters | None = None,
                       filename: str = "streaming_golden.npz", hop_hz: float = 60.0,
                       seconds: float = 1.5, device="cuda") -> str:
    """Streaming golden: a fixed signal through ring+AGC+VQT at 60 Hz hops
    (the serving pipeline's stateful path), storing every hop's spectrum.
    A kernel or dB-semantics or AGC regression shifts these spectra."""
    from ..models.pipeline import StreamingPipeline

    params = params or VqtParameters()
    sig = streaming_signal(params, seconds)
    hop = int(params.sr / hop_hz)
    pipe = StreamingPipeline(1, params, device=device)
    spectra = []
    gains = []
    for i in range(len(sig) // hop):
        out = pipe.step(sig[None, i * hop : (i + 1) * hop], hop / params.sr)
        spectra.append(_np(out.x_vqt[0]))
        gains.append(float(out.gain[0]))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez_compressed(
        path, signal=sig, hop=hop, spectra=np.stack(spectra), gains=np.asarray(gains)
    )
    return path


def chain_signals(params: VqtParameters, seconds: float = 10.0, with_synth: bool = True) -> dict[str, np.ndarray]:
    """Deterministic 10 s signals for the FULL-chain golden — tones sweeping
    the serial range, a chirp, and the SF2 engine's own render (so the golden
    also witnesses the synth as a signal source, like the reference's
    train-data path feeds rendered audio into the VQT). ``with_synth=False``
    leaves out the synth clip (the f64 engine renders about one second of
    audio a second), for long signals of the other three."""
    sr = params.sr
    n = int(sr * seconds)
    t = np.arange(n) / sr
    rng = np.random.default_rng(2024)

    # 1) arpeggio over the full serial range (A1 55 Hz .. A6 1760 Hz)
    arp = rng.standard_normal(n) * 0.002
    freqs = [55.0 * 2 ** (k / 3.0) for k in range(15)]  # 15 notes, 0.6 s apart
    for i, f in enumerate(freqs):
        start = int(i * 0.62 * sr)
        if start >= n:
            continue
        tt = t[start:] - start / sr
        arp[start:] += np.sin(2 * np.pi * f * tt) * 0.12 * np.exp(-tt * 1.2)

    # 2) slow exponential chirp 60 -> 1500 Hz (phase-continuous)
    f0, f1 = 60.0, 1500.0
    k = np.log(f1 / f0) / seconds
    phase = 2 * np.pi * f0 * (np.exp(k * t) - 1.0) / k
    chirp = np.sin(phase) * 0.1

    # 3) chord + releases: held A-major with onsets/offsets (EMA + calmness motion)
    chord = rng.standard_normal(n) * 0.001
    for j, f in enumerate([110.0, 138.59, 164.81, 220.0, 440.0]):
        on = int(j * 0.8 * sr)
        off = int(min(seconds - 0.5, j * 0.8 + 4.0) * sr)
        tt = t[on:off] - on / sr
        chord[on:off] += np.sin(2 * np.pi * f * tt) * 0.08 * np.minimum(tt * 8, 1.0)

    sigs = {"arpeggio": arp, "chirp": chirp, "chord": chord}
    if with_synth:
        # 4) the synth engine's own output (deterministic NumPy f64 render)
        sigs["synth"] = _chain_synth_signal(seconds, sr=int(sr))[:n]
    return {k: v.astype(np.float32) for k, v in sigs.items()}


def _chain_synth_signal(seconds: float, sr: int = 22050) -> np.ndarray:
    """Render a fixed two-channel MIDI clip with the f64/NumPy engine
    (synth/engine.py) from a procedurally written SF2 — fully code-defined,
    so the golden has no binary inputs. Rendered at ``sr`` (the chain
    params' rate — a fixed 22050 would come out truncated and an octave
    off under any other rate)."""
    import tempfile

    from ..synth.engine import MidiFileSequencer, Synthesizer, SynthesizerSettings
    from ..synth.midi import load_midi, write_midi
    from ..synth.sf2 import SoundFont, write_minimal_sf2
    with tempfile.TemporaryDirectory() as d:
        t = np.arange(400)
        wave = 0.7 * np.sin(2 * np.pi * t / 50) + 0.2 * np.sin(4 * np.pi * t / 50)
        write_minimal_sf2(os.path.join(d, "g.sf2"), wave, sr, root_key=69, loop=True)
        font = SoundFont.from_file(os.path.join(d, "g.sf2"))
        notes = []
        for i in range(int(seconds / 0.6) - 1):
            notes.append((i * 0.6, 0.5, 0, 45 + (i * 5) % 36, 80 + (i * 7) % 40))
            if i % 2 == 0:
                notes.append((i * 0.6 + 0.1, 0.8, 1, 33 + (i * 4) % 24, 100))
        write_midi(os.path.join(d, "g.mid"), notes)
        synth = Synthesizer(font, SynthesizerSettings(sr, enable_reverb_and_chorus=True))
        seq = MidiFileSequencer(synth)
        seq.play(load_midi(os.path.join(d, "g.mid")))
        n = int(seconds * sr)
        left = np.zeros(n, np.float32)
        right = np.zeros(n, np.float32)
        seq.render(left, right)
    return ((left + right) * 0.5).astype(np.float32)


CHAIN_KEYS = (
    "x_vqt", "peaks", "peak_center", "peak_size", "calmness",
    "scene_calmness", "tuning_inaccuracy", "led",
)
VIEWER_KEYS = (
    "ball_position", "ball_rgba", "ball_scale", "ball_visible",
    "ball_calmness", "ball_pitch_accuracy", "ball_pitch_deviation",
    "chroma", "bloom", "spectrogram_row",
    "bass_visible", "bass_rgba", "hist_heights", "hist_segment_rgb",
)


def run_chain(
    params: VqtParameters,
    sig: np.ndarray,
    *,
    path: str = "time",
    fast: bool = False,
    hop_hz: float = 60.0,
    block: int = 60,
    with_viewer: bool = False,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Run the COMPLETE serving chain (ring+AGC -> VQT -> analysis -> LED)
    over one signal on ``device`` and return per-frame trajectories + the
    exact framed serial byte stream (io/led.py frame_bytes; matches
    pitchvis_serial/src/main.rs:146-174 framing). With ``with_viewer`` the
    fused display stage runs too and every update_display-derived quantity
    (balls, chroma, bloom, spectrogram row, bass spiral, calmness histogram
    — pitchvis_viewer/src/display_system/update.rs) is recorded per frame.
    Hops run ``block`` at a time (StreamingPipeline.step_multi), as in the
    JAX package."""
    from ..models.pipeline import StreamingPipeline
    from .led import frame_bytes

    hop = int(params.sr / hop_hz)
    k_total = len(sig) // hop
    chunks = sig[: k_total * hop].reshape(k_total, 1, hop)
    pipe = StreamingPipeline(
        1, params, path=path, fast=fast, with_led=True, with_viewer=with_viewer, device=device
    )
    rec: dict[str, list] = {k: [] for k in CHAIN_KEYS + (VIEWER_KEYS if with_viewer else ())}
    for i in range(0, k_total, block):
        out = pipe.step_multi(chunks[i : i + block], hop / params.sr)
        a = out.analysis
        leaves = {
            "x_vqt": out.x_vqt, "peaks": a.peaks, "peak_center": a.peak_center,
            "peak_size": a.peak_size, "calmness": a.calmness, "scene_calmness": a.scene_calmness,
            "tuning_inaccuracy": a.tuning_inaccuracy, "led": out.led,
        }
        if with_viewer:
            v = out.viewer
            leaves.update({
                "ball_position": v.balls.position, "ball_rgba": v.balls.rgba,
                "ball_scale": v.balls.scale, "ball_visible": v.balls.visible,
                "ball_calmness": v.balls.calmness, "ball_pitch_accuracy": v.balls.pitch_accuracy,
                "ball_pitch_deviation": v.balls.pitch_deviation, "chroma": v.chroma,
                "bloom": v.bloom, "spectrogram_row": v.spectrogram_row,
                "bass_visible": v.bass.visible, "bass_rgba": v.bass.rgba,
                "hist_heights": v.calmness_histogram.heights,
                "hist_segment_rgb": v.calmness_histogram.segment_rgb,
            })
        for k, leaf in leaves.items():
            rec[k].append(_np(leaf[:, 0]))
    res = {k: np.concatenate(v) for k, v in rec.items()}
    stream = b"".join(frame_bytes(res["led"][k]) for k in range(k_total))
    res["stream"] = np.frombuffer(stream, np.uint8)
    res["hop"] = np.asarray(hop)
    return res


def generate_chain(
    out_dir: str, filename: str = "chain_golden.npz", seconds: float = 10.0, device="cuda"
) -> str:
    """Full-chain golden at the SERIAL parameters (5 oct / 36 bpo / Q=1.8,
    pitchvis_serial/src/main.rs:17-39): per-frame peaks/calmness/tuning/LED
    trajectories and the exact framed byte stream, canonical f32 "time"
    path."""
    params = SERIAL_VQT_PARAMETERS
    blobs: dict[str, np.ndarray] = {}
    for name, sig in chain_signals(params, seconds).items():
        res = run_chain(params, sig, device=device)
        blobs[f"in_{name}"] = sig
        for k, v in res.items():
            blobs[f"{name}_{k}"] = v
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez_compressed(path, **blobs)
    return path


def generate_viewer(
    out_dir: str, filename: str = "viewer_golden.npz", seconds: float = 6.0, device="cuda"
) -> str:
    """Viewer-derived-outputs golden at the serial parameters: per-frame
    trajectories of every display quantity (ball transforms/colors/
    visibility/shader params, chroma, bloom, spectrogram row, bass spiral,
    calmness histogram — update.rs:136-1144) on two deterministic signals.
    Canonical f32 "time" path."""
    params = SERIAL_VQT_PARAMETERS
    sigs = chain_signals(params, seconds)
    blobs: dict[str, np.ndarray] = {}
    for name in ("arpeggio", "chord"):  # ball churn + calmness/bloom motion
        res = run_chain(params, sigs[name], with_viewer=True, device=device)
        blobs[f"in_{name}"] = sigs[name]
        for k, v in res.items():
            blobs[f"{name}_{k}"] = v
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez_compressed(path, **blobs)
    return path


def render_scene_inputs(params: VqtParameters | None = None, device="cuda"):
    """The raster golden's scene: a seeded 3-peak frame pushed through the
    display math (update_balls, bass_spiral) plus seeded Debugging-overlay
    panel data, one stream, on ``device`` (the card unless
    ``device="cpu"``). Returns (cfg, rng_cfg, balls, bass, debug,
    scene_calmness, time), each per-stream leaf with a stream axis of one."""
    device = resolve_device(device)
    params = params or SERIAL_VQT_PARAMETERS
    rng_cfg = params.range
    n = rng_cfg.n_buckets
    cfg = RenderConfig(width=160, height=90, ball_patch=48, max_balls=16)

    r = np.random.default_rng(42)
    peaks = np.zeros(n, bool)
    center = np.arange(n, dtype=np.float32)
    size = np.zeros(n, np.float32)
    for b in (20, 61, 118):
        peaks[b] = True
        center[b] = b + float(r.uniform(-0.4, 0.4))
        size[b] = float(r.uniform(10.0, 25.0))
    calmness = r.uniform(0.0, 1.0, n).astype(np.float32)
    accuracy = r.uniform(0.5, 1.0, n).astype(np.float32)
    deviation = r.uniform(-0.4, 0.4, n).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a)[None]).to(device)

    _, balls = update_balls(
        rng_cfg, BallState.init(1, n, device=device), t(peaks), t(center), t(size), t(calmness), t(accuracy),
        t(deviation), 1.0 / 60.0,
    )
    bass = bass_spiral(rng_cfg, t(peaks), t(center), t(size))
    debug = DebugInputs(
        x_vqt_smoothed=t(r.uniform(0, 30, n).astype(np.float32)),
        peaks=t(peaks),
        peak_center=t(center),
        peak_size=t(size),
        calmness=t(calmness),
        graph_values=t(r.uniform(0, 1, 300).astype(np.float32)),
        spectrogram=t(r.integers(0, 256, (200, n, 4), np.uint8)),
        spectrogram_write_index=t(np.int32(37)),
        chroma=t(r.uniform(0, 1, 12).astype(np.float32)),
    )
    return cfg, rng_cfg, balls, bass, debug, np.float32(0.6), np.float32(1.25)


def generate_render(out_dir: str, filename: str = "render_golden.npz", device="cuda") -> str:
    """Rasterizer golden: the exact uint8 sRGB frames render_frame produces
    for the deterministic scene of ``render_scene_inputs`` — one plain frame
    and one with the Debugging overlay panels."""
    from ..models.render import render_frame

    cfg, rng_cfg, balls, bass, debug, scene_calmness, t = render_scene_inputs(device=device)
    plain = _np(render_frame(cfg, rng_cfg, balls, bass, scene_calmness, t))
    overlay = _np(render_frame(cfg, rng_cfg, balls, bass, scene_calmness, t, debug=debug))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez_compressed(path, plain=plain, overlay=overlay)
    return path


def load(path: str) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Loads a FRAME golden (generate()'s in_/out_ pairs). The streaming
    and chain goldens use different layouts (per-stage trajectory keys) —
    this raises instead of KeyError-ing or silently returning {} on them."""
    out = {}
    with np.load(path) as z:
        names = sorted(
            k[3:] for k in z.files
            if k.startswith("in_") and f"out_{k[3:]}" in z.files
        )
        if not names:
            raise ValueError(
                f"{path} has no in_/out_ frame pairs — not a generate() "
                "golden (streaming/chain goldens are read by their tests "
                "directly from their stage keys)"
            )
        for name in names:
            out[name] = (z[f"in_{name}"], z[f"out_{name}"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="write golden files (see the module docstring)")
    parser.add_argument("out_dir")
    parser.add_argument("kind", nargs="?", default="all",
                        choices=["frame", "streaming", "chain", "viewer", "render", "all"])
    parser.add_argument("--device", default="cuda", help="device of the stateful goldens (default: the card)")
    args = parser.parse_args(argv)
    kinds = ["frame", "streaming", "chain", "viewer", "render"] if args.kind == "all" else [args.kind]
    for kind in kinds:
        if kind == "frame":
            print(generate(args.out_dir))
            print(generate(args.out_dir, VqtParameters(), "vqt_golden_default.npz"))
        elif kind == "streaming":
            print(generate_streaming(args.out_dir, device=args.device))
        elif kind == "chain":
            print(generate_chain(args.out_dir, device=args.device))
        elif kind == "viewer":
            print(generate_viewer(args.out_dir, device=args.device))
        else:
            print(generate_render(args.out_dir, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
