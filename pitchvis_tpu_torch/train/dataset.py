"""Training dataset generation: MIDI -> rendered audio -> batched VQT labels.

Port of ``pitchvis_tpu/train/dataset.py`` (itself a port of
pitchvis_train/src/train.rs:112-351): synthesis and AGC/ring-buffer
bookkeeping run on the host in native C++ (the reference renders with
rustysynth on rayon threads), while the VQT of all captured frames of a MIDI
file is one batched call on the device instead of one CPU mat-vec per frame.
The VQT is the port's ``Vqt(params)``, the ``time`` path in float32
(``torch.matmul`` with TF32 off), as the JAX package's default ``Vqt`` is.

Pipeline per MIDI file (train.rs:252-351):
  * render in chunks of vqt_delay samples (rounded down to a multiple of 64)
  * downmix to mono, freeze AGC on silent chunks (energy < 1e-6), AGC the
    ring buffer tail
  * every 3rd chunk: snapshot active voices (key -> (l+r)/2 * agc_gain, max
    per key) and the trailing n_fft window
  * emit rows of (n_buckets VQT dB values + 128 MIDI targets), where targets
    are 1.0 where the *previous* snapshot's attack > 0.5 (train.rs:443-460)

The native libraries (runtime/native.py) are built at first use; there is
no pure-Python fallback, so a failed build raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import TRAIN_VQT_PARAMETERS, VqtParameters
from ..models.pitch_mlp import N_MIDI
from ..ops.vqt import Vqt
from ..synth.midi import MidiFile, load_midi
from ..synth.synthesizer import MidiFileSequencer, make_synthesizer

FREQ_A1_MIDI_KEY_ID = 33  # train.rs:34
STEP_SIZE_IN_CHUNKS = 3  # train.rs:43
BUFSIZE_FACTOR = 2  # BUFSIZE = 2 * SR (train.rs:31)


class _HostAgc:
    """Literal dagc recurrence on the host, in the native library
    (runtime/native.py::agc_process)."""

    def __init__(self, desired_rms: float = 0.07, distortion: float = 0.001):
        from ..runtime import native

        native.load()  # raises here, not mid-file, if the library cannot be built
        self._native = native
        self.desired_rms = desired_rms
        self.k = distortion
        self.gain = 1.0
        self.frozen = False

    def freeze_gain(self, frozen: bool) -> None:
        self.frozen = frozen

    def process(self, samples: np.ndarray) -> None:
        self.gain = self._native.agc_process(self.gain, samples, self.desired_rms, self.k, self.frozen)


def _chunk_samples(vqt: Vqt, sr: int) -> int:
    """Render-chunk size: the VQT delay in ms, floored to the 64-sample
    block grid (train.rs:243-247)."""
    delay_samples = int(vqt.delay_secs * 1000.0) * sr // 1000
    delay_samples = (delay_samples // 64) * 64
    if delay_samples == 0:
        raise ValueError("vqt delay too small")
    return delay_samples


def annotate_midi(
    midi: MidiFile,
    vqt: Vqt,
    params: VqtParameters = TRAIN_VQT_PARAMETERS,
    step_size_in_chunks: int = STEP_SIZE_IN_CHUNKS,
    max_seconds: float | None = None,
    sound_font=None,
) -> list[tuple[dict[int, float], np.ndarray]]:
    """Renders one MIDI file and captures (active_keys, vqt_frame) pairs
    (train.rs:252-351). The VQT of all captured windows runs as ONE batched
    device call. `sound_font` (synth/sf2.py SoundFont) switches the
    synthesizer to SF2 sample playback like the reference's
    MuseScore_General.sf2 (train.rs:139-140), rendered with the whole
    render->AGC->snapshot loop in one native call
    (native/synth_engine.cpp pv_train_synthesize)."""
    sr = int(params.sr)
    delay_samples = _chunk_samples(vqt, sr)
    bufsize = BUFSIZE_FACTOR * sr

    if sound_font is not None:
        from ..synth.engine_native import synthesize_labeled

        stream, labels = synthesize_labeled(
            sound_font, midi, sample_rate=sr, chunk=delay_samples,
            step_chunks=step_size_in_chunks, max_seconds=max_seconds,
        )
        if not labels:
            return []
        specs = _stream_specs_device(vqt, stream, len(labels), delay_samples, step_size_in_chunks)
        return list(zip(labels, specs))

    synth = make_synthesizer(sr, sound_font=sound_font)
    seq = MidiFileSequencer(synth)
    seq.play(midi)
    agc = _HostAgc(0.07, 0.001)

    length = midi.get_length()
    if max_seconds is not None:
        length = min(length, max_seconds)
    sample_count = int(sr * length)

    ring = np.zeros(bufsize, np.float32)
    left = np.zeros(delay_samples, np.float32)
    right = np.zeros(delay_samples, np.float32)

    key_snapshots: list[dict[int, float]] = []
    windows: list[np.ndarray] = []
    written = 0
    chunk_count = 0
    prev_active: dict[int, float] = {}
    active: dict[int, float] = {}
    while written < sample_count:
        chunk_count += 1
        seq.render(left, right)
        written += len(left)

        mono = (left + right) / 2.0
        agc.freeze_gain(float(np.sum(mono**2)) < 1e-6)
        ring = np.concatenate([ring[len(mono) :], mono])
        tail = ring[-len(mono) :].copy()
        agc.process(tail)
        ring[-len(mono) :] = tail

        if chunk_count % step_size_in_chunks != 0:
            continue

        prev_active = active
        active = {}
        for voice in synth.get_active_voices():
            gain = (voice.current_mix_gain_left + voice.current_mix_gain_right) / 2.0 * agc.gain
            if gain > active.get(voice.key, -1.0):
                active[voice.key] = gain

        key_snapshots.append(prev_active)
        windows.append(ring[-params.n_fft :].copy())

    if not windows:
        return []
    return list(zip(key_snapshots, _batched_specs(vqt, np.stack(windows))))


def _slice_windows(stream: torch.Tensor, *, stride: int, n_caps: int, n_fft: int) -> torch.Tensor:
    """Capture windows of an AGC'd (N,) stream, on its device: window c is
    the n_fft samples ending at (c+1)*stride, left-padded with the ring
    buffer's initial zeros. (n_caps, n_fft), a strided view of the padded
    stream: no gather, and the stream crosses to the device once."""
    need = n_fft + n_caps * stride
    padded = torch.zeros(need, dtype=torch.float32, device=stream.device)
    take = min(stream.shape[0], need - n_fft)
    padded[n_fft : n_fft + take] = stream[:take]
    return padded.unfold(0, n_fft, stride)[1 : n_caps + 1]


def _stream_specs_device(
    vqt: Vqt, stream: np.ndarray, n_caps: int, chunk: int, step: int
) -> np.ndarray:
    """VQT spectra of every capture window of a host stream, slicing the
    windows on the device from the (much smaller) stream."""
    stream_t = torch.from_numpy(np.ascontiguousarray(stream, np.float32)).to(vqt.device)
    windows = _slice_windows(stream_t, stride=step * chunk, n_caps=n_caps, n_fft=vqt.params.n_fft)
    return _batched_specs(vqt, windows)


def _batched_specs(vqt: Vqt, stack) -> np.ndarray:
    """All captured windows through the VQT as one device call, back on the
    host. (The JAX package pads the batch to a power of two so that its
    compiled executable is reused; eager PyTorch compiles nothing.)"""
    return vqt.calculate_vqt_batch_in_db(stack).cpu().numpy()


def generate_data_row(
    active_keys: dict[int, float], x_vqt: np.ndarray, n_buckets: int
) -> np.ndarray:
    """One flat (n_buckets + 128) row: VQT dB + binary attack targets
    (train.rs:443-460)."""
    if len(x_vqt) != n_buckets:
        # a wrong-width spectrum would silently produce misaligned flat
        # rows that window_data later reshapes into garbage
        raise ValueError(f"x_vqt has {len(x_vqt)} bins, expected {n_buckets}")
    targets = np.zeros(N_MIDI, np.float32)
    for key, attack in active_keys.items():
        if 0 <= key < N_MIDI:
            targets[key] = 1.0 if attack > 0.5 else 0.0
    return np.concatenate([np.asarray(x_vqt, np.float32), targets])


def generate_dataset(
    midi_paths: list[str],
    params: VqtParameters = TRAIN_VQT_PARAMETERS,
    out_path: str | None = None,
    max_seconds_per_file: float | None = None,
    sound_font_path: str | None = None,
    n_workers: int = 1,
    device="cuda",
) -> np.ndarray:
    """Full dataset over a MIDI corpus (train.rs:112-207). Returns (and
    optionally saves as .npy) the flat f32 array in the reference's data.npy
    layout. The VQT runs on ``device`` (the card unless ``device="cpu"``).

    ``n_workers > 1`` with a sound font parallelizes the host-side
    render->AGC->snapshot loop over MIDI files on a thread pool, the
    structure of the reference's rayon par_iter over files with per-thread
    synthesizer instances (train.rs:146-153). The native C++ loop
    (pv_train_synthesize) releases the GIL for its whole duration, so
    threads scale near-linearly; the batched device VQT calls stay on the
    calling thread. Without a font (the additive synthesizer, whose voice
    loop is short native calls between Python) it runs the serial loop. Row
    order matches the serial path (corpus order) regardless of completion
    order."""
    vqt = Vqt(params, device=device)
    sound_font = None
    if sound_font_path:
        from ..synth.sf2 import SoundFont

        sound_font = SoundFont.from_file(sound_font_path)

    if n_workers > 1 and sound_font is not None:
        return _generate_dataset_parallel(
            midi_paths, vqt, params, out_path, max_seconds_per_file, sound_font, n_workers,
        )

    rows: list[np.ndarray] = []
    for p in midi_paths:
        try:
            midi = load_midi(p)
        except Exception as e:  # mirrors the reference's per-file tolerance
            print(f"failed to parse midi file {p}: {e}")
            continue
        annotated = annotate_midi(
            midi, vqt, params, max_seconds=max_seconds_per_file, sound_font=sound_font
        )
        for active, spec in annotated:
            rows.append(generate_data_row(active, spec, params.n_buckets))
    data = np.concatenate(rows) if rows else np.zeros(0, np.float32)
    if out_path:
        np.save(out_path, data)
    return data


def _generate_dataset_parallel(
    midi_paths: list[str],
    vqt: Vqt,
    params: VqtParameters,
    out_path: str | None,
    max_seconds_per_file: float | None,
    sound_font,
    n_workers: int,
) -> np.ndarray:
    """Thread-pool corpus generation (see generate_dataset). Each worker owns
    its own native synthesizer+sequencer per file (created inside
    synthesize_labeled); the device VQT runs from this thread only."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..synth.engine_native import synthesize_labeled

    sr = int(params.sr)
    chunk = _chunk_samples(vqt, sr)

    def host_work(path: str):
        try:
            midi = load_midi(path)
        except Exception as e:  # per-file tolerance, as in the serial loop
            print(f"failed to parse midi file {path}: {e}")
            return None
        return synthesize_labeled(
            sound_font, midi, sample_rate=sr, chunk=chunk,
            step_chunks=STEP_SIZE_IN_CHUNKS, max_seconds=max_seconds_per_file,
        )

    rows: list[np.ndarray] = []
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        # bounded in-flight window (n_workers + 1 ahead): consuming in
        # submission order keeps row order deterministic, and the window
        # caps buffered rendered streams (each is a whole file of f32
        # audio) at O(n_workers) instead of O(corpus) when the head file
        # or the serialized device VQT lags
        pending: deque = deque()
        it = iter(midi_paths)

        def top_up():
            while len(pending) <= n_workers:
                p = next(it, None)
                if p is None:
                    return
                pending.append(pool.submit(host_work, p))

        top_up()
        while pending:
            res = pending.popleft().result()
            top_up()
            if res is None:
                continue
            stream, labels = res
            if not labels:
                continue
            specs = _stream_specs_device(vqt, stream, len(labels), chunk, STEP_SIZE_IN_CHUNKS)
            for active, spec in zip(labels, specs):
                rows.append(generate_data_row(active, spec, params.n_buckets))
    data = np.concatenate(rows) if rows else np.zeros(0, np.float32)
    if out_path:
        np.save(out_path, data)
    return data


def center_vqt_samples(
    active_keys: dict[int, float],
    vqt_transform: np.ndarray,
    buckets_per_semitone: int,
    octaves: int,
) -> tuple[list[tuple[np.ndarray, float]], list[tuple[np.ndarray, float]]]:
    """Key-centered positive/negative sample augmentation
    (train.rs:366-441): positives center the active key with 40 semitones
    below / 46 above in an 87-semitone window; negatives shift by
    +-{3..9,12,19,24} semitones when no other active key is within 2."""
    shifts = [-24, -19, -12, -9, -8, -7, -6, -5, -4, -3, 3, 4, 5, 6, 7, 8, 9, 12, 19, 24]
    positives: list[tuple[np.ndarray, float]] = []
    negatives: list[tuple[np.ndarray, float]] = []
    width = 87 * buckets_per_semitone

    def boundaries(key_index: int):
        start = max(key_index - 40 * buckets_per_semitone, 0)
        start_overshoot = max(40 * buckets_per_semitone - key_index, 0)
        end = min(key_index + 46 * buckets_per_semitone, len(vqt_transform))
        end_overshoot = max(key_index + 46 * buckets_per_semitone - len(vqt_transform), 0)
        return start, start_overshoot, end, end_overshoot

    def spliced(key_index: int) -> np.ndarray:
        # Rust Vec::splice replaces range [so, width - eo) with the slice and
        # the vector length changes when the lengths differ (train.rs:399-403)
        start, so, end, eo = boundaries(key_index)
        zeros = np.zeros(width, np.float32)
        return np.concatenate(
            [zeros[:so], vqt_transform[start:end], zeros[width - eo :]]
        ).astype(np.float32)

    for key, attack in active_keys.items():
        if key < FREQ_A1_MIDI_KEY_ID or key >= FREQ_A1_MIDI_KEY_ID + octaves * 12:
            continue
        key_index = (key - FREQ_A1_MIDI_KEY_ID) * buckets_per_semitone
        positives.append((spliced(key_index), attack))

        for shift in shifts:
            shifted_key = key + shift
            if shifted_key < FREQ_A1_MIDI_KEY_ID or shifted_key >= FREQ_A1_MIDI_KEY_ID + octaves * 12:
                continue
            if all(abs(other - shifted_key) >= 2 for other in active_keys):
                ki = (shifted_key - FREQ_A1_MIDI_KEY_ID) * buckets_per_semitone
                negatives.append((spliced(ki), attack))

    return positives, negatives
