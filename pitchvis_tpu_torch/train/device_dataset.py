"""Training-data generation with the DSP on the card.

Port of ``pitchvis_tpu/train/device_dataset.py``. The host route
(train/dataset.py) mirrors the reference: sequential chunked synthesis + AGC
on the CPU, batched VQT on the device. This module moves the DSP onto the
card as well:

* **Synthesis is stateless in absolute time**: an additive voice's phase is
  2*pi*f*(t - t_on), so the whole signal renders as a batched (notes x
  samples) sin-sum, with no sequential chunk loop and no phase carry. The
  JAX package renders all samples at once (XLA fuses it); eager PyTorch
  would keep several dense (K, T) float32 tensors alive (2.7 GB each at
  K=512 notes, T=1.33 M samples), so :func:`_render_core` renders the time
  axis in blocks. A sample's value depends only on its time, and the sum
  over notes is a fixed pairwise tree, so neither depends on the block.
* **AGC** is the signal mode of the hand-written AGC kernel
  (``ops/agc.py::agc_signal``, ``csrc/agc.cu``): all chunks of a signal in
  one launch, per-chunk silence freeze, the gain carried from chunk to chunk.
  :func:`generate_dataset_device` renders its files one at a time into the
  rows of one zero-padded batch and runs one launch for up to one row an SM
  (:func:`rows_per_launch`) and BATCH_SAMPLES padded samples: a row's chain
  is latency-bound, so rows run side by side at the time of one. The zeros after a file's own chunks freeze and
  change none of its outputs.
* **Windows + VQT + labels**: the capture windows are views of the AGC'd
  signal on the device, their VQT one batched ``Vqt`` call; the labels are
  read on the host from the note table and the per-chunk gains.

Only MIDI parsing, the note schedule and the labels stay on the host. Render
and AGC do not synchronise with the host; a batch reads its gains back once,
a file its spectra.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import TRAIN_VQT_PARAMETERS, AgcParameters, VqtParameters
from ..core.device import resolve_device
from ..ops.agc import agc_signal
from ..ops.vqt import Vqt
from ..synth.midi import MidiFile, load_midi
from ..synth.synthesizer import _DEFAULT_TIMBRE, _FAMILY_TIMBRES
from .dataset import STEP_SIZE_IN_CHUNKS, _batched_specs, _chunk_samples, _slice_windows, generate_data_row

MAX_HARMONICS = 10
# elements of one dense (notes, samples) float32 tensor of the render: 512 MB
RENDER_BLOCK_ELEMENTS = 1 << 27


@dataclass
class NoteSchedule:
    """Host-side note table extracted from a MidiFile (percussion dropped)."""

    t_on: np.ndarray  # (K,) seconds
    t_off: np.ndarray  # (K,) seconds (note-off time; end of file if none)
    key: np.ndarray  # (K,) int
    velocity: np.ndarray  # (K,)
    harmonics: np.ndarray  # (K, MAX_HARMONICS)
    attack: np.ndarray
    decay: np.ndarray
    sustain: np.ndarray
    release: np.ndarray
    # (K,) absolute seconds a voice is force-silenced by the 64-voice pool
    # (inf = never evicted); see _polyphony_forced_ends
    t_cut: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.t_on)


def schedule_from_midi(
    midi: MidiFile, length: float, quantize_secs: float | None = None
) -> NoteSchedule:
    """`quantize_secs` rounds event times UP to the dispatch grid, mirroring
    MidiFileSequencer's block-start dispatch (an event inside a block fires
    at the start of the next block, midifile_sequencer.rs:60-76) so device
    and host renders align sample-exactly. Pass 64/sr to match the default
    block size."""

    def q(t: float) -> float:
        if quantize_secs is None:
            return t
        return math.ceil(t / quantize_secs - 1e-9) * quantize_secs

    programs = [0] * 16
    open_notes: dict[tuple[int, int], list] = {}
    rows = []
    for ev in midi.events:
        if ev.kind == "program":
            programs[ev.channel] = ev.program
        elif ev.kind == "on" and ev.channel != 9:
            timbre = _FAMILY_TIMBRES.get(programs[ev.channel] // 8, _DEFAULT_TIMBRE)
            row = [q(ev.time), length, ev.key, ev.velocity, timbre]
            open_notes.setdefault((ev.channel, ev.key), []).append(row)
            rows.append(row)
        elif ev.kind == "off":
            # the host synthesizer's note_off releases ALL unreleased voices
            # for (channel, key), so every open note closes here too
            stack = open_notes.pop((ev.channel, ev.key), None)
            if stack:
                for row in stack:
                    row[1] = q(ev.time)

    k = len(rows)
    sched = NoteSchedule(
        t_on=np.array([r[0] for r in rows], np.float32),
        t_off=np.array([min(r[1], length) for r in rows], np.float32),
        key=np.array([r[2] for r in rows], np.int32),
        velocity=np.array([r[3] for r in rows], np.float32),
        harmonics=np.zeros((k, MAX_HARMONICS), np.float32),
        attack=np.array([r[4].attack for r in rows], np.float32),
        decay=np.array([r[4].decay for r in rows], np.float32),
        sustain=np.array([r[4].sustain for r in rows], np.float32),
        release=np.array([r[4].release for r in rows], np.float32),
    )
    for i, r in enumerate(rows):
        h = r[4].harmonics[:MAX_HARMONICS]
        sched.harmonics[i, : len(h)] = h
    if quantize_secs is not None:
        sched.t_cut = _polyphony_forced_ends(sched, quantize_secs)
    return sched


def _polyphony_forced_ends(
    sched: NoteSchedule, block_secs: float, max_voices: int = 64
) -> np.ndarray:
    """Simulates synth/synthesizer.py's voice pool over the schedule:
    ``note_on`` evicts the OLDEST live voice when the pool holds
    ``MAX_VOICES=64`` (``voices.pop(0)``), and finished voices leave the
    pool at the first block boundary STRICTLY after their envelope end
    (``done()`` is checked after each rendered block). Returns per-note
    absolute times the pool force-silences them (inf = never evicted), so
    dense files render the same audio and labels on both routes."""
    order = np.argsort(sched.t_on, kind="stable")  # dispatch order
    forced = np.full(len(sched), np.inf, np.float32)
    live: list[tuple[float, int]] = []  # insertion-ordered (leave_time, idx)
    for i in order:
        t = float(sched.t_on[i])
        live = [(d, j) for (d, j) in live if d > t]
        if len(live) >= max_voices:
            _, j = live.pop(0)
            forced[j] = t
        env_end = float(sched.t_off[i]) + float(sched.release[i])
        leave = (math.floor(env_end / block_secs) + 1) * block_secs
        live.append((leave, int(i)))
    return forced


def _envelope(t_rel, released_rel, attack, decay, sustain, release):
    """ADSR matching synth.synthesizer.Voice.envelope (vectorized, absolute
    note-relative time), op for op as the JAX package writes it."""
    env = torch.where(
        t_rel < attack,
        t_rel / torch.clamp_min(attack, 1e-5),
        torch.where(
            t_rel < attack + decay,
            1.0 - (1.0 - sustain) * (t_rel - attack) / torch.clamp_min(decay, 1e-5),
            sustain,
        ),
    )
    tr = t_rel - released_rel
    env = torch.where(tr > 0.0, env * torch.clamp_min(1.0 - tr / torch.clamp_min(release, 1e-5), 0.0), env)
    return torch.where(t_rel >= 0.0, env, 0.0)


def _sum_notes(x: torch.Tensor) -> torch.Tensor:
    """(K, T) -> (T,): the sum over notes as a pairwise tree (row i + row
    i + K/2, halving), the same order for every column, block and device."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pair = x[:half] + x[half : 2 * half]
        x = torch.cat([pair, x[2 * half :]]) if x.shape[0] % 2 else pair
    return x[0]


DEFAULT_MASTER_GAIN = 0.18


def _render_core(
    t_on, t_off, freq, vel, harmonics, attack, decay, sustain, release, t_cut,
    n_samples: int, sr: float, master_gain: float, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Shared synthesis body ((K,) float32 note tensors -> (n_samples,)
    float32 mono on their device, written into ``out`` where it is given):
    ADSR envelope x band-limited harmonic stack x velocity, summed over
    notes. ``t_cut`` (K,) absolute seconds force-silences evicted voices
    (the host pool's pop(0), see _polyphony_forced_ends).

    The time axis goes in blocks of at most RENDER_BLOCK_ELEMENTS / K
    samples. The float32 operations are those of the JAX package's compiled
    program (_render_agc_jit), whose rewrites the port spells out, since the
    phase argument reaches some 4e6 rad in a 60-second file, where one ulp
    of it moves a sine by a quarter of a radian:

    * XLA turns a division by a constant into a product with its float32
      reciprocal (so does PyTorch on the card, but not on the CPU): t =
      arange(n) * (1/sr), and vel * (1/127);
    * XLA folds products of constants first: the phase is (freq * c_h) *
      t_rel with c_h = float32(2 pi) * (h + 1) in float32, and the note's
      scale vel * (0.18 * (1/127)).

    What is left between the two is the rounding of sin (an ulp here and
    there, on either device) and the order of the sum over notes."""
    k = t_on.shape[0]
    device = t_on.device
    col = lambda a: a[:, None]  # noqa: E731
    released_rel = col(t_off - t_on)
    nyq = sr / 2.0
    f32 = np.float32
    inv_sr = float(f32(1.0) / f32(sr))
    scale = col(vel) * float(f32(master_gain) * (f32(1.0) / f32(127.0)))
    two_pi = f32(2.0 * math.pi)
    block = max(1, RENDER_BLOCK_ELEMENTS // max(k, 1))
    if out is None:
        out = torch.empty(n_samples, dtype=torch.float32, device=device)
    for start in range(0, n_samples, block):
        stop = min(n_samples, start + block)
        t = torch.arange(start, stop, dtype=torch.float32, device=device) * inv_sr  # (Tb,)
        t_rel = t[None, :] - col(t_on)  # (K, Tb)
        env = _envelope(t_rel, released_rel, col(attack), col(decay), col(sustain), col(release))
        env = torch.where(t[None, :] < col(t_cut), env, 0.0)
        wave = torch.zeros_like(t_rel)
        for h in range(MAX_HARMONICS):
            fh = col(freq) * (h + 1)
            amp_h = torch.where(fh < nyq, harmonics[:, h : h + 1], 0.0)
            wave = wave + amp_h * torch.sin((col(freq) * float(two_pi * f32(h + 1))) * t_rel)
        out[start:stop] = _sum_notes(scale * env * wave)
    return out


def key_to_freq_array(keys: np.ndarray) -> np.ndarray:
    return (440.0 * 2.0 ** ((keys.astype(np.float64) - 69) / 12.0)).astype(np.float32)


def _note_tensors(sched: NoteSchedule, device, k_pad: int | None = None) -> list[torch.Tensor]:
    """The schedule's (K,) columns as float32 tensors on ``device``, in
    _render_core's argument order, padded to ``k_pad`` notes that never
    sound (velocity 0, starting at 1e9 s) when it is given."""
    t_cut = sched.t_cut if sched.t_cut is not None else np.full(len(sched), np.inf, np.float32)
    cols = [
        (sched.t_on, 1e9), (sched.t_off, 1e9), (key_to_freq_array(sched.key), 1.0),
        (sched.velocity, 0.0), (sched.harmonics, 0.0), (sched.attack, 1.0), (sched.decay, 1.0),
        (sched.sustain, 0.0), (sched.release, 1.0), (t_cut, np.inf),
    ]
    k = len(sched)
    out = []
    for a, fill in cols:
        a = np.asarray(a, np.float32)
        if k_pad is not None and k_pad > k:
            a = np.concatenate([a, np.full((k_pad - k,) + a.shape[1:], fill, np.float32)])
        out.append(torch.from_numpy(a).to(device))
    return out


def _file_notes(sched: NoteSchedule, device) -> list[torch.Tensor]:
    """_note_tensors of one file, its note table padded to a power of two
    (at least 16) as the JAX package buckets it."""
    return _note_tensors(sched, device, max(16, 1 << (len(sched) - 1).bit_length()))


def render_schedule_device(
    sched: NoteSchedule, n_samples: int, sr: float, master_gain: float = DEFAULT_MASTER_GAIN,
    device="cuda",
) -> torch.Tensor:
    """Renders the full mono signal on the device: (n_samples,) float32."""
    device = resolve_device(device)
    if len(sched) == 0:
        return torch.zeros(n_samples, dtype=torch.float32, device=device)
    return _render_core(*_note_tensors(sched, device), n_samples, sr, master_gain)


TRAIN_AGC = AgcParameters(desired_output_rms=0.07, distortion_factor=0.001)  # train.rs:271


def agc_signal_device(
    signal: torch.Tensor, chunk: int, params: AgcParameters = TRAIN_AGC
) -> torch.Tensor:
    """dagc over the whole (N,) signal, chunk by chunk (per-chunk silence
    freeze, matching the host callbacks): the processed (N // chunk * chunk,)
    signal. On the card one launch of the AGC kernel's signal mode."""
    processed, _ = agc_signal(signal[None, :], chunk, params)
    return processed[0]


def active_keys_at(sched: NoteSchedule, t: float, agc_gain: float) -> dict[int, float]:
    """Host-side label extraction at time t (train.rs:318-338 semantics:
    per-voice gain = velocity/127 * envelope, max per key, times AGC gain),
    vectorized over the note table; pool-evicted voices (t >= t_cut) are
    excluded like the host's get_active_voices."""
    t_rel = t - sched.t_on.astype(np.float64)
    rel_rel = (sched.t_off - sched.t_on).astype(np.float64)
    release = sched.release.astype(np.float64)
    alive = (t_rel >= 0) & (t_rel <= rel_rel + release)
    if sched.t_cut is not None:
        alive &= t < sched.t_cut
    if not alive.any():
        return {}
    attack = sched.attack.astype(np.float64)
    decay = sched.decay.astype(np.float64)
    sustain = sched.sustain.astype(np.float64)
    env = np.where(
        t_rel < attack,
        t_rel / np.maximum(attack, 1e-5),
        np.where(
            t_rel < attack + decay,
            1.0 - (1.0 - sustain) * (t_rel - attack) / np.maximum(decay, 1e-5),
            sustain,
        ),
    )
    tr = t_rel - rel_rel
    env = np.where(tr > 0, env * np.maximum(1.0 - tr / np.maximum(release, 1e-5), 0.0), env)
    gain = sched.velocity.astype(np.float64) / 127.0 * env * agc_gain
    out: dict[int, float] = {}
    for i in np.nonzero(alive)[0]:
        key = int(sched.key[i])
        g = float(gain[i])
        if g > out.get(key, -1.0):
            out[key] = g
    return out


def _render_agc_rows(
    notes: list[list[torch.Tensor]], n_samples: list[int], *, sr: float, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render each file's notes (its _note_tensors) into its row of one
    (F, max n_samples) float32 batch, zero after its own samples, one file
    at a time so that the render's peak memory does not grow with F; then
    AGC every row in one launch of the signal mode. ((F, N) processed, (F, N
    // chunk) gain after each chunk), with no host synchronisation between
    or inside them; a row's first n_samples // chunk chunks are its file's
    own. The JAX package compiles render and AGC as one program a file
    (_render_agc_jit)."""
    rows = torch.zeros((len(notes), max(n_samples)), dtype=torch.float32, device=notes[0][0].device)
    for row, cols, n in zip(rows, notes, n_samples):
        _render_core(*cols, n, sr, DEFAULT_MASTER_GAIN, out=row[:n])
    return agc_signal(rows, chunk, TRAIN_AGC)


def _render_inputs(midi: MidiFile, params: VqtParameters, chunk: int, max_seconds: float | None):
    """(schedule, n_samples) of one file: its length rounded UP to whole
    chunks (the host loop renders full chunks until written >= sample_count,
    so flooring would emit one capture row fewer for partial-chunk lengths),
    or (None, 0) when it renders nothing."""
    sr = int(params.sr)
    length = midi.get_length()
    if max_seconds is not None:
        length = min(length, max_seconds)
    n_samples = -(-int(sr * length) // chunk) * chunk
    if n_samples == 0:
        return None, 0
    sched = schedule_from_midi(midi, length, quantize_secs=64 / sr)
    if len(sched) == 0:
        return None, 0
    return sched, n_samples


def _captures(
    sched: NoteSchedule, processed: torch.Tensor, gains: np.ndarray, vqt: Vqt, *, chunk: int,
    step_size_in_chunks: int,
) -> list[tuple[dict[int, float], np.ndarray]]:
    """Windows + VQT + labels of one rendered file: capture every
    `step_size_in_chunks`-th chunk, labels from the PREVIOUS capture's
    snapshot (train.rs:317-347)."""
    sr = int(vqt.params.sr)
    n_chunks = gains.shape[0]
    capture_chunks = [c for c in range(1, n_chunks + 1) if c % step_size_in_chunks == 0]
    if not capture_chunks:
        return []
    windows = _slice_windows(
        processed, stride=step_size_in_chunks * chunk, n_caps=len(capture_chunks), n_fft=vqt.params.n_fft
    )
    specs = _batched_specs(vqt, windows)
    out = []
    prev: dict[int, float] = {}
    for idx, c in enumerate(capture_chunks):
        active = active_keys_at(sched, c * chunk / sr, float(gains[c - 1]))
        out.append((prev, specs[idx]))
        prev = active
    return out


def annotate_midi_device(
    midi: MidiFile,
    vqt: Vqt,
    params: VqtParameters = TRAIN_VQT_PARAMETERS,
    step_size_in_chunks: int = STEP_SIZE_IN_CHUNKS,
    max_seconds: float | None = None,
) -> list[tuple[dict[int, float], np.ndarray]]:
    """Device-rendered equivalent of train/dataset.annotate_midi: same
    capture cadence (every `step_size_in_chunks`-th vqt-delay chunk, labels
    from the PREVIOUS capture's voice snapshot), synthesis + AGC + VQT on
    ``vqt``'s device."""
    chunk = _chunk_samples(vqt, int(params.sr))  # the ONE chunk-grid rule (train.rs:243-247)
    sched, n_samples = _render_inputs(midi, params, chunk, max_seconds)
    if sched is None:
        return []
    processed, gains = _render_agc_rows([_file_notes(sched, vqt.device)], [n_samples], sr=float(params.sr),
                                        chunk=chunk)
    return _captures(sched, processed[0], gains[0].cpu().numpy(), vqt, chunk=chunk,
                     step_size_in_chunks=step_size_in_chunks)


# files of one signal-mode launch on the CPU, where no SM count applies (the
# plain version walks the rows of a batch together, sample by sample)
CPU_ROWS_PER_LAUNCH = 8


def rows_per_launch(device: torch.device) -> int:
    """Files of one agc_signal launch in generate_dataset_device: one row an
    SM of the card (multi_processor_count, 132 on the H100), each row's
    latency-bound chain on an SM of its own; CPU_ROWS_PER_LAUNCH on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return CPU_ROWS_PER_LAUNCH


# padded samples of one batch at most: the batch and its processed copy are
# float32, so 2 GiB of them on the device whatever the files' lengths (132
# files of 60 s at 22050 Hz fill two thirds of it; a longer file than this
# alone is a batch of its own)
BATCH_SAMPLES = 1 << 28


def _batches(files, rows: int):
    """Consecutive runs of ``files`` ((schedule, n_samples), in order) of at
    most ``rows`` files and at most BATCH_SAMPLES samples once padded to the
    longest of the run; a file over BATCH_SAMPLES alone is a run of one."""
    batch, longest = [], 0
    for f in files:
        if batch and (len(batch) == rows or (len(batch) + 1) * max(longest, f[1]) > BATCH_SAMPLES):
            yield batch
            batch, longest = [], 0
        batch.append(f)
        longest = max(longest, f[1])
    if batch:
        yield batch


def _renderable_files(midi_paths: list[str], params: VqtParameters, chunk: int, max_seconds: float | None):
    """(schedule, n_samples) of each file, in order, that parses and renders
    something; a file that does not parse is reported and skipped, as the
    reference tolerates it."""
    for p in midi_paths:
        try:
            midi = load_midi(p)
        except Exception as e:  # mirrors the reference's per-file tolerance
            print(f"failed to parse midi file {p}: {e}")
            continue
        sched, n_samples = _render_inputs(midi, params, chunk, max_seconds)
        if sched is not None:
            yield sched, n_samples


def generate_dataset_device(
    midi_paths: list[str],
    params: VqtParameters = TRAIN_VQT_PARAMETERS,
    out_path: str | None = None,
    max_seconds_per_file: float | None = None,
    device="cuda",
) -> np.ndarray:
    """data.npy-layout dataset with synthesis + AGC + VQT on the device
    (the card unless ``device="cpu"``): the rows of annotate_midi_device,
    file after file, with the files' AGC batched (_render_agc_rows, up to
    rows_per_launch files and BATCH_SAMPLES padded samples a launch)."""
    vqt = Vqt(params, device=device)
    chunk = _chunk_samples(vqt, int(params.sr))
    sr = float(params.sr)
    rows: list[np.ndarray] = []
    files = _renderable_files(midi_paths, params, chunk, max_seconds_per_file)
    for batch in _batches(files, rows_per_launch(vqt.device)):
        processed, gains = _render_agc_rows([_file_notes(sched, vqt.device) for sched, _ in batch],
                                            [n for _, n in batch], sr=sr, chunk=chunk)
        gains = gains.cpu().numpy()
        for i, (sched, n_samples) in enumerate(batch):
            for active, spec in _captures(sched, processed[i, :n_samples], gains[i, : n_samples // chunk], vqt,
                                          chunk=chunk, step_size_in_chunks=STEP_SIZE_IN_CHUNKS):
                rows.append(generate_data_row(active, spec, params.n_buckets))
    data = np.concatenate(rows) if rows else np.zeros(0, np.float32)
    if out_path:
        np.save(out_path, data)
    return data
