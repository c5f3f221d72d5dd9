"""Procedural training corpus + one-command realistic-scale training demo.

Port of ``pitchvis_tpu/train/corpus.py``. The reference trains on ~346k
frames rendered from MuseScore_General.sf2 over an lmd MIDI corpus
(pitchvis_train/train.py:31, train.rs:112-207). Neither asset can ship here,
so this module builds both procedurally:

* ``build_training_font`` — a multi-instrument SF2 (10 GM-spread presets
  with distinct harmonic recipes and volume envelopes) through the
  project's own SF2 writer, so program-change events in the corpus select
  real timbre changes exactly like the reference's multi-preset font.
* ``build_midi_corpus`` — music-like SMF files: per-file key/mode/tempo,
  a chord track, a bass track and a melody track on separate channels
  with distinct programs.
* ``train_demo`` — font -> corpus -> labeled frames (native C++ engine +
  batched VQT on the card, train/dataset.py) -> PitchMLP training
  (train/train.py, the reference's hyperparameters) -> metrics file +
  NumPy checkpoint. One command:

      python -m pitchvis_tpu_torch.train.corpus

The font and the corpus come from the same seeded NumPy generators as the
JAX package's, so they are the same bytes. The port's runs
write under ``build/train_demo_torch*`` at the root of the checkout (a
directory .gitignore lists), never the JAX package's committed artifacts.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..synth.sf2 import (
    GEN_ATTACK_VOL_ENV,
    GEN_DECAY_VOL_ENV,
    GEN_RELEASE_VOL_ENV,
    GEN_SUSTAIN_VOL_ENV,
    write_multi_sf2,
)

SR = 22050
# where the port's demo runs write: build/ at the root of the checkout
DEMO_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build")
DEMO_OUT_DIR = os.path.join(DEMO_ROOT, "train_demo_torch")


# Corpus-scale presets shared by train_demo's auto gate, the CLI preset
# flags, and the metrics-copy guards below.
DEMO_SCALE_FILES = 420
FULL_SCALE_FILES = 1535  # the reference's corpus size (train.py:31 scale)
DEMO_SECONDS_PER_FILE = 60.0


def _timecents(seconds: float) -> int:
    return int(round(1200.0 * np.log2(max(seconds, 1e-4))))


def _loop_sample(f0: float, amps, sr: int = SR, seconds: float = 1.0, rng=None) -> np.ndarray:
    """Loop-periodic additive sample: an integer number of f0 cycles so the
    full-sample loop is click-free; harmonics above 0.45*sr are dropped
    (they would alias immediately, before any resampling)."""
    n_cycles = max(1, int(round(seconds * f0)))
    n = int(round(n_cycles * sr / f0))
    t = np.arange(n) / sr
    f_real = n_cycles / (n / sr)  # exact integer-cycle frequency
    out = np.zeros(n, np.float64)
    for k, a in enumerate(amps, 1):
        if k * f_real >= 0.45 * sr:
            break
        jitter = 1.0 if rng is None else float(rng.uniform(0.9, 1.1))
        out += a * jitter * np.sin(2 * np.pi * f_real * k * t)
    peak = np.max(np.abs(out))
    return (0.4 * out / max(peak, 1e-9)).astype(np.float32)


def _env(attack: float, decay: float, sustain_cb: int, release: float):
    return [
        (GEN_ATTACK_VOL_ENV, _timecents(attack)),
        (GEN_DECAY_VOL_ENV, _timecents(decay)),
        (GEN_SUSTAIN_VOL_ENV, int(sustain_cb)),
        (GEN_RELEASE_VOL_ENV, _timecents(release)),
    ]


# GM programs of the training timbres — the single source for both
# _timbre_specs (which asserts against it) and build_midi_corpus's
# defaults, so adding/renumbering a timbre cannot silently leave the
# generated corpus unrepresentative of the font.
TIMBRE_PROGRAMS = (0, 4, 19, 24, 32, 48, 52, 61, 73, 80)
MELODY_PROGRAMS = (0, 4, 24, 61, 73, 80)  # lead-capable subset
CHORD_PROGRAMS = (0, 19, 48, 52)  # pad/comping subset


# (program, name, harmonic recipe, root_key, f0, envelope)
# sustain is in centibels of attenuation (0 = full level).
def _timbre_specs(rng) -> list[dict]:
    def roll(p, n=12):
        k = np.arange(1, n + 1, dtype=np.float64)
        return 1.0 / k**p

    odd = np.array([1.0, 0.0, 0.7, 0.0, 0.45, 0.0, 0.3, 0.0, 0.2])
    brass = np.array([0.5, 0.8, 1.0, 0.9, 0.7, 0.55, 0.4, 0.3])
    specs = [
        (0, "piano", roll(1.3, 10), 57, _env(0.005, 1.8, 960, 0.15)),
        (4, "epiano", roll(2.0, 8), 57, _env(0.004, 1.2, 700, 0.2)),
        (19, "organ", odd, 57, _env(0.02, 0.3, 0, 0.08)),
        (24, "guitar", roll(1.1, 10), 57, _env(0.003, 0.9, 1100, 0.12)),
        (32, "bass", roll(1.5, 8), 45, _env(0.005, 0.7, 500, 0.1)),
        (48, "strings", roll(1.0, 12), 57, _env(0.12, 0.4, 60, 0.35)),
        (52, "choir", roll(1.7, 8), 57, _env(0.15, 0.5, 100, 0.4)),
        (61, "brass", brass, 57, _env(0.04, 0.5, 150, 0.2)),
        (73, "flute", np.array([1.0, 0.18, 0.08, 0.03]), 69, _env(0.06, 0.3, 80, 0.2)),
        (80, "sqlead", odd * roll(0.4, 9)[: len(odd)], 57, _env(0.01, 0.4, 200, 0.1)),
    ]
    assert tuple(s[0] for s in specs) == TIMBRE_PROGRAMS
    out = []
    for program, name, amps, root, env in specs:
        f0 = 440.0 * 2.0 ** ((root - 69) / 12.0)
        out.append(
            {
                "program": program,
                "name": name,
                "sample": _loop_sample(f0, amps, rng=rng),
                "sample_rate": SR,
                "root_key": root,
                "loop": True,
                "instrument_gens": env,
            }
        )
    return out


def build_training_font(path: str, seed: int = 0) -> list[int]:
    """Writes the multi-instrument training font; returns its program list."""
    rng = np.random.default_rng(seed)
    specs = _timbre_specs(rng)
    write_multi_sf2(path, specs, name="pitchvis-train")
    return [s["program"] for s in specs]


_MAJOR = [0, 2, 4, 5, 7, 9, 11]
_MINOR = [0, 2, 3, 5, 7, 8, 10]
# chord degrees (I, IV, V, vi and friends) as scale-degree indices
_PROGRESSIONS = [
    [0, 3, 4, 0],
    [0, 5, 3, 4],
    [0, 4, 5, 3],
    [5, 3, 0, 4],
]


def _scale_key(tonic: int, scale: list[int], degree: int, octave: int) -> int:
    return tonic + scale[degree % 7] + 12 * (octave + degree // 7)


def generate_piece(
    rng, seconds: float, melody_programs: list[int], chord_programs: list[int],
    bass_program: int = 32,
) -> tuple[list[tuple[float, float, int, int, int]], dict[int, int]]:
    """One music-like piece: chord pads (ch0), bass roots (ch1), melody
    (ch2); returns (notes, channel->program map). Key range is clamped to
    [36, 96] so every note stays inside the font's usable register."""
    bpm = float(rng.uniform(70, 160))
    beat = 60.0 / bpm
    bar = 4 * beat
    tonic = 36 + int(rng.integers(0, 12))
    scale = _MAJOR if rng.random() < 0.6 else _MINOR
    progression = _PROGRESSIONS[int(rng.integers(0, len(_PROGRESSIONS)))]
    programs = {
        0: int(chord_programs[rng.integers(0, len(chord_programs))]),
        1: bass_program,
        2: int(melody_programs[rng.integers(0, len(melody_programs))]),
    }

    notes: list[tuple[float, float, int, int, int]] = []

    def clamp(k: int) -> int:
        while k > 96:
            k -= 12
        while k < 36:
            k += 12
        return k

    n_bars = int(np.ceil(seconds / bar))
    for b in range(n_bars):
        t0 = b * bar
        degree = progression[b % len(progression)]
        # chord pad: triad, one bar, centered an octave above the tonic
        if rng.random() < 0.9:
            vel = int(rng.integers(50, 90))
            for off in (0, 2, 4):
                key = clamp(_scale_key(tonic, scale, degree + off, 1))
                notes.append((t0, bar * float(rng.uniform(0.85, 1.0)), 0, key, vel))
        # bass: root on beats 1 and 3
        for half in (0.0, 2 * beat):
            if rng.random() < 0.8:
                key = clamp(_scale_key(tonic, scale, degree, 0) - 12)
                notes.append((t0 + half, 2 * beat * 0.9, 1, key, int(rng.integers(60, 100))))
        # melody: random walk on the scale, mixed 8th/quarter rhythm
        t = t0
        md = degree + 7  # start near an octave above the chord
        while t < t0 + bar - 1e-6:
            dur = beat * (0.5 if rng.random() < 0.6 else 1.0)
            if rng.random() < 0.8:  # note (else rest)
                md += int(rng.integers(-2, 3))
                md = int(np.clip(md, 5, 20))
                key = clamp(_scale_key(tonic, scale, md, 1))
                notes.append(
                    (t, dur * float(rng.uniform(0.7, 0.95)), 2, key, int(rng.integers(60, 120)))
                )
            t += dur

    notes = [n for n in notes if n[0] < seconds]
    return notes, programs


def build_midi_corpus(
    dir_path: str,
    n_files: int,
    seconds_per_file: float = 60.0,
    seed: int = 0,
    programs: list[int] | None = None,
) -> list[str]:
    """Writes ``n_files`` generated pieces; returns their paths (sorted,
    deterministic for a given seed)."""
    from ..synth.midi import write_midi

    programs = programs or list(TIMBRE_PROGRAMS)
    melody = [p for p in programs if p in MELODY_PROGRAMS] or programs
    chords = [p for p in programs if p in CHORD_PROGRAMS] or programs
    os.makedirs(dir_path, exist_ok=True)
    paths = []
    for i in range(n_files):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        notes, ch_programs = generate_piece(rng, seconds_per_file, melody, chords)
        path = os.path.join(dir_path, f"piece_{i:05d}.mid")
        write_midi(path, notes, tempo_bpm=120.0, programs=ch_programs)
        paths.append(path)
    return paths


def train_demo(
    out_dir: str = DEMO_OUT_DIR,
    n_files: int = DEMO_SCALE_FILES,
    seconds_per_file: float = DEMO_SECONDS_PER_FILE,
    epochs: int = 32,
    n_workers: int = 2,
    seed: int = 0,
    target_frames: int | None = None,
    metrics_copy: str | None = "auto",
    tuned: bool = False,
    device="cuda",
) -> dict:
    """Font -> corpus -> labeled dataset -> training -> metrics.

    Matches the reference's end-to-end flow (train.rs:112-207 +
    pitchvis_train/train.py:108-208) at reduced-but-realistic scale; the
    dataset size is n_files * seconds_per_file * ~3.7 frames/s. The VQT and
    the training run on ``device`` (the card unless ``device="cpu"``).
    ``metrics_copy="auto"`` copies the report of a demo-scale run to
    ``build/TRAIN_DEMO_TORCH[_TUNED].json``, and of a smaller run nowhere."""
    from ..core.config import TRAIN_VQT_PARAMETERS
    from .dataset import generate_dataset
    from .train import TrainConfig, train, tuned_config

    if metrics_copy == "auto":
        metrics_copy = None
        if n_files >= DEMO_SCALE_FILES and seconds_per_file >= DEMO_SECONDS_PER_FILE:
            metrics_copy = os.path.join(DEMO_ROOT, "TRAIN_DEMO_TORCH_TUNED.json" if tuned else "TRAIN_DEMO_TORCH.json")
    os.makedirs(out_dir, exist_ok=True)
    font_path = os.path.join(out_dir, "train_font.sf2")
    midi_dir = os.path.join(out_dir, "midi")
    wall: dict[str, float] = {}

    t0 = time.time()
    programs = build_training_font(font_path, seed=seed)
    paths = build_midi_corpus(
        midi_dir, n_files, seconds_per_file, seed=seed, programs=programs
    )
    wall["corpus_build"] = time.time() - t0

    t0 = time.time()
    data = generate_dataset(
        paths,
        TRAIN_VQT_PARAMETERS,
        out_path=os.path.join(out_dir, "data.npy"),
        sound_font_path=font_path,
        n_workers=n_workers,
        device=device,
    )
    wall["dataset_gen"] = time.time() - t0
    row = TRAIN_VQT_PARAMETERS.n_buckets + 128
    n_frames = len(data) // row
    if target_frames is not None and n_frames < target_frames:
        raise RuntimeError(f"corpus produced {n_frames} frames < target {target_frames}")

    t0 = time.time()
    mk = tuned_config if tuned else TrainConfig
    cfg = mk(n_buckets=TRAIN_VQT_PARAMETERS.n_buckets, epochs=epochs, seed=seed)
    _, metrics = train(data, cfg, checkpoint_dir=os.path.join(out_dir, "ckpt"), device=device)
    wall["train"] = time.time() - t0

    report = {
        "recipe": "tuned (AdamW warmup-cosine)" if tuned else "reference hparams",
        "n_files": n_files,
        "seconds_per_file": seconds_per_file,
        "n_frames": n_frames,
        "programs": programs,
        "seed": seed,
        "epochs": epochs,
        "wall_seconds": {k: round(v, 1) for k, v in wall.items()},
        "metrics": metrics,
    }
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(report, f, indent=2)
    if metrics_copy:
        os.makedirs(os.path.dirname(metrics_copy) or ".", exist_ok=True)
        with open(metrics_copy, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEMO_OUT_DIR)
    ap.add_argument("--files", type=int, default=DEMO_SCALE_FILES)
    ap.add_argument("--seconds", type=float, default=DEMO_SECONDS_PER_FILE)
    ap.add_argument("--epochs", type=int, default=32)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--target-frames", type=int, default=None)
    ap.add_argument(
        "--tuned", action="store_true",
        help="modernized optimizer recipe (AdamW + warmup-cosine) instead of "
        "the reference's hyperparameters",
    )
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument(
        "--quick", action="store_true",
        help="tiny smoke run (4 files x 10 s, 2 epochs)",
    )
    scale.add_argument(
        "--full", action="store_true",
        help="full reference-scale run (1535 files x 60 s -> ~346k frames, "
        "matching pitchvis_train/train.py:31's 346,616-frame corpus; tuned "
        "recipe, 20 epochs)",
    )
    ap.add_argument(
        "--reference-hparams", action="store_true",
        help="with --full: keep the reference's exact hyperparameters "
        "(Adam lr=1e-5, batch 300, 32 epochs) instead of the tuned recipe",
    )
    args = ap.parse_args(argv)
    if args.reference_hparams and not args.full:
        ap.error("--reference-hparams only applies to --full (smaller runs "
                 "already default to the reference recipe)")
    # preset flags fill in only values the user did NOT set explicitly
    if args.quick:
        if args.files == ap.get_default("files"):
            args.files = 4
        if args.seconds == ap.get_default("seconds"):
            args.seconds = 10.0
        if args.epochs == ap.get_default("epochs"):
            args.epochs = 2
    if args.full:
        if args.files == ap.get_default("files"):
            args.files = FULL_SCALE_FILES
        args.tuned = not args.reference_hparams
        if args.epochs == ap.get_default("epochs"):
            args.epochs = 32 if args.reference_hparams else 20
        if args.out == ap.get_default("out"):
            args.out = DEMO_OUT_DIR + ("_full_ref" if args.reference_hparams else "_full")
    # a run's metrics are copied beside the others only at the preset's
    # corpus scale and epochs: a downsized run keeps its own out_dir only
    at_scale = (
        args.seconds >= DEMO_SECONDS_PER_FILE
        and args.epochs >= (8 if args.tuned else 32)
    )
    metrics_copy = None
    if not args.quick and at_scale:
        if args.full:
            if args.files >= FULL_SCALE_FILES:
                name = "TRAIN_DEMO_TORCH_FULLSCALE_REF.json" if args.reference_hparams else "TRAIN_DEMO_TORCH_FULLSCALE.json"
                metrics_copy = os.path.join(DEMO_ROOT, name)
        elif args.files >= DEMO_SCALE_FILES:
            metrics_copy = os.path.join(DEMO_ROOT, "TRAIN_DEMO_TORCH_TUNED.json" if args.tuned else "TRAIN_DEMO_TORCH.json")
    report = train_demo(
        out_dir=args.out,
        n_files=args.files,
        seconds_per_file=args.seconds,
        epochs=args.epochs,
        n_workers=args.workers,
        seed=args.seed,
        target_frames=args.target_frames,
        metrics_copy=metrics_copy,
        tuned=args.tuned,
    )
    print(json.dumps({
        "n_frames": report["n_frames"],
        "f1_micro": report["metrics"]["f1_micro"],
        "accuracy": report["metrics"]["accuracy"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
