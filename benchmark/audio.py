"""The seeded audio every traffic mix plays: music, not pure tones.

A run makes ``tracks`` tracks of polyphonic music from its seed and gives
each stream one of them at an offset of whole hops and a level of its own;
one stream in ``silent_every`` is silent, which drives the AGC's freeze
path. Each track is a sequence of notes of ``note_seconds`` (drawn
uniformly), each note ``voices`` voices (1 to 3) of ``partials`` harmonic
partials, a fundamental on the semitone grid with a small detune inside the
cell's VQT range, a level drawn over ``level_db`` (40 dB), a short attack
and an exponential decay, over a noise floor at ``noise_db``. The note
parameters come from NumPy's generator on the host and the samples from a
``torch.Generator`` on the run's device, in a few large calls, so every
seed makes the same amount of work from other music.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MAX_VOICES = 3


@dataclasses.dataclass
class Music:
    """Host or device tracks and each stream's share of them."""

    tracks: torch.Tensor  # (n_tracks + 1, n_samples) f32; the last row is silence
    track_of: np.ndarray  # (B,) int64 track index of each stream
    offset: np.ndarray  # (B,) int64 offset in hops
    level: np.ndarray  # (B,) f32 gain of each stream
    hop: int

    def chunk_index(self, streams: np.ndarray, m: int) -> np.ndarray:
        """Flat indices into ``tracks.view(-1, hop)`` of chunk ``m`` (in
        hops from each stream's start) of ``streams``."""
        per_track = self.tracks.shape[1] // self.hop
        return self.track_of[streams] * per_track + self.offset[streams] + m

    def chunks(self, streams: np.ndarray, first: int, count: int) -> np.ndarray:
        """(len(streams), count * hop) float32 samples of chunks
        ``first .. first + count - 1`` of ``streams``, on the host."""
        view = self.tracks.reshape(-1, self.hop)
        idx = np.stack([self.chunk_index(streams, first + i) for i in range(count)], axis=1)
        rows = view[torch.from_numpy(idx.reshape(-1))].reshape(len(streams), count * self.hop)
        return (rows.cpu().numpy() * self.level[streams, None]).astype(np.float32)


def _note_table(rng: np.random.Generator, n_tracks: int, seconds: float, music: dict, vqt: dict):
    """(starts, durations, f0 per voice (0 = silent voice), level, decay) of
    every note of every track, (n_tracks, n_notes[, voices])."""
    lo, hi = music["note_seconds"]
    n_notes = int(math.ceil(seconds / lo)) + 1
    dur = rng.uniform(lo, hi, (n_tracks, n_notes))
    starts = np.concatenate([np.zeros((n_tracks, 1)), np.cumsum(dur, axis=1)[:, :-1]], axis=1)
    # fundamentals on the semitone grid from the range's second semitone to
    # an octave below its top, so that the partials fall in the range
    semis = 12 * int(vqt["octaves"]) - 12
    semitone = rng.integers(1, max(2, semis), (n_tracks, n_notes, MAX_VOICES))
    detune = rng.uniform(-0.2, 0.2, (n_tracks, n_notes, MAX_VOICES))
    f0 = float(vqt["min_freq"]) * 2.0 ** ((semitone + detune) / 12.0)
    voices = rng.integers(1, MAX_VOICES + 1, (n_tracks, n_notes))
    f0 = np.where(np.arange(MAX_VOICES)[None, None, :] < voices[..., None], f0, 0.0)
    level_lo, level_hi = music["level_db"]
    level = 10.0 ** (rng.uniform(level_lo, level_hi, (n_tracks, n_notes)) / 20.0)
    decay = rng.uniform(0.3, 1.5, (n_tracks, n_notes))
    return starts, dur, f0, level, decay


def make_music(seed: int, n_streams: int, n_hops: int, hop: int, sr: float, music: dict, vqt: dict,
               device) -> Music:
    """Tracks long enough for ``n_hops`` hops of every stream at its offset,
    and each stream's track, offset and level, all from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    n_tracks = int(music["tracks"])
    spread = int(round(music["offset_seconds"] * sr / hop))
    n_track_hops = n_hops + spread
    n_samples = n_track_hops * hop
    seconds = n_samples / sr
    starts, dur, f0, level, decay = _note_table(rng, n_tracks, seconds, music, vqt)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 2]).integers(0, 2**62)))
    partials = int(music["partials"])
    weights = torch.tensor([1.0 / h for h in range(1, partials + 1)], dtype=torch.float64, device=device)
    noise_amp = 10.0 ** (music["noise_db"] / 20.0)
    t = torch.arange(n_samples, dtype=torch.float64, device=device) / sr
    rows = []
    for k in range(n_tracks):
        # the note sounding at each sample, and the time since its start
        idx = torch.searchsorted(torch.from_numpy(starts[k]).to(device), t, right=True) - 1
        since = t - torch.from_numpy(starts[k]).to(device)[idx]
        env = torch.clamp(since / 0.01, max=1.0) * torch.exp(-since / torch.from_numpy(decay[k]).to(device)[idx])
        amp = torch.from_numpy(level[k]).to(device)[idx] * env * 0.3
        f = torch.from_numpy(f0[k]).to(device)[idx]  # (n_samples, voices)
        phase = torch.remainder(torch.cumsum(2.0 * math.pi * f / sr, dim=0), 2.0 * math.pi)
        h = torch.arange(1, partials + 1, dtype=torch.float64, device=device)
        audible = (f[..., None] * h < 0.45 * sr) & (f[..., None] > 0)
        tone = (torch.sin(phase[..., None] * h) * weights * audible).sum(dim=(-1, -2))
        noise = torch.randn(n_samples, generator=gen, dtype=torch.float64, device=device) * noise_amp
        rows.append((amp * tone + noise).float())
    rows.append(torch.zeros(n_samples, dtype=torch.float32, device=device))
    tracks = torch.stack(rows)

    track_of = rng.integers(0, n_tracks, n_streams)
    silent = (np.arange(n_streams) % int(music["silent_every"])) == int(music["silent_every"]) - 1
    track_of = np.where(silent, n_tracks, track_of).astype(np.int64)
    offset = rng.integers(0, spread + 1, n_streams).astype(np.int64)
    stream_level = (10.0 ** (rng.uniform(-6.0, 6.0, n_streams) / 20.0)).astype(np.float32)
    return Music(tracks, track_of, offset, stream_level, hop)


def silent_streams(n_streams: int, music: dict) -> np.ndarray:
    every = int(music["silent_every"])
    return np.flatnonzero((np.arange(n_streams) % every) == every - 1)


def sample_streams(seed: int, n_streams: int, count: int, music: dict) -> np.ndarray:
    """``count`` streams for the comparison, one from each of ``count``
    equal strata of the batch (so every part of it is
    covered), drawn from ``seed``; the first stratum gives a silent
    stream."""
    rng = np.random.default_rng([seed, 3])
    count = min(count, n_streams)
    bounds = np.linspace(0, n_streams, count + 1).astype(np.int64)
    rows = [int(rng.integers(lo, hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]
    silent = silent_streams(n_streams, music)
    first = silent[(silent >= bounds[0]) & (silent < bounds[1])]
    if len(first):
        rows[0] = int(first[0])
    return np.array(rows, np.int64)
