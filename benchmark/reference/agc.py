"""The dagc AGC recurrence (dagc_fork/src/lib.rs:76-87), in float64.

Per sample, ``out = x * gain``, and unless the chunk is frozen
``gain *= max(1 + k * (1 - out^2 / desired_rms), k)``; a chunk freezes the
gain when its pre-gain energy is under 1e-6 (pitchvis_audio/src/
audio_desktop.rs:99-127). Written for the benchmark from that definition
(the program runs it in C++ on the host and in its AGC kernel on the card):
each chunk is cut into blocks of ``BLOCK`` samples, and each block's gains
are found as the fixed point of ``g[i+1] = g[0] * prod(f(x[j] g[j]), j <= i)``
by iteration, which converges in a few rounds because ``k`` is small; a
block that does not converge, where a loud onset drives the factor to its
floor, is run sample by sample.
"""

from __future__ import annotations

import numpy as np

SILENCE_ENERGY = 1e-6
BLOCK = 256
ROUNDS = 40


def _block_sequential(x, g, k, inv):
    out = np.empty_like(x)
    for i in range(x.shape[1]):
        out[:, i] = x[:, i] * g
        y = out[:, i] * out[:, i] * inv
        g = g * np.maximum(1.0 + k * (1.0 - y), k)
    return out, g


def _block(x: np.ndarray, g0: np.ndarray, k: float, inv: float):
    """(S, n) samples, (S,) gains -> ((S, n) processed, (S,) gains after)."""
    g = np.repeat(g0[:, None], x.shape[1], axis=1)
    for _ in range(ROUNDS):
        out = x * g
        f = np.maximum(1.0 + k * (1.0 - out * out * inv), k)
        prod = np.cumprod(f, axis=1)
        new = np.concatenate([g0[:, None], g0[:, None] * prod[:, :-1]], axis=1)
        done = np.array_equal(new, g)
        g = new
        if done:
            return x * g, g0 * prod[:, -1]
    return _block_sequential(x, g0, k, inv)


def agc_chunks(chunks: np.ndarray, desired_rms: float = 0.07, distortion: float = 1e-4,
               gain: np.ndarray | None = None):
    """(S, C, T) raw chunks, pushed in order -> ((S, C, T) processed in
    float64, (S, C) gain after each chunk). Non-finite input is refused:
    the benchmark's traffic has none."""
    x = np.asarray(chunks, np.float64)
    if not np.isfinite(x).all():
        raise ValueError("the reference AGC takes finite audio only")
    s, c, t = x.shape
    k, inv = float(distortion), 1.0 / float(desired_rms)
    g = np.ones(s) if gain is None else np.asarray(gain, np.float64).copy()
    out = np.empty_like(x)
    gains = np.empty((s, c))
    energy = (x * x).sum(axis=2)
    for ci in range(c):
        frozen = energy[:, ci] < SILENCE_ENERGY
        live = ~frozen
        out[frozen, ci] = x[frozen, ci] * g[frozen, None]
        if live.any():
            gl = g[live]
            xl = x[live, ci]
            parts = []
            for b in range(0, t, BLOCK):
                o, gl = _block(xl[:, b : b + BLOCK], gl, k, inv)
                parts.append(o)
            out[live, ci] = np.concatenate(parts, axis=1)
            g[live] = gl
        gains[:, ci] = g
    return out, gains
