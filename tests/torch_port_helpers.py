"""Shared helpers of the tests that hold pitchvis_tpu_torch against
pitchvis_tpu: parameter conversion between the two packages' (identical)
config dataclasses and seeded input signals, made with NumPy so both
packages see the same bits."""

from __future__ import annotations

import dataclasses

import numpy as np

import pitchvis_tpu.core.config as jcfg
import pitchvis_tpu_torch.core.config as tcfg


def to_port(obj):
    """A pitchvis_tpu config dataclass -> the equal pitchvis_tpu_torch one."""
    cls = getattr(tcfg, type(obj).__name__)
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kwargs[f.name] = to_port(v) if dataclasses.is_dataclass(v) else v
    return cls(**kwargs)


def default_params():
    return jcfg.VqtParameters()


def streams(n_streams: int, n_samples: int, sr: float, seed: int) -> np.ndarray:
    """(B, T) float32: per stream two seeded sines plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.5, (n_streams, 2, 1))
    a = rng.uniform(0.05, 0.4, (n_streams, 2, 1))
    sig = (a * np.sin(2 * np.pi * f * t)).sum(axis=1)
    sig += 0.01 * rng.standard_normal((n_streams, n_samples))
    return sig.astype(np.float32)


def peaks_kernel_emulation(x, configs, distance, rounds, min_bin, step=32):
    """NumPy emulation, row by row, of the per-row algorithm of
    pitchvis_tpu_torch/csrc/peaks.cu in its candidates-only mode, stage by
    stage as the kernel runs it (the kernel itself only runs on a CUDA card):

    1. local maxima by scatter from each plateau's first bin;
    2. a flag byte a bin: bit 0 local maximum, bit 1 + c candidate of
       configuration c (at or above its min_height), and a list of the bins
       that are a candidate of any configuration;
    3. Jacobi suppression rounds over that list on double-buffered bytes,
       ``rounds < 0`` until a round changes nothing, else exactly ``rounds``
       rounds;
    4. the prominence at the list's survivors only, reading outward ``step``
       samples at a time to the nearest strictly greater one;
    5. one mask per configuration.

    x: (B, n) float32; configs: one or two (min_height, min_prominence)
    pairs. Returns a list of (B, n) bool arrays."""
    x = np.asarray(x, np.float32)
    b, n = x.shape
    heights = [np.float32(h) for h, _ in configs]
    proms = [np.float32(p) for _, p in configs]
    out = [np.zeros((b, n), bool) for _ in configs]

    def window_min(xs, i, h, direction):
        m = h
        base = i + direction
        while 0 <= base < n:
            lanes = [base + direction * lane for lane in range(step)]
            # beyond the row a lane holds h: no end of the window, no new minimum
            vals = [xs[j] if 0 <= j < n else h for j in lanes]
            greater = [v > h for v in vals]
            stop = greater.index(True) if any(greater) else step
            for v in vals[:stop]:
                m = min(m, v)
            if any(greater):
                break
            base += step * direction
        return m

    for row in range(b):
        xs = x[row]
        flag = np.zeros(n, np.uint8)
        candidates = []
        for i in range(1, n):
            if not xs[i - 1] < xs[i]:
                continue
            e = i
            while e < n - 1 and xs[e + 1] == xs[i]:
                e += 1
            if e < n - 1 and xs[e + 1] < xs[i]:
                f = 1
                for c, h in enumerate(heights):
                    if xs[i] >= h:
                        f |= 2 << c
                flag[(i + e) >> 1] = f
                if f > 1:
                    candidates.append((i + e) >> 1)
        # the kernel's list is in no particular order
        candidates.reverse()
        sup = [np.zeros(n, np.uint8), np.zeros(n, np.uint8)]
        p = 0
        if distance >= 2:
            pad = distance - 1
            r = 0
            while rounds < 0 or r < rounds:
                changed = False
                for i in candidates:
                    hit = 0
                    for j in range(max(0, i - pad), min(n - 1, i + pad) + 1):
                        if j == i:
                            continue
                        alive = (flag[j] >> 1) & ~sup[p][j] & 3
                        if alive and (xs[j] > xs[i] or (xs[j] == xs[i] and j > i)):
                            hit |= alive
                    hit &= (flag[i] >> 1) & 3
                    changed |= hit != sup[p][i]
                    sup[p ^ 1][i] = hit
                p ^= 1
                r += 1
                if rounds < 0 and not changed:
                    break
        for i in candidates:
            alive = (flag[i] >> 1) & ~sup[p][i] & 3
            if not alive or i < min_bin:
                continue
            h = xs[i]
            prom = h - max(window_min(xs, i, h, -1), window_min(xs, i, h, +1))
            for c in range(len(configs)):
                if alive & (1 << c) and prom >= proms[c]:
                    out[c][row, i] = True
    return out
