"""Shared helpers of the tests that hold pitchvis_tpu_torch against
pitchvis_tpu: parameter conversion between the two packages' (identical)
config dataclasses, seeded input signals, made with NumPy so both packages
see the same bits, and a fixture that makes the JAX package's native
library safe to load from several test workers at once (the checkout's
conftest.py builds it under the same lock before any module is
collected)."""

from __future__ import annotations

import dataclasses
import fcntl
import os
import subprocess
import time

import numpy as np
import pytest

import pitchvis_tpu.core.config as jcfg
import pitchvis_tpu_torch.core.config as tcfg

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def seeded_analysis_outputs(n_streams: int, n: int, seed: int) -> dict:
    """One frame of analysis outputs for ``n_streams`` >= 3 streams of ``n``
    bins, as NumPy arrays under the AnalysisOutputs field names, shaped like
    what the analysis emits: peaks at least 2 bins apart, each peak's center
    within one bin of it (exact half-bin offsets included), centers and sizes
    zero off the peaks. Stream 0 has seeded peaks, stream 1 is silent (all
    zeros), stream 2 has a run of peaks at the 2-bin minimum distance whose
    centers key neighbouring bins, the rest seeded peaks like stream 0."""
    assert n_streams >= 3
    r = np.random.default_rng(seed)
    peaks = np.zeros((n_streams, n), bool)
    for s in range(n_streams):
        if s == 1:
            continue
        if s == 2:
            peaks[s, 3 : n // 2 : 2] = True
            continue
        i = 2
        while i < n - 1:
            if r.random() < 0.12:
                peaks[s, i] = True
                i += 2
            else:
                i += 1
    offset = r.uniform(-1.0, 1.0, (n_streams, n))
    offset[r.random((n_streams, n)) < 0.1] = 0.5
    center = np.where(peaks, np.clip(np.arange(n) + offset, 0.0, n - 1.0), 0.0).astype(np.float32)
    size = np.where(peaks, r.uniform(0.5, 30.0, (n_streams, n)), 0.0).astype(np.float32)
    smoothed = r.uniform(0.0, 40.0, (n_streams, n)).astype(np.float32)
    calmness = r.uniform(0.0, 1.0, (n_streams, n)).astype(np.float32)
    accuracy = np.where(peaks, r.uniform(0.0, 1.0, (n_streams, n)), 0.0).astype(np.float32)
    deviation = np.where(peaks, r.uniform(-0.5, 0.5, (n_streams, n)), 0.0).astype(np.float32)
    out = {
        "x_vqt_smoothed": smoothed,
        "x_vqt_peakfiltered": np.where(peaks, smoothed, 0.0).astype(np.float32),
        "x_vqt_afterglow": smoothed,
        "peaks": peaks,
        "peak_center": center,
        "peak_size": size,
        "calmness": calmness,
        "pitch_accuracy": accuracy,
        "pitch_deviation": deviation,
        "scene_calmness": r.uniform(0.0, 1.0, n_streams).astype(np.float32),
        "tuning_inaccuracy": r.uniform(0.0, 30.0, n_streams).astype(np.float32),
    }
    for k, v in out.items():
        if k != "peaks":
            v[1] = 0.0
    return out


def u8_within_one_level(got, want, share: float, what: str = "") -> None:
    """u8-valued arrays (or levels as floats) within one level of each
    other, in at most ``share`` of the values."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1.0, f"{what}: a level moved by {d.max()}"
    assert (d > 0).mean() <= share, f"{what}: {(d > 0).sum()} of {d.size} levels flipped"


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


def _fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding, as ``__fmaf_rn`` computes it:
    the product of two float32 values is exact in float64, and where the
    float64 sum lands exactly halfway between two float32 values, the exact
    error of the sum (TwoSum) decides the direction."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.float64(np.float32(b))
    c = np.float64(np.float32(c))
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    nb = np.nextafter(r, np.where(s > r64, np.inf, -np.inf).astype(np.float32))
    halfway = (s != r64) & (s == (r64 + nb.astype(np.float64)) * 0.5) & (err != 0)
    return np.where(halfway, np.where(err > 0, np.maximum(r, nb), np.minimum(r, nb)), r)


def ring_push_kernel_emulation(buffer, gain, chunk, k, inv_rms, silence, *, src_offset=0,
                               threads=256, unroll=8, tile=1024):
    """NumPy emulation, block by block, of the ring mode of
    pitchvis_tpu_torch/csrc/agc.cu (the kernel itself only runs on a CUDA
    card), with its memory as flat float32 arrays:

    1. the vote: each thread tests its strided chunk samples for non-finite
       values, the block ORs them; a rejected row copies its whole buffer row
       and keeps its gain;
    2. warp 0: the energy as 32 lanes' strided sums and an xor butterfly,
       then a frozen row's x*g across the lanes, any other row's recurrence
       in lane 0 over tiles of ``tile`` samples staged in shared memory,
       appended at new_buffer[L-T:L];
    3. the other warps: the shift of buffer[T:L] to new_buffer[0:L-T] as the
       kernel's ``copy_row`` does it, a scalar head to the destination's
       16-byte boundary, aligned float4 stores each built from the two aligned
       float4 loads around its four source samples (thread t takes vectors t +
       nt * (u + unroll * m)), a scalar tail.

    The source buffer lies ``src_offset`` floats past a 16-byte boundary
    (rows of stride L); the new buffer is a fresh, aligned allocation. Checks
    as it goes that every aligned load holds a source sample of its row and
    lies inside the allocation, and that every output float is written
    exactly once. Returns (new_buffer, new_gain)."""
    buffer = np.asarray(buffer, np.float32)
    chunk = np.asarray(chunk, np.float32)
    b_rows, length = buffer.shape
    t_len = chunk.shape[1]
    alloc = -(-(src_offset + b_rows * length) // 4) * 4  # whole 16-byte words
    src_mem = np.zeros(alloc, np.float32)
    src_mem[src_offset : src_offset + b_rows * length] = buffer.ravel()
    dst_mem = np.zeros(b_rows * length, np.float32)
    written = np.zeros(b_rows * length, np.int64)
    new_gain = np.asarray(gain, np.float32).copy()

    def copy_row(dst, src, n, nt):
        head = min(n, (-dst) % 4)
        for t in range(min(head, nt)):
            dst_mem[dst + t] = src_mem[src + t]
            written[dst + t] += 1
        dst, src, n = dst + head, src + head, n - head
        nv, r = n >> 2, src % 4
        if nv:
            assert dst % 4 == 0, "float4 stores start on a 16-byte boundary"
            taken = np.concatenate([
                np.arange(t + u * nt, nv, unroll * nt) for t in range(nt) for u in range(unroll)])
            assert np.array_equal(np.sort(taken), np.arange(nv)), "each vector once"
            aligned = src - r + 4 * np.arange(nv)
            lanes = np.arange(8 if r else 4)
            idx = aligned[:, None] + lanes
            assert idx.min() >= 0 and idx.max() < alloc, "an aligned load leaves the allocation"
            # the first load holds src[4i], the second (r > 0) src[4i + 3]
            assert np.all(aligned + 4 > src + 4 * np.arange(nv))
            if r:
                assert np.all(aligned + 4 <= src + 4 * np.arange(nv) + 3)
            vals = src_mem[idx][:, r : r + 4]
            dst_mem[dst : dst + 4 * nv] = vals.ravel()
            written[dst : dst + 4 * nv] += 1
        for t in range(min(n & 3, nt)):
            dst_mem[dst + 4 * nv + t] = src_mem[src + 4 * nv + t]
            written[dst + 4 * nv + t] += 1

    good, frozen = [], []
    for b in range(b_rows):
        x = chunk[b]
        src_row, dst_row = src_offset + b * length, b * length
        votes = [not np.isfinite(x[t::threads]).all() for t in range(threads)]
        if any(votes):
            copy_row(dst_row, src_row, length, threads)
            continue
        copy_row(dst_row, src_row + t_len, length - t_len, threads - 32)
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            for v in x[lane::32]:
                lanes[lane] = np.float32(lanes[lane] + np.float32(v * v))
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
        good.append(b)
        frozen.append(bool(lanes[0] < np.float32(silence)))
    # lane 0 of each kept row's warp 0, the rows side by side (each its own block)
    frozen = np.array(frozen, bool)
    g = np.asarray(gain, np.float32)[good]
    k32 = np.float32(k)
    for base in range(0, t_len, tile):
        staged = chunk[good, base : base + tile].copy()
        for t in range(staged.shape[1]):
            o = (staged[:, t] * g).astype(np.float32)
            staged[:, t] = o
            upd = _fma32(_fma32(-(o * o).astype(np.float32), inv_rms, 1.0), k, 1.0)
            upd = np.where((upd >= k32) | (upd != upd), upd, k32)
            g = np.where(frozen, g, (g * upd).astype(np.float32))
        for i, b in enumerate(good):
            tail = b * length + length - t_len + base
            dst_mem[tail : tail + staged.shape[1]] = staged[i]
            written[tail : tail + staged.shape[1]] += 1
    new_gain[good] = g
    assert (written == 1).all(), "every output float written exactly once"
    return dst_mem.reshape(b_rows, length), new_gain


@pytest.fixture(scope="session")
def jax_native_lib():
    """The JAX package's native library, built before this worker's first
    JAX native load: ``make -C native`` under an exclusive lock on a file in
    build/ (shared by every test worker that uses this fixture), retried
    until the library loads. The JAX loader (pitchvis_tpu/runtime/native.py)
    runs ``make`` unlocked at first use and remembers a failure for the rest
    of the process, so a worker that lost a build race to another would
    fail every JAX server test it runs; its memory of that failure is
    cleared here once the library loads."""
    from pitchvis_tpu.runtime import native as jax_native

    native_dir = os.path.join(_ROOT, "native")
    lock_dir = os.path.join(_ROOT, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "jax_native_make.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(5):
            if jax_native._lib is not None:
                break
            jax_native._tried = False
            if jax_native.available():
                break
            subprocess.run(["make", "-C", native_dir], capture_output=True, timeout=300)
            time.sleep(1.0)
    assert jax_native._lib is not None, "native/libpitchvis_native.so did not build or load"
    return jax_native


def _silence_energy(x):
    """The pre-gain energy of a chunk as a warp sums it in csrc/agc.cu: 32
    lanes' float32 sums of x[lane::32] in order, then an xor butterfly;
    lane 0's value."""
    lanes = np.zeros(32, np.float32)
    for lane in range(32):
        for v in x[lane::32]:
            lanes[lane] = np.float32(lanes[lane] + np.float32(v * v))
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
    return lanes[0]


def agc_signal_kernel_emulation(signal, chunk, k, inv_rms, silence, *, tile=1024, slots=4, stats=None):
    """NumPy emulation, row by row, of the signal mode of
    pitchvis_tpu_torch/csrc/agc.cu (the kernel itself only runs on a CUDA
    card): a block of two warps a row. Chunk c is cut into pieces of
    ``tile`` samples (its last shorter); piece q of the row lives in slot q
    % ``slots`` of a ring of slots of tile + 8 floats. The two warps'
    steps, in an order the kernel's barriers allow:

    1. the producer, ahead of the chain: a chunk's freeze flag as it stages
       the chunk's first piece (the warp's lane-strided energy and xor
       butterfly, :func:`_silence_energy`), the first ``slots`` pieces, and,
       once the consumer has released piece q, its store to the output (the
       chunk's gain after the chunk's last piece) and the staging of piece q
       + ``slots`` in that slot;
    2. the consumer: a frozen piece as x*g across its 32 lanes, the gain
       held; any other piece through lane 0's chain, eight samples a turn
       with the next turn's eight loaded first, then the rest one by one,
       the gain carried from piece to piece and chunk to chunk (1 before the
       first). Steps where the max clamps the update at k are counted in
       ``stats["clamped_steps"]`` when ``stats`` is a dict.

    Rows padded with zero chunks go through it as they are. Checks as it
    goes that the consumer finds each piece in the slot it was staged in,
    that no slot is restaged before its piece was stored, that the chain's
    loads stay inside the slot, and that every output float and every gain
    is written exactly once. Returns ((B, C * chunk) processed, (B, C)
    gains)."""
    signal = np.asarray(signal, np.float32)
    b_rows, n = signal.shape
    n_chunks = n // chunk
    per_chunk = -(-chunk // tile)
    pieces = n_chunks * per_chunk
    stride = tile + 8
    out = np.zeros((b_rows, n_chunks * chunk), np.float32)
    gains = np.zeros((b_rows, n_chunks), np.float32)
    out_written = np.zeros(out.shape, np.int64)
    gains_written = np.zeros(gains.shape, np.int64)
    k32 = np.float32(k)

    def piece(q):
        c, off = q // per_chunk, (q % per_chunk) * tile
        return c, off, min(tile, chunk - off)

    clamped = 0

    def step(x, g):
        nonlocal clamped
        o = np.float32(x * g)
        upd = _fma32(_fma32(-np.float32(o * o), inv_rms, 1.0), k, 1.0)
        clamped += bool(upd < k32)
        upd = upd if (upd >= k32 or upd != upd) else k32  # max.NaN.f32
        return o, np.float32(g * upd)

    for b in range(b_rows):
        x = signal[b]
        ring = np.zeros((slots, stride), np.float32)
        held = [None] * slots
        slot_frozen = [False] * slots
        slot_gain = [None] * slots
        frozen = False

        def stage(q):
            nonlocal frozen
            c, off, m = piece(q)
            if off == 0:
                frozen = bool(_silence_energy(x[c * chunk : (c + 1) * chunk]) < np.float32(silence))
            s = q % slots
            assert held[s] is None, "a slot restaged before its piece was stored"
            ring[s, :m] = x[c * chunk + off : c * chunk + off + m]
            held[s], slot_frozen[s] = q, frozen

        for q in range(min(slots, pieces)):
            stage(q)
        g = np.float32(1.0)
        for q in range(pieces):
            s = q % slots
            c, off, m = piece(q)
            assert held[s] == q, "the consumer found another piece in its slot"
            if slot_frozen[s]:
                ring[s, :m] = (ring[s, :m] * g).astype(np.float32)
            else:
                turns = m // 8
                assert 8 * turns + 8 <= stride, "the chain's loads leave the slot"
                for t in range(m):
                    ring[s, t], g = step(ring[s, t], g)
            if off + m == chunk:
                slot_gain[s] = g
            # the producer, once the slot is released
            out[b, c * chunk + off : c * chunk + off + m] = ring[s, :m]
            out_written[b, c * chunk + off : c * chunk + off + m] += 1
            if off + m == chunk:
                gains[b, c] = slot_gain[s]
                gains_written[b, c] += 1
            held[s] = None
            if q + slots < pieces:
                stage(q + slots)
    assert (out_written == 1).all() and (gains_written == 1).all(), "an output written other than once"
    if stats is not None:
        stats["clamped_steps"] = clamped
    return out, gains
