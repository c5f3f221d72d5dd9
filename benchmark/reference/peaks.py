# Frozen copy of pitchvis_tpu_torch/ops/peaks.py at commit 5c134db8c4ad,
# the plain reference of the benchmark: it imports nothing of the program.
# Added in this copy: prominences_at (prominences' reductions at marked bins only).
"""Vectorized spectral peak detection.

Port of ``pitchvis_tpu/ops/peaks.py``, the reference's peak pipeline
(`pitchvis_analysis/src/analysis_modules/peak_detection.rs`, a wrapper of
the `find_peaks` crate, itself a scipy.signal.find_peaks port). Peaks are
per-bin masks and per-bin continuous values. Every function here works on
the last axis of a (..., n) tensor, so a stream batch rides the leading axes.

Algorithms (scipy semantics, filter order: height -> distance -> prominence):

* local maxima with plateau handling (plateau midpoint is the peak
  position): run boundaries + packed-cummax segmented fills;
* prominence via "nearest strictly-greater element" + window minima as
  masked broadcast-reductions, O(n^2) per spectrum (`prominences`, the plain
  version of the peaks kernel in ops/peaks_pallas.py) or on a pair-compacted
  candidate axis (`prominences_compact`);
* min-distance suppression (priority = peak height, ties to the higher
  index, matching scipy's argsort-from-the-end iteration) as a Jacobi
  fixpoint: a candidate is suppressed iff an unsuppressed higher-priority
  candidate lies strictly within `distance`. The greedy solution is the
  unique fixpoint; by default the rounds run to exact convergence (musical
  spectra: 2-3 rounds).

`find_peaks_mask`, `_suppress_by_distance` and `prominences` are the plain
version of the peaks kernel and the CPU route. Their convergence check reads
the device from the host once a round, so on the card the analysis step
takes its masks from ops/peaks_pallas.py::find_peaks_masks instead, which
runs the same rounds inside one kernel launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import PeakDetectionParameters, VqtRange

_NEG = float(np.float32(-3.0e38))
_POS = float(np.float32(3.0e38))


def min_separation_bins(buckets_per_octave: int) -> int:
    """0.4-semitone minimum peak separation (peak_detection.rs:37), with
    Rust's round-half-away-from-zero."""
    return int(math.floor(buckets_per_octave * 0.4 / 12.0 + 0.5))


def first_allowed_bin(buckets_per_octave: int) -> int:
    """Drop the lowest ~half semitone (peak_detection.rs:45): min_bin =
    div_ceil(buckets_per_octave / 12, 2)."""
    per_semitone = buckets_per_octave // 12
    return -(-per_semitone // 2)


def _shift(a: torch.Tensor, off: int, fill) -> torch.Tensor:
    """b[..., i] = a[..., i + off] where 0 <= i + off < n, else ``fill``."""
    n = a.shape[-1]
    out = torch.full_like(a, fill)
    if off >= 0:
        if off < n:
            out[..., : n - off] = a[..., off:]
    elif -off < n:
        out[..., -off:] = a[..., : n + off]
    return out


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of local maxima with plateau handling: a plateau run
    [s, e] is a peak iff x[s-1] < x[s] and x[e+1] < x[e]; the peak position
    is the plateau midpoint (s + e) // 2. Edges cannot be peaks.

    The neighbor comparisons are evaluated once at each run boundary and
    propagated along the run by a cummax over (index, flag) pairs packed into
    one integer (the index majorizes, so the scan carries the flag of the
    latest run boundary at or before each position)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.bool, device=x.device)
    neq = x[..., 1:] != x[..., :-1]
    change = torch.cat([ones, neq], dim=-1)
    change_next = torch.cat([neq, ones], dim=-1)

    # The roll wrap-around only corrupts position 0 (start) / n-1 (end),
    # whose runs are excluded by s > 0 / e < n-1 below.
    start_flag = change & (torch.roll(x, 1, dims=-1) < x)
    end_flag = change_next & (torch.roll(x, -1, dims=-1) < x)

    minus_one = torch.full((), -1, dtype=torch.int64, device=x.device)
    packed = torch.cummax(torch.where(change, idx * 2 + start_flag.long(), minus_one), dim=-1).values
    s = packed >> 1
    prev_less = packed % 2 == 1
    ridx = n - 1 - idx
    packed_r = torch.cummax(
        torch.where(change_next, ridx * 2 + end_flag.long(), minus_one).flip(-1), dim=-1
    ).values.flip(-1)
    e = n - 1 - (packed_r >> 1)
    next_less = packed_r % 2 == 1

    prev_ok = (s > 0) & prev_less
    next_ok = (e < n - 1) & next_less
    mid = (s + e) // 2
    return prev_ok & next_ok & (idx == mid)


def prominences(x: torch.Tensor) -> torch.Tensor:
    """Per-bin scipy-style prominence (valid at local maxima): the peak
    height minus the higher of the two window minima, where each window
    extends to the nearest strictly-greater sample (or the signal edge).

    Four O(n^2) masked broadcast-reductions: a (..., n, n) intermediate per
    spectrum, which is why the hot path runs the peaks kernel instead."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    i = idx[:, None]  # peak position
    j = idx[None, :]  # scanned position
    xi = x[..., :, None]
    xj = x[..., None, :]
    pos = torch.tensor(_POS, dtype=x.dtype, device=x.device)
    greater = xj > xi

    # nearest strictly-greater element on each side (-1 / n if none)
    left_bound = torch.where((j < i) & greater, j, -1).amax(dim=-1)
    right_bound = torch.where((j > i) & greater, j, n).amin(dim=-1)

    # window minima: min x[left_bound+1 .. i] and min x[i .. right_bound-1]
    left_min = torch.where((j > left_bound[..., None]) & (j <= i), xj, pos).amin(dim=-1)
    right_min = torch.where((j >= i) & (j < right_bound[..., None]), xj, pos).amin(dim=-1)
    return x - torch.maximum(left_min, right_min)


def prominences_at(x: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Per-bin prominences at the bins of the bool mask ``at`` (the local
    maxima), all other bins -inf-ish: :func:`prominences`'s four masked
    reductions, run on the rows of the marked bins only, so each marked bin
    gets exactly :func:`prominences`'s value. Added to this copy for the
    benchmark's reference, which runs the analysis chain of thousands of
    hops on the CPU; ``find_peaks_mask`` reads prominence only at local
    maxima."""
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    rows, cols = torch.nonzero(at.reshape(-1, n), as_tuple=True)
    out = torch.full_like(flat, _NEG)
    if rows.numel() == 0:
        return out.reshape(x.shape)
    xr = flat[rows]
    c = cols[:, None]
    h = xr.gather(1, c)
    j = torch.arange(n, device=x.device)[None, :]
    pos = torch.tensor(_POS, dtype=x.dtype, device=x.device)
    greater = xr > h
    left_bound = torch.where((j < c) & greater, j, -1).amax(dim=-1, keepdim=True)
    right_bound = torch.where((j > c) & greater, j, n).amin(dim=-1, keepdim=True)
    left_min = torch.where((j > left_bound) & (j <= c), xr, pos).amin(dim=-1, keepdim=True)
    right_min = torch.where((j >= c) & (j < right_bound), xr, pos).amin(dim=-1, keepdim=True)
    out[rows, cols] = (h - torch.maximum(left_min, right_min))[:, 0]
    return out.reshape(x.shape)


def prominences_compact(
    x: torch.Tensor,
    lmax: torch.Tensor,
    min_height: float | None = None,
) -> torch.Tensor:
    """Per-bin prominences, computed only at local maxima (optionally
    pre-filtered by ``min_height``); all other bins read as -inf-ish.
    Exactly equal to :func:`prominences` at every local-maximum bin.

    Consecutive local maxima are always >= 2 bins apart, so the bin pair
    (2k, 2k+1) holds at most one candidate: compaction to n/2 candidate
    slots and the scatter-back are reshapes."""
    n = x.shape[-1]
    n2 = (n + 1) // 2
    pad = 2 * n2 - n
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x, (0, pad), value=_NEG)
    lp = torch.nn.functional.pad(lmax, (0, pad), value=False)
    if min_height is not None:
        lp = lp & (xp >= min_height)
    x2 = xp.reshape(lead + (n2, 2))
    l2 = lp.reshape(lead + (n2, 2))
    first = l2[..., 0]
    valid = (first | l2[..., 1])[..., None]
    k2 = torch.arange(n2, device=x.device) * 2
    c = torch.where(first, k2, k2 + 1)[..., None]
    h = torch.where(first, x2[..., 0], x2[..., 1])[..., None]
    pos = torch.tensor(_POS, dtype=x.dtype, device=x.device)
    neg = torch.tensor(_NEG, dtype=x.dtype, device=x.device)
    # invalid slots get h=+inf so the bound reductions terminate immediately
    hi = torch.where(valid, h, pos)

    j = torch.arange(n, device=x.device)
    xj = x[..., None, :]
    greater = xj > hi
    left_bound = torch.where((j < c) & greater, j, -1).amax(dim=-1, keepdim=True)
    right_bound = torch.where((j > c) & greater, j, n).amin(dim=-1, keepdim=True)
    left_min = torch.where((j > left_bound) & (j <= c), xj, pos).amin(dim=-1, keepdim=True)
    right_min = torch.where((j >= c) & (j < right_bound), xj, pos).amin(dim=-1, keepdim=True)
    prom_k = torch.where(valid, h - torch.maximum(left_min, right_min), neg)[..., 0]

    out2 = torch.stack(
        [torch.where(first, prom_k, neg), torch.where(~first & l2[..., 1], prom_k, neg)],
        dim=-1,
    )
    return out2.reshape(lead + (2 * n2,))[..., :n]


def _suppress_by_distance(
    candidate: torch.Tensor,
    height: torch.Tensor,
    distance: int,
    max_iterations: int | None = None,
) -> torch.Tensor:
    """Greedy min-distance selection (scipy _select_by_peak_distance):
    among candidates, iteratively suppress any with an unsuppressed
    strictly-higher-priority candidate strictly within `distance` bins.
    Priority = (height, index); larger index wins exact-height ties.

    ``max_iterations=None`` iterates to exact convergence, checking on the
    host after every round (one synchronisation per round); an int runs that
    many rounds with no check."""
    pad = distance - 1
    # neighbor j = i + off for every off in [-pad, pad] but 0, as the
    # columns of a sliding window over the padded spectrum
    offsets = torch.tensor(
        [off for off in range(-pad, pad + 1) if off != 0], device=height.device
    )
    cols = offsets + pad
    h_j = torch.nn.functional.pad(height, (pad, pad)).unfold(-1, 2 * pad + 1, 1)[..., cols]
    h_i = height[..., None]
    # which neighbors outrank bin i; fixed across rounds (padding columns are
    # never alive, so their values do not matter)
    higher = (h_j > h_i) | ((h_j == h_i) & (offsets > 0))
    no = torch.zeros(candidate.shape[:-1] + (pad,), dtype=torch.bool, device=candidate.device)

    def has_higher_neighbor(suppressed):
        alive = torch.cat([no, candidate & ~suppressed, no], dim=-1)
        alive_j = alive.unfold(-1, 2 * pad + 1, 1)[..., cols]
        return (alive_j & higher).any(dim=-1) & candidate

    suppressed = torch.zeros_like(candidate)
    if max_iterations is not None:
        for _ in range(max_iterations):
            suppressed = has_higher_neighbor(suppressed)
        return candidate & ~suppressed

    while True:
        new = has_higher_neighbor(suppressed)
        if torch.equal(new, suppressed):
            break
        suppressed = new
    return candidate & ~suppressed


def find_peaks_mask(
    x: torch.Tensor,
    config: PeakDetectionParameters,
    buckets_per_octave: int,
    *,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
    suppress_iterations: int | None = None,
) -> torch.Tensor:
    """Discrete peak mask, matching `find_peaks` (peak_detection.rs:26-51):
    local maxima filtered by min_height, then min-distance (0.4 semitones),
    then min_prominence; the first ~half semitone of bins is dropped.

    ``precomputed``: optional (local_maxima, prominences) pair — both are
    threshold-independent, so callers applying several configs to the same
    spectrum (analysis.rs:331-349) compute them once. Prominence is read
    only at local maxima at or above ``config.min_height``.
    """
    if precomputed is None:
        mask, prom = local_maxima(x), None
    else:
        mask, prom = precomputed
    mask = mask & (x >= config.min_height)
    d = min_separation_bins(buckets_per_octave)
    if d >= 2:
        mask = _suppress_by_distance(mask, x, d, suppress_iterations)
    if prom is None:
        prom = prominences(x)
    mask = mask & (prom >= config.min_prominence)
    min_bin = first_allowed_bin(buckets_per_octave)
    return mask & (torch.arange(x.shape[-1], device=x.device) >= min_bin)


def enhance_peaks_continuous(
    peak_mask: torch.Tensor, x: torch.Tensor, rng: VqtRange
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sub-bin peak refinement (peak_detection.rs:61-148): fit a Lagrange
    parabola in log-frequency space around each peak, clamp its maximum to
    the neighbor bins, and linearly interpolate the amplitude at the refined
    center.

    Returns per-bin tensors (center, size); entries are only meaningful where
    ``peak_mask`` is set. Centers are in fractional bins; sizes in dB >= 0.
    """
    n = x.shape[-1]
    idx_f = torch.arange(n, device=x.device, dtype=torch.float32)

    xm = torch.roll(x, 1, dims=-1)  # x[i-1]; wrap only affects edge bins (overridden)
    x0 = x
    xp = torch.roll(x, -1, dims=-1)  # x[i+1]

    # Uniform log-f spacing: the Lagrange parabola maximum reduces to
    # p + (y- - y+) / (2 (y- - 2 y0 + y+)) bins.
    denom = xm - 2.0 * x0 + xp
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    offset = torch.where(denom.abs() < 1e-12, zero, (xm - xp) / (2.0 * denom))
    offset = offset.clamp(-1.0, 1.0)

    center = (idx_f + offset).clamp(0.0, n - 1.0)

    # linear interpolation at the refined center (offset within one bin)
    size_pos = x0 * (1.0 - offset) + xp * offset  # offset in [0, 1]
    size_neg = xm * (-offset) + x0 * (1.0 + offset)  # offset in [-1, 0)
    size = torch.clamp_min(torch.where(offset >= 0.0, size_pos, size_neg), 0.0)

    # Edge bins use the discrete values directly (peak_detection.rs:71-77).
    edge = (idx_f < 1) | (idx_f > n - 2)
    center = torch.where(edge, idx_f, center)
    size = torch.where(edge, x, size)
    return center, size


def promote_bass_peaks(
    peak_mask: torch.Tensor,
    center: torch.Tensor,
    size: torch.Tensor,
    x: torch.Tensor,
    rng: VqtRange,
    highest_bassnote: int,
    harmonic_threshold: float,
) -> torch.Tensor:
    """Harmonic-content boost for bass peaks (peak_detection.rs:172-241):
    score harmonics 2..5 (weights .5/.3/.15/.05) in the power domain against
    `harmonic_threshold` * fundamental power; boost the peak by
    ``10*log10(min(1 + 0.5*score/fundamental, 1.5))`` dB."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    bpo = float(rng.buckets_per_octave)
    is_bass = peak_mask & (center <= float(highest_bassnote))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    fundamental_power = torch.pow(10.0, size / 10.0)
    shifted = {}

    def shift(d: int) -> torch.Tensor:
        if d not in shifted:
            shifted[d] = _shift(x, d, _NEG)
        return shifted[d]

    score = torch.zeros_like(size)
    for harmonic, weight in zip((2, 3, 4, 5), (0.5, 0.3, 0.15, 0.05)):
        # harmonic bin = center + bpo*log2(h); center is within one bin of i,
        # so floor(hb) - i takes one of three static values
        c_h = bpo * math.log2(harmonic)
        hb = center + c_h
        in_range = (hb >= 0.0) & (hb < n)
        lo_rel_mid = math.floor(c_h)
        hb_floor = torch.floor(hb)
        lo_rel = hb_floor.to(torch.int32) - idx
        x_lo = torch.full_like(x, _NEG)
        x_hi = torch.full_like(x, _NEG)
        for d in (lo_rel_mid - 1, lo_rel_mid, lo_rel_mid + 1):
            sel = lo_rel == d
            x_lo = torch.where(sel, shift(d), x_lo)
            x_hi = torch.where(sel, shift(d + 1), x_hi)
        frac = hb - hb_floor
        lo_is_hi = (frac == 0.0) | (hb_floor >= n - 1)
        amp_db = torch.where(lo_is_hi, x_lo, x_lo * (1.0 - frac) + x_hi * frac)
        hp = torch.pow(10.0, amp_db / 10.0)
        present = in_range & (hp > fundamental_power * harmonic_threshold)
        score = score + torch.where(present, hp * weight, zero)

    boost = torch.clamp_max(1.0 + 0.5 * score / torch.clamp_min(fundamental_power, 1e-6), 1.5)
    boosted = size + 10.0 * torch.log10(boost)
    return torch.where(is_bass & (score > 0.0), boosted, size)


def top_k_peaks(
    peak_mask: torch.Tensor, center: torch.Tensor, size: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size peak list for list consumers (display balls, ML): the k
    largest peaks by size, returned in ascending center order with a validity
    mask. Invalid slots have center=+inf, size=0. Equal sizes keep the lower
    bin first, and equal centers their order, as ``lax.top_k`` and the
    stable ``jnp.argsort`` break ties."""
    neg = torch.where(peak_mask, size, torch.full_like(size, -1.0))
    vals, idxs = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idxs = vals[..., :k], idxs[..., :k]
    valid = vals >= 0.0
    c = torch.where(valid, center.gather(-1, idxs), torch.full_like(vals, float("inf")))
    s = torch.where(valid, size.gather(-1, idxs), torch.zeros_like(vals))
    order = torch.argsort(c, dim=-1, stable=True)
    return c.gather(-1, order), s.gather(-1, order), valid.gather(-1, order)
