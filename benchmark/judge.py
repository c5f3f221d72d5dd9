"""What decides ``correct``: the program's outputs against the plain
reference, as numbers each held to its limit (benchmark/limits/).

* ``spectrum_gap_db_max``: for each compared stream-hop the mean over the
  bins of |program - reference| of the smoothed spectrum in dB, and of
  those the largest. It carries the AGC, the window, the VQT and the
  smoothing, and the spectrum has no threshold in it, so every compared
  stream-hop is held: a lower precision of the VQT, a state that does not
  advance, or streams that were not computed move it, in any one stream.
* ``outputs_gap_p75``: for each compared stream-hop the mean, over the
  served outputs (the LED block, or every display output, and the two
  per-stream scalars), of each one's mean gap in its own scale, and of
  those the 75th percentile.
* ``outputs_off_share``: the share of compared stream-hops in which a
  served output is off the reference: a u8 value by more than one level, a
  flag at all, a float by more than ``FLOAT_ATOL + FLOAT_RTOL *
  |reference|``. Rounding alone is inside these; a peak that one side
  finds and the other does not (a ball or an LED then differs for as long
  as the peak's effect lasts), or an altered answer, is not. Sound runs
  read a share of such flips, so the limit lies between theirs and the
  control's.
* ``ingest_off_count`` (live cells): the compared stream-consumes whose
  advance or row differ from every outcome that the push log allows, and
  the dispatches whose clock lies outside the harness's own bracket of the
  call (benchmark/live.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

U8_LEVELS = 1
FLOAT_ATOL = 4e-3  # a color channel is a multiple of 1/255
FLOAT_RTOL = 1e-3

# the leaves of the analysis outputs that reach a user besides the LED block
# or the display outputs
SCALARS = ("analysis.scene_calmness", "analysis.tuning_inaccuracy")


def flatten(tree, prefix: str = "") -> dict:
    """Leaf name -> leaf of a tree of tensors, dicts and dataclasses."""
    if tree is None:
        return {}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return {prefix: tree}  # a tensor or an array
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        raise TypeError(f"cannot flatten {type(tree)} at {prefix!r}")
    out = {}
    for name, value in items:
        out.update(flatten(value, f"{prefix}.{name}" if prefix else name))
    return out


def served_leaves(leaves: dict) -> dict:
    """The leaves a user is served: the LED block, the display outputs and
    the two per-stream scalars."""
    return {k: v for k, v in leaves.items() if k == "led" or k.startswith("viewer.") or k in SCALARS}


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spectrum_gaps(program, reference) -> np.ndarray:
    """(..., bins) smoothed spectra -> the mean |gap| of each row (a mean,
    not a median: most bins of a spectrum sit at its 60-dB floor, where
    both sides read 0)."""
    return np.abs(_np(program).astype(np.float64) - _np(reference).astype(np.float64)).mean(axis=-1)


def off_rows(program: dict, reference: dict, lead: int, by_leaf: dict | None = None) -> np.ndarray:
    """A bool per stream-hop (the first ``lead`` axes of every leaf): some
    served output is off the reference. ``by_leaf`` receives the count of
    stream-hops off in each leaf that has any."""
    off = None
    for name, ref in reference.items():
        ref = _np(ref)
        got = _np(program[name])
        if got.shape != ref.shape:
            raise ValueError(f"{name}: program {got.shape} against reference {ref.shape}")
        axes = tuple(range(lead, ref.ndim))
        if ref.dtype == np.bool_:
            bad = got != ref
        elif ref.dtype == np.uint8:
            bad = np.abs(got.astype(np.int64) - ref.astype(np.int64)) > U8_LEVELS
        else:
            got64, ref64 = got.astype(np.float64), ref.astype(np.float64)
            bad = ~(np.abs(got64 - ref64) <= FLOAT_ATOL + FLOAT_RTOL * np.abs(ref64))
        bad = bad.any(axis=axes) if axes else bad
        if by_leaf is not None and bad.any():
            by_leaf[name] = int(bad.sum())
        off = bad if off is None else off | bad
    return off


def output_gaps(program: dict, reference: dict, lead: int, by_leaf: dict | None = None) -> np.ndarray:
    """A number per stream-hop: the mean over the served leaves of each
    leaf's mean |program - reference| in the leaf's own scale (a u8 value
    over 255, a flag as 0 or 1, a float over 1 + |reference|). ``by_leaf``
    receives each leaf's 75th percentile over the stream-hops."""
    total = None
    for name, ref in reference.items():
        ref = _np(ref)
        got = _np(program[name])
        if ref.dtype == np.bool_:
            d = (got != ref).astype(np.float64)
        elif ref.dtype == np.uint8:
            d = np.abs(got.astype(np.float64) - ref.astype(np.float64)) / 255.0
        else:
            ref64 = ref.astype(np.float64)
            d = np.abs(got.astype(np.float64) - ref64) / (1.0 + np.abs(ref64))
        d = d.reshape(*d.shape[:lead], -1).mean(axis=-1) if d.ndim > lead else d
        if by_leaf is not None:
            by_leaf[name] = float(np.percentile(d, 75))
        total = d if total is None else total + d
    return total / len(reference)


def readings(gaps: np.ndarray, off: np.ndarray, out_gaps: np.ndarray) -> dict:
    return {
        "spectrum_gap_db_max": float(gaps.max()) if gaps.size else float("inf"),
        "outputs_gap_p75": float(np.percentile(out_gaps, 75)) if out_gaps.size else float("inf"),
        "outputs_off_share": float(off.mean()) if off.size else 1.0,
    }


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limit of the cell."""
    checks = {name: {"value": values.get(name, float("inf")), "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
