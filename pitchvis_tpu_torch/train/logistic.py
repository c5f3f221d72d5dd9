"""Legacy logistic-regression diagnostic (pitchvis_train/src/train.rs:45-110).

Port of ``pitchvis_tpu/train/logistic.py``, a copy (NumPy only).

The reference keeps a (currently commented-out, train.rs:210-238) linfa
pipeline that fits a binary logistic regression on the key-centered
positive/negative samples produced by the centering augmentation
(`center_vqt_samples`, train.rs:366-441) and reports a confusion matrix,
accuracy, and Matthews correlation coefficient on a 90/10 shuffled split.
This module is the framework's equivalent: a deterministic, host-side
NumPy IRLS (Newton) fit with linfa's defaults (L2 alpha=1.0 on the weights,
fitted intercept, iteration cap) — a quick linear-separability diagnostic
for the centered dataset, not a serving path (the real model is
models/pitch_mlp.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LogisticFit:
    """Fit artifacts mirroring what the reference prints (train.rs:80-110):
    the parameter vector (chunkable per octave), the validation confusion
    matrix [[TN, FP], [FN, TP]], accuracy, and MCC."""

    weights: np.ndarray  # (n_features,)
    intercept: float
    confusion: np.ndarray  # (2, 2) int64: rows = true 0/1, cols = pred 0/1
    accuracy: float
    mcc: float

    def params_by_octave(self, buckets_per_octave: int) -> list[np.ndarray]:
        """The reference's per-octave weight dump
        (train.rs:82-87: axis_chunks_iter over BUCKETS_PER_OCTAVE)."""
        return [
            self.weights[i : i + buckets_per_octave]
            for i in range(0, len(self.weights), buckets_per_octave)
        ]


def matthews_corrcoef(confusion: np.ndarray) -> float:
    """MCC from a 2x2 confusion matrix; 0.0 when any marginal is empty
    (the convention linfa's cm.mcc() follows for degenerate splits)."""
    (tn, fp), (fn, tp) = confusion.astype(np.float64)
    denom = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    if denom == 0.0:
        return 0.0
    return float((tp * tn - fp * fn) / np.sqrt(denom))


def fit(
    positive: list[tuple[np.ndarray, float]],
    negative: list[tuple[np.ndarray, float]],
    *,
    max_iterations: int = 120,
    alpha: float = 1.0,
    split: float = 0.9,
    seed: int = 0,
) -> LogisticFit:
    """Fits positive-vs-negative logistic regression and evaluates on a
    shuffled 90/10 holdout (train.rs:45-110; the reference shuffles with
    thread_rng — here the seed is explicit so runs are reproducible).

    positive/negative: (sample, attack) tuples as produced by
    `train.dataset.center_vqt_samples`; the attack value is carried by the
    reference but unused by the fit (targets are the pos/neg labels).
    """
    if not positive or not negative:
        raise ValueError("need at least one positive and one negative sample")
    x = np.stack(
        [np.asarray(s, np.float64) for s, _ in positive]
        + [np.asarray(s, np.float64) for s, _ in negative]
    )
    y = np.concatenate([np.ones(len(positive)), np.zeros(len(negative))])

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    n_train = max(1, min(len(x) - 1, int(round(len(x) * split))))
    xt, yt = x[:n_train], y[:n_train]
    xv, yv = x[n_train:], y[n_train:]

    w = np.zeros(x.shape[1])
    b = 0.0
    # IRLS / Newton with L2 on the weights (not the intercept), linfa's
    # regularization convention; ~1e1 iterations to machine convergence at
    # these feature counts (87 semitones * buckets_per_semitone)
    for _ in range(max_iterations):
        z = xt @ w + b
        p = 1.0 / (1.0 + np.exp(-z))
        g_w = xt.T @ (p - yt) + alpha * w
        g_b = float(np.sum(p - yt))
        r = np.clip(p * (1.0 - p), 1e-10, None)
        h_ww = (xt * r[:, None]).T @ xt + alpha * np.eye(len(w))
        h_wb = xt.T @ r
        h_bb = float(np.sum(r))
        h = np.block(
            [[h_ww, h_wb[:, None]], [h_wb[None, :], np.array([[h_bb]])]]
        )
        step = np.linalg.solve(h, np.concatenate([g_w, [g_b]]))
        w -= step[:-1]
        b -= float(step[-1])
        if np.max(np.abs(step)) < 1e-10:
            break

    pred = (xv @ w + b) > 0.0
    confusion = np.zeros((2, 2), np.int64)
    for t, q in zip(yv.astype(int), pred.astype(int)):
        confusion[t, q] += 1
    correct = int(confusion[0, 0] + confusion[1, 1])
    accuracy = correct / max(1, len(yv))
    return LogisticFit(
        weights=w.astype(np.float32),
        intercept=float(b),
        confusion=confusion,
        accuracy=float(accuracy),
        mcc=matthews_corrcoef(confusion),
    )
