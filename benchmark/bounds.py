"""The yardstick of the kernel metrics: the chip's published peaks and the
operations and bytes each kernel's work needs, from the cell's shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit. A kernel's
least time is the larger of its operations over the peak rate of its
arithmetic and its bytes over HBM bandwidth, counting each input byte read
once and each output byte written once (PERF.md's kernel table works out
the same counts at B=2048). The counts depend on the work, not on how an
implementation lays it out: the VQT's weights are counted at their true
filter counts, not padded to a tile.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12


def bound_s(bytes_moved: float, ops: float, rate: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / rate)


def vqt_geometry(kernel) -> dict:
    """Window sizes, filter counts and the tail the VQT reads, from a
    filter bank's window groups (benchmark/reference/filter_bank.py)."""
    groups = kernel.window_groups
    begin = min(g.window[0] for g in groups)
    return {
        "tail": kernel.params.n_fft - begin,
        "window_sizes": [g.window[1] - g.window[0] for g in groups],
        "filters": [g.n_filters for g in groups],
        "bins": kernel.n_buckets,
    }


def vqt_ops(b: int, window_sizes, filters, passes: int) -> float:
    """Multiply-adds of the time-domain products, two operations each: per
    group a (B, window) x (window, 2 filters) product; ``passes`` is 3 for
    f32 done as 3xTF32, 1 for bf16."""
    return passes * 2.0 * b * sum(size * 2 * nf for size, nf in zip(window_sizes, filters))


def vqt_bytes(b: int, tail: int, window_sizes, filters, bins: int, weight_itemsize: int) -> float:
    """The f32 frames' tail read once, the weights read once, the (B, bins)
    f32 power written once."""
    weights = sum(size * 2 * nf for size, nf in zip(window_sizes, filters)) * weight_itemsize
    return b * tail * 4.0 + weights + b * bins * 4.0


def vqt_bound_s(b: int, geometry: dict, fast: bool) -> float:
    ops = vqt_ops(b, geometry["window_sizes"], geometry["filters"], 1 if fast else 3)
    moved = vqt_bytes(b, geometry["tail"], geometry["window_sizes"], geometry["filters"], geometry["bins"],
                      2 if fast else 4)
    return bound_s(moved, ops, BF16_FLOPS if fast else TF32_FLOPS)


def peaks_bytes(b: int, bins: int, n_configs: int) -> float:
    """One launch of the peaks kernel: (B, bins) f32 spectra in, one (B,
    bins) bool mask a configuration out."""
    return b * bins * 4.0 + n_configs * b * bins


def peaks_hop_bound_s(b: int, bins: int) -> float:
    """The hop's two launches: the smoothed spectrum under two
    configurations, the raw one under one."""
    return (peaks_bytes(b, bins, 2) + peaks_bytes(b, bins, 1)) / HBM_BYTES_PER_S


def ring_push_bytes(b: int, buffer_len: int, hop: int) -> float:
    """One ring push: the (B, buffer) ring read and written once, the (B,
    hop) chunk read, the (B,) gains read and written."""
    return 2.0 * b * buffer_len * 4 + b * hop * 4.0 + 2.0 * b * 4


def ring_push_bound_s(b: int, buffer_len: int, hop: int) -> float:
    return ring_push_bytes(b, buffer_len, hop) / HBM_BYTES_PER_S
