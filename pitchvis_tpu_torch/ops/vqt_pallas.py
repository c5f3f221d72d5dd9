"""Fused multi-group VQT kernel.

Port of ``pitchvis_tpu/ops/vqt_pallas.py``: one launch of the hand-written
CUDA kernel ``csrc/vqt.cu`` computes the whole multi-group VQT power
spectrum. Every window group reads its slice of the batch's trailing
``tail`` samples in place (all groups nest inside the largest group's
window), and the complex magnitude-squared is fused into the kernel, so only
(B, n_buckets) power leaves it.

Group weights are zero-padded to multiples of 128 filter columns at pack
time, the re and im halves separately, as in the JAX package
(``PallasVqtArrays.weights``; the plain version reads these). The kernel
reads a second, kernel-side layout derived from them once at pack time
(:func:`kernel_side_layout`): K-major tiles of 64 filters with re and im
interleaved, K zero-padded to whole K-tiles from an aligned start. One
kernel serves both weight dtypes, both on the tensor cores with f32 sums:
bf16 (fast mode: bf16 weights, the frames rounded to bf16 in registers) and
f32 (3xTF32: frames and weights split into tf32 hi + lo, three products a
step, never single-pass TF32).

:func:`vqt_power_pallas_plain` is the kernel's plain PyTorch version, run
for CPU tensors; :func:`vqt_power_kernel_layout_plain` computes the same
from the kernel-side layout, addressed as the kernel addresses it, so that
a test without a card can hold the layout against the packed weights.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernel.builder import VqtKernel
from ..utils import nvcc
from .vqt import matmul_f32, power_to_db, precision_for

LANE = 128
TILE_FILTERS = 64  # filters a kernel tile (csrc/vqt.cu TILE_ROWS: 64 re + 64 im rows)
ROW_BYTES = 128  # csrc/vqt.cu ROW_BYTES: one K-tile of one weight row
X_ALIGN = 8  # samples: a group's read starts at a multiple of this
TILE_INTS = 8  # csrc/vqt.cu TILE_INTS
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/vqt.cu vqt_power's own return codes (CUDA's are positive)
_LAUNCH_REFUSALS = {
    -1: "arguments the kernel does not take (dtype, sizes, or an unaligned address or stride)",
    -2: "libcuda has no cuTensorMapEncodeTiled",
    -3: "cuTensorMapEncodeTiled refused a tensor map for these frames or weights",
}

# launches of the CUDA kernel (the plain version does not count)
launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tf32_round(w: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits, nearest even), as float32
    with the low 13 bits zero."""
    bits = w.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def kernel_side_layout(weights, offsets, window_sizes, nf, nf_pad):
    """The packed group weights re-laid for ``csrc/vqt.cu``.

    Returns ``(w_tiles, table)``, on the weights' device. ``w_tiles`` is a
    stack of blocks of 128 rows x KT samples, KT being 128 bytes of samples
    (64 in bf16, 32 in f32). A block holds one K-tile of one 64-filter tile,
    transposed (K-major): rows 0..63 the real parts of filters c0..c0+63,
    rows 64..127 their imaginary parts. A group's K axis starts at its offset
    rounded down to a multiple of ``X_ALIGN`` samples (zero rows in front)
    and is zero-padded at the end to whole K-tiles. bf16 weights give (n,
    128, 64). f32 weights give (n, 256, 32) for the kernel's 3xTF32 products:
    rows 0..127 ``hi = tf32(w)``, rows 128..255 ``lo = tf32(w - hi)`` (hi + lo
    is w to 2^-22 of its magnitude).

    ``table`` is an int32 (tiles, 8) tensor, one row a filter tile: first
    block, K-tiles, first sample read in the tail, first output column, true
    filters in the tile (three ints unused); sorted by descending K-tiles,
    so that the kernel starts its longest blocks first."""
    dtype = weights[0].dtype
    kt = ROW_BYTES // weights[0].element_size()
    blocks, rows = [], []
    n_blocks = 0
    out_col = 0
    for w, off, size, f, fp in zip(weights, offsets, window_sizes, nf, nf_pad):
        x_col = off - off % X_ALIGN
        front = off - x_col
        n_k = -(-(front + size) // kt)
        for c0 in range(0, f, TILE_FILTERS):
            cols = torch.cat(
                [w[:, c0 : c0 + TILE_FILTERS], w[:, fp + c0 : fp + c0 + TILE_FILTERS]], dim=1
            )  # (size, 128): re | im
            padded = torch.zeros((n_k * kt, 2 * TILE_FILTERS), dtype=dtype, device=w.device)
            padded[front : front + size] = cols
            blocks.append(padded.T.reshape(2 * TILE_FILTERS, n_k, kt).permute(1, 0, 2))
            rows.append([n_blocks, n_k, x_col, out_col + c0, min(TILE_FILTERS, f - c0), 0, 0, 0])
            n_blocks += n_k
        out_col += f
    rows.sort(key=lambda r: -r[1])  # stable: equal lengths keep their order
    table = torch.tensor(rows, dtype=torch.int32, device=weights[0].device)
    w_tiles = torch.cat(blocks).contiguous()
    if dtype == torch.float32:
        hi = tf32_round(w_tiles)
        w_tiles = torch.cat([hi, tf32_round(w_tiles - hi)], dim=1).contiguous()
    return w_tiles, table


@dataclass
class PallasVqtArrays:
    """Padded per-group weights + static geometry for the fused kernel."""

    weights: tuple[torch.Tensor, ...]  # per group (w_g, 2*nf_pad_g)
    offsets: tuple[int, ...]  # group window offset within the tail
    window_sizes: tuple[int, ...]
    nf: tuple[int, ...]  # true filter counts
    nf_pad: tuple[int, ...]
    tail: int  # tail window size (largest group window)
    n_fft: int
    n_buckets: int
    # the kernel-side layout, always derived from the fields above
    kernel_weights: torch.Tensor = field(init=False, repr=False)
    kernel_tiles: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.kernel_weights, self.kernel_tiles = kernel_side_layout(
            self.weights, self.offsets, self.window_sizes, self.nf, self.nf_pad
        )

    @classmethod
    def from_kernel(
        cls, kernel: VqtKernel, dtype=torch.float32, device="cuda"
    ) -> "PallasVqtArrays":
        device = resolve_device(device)
        n_fft = kernel.params.n_fft
        tail_begin = min(g.window[0] for g in kernel.window_groups)
        tail = n_fft - tail_begin
        weights, offsets, sizes, nf, nf_pad = [], [], [], [], []
        for g in kernel.window_groups:
            begin, end = g.window
            if begin < tail_begin or end > n_fft:
                raise ValueError("group window outside tail")
            w = g.w_time  # (window, 2*nf)
            f = g.n_filters
            fp = _round_up(f, LANE)
            padded = np.zeros((w.shape[0], 2 * fp), np.float32)
            padded[:, :f] = w[:, :f]  # re half
            padded[:, fp : fp + f] = w[:, f:]  # im half
            weights.append(torch.from_numpy(padded).to(device=device, dtype=dtype))
            offsets.append(begin - tail_begin)
            sizes.append(w.shape[0])
            nf.append(f)
            nf_pad.append(fp)
        return cls(
            weights=tuple(weights),
            offsets=tuple(offsets),
            window_sizes=tuple(sizes),
            nf=tuple(nf),
            nf_pad=tuple(nf_pad),
            tail=tail,
            n_fft=n_fft,
            n_buckets=kernel.n_buckets,
        )


def _tail(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expected (B, n_fft) or (B, tail) frames, got {tuple(x.shape)}")
    if x.shape[1] == arrays.n_fft:
        x = x[:, arrays.n_fft - arrays.tail :]
    if x.shape[1] != arrays.tail:
        raise ValueError(f"expected tail {arrays.tail}, got {x.shape[1]}")
    return x


def vqt_power_pallas_plain(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per group, the input slice rounded
    to the weights' pairing, an f32 product with the padded weights, then
    re^2 + im^2 on the true filter columns."""
    x = _tail(arrays, x)
    parts = []
    for w, off, size, f, fp in zip(
        arrays.weights, arrays.offsets, arrays.window_sizes, arrays.nf, arrays.nf_pad
    ):
        y = matmul_f32(x[:, off : off + size].to(precision_for(w.dtype)), w)
        re = y[:, :f]
        im = y[:, fp : fp + f]
        parts.append(re * re + im * im)
    return torch.cat(parts, dim=-1)


def vqt_power_kernel_layout_plain(
    arrays: PallasVqtArrays, x: torch.Tensor, acc_dtype=torch.float32
) -> torch.Tensor:
    """The power computed from the kernel-side layout exactly as the kernel
    addresses it: per filter tile, the frames from the aligned start over
    whole K-tiles (zeros beyond the row), times the transposed, interleaved
    blocks (f32: hi + lo), then re^2 + im^2 on the true filters. Against
    :func:`vqt_power_pallas_plain` only zeros are added to the sums, and in
    f32 each weight is hi + lo, which is w to 2^-22 (``acc_dtype=
    torch.float64`` shows that past the f32 sum order). It is what a test
    without a card holds the layout by, and is not used on the main path."""
    x = _tail(arrays, x)
    wk = arrays.kernel_weights
    kt = wk.shape[2]
    x = x.to(precision_for(wk.dtype)).to(acc_dtype)
    out = torch.zeros((x.shape[0], arrays.n_buckets), dtype=acc_dtype, device=x.device)
    for block0, n_k, x_col, out_col, n_valid, *_ in arrays.kernel_tiles.tolist():
        k = n_k * kt
        xs = x[:, x_col : x_col + k]
        xs = torch.nn.functional.pad(xs, (0, k - xs.shape[1]))  # past the row: zeros
        w = wk[block0 : block0 + n_k].to(acc_dtype)
        if w.shape[1] == 4 * TILE_FILTERS:  # tf32 hi and lo halves
            w = w[:, : 2 * TILE_FILTERS] + w[:, 2 * TILE_FILTERS :]
        w = w.permute(0, 2, 1).reshape(k, 2 * TILE_FILTERS)
        y = xs @ w
        re = y[:, :n_valid]
        im = y[:, TILE_FILTERS : TILE_FILTERS + n_valid]
        out[:, out_col : out_col + n_valid] = re * re + im * im
    return out


def _check_kernel_side(arrays: PallasVqtArrays, device: torch.device) -> None:
    wk, table = arrays.kernel_weights, arrays.kernel_tiles
    if wk.dtype not in _DTYPE_CODE:
        raise TypeError(f"VQT kernel takes f32 or bf16 weights, got {wk.dtype}")
    if wk.device != device or table.device != device:
        raise ValueError("kernel-side weights and tile table must be on the input's device")
    kt = ROW_BYTES // wk.element_size()
    rows = (4 if wk.dtype == torch.float32 else 2) * TILE_FILTERS
    if wk.dim() != 3 or tuple(wk.shape[1:]) != (rows, kt) or not wk.is_contiguous():
        raise ValueError(f"kernel-side weights {tuple(wk.shape)} are not (n, {rows}, {kt}) blocks")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != TILE_INTS:
        raise ValueError("tile table must be int32 (tiles, 8)")
    if not table.is_contiguous() or table.shape[0] < 1:
        raise ValueError("tile table must be contiguous and hold at least one tile")


def _kernel_frames(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    """The f32 tail as a (B, tail) tensor the kernel's tensor map can
    describe: unit sample stride, base address and row stride multiples of 16
    bytes. The streaming ring's window is so in place; where the given tensor
    is not (a custom n_fft or buffer length), a padded copy is. Fast mode
    rounds the frames to bf16 inside the kernel (the JAX package casts before
    its pallas_call; the rounding is the same)."""
    x = _tail(arrays, x)
    if x.dtype != torch.float32:
        raise TypeError(f"VQT kernel takes f32 frames, got {x.dtype}")
    size = x.element_size()
    if x.stride(1) != 1 or x.data_ptr() % 16 or (x.stride(0) * size) % 16:
        padded = torch.empty(
            (x.shape[0], _round_up(x.shape[1], 16 // size)), dtype=x.dtype, device=x.device
        )[:, : x.shape[1]]
        padded.copy_(x)
        x = padded
    return x


def _launch(arrays: PallasVqtArrays, frames: torch.Tensor, out: torch.Tensor) -> None:
    """The C call alone: ``frames`` as :func:`_kernel_frames` returns them,
    ``out`` (B, n_buckets) f32. Counts one launch."""
    global launches
    wk, table = arrays.kernel_weights, arrays.kernel_tiles
    fn = nvcc.library("vqt").vqt_power
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODE[wk.dtype], frames.data_ptr(), frames.shape[0], frames.shape[1],
            frames.stride(0), wk.data_ptr(), wk.shape[0], table.data_ptr(), table.shape[0],
            out.data_ptr(), arrays.n_buckets, stream,
        )
    if rc < 0:
        raise RuntimeError(f"vqt_power: {_LAUNCH_REFUSALS.get(rc, rc)}")
    nvcc.check(rc, "vqt_power")
    launches += 1


def _vqt_power_cuda(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    _check_kernel_side(arrays, x.device)
    frames = _kernel_frames(arrays, x)
    out = torch.empty((frames.shape[0], arrays.n_buckets), dtype=torch.float32, device=x.device)
    if frames.shape[0] > 0:
        _launch(arrays, frames, out)
    return out


def vqt_power_pallas(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    """|VQT|^2 of a batch of frames via the fused kernel.

    x: (B, n_fft) or (B, tail) f32 -> (B, n_buckets) f32. A CUDA tensor goes
    to the kernel, a CPU tensor to :func:`vqt_power_pallas_plain`."""
    if x.device.type == "cuda":
        return _vqt_power_cuda(arrays, x)
    if x.device.type == "cpu":
        return vqt_power_pallas_plain(arrays, x)
    raise ValueError(f"unsupported device {x.device}")


def vqt_db_pallas(arrays: PallasVqtArrays, x: torch.Tensor) -> torch.Tensor:
    return power_to_db(vqt_power_pallas(arrays, x))
