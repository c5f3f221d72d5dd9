"""Back-to-front composite of K square patches over an RGB raster.

The JAX rasterizer composites its pitch balls (``models/render.py::
_render_frame_impl``) and its debug peak disks (``_debug_world_panels``) as
a ``lax.scan`` of ``dynamic_slice`` / blend / ``dynamic_update_slice``: for
k = 0..K-1, the P x P window at (sj[k], si[k]) becomes
``rgb[k] * a[k] + window * (1 - a[k])``. The order matters where patches
overlap. Here the same function is:

* :func:`composite_patches`, the hand-written kernel ``csrc/composite.cu``
  on CUDA tensors (one launch a call, one thread a pixel walking k in
  order); on CPU tensors its plain version;
* :func:`composite_patches_plain`, a loop over k of gathered and scattered
  (B, P, P) windows, what the CPU runs.

The two agree bit for bit: the kernel rounds each product, difference and
sum on its own in the plain version's order (``-fmad=false``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# the kernel stages a stream's origins, two ints a patch, in the 48 KB of
# shared memory a launch may take without an opt-in
MAX_KERNEL_PATCHES = 48 * 1024 // 8

_composite_f32 = None


def _kernel():
    """``composite_patches_f32`` of the built library, its signature bound once."""
    global _composite_f32
    if _composite_f32 is None:
        fn = nvcc.library("composite").composite_patches_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
        _composite_f32 = fn
    return _composite_f32


def _check(img, rgb, a, si, sj) -> None:
    """Raises on shapes and types the function does not take: float32 img
    (B, Hp, Wp, 3), alpha (B, K, P, P), rgb (B, K, P, P, 3) (any strides, a
    broadcast view too), integer origins (B, K), P no larger than the
    raster, all on one device."""
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"expected img (B, Hp, Wp, 3), got {tuple(img.shape)}")
    b, hp, wp, _ = img.shape
    if a.dim() != 4 or a.shape[0] != b or a.shape[2] != a.shape[3]:
        raise ValueError(f"expected alpha (B, K, P, P) for img {tuple(img.shape)}, got {tuple(a.shape)}")
    k, p = a.shape[1], a.shape[2]
    if tuple(rgb.shape) != (b, k, p, p, 3):
        raise ValueError(f"expected rgb {(b, k, p, p, 3)}, got {tuple(rgb.shape)}")
    if tuple(si.shape) != (b, k) or tuple(sj.shape) != (b, k):
        raise ValueError(f"expected origins ({b}, {k}), got {tuple(si.shape)} and {tuple(sj.shape)}")
    if any(x.dtype != torch.float32 for x in (img, rgb, a)):
        raise TypeError(f"composite takes float32 img, rgb and alpha, got {img.dtype}, {rgb.dtype}, {a.dtype}")
    if si.dtype.is_floating_point or sj.dtype.is_floating_point or si.dtype == torch.bool:
        raise TypeError(f"composite takes integer origins, got {si.dtype} and {sj.dtype}")
    if k and p > min(hp, wp):
        raise ValueError(f"a {p} x {p} patch does not fit the {hp} x {wp} raster")
    if len({x.device for x in (img, rgb, a, si, sj)}) > 1:
        raise ValueError("composite takes tensors on one device")


def composite_patches_plain(
    img: torch.Tensor, rgb: torch.Tensor, a: torch.Tensor, si: torch.Tensor, sj: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: for k = 0..K-1 the (B, P, P) windows at rows
    sj[:, k] and columns si[:, k] are gathered, blended with patch k and
    scattered back. Returns a new (B, Hp, Wp, 3) tensor."""
    _check(img, rgb, a, si, sj)
    b, k_total, p = a.shape[0], a.shape[1], a.shape[2]
    out = img.clone()
    if b == 0:
        return out
    offsets = torch.arange(p, device=img.device)
    streams = torch.arange(b, device=img.device)[:, None, None]
    for k in range(k_total):
        rows = sj[:, k, None, None].long() + offsets[None, :, None]  # (B, P, 1)
        cols = si[:, k, None, None].long() + offsets[None, None, :]  # (B, 1, P)
        window = out[streams, rows, cols]  # (B, P, P, 3)
        ak = a[:, k, :, :, None]
        out[streams, rows, cols] = rgb[:, k] * ak + window * (1.0 - ak)
    return out


def _composite_cuda(img, rgb, a, si, sj) -> torch.Tensor:
    global launches
    _check(img, rgb, a, si, sj)
    b, hp, wp, _ = img.shape
    k, p = a.shape[1], a.shape[2]
    if k > MAX_KERNEL_PATCHES:
        raise ValueError(f"composite kernel takes at most {MAX_KERNEL_PATCHES} patches a stream, got {k}")
    img = img.contiguous()
    si = si.to(torch.int32).contiguous()
    sj = sj.to(torch.int32).contiguous()
    out = torch.empty((b, hp, wp, 3), dtype=torch.float32, device=img.device)
    if b == 0 or hp == 0 or wp == 0:
        return out
    fn = _kernel()
    args = (
        img.data_ptr(), out.data_ptr(), rgb.data_ptr(), a.data_ptr(), si.data_ptr(), sj.data_ptr(),
        b, hp, wp, k, p, *rgb.stride(), *a.stride(), torch.cuda.current_stream(img.device).cuda_stream,
    )
    # the launch goes to the current device: switch only if the tensors lie elsewhere
    if img.device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(img.device):
            rc = fn(*args)
    nvcc.check(rc, "composite_patches_f32")
    launches += 1
    return out


def composite_patches(
    img: torch.Tensor, rgb: torch.Tensor, a: torch.Tensor, si: torch.Tensor, sj: torch.Tensor
) -> torch.Tensor:
    """Composites patch k = 0..K-1 of every stream over ``img`` in order:
    the P x P window at row sj[b, k], column si[b, k] becomes
    ``rgb * a + window * (1 - a)``. img (B, Hp, Wp, 3) float32; rgb
    (B, K, P, P, 3) and a (B, K, P, P) float32; si, sj (B, K) integers,
    each window inside the raster. Returns a new (B, Hp, Wp, 3) tensor. A
    CUDA tensor goes to the kernel (one launch, no host synchronisation), a
    CPU tensor to :func:`composite_patches_plain`."""
    if img.device.type == "cuda":
        return _composite_cuda(img, rgb, a, si, sj)
    if img.device.type == "cpu":
        return composite_patches_plain(img, rgb, a, si, sj)
    raise ValueError(f"unsupported device {img.device}")
