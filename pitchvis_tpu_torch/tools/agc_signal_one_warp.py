"""Times the AGC kernel's signal mode (csrc/agc.cu, agc_signal_kernel: a
block of two warps a row, the chain alone on one lane, a producer warp for
the freeze flags, the staging and the stores) against the same chain in one
warp a row (agc_row chunk after chunk: the warp sums the chunk's energy,
stages each 1024-sample tile in shared memory, lane 0 runs the chain, the
warp stores the tile; a frozen chunk is x*g across the lanes), the design the
producer warp replaced.

    python3 -m pitchvis_tpu_torch.tools.agc_signal_one_warp

Run from the root of the checkout on a machine with a CUDA card and nvcc.
One nvcc builds csrc/agc.cu with the one-warp kernel appended (ONE_WARP
below) into build/pitchvis_tpu_torch/sweep/, so both kernels come from one
library at the same flags. Both are first held torch.equal to each other on
every timed input and to agc_signal_plain on a small one (silent chunks, an
all-silent row, a ragged tail), gains included; then each is timed (CUDA
events around one C call) at B=1, 8 and 132 rows of 686 chunks of 1984
samples of noise (the dataset's chunk, the corpus's longest 60-second
file; no chunk silent, so every chunk walks the chain) in two rounds, the
second in reverse order, so that a drift of the card's clock shows as a
disagreement between rounds.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ..ops import agc
from ..train.device_dataset import TRAIN_AGC
from ..utils import nvcc

CHUNK = 1984
CHUNKS = 686
ROWS = (1, 8, 132)

ONE_WARP = r"""
__global__ void __launch_bounds__(32)
agc_signal_one_warp_kernel(const float* __restrict__ x, int64_t x_stride, float* __restrict__ y,
                           float* __restrict__ gains, int C, int T, float k, float inv_rms, float silence) {
  __shared__ __align__(16) float tile[kTileStride];
  const float* xr = x + (int64_t)blockIdx.x * x_stride;
  float* yr = y + (int64_t)blockIdx.x * C * T;
  float g = 1.f;
  for (int c = 0; c < C; ++c) {
    g = agc_row(xr + (int64_t)c * T, yr + (int64_t)c * T, tile, T, g, k, inv_rms, silence, -1);
    g = __shfl_sync(0xffffffffu, g, 0);  // a frozen chunk's x*g reads it in every lane
    if (threadIdx.x == 0) gains[(int64_t)blockIdx.x * C + c] = g;
  }
}

extern "C" int agc_signal_one_warp_f32(const float* x, long long x_stride, float* y, float* gains, int B, int C,
                                       int T, float k, float inv_rms, float silence, void* stream) {
  agc_signal_one_warp_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(x, x_stride, y, gains, C, T, k, inv_rms, silence);
  return (int)cudaGetLastError();
}
"""


def _build() -> tuple[ctypes.CDLL, str]:
    out_dir = os.path.join(nvcc.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "agc_one_warp.cu")
    with open(os.path.join(nvcc.CSRC_DIR, "agc.cu")) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write(text + ONE_WARP)
    lib_path = os.path.join(out_dir, "libagc_one_warp.so")
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.ARCH_FLAGS, *nvcc.BASE_FLAGS, *nvcc.EXTRA_FLAGS["agc"],
                           "-o", lib_path, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    report = "; ".join(line.strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line)
    lib = ctypes.CDLL(lib_path)
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    for fn in (lib.agc_signal_f32, lib.agc_signal_one_warp_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, i64, ptr, ptr] + [i32] * 3 + [f32] * 3 + [ptr]
    return lib, report


def _run(fn, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, n = x.shape
    c = n // CHUNK
    out = torch.empty((b, c * CHUNK), device=x.device)
    gains = torch.empty((b, c), device=x.device)
    k, inv_rms = agc._constants(TRAIN_AGC)
    nvcc.check(fn(x.data_ptr(), x.stride(0), out.data_ptr(), gains.data_ptr(), b, c, CHUNK, k, inv_rms,
                  agc.SILENCE_ENERGY, torch.cuda.current_stream().cuda_stream), "agc signal mode")
    return out, gains


def _time_ms(fn, x: torch.Tensor, reps: int = 5) -> float:
    _run(fn, x)
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        _run(fn, x)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("agc_signal_one_warp: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    lib, report = _build()
    print(f"build: {report}")
    kernels = {"two warps (shipped)": lib.agc_signal_f32, "one warp": lib.agc_signal_one_warp_f32}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {b: torch.randn((b, CHUNKS * CHUNK), generator=gen, device="cuda") * 0.1 for b in ROWS}
    small = torch.randn((5, 9 * CHUNK + 5), generator=gen, device="cuda") * 0.3
    small[1] = 0.0
    small[2, CHUNK : 3 * CHUNK] = 0.0
    want = agc.agc_signal_plain(small, CHUNK, TRAIN_AGC)
    for label, fn in kernels.items():
        got = _run(fn, small)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"{label}: differs from agc_signal_plain")
        for b, x in rows.items():
            a, g = _run(fn, x), _run(lib.agc_signal_f32, x)
            if not (torch.equal(a[0], g[0]) and torch.equal(a[1], g[1])):
                raise SystemExit(f"{label}: differs from the shipped kernel at B={b}")
    print("both kernels torch.equal to agc_signal_plain (B=5, 9 chunks and a tail, silent chunks) and to each other "
          f"at B={ROWS}, gains included")
    ms = {label: {b: [] for b in ROWS} for label in kernels}
    for order in (list(kernels), list(kernels)[::-1]):
        for label in order:
            for b, x in rows.items():
                ms[label][b].append(_time_ms(kernels[label], x))
    n = CHUNKS * CHUNK
    for label, by_rows in ms.items():
        print(f"{label}: " + "; ".join(f"B={b}: {t[0]:.4f}, {t[1]:.4f} ms ({t[0] * 1e6 / n:.2f} ns a sample)"
                                       for b, t in by_rows.items()))
    print(json.dumps({"card": smi, "chunks": CHUNKS, "chunk": CHUNK,
                      "ms": {label: {str(b): t for b, t in by_rows.items()} for label, by_rows in ms.items()}}))


if __name__ == "__main__":
    main()
