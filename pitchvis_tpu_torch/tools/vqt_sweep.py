"""Builds the VQT kernel (csrc/vqt.cu) under other tilings and times them at
the main path's shapes (default VqtParameters, B=2048).

    python3 -m pitchvis_tpu_torch.tools.vqt_sweep            # every variant
    python3 -m pitchvis_tpu_torch.tools.vqt_sweep --shipped  # the defaults only

Run from the root of the checkout on a machine with a CUDA card and nvcc.
The kernel's real choices are macros of the source, for each mode the
consumer warpgroups a block (64 frames each) and the stages of its
shared-memory ring; together they fix the shared memory a block takes and so
the blocks an SM holds. Each variant below sets both modes' macros; one nvcc
each, all started together, into build/pitchvis_tpu_torch/sweep/, and each
build's register and spill report and warnings are printed. Every variant is
first compared with the plain version on the same tonal frames (the worst of
B=2048, 5 and 1; one beyond 1e-3 dB or 1e-4 of the frame maximum is marked),
then timed (CUDA events around the C
call alone) in two rounds, the second in
reverse order, so that a drift of the card's clock shows as a disagreement
between rounds. The first variant is the shipped one (the macros' defaults).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from .. import VqtParameters, get_kernel
from ..ops import vqt_pallas
from ..ops.vqt import power_to_db
from ..utils import nvcc

B = 2048
DB_TOL, REL_TOL = 1e-3, 1e-4  # chip_smoke.py's tolerances against the plain version
# (label, macros): warpgroups a block, stages and the K-tiles between two
# flushes of the wgmma accumulator, bf16 | f32. A stage is 8 KB (f32) or 16
# KB (bf16) of frames a warpgroup plus 32 KB (f32) or 16 KB (bf16) of weights.
VARIANTS = (
    ("shipped: bf16 1wg 6st flush 16 | f32 1wg 4st flush 8", {}),
    ("bf16 1wg 7st flush 16 | f32 1wg 5st flush 8", {"VQT_BF16_STAGES": 7, "VQT_F32_STAGES": 5}),
    ("bf16 1wg 4st flush 16 | f32 1wg 3st flush 8", {"VQT_BF16_STAGES": 4, "VQT_F32_STAGES": 3}),
    ("bf16 1wg 3st flush 16 | f32 1wg 2st flush 8", {"VQT_BF16_STAGES": 3, "VQT_F32_STAGES": 2}),
    ("bf16 1wg 6st flush 1 | f32 1wg 4st flush 1", {"VQT_BF16_FLUSH": 1, "VQT_F32_FLUSH": 1}),
    ("bf16 1wg 6st flush 4 | f32 1wg 4st flush 4", {"VQT_BF16_FLUSH": 4, "VQT_F32_FLUSH": 4}),
    ("bf16 1wg 6st flush 8 | f32 1wg 4st flush 2", {"VQT_BF16_FLUSH": 8, "VQT_F32_FLUSH": 2}),
    ("bf16 1wg 6st flush 32 | f32 1wg 4st flush 32", {"VQT_BF16_FLUSH": 32, "VQT_F32_FLUSH": 32}),
    ("bf16 1wg 6st never flushed | f32 1wg 4st never flushed",
     {"VQT_BF16_FLUSH": 1 << 20, "VQT_F32_FLUSH": 1 << 20}),
    ("bf16 2wg 3st flush 16 | f32 1wg 4st flush 8", {"VQT_BF16_WGS": 2, "VQT_BF16_STAGES": 3}),
)


def _time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _build(variants) -> dict[str, ctypes.CDLL]:
    libs = {}
    for label, (lib, report) in nvcc.build_variants("vqt", variants).items():
        print(f"{label}: {report}")
        libs[label] = lib
    return libs


def _check(arrays, x) -> tuple[float, float]:
    """The kernel's distance from the plain version, the worst of B=2048, 5
    and 1: (dB, power error over the frame's maximum)."""
    worst_db = worst_rel = 0.0
    for b in (x.shape[0], 5, 1):
        got = vqt_pallas.vqt_power_pallas(arrays, x[:b])
        want = vqt_pallas.vqt_power_pallas_plain(arrays, x[:b])
        torch.cuda.synchronize()
        worst_db = max(worst_db, float((power_to_db(got) - power_to_db(want)).abs().max()))
        worst_rel = max(worst_rel, float(((got - want).abs() / want.amax(1, keepdim=True)).max()))
    return worst_db, worst_rel


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vqt_sweep: needs a CUDA card")
    variants = VARIANTS[:1] if "--shipped" in sys.argv[1:] else VARIANTS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = get_kernel(VqtParameters())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # tonal frames (two sines and a little noise): their weak bins are sums
    # that cancel, where an arithmetic fault shows first
    t = torch.arange(kernel.params.n_fft, device="cuda", dtype=torch.float64) / kernel.params.sr
    f = 55.0 * 2.0 ** (torch.rand((B, 2, 1), generator=gen, device="cuda", dtype=torch.float64) * 6.5)
    x = (0.3 * torch.sin(2 * np.pi * f * t).sum(1)
         + 0.01 * torch.randn((B, kernel.params.n_fft), generator=gen, device="cuda", dtype=torch.float64)).float()
    modes = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        arrays = vqt_pallas.PallasVqtArrays.from_kernel(kernel, dtype=dtype, device="cuda")
        frames = vqt_pallas._kernel_frames(arrays, x)
        out = torch.empty((B, arrays.n_buckets), dtype=torch.float32, device="cuda")
        modes[name] = (arrays, frames, out)
    libs = _build(variants)

    results = {label: {"f32": [], "bf16": []} for label in libs}
    errors = {label: {} for label in libs}
    try:
        for order in (list(libs), list(libs)[::-1]):
            for label in order:
                nvcc._libs["vqt"] = libs[label]
                for name, (arrays, frames, out) in modes.items():
                    errors[label][name] = _check(arrays, x)
                    results[label][name].append(
                        _time_ms(lambda: vqt_pallas._launch(arrays, frames, out)))
    finally:
        nvcc._libs.pop("vqt", None)
    for label, r in results.items():
        ok = all(db <= DB_TOL and rel <= REL_TOL for db, rel in errors[label].values())
        print(f"{label}: f32 ms {r['f32']}, bf16 ms {r['bf16']}; (dB, share of the frame maximum) "
              f"from plain: {errors[label]}{'' if ok else ' OUT OF TOLERANCE'}")
    print(json.dumps({"card": smi, "B": B, "ms": [
        {"variant": label, "macros": dict(variants[i][1]), "f32": r["f32"], "bf16": r["bf16"],
         "errors": errors[label]}
        for i, (label, r) in enumerate(results.items())]}))


if __name__ == "__main__":
    main()
