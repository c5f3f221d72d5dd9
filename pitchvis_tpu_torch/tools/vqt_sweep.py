"""Times the VQT kernel (csrc/vqt.cu) under other launch-bound and unroll
choices, at the main path's shapes (default VqtParameters, B=2048).

    python3 -m pitchvis_tpu_torch.tools.vqt_sweep

Run from the root of the checkout on a machine with a CUDA card and nvcc.
It builds one library per (blocks per SM, K-loop unroll) pair, with one
nvcc each, all started together, under build/pitchvis_tpu_torch/sweep/,
and prints each build's register and spill report. Then it times every
variant in f32 and in bf16 (median of CUDA-event timings), in two rounds,
the second in reverse order, so that a drift of the card's clock shows as a
disagreement between rounds. Each variant is first checked against the
shipped build on the same input. The shipped choice is f32 at 1 block an
SM, bf16 at 2, unroll 8 (the macros' defaults in vqt.cu).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import VqtParameters, get_kernel
from ..ops import vqt_pallas
from ..utils import nvcc

B = 2048
BLOCKS = (1, 2)
UNROLLS = (2, 4, 8)


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


def _build_variants() -> dict[tuple[int, int], ctypes.CDLL]:
    out_dir = os.path.join(nvcc.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(nvcc.CSRC_DIR, "vqt.cu")
    procs = {}
    for blocks in BLOCKS:
        for unroll in UNROLLS:
            out = os.path.join(out_dir, f"libvqt_b{blocks}_u{unroll}.so")
            macros = [f"-DVQT_F32_MIN_BLOCKS={blocks}", f"-DVQT_BF16_MIN_BLOCKS={blocks}",
                      f"-DVQT_K_UNROLL={unroll}"]
            cmd = [nvcc.nvcc_path(), *nvcc.ARCH_FLAGS, *nvcc.BASE_FLAGS, *macros, "-o", out, src]
            procs[(blocks, unroll)] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        report = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"blocks {key[0]} unroll {key[1]}: {report}")
        libs[key] = ctypes.CDLL(out)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vqt_sweep: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    kernel = get_kernel(VqtParameters())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn((B, kernel.params.n_fft), generator=gen, device="cuda") * 0.1
    arrays = {
        name: vqt_pallas.PallasVqtArrays.from_kernel(kernel, dtype=dtype, device="cuda")
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    }
    shipped = {name: vqt_pallas.vqt_power_pallas(a, x) for name, a in arrays.items()}
    libs = _build_variants()

    results = {key: {"f32": [], "bf16": []} for key in libs}
    for order in (list(libs), list(libs)[::-1]):
        for key in order:
            nvcc._libs["vqt"] = libs[key]
            for name, a in arrays.items():
                got = vqt_pallas.vqt_power_pallas(a, x)
                rel = float(((got - shipped[name]).abs() / shipped[name].amax(1, keepdim=True)).max())
                if rel > 1e-4:
                    raise RuntimeError(f"variant {key} {name} differs from the shipped build by {rel}")
                results[key][name].append(_time_ms(lambda a=a: vqt_pallas.vqt_power_pallas(a, x)))
    nvcc._libs.pop("vqt")
    for key, r in results.items():
        print(f"blocks {key[0]} unroll {key[1]}: f32 ms {r['f32']}, bf16 ms {r['bf16']}")
    print(json.dumps({"card": smi, "B": B, "ms": [
        {"blocks": k[0], "unroll": k[1], "f32": r["f32"], "bf16": r["bf16"]} for k, r in results.items()]}))


if __name__ == "__main__":
    main()
