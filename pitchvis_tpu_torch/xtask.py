"""Developer task runner of the port (the reference's cargo-xtask,
xtask/src/main.rs:14-39; the JAX package's ``xtask.py``):

    python -m pitchvis_tpu_torch.xtask check [--device cpu]  # a small Vqt on the card
    python -m pitchvis_tpu_torch.xtask test [args]   # tests/test_torch_*.py
    python -m pitchvis_tpu_torch.xtask bench [args]  # python -m pitchvis_tpu_torch.bench
    python -m pitchvis_tpu_torch.xtask build-native  # both native libraries (g++)
                                                     # and the CUDA kernels (nvcc)
    python -m pitchvis_tpu_torch.xtask golden [kind] [--device cpu]
                                                     # golden files into build/golden_torch/
    python -m pitchvis_tpu_torch.xtask warm [args]   # build everything and run one
                                                     # pipeline hop, one server hop
                                                     # and one step_multi(8)
    python -m pitchvis_tpu_torch.xtask clean         # remove the port's build outputs
    python -m pitchvis_tpu_torch.xtask train-demo [args]  # train/corpus.py
    python -m pitchvis_tpu_torch.xtask soak [args]   # bench/soak.py
    python -m pitchvis_tpu_torch.xtask longhaul [args]    # bench/longhaul.py

``bench --check`` is the regression gate: it re-runs every configuration of
build/BENCH_SWEEP_torch.json and fails on a best-of-N result below 0.4x the
recorded value. There is no compile cache to warm: the port's kernels are
nvcc builds under build/pitchvis_tpu_torch/, made at first use.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join("build", "golden_torch")
# the port's build outputs: the nvcc kernels and the g++/gcc host libraries
# (utils/nvcc.py::BUILD_DIR)
BUILD_OUTPUTS = (os.path.join("build", "pitchvis_tpu_torch"),)
NATIVE_LIBRARIES = ("pitchvis_native", "synth_engine")


def _run(cmd, **kw):
    print("+", " ".join(cmd))
    return subprocess.run(cmd, cwd=ROOT, **kw).returncode


CHECK_CODE = (
    "import sys\n"
    "import numpy as np\n"
    "from pitchvis_tpu_torch import Vqt\n"
    "from pitchvis_tpu_torch.core.config import VqtParameters, VqtRange\n"
    "from pitchvis_tpu_torch.ops import vqt_pallas\n"
    "device = sys.argv[sys.argv.index('--device') + 1] if '--device' in sys.argv else 'cuda'\n"
    "p = VqtParameters(n_fft=2048, range=VqtRange(min_freq=220.0, octaves=3, buckets_per_octave=12))\n"
    "v = Vqt(p, path='pallas', device=device)\n"
    "t = np.arange(p.n_fft) / p.sr\n"
    "x = np.stack([np.sin(2 * np.pi * f * t) for f in (440.0, 880.0)]).astype(np.float32)\n"
    "out = v.calculate_vqt_batch_in_db(x)\n"
    "assert tuple(out.shape) == (2, p.n_buckets), out.shape\n"
    "assert out.argmax(dim=1).tolist() == [12, 24], out.argmax(dim=1).tolist()\n"
    "print('check ok:', tuple(out.shape), 'on', out.device, '- A4 and A5 at bins 12 and 24; '\n"
    "      'VQT kernel launches:', vqt_pallas.launches)\n"
)


def check(args) -> int:
    """A small Vqt on the fused kernel path, in a fresh process, two tones
    found at their bins: on the card it builds and launches the VQT kernel
    (``--device cpu``: its plain version)."""
    return _run([sys.executable, "-c", CHECK_CODE, *args])


def test(args) -> int:
    files = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    return _run([sys.executable, "-m", "pytest", *files, "-q", *args])


def bench(args) -> int:
    return _run([sys.executable, "-m", "pitchvis_tpu_torch.bench", *args])


def build_native() -> int:
    """Both native host libraries (g++) and every CUDA kernel (nvcc)."""
    from .utils import host_build, nvcc

    for lib in NATIVE_LIBRARIES:
        print(lib, "->", host_build.library_path(lib))
    try:
        seconds = nvcc.build_all()
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print("nvcc seconds:", seconds)
    return 0


def golden(args) -> int:
    return _run([sys.executable, "-m", "pitchvis_tpu_torch.io.golden", GOLDEN_DIR, *args])


def warm(argv) -> int:
    """Builds the CUDA kernels and both native libraries, then runs one
    pipeline hop, one server hop and one server ``step_multi(8)``, printing
    the seconds each took (first use: kernel loads, weight uploads, static
    tables). Flags: --streams N (default 512), --path {time,freq,pallas}
    (default pallas), --fast, --fused (the ML and LED stages too), --small
    (reduced parameters), --device (default the card)."""
    import numpy as np
    import torch

    from .bench.configs import _sync
    from .core.config import VqtParameters, VqtRange
    from .core.device import resolve_device
    from .models.pipeline import StreamingPipeline
    from .models.pitch_mlp import DEFAULT_T, PitchMLP
    from .runtime import native
    from .utils import host_build, nvcc

    ap = argparse.ArgumentParser(prog="xtask warm")
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--path", default="pallas", choices=["time", "freq", "pallas"])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    for lib in NATIVE_LIBRARIES:
        host_build.library_path(lib)
    built = nvcc.build_all() if dev.type == "cuda" else {}
    print(f"built native libraries and kernels {built}: {time.perf_counter() - t0:.1f}s")
    params = (VqtParameters(n_fft=2048, range=VqtRange(min_freq=220.0, octaves=3, buckets_per_octave=12))
              if args.small else VqtParameters())
    n = args.streams
    kw = dict(path=args.path, fast=args.fast, device=dev)
    if args.fused:
        model = PitchMLP(input_bins=DEFAULT_T * params.n_buckets, seed=0, device=dev)
        kw.update(ml_model=model, with_led=True)
    hop = int(params.sr / 60.0)
    t0 = time.perf_counter()
    pipe = StreamingPipeline(n, params, **kw)
    pipe.step(torch.zeros((n, hop)), hop / params.sr)
    _sync(dev)
    print(f"warmed pipeline step ({n} streams, {args.path}{', fast' if args.fast else ''}): "
          f"{time.perf_counter() - t0:.1f}s")
    # the JAX task's skip where the ingest library does not build, kept for
    # the CPU; on the card its RuntimeError propagates
    if dev.type == "cuda":
        native.load()
    elif not native.available():
        print("server warm skipped: native runtime unavailable")
        return 0
    from .runtime.server import StreamServer

    t0 = time.perf_counter()
    srv = StreamServer(n, params, buffer_seconds=1.0, **kw)
    try:
        srv.push(0, np.zeros(hop, np.float32))
        srv.step(dt=hop / params.sr)
        _sync(dev)
        print(f"warmed server step ({n} streams): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        srv.step_multi(8)
        _sync(dev)
        print(f"warmed server step_multi(8): {time.perf_counter() - t0:.1f}s")
    finally:
        srv.close()
    return 0


def clean(root: str = ROOT) -> int:
    """Removes the port's build outputs under ``root``; nothing of the JAX
    package (its .cache/ and native/libpitchvis_native.so stay)."""
    for rel in BUILD_OUTPUTS:
        path = os.path.join(root, rel)
        if os.path.isdir(path):
            shutil.rmtree(path)
            print("removed", path)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    cmd, *rest = argv
    if cmd == "check":
        return check(rest)
    if cmd == "test":
        return test(rest)
    if cmd == "bench":
        return bench(rest)
    if cmd == "build-native":
        return build_native()
    if cmd == "golden":
        return golden(rest)
    if cmd == "warm":
        return warm(rest)
    if cmd == "clean":
        return clean()
    if cmd == "train-demo":
        from .train.corpus import main as corpus_main

        return corpus_main(rest)
    if cmd == "soak":
        from .bench.soak import main as soak_main

        return soak_main(rest)
    if cmd == "longhaul":
        from .bench.longhaul import main as longhaul_main

        return longhaul_main(rest)
    print(f"unknown task {cmd!r}")
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
