"""Builds the hand-written CUDA kernels of ``pitchvis_tpu_torch/csrc/`` and
loads them through ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled by ``nvcc``
into its own shared library under ``build/pitchvis_tpu_torch/`` at the root
of the checkout (listed in .gitignore), at first use. The library's file
name carries a hash of its source and flags, so an edited source is never
served from a stale build. :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them; :func:`library` builds one on demand.

Nothing here runs at import time: this module is imported on hosts with no
CUDA toolkit, where only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pitchvis_tpu_torch")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags
EXTRA_FLAGS: dict[str, list[str]] = {
    "vqt": [],
    "peaks": [],
    # the AGC recurrence spells out each fused multiply-add it wants with
    # __fmaf_rn and each plain rounding with __fmul_rn/__fadd_rn; no other
    # contraction may change its bits
    "agc": ["-fmad=false"],
    # the blend rounds each product, difference and sum on its own, in the
    # plain version's order
    "composite": ["-fmad=false"],
    # the viewer stage rounds each operation on its own, in the order of the
    # plain version's PyTorch kernels
    "viewer": ["-fmad=false"],
    # an empty kernel, for timing what a launch costs (no path calls it)
    "launch_floor": [],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output of each build (ptxas register/shared-memory report)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "pitchvis_tpu_torch are built from source at first use"
        )
    return path


def source_digest(src: str, flags: list[str]) -> str:
    """Short hash of a source file and its compiler flags: the part of a
    built library's file name that keeps an edited source from being served
    by a stale build."""
    with open(src, "rb") as f:
        text = f.read()
    return hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:12]


def _target(name: str) -> tuple[str, list[str]]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS[name]
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(src, flags)}.so")
    return out, [nvcc_path(), *flags, "-o", out, src]


def build_all(names=None) -> dict[str, float]:
    """Compiles every named source (default: all of EXTRA_FLAGS) with one
    nvcc process each, all started together. Returns seconds per source
    (0.0 for a library that was already built). Raises on any failure."""
    names = list(names or EXTRA_FLAGS)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out, cmd = _target(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp_out = f"{out}.{os.getpid()}.tmp"
        cmd = [*cmd[:-3], "-o", tmp_out, cmd[-1]]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp_out,
            out,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp_out, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp_out, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_variants(name: str, variants) -> dict[str, tuple[ctypes.CDLL, list[str]]]:
    """Builds ``csrc/<name>.cu`` once for each ``(label, macros)`` of
    ``variants`` (each macro a ``-D`` flag; one nvcc each, all started
    together) into ``build/pitchvis_tpu_torch/sweep/`` and loads each.
    Returns label -> (library, the build's register, spill and warning
    lines). Raises on any failure."""
    out_dir = os.path.join(BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    procs = {}
    for i, (label, macros) in enumerate(variants):
        out = os.path.join(out_dir, f"lib{name}_{i}.so")
        defs = [f"-D{k}={v}" for k, v in macros.items()]
        cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *EXTRA_FLAGS[name], *defs, "-o", out, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for label, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu, variant {label!r}:\n{log}")
        report = [line.strip() for line in log.splitlines()
                  if "registers" in line or "spill" in line or "warning" in line.lower()]
        libs[label] = (ctypes.CDLL(out), report)
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, _ = _target(name)
            if not os.path.exists(out):
                build_all([name])
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raises if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
