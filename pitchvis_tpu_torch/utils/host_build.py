"""Builds the port's host libraries (``pitchvis_tpu_torch/native/``) at first
use, the C++ ones with ``g++`` and the C one (the ALSA test stub) with
``gcc``, as :mod:`.nvcc` builds the CUDA kernels.

The library lands in ``build/pitchvis_tpu_torch/`` at the root of the
checkout (listed in .gitignore). Its file name carries a hash of the source,
the flags and the machine type, so an edited source or another host is never
served by a stale build. Several processes may ask for the library at once
(test workers, a server and its tools): the build runs under an exclusive
``fcntl.flock`` on a lock file in the build directory, writes a temporary
file and ``os.replace``-s it into place, so no process ever loads a file
another one is still writing, and no process gives up because another one
was building.

Nothing here runs at import time.
"""

from __future__ import annotations

import fcntl
import os
import platform
import shutil
import subprocess
import time

from .nvcc import BUILD_DIR, build_logs, source_digest

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
# the flag sets of the JAX package's native/Makefile (its C++ library and its
# alsa-stub rule)
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
C_FLAGS = ["-O2", "-fPIC", "-shared"]
BUILD_TIMEOUT_S = 300


def host_compiler(name: str = "g++") -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"{name} not found: pitchvis_tpu_torch builds its "
            "native libraries from source at first use"
        )
    return path


def library_path(name: str, language: str = "c++") -> str:
    """Path of the built ``native/<name>.cpp`` (``language="c"``:
    ``native/<name>.c``), built first if it is not there. Raises
    RuntimeError if the compiler fails."""
    if language not in ("c++", "c"):
        raise ValueError(f"language must be 'c++' or 'c', got {language!r}")
    src = os.path.join(NATIVE_DIR, f"{name}.cpp" if language == "c++" else f"{name}.c")
    flags = HOST_FLAGS if language == "c++" else C_FLAGS
    digest = source_digest(src, flags + [platform.machine()])
    out = os.path.join(BUILD_DIR, f"lib{name}_host_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # built by another process while we waited
            return out
        tmp_out = f"{out}.{os.getpid()}.tmp"
        if language == "c++":
            cmd = [host_compiler(), *HOST_FLAGS, "-o", tmp_out, src]
        else:
            cmd = [host_compiler("gcc"), *C_FLAGS, "-o", tmp_out, src, "-lm"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        build_logs[name] = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}({time.perf_counter() - t0:.2f} s)"
        if proc.returncode != 0:
            if os.path.exists(tmp_out):
                os.remove(tmp_out)
            raise RuntimeError(
                f"{cmd[0]} failed for {os.path.relpath(src, NATIVE_DIR)} (rc {proc.returncode}):\n{build_logs[name]}"
            )
        os.replace(tmp_out, out)
    return out
