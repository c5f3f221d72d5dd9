"""Pytest setup shared by the whole checkout: builds the JAX package's
native library before any test module is collected, and caps torch's CPU
threads in each pytest-xdist worker.

native/libpitchvis_native.so is not committed. The JAX package's loader
(pitchvis_tpu/runtime/native.py) runs ``make -C native`` without a lock at
first use and remembers a failure for the rest of its process, and several
JAX test modules ask for the library while they are collected (in a
``skipif`` condition). Under pytest-xdist every worker collects every module
at once, so on a checkout without the library the workers raced one
another's builds, and a worker that lost skipped or failed every JAX native
test it then ran. pytest imports this file in the controlling process and in
each worker before it collects anything; here the library is built, if it is
missing or older than a source, under an exclusive lock on
build/jax_native_make.lock (the lock tests/torch_port_helpers.py's
``jax_native_lib`` fixture takes), so the JAX loader finds it built. A failed
build is left for the JAX loader to report. Nothing of the JAX package is
imported here.

Under pytest-xdist every worker runs torch with one intra-op thread per core
of the host by default, so six workers on eight cores ask for 48 threads,
and each small parallel op of the port's CPU route (the plain peaks
version's (B, n, n) reductions) then waits tens of milliseconds for its
OpenMP region. Each worker gets its share of the cores instead: torch's
intra-op threads (``pytest_configure``), and MKL's, torch's BLAS on the CPU,
through MKL_NUM_THREADS, which MKL reads once when torch loads and which
sizes its thread team in every OS thread (``torch.set_num_threads`` caps
MKL in the calling thread only, so a product on a server's loop thread
would otherwise split its sums differently from the same product on the
test's thread). JAX's threads, and NumPy's OpenBLAS, are left as they
are."""

import fcntl
import os
import subprocess

_ROOT = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB = os.path.join(_NATIVE_DIR, "libpitchvis_native.so")
JAX_NATIVE_LOCK = os.path.join(_ROOT, "build", "jax_native_make.lock")


def _stale() -> bool:
    """The JAX loader's rule (pitchvis_tpu/runtime/native.py::_stale): the
    library is missing or older than a native source other than the ALSA
    stub's."""
    try:
        built = os.path.getmtime(_LIB)
        for name in os.listdir(_NATIVE_DIR):
            if name.endswith((".cpp", ".c", ".h")) and not name.startswith("alsa"):
                if os.path.getmtime(os.path.join(_NATIVE_DIR, name)) > built:
                    return True
    except OSError:
        return True
    return False


def _build_jax_native_library() -> None:
    os.makedirs(os.path.dirname(JAX_NATIVE_LOCK), exist_ok=True)
    with open(JAX_NATIVE_LOCK, "w") as lock:
        # checked under the lock: make writes the library in place, so a file
        # another process is still linking must not pass for a built one
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                pass


_build_jax_native_library()


def _worker_threads() -> int | None:
    """A pytest-xdist worker's share of the host's cores; None outside
    one."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    n_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, n_workers))


if _worker_threads() is not None:
    # before any test module imports torch (this file is imported first)
    os.environ["MKL_NUM_THREADS"] = str(_worker_threads())


def pytest_configure(config):
    if _worker_threads() is not None:
        import torch

        torch.set_num_threads(_worker_threads())
