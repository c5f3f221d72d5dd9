"""The VQT kernel's least time (benchmark/bounds.py: 3xTF32 operations at
the tf32 peak, or bf16 at the bf16 peak, or its bytes at HBM bandwidth,
whichever is larger, at each launch's rows) over its device time in the
profiled window."""

from benchmark import bounds


def read(record):
    if record.trace is None:
        return None
    launches, seconds = record.trace.kernel_time("vqt_kernel")
    if not launches or seconds <= 0:
        return None
    shapes = record.shapes
    least = launches * bounds.vqt_bound_s(shapes["per_device"], shapes["geometry"], shapes["fast"])
    return 100.0 * least / seconds
