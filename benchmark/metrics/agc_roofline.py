"""The AGC kernel's ring mode (one ring push a launch) against its least
time, its bytes at HBM bandwidth (the ring read and written once, the chunk
read), over its device time in the profiled window."""

from benchmark import bounds


def read(record):
    if record.trace is None:
        return None
    launches, seconds = record.trace.kernel_time("ring_push_kernel")
    if not launches or seconds <= 0:
        return None
    shapes = record.shapes
    least = launches * bounds.ring_push_bound_s(shapes["per_device"], shapes["buffer_len"], shapes["hop"])
    return 100.0 * least / seconds
