"""The peaks kernel's least time (its bytes at HBM bandwidth: the spectra
read, one mask a configuration written; two launches a hop) over its device
time in the profiled window."""

from benchmark import bounds


def read(record):
    if record.trace is None:
        return None
    launches, seconds = record.trace.kernel_time("peaks_kernel")
    if not launches or seconds <= 0:
        return None
    shapes = record.shapes
    least = launches / 2 * bounds.peaks_hop_bound_s(shapes["per_device"], shapes["bins"])
    return 100.0 * least / seconds
