"""Kernels on the device in the profiled window over the hops dispatched in
it."""


def read(record):
    if record.trace is None or not record.counters.get("traced_hops") or not record.trace.kernels():
        return None
    return len(record.trace.kernels()) / record.counters["traced_hops"]
