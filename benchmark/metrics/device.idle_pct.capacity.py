"""Share of the profiled window with no kernel, copy or fill on the device
(averaged over the devices the run uses)."""


def read(record):
    if record.trace is None or not record.trace.events:
        return None
    return 100.0 * (1.0 - record.trace.busy_s() / record.trace.window_s)
