"""Grid slots the serve loop dropped while the host stalled, over the grid
slots of the window (ServeLoop.stats["skipped_deadlines"], read at each
dispatch), leaving out the profiled part of the window."""


def read(record):
    slots = record.counters.get("grid_slots")
    if not slots:
        return None
    return 100.0 * record.counters["skipped_deadlines"] / slots
