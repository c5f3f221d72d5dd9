"""Median host time to enqueue one step_multi call (no synchronise in it),
over the call's hops."""

import numpy as np


def read(record):
    spans = record.spans.get("enqueue_per_hop")
    return float(np.median(spans) * 1e3) if spans else None
