"""Median host time of one native consume of the ring bank (rings.consume),
from the benchmark's wrapper, outside the profiled part of the window."""

import numpy as np


def read(record):
    spans = record.spans.get("consume")
    return float(np.median(spans) * 1e3) if spans else None
